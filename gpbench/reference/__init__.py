"""Plain float64 references of the benchmark's cells (``gp.py``)."""
