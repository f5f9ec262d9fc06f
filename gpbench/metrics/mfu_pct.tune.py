"""mfu_pct.tune: the tuning step's counted operations a second over the
card's TF32 peak; the counts are the benchmark's (``counts.py``, by the
configuration's ``models/<model>.py``), whatever implements the step."""

from gpbench.readings import tune_mfu as read  # noqa: F401
