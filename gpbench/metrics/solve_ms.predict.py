"""solve_ms.predict: device milliseconds a predict batch under the port
span ``albatross.solve``, the triangular solves against the training
factor (``gpbench/spans.py``)."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.solve")
