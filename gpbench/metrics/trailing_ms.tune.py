"""trailing_ms.tune: device milliseconds a tuning step under the port span
``albatross.cholesky.trailing``, the factorization's trailing update,
forward and backward (``gpbench/spans.py``)."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.cholesky.trailing")
