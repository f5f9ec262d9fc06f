"""factor_ms.loo: device milliseconds a leave-one-out step under the port
span ``albatross.cholesky`` and its children (panel, panel solve, trailing
update, whitening), forward and backward (``gpbench/spans.py``)."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.cholesky")
