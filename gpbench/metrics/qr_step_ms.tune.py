"""qr_step_ms.tune: device milliseconds a tuning step under the port span
``albatross.sparse.qr``, the sparse GP's tall QR, forward and backward
(``gpbench/spans.py``); only where the step opens that span."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.sparse.qr")
