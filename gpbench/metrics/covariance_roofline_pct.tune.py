"""covariance_roofline_pct.tune: the covariance layer's least time, the
model's ``covariance_bytes`` (the (N, N) covariance written once forward
and its gradient read once backward) over the card's 3.35 TB/s, as a share
of its device time a tuning step under ``albatross.covariance``
(``covariance_ms.tune``); None where the program opens no such span."""

from gpbench import counts, spans


def read(ctx):
    ms = spans.device_ms(spans.summary(ctx), "albatross.covariance")
    if not ms:
        return None
    return 100.0 * ctx.model.covariance_bytes(ctx.config) / counts.HBM_BYTES_PER_S / (ms * 1e-3)
