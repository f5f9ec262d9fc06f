"""predict_p95_ms: the 95th percentile of every batch latency in the
window, from the call to the result on the host."""

import numpy as np


def read(ctx):
    if ctx.kind != "predict" or not ctx.window.completed:
        return None
    return float(np.percentile(ctx.window.latencies, 95)) * 1e3
