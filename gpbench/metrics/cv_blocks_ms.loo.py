"""cv_blocks_ms.loo: device milliseconds a leave-one-out step under the
port spans ``albatross.cv.folds`` (the folds' index arrays),
``albatross.cv.blocks`` (the inverse's diagonal blocks: gather, products,
per-fold solves) and ``albatross.cholesky.inverse`` (L^-1), forward and
backward, the index's backward included (``gpbench/spans.py``)."""

from gpbench import spans


def read(ctx):
    return spans.device_ms(spans.summary(ctx), "albatross.cv.folds", "albatross.cv.blocks",
                           "albatross.cholesky.inverse")
