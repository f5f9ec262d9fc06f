"""mfu_pct.predict: a predict batch's counted operations (for the exact
GP one triangular solve and the mean's product) a second over the card's
TF32 peak."""

from gpbench.readings import mfu_pct


def read(ctx):
    if ctx.kind != "predict":
        return None
    return mfu_pct(ctx, ctx.model.predict_flops(ctx.config, ctx.traffic["batch"]))
