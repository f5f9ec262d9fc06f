"""gram_roofline_pct.predict: the port's gram entry at a predict batch's
(N, batch) cross covariance, CUDA-event time against its roofline bound."""

from gpbench import generator
from gpbench.readings import roofline_pct


def read(ctx):
    if ctx.kind != "predict":
        return None
    xs = generator.predict_points(ctx.config, ctx.traffic, ctx.seed, 0, ctx.program.x.device)
    return roofline_pct(ctx, *ctx.model.predict_gram(ctx.program, xs))
