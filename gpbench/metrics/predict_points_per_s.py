"""predict_points_per_s: marginal predictions delivered to the host in
the window over the time from its start to the end of the last batch."""


def read(ctx):
    rate = ctx.steps_per_s() if ctx.kind == "predict" else None
    return None if rate is None else rate * ctx.traffic["batch"]
