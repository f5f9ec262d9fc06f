"""device_idle_pct.predict: the share of a traced span of predict batches
in which no operation ran on the card."""

from gpbench.readings import idle_pct


def read(ctx):
    return idle_pct(ctx) if ctx.kind == "predict" else None
