"""mfu_f64_pct.tune: the tuning step's counted operations
(``models/<model>.py``'s ``value_grad_flops``) a second over the card's
float64 peak, 67 TFLOP/s: the H100 SXM's FP64 tensor cores, dense, at its
700 W limit (NVIDIA's data sheet, as ``counts.py`` cites its own peaks).
For the cells that compute in float64, whose fastest rate is that one."""

FP64_FLOP_PER_S = 67e12


def read(ctx):
    rate = ctx.steps_per_s()
    if ctx.kind != "tune" or rate is None or not ctx.on_card:
        return None
    return 100.0 * ctx.model.value_grad_flops(ctx.config, ctx.traffic["objective"]) * rate / FP64_FLOP_PER_S
