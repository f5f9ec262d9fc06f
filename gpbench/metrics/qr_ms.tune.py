"""qr_ms.tune: milliseconds of the sparse GP's tall QR in the mode that
value+grad takes (reduced), CUDA events, on a seeded f32 matrix of the
step's shape; only where the model's module has a ``tall_qr``."""


def read(ctx):
    tall_qr = getattr(ctx.model, "tall_qr", None)
    if ctx.kind != "tune" or tall_qr is None:
        return None
    seconds = ctx.cuda_seconds(tall_qr(ctx.program, ctx.seed))
    return None if seconds is None else seconds * 1e3
