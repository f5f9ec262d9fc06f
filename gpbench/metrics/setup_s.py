"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build or load, the data, the model and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
