"""peak_mem_gib: the card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    return None if ctx.window_peak_bytes is None else ctx.window_peak_bytes / 2**30
