"""peak_gb: torch.cuda.max_memory_allocated() over the whole run, set-up included, in GB (1e9 bytes)."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
