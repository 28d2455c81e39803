"""setup_s: seconds from the start of the process to the end of the warm-up (loading, building, warming)."""


def read(ctx):
    return ctx["setup_s"]
