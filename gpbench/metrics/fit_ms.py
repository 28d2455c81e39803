"""fit_ms: the window's host seconds over the posterior fits it completed, in ms."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["ops"]
