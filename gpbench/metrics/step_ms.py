"""step_ms: the window's host seconds over the training steps it completed, in ms."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["ops"]
