"""bwd_ms: loss.backward()'s span (closed by a synchronise), mean per step, in ms."""

from gpbench.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "backward")
