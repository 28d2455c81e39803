"""posterior_ms: posterior_cache's span (closed by a synchronise), mean per fit, in ms."""

from gpbench.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "posterior_cache")
