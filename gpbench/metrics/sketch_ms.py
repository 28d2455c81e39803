"""sketch_ms: the stream ms per op of posterior_cache's range sketch (its ``sketch`` spans: the wide plan, two
wide MVMs, QR, eigh), from simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "sketch")
