"""cg_ms: the stream ms per op of the program's CG solves (its ``cg`` spans: K10 around the MVMs), from
simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "cg")
