"""plan_ms: the stream ms per op of the program's plan builds (its ``plan`` spans: K1 and K3'a, or K1, K2 and the join
rows), from simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "plan")
