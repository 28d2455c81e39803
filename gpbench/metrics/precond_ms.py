"""precond_ms: the stream ms per op of the program's preconditioner (its ``precond`` spans: K6's factor, then
make_preconditioner), from simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "precond")
