"""slq_ms: the stream ms per op of the program's log-det quadrature (its ``slq`` spans: the tridiagonals from
the CG's record and their batched eigh), from simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "slq")
