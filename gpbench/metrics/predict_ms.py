"""predict_ms: the stream ms per op of predict_from_cache (its ``predict`` spans: the rect filter's plan and
apply over [train; test]), from simplex_gp_torch.trace."""

from gpbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "predict")
