"""predict_p95_ms: the 95th percentile of every request's latency in the window, issue to results on the host."""

from gpbench.readers import p95


def read(ctx):
    return 1e3 * p95([r["latency"] for r in ctx["cell"].records])
