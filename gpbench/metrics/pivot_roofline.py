"""pivot_roofline: K6's share of its roofline: the factors' bytes, sum over pivots j of 4n(d + j + 3)
(counts.factor_cost), over 3.35 TB/s, over the pivot kernels' device time, in %."""

from gpbench.readers import roofline_pct

KERNELS = ("pivot_column_kernel",)


def read(ctx):
    return roofline_pct(ctx, "pivot", KERNELS)
