"""splat_roofline: K3'b's share of its roofline: the bytes the splats of the traced ops need (the plan's
points and weights, v, the live table out: counts.splat_cost) over 3.35 TB/s, over the chain_splat kernels' device
time, in %."""

from gpbench.readers import roofline_pct

KERNELS = ("chain_splat_kernel", "chain_combine_kernel")


def read(ctx):
    return roofline_pct(ctx, "splat", KERNELS)
