"""cg_iters: the program's own CG iteration counter (nlml's stats["cg_iters"], posterior_cache's cache["cg_iters"]),
mean per step or fit."""

from gpbench.readers import mean_counter


def read(ctx):
    return mean_counter(ctx, "cg_iters")
