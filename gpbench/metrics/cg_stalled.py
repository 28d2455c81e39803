"""cg_stalled: the share of the window's CG solves that the stall guard stopped, from the program's
``cg.stop.<reason>`` counters (simplex_gp_torch.trace), in %."""

from gpbench.program_spans import counter_total


def read(ctx):
    solves = counter_total(ctx, "cg.stop.")
    return 100.0 * counter_total(ctx, "cg.stop.stall") / solves if solves else None
