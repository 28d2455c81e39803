"""idle_pct: the share of the traced window in which no kernel, memory copy or memset runs on the card, in %."""

from gpbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
