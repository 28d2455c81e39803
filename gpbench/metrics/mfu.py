"""mfu: the traced ops' least time on the chip (gpbench/counts.py: the larger of their bytes over 3.35 TB/s and
their float32 operations over 67 TFLOP/s) over the traced window, in %."""

from gpbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
