"""attn_band_roofline.b8: Kernel A's banded instance (the local layers of
the ModernBERT cell, ``work.modernbert.attention_band`` at 8 x 16 x 8,192 x
64, half-width 64): its least time, counted from the band's own pairs, over
its device time, by the kernel name ``attention_band`` in the trace."""

from portbench.metrics import kernel_roofline

UNIT = "%"
BETTER = "higher"
LAYER = "attention kernel A"
MOVES = "qps"


def read(ctx):
    per_launch = ctx["work"].get("attn_band", {}).get("per_launch")
    if per_launch is None:
        return None
    return kernel_roofline(ctx, "attention_band", per_launch)
