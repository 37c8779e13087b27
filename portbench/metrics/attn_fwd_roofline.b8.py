"""attn_fwd_roofline.b8: Kernel A's global launches (the global layers of
the ModernBERT cell, ``work.attention_fwd`` at 8 x 16 x 8,192 x 64): their
least time over their device time, by kernel name in the trace. The banded
instance's launches are named ``attention_band`` and are not counted."""

from portbench.metrics import kernel_roofline

UNIT = "%"
BETTER = "higher"
LAYER = "attention kernel A"
MOVES = "qps"


def read(ctx):
    per_launch = ctx["work"].get("attn_fwd", {}).get("per_launch")
    if per_launch is None:
        return None
    return kernel_roofline(ctx, "attention_fwd", per_launch)
