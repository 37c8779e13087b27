"""attn_fwd_roofline.b64: Kernel A's least time (``work.attention_fwd`` at
the towers' shape) over its device time, by kernel name in the trace."""

from portbench.metrics import kernel_roofline

UNIT = "%"
BETTER = "higher"
LAYER = "attention kernel A"
MOVES = "qps"


def read(ctx):
    return kernel_roofline(ctx, "attention_fwd",
                           ctx["work"]["attn_fwd"]["per_launch"])
