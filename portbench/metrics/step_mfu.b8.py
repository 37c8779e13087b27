"""step_mfu.b8: Useful operations of the traced requests (both towers'
forward at the padded length, attention counted over the pairs each layer
kind scores, the scan's products, the rescore) over the traced window's
wall time, against 989 TFLOP/s."""

from portbench.metrics import step_mfu

UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "qps"


def read(ctx):
    return step_mfu(ctx)
