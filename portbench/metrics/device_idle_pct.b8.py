"""device_idle_pct.b8: Share of the traced window's wall time in which no
kernel, copy or set ran on the device."""

from portbench.metrics import idle_pct

UNIT = "%"
BETTER = "lower"
LAYER = "device"
MOVES = "qps"


def read(ctx):
    return idle_pct(ctx)
