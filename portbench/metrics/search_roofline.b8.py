"""search_roofline.b8: The flat stage's least time (the int8 corpus read
once a request, or the scan's products) over ``search_ms``."""

from portbench import work
from portbench.metrics import span_ms

UNIT = "%"
BETTER = "higher"
LAYER = "index"
MOVES = "qps"


def read(ctx):
    ms = span_ms(ctx, "search")
    scan = ctx["work"].get("search")  # the flat route counts its scan
    if ms is None or scan is None:
        return None
    return 100.0 * 1e3 * work.least_s(*scan) / ms
