"""pq_scan_roofline.b64: Kernel D's least time for the rows the traced
requests scanned (``work.pq_scan``; the route counts them) over its
device time."""

from portbench.metrics import pq_roofline

UNIT = "%"
BETTER = "higher"
LAYER = "PQ scan kernel D"
MOVES = "qps"


def read(ctx):
    return pq_roofline(ctx)
