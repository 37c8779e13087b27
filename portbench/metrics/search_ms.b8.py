"""search_ms.b8: Mean ms a request of stage 1 (``MIPS.search_dense``) and
stage 2 (the span rescore), each ending in a device sync; the host
assembly inside stage 2 is not counted."""

from portbench.metrics import span_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "index"
MOVES = "qps"


def read(ctx):
    return span_ms(ctx, "search")
