"""assemble_ms.b8: Mean ms a request of ``MIPS._assemble`` and
``aggregate_results`` on the host."""

from portbench.metrics import span_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "host assembly"
MOVES = "qps"


def read(ctx):
    return span_ms(ctx, "assemble")
