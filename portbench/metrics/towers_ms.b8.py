"""towers_ms.b8: Mean ms a request of ``DensePhrases.query2vec``
(tokenizing and both query towers), ending in a device sync."""

from portbench.metrics import span_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "query towers"
MOVES = "qps"


def read(ctx):
    return span_ms(ctx, "towers")
