"""latency_p95_ms: The 95th percentile over every request of the window,
each from its send to its answers assembled (nearest rank)."""

from portbench.metrics import p95

UNIT = "ms"
BETTER = "lower"


def read(ctx):
    lat = p95(ctx["latencies_s"])
    return None if lat is None else 1e3 * lat
