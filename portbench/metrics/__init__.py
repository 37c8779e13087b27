"""Metric readers: ``metrics/<name>.py`` for each metric of
``BENCHMARK.json``, with ``UNIT``, ``BETTER``, ``LAYER`` (per-layer
metrics), ``MOVES`` (the end-to-end metric it should move) and
``read(ctx)``, which returns the number or None when the run gave it
nothing to read. A share of a roofline or of a peak is never made 0 or
clipped: where its time is missing it is None.

``ctx`` holds, for the window: ``window_s``, ``requests``, ``queries``,
``latencies_s`` (every request), ``setup_s``, ``mem_peak_bytes``; for a
traced run also ``spans`` (seconds by layer over the ``span_requests``
requests that follow the profiled part),
``trace`` (``trace.read_trace`` over the profiled part, or None) and
``traced_requests``; and ``work``, the route's count of one request's
work. The helpers below are shared by the readers.
"""

from __future__ import annotations

import math

from portbench import work


def p95(values):
    """The nearest-rank 95th percentile: the smallest value with at least
    95% of the values at or under it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def span_ms(ctx, layer: str):
    """Mean ms of a layer's self time a request, over the requests after
    the profiled part (``span_requests``)."""
    spans = ctx.get("spans")
    if not spans or layer not in spans or not ctx.get("span_requests"):
        return None
    return 1e3 * spans[layer] / ctx["span_requests"]


def kernel_seconds(ctx, fragment: str):
    """(device seconds, launches) of the traced kernels whose name holds
    ``fragment``, or None when none ran."""
    trace = ctx.get("trace")
    if not trace:
        return None
    hits = [v for k, v in trace["kernels"].items() if fragment in k]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def kernel_roofline(ctx, fragment: str, per_launch):
    """% of the least time of the traced launches (``per_launch``: (ops,
    bytes) of one launch) over their device time."""
    got = kernel_seconds(ctx, fragment)
    if got is None or got[0] <= 0:
        return None
    seconds, launches = got
    return 100.0 * launches * work.least_s(*per_launch) / seconds


def idle_pct(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def step_mfu(ctx):
    """% of the bf16 peak: the useful operations of the traced requests
    over the traced window's wall time."""
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0 or not ctx.get("traced_requests"):
        return None
    ops = ctx["work"]["step_flops"] * ctx["traced_requests"]
    return 100.0 * ops / trace["window_s"] / work.PEAK_OPS_PER_S["bfloat16"]


def pq_roofline(ctx):
    """% of kernel D's least time, summed over the traced requests'
    launches (``ctx["pq_launches"]``: (ops, bytes) of each, as the route
    counted the rows it scanned), over D's device time."""
    got = kernel_seconds(ctx, "pq_scan")
    launches = ctx.get("pq_launches")
    if got is None or got[0] <= 0 or not launches:
        return None
    return 100.0 * sum(work.least_s(*w) for w in launches) / got[0]
