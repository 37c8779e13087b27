"""The traced run's readings: layer spans on the host clock, and a
``torch.profiler`` trace of the device over a part of the window.

``Spans`` wraps calls of the served object (instance attributes only; the
port's code is not changed). While ``profiling`` is set, a wrapped call
only notes its host-clock interval and adds no sync, so that the profiled
requests run the path an untraced run does; otherwise each call ends in a
device sync and adds its self time (its time less that of the wrapped
calls inside it) to its layer.

The profiler records the device only (kernels, copies, sets, and the CUDA
calls that launch them): recording every host op as well slowed a request
of the flat cell by 64%, the device alone by 20–60% (on an H100). Two
marker kernels (``torch.cuda._sleep``) launched at host times the harness
notes tie the trace's clock to the host's, through the launch call that
shares each marker's correlation id. ``read_trace`` then reduces the trace
to the traced window's length, the seconds in which an operation ran on
the device (the union of kernels, copies and sets), device seconds by
kernel name, and idle seconds by the innermost layer call open on the host
when each gap began (``portbench.client`` when none was).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Self time by layer, in seconds, over the wrapped calls."""

    def __init__(self, device):
        self.device = device
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.profiling = False
        self.intervals = []  # (start, end, layer) of the profiled calls
        self._inner = []  # time of wrapped calls inside the open ones

    def install(self, layers):
        for obj, attr, layer in layers:
            setattr(obj, attr, self._wrap(getattr(obj, attr), layer))

    def _wrap(self, fn, layer):
        def timed(*args, **kwargs):
            if self.profiling:
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.intervals.append((t0, time.perf_counter(), layer))
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                sync(self.device)
            finally:
                dt = time.perf_counter() - t0
                inner = self._inner.pop()
                self.seconds[layer] += dt - inner
                self.calls[layer] += 1
                if self._inner:
                    self._inner[-1] += dt
            return out
        return timed


class Profile:
    """The device profile of a part of the window: ``start`` and ``stop``
    around it, each launching a marker kernel and noting the host time."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.marks = []

    def _mark(self):
        sync(self.device)
        self.marks.append(time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda._sleep(1)
        sync(self.device)

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._mark()

    def stop(self):
        self._mark()
        self.prof.__exit__(None, None, None)


def export(prof) -> dict:
    """The profiler's Chrome trace as a dict (written to and read back
    from the temp dir, then removed)."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(trace: dict, marks, intervals) -> dict:
    """→ {"window_s", "busy_s", "kernels": {name: [seconds, count]},
    "idle": {layer: seconds}} over the window between the host times
    ``marks`` (start, stop); ``intervals``: the layer calls' host
    intervals. Without device events (a CPU run) the window is the host's
    and nothing was busy."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    launch = {e["args"].get("correlation"): float(e["ts"]) for e in events
              if e.get("cat") == "cuda_runtime" and "args" in e}
    marker = sorted(launch[e["args"]["correlation"]] for e in events
                    if e.get("cat") == "kernel" and MARKER in e["name"]
                    and e.get("args", {}).get("correlation") in launch)
    h0, h1 = marks
    if not marker:
        return {"window_s": h1 - h0, "busy_s": 0.0, "kernels": {},
                "idle": {"portbench.client": h1 - h0}}
    # trace µs → host seconds, from the first marker's launch
    offset = h0 - marker[0] * 1e-6
    w0, w1 = (h0 - offset) * 1e6, (h1 - offset) * 1e6
    dev, kernels = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") not in DEVICE_CATS or MARKER in e["name"]:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            k = kernels[e["name"]]
            k[0] += (b - a) * 1e-6
            k[1] += 1
    busy = _merge(dev)
    calls = sorted(intervals)
    starts = [c[0] for c in calls]
    idle = defaultdict(float)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            host = edge * 1e-6 + offset
            idle[_open_call(calls, starts, host)] += (a - edge) * 1e-6
        edge = max(edge, b)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": dict(kernels), "idle": dict(idle)}


def _open_call(calls, starts, t: float, look: int = 8) -> str:
    """The innermost layer call open at host time t (the latest-starting
    one that covers it; calls nest a few deep), or "portbench.client"
    when none is."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        a, b, layer = calls[j]
        if a <= t <= b:
            return f"portbench.{layer}"
    return "portbench.client"
