"""The traced run's reductions on hand-made traces and calls."""

import time

import pytest
import torch

from portbench import metrics, trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


MARKS = (10.0, 10.001)  # host seconds of the two markers' launches
CALLS = [(9.9999, 10.00035, "towers"), (10.0007, 10.00095, "assemble")]


def synthetic():
    """A 1,000 µs traced window, from the first marker's launch at trace
    time 1000 µs (host 10.0 s) to the second's: kernels at [100, 300) and
    [250, 400) (overlapping: 300 µs busy), a copy at [600, 700), a kernel
    straddling the window's end; the host in the towers' call until 350
    and in the assembly's from 700."""
    return {"traceEvents": [
        _x("cudaLaunchKernel", "cuda_runtime", 1000, 5, corr=1),
        _x("void at::native::spin_kernel(long)", "kernel", 1010, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 2000, 5, corr=2),
        _x("void at::native::spin_kernel(long)", "kernel", 2010, 2, corr=2),
        _x("attention_fwd_mma<64, 2>", "kernel", 1100, 200, corr=3),
        _x("attention_fwd_mma<64, 2>", "kernel", 1250, 150, corr=4),
        _x("Memcpy DtoH", "gpu_memcpy", 1600, 100),
        _x("pq_scan8<4, 16>", "kernel", 1950, 200, corr=5),
        _x("before the window", "kernel", 500, 100),
    ]}


def test_busy_and_idle_from_a_synthetic_trace():
    got = trace.read_trace(synthetic(), MARKS, CALLS)
    assert got["window_s"] == pytest.approx(1000e-6)
    # 300 (two overlapping kernels) + 100 (copy) + 50 (cut at the end);
    # the markers do not count
    assert got["busy_s"] == pytest.approx(450e-6)
    assert got["kernels"]["attention_fwd_mma<64, 2>"] == [
        pytest.approx(350e-6), 2]
    assert got["kernels"]["pq_scan8<4, 16>"][0] == pytest.approx(50e-6)
    assert "before the window" not in got["kernels"]
    assert not any("spin_kernel" in k for k in got["kernels"])
    # gaps, each put to the call open where it starts: [0, 100) in the
    # towers, [400, 600) in none, [700, 950) in the assembly
    assert got["idle"]["portbench.towers"] == pytest.approx(100e-6)
    assert got["idle"]["portbench.client"] == pytest.approx(200e-6)
    assert got["idle"]["portbench.assemble"] == pytest.approx(250e-6)
    assert sum(got["idle"].values()) == pytest.approx(550e-6)
    ctx = {"trace": got}
    assert metrics.idle_pct(ctx) == pytest.approx(55.0)


def test_kernel_roofline_counts_launches_and_device_time():
    ctx = {"trace": trace.read_trace(synthetic(), MARKS, CALLS)}
    # 2 launches whose least time is 35 µs each, in 350 µs of device time
    per = (0.0, 35e-6 * 3.35e12)
    assert metrics.kernel_roofline(ctx, "attention_fwd", per) == \
        pytest.approx(20.0)
    assert metrics.kernel_roofline(ctx, "no such kernel", per) is None


def test_without_device_events_nothing_is_busy():
    got = trace.read_trace({"traceEvents": []}, MARKS, CALLS)
    assert got["busy_s"] == 0.0
    assert got["window_s"] == pytest.approx(0.001)
    assert metrics.idle_pct({"trace": got}) is None
    assert metrics.idle_pct({"trace": None}) is None
    assert metrics.step_mfu({"trace": None}) is None


def test_spans_count_self_time():
    class Obj:
        def outer(self):
            time.sleep(0.03)
            self.inner()

        def inner(self):
            time.sleep(0.02)

    obj = Obj()
    spans = trace.Spans(torch.device("cpu"))
    spans.install([(obj, "inner", "assemble"), (obj, "outer", "search")])
    obj.outer()
    assert spans.calls == {"assemble": 1, "search": 1}
    assert 0.02 <= spans.seconds["assemble"] < 0.03
    assert 0.03 <= spans.seconds["search"] < 0.045


def test_profiled_calls_add_no_sync(monkeypatch):
    """While the profile runs, a wrapped call only notes its host
    interval: the traced requests run the untraced path."""
    syncs = []
    monkeypatch.setattr(trace, "sync", lambda device: syncs.append(device))

    class Obj:
        def call(self):
            return 7

    obj = Obj()
    spans = trace.Spans(torch.device("cpu"))
    spans.install([(obj, "call", "towers")])
    spans.profiling = True
    assert obj.call() == 7
    assert syncs == [] and not spans.seconds
    assert [c[2] for c in spans.intervals] == ["towers"]
    spans.profiling = False
    assert obj.call() == 7
    assert len(syncs) == 1 and spans.calls == {"towers": 1}
    assert len(spans.intervals) == 1
