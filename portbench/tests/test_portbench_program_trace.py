"""The join of the port's own spans to a device profile, on hand-made
traces, its readers, and the study on a tiny cell on the CPU."""

import time

import pytest
import torch

from portbench import metrics, program_trace as pt, run, trace
from portbench.registry import Registry

from densephrases_tpu_torch.utils.profiling import Span

CPU = torch.device("cpu")
MARKS = (10.0, 10.001)  # host seconds of the two markers' launches


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _h(us: float) -> float:
    """Trace µs → host seconds (the first marker's launch at 1000 µs is
    host 10.0 s)."""
    return 10.0 + (us - 1000) * 1e-6


def _span(i, name, a_us, b_us, parent=None, request=0):
    return Span(i, name, _h(a_us), _h(b_us), parent, request, 1, {})


# one request: towers, then stage 1 with its scan, then the wait and the
# assembly
SPANS = [
    _span(0, "serve.request", 1005, 1905),
    _span(1, "towers.forward", 1010, 1200, parent=0),
    _span(2, "index.search_dense", 1210, 1595, parent=0),
    _span(3, "index.flat.scan", 1220, 1550, parent=2),
    _span(4, "serve.wait", 1610, 1800, parent=0),
    _span(5, "index.assemble", 1810, 1900, parent=0),
]
CALLS = [(_h(1008), _h(1205), "towers")]


def synthetic():
    """A 1,000 µs window. A kernel launched before the window runs at
    [1000, 1020); kernel A is launched in the towers (1050) and runs at
    [1100, 1300), while the host is already in stage 1; kernel B is
    launched in the scan (1300) and runs at [1300, 1500); a copy is
    launched in stage 1 after the scan (1570) and runs at [1580, 1600);
    one kernel has no launch call in the trace ([1700, 1720))."""
    return {"traceEvents": [
        _x("cudaLaunchKernel", "cuda_runtime", 1000, 5, corr=1),
        _x("void at::native::spin_kernel(long)", "kernel", 1000.5, 0.1,
           corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 2000, 5, corr=2),
        _x("void at::native::spin_kernel(long)", "kernel", 2000.5, 0.1,
           corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 990, 5, corr=6),
        _x("early", "kernel", 1000, 20, corr=6),
        _x("cudaLaunchKernel", "cuda_runtime", 1050, 5, corr=3),
        _x("gemm_A", "kernel", 1100, 200, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 1300, 5, corr=4),
        _x("topk_B", "kernel", 1300, 200, corr=4),
        _x("cudaMemcpyAsync", "cuda_runtime", 1570, 5, corr=5),
        _x("Memcpy DtoH", "gpu_memcpy", 1580, 20, corr=5),
        _x("orphan", "kernel", 1700, 20, corr=99),
    ]}


def test_kernels_fall_to_the_span_open_at_their_launch():
    got = pt.join(synthetic(), MARKS, SPANS, CALLS)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(460e-6)
    assert got["requests"] == [0]
    # A runs while the host is in stage 1, but was launched in the towers
    assert got["self"]["towers.forward"] == [pytest.approx(200e-6), 1]
    assert got["self"]["index.flat.scan"] == [pytest.approx(200e-6), 1]
    assert got["self"]["index.search_dense"] == [pytest.approx(20e-6), 1]
    assert got["self"]["none"] == [pytest.approx(40e-6), 2]
    # a span holds what the spans nested in it launched
    assert got["under"]["index.search_dense"] == [pytest.approx(220e-6), 2]
    assert got["under"]["serve.request"] == [pytest.approx(420e-6), 3]
    assert got["launches"] == {0: 3}


def test_idle_gaps_are_named_by_the_innermost_span():
    got = pt.join(synthetic(), MARKS, SPANS, CALLS)
    # each gap goes to the span open where it begins: [1020, 1100) in the
    # towers' program span, which wins over the harness's wrapped call
    # around it; [1500, 1580) in the scan; [1600, 1700) in the request
    # between stage 1 and the wait; [1720, 2000) in the wait (the clock's
    # rounding leaves a gap of ~1e-16 s at the window's start)
    idle = {k: v for k, v in got["idle"].items() if v > 1e-12}
    assert idle == {
        "towers.forward": pytest.approx(80e-6),
        "index.flat.scan": pytest.approx(80e-6),
        "serve.request": pytest.approx(100e-6),
        "serve.wait": pytest.approx(280e-6)}
    # split by where the host was through each gap: [1500, 1580) is 50 µs
    # in the scan and 30 in stage 1; [1600, 1700) 10 in the request and 90
    # in the wait; [1720, 2000) 80 in the wait, 15 in the request, 90 in
    # the assembly and 95 after the request
    during = {k: v for k, v in got["idle_during"].items() if v > 1e-12}
    assert during == {
        "towers.forward": pytest.approx(80e-6),
        "index.flat.scan": pytest.approx(50e-6),
        "index.search_dense": pytest.approx(30e-6),
        "serve.request": pytest.approx(25e-6),
        "serve.wait": pytest.approx(170e-6),
        "index.assemble": pytest.approx(90e-6),
        "portbench.client": pytest.approx(95e-6)}
    assert sum(during.values()) == pytest.approx(sum(idle.values()))


def test_harness_calls_name_gaps_no_program_span_covers():
    got = pt.join(synthetic(), MARKS, [], CALLS)
    assert got["idle"]["portbench.towers"] == pytest.approx(80e-6)
    assert got["idle"]["portbench.client"] == pytest.approx(460e-6)
    assert got["requests"] == [] and got["launches"] == {}
    assert got["self"] == {"none": [pytest.approx(460e-6), 5]}


def test_the_innermost_span_of_a_deep_request_is_found():
    """A request of 30 spans: 24 closed siblings, then a chain 5 deep; a
    gap after the siblings, in the root, and one at the chain's bottom."""
    spans = [Span(0, "serve.request", 0.0, 100.0, None, 7, 1, {})]
    for i in range(24):
        spans.append(Span(1 + i, f"sib{i}", 1 + 3 * i, 2 + 3 * i, 0, 7, 1,
                          {}))
    parent = 0
    for d in range(5):
        spans.append(Span(30 + d, f"deep{d}", 80.0 + d, 95.0 - d, parent, 7,
                          1, {}))
        parent = 30 + d
    look = pt.Innermost((s.start, s.end, s.name) for s in spans)
    assert look.at(75.0) == "serve.request"
    assert look.at(90.0) == "deep4"
    assert look.at(93.5) == "deep1"
    assert look.at(2.5) == "serve.request"
    assert look.at(1.5) == "sib0"
    assert look.at(150.0) is None and look.at(-1.0) is None
    # the same through the join: one gap at host 75 s in a window [0, 200]
    doc = {"traceEvents": [
        _x("cudaLaunchKernel", "cuda_runtime", 0, 1, corr=1),
        _x("spin_kernel", "kernel", 0, 1, corr=1),
        _x("k", "kernel", 0, 75e6, corr=2),
        _x("k", "kernel", 76e6, 124e6, corr=3)]}
    got = pt.join(doc, (0.0, 200.0), spans)
    assert got["idle"] == {"serve.request": pytest.approx(1.0)}


def test_the_join_leaves_the_existing_readings_as_they_were():
    doc = synthetic()
    before = trace.read_trace(doc, MARKS, CALLS)
    pt.join(doc, MARKS, SPANS, CALLS)
    after = trace.read_trace(doc, MARKS, CALLS)
    assert before == after
    ctx = {"trace": before, "traced_requests": 1,
           "work": {"step_flops": 1e9}}
    with_spans = dict(ctx, program=pt.join(doc, MARKS, SPANS, CALLS))
    for read in (metrics.idle_pct, metrics.step_mfu):
        assert read(ctx) == read(with_spans)
    assert metrics.kernel_seconds(ctx, "gemm") == \
        metrics.kernel_seconds(with_spans, "gemm")


def test_readers_read_a_profiled_request():
    joined = pt.join(synthetic(), MARKS, SPANS, CALLS)
    readings = {"joined": joined, "counters": {
        "towers.tokens_real": 30, "towers.tokens_padded": 120,
        "index.ivf.rows_own": 5, "index.ivf.rows_scored": 250},
        "plain_self": pt.self_times(SPANS), "plain_requests": 1}
    assert pt.launches(readings) == 3
    assert pt.towers_device_ms(readings) == pytest.approx(0.2)
    assert pt.search_device_ms(readings) == pytest.approx(0.22)
    assert pt.towers_token_useful(readings) == pytest.approx(25.0)
    assert pt.ivf_scan_useful(readings) == pytest.approx(2.0)
    # host self times: the towers 190 µs, the scan 330 (stage 1's own 55
    # is not launch work)
    assert pt.dispatch_ms(readings) == pytest.approx(0.19 + 0.33)


def test_each_reader_is_none_without_its_input():
    flat = {"counters": {"towers.tokens_real": 3,
                         "towers.tokens_padded": 6}}
    assert pt.ivf_scan_useful(flat) is None
    for read in pt.READERS.values():
        assert read({}) is None
    no_device = {"joined": pt.join({"traceEvents": []}, MARKS, SPANS)}
    for read in (pt.launches, pt.towers_device_ms, pt.search_device_ms):
        assert read(no_device) is None


def _tracer():
    prof = pt.tracer()
    assert prof is not None
    return prof


def test_a_tiny_run_leaves_program_tracing_off(tiny_root):
    prof = _tracer()
    reg = Registry(tiny_root, tiny_root / "portbench")
    cell = reg.spec["workloads"][0]["name"]
    for traced in (False, True):
        line, _ = run.run_cell(reg, cell, seed=2**35 + 1, seconds=0.5,
                               trace=traced, device=CPU,
                               t_process0=time.perf_counter())
        assert line["correct"] is True
        assert not prof.active()


@pytest.mark.parametrize("cell", ["flat-sq8.nq-b64", "ivf-opq96.nq-b64"])
def test_a_tiny_study_reads_the_counters_and_host_spans(tiny_root, cell):
    reg = Registry(tiny_root, tiny_root / "portbench")
    out = pt.study(reg, cell, seed=2**34 + 5, device=CPU, rounds=1,
                   profile_s=0.3, plain_s=0.3)
    assert not _tracer().active()
    m = out["metrics"]
    # the CPU profile has no device events: no device reading
    assert m["launches"] is None and m["towers_device_ms"] is None
    assert 0 < m["towers_token_useful"] < 100
    assert m["dispatch_ms"] > 0
    if cell.startswith("ivf"):
        assert 0 < m["ivf_scan_useful"] <= 100
        assert out["counters"]["index.ivf.rows_scored"] > 0
    else:
        assert m["ivf_scan_useful"] is None
        assert out["counters"]["index.flat.chunks"] > 0
    names = {k for k, _ in out["host_self_ms"]}
    assert {"serve.request", "towers.forward", "index.rescore",
            "index.assemble"} <= names
    assert [r["program"] for r in out["profiled"]] == [False, True]
    assert out["profiled_qps_on"] > 0 and out["plain_qps_off"] > 0
