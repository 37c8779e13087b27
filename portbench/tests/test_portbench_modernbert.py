"""The ModernBERT cell: found by name, its work counts against hand counts,
its metrics silent where nothing was traced, and a tiny run on the CPU
(the towers cut to the tiny width, the documents to 20-90 words) that is
correct while the fp8 control is not."""

import json
import time

import pytest
import torch

from portbench import readings, run, work
from portbench.registry import Registry
from portbench.work import modernbert as work_mb

CELL = "mbl-flat-sq8.doc-el8k-b8"
NEW_METRICS = {"towers_ms.b8", "attn_fwd_roofline.b8",
               "attn_band_roofline.b8", "device_idle_pct.b8", "step_mfu.b8",
               "search_ms.b8", "search_roofline.b8", "assemble_ms.b8"}


def test_the_cell_is_found_by_name():
    reg = Registry()
    plan = reg.plan(CELL)
    assert plan["config"]["name"] == "modernbert-large.flat-sq8"
    assert plan["config"]["route"] == "fused_flat_modernbert"
    assert plan["traffic"]["batch"] == 8
    assert plan["traffic"]["max_query_length"] == 8192
    assert set(plan["per_layer"]) == NEW_METRICS
    assert set(plan["end_to_end"]) == {"qps", "latency_p95_ms",
                                       "device_mem_gib", "setup_s"}
    for m in reg.spec["per_layer"]:
        assert (m["name"] in NEW_METRICS) == (CELL in m["workloads"])
    assert reg.cell(CELL)["chips"] == 1
    assert callable(plan["route"].Served)


def test_every_length_is_sent_equally_often():
    reg = Registry()
    plan = reg.plan(CELL)
    lengths = [n for i in range(750)
               for n in plan["generator"].lengths(plan["traffic"], 7, i)]
    assert sorted(lengths) == list(range(2001, 8001))


def test_band_work_by_hand():
    # 8 x 16 x 8,192 x 64, w 64: each row 129 keys, less 64·65 at the ends
    ops, nbytes = work_mb.attention_band(8, 16, 8192, 64, 64)
    pairs = 8192 * 129 - 64 * 65
    assert work_mb.band_keys(8192, 64) == pairs == sum(
        min(8191, i + 64) - max(0, i - 64) + 1 for i in range(8192))
    assert ops == 4 * 8 * 16 * 64 * pairs
    assert nbytes == 4 * 8 * 16 * 8192 * 64 * 2 + 4 * 8 * 8192
    # bytes bound it: 537 MB in 0.160 ms against 0.035 ms of products
    assert 1e3 * work.least_s(ops, nbytes) == pytest.approx(0.1603, abs=1e-4)
    assert 1e3 * ops / work.PEAK_OPS_PER_S["bfloat16"] == pytest.approx(
        0.0349, abs=1e-4)
    assert work_mb.band_keys(10, 20) == 100


def test_tower_flops_by_hand():
    model = json.loads((Registry().pkg / "configs"
                        / "modernbert-large.flat-sq8.json").read_text())["model"]
    h, f, b, l = 1024, 2624, 8, 8192
    assert work_mb.layer_kinds(model) == (10, 18)
    dense = 28 * b * l * (2 * (3 * h * h + h * h) + 2 * (h * 2 * f + f * h))
    attn = 4 * b * h * (10 * l * l + 18 * (l * 129 - 64 * 65))
    assert work_mb.tower_flops(model, b, l) == dense + attn
    # projections and GeGLU 24.5 MFLOP a token a layer; two towers 90 TFLOP
    assert 2 * dense == pytest.approx(89.9e12, rel=0.01)
    assert 2 * attn == pytest.approx(45.2e12, rel=0.01)


def test_request_work_of_the_cell():
    plan = Registry().plan(CELL)
    w = plan["route"].request_work(plan["config"], plan["traffic"])
    assert w["attn_fwd"]["launches"] == 20
    assert w["attn_band"]["launches"] == 36
    assert w["attn_fwd"]["per_launch"] == work.attention_fwd(8, 16, 8192, 64)
    assert w["attn_band"]["per_launch"] == work_mb.attention_band(
        8, 16, 8192, 64, 64)
    assert w["search"] == work.flat_scan(16, 1_000_000, 1024)
    assert w["step_flops"] > 2 * work_mb.tower_flops(
        plan["config"]["model"], 8, 8192)
    json.dumps(w)


def test_metrics_are_silent_where_nothing_was_traced():
    reg = Registry()
    plan = reg.plan(CELL)
    work_ = plan["route"].request_work(plan["config"], plan["traffic"])
    untraced = {"work": work_, "trace": None, "spans": None}
    empty = {"work": work_, "spans": {}, "span_requests": 0,
             "traced_requests": 3,
             "trace": {"kernels": {"void flat_scan_topk<16>": (0.002, 3)},
                       "busy_s": 0.0, "window_s": 4.0, "idle": {}}}
    for name in NEW_METRICS:
        reader = reg.metric(name)
        assert reader.read(untraced) is None, name
        assert reader.read(empty) is None, name
    # a parent's route counts no band: its reader stays silent
    assert reg.metric("attn_band_roofline.b8").read(
        {"work": {}, "trace": empty["trace"]}) is None


def test_band_roofline_reads_the_band_kernel_alone():
    reg = Registry()
    plan = reg.plan(CELL)
    work_ = plan["route"].request_work(plan["config"], plan["traffic"])
    band_s, glob_s = 36 * 0.2e-3, 20 * 5e-3
    ctx = {"work": work_, "trace": {"kernels": {
        "void (anonymous namespace)::attention_band_mma<64>(...)": (band_s, 36),
        "void (anonymous namespace)::attention_fwd_mma<64, 1>(...)": (glob_s, 20)},
        "busy_s": 1.0, "window_s": 2.0, "idle": {}}}
    band = reg.metric("attn_band_roofline.b8").read(ctx)
    glob = reg.metric("attn_fwd_roofline.b8").read(ctx)
    assert band == pytest.approx(100 * 0.1603e-3 / 0.2e-3, rel=0.01)
    assert glob == pytest.approx(100 * 2.2236e-3 / 5e-3, rel=0.01)


def test_search_metrics_read_the_cells_spans():
    reg = Registry()
    plan = reg.plan(CELL)
    work_ = plan["route"].request_work(plan["config"], plan["traffic"])
    ctx = {"work": work_, "spans": {"search": 0.03, "assemble": 0.012},
           "span_requests": 10}
    assert reg.metric("search_ms.b8").read(ctx) == pytest.approx(3.0)
    assert reg.metric("assemble_ms.b8").read(ctx) == pytest.approx(1.2)
    # E's least time at 16 x 1M x 1,024 int8: the codes read once
    least_ms = 1e3 * work.least_s(*work.flat_scan(16, 1_000_000, 1024))
    assert reg.metric("search_roofline.b8").read(ctx) == pytest.approx(
        100 * least_ms / 3.0)


@pytest.fixture
def tiny_cell(tiny_root):
    """The tiny benchmark with this cell's documents cut to 20-90 words
    (96 tokens) and three layers (a global and two local ones, a band of 8
    each side), so that the CPU runs it in seconds."""
    pkg = tiny_root / "portbench"
    path = pkg / "traffic" / "doc-el8k-b8.json"
    traffic = json.loads(path.read_text())
    traffic.update(max_query_length=96, words=[21, 92])
    path.write_text(json.dumps(traffic))
    path = pkg / "configs" / "modernbert-large.flat-sq8.json"
    cfg = json.loads(path.read_text())
    cfg["model"].update(num_hidden_layers=3, local_attention=16)
    path.write_text(json.dumps(cfg))
    return Registry(tiny_root, pkg)


def test_a_tiny_run_is_correct(tiny_cell):
    line, info = run.run_cell(tiny_cell, CELL, seed=2**33 + 11, seconds=1.0,
                              trace=False, device=torch.device("cpu"),
                              t_process0=time.perf_counter())
    assert line["correct"] is True, (line["check"], info)
    assert line["failed"] == 0 and info["errors"] == []
    assert set(line["metrics"]) == {"qps", "latency_p95_ms",
                                    "device_mem_gib", "setup_s"}


def test_the_fp8_control_is_not_correct_at_the_tiny_size(tiny_cell):
    limits = tiny_cell.cell(CELL)["limits"]
    nums = readings.control_numbers(tiny_cell, CELL, 2**35 + 1, 1.0,
                                    torch.device("cpu"))
    assert any(nums[k] > lim for k, lim in limits.items()), nums
