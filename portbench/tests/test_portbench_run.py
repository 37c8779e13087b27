"""A run end to end at a tiny size on the CPU (the look for a card
skipped), its result line, its percentile, and what it may load."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import metrics, run
from portbench.registry import Registry

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def tiny_run(root, cell, seed=2**33 + 11, trace=False, fault=None,
             seconds=1.0):
    reg = Registry(root, root / "portbench")
    return run.run_cell(reg, cell, seed=seed, seconds=seconds, trace=trace,
                        device=CPU, t_process0=time.perf_counter(),
                        fault=fault)


def cells():
    return [w["name"] for w in Registry().spec["workloads"]]


@pytest.mark.parametrize("cell", cells())
def test_tiny_run_is_correct_and_prints_the_contract_keys(tiny_root, cell):
    line, info = tiny_run(tiny_root, cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True, (line["check"], info)
    assert line["failed"] == 0 and line["attempted"] > 0
    assert info["errors"] == []
    reg = Registry(tiny_root, tiny_root / "portbench")
    want = {m["name"] for m in reg.metrics(cell, "end_to_end")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for key, v in line["check"].items():
        assert set(v) == {"value", "limit"}, key
    json.dumps(line, allow_nan=False)


def test_traced_tiny_run_reports_per_layer_metrics(tiny_root, monkeypatch):
    # the first request profiled, the later ones timed by spans
    monkeypatch.setattr(run, "TRACE_S", 0.0)
    cell = cells()[0]
    line, _ = tiny_run(tiny_root, cell, trace=True, seconds=3.0)
    assert line["correct"] is True
    # the CPU trace has no device events: only the host-clock spans read
    assert {"towers_ms.b64", "search_ms.b64",
            "assemble_ms.b64"} <= set(line["metrics"])
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_requests(tiny_root):
    reg = Registry(tiny_root, tiny_root / "portbench")
    from portbench import inputs

    plan = reg.plan(cells()[0])
    vocab = inputs.make_vocab(plan["config"]["vocab"]["size"],
                              plan["config"]["vocab"]["lead"], 2**40 + 3)
    a = plan["generator"].stream(plan["traffic"], vocab, 99)
    b = plan["generator"].stream(plan["traffic"], vocab, 99)
    c = plan["generator"].stream(plan["traffic"], vocab, 98)
    ra, rb, rc = ([next(s) for _ in range(3)] for s in (a, b, c))
    assert ra == rb and ra != rc
    # every seed sends the same set of sizes, in another order
    sizes = lambda r: sorted(len(t.split()) for t in r[0])  # noqa: E731
    assert sizes(ra) == sizes(rc)


def test_p95_counts_every_request():
    ctx = {"latencies_s": [0.001 * i for i in range(1, 101)]}
    assert metrics.p95(ctx["latencies_s"]) == pytest.approx(0.095)
    reader = Registry().metric("latency_p95_ms")
    assert reader.read(ctx) == pytest.approx(95.0)
    # one stall among 20 requests is the 5% above the 95th percentile
    lat = [0.01] * 19 + [1.0]
    assert metrics.p95(lat) == 0.01
    assert metrics.p95(lat + [1.0]) == 1.0


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "densephrases_tpu_torch_x", sys)
    assert "densephrases_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "densephrases_tpu.models", sys)
    assert run.forbidden_modules() == ["densephrases_tpu.models"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch\n"
            "from portbench import run, check, readings, trace, inputs\n"
            "from portbench.registry import Registry\n"
            "r = Registry()\n"
            "for w in r.spec['workloads']:\n"
            "    r.plan(w['name'])\n"
            "import densephrases_tpu_torch.serve.fused\n"
            "import densephrases_tpu_torch.model\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_harness_file_imports_jax_or_the_jax_package():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                         r"densephrases_tpu)(\.|\s|$)", re.M)
    port = re.compile(r"^\s*(import|from)\s+densephrases_tpu_torch", re.M)
    for path in (REPO / "portbench").rglob("*.py"):
        text = path.read_text()
        assert pattern.search(text) is None, path
        if "reference" in path.parts:
            assert port.search(text) is None, path


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_without_a_card_the_run_fails_and_prints_nothing(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cwd = REPO
    if where == "alone":  # BENCHMARK.json and the harness, no port
        import shutil

        cwd = tmp_path
        shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                        ignore=shutil.ignore_patterns(".cache",
                                                      "__pycache__"))
        shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        spec["command"] + ["--workload", spec["workloads"][0]["name"],
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
