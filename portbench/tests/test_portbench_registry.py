"""Finding a cell's parts by name, and adding a cell, a configuration and a
metric as new files and new entries only."""

import hashlib
import json
import shutil

import pytest

from portbench.registry import Registry


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_every_cell_and_metric_resolves():
    reg = Registry()
    for cell in reg.spec["workloads"]:
        plan = reg.plan(cell["name"])
        assert plan["config"]["name"] == cell["config"]
        assert plan["cell"]["limits"]
        assert "setup_s" in plan["end_to_end"]
        assert len(plan["end_to_end"]) >= 2 and plan["per_layer"]
        assert callable(plan["route"].Served)
        assert callable(plan["generator"].stream)
    for kind in ("end_to_end", "per_layer"):
        for m in reg.spec[kind]:
            reader = reg.metric(m["name"])
            assert reader.UNIT == m["unit"] and reader.BETTER == m["better"]
            if kind == "per_layer":
                assert reader.LAYER == m["layer"]
                assert reader.MOVES == m["moves"]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    reg = Registry()
    for m in reg.spec["per_layer"]:
        for cell in m["workloads"]:
            e2e = [x["name"] for x in reg.metrics(cell, "end_to_end")]
            assert m["moves"] in e2e


def test_new_cell_config_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "bench"
    src = Registry()
    shutil.copytree(src.pkg, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(src.root / "BENCHMARK.json", root)
    before = _digests(root / "portbench")
    pkg = root / "portbench"
    first = src.spec["workloads"][0]
    cfg = json.loads((pkg / "configs" / f"{first['config']}.json")
                     .read_text())
    cfg["name"] = "new-config"
    (pkg / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "traffic" / f"{first['traffic']}.json")
                     .read_text())
    mix["batch"] = 32
    (pkg / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (pkg / "workloads" / "new-config.new-mix.json").write_text(json.dumps(
        {"config": "new-config", "traffic": "new-mix",
         "limits": {"score_gap": 1.0, "rank_gap": 1.0}}))
    (pkg / "metrics" / "towers_calls.b32.py").write_text(
        'UNIT = "1"\nBETTER = "lower"\nLAYER = "query towers"\n'
        'MOVES = "qps"\n\n\ndef read(ctx):\n    return 2.0\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="new-config",
                                file="portbench/configs/new-config.json"))
    spec["workloads"].append({"name": "new-config.new-mix",
                              "config": "new-config", "traffic": "new-mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "towers_calls.b32", "unit": "1",
                              "better": "lower", "source": "program_span",
                              "layer": "query towers", "moves": "qps",
                              "workloads": ["new-config.new-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(root, pkg)
    plan = reg.plan("new-config.new-mix")
    assert plan["traffic"]["batch"] == 32
    assert plan["config"]["name"] == "new-config"
    assert plan["per_layer"]["towers_calls.b32"].read({}) == 2.0
    assert "towers_calls.b32" not in reg.plan(first["name"])["per_layer"]
    # the batch-64 metrics are read only where the traffic sends 64
    assert "towers_ms.b64" not in plan["per_layer"]
    assert "towers_ms.b64" in reg.plan(first["name"])["per_layer"]
    after = _digests(pkg)
    assert all(after[p] == d for p, d in before.items())


def test_cell_file_must_agree_with_benchmark(tmp_path):
    root = tmp_path / "bench"
    src = Registry()
    shutil.copytree(src.pkg, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(src.root / "BENCHMARK.json", root)
    name = src.spec["workloads"][0]["name"]
    path = root / "portbench" / "workloads" / f"{name}.json"
    cell = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cell, traffic="other")))
    with pytest.raises(ValueError, match="traffic"):
        Registry(root, root / "portbench").cell(name)


def test_a_new_cell_reports_the_existing_metrics(tiny_root, monkeypatch):
    """A cell added as a new traffic file, a new cell file and a new entry
    under ``workloads`` reports the per-layer metrics there are, with no
    existing file or entry edited."""
    from portbench import run
    from portbench.tests.test_portbench_run import tiny_run

    # the first request profiled, the later ones timed by spans
    monkeypatch.setattr(run, "TRACE_S", 0.0)
    pkg = tiny_root / "portbench"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    first = spec["workloads"][0]
    old_entries = json.dumps({k: spec[k] for k in ("configs", "end_to_end",
                                                   "per_layer")})
    before = _digests(pkg)
    mix = json.loads((pkg / "traffic" / f"{first['traffic']}.json")
                     .read_text())
    mix["words"] = [5, 12]
    (pkg / "traffic" / "short-b64.json").write_text(json.dumps(mix))
    cell = json.loads((pkg / "workloads" / f"{first['name']}.json")
                      .read_text())
    name = f"{first['config']}.short-b64"
    (pkg / "workloads" / f"{name}.json").write_text(json.dumps(
        dict(cell, traffic="short-b64")))
    spec["workloads"].append({"name": name, "config": first["config"],
                              "traffic": "short-b64", "chips": 1,
                              "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    line, _ = tiny_run(tiny_root, name, trace=True, seconds=3.0)
    assert line["correct"] is True
    # the CPU trace has no device events: the host-clock spans read
    assert {"towers_ms.b64", "search_ms.b64",
            "assemble_ms.b64"} <= set(line["metrics"])
    after = _digests(pkg)
    assert all(after[p] == d for p, d in before.items())
    assert json.dumps({k: spec[k] for k in ("configs", "end_to_end",
                                           "per_layer")}) == old_entries
