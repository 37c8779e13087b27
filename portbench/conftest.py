"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need a CUDA card carry the ``card`` marker
and take the ``cuda_device`` fixture, which skips them where there is no
card; the decision is made in the fixture, never while a module is
imported."""

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the "
        "card with `python3 -m pytest portbench/tests -m card`")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


TINY_MODEL = {"vocab_size": 600, "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 128}


def make_tiny_root(tmp_path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and the harness's data
    files) whose configurations are cut to a size the CPU runs in seconds:
    a 2-layer, 64-wide tower, a 600-word vocab, 1,000 corpus rows (IVF:
    in 24 lists, 8 sub-quantizers)."""
    root = Path(tmp_path) / "bench"
    shutil.copytree(PKG, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(PKG.parent / "BENCHMARK.json", root)
    for path in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"].update(TINY_MODEL)
        cfg["vocab"]["size"] = TINY_MODEL["vocab_size"]
        # the weights' spread times the root of the width as at full size
        # (0.05 at 768), so that the tiny towers mix a query's tokens as
        # much and distinct queries get distinct answers
        cfg["weights"]["std"] = 0.15
        cfg["index"].update(dim=TINY_MODEL["hidden_size"], n_docs=50,
                            vecs_per_doc=20)
        if cfg["index"]["kind"] == "ivf":
            cfg["index"].update(n_rows=1000, nlist=24, m=8, pq_sample=512,
                                pq_iters=2)
        path.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
