"""The port's serve benchmark (``densephrases_tpu_torch/bench.py``) against
the repository's root ``bench.py``, on the CPU at a small size: the store
recipe, the numpy CPU baseline's scan, the fused server of both packages on
one bench-recipe store and one set of weights, the JSON line's keys, the
vocab without ``tokenizers``, and ``utils/profiling.trace``."""

import ast
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import DocMeta as JaxDocMeta
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.index.store import StoreWriter as JaxStoreWriter
from densephrases_tpu.model import DensePhrases as JaxDensePhrases
from densephrases_tpu.models.bert import BertConfig as JaxBertConfig
from densephrases_tpu.models.encoder import init_encoder_params as jax_init
from densephrases_tpu.serve.fused import FusedServer as JaxFusedServer
from densephrases_tpu_torch import bench
from densephrases_tpu_torch.data.tokenization import build_vocab
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.from_jax import encoder_from_jax
from densephrases_tpu_torch.serve.fused import FusedServer
from densephrases_tpu_torch.utils.profiling import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both packages' towers multiply in bf16: their query vectors differ by up
# to a bf16 ulp (test_torch_bert.py::test_embed_query_matches_bf16), which
# moves a span's score by up to ~1% here; chip_smoke.py's kernel-vs-plain
# serve tolerance
SCORE_RTOL = 2e-2
TINY_FLAGS = ["--config", "tiny", "--n_docs", "24", "--vecs_per_doc", "20",
              "--vocab_kind", "whole_word"]


def _reference_keys():
    """(top-level keys, stages_ms keys, windows_s keys) of the JSON line
    the root bench.py prints, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            top = node.args[0]
            keys = [k.value for k in top.keys]
            nested = {k.value: {kk.value for kk in v.keys}
                      for k, v in zip(top.keys, top.values)
                      if isinstance(v, ast.Dict)}
            return set(keys), nested["stages_ms"], nested["windows_s"]
    raise AssertionError("bench.py prints no JSON dict")


def _reference_store(path, n_docs, vecs_per_doc, d):
    """bench.py:126-145 with the JAX package's writer."""
    rng = np.random.default_rng(0)
    writer = JaxStoreWriter(path, d)
    w2cs = np.arange(vecs_per_doc, dtype=np.int32) * 5
    w2ce = w2cs + 4
    f2o = np.arange(vecs_per_doc, dtype=np.int32)
    ctx = " ".join(["word"] * (vecs_per_doc + 2))
    block = 500
    for b0 in range(0, n_docs, block):
        blk = rng.integers(-60, 61, (block * vecs_per_doc, d), dtype=np.int8)
        for j in range(block):
            writer.add_doc(
                JaxDocMeta(doc_id=b0 + j, title=f"doc{b0 + j}", context=ctx,
                           word2char_start=w2cs, word2char_end=w2ce,
                           f2o_start=f2o),
                blk[j * vecs_per_doc:(j + 1) * vecs_per_doc])
    return writer.finalize()


def test_build_store_follows_the_reference_recipe(tmp_path):
    ref = _reference_store(str(tmp_path / "ref"), 500, 12, 32)
    port = bench.build_store(str(tmp_path / "port"), 500, 12, 32)
    np.testing.assert_array_equal(np.asarray(port.vecs), np.asarray(ref.vecs))
    np.testing.assert_array_equal(port.doc_bases, ref.doc_bases)
    np.testing.assert_array_equal(port.doc_ids, ref.doc_ids)
    assert port.metas == ref.metas  # compressed records, byte for byte
    assert (port.offset, port.scale) == (ref.offset, ref.scale)
    for name in ("vecs.int8", "meta.pkls"):
        assert open(tmp_path / "port" / name, "rb").read() == \
            open(tmp_path / "ref" / name, "rb").read(), name


def test_cpu_mips_topk_is_the_exact_top_k():
    rng = np.random.default_rng(3)
    codes = rng.integers(-60, 61, (1000, 48), dtype=np.int8)
    # bf16-representable queries: the flat index rounds its queries to bf16
    q = torch.as_tensor(bench.baseline_queries(rng, 5, 48)).to(
        torch.bfloat16).float().numpy()
    scores, ids = bench.cpu_mips_topk(codes, q, 10, -2.0, 20.0, chunk=96)
    exact = q @ (codes.astype(np.float32) / 20.0).T + q.sum(1)[:, None] * -2.0
    want = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(scores, np.take_along_axis(exact, want, 1),
                               rtol=1e-6)
    _, flat_ids = FlatIndex(codes, chunk=128, device="cpu").search(
        q, top_k=10)
    np.testing.assert_array_equal(ids, flat_ids)
    assert ids.dtype == np.int64 and scores.dtype == np.float32


def test_cpu_mips_qps_is_positive():
    codes = np.random.default_rng(4).integers(-60, 61, (500, 16),
                                              dtype=np.int8)
    assert bench.cpu_mips_qps(codes, 4, 10, -2.0, 20.0) > 0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each package's fused server over one bench-recipe store of 8 docs,
    BertConfig.tiny towers with the JAX weights converted by from_jax,
    bf16 serving, a whole-word vocab that tells the bench queries apart."""
    path = str(tmp_path_factory.mktemp("bench") / "store")
    bench.build_store(path, 8, 100, 64)
    queries = bench.bench_queries(8)
    tok = build_vocab(queries, vocab_size=64, kind="whole_word")
    jcfg = JaxBertConfig.tiny(vocab_size=tok.vocab_size)
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = encoder_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    jmodel = JaxDensePhrases(jparams, jcfg, JaxTokenizer(tok.vocab),
                             JaxMIPS(JaxPhraseStore.load(path)),
                             max_query_length=bench.MAX_QUERY_LENGTH,
                             serve_dtype="bf16")
    model = DensePhrases(params, cfg, tok,
                         MIPS(PhraseStore.load(path), device="cpu"),
                         max_query_length=bench.MAX_QUERY_LENGTH,
                         serve_dtype="bf16")
    return {"queries": queries, "jax": JaxFusedServer(jmodel),
            "port": FusedServer(model), "model": model}


def _spans(outs):
    return [[(r["doc_idx"], r["start_idx"], r["end_idx"]) for r in ret]
            for ret in outs]


def _same_up_to_near_ties(got, want, rtol):
    """One query's served answers against the reference's: the same top
    span, the scores rank by rank within ``rtol``, and the same spans but
    where two spans within ``rtol`` of each other trade places, or one
    within ``rtol`` of the last kept score trades with one past it."""
    gs, ws = _spans([got])[0], _spans([want])[0]
    g_sc = np.array([r["score"] for r in got])
    w_sc = np.array([r["score"] for r in want])
    assert len(gs) == len(ws) and gs[0] == ws[0]
    np.testing.assert_allclose(g_sc, w_sc, rtol=rtol)
    edge = w_sc[-1] * (1 + rtol) if w_sc[-1] > 0 else w_sc[-1] * (1 - rtol)
    for span in set(gs) ^ set(ws):
        score = (g_sc[gs.index(span)] if span in gs
                 else w_sc[ws.index(span)])
        assert score <= edge, (span, score, w_sc[-1])
    return gs == ws


def test_fused_server_matches_the_reference(served):
    queries = served["queries"]
    want = served["jax"].search(queries, top_k=bench.TOP_K, aggregate=True)
    got = served["port"].search(queries, top_k=bench.TOP_K, aggregate=True)
    assert len({tuple(s) for s in _spans(got)}) > 1  # the queries differ
    exact = [_same_up_to_near_ties(g, w, SCORE_RTOL)
             for g, w in zip(got, want)]
    assert sum(exact) >= len(queries) // 2  # most agree span for span
    for g, w in zip(got, want):
        assert g[0]["answer"] == w[0]["answer"]


def test_modes_serve_the_same_answers(served):
    fused, queries = served["port"], served["queries"]
    sync = bench.one_batch(fused, queries)
    _, out = served["model"].search(queries, retrieval_unit="phrase",
                                    top_k=bench.TOP_K, return_meta=True)
    assert _spans([r[:bench.TOP_K] for r in sync]) == _spans(out)
    for depth in (2, 4):
        outs = fused.search_pipelined([queries] * 3, depth=depth,
                                      top_k=bench.TOP_K, aggregate=True)
        assert [_spans(o) for o in outs] == [_spans(sync)] * 3


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One ``main`` run at a tiny size (one batch a window, one timed call
    a stage, one warm-up batch; N_WINDOWS windows a mode as always) that
    keeps its store, traces its windows and counts the batches through the
    towers; with its standard output."""
    from densephrases_tpu_torch import model as model_mod

    tmp = tmp_path_factory.mktemp("tiny_run")
    calls = []
    real = model_mod.DensePhrases.encode
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("N_BATCHES", "N_STAGE", "WARMUP"):
            mp.setattr(bench, name, 1)
        mp.setenv("DPH_TRACE_DIR", str(tmp / "trace"))
        mp.setattr(model_mod.DensePhrases, "encode",
                   lambda self, q: calls.append(1) or real(self, q))
        with contextlib.redirect_stdout(out):
            res = bench.main(TINY_FLAGS + ["--store_dir", str(tmp)],
                             device="cpu")
        towered = bench.towered_batches()
    return {"res": res, "lines": out.getvalue().strip().splitlines(),
            "encodes": len(calls), "towered": towered, "tmp": tmp}


def test_main_prints_the_reference_keys(tiny_run):
    res, lines = tiny_run["res"], tiny_run["lines"]
    assert len(lines) == 1 and json.loads(lines[0]) == res
    top, stages, windows = _reference_keys()
    assert set(res) == top
    assert set(res["stages_ms"]) == stages - {"dispatch_floor"}
    assert set(res["windows_s"]) == windows
    assert all(len(w) == bench.N_WINDOWS for w in res["windows_s"].values())
    assert res["value"] == max(res[f"value_{m}"] for m in windows)
    assert res["value"] == res[f"value_{res['mode']}"]
    assert res["unit"] == "q/s" and res["baseline"] > 0
    for key in ("value", "vs_baseline", "mips_init_s", "setup_s"):
        assert res[key] > 0, key
    assert all(v > 0 for v in res["stages_ms"].values())


def test_main_traces_the_windows(tiny_run):
    assert glob.glob(str(tiny_run["tmp"] / "trace" / "*.pt.trace.json"))


def test_main_keeps_the_store_it_is_given(tiny_run):
    store = PhraseStore.load(str(tiny_run["tmp"] / "store"))
    assert store.num_docs == 24 and store.vecs.shape == (24 * 20, 64)


def test_towered_batches_counts_every_encode(tiny_run):
    # kernel A launches twice a layer for each batch through the towers
    assert tiny_run["encodes"] == tiny_run["towered"] == 1 + 1 + 2 * 2 + 15


def test_wordpiece_vocab_raises_without_tokenizers(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError):
        bench.main(TINY_FLAGS + ["--vocab_kind", "wordpiece",
                                 "--store_dir", str(tmp_path)], device="cpu")
    assert not os.listdir(tmp_path)  # raised before writing a store
    assert bench.parse_args([]).vocab_kind == "wordpiece"


def test_trace_writes_a_trace_file(tmp_path):
    with trace(None):  # no directory: nothing is traced
        pass
    with trace(str(tmp_path)):
        torch.ones(4, 4).sum()
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))


def test_bench_leaves_jax_out():
    code = ("import sys\nimport densephrases_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'densephrases_tpu' or m.startswith('densephrases_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
