"""The port's tracer (``utils/profiling.py``) on the serve path, on the CPU
at a tiny size: answers bitwise equal with tracing on and off, the spans
of a request nested under one ``serve.request``, pipelined batches kept
apart, the IVF work counters against a numpy recount from the probe ids,
the token counters against the masks, the no-op while off, and the spans
written into ``trace``'s Chrome trace on its clock."""

import glob
import inspect
import json
import threading

import numpy as np
import pytest
import torch

from densephrases_tpu_torch import bench
from densephrases_tpu_torch.data.features import convert_questions_to_features
from densephrases_tpu_torch.index import flat as flat_mod
from densephrases_tpu_torch.index import ivf as ivf_mod
from densephrases_tpu_torch.index import search as search_mod
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.ops import ivf_pack
from densephrases_tpu_torch.serve import fused as fused_mod
from densephrases_tpu_torch.utils import profiling

QUERY_LEN = 16
TEXTS = [" ".join(["benchmark", "query", "words"][: 1 + i % 3] * (1 + i))
         for i in range(6)]
TOWERS = {"towers.tokenize", "towers.upload", "towers.forward"}
AFTER = {"index.rescore", "serve.copy", "serve.wait", "index.assemble",
         "index.aggregate"}
FLAT_SPANS = ({"serve.request", "index.search_dense", "index.flat.scan"}
              | TOWERS | AFTER)
IVF_SPANS = ({"serve.request", "index.search_dense", "index.ivf.probe",
              "index.ivf.block_table", "index.ivf.scan", "index.ivf.select",
              "index.ivf.refine"} | TOWERS | AFTER)
# MIPS's one device→host hand-off opens each of these once a request, on
# the fused and the modular route alike
ONCE = ("serve.copy", "serve.wait", "index.assemble", "index.aggregate")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny flat store served by ``FusedServer``, and the same store and
    towers over an OPQ IVF index with the int8 refine through
    ``DensePhrases``."""
    root = tmp_path_factory.mktemp("tracing")
    store = bench.build_store(str(root / "store"), n_docs=30,
                              vecs_per_doc=20, d=64)
    config = BertConfig.tiny()
    tok = bench.bench_vocab("whole_word")
    flat_model, fused, _ = bench.serve_model(store, config, tok,
                                             device="cpu")
    flat_model.max_query_length = QUERY_LEN
    ivf = IVFIndex.build(np.asarray(store.vecs), IVFConfig(
        num_clusters=12, fine_quant="OPQ16", kmeans_iters=3, pq_iters=2,
        opq_iters=1, refine_factor=4), device="cpu")
    ivf_model = DensePhrases(flat_model.params, config, tok,
                             MIPS(store, index=ivf),
                             max_query_length=QUERY_LEN)
    return {"fused": fused, "flat_model": flat_model, "ivf": ivf,
            "ivf_model": ivf_model, "tok": tok}


def _ivf_search(served):
    return served["ivf_model"].search(TEXTS, top_k=5, return_meta=True)


def _flat_search(served):
    return served["fused"].search(TEXTS, top_k=5)


def _pipelined(served):
    batches = [TEXTS[:2], TEXTS[2:4], TEXTS[4:]]
    return served["fused"].search_pipelined(batches, depth=2, top_k=5)


@pytest.mark.parametrize("call", [_flat_search, _pipelined, _ivf_search])
def test_answers_equal_with_tracing_on_and_off(served, call):
    off = call(served)
    with profiling.recording() as rec:
        on = call(served)
    assert rec.spans()
    assert on == off


def _by_id(spans):
    return {s.id: s for s in spans}


def _roots(spans):
    """Each span's chain of ancestors' names, innermost first."""
    ids = _by_id(spans)
    out = {}
    for s in spans:
        chain, p = [], s.parent
        while p is not None:
            chain.append(ids[p].name)
            p = ids[p].parent
        out[s.id] = chain
    return out


def _check_nesting(spans):
    """Every span but a root ``serve.request`` has exactly one
    ``serve.request`` among its ancestors and carries its request id."""
    ids = _by_id(spans)
    for s in spans:
        if s.name == "serve.request":
            assert s.parent is None and s.request is not None
            continue
        p, roots = s.parent, []
        while p is not None:
            if ids[p].name == "serve.request":
                roots.append(ids[p])
            p = ids[p].parent
        assert len(roots) == 1, s
        assert s.request == roots[0].request
        parent = ids[s.parent]
        assert parent.start <= s.start <= s.end <= parent.end


def test_flat_spans_nest_under_one_request(served):
    with profiling.recording() as rec:
        _flat_search(served)
    spans = rec.spans()
    assert {s.name for s in spans} == FLAT_SPANS
    names = [s.name for s in spans]
    assert names.count("serve.request") == 1
    for name in ONCE:
        assert names.count(name) == 1, name
    _check_nesting(spans)
    chains = _roots(spans)
    scan = next(s for s in spans if s.name == "index.flat.scan")
    assert chains[scan.id] == ["index.search_dense", "serve.request"]
    rows = served["fused"].mips.index.codes.shape[0]
    chunk = served["fused"].chunk
    assert rec.counters()["index.flat.chunks"] == -(-rows // chunk)


def test_pipelined_batches_keep_their_requests_apart(served):
    with profiling.recording() as rec:
        _pipelined(served)
    spans = rec.spans()
    _check_nesting(spans)
    roots = [s for s in spans if s.name == "serve.request"]
    rids = sorted({s.request for s in roots})
    assert len(rids) == 3
    # submit and collect each open the batch's root span
    assert sorted(s.request for s in roots) == sorted(rids * 2)
    for rid in rids:
        names = [s.name for s in spans if s.request == rid]
        assert set(names) == FLAT_SPANS
        for name in ONCE:
            assert names.count(name) == 1, (rid, name)


def test_ivf_spans_nest_under_one_request(served):
    with profiling.recording() as rec:
        _ivf_search(served)
    spans = rec.spans()
    assert {s.name for s in spans} == IVF_SPANS
    names = [s.name for s in spans]
    for name in ONCE:
        assert names.count(name) == 1, name
    _check_nesting(spans)
    chains = _roots(spans)
    for s in spans:
        if s.name.startswith("index.ivf."):
            assert "index.search_dense" in chains[s.id]


def test_pack_round_trips_floats_and_ints():
    """``_pack`` bit-casts floats and narrows integers into one int32
    buffer; ``_unpack`` on its host copy gives each value back."""
    g = torch.Generator().manual_seed(0)
    parts = {"f32": torch.randn(3, 4, generator=g),
             "bf16": torch.randn(2, 5, generator=g).to(torch.bfloat16),
             "i64": torch.randint(-2**31, 2**31, (3, 2), generator=g),
             "i32": torch.randint(-9, 9, (4,), generator=g,
                                  dtype=torch.int32),
             "empty": torch.zeros(0, 3)}
    buf, layout = search_mod._pack(parts)
    assert buf.dtype == torch.int32
    assert buf.numel() == sum(t.numel() for t in parts.values())
    got = search_mod._unpack(buf.numpy(), layout)
    assert list(got) == list(parts)
    for key, t in parts.items():
        want = (t.to(torch.float32) if t.is_floating_point()
                else t.to(torch.int32)).numpy()
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        assert np.array_equal(got[key], want), key


def test_send_hands_the_cpu_buffer_over_and_counts_its_bytes(served):
    """On the CPU ``_send`` copies nothing and records no event; it counts
    the bundle's bytes, and ``_receive`` assembles from the buffer."""
    mips = served["fused"].mips
    query = served["flat_model"].query2vec(TEXTS)
    hits = mips.search_dense(query, top_k=5)
    buf, layout = mips.rescore(query, *hits)
    with profiling.recording() as rec:
        handle = mips._send(buf, layout)
    assert handle["buf"] is buf and handle["done"] is None
    assert rec.counters() == {"serve.d2h_bytes": 4 * buf.numel()}
    assert len(mips._receive(handle)) == len(TEXTS)


@pytest.mark.parametrize("route", ["flat", "ivf"])
def test_search_phrase_is_rescore_send_receive(served, route):
    """``search_phrase`` on a device index gives what the fused route's
    two halves give for the same hits."""
    model = served["flat_model" if route == "flat" else "ivf_model"]
    mips = model.mips
    query = model.query2vec(TEXTS)
    hits = mips.search_dense(query, top_k=5)
    whole = mips.search_phrase(query, *hits, return_sent=True)
    halves = mips._receive(mips._send(*mips.rescore(query, *hits)),
                           return_sent=True)
    assert whole == halves
    assert mips._aggregate(whole, TEXTS, 5, "opt1") == [
        mips.aggregate_results(r, 5, q, "opt1") for r, q in zip(halves, TEXTS)]


def _recount(ivf, stacked, nprobe):
    """numpy: (lists_unique, rows_scored, rows_own) of a union scan from
    the probe ids alone."""
    ids = ivf_pack.probe(stacked, ivf.centroids, nprobe).numpy()
    offs = ivf.list_offsets.numpy()
    lens = np.minimum(np.diff(offs), ivf.cap)
    own = int(lens[ids].sum())
    blocks = set()
    for lst in np.unique(ids):
        lo = offs[lst] // ivf_pack.RB
        hi = -(-(offs[lst] + lens[lst]) // ivf_pack.RB)
        blocks.update(range(lo, hi))
    valid = sum(min(ivf_pack.RB, max(ivf.n_real - b * ivf_pack.RB, 0))
                for b in blocks)
    return len(np.unique(ids)), ids.shape[0] * valid, own


@pytest.mark.parametrize("nprobe", [3, 256])
def test_ivf_counters_equal_a_numpy_recount(served, nprobe):
    model, ivf = served["ivf_model"], served["ivf"]
    q = model.query2vec(TEXTS)
    qs, qe = q.chunk(2, dim=1)
    stacked = torch.cat([qs, qe], 0)
    with profiling.recording() as rec:
        if nprobe == 256:  # DensePhrases.search probes MIPS's default
            _ivf_search(served)
        else:
            model.mips.search(q, top_k=5, nprobe=nprobe)
    got = rec.counters()
    unique, scored, own = _recount(ivf, stacked, min(nprobe, ivf.nlist))
    assert got["index.ivf.lists_unique"] == unique
    assert got["index.ivf.rows_scored"] == scored
    assert got["index.ivf.rows_own"] == own
    assert 0 < own <= scored
    if nprobe >= ivf.nlist:  # every list probed: every row is useful
        assert own == scored == stacked.shape[0] * ivf.n_real
    # refine: 2B query rows of top_k x refine_factor candidates
    assert got["index.ivf.candidates_refined"] == stacked.shape[0] * 5 * 4
    assert got["serve.d2h_bytes"] > 0


def test_token_counters_equal_the_masks(served):
    feats = convert_questions_to_features(TEXTS, served["tok"], QUERY_LEN)
    mask = np.stack([f.attention_mask for f in feats])
    with profiling.recording() as rec:
        _flat_search(served)
    got = rec.counters()
    assert got["towers.tokens_real"] == int(mask.sum())
    assert got["towers.tokens_padded"] == mask.size == len(TEXTS) * QUERY_LEN
    assert got["towers.tokens_real"] < got["towers.tokens_padded"]


def test_tracing_off_records_nothing(served):
    assert not profiling.active()
    assert profiling.span("a") is profiling.span("b", x=1)
    assert profiling.request() is profiling.span("c")
    rec = profiling.enable()
    assert profiling.disable() is rec
    _flat_search(served)
    _ivf_search(served)
    profiling.count("x", 3)
    assert rec.spans() == [] and rec.counters() == {}
    assert profiling.current_request() is None


def test_spans_keep_their_attributes():
    with profiling.recording() as rec:
        with profiling.span("index.flat.scan", rows=3):
            pass
    (got,) = rec.spans()
    assert got.attrs == {"rows": 3} and got.request is None


def test_counters_sum_host_ints_and_device_scalars():
    with profiling.recording() as rec:
        profiling.count("n", 2)
        profiling.count("n", torch.tensor(5))
        profiling.count("m", torch.tensor(7, dtype=torch.int64).sum())
    assert rec.counters() == {"n": 7, "m": 7}


def test_threads_nest_their_own_spans():
    def work(tag):
        with profiling.request():
            with profiling.span(f"inner.{tag}"):
                pass

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    spans = rec.spans()
    _check_nesting(spans)
    assert len({s.request for s in spans}) == 4
    assert len({s.thread for s in spans}) == 4


def test_serve_path_calls_no_record_function():
    for mod in (fused_mod, search_mod, flat_mod, ivf_mod, ivf_pack):
        assert "record_function" not in inspect.getsource(mod), mod
    assert not hasattr(profiling, "StageTimer")


def test_trace_writes_the_spans_on_the_trace_clock(served, tmp_path):
    with profiling.trace(str(tmp_path)):
        _flat_search(served)
    assert not profiling.active()  # on for the block only
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "densephrases"]
    assert {e["name"] for e in spans} == FLAT_SPANS
    assert all(e["pid"] == profiling.SPAN_PID for e in spans)
    assert doc["densephrasesCounters"]["towers.tokens_padded"] == \
        len(TEXTS) * QUERY_LEN
    # on the trace's clock: the towers' span holds the host ops of the
    # towers' matmuls, and the whole request lies after the mark
    mark = next(e for e in events if e["name"] == profiling.MARK)
    fwd = next(e for e in spans if e["name"] == "towers.forward")
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::linear", "aten::matmul", "aten::addmm")]
    inside = [e for e in ops
              if fwd["ts"] <= e["ts"] <= fwd["ts"] + fwd["dur"]]
    assert inside and len(inside) >= len(ops) // 2
    assert min(e["ts"] for e in spans) >= mark["ts"]
