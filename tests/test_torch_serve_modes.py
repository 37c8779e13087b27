"""The port's serve modes against the JAX reference, on one store and on
indexes the reference built and saved: decode-mode PQ serving (a PQ / OPQ
index with no int8 refine), the host refine tier, the query rotation
(``MIPS.R``), ``vecs_on_device``, the int4 flat index, ``MIPS``'s other
constructor options, the reference's build parameters, and the mesh path
at one rank."""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import DocMeta as JaxDocMeta
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.index.store import StoreWriter as JaxStoreWriter
from densephrases_tpu.ops.kmeans import kmeans as jax_kmeans
from densephrases_tpu.ops.pq import unpack_nibbles_dev as jax_unpack_nibbles
from densephrases_tpu.ops.quant import float_to_int8, int8_to_float
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.ops.kmeans import kmeans
from densephrases_tpu_torch.ops.pq import unpack_nibbles_dev
from densephrases_tpu_torch.parallel import make_mesh

DIM, NLIST = 64, 32
# span scores are O(10) sums of bf16-rounded products (stage 1: the bf16
# LUT or bf16 queries) taken in another order (tests/test_torch_ivf.py)
SCORE_ATOL = 1e-3
# candidate vectors: the same fp32 book rows, centroids rotated by an fp32
# product in another order
VEC_ATOL = 1e-4
# saved by the reference: (fine_quant, refine_factor)
VARIANTS = {"OPQ16": ("OPQ16", 1), "OPQ32x4": ("OPQ32x4", 1),
            "PQ16": ("PQ16", 1), "OPQ16-refine": ("OPQ16", 4),
            "SQ8": ("SQ8", 4)}


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """The reference's MIPS test store (tests/test_mips_ivf.py::_store):
    40 docs of 50 clustered vectors, so IVF probing works."""
    path = tmp_path_factory.mktemp("serve_modes") / "store"
    rng = np.random.default_rng(0)
    writer = JaxStoreWriter(str(path), DIM)
    centers = rng.normal(-2, 1.0, (24, DIM)).astype(np.float32)
    for d in range(40):
        vecs = (centers[rng.integers(0, 24, 50)]
                + 0.25 * rng.normal(size=(50, DIM))).astype(np.float32)
        writer.add_doc(
            JaxDocMeta(doc_id=d, title=f"doc{d}",
                       context=" ".join(["tok"] * 52),
                       word2char_start=np.arange(50, dtype=np.int32) * 4,
                       word2char_end=np.arange(50, dtype=np.int32) * 4 + 3,
                       f2o_start=np.arange(50, dtype=np.int32)),
            float_to_int8(vecs))
    writer.finalize()
    return str(path)


@pytest.fixture(scope="module")
def stores(store_path):
    return JaxPhraseStore.load(store_path), PhraseStore.load(store_path)


@pytest.fixture(scope="module")
def saves(store_path, tmp_path_factory):
    """Each variant built and saved by the reference (lazily)."""
    root = tmp_path_factory.mktemp("serve_mode_saves")
    vecs = np.asarray(JaxPhraseStore.load(store_path).vecs)
    done = {}

    def get(name):
        if name not in done:
            fq, rf = VARIANTS[name]
            JaxIVFIndex.build(vecs, JaxIVFConfig(
                num_clusters=NLIST, fine_quant=fq, kmeans_iters=5,
                pq_iters=3, opq_iters=2, refine_factor=rf)).save(
                str(root / name))
            done[name] = str(root / name)
        return done[name]
    return get


def _queries(store, n=8, seed=1):
    """Queries near stored spans (tests/test_mips_ivf.py::_queries)."""
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        b0 = int(store.doc_bases[int(rng.integers(0, store.num_docs))])
        s = int(rng.integers(0, 40))
        qs.append(np.concatenate([
            int8_to_float(np.asarray(store.vecs[b0 + s])),
            int8_to_float(np.asarray(store.vecs[b0 + s + 2]))]))
    return np.stack(qs).astype(np.float32)


def _spans(results):
    """{(doc, start, end, candidate column): score} of one query's results."""
    return {(r["doc_idx"], r["start_idx"], r["end_idx"], r["cand_col"]):
            r["score"] for r in results}


def _same_spans(ref, out, atol=SCORE_ATOL):
    for r, o in zip(ref, out):
        rs, os_ = _spans(r), _spans(o)
        assert rs.keys() == os_.keys()
        np.testing.assert_allclose([os_[k] for k in rs], list(rs.values()),
                                   atol=atol)


def _vecs(results):
    """{span key: (start_vec, end_vec)} of one query's results."""
    return {(r["doc_idx"], r["start_idx"], r["end_idx"], r["cand_col"]):
            (np.asarray(r["start_vec"]), np.asarray(r["end_vec"]))
            for r in results}


def _same_vecs(ref, out):
    for r, o in zip(ref, out):
        rv, ov = _vecs(r), _vecs(o)
        assert rv.keys() == ov.keys()
        for k in rv:
            np.testing.assert_allclose(ov[k][0], rv[k][0], atol=VEC_ATOL)
            np.testing.assert_allclose(ov[k][1], rv[k][1], atol=VEC_ATOL)


# ----------------------------------------------------------- decode mode
@pytest.mark.parametrize("name", ["OPQ16", "OPQ32x4", "PQ16"])
def test_decode_mode_matches_reference(stores, saves, name):
    # ref tests/test_mips_ivf.py:123-146, on one saved index in both
    jstore, pstore = stores
    jm = JaxMIPS(jstore, index=JaxIVFIndex.load(saves(name)))
    pm = MIPS(pstore, index=IVFIndex.load(saves(name), device="cpu"))
    # no corpus-sized int8 tensor on the device (ref :139)
    assert jm.vecs_dev is None and pm.vecs_dev is None
    assert pm.pq_serve is not None and pm.index.refine_codes is None
    assert set(pm.init_stages) == set(jm.init_stages)
    assert pm.init_stages["pq_compacted"] is False
    ps, js = pm.pq_serve, jm.pq_serve
    np.testing.assert_array_equal(ps["inv_perm"].numpy(),
                                  np.asarray(js["inv_perm"]))
    np.testing.assert_array_equal(ps["row_list"].numpy(),
                                  np.asarray(js["row_list"]))
    np.testing.assert_allclose(ps["c_rot"].numpy(), np.asarray(js["c_rot"]),
                               atol=1e-5)
    q = _queries(jstore)
    for nprobe in (4, NLIST):
        ref = jm.search(q, top_k=5, nprobe=nprobe)
        out = pm.search(q, top_k=5, nprobe=nprobe)
        _same_spans(ref, out)
        for ret in out:
            for r in ret:
                assert r["answer"] == r["context"][r["start_pos"]:r["end_pos"]]


def test_decode_mode_return_vecs(stores, saves):
    # ref tests/test_mips_ivf.py:149-165: q · v is the serve score, and the
    # vectors are the reference's
    jstore, pstore = stores
    jm = JaxMIPS(jstore, index=JaxIVFIndex.load(saves("OPQ16")))
    pm = MIPS(pstore, index=IVFIndex.load(saves("OPQ16"), device="cpu"))
    q = _queries(jstore, n=4)
    ref = jm.search(q, top_k=4, nprobe=NLIST, return_idxs=True)
    out = pm.search(q, top_k=4, nprobe=NLIST, return_idxs=True)
    _same_spans(ref, out)
    _same_vecs(ref, out)
    d = jstore.dim
    for b, ret in enumerate(out):
        for r in ret[:3]:
            got = float(q[b, :d] @ r["start_vec"] + q[b, d:] @ r["end_vec"])
            assert abs(got - r["score"]) < 0.75, (got, r["score"])


def test_refine_index_loaded_without_refine_decodes(stores, saves):
    jstore, pstore = stores
    path = saves("OPQ16-refine")
    jm = JaxMIPS(jstore, index=JaxIVFIndex.load(path, drop_refine=True))
    pm = MIPS(pstore, index=IVFIndex.load(path, refine_mode="none",
                                          device="cpu"))
    assert pm.vecs_dev is None and pm.pq_serve is not None
    q = _queries(jstore, seed=4)
    _same_spans(jm.search(q, top_k=5, nprobe=8),
                pm.search(q, top_k=5, nprobe=8))


def _legacy_copy(src, dst):
    """The save with its config pickled before ``pq_residual`` existed."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "ivf.pkl"), "rb") as f:
        extra = pickle.load(f)
    del extra["cfg"].__dict__["pq_residual"]
    with open(os.path.join(dst, "ivf.pkl"), "wb") as f:
        pickle.dump(extra, f)
    return dst


def test_decode_mode_adds_the_centroid_whatever_pq_residual(stores, saves,
                                                            tmp_path):
    # a fault of the reference (ROADMAP Queue 3), reproduced for parity: the
    # decode fetch adds the rotated centroid (ref search.py:99) even when
    # the scans do not (pq_residual False, ref ivf.py:386), so for a legacy
    # index the rescore scores another vector than stage 1 ranked
    jstore, pstore = stores
    legacy = _legacy_copy(saves("OPQ16"), str(tmp_path / "legacy"))
    d, k = pstore.dim, 4
    q = _queries(jstore, n=4, seed=5)
    gaps = {}
    for name, path in (("residual", saves("OPQ16")), ("legacy", legacy)):
        jm = JaxMIPS(jstore, index=JaxIVFIndex.load(path))
        pm = MIPS(pstore, index=IVFIndex.load(path, device="cpu"))
        assert pm.index.pq_residual == jm.index.pq_residual == (
            name == "residual")
        _same_spans(jm.search(q, top_k=k, nprobe=NLIST),
                    pm.search(q, top_k=k, nprobe=NLIST))
        s_gids, e_gids, s_scores, e_scores = pm.search_dense(
            q, top_k=k, nprobe=NLIST)
        outs = pm.search_phrase(q, s_gids, e_gids, s_scores, e_scores,
                                return_idxs=True)
        # q_s · c_rot of each start hit's own list, in the rotated space
        ps = pm.pq_serve
        lists = ps["row_list"][ps["inv_perm"][s_gids.long()].long()].long()
        q_rot = torch.from_numpy(q[:, :d]) @ pm.index.rotation
        qc = torch.einsum("bd,bkd->bk", q_rot, ps["c_rot"][lists]).numpy()
        # a start-anchored candidate's start vector is its anchor row:
        # q_s · v against the stage-1 score of that row
        gap, centroid_term = [], []
        for b, ret in enumerate(outs):
            for r in ret:
                if r["cand_col"] < k:
                    gap.append(float(q[b, :d] @ r["start_vec"])
                               - float(s_scores[b, r["cand_col"]]))
                    centroid_term.append(qc[b, r["cand_col"]])
        gaps[name] = (np.array(gap), np.array(centroid_term))
    # residual codes: the rescore's vector is the one stage 1 scored
    # (within the bf16 LUT's rounding); legacy codes: it is not, and the
    # gap is the centroid term the scan left out
    gap, _ = gaps["residual"]
    assert np.abs(gap).max() < 0.1, gap
    gap, centroid_term = gaps["legacy"]
    assert np.abs(gap).min() > 1.0, gap
    np.testing.assert_allclose(gap, centroid_term, atol=0.1)


# --------------------------------------------------------- host refine
def _bf16_bound(q, rows, scale):
    """The most that rounding q to bf16 moves q · row / scale."""
    return (2.0 ** -8) * (np.abs(q)[:, None, :] * np.abs(rows)).sum(-1) / scale


@pytest.mark.parametrize("nprobe", [4, NLIST])
def test_host_refine_matches_device_refine(stores, saves, nprobe):
    jstore, _ = stores
    path = saves("OPQ16-refine")
    host = IVFIndex.load(path, refine_mode="host", device="cpu")
    dev = IVFIndex.load(path, device="cpu")
    assert host.refine_codes is None and isinstance(host.refine_host,
                                                    np.memmap)
    q = np.concatenate(np.split(_queries(jstore, seed=6), 2, axis=1))
    hv, hi = host.search(q, top_k=10, nprobe=nprobe)
    # the reference's host refine: the same numpy re-rank of the same
    # candidates
    rv, ri = JaxIVFIndex.load(path, refine_mode="host").search(
        q, top_k=10, nprobe=nprobe)
    np.testing.assert_array_equal(hi, ri)
    np.testing.assert_allclose(hv, rv, atol=1e-5)
    # the device refine rounds the queries to bf16 and the host refine does
    # not: ids agree except between rows whose fp32 scores lie within the
    # two rows' bf16 bounds
    dv, di = dev.search(q, top_k=10, nprobe=nprobe)
    refine = np.asarray(jstore.vecs, np.float32)
    for b in range(q.shape[0]):
        for j in np.nonzero(hi[b] != di[b])[0]:
            pair = refine[[hi[b, j], di[b, j]]]
            exact = (pair @ q[b]) / jstore.scale
            tol = _bf16_bound(q[b:b + 1], pair[None], jstore.scale).sum()
            assert abs(exact[0] - exact[1]) <= tol + 1e-5, (b, j)
    assert (hi == di).mean() >= 0.9
    # as_numpy=False: the host refine's results come back as tensors
    tv, ti = host.search(q, top_k=10, nprobe=nprobe, as_numpy=False)
    assert isinstance(ti, torch.Tensor)
    np.testing.assert_array_equal(ti.numpy(), hi)


def test_host_refine_serves_in_decode_mode(stores, saves):
    jstore, pstore = stores
    path = saves("OPQ16-refine")
    jm = JaxMIPS(jstore, index=JaxIVFIndex.load(path, refine_mode="host"))
    pm = MIPS(pstore, index=IVFIndex.load(path, refine_mode="host",
                                          device="cpu"))
    assert jm.vecs_dev is None and pm.vecs_dev is None
    q = _queries(jstore, seed=7)
    _same_spans(jm.search(q, top_k=5, nprobe=8),
                pm.search(q, top_k=5, nprobe=8))


# ------------------------------------------------------------- rotation
def _rotation(seed=3):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.normal(size=(DIM, DIM)))[0].astype(np.float32)


@pytest.mark.parametrize("kind", ["flat", "SQ8", "OPQ16"])
def test_rotation_matches_reference(stores, saves, kind):
    jstore, pstore = stores
    R = _rotation()
    if kind == "flat":
        jm, pm = JaxMIPS(jstore, None, R), MIPS(pstore, None, R, device="cpu")
    else:
        jm = JaxMIPS(jstore, JaxIVFIndex.load(saves(kind)), R)
        pm = MIPS(pstore, IVFIndex.load(saves(kind), device="cpu"), R)
    np.testing.assert_array_equal(pm.R.numpy(), np.asarray(jm.R))
    q = _queries(jstore, seed=8)
    ref = jm.search(q, top_k=5, nprobe=8, return_idxs=True)
    out = pm.search(q, top_k=5, nprobe=8, return_idxs=True)
    _same_spans(ref, out)
    _same_vecs(ref, out)
    if kind != "OPQ16":  # decode mode rotates back by the index's rotation
        d = pstore.dim
        for b, ret in enumerate(out):
            for r in ret[:3]:
                got = float(q[b, :d] @ r["start_vec"]
                            + q[b, d:] @ r["end_vec"])
                assert abs(got - r["score"]) < 1e-3 * max(1, abs(got))


# -------------------------------------------------------- vecs_on_device
@pytest.mark.parametrize("kind", ["flat", "OPQ16"])
def test_vecs_on_device_matches_attached(stores, saves, kind):
    # ref tests/test_train_query.py:73-90
    jstore, pstore = stores
    index = (None if kind == "flat"
             else IVFIndex.load(saves(kind), device="cpu"))
    pm = MIPS(pstore, index, device="cpu")
    jm = JaxMIPS(jstore, None if kind == "flat"
                 else JaxIVFIndex.load(saves(kind)))
    q = _queries(jstore, n=4, seed=9)
    attached = pm.search(q, top_k=6, nprobe=8, return_idxs=True,
                         max_answer_length=5)
    results, (sv, ev) = pm.search(q, top_k=6, nprobe=8, vecs_on_device=True,
                                  max_answer_length=5)
    assert isinstance(sv, torch.Tensor) and sv.shape == (4, 12, DIM)
    assert ev.shape == (4, 12, DIM) and sv.device == pm.device
    _, (jsv, jev) = jm.search(q, top_k=6, nprobe=8, vecs_on_device=True,
                              max_answer_length=5)
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), atol=VEC_ATOL)
    np.testing.assert_allclose(ev.numpy(), np.asarray(jev), atol=VEC_ATOL)
    for b in range(len(q)):
        assert [r["cand_col"] for r in results[b]] == \
            [r["cand_col"] for r in attached[b]]
        for r, a in zip(results[b], attached[b]):
            assert r["start_vec"] is None and r["end_vec"] is None
            np.testing.assert_array_equal(sv[b, r["cand_col"]].numpy(),
                                          a["start_vec"])
            np.testing.assert_array_equal(ev[b, r["cand_col"]].numpy(),
                                          a["end_vec"])


# ------------------------------------------------------- int4 flat index
def _int8_corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    return (float_to_int8(rng.normal(-2.0, 1.0, (n, DIM)).astype(np.float32)),
            rng.standard_normal((6, DIM)).astype(np.float32))


@pytest.mark.parametrize("n,chunk,k", [(3000, 512, 10), (1000, 512, 37),
                                       (700, 4096, 5)])
def test_int4_flat_ids_identical(n, chunk, k):
    # as test_torch_store_flat.py::test_scan_topk_ids_identical asks of int8
    codes, q = _int8_corpus(n)
    ref = JaxFlatIndex(codes, chunk=chunk, quant="int4")
    port = FlatIndex(codes, chunk=chunk, quant="int4", device="cpu")
    assert port.codes.dtype == torch.uint8 and port.dim == DIM
    assert port.codes.shape == tuple(ref.codes.shape)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    rv, ri = ref.search(q, top_k=k)
    pv, pi = port.search(q, top_k=k)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, atol=1e-4)


def test_int4_flat_contract_and_footprint():
    codes, q = _int8_corpus(1000, seed=1)
    port = FlatIndex(codes, chunk=512, quant="int4", int4_offset=-4.0,
                     int4_scale=2.0, device="cpu")
    ref = JaxFlatIndex(codes, chunk=512, quant="int4", int4_offset=-4.0,
                       int4_scale=2.0)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    int8 = FlatIndex(codes, chunk=512, device="cpu")
    assert port.codes.numel() * 2 == int8.codes.numel()
    # exact scores of the nibbles under the int4 contract
    nib = port.codes[:1000].to(torch.int32)
    x = torch.cat([nib >> 4, nib & 15], 1).double().numpy()
    qbf = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    exact = qbf @ x.T / 2.0 + (-4.0 * q.astype(np.float64).sum(-1))[:, None]
    vals, ids = port.search(q, top_k=8)
    np.testing.assert_allclose(vals, np.take_along_axis(exact, ids, 1),
                               atol=1e-4)


def test_mips_over_int4_flat_rescores_the_store(stores):
    # the reference's MIPS shares the int4 index's packed nibbles as the
    # rescore corpus and fails (ROADMAP Queue 3); the port rescores from
    # the store's int8 codes. Held against the reference's stage 1 with
    # the store's codes put in the rescore's place.
    jstore, pstore = stores
    jidx = JaxFlatIndex(np.asarray(jstore.vecs), quant="int4")
    with pytest.raises((ValueError, TypeError)):
        JaxMIPS(jstore, index=jidx).search(_queries(jstore, n=2), top_k=3)
    jm = JaxMIPS(jstore, index=jidx)
    jm.vecs_dev = jnp.asarray(np.asarray(jstore.vecs))
    pm = MIPS(pstore, index=FlatIndex(pstore.vecs, quant="int4",
                                      device="cpu"))
    assert pm.vecs_dev.dtype == torch.int8
    assert tuple(pm.vecs_dev.shape) == (pstore.n_vecs, DIM)
    q = _queries(jstore, seed=10)
    _same_spans(jm.search(q, top_k=5), pm.search(q, top_k=5))


def test_unpack_nibbles_dev_matches_reference():
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, (3, 5, 10), dtype=np.uint8)
    for m in (12, 20):  # bytes past M/2 are ignored
        np.testing.assert_array_equal(
            unpack_nibbles_dev(torch.from_numpy(packed), m).numpy(),
            np.asarray(jax_unpack_nibbles(jnp.asarray(packed), m)))


# ------------------------------------------------- MIPS's other options
def test_mips_options_follow_reference(stores, monkeypatch):
    jstore, pstore = stores
    calls = []
    monkeypatch.setattr(pstore, "preload_metas",
                        lambda background=False: calls.append(background))
    pm = MIPS(pstore, collect_stats=True, preload_meta=False, device="cpu")
    assert calls == []
    jm = JaxMIPS(jstore, collect_stats=True)
    assert set(pm.init_stages) == set(jm.init_stages) == {
        "index_upload_s", "f2o_s", "serve_arrays_s"}
    q = _queries(jstore, seed=11)
    for top_k in (3, 8):
        pm.search_dense(q, top_k=top_k)
        jm.search_dense(q, top_k=top_k)
    assert pm.num_docs_list == jm.num_docs_list and len(pm.num_docs_list) == 2
    MIPS(pstore, device="cpu")
    assert calls == [True]


@pytest.mark.parametrize("call", ["MIPS mesh", "FlatIndex mesh"])
def test_unported_parameters_raise(stores, call):
    """``mesh``, once refused, is ported: by position, a mesh of one (a
    process in no group) serves as the reference's one-device mesh does.
    Several ranks: tests/test_torch_parallel.py."""
    jstore, pstore = stores
    codes = np.asarray(pstore.vecs)
    mesh = make_mesh(axis="shard", devices=["cpu"])
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:1]), ("shard",))
    if call == "MIPS mesh":
        q = _queries(jstore)
        got = MIPS(pstore, None, None, mesh).search(q, top_k=4)
        want = JaxMIPS(jstore, None, None, jmesh).search(q, top_k=4)
        key = lambda rs: [(r["doc_idx"], r["start_idx"], r["end_idx"])
                          for r in rs]
        assert [key(r) for r in got] == [key(r) for r in want]
        np.testing.assert_allclose([r["score"] for rs in got for r in rs],
                                   [r["score"] for rs in want for r in rs],
                                   rtol=1e-5)
    else:
        q = np.random.default_rng(3).normal(size=(4, DIM)).astype(np.float32)
        vals, ids = FlatIndex(codes, -2.0, 20.0, mesh).search(q, top_k=7)
        ref_v, ref_i = JaxFlatIndex(codes, -2.0, 20.0, jmesh).search(
            q, top_k=7)
        np.testing.assert_array_equal(ids, np.asarray(ref_i))
        np.testing.assert_allclose(vals, np.asarray(ref_v), rtol=1e-5)
    with pytest.raises(ValueError, match="single-device"):
        FlatIndex(codes, -2.0, 20.0, mesh, quant="int4")


@pytest.mark.parametrize("call", ["build coarse_cache", "kmeans rounded"])
def test_reference_parameters_match_reference(stores, call, tmp_path):
    # accepted by position, as the reference takes them, and equal to it
    jstore, pstore = stores
    codes = np.asarray(pstore.vecs)
    if call == "build coarse_cache":
        port = IVFIndex.build(codes, IVFConfig(num_clusters=8), -2.0, 20.0,
                              False, str(tmp_path / "p"), device="cpu")
        ref = JaxIVFIndex.build(codes, JaxIVFConfig(num_clusters=8), -2.0,
                                20.0, False, str(tmp_path / "j"))
        assert os.path.exists(tmp_path / "p" / "coarse.done")
        np.testing.assert_array_equal(
            np.load(tmp_path / "p" / "assign.npy"),
            np.load(tmp_path / "j" / "assign.npy"))
        np.testing.assert_allclose(port.centroids.numpy(),
                                   np.asarray(ref.centroids), atol=1e-4)
    else:
        pc, pa = kmeans(codes, 8, 2, 0, 256, False, True, device="cpu")
        rc, ra = jax_kmeans(codes, 8, 2, 0, 256, False, True)
        np.testing.assert_allclose(pc, rc, atol=1e-4)
        assert pa.shape == (len(codes),) and (pa == ra).mean() >= 0.99
