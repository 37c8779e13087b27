"""The port's host-tiered serving against the JAX reference's, on the same
saves and whole batches of the same composition (a tiered IVF query's
results depend on its batch: each query scores the batch's union of
probed lists): ``TieredFlatIndex``, ``TieredIVF`` (SQ8, SQ4 with trained
ranges), their row gathers, ``IVFIndex.build_host_save``, and ``MIPS``'s
host rescore over each tiered index (return_idxs, vecs_on_device, a
rotation)."""

import filecmp
import inspect

import numpy as np
import pytest
import torch

from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.index.search import MIPS as JaxMIPS
from densephrases_tpu.index.store import DocMeta as JaxDocMeta
from densephrases_tpu.index.store import PhraseStore as JaxPhraseStore
from densephrases_tpu.index.store import StoreWriter as JaxStoreWriter
from densephrases_tpu.index.tiered import TieredFlatIndex as JaxTieredFlat
from densephrases_tpu.index.tiered import TieredIVF as JaxTieredIVF
from densephrases_tpu.ops.quant import float_to_int8
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.index.tiered import TieredFlatIndex, TieredIVF

# stage-1 scores are O(10): fp32 sums of the same exact bf16 x int8
# products in another order
REL_TOL = 1e-4
LIVE = -1e29  # scores above this are real; below, masked padding


def _corpus(n=5000, d=64, seed=0):
    """tests/test_tiered.py::_corpus."""
    rng = np.random.default_rng(seed)
    return float_to_int8(rng.normal(-2, 1, (n, d)).astype(np.float32))


def _same(ref, got):
    """Scores, position by position, within REL_TOL of the largest |score|;
    so an id may differ only where its row's score ties the reference's
    row's within that tolerance (a near-tie). Ids must agree elsewhere."""
    (rv, ri), (gv, gi) = ref, got
    live = rv > LIVE
    np.testing.assert_array_equal(gv > LIVE, live)
    tol = REL_TOL * float(np.abs(rv[live]).max())
    np.testing.assert_allclose(gv[live], rv[live], atol=tol, rtol=0)
    differ = live & (np.asarray(gi) != np.asarray(ri))
    assert differ.mean() <= 0.01, np.argwhere(differ)


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """The reference's IVF builds over one corpus, saved (lazily)."""
    root = tmp_path_factory.mktemp("tiered_saves")
    done = {}

    def get(fq):
        if fq not in done:
            JaxIVFIndex.build(_corpus(6000, 64, seed=11), JaxIVFConfig(
                num_clusters=64, fine_quant=fq, kmeans_iters=4)).save(
                str(root / fq))
            done[fq] = str(root / fq)
        return done[fq]
    return get


# ------------------------------------------------------------ the indexes
@pytest.mark.parametrize("budget_rows", [0, 512, 3000, 10**9])
def test_tiered_flat_matches_reference(budget_rows):
    codes = _corpus()
    q = np.random.default_rng(1).normal(size=(7, 64)).astype(np.float32)
    kw = dict(hbm_budget_bytes=budget_rows * 64, block_rows=700, chunk=512)
    ref = JaxTieredFlat(codes, **kw)
    port = TieredFlatIndex(codes, device="cpu", **kw)
    assert port.n_resident == ref.n_resident
    _same(ref.search(q, top_k=9), port.search(q, top_k=9))
    # and the port's own flat index: the same scan, split in tiers
    _same(FlatIndex(codes, chunk=512, device="cpu").search(q, top_k=9),
          port.search(q, top_k=9))


def test_tiered_flat_top_k_past_the_corpus():
    codes = _corpus(n=300)
    q = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    kw = dict(hbm_budget_bytes=0, block_rows=128)
    rv, ri = JaxTieredFlat(codes, **kw).search(q, top_k=400)
    gv, gi = TieredFlatIndex(codes, device="cpu", **kw).search(q, top_k=400)
    assert gv.shape == (3, 400) and (gv[:, 300:] < LIVE).all()
    _same((rv, ri), (gv, gi))


@pytest.mark.parametrize("block_rows", [512, 64])
@pytest.mark.parametrize("fq", ["SQ8", "SQ4"])
def test_tiered_ivf_matches_reference(saves, fq, block_rows):
    path = saves(fq)
    q = np.random.default_rng(12).normal(-2, 1, (6, 64)).astype(np.float32)
    ref = JaxTieredIVF.load(path, block_rows=block_rows)
    port = TieredIVF.load(path, block_rows=block_rows, device="cpu")
    assert port.sq4 == (fq == "SQ4") and port.int4_vector == ref.int4_vector
    for nprobe in (4, 16, 64):
        _same(ref.search(q, top_k=10, nprobe=nprobe),
              port.search(q, top_k=10, nprobe=nprobe))


def test_tiered_ivf_equals_the_in_device_union_scan(saves):
    # both score bf16(q) · code over the batch's probed-list union; at full
    # probe the union is every list, so the two agree exactly up to ties
    path = saves("SQ8")
    q = np.random.default_rng(13).normal(-2, 1, (8, 64)).astype(np.float32)
    tiered = TieredIVF.load(path, block_rows=512, device="cpu")
    device = IVFIndex.load(path, device="cpu")
    _same(device.search_union(q, top_k=10, nprobe=64),
          tiered.search(q, top_k=10, nprobe=64))
    # from_index wraps the loaded index's own arrays
    _same(tiered.search(q, top_k=10, nprobe=8),
          TieredIVF.from_index(device, block_rows=512, device="cpu")
          .search(q, top_k=10, nprobe=8))


def test_tiered_ivf_profile_and_device_results(saves, monkeypatch):
    monkeypatch.setenv("DPH_TIERED_PROFILE", "1")
    port = TieredIVF.load(saves("SQ8"), block_rows=256, device="cpu")
    q = np.random.default_rng(14).normal(-2, 1, (4, 64)).astype(np.float32)
    vals, gids = port.search(q, top_k=5, nprobe=8, as_numpy=False)
    assert isinstance(vals, torch.Tensor) and not gids.is_floating_point()
    prof = port.last_profile
    assert set(prof) == {"probe_s", "io_s", "h2d_s", "fetch_s", "blocks",
                         "rows", "uniq_lists", "total_s"}
    assert prof["blocks"] == -(-prof["rows"] // 256) and prof["uniq_lists"] > 0


@pytest.mark.parametrize("fq", ["SQ8", "SQ4"])
def test_gather_rows_host_matches_reference(saves, fq):
    path = saves(fq)
    codes = _corpus(6000, 64, seed=11)
    gids = np.array([0, 5, 11, 5999, 7000, -3])  # clipped to the corpus
    ref = JaxTieredIVF.load(path)
    port = TieredIVF.load(path, device="cpu")
    # through the inverse permutation (SQ4: unpacked and re-expressed as
    # int8 codes of the store's affine)
    np.testing.assert_array_equal(port.gather_rows_host(gids),
                                  ref.gather_rows_host(gids))
    if fq == "SQ8":
        np.testing.assert_array_equal(port.gather_rows_host(gids),
                                      codes[np.clip(gids, 0, 5999)])
    port.store_vecs = ref.store_vecs = codes  # through the store's rows
    np.testing.assert_array_equal(port.gather_rows_host(gids),
                                  ref.gather_rows_host(gids))


def test_pq_is_refused(tmp_path):
    codes = _corpus(2000, 32, seed=2)
    JaxIVFIndex.build(codes, JaxIVFConfig(num_clusters=8, fine_quant="PQ8",
                                          kmeans_iters=2, pq_iters=2)).save(
        str(tmp_path / "pq"))
    with pytest.raises(AssertionError, match="not PQ"):
        TieredIVF.load(str(tmp_path / "pq"), device="cpu")
    with pytest.raises(AssertionError, match="not PQ"):
        TieredIVF.from_index(IVFIndex.load(str(tmp_path / "pq"),
                                           device="cpu"), device="cpu")


# --------------------------------------------------------- build_host_save
def test_build_host_save_equals_build_save(tmp_path):
    # tests/test_tiered.py:217-244 on the port, served by both packages
    rng = np.random.default_rng(3)
    codes = float_to_int8(rng.normal(size=(2000, 64)).astype(np.float32)
                          * 0.4)
    cfg = IVFConfig(num_clusters=16, fine_quant="SQ8", kmeans_iters=4, seed=5)
    dev_dir, host_dir = str(tmp_path / "dev"), str(tmp_path / "host")
    IVFIndex.build(codes, cfg, device="cpu").save(dev_dir)
    stages = {}
    IVFIndex.build_host_save(codes, cfg, host_dir, stage_s=stages,
                             device="cpu")
    assert set(stages) == {"sample_s", "kmeans_s", "assign_s", "balance_s"}
    for name in ("centroids", "row_perm", "list_offsets", "codes"):
        assert filecmp.cmp(f"{host_dir}/{name}.npy", f"{dev_dir}/{name}.npy",
                           shallow=False), name  # byte for byte
    q = rng.normal(size=(4, 64)).astype(np.float32)
    in_device = IVFIndex.load(host_dir, device="cpu").search(q, top_k=10,
                                                             nprobe=16)
    _same(in_device, TieredIVF.load(host_dir, device="cpu").search(
        q, top_k=10, nprobe=16))
    _same(JaxTieredIVF.load(host_dir).search(q, top_k=10, nprobe=16),
          TieredIVF.load(host_dir, device="cpu").search(q, top_k=10,
                                                        nprobe=16))
    with pytest.raises(AssertionError, match="SQ8"):
        IVFIndex.build_host_save(codes, IVFConfig(fine_quant="SQ4"),
                                 str(tmp_path / "x"), device="cpu")


# ------------------------------------------------------------ tiered MIPS
DIM = 32


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """tests/test_tiered.py::_tiny_store with 20 docs."""
    path = tmp_path_factory.mktemp("tiered_store") / "st"
    rng = np.random.default_rng(21)
    w = JaxStoreWriter(str(path), DIM)
    for d in range(20):
        nv = int(rng.integers(6, 20))
        vecs = rng.normal(-2, 1, (nv, DIM)).astype(np.float32)
        w.add_doc(JaxDocMeta(
            doc_id=d, title=f"doc{d}",
            context=" ".join(f"w{i}" for i in range(nv)),
            word2char_start=np.arange(nv, dtype=np.int32) * 3,
            word2char_end=np.arange(nv, dtype=np.int32) * 3 + 2,
            f2o_start=np.arange(nv, dtype=np.int32)), float_to_int8(vecs))
    w.finalize()
    return str(path)


def _spans(results):
    return {(r["doc_idx"], r["start_idx"], r["end_idx"], r["cand_col"]):
            r["score"] for r in results}


def _tiered_pair(kind, store_path, tmp_path):
    """(reference index, port index) of one kind over the store."""
    jstore = JaxPhraseStore.load(store_path, mmap=True)
    pstore = PhraseStore.load(store_path, mmap=True)
    if kind == "flat":
        kw = dict(hbm_budget_bytes=0, block_rows=16)
        return (JaxTieredFlat(np.asarray(jstore.vecs), jstore.offset,
                              jstore.scale, **kw),
                TieredFlatIndex(np.asarray(pstore.vecs), pstore.offset,
                                pstore.scale, device="cpu", **kw))
    path = str(tmp_path / "ivf")
    JaxIVFIndex.build(np.asarray(jstore.vecs), JaxIVFConfig(
        num_clusters=8, fine_quant="SQ8", kmeans_iters=4)).save(path)
    ref = JaxTieredIVF.load(path, block_rows=64)
    port = TieredIVF.load(path, block_rows=64, device="cpu")
    if kind == "ivf-store":
        ref.store_vecs, port.store_vecs = jstore.vecs, pstore.vecs
    return ref, port


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("kind", ["flat", "ivf", "ivf-store"])
def test_tiered_mips_matches_reference(store_path, tmp_path, kind, rotate):
    jstore = JaxPhraseStore.load(store_path, mmap=True)
    pstore = PhraseStore.load(store_path, mmap=True)
    ref_index, port_index = _tiered_pair(kind, store_path, tmp_path)
    R = (np.linalg.qr(np.random.default_rng(7).normal(size=(DIM, DIM)))[0]
         .astype(np.float32) if rotate else None)
    jm = JaxMIPS(jstore, index=ref_index, rotation=R)
    pm = MIPS(pstore, index=port_index, rotation=R)
    assert pm.tiered and pm.vecs_dev is None
    q = np.random.default_rng(22).normal(size=(3, 2 * DIM)).astype(np.float32)
    ref = jm.search(q, top_k=4, nprobe=8, return_idxs=True)
    out = pm.search(q, top_k=4, nprobe=8, return_idxs=True)
    for r, o in zip(ref, out):
        rs, os_ = _spans(r), _spans(o)
        assert rs.keys() == os_.keys()
        np.testing.assert_allclose([os_[k] for k in rs], list(rs.values()),
                                   rtol=REL_TOL, atol=1e-3)
        rv = {k: (x["start_vec"], x["end_vec"]) for k, x in
              zip(rs, r)}
        for k, x in zip(os_, o):
            np.testing.assert_allclose(x["start_vec"], rv[k][0], atol=1e-5)
            np.testing.assert_allclose(x["end_vec"], rv[k][1], atol=1e-5)
    # the vectors kept on the device: [B, 2K, D] by candidate column
    results, (sv, ev) = pm.search(q, top_k=4, nprobe=8, vecs_on_device=True)
    assert sv.shape == ev.shape == (3, 8, DIM)
    for bi, res in enumerate(results):
        for r_ref, r_new in zip(out[bi], res):
            col = r_new["cand_col"]
            np.testing.assert_allclose(sv[bi, col].numpy(),
                                       r_ref["start_vec"], atol=1e-6)
            np.testing.assert_allclose(ev[bi, col].numpy(),
                                       r_ref["end_vec"], atol=1e-6)


def test_tiered_mips_keeps_no_corpus_on_the_device(store_path):
    pstore = PhraseStore.load(store_path, mmap=True)
    index = TieredFlatIndex(pstore.vecs, pstore.offset, pstore.scale,
                            hbm_budget_bytes=0, device="cpu")
    mips = MIPS(pstore, index=index)
    assert index.codes is None and mips.vecs_dev is None
    assert not hasattr(mips, "f2o_dev")
    assert set(mips.init_stages) == {"f2o_s", "serve_arrays_s"}


def _params(fn):
    return [name for name, p in inspect.signature(fn).parameters.items()
            if name != "self" and p.kind in (p.POSITIONAL_ONLY,
                                             p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("port_fn,ref_fn", [
    (TieredFlatIndex.__init__, JaxTieredFlat.__init__),
    (TieredFlatIndex.search, JaxTieredFlat.search),
    (TieredIVF.__init__, JaxTieredIVF.__init__),
    (TieredIVF.load, JaxTieredIVF.load),
    (TieredIVF.from_index, JaxTieredIVF.from_index),
    (TieredIVF.search, JaxTieredIVF.search),
    (IVFIndex.build_host_save, JaxIVFIndex.build_host_save),
], ids=["TieredFlatIndex.__init__", "TieredFlatIndex.search",
        "TieredIVF.__init__", "TieredIVF.load", "TieredIVF.from_index",
        "TieredIVF.search", "IVFIndex.build_host_save"])
def test_signatures_follow_reference(port_fn, ref_fn):
    # the reference's parameters in its order; the port's own (device,
    # stage_s) keyword-only after them
    assert _params(port_fn) == _params(ref_fn)
    own = inspect.signature(port_fn).parameters.get("device")
    assert own is None or own.kind is own.KEYWORD_ONLY
