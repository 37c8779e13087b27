"""The port's two-level coarse quantizer against the JAX reference's:
two-level k-means and its batched Lloyd, ``kmeans(rounded=True)``, the
hierarchical assignments, the balancing of the two-level lists, the
two-level branch of ``IVFIndex.build``, and the coarse-quantizer cache,
which each package builds from when the other wrote it."""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.index import ivf as jivf
from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.ops import kmeans as jk
from densephrases_tpu.ops.quant import float_to_int8
from densephrases_tpu_torch.index import ivf as tivf
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.ops import kmeans as tk

# centroids are fp32 means of the same rows summed in another order
CENT_ATOL = 1e-4
# bf16 distance products summed in fp32 in another order: a near-tie may
# move a row to another centroid
ROW_AGREE = 0.99
OFF, SC = -2.0, 20.0


def _blobs(n, d, n_blobs=16, spread=3.0, noise=0.3, seed=23):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, (n_blobs, d)).astype(np.float32)
    return (centers[rng.integers(0, n_blobs, n)]
            + noise * rng.normal(size=(n, d))).astype(np.float32)


def _clustered(n, d, n_clusters=32, seed=0):
    """tests/test_ivf.py::_clustered_data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(-2, 1.0, (n_clusters, d)).astype(np.float32)
    idx = rng.integers(0, n_clusters, n)
    return (centers[idx] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _data(kind):
    """fp32 rows, or int8 codes with the (OFF, SC) contract."""
    if kind == "fp32":
        return _blobs(6000, 16), 0.0, 1.0
    return float_to_int8(_clustered(4000, 32, 40, seed=3)), OFF, SC


def _row_lists(offs, row_perm):
    """The list of every global row of a built index."""
    n = int(offs[-1])
    out = np.empty(n, np.int64)
    out[np.asarray(row_perm)[:n]] = np.searchsorted(
        offs, np.arange(n), side="right") - 1
    return out


# --------------------------------------------------------------- trainers
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_kmeans_two_level_matches_reference(kind):
    x, off, sc = _data(kind)
    rc, rl, ro = jk.kmeans_two_level(x, k=96, iters=3, seed=2, offset=off,
                                     scale=sc)
    pc, pl, po = tk.kmeans_two_level(x, k=96, iters=3, seed=2, offset=off,
                                     scale=sc, device="cpu")
    np.testing.assert_array_equal(po, ro)
    scale = float(np.abs(rc).max())
    np.testing.assert_allclose(pc, rc, atol=CENT_ATOL * scale)
    np.testing.assert_allclose(pl, rl, atol=CENT_ATOL * scale)


@pytest.mark.parametrize("k,k1", [(16384, 128), (512, 16), (2048, 64),
                                  (1 << 20, 1024), (80, 16)])
def test_k1_rounds_like_reference(k, k1):
    # k1 = clip(2**round(log2(sqrt(k))), 16, 4096) with Python's round,
    # halves to even: sqrt(512) = 2**4.5 → 16, sqrt(2048) = 2**5.5 → 64;
    # sqrt(80) = 2**3.16 rounds to 8, clipped up to 16
    x = _blobs(k1 * 8 + 8, 4, seed=1)
    seen = {}

    def fake_kmeans(x, k, **kw):
        seen["k1"] = k
        raise StopIteration

    for mod in (jk, tk):
        orig = mod.kmeans
        mod.kmeans = fake_kmeans
        try:
            with pytest.raises(StopIteration):
                kw = {"device": "cpu"} if mod is tk else {}
                mod.kmeans_two_level(x, k, **kw)
        finally:
            mod.kmeans = orig
        assert seen.pop("k1") == k1, mod.__name__


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_kmeans_batched_matches_reference(kind):
    x, off, sc = _data(kind)
    rng = np.random.default_rng(5)
    # groups of several sizes; a small group budget makes stacks of 2, and
    # the last stack is filled up by repeating its groups
    groups = [x[rng.choice(len(x), n, replace=False)]
              for n in (300, 41, 512, 97, 260)]
    floats = 2 * 512 * x.shape[1]
    ref = jk.kmeans_batched(groups, 12, iters=4, seed=7,
                            max_group_floats=floats, offset=off, scale=sc)
    got = tk.kmeans_batched(groups, 12, iters=4, seed=7,
                            max_group_floats=floats, offset=off, scale=sc,
                            device="cpu")
    assert len(got) == len(ref) == len(groups)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=CENT_ATOL * np.abs(r).max())


def test_batched_lloyd_reseeds_empty_clusters_like_reference():
    rng = np.random.default_rng(2)
    X = np.concatenate([_blobs(256, 8, 4, seed=s)[None] for s in (3, 4)])
    C0 = X[:, rng.choice(256, 6, replace=False)].copy()
    C0[0, 2] = 1e3  # draws no row: reseeded with the farthest row
    C0[1, 4:] = -1e3  # two empty: the farthest and the second farthest
    ref = np.asarray(jk._batched_lloyd(jnp.asarray(X), jnp.asarray(C0),
                                       iters=3))
    got = tk._batched_lloyd(torch.from_numpy(X), torch.from_numpy(C0),
                            iters=3).numpy()
    np.testing.assert_allclose(got, ref, atol=CENT_ATOL * np.abs(ref).max())
    assert np.abs(got).max() < 100  # every far centroid was reseeded
    one = tk._batched_lloyd(torch.from_numpy(X), torch.from_numpy(C0),
                            iters=1).numpy()
    for g, c in ((0, 2), (1, 4), (1, 5)):  # reseeded with rows of the group
        assert (np.abs(X[g] - one[g, c]).max(1) == 0).any(), (g, c)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_kmeans_rounded_matches_reference(kind):
    x, off, sc = _data(kind)
    x = x[:900]  # pads to 1024 rows with resampled ones
    rc, ra = jk.kmeans(x, 24, iters=4, seed=3, chunk=256, rounded=True,
                       offset=off, scale=sc)
    pc, pa = tk.kmeans(x, 24, iters=4, seed=3, chunk=256, rounded=True,
                       offset=off, scale=sc, device="cpu")
    assert pa.shape == ra.shape == (900,)
    np.testing.assert_allclose(pc, rc, atol=CENT_ATOL * np.abs(rc).max())
    assert (pa == ra).mean() >= ROW_AGREE
    plain, _ = tk.kmeans(x, 24, iters=4, seed=3, chunk=256, offset=off,
                         scale=sc, device="cpu")
    assert not np.allclose(plain, pc)  # the resampling changed the draws


def test_sort_children_matches_reference():
    x = _blobs(3000, 16)
    cents, l1, _ = jk.kmeans_two_level(x, k=64, iters=3, seed=2)
    shuffled = cents[np.random.default_rng(0).permutation(len(cents))]
    for r, p in zip(jk.sort_children(shuffled, l1),
                    tk.sort_children(shuffled, l1, device="cpu")):
        np.testing.assert_array_equal(p, r)


# ------------------------------------------------- hierarchical assignment
@pytest.fixture(scope="module")
def quantizer():
    """A reference two-level quantizer over fp32 blobs and over int8
    codes, shared by the assignment tests."""
    out = {}
    for kind in ("fp32", "int8"):
        x, off, sc = _data(kind)
        cents, l1, offs = jk.kmeans_two_level(x, k=96, iters=3, seed=2,
                                              offset=off, scale=sc)
        out[kind] = (x, off, sc, cents, l1, offs)
    return out


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_assign_blocks_hier_matches_reference(quantizer, kind):
    x, off, sc, cents, l1, offs = quantizer[kind]
    ref = jk.assign_blocks_hier(x, l1, cents, offs, probe=4, block=1500,
                                offset=off, scale=sc)
    got = tk.assign_blocks_hier(x, l1, cents, offs, probe=4, block=1500,
                                offset=off, scale=sc, device="cpu")
    assert (got == ref).mean() >= ROW_AGREE


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_assign_corpus_hier_matches_reference(quantizer, kind):
    x, off, sc, cents, l1, offs = quantizer[kind]
    ref = jk.assign_corpus_hier(jnp.asarray(x), l1, cents, offs, probe=4,
                                offset=off, scale=sc)
    got = tk.assign_corpus_hier(torch.from_numpy(x), l1, cents, offs,
                                probe=4, offset=off, scale=sc)
    assert got.dtype == np.int32
    assert (got == ref).mean() >= ROW_AGREE
    streamed = tk.assign_hier_streamed(x, l1, cents, offs, probe=4,
                                       offset=off, scale=sc, block_bytes=1,
                                       device="cpu")
    ref_streamed = jk.assign_hier_streamed(x, l1, cents, offs, probe=4,
                                           offset=off, scale=sc,
                                           block_bytes=1)
    np.testing.assert_array_equal(streamed, got)
    assert (streamed == ref_streamed).mean() >= ROW_AGREE


def test_assign_corpus_hier_group_edges():
    # more parents than one group, a parent group past the corpus end (the
    # clamped start) and odd pg: rows still take their own parent's
    # candidates, as in the reference
    x = _blobs(700, 8, 24, seed=9)
    cents, l1, offs = jk.kmeans_two_level(x, k=40, iters=3, seed=1, k1=17)
    for pg in (1, 3):
        ref = jk.assign_corpus_hier(jnp.asarray(x), l1, cents, offs,
                                    probe=3, pg=pg)
        got = tk.assign_corpus_hier(torch.from_numpy(x), l1, cents, offs,
                                    probe=3, pg=pg)
        assert (got == ref).mean() >= ROW_AGREE, pg


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_assign_corpus_hier_in_pieces(quantizer, kind, monkeypatch):
    # a parent group's rows go through in pieces of at most rows_max (512
    # at this GROUP_ELEMS): the same assignment as in one piece, and the
    # reference's
    x, off, sc, cents, l1, offs = quantizer[kind]
    whole = tk.assign_corpus_hier(torch.from_numpy(x), l1, cents, offs,
                                  probe=4, offset=off, scale=sc)
    monkeypatch.setattr(tk, "GROUP_ELEMS", 1)
    pieces = tk.assign_corpus_hier(torch.from_numpy(x), l1, cents, offs,
                                   probe=4, offset=off, scale=sc)
    np.testing.assert_array_equal(pieces, whole)
    ref = jk.assign_corpus_hier(jnp.asarray(x), l1, cents, offs, probe=4,
                                offset=off, scale=sc)
    assert (pieces == ref).mean() >= ROW_AGREE


# -------------------------------------------------------------- balancing
@pytest.mark.parametrize("with_offs", [False, True])
def test_balance_lists_hier_matches_reference(with_offs):
    x = _clustered(3000, 16, 12, seed=5)
    cents, l1, offs = jk.kmeans_two_level(x, k=24, iters=3, seed=0)
    assign = jk.assign_blocks_hier(x, l1, cents, offs, probe=4)
    kw = dict(balance_factor=1.5, rounds=3, probe=4, growth_cap=1.5,
              parent_offs=offs if with_offs else None)
    rc, rl, ro, ra = jivf._balance_lists_hier(x, cents, l1, assign, **kw)
    pc, pl, po, pa = tivf._balance_lists_hier(x, cents, l1, assign,
                                              device="cpu", **kw)
    assert pc.shape[0] > cents.shape[0]  # lists were split
    np.testing.assert_array_equal(po, ro)
    np.testing.assert_allclose(pc, rc, atol=CENT_ATOL * np.abs(rc).max())
    assert pl is l1 and (pa == ra).mean() >= ROW_AGREE


@pytest.mark.parametrize("budget", [None, 3, 0])
def test_force_partition_with_parents_matches_reference(budget):
    x = _clustered(2000, 16, 6, seed=8)
    cents, l1, offs = jk.kmeans_two_level(x, k=12, iters=3, seed=0, k1=4)
    assign = jk.assign_blocks_hier(x, l1, cents, offs, probe=2)
    cap = 1.2 * len(x) / len(cents)
    ref = jivf._force_partition(cents, assign, cap, l1_cents=l1,
                                budget=budget)
    got = tivf._force_partition(cents, assign, cap, l1_cents=l1,
                                budget=budget, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    flat = tivf._force_partition(cents, assign, cap, budget=budget,
                                 device="cpu")
    assert flat[1] is None and len(flat) == 3


# ---------------------------------------------------------------- builds
def _two_level_cfg(cls, **kw):
    # two_level_clusters forced low, as tests/test_ivf.py:145-163
    return cls(num_clusters=256, fine_quant="SQ8", kmeans_iters=4,
               two_level_clusters=64, **kw)


def test_two_level_build_matches_reference():
    codes = float_to_int8(_clustered(12000, 64, 200, seed=21))
    queries = _clustered(16, 64, 200, seed=22)
    ref = JaxIVFIndex.build(codes, _two_level_cfg(JaxIVFConfig))
    port = IVFIndex.build(codes, _two_level_cfg(IVFConfig), device="cpu")
    assert port.nlist == ref.centroids.shape[0]
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), atol=CENT_ATOL)
    ra = _row_lists(np.asarray(ref.list_offsets), ref.row_perm)
    pa = _row_lists(port.list_offsets.numpy(), port.row_perm.numpy())
    assert (pa == ra).mean() >= ROW_AGREE
    _, exact = JaxFlatIndex(codes, chunk=512).search(queries, top_k=10)

    def recall(ids):
        return np.mean([len(set(e.tolist()) & set(i.tolist())) / 10
                        for e, i in zip(exact, ids)])

    r_recall = recall(ref.search(queries, top_k=10, nprobe=64)[1])
    p_recall = recall(port.search(queries, top_k=10, nprobe=64)[1])
    assert p_recall >= 0.9 and abs(p_recall - r_recall) <= 0.02


def test_two_level_build_streams_past_the_device_budget(monkeypatch):
    # a corpus above DPH_ASSIGN_DEVICE_BYTES is assigned block by block
    # through assign_hier_streamed, with the same result
    codes = float_to_int8(_clustered(3000, 32, 40, seed=6))
    cfg = IVFConfig(num_clusters=64, fine_quant="SQ8", kmeans_iters=3,
                    two_level_clusters=32)
    resident = IVFIndex.build(codes, cfg, device="cpu")
    calls = []
    monkeypatch.setenv("DPH_ASSIGN_DEVICE_BYTES", "0")
    monkeypatch.setattr(tivf, "assign_hier_streamed",
                        lambda *a, **k: calls.append(1)
                        or tk.assign_hier_streamed(*a, **k))
    streamed = IVFIndex.build(codes, cfg, device="cpu")
    assert calls
    for key in ("list_offsets", "row_perm", "centroids"):
        np.testing.assert_array_equal(getattr(streamed, key).numpy(),
                                      getattr(resident, key).numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_coarse_cache_is_read_across_packages(tmp_path, writer):
    # the cache is plain npy and JSON: a build from the other package's
    # cache lays out exactly the same lists
    codes = float_to_int8(_clustered(4000, 32, 50, seed=30))
    cc = str(tmp_path / "coarse")
    jcfg, pcfg = (_two_level_cfg(cls, seed=4) for cls in (JaxIVFConfig,
                                                          IVFConfig))
    stages = {}
    if writer == "reference":
        first = JaxIVFIndex.build(codes, jcfg, coarse_cache=cc)
        second = IVFIndex.build(codes, pcfg, coarse_cache=cc, stage_s=stages,
                                device="cpu")
    else:
        first = IVFIndex.build(codes, pcfg, coarse_cache=cc, device="cpu")
        second = JaxIVFIndex.build(codes, jcfg, coarse_cache=cc)
    for name in ("coarse.done", "kmeans.done", "centroids.npy", "assign.npy",
                 "km_centroids.npy", "km_l1.npy", "km_offs.npy"):
        assert os.path.exists(os.path.join(cc, name)), name

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    for key in ("codes", "list_offsets", "row_perm", "centroids"):
        np.testing.assert_array_equal(host(getattr(second, key)),
                                      host(getattr(first, key)), key)
    if writer == "reference":  # a cache hit reports the writer's clocks
        assert set(stages) == {"fine_s"} | (
            {"sample_s", "kmeans_s", "assign_s", "balance_s"}
            if os.path.exists(os.path.join(cc, "stage_s.json")) else set())


def test_kmeans_checkpoint_resume(tmp_path):
    # tests/test_ivf.py:541-566: a crash between the two-level k-means and
    # the coarse .done marker resumes from the k-means checkpoint
    codes = float_to_int8(_clustered(4000, 32, 50, seed=30))
    cc = str(tmp_path / "coarse")
    cfg = IVFConfig(num_clusters=64, fine_quant="SQ8", kmeans_iters=3,
                    two_level_clusters=48)
    first = IVFIndex.build(codes, cfg, coarse_cache=cc, device="cpu")
    assert os.path.exists(os.path.join(cc, "kmeans.done"))
    os.remove(os.path.join(cc, "coarse.done"))
    os.remove(os.path.join(cc, "assign.npy"))
    calls = []
    orig = tivf.kmeans_two_level
    tivf.kmeans_two_level = lambda *a, **k: calls.append(1)
    try:
        again = IVFIndex.build(codes, cfg, coarse_cache=cc, device="cpu")
    finally:
        tivf.kmeans_two_level = orig
    assert calls == []  # the k-means came from the checkpoint
    queries = _clustered(8, 32, 50, seed=31)
    np.testing.assert_array_equal(
        first.search(queries, top_k=5, nprobe=16)[1],
        again.search(queries, top_k=5, nprobe=16)[1])


@pytest.mark.parametrize("two_level", [False, True])
def test_coarse_cache_keeps_the_stage_clocks(tmp_path, two_level):
    # tests/test_ivf.py:569-584, on both branches
    codes = float_to_int8(_clustered(2000, 32, 20, seed=33))
    cc = str(tmp_path / "coarse")
    cfg = IVFConfig(num_clusters=16, fine_quant="SQ8", kmeans_iters=3,
                    two_level_clusters=16 if two_level else 8192)
    s1 = {}
    IVFIndex.build_coarse(codes, cfg, coarse_cache=cc, stage_s=s1,
                          device="cpu")
    assert set(s1) == {"sample_s", "kmeans_s", "assign_s", "balance_s"}
    assert os.path.exists(os.path.join(cc, "kmeans.done")) == two_level
    s2 = {}
    _, _, sample = IVFIndex.build_coarse(codes, cfg, coarse_cache=cc,
                                         stage_s=s2, device="cpu")
    assert sample is None and s2 == s1  # a hit: the clocks reloaded


def _params(fn):
    return [name for name, p in inspect.signature(fn).parameters.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("name", [
    "kmeans_two_level", "kmeans_batched", "sort_children",
    "assign_blocks_hier", "assign_corpus_hier", "assign_hier_streamed",
    "_balance_lists_hier", "_force_partition"])
def test_signatures_follow_reference(name):
    mod_t, mod_j = ((tivf, jivf) if name.startswith("_") else (tk, jk))
    assert _params(getattr(mod_t, name)) == _params(getattr(mod_j, name))
