"""The port's IVF index against the JAX reference's: search on one saved
index (the reference builds and saves, the port loads), the reference's
own contracts on the port, the port's build against the reference's, and
the save format in both directions."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from densephrases_tpu.index.flat import FlatIndex as JaxFlatIndex
from densephrases_tpu.index.ivf import IVFConfig as JaxIVFConfig
from densephrases_tpu.index.ivf import IVFIndex as JaxIVFIndex
from densephrases_tpu.ops import kmeans as jk
from densephrases_tpu.ops import opq as jopq
from densephrases_tpu.ops import pq as jpq
from densephrases_tpu.ops.quant import float_to_int8
from densephrases_tpu.ops.quant import train_int4_ranges as jax_int4_ranges
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.ops import kmeans as tk
from densephrases_tpu_torch.ops import opq as topq
from densephrases_tpu_torch.ops import pq as tpq
from densephrases_tpu_torch.ops.quant import train_int4_ranges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 1500, 256
NLIST = 16
LIVE = -1e29  # scores above this are real; below, masked padding
# scores are O(10): fp32 sums of the same exact products in another order
SCORE_ATOL = 1e-4


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    return float_to_int8(rng.normal(size=(N, D)).astype(np.float32) * 0.4)


def _queries(b=8, seed=1, d=D):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _clustered(n, d, n_clusters=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(-2, 1.0, (n_clusters, d)).astype(np.float32)
    idx = rng.integers(0, n_clusters, n)
    return (centers[idx] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _cfg(cls, fine_quant, refine_factor=4, **kw):
    return cls(num_clusters=NLIST, fine_quant=fine_quant, kmeans_iters=4,
               pq_iters=3, opq_iters=2, refine_factor=refine_factor, **kw)


VARIANTS = {
    "SQ8": ("SQ8", 4), "SQ4": ("SQ4", 4), "OPQ8": ("OPQ8", 4),
    "PQ8": ("PQ8", 4), "OPQ16x4": ("OPQ16x4", 4),
    "PQ8-norefine": ("PQ8", 1), "OPQ16x4-norefine": ("OPQ16x4", 1),
}


@pytest.fixture(scope="module")
def ref_saves(tmp_path_factory):
    """Each variant built and saved by the reference (lazily)."""
    root = tmp_path_factory.mktemp("ref_ivf")
    done = {}

    def get(name):
        if name not in done:
            fq, rf = VARIANTS[name]
            idx = JaxIVFIndex.build(_corpus(), _cfg(JaxIVFConfig, fq, rf))
            idx.save(str(root / name))
            done[name] = str(root / name)
        return done[name]
    return get


def _same_results(ref, got, atol=SCORE_ATOL):
    (rv, ri), (gv, gi) = ref, got
    live = rv > LIVE
    np.testing.assert_array_equal(gv > LIVE, live)
    np.testing.assert_array_equal(gi[live], ri[live])
    np.testing.assert_allclose(gv[live], rv[live], atol=atol, rtol=0)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_search_matches_reference_on_its_save(ref_saves, name, b):
    path = ref_saves(name)
    ref, port = JaxIVFIndex.load(path), IVFIndex.load(path, device="cpu")
    assert port.nlist == NLIST and port.pq_residual == ref.pq_residual
    assert (port.refine_codes is None) == (ref.refine_codes is None)
    q = _queries(b, seed=10 + b)
    # OPQ without refine returns LUT scores of bf16(q @ R): q @ R differs
    # between the packages in its last fp32 bits, which may round a query
    # element to the neighbouring bf16 value (a LUT entry moves by up to a
    # bf16 ulp of |q|·|c|, ~1e-3 here); the refine rescoring does not
    # rotate
    atol = 1e-2 if name.startswith("OPQ") and name.endswith("norefine") \
        else SCORE_ATOL
    for nprobe in (1, 4, NLIST):
        _same_results(ref.search(q, top_k=10, nprobe=nprobe),
                      port.search(q, top_k=10, nprobe=nprobe), atol=atol)


@pytest.mark.parametrize("name", ["SQ8", "OPQ8", "PQ8-norefine"])
def test_residual_index_keeps_its_row_lists(ref_saves, name):
    """From its load on, an index over residual PQ codes holds each padded
    code row's list (the residual base's), int32, rows past the last list
    in it; an index without residual codes holds none."""
    port = IVFIndex.load(ref_saves(name), device="cpu")
    if not port.pq_residual:
        assert name == "SQ8" and port.row_list is None
        return
    offs = port.list_offsets.numpy()
    rows = np.arange(port.codes.shape[0])
    want = np.minimum(np.searchsorted(offs, rows, side="right") - 1,
                      port.nlist - 1)
    assert port.row_list.dtype == torch.int32
    np.testing.assert_array_equal(port.row_list.numpy(), want)


def test_union_route_matches_reference_for_one_query(ref_saves):
    # one SQ8 query row takes _probe_score in search(); search_union is the
    # other route, held to the reference's search_union
    path = ref_saves("SQ8")
    ref, port = JaxIVFIndex.load(path), IVFIndex.load(path, device="cpu")
    q = _queries(1, seed=3)
    for nprobe in (1, 4):
        _same_results(ref.search_union(q, top_k=12, nprobe=nprobe),
                      port.search_union(q, top_k=12, nprobe=nprobe))


# --------------------------------------- the reference's contracts, ported
def _brute_sq8(q, codes):
    """bf16(q) · code in float64 (exact), then the int8 affine contract."""
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    raw = qb @ codes.T.astype(np.float64)
    return raw / 20.0 + (q.astype(np.float64) * -2.0).sum(-1)[:, None]


@pytest.fixture(scope="module")
def port_sq8():
    return IVFIndex.build(_corpus(), _cfg(IVFConfig, "SQ8"), device="cpu")


@pytest.mark.parametrize("b", [1, 8])
def test_full_probe_sq8_equals_flat_index(port_sq8, b):
    q = _queries(b, seed=20)
    fv, fi = FlatIndex(_corpus(), device="cpu").search(q, top_k=25)
    iv, ii = port_sq8.search(q, top_k=25, nprobe=NLIST)
    np.testing.assert_array_equal(ii, fi)
    np.testing.assert_allclose(iv, fv, atol=SCORE_ATOL, rtol=0)


def test_no_duplicate_ids_partial_probe(port_sq8):
    q = _queries(16, seed=3)
    vals, gids = port_sq8.search_union(q, top_k=40, nprobe=5)
    for r in range(q.shape[0]):
        real = gids[r][vals[r] > LIVE]
        assert len(real) > 0 and len(np.unique(real)) == len(real)


def test_scores_exact_partial_probe(port_sq8):
    q = _queries(4, seed=5)
    vals, gids = port_sq8.search_union(q, top_k=30, nprobe=6)
    brute = _brute_sq8(q, _corpus())
    got = np.take_along_axis(brute, gids.astype(np.int64), axis=1)
    live = vals > LIVE
    np.testing.assert_allclose(vals[live], got[live], atol=SCORE_ATOL, rtol=0)


def test_pq_4bit_full_probe_recall():
    idx = IVFIndex.build(_corpus(), IVFConfig(
        num_clusters=NLIST, fine_quant="OPQ64x4", pq_iters=3, opq_iters=2,
        kmeans_iters=4, refine_factor=16), device="cpu")
    assert idx.codes.shape[1] == 32  # nibble-packed
    q = _queries(8, seed=8)
    vals, gids = idx.search_union(q, top_k=10, nprobe=NLIST)
    brute = _brute_sq8(q, _corpus())
    exact = np.argsort(brute, axis=1)[:, ::-1][:, :10]
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(gids, exact)])
    assert overlap >= 0.85, overlap
    got = np.take_along_axis(brute, gids.astype(np.int64), axis=1)
    live = vals > LIVE
    np.testing.assert_allclose(vals[live], got[live], atol=1e-3, rtol=0)


# ------------------------------------------------------------------ build
def test_kmeans_matches_reference():
    x = _clustered(2000, 32)
    rc, ra = jk.kmeans(x, 16, iters=8, seed=0, chunk=256)
    pc, pa = tk.kmeans(x, 16, iters=8, seed=0, chunk=256, device="cpu")
    # same init rows; bf16 distance products summed in fp32 in another
    # order, so a near-tie may move a row
    np.testing.assert_allclose(pc, rc, atol=1e-4)
    assert (pa == ra).mean() >= 0.99
    codes = _corpus()  # the int8 path (transformed centroids)
    rc, ra = jk.kmeans(codes, 16, iters=5, seed=0, offset=-2.0, scale=20.0)
    pc, pa = tk.kmeans(codes, 16, iters=5, seed=0, offset=-2.0, scale=20.0,
                       device="cpu")
    np.testing.assert_allclose(pc, rc, atol=1e-4)
    assert (pa == ra).mean() >= 0.99


def test_pq_matches_reference():
    x = _clustered(3000, 64, seed=1)
    rp = jpq.train_pq(x, 8, iters=5)
    pp = tpq.train_pq(x, 8, iters=5, device="cpu")
    np.testing.assert_allclose(pp.codebooks, rp.codebooks, atol=1e-4)
    pc = tpq.pq_encode(pp, x, device="cpu")
    assert pc.dtype == np.uint8 and (pc == jpq.pq_encode(rp, x)).mean() > 0.99
    np.testing.assert_array_equal(tpq.pq_decode(pp, pc),
                                  jpq.pq_decode(pp, pc))
    q = _queries(4, seed=2, d=64)
    np.testing.assert_allclose(
        tpq.pq_lut(torch.from_numpy(pp.codebooks), torch.from_numpy(q)),
        np.asarray(jpq.pq_lut(pp.codebooks, q)), atol=1e-5)
    c4 = np.random.default_rng(0).integers(0, 16, (50, 12)).astype(np.uint8)
    packed = tpq.pack_nibbles(c4)
    np.testing.assert_array_equal(packed, jpq.pack_nibbles(c4))
    np.testing.assert_array_equal(tpq.unpack_nibbles(packed), c4)


def test_opq_reduces_error_like_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 64)).astype(np.float32) \
        @ rng.normal(size=(64, 64)).astype(np.float32)
    ro = jopq.train_opq(x, 8, niter=3, pq_iters=4)
    po = topq.train_opq(x, 8, niter=3, pq_iters=4, device="cpu")
    np.testing.assert_allclose(po.rotation @ po.rotation.T, np.eye(64),
                               atol=1e-4)

    def mse(o):
        y = x @ o.rotation
        return np.mean((y - jpq.pq_decode(o.pq, jpq.pq_encode(o.pq, y))) ** 2)

    # the same init and seeds, but fp32 products in another order feed an
    # SVD each iteration, so the rotations drift apart; their quality must
    # not (measured within 1%)
    assert mse(po) <= 1.05 * mse(ro), (mse(po), mse(ro))


def test_train_int4_ranges_identical():
    x = _clustered(500, 16, seed=4)
    for a, b in zip(train_int4_ranges(x), jax_int4_ranges(x)):
        np.testing.assert_array_equal(a, b)


def _row_lists(offs, row_perm):
    """The list of every global row."""
    n = int(offs[-1])
    out = np.empty(n, np.int64)
    out[np.asarray(row_perm)[:n]] = np.searchsorted(
        offs, np.arange(n), side="right") - 1
    return out


@pytest.mark.parametrize("fine_quant", ["SQ8", "SQ4", "OPQ8"])
def test_build_matches_reference(fine_quant):
    ref = JaxIVFIndex.build(_corpus(), _cfg(JaxIVFConfig, fine_quant))
    port = IVFIndex.build(_corpus(), _cfg(IVFConfig, fine_quant),
                          device="cpu")
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), atol=1e-4)
    ra = _row_lists(np.asarray(ref.list_offsets), ref.row_perm)
    pa = _row_lists(port.list_offsets.numpy(), port.row_perm.numpy())
    assert (pa == ra).mean() >= 0.99  # bf16 near-ties may move a row
    assert port.codes.shape == tuple(ref.codes.shape)
    agree = (port.codes.numpy() == np.asarray(ref.codes)).mean()
    # SQ: the same codes; OPQ8: the rotation drifts in the fp32 order of
    # its products (see test_opq_reduces_error_like_reference)
    assert agree >= (0.95 if fine_quant == "OPQ8" else 0.99), agree
    if fine_quant == "SQ4":
        np.testing.assert_array_equal(port.int4_offset.numpy(),
                                      np.asarray(ref.int4_offset))


@pytest.mark.parametrize("two_level", [False, True],
                         ids=["flat", "two_level"])
def test_build_stage_seconds(two_level):
    # both coarse branches report the same stages; the two-level one runs
    # from num_clusters >= two_level_clusters
    stages = {}
    index = IVFIndex.build(_corpus(), _cfg(
        IVFConfig, "SQ8", two_level_clusters=NLIST if two_level else 8192),
        stage_s=stages, device="cpu")
    assert set(stages) == {"sample_s", "kmeans_s", "assign_s", "balance_s",
                           "fine_s"}
    assert all(v >= 0 for v in stages.values())
    assert NLIST <= index.nlist <= np.ceil(1.1 * NLIST) + 1


# ------------------------------------------------------ the save format
@pytest.mark.parametrize("fine_quant,min_recall", [
    ("SQ8", 0.95), ("PQ8", 0.55), ("OPQ8", 0.55), ("OPQ16x4", 0.5),
])
def test_port_save_passes_reference_recall_bands(tmp_path, fine_quant,
                                                 min_recall):
    # tests/test_ivf.py::test_ivf_recall_vs_exact, built by the port and
    # searched by the reference
    x = _clustered(5000, 64, seed=4)
    codes = float_to_int8(x)
    queries = _clustered(16, 64, seed=5)
    _, exact_ids = JaxFlatIndex(codes, chunk=512).search(queries, top_k=10)
    IVFIndex.build(codes, IVFConfig(num_clusters=64, fine_quant=fine_quant,
                                    kmeans_iters=6, pq_iters=4, opq_iters=2),
                   device="cpu").save(str(tmp_path / "ivf"))
    ref = JaxIVFIndex.load(str(tmp_path / "ivf"))
    assert isinstance(ref.cfg, JaxIVFConfig)
    _, ivf_ids = ref.search(queries, top_k=10, nprobe=16)
    recall = np.mean([len(set(e.tolist()) & set(i.tolist())) / 10
                      for e, i in zip(exact_ids, ivf_ids)])
    assert recall >= min_recall, f"{fine_quant} recall@10 {recall}"


def test_port_save_full_probe_sq8_is_near_exact_in_reference(tmp_path):
    # tests/test_ivf.py::test_ivf_full_probe_sq8_is_near_exact
    codes = float_to_int8(_clustered(2000, 64, seed=6))
    queries = _clustered(8, 64, seed=7)
    ev, exact_ids = JaxFlatIndex(codes, chunk=512).search(queries, top_k=5)
    IVFIndex.build(codes, IVFConfig(num_clusters=32, fine_quant="SQ8",
                                    kmeans_iters=5),
                   device="cpu").save(str(tmp_path / "i"))
    iv, ivf_ids = JaxIVFIndex.load(str(tmp_path / "i")).search(
        queries, top_k=5, nprobe=32)
    recall = np.mean([len(set(e.tolist()) & set(i.tolist())) / 5
                      for e, i in zip(exact_ids, ivf_ids)])
    assert recall >= 0.95, recall
    np.testing.assert_allclose(np.sort(iv, 1), np.sort(ev, 1), atol=0.2)


@pytest.mark.parametrize("fine_quant", ["SQ4", "OPQ16x4"])
def test_port_save_round_trips_through_reference(tmp_path, fine_quant):
    port = IVFIndex.build(_corpus(), _cfg(IVFConfig, fine_quant),
                          device="cpu")
    port.save(str(tmp_path / "a"))
    ref = JaxIVFIndex.load(str(tmp_path / "a"))
    q = _queries(8, seed=30)
    _same_results(ref.search(q, top_k=10, nprobe=4),
                  port.search(q, top_k=10, nprobe=4))
    ref.save(str(tmp_path / "b"))  # and back into the port
    again = IVFIndex.load(str(tmp_path / "b"), device="cpu")
    _same_results(port.search(q, top_k=10, nprobe=4),
                  again.search(q, top_k=10, nprobe=4), atol=0)


def test_loading_a_reference_save_imports_no_jax(ref_saves):
    path = ref_saves("OPQ8")
    code = ("import sys\n"
            "from densephrases_tpu_torch.index.ivf import IVFIndex\n"
            f"idx = IVFIndex.load({path!r}, device='cpu')\n"
            "assert idx.pq is not None and idx.rotation is not None\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m.split('.')[0] == 'densephrases_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_ivf_pkl_refuses_other_globals(tmp_path, ref_saves):
    import shutil

    path = tmp_path / "evil"
    shutil.copytree(ref_saves("SQ8"), path)
    with open(path / "ivf.pkl", "wb") as f:
        pickle.dump({"cfg": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        IVFIndex.load(str(path), device="cpu")


def test_legacy_config_without_pq_residual(ref_saves):
    path = ref_saves("PQ8")
    port = IVFIndex.load(path, device="cpu")
    cfg = port.cfg
    del cfg.__dict__["pq_residual"]  # a pre-residual pickle
    legacy = IVFIndex(cfg, port.centroids.numpy(), port.row_perm.numpy(),
                      port.list_offsets.numpy(), port.codes.numpy(),
                      pq=port.pq, n_total=port.n_total, device="cpu")
    assert port.pq_residual and not legacy.pq_residual


def test_unaligned_memmap_codes_serve_like_reference(tmp_path, ref_saves):
    # a legacy save whose code rows are not a multiple of 32, loaded as a
    # memmap: the port pads it on the device as it uploads; the reference,
    # given the same save in RAM, pads it on the host and scans it packed
    path = ref_saves("SQ8")
    port = IVFIndex.load(path, device="cpu")
    offs = port.list_offsets.numpy()
    n_legacy = int(offs[-1]) + port.cap  # cap padding only (tests/test_ivf.py)
    if n_legacy % 32 == 0:
        n_legacy += 8
    codes = np.zeros((n_legacy, D), np.int8)
    perm = np.zeros(n_legacy, np.int64)
    m = min(n_legacy, port.codes.shape[0])
    codes[:m] = port.codes.numpy()[:m]
    perm[:m] = port.row_perm.numpy()[:m]
    np.save(str(tmp_path / "codes.npy"), codes)
    mm = np.load(str(tmp_path / "codes.npy"), mmap_mode="r")
    assert isinstance(mm, np.memmap) and mm.shape[0] % 32
    legacy = IVFIndex(port.cfg, port.centroids.numpy(), perm, offs, mm,
                      n_total=N, device="cpu")
    assert legacy.codes.shape[0] == _round_up(n_legacy, 32)
    assert not legacy.codes[n_legacy:].any()
    assert "codes" not in legacy._host_arrays  # save() writes the padded copy
    ref = JaxIVFIndex(JaxIVFConfig(**vars(port.cfg)),
                      port.centroids.numpy(), perm, offs, np.array(mm),
                      n_total=N)
    assert ref._packed_ok
    q = _queries(8, seed=41)
    for nprobe in (4, NLIST):
        _same_results(ref.search(q, top_k=8, nprobe=nprobe),
                      legacy.search(q, top_k=8, nprobe=nprobe))
    legacy.save(str(tmp_path / "resaved"))
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "resaved" / "codes.npy")),
        legacy.codes.numpy())


def _round_up(x, m):
    return -(-x // m) * m
