"""Kernels C and D (their plain twins), the block table, the budget table
and the two-stage top-k against the JAX reference's ``ops/ivf_pack.py``
(its Pallas kernels in interpret mode, with the default env)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densephrases_tpu.ops import ivf_pack as jpack
from densephrases_tpu_torch.ops import ivf_pack as tpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 1500, 256
N_PAD = 1536 + 32  # 48 data blocks and the all-zero pad block
PAD_BLK = N_PAD // 32 - 1
B = 16


def _codes(cols, seed=0, dtype=np.int8, high=None):
    rng = np.random.default_rng(seed)
    codes = np.zeros((N_PAD, cols), dtype)
    if dtype == np.int8:
        codes[:N] = rng.integers(-128, 128, (N, cols))
    else:
        codes[:N] = rng.integers(0, high, (N, cols))
    return codes


def _table(n_real=13, budget=24, seed=1):
    """A block table of n_real real entries (random data blocks, some
    adjacent) and a junk suffix: tile 0 real, tile 1 partly junk, tile 2
    all junk."""
    rng = np.random.default_rng(seed)
    blk = np.full(budget, PAD_BLK, np.int32)
    blk[:n_real] = rng.choice(PAD_BLK, n_real, replace=False)
    return blk, n_real


def _queries(b=B, d=D, seed=2):
    return np.random.default_rng(seed).standard_normal((b, d)) \
        .astype(np.float32)


# fp32 sums of the same exact bf16 x int8 products (|raw| up to ~2,000)
# taken in another order
RAW_ATOL = 2e-3


@pytest.mark.parametrize("sq4", [False, True])
def test_pack_score_plain_matches_pallas(sq4):
    codes = _codes(D // 2 if sq4 else D, seed=3)
    blk, n_real = _table()
    q = _queries()
    q_bf = jnp.asarray(q).astype(jnp.bfloat16)
    ref = np.asarray(jpack._pack_score(q_bf, jnp.asarray(codes),
                                       jnp.asarray(blk), budget=len(blk),
                                       sq4=sq4, interpret=True))
    got = tpack.pack_score_plain(torch.from_numpy(q).to(torch.bfloat16),
                                 torch.from_numpy(codes),
                                 torch.from_numpy(blk), sq4=sq4).numpy()
    assert got.shape == ref.shape == (B, len(blk) * 32)
    valid = n_real * 32
    np.testing.assert_allclose(got[:, :valid], ref[:, :valid], atol=RAW_ATOL,
                               rtol=0)


def _lut(b, m, ksub, seed=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, m, ksub)).astype(np.float32)


@pytest.mark.parametrize("m,ksub", [(8, 256), (16, 16)])
def test_pq_pack_score_plain_matches_pallas(m, ksub, monkeypatch):
    monkeypatch.delenv("DPH_PQ_OH", raising=False)
    monkeypatch.delenv("DPH_PQ_TPB", raising=False)
    cols = m // 2 if ksub == 16 else m
    codes = _codes(cols, seed=5, dtype=np.uint8, high=256)
    blk, n_real = _table(seed=6)
    lut = _lut(B, m, ksub)
    lut_bf = jnp.asarray(lut).astype(jnp.bfloat16)
    codes128 = np.zeros((N_PAD, 128), np.uint8)
    codes128[:, :cols] = codes
    ref = np.asarray(jpack._pq_pack_score(
        lut_bf.reshape(B, m * ksub), jnp.asarray(codes128), jnp.asarray(blk),
        budget=len(blk), m=m, ksub=ksub, interpret=True))
    got = tpack.pq_pack_score_plain(
        torch.from_numpy(lut).to(torch.bfloat16), torch.from_numpy(codes),
        torch.from_numpy(blk)).numpy()
    valid = n_real * 32
    # fp32 sums of the same M bf16 LUT entries (|raw| up to ~15), in
    # another order
    np.testing.assert_allclose(got[:, :valid], ref[:, :valid], atol=1e-4,
                               rtol=0)


def test_cpu_tensors_take_the_plain_twins():
    codes = torch.from_numpy(_codes(D))
    blk = torch.from_numpy(_table()[0])
    q = torch.from_numpy(_queries()).to(torch.bfloat16)
    before = (tpack.IVF_PACK_SCORE.launches, tpack.PQ_PACK_SCORE.launches)
    assert torch.equal(tpack.pack_score(q, codes, blk, sq4=False),
                       tpack.pack_score_plain(q, codes, blk, sq4=False))
    lut = torch.from_numpy(_lut(4, 8, 256)).to(torch.bfloat16)
    pq_codes = torch.from_numpy(_codes(8, dtype=np.uint8, high=256))
    assert torch.equal(tpack.pq_pack_score(lut, pq_codes, blk),
                       tpack.pq_pack_score_plain(lut, pq_codes, blk))
    assert (tpack.IVF_PACK_SCORE.launches,
            tpack.PQ_PACK_SCORE.launches) == before


@pytest.mark.parametrize("kernel", ["C", "D"])
def test_kernel_on_cpu_tensor_raises(kernel):
    blk = torch.from_numpy(_table()[0])
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "C":
            tpack.pack_score(torch.from_numpy(_queries()).to(torch.bfloat16),
                             torch.from_numpy(_codes(D)), blk, sq4=False,
                             impl="cuda")
        else:
            tpack.pq_pack_score(
                torch.from_numpy(_lut(4, 8, 256)).to(torch.bfloat16),
                torch.from_numpy(_codes(8, dtype=np.uint8, high=256)), blk,
                impl="cuda")


def test_import_needs_no_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = REPO
    code = ("from densephrases_tpu_torch.ops.ivf_pack import "
            "IVF_PACK_SCORE, PQ_PACK_SCORE\n"
            "import densephrases_tpu_torch.index.ivf\n"
            "assert IVF_PACK_SCORE._fn is None and PQ_PACK_SCORE._fn is None\n"
            "print(IVF_PACK_SCORE.library_path().name, "
            "PQ_PACK_SCORE.library_path().name)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ivf_pack_score-")
    assert " pq_pack_score-" in proc.stdout


# ------------------------------------------------------------ block table
def _ref_block_table(probe_ids, list_offsets, nlist, cap, pad_blk, budget):
    """The reference's block-table statements, verbatim from
    ``packed_union_scan`` (densephrases_tpu/ops/ivf_pack.py:219-240,
    :256-260), run by jax."""
    RB = jpack.RB
    flat = jnp.sort(probe_ids.reshape(-1))
    keep = jnp.concatenate([jnp.ones((1,), bool), flat[1:] != flat[:-1]])
    uniq = jnp.sort(jnp.where(keep, flat, nlist))
    u_n = uniq.shape[0]
    valid_l = uniq < nlist
    lic = jnp.minimum(uniq, nlist - 1).astype(jnp.int32)
    offs = list_offsets[lic]
    lens = jnp.where(valid_l,
                     jnp.minimum(list_offsets[lic + 1] - offs, cap), 0)
    b0 = offs // RB
    e = (offs + lens + RB - 1) // RB
    start = jnp.maximum(b0, jnp.concatenate(
        [jnp.zeros((1,), e.dtype), e[:-1]]))
    bc = jnp.where(valid_l, jnp.maximum(e - start, 0), 0)
    cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(bc).astype(jnp.int32)])
    total = cum[u_n]
    j = jnp.arange(budget, dtype=jnp.int32)
    u_of = jnp.clip(jnp.searchsorted(cum, j, side="right") - 1, 0, u_n - 1)
    blk = jnp.where(j < total, start[u_of] + (j - cum[u_of]),
                    pad_blk).astype(jnp.int32)
    return np.asarray(blk), int(total)


def _lists(seed, nlist=16, n=1500):
    """Sorted list offsets with ragged lengths that mostly do not align to
    32 rows, so neighbouring lists share boundary blocks."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 2 * n // nlist, nlist)
    lens[rng.integers(0, nlist)] = 0  # an empty list
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@pytest.mark.parametrize("seed,b,nprobe", [(0, 1, 1), (1, 2, 3), (2, 4, 5),
                                           (3, 8, 16), (4, 3, 7)])
def test_block_table_matches_reference(seed, b, nprobe):
    nlist = 16
    offs = _lists(seed)
    n_real = int(offs[-1])
    n_pad = (n_real // 32 + 2) * 32
    pad_blk = n_pad // 32 - 1
    cap = int(np.diff(offs).max())
    table = tpack.pack_budget_table(offs, cap)
    budget = tpack._round_up(int(table[min(b * nprobe, nlist) - 1]), 8)
    rng = np.random.default_rng(100 + seed)
    probe_ids = np.stack([rng.choice(nlist, nprobe, replace=False)
                          for _ in range(b)])
    want, want_total = _ref_block_table(jnp.asarray(probe_ids),
                                        jnp.asarray(offs), nlist, cap,
                                        pad_blk, budget)
    got, total = tpack.block_table(
        torch.from_numpy(probe_ids).long(),
        torch.from_numpy(offs.astype(np.int64)), nlist=nlist, cap=cap,
        pad_blk=pad_blk, budget=budget)
    assert int(total) == want_total
    np.testing.assert_array_equal(got.numpy(), want)
    # disjoint and complete coverage of the probed lists' rows
    rows = (got.numpy()[:want_total, None] * 32 + np.arange(32)).reshape(-1)
    assert len(np.unique(rows)) == len(rows)
    probed = np.unique(probe_ids)
    need = np.concatenate([np.arange(offs[li], offs[li + 1]) for li in probed])
    assert np.isin(need, rows).all()


def test_pack_budget_table_identical():
    for seed in range(4):
        offs = _lists(seed, nlist=32)
        cap = int(np.diff(offs).max())
        for c in (cap, max(cap // 2, 1)):
            np.testing.assert_array_equal(tpack.pack_budget_table(offs, c),
                                          jpack.pack_budget_table(offs, c))


@pytest.mark.parametrize("cols,k", [(300, 7), (8192, 40), (16384, 2100)])
def test_topk2_matches_lax_top_k(cols, k):
    rng = np.random.default_rng(cols)
    # coarse values so that ties occur
    s = np.round(rng.standard_normal((5, cols)) * 8).astype(np.float32)
    s[1, 100:] = -1e30  # a masked tail
    v, i = tpack._topk2(torch.from_numpy(s), k)
    rv, ri = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(np.take_along_axis(s, i.numpy(), 1),
                                  v.numpy())
    # the port breaks ties by the lower index; so does lax.top_k at these
    # widths (at k = 2100 on the CPU it does not always, so there only the
    # values are compared)
    np.testing.assert_array_equal(
        i.numpy(), np.argsort(-s, axis=1, kind="stable")[:, :k])
    if k <= 2048:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(
            i.numpy(), np.asarray(jpack._topk2(jnp.asarray(s), k)[1]))


# ------------------------------------------------ kernel D's fused select
PQ_M = 8


def _pq_layout(seed, *, nlist=32, n=8000, b=6, nprobe=6, dup=True):
    """A PQ layout over ragged lists (boundary blocks straddle two lists),
    each list's copies of one code row (ties), code rows past n_real that
    are not zero (the pad rows must be masked, not merely score low), and
    the batch's block table with a junk suffix (the guard budget, rounded
    to 64 blocks as ``IVFIndex`` rounds it)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(n // nlist // 2, 3 * n // nlist // 2, nlist)
    lens[rng.integers(0, nlist - 1)] = 0  # an empty list
    lens[-1] += (5 - lens.sum()) % 32  # the last block is part padding
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n_real = int(offs[-1])
    n_pad = (n_real // 32 + 2) * 32
    codes = rng.integers(0, 256, (n_pad, PQ_M)).astype(np.uint8)
    if dup:
        for li in range(nlist):
            a, z = offs[li], offs[li + 1]
            if z - a >= 40:  # rows 3 and 37 of the list: another block
                codes[a + 37] = codes[a + 3]
    cap = int(np.diff(offs).max())
    budget = tpack._round_up(int(tpack.pack_budget_table(offs, cap)[
        min(b * nprobe, nlist) - 1]), 64)
    g = torch.Generator().manual_seed(seed)
    cents = torch.randn(nlist, 16, generator=g)
    q = torch.randn(b, 16, generator=g)
    q[0] = 10 * cents[-1]  # query 0 probes the last list
    books = torch.randn(PQ_M, 256, 2, generator=g)
    offs_t = torch.from_numpy(offs)
    blk, total = tpack.block_table(
        tpack.probe(q, cents, nprobe), offs_t, nlist=nlist, cap=cap,
        pad_blk=n_pad // 32 - 1, budget=budget)
    lut = tpack.pq_lut(books, q).to(torch.bfloat16).contiguous()
    return dict(q=q, cents=cents, offs=offs_t, codes=torch.from_numpy(codes),
                blk=blk, total=total, n_real=n_real, lut=lut, budget=budget,
                books=books, cap=cap)


def _todays_select(lay, k, residual):
    """The select after D as the scan ran it before the fusion, verbatim:
    D's twin, the residual of each row's own list, the mask, ``_topk2``."""
    raw = tpack.pq_pack_score_plain(lay["lut"], lay["codes"], lay["blk"])
    src, valid = tpack._valid_rows(lay["blk"], lay["total"], lay["n_real"])
    s = raw
    if residual:
        cs32 = lay["q"] @ lay["cents"].T
        rlist = (torch.searchsorted(lay["offs"], src, right=True) - 1) \
            .clamp(0, lay["cents"].shape[0] - 1)
        s = s + cs32[:, rlist]
    s = torch.where(valid[None, :], s, torch.full_like(s, tpack.NEG_INF))
    return tpack._topk2(s, min(k, s.shape[1]))


def _twin(lay, k, residual):
    return tpack.pq_pack_score_topk_plain(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=k,
        cs32=lay["q"] @ lay["cents"].T if residual else None,
        row_list=tpack.row_lists(lay["offs"], lay["codes"].shape[0],
                                 lay["cents"].shape[0]))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("k", [1, 10, 40, 64])
def test_pq_topk_twin_is_todays_select(k, residual):
    """The fused select's twin gives bit for bit what the scan's select
    gave: the same scores and packed columns, ties to the lower column."""
    lay = _pq_layout(k)
    assert lay["budget"] * 32 > 4096  # _topk2 takes its two stages
    assert int(lay["total"]) < lay["budget"]  # a junk suffix
    want_v, want_c = _todays_select(lay, k, residual)
    got_v, got_c = _twin(lay, k, residual)
    assert torch.equal(got_v, want_v) and torch.equal(got_c, want_c)
    # the planted copies tie, and the layout has rows past n_real
    s_rows = tpack._table_rows(lay["blk"])[:int(lay["total"]) * 32]
    assert (s_rows >= lay["n_real"]).any()


def _kernel_model(lay, k, residual, tiles):
    """``pq_scan_topk``'s lists, modelled on the twin's own scores: tile x
    takes the real entries [x·per, (x+1)·per), per = ⌈total / tiles⌉, and
    keeps its valid columns' k best (score, then the lower column)."""
    raw = tpack.pq_pack_score_plain(lay["lut"], lay["codes"], lay["blk"])
    src, valid = tpack._valid_rows(lay["blk"], lay["total"], lay["n_real"])
    if residual:
        rows = tpack.row_lists(lay["offs"], lay["codes"].shape[0],
                               lay["cents"].shape[0])
        raw = raw + (lay["q"] @ lay["cents"].T)[:, rows[src].long()]
    b, total = raw.shape[0], int(lay["total"])
    per = -(-total // tiles)
    vals = torch.full((b, tiles, k), -float("inf"))
    cols = torch.full((b, tiles, k), -1, dtype=torch.int32)
    for x in range(tiles):
        c = torch.arange(32 * min(total, x * per),
                         32 * min(total, (x + 1) * per))
        c = c[valid[c]]
        for i in range(b):
            order = sorted(c.tolist(), key=lambda j: (-float(raw[i, j]), j))
            order = order[:k]
            vals[i, x, :len(order)] = raw[i, order]
            cols[i, x, :len(order)] = torch.tensor(order, dtype=torch.int32)
    return vals.reshape(b, -1), cols.reshape(b, -1)


@pytest.mark.parametrize("tiles", [1, 3, 40])
@pytest.mark.parametrize("k,residual,nprobe", [
    (1, True, 6), (10, False, 6), (40, True, 6), (64, True, 6),
    (64, False, 1)])
def test_tile_lists_merge_to_the_twin(k, residual, nprobe, tiles):
    """The kernel's contract, modelled: per-tile lists over contiguous runs
    of the real entries, then ``merge_pq_tiles``, give the twin's scores
    and columns exactly; with fewer valid columns than k (one probe), the
    merge pads with the first invalid columns at NEG_INF, as the twin's
    masked sort does. 40 tiles leave some empty."""
    lay = _pq_layout(100 + k, nprobe=nprobe, b=3)
    n_valid = tpack._valid_count(lay["blk"], lay["total"], lay["n_real"])
    _, valid = tpack._valid_rows(lay["blk"], lay["total"], lay["n_real"])
    assert int(n_valid) == int(valid.sum())
    assert bool(valid[:int(n_valid)].all())  # the valid columns lead
    vals, cols = _kernel_model(lay, k, residual, tiles)
    got_v, got_c = tpack.merge_pq_tiles(vals, cols, n_valid, k)
    want_v, want_c = _twin(lay, k, residual)
    assert torch.equal(got_v, want_v) and torch.equal(got_c, want_c)


def test_pq_topk_plan_at_the_serve_shape():
    """128 stacked query rows, OPQ96, k 40: 4 queries a block beside their
    lists (197,936 bytes), 32 groups, 4 tiles each: one wave on 132 SMs,
    lists of 160 KB."""
    bq, smem, groups, tiles = tpack.pq_topk_plan(128, 96, 40, 132)
    assert (bq, smem, groups, tiles) == (4, 4 * (96 * 512 + 332), 32, 4)
    assert smem <= tpack.SMEM_MAX and groups * tiles <= 132
    assert 128 * tiles * 40 * 8 == 163840
    for m in (8, 24, 96, 112):
        for k in (1, 40, tpack.PQ_K_MAX):
            bq, smem, _, _ = tpack.pq_topk_plan(130, m, k, 132)
            assert smem == bq * (m * 512 + 8 * k + 12) <= tpack.SMEM_MAX


@pytest.mark.parametrize("ksub,scan_k,on_card", [
    (256, 40, True), (256, tpack.PQ_K_MAX, True), (16, 40, False),
    (256, tpack.PQ_K_MAX + 1, False)])
def test_pq_select_route(ksub, scan_k, on_card):
    """A CUDA device with 8-bit codes and k <= 64 takes the fused select;
    4-bit codes and k > 64 keep D's scores and the select after it. CPU
    tensors always keep the plain twins: no tile count, D's scores counted
    instead (``index.ivf.rows_scored``), no launch of either entry."""
    from densephrases_tpu_torch.utils import profiling

    assert tpack.pq_fused_route("cuda", ksub, scan_k) is on_card
    assert tpack.pq_fused_route("cuda:1", ksub, scan_k) is on_card
    assert not tpack.pq_fused_route("cpu", ksub, scan_k)
    lay = _pq_layout(5, b=4)
    m = PQ_M if ksub == 256 else 2 * PQ_M
    g = torch.Generator().manual_seed(6)
    books = torch.randn(m, ksub, 16 // m, generator=g)
    codes = lay["codes"] if ksub == 256 else lay["codes"] & 0x77
    row_perm = torch.arange(codes.shape[0], dtype=torch.int32)
    before = (tpack.PQ_PACK_SCORE.launches, tpack.PQ_SCAN_TOPK.launches)
    with profiling.recording() as rec:
        vals, gids = tpack.packed_pq_scan(
            lay["q"], lay["q"], lay["cents"], lay["offs"], codes, row_perm,
            books, None, 0.0, 1.0, top_k=scan_k, nprobe=6, cap=lay["cap"],
            budget=lay["budget"], n_real=lay["n_real"], scan_k=scan_k,
            pq_residual=True, row_list=tpack.row_lists(
                lay["offs"], codes.shape[0], lay["cents"].shape[0]))
    counters = rec.counters()
    assert "index.ivf.kernel_tiles" not in counters
    _, valid = tpack._valid_rows(lay["blk"], lay["total"], lay["n_real"])
    assert counters["index.ivf.rows_scored"] == 4 * int(valid.sum())
    assert (tpack.PQ_PACK_SCORE.launches,
            tpack.PQ_SCAN_TOPK.launches) == before
    assert tuple(gids.shape) == (4, scan_k)


def test_fused_kernel_symbol_keeps_pq_scan():
    """Kernel D's device time is found by the fragment ``pq_scan``
    (``portbench/metrics.pq_roofline``): every ``__global__`` of its
    source, the fused select's included, holds it."""
    import re

    src = open(os.path.join(REPO, "densephrases_tpu_torch", "csrc",
                            "pq_pack_score.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert "pq_scan8_topk" in names and "pq_scan8" in names
    assert all("pq_scan" in n for n in names)


def test_fused_entry_counts_on_its_own(monkeypatch):
    """The fused select is an entry of kernel D's library (the same hash)
    with a launch count of its own: its launches leave D's count as it
    was, and a failed launch counts on neither."""
    assert (tpack.PQ_SCAN_TOPK.library_path()
            == tpack.PQ_PACK_SCORE.library_path())
    assert tpack.PQ_SCAN_TOPK.symbol != tpack.PQ_PACK_SCORE.symbol
    fused, d = tpack.PQ_SCAN_TOPK, tpack.PQ_PACK_SCORE
    before = (fused.launches, d.launches)
    monkeypatch.setattr(fused, "_fn", lambda *a: 0)
    fused.launch()
    fused.launch()
    assert (fused.launches, d.launches) == (before[0] + 2, before[1])
    monkeypatch.setattr(fused, "_fn", lambda *a: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fused.launch()
    assert (fused.launches, d.launches) == (before[0] + 2, before[1])
    fused.launches = before[0]


def test_residual_scan_needs_its_row_list():
    """``packed_pq_scan`` over residual codes takes the index's row lists
    (built once, where the index uploads its codes) and builds none."""
    lay = _pq_layout(8, b=2)
    with pytest.raises(ValueError, match="row_list"):
        tpack.packed_pq_scan(
            lay["q"], lay["q"], lay["cents"], lay["offs"], lay["codes"],
            torch.arange(lay["codes"].shape[0], dtype=torch.int32),
            lay["books"], None, 0.0, 1.0, top_k=10, nprobe=6,
            cap=lay["cap"], budget=lay["budget"], n_real=lay["n_real"],
            scan_k=10, pq_residual=True)


def _topk_args(b=4, m=8, rows=64):
    return dict(lut_bf=torch.zeros((b, m, 256), dtype=torch.bfloat16),
                codes=torch.zeros((rows, m), dtype=torch.uint8),
                blk=torch.zeros(8, dtype=torch.int32),
                total=torch.zeros((), dtype=torch.int64),
                cs32=torch.zeros((b, 3)),
                row_list=torch.zeros(rows, dtype=torch.int32))


@pytest.mark.parametrize("bad,k,match", [
    (dict(lut_bf=torch.zeros((4, 8, 256))), 10, "lut must be bf16"),
    (dict(lut_bf=torch.zeros((4, 8, 16), dtype=torch.bfloat16)), 10,
     "lut must be bf16"),
    (dict(codes=torch.zeros((64, 4), dtype=torch.uint8)), 10,
     "codes must be uint8"),
    (dict(codes=torch.zeros((64, 8), dtype=torch.int8)), 10,
     "codes must be uint8"),
    (dict(blk=torch.zeros(7, dtype=torch.int32)), 10, "blk must be int32"),
    (dict(total=torch.zeros((), dtype=torch.int32)), 10,
     "total must be one int64"),
    ({}, 0, "k=0"), ({}, tpack.PQ_K_MAX + 1, "k=65"),
    (dict(row_list=None), 10, "go together"),
    (dict(cs32=torch.zeros((4, 3), dtype=torch.float64)), 10,
     "cs32 must be"),
    (dict(cs32=torch.zeros((3, 4)).T), 10, "cs32 must be"),
    (dict(row_list=torch.zeros(64, dtype=torch.int64)), 10,
     "row_list must be"),
    (dict(row_list=torch.zeros((64, 2), dtype=torch.int32)[:, 0]), 10,
     "row_list must be"),
    (dict(lut_bf=torch.zeros((4, 256, 8), dtype=torch.bfloat16)
          .transpose(1, 2)), 10, "lut must be bf16|contiguous"),
    ({}, 10, "CUDA tensors"),
])
def test_pq_scan_topk_refuses(bad, k, match):
    """The fused select's wrapper refuses what its kernel cannot take, and
    CPU tensors, before any launch."""
    args = {**_topk_args(), **bad}
    before = tpack.PQ_SCAN_TOPK.launches
    with pytest.raises(ValueError, match=match):
        tpack.pq_scan_topk(args.pop("lut_bf"), args.pop("codes"),
                           args.pop("blk"), args.pop("total"), n_real=60,
                           k=k, **args)
    assert tpack.PQ_SCAN_TOPK.launches == before
