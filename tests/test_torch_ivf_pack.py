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
