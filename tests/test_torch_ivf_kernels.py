"""The arithmetic and layouts of kernels C and D (``csrc/ivf_pack_score.cu``,
``csrc/pq_pack_score.cu``) modelled on the CPU, each held against the plain
twins of ``densephrases_tpu_torch/ops/ivf_pack.py``; the twins are held
against the Pallas kernels in interpret mode by ``test_torch_ivf_pack.py``.
The kernels themselves run only on the card (``chip_smoke.py`` phase 2)."""

import numpy as np
import pytest
import torch

from densephrases_tpu_torch.ops import ivf_pack as tpack

RB = tpack.RB


def _layout(n_blocks=12, n_real=7, budget=16, seed=0):
    """A block table of n_real distinct blocks and a junk suffix."""
    rng = np.random.default_rng(seed)
    blk = np.full(budget, n_blocks, np.int32)
    blk[:n_real] = rng.choice(n_blocks, n_real, replace=False)
    return torch.from_numpy(blk), n_real * RB


def _codes(n_blocks, cols, seed, signed):
    rng = np.random.default_rng(seed)
    codes = np.zeros(((n_blocks + 1) * RB, cols),
                     np.int8 if signed else np.uint8)
    lo, hi = (-128, 128) if signed else (0, 256)
    codes[:n_blocks * RB] = rng.integers(lo, hi, (n_blocks * RB, cols))
    return torch.from_numpy(codes)


# ------------------------------------------------- bit-level device helpers
def _bf16_bits_to_f32(h):
    return (np.asarray(h, np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits_rn(x):
    """Round-to-nearest-even fp32 → bf16 bits."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _halves(w):
    w = np.asarray(w, np.uint32)
    return w & 0xFFFF, w >> 16


def _bf16x2_sub(a, b):
    """fma.rn.bf16x2(a, 1.0, -b), per half, as exact fp32 then RN to bf16."""
    out = np.zeros_like(np.asarray(a, np.uint32))
    for sh, (ha, hb) in enumerate(zip(_halves(a), _halves(b))):
        d = _bf16_bits_to_f32(ha).astype(np.float64) - \
            _bf16_bits_to_f32(hb).astype(np.float64)
        r = _f32_to_bf16_bits_rn(d.astype(np.float32))
        # the subtraction must be exact for the kernel's use
        assert np.array_equal(_bf16_bits_to_f32(r).astype(np.float64), d)
        out |= r << (16 * sh)
    return out


def _spread_pair(w, j):
    """__byte_perm(w, 0, j ? 0x4342 : 0x4140): bytes 2j, 2j+1 into the low
    bytes of the two 16-bit halves."""
    w = np.asarray(w, np.uint32)
    b0 = (w >> (16 * j)) & 0xFF
    b1 = (w >> (16 * j + 8)) & 0xFF
    return b0 | (b1 << 16)


def _s8x2_to_bf16x2(v):
    return _bf16x2_sub((v & 0x007F007F) | 0x43004300,
                       (v & 0x00800080) | 0x43004300)


def _u4x2_to_bf16x2(v, hi):
    n = ((v >> 4) if hi else v) & 0x000F000F
    return _bf16x2_sub(n | 0x43004300, np.uint32(0x43004300))


def _decode_pair(w):
    lo, hi = _halves(w)
    return _bf16_bits_to_f32(lo), _bf16_bits_to_f32(hi)


def _all_byte_words():
    """Words whose 4 bytes run through all 256 values in every position."""
    b = np.arange(256, dtype=np.uint32)
    return b | (((b + 85) % 256) << 8) | (((b + 170) % 256) << 16) | \
        (((b + 37) % 256) << 24)


@pytest.mark.parametrize("j", [0, 1])
def test_int8_to_bf16_is_exact_on_every_byte(j):
    """(c) C's SQ8 conversion: every signed byte value, in either byte pair
    of a word, becomes its exact bf16."""
    w = _all_byte_words()
    got = _decode_pair(_s8x2_to_bf16x2(_spread_pair(w, j)))
    for k, g in enumerate(got):
        want = ((w >> (8 * (2 * j + k))) & 0xFF).astype(np.uint8) \
            .view(np.int8).astype(np.float32)
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("hi", [True, False])
def test_nibble_to_bf16_is_exact_on_every_byte(hi):
    """(c) C's SQ4 conversion: the high or low nibble of every byte value."""
    w = _all_byte_words()
    for j in (0, 1):
        got = _decode_pair(_u4x2_to_bf16x2(_spread_pair(w, j), hi))
        for k, g in enumerate(got):
            byte = (w >> (8 * (2 * j + k))) & 0xFF
            want = (byte >> 4 if hi else byte & 0xF).astype(np.float32)
            np.testing.assert_array_equal(g, want)


# ------------------------------------------ kernel C: fragment-level model
def _bank(q_bf, code_bytes, sq4):
    """The block's shared query bank as the kernel fills it: row = [segment
    0 | segment 1 (SQ4)], each seg_w wide, zeros past a segment's dims and
    in the row padding. Returns (bank [b, stride] fp32, seg_w)."""
    b, dim = q_bf.shape
    _, _, stride, _ = tpack.scan_plan(b, code_bytes, sq4=sq4)
    seg_w = tpack._round_up(code_bytes, 32)
    seg_dims = dim // 2 if sq4 else dim
    bank = np.zeros((b, stride), np.float32)
    q = q_bf.float().numpy()
    for seg in range(2 if sq4 else 1):
        bank[:, seg * seg_w:seg * seg_w + seg_dims] = \
            q[:, seg * seg_dims:(seg + 1) * seg_dims]
    return bank, seg_w


def _pack_score_model(q_bf, rows, sq4):
    """Kernel C's arithmetic, lane by lane, over code rows [R, code_bytes]
    (R a multiple of 16): each lane (g, t) of a 16-row tile reads 8 code
    bytes per 32-byte chunk, converts them as the kernel does, and the A and
    B fragments are read back through mma.m16n8k16's fragment layout into
    matrices whose product is summed over k-blocks, chunks and (SQ4) both
    halves. Returns [B, R] scores."""
    b = q_bf.shape[0]
    n_rows, code_bytes = rows.shape
    bank, seg_w = _bank(q_bf, code_bytes, sq4)
    padded = np.zeros((n_rows, tpack._round_up(code_bytes, 32)), np.uint8)
    padded[:, :code_bytes] = rows
    words = padded.view(np.uint32)  # little-endian words of each row
    out = np.zeros((b, n_rows))
    n_pad = tpack._round_up(b, 8)
    qb = np.zeros((n_pad, bank.shape[1]), np.float32)
    qb[:b] = bank
    for r0 in range(0, n_rows, 16):
        acc = np.zeros((16, n_pad))
        for c in range(padded.shape[1] // 32):
            for half in ((True, 0), (False, seg_w)) if sq4 else ((None, 0),):
                hi, off = half
                for kb in range(2):
                    a = np.zeros((16, 16))
                    bm = np.zeros((16, n_pad))
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        regs = []
                        for row in (g, g + 8):
                            w = words[r0 + row, c * 8 + 2 * t + kb]
                            regs.append([
                                _u4x2_to_bf16x2(_spread_pair(w, j), hi)
                                if sq4 else _s8x2_to_bf16x2(_spread_pair(w, j))
                                for j in (0, 1)])
                        # a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 8+2t..),
                        # a3 (g+8, 8+2t..)
                        for reg, (row, k0) in zip(
                                (regs[0][0], regs[1][0], regs[0][1],
                                 regs[1][1]),
                                ((g, 2 * t), (g + 8, 2 * t), (g, 8 + 2 * t),
                                 (g + 8, 8 + 2 * t))):
                            a[row, k0:k0 + 2] = _decode_pair(reg)
                        for nt in range(n_pad // 8):
                            n = nt * 8 + g
                            # b0 (k 2t.., n g), b1 (k 8+2t.., n g) from the
                            # 16-byte row read at 32c + 8t of the segment
                            vals = qb[n, off + 32 * c + 8 * t + 4 * kb:
                                      off + 32 * c + 8 * t + 4 * kb + 4]
                            bm[2 * t:2 * t + 2, n] = vals[:2]
                            bm[8 + 2 * t:10 + 2 * t, n] = vals[2:]
                    acc += a @ bm
        out[:, r0:r0 + 16] = acc[:, :b].T
    return out


@pytest.mark.parametrize("b,dim,sq4", [(3, 64, False), (5, 64, True),
                                       (9, 68, False), (4, 72, True)])
def test_pack_score_fragment_model_matches_plain(b, dim, sq4):
    """(c) C's conversion, k-permutation, fragment layouts and query bank,
    at row widths with a partial last chunk, against pack_score_plain."""
    codes = _codes(3, dim // 2 if sq4 else dim, seed=dim, signed=True)
    blk = torch.tensor([2] + [3] * 7, dtype=torch.int32)  # one real block
    q = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (b, dim)).astype(np.float32)).to(torch.bfloat16)
    rows = codes[tpack._table_rows(blk)[:RB]].numpy().view(np.uint8)
    got = _pack_score_model(q, rows, sq4)
    want = tpack.pack_score_plain(q, codes, blk, sq4=sq4).numpy()[:, :RB]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# ------------------------------------------------------ kernel D: 8-bit
def _query_minor(lut_bf, q0, bq):
    """load_lut_query_minor: natural [B, M, 256] bf16 → the flat
    [M][256][bq] table, built as the kernel does: run i of 8 codes, one
    16-byte read per query, 8 bq-vectors packed two bf16 a word."""
    bits = lut_bf.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    b, m, ksub = bits.shape
    flat = np.zeros(m * ksub * bq, np.uint32)
    nat = bits.reshape(b, m * ksub)
    for i in range(m * ksub // 8):
        v = [nat[q0 + qb, 8 * i:8 * i + 8] if q0 + qb < b
             else np.zeros(8, np.uint32) for qb in range(bq)]
        for j in range(8):
            p = np.zeros(max(bq // 2, 1), np.uint32)
            for qb in range(bq):
                word = v[qb][2 * (j >> 1)] | (v[qb][2 * (j >> 1) + 1] << 16)
                h = (word >> (16 * (j & 1))) & 0xFFFF
                p[qb >> 1] |= h << (16 * (qb & 1))
            e = i * 8 + j
            halves = np.stack([p & 0xFFFF, p >> 16], 1).reshape(-1)[:bq]
            flat[e * bq:(e + 1) * bq] = halves
    return flat


@pytest.mark.parametrize("bq", [1, 2, 4, 8])
def test_query_minor_lut_index_map(bq):
    """(b) Element (m*256 + k)*bq + qb of the kernel's table holds
    LUT[q0 + qb, m, k]; queries past the batch are zeros."""
    rng = np.random.default_rng(bq)
    b, m = 5, 3
    lut = torch.from_numpy(rng.standard_normal((b, m, 256)).astype(
        np.float32)).to(torch.bfloat16)
    nat = lut.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    for q0 in range(0, b, bq):
        flat = _query_minor(lut, q0, bq)
        mm, kk, qq = np.meshgrid(np.arange(m), np.arange(256),
                                 np.arange(bq), indexing="ij")
        got = flat[(mm * 256 + kk) * bq + qq]
        want = np.where(q0 + qq < b, nat[np.minimum(q0 + qq, b - 1), mm, kk],
                        0)
        np.testing.assert_array_equal(got, want)


def test_query_minor_gather_matches_plain():
    """(b) The 8-bit kernel's sum over subspaces of one bq-vector per code
    byte, from the query-minor table, equals pq_pack_score_plain."""
    rng = np.random.default_rng(7)
    b, m, bq = 6, 24, 4
    lut = torch.from_numpy(rng.standard_normal((b, m, 256)).astype(
        np.float32)).to(torch.bfloat16)
    codes = _codes(4, m, seed=8, signed=False)
    blk, valid = _layout(n_blocks=4, n_real=3, budget=8, seed=9)
    rows = codes[tpack._table_rows(blk)].numpy()[:valid].astype(np.int64)
    got = np.zeros((b, valid), np.float32)
    for q0 in range(0, b, bq):
        table = _bf16_bits_to_f32(_query_minor(lut, q0, bq))
        for qb in range(min(bq, b - q0)):
            acc = np.zeros(valid, np.float32)
            for s in range(m):  # the kernel's order: subspace by subspace
                acc += table[(s * 256 + rows[:, s]) * bq + qb]
            got[q0 + qb] = acc
    want = tpack.pq_pack_score_plain(lut, codes, blk).numpy()[:, :valid]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------ kernel D: 4-bit
def _onehot2(s):
    """__funnelshift_lc(0, 0x3F80, s): the high word of {0x3F80 : 0} <<
    min(s, 32), s unsigned."""
    s = np.minimum(np.asarray(s, np.uint64) & 0xFFFFFFFF, 32)
    return ((np.uint64(0x3F80) << np.uint64(32)) << s >> np.uint64(32)) \
        .astype(np.uint64) & 0xFFFFFFFF


def test_onehot_fragment_is_the_one_hot_of_the_nibble():
    """(a) The A fragment each lane builds by funnel shifts, read back
    through the m16n8k16 A layout, is the [16 rows x 16 codes] one-hot of
    the rows' nibbles, for every nibble in every row position."""
    rng = np.random.default_rng(0)
    for trial in range(8):
        nib = rng.integers(0, 16, 16) if trial else np.arange(16)
        a = np.zeros((16, 16), np.float32)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            lo, hi = 16 * int(nib[g]), 16 * int(nib[g + 8])
            regs = [_onehot2((x - 32 * t - k) & 0xFFFFFFFF)
                    for x, k in ((lo, 0), (hi, 0), (lo, 128), (hi, 128))]
            for reg, (row, k0) in zip(regs, ((g, 2 * t), (g + 8, 2 * t),
                                             (g, 8 + 2 * t),
                                             (g + 8, 8 + 2 * t))):
                a[row, k0:k0 + 2] = _decode_pair(np.uint32(reg))
        np.testing.assert_array_equal(a, np.eye(16, dtype=np.float32)[nib])


@pytest.mark.parametrize("m", [2, 12, 16])
def test_onehot_product_matches_plain(m):
    """(a) The 4-bit kernel's product: per subspace a [rows x 16] one-hot
    (low nibble = subspace 2i, high = 2i+1) times LUT[:, m, :]ᵀ, summed over
    m in fp32, equals pq_pack_score_plain."""
    rng = np.random.default_rng(m)
    b = 5
    lut = torch.from_numpy(rng.standard_normal((b, m, 16)).astype(
        np.float32)).to(torch.bfloat16)
    codes = _codes(4, m // 2, seed=m, signed=False)
    blk, valid = _layout(n_blocks=4, n_real=3, budget=8, seed=m + 1)
    rows = codes[tpack._table_rows(blk)].long()
    nib = torch.stack([rows & 0xF, rows >> 4], dim=-1).reshape(
        rows.shape[0], m)
    acc = torch.zeros(b, rows.shape[0])
    for s in range(m):
        oh = torch.nn.functional.one_hot(nib[:, s], 16).to(torch.bfloat16)
        acc += (lut[:, s, :].float() @ oh.float().T)
    want = tpack.pq_pack_score_plain(lut, codes, blk)
    torch.testing.assert_close(acc[:, :valid], want[:, :valid], rtol=0,
                               atol=1e-5)


# ------------------------------------------------- launch arithmetic
def test_scan_plan_at_the_serve_shape():
    """(d) 128 query rows of 768 dims: one block of 128 queries (nt 16),
    rows padded to 800 bf16 (1,600 bytes = 64 past a multiple of 128)."""
    assert tpack.scan_plan(128, 768, sq4=False) == (16, 128, 800, 204800)
    assert tpack.scan_plan(128, 384, sq4=True) == (16, 128, 800, 204800)
    assert tpack.scan_plan(130, 768, sq4=False)[0] == 16


@pytest.mark.parametrize("b", [1, 8, 9, 16, 17, 37, 64, 65, 128, 130])
def test_scan_plan_groups_and_fit(b):
    """(d) Blocks hold the fewest n-tiles that cover the batch (at most 16),
    fit the shared memory, and keep the 16-byte B loads conflict-free."""
    for code_bytes, sq4 in ((64, False), (68, False), (36, True),
                            (768, False), (384, True), (1024, False)):
        nt, bq, stride, smem = tpack.scan_plan(b, code_bytes, sq4=sq4)
        assert nt in (2, 4, 8, 16) and bq == 8 * nt
        assert smem == bq * stride * 2 <= tpack.SMEM_MAX
        assert (2 * stride) % 128 == 64
        width = (2 if sq4 else 1) * tpack._round_up(code_bytes, 32)
        assert width <= stride
        if bq < b:
            assert nt == 16 or 2 * bq * stride * 2 > tpack.SMEM_MAX
        else:
            assert nt == 2 or bq // 2 < b


def test_scan_plan_refuses_rows_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        tpack.scan_plan(4, 8192, sq4=False)


@pytest.mark.parametrize("b,m,ksub,want", [
    (128, 96, 256, (4, 196608)), (2, 96, 256, (2, 98304)),
    (1, 96, 256, (1, 49152)), (130, 8, 256, (8, 32768)),
    (128, 24, 256, (8, 98304)), (128, 192, 16, (32, 197120)),
    (16, 192, 16, (16, 98560)), (37, 12, 16, (32, 12800))])
def test_pq_plan(b, m, ksub, want):
    """(d) Kernel D's queries per block and shared memory."""
    assert tpack.pq_plan(b, m, ksub) == want
    assert want[1] <= tpack.SMEM_MAX


def test_pq_plan_4bit_rows_keep_ldmatrix_conflict_free():
    """(d) A 4-bit LUT row of M*16 bf16 plus the 8-bf16 pad is an odd
    multiple of 16 bytes modulo 128, so ldmatrix's 8 rows fall in 8 bank
    groups, at every even M whose 16 LUTs fit."""
    for m in range(2, 400, 2):
        stride_bytes = (m * 16 + 8) * 2
        assert (stride_bytes % 128) // 16 % 2 == 1
        bq, smem = tpack.pq_plan(64, m, 16)
        assert smem == bq * stride_bytes <= tpack.SMEM_MAX


def test_pq_plan_refuses_luts_too_large():
    with pytest.raises(ValueError, match="shared memory"):
        tpack.pq_plan(4, 512, 256)
    with pytest.raises(ValueError, match="shared memory"):
        tpack.pq_plan(4, 1024, 16)


@pytest.mark.parametrize("row_bytes,ptr,widths,want", [
    (96, 0, (16, 4, 1), 16), (24, 0, (16, 4, 1), 4), (6, 0, (16, 4, 1), 1),
    (96, 8, (16, 4, 1), 4), (96, 3, (16, 4, 1), 1), (768, 0, (8, 4), 8),
    (68, 0, (8, 4), 4), (768, 4, (8, 4), 4), (768, 2, (8, 4), 0)])
def test_load_width(row_bytes, ptr, widths, want):
    """(d) The code loads' width divides the row width and the address."""
    assert tpack.load_width(row_bytes, ptr, widths) == want


def test_check_aligned():
    """The alignment repair: an offset view raises ValueError."""
    base = torch.zeros(64, dtype=torch.uint8)
    tpack.check_aligned(base.data_ptr(), 16, "codes")
    with pytest.raises(ValueError, match="codes must be 16-byte aligned"):
        tpack.check_aligned(base[3:].data_ptr(), 16, "codes")
    with pytest.raises(ValueError, match="q must be 8-byte aligned"):
        tpack.check_aligned(base[4:].data_ptr(), 8, "q")
