"""Kernel E (``csrc/flat_scan_topk.cu``), the flat int8 scan with a per-tile
top-k, and the route that chooses it (``index/flat.py:kernel_route``).

On the CPU: E's launch arithmetic (``ops/flat_scan.py:flat_scan_plan``), its
query bank's swizzle, its raw floor, the tiles-then-merge tie rule, the
route, and the wrapper's refusals. On the card (skipped without one): E
against its plain twin, the chunked loop, on the same CUDA tensors. This
file imports no JAX, so on a card's machine without it:

    python -m pytest --noconftest tests/test_torch_flat_scan.py -q
"""

import numpy as np
import pytest
import torch

from densephrases_tpu_torch.index import flat
from densephrases_tpu_torch.ops import flat_scan as tflat
from densephrases_tpu_torch.ops import ivf_pack as tpack
from densephrases_tpu_torch.ops.topk import topk

OFFSET, SCALE = -2.0, 20.0
N_SM = 132  # the H100's SMs


# ------------------------------------------------------ launch arithmetic
def test_flat_scan_plan_at_the_serve_shape():
    """128 stacked query rows over the cell's padded 1M x 768 buffer, k 10:
    one query group, 131 tiles of 7,680 rows (one wave over 132 SMs), a
    1.3 MB candidate buffer."""
    p = tflat.flat_scan_plan(128, 768, 10, 1003520, N_SM)
    assert p == (16, 128, 1, 768, 128 * (1536 + 96), 7680, 131)
    assert 128 * p.tiles * 10 * 8 == 1341440


@pytest.mark.parametrize("b", [1, 64, 128, 130, 1024])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("rows", [40, 2047, 2049, 1_000_000, 10_485_760])
def test_flat_scan_plan_tiles_and_fit(b, k, rows):
    for dim in (64, 100, 768, 1024):
        p = tflat.flat_scan_plan(b, dim, k, rows, N_SM)
        assert p.nt in (2, 4, 8, 16) and p.bq == 8 * p.nt
        assert p.groups * p.bq >= b > (p.groups - 1) * p.bq
        assert p.stride % 64 == 0 and dim <= p.stride < dim + 64
        assert p.smem == p.bq * (2 * p.stride + 4 * (2 * k + 4))
        assert p.smem <= tpack.SMEM_MAX
        assert p.tile_rows >= tflat.FLAT_TILE_MIN and p.tile_rows % 256 == 0
        assert (p.tiles - 1) * p.tile_rows < rows <= p.tiles * p.tile_rows
        if p.tile_rows > tflat.FLAT_TILE_MIN:  # one wave
            assert p.tiles * p.groups <= N_SM
        if rows == 1_000_000:
            assert b * p.tiles * k * 8 <= 5_000_000


def test_flat_scan_plan_refuses_rows_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        tflat.flat_scan_plan(4, 8192, 10, 100_000, N_SM)


# ------------------------------------------------- the kernel's arithmetic
def _bank_write(qb: int, d0: int) -> int:
    """Where the kernel's query-bank copy puts dims d0..d0+3 of row qb (in
    bf16 within the row): 16-byte unit u at u ^ 4 (qb & 1)."""
    return ((((d0 >> 3) ^ ((qb & 1) << 2))) << 3) | (d0 & 7)


@pytest.mark.parametrize("dim", [64, 96, 768])
def test_query_bank_swizzle_is_read_back_and_conflict_free(dim):
    """The B loads find the dims the copies put down, and the 8 lanes of a
    quarter warp (rows g = 0, 1 of an n-tile, t = 0..3) read 8 distinct
    16-byte bank groups."""
    stride = tflat.flat_scan_plan(16, dim, 10, 4096, N_SM).stride
    bank = np.full((16, stride), -1)
    for qb in range(16):
        for d0 in range(0, stride, 4):
            pd = _bank_write(qb, d0)
            bank[qb, pd:pd + 4] = np.arange(d0, d0 + 4)
    assert (bank >= 0).all()  # a permutation of each row
    for c in range(-(-dim // 32)):
        for nt in range(2):
            groups = []
            for g in range(8):
                for t in range(4):
                    row = nt * 8 + g
                    unit = (4 * c + t) ^ ((g & 1) << 2)
                    got = bank[row, unit * 8:unit * 8 + 8]
                    np.testing.assert_array_equal(
                        got, np.arange(32 * c + 8 * t, 32 * c + 8 * t + 8))
                    if g < 2:  # the first quarter warp
                        groups.append((row * stride * 2 + unit * 16) % 128
                                      // 16)
            assert sorted(groups) == list(range(8))


def _score(raw, qsum):
    """The kernel's score: fp32 raw / scale, then + qsum, each rounded."""
    return np.float32(np.float32(raw) / np.float32(SCALE)) + np.float32(qsum)


def _raw_floor(kth, qsum):
    """csrc/flat_scan_topk.cu:raw_floor in double, rounded down to fp32."""
    x = float(kth) - float(qsum)
    eps = (abs(x) + abs(float(kth))) * 2.0 ** -22 + 1e-37
    r = (x - eps) * SCALE
    f = np.float32(r)
    return np.nextafter(f, np.float32(-np.inf)) if float(f) > r else f


def test_raw_floor_is_safe_and_tight():
    """Every raw sum below the floor scores below the k-th (the largest
    fp32 below it does, and the score is monotone), and the floor sits
    within 2^-19 of the k-th's own raw sum, so it keeps the filter tight."""
    rng = np.random.default_rng(0)
    for _ in range(3000):
        qsum = np.float32(rng.normal() * 10 ** rng.uniform(-3, 3))
        raw_k = np.float32(rng.normal() * 10 ** rng.uniform(-2, 5))
        kth = _score(raw_k, qsum)
        fl = _raw_floor(kth, qsum)
        below = np.nextafter(fl, np.float32(-np.inf))
        assert _score(below, qsum) < kth
        assert _score(fl, qsum) <= kth
        gap = abs(float(raw_k) - float(fl))
        assert gap <= 2.0 ** -19 * (abs(float(raw_k)) + SCALE * (
            abs(float(kth)) + abs(float(qsum)))) + 1e-30


def _tile_lists(scores, tile_rows, k):
    """E's output modelled: each tile's k best (score, row), best first,
    ties to the lower row; empty slots -inf and -1."""
    b, n = scores.shape
    tiles = -(-n // tile_rows)
    vals = np.full((b, tiles, k), -np.inf, np.float32)
    ids = np.full((b, tiles, k), -1, np.int32)
    for j in range(tiles):
        s = scores[:, j * tile_rows:(j + 1) * tile_rows]
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        vals[:, j, :order.shape[1]] = np.take_along_axis(s, order, 1)
        ids[:, j, :order.shape[1]] = order + j * tile_rows
    return vals.reshape(b, -1), ids.reshape(b, -1)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_tiles_then_one_stable_merge_keep_the_lower_row(k):
    """The route's merge (one ops/topk.topk over the tiles' lists, then a
    gather) equals one stable top-k over all rows, planted ties included."""
    rng = np.random.default_rng(k)
    scores = rng.integers(-6, 7, (5, 700)).astype(np.float32)  # many ties
    scores[:, 690:] = flat.NEG_INF  # padding rows
    vals, ids = _tile_lists(scores, 96, k)
    v, pos = topk(torch.from_numpy(vals), k)
    got = torch.gather(torch.from_numpy(ids), 1, pos).numpy()
    want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        v.numpy(), np.take_along_axis(scores, want, 1))


# --------------------------------------------------------------- the route
@pytest.mark.parametrize("device,k,dim,want", [
    ("cuda", 10, 768, True), ("cuda:1", 1, 768, True),
    ("cuda", tflat.FLAT_K_MAX, 768, True),
    ("cuda", tflat.FLAT_K_MAX + 1, 768, False),
    ("cuda", 10, 100, False), ("cuda", 0, 768, False),
    ("cuda", 10, 6, False), ("cpu", 10, 768, False),
])
def test_kernel_route(device, k, dim, want):
    assert tflat.FLAT_K_MAX >= 32
    assert flat.kernel_route(device, k, dim) is want


def test_cpu_scans_take_the_chunked_loop():
    """CPU tensors keep the plain twin: the chunk counter, no tile count,
    no launch of E."""
    from densephrases_tpu_torch.utils import profiling

    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(-60, 61, (1000, 64), np.int8))
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    before = tflat.FLAT_SCAN_TOPK.launches
    with profiling.recording() as rec:
        v, ids = flat._scan_topk(q, codes, 990, OFFSET, SCALE, top_k=5,
                                 chunk=256)
    assert rec.counters() == {"index.flat.chunks": 4}
    assert tflat.FLAT_SCAN_TOPK.launches == before
    want = flat._chunked_topk(q, codes, 990, OFFSET, SCALE,
                              lambda c: c.to(torch.float32), top_k=5,
                              chunk=256)
    torch.testing.assert_close(v, want[0], rtol=0, atol=0)
    torch.testing.assert_close(ids, want[1], rtol=0, atol=0)


# ------------------------------------------------------------ the wrapper
def _args(b=4, dim=64, rows=64):
    return (torch.zeros((b, dim), dtype=torch.float32),
            torch.zeros((rows, dim), dtype=torch.int8),
            torch.zeros(b, dtype=torch.float32))


@pytest.mark.parametrize("bad,match", [
    (lambda q, c, s: (q.to(torch.bfloat16), c, s), "q must be fp32"),
    (lambda q, c, s: (q, c.view(torch.uint8), s), "codes must be int8"),
    (lambda q, c, s: (q, c[:, :32], s), "do not match"),
    (lambda q, c, s: (q[:, :60], c[:, :60].contiguous(), s),
     "a multiple of 8"),
    (lambda q, c, s: (q, c, s.double()), "qsum must be fp32"),
    (lambda q, c, s: (q, c, s[:3]), "qsum must be fp32"),
    (lambda q, c, s: (torch.zeros((64, 4)).T, c, s), "contiguous"),
    (lambda q, c, s: (q, c.T.contiguous().T, s), "contiguous"),
    (lambda q, c, s: (q, torch.zeros(64 * 64 + 4, dtype=torch.int8)[4:]
                      .view(64, 64), s), "codes must be 8-byte aligned"),
    (lambda q, c, s: (torch.zeros(4 * 64 + 2)[2:].view(4, 64), c, s),
     "q must be 16-byte aligned"),
    (lambda q, c, s: (q, c, s), "CUDA tensors"),
])
def test_flat_scan_topk_refuses(bad, match):
    q, c, s = bad(*_args())
    with pytest.raises(ValueError, match=match):
        tflat.flat_scan_topk(q, c, s, c.shape[0], OFFSET, SCALE, 10)


@pytest.mark.parametrize("n_valid,scale,k,match", [
    (65, SCALE, 10, "n_valid"), (-1, SCALE, 10, "n_valid"),
    (64, 0.0, 10, "scale"), (64, SCALE, 33, "k=33"), (64, SCALE, 0, "k=0"),
])
def test_flat_scan_topk_refuses_arguments(n_valid, scale, k, match):
    q, c, s = _args()
    with pytest.raises(ValueError, match=match):
        tflat.flat_scan_topk(q, c, s, n_valid, OFFSET, scale, k)


def test_flat_scan_topk_refuses_k_past_the_rows():
    q, c, s = _args(rows=8)
    with pytest.raises(ValueError, match="k=10"):
        tflat.flat_scan_topk(q, c, s, 8, OFFSET, SCALE, 10)


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _corpus(dev, rows, dim, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(-60, 61, (rows, dim), dtype=torch.int8, device=dev,
                          generator=g)
    q = torch.randn((b, dim), device=dev, generator=g)
    return codes, q


def _plain(q, codes, n_valid, k):
    return flat._chunked_topk(q, codes, n_valid, OFFSET, SCALE,
                              lambda c: c.to(torch.float32), top_k=k,
                              chunk=4096)


def _tolerance(q):
    """Per query: two fp32 sums of the same exact products in any orders
    differ by at most 2 (D - 1) 2^-24 Σ|p|, and Σ|p| <= 60 Σ|q_bf16| for
    codes in [-60, 60]; plus a few ulps of the score's size for the twin's
    division by the reciprocal and the addition."""
    d = q.shape[1]
    top = 60 * q.to(torch.bfloat16).float().abs().sum(-1) / SCALE
    return 2 * d * 2.0 ** -24 * top + 2.0 ** -20 * (
        top + (q.sum(-1) * OFFSET).abs())


def _check_against_plain(q, codes, n_valid, k, bites=True):
    """E's route against the twin: exactly one launch; scores within the
    tolerance; the same ids wherever the twin's k-th and (k+1)-th scores
    are further apart than it (as sets: neighbours within it may swap),
    which is most queries (bites)."""
    before = tflat.FLAT_SCAN_TOPK.launches
    v, ids = flat._scan_topk(q, codes, n_valid, OFFSET, SCALE, top_k=k,
                             chunk=4096)
    torch.cuda.synchronize()
    assert tflat.FLAT_SCAN_TOPK.launches - before == 1
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (q.shape[0], k)
    kk = min(k + 1, codes.shape[0])
    pv, pids = _plain(q, codes, n_valid, kk)
    tol = _tolerance(q)
    assert ((v - pv[:, :k]).abs() <= tol[:, None]).all()
    clear = (pv[:, k - 1] - pv[:, kk - 1] > tol) if kk > k else \
        torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    assert not bites or clear.float().mean() > 0.5
    got = ids.sort(-1).values[clear]
    want = pids[:, :k].sort(-1).values[clear]
    assert torch.equal(got, want)
    assert (ids >= 0).all() and (ids < codes.shape[0]).all()
    assert ((ids < n_valid) | (v == flat.NEG_INF)).all()


def test_card_matches_the_twin_at_the_cell_shape(cuda):
    """The flat cells' scan: 1,000,000 rows of 768 dims, 128 stacked query
    rows, k 10."""
    codes, q = _corpus(cuda, 1_000_000, 768, 128, seed=16)
    _check_against_plain(q, codes, 1_000_000, 10)


@pytest.mark.parametrize("b", [1, 64, 128, 130])
@pytest.mark.parametrize("k", [1, 10, tflat.FLAT_K_MAX])
def test_card_matches_the_twin(cuda, b, k):
    """n_valid not a multiple of any tile, padding rows after it."""
    codes, q = _corpus(cuda, 150_016, 768, b, seed=100 * b + k)
    _check_against_plain(q, codes, 149_999, k)


@pytest.mark.parametrize("rows,n_valid,k", [(1000, 1000, 10), (1000, 3, 10),
                                            (40, 37, 32), (2048, 2047, 1)])
def test_card_short_corpora(cuda, rows, n_valid, k):
    """A corpus shorter than one tile, and one with fewer valid rows than k
    (padding rows then fill the list at NEG_INF, lowest rows first)."""
    codes, q = _corpus(cuda, rows, 64, 9, seed=rows + n_valid)
    _check_against_plain(q, codes, n_valid, k, bites=n_valid > k)
    if n_valid < k:
        v, ids = flat._scan_topk(q, codes, n_valid, OFFSET, SCALE, top_k=k,
                                 chunk=4096)
        want = torch.arange(n_valid, k, dtype=torch.int32, device=cuda)
        assert torch.equal(ids[:, n_valid:], want.expand(9, -1))
        assert (v[:, n_valid:] == flat.NEG_INF).all()


def test_card_planted_duplicates_go_to_the_lower_row(cuda):
    """Copies of one row that tops query 0, in several tiles and twice in
    one warp's 32 rows: equal scores, listed by row; k 1 keeps the lowest."""
    codes, q = _corpus(cuda, 400_000, 768, 128, seed=7)
    top = (q[0] / q[0].abs().max() * 60).round().to(torch.int8)
    rows = [5, 17, 123_457, 262_143, 399_999]
    codes[rows] = top
    for k in (1, 10):
        v, ids = flat._scan_topk(q, codes, 400_000, OFFSET, SCALE, top_k=k,
                                 chunk=4096)
        n = min(k, len(rows))
        assert ids[0, :n].tolist() == rows[:n]
        assert (v[0, :n] == v[0, 0]).all()
        if k > n:
            assert v[0, n] < v[0, 0]


def test_card_flat_index_and_mesh_free_paths_launch_once(cuda):
    """FlatIndex.search on the card makes one E launch a scan and counts
    its tiles, not chunks."""
    from densephrases_tpu_torch.utils import profiling

    codes, q = _corpus(cuda, 20_000, 768, 8, seed=3)
    index = flat.FlatIndex(codes, OFFSET, SCALE, device=cuda)
    before = tflat.FLAT_SCAN_TOPK.launches
    with profiling.recording() as rec:
        v, ids = index.search(q, top_k=10, as_numpy=False)
    assert tflat.FLAT_SCAN_TOPK.launches - before == 1
    counters = rec.counters()
    assert "index.flat.chunks" not in counters
    assert counters["index.flat.kernel_tiles"] >= 1
    pv, pids = _plain(q, index.codes, 20_000, 10)
    assert ((v - pv).abs() <= _tolerance(q)[:, None]).all()
