"""Kernel D's fused select (``ops/ivf_pack.pq_scan_topk``, the 8-bit path
of ``csrc/pq_pack_score.cu`` with each tile's exact top-k in its epilogue)
on the card, against its plain twin ``pq_pack_score_topk_plain`` and the
unfused route, and the route ``packed_pq_scan`` takes. Its CPU tests (the
twin, the tiles' merge, the plan and the route's rule) are in
``test_torch_ivf_pack.py``. Every test here needs a CUDA card and is
skipped without one; this file imports no JAX, so on a card's machine
without it:

    python -m pytest --noconftest tests/test_torch_pq_select.py -q
"""

import pytest
import torch

from densephrases_tpu_torch.ops import ivf_pack as pack
from densephrases_tpu_torch.tools import bench_pq_select as bps
from densephrases_tpu_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _twin(lay, k):
    return pack.pq_pack_score_topk_plain(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=k, cs32=lay["cs32"],
        row_list=lay["row_list"])


def _check(lay, k, want=None):
    """The fused route against ``want`` (the twin at k + 1 by default):
    one launch of the fused entry and none of D's scores, scores within the tolerance, the same ids wherever the
    scores stand clear of it, and most queries clear."""
    before = (pack.PQ_SCAN_TOPK.launches, pack.PQ_PACK_SCORE.launches)
    got = bps.fused(lay, k)
    torch.cuda.synchronize()
    assert (pack.PQ_SCAN_TOPK.launches - before[0],
            pack.PQ_PACK_SCORE.launches - before[1]) == (1, 0)
    if want is None:
        want = _twin(lay, k + 1)
    row = bps.agreement(got, want, bps.tolerance(lay))
    assert row["within_tolerance"], row
    assert row["sets_equal_where_clear"], row
    assert row["ids_equal_where_alone"], row
    assert row["clear_share"] > 0.5, row
    return got, want


def test_card_matches_the_twin_at_the_cell_shape(cuda):
    """The ``ivf-opq96.nq-b64`` scan: 128 query rows, 16,384 lists of ~512
    rows, nprobe 256, OPQ96, k 40, against the twin over every column of
    the guard budget."""
    lay = bps.layout(16384, 512, 128, 256, 96, seed=19)
    assert 4 * int(lay["total"]) < lay["budget"]  # most of it junk
    _check(lay, 40)


@pytest.mark.parametrize("b", [1, 5, 130])
@pytest.mark.parametrize("k", [1, 40, pack.PQ_K_MAX])
def test_card_matches_the_twin(cuda, b, k):
    """Batches below one block's queries and past 128, k from 1 to the
    two-slot limit, M 24 (4-byte code loads)."""
    lay = bps.layout(512, 256, b, 16, 24, seed=100 * b + k)
    _check(lay, k)


@pytest.mark.parametrize("m", [8, 96])
def test_card_without_residual_and_other_widths(cuda, m):
    """No residual base (``cs32`` None): the ADC sums alone, M 8 (8 queries
    a block) and 96."""
    lay = bps.layout(256, 256, 37, 8, m, seed=m)
    lay["cs32"], lay["row_list"] = None, None
    got = pack.merge_pq_tiles(*pack.pq_scan_topk(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=40)[:2],
        pack._valid_count(lay["blk"], lay["total"], lay["n_real"]), 40)
    want = pack.pq_pack_score_topk_plain(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=41)
    lay["cs32"] = torch.zeros_like(lay["q"][:, :1])  # no base in the bound
    row = bps.agreement(got, want, bps.tolerance(lay))
    assert row["within_tolerance"] and row["ids_equal_where_alone"], row
    assert row["sets_equal_where_clear"] and row["clear_share"] > 0.5, row


def test_card_fewer_valid_rows_than_k_pad_like_the_twin(cuda):
    """One probe of a list shorter than k, within one block: its 32 rows,
    then the first invalid columns at NEG_INF in column order, as the
    twin's masked sort leaves them."""
    lay = bps.layout(256, 4, 1, 1, 24, seed=7)
    offs = lay["offs"].tolist()
    li = next(i for i in range(256)
              if offs[i] < offs[i + 1] and offs[i] // 32 == offs[i + 1] // 32)
    lay["q"][0] = 10 * lay["cents"][li]  # probes list li alone
    bps.scan_inputs(lay, 1)
    n_valid = int(pack._valid_count(lay["blk"], lay["total"], lay["n_real"]))
    assert n_valid == 32
    gv, gc = bps.fused(lay, 64)
    wv, wc = _twin(lay, 64)
    torch.cuda.synchronize()
    pad = wv == pack.NEG_INF
    assert torch.equal(gv == pack.NEG_INF, pad) and bool(pad.any())
    assert torch.equal(gc[pad], wc[pad])
    assert (gc[~pad] < n_valid).all() and (gc[pad] >= n_valid).all()


def test_card_planted_ties_go_to_the_lower_column(cuda):
    """Copies of query 0's best code row in one list, in different blocks
    and tiles' reach: equal scores in both routes, listed by column."""
    lay = bps.layout(512, 256, 8, 16, 24, seed=3)
    lut = lay["lut"][0].float()  # [M, 256]
    best = lut.argmax(-1).to(torch.uint8)
    li = int(pack.probe(lay["q"][:1], lay["cents"], 1)[0, 0])
    a, z = int(lay["offs"][li]), int(lay["offs"][li + 1])
    rows = [a + 1, a + 40, z - 2]
    lay["codes"][rows] = best
    got, want = _check(lay, 10)
    src = lambda cols: (lay["blk"].long()[cols // 32] * 32  # noqa: E731
                        + cols % 32)
    assert src(got[1][0, :3]).tolist() == rows
    assert torch.equal(got[1][0, :3], want[1][0, :3])
    assert (got[0][0, :3] == got[0][0, 0]).all()


def _scan(lay, books, codes, scan_k, **kw):
    row_perm = torch.arange(codes.shape[0], dtype=torch.int32,
                            device=codes.device)
    return pack.packed_pq_scan(
        lay["q"], lay["q"], lay["cents"], lay["offs"], codes, row_perm,
        books, None, 0.0, 1.0, top_k=scan_k, nprobe=kw.pop("nprobe"),
        cap=lay["cap"], budget=lay["budget"], n_real=lay["n_real"],
        scan_k=scan_k, pq_residual=True, **kw)


@pytest.mark.parametrize("ksub,scan_k,fused", [
    (256, 40, True), (256, pack.PQ_K_MAX, True), (16, 40, False),
    (256, pack.PQ_K_MAX + 1, False)])
def test_card_route(cuda, ksub, scan_k, fused):
    """``packed_pq_scan`` on the card: 8-bit codes with k <= 64 launch the
    fused entry once (and not D's scores) and count its tiles; 4-bit codes
    and k > 64 launch D's scores once (and not the fused entry) and count
    no tiles."""
    lay = bps.layout(512, 256, 16, 16, 24, seed=ksub + scan_k)
    m = 24 if ksub == 256 else 48
    books = torch.randn(m, ksub, 768 // m, device=cuda)
    codes = lay["codes"] if ksub == 256 else lay["codes"][:, :m // 2]
    codes = codes.contiguous()
    before = (pack.PQ_SCAN_TOPK.launches, pack.PQ_PACK_SCORE.launches)
    with profiling.recording() as rec:
        vals, gids = _scan(lay, books, codes, scan_k, nprobe=16,
                           row_list=lay["row_list"])
        counters = rec.counters()
    assert (pack.PQ_SCAN_TOPK.launches - before[0],
            pack.PQ_PACK_SCORE.launches - before[1]) == (int(fused),
                                                         int(not fused))
    assert ("index.ivf.kernel_tiles" in counters) is fused
    n_valid = int(pack._valid_count(lay["blk"], lay["total"],
                                    lay["n_real"]))
    assert counters["index.ivf.rows_scored"] == 16 * n_valid
    assert tuple(gids.shape) == (16, scan_k)
    if fused:
        _, _, tiles = pack.pq_scan_topk(
            lay["lut"], codes, lay["blk"], lay["total"],
            n_real=lay["n_real"], k=scan_k, cs32=lay["cs32"],
            row_list=lay["row_list"])
        assert counters["index.ivf.kernel_tiles"] == tiles


def test_card_route_allocates_no_score_matrix(cuda):
    """One search at the cell's shape on the fused route: its allocator
    peak stays far below one [128, budget·32] fp32 score matrix (4.3 GB),
    which the unfused route writes, gathers, masks and sorts."""
    lay = bps.layout(16384, 512, 128, 256, 96, seed=5)
    row_list = lay["row_list"]
    for k in list(lay):
        if k not in ("q", "cents", "offs", "codes", "cap", "budget",
                     "n_real", "books"):
            lay.pop(k)
    scores = 128 * lay["budget"] * 32 * 4
    peak = bps.peak_bytes(lambda: _scan(lay, lay["books"], lay["codes"], 40,
                                        nprobe=256, row_list=row_list), cuda)
    assert peak < scores // 16, (peak, scores)
