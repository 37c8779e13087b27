"""Kernel D's fused select (``ops/ivf_pack.pq_scan_topk``, then
``merge_pq_tiles``) at an IVF-PQ scan's shape, against its plain twin
(``pq_pack_score_topk_plain``) and beside the route it replaced on 8-bit
codes: D's scores, then ``pq_select`` (the residual gather, the mask and a
stable sort over every column of the guard budget).

    python -m densephrases_tpu_torch.tools.bench_pq_select \\
        [--lists 16384] [--rows 512] [--batch 128] [--nprobe 256] \\
        [--m 96] [--k 40]

The defaults are the ``ivf-opq96.nq-b64`` cell's: 128 stacked query rows,
16,384 lists of ~512 rows (2^23 rows), nprobe 256, OPQ96 residual codes,
k 40 (top_k 10 × refine 4). Codes, centroids, queries and PQ books are
drawn on the card from ``--seed``; the block table is the batch's own at
the guard budget (``IVFIndex._pack_budget``'s). The line holds the CUDA-event
times of both routes, of the twin (``plain_ms``) and of D and the fused
kernel alone, the allocator's peak above what was allocated before one
call of each route, and the fused route's agreement with the twin and
(``unfused_*``) with D and its select: scores within ``tolerance``, the
same ids at every rank whose score stands further than twice it from its
neighbours. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from densephrases_tpu_torch.ops import ivf_pack as pack
from densephrases_tpu_torch.ops.pq import pq_lut
from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.tools.bench_flat_scan import card


def layout(lists: int, rows: int, batch: int, nprobe: int, m: int,
           seed: int, dim: int = 768, device="cuda") -> dict:
    """A seeded IVF-PQ layout and one batch's scan inputs on ``device``:
    lists of rows/2 .. 3·rows/2 code rows (boundary blocks straddle two
    lists, the last block is part padding), the probe's block table at the
    guard budget (mostly junk, as the cell's), the bf16 LUTs from random
    books, the residual bases ``q @ centroids.T`` and each row's list."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(rows // 2, 3 * rows // 2 + 1, lists)
    lens[-1] += (5 - lens.sum()) % 32
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n_real = int(offs[-1])
    n_pad = pack._round_up(n_real, pack.RB) + pack.RB
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 256, (n_pad, m), dtype=torch.uint8,
                          device=device, generator=gen)
    cents = torch.randn(lists, dim, device=device, generator=gen)
    # queries about one common direction, so that a batch of 128 at
    # nprobe 256 probes ~14% of 16,384 lists, as the cell's do (12-16%)
    q = (torch.randn(batch, dim, device=device, generator=gen)
         + 2 * torch.randn(1, dim, device=device, generator=gen))
    books = torch.randn(m, 256, dim // m, device=device, generator=gen)
    cap = int(lens.max())
    budget = pack._round_up(max(int(pack.pack_budget_table(offs, cap)[
        min(batch * nprobe, lists) - 1]), pack.TPB), 64)
    offs_t = torch.as_tensor(offs, device=device)
    lay = {"q": q, "cents": cents, "offs": offs_t, "codes": codes,
           "n_real": n_real, "cap": cap, "budget": budget, "books": books,
           "row_list": pack.row_lists(offs_t, n_pad, lists)}
    return scan_inputs(lay, nprobe)


def scan_inputs(lay: dict, nprobe: int) -> dict:
    """``lay`` with its batch's scan inputs (again, after the queries
    changed): the block table and its real count at ``lay``'s budget, the
    bf16 LUTs and the residual bases."""
    q, cents = lay["q"], lay["cents"]
    lay["blk"], lay["total"] = pack.block_table(
        pack.probe(q, cents, nprobe), lay["offs"], nlist=cents.shape[0],
        cap=lay["cap"], pad_blk=lay["codes"].shape[0] // pack.RB - 1,
        budget=lay["budget"])
    lay["lut"] = pq_lut(lay["books"], q).to(torch.bfloat16).contiguous()
    lay["cs32"] = q @ cents.T
    return lay


def tolerance(lay) -> torch.Tensor:
    """Per query, how far two sums of one row's M bf16 LUT entries, in any
    two orders, plus the residual base, may lie apart: 2 (M - 1) 2^-24 Σ_m
    max |LUT[q, m, :]| for the sums and 2^-23 |score| for the base's
    addition, the score bounded by the sums' and the bases' largest."""
    lut = lay["lut"].float().abs().amax(-1).sum(-1)
    m = lay["lut"].shape[1]
    top = lut + lay["cs32"].abs().amax(-1)
    return 2 * (m - 1) * 2.0 ** -24 * lut + 2.0 ** -23 * top


def fused(lay, k: int):
    """The fused route: D with the select in its epilogue, then the merge
    of its tiles' lists → (vals [B, k], packed columns [B, k])."""
    vals, cols, _ = pack.pq_scan_topk(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=k, cs32=lay["cs32"],
        row_list=lay["row_list"])
    return pack.merge_pq_tiles(
        vals, cols, pack._valid_count(lay["blk"], lay["total"],
                                      lay["n_real"]), k)


def unfused(lay, k: int):
    """D's scores, then the select after them (the route of 4-bit codes
    and k > 64)."""
    raw = pack.pq_pack_score(lay["lut"], lay["codes"], lay["blk"])
    return pack.pq_select(raw, lay["blk"], lay["total"],
                          n_real=lay["n_real"], k=k, cs32=lay["cs32"],
                          row_list=lay["row_list"])


def plain(lay, k: int):
    """The fused select's plain twin: D's twin, then ``pq_select``."""
    return pack.pq_pack_score_topk_plain(
        lay["lut"], lay["codes"], lay["blk"], lay["total"],
        n_real=lay["n_real"], k=k, cs32=lay["cs32"],
        row_list=lay["row_list"])


def agreement(got, want, tol) -> dict:
    """``got`` (vals, cols) [B, k] against ``want`` [B, k + 1]: every score
    within tol of the same rank's; the same top-k set where the k-th and
    (k+1)-th scores lie more than 2 tol apart; the same column at each rank
    whose score lies more than 2 tol from both neighbours."""
    (gv, gc), (wv, wc) = got, want
    k = gv.shape[1]
    t = tol[:, None]
    within = bool(((gv - wv[:, :k]).abs() <= t).all())
    clear = wv[:, k - 1] - wv[:, k] > 2 * tol
    same_set = (gc.sort(-1).values == wc[:, :k].sort(-1).values).all(-1)
    gaps = wv[:, :-1] - wv[:, 1:]  # [B, k]: rank r to r + 1
    alone = torch.cat([torch.ones_like(gaps[:, :1], dtype=torch.bool),
                       gaps[:, :k - 1] > 2 * t], 1) & (gaps > 2 * t)
    return {"within_tolerance": within,
            "score_max_abs_diff": float((gv - wv[:, :k]).abs().max()),
            "tolerance_max": float(tol.max()),
            "clear_share": float(clear.float().mean()),
            "sets_equal_where_clear": bool(same_set[clear].all()),
            "alone_share": float(alone.float().mean()),
            "ids_equal_where_alone": bool((gc == wc[:, :k])[alone].all())}


def peak_bytes(fn, device) -> int:
    """The allocator's peak above what was allocated before one call."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak)


def measure(lay, k: int, iters: int = 20) -> dict:
    """Both routes and the twin at one layout: times, launches, peaks,
    agreement."""
    dev = lay["codes"].device
    kernels = (pack.PQ_PACK_SCORE, pack.PQ_SCAN_TOPK)
    b, m = lay["lut"].shape[:2]
    row = {"batch": b, "m": m, "k": k, "lists": lay["cs32"].shape[1],
           "rows": lay["n_real"], "budget_blocks": lay["budget"],
           "real_blocks": int(lay["total"]), "card": card()}
    with _bench.uncounted(*kernels):
        before = [kk.launches for kk in kernels]
        got = fused(lay, k)
        torch.cuda.synchronize(dev)
        row["launches_a_scan"] = {kk.symbol: kk.launches - n
                                  for kk, n in zip(kernels, before)}
        tol = tolerance(lay)
        row.update(agreement(got, plain(lay, k + 1), tol))
        row.update({f"unfused_{key}": v for key, v in agreement(
            got, unfused(lay, k + 1), tol).items()})
        row["fused_peak_bytes"] = peak_bytes(lambda: fused(lay, k), dev)
        row["unfused_peak_bytes"] = peak_bytes(lambda: unfused(lay, k), dev)
        row["scores_bytes"] = b * lay["budget"] * pack.RB * 4
        row["fused_ms"] = _bench.device_ms(lambda: fused(lay, k), dev, iters)
        row["kernel_ms"] = _bench.device_ms(lambda: pack.pq_scan_topk(
            lay["lut"], lay["codes"], lay["blk"], lay["total"],
            n_real=lay["n_real"], k=k, cs32=lay["cs32"],
            row_list=lay["row_list"]), dev, iters)
        row["unfused_ms"] = _bench.device_ms(lambda: unfused(lay, k), dev,
                                             max(iters // 4, 3))
        row["plain_ms"] = _bench.device_ms(lambda: plain(lay, k), dev, 2,
                                           warmup=1)
        row["d_ms"] = _bench.device_ms(lambda: pack.pq_pack_score(
            lay["lut"], lay["codes"], lay["blk"]), dev, iters)
    # the fused kernel's least time: b·M fp32 adds a valid row; the valid
    # rows' codes, the LUTs and the block table read once, the lists
    # written once
    tiles = pack.pq_topk_plan(b, m, k, pack._sm_count(dev))[3]
    valid = int(pack._valid_count(lay["blk"], lay["total"], lay["n_real"]))
    row["bound_ms"], row["bound_by"] = _bench.bound(
        b * valid * m, valid * m + lay["lut"].numel() * 2
        + 4 * lay["budget"] + 8 * b * tiles * k, "float32")
    row["share_pct"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    row["tiles"] = tiles
    kernel = pack.PQ_SCAN_TOPK
    row["build_seconds"] = kernel.build_seconds
    row["ptxas"] = [ln for ln in kernel.build_log.splitlines()
                    if "registers" in ln or "spill" in ln][:40]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lists", type=int, default=16384)
    ap.add_argument("--rows", type=int, default=512,
                    help="mean code rows a list")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nprobe", type=int, default=256)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lay = layout(args.lists, args.rows, args.batch, args.nprobe, args.m,
                 args.seed)
    print(json.dumps(measure(lay, args.k, args.iters)))


if __name__ == "__main__":
    main()
