"""Kernel E (``csrc/flat_scan_topk.cu``) at a flat scan's shape: its time
by CUDA events beside its bound, the plain twin's (the chunked loop,
``index/flat.py:_chunked_topk``) and a library yardstick that the port
never calls (``torch.matmul`` of bf16 codes, then ``torch.topk``).

    python -m densephrases_tpu_torch.tools.bench_flat_scan \\
        [--rows 1003520] [--dim 768] [--batch 128] [--k 10]

The corpus is int8 uniform in [-60, 60] and the queries normal, both drawn
on the card from ``--seed``. Besides the times, the line holds E's route
against the twin: its launches a scan, its largest score error beside
``tolerance``, and whether the ids agree (as sets) for every query whose
twin's k-th and (k+1)-th scores lie further apart than that. Prints one
JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from densephrases_tpu_torch.index.flat import _chunked_topk, _scan_topk
from densephrases_tpu_torch.ops import flat_scan
from densephrases_tpu_torch.tools import _bench

OFFSET, SCALE = -2.0, 20.0


def card() -> dict:
    """The card's name and power limit (W), as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    name, _, limit = out.stdout.strip().splitlines()[0].partition(",")
    return {"name": name.strip(), "power_limit_w": float(limit)}


def tolerance(q):
    """Per query, how far E's scores may sit from the twin's: two fp32 sums
    of the same exact bf16 x int8 products in any orders differ by at most
    2 (D - 1) 2^-24 sum|p|, and sum|p| <= 60 sum|q_bf16| for codes in
    [-60, 60]; plus a few ulps of the score's size for the twin's division
    and addition."""
    top = 60 * q.to(torch.bfloat16).float().abs().sum(-1) / SCALE
    return 2 * q.shape[1] * 2.0 ** -24 * top + 2.0 ** -20 * (
        top + (q.sum(-1) * OFFSET).abs())


def measure(rows: int, dim: int, batch: int, k: int, seed: int,
            iters: int = 20, n_valid: int | None = None) -> dict:
    """E, its route and the twin at one shape (rows past ``n_valid``, by
    default none, are padding)."""
    dev = torch.device("cuda", 0)
    n_valid = rows if n_valid is None else n_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(-60, 61, (rows, dim), dtype=torch.int8,
                          device=dev, generator=gen)
    q = torch.randn((batch, dim), device=dev, generator=gen)
    qsum = q.sum(-1)
    kernel = flat_scan.FLAT_SCAN_TOPK

    def plain(kk=k):
        return _chunked_topk(q, codes, n_valid, OFFSET, SCALE,
                             lambda c: c.to(torch.float32), top_k=kk,
                             chunk=4096)

    def route():  # E, then the merge
        return _scan_topk(q, codes, n_valid, OFFSET, SCALE, top_k=k,
                          chunk=4096)

    def e_alone():
        return flat_scan.flat_scan_topk(q, codes, qsum, n_valid, OFFSET,
                                        SCALE, k)

    row = {"rows": rows, "n_valid": n_valid, "dim": dim, "batch": batch,
           "k": k, "card": card()}
    with _bench.uncounted(kernel):
        before = kernel.launches
        got = route()
        torch.cuda.synchronize()
        row["launches_a_scan"] = kernel.launches - before
        kk = min(k + 1, rows)
        want_v, want_i = plain(kk)
        tol = tolerance(q)
        err = (got[0] - want_v[:, :k]).abs()
        clear = (want_v[:, k - 1] - want_v[:, kk - 1] > tol if kk > k
                 else torch.ones_like(tol, dtype=torch.bool))
        same = (got[1].sort(-1).values == want_i[:, :k].sort(-1).values
                ).all(-1)
        row["ids_equal_share"] = float(same.float().mean())
        row["recall_vs_plain"] = _bench.recall(got[1].cpu(),
                                               want_i[:, :k].cpu())
        row["score_max_abs_diff"] = float(err.max())
        row["tolerance_max"] = float(tol.max())
        row["within_tolerance"] = bool((err <= tol[:, None]).all())
        row["clear_share"] = float(clear.float().mean())
        row["ids_equal_where_clear"] = bool(same[clear].all())
        row["valid_ids"] = bool(((got[1] >= 0) & (got[1] < n_valid)).all())
        tiles = row["tiles"] = e_alone()[2]
        row["kernel_ms"] = _bench.device_ms(e_alone, dev, iters)
        row["route_ms"] = _bench.device_ms(route, dev, iters)
        row["plain_ms"] = _bench.device_ms(plain, dev, max(iters // 4, 3))
        qbf, cbf = q.to(torch.bfloat16), codes.to(torch.bfloat16)
        row["library_ms"] = _bench.device_ms(
            lambda: torch.topk(torch.matmul(qbf, cbf.T), k, dim=-1), dev,
            iters)
        del cbf
    ops, nbytes = 2 * batch * rows * dim, rows * dim
    row["bound_ms"], row["bound_by"] = _bench.bound(ops, nbytes, "bfloat16")
    row["share_pct"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    row["candidate_bytes"] = batch * tiles * k * 8
    row["build_seconds"] = kernel.build_seconds
    row["ptxas"] = [ln for ln in kernel.build_log.splitlines()
                    if "registers" in ln or "spill" in ln][:24]
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1003520)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    row = measure(args.rows, args.dim, args.batch, args.k, args.seed,
                  args.iters)
    print(json.dumps(row, default=lambda x: np.asarray(x).tolist()))


if __name__ == "__main__":
    main()
