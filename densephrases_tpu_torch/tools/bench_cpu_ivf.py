"""The CPU IVF-PQ baseline at the flagship operating point (10.5M OPQ96).

The counterpart of ``densephrases_tpu/tools/bench_cpu_ivf.py``: host numpy
code, nearly a copy. BASELINE.md's north star is "≥5x FAISS-CPU
queries/sec at matched recall@20 on the full phrase index". No FAISS
binary is installed, so the baseline is an in-process numpy IVF-PQ search
doing the FAISS CPU algorithm (the upstream serve path's ``IndexIVFPQ``
ADC scan): a BLAS probe over the coarse centroids, a per-query LUT (the
asymmetric distance table), the LUT scan over the probed lists' codes with
the residual term, and the int8 refine re-rank. It runs over the SAME
saved index the device rows measure (``bench_ivf_scale``), at the same
nprobe and refine point, scored for recall@20 against the same cached
exact ground truth, on the same queries.

Two differences from the reference: ``ivf.pkl`` is read with the port's
unpickler (the file names the reference's classes, whose modules import
jax), and the 4-bit codes are unpacked with the port's ``unpack_nibbles``.

Run (no GPU needed), after ``bench_ivf_scale``:
  python -m densephrases_tpu_torch.tools.bench_cpu_ivf [--nlist 65536]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from densephrases_tpu_torch.tools import _bench


def load_index_host(idx_dir: str) -> dict:
    """Host view of a saved IVF index directory (either package's): no
    device, no jax."""
    from densephrases_tpu_torch.index.ivf import _RefUnpickler

    with open(os.path.join(idx_dir, "ivf.pkl"), "rb") as f:
        extra = _RefUnpickler(f).load()
    d = {
        "centroids": np.load(os.path.join(idx_dir, "centroids.npy")),
        "row_perm": np.load(os.path.join(idx_dir, "row_perm.npy")),
        "list_offsets": np.load(os.path.join(idx_dir, "list_offsets.npy")),
        "codes": np.load(os.path.join(idx_dir, "codes.npy"), mmap_mode="r"),
        "rotation": extra["rotation"],
        "pq": extra["pq"],
        "offset": extra["offset"], "scale": extra["scale"],
        "pq_residual": bool(
            extra["cfg"].__dict__.get("pq_residual", False)),
    }
    rp = os.path.join(idx_dir, "refine_codes.npy")
    d["refine"] = np.load(rp, mmap_mode="r") if os.path.exists(rp) else None
    return d


def cpu_ivfpq_search(idx: dict, queries: np.ndarray, top_k: int = 20,
                     nprobe: int = 16, refine_factor: int = 16) -> np.ndarray:
    """The FAISS-CPU IVFPQ algorithm in numpy, one query at a time (the
    per-list gather and LUT scan are per-query work, as in the C++ scan
    loop). Returns ids [B, top_k] int64."""
    cents = idx["centroids"]  # [nlist, D]
    offs = idx["list_offsets"]
    codes = idx["codes"]  # [N, M] uint8 (memmap; [N, M//2] when ksub=16)
    books = idx["pq"].codebooks  # [M, ksub, dsub]
    rot = idx["rotation"]
    m = books.shape[0]
    ksub = books.shape[1]
    packed4 = ksub == 16  # 4-bit codes are nibble-packed
    if packed4:
        from densephrases_tpu_torch.ops.pq import unpack_nibbles
    marange = np.arange(m)
    out_ids = np.empty((queries.shape[0], top_k), np.int64)

    # batched probe (BLAS): the C++ path does the same coarse matmul
    cs = queries @ cents.T  # [B, nlist]
    probe = np.argpartition(-cs, nprobe, axis=1)[:, :nprobe]

    q_rot = queries if rot is None else queries @ rot
    scan_k = top_k * refine_factor
    for qi in range(queries.shape[0]):
        lut = np.einsum("ms,mks->mk", q_rot[qi].reshape(m, -1), books,
                        dtype=np.float32)  # [M, ksub] ADC table
        parts_s, parts_r = [], []
        for li in probe[qi]:
            lo, hi = int(offs[li]), int(offs[li + 1])
            if hi <= lo:
                continue
            c = np.asarray(codes[lo:hi])  # [rows, M] (or packed [rows, M//2])
            if packed4:
                c = unpack_nibbles(c)  # [rows, M] values < 16
            s = lut[marange[None, :], c].sum(1)  # LUT scan
            if idx["pq_residual"]:
                s += float(queries[qi] @ cents[li])
            parts_s.append(s)
            parts_r.append(np.arange(lo, hi))
        s = np.concatenate(parts_s)
        rows = np.concatenate(parts_r)
        k1 = min(scan_k, s.shape[0])
        sel = np.argpartition(-s, k1 - 1)[:k1]
        gids = idx["row_perm"][rows[sel]]
        if idx["refine"] is not None:
            rrows = np.asarray(idx["refine"][gids]).astype(np.float32)
            rs = (rrows @ queries[qi] / idx["scale"]
                  + queries[qi].sum() * idx["offset"])
            best = np.argpartition(-rs, min(top_k, rs.shape[0]) - 1)
            best = best[:top_k][np.argsort(-rs[best[:top_k]])]
            out_ids[qi] = gids[best]
        else:
            best = sel[np.argsort(-s[sel])][:top_k]
            out_ids[qi] = idx["row_perm"][rows[best]]
    return out_ids


def measure(idx: dict, queries: np.ndarray, gt: np.ndarray, nprobe: int,
            refine_factor: int, windows: int = 3) -> dict:
    """recall@20 of one warm-up pass against ``gt``, then the median of
    ``windows`` timed passes over the batch (host clock)."""
    ids = cpu_ivfpq_search(idx, queries, top_k=20, nprobe=nprobe,
                           refine_factor=refine_factor)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        cpu_ivfpq_search(idx, queries, top_k=20, nprobe=nprobe,
                         refine_factor=refine_factor)
        times.append(time.perf_counter() - t0)
    times.sort()
    el = times[len(times) // 2]
    return {"recall20_b64": _bench.recall(ids, gt), "batch_s": el,
            "qps": queries.shape[0] / el, "windows_s": times, "ids": ids}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=65536,
                    help="the bench_ivf_scale build's nlist (names its dir)")
    ap.add_argument("--quant", default="OPQ96")
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--refine_factor", type=int, default=16)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--workdir", default=_bench.default_workdir())
    ap.add_argument("--out", default=_bench.default_out("BENCH_IVF.json"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from densephrases_tpu_torch.tools.bench_ivf_scale import (
        corpus_path, corpus_queries, index_dir)

    args = parse_args(argv)
    idx_dir = index_dir(args.workdir, args.quant, args.n, args.d, args.nlist)
    cache = corpus_path(args.workdir, args.n, args.d)
    gt_path = cache + ".gt20.npz"
    if not (os.path.exists(gt_path)
            and os.path.exists(os.path.join(idx_dir, "save.done"))):
        raise FileNotFoundError(
            f"{gt_path} or {idx_dir}: run tools/bench_ivf_scale.py first")
    # the IVF_SCALE query protocol and its cached exact ground truth
    q64 = corpus_queries(np.load(cache, mmap_mode="r"))[1:]
    ei64 = np.load(gt_path)["ei64"]
    idx = load_index_host(idx_dir)
    res = {"quant": args.quant, "n": args.n, "nlist": args.nlist,
           "nprobe": args.nprobe, "refine_factor": args.refine_factor,
           "host_threads": os.cpu_count(),
           "blas_note": "numpy/BLAS in-process"}
    row = measure(idx, q64, ei64, args.nprobe, args.refine_factor,
                  args.windows)
    row.pop("ids")
    res.update(row)
    print(json.dumps(res))
    _bench.merge_rows(os.path.abspath(args.out),
                      f"cpu_baseline_{args.quant}_rf{args.refine_factor}"
                      f"_p{args.nprobe}", res)
    return res


if __name__ == "__main__":
    main()
