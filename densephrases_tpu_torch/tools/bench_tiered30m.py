"""Serving a corpus beyond the card's memory: ``TieredIVF`` at scale.

The counterpart of ``densephrases_tpu/tools/bench_tiered30m.py``. The
reference built 30M x 768 rows (23 GB of int8, 1.4x a v5e's HBM) and served
them with the inverted lists on a host memmap, the coarse centroids on the
device and the probed lists streamed to it each batch. On an 80 GB card
30M rows are 0.3x its memory, so ``--n auto`` sizes the corpus from
``torch.cuda.mem_get_info`` to exceed the card (1.1x its total memory)
after checking that the disk holds it (the memmap plus the sorted copy,
about 2x the corpus); where it does not, the largest n that fits is used
and the result says that the corpus sits within the card.

Stages (each cached under ``--workdir``; each a function the tests call):

1. ``gen_corpus_device_stream``: the corpus made on the device in chunks
   and streamed into an int8 memmap (it never sits on the device whole);
2. ``exact_gt_device``: the exact ground truth by chunked device scans;
3. ``IVFIndex.build_host_save``: the coarse quantizer on the device, the
   sorted lists written memmap to memmap;
4. ``serve``: ``TieredIVF`` at ``--probes``: recall@20, q/s and the bytes
   it holds on the device. ``--compare_hbm`` also loads the same save as
   an in-memory ``IVFIndex`` (kernel C) when it fits, for the same points.

``TieredIVF`` scores each streamed block with a plain product, in both
packages (the reference's is an XLA matmul, ``index/tiered.py:45``): the
tiered serve launches no hand kernel.

Run on the card:  python -m densephrases_tpu_torch.tools.bench_tiered30m \\
    --n auto
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE
from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device

DISK_FACTOR = 2.1  # the memmap, the sorted copy and the small arrays


def _gen_chunk(ci: int, rows: int, d: int, centers: torch.Tensor,
               seed: int) -> torch.Tensor:
    """Chunk ``ci`` of the corpus, drawn from its own generator (seed,
    chunk), so any chunk can be made again alone."""
    dev = centers.device
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([seed, ci]).generate_state(1)[0]))
    idx = torch.randint(0, centers.shape[0], (rows,), generator=gen,
                        device=dev)
    x = centers[idx] + 0.3 * torch.randn((rows, d), generator=gen,
                                         device=dev)
    return torch.clamp(torch.round((x - DEFAULT_OFFSET) * DEFAULT_SCALE),
                       -128, 127).to(torch.int8)


def gen_corpus_device_stream(path: str, n: int, d: int, qids: np.ndarray,
                             n_clusters: int = 4096, seed: int = 7,
                             chunk: int = 1 << 21, *,
                             device="cuda") -> np.ndarray:
    """The clustered int8 corpus (centres ~ N(-2, 1), members = centre +
    0.3 N(0, 1), the affine int8 contract) made on ``device`` ``chunk``
    rows at a time and streamed into an ``.npy`` memmap at ``path``;
    returns the raw int8 rows at ``qids``. Resumable at chunk
    granularity (``.progress``; ``.done`` when whole)."""
    device = resolve_device(device)
    assert n % chunk == 0, f"n={n} must be a multiple of chunk={chunk}"
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((n_clusters, d), generator=gen,
                          device=device) - 2.0
    qids = np.asarray(qids, np.int64)
    done = os.path.exists(path + ".done")
    prog = path + ".progress"
    start_c = 0
    if not done and os.path.exists(path) and os.path.exists(prog):
        try:
            start_c = int(open(prog).read().split()[0])
        except (ValueError, OSError):
            start_c = 0
    mm = None
    if not done:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        mm = np.lib.format.open_memmap(
            path, mode="r+" if start_c else "w+", dtype=np.int8,
            shape=(n, d))
    qrows = np.zeros((len(qids), d), np.int8)
    src = None
    for ci in range(n // chunk):
        c0 = ci * chunk
        sel = (qids >= c0) & (qids < c0 + chunk)
        if done or ci < start_c:
            if sel.any():  # the query rows from the written memmap
                if src is None:
                    src = np.load(path, mmap_mode="r")
                qrows[sel] = src[qids[sel]]
            continue
        host = _gen_chunk(ci, chunk, d, centers, seed).cpu().numpy()
        mm[c0:c0 + chunk] = host
        mm.flush()
        if sel.any():
            qrows[sel] = host[qids[sel] - c0]
        with open(prog, "w") as f:
            f.write(f"{ci + 1}\n")
    if mm is not None:
        del mm
        with open(path + ".done", "w") as f:
            f.write(f"{n} {d}\n")
        if os.path.exists(prog):
            os.remove(prog)
    return qrows


def exact_gt_device(corpus_path: str, queries: np.ndarray, path: str,
                    k: int = 20, chunk: int = 1 << 21, *,
                    device="cuda") -> np.ndarray:
    """Exact top-k ids by chunked device scans: each chunk uploaded, one
    bf16 product (fp32 accumulation), its top-k merged on the host.
    Cached at ``path``."""
    if os.path.exists(path):
        return np.load(path)["ids"]
    device = resolve_device(device)
    corpus = np.load(corpus_path, mmap_mode="r")
    n = corpus.shape[0]
    q_bf = torch.as_tensor(queries, dtype=torch.float32,
                           device=device).to(torch.bfloat16)
    qsum = queries.sum(1) * DEFAULT_OFFSET
    b = queries.shape[0]
    best_s = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    for c0 in range(0, n, chunk):
        blk = torch.as_tensor(np.array(corpus[c0:c0 + chunk]),
                              device=device)
        # bf16-rounded queries against exact codes, in fp32 (the
        # reference: a bf16 product with fp32 accumulation)
        s = (q_bf.to(torch.float32) @ blk.to(torch.float32).T) / DEFAULT_SCALE
        sv, si = torch.topk(s, min(k, s.shape[1]), dim=1)
        cat_s = np.concatenate([best_s, sv.cpu().numpy() + qsum[:, None]],
                               axis=1)
        cat_i = np.concatenate([best_i, si.cpu().numpy().astype(np.int64)
                                + c0], axis=1)
        sel = np.argpartition(cat_s, -k, axis=1)[:, -k:]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    np.savez(path, ids=best_i)
    return best_i


def size_n(d: int, chunk: int, workdir: str, factor: float = 1.1, *,
           device="cuda", cap=None) -> dict:
    """The row count that puts the corpus past the card: ``factor`` x the
    card's total memory (``torch.cuda.mem_get_info``), in whole chunks.
    If the disk under ``workdir`` cannot hold ``DISK_FACTOR`` x that corpus
    (or ``cap`` rows is smaller), the largest n that fits. Returns {n,
    card_bytes, disk_free_bytes, beyond_card, reason}."""
    device = resolve_device(device)
    if device.type == "cuda":
        _, card = torch.cuda.mem_get_info(device)
    else:
        card = 0
    want = -(-int(factor * card) // (d * chunk)) * chunk if card else chunk
    os.makedirs(workdir, exist_ok=True)
    free = shutil.disk_usage(workdir).free
    fits = int(free / (DISK_FACTOR * d)) // chunk * chunk
    n, reason = want, "sized past the card's memory"
    if fits < want:
        n, reason = fits, (f"the disk holds {free} bytes, not "
                           f"{DISK_FACTOR} x {want} x {d}")
    if cap is not None and cap < n:
        n, reason = cap // chunk * chunk, f"capped at {cap} rows"
    if n < chunk:
        raise RuntimeError(f"no room for one chunk of {chunk} rows: {reason}")
    return {"n": int(n), "card_bytes": int(card), "disk_free_bytes": int(free),
            "beyond_card": bool(card and n * d > card), "reason": reason}


def build(corpus, workdir: str, nlist: int, *, device="cuda") -> tuple:
    """(save dir, build seconds or None): ``IVFIndex.build_host_save`` of
    SQ8 (the reference's config), cached with ``save.done``."""
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex

    n, d = corpus.shape
    idx_dir = os.path.join(workdir, f"tiered_idx_SQ8_{n}x{d}_nl{nlist}")
    if os.path.exists(os.path.join(idx_dir, "save.done")):
        return idx_dir, None
    t0 = time.perf_counter()
    cfg = IVFConfig(num_clusters=nlist, fine_quant="SQ8", kmeans_iters=6,
                    sample_ratio=min(1.0, 1.5e6 / n), balance_factor=4.0)
    IVFIndex.build_host_save(
        corpus, cfg, idx_dir,
        coarse_cache=os.path.join(workdir, f"tiered_coarse_{n}x{d}_{nlist}"),
        verbose=True, device=device)
    with open(os.path.join(idx_dir, "save.done"), "w") as f:
        f.write("ok\n")
    return idx_dir, time.perf_counter() - t0


def serve(index, queries: np.ndarray, gt: np.ndarray, probes, *,
          device="cuda", windows: int = 3) -> dict:
    """{"p<nprobe>": {recall20_b64, batch_s, qps, windows_s}} of one index
    (tiered or in memory) over the batch."""
    out = {}
    for p in probes:
        _, ids = index.search(queries, top_k=20, nprobe=p)
        times = []
        for _ in range(windows):
            t0 = time.perf_counter()
            index.search(queries, top_k=20, nprobe=p)
            _bench.sync(device)
            times.append(time.perf_counter() - t0)
        times.sort()
        el = times[len(times) // 2]
        out[f"p{p}"] = {"recall20_b64": _bench.recall(ids, gt),
                        "batch_s": el, "qps": queries.shape[0] / el,
                        "windows_s": times}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", default="auto",
                    help="rows, or 'auto': past the card's memory, as far "
                         "as the disk holds (see size_n)")
    ap.add_argument("--n_cap", type=int, default=None,
                    help="with --n auto, at most this many rows")
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=131072)
    ap.add_argument("--probes", default="16,64")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block_rows", type=int, default=1 << 18)
    ap.add_argument("--chunk", type=int, default=1 << 21,
                    help="device gen/GT chunk rows (n must be a multiple)")
    ap.add_argument("--compare_hbm", action="store_true",
                    help="also serve the save as an in-memory IVFIndex "
                         "when it fits on the card")
    ap.add_argument("--workdir", default=_bench.default_workdir())
    ap.add_argument("--out", default=_bench.default_out("BENCH_IVF.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.index.tiered import TieredIVF

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    if args.n == "auto":
        sizing = size_n(args.d, args.chunk, args.workdir, device=device,
                        cap=args.n_cap)
    else:
        sizing = {"n": int(args.n), "reason": "given"}
    n = sizing["n"]
    cpath = os.path.join(args.workdir, f"tiered_corpus_{n}x{args.d}.npy")
    print(f"corpus: {cpath} ({sizing})", flush=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    qids = np.sort(rng.integers(0, n, args.batch))
    qrows_raw = gen_corpus_device_stream(cpath, n, args.d, qids,
                                         chunk=args.chunk, device=device)
    corpus = np.load(cpath, mmap_mode="r")
    gen_s = time.perf_counter() - t0
    qrows = qrows_raw.astype(np.float32) / DEFAULT_SCALE + DEFAULT_OFFSET
    qrows += 0.05 * rng.normal(size=qrows.shape).astype(np.float32)
    t0 = time.perf_counter()
    gt = exact_gt_device(cpath, qrows, cpath + ".gt20.npz",
                         chunk=args.chunk, device=device)
    gt_s = time.perf_counter() - t0
    idx_dir, build_s = build(corpus, args.workdir, args.nlist, device=device)

    before = _bench.allocated(device)
    t0 = time.perf_counter()
    tivf = TieredIVF.load(idx_dir, block_rows=args.block_rows, device=device)
    init_s = time.perf_counter() - t0
    probes = [int(x) for x in args.probes.split(",")]
    res = {"n": n, "d": args.d, "nlist": args.nlist, "sizing": sizing,
           "corpus_bytes": int(n) * int(args.d), "gen_s": gen_s,
           "gt_s": gt_s, "build_s": build_s, "init_s": init_s,
           "device": str(device),
           "device_resident_bytes": _bench.device_tensor_bytes(
               tivf.centroids),
           "serve": "TieredIVF (host memmap lists, streamed blocks)"}
    res.update(serve(tivf, qrows, gt, probes, device=device))
    res["allocated_delta_bytes"] = _bench.allocated(device) - before
    del tivf
    if args.compare_hbm:
        fits = (device.type != "cuda" or n * args.d
                < 0.8 * torch.cuda.mem_get_info(device)[0])
        if fits:
            from densephrases_tpu_torch.index.ivf import IVFIndex

            ivf = IVFIndex.load(idx_dir, device=device)
            res["hbm"] = serve(ivf, qrows, gt, probes, device=device)
            del ivf
            if device.type == "cuda":
                torch.cuda.empty_cache()
        else:
            res["hbm"] = "skipped: the corpus does not fit the card"
    _bench.merge_rows(os.path.abspath(args.out), f"tiered_{n}_SQ8", res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
