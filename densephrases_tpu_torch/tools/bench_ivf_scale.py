"""IVF against flat at scale: the at-scale measurement grid.

The counterpart of ``densephrases_tpu/tools/bench_ivf_scale.py``. It makes
a clustered int8 corpus (10,485,760 x 768 by default: 8 GB), its exact flat
ground truth, and an IVF index for each requested fine quantization (SQ8,
SQ4, OPQ96; the reference's headline index is ``1048576_flat_OPQ96``), then
measures:

- ms a batch at batch 1 and 64 (the synchronised host clock) and q/s,
- recall@20 against the exact flat scan, over ``--probes``,
- the index's bytes (codes, books) and its tensors' bytes on the device,
- with ``--kernel_rows``, each list-scan kernel alone (C for SQ8 / SQ4, D
  for PQ / OPQ) on the batch of 64's own block table: CUDA-event ms, its
  launches in one search, the bound of its work and its share of the
  whole scan.

Each stage is split into a function the tests call: ``gen_corpus_device``
/ ``cache_corpus`` (the corpus, made on the device from a
``torch.Generator`` and cached as an ``.npy`` memmap with a ``.done``
marker), ``corpus_queries`` and ``ground_truth`` (``.gt20.npz``, from the
device flat scan or, for a cached corpus, an exact host scan),
``build_or_load`` (every quantization shares one ``coarse_cache``) and
``measure`` / ``kernel_rows``.

The reference's TPU timing harnesses stay behind: its dispatch floor and
fori-loop repeats (``dispatch_floor_ms``, ``amortized_ms``,
``bench_union_repeat``) and the grouped XLA scans it compared against
(``--no_grouped``, ``--grouped_budget_ms``). Its ``*_rep_*`` keys are
gone; ``kernel_rows`` measures the kernel itself instead. ``--coarse_only``
(the 2^20-list probe study, timed by fori loops) is not ported.

Everything goes under ``--workdir`` and ``--out``, by default in the
system's temp dir (``tools/_bench.py``), never in the repository.

Run on the card:  python -m densephrases_tpu_torch.tools.bench_ivf_scale
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE
from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device

GT_K = 20


# ------------------------------------------------------------------ corpus
def gen_corpus_device(n: int, d: int, n_clusters: int = 4096, seed: int = 0,
                      block: int = 1 << 20, *, device="cuda") -> torch.Tensor:
    """Clustered int8 corpus [n, d] made on ``device``: centres ~ N(-2, 1),
    members = centre + 0.3 N(0, 1), quantized with the store's affine int8
    contract. One ``torch.Generator`` on the device draws it (the
    reference draws from ``jax.random``: same distribution, other bits).
    Temporary memory is O(block x d) fp32."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((n_clusters, d), generator=gen,
                          device=device) - 2.0
    out = torch.empty((n, d), dtype=torch.int8, device=device)
    for b0 in range(0, n, block):
        rows = min(block, n - b0)
        idx = torch.randint(0, n_clusters, (rows,), generator=gen,
                            device=device)
        x = centers[idx] + 0.3 * torch.randn((rows, d), generator=gen,
                                             device=device)
        out[b0:b0 + rows] = torch.clamp(
            torch.round((x - DEFAULT_OFFSET) * DEFAULT_SCALE),
            -128, 127).to(torch.int8)
    return out


def cache_corpus(codes_dev: torch.Tensor, path: str,
                 block: int = 1 << 20) -> None:
    """Copy a device corpus into an int8 ``.npy`` memmap at ``path``, then
    write ``path.done``. A ``.progress`` sidecar records the rows already
    flushed, so a rerun (the corpus is deterministic in its seed) resumes
    after them; a memmap without it is never trusted."""
    n, d = codes_dev.shape
    prog = path + ".progress"
    start = 0
    if os.path.exists(path) and os.path.exists(prog):
        try:
            prows, pd = (int(v) for v in open(prog).read().split()[:2])
            if pd == d and 0 < prows <= n and (prows % block == 0
                                               or prows == n):
                start = prows
        except (ValueError, OSError):
            start = 0
    mm = np.lib.format.open_memmap(
        path, mode="r+" if start else "w+", dtype=np.int8, shape=(n, d))
    if start and mm.shape != (n, d):
        # r+ trusts the header over the shape: a wrong-shaped cache restarts
        del mm
        start = 0
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int8,
                                       shape=(n, d))
    for b0 in range(start, n, block):
        b1 = min(b0 + block, n)
        mm[b0:b1] = codes_dev[b0:b1].cpu().numpy()
        mm.flush()
        with open(prog, "w") as f:
            f.write(f"{b1} {d}\n")
    del mm
    with open(path + ".done", "w") as f:
        f.write(f"{n} {d}\n")
    if os.path.exists(prog):
        os.remove(prog)


def corpus_path(workdir: str, n: int, d: int) -> str:
    return os.path.join(workdir, f"ivf_scale_corpus_{n}x{d}.npy")


def load_or_make_corpus(path: str, n: int, d: int, *, device="cuda",
                        keep_on_device: bool = True):
    """(host memmap, device corpus or None, seconds to make it or None).
    A cached corpus is read from ``path``; else it is made on the device
    and cached. keep_on_device: keep (or upload) the device copy for the
    flat ground truth."""
    device = resolve_device(device)
    if os.path.exists(path) and os.path.exists(path + ".done"):
        host = np.load(path, mmap_mode="r")
        if host.shape != (n, d):
            raise ValueError(f"{path} holds {host.shape}, not {(n, d)}")
        dev = (torch.as_tensor(np.array(host), device=device)
               if keep_on_device else None)
        return host, dev, None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t0 = time.perf_counter()
    dev = gen_corpus_device(n, d, device=device)
    _bench.sync(device)
    gen_s = time.perf_counter() - t0
    cache_corpus(dev, path)
    return np.load(path, mmap_mode="r"), dev if keep_on_device else None, \
        gen_s


def corpus_queries(host_codes, seed: int = 1, n_q: int = 65) -> np.ndarray:
    """The IVF_SCALE query protocol: ``n_q`` sorted random corpus rows,
    dequantized, plus 0.05 N(0, 1) (rows [0:1] are the batch of 1, [1:65]
    the batch of 64). ``bench_cpu_ivf`` draws the same chain."""
    n = host_codes.shape[0]
    rng = np.random.default_rng(seed)
    qids = np.sort(rng.integers(0, n, n_q))
    qrows = np.ascontiguousarray(host_codes[qids]).astype(np.float32)
    qrows = qrows / DEFAULT_SCALE + DEFAULT_OFFSET
    qrows += 0.05 * rng.normal(size=qrows.shape).astype(np.float32)
    return qrows


# ------------------------------------------------------------ ground truth
def exact_gt_host(host_codes, queries: np.ndarray, k: int = GT_K,
                  block: int = 1 << 20) -> np.ndarray:
    """Exact top-k ids by fp32 host scans over ``block`` rows at a time
    (the reference's host path for a cached corpus)."""
    n = host_codes.shape[0]
    b = queries.shape[0]
    best_s = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    qsum = queries.sum(1, keepdims=True) * DEFAULT_OFFSET
    for c0 in range(0, n, block):
        blk = np.ascontiguousarray(host_codes[c0:c0 + block]).astype(
            np.float32)
        s = queries @ blk.T / DEFAULT_SCALE + qsum
        kk = min(k, s.shape[1])
        part = np.argpartition(s, -kk, axis=1)[:, -kk:]
        cat_s = np.concatenate(
            [best_s, np.take_along_axis(s, part, axis=1)], axis=1)
        cat_i = np.concatenate([best_i, part + c0], axis=1)
        sel = np.argpartition(cat_s, -k, axis=1)[:, -k:]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    order = np.argsort(-best_s, axis=1, kind="stable")
    return np.take_along_axis(best_i, order, axis=1)


def exact_gt_device(codes, queries: np.ndarray, k: int = GT_K, *,
                    device="cuda") -> np.ndarray:
    """Exact top-k ids by the flat index (``FlatIndex.search``) over
    ``codes`` (a device tensor or a host array). The flat index is freed
    before returning."""
    from densephrases_tpu_torch.index.flat import FlatIndex

    flat = FlatIndex(codes, chunk=65536, device=device)
    _, ids = flat.search(queries, top_k=k)
    del flat
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ids


def ground_truth(path: str, host_codes, qrows: np.ndarray, codes_dev=None,
                 *, device="cuda"):
    """(ei1, ei64): exact top-20 of the batch of 1 and the batch of 64,
    cached at ``path`` (``<corpus>.gt20.npz``). From the device flat scan
    when ``codes_dev`` is given, else an exact host scan."""
    if os.path.exists(path):
        gt = np.load(path)
        return gt["ei1"], gt["ei64"]
    q1, q64 = qrows[:1], qrows[1:]
    if codes_dev is not None:
        ei1 = exact_gt_device(codes_dev, q1, device=device)
        ei64 = exact_gt_device(codes_dev, q64, device=device)
    else:
        ei1 = exact_gt_host(host_codes, q1)
        ei64 = exact_gt_host(host_codes, q64)
    np.savez(path, ei1=ei1, ei64=ei64)
    return ei1, ei64


# ------------------------------------------------------------------ builds
def index_dir(workdir: str, quant: str, n: int, d: int, nlist: int) -> str:
    """The save directory of one quantization (the reference's names: the
    default nlist carries no suffix)."""
    nl_sfx = "" if nlist == 65536 else f"_nl{nlist}"
    return os.path.join(workdir, f"ivf_scale_idx_{quant}_{n}x{d}{nl_sfx}")


def coarse_dir(workdir: str, n: int, d: int, nlist: int) -> str:
    return os.path.join(workdir, f"ivf_scale_coarse_{n}x{d}_{nlist}")


def scale_config(quant: str, nlist: int, n: int,
                 refine_factor: Optional[int] = None, **overrides):
    """The grid's ``IVFConfig`` (the reference's: 6 k-means iterations, a
    1M-row sample, balance factor 4, refine factor 4)."""
    from densephrases_tpu_torch.index.ivf import IVFConfig

    kw = dict(num_clusters=nlist, fine_quant=quant, kmeans_iters=6,
              sample_ratio=min(1.0, 1e6 / n), balance_factor=4.0,
              refine_factor=refine_factor or 4)
    kw.update(overrides)
    return IVFConfig(**kw)


def build_or_load(host_codes, quant: str, nlist: int, workdir: str,
                  refine_factor: Optional[int] = None, *, device="cuda",
                  refine_mode: str = "device", **cfg_overrides):
    """(index, build seconds or None). A saved index (``save.done``) is
    loaded; else built from the shared coarse cache, saved and marked."""
    from densephrases_tpu_torch.index.ivf import IVFIndex

    n, d = host_codes.shape
    path = index_dir(workdir, quant, n, d, nlist)
    if os.path.exists(os.path.join(path, "save.done")):
        ivf = IVFIndex.load(path, refine_mode=refine_mode, device=device)
        if refine_factor is not None:
            ivf.cfg.refine_factor = refine_factor
        return ivf, None
    t0 = time.perf_counter()
    cfg = scale_config(quant, nlist, n, refine_factor, **cfg_overrides)
    ivf = IVFIndex.build(host_codes, cfg, verbose=True,
                         coarse_cache=coarse_dir(workdir, n, d, nlist),
                         device=device)
    _bench.sync(device)
    build_s = time.perf_counter() - t0
    if os.path.exists(path):
        shutil.rmtree(path)
    ivf.save(path)
    with open(os.path.join(path, "save.done"), "w") as f:
        f.write("ok\n")
    return ivf, build_s


def index_row(ivf) -> dict:
    """The index's shape and bytes: its codes (+ PQ books) as saved, and
    every tensor it keeps on its device."""
    lens = np.diff(ivf.list_offsets.cpu().numpy())
    code_bytes = int(ivf.codes.element_size() * ivf.n_real
                     * ivf.codes.shape[1])
    row = {"nlist_actual": int(ivf.centroids.shape[0]), "cap": int(ivf.cap),
           "list_mean": float(lens.mean()), "list_max": int(lens.max()),
           "code_bytes": code_bytes}
    if ivf.pq_books is not None:
        row["code_bytes"] += int(ivf.pq_books.numel() * 4)
        row["refine"] = ivf.refine_codes is not None
    row["device_bytes"] = _bench.device_tensor_bytes(
        ivf.codes, ivf.centroids, ivf.row_perm, ivf.list_offsets,
        ivf.refine_codes, ivf.pq_books, ivf.rotation)
    return row


# ----------------------------------------------------------------- measure
def measure(ivf, q1: np.ndarray, q64: np.ndarray, ei1, ei64, probes,
            *, device="cuda", n_rep: int = 5, top_k: int = GT_K) -> dict:
    """{"p<nprobe>": {b1_ms, b64_ms, b64_qps, recall20_b1, recall20_b64}}:
    ms a batch (median, synchronised host clock) and recall@20 against
    the exact ids."""
    out = {}
    for nprobe in probes:
        _, i1 = ivf.search(q1, top_k=top_k, nprobe=nprobe)
        _, i64 = ivf.search(q64, top_k=top_k, nprobe=nprobe)
        ms1 = _bench.timed_ms(
            lambda: ivf.search(q1, top_k=top_k, nprobe=nprobe), device,
            n_rep=n_rep)
        ms64 = _bench.timed_ms(
            lambda: ivf.search(q64, top_k=top_k, nprobe=nprobe), device,
            n_rep=n_rep)
        out[f"p{nprobe}"] = {
            "b1_ms": ms1, "b64_ms": ms64, "b64_qps": 64e3 / ms64,
            "recall20_b1": _bench.recall(i1, ei1),
            "recall20_b64": _bench.recall(i64, ei64)}
    return out


def kernel_rows(ivf, queries: np.ndarray, probes, *, device="cuda",
                top_k: int = GT_K, iters: int = 20) -> dict:
    """Each probe's list-scan kernel alone on the batch's own inputs:
    {"p<nprobe>": {kernel, launches, ms, scan_ms, share_of_scan, bound_ms,
    bound_by, rows}}. The kernel's inputs are those one ``search`` hands
    it; ``ms`` is its CUDA-event time on them, ``scan_ms`` that of the whole
    ``search``; ``launches`` counts its launches in that one search. The
    bound counts the valid rows' codes, the queries or LUTs, the block
    table and the fp32 scores of the valid columns. Timing launches leave
    the counters as they were."""
    from densephrases_tpu_torch.ops import ivf_pack as pack

    pq = ivf.pq_books is not None
    name = "pq_pack_score" if pq else "pack_score"
    kernel = pack.PQ_PACK_SCORE if pq else pack.IVF_PACK_SCORE
    real_fn, real_bt = getattr(pack, name), pack.block_table
    q = torch.as_tensor(queries, dtype=torch.float32, device=ivf.device)
    b = int(q.shape[0])
    out = {}
    for nprobe in probes:
        seen = {}

        def spy(*a, **kw):
            seen["args"] = (a, kw)
            return real_fn(*a, **kw)

        def spy_bt(*a, **kw):
            blk, total = real_bt(*a, **kw)
            seen["total"] = total
            return blk, total

        setattr(pack, name, spy)
        pack.block_table = spy_bt
        try:
            before = kernel.launches
            ivf.search(q, top_k=top_k, nprobe=nprobe, as_numpy=False)
            _bench.sync(device)
            launches = kernel.launches - before
        finally:
            setattr(pack, name, real_fn)
            pack.block_table = real_bt
        a, kw = seen["args"]
        with _bench.uncounted(kernel):
            ms = _bench.device_ms(lambda: real_fn(*a, **kw), device,
                                  iters=iters)
            scan_ms = _bench.device_ms(
                lambda: ivf.search(q, top_k=top_k, nprobe=nprobe,
                                   as_numpy=False), device, iters=iters)
        valid = int(seen["total"]) * pack.RB
        src, codes, blk = a[0], a[1], a[2]
        row_bytes = codes.shape[1] * codes.element_size()
        if pq:
            ops, kind = b * valid * int(src.shape[1]), "float32"
        else:
            ops, kind = 2 * b * valid * ivf.centroids.shape[1], "bfloat16"
        nbytes = (valid * row_bytes + src.numel() * src.element_size()
                  + 4 * blk.numel() + 4 * b * valid)
        bound_ms, bound_by = _bench.bound(ops, nbytes, kind)
        out[f"p{nprobe}"] = {
            "kernel": "pq_pack_score" if pq else "ivf_pack_score",
            "batch": b, "rows": valid, "launches": launches, "ms": ms,
            "scan_ms": scan_ms, "share_of_scan": ms / scan_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
    return out


# -------------------------------------------------------------------- main
def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=65536)
    ap.add_argument("--quants", default="SQ8,SQ4,OPQ96",
                    help="comma list of fine quantizations to build+measure")
    ap.add_argument("--refine_factor", type=int, default=None,
                    help="override IVFConfig.refine_factor at search time "
                         "(rows land under ivf_<quant>_rf<N>)")
    ap.add_argument("--probes", default="16,64,256",
                    help="comma list of nprobe values to measure")
    ap.add_argument("--n_rep", type=int, default=5,
                    help="timed searches a point (median)")
    ap.add_argument("--kernel_rows", action="store_true",
                    help="also time each list-scan kernel alone at batch "
                         "64 (CUDA events), with its bound")
    ap.add_argument("--cache", default=None,
                    help="corpus memmap path (.npy); default "
                         "{workdir}/ivf_scale_corpus_{n}x{d}.npy")
    ap.add_argument("--workdir", default=_bench.default_workdir(),
                    help="corpus, ground truth, coarse and index caches")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing output JSON (the caches stay)")
    ap.add_argument("--out", default=_bench.default_out("IVF_SCALE.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    os.makedirs(args.workdir, exist_ok=True)
    cache = args.cache or corpus_path(args.workdir, args.n, args.d)
    out_path = os.path.abspath(args.out)
    res = {}
    if not args.fresh and os.path.exists(out_path):
        with open(out_path) as f:
            res = json.load(f)
        if (res.get("n"), res.get("d"), res.get("nlist")) != (
                args.n, args.d, args.nlist):
            res = {}
    res.update({"n": args.n, "d": args.d, "nlist": args.nlist,
                "device": str(device),
                "device_name": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu")})

    t0 = time.perf_counter()
    gt_path = cache + ".gt20.npz"
    host_codes, codes_dev, gen_s = load_or_make_corpus(
        cache, args.n, args.d, device=device,
        keep_on_device=not os.path.exists(gt_path))
    if gen_s is not None:
        res["gen_s"] = gen_s
    res["corpus_s"] = time.perf_counter() - t0
    qrows = corpus_queries(host_codes)
    q1, q64 = qrows[:1], qrows[1:]

    t0 = time.perf_counter()
    if codes_dev is not None:
        from densephrases_tpu_torch.index.flat import FlatIndex

        ei1, ei64 = ground_truth(gt_path, host_codes, qrows, codes_dev,
                                 device=device)
        flat = FlatIndex(codes_dev, chunk=65536, device=device)
        del codes_dev
        res["flat_b1_ms"] = _bench.timed_ms(
            lambda: flat.search(q1, top_k=GT_K), device, n_rep=args.n_rep)
        res["flat_b64_ms"] = _bench.timed_ms(
            lambda: flat.search(q64, top_k=GT_K), device, n_rep=args.n_rep)
        res["flat_b64_qps"] = 64e3 / res["flat_b64_ms"]
        del flat
    else:
        ei1, ei64 = ground_truth(gt_path, host_codes, qrows, device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res["gt_s"] = time.perf_counter() - t0
    res["flat_bytes"] = int(args.n) * int(args.d)
    _bench.write_json(out_path, res)

    probes = tuple(int(p) for p in args.probes.split(",") if p.strip())
    for quant in (q.strip() for q in args.quants.split(",")):
        qkey = (f"ivf_{quant}" if args.refine_factor is None
                else f"ivf_{quant}_rf{args.refine_factor}")
        print(f"=== {quant} ===", flush=True)
        ivf, build_s = build_or_load(host_codes, quant, args.nlist,
                                     args.workdir, args.refine_factor,
                                     device=device)
        row = index_row(ivf)
        if build_s is not None:
            row["build_s"] = build_s
        if args.refine_factor is not None:
            row["refine_factor"] = args.refine_factor
        row.update(measure(ivf, q1, q64, ei1, ei64, probes, device=device,
                           n_rep=args.n_rep))
        if args.kernel_rows:
            row["kernel"] = kernel_rows(ivf, q64, probes, device=device)
        res[qkey] = row
        print(f"  {quant}: {json.dumps(row)}", flush=True)
        _bench.write_json(out_path, res)
        del ivf
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
