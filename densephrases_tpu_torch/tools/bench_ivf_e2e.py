"""The whole serve at IVF scale, end to end over ``bench_ivf_scale``'s corpus.

The counterpart of ``densephrases_tpu/tools/bench_ivf_e2e.py``. It composes
the serving pipeline -- tokenize, the BERT-base query towers (kernel A),
the IVF search (OPQ96 with its int8 refine by default: kernel D), the
windowed span rescore and host assembly -- over the corpus and index
directories that ``bench_ivf_scale`` cached, and reports q/s, the stage
split, stage-1 recall@20 against the exact flat scan, and the device bytes
of each ``--serve_mode``:

- ``refine``: the int8 refine matrix on the device, shared with the
  rescore (the reference's flagship serve);
- ``decode``: no int8 matrix on the device; stage 2 decodes the candidate
  windows from the PQ codes;
- ``host_refine``: decode mode's device footprint, the stage-1 candidates
  re-ranked exactly against the host memmap.

Only the store's metadata is synthetic (``synth_store``); every served
vector is a corpus row. The ground truth (the flat scan of the served
query vectors and of in-distribution probes) is computed in this process
and the flat index freed (``del`` and ``torch.cuda.empty_cache``) before
the index loads; the run records ``torch.cuda.memory_allocated`` before
and after it. The reference's child process for that, and its dispatch
floor subtraction, stay behind. Random-weight queries are far from the
corpus's distribution, so recall is measured on perturbed corpus rows, as
``bench_ivf_scale`` does.

Run on the card, after ``bench_ivf_scale``:
  python -m densephrases_tpu_torch.tools.bench_ivf_e2e --serve_mode refine \\
      --nprobe 256
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE
from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device

MODES = {"refine": "device", "decode": "none", "host_refine": "host"}


def synth_store(corpus, vecs_per_doc: int = 1024):
    """In-RAM ``PhraseStore`` around a real [N, D] int8 memmap: N / vpd
    docs, identity word maps, synthetic contexts. Only the metadata is
    synthetic."""
    from densephrases_tpu_torch.index.store import DocMeta, PhraseStore

    n, d = corpus.shape
    assert n % vecs_per_doc == 0
    n_docs = n // vecs_per_doc
    w2cs = np.arange(vecs_per_doc, dtype=np.int32) * 5
    w2ce = w2cs + 4
    f2o = np.arange(vecs_per_doc, dtype=np.int32)
    ctx = " ".join(["word"] * (vecs_per_doc + 2))
    meta_c = DocMeta(doc_id=0, title="doc", context=ctx,
                     word2char_start=w2cs, word2char_end=w2ce,
                     f2o_start=f2o).compress()
    metas = []
    for i in range(n_docs):
        m = dict(meta_c)
        m["doc_id"] = i
        m["title"] = f"doc{i}"
        metas.append(m)
    doc_bases = np.arange(n_docs + 1, dtype=np.int64) * vecs_per_doc
    return PhraseStore(vecs=corpus, doc_bases=doc_bases,
                       doc_ids=np.arange(n_docs, dtype=np.int64),
                       metas=metas, offset=DEFAULT_OFFSET,
                       scale=DEFAULT_SCALE, path=None)


def bench_queries(batch: int):
    """(tokenizer, queries): every query tokenizes to a distinct id
    sequence, so a batch probes distinct lists. The reference trains a
    WordPiece vocab on the query words; here the vocab is those whole
    words (no ``tokenizers`` package needed)."""
    from densephrases_tpu_torch.data.tokenization import (
        SPECIAL_TOKENS, WordPieceTokenizer)

    words = [f"{a}{b}ton" for a in "brancespotilkugh" for b in "aeiou"]
    vocab = SPECIAL_TOKENS + ["benchmark", "query", "words"] + words
    tok = WordPieceTokenizer({t: i for i, t in enumerate(vocab)})
    nw = len(words)
    queries = [f"benchmark query {words[i % nw]} {words[(i * 7 + 3) % nw]}"
               f" words" for i in range(batch)]
    return tok, queries


def indist_queries(corpus, rows: int, seed: int = 0) -> np.ndarray:
    """In-distribution recall probes: perturbed corpus rows."""
    rng = np.random.default_rng(seed)
    qk = np.sort(rng.integers(0, corpus.shape[0], rows))
    q = (np.ascontiguousarray(corpus[qk]).astype(np.float32)
         / DEFAULT_SCALE + DEFAULT_OFFSET)
    return q + 0.05 * rng.normal(size=q.shape).astype(np.float32)


def ground_truth(path: str, corpus, qvec: np.ndarray, indist: np.ndarray,
                 *, device="cuda") -> dict:
    """Exact flat top-20 of the stacked query halves and of the probes,
    cached at ``path``. The flat index is freed before returning; the
    result holds the allocated bytes before, with and after it."""
    from densephrases_tpu_torch.index.flat import FlatIndex

    if os.path.exists(path):
        gt = dict(np.load(path))
        gt["cached"] = True
        return gt
    d = corpus.shape[1]
    stacked = np.concatenate([qvec[:, :d], qvec[:, d:]], axis=0)
    before = _bench.allocated(device)
    flat = FlatIndex(corpus, chunk=65536, device=device)
    during = _bench.allocated(device)
    _, gt_ids = flat.search(stacked, top_k=20)
    _, gt_ind = flat.search(indist, top_k=20)
    del flat
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()
    after = _bench.allocated(device)
    np.savez(path, qvec=qvec, gt_ids=gt_ids, indist=indist, gt_ind=gt_ind)
    return {"qvec": qvec, "gt_ids": gt_ids, "indist": indist,
            "gt_ind": gt_ind, "allocated_before": before,
            "allocated_with_flat": during, "allocated_after": after}


def open_serve(store, idx_dir: str, serve_mode: str, params, config, tok,
               rf=None, *, device="cuda"):
    """(DensePhrases, MIPS, IVFIndex, {init seconds and stages, allocated
    bytes it added}) of one serve mode."""
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases

    before = _bench.allocated(device)
    t0 = time.perf_counter()
    ivf = IVFIndex.load(idx_dir, refine_mode=MODES[serve_mode],
                        device=device)
    if rf is not None:
        ivf.cfg.refine_factor = rf
    mips = MIPS(store, index=ivf, device=device)
    info = {"mips_init_s": time.perf_counter() - t0,
            "mips_init_stages": mips.init_stages,
            "shared_refine_rescore": bool(
                ivf.refine_codes is not None
                and mips.vecs_dev is ivf.refine_codes),
            "pq_decode_rescore": mips.pq_serve is not None}
    dp = DensePhrases(params, config, tok, mips, max_query_length=32,
                      serve_dtype="bf16")
    info["allocated_delta_bytes"] = _bench.allocated(device) - before
    return dp, mips, ivf, info


def serve_batch(dp, queries, nprobe: int, top_k: int):
    """One batch through the whole serve: towers, IVF, rescore, assembly."""
    qv = dp.query2vec(queries)
    return dp.mips.search(qv, q_texts=queries, top_k=top_k, nprobe=nprobe,
                          aggregate=True)


def span_ids(outs):
    """(doc, start, end) of every served answer, batch order."""
    return [[(r["doc_idx"], r["start_idx"], r["end_idx"]) for r in ret]
            for ret in outs]


def measure_qps(dp, queries, nprobe: int, top_k: int, n_batches: int = 8,
                windows: int = 5, warmup: int = 4) -> dict:
    """q/s over ``windows`` windows of ``n_batches`` batches (the median
    of the windows within 3x of the fastest), host clock."""
    for _ in range(warmup):
        serve_batch(dp, queries, nprobe, top_k)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            serve_batch(dp, queries, nprobe, top_k)
        times.append(time.perf_counter() - t0)
    times.sort()
    good = [t for t in times if t <= 3.0 * times[0]] or times
    elapsed = good[len(good) // 2]
    return {"qps": n_batches * len(queries) / elapsed, "windows_s": times}


def stage_split(dp, queries, nprobe: int, top_k: int, *, device,
                reps: int = 4) -> dict:
    """Mean ms of each stage on the synchronised host clock: the towers,
    the IVF search (stage 1), the rescore and host assembly."""
    mips = dp.mips
    encode_ms = _bench.timed_ms(lambda: dp.query2vec(queries), device,
                                n_rep=reps, warmup=1)
    qv = dp.query2vec(queries)
    ivf_ms = _bench.timed_ms(
        lambda: mips.search_dense(qv, top_k=top_k, nprobe=nprobe), device,
        n_rep=reps, warmup=1)
    hits = mips.search_dense(qv, top_k=top_k, nprobe=nprobe)
    _bench.sync(device)
    t0 = time.perf_counter()
    mips.search_phrase(qv, *hits)
    rescore_ms = 1e3 * (time.perf_counter() - t0)
    return {"encode_b": encode_ms, "ivf_search_b": ivf_ms,
            "rescore_assemble_b": rescore_ms}


def serve_device_bytes(ivf, mips) -> int:
    """Bytes of every device tensor the serve holds (the memory point of
    the decode mode is this number)."""
    return _bench.device_tensor_bytes(
        ivf.codes, ivf.centroids, ivf.row_perm, ivf.list_offsets,
        ivf.refine_codes, ivf.pq_books, ivf.rotation, mips.vecs_dev,
        getattr(mips, "f2o_dev", None), getattr(mips, "doc_end_dev", None),
        getattr(mips, "doc_base_dev", None), mips.pq_serve or {})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=65536,
                    help="the bench_ivf_scale build's nlist (names its dir)")
    ap.add_argument("--quant", default="OPQ96",
                    help="which cached bench_ivf_scale index to serve")
    ap.add_argument("--nprobe", type=int, default=16,
                    help="16 (this tool's default); the reference's serve "
                         "default is 256")
    ap.add_argument("--rf", type=int, default=None,
                    help="override IVFConfig.refine_factor at search time")
    ap.add_argument("--serve_mode", default="refine", choices=tuple(MODES))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--workdir", default=_bench.default_workdir())
    ap.add_argument("--out", default=_bench.default_out("BENCH_IVF.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import init_encoder_params
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.tools.bench_ivf_scale import (
        corpus_path, index_dir)

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    cpath = corpus_path(args.workdir, args.n, args.d)
    idx_dir = index_dir(args.workdir, args.quant, args.n, args.d, args.nlist)
    if not (os.path.exists(cpath + ".done")
            and os.path.exists(os.path.join(idx_dir, "save.done"))):
        raise FileNotFoundError(
            f"{cpath} or {idx_dir}: run tools/bench_ivf_scale.py first")
    res = {"n": args.n, "d": args.d, "nlist": args.nlist,
           "quant": args.quant, "nprobe": args.nprobe, "batch": args.batch,
           "top_k": args.top_k, "serve_mode": args.serve_mode,
           "device": str(device)}
    corpus = np.load(cpath, mmap_mode="r")
    store = synth_store(corpus)
    res["n_docs"] = int(store.num_docs)

    config = BertConfig()  # BERT-base geometry, as in bench.py
    params = init_encoder_params(config, torch.Generator().manual_seed(0),
                                 device=device)
    tok, queries = bench_queries(args.batch)

    # ---- ground truth (flat scan, freed before the index loads)
    gt_path = os.path.join(args.workdir,
                           f"e2e_gt_{args.n}x{args.d}_b{args.batch}.npz")
    enc = DensePhrases(params, config, tok, _bench.EncodeOnly(params.device),
                       max_query_length=32, serve_dtype="bf16")
    qvec = enc.query2vec(queries).float().cpu().numpy()
    del enc
    gt = ground_truth(gt_path, corpus,
                      qvec, indist_queries(corpus, 2 * args.batch),
                      device=device)
    for k in ("allocated_before", "allocated_with_flat", "allocated_after"):
        if k in gt:
            res[f"gt_{k}"] = int(gt[k])
    res["distinct_qvecs"] = int(np.unique(gt["qvec"], axis=0).shape[0])
    if res["distinct_qvecs"] != args.batch:
        raise AssertionError("the query texts collapsed to fewer vectors")

    # ---- serve over the IVF index
    dp, mips, ivf, info = open_serve(store, idx_dir, args.serve_mode,
                                     params, config, tok, args.rf,
                                     device=device)
    del params
    res.update(info)
    if args.rf is not None:
        res["refine_factor"] = args.rf
    outs = serve_batch(dp, queries, args.nprobe, args.top_k)
    assert len(outs) == args.batch and outs[0][0]["answer"]
    # the served batch against MIPS.search on the same vectors from the host
    ref = mips.search(gt["qvec"], q_texts=queries, top_k=args.top_k,
                      nprobe=args.nprobe, aggregate=True)
    res["served_equals_mips_search"] = span_ids(outs) == span_ids(ref)
    _, ids = ivf.search(gt["indist"], top_k=20, nprobe=args.nprobe)
    res["stage1_recall20_indist"] = _bench.recall(ids, gt["gt_ind"])
    res.update(measure_qps(dp, queries, args.nprobe, args.top_k))
    res["stages_ms"] = stage_split(dp, queries, args.nprobe, args.top_k,
                                   device=device)
    res["device_resident_bytes"] = serve_device_bytes(ivf, mips)
    key = (f"{args.quant}" + (f"_rf{args.rf}" if args.rf is not None else "")
           + f"_p{args.nprobe}_{args.serve_mode}")
    _bench.merge_rows(os.path.abspath(args.out), key, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
