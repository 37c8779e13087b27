"""The whole serve over a real store: ``dsmall``'s dump and encoder.

The counterpart of ``densephrases_tpu/tools/bench_serve_real.py``.
``bench_ivf_e2e`` serves synthetic metadata (identity word maps, "word
word ..." contexts), so its rescore, assembly and ``MIPS`` set-up never
touch a realistic metadata path. This tool serves a real ``dsmall`` dump:
real contexts, word-to-character maps, compressed per-doc metadata, the
trained encoder, and the held-out dev questions as the query stream.

It reports the store load and metadata preload (``preload_metas``), the
``MIPS`` set-up stages, dev EM@1 over the stream as an end-to-end check,
q/s, and the stage split (towers, search, rescore with real assembly) on
the synchronised host clock. ``--index flat`` serves the store's flat int8
index; ``SQ8`` / ``SQ4`` / ``OPQ`` serve ``bench_ivf_real``'s saves (OPQ
in decode mode, kernel D; SQ kernel C).

Run on the card:
  python -m densephrases_tpu_torch.tools.bench_serve_real \\
      --store <dsmall workdir>/store_pars<N> --encoder <dsmall>/encoder_qft
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device


def load_dev(qa_path: str):
    """(questions, gold answer lists) of the dsmall dev split."""
    with open(qa_path) as f:
        dev = json.load(f)["dev"]
    return [e["question"] for e in dev], [[e["answer_text"]] for e in dev]


def open_store(store_dir: str) -> tuple:
    """(store, info): the store and its metadata preloaded, with seconds."""
    from densephrases_tpu_torch.index.store import PhraseStore

    t0 = time.perf_counter()
    store = PhraseStore.load(store_dir)
    info = {"store_load_s": time.perf_counter() - t0,
            "n_vecs": int(store.n_vecs), "n_docs": int(store.num_docs)}
    meta_file = os.path.join(store_dir, "meta.pkls")
    if os.path.exists(meta_file):
        info["meta_bytes_disk"] = os.path.getsize(meta_file)
    t0 = time.perf_counter()
    store.preload_metas(background=False)
    info["meta_preload_s"] = time.perf_counter() - t0
    return store, info


def open_index(store, index: str, workdir: str, *, device="cuda") -> tuple:
    """(MIPS, info) over the flat index or a ``bench_ivf_real`` save."""
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.tools.bench_ivf_real import index_dir

    t0 = time.perf_counter()
    if index == "flat":
        mips = MIPS(store, preload_meta=False, device=device)
        info = {}
    else:
        path = index_dir(workdir, index, store.n_vecs, store.dim)
        if not os.path.exists(os.path.join(path, "save.done")):
            raise FileNotFoundError(
                f"{path}: run tools/bench_ivf_real.py first")
        ivf = IVFIndex.load(path, drop_refine=index == "OPQ", device=device)
        mips = MIPS(store, index=ivf, preload_meta=False, device=device)
        info = {"pq_decode_rescore": mips.pq_serve is not None}
    info["mips_init_s"] = time.perf_counter() - t0
    info["mips_init_stages"] = mips.init_stages
    return mips, info


def dev_batches(qs, golds, batch: int, limit: int = 12):
    return [(qs[i:i + batch], golds[i:i + batch])
            for i in range(0, len(qs) - batch + 1, batch)][:limit]


def em_at_1(dp, batches, nprobe: int) -> dict:
    """EM@1 over the stream, and the top-1 answers and (doc, start, end)
    ids of each question."""
    from densephrases_tpu_torch.eval.metrics import exact_match_score

    hits = total = 0
    answers, ids = [], []
    for bq, bg in batches:
        qv = dp.query2vec(bq)
        outs = dp.mips.search(qv, q_texts=bq, top_k=1, nprobe=nprobe,
                              aggregate=True)
        for ret, gold in zip(outs, bg):
            total += 1
            top = ret[0] if ret else None
            answers.append(top["answer"] if top else "")
            ids.append((top["doc_idx"], top["start_idx"], top["end_idx"])
                       if top else None)
            if top and any(exact_match_score(top["answer"], g)
                           for g in gold):
                hits += 1
    return {"dev_em1": 100.0 * hits / max(total, 1), "dev_em1_n": total,
            "answers": answers, "ids": ids}


def measure(dp, batches, nprobe: int, top_k: int, *, device,
            n_batches: int = 8, windows: int = 5) -> dict:
    """q/s over windows of ``n_batches`` (host clock, median window) and
    the stage split on the first batch (synchronised host clock)."""
    mips = dp.mips

    def one_batch(i):
        bq, _ = batches[i % len(batches)]
        qv = dp.query2vec(bq)
        return mips.search(qv, q_texts=bq, top_k=top_k, nprobe=nprobe,
                           aggregate=True)

    for i in range(4):
        one_batch(i)
    times = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(n_batches):
            one_batch(w * n_batches + i)
        times.append(time.perf_counter() - t0)
    times.sort()
    bsz = len(batches[0][0])
    res = {"qps": n_batches * bsz / times[len(times) // 2],
           "windows_s": times}
    bq, _ = batches[0]
    encode_ms = _bench.timed_ms(lambda: dp.query2vec(bq), device, n_rep=4,
                                warmup=1)
    qv = dp.query2vec(bq)
    search_ms = _bench.timed_ms(
        lambda: mips.search_dense(qv, top_k=top_k, nprobe=nprobe), device,
        n_rep=4, warmup=1)
    hits = mips.search_dense(qv, top_k=top_k, nprobe=nprobe)
    _bench.sync(device)
    t0 = time.perf_counter()
    mips.search_phrase(qv, *hits)
    res["stages_ms"] = {"encode": encode_ms, "search": search_ms,
                        "rescore_assemble_real_meta":
                            1e3 * (time.perf_counter() - t0)}
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--encoder", required=True)
    ap.add_argument("--qa", default=None,
                    help="dsmall qa_doc_split.json; default "
                         "<store>/../qa_doc_split.json")
    ap.add_argument("--index", default="flat",
                    help="flat, or a fine quant (SQ8/SQ4/OPQ) served from "
                         "the bench_ivf_real index cache")
    ap.add_argument("--nprobe", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--workdir", default=None,
                    help="bench_ivf_real's index cache (default: beside "
                         "the store)")
    ap.add_argument("--out", default=_bench.default_out(
        "BENCH_SERVE_REAL.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.cli.common import load_encoder
    from densephrases_tpu_torch.model import DensePhrases

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    store_dir = os.path.abspath(args.store)
    workdir = args.workdir or os.path.dirname(store_dir)
    qs, golds = load_dev(args.qa or os.path.join(
        os.path.dirname(store_dir), "qa_doc_split.json"))
    res = {"store": store_dir, "index": args.index, "batch": args.batch,
           "top_k": args.top_k, "device": str(device)}
    store, info = open_store(store_dir)
    res.update(info)
    mips, info = open_index(store, args.index, workdir, device=device)
    res.update(info)
    res["nprobe"] = 0 if args.index == "flat" else args.nprobe
    params, config, tok = load_encoder(os.path.abspath(args.encoder),
                                       device=device)
    dp = DensePhrases(params, config, tok, mips, max_query_length=24)
    batches = dev_batches(qs, golds, args.batch)
    if not batches:
        raise ValueError(f"{len(qs)} dev questions < one batch of "
                         f"{args.batch}")
    nprobe = args.nprobe or 64
    bq, _ = batches[0]
    outs = mips.search(dp.query2vec(bq), q_texts=bq, top_k=args.top_k,
                       nprobe=nprobe, aggregate=True)
    assert len(outs) == args.batch and outs[0][0]["answer"]
    em = em_at_1(dp, batches, nprobe)
    res["dev_em1"], res["dev_em1_n"] = em["dev_em1"], em["dev_em1_n"]
    res.update(measure(dp, batches, nprobe, args.top_k, device=device))
    out = os.path.abspath(args.out)
    blob = {}
    if os.path.exists(out):
        try:
            with open(out) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            blob = {}
    blob[args.index] = res
    _bench.write_json(out, blob)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
