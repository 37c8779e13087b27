"""The IVF quantizer grid over real phrase vectors (a ``dsmall`` dump).

The counterpart of ``densephrases_tpu/tools/bench_ivf_real.py``. Every
at-scale recall figure of ``bench_ivf_scale`` rides on a synthetic
clustered-Gaussian corpus; real phrase vectors are anisotropic, topic
clustered and filter pruned, and stress k-means, OPQ and nprobe
differently. This tool rebuilds the grid (SQ8, SQ4 and OPQ with M = D/8
subspaces, the flagship OPQ96's 8 dims a subspace) over a ``dsmall`` store
and measures recall@20 against the exact int8 flat scan with real
queries: the held-out dev questions encoded by the trained towers, both
halves stacked as the serve path sends them. For OPQ it also measures the
recall without the int8 refine (decode mode's ranking).

Index saves go to ``--workdir`` (default: beside the store, where
``bench_serve_real`` reads them); the result goes under ``real_vectors``
in ``--out`` (default in the system's temp dir).

Run on the card:
  python -m densephrases_tpu_torch.tools.bench_ivf_real \\
      --store <dsmall workdir>/store_pars<N> --encoder <dsmall>/encoder
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device


def fine_quant(quant: str, d: int) -> str:
    """The grid's name for a quant: OPQ means OPQ with M = D/8."""
    return f"OPQ{d // 8}" if quant == "OPQ" else quant


def index_dir(workdir: str, quant: str, n: int, d: int) -> str:
    return os.path.join(workdir, f"ivf_real_{fine_quant(quant, d)}_{n}x{d}")


def real_queries(encoder_dir: str, qa_path: str, nq: int, *,
                 device="cuda") -> tuple:
    """(stacked [2 nq, D] start/end query halves, encode seconds): the
    first ``nq`` dev questions through the trained towers."""
    from densephrases_tpu_torch.cli.common import load_encoder
    from densephrases_tpu_torch.model import DensePhrases

    with open(qa_path) as f:
        dev_qs = [e["question"] for e in json.load(f)["dev"]][:nq]
    params, config, tok = load_encoder(encoder_dir, device=device)
    dp = DensePhrases(params, config, tok, _bench.EncodeOnly(params.device),
                      max_query_length=24)
    t0 = time.perf_counter()
    qvec = dp.query2vec(dev_qs).float().cpu().numpy()
    encode_s = time.perf_counter() - t0
    d = qvec.shape[1] // 2
    return np.concatenate([qvec[:, :d], qvec[:, d:]], axis=0), encode_s


def flat_truth(store, stacked: np.ndarray, *, device="cuda") -> np.ndarray:
    """Exact top-20 ids of the int8 flat scan (freed after)."""
    from densephrases_tpu_torch.index.flat import FlatIndex

    flat = FlatIndex(np.asarray(store.vecs), store.offset, store.scale,
                     chunk=65536, device=device)
    _, ids = flat.search(stacked, top_k=20)
    del flat
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ids


def grid_row(store, quant: str, stacked: np.ndarray, gt: np.ndarray,
             probes, workdir: str, nlist: int, refine_factor: int, *,
             device="cuda") -> dict:
    """Build (or load) one quant's index over the store and measure its
    recall@20 at each probe count."""
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex

    vecs = np.asarray(store.vecs)
    n, d = vecs.shape
    fq = fine_quant(quant, d)
    path = index_dir(workdir, quant, n, d)
    t0 = time.perf_counter()
    if os.path.exists(os.path.join(path, "save.done")):
        ivf = IVFIndex.load(path, device=device)
        build_s = None
    else:
        cfg = IVFConfig(num_clusters=nlist, fine_quant=fq, kmeans_iters=6,
                        balance_factor=4.0, refine_factor=refine_factor)
        ivf = IVFIndex.build(vecs, cfg, verbose=True, device=device)
        build_s = time.perf_counter() - t0
        ivf.save(path)
        with open(os.path.join(path, "save.done"), "w") as f:
            f.write("ok\n")
    lens = np.diff(ivf.list_offsets.cpu().numpy())
    row = {"build_s": build_s, "nlist_actual": int(ivf.centroids.shape[0]),
           "list_mean": float(lens.mean()), "list_max": int(lens.max()),
           "code_bytes": int(ivf.codes.element_size() * ivf.n_real
                             * ivf.codes.shape[1])}
    for p in probes:
        t0 = time.perf_counter()
        _, ids = ivf.search(stacked, top_k=20, nprobe=p)
        row[f"p{p}"] = {"recall20": _bench.recall(ids, gt),
                        "search_s": time.perf_counter() - t0,
                        "ids": ids}
        if quant == "OPQ" and ivf.refine_codes is not None:
            # decode mode's ranking: no int8 refine matrix
            rc, ivf.refine_codes = ivf.refine_codes, None
            _, ids_nr = ivf.search(stacked, top_k=20, nprobe=p)
            ivf.refine_codes = rc
            row[f"p{p}"]["recall20_norefine"] = _bench.recall(ids_nr, gt)
    del ivf
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--store", required=True,
                    help="real phrase store dir (tools/dsmall.py output)")
    ap.add_argument("--encoder", required=True,
                    help="trained encoder dir (its query towers)")
    ap.add_argument("--qa", default=None,
                    help="dsmall qa_doc_split.json; default "
                         "<store>/../qa_doc_split.json")
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--nq", type=int, default=256,
                    help="dev questions to encode as recall probes")
    ap.add_argument("--quants", default="SQ8,SQ4,OPQ")
    ap.add_argument("--probes", default="16,64")
    ap.add_argument("--refine_factor", type=int, default=16)
    ap.add_argument("--workdir", default=None,
                    help="index saves (default: beside the store)")
    ap.add_argument("--out", default=_bench.default_out("IVF_SCALE.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.index.store import PhraseStore

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    store_dir = os.path.abspath(args.store)
    workdir = args.workdir or os.path.dirname(store_dir)
    store = PhraseStore.load(store_dir)
    n, d = store.vecs.shape
    stacked, encode_s = real_queries(
        os.path.abspath(args.encoder),
        args.qa or os.path.join(os.path.dirname(store_dir),
                                "qa_doc_split.json"),
        args.nq, device=device)
    gt = flat_truth(store, stacked, device=device)
    section = {"store": store_dir, "n": int(n), "d": int(d),
               "nlist": args.nlist, "n_queries": stacked.shape[0] // 2,
               "query_source": "document-held-out dev questions, trained "
                               "towers", "encode_s": encode_s}
    probes = [int(p) for p in args.probes.split(",")]
    for quant in args.quants.split(","):
        row = grid_row(store, quant, stacked, gt, probes, workdir,
                       args.nlist, args.refine_factor, device=device)
        for p in probes:
            row[f"p{p}"].pop("ids")
        section[f"ivf_{fine_quant(quant, d)}"] = row
        print(f"{quant}: {json.dumps(row)}", flush=True)
    out = os.path.abspath(args.out)
    res = {}
    if os.path.exists(out):
        with open(out) as f:
            res = json.load(f)
    res["real_vectors"] = section
    _bench.write_json(out, res)
    print(json.dumps(section))
    return section


if __name__ == "__main__":
    main()
