"""Open-domain retrieval evaluation driver.

The counterpart of ``densephrases_tpu/cli/eval_phrase_retrieval.py`` (ref
eval_phrase_retrieval.py:373-417, one test file or a comma-separated list)
with an explicit device: loads the encoder, the store and the index onto
``device``, runs EM/F1 @1/@k, writes ``pred_*.json`` (ref: :199-205) and
appends to ``eval_logger.txt`` (ref: train_rc.py:402-403); ``--eval_psg``
runs the passage-level eval and writes ``fid_*.json``. ``--index_tier
host`` serves from host memory (``index/tiered.py``): the store is
memory-mapped, an IVF index is a ``TieredIVF`` whose rescore rows come from
the store, and without one a ``TieredFlatIndex`` streams the store.

Usage:
  python -m densephrases_tpu_torch.cli.eval_phrase_retrieval \\
      --load_dir enc/ --dump_dir dump/ --index_name start/1024_flat_SQ8 \\
      --test_path nq_test.json [--regex] [--truecase_path tc.pkl]
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from densephrases_tpu_torch.cli.common import load_encoder
from densephrases_tpu_torch.data.qa import load_qa_pairs
from densephrases_tpu_torch.data.truecase import TrueCaser
from densephrases_tpu_torch.eval.retrieval import evaluate_retrieval
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFIndex
from densephrases_tpu_torch.index.search import MIPS
from densephrases_tpu_torch.index.store import PhraseStore
from densephrases_tpu_torch.index.tiered import TieredFlatIndex, TieredIVF
from densephrases_tpu_torch.model import DensePhrases
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def load_model(opts: Options, *, device) -> DensePhrases:
    m, ix, r = opts.model, opts.index, opts.retrieval
    params, config, tokenizer = load_encoder(m.load_dir, draft=opts.draft,
                                             device=device)
    host_tier = r.index_tier == "host"
    store = PhraseStore.load(os.path.join(ix.dump_dir, ix.phrase_dir),
                             mmap=host_tier)
    index_dir = os.path.join(ix.dump_dir, ix.index_name)
    have_ivf = os.path.exists(os.path.join(index_dir, "ivf.pkl"))
    if host_tier:
        if have_ivf:
            index = TieredIVF.load(index_dir, device=device)
            index.store_vecs = store.vecs
        else:
            index = TieredFlatIndex(store.vecs, store.offset, store.scale,
                                    device=device)
    elif have_ivf:
        index = IVFIndex.load(index_dir, device=device)
    else:
        index = FlatIndex(np.asarray(store.vecs), store.offset, store.scale,
                          device=device)
    mips = MIPS(store, index=index)
    truecase = TrueCaser(r.truecase_path) if (r.truecase and r.truecase_path
                                              and os.path.exists(r.truecase_path)) else None
    return DensePhrases(params, config, tokenizer, mips,
                        max_query_length=m.max_query_length, truecase=truecase)


def evaluate_psg(opts: Options, model, test_path: str):
    """Passage-level retrieval eval + FiD export
    (ref: eval_phrase_retrieval.py:304-371 evaluate_results_psg)."""
    from densephrases_tpu_torch.eval.passage import (
        evaluate_passages, to_fid_format)

    r = opts.retrieval
    qids, questions, answers = load_qa_pairs(
        test_path, draft=opts.draft, truecase=model.truecase)
    results = []
    for b0 in range(0, len(questions), r.eval_batch_size):
        chunk = questions[b0: b0 + r.eval_batch_size]
        qvec = model.query2vec(chunk)
        results.extend(model.mips.search(
            qvec, q_texts=chunk, top_k=r.psg_top_k, aggregate=True,
            agg_strat="opt2"))
    metrics = evaluate_passages(results, answers, regex=r.regex)
    out_dir = opts.data.save_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    to_fid_format(questions, answers, results, mark_phrase=True,
                  out_path=os.path.join(
                      out_dir, f"fid_{os.path.basename(test_path)}.json"))
    with open(os.path.join(out_dir, "eval_logger.txt"), "a") as f:
        f.write(f"{test_path}\tPSG\t" + "\t".join(
            f"{k}={v:.2f}" for k, v in metrics.items()) + "\n")
    return metrics


def evaluate_one(opts: Options, model, test_path: str):
    r = opts.retrieval
    if r.eval_psg:
        return evaluate_psg(opts, model, test_path)
    qids, questions, answers = load_qa_pairs(
        test_path, draft=opts.draft, truecase=model.truecase)
    candidates = None
    if r.candidate_path and os.path.exists(r.candidate_path):
        # answer-candidate vocabulary (WebQ eval, ref: --candidate_path)
        candidates = [line.strip() for line in open(r.candidate_path)
                      if line.strip()]
    metrics = evaluate_retrieval(
        model, list(zip(questions, answers)), top_k=r.top_k, regex=r.regex,
        batch_size=r.eval_batch_size, candidates=candidates)

    out_dir = opts.data.save_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    pred_path = os.path.join(
        out_dir, f"pred_{os.path.basename(test_path)}_{r.top_k}.json")
    with open(pred_path, "w") as f:
        json.dump({qid: {"question": q, "prediction": p, "answers": a}
                   for qid, q, p, a in zip(
                       qids, questions, metrics["predictions"], answers)}, f)
    # append-only results ledger (ref: train_rc.py:402-403)
    with open(os.path.join(out_dir, "eval_logger.txt"), "a") as f:
        f.write(f"{test_path}\tEM@1={metrics['em_top1']:.2f}\t"
                f"EM@{r.top_k}={metrics['em_topk']:.2f}\t"
                f"F1@1={metrics['f1_top1']:.2f}\n")
    logger.info("predictions → %s", pred_path)
    return metrics


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    opts = Options().parse(argv, groups=["model", "index", "retrieval", "data"])
    model = load_model(opts, device=device)
    # eval_all: comma-separated test paths loop (ref run_mode eval_all,
    # eval_phrase_retrieval.py:393-417)
    paths = [p for p in opts.retrieval.test_path.split(",") if p]
    all_metrics = {}
    for path in paths:
        all_metrics[path] = evaluate_one(opts, model, path)
    return all_metrics[paths[-1]] if len(paths) == 1 else all_metrics


if __name__ == "__main__":
    main()
