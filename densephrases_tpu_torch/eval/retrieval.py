"""Open-domain retrieval evaluation: EM/F1 @1/@k.

Host copy of ``densephrases_tpu/eval/retrieval.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with ref: eval_phrase_retrieval.py:94-211 (top1/topk EM+F1,
redundancy stat, per-question predictions).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from densephrases_tpu_torch.eval.metrics import (
    drqa_exact_match_score,
    drqa_metric_max_over_ground_truths,
    drqa_regex_match_score,
    f1_score,
)

logger = logging.getLogger(__name__)


def evaluate_predictions(predictions: List[List[str]], answers: List[List[str]],
                         regex: bool = False):
    """predictions: per-question ranked answer strings; answers: gold sets."""
    match_fn = drqa_regex_match_score if regex else drqa_exact_match_score
    n = len(predictions)
    em_top1 = np.zeros(n)
    em_topk = np.zeros(n)
    f1_top1 = np.zeros(n)
    f1_topk = np.zeros(n)
    for i, (preds, golds) in enumerate(zip(predictions, answers)):
        if not preds or not golds:
            continue
        ems = [
            float(drqa_metric_max_over_ground_truths(match_fn, p, golds))
            for p in preds
        ]
        em_top1[i] = ems[0]
        em_topk[i] = max(ems)
        if not regex:
            f1s = [
                max(f1_score(p, g)[0] for g in golds) for p in preds
            ]
            f1_top1[i] = f1s[0]
            f1_topk[i] = max(f1s)
        else:
            f1_top1[i] = em_top1[i]
            f1_topk[i] = em_topk[i]
    return {
        "em_top1": float(em_top1.mean()) * 100,
        "em_topk": float(em_topk.mean()) * 100,
        "f1_top1": float(f1_top1.mean()) * 100,
        "f1_topk": float(f1_topk.mean()) * 100,
        "n": n,
    }


def evaluate_retrieval(model, qa_pairs: List[Tuple[str, List[str]]],
                       top_k: int = 10, regex: bool = False,
                       max_answer_length: int = 10, batch_size: int = 64,
                       candidates: List[str] = None):
    """candidates: optional answer-candidate vocabulary — predictions are
    restricted to strings whose normalization appears in it (WebQ candidate
    eval, ref: --candidate_path open_utils.py/eval flow)."""
    from densephrases_tpu_torch.eval.metrics import normalize_answer

    cand_set = ({normalize_answer(c) for c in candidates}
                if candidates else None)
    questions = [q for q, _ in qa_pairs]
    answers = [a for _, a in qa_pairs]
    predictions = []
    for b0 in range(0, len(questions), batch_size):
        chunk = questions[b0: b0 + batch_size]
        # over-retrieve when filtering to candidates
        k = top_k * 4 if cand_set else top_k
        preds = model.search(chunk, retrieval_unit="phrase", top_k=k,
                             max_answer_length=max_answer_length)
        if cand_set:
            preds = [
                ([p for p in ps if normalize_answer(p) in cand_set]
                 or ps)[:top_k]
                for ps in preds
            ]
        predictions.extend(preds)
    metrics = evaluate_predictions(predictions, answers, regex=regex)
    metrics["predictions"] = predictions
    logger.info("EM@1 %.2f | EM@%d %.2f | F1@1 %.2f | F1@%d %.2f",
                metrics["em_top1"], top_k, metrics["em_topk"],
                metrics["f1_top1"], top_k, metrics["f1_topk"])
    return metrics
