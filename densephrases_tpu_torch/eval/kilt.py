"""KILT benchmark metrics and evaluation.

Host copy of ``densephrases_tpu/eval/kilt.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Re-implementation of the official KILT metric suite vendored by the
reference (ref: densephrases/utils/kilt/eval.py:21-130 answer metrics,
:132-246 retrieval metrics; kilt_utils.py): EM / F1 / ROUGE-L accuracy
("downstream" metrics), R-precision and recall@k over provenance
(wikipedia ids), and the KILT-* variants that award downstream credit only
when the top-R provenance is correct.

Input format: each prediction is {'answer': str, 'provenance': [wikipedia_id]}
and each gold item is {'answers': [str], 'provenance': [[wikipedia_id, ...]]}
(multiple gold provenance sets = any counts).
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Dict, List

import numpy as np

from densephrases_tpu_torch.eval.metrics import exact_match_score, f1_score, normalize_answer

logger = logging.getLogger(__name__)


def _rouge_l(prediction: str, ground_truth: str) -> float:
    """ROUGE-L F1 on normalized tokens (ref: kilt eval.py rougel)."""
    a = normalize_answer(prediction).split()
    b = normalize_answer(ground_truth).split()
    if not a or not b:
        return 0.0
    # LCS via DP
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i in range(len(a)):
        for j in range(len(b)):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if a[i] == b[j]
                                else max(dp[i, j + 1], dp[i + 1, j]))
    lcs = int(dp[-1, -1])
    if lcs == 0:
        return 0.0
    p = lcs / len(a)
    r = lcs / len(b)
    return 2 * p * r / (p + r)


def _max_over_golds(fn, pred: str, golds: List[str]) -> float:
    return max((fn(pred, g) for g in golds), default=0.0)


def rprecision(pred_prov: List[str], gold_prov_sets: List[List[str]]) -> float:
    """R-precision: of the first R predicted provenance ids, the fraction in
    the gold set, maximized over gold sets (ref: kilt eval.py retrieval)."""
    best = 0.0
    for gold in gold_prov_sets:
        r = len(set(gold))
        if r == 0:
            continue
        top_r = pred_prov[:r]
        hit = len(set(top_r) & set(gold))
        best = max(best, hit / r)
    return best


def recall_at_k(pred_prov: List[str], gold_prov_sets: List[List[str]],
                k: int = 5) -> float:
    best = 0.0
    for gold in gold_prov_sets:
        if not gold:
            continue
        hit = len(set(pred_prov[:k]) & set(gold)) / len(set(gold))
        best = max(best, hit)
    return best


def evaluate_kilt(predictions: List[dict], golds: List[dict],
                  k: int = 5) -> Dict[str, float]:
    """Compute the full KILT metric table."""
    assert len(predictions) == len(golds)
    n = max(len(predictions), 1)
    em = f1 = rl = rp = rec = kem = kf1 = krl = 0.0
    for pred, gold in zip(predictions, golds):
        answers = gold.get("answers", [])
        p_ans = pred.get("answer", "")
        em_i = float(_max_over_golds(
            lambda a, b: float(exact_match_score(a, b)), p_ans, answers))
        f1_i = _max_over_golds(lambda a, b: f1_score(a, b)[0], p_ans, answers)
        rl_i = _max_over_golds(_rouge_l, p_ans, answers)
        rp_i = rprecision(pred.get("provenance", []),
                          gold.get("provenance", []))
        rec_i = recall_at_k(pred.get("provenance", []),
                            gold.get("provenance", []), k=k)
        em += em_i
        f1 += f1_i
        rl += rl_i
        rp += rp_i
        rec += rec_i
        # KILT-scores: downstream credit only when R-precision == 1
        if rp_i == 1.0:
            kem += em_i
            kf1 += f1_i
            krl += rl_i
    out = {
        "em": 100 * em / n, "f1": 100 * f1 / n, "rougel": 100 * rl / n,
        "rprec": 100 * rp / n, f"recall@{k}": 100 * rec / n,
        "kilt_em": 100 * kem / n, "kilt_f1": 100 * kf1 / n,
        "kilt_rougel": 100 * krl / n, "n": n,
    }
    logger.info("KILT: EM %.2f | R-Prec %.2f | KILT-EM %.2f",
                out["em"], out["rprec"], out["kilt_em"])
    return out


def results_to_kilt_predictions(results: List[List[dict]],
                                title2wikiid: Dict[str, str]) -> List[dict]:
    """Convert MIPS search results → KILT prediction rows
    (title→wikipedia_id mapping, ref: eval_phrase_retrieval.py:218-220)."""
    preds = []
    for ret in results:
        prov = []
        for r in ret:
            for title in r.get("title", []):
                wid = title2wikiid.get(title)
                if wid is not None and wid not in prov:
                    prov.append(wid)
        preds.append({
            "answer": ret[0]["answer"] if ret else "",
            "provenance": prov,
        })
    return preds


def load_kilt_data(path: str):
    """Read official KILT jsonl → (queries, golds)."""
    import json

    queries, golds = [], []
    for line in open(path):
        if not line.strip():
            continue
        row = json.loads(line)
        queries.append(row["input"])
        answers, prov_sets = [], []
        for out in row.get("output", []):
            if out.get("answer"):
                answers.append(out["answer"])
            prov = [str(p.get("wikipedia_id"))
                    for p in out.get("provenance", []) if p.get("wikipedia_id")]
            if prov:
                prov_sets.append(prov)
        golds.append({"answers": answers, "provenance": prov_sets})
    return queries, golds
