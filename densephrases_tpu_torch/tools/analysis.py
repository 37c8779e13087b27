"""Prediction analysis: error breakdown vs gold answers.

Host copy of ``densephrases_tpu/tools/analysis.py``: the port never
imports the JAX package, whose ``__init__`` imports jax. Keep the two
in step.

Parity with ref: scripts/analysis/run_analysis.py (493 LoC qualitative /
error analysis of prediction json) and run_analysis_dpr.py (comparison
against another system's predictions).
"""

from __future__ import annotations

import json
import logging
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from densephrases_tpu_torch.eval.metrics import (
    drqa_exact_match_score,
    drqa_metric_max_over_ground_truths,
    f1_score,
    normalize_answer,
)

logger = logging.getLogger(__name__)


def analyze_predictions(pred_path: str, top_k: int = 10) -> Dict[str, object]:
    """pred json rows: {qid: {'question', 'prediction': [str], 'answers'}}
    (the eval driver's output format). Returns an error-analysis report."""
    data = json.load(open(pred_path))
    n = len(data)
    em1 = emk = 0
    f1_sum = 0.0
    rank_hist = Counter()
    wrong_samples = []
    pred_lengths = []
    for qid, row in data.items():
        preds = row.get("prediction", [])[:top_k]
        golds = row.get("answers", [])
        if not preds or not golds:
            continue
        ems = [drqa_metric_max_over_ground_truths(
            drqa_exact_match_score, p, golds) for p in preds]
        pred_lengths.append(len(preds[0].split()))
        if ems[0]:
            em1 += 1
            rank_hist[0] += 1
        else:
            if any(ems):
                rank_hist[int(np.argmax(ems))] += 1
            else:
                rank_hist[-1] += 1
            if len(wrong_samples) < 20:
                wrong_samples.append({
                    "question": row.get("question", qid),
                    "prediction": preds[0], "answers": golds})
        emk += int(any(ems))
        f1_sum += max(f1_score(preds[0], g)[0] for g in golds)

    report = {
        "n": n,
        "em_top1": 100.0 * em1 / max(n, 1),
        "em_topk": 100.0 * emk / max(n, 1),
        "f1_top1": 100.0 * f1_sum / max(n, 1),
        "first_hit_rank_histogram": dict(sorted(rank_hist.items())),
        "mean_pred_words": float(np.mean(pred_lengths)) if pred_lengths else 0,
        "wrong_samples": wrong_samples,
    }
    logger.info("analysis: EM@1 %.2f EM@k %.2f", report["em_top1"],
                report["em_topk"])
    return report


def compare_predictions(pred_path_a: str, pred_path_b: str) -> Dict[str, object]:
    """A-vs-B win/loss breakdown (ref: run_analysis_dpr.py)."""
    a = json.load(open(pred_path_a))
    b = json.load(open(pred_path_b))
    both = wins_a = wins_b = neither = 0
    examples = {"a_only": [], "b_only": []}
    for qid in set(a) & set(b):
        golds = a[qid].get("answers", [])
        pa = a[qid].get("prediction", [""])[0]
        pb = b[qid].get("prediction", [""])[0]
        hit_a = drqa_metric_max_over_ground_truths(
            drqa_exact_match_score, pa, golds) if golds else False
        hit_b = drqa_metric_max_over_ground_truths(
            drqa_exact_match_score, pb, golds) if golds else False
        if hit_a and hit_b:
            both += 1
        elif hit_a:
            wins_a += 1
            if len(examples["a_only"]) < 10:
                examples["a_only"].append(
                    {"question": a[qid].get("question", qid),
                     "a": pa, "b": pb, "answers": golds})
        elif hit_b:
            wins_b += 1
            if len(examples["b_only"]) < 10:
                examples["b_only"].append(
                    {"question": a[qid].get("question", qid),
                     "a": pa, "b": pb, "answers": golds})
        else:
            neither += 1
    return {"both": both, "a_only": wins_a, "b_only": wins_b,
            "neither": neither, "examples": examples}
