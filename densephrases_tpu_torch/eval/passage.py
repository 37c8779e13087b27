"""Passage-level retrieval evaluation: top-k recall + FiD export.

Host copy of ``densephrases_tpu/eval/passage.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with ref: eval_phrase_retrieval.py:304-371 evaluate_results_psg
(phrase→passage aggregation, FiD-format ctxs with phrase markers) and
scripts/postprocess/recall.py:39-88 (DPR-style has-answer recall with
string/regex matching)."""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

import numpy as np

from densephrases_tpu_torch.eval.metrics import (
    drqa_exact_match_score,
    drqa_regex_match_score,
    normalize_answer,
)

logger = logging.getLogger(__name__)


def has_answer(text: str, answers: List[str], regex: bool = False) -> bool:
    """DPR-style has-answer: any gold answer appears (normalized substring /
    regex) in the passage (ref: recall.py:39-88)."""
    if regex:
        import re

        for a in answers:
            try:
                if re.search(a, text, flags=re.IGNORECASE | re.UNICODE):
                    return True
            except re.error:
                continue
        return False
    norm_text = normalize_answer(text)
    return any(normalize_answer(a) in norm_text for a in answers)


def evaluate_passages(results: List[List[dict]], answers: List[List[str]],
                      ks=(1, 5, 20, 100), regex: bool = False) -> Dict[str, float]:
    """Top-k passage recall: fraction of questions whose top-k retrieved
    passages contain an answer."""
    out = {}
    for k in ks:
        hits = [
            float(any(has_answer(r["context"], golds, regex)
                      for r in ret[:k]))
            for ret, golds in zip(results, answers)
        ]
        out[f"recall@{k}"] = 100.0 * float(np.mean(hits)) if hits else 0.0
    logger.info("passage recall: %s",
                {k: round(v, 2) for k, v in out.items()})
    return out


def to_fid_format(questions: List[str], answers: List[List[str]],
                  results: List[List[dict]], mark_phrase: bool = False,
                  out_path: Optional[str] = None) -> List[dict]:
    """Export retrieved passages as FiD reader input
    (ref: eval_phrase_retrieval.py:340-365, phrase markers :348-352)."""
    rows = []
    for q, golds, ret in zip(questions, answers, results):
        ctxs = []
        for r in ret:
            text = r["context"]
            if mark_phrase:
                s, e = r.get("start_pos", 0), r.get("end_pos", 0)
                text = text[:s] + "<e>" + text[s:e] + "</e>" + text[e:]
            ctxs.append({"title": r["title"][0] if r.get("title") else "",
                         "text": text, "score": r.get("score", 0.0)})
        rows.append({"question": q, "answers": golds, "ctxs": ctxs})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f)
    return rows
