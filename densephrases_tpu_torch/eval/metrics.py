"""Answer-string metrics: SQuAD / DrQA normalization, EM, F1, regex match.

Host copy of ``densephrases_tpu/eval/metrics.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Behavior parity with ref: densephrases/utils/eval_utils.py:9-86 — these exact
semantics (articles/punct stripping, whitespace fix, token-level F1,
regex match with re.UNICODE|IGNORECASE|MULTILINE compilation) are what the
published EM/F1 numbers are measured with, so they are reproduced faithfully.
"""

from __future__ import annotations

import re
import string
import unicodedata
from collections import Counter


def normalize_answer(s: str) -> str:
    def remove_articles(text):
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text):
        return " ".join(text.split())

    def remove_punc(text):
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    def lower(text):
        return text.lower()

    return white_space_fix(remove_articles(remove_punc(lower(s))))


def f1_score(prediction: str, ground_truth: str):
    normalized_prediction = normalize_answer(prediction)
    normalized_ground_truth = normalize_answer(ground_truth)

    ZERO_METRIC = (0, 0, 0)

    # yes/no/noanswer answers score 0 unless they match exactly — token
    # overlap between e.g. "no" and "no answer found" must not earn F1
    # (ref: eval_utils.py:31-36)
    if (normalized_prediction in ["yes", "no", "noanswer"]
            and normalized_prediction != normalized_ground_truth):
        return ZERO_METRIC
    if (normalized_ground_truth in ["yes", "no", "noanswer"]
            and normalized_prediction != normalized_ground_truth):
        return ZERO_METRIC

    prediction_tokens = normalized_prediction.split()
    ground_truth_tokens = normalized_ground_truth.split()
    common = Counter(prediction_tokens) & Counter(ground_truth_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return ZERO_METRIC
    precision = 1.0 * num_same / len(prediction_tokens)
    recall = 1.0 * num_same / len(ground_truth_tokens)
    f1 = (2 * precision * recall) / (precision + recall)
    return f1, precision, recall


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def regex_match_score(prediction: str, pattern: str) -> bool:
    """Match prediction against a gold regex (ref: eval_utils.py:64-75)."""
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE + re.UNICODE + re.MULTILINE)
    except re.error:
        return False
    return compiled.match(prediction) is not None


# DrQA-style variants used by open-domain eval (ref: eval_utils.py:50-86).
def drqa_normalize(text: str) -> str:
    """Resolve different types of unicode encodings (ref: eval_utils.py:54-56
    — NFD, NOT answer normalization; the published numbers depend on it)."""
    return unicodedata.normalize("NFD", text)


def drqa_exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def drqa_regex_match_score(prediction: str, pattern: str) -> bool:
    return regex_match_score(prediction, pattern)


def drqa_metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    scores = []
    for gt in ground_truths:
        res = metric_fn(prediction, gt)
        scores.append(res[0] if isinstance(res, tuple) else res)
    return max(scores)
