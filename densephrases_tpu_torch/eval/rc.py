"""Reading-comprehension prediction decoding + evaluation.

The counterpart of ``densephrases_tpu/eval/rc.py``: ``decode_spans`` is a
host copy (keep the two in step); ``evaluate_rc`` and ``filter_test`` run
the port's phrase forward (``dump._phrase_forward``) and query towers
(``embed_query``) on the params' device.

Replaces ref: densephrases/utils/squad_metrics.py:408-686
``compute_predictions_logits``: n-best span extraction from start/end logits
with filter-threshold pruning (ref: :515-519) and text projection. Because
our pipeline tracks exact char offsets forward (data/features.py), the
token→text projection is a direct table lookup — none of the reference's
``get_final_text`` alignment heuristics (ref: :256-351) are needed.

``evaluate_rc`` runs the whole RC dev loop (ref: train_rc.py:307-407):
batched phrase+query forward, span decoding over all windows of each
example, SQuAD EM/F1.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densephrases_tpu_torch.data.features import (
    ContextFeatures,
    DocContext,
    convert_context_to_features,
    convert_questions_to_features,
)
from densephrases_tpu_torch.eval.metrics import exact_match_score, f1_score

logger = logging.getLogger(__name__)


def decode_spans(
    start_logits: np.ndarray,  # [L]
    end_logits: np.ndarray,  # [L]
    feature: ContextFeatures,
    doc_ctx: DocContext,
    n_best: int = 10,
    max_answer_length: int = 10,
    filter_start: Optional[np.ndarray] = None,
    filter_end: Optional[np.ndarray] = None,
    filter_threshold: float = -1e8,
) -> List[dict]:
    """N-best spans for one window. Returns dicts with text + score."""
    c0 = feature.content_start
    c1 = c0 + feature.content_len
    if feature.content_len <= 0:
        return []
    s_log = start_logits[c0:c1].copy()
    e_log = end_logits[c0:c1].copy()
    if filter_start is not None and filter_threshold > -1e7:
        # filter-pruned candidates (ref: squad_metrics.py:515-519)
        s_log = np.where(filter_start[c0:c1] > filter_threshold, s_log, -1e8)
        e_log = np.where(filter_end[c0:c1] > filter_threshold, e_log, -1e8)

    k = min(n_best, len(s_log))
    s_top = np.argsort(-s_log)[:k]
    e_top = np.argsort(-e_log)[:k]
    cands: List[Tuple[float, int, int]] = []
    for si in s_top:
        for ei in e_top:
            if ei < si or ei - si + 1 > max_answer_length:
                continue
            cands.append((float(s_log[si] + e_log[ei]), int(si), int(ei)))
    cands.sort(key=lambda x: -x[0])

    out = []
    off = feature.doc_token_offset
    for score, si, ei in cands[:n_best]:
        t0, _ = doc_ctx.token_char_span(off + si)
        _, t1 = doc_ctx.token_char_span(off + ei)
        out.append({
            "text": doc_ctx.context[t0:t1], "score": score,
            "start_pos": t0, "end_pos": t1,
        })
    return out


def evaluate_rc(params, config, tokenizer, examples: List[dict],
                max_seq_length: int = 384, doc_stride: int = 128,
                max_query_length: int = 64, max_answer_length: int = 10,
                batch_size: int = 16, filter_threshold: float = -1e8,
                attn_impl: str = "auto") -> Dict[str, float]:
    """Full RC eval: per-question best span over all windows → EM/F1.

    examples: rows from data/qa.load_rc_examples (dev set with answers)."""
    from densephrases_tpu_torch.dump import _phrase_forward
    from densephrases_tpu_torch.models.encoder import embed_query

    # window features per example
    all_windows: List[ContextFeatures] = []
    window_owner: List[int] = []
    doc_ctxs: List[DocContext] = []
    for i, ex in enumerate(examples):
        ws, ctx = convert_context_to_features(
            i, ex["title"], [ex["context"]], tokenizer,
            max_seq_length=max_seq_length, stride=doc_stride)
        doc_ctxs.append(ctx)
        for w in ws:
            all_windows.append(w)
            window_owner.append(i)

    qfeats = convert_questions_to_features(
        [e["question"] for e in examples], tokenizer, max_query_length)

    # query reps
    q_start = np.zeros((len(examples), config.hidden_size), np.float32)
    q_end = np.zeros((len(examples), config.hidden_size), np.float32)
    for b0 in range(0, len(qfeats), batch_size):
        chunk = qfeats[b0:b0 + batch_size]
        qs, qe = embed_query(
            params, *(torch.as_tensor(np.stack([getattr(f, k) for f in chunk]),
                                      device=params.device)
                      for k in ("input_ids", "attention_mask",
                                "token_type_ids")),
            attn_impl=attn_impl)
        q_start[b0:b0 + len(chunk)] = qs.cpu().numpy()
        q_end[b0:b0 + len(chunk)] = qe.cpu().numpy()

    # phrase reps per window → logits vs the owning question
    best: Dict[int, dict] = {}
    for b0 in range(0, len(all_windows), batch_size):
        chunk = all_windows[b0:b0 + batch_size]
        owners = window_owner[b0:b0 + batch_size]
        start, f_s, f_e = _phrase_forward(
            params, *(np.stack([getattr(f, k) for f in chunk])
                      for k in ("input_ids", "attention_mask",
                                "token_type_ids")), attn_impl=attn_impl)
        for j, (w, owner) in enumerate(zip(chunk, owners)):
            s_logits = start[j] @ q_start[owner]
            e_logits = start[j] @ q_end[owner]
            spans = decode_spans(
                s_logits, e_logits, w, doc_ctxs[owner],
                max_answer_length=max_answer_length,
                filter_start=f_s[j], filter_end=f_e[j],
                filter_threshold=filter_threshold)
            if spans and (owner not in best
                          or spans[0]["score"] > best[owner]["score"]):
                best[owner] = spans[0]

    em, f1 = [], []
    for i, ex in enumerate(examples):
        pred = best.get(i, {}).get("text", "")
        gold = ex["answer_text"]
        if not gold:
            continue
        em.append(float(exact_match_score(pred, gold)))
        f1.append(f1_score(pred, gold)[0])
    result = {
        "exact_match": 100.0 * float(np.mean(em)) if em else 0.0,
        "f1": 100.0 * float(np.mean(f1)) if f1 else 0.0,
        "n": len(em),
    }
    logger.info("RC eval: EM %.2f F1 %.2f (n=%d)",
                result["exact_match"], result["f1"], result["n"])
    return result


def filter_test(params, config, tokenizer, examples: List[dict],
                thresholds=(-4.0, -3.0, -2.0, -1.0, 0.0, 1.0, 2.0),
                **eval_kw) -> Dict[float, dict]:
    """Threshold sweep: EM/F1 + vector keep-rate per threshold
    (ref: train_rc.py:410-431, Makefile:233-244)."""
    from densephrases_tpu_torch.dump import _phrase_forward

    out = {}
    for th in thresholds:
        metrics = evaluate_rc(params, config, tokenizer, examples,
                              filter_threshold=th, **eval_kw)
        # keep-rate on a sample of windows
        sample = examples[:16]
        ws = []
        for i, ex in enumerate(sample):
            w, _ = convert_context_to_features(
                i, ex["title"], [ex["context"]], tokenizer,
                max_seq_length=eval_kw.get("max_seq_length", 384))
            ws.extend(w)
        _, f_s, f_e = _phrase_forward(
            params, *(np.stack([getattr(f, k) for f in ws])
                      for k in ("input_ids", "attention_mask",
                                "token_type_ids")),
            attn_impl=eval_kw.get("attn_impl", "auto"))
        mask = np.stack([f.attention_mask for f in ws]) > 0
        keep = ((f_s > th) | (f_e > th)) & mask
        metrics["keep_rate"] = float(keep.sum() / mask.sum())
        out[th] = metrics
        logger.info("filter_test th=%.1f: EM %.2f keep %.3f",
                    th, metrics["exact_match"], metrics["keep_rate"])
    return out
