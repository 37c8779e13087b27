"""RC training batches: SQuAD-style examples → model-ready arrays.

Host copy of ``densephrases_tpu/data/rc_dataset.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

The collation side of the reference's features pipeline
(ref: squad_utils.py:96-433 squad_convert_example_to_features +
TensorDataset assembly :556-630): each example becomes ONE training row —
the stride window containing the answer span — with
(passage ids, query ids, start/end token positions). Unanswerable examples
get position 0 ([CLS]) like the reference's impossible-span convention.

Optionally emits the merged cross-encoder inputs + teacher_gather map used
for distillation (ref: encoder.py:65-90 merge_inputs, done here at data time
instead of inside the model so the train step stays static-shaped).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from densephrases_tpu_torch.data.features import (
    align_answer_to_window,
    convert_context_to_features,
    convert_questions_to_features,
)
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer


@dataclass
class RCFeature:
    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    query_input_ids: np.ndarray
    query_attention_mask: np.ndarray
    query_token_type_ids: np.ndarray
    start_position: int
    end_position: int
    qid: str = ""
    # distillation extras
    cross_input_ids: Optional[np.ndarray] = None
    cross_attention_mask: Optional[np.ndarray] = None
    cross_token_type_ids: Optional[np.ndarray] = None
    teacher_gather: Optional[np.ndarray] = None


def convert_rc_examples(
    examples: List[dict],
    tokenizer: WordPieceTokenizer,
    max_seq_length: int = 384,
    doc_stride: int = 128,
    max_query_length: int = 64,
    append_title: bool = True,
    with_teacher: bool = False,
    max_cross_length: Optional[int] = None,
) -> List[RCFeature]:
    """examples: rows from data/qa.load_rc_examples."""
    feats: List[RCFeature] = []
    qfeats = convert_questions_to_features(
        [e["question"] for e in examples], tokenizer, max_query_length,
        qids=[e["qid"] for e in examples])

    for ex, qf in zip(examples, qfeats):
        windows, doc_ctx = convert_context_to_features(
            0, ex["title"] if append_title else "", [ex["context"]],
            tokenizer, max_seq_length=max_seq_length, stride=doc_stride,
            append_title=append_title)

        # answer char span in the normalized context string: the raw
        # answer_start indexes ex['context']; our doc string is
        # whitespace-normalized, so re-locate by word index.
        if ex["answer_start"] >= 0 and ex["answer_text"]:
            from densephrases_tpu_torch.data.features import whitespace_split
            _, char_to_word = whitespace_split(ex["context"])
            cs_word = char_to_word[min(ex["answer_start"],
                                       len(char_to_word) - 1)]
            ce_word = char_to_word[min(
                ex["answer_start"] + len(ex["answer_text"]) - 1,
                len(char_to_word) - 1)]
            char_start = int(doc_ctx.word_char_start[max(cs_word, 0)])
            char_end = int(doc_ctx.word_char_end[min(
                max(ce_word, 0), len(doc_ctx.word_char_end) - 1)])
        else:
            char_start = char_end = -1

        chosen, s_pos, e_pos = None, 0, 0
        for w in windows:
            if char_start >= 0:
                s, e = align_answer_to_window(doc_ctx, w, char_start, char_end)
                if s >= 0:
                    chosen, s_pos, e_pos = w, s, e
                    break
        if chosen is None:
            chosen = windows[0]  # unanswerable (or answer out of window)
            s_pos = e_pos = 0  # [CLS] convention

        f = RCFeature(
            input_ids=chosen.input_ids,
            attention_mask=chosen.attention_mask,
            token_type_ids=chosen.token_type_ids,
            query_input_ids=qf.input_ids,
            query_attention_mask=qf.attention_mask,
            query_token_type_ids=qf.token_type_ids,
            start_position=s_pos, end_position=e_pos, qid=ex["qid"],
        )
        if with_teacher:
            _add_cross_inputs(f, tokenizer, max_cross_length
                              or (max_seq_length + max_query_length))
        feats.append(f)
    return feats


def _add_cross_inputs(f: RCFeature, tok: WordPieceTokenizer, max_len: int):
    """Merged query+passage cross-encoder inputs + the teacher_gather map
    aligning teacher positions back to passage token positions
    (ref: encoder.py:65-90,294-303 — precomputed here)."""
    q_len = int(f.query_attention_mask.sum())
    p_len = int(f.attention_mask.sum())
    p_ids = f.input_ids[:p_len]
    # first SEP separates the title (ref: merge_inputs title_sep logic)
    sep_positions = np.nonzero(p_ids == tok.sep_token_id)[0]
    title_sep = int(sep_positions[0]) if len(sep_positions) else 0
    content = p_ids[title_sep + 1: p_len]  # content tokens + final [SEP]

    merged = np.concatenate([f.query_input_ids[:q_len], content])[:max_len]
    cross_ids = np.full(max_len, tok.pad_token_id, np.int32)
    cross_ids[:len(merged)] = merged
    cross_mask = (cross_ids != tok.pad_token_id).astype(np.int32)
    cross_types = np.zeros(max_len, np.int32)
    cross_types[q_len: len(merged)] = 1

    # teacher_gather[i] = cross position whose logit supervises passage
    # position i; -1 → masked (title region + padding)
    gather = np.full(len(f.input_ids), -1, np.int32)
    gather[0] = 0  # [CLS] ← cross [CLS]
    n_content = p_len - (title_sep + 1)
    for j in range(n_content):
        p_pos = title_sep + 1 + j
        c_pos = q_len + j
        if c_pos < max_len and p_pos < len(gather):
            gather[p_pos] = c_pos

    f.cross_input_ids = cross_ids
    f.cross_attention_mask = cross_mask
    f.cross_token_type_ids = cross_types
    f.teacher_gather = gather


def batches(feats: List[RCFeature], batch_size: int, shuffle: bool = True,
            seed: int = 0, drop_last: bool = True,
            skip_steps: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked batches. `skip_steps` fast-forwards for resume
    (ref: train_rc.py:147-189 step-skipping)."""
    order = np.arange(len(feats))
    if shuffle:
        order = np.random.default_rng(seed).permutation(order)
    keys = ["input_ids", "attention_mask", "token_type_ids",
            "query_input_ids", "query_attention_mask", "query_token_type_ids"]
    has_teacher = feats and feats[0].cross_input_ids is not None
    step = 0
    for b0 in range(0, len(order), batch_size):
        idx = order[b0: b0 + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        if step < skip_steps:
            step += 1
            continue
        step += 1
        chunk = [feats[i] for i in idx]
        batch = {k: np.stack([getattr(f, k) for f in chunk]) for k in keys}
        batch["start_positions"] = np.asarray(
            [f.start_position for f in chunk], np.int32)
        batch["end_positions"] = np.asarray(
            [f.end_position for f in chunk], np.int32)
        if has_teacher:
            batch["cross_input_ids"] = np.stack([f.cross_input_ids for f in chunk])
            batch["cross_attention_mask"] = np.stack(
                [f.cross_attention_mask for f in chunk])
            batch["cross_token_type_ids"] = np.stack(
                [f.cross_token_type_ids for f in chunk])
            batch["teacher_gather"] = np.stack([f.teacher_gather for f in chunk])
        yield batch
