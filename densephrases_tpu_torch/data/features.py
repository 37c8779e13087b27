"""Context/question feature pipeline: striding windows with exact char offsets.

Host copy of ``densephrases_tpu/data/features.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Re-design of the reference's SQuAD-style machinery
(ref: densephrases/utils/squad_utils.py:96-433 window generation;
embed_utils.py:40-114 offset maps). The reference reconstructs character
offsets after the fact with alignment heuristics (``get_final_text_``,
ref: squad_metrics.py:354-371). Here offsets are tracked *forward* through
tokenization — every context token knows its source word and every word its
exact char span in the document string — so the store's word2char maps are
exact by construction and no fuzzy realignment exists anywhere.

Document text contract (must match the store/serve layer):
``context = ' '.join(words_para0) + ' [PAR] ' + ' '.join(words_para1) + ...``
(ref: embed_utils.py:86-105 [PAR] concatenation; index.py:167-176 window
re-adjustment at serve time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer

PAR_SEP = " [PAR] "


@dataclass
class DocContext:
    """Per-document offset bookkeeping shared by dump + serve."""

    doc_id: int
    title: str
    context: str  # whitespace-normalized, [PAR]-joined
    tok2word: np.ndarray  # int32 [n_tokens] token → word index
    word_char_start: np.ndarray  # int32 [n_words]
    word_char_end: np.ndarray  # int32 [n_words]

    @property
    def n_tokens(self) -> int:
        return len(self.tok2word)

    def token_char_span(self, tok: int) -> Tuple[int, int]:
        w = self.tok2word[tok]
        return int(self.word_char_start[w]), int(self.word_char_end[w])


@dataclass
class ContextFeatures:
    """One encoder window: [CLS] title [SEP] content... [SEP]."""

    doc_id: int
    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    content_start: int  # index in input_ids of the first content token
    content_len: int  # number of real content tokens in this window
    doc_token_offset: int  # doc-stream position of the first content token
    # RC training only:
    start_position: int = -1  # token index within input_ids, -1 if N/A
    end_position: int = -1
    unique_id: int = -1


@dataclass
class QuestionFeatures:
    qid: str
    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    question_text: str = ""


def whitespace_split(text: str) -> Tuple[List[str], List[int]]:
    """Split into words; return (words, char_to_word) where char_to_word maps
    every char of `text` to its word index (ref: squad_utils.py:1015-1111
    doc_tokens/char_to_word_offset construction)."""
    words: List[str] = []
    char_to_word: List[int] = []
    prev_is_ws = True
    for ch in text:
        if ch in " \t\r\n" or ord(ch) == 0x202F:
            prev_is_ws = True
            char_to_word.append(len(words) - 1)
        else:
            if prev_is_ws:
                words.append(ch)
            else:
                words[-1] += ch
            prev_is_ws = False
            char_to_word.append(len(words) - 1)
    return words, char_to_word


def build_doc_context(doc_id: int, title: str, paragraphs: List[str],
                      tokenizer: WordPieceTokenizer):
    """Tokenize a document, producing the DocContext and the flat token
    stream (token ids + per-paragraph boundaries)."""
    all_words: List[str] = []
    para_word_bounds: List[Tuple[int, int]] = []
    for para in paragraphs:
        words, _ = whitespace_split(para)
        para_word_bounds.append((len(all_words), len(all_words) + len(words)))
        all_words.extend(words)

    # Exact char spans in the [PAR]-joined context string.
    word_char_start = np.zeros(len(all_words), np.int32)
    word_char_end = np.zeros(len(all_words), np.int32)
    pos = 0
    pieces = []
    for pi, (w0, w1) in enumerate(para_word_bounds):
        if pi > 0:
            pieces.append(PAR_SEP)
            pos += len(PAR_SEP)
        for wi in range(w0, w1):
            if wi > w0:
                pieces.append(" ")
                pos += 1
            word_char_start[wi] = pos
            pos += len(all_words[wi])
            word_char_end[wi] = pos
            pieces.append(all_words[wi])
    context = "".join(pieces)

    token_ids: List[int] = []
    tok2word: List[int] = []
    para_tok_bounds: List[Tuple[int, int]] = []
    for (w0, w1) in para_word_bounds:
        t0 = len(token_ids)
        for wi in range(w0, w1):
            sub = tokenizer.tokenize_word(all_words[wi])
            ids = tokenizer.convert_tokens_to_ids(sub)
            token_ids.extend(ids)
            tok2word.extend([wi] * len(ids))
        para_tok_bounds.append((t0, len(token_ids)))

    doc_ctx = DocContext(
        doc_id=doc_id, title=title, context=context,
        tok2word=np.asarray(tok2word, np.int32),
        word_char_start=word_char_start, word_char_end=word_char_end,
    )
    return doc_ctx, np.asarray(token_ids, np.int32), para_tok_bounds


def convert_context_to_features(
    doc_id: int, title: str, paragraphs: List[str],
    tokenizer: WordPieceTokenizer, max_seq_length: int = 512,
    stride: Optional[int] = None, append_title: bool = True,
):
    """Build striding windows over a document for the phrase dump.

    Returns (features, doc_ctx). Default stride = full content width (no
    overlap) — the dump concatenates each window's content tokens into the
    doc stream, so overlap would duplicate vectors (the reference's
    stride-500-of-512 leaves a small overlap; we remove it by design).
    """
    doc_ctx, token_ids, _ = build_doc_context(doc_id, title, paragraphs, tokenizer)

    title_ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(title)) if append_title else []
    head = [tokenizer.cls_token_id] + title_ids + [tokenizer.sep_token_id] if append_title \
        else [tokenizer.cls_token_id]
    content_width = max_seq_length - len(head) - 1  # room for trailing [SEP]
    assert content_width > 0, "title too long for max_seq_length"
    step = content_width if stride is None else stride

    features = []
    offset = 0
    n = len(token_ids)
    while offset < n or (n == 0 and offset == 0):
        chunk = token_ids[offset: offset + content_width]
        ids = head + list(chunk) + [tokenizer.sep_token_id]
        pad = max_seq_length - len(ids)
        input_ids = np.asarray(ids + [tokenizer.pad_token_id] * pad, np.int32)
        attention_mask = np.asarray([1] * len(ids) + [0] * pad, np.int32)
        token_type_ids = np.zeros(max_seq_length, np.int32)
        features.append(ContextFeatures(
            doc_id=doc_id,
            input_ids=input_ids, attention_mask=attention_mask,
            token_type_ids=token_type_ids,
            content_start=len(head), content_len=len(chunk),
            doc_token_offset=offset,
        ))
        if offset + content_width >= n:
            break
        offset += step
    return features, doc_ctx


def convert_questions_to_features(
    questions: List[str], tokenizer: WordPieceTokenizer,
    max_query_length: int = 64, qids: Optional[List[str]] = None,
):
    """[CLS] question [SEP] features (ref: squad_utils.py:1621-1638).
    Uses the Rust batch tokenizer when available (queries need no offsets)."""
    out = []
    all_ids = tokenizer.encode_batch_ids(questions)
    for i, q in enumerate(questions):
        ids = all_ids[i]
        ids = [tokenizer.cls_token_id] + ids[: max_query_length - 2] + [tokenizer.sep_token_id]
        pad = max_query_length - len(ids)
        out.append(QuestionFeatures(
            qid=qids[i] if qids else str(i),
            input_ids=np.asarray(ids + [tokenizer.pad_token_id] * pad, np.int32),
            attention_mask=np.asarray([1] * len(ids) + [0] * pad, np.int32),
            token_type_ids=np.zeros(max_query_length, np.int32),
            question_text=q,
        ))
    return out


def batch_features(features, keys=("input_ids", "attention_mask", "token_type_ids")):
    """Stack a list of features into arrays."""
    return {k: np.stack([getattr(f, k) for f in features]) for k in keys}


def align_answer_to_window(
    doc_ctx: DocContext, feature: ContextFeatures, char_start: int, char_end: int,
):
    """Map an answer char span → (start_token, end_token) within the window's
    input_ids, or (-1, -1) if not fully inside this window
    (ref answer alignment: squad_utils.py:176-185,326-362).
    """
    # word indices containing the span
    ws = np.searchsorted(doc_ctx.word_char_end, char_start, side="right")
    we = np.searchsorted(doc_ctx.word_char_start, char_end, side="right") - 1
    if ws >= len(doc_ctx.word_char_start) or we < ws:
        return -1, -1
    # token range of those words
    toks = np.nonzero((doc_ctx.tok2word >= ws) & (doc_ctx.tok2word <= we))[0]
    if len(toks) == 0:
        return -1, -1
    t0, t1 = int(toks[0]), int(toks[-1])
    w_lo = feature.doc_token_offset
    w_hi = w_lo + feature.content_len
    if t0 < w_lo or t1 >= w_hi:
        return -1, -1
    return (t0 - w_lo + feature.content_start,
            t1 - w_lo + feature.content_start)
