"""Streaming RC dataset: on-the-fly tokenization + hard negatives.

Copy of ``densephrases_tpu/data/lazy.py`` over the port's tokenizer and
``data/rc_dataset.convert_rc_examples``: the port never imports the
JAX package. Keep the two in step. It yields numpy batches; the
caller moves them to the device (``train.rc.make_train_step`` takes
device tensors).

Parity with ref: squad_utils.py:1353-1449 ``LazyDataset`` — for corpora too
large to pre-tokenize (PAQ-scale), examples are tokenized lazily per batch,
optionally pairing each question with a hard-negative passage drawn from a
DPR-style TSV passage pool. Also covers the rank-sharded QA-only jsonl
reader (ref: squad_utils.py:952-1003 _create_examples_qa_only).
"""

from __future__ import annotations

import csv
import json
import logging
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from densephrases_tpu_torch.data.rc_dataset import convert_rc_examples
from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer

logger = logging.getLogger(__name__)


def read_qa_jsonl(path: str, rank: int = 0, world_size: int = 1,
                  skip: int = 0) -> Iterator[dict]:
    """Rank-modulo sharded QA-only jsonl reader (ref: squad_utils.py:960-962
    idx % world_size == rank sharding; `skip` for resume)."""
    with open(path) as f:
        for i, line in enumerate(f):
            if i % world_size != rank or not line.strip():
                continue
            if skip > 0:
                skip -= 1
                continue
            row = json.loads(line)
            yield {
                "qid": str(row.get("id", i)),
                "question": row.get("question", row.get("input", "")),
                "title": row.get("title", ""),
                "context": row.get("context", row.get("passage", "")),
                "answer_text": (row.get("answers") or [""])[0]
                if isinstance(row.get("answers"), list) else row.get("answer", ""),
                "answer_start": row.get("answer_start", -1),
            }


class PassagePool:
    """DPR-style TSV passage pool (id \\t text \\t title) for hard negatives
    (ref: LazyDataset DPR tsv passages, squad_utils.py:1386-1420)."""

    def __init__(self, tsv_path: str, max_rows: Optional[int] = None):
        self.texts: List[str] = []
        self.titles: List[str] = []
        with open(tsv_path) as f:
            reader = csv.reader(f, delimiter="\t")
            for i, row in enumerate(reader):
                if max_rows and i >= max_rows:
                    break
                if len(row) >= 2 and row[0] != "id":
                    self.texts.append(row[1])
                    self.titles.append(row[2] if len(row) > 2 else "")

    def __len__(self):
        return len(self.texts)

    def sample(self, rng: random.Random, n: int = 1):
        idx = [rng.randrange(len(self.texts)) for _ in range(n)]
        return [(self.titles[i], self.texts[i]) for i in idx]


class LazyRCDataset:
    """Iterate model-ready RC batches with per-batch tokenization.

    Host memory stays O(batch); suitable for million-example QA files.
    """

    def __init__(self, example_iter, tokenizer: WordPieceTokenizer,
                 batch_size: int, max_seq_length: int = 384,
                 doc_stride: int = 128, max_query_length: int = 64,
                 negative_pool: Optional[PassagePool] = None, seed: int = 0,
                 with_teacher: bool = False):
        self.example_iter = example_iter
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.doc_stride = doc_stride
        self.max_query_length = max_query_length
        self.negative_pool = negative_pool
        self.rng = random.Random(seed)
        self.with_teacher = with_teacher

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List[dict] = []
        for ex in self.example_iter:
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        # final partial batch dropped (static shapes)

    def _collate(self, examples: List[dict]) -> Dict[str, np.ndarray]:
        feats = convert_rc_examples(
            examples, self.tokenizer, max_seq_length=self.max_seq_length,
            doc_stride=self.doc_stride, max_query_length=self.max_query_length,
            with_teacher=self.with_teacher)
        keys = ["input_ids", "attention_mask", "token_type_ids",
                "query_input_ids", "query_attention_mask",
                "query_token_type_ids"]
        batch = {k: np.stack([getattr(f, k) for f in feats]) for k in keys}
        batch["start_positions"] = np.asarray(
            [f.start_position for f in feats], np.int32)
        batch["end_positions"] = np.asarray(
            [f.end_position for f in feats], np.int32)
        if self.with_teacher and feats[0].cross_input_ids is not None:
            for k in ("cross_input_ids", "cross_attention_mask",
                      "cross_token_type_ids", "teacher_gather"):
                batch[k] = np.stack([getattr(f, k) for f in feats])

        if self.negative_pool is not None and len(self.negative_pool):
            neg_examples = []
            for ex in examples:
                title, text = self.negative_pool.sample(self.rng, 1)[0]
                neg_examples.append({
                    "qid": "neg", "question": ex["question"], "title": title,
                    "context": text, "answer_text": "", "answer_start": -1})
            neg_feats = convert_rc_examples(
                neg_examples, self.tokenizer,
                max_seq_length=self.max_seq_length,
                doc_stride=self.doc_stride,
                max_query_length=self.max_query_length)
            batch["neg_input_ids"] = np.stack(
                [f.input_ids for f in neg_feats])
            batch["neg_attention_mask"] = np.stack(
                [f.attention_mask for f in neg_feats])
            batch["neg_token_type_ids"] = np.stack(
                [f.token_type_ids for f in neg_feats])
        return batch
