"""Wikipedia → SQuAD-style corpus construction.

Host copy of ``densephrases_tpu/preprocess/wiki.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with the reference's preprocessing chain:
- article filtering — disambiguation/list/outline page removal and short-
  paragraph dropping (ref: scripts/preprocess/prep_wikipedia.py:17-35
  DrQA-style blacklist)
- doc→json conversion with paragraph splitting
  (ref: scripts/preprocess/build_wikisquad.py)
- small-doc concatenation to even out document sizes
  (ref: scripts/preprocess/concat_wikisquad.py)
- open-domain test-set construction (ref: scripts/preprocess/create_openqa.py)

All host-side offline tooling.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional

from densephrases_tpu_torch.preprocess.doc_db import DocDB

# DrQA-style page blacklist (ref: prep_wikipedia.py:17-35)
BLACKLIST_PATTERNS = (
    r"\(disambiguation\)", r"\(disambiguation page\)",
    r"^(List of .+)|(Index of .+)|(Outline of .+)$",
)


def keep_article(title: str, text: str, min_chars: int = 50) -> bool:
    for pat in BLACKLIST_PATTERNS:
        if re.search(pat, title, flags=re.IGNORECASE):
            return False
    if len(text.strip()) < min_chars:
        return False
    return True


def split_paragraphs(text: str, min_par_chars: int = 25) -> List[str]:
    """Newline-delimited paragraphs, dropping headers/stubs."""
    paras = []
    for para in text.split("\n"):
        para = para.strip()
        if len(para) < min_par_chars:
            continue
        paras.append(para)
    return paras


def db_to_squad_docs(db_path: str, out_dir: str, docs_per_file: int = 1000,
                     min_par_chars: int = 25) -> int:
    """DocDB → numbered SQuAD-style corpus files (ref: build_wikisquad.py).

    Output: out_dir/NNNN.json with {'data': [{'title', 'paragraphs':
    [{'context': ...}]}]} — the dump driver's input format."""
    os.makedirs(out_dir, exist_ok=True)
    n_files = 0
    buf: List[dict] = []
    with DocDB(db_path) as db:
        for doc_id in db.doc_ids():
            title = db.get_doc_title(doc_id) or ""
            text = db.get_doc_text(doc_id) or ""
            if not keep_article(title, text):
                continue
            paras = split_paragraphs(text, min_par_chars)
            if not paras:
                continue
            buf.append({"title": title,
                        "paragraphs": [{"context": p} for p in paras]})
            if len(buf) >= docs_per_file:
                _write_file(out_dir, n_files, buf)
                n_files += 1
                buf = []
    if buf:
        _write_file(out_dir, n_files, buf)
        n_files += 1
    return n_files


def _write_file(out_dir: str, idx: int, docs: List[dict]):
    with open(os.path.join(out_dir, f"{idx:04d}.json"), "w") as f:
        json.dump({"data": docs}, f)


def concat_small_docs(in_dir: str, out_dir: str, min_words: int = 500) -> int:
    """Merge consecutive small documents into one (title = first doc's)
    so per-doc work is even (ref: concat_wikisquad.py)."""
    os.makedirs(out_dir, exist_ok=True)
    n_out = 0
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".json"):
            continue
        data = json.load(open(os.path.join(in_dir, name)))["data"]
        merged: List[dict] = []
        cur: Optional[dict] = None
        cur_words = 0
        for doc in data:
            words = sum(len(p["context"].split()) for p in doc["paragraphs"])
            if cur is None:
                cur, cur_words = doc, words
            elif cur_words < min_words:
                cur["paragraphs"] = cur["paragraphs"] + doc["paragraphs"]
                cur_words += words
            else:
                merged.append(cur)
                cur, cur_words = doc, words
        if cur is not None:
            merged.append(cur)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"data": merged}, f)
        n_out += 1
    return n_out


def create_openqa(qa_rows: Iterable[dict], out_path: str,
                  input_type: str = "squad") -> int:
    """Build an open-domain QA test file from SQuAD/DrQA/KILT-style rows
    (ref: create_openqa.py:16-43)."""
    out = []
    for row in qa_rows:
        if input_type == "squad":
            q = row["question"]
            answers = [a["text"] if isinstance(a, dict) else a
                       for a in row.get("answers", [])]
        elif input_type == "drqa":  # tsv-like [question, [answers]]
            q, answers = row[0], row[1]
        elif input_type == "kilt":
            q = row["input"]
            answers = [o["answer"] for o in row.get("output", [])
                       if o.get("answer")]
        else:
            raise ValueError(input_type)
        out.append({"id": str(len(out)), "question": q, "answers": answers})
    with open(out_path, "w") as f:
        json.dump({"data": out}, f)
    return len(out)
