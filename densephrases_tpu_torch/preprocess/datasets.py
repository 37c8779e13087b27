"""Dataset construction/merging utilities.

Host copy of ``densephrases_tpu/preprocess/datasets.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with the remaining scripts/preprocess entries:
- ``nq_to_squad`` — Natural Questions (simplified jsonl) → SQuAD-style
  reader data (ref: create_nq_reader*.py).
- ``merge_openqa`` — merge open-QA test/train files (ref: merge_openqa.py;
  merge_paq.py is the jsonl variant, covered by the jsonl branch).
- ``stat_entities`` — answer-type statistics (ref: stat_entities.py; the
  reference uses spaCy NER — unavailable here — so typing is rule-based).
- ``filter_noans`` — drop unanswerable rows (ref: filter_noans.py).
- ``filter_wiki`` — drop blacklist articles from corpus files
  (ref: filter_wiki.py; reuses the prep_wikipedia blacklist).
- ``tsv_to_corpus`` — DPR-style passage TSV → SQuAD-style corpus files,
  the passage-index input (ref: create_psg_hdf5.py).
- ``SimpleTokenizer`` — DrQA regex word tokenizer used by passage recall
  matching (ref: scripts/preprocess/simple_tokenizer.py).

(download_wikidump.py is a network fetch script — not applicable in this
offline environment; any Wikipedia dump dropped on disk feeds build_db.)
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)


# --------------------------------------------------------------- tokenizer
class SimpleTokenizer:
    """DrQA-style regex tokenizer: alphanumeric runs or single non-space
    chars (ref: simple_tokenizer.py:185 — same core regex)."""

    def __init__(self):
        import regex  # baked into the image; supports \p classes

        self._re = regex.compile(r"[\p{L}\p{N}\p{M}]+|[^\p{Z}\p{C}]",
                                 regex.UNICODE)

    def tokenize(self, text: str) -> List[str]:
        return [m.group() for m in self._re.finditer(text)]

    def words(self, text: str, uncased: bool = True) -> List[str]:
        toks = self.tokenize(text)
        return [t.lower() for t in toks] if uncased else toks


# --------------------------------------------------------------- NQ reader
def nq_to_squad(nq_jsonl_path: str, out_path: str,
                max_rows: Optional[int] = None) -> int:
    """Simplified-NQ jsonl → SQuAD reader json (ref: create_nq_reader.py).

    Expects rows with 'question_text', 'document_text' (space-joined
    tokens), and 'annotations' ([{'long_answer': {start_token, end_token},
    'short_answers': [{start_token, end_token}]}]). The long answer becomes
    the context; the first short answer becomes the span."""
    data = []
    n = 0
    with open(nq_jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            if max_rows and n >= max_rows:
                break
            row = json.loads(line)
            doc_tokens = row["document_text"].split(" ")
            for ann in row.get("annotations", []):
                la = ann.get("long_answer", {})
                ls, le = la.get("start_token", -1), la.get("end_token", -1)
                le = min(le, len(doc_tokens))
                if ls < 0 or le <= ls:
                    continue
                # strip html-ish tokens (ref create_nq_reader html removal)
                ctx_tokens, tok_map = [], {}
                for i in range(ls, le):
                    t = doc_tokens[i]
                    if t.startswith("<") and t.endswith(">"):
                        continue
                    tok_map[i] = len(ctx_tokens)
                    ctx_tokens.append(t)
                if not ctx_tokens:
                    continue
                context = " ".join(ctx_tokens)
                qas = []
                for sa in ann.get("short_answers", [])[:1]:
                    ss, se = sa.get("start_token", -1), sa.get("end_token", -1)
                    if ss not in tok_map or (se - 1) not in tok_map:
                        continue
                    w0 = tok_map[ss]
                    answer = " ".join(ctx_tokens[w0: tok_map[se - 1] + 1])
                    starts = 0 if w0 == 0 else len(
                        " ".join(ctx_tokens[:w0])) + 1
                    qas.append({
                        "id": f"nq-{n}", "question": row["question_text"],
                        "answers": [{"text": answer, "answer_start": starts}],
                    })
                if qas:
                    data.append({"title": row.get("document_title", ""),
                                 "paragraphs": [{"context": context,
                                                 "qas": qas}]})
                    n += 1
    with open(out_path, "w") as f:
        json.dump({"data": data}, f)
    logger.info("nq_to_squad: %d examples → %s", n, out_path)
    return n


# --------------------------------------------------------------- merging
def merge_openqa(paths: List[str], out_path: str, dedup: bool = True) -> int:
    """Merge open-QA files ({'data': [{'id','question','answers'}]}) —
    ref: merge_openqa.py (json) / merge_paq.py (jsonl)."""
    rows, seen = [], set()
    for path in paths:
        if path.endswith(".jsonl"):
            items = [json.loads(l) for l in open(path) if l.strip()]
        else:
            items = json.load(open(path))["data"]
        for row in items:
            q = row.get("question", "")
            if dedup:
                key = q.strip().lower()
                if key in seen:
                    continue
                seen.add(key)
            rows.append({"id": str(len(rows)), "question": q,
                         "answers": row.get("answers", [])})
    with open(out_path, "w") as f:
        json.dump({"data": rows}, f)
    return len(rows)


# --------------------------------------------------------------- filtering
def filter_noans(path: str, out_path: str) -> int:
    """Drop rows without answers (ref: filter_noans.py)."""
    data = json.load(open(path))["data"]
    kept = [r for r in data if r.get("answers")]
    with open(out_path, "w") as f:
        json.dump({"data": kept}, f)
    return len(kept)


def filter_wiki(in_dir: str, out_dir: str) -> int:
    """Drop blacklist articles from SQuAD-style corpus files
    (ref: filter_wiki.py, blacklist from prep_wikipedia)."""
    from densephrases_tpu_torch.preprocess.wiki import keep_article

    os.makedirs(out_dir, exist_ok=True)
    kept = 0
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".json"):
            continue
        data = json.load(open(os.path.join(in_dir, name)))["data"]
        out = [d for d in data if keep_article(
            d.get("title", ""),
            " ".join(p["context"] for p in d["paragraphs"]))]
        kept += len(out)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump({"data": out}, f)
    return kept


# --------------------------------------------------------------- stats
_NUM_RE = re.compile(r"^[\d,.\-–—/%$€£¥:]+$")
_DATE_RE = re.compile(
    r"\b(january|february|march|april|may|june|july|august|september|"
    r"october|november|december|\d{4})\b", re.IGNORECASE)


def answer_type(answer: str) -> str:
    """Rule-based answer typing (ref stat_entities uses spaCy NER; spaCy is
    not in this image, so: NUM / DATE / PROPER / OTHER)."""
    a = answer.strip()
    if not a:
        return "EMPTY"
    if _NUM_RE.match(a.replace(" ", "")):
        return "NUM"
    if _DATE_RE.search(a):
        return "DATE"
    words = a.split()
    if words and all(w[:1].isupper() for w in words if w[:1].isalpha()):
        return "PROPER"
    return "OTHER"


def stat_entities(path: str) -> Dict[str, int]:
    """Answer-type histogram over an open-QA file (ref: stat_entities.py)."""
    data = json.load(open(path))["data"]
    counts = Counter()
    for row in data:
        for ans in row.get("answers", []):
            counts[answer_type(ans if isinstance(ans, str)
                               else ans.get("text", ""))] += 1
    logger.info("answer types: %s", dict(counts))
    return dict(counts)


# --------------------------------------------------------------- passages
def tsv_to_corpus(tsv_path: str, out_dir: str, docs_per_file: int = 1000,
                  passages_per_doc: int = 1) -> int:
    """DPR passage TSV (id \\t text \\t title) → SQuAD-style corpus files
    for passage-index building (ref: create_psg_hdf5.py)."""
    import csv

    os.makedirs(out_dir, exist_ok=True)
    buf: List[dict] = []
    cur: Optional[dict] = None
    n_files = 0

    def flush():
        nonlocal n_files, buf
        with open(os.path.join(out_dir, f"{n_files:04d}.json"), "w") as f:
            json.dump({"data": buf}, f)
        n_files += 1
        buf = []

    with open(tsv_path) as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if len(row) < 2 or row[0] == "id":
                continue
            text = row[1]
            title = row[2] if len(row) > 2 else ""
            if cur is None or cur["title"] != title or \
                    len(cur["paragraphs"]) >= passages_per_doc:
                if cur is not None:
                    buf.append(cur)
                    if len(buf) >= docs_per_file:
                        flush()
                cur = {"title": title, "paragraphs": []}
            cur["paragraphs"].append({"context": text})
    if cur is not None:
        buf.append(cur)
    if buf:
        flush()
    return n_files
