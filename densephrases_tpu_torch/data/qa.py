"""Open-domain QA pair loading.

Host copy of ``densephrases_tpu/data/qa.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with ref: open_utils.py:104-160 ``load_qa_pairs``: reads SQuAD-style
json ({'data': [{'question', 'answers', ...}]}) or jsonl, lowercase+truecase
handling, [START_ENT] window clipping for entity-linking queries
(ref: open_utils.py:118-120), trailing '?' strip (ref: :128), and --draft
subsampling (ref: :141-146)."""

from __future__ import annotations

import json
import logging
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)


def load_qa_pairs(path: str, draft: bool = False, draft_num: int = 100,
                  truecase=None, shuffle: bool = False, seed: int = 0
                  ) -> Tuple[List[str], List[str], List[List[str]]]:
    """Returns (ids, questions, answer_lists)."""
    qids: List[str] = []
    questions: List[str] = []
    answers: List[List[str]] = []

    if path.endswith(".jsonl"):
        rows = [json.loads(line) for line in open(path) if line.strip()]
    else:
        data = json.load(open(path))
        rows = data["data"] if isinstance(data, dict) else data

    for i, row in enumerate(rows):
        q = row.get("question", row.get("input", ""))
        ans = row.get("answers", row.get("answer", []))
        if isinstance(ans, str):
            ans = [ans]
        qid = str(row.get("id", i))

        # entity-linking [START_ENT] window clip (ref: open_utils.py:118-120)
        if "[START_ENT]" in q:
            pos = q.index("[START_ENT]")
            q = q[max(0, pos - 300): pos + 300]

        q = q.strip()
        if q.endswith("?"):
            q = q[:-1]
        if truecase is not None and q == q.lower():
            q = truecase.get_true_case(q)

        qids.append(qid)
        questions.append(q)
        answers.append(ans)

    if shuffle:
        import random

        rng = random.Random(seed)
        order = list(range(len(qids)))
        rng.shuffle(order)
        qids = [qids[i] for i in order]
        questions = [questions[i] for i in order]
        answers = [answers[i] for i in order]

    if draft:
        qids, questions, answers = (
            qids[:draft_num], questions[:draft_num], answers[:draft_num])
    logger.info("loaded %d QA pairs from %s", len(qids), path)
    return qids, questions, answers


def load_squad_paragraphs(path: str):
    """Read a SQuAD-format file into dump-ready docs:
    [{'doc_id', 'title', 'paragraphs': [str]}] (corpus side of
    ref: squad_utils.py:811-950 _create_examples context path)."""
    data = json.load(open(path))["data"]
    docs = []
    for i, art in enumerate(data):
        docs.append({
            "doc_id": i,
            "title": art.get("title", f"doc{i}"),
            "paragraphs": [p["context"] for p in art["paragraphs"]],
        })
    return docs


def load_rc_examples(path: str, draft: bool = False, draft_num: int = 1002):
    """Read SQuAD-format training data into RC examples:
    [{'qid','question','title','context','answer_text','answer_start'}]
    (ref: squad_utils.py:866-950)."""
    data = json.load(open(path))["data"]
    out = []
    for art in data:
        title = art.get("title", "")
        for para in art["paragraphs"]:
            ctx = para["context"]
            for qa in para.get("qas", []):
                ans = qa.get("answers", [])
                if qa.get("is_impossible") or not ans:
                    answer_text, answer_start = "", -1
                else:
                    answer_text = ans[0]["text"]
                    answer_start = ans[0]["answer_start"]
                out.append({
                    "qid": qa.get("id", str(len(out))),
                    "question": qa["question"],
                    "title": title,
                    "context": ctx,
                    "answer_text": answer_text,
                    "answer_start": answer_start,
                })
                if draft and len(out) >= draft_num:
                    return out
    return out
