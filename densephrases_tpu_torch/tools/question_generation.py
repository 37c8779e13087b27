"""Question generation for RC training augmentation.

Host copy of ``densephrases_tpu/tools/question_generation.py``: the port never
imports the JAX package, whose ``__init__`` imports jax. Keep the two
in step.

Parity with ref: scripts/question_generation/generate_squad.py (T5-based QG
over paragraphs to synthesize SQuAD-style training data) and filter_qg.py
(round-trip consistency filtering).

The reference shells out to an external T5 ``question_generation`` repo;
this module accepts ANY callable ``qg_fn(context) -> [(question, answer)]``
so a seq2seq model can be plugged in when weights are on local disk, and
ships a noisy-cloze fallback generator so the augmentation + filtering
pipeline runs self-contained.
"""

from __future__ import annotations

import json
import logging
import random
import re
import zlib
from typing import Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)

_ENT_RE = re.compile(r"\b([A-Z][a-zA-Z0-9]+(?: [A-Z][a-zA-Z0-9]+)*|\d{4}|\d+)\b")


def cloze_qg(context: str, max_questions: int = 3, seed: int = 0
             ) -> List[Tuple[str, str]]:
    """Noisy-cloze generator: pick entity-like spans as answers, turn their
    sentence into a wh-cloze question. Weak but self-contained; the official
    T5 route plugs in via the qg_fn parameter."""
    rng = random.Random(seed)
    out = []
    sents = re.split(r"(?<=[.!?])\s+", context)
    cands = []
    for sent in sents:
        for m in _ENT_RE.finditer(sent):
            # skip sentence-initial capitalized words (likely not entities)
            if m.start() == 0:
                continue
            cands.append((sent, m.group(0)))
    rng.shuffle(cands)
    for sent, ans in cands[:max_questions]:
        wh = "when" if ans.isdigit() else "what"
        question = f"{wh} is " + sent.replace(ans, "").strip().rstrip(".?!,")
        question = re.sub(r"\s+", " ", question)[:200]
        out.append((question, ans))
    return out


_STOP = frozenset(
    "the a an and or but of to in on at by for with from as is are was were "
    "be been being has have had do does did will would can could should may "
    "might it its his her their this that these those he she they we you i "
    "not no nor so than then there here when where who whom which what why "
    "how all any both each few more most other some such only own same s t "
    "just also into over under again further once during before after above "
    "below up down out off about against between through".split())

_NUM_RE = re.compile(r"\b\d[\d,.]*%?\b")
_WORD_RE = re.compile(r"[A-Za-z][A-Za-z'-]*")


def _wh_for(ans: str, salt: int) -> str:
    """Answer-type question word; deterministic variety via salt."""
    if re.fullmatch(r"\d{4}", ans):
        return "when"
    if _NUM_RE.fullmatch(ans):
        return ("how many", "when", "what")[salt % 3]
    if ans[:1].isupper():
        return ("who", "what", "which")[salt % 3]
    return "what"


def cloze_qg_extended(context: str, max_questions: int = 100, seed: int = 0
                      ) -> List[Tuple[str, str]]:
    """Richer cloze generator for data-scale studies (tools/dsmall.py).

    The basic generator saturates at ~16 entity answers per paragraph —
    far too few to study EM as a function of training pairs. This one
    widens answer candidates to entity spans (including sentence-initial
    ones), number/percent spans, and content-word n-grams, and varies
    the question surface (answer-typed wh-word; full-sentence and local-
    window cloze views), yielding ~50-150 distinct (question, answer)
    pairs per Wikipedia paragraph. Role: a stand-in for the reference's
    T5-large QG sampling many questions per paragraph
    (ref: scripts/question_generation/generate_squad.py:14)."""
    rng = random.Random(seed)
    sents = re.split(r"(?<=[.!?])\s+", context)
    cands = []
    for sent in sents:
        spans = set()
        for m in _ENT_RE.finditer(sent):
            spans.add(m.group(0))
        for m in _NUM_RE.finditer(sent):
            spans.add(m.group(0))
        # content words + adjacent-bigram n-grams (no stopwords,
        # lowercase-led so entity spans stay with the entity branch)
        words = [(m.group(0), m.start()) for m in _WORD_RE.finditer(sent)]
        for w, _ in words:
            if (w[:1].islower() and w.lower() not in _STOP
                    and len(w) >= 4):
                spans.add(w)
        for i in range(len(words) - 1):
            (w1, p1), (w2, p2) = words[i], words[i + 1]
            if (w1.lower() not in _STOP and w2.lower() not in _STOP
                    and p2 == p1 + len(w1) + 1 and w1[:1].islower()):
                spans.add(f"{w1} {w2}")
        for ans in spans:
            if len(ans) < 2 or ans.lower() in _STOP:
                continue
            cands.append((sent, ans))
    rng.shuffle(cands)
    out, seen = [], set()
    for sent, ans in cands:
        if len(out) >= max_questions:
            break
        salt = zlib.crc32((sent + '\x00' + ans).encode())
        wh = _wh_for(ans, salt)
        views = [sent]
        # local-window view: ±8 words around the blank (a second surface
        # form for the same fact)
        pos = sent.find(ans)
        if pos >= 0:
            left = sent[:pos].split()[-8:]
            right = sent[pos + len(ans):].split()[:8]
            win = " ".join(left + right)
            if win and win != sent:
                views.append(win)
        view = views[salt % len(views)]
        q = f"{wh} is " + view.replace(ans, "", 1).strip().rstrip(".?!,")
        q = re.sub(r"\s+", " ", q)[:200]
        if (q, ans) in seen:
            continue
        seen.add((q, ans))
        out.append((q, ans))
    return out


def hf_seq2seq_qg(model_path: str, max_questions: int = 3,
                  device: str = "cpu", max_input_len: int = 512,
                  max_output_len: int = 64) -> Callable:
    """Build a ``qg_fn`` from a LOCAL HuggingFace seq2seq checkpoint — the
    reference's actual generator is T5-large QG
    (ref: scripts/question_generation/generate_squad.py:14).

    Expects a highlight-format QG model (answer span wrapped in <hl> marks,
    the valhalla/t5-*-qg convention): for each entity-like candidate span
    the model generates one question. Requires the weights on local disk
    (`transformers` loads with local_files_only=True; no hub access)."""
    import torch
    from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    model = AutoModelForSeq2SeqLM.from_pretrained(
        model_path, local_files_only=True).to(device).eval()

    def qg_fn(context: str) -> List[Tuple[str, str, int]]:
        matches = [m for m in _ENT_RE.finditer(context)
                   if m.start() > 0][:max_questions]
        if not matches:
            return []
        # splice the highlight at the MATCHED span's offsets — a
        # str.replace would mark the first occurrence of the string, which
        # for repeated entities is a different span than the one matched
        prompts = [
            "generate question: " + context[:m.start()]
            + f"<hl> {m.group(0)} <hl>" + context[m.end():]
            for m in matches
        ]
        enc = tok(prompts, return_tensors="pt", padding=True,
                  truncation=True, max_length=max_input_len)
        # some fast tokenizers emit token_type_ids, which seq2seq
        # generate() rejects as an unused model kwarg
        enc.pop("token_type_ids", None)
        enc = enc.to(device)
        with torch.no_grad():
            gen = model.generate(**enc, max_length=max_output_len,
                                 num_beams=4)
        questions = tok.batch_decode(gen, skip_special_tokens=True)
        # (question, answer, answer_start) — the start pins the gold span
        # to the highlighted occurrence
        return [(q.strip(), m.group(0), m.start())
                for q, m in zip(questions, matches) if q.strip()]

    return qg_fn


def generate_squad(docs: List[dict], out_path: str,
                   qg_fn: Optional[Callable] = None,
                   max_questions_per_par: int = 3, seed: int = 0) -> int:
    """docs: [{'title', 'paragraphs': [str]}] → SQuAD-format QG file
    (ref: generate_squad.py)."""
    qg = qg_fn or (lambda ctx: cloze_qg(ctx, max_questions_per_par, seed))
    data = []
    n_q = 0
    for doc in docs:
        paragraphs = []
        for par in doc["paragraphs"]:
            qas = []
            for item in qg(par):
                # qg_fn may yield (q, a) or (q, a, answer_start); with an
                # explicit start the gold span is the generator's own
                q, a = item[0], item[1]
                start = item[2] if len(item) > 2 else par.find(a)
                if start < 0 or par[start:start + len(a)] != a:
                    continue
                qas.append({
                    "id": f"qg-{n_q}", "question": q,
                    "answers": [{"text": a, "answer_start": start}],
                })
                n_q += 1
            if qas:
                paragraphs.append({"context": par, "qas": qas})
        if paragraphs:
            data.append({"title": doc.get("title", ""),
                         "paragraphs": paragraphs})
    with open(out_path, "w") as f:
        json.dump({"data": data}, f)
    logger.info("generated %d questions → %s", n_q, out_path)
    return n_q


def filter_qg(qg_path: str, out_path: str, answer_fn: Callable[[str, str], str],
              match: str = "em") -> int:
    """Round-trip filtering: keep a generated QA pair only when a reader
    answers the question with (a superset of) the original answer
    (ref: filter_qg.py). answer_fn(question, context) -> predicted answer."""
    from densephrases_tpu_torch.eval.metrics import exact_match_score, f1_score

    data = json.load(open(qg_path))["data"]
    kept_data = []
    kept = 0
    for art in data:
        new_pars = []
        for par in art["paragraphs"]:
            new_qas = []
            for qa in par["qas"]:
                pred = answer_fn(qa["question"], par["context"])
                gold = qa["answers"][0]["text"]
                ok = (exact_match_score(pred, gold) if match == "em"
                      else f1_score(pred, gold)[0] > 0.5)
                if ok:
                    new_qas.append(qa)
                    kept += 1
            if new_qas:
                new_pars.append({"context": par["context"], "qas": new_qas})
        if new_pars:
            kept_data.append({"title": art["title"], "paragraphs": new_pars})
    with open(out_path, "w") as f:
        json.dump({"data": kept_data}, f)
    return kept
