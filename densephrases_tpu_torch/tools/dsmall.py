"""D_small: EM over real text as the indexed corpus grows, with one encoder.

The counterpart of ``densephrases_tpu/tools/dsmall.py``. The reference's
identity is open-domain EM over a real corpus; its "D_small" setting
indexes the NQ-dev passages, the full one all of Wikipedia. With no
pretrained weights and no Wikipedia, this driver builds the closest
offline analog over local prose and runs the whole stack on real text:

1. a document-held-out dev set: cloze-QG pairs from whole documents the
   encoder never trains on (``split_docs``, ``build_qa``); the dev
   paragraphs are in every index;
2. corpus scale: the same encoder and dev set with the index grown by
   whole documents (``nested_corpora``), the semi-open to open axis;
3. RC training with checkpoint selection: 5% of the train pairs held out,
   the best dev-loss parameters kept, early stop after ``--patience``
   evals (``train_rc_selected``, on ``train/rc.py``: kernels A and B);
4. query-side fine-tuning against the frozen largest index
   (``query_ft``, on ``train/query.py``), as a delta on the same dev set.

The corpus: the reference's ``build_corpus_docs`` opens the upstream
checkout's ``articles.json`` and ``examples_context.txt``, which are not
on disk here, so ``local_corpus_docs`` builds the corpus JSON from local
sources only (docstrings of installed packages and ``.md`` files) and
passes it as ``--corpus``; ``build_corpus_docs`` returns a cached file as
it is. The corpus depends on the installed packages, so the result
records ``n_docs`` and ``n_paragraphs``; set ``--scales`` from them.

Encoders load through ``cli.common.load_encoder`` (the port's saves, or a
``pytorch_model.bin``). Every phase caches under ``--workdir``; one JSON
goes to ``--out``. Both default under the system's temp dir.

Run:  python -m densephrases_tpu_torch.tools.dsmall --corpus_only --workdir W
      python -m densephrases_tpu_torch.cli.train_mlm --out W/mlm \
          --corpus W/corpus.txt
      python -m densephrases_tpu_torch.tools.dsmall --pretrained W/mlm \
          --workdir W
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import logging
import os
import time

import numpy as np
import torch

from densephrases_tpu_torch.tools import _bench
from densephrases_tpu_torch.utils.device import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _h(s: str) -> int:
    return int(hashlib.sha1(s.encode()).hexdigest()[:8], 16)


def split_docs(docs, dev_par_target: int, max_dev_doc_pars: int = 40):
    """Deterministic document-held-out split: dev docs are picked in
    title-hash order until the dev paragraph budget is met. One article
    (the smallest) is force-included so dev covers the wiki genre too."""
    arts = [d for d in docs if ":" not in d["title"]
            and not d["title"].startswith(("SQuAD", "demo"))]
    forced = min(arts, key=lambda d: len(d["paragraphs"])) if arts else None
    dev_docs, n = [], 0
    if forced is not None:
        dev_docs.append(forced)
        n = len(forced["paragraphs"])
    for d in sorted(docs, key=lambda d: _h(d["title"])):
        if n >= dev_par_target:
            break
        if d is forced or len(d["paragraphs"]) > max_dev_doc_pars:
            continue
        dev_docs.append(d)
        n += len(d["paragraphs"])
    dev_titles = {d["title"] for d in dev_docs}
    train_docs = [d for d in docs if d["title"] not in dev_titles]
    return train_docs, dev_docs


def build_qa(docs, per_par: int, seed: int = 0, max_pars: int = 0):
    """Cloze-QG pairs over documents (real answer spans in real text),
    deduplicated by (question, answer). max_pars > 0 caps the paragraph
    count (title-hash order)."""
    from densephrases_tpu_torch.tools.question_generation import (
        cloze_qg_extended)

    pars = [(d["title"], f"{di}_{pi}", p)
            for di, d in enumerate(docs)
            for pi, p in enumerate(d["paragraphs"])]
    if max_pars and len(pars) > max_pars:
        pars = sorted(pars, key=lambda t: _h(t[1] + t[2][:32]))[:max_pars]
    examples, seen = [], set()
    for title, par_key, par in pars:
        for q, a in cloze_qg_extended(par, max_questions=per_par, seed=seed):
            start = par.find(a)
            if start < 0 or (q, a) in seen or len(a) < 2:
                continue
            seen.add((q, a))
            examples.append({
                "qid": hashlib.sha1((q + a).encode()).hexdigest()[:16],
                "question": q, "title": title, "context": par,
                "par_key": par_key,
                "answer_text": a, "answer_start": start})
    return examples


def nested_corpora(dev_docs, train_docs, scales):
    """Nested corpora by whole documents: dev docs first (every scale
    answers the fixed dev set), then train docs in title-hash order until
    each paragraph target is met."""
    ordered = dev_docs + sorted(train_docs, key=lambda d: _h(d["title"]))
    out = []
    for target in scales:
        corpus, n = [], 0
        for d in ordered:
            if n >= target:
                break
            corpus.append(d)
            n += len(d["paragraphs"])
        out.append(corpus)
    return out


def _metrics(dp, exs, top_k=10):
    pairs = [(e["question"], [e["answer_text"]]) for e in exs]
    t0 = time.perf_counter()
    m = dp.evaluate(pairs, top_k=top_k)
    return {
        "em_top1": round(float(m["em_top1"]), 4),
        "em_top10": round(float(m["em_topk"]), 4),
        "f1_top1": round(float(m["f1_top1"]), 4),
        "f1_top10": round(float(m["f1_topk"]), 4),
        "n": m["n"], "eval_s": round(time.perf_counter() - t0, 1),
    }


def local_corpus_docs(out_path: str, roots=None, md_roots=None,
                      max_files: int = 20000):
    """The corpus JSON from local sources only: one document per python
    source file's docstrings under ``roots`` (default: the installed
    packages ``offline_corpus`` harvests) and one per ``.md`` / ``.rst``
    file under ``md_roots`` (default: the repository), with
    ``build_corpus_docs``'s prose filter and first-160-characters dedupe.
    Written to ``out_path``; a file already there is returned as it is."""
    import re

    from densephrases_tpu_torch.preprocess.offline_corpus import (
        _normalize, docs_from_docstrings, looks_like_prose)

    if os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    groups = list(docs_from_docstrings(roots, max_files=max_files))
    for root in (md_roots if md_roots is not None else [REPO_ROOT]):
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
            for fn in sorted(filenames):
                if not fn.endswith((".md", ".rst")):
                    continue
                try:
                    with open(os.path.join(dirpath, fn), encoding="utf-8",
                              errors="replace") as f:
                        text = f.read()
                except OSError:
                    continue
                text = re.sub(r"```.*?```", " ", text, flags=re.S)
                pars = [_normalize(re.sub(r"[#*`]", "", p))
                        for p in re.split(r"\n\s*\n", text)]
                pars = [p for p in pars if looks_like_prose(p)]
                if pars:
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    groups.append({"title": rel, "paragraphs": pars})
    seen, docs = set(), []
    for g in groups:
        pars = []
        for p in g["paragraphs"]:
            key = p.lower()[:160]
            if key not in seen:
                seen.add(key)
                pars.append(p)
        if pars:
            docs.append({"title": g["title"], "paragraphs": pars})
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(docs, f)
    return docs


def split_rc(train_ex):
    """(rc_train, rc_dev): the 5% RC-dev slice by qid, never trained on."""
    rc_dev = [e for e in train_ex if int(e["qid"][:4], 16) % 20 == 0]
    rc_train = [e for e in train_ex if int(e["qid"][:4], 16) % 20 != 0]
    return rc_train, rc_dev


def train_rc_selected(params, config, tok, rc_train, rc_dev, *, steps: int,
                      batch: int, lr: float, seq: int, pre_batch: int,
                      eval_every: int, patience: int, device, seed: int = 1):
    """RC training with dev-loss checkpoint selection (kernels A and B):
    ``params`` train in place; the best-dev-loss parameters (or the last
    when no eval ran) are loaded back into them. Returns the train info."""
    from densephrases_tpu_torch.data.rc_dataset import (
        batches, convert_rc_examples)
    from densephrases_tpu_torch.models.encoder import RCLossConfig, rc_loss
    from densephrases_tpu_torch.train.rc import (
        create_train_state, make_optimizer, make_train_step)

    def feats_of(exs):
        return convert_rc_examples(exs, tok, max_seq_length=seq,
                                   doc_stride=seq // 2, max_query_length=24)

    feats, dev_feats = feats_of(rc_train), feats_of(rc_dev)
    opt = make_optimizer(lr=lr, warmup_steps=steps // 10, total_steps=steps)
    state = create_train_state(params, opt, pbn_size=pre_batch,
                               batch_size=batch, hidden=config.hidden_size)
    loss_cfg = RCLossConfig(lambda_neg=1.0, lambda_flt=1.0)
    step_fn = make_train_step(config, loss_cfg, opt, attn_impl="auto")

    def to_dev(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    dev_batches = [to_dev(b) for b in batches(
        dev_feats, batch, shuffle=False,
        drop_last=len(dev_feats) >= batch)]

    def dev_loss():
        if not dev_batches:
            return float("inf")
        with torch.no_grad():
            return float(np.mean([float(rc_loss(
                state.params, config, b, loss_cfg, deterministic=True)[0])
                for b in dev_batches]))

    order_rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    n_step, stale, best = 0, 0, (float("inf"), None, 0)
    curve = []
    while n_step < steps and stale < patience:
        idx = order_rng.permutation(len(feats))
        if len(idx) < batch:
            raise ValueError(f"{len(feats)} features < one batch of {batch}")
        for b in batches([feats[i] for i in idx], batch, shuffle=False,
                         drop_last=True):
            state, m = step_fn(state, to_dev(b), gen)
            n_step += 1
            if n_step % eval_every == 0:
                dl = dev_loss()
                curve.append({"step": n_step, "loss": float(m["loss"]),
                              "dev_loss": dl})
                if dl < best[0]:
                    best = (dl, {k: v.detach().cpu().clone() for k, v in
                                 state.params.state_dict().items()}, n_step)
                    stale = 0
                else:
                    stale += 1
            if n_step >= steps or stale >= patience:
                break
    if best[1] is not None:
        params.load_state_dict(best[1])
    return {"train_s": time.perf_counter() - t0, "steps_run": n_step,
            "best_step": best[2], "best_dev_loss": best[0],
            "early_stopped": stale >= patience, "n_features": len(feats),
            "curve": curve}


def dump_scale(params, config, tok, corpus, store_dir: str, *, seq: int,
               dump_batch: int):
    """(store, dump seconds or None) of one corpus (cached)."""
    from densephrases_tpu_torch.dump import dump_phrases
    from densephrases_tpu_torch.index.store import PhraseStore

    if os.path.exists(os.path.join(store_dir, "store.json")):
        return PhraseStore.load(store_dir), None
    docs = [{"doc_id": i, "title": d["title"], "paragraphs": d["paragraphs"]}
            for i, d in enumerate(corpus)]
    t0 = time.perf_counter()
    store = dump_phrases(params, config, tok, docs, store_dir,
                         max_seq_length=seq, batch_size=dump_batch,
                         attn_impl="auto")
    return store, time.perf_counter() - t0


def query_ft(dp, rc_train, dev_ex, *, epochs: int, pairs: int, top_k: int,
             lr: float, batch: int):
    """Query-side fine-tuning of ``dp``'s towers against its frozen index
    (kernels A and B); returns the history and the dev metrics after."""
    from densephrases_tpu_torch.train.query import (
        QueryFTConfig, train_query_encoder)

    qft_ex = sorted(rc_train, key=lambda e: _h(e["qid"]))[:pairs]
    train_pairs = [(e["question"], [e["answer_text"]]) for e in qft_ex]
    dev_pairs = [(e["question"], [e["answer_text"]]) for e in dev_ex]
    cfg = QueryFTConfig(top_k=top_k, learning_rate=lr, epochs=epochs)
    t0 = time.perf_counter()
    _, history = train_query_encoder(dp, train_pairs, cfg, batch_size=batch,
                                     dev_pairs=dev_pairs, eval_top_k=10)
    return {"epochs": epochs, "n_pairs": len(train_pairs), "top_k": top_k,
            "lr": lr, "train_s": time.perf_counter() - t0,
            "loss": list(history["loss"]), "train_top1": list(history["top1"]),
            "dev_em_by_epoch": list(history["dev_em"]),
            "steps": list(history["steps"]),
            "dev": _metrics(dp, dev_ex)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=os.path.join(
        _bench.default_workdir(), "dsmall"))
    ap.add_argument("--corpus", default=None,
                    help="structured corpus JSON; default <workdir>/"
                         "corpus_docs.json, built by local_corpus_docs")
    ap.add_argument("--doc_roots", default=None,
                    help="comma list of source dirs whose docstrings make "
                         "documents (default: the installed packages)")
    ap.add_argument("--md_roots", default=None,
                    help="comma list of dirs whose .md files make documents "
                         "(default: the repository)")
    ap.add_argument("--pretrained", default=None,
                    help="MLM-pretrained encoder dir (cli/train_mlm); "
                         "required but with --corpus_only")
    ap.add_argument("--corpus_only", action="store_true",
                    help="write the corpus JSON and <workdir>/corpus.txt "
                         "(one paragraph a line: cli/train_mlm's --corpus) "
                         "and stop")
    ap.add_argument("--scales", default="112,2048,18780",
                    help="comma list of corpus sizes in PARAGRAPHS")
    ap.add_argument("--dev_pars", type=int, default=90)
    ap.add_argument("--dev_per_par", type=int, default=12)
    ap.add_argument("--train_per_par", type=int, default=20)
    ap.add_argument("--train_max_pars", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seq", type=int, default=192)
    ap.add_argument("--pre_batch", type=int, default=2)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--patience", type=int, default=6)
    ap.add_argument("--qft_epochs", type=int, default=6)
    ap.add_argument("--qft_pairs", type=int, default=4000)
    ap.add_argument("--qft_topk", type=int, default=40)
    ap.add_argument("--qft_lr", type=float, default=1e-4)
    ap.add_argument("--qft_batch", type=int, default=24)
    ap.add_argument("--dump_batch", type=int, default=32)
    ap.add_argument("--out", default=_bench.default_out("DSMALL.json"))
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.cli.common import load_encoder, save_encoder
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.preprocess.offline_corpus import (
        build_corpus_docs)

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(device)
    args.workdir = os.path.abspath(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    scales = sorted(int(s) for s in args.scales.split(","))
    fp = {k: getattr(args, k)
          for k in ("scales", "dev_pars", "dev_per_par", "train_per_par",
                    "train_max_pars", "steps", "batch", "lr", "seq",
                    "pre_batch")}
    res = {}
    out = os.path.abspath(args.out)
    if os.path.exists(out):
        try:
            with open(out) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = {}
        if prev.get("protocol") == fp:
            res = prev  # resume within one protocol configuration
    res["protocol"] = fp
    res["device"] = str(device)

    corpus_path = args.corpus or os.path.join(args.workdir,
                                              "corpus_docs.json")
    if not os.path.exists(corpus_path):
        local_corpus_docs(
            corpus_path,
            roots=args.doc_roots.split(",") if args.doc_roots else None,
            md_roots=args.md_roots.split(",") if args.md_roots else None)
    docs = build_corpus_docs(out_path=corpus_path)
    res["n_docs"], res["n_paragraphs"] = (
        len(docs), sum(len(d["paragraphs"]) for d in docs))
    if args.corpus_only:
        with open(os.path.join(args.workdir, "corpus.txt"), "w",
                  encoding="utf-8") as f:
            f.writelines(p + "\n" for d in docs for p in d["paragraphs"])
        print(json.dumps(res))
        return res
    if not args.pretrained:
        raise SystemExit("dsmall: --pretrained is required")

    # ---- phase 0: document split + QG (cached)
    train_docs, dev_docs = split_docs(docs, args.dev_pars)
    res["split"] = {
        "dev_docs": len(dev_docs),
        "dev_paragraphs": sum(len(d["paragraphs"]) for d in dev_docs),
        "dev_titles_sample": [d["title"] for d in dev_docs[:8]],
        "train_docs": len(train_docs)}
    qa_path = os.path.join(args.workdir, "qa_doc_split.json")
    if os.path.exists(qa_path):
        with open(qa_path) as f:
            blob = json.load(f)
        train_ex, dev_ex = blob["train"], blob["dev"]
    else:
        dev_ex = build_qa(dev_docs, args.dev_per_par, seed=0)
        train_ex = build_qa(train_docs, args.train_per_par, seed=0,
                            max_pars=args.train_max_pars)
        with open(qa_path, "w") as f:
            json.dump({"train": train_ex, "dev": dev_ex}, f)
    rc_train, rc_dev = split_rc(train_ex)
    res["n_train"], res["n_rc_dev"], res["n_dev"] = (
        len(rc_train), len(rc_dev), len(dev_ex))
    print(f"QA: {len(rc_train)} train / {len(rc_dev)} rc-dev / "
          f"{len(dev_ex)} dev (document-held-out)", flush=True)

    pretrained = os.path.abspath(args.pretrained)
    res["pretrained_dir"] = pretrained

    # ---- phase 1: RC training with checkpoint selection
    enc_dir = os.path.join(args.workdir, "encoder")
    if os.path.exists(os.path.join(enc_dir, "config.json")):
        params, config, tok = load_encoder(enc_dir, device=device)
    else:
        params, config, tok = load_encoder(pretrained, device=device)
        res["rc_train"] = train_rc_selected(
            params, config, tok, rc_train, rc_dev, steps=args.steps,
            batch=args.batch, lr=args.lr, seq=args.seq,
            pre_batch=args.pre_batch, eval_every=args.eval_every,
            patience=args.patience, device=device)
        save_encoder(enc_dir, params, config, tok)
        params, config, tok = load_encoder(enc_dir, device=device)

    # ---- phase 2: per-scale dump + eval
    corpora = nested_corpora(dev_docs, train_docs, scales)
    res.setdefault("scales", {})
    dp_largest = None
    for target, corpus in zip(scales, corpora):
        key = f"pars{target}"
        store, dump_s = dump_scale(
            params, config, tok, corpus,
            os.path.join(args.workdir, f"store_{key}"), seq=args.seq,
            dump_batch=args.dump_batch)
        dp = DensePhrases(params, config, tok, MIPS(store, device=device),
                          max_query_length=24)
        if target == scales[-1]:
            dp_largest = dp
        cached = res["scales"].get(key)
        if cached and "dev" in cached:
            continue
        row = {"n_docs": len(corpus),
               "n_paragraphs": sum(len(d["paragraphs"]) for d in corpus),
               "n_vecs": int(store.n_vecs), "dump_s": dump_s,
               "dev": _metrics(dp, dev_ex)}
        res["scales"][key] = row
        print(f"[{key}] {row['n_vecs']} vecs dev {row['dev']}", flush=True)
        _bench.write_json(out, res)

    # ---- phase 3: query-FT at the largest scale
    if args.qft_epochs > 0 and dp_largest is not None and "qft" not in res:
        key = f"pars{scales[-1]}"
        base = res["scales"][key]["dev"]
        # train a copy: the RC encoder's store and save stay as they were
        dp_largest.params = copy.deepcopy(dp_largest.params)
        qft = query_ft(dp_largest, rc_train, dev_ex, epochs=args.qft_epochs,
                       pairs=args.qft_pairs, top_k=args.qft_topk,
                       lr=args.qft_lr, batch=args.qft_batch)
        qft["scale"] = key
        qft["em1_delta"] = qft["dev"]["em_top1"] - base["em_top1"]
        qft["em10_delta"] = qft["dev"]["em_top10"] - base["em_top10"]
        res["qft"] = qft
        save_encoder(os.path.join(args.workdir, "encoder_qft"),
                     dp_largest.params, config, tok)
    _bench.write_json(out, res)
    print(json.dumps(res)[:2000])
    return res


if __name__ == "__main__":
    main()
