"""Query-side fine-tuning: train the query towers against a frozen index,
with retrieval in the training loop.

The counterpart of ``densephrases_tpu/train/query.py`` (ref
train_query.py:34-275):

- a frozen copy of the query towers (``QueryTowers``) embeds each question
  batch and searches the index with ``vecs_on_device=True``: the candidate
  phrase vectors stay on the device as [B, 2K, D] tensors and each result
  dict carries its column ``cand_col``;
- the host annotates the candidates (``annotate_candidate_cols``): phrase
  targets by EM / regex answer match, doc targets by title or answer-in-
  context match, as [B, C] masks;
- the train step gathers the annotated columns on the device and optimizes
  the two query towers whole, word embeddings included, with the MML
  objective (``models/encoder.query_loss``); the phrase tower and the
  filter get no gradient;
- the searcher copy is refreshed every ``update_freq`` epochs and the best
  towers by dev ``em_top1`` (strict ``>``) are kept.

The optimizer is the reference's plain ``optax.adamw`` (no clipping, weight
decay 0.01 on every parameter) with a warmup of ``max(int(total ·
warmup_ratio), 1)`` steps and then a linear decay over ``total`` steps,
``total = epochs · (len // batch + 1)``. A batch with neither a phrase nor a
doc target is skipped without a step. Torch modules are mutable, so the
towers train in place in ``model.params``, and "set the model's params"
means swapping modules: ``model.params`` is the searcher during the search
and the trained encoder otherwise.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from densephrases_tpu_torch.data.features import convert_questions_to_features
from densephrases_tpu_torch.eval.metrics import (
    drqa_exact_match_score,
    drqa_metric_max_over_ground_truths,
    drqa_regex_match_score,
    normalize_answer,
)
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import query_loss
from densephrases_tpu_torch.train.rc import (
    AdamW,
    decay_all,
    warmup_linear_decay_schedule,
)

logger = logging.getLogger(__name__)

QUERY_TOWERS = ("query_start", "query_end")


@dataclass
class QueryFTConfig:
    top_k: int = 100
    learning_rate: float = 3e-5
    epochs: int = 3
    regex: bool = False
    label_strat: str = "phrase,doc"  # ref: options.py:177-187
    update_freq: int = 1  # epochs between frozen-tower refreshes
    max_answer_length: int = 10
    warmup_ratio: float = 0.1


class QueryTowers(nn.Module):
    """The two query towers alone: what the frozen searcher needs
    (``embed_query`` reads only these, ``DensePhrases`` their device)."""

    def __init__(self, query_start: nn.Module, query_end: nn.Module):
        super().__init__()
        self.query_start = query_start
        self.query_end = query_end

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def copy_query_towers(params) -> QueryTowers:
    """A detached copy of ``params``' query towers."""
    return QueryTowers(copy.deepcopy(params.query_start),
                       copy.deepcopy(params.query_end)).requires_grad_(False)


def _match(r: dict, golds, gold_titles, match_fn):
    """(phrase target, doc target) of one candidate."""
    target = bool(golds) and bool(drqa_metric_max_over_ground_truths(
        match_fn, r["answer"], golds))
    p_target = False
    if gold_titles is not None and r.get("title"):
        p_target = any(normalize_answer(t) in gold_titles for t in r["title"])
    elif golds:
        # doc-level positive: the answer appears in the candidate's context
        p_target = any(normalize_answer(g) in normalize_answer(r["context"])
                       for g in golds)
    return target, p_target


def annotate_candidates(results: List[List[dict]], answers: List[List[str]],
                        titles: Optional[List[List[str]]] = None,
                        regex: bool = False, n_cands: int = 200):
    """[B, C] target masks from search results with their vectors attached
    (``return_idxs=True``; ref: train_query.py:208-275).

    Returns (start_vecs, end_vecs, targets, p_targets, cand_mask), numpy
    arrays padded to ``n_cands`` candidates."""
    match_fn = drqa_regex_match_score if regex else drqa_exact_match_score
    b = len(results)
    dim = next((len(r["start_vec"]) for ret in results for r in ret
                if r.get("start_vec") is not None), None)
    assert dim is not None, "search must be called with return_idxs=True"

    start_vecs = np.zeros((b, n_cands, dim), np.float32)
    end_vecs = np.zeros((b, n_cands, dim), np.float32)
    targets = np.zeros((b, n_cands), bool)
    p_targets = np.zeros((b, n_cands), bool)
    cand_mask = np.zeros((b, n_cands), bool)
    for bi, ret in enumerate(results):
        golds = answers[bi]
        gold_titles = ([normalize_answer(t) for t in titles[bi]]
                       if titles is not None else None)
        for ci, r in enumerate(ret[:n_cands]):
            if r.get("start_vec") is None:
                continue
            start_vecs[bi, ci] = r["start_vec"]
            end_vecs[bi, ci] = r["end_vec"]
            cand_mask[bi, ci] = True
            targets[bi, ci], p_targets[bi, ci] = _match(r, golds, gold_titles,
                                                        match_fn)
    return start_vecs, end_vecs, targets, p_targets, cand_mask


def annotate_candidate_cols(results: List[List[dict]],
                            answers: List[List[str]],
                            titles: Optional[List[List[str]]] = None,
                            regex: bool = False, n_cands: int = 200):
    """``annotate_candidates`` for the ``vecs_on_device`` search: no
    vectors, each result's ``cand_col`` instead. Returns (cand_cols,
    targets, p_targets, cand_mask), all [B, n_cands] numpy arrays."""
    match_fn = drqa_regex_match_score if regex else drqa_exact_match_score
    b = len(results)
    cand_cols = np.zeros((b, n_cands), np.int32)
    targets = np.zeros((b, n_cands), bool)
    p_targets = np.zeros((b, n_cands), bool)
    cand_mask = np.zeros((b, n_cands), bool)
    for bi, ret in enumerate(results):
        golds = answers[bi]
        gold_titles = ([normalize_answer(t) for t in titles[bi]]
                       if titles is not None else None)
        for ci, r in enumerate(ret[:n_cands]):
            cand_cols[bi, ci] = r["cand_col"]
            cand_mask[bi, ci] = True
            targets[bi, ci], p_targets[bi, ci] = _match(r, golds, gold_titles,
                                                        match_fn)
    return cand_cols, targets, p_targets, cand_mask


def query_named(params) -> dict:
    """The query towers' parameters by the port's name: what query-side
    fine-tuning trains."""
    return {n: p for n, p in params.named_parameters()
            if n.split(".")[0] in QUERY_TOWERS}


def make_query_optimizer(learning_rate: float, total_steps: int,
                         warmup_ratio: float) -> AdamW:
    """The reference's ``optax.adamw(..., weight_decay=0.01)`` with its
    warmup-then-decay schedule (train/query.py:214-221)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    return AdamW(warmup_linear_decay_schedule(learning_rate, warmup,
                                              total_steps),
                 weight_decay=0.01, max_grad_norm=None, decayed=decay_all)


def make_query_train_step(config: BertConfig, optimizer: AdamW,
                          label_strat: str, attn_impl: str = "auto", *,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """The train step ``step(params, opt_state, batch, dropout) -> (loss,
    top1)``: one ``query_loss`` and one optimizer update of the query
    towers, in place. ``batch`` holds device tensors: query_input_ids,
    query_attention_mask, start_vecs / end_vecs ([B, C, D], or the raw
    [B, 2K, D] search outputs with ``cand_cols`` [B, C] to gather on the
    device), targets, p_targets, cand_mask. ``dropout`` as in
    ``query_loss``. Returns 0-dim / [B] device tensors (no host sync)."""
    use_phrase = "phrase" in label_strat
    use_doc = "doc" in label_strat

    def step(params, opt_state, batch, dropout):
        named = query_named(params)
        t = batch["targets"] if use_phrase \
            else torch.zeros_like(batch["targets"])
        pt = batch["p_targets"] if use_doc \
            else torch.zeros_like(batch["p_targets"])
        sv, ev = batch["start_vecs"], batch["end_vecs"]
        if "cand_cols" in batch:
            cols = batch["cand_cols"].long()[..., None].expand(
                -1, -1, sv.shape[-1])
            sv, ev = torch.gather(sv, 1, cols), torch.gather(ev, 1, cols)
        loss, top1 = query_loss(
            params, config, batch["query_input_ids"],
            batch["query_attention_mask"], sv, ev, t, pt,
            cand_mask=batch["cand_mask"], deterministic=False,
            dropout=dropout, attn_impl=attn_impl, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        optimizer.update({n: torch.zeros_like(p) if g is None else g
                          for (n, p), g in zip(named.items(), grads)},
                         opt_state, named)
        return loss.detach(), top1

    return step


def train_query_encoder(
    model,  # DensePhrases facade: its params are trained in place
    qa_pairs: Sequence[Tuple[str, List[str]]],
    cfg: QueryFTConfig,
    batch_size: int = 12,
    dev_pairs: Optional[Sequence[Tuple[str, List[str]]]] = None,
    eval_top_k: int = 10,
    seed: int = 0,
    rng_impl: str = "rbg",
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """The driver loop (ref: train_query.py:34-179). Returns (the kept
    query towers as ``QueryTowers``, history).

    ``model`` gives ``query2vec`` / ``mips`` / ``params`` / ``config`` /
    ``tokenizer``; its params (an ``EncoderParams``) train in place, and at
    the end hold the kept towers: the best by dev ``em_top1`` with dev
    pairs, else the last. Dropout seeds come from a CPU generator seeded
    with ``seed``; ``rng_impl`` is accepted and has no effect.
    history: per epoch ``loss`` and ``top1`` (means over the stepped
    batches, 0.0 without any), ``dev_em``; and per epoch ``steps`` and
    ``skipped`` (batches without a target)."""
    config = model.config
    trained = model.params
    n_cands = cfg.top_k * 2
    total_steps = max(1, cfg.epochs * (len(qa_pairs) // max(batch_size, 1) + 1))
    optimizer = make_query_optimizer(cfg.learning_rate, total_steps,
                                     cfg.warmup_ratio)
    opt_state = optimizer.init(query_named(trained))
    step_fn = make_query_train_step(config, optimizer, cfg.label_strat,
                                    compute_dtype=compute_dtype)
    dropout = torch.Generator().manual_seed(seed)
    searcher = copy_query_towers(trained)  # refreshed every update_freq
    history = {"loss": [], "top1": [], "dev_em": [], "steps": [],
               "skipped": []}
    best_em = -1.0
    best = None
    dev = trained.device

    questions = [q for q, _ in qa_pairs]
    answers = [a for _, a in qa_pairs]
    try:
        for epoch in range(cfg.epochs):
            order = np.random.default_rng(seed + epoch).permutation(
                len(questions))
            ep_losses, ep_top1, skipped = [], [], 0
            for b0 in range(0, len(order), batch_size):
                idx = order[b0: b0 + batch_size]
                qs = [questions[i] for i in idx]
                golds = [answers[i] for i in idx]

                # retrieve with the frozen towers (ref: get_top_phrases);
                # the candidate vectors stay on the device
                model.params = searcher
                qvec = model.query2vec(qs)
                results, (sv_dev, ev_dev) = model.mips.search(
                    qvec, q_texts=qs, top_k=cfg.top_k, vecs_on_device=True,
                    max_answer_length=cfg.max_answer_length)
                model.params = trained
                cols, t, pt, cm = annotate_candidate_cols(
                    results, golds, regex=cfg.regex, n_cands=n_cands)
                if not t.any() and not pt.any():
                    skipped += 1
                    continue  # ref skips batches with no targets

                feats = convert_questions_to_features(
                    qs, model.tokenizer, model.max_query_length)
                batch = {
                    "query_input_ids": np.stack([f.input_ids for f in feats]),
                    "query_attention_mask": np.stack(
                        [f.attention_mask for f in feats]),
                    "cand_cols": cols, "targets": t, "p_targets": pt,
                    "cand_mask": cm}
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                batch["start_vecs"], batch["end_vecs"] = sv_dev, ev_dev
                loss, top1 = step_fn(trained, opt_state, batch, dropout)
                ep_losses.append(float(loss))
                ep_top1.append(float(top1.float().mean()))

            history["loss"].append(float(np.mean(ep_losses))
                                   if ep_losses else 0.0)
            history["top1"].append(float(np.mean(ep_top1))
                                   if ep_top1 else 0.0)
            history["steps"].append(len(ep_losses))
            history["skipped"].append(skipped)
            logger.info("qsft epoch %d: loss=%.4f top1=%.3f (%d steps, %d "
                        "skipped)", epoch, history["loss"][-1],
                        history["top1"][-1], len(ep_losses), skipped)

            # dev eval with the trained towers; keep the best
            if dev_pairs is not None:
                em = model.evaluate(list(dev_pairs), top_k=eval_top_k,
                                    regex=cfg.regex)["em_top1"]
                history["dev_em"].append(em)
                if em > best_em:
                    best_em = em
                    best = copy_query_towers(trained)

            # refresh the frozen searcher (ref: train_query.py:174-176)
            if (epoch + 1) % cfg.update_freq == 0:
                searcher = copy_query_towers(trained)
    finally:
        model.params = trained

    if best is not None:
        with torch.no_grad():
            for name in QUERY_TOWERS:
                getattr(trained, name).load_state_dict(
                    getattr(best, name).state_dict())
    return copy_query_towers(trained), history
