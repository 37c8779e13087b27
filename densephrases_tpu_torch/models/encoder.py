"""Phrase/query encoder towers, the span filter head and the RC loss.

The counterpart of ``densephrases_tpu/models/encoder.py``:

- ``EncoderParams`` holds the three towers (``phrase``, ``query_start``,
  ``query_end``) and the 2-logit ``filter`` head, the reference's params
  dict as one ``nn.Module``; with a teacher it also holds the frozen
  ``cross`` tower and its ``qa_outputs`` head. The towers are BERT
  (``BertConfig``) or, for serving, ModernBERT (``ModernBertConfig``,
  ``models/modernbert.py``), which the JAX package does not have;
- ``embed_phrase``: token-wise start = end = last hidden state of the
  phrase tower, plus the filter logits;
- ``embed_query``: the [CLS] hidden state of each query tower. The
  reference runs the two towers as one vmapped forward; here they run as
  two forwards, which gives the same outputs. Both are inference entry
  points and build no autograd graph;
- ``rc_loss``: the 4-part training objective (encoder.py:135-292): single-
  passage CE, KL distillation from the teacher, in-batch / pre-batch /
  hard-negative CE and the filter BCE, with gradients. With ``axis_name``
  set, the negatives are global across the data-parallel ranks: the gold
  reps and hard negatives are gathered with ``parallel.all_gather_grad``
  and the labels offset by ``rank * B`` (encoder.py:223-243);
- ``init_pre_batch`` / ``pre_batch_update``: the pre-batch ring buffer;
- ``query_loss``: the query-side fine-tuning MML objective
  (encoder.py:313-370) over frozen candidate vectors, with gradients into
  the query towers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from densephrases_tpu_torch.models.bert import BertConfig, BertModel, _param
from densephrases_tpu_torch.models.modernbert import (ModernBertConfig,
                                                      ModernBertModel)
from densephrases_tpu_torch.parallel import all_gather_grad, rank_and_size
from densephrases_tpu_torch.utils.device import resolve_device

TOWERS = ("phrase", "query_start", "query_end")
TEACHER = ("cross", "qa_outputs")
NEG_INF = -1e9
MIN_PROB = 1e-7


class LinearHead(nn.Module):
    """``x @ w + b`` with ``w`` stored [in, out] (the reference's layout)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = _param(d_in, d_out)
        self.b = _param(d_out)

    def forward(self, x):
        return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


TowerConfig = Union[BertConfig, ModernBertConfig]


class EncoderParams(nn.Module):
    def __init__(self, config: TowerConfig, with_teacher: bool = False):
        super().__init__()
        self.config = config
        tower = (ModernBertModel if isinstance(config, ModernBertConfig)
                 else BertModel)
        self.phrase = tower(config)
        self.query_start = tower(config)
        self.query_end = tower(config)
        self.filter = LinearHead(config.hidden_size, 2)
        if with_teacher:
            self.cross = tower(config)
            self.qa_outputs = LinearHead(config.hidden_size, 2)

    @property
    def with_teacher(self) -> bool:
        return hasattr(self, "cross")

    @property
    def device(self) -> torch.device:
        return self.filter.w.device


def init_encoder_params(config: TowerConfig,
                        generator: Optional[torch.Generator] = None,
                        device="cuda", with_teacher: bool = False
                        ) -> EncoderParams:
    """Random fp32 towers. The query towers start as copies of the phrase
    tower (ref: encoder.py:50-52 deepcopy). Drawn on the CPU from
    ``generator`` (seed 0 when None), then moved to ``device``. With a
    teacher, the ``cross`` tower and ``qa_outputs`` head are drawn after
    the rest."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = EncoderParams(config, with_teacher)
    params.phrase.init_weights(generator)
    state = params.phrase.state_dict()
    params.query_start.load_state_dict(state)
    params.query_end.load_state_dict(state)
    heads = [params.filter]
    if with_teacher:
        params.cross.init_weights(generator)
        heads.append(params.qa_outputs)
    with torch.no_grad():
        for head in heads:
            head.w.copy_(torch.randn(head.w.shape, generator=generator)
                         * config.initializer_range)
            head.b.zero_()
    return params.to(device)


def _phrase(params: EncoderParams, input_ids, attention_mask, token_type_ids,
            **kw):
    hidden = params.phrase(input_ids, attention_mask, token_type_ids, **kw)
    flt = params.filter(hidden)
    return hidden, hidden, flt[..., 0], flt[..., 1]


def _query(params: EncoderParams, input_ids, attention_mask, token_type_ids,
           **kw):
    return tuple(tower(input_ids, attention_mask, token_type_ids, **kw)[:, 0, :]
                 for tower in (params.query_start, params.query_end))


@torch.no_grad()
def embed_phrase(params: EncoderParams, input_ids, attention_mask,
                 token_type_ids=None, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (start, end, filter_start_logits, filter_end_logits); start
    and end are the same [B, L, H] fp32 hidden states (ref: encoder.py:92-99)."""
    return _phrase(params, input_ids, attention_mask, token_type_ids,
                   attn_impl=attn_impl, compute_dtype=compute_dtype)


@torch.no_grad()
def embed_query(params: EncoderParams, input_ids, attention_mask,
                token_type_ids=None, attn_impl: str = "auto",
                compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (query_start [B, H], query_end [B, H]): the [CLS] states of
    the two query towers (ref: encoder.py:101-118)."""
    return _query(params, input_ids, attention_mask, token_type_ids,
                  attn_impl=attn_impl, compute_dtype=compute_dtype)


def _masked_ce(logits, labels, valid):
    """CE with a per-example validity mask; mean over valid examples
    (encoder.py:119-124).

    rc_loss passes the ignored index L as a label with valid 0, which the
    reference gathers out of range. What that gives depends on jit there:
    eager ``jnp.take_along_axis`` fills NaN and the loss is NaN, while the
    jitted train step (``make_train_step``) returns the finite loss of the
    other rows; the row's gradient is 0 in both. The port gives the jitted
    step's values: an out-of-range row contributes 0."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.clamp(min=0)
    in_range = labels < logp.shape[-1]
    picked = torch.gather(logp, 1, torch.where(in_range, labels, 0)[:, None])
    picked = torch.where(in_range, picked[:, 0], 0.0)
    losses = -picked * valid
    return losses.sum() / valid.sum().clamp(min=1.0)


@dataclass
class RCLossConfig:
    lambda_kl: float = 0.0
    lambda_neg: float = 0.0
    lambda_flt: float = 0.0
    # the data-parallel axis for global negatives: the default process
    # group's one axis (``parallel.Mesh``); None keeps them local
    axis_name: Optional[str] = None


def rc_loss(params: EncoderParams, config: BertConfig, batch, loss_cfg:
            RCLossConfig, pre_batch=None, deterministic: bool = False,
            dropout: Optional[torch.Generator] = None, attn_impl: str = "auto",
            remat: str = "full", compute_dtype: torch.dtype = torch.bfloat16):
    """The full RC training objective (ref: densephrases_tpu rc_loss).

    batch: dict of device tensors, keys as in the reference:
    input_ids/attention_mask/token_type_ids (passage, [B, L]),
    query_input_ids/query_attention_mask/query_token_type_ids ([B, Lq]),
    start_positions/end_positions ([B]; L means "ignored"), optional neg_*
    (hard negative passages), optional cross_* and teacher_gather ([B, L]
    map into cross-encoder positions, -1 = masked).

    pre_batch: optional ``init_pre_batch`` ring of previous gold reps.
    dropout: a CPU generator for the dropout seeds, or None (dropout off,
    as is ``deterministic=True``).

    Returns (total_loss, aux): aux carries the per-part losses, the logits
    and the gold reps (detached) for the pre-batch ring.
    """
    gen = None if deterministic else dropout
    kw = dict(attn_impl=attn_impl, remat=remat, compute_dtype=compute_dtype)
    start, end, f_start, f_end = _phrase(
        params, batch["input_ids"], batch["attention_mask"],
        batch.get("token_type_ids"), dropout=gen, **kw)
    query_start, query_end = _query(
        params, batch["query_input_ids"], batch["query_attention_mask"],
        batch.get("query_token_type_ids"), dropout=gen, **kw)

    b, l, h = start.shape
    ignored_index = l
    start_positions = batch["start_positions"].long().clamp(0, ignored_index)
    end_positions = batch["end_positions"].long().clamp(0, ignored_index)

    start_logits = torch.einsum("blh,bh->bl", start, query_start)
    end_logits = torch.einsum("blh,bh->bl", end, query_end)

    # 1) single-passage loss == CE on the start/end logits
    valid_s = (start_positions < ignored_index).to(torch.float32)
    valid_e = (end_positions < ignored_index).to(torch.float32)
    single_loss = 0.5 * (_masked_ce(start_logits, start_positions, valid_s)
                         + _masked_ce(end_logits, end_positions, valid_e))
    total = single_loss
    aux = {"single_loss": single_loss}

    # 2) KL distillation; the teacher tower runs without grad (its head
    # does get a gradient, as in the reference, which the train step drops)
    if loss_cfg.lambda_kl > 0 and "cross_input_ids" in batch:
        with torch.no_grad():
            t_hidden = params.cross(
                batch["cross_input_ids"], batch["cross_attention_mask"],
                batch.get("cross_token_type_ids"), attn_impl=attn_impl,
                compute_dtype=compute_dtype)
        t_logits = params.qa_outputs(t_hidden)
        gmap = batch["teacher_gather"].long()
        gclip = gmap.clamp(min=0)
        tmask = gmap >= 0
        ts = torch.where(tmask, torch.gather(t_logits[..., 0], 1, gclip), -1e4)
        te = torch.where(tmask, torch.gather(t_logits[..., 1], 1, gclip), -1e4)
        tgt_s = torch.softmax(ts.to(torch.float32), dim=1)
        tgt_e = torch.softmax(te.to(torch.float32), dim=1)
        logp_s = torch.log_softmax(start_logits.to(torch.float32), dim=1)
        logp_e = torch.log_softmax(end_logits.to(torch.float32), dim=1)
        kl_s = (tgt_s * (torch.log(tgt_s.clamp(min=MIN_PROB)) - logp_s)
                ).sum(1).mean()
        kl_e = (tgt_e * (torch.log(tgt_e.clamp(min=MIN_PROB)) - logp_e)
                ).sum(1).mean()
        kl_loss = 0.5 * (kl_s + kl_e)
        total = total + loss_cfg.lambda_kl * kl_loss
        aux["kl_loss"] = kl_loss

    # gold phrase reps for the negatives and the ring
    gold_pos_s = torch.where(start_positions > 0, start_positions,
                             0).clamp(0, l - 1)
    gold_pos_e = torch.where(end_positions > 0, end_positions, 0).clamp(0, l - 1)
    rows = torch.arange(b, device=start.device)
    gold_start = start[rows, gold_pos_s]
    gold_end = end[rows, gold_pos_e]
    aux["gold_start"] = gold_start.detach()
    aux["gold_end"] = gold_end.detach()

    # 3) in-batch / hard / pre-batch negatives
    if loss_cfg.lambda_neg > 0:
        all_gold_start, all_gold_end, label_offset = gold_start, gold_end, 0
        if loss_cfg.axis_name is not None:
            # the global batch's golds from every rank
            rank, _ = rank_and_size()
            all_gold_start = all_gather_grad(gold_start)
            all_gold_end = all_gather_grad(gold_end)
            label_offset = rank * b
        inb_start_logits = query_start @ all_gold_start.T  # [B, B * ranks]
        inb_end_logits = query_end @ all_gold_end.T
        if "neg_input_ids" in batch:
            neg_start, neg_end, _, _ = _phrase(
                params, batch["neg_input_ids"], batch["neg_attention_mask"],
                batch.get("neg_token_type_ids"), dropout=gen, **kw)
            if loss_cfg.axis_name is not None:
                neg_start = all_gather_grad(neg_start)
                neg_end = all_gather_grad(neg_end)
            neg_s = torch.einsum("bh,nlh->bnl", query_start, neg_start).amax(-1)
            neg_e = torch.einsum("bh,nlh->bnl", query_end, neg_end).amax(-1)
            inb_start_logits = torch.cat([inb_start_logits, neg_s], 1)
            inb_end_logits = torch.cat([inb_end_logits, neg_e], 1)
        if pre_batch is not None and pre_batch["start"].shape[0] > 0:
            p, pb, _ = pre_batch["start"].shape
            pre_s = pre_batch["start"].reshape(p * pb, h)
            pre_e = pre_batch["end"].reshape(p * pb, h)
            slot_valid = (torch.arange(p, device=start.device)
                          < pre_batch["count"]).repeat_interleave(pb)
            pinb_s = torch.where(slot_valid[None], query_start @ pre_s.T, NEG_INF)
            pinb_e = torch.where(slot_valid[None], query_end @ pre_e.T, NEG_INF)
            inb_start_logits = torch.cat([inb_start_logits, pinb_s], 1)
            inb_end_logits = torch.cat([inb_end_logits, pinb_e], 1)
        ones = torch.ones(b, device=start.device)
        labels = rows + label_offset
        neg_loss = 0.5 * (_masked_ce(inb_start_logits, labels, ones)
                          + _masked_ce(inb_end_logits, labels, ones))
        total = total + loss_cfg.lambda_neg * neg_loss
        aux["neg_loss"] = neg_loss

    # 4) filter BCE with pos_weight = L
    if loss_cfg.lambda_flt > 0:
        pos = torch.arange(l, device=start.device)[None]
        s1h = ((start_positions[:, None] == pos) & (valid_s[:, None] > 0)
               ).to(torch.float32)
        e1h = ((end_positions[:, None] == pos) & (valid_e[:, None] > 0)
               ).to(torch.float32)

        def bce(logits, tgt):
            zf = logits.to(torch.float32)
            return (-(float(l) * tgt * F.logsigmoid(zf)
                      + (1.0 - tgt) * F.logsigmoid(-zf))).mean(1)

        flt = 0.5 * bce(f_start, s1h) + 0.5 * bce(f_end, e1h)
        ans_mask = (batch["start_positions"] > 0).to(torch.float32)
        flt_loss = (flt * ans_mask).sum() / (ans_mask.sum() + 1e-9)
        total = total + loss_cfg.lambda_flt * flt_loss
        aux["filter_loss"] = flt_loss

    aux["start_logits"] = start_logits
    aux["end_logits"] = end_logits
    aux["filter_start_logits"] = f_start
    aux["filter_end_logits"] = f_end
    return total, aux


def init_pre_batch(pbn_size: int, batch_size: int, hidden: int, *, device):
    """The empty ring: ``pbn_size`` slots of [batch_size, hidden] gold reps
    and a host-side count of the pushes so far."""
    device = resolve_device(device)
    return {"start": torch.zeros(pbn_size, batch_size, hidden, device=device),
            "end": torch.zeros(pbn_size, batch_size, hidden, device=device),
            "count": 0}


def pre_batch_update(pre_batch, gold_start, gold_end):
    """Push this step's gold reps into the ring (ref: encoder.py:295-302).
    Returns a new ring; the old one is left as it was."""
    p = pre_batch["start"].shape[0]
    idx = pre_batch["count"] % p
    new_start = pre_batch["start"].clone()
    new_end = pre_batch["end"].clone()
    new_start[idx] = gold_start.detach()
    new_end[idx] = gold_end.detach()
    return {"start": new_start, "end": new_end, "count": pre_batch["count"] + 1}


def _mml(logits, target_mask):
    """-log(sum of the softmax probabilities at the targets), the sum
    clipped to [MIN_PROB, 1] (encoder.py:313-317)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    p = (probs * target_mask).sum(-1)
    return -torch.log(p.clamp(MIN_PROB, 1.0))


def _masked_mean(x, m):
    mf = m.to(torch.float32)
    return (x * mf).sum() / mf.sum().clamp(min=1.0)


def query_loss(params: EncoderParams, config: BertConfig, query_input_ids,
               query_attention_mask, start_vecs, end_vecs, targets, p_targets,
               cand_mask=None, query_token_type_ids=None,
               deterministic: bool = False, *, dropout=None,
               attn_impl: str = "auto", remat: str = "full",
               compute_dtype: torch.dtype = torch.bfloat16):
    """The query-side fine-tuning objective (ref: densephrases_tpu
    query_loss, encoder.py:320-370), with gradients into the query towers.

    start_vecs / end_vecs: [B, C, H] frozen phrase vectors from the index;
    targets / p_targets: [B, C] phrase-level / doc-level gold masks;
    cand_mask: [B, C], False for padded candidates (their logits become
    -1e9). The phrase term (joint + start + end MML over the rows with a
    phrase target) counts only when some row has one, the doc term (start +
    end MML with the phrase targets suppressed by -1e9) only when some row
    has a doc target. dropout: as in ``rc_loss``.

    Returns (loss, top1 [B] bool): whether the argmax candidate (the first
    on ties) is a phrase target."""
    gen = None if deterministic else dropout
    query_start, query_end = _query(
        params, query_input_ids, query_attention_mask, query_token_type_ids,
        dropout=gen, attn_impl=attn_impl, remat=remat,
        compute_dtype=compute_dtype)
    start_logits = torch.einsum("bh,bch->bc", query_start, start_vecs)
    end_logits = torch.einsum("bh,bch->bc", query_end, end_vecs)
    if cand_mask is not None:
        start_logits = torch.where(cand_mask, start_logits, NEG_INF)
        end_logits = torch.where(cand_mask, end_logits, NEG_INF)
    logits = start_logits + end_logits

    targets = targets.to(torch.float32)
    p_targets = p_targets.to(torch.float32)
    has_t = targets.sum(-1) > 0
    has_pt = p_targets.sum(-1) > 0

    # phrase term: joint + start-only + end-only MML (ref: encoder.py:391-407)
    loss_t = (_masked_mean(_mml(logits, targets), has_t)
              + _masked_mean(_mml(start_logits, targets), has_t)
              + _masked_mean(_mml(end_logits, targets), has_t))
    # doc term with the phrase targets suppressed (ref: encoder.py:409-425)
    sup = torch.where(targets > 0, NEG_INF, 0.0)
    loss_pt = (_masked_mean(_mml(start_logits + sup, p_targets), has_pt)
               + _masked_mean(_mml(end_logits + sup, p_targets), has_pt))
    loss = (has_t.any().to(torch.float32) * loss_t
            + has_pt.any().to(torch.float32) * loss_pt)

    top1 = torch.gather(targets, 1, logits.argmax(-1)[:, None])[:, 0] > 0
    return loss, top1


class PhraseEncoder:
    """Holds (config, params) and mirrors the reference ``Encoder`` surface
    (ref: encoder.py:17-118). Exported as ``Encoder``, it is an entry point:
    fresh towers go to ``device``, the card unless the caller asks for the
    CPU. Given ``params`` stay where they are."""

    def __init__(self, config: BertConfig, params: Optional[EncoderParams] = None,
                 generator: Optional[torch.Generator] = None,
                 with_teacher: bool = False, *, device="cuda"):
        self.config = config
        if params is None:
            params = init_encoder_params(config, generator, device=device,
                                         with_teacher=with_teacher)
        self.params = params

    def embed_phrase(self, input_ids, attention_mask, token_type_ids=None, **kw):
        return embed_phrase(self.params, input_ids, attention_mask,
                            token_type_ids, **kw)

    def embed_query(self, input_ids, attention_mask, token_type_ids=None, **kw):
        return embed_query(self.params, input_ids, attention_mask,
                           token_type_ids, **kw)
