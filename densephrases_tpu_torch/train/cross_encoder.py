"""Cross-encoder (distillation teacher) parameters and training.

The counterpart of ``densephrases_tpu/train/cross_encoder.py`` (ref
train_cross_encoder.py): SQuAD fine-tuning of one BERT tower over merged
question + passage inputs (``cross``) with a 2-logit QA head
(``qa_outputs``). For RC distillation the trained pair joins the student's
``EncoderParams`` as its frozen teacher (``cli/train_rc.py --teacher_dir``).

The inputs are the RC collation's merged cross-encoder features
(``data/rc_dataset.py``), the answer positions mapped into cross
coordinates by ``teacher_gather`` (``cross_positions``). The loss is the
mean over the batch of (start CE + end CE) / 2 over the cross length, the
padding masked by -1e9 before the log-softmax. The optimizer is the
reference's plain ``optax.adamw`` (no clipping, weight decay 0.01 on every
parameter), warmup ``max(steps // 10, 1)`` then a linear decay over
``steps = epochs · (len // batch)``; batches come from
``data/rc_dataset.batches(feats, batch, seed=seed + epoch)``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

from densephrases_tpu_torch.models.bert import BertConfig, BertModel
from densephrases_tpu_torch.models.encoder import LinearHead
from densephrases_tpu_torch.train.rc import (
    AdamW,
    decay_all,
    warmup_linear_decay_schedule,
)
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

CROSS_KEYS = ("cross_input_ids", "cross_attention_mask",
              "cross_token_type_ids")


class CrossParams(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.cross = BertModel(config)
        self.qa_outputs = LinearHead(config.hidden_size, 2)


def init_cross_params(config: BertConfig,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> CrossParams:
    """A random fp32 teacher, drawn on the CPU from ``generator`` (seed 0
    when None), then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = CrossParams(config)
    params.cross.init_weights(generator)
    with torch.no_grad():
        params.qa_outputs.w.copy_(torch.randn(
            params.qa_outputs.w.shape, generator=generator)
            * config.initializer_range)
        params.qa_outputs.b.zero_()
    return params.to(device)


def cross_positions(batch) -> tuple:
    """Passage-coordinate answer positions → cross coordinates through
    ``teacher_gather`` (host side, numpy); 0 where unmapped."""
    g = batch["teacher_gather"]  # [B, L]
    sp = batch["start_positions"]
    ep = batch["end_positions"]
    b = len(sp)
    cs = np.zeros(b, np.int32)
    ce = np.zeros(b, np.int32)
    for i in range(b):
        cs[i] = g[i, sp[i]] if sp[i] < g.shape[1] and g[i, sp[i]] >= 0 else 0
        ce[i] = g[i, ep[i]] if ep[i] < g.shape[1] and g[i, ep[i]] >= 0 else 0
    return cs, ce


def cross_loss(params: CrossParams, config: BertConfig, batch, dropout=None,
               attn_impl: str = "auto", *, remat: str = "full",
               compute_dtype: torch.dtype = torch.bfloat16):
    """The teacher's SQuAD loss on one batch of device tensors (the cross_*
    inputs and cross_start_positions / cross_end_positions). dropout: as in
    ``BertModel.forward``."""
    hidden = params.cross(batch["cross_input_ids"],
                          batch["cross_attention_mask"],
                          batch["cross_token_type_ids"], attn_impl=attn_impl,
                          compute_dtype=compute_dtype, dropout=dropout,
                          remat=remat)
    logits = params.qa_outputs(hidden)
    neg = (1.0 - batch["cross_attention_mask"].to(torch.float32)) * -1e9
    s_logp = torch.log_softmax(logits[..., 0] + neg, dim=-1)
    e_logp = torch.log_softmax(logits[..., 1] + neg, dim=-1)
    sp = batch["cross_start_positions"].long()[:, None]
    ep = batch["cross_end_positions"].long()[:, None]
    return -(torch.gather(s_logp, 1, sp)[:, 0]
             + torch.gather(e_logp, 1, ep)[:, 0]).mean() / 2


def make_cross_optimizer(lr: float, steps: int) -> AdamW:
    """The reference's teacher optimizer (train/cross_encoder.py:101-106)."""
    warmup = max(steps // 10, 1)
    return AdamW(warmup_linear_decay_schedule(lr, warmup, steps),
                 weight_decay=0.01, max_grad_norm=None, decayed=decay_all)


def make_cross_train_step(config: BertConfig, optimizer: AdamW,
                          attn_impl: str = "auto", *, remat: str = "full",
                          compute_dtype: torch.dtype = torch.bfloat16):
    """The train step ``step(params, opt_state, batch, dropout) -> loss``:
    one ``cross_loss`` and one in-place update of every teacher parameter.
    Returns the loss as a 0-dim device tensor."""

    def step(params: CrossParams, opt_state, batch, dropout):
        named = dict(params.named_parameters())
        loss = cross_loss(params, config, batch, dropout, attn_impl,
                          remat=remat, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, list(named.values()))
        optimizer.update(dict(zip(named, grads)), opt_state, named)
        return loss.detach()

    return step


def train_cross_encoder(config: BertConfig, feats, epochs: int = 2,
                        batch_size: int = 8, lr: float = 3e-5, seed: int = 0,
                        attn_impl: str = "auto", params=None,
                        rng_impl: str = "rbg", *, device="cuda",
                        remat: str = "full",
                        compute_dtype: torch.dtype = torch.bfloat16):
    """Train the teacher on RC features built with ``with_teacher=True``.
    Returns (params, losses): a ``CrossParams`` on ``device`` (``params``,
    trained in place, or a fresh ``init_cross_params`` from ``seed``) and
    the loss of every step. Dropout seeds come from a CPU generator seeded
    with ``seed``; ``rng_impl`` is accepted and has no effect."""
    from densephrases_tpu_torch.data.rc_dataset import batches

    device = resolve_device(device)
    if params is None:
        params = init_cross_params(config, torch.Generator().manual_seed(seed),
                                   device=device)
    elif params.qa_outputs.w.device != device:
        raise ValueError(f"params on {params.qa_outputs.w.device}, "
                         f"device {device}")
    steps = max(1, epochs * (len(feats) // batch_size))
    optimizer = make_cross_optimizer(lr, steps)
    opt_state = optimizer.init(dict(params.named_parameters()))
    step_fn = make_cross_train_step(config, optimizer, attn_impl,
                                    remat=remat, compute_dtype=compute_dtype)
    dropout = torch.Generator().manual_seed(seed)

    losses = []
    for epoch in range(epochs):
        for batch in batches(feats, batch_size, seed=seed + epoch):
            cs, ce = cross_positions(batch)
            dev_batch = {k: torch.as_tensor(batch[k], device=device)
                         for k in CROSS_KEYS}
            dev_batch["cross_start_positions"] = torch.as_tensor(cs,
                                                                 device=device)
            dev_batch["cross_end_positions"] = torch.as_tensor(ce,
                                                               device=device)
            losses.append(float(step_fn(params, opt_state, dev_batch,
                                        dropout)))
        logger.info("cross-encoder epoch %d: loss=%.4f", epoch,
                    float(np.mean(losses[-10:])) if losses else float("nan"))
    return params, losses
