"""Masked-LM pretraining: the offline stand-in for a hub checkpoint.

The counterpart of ``densephrases_tpu/train/mlm.py``: a BERT masked-LM
pretraining stage over offline text whose backbone then initializes the
three DensePhrases towers, as the reference copies SpanBERT into them
(ref: densephrases/encoder.py:20-52).

- Corruption: 15% of the non-special tokens are predicted (a uint8 draw
  ``u_pos < 38``, 38 = round(0.15 · 256)); of those, a second uint8 draw
  ``u_act`` picks [MASK] below 204, a random id in [N_SPECIAL, vocab) below
  230, else the token is kept. The draws come from a torch generator on
  the device (``mlm_draws``); ``mlm_loss`` takes them as tensors, so a test
  can feed it the reference's.
- The head: a bf16 dense layer with its bias, exact (erf) GELU in fp32, an
  fp32 layer norm, then the decoder tied to the word embedding (bf16
  inputs, fp32 products and sums, so fp32 logits) plus ``out_bias``; the
  log-softmax in fp32. The loss and accuracy count the predicted positions
  only, over ``max(n, 1)``.
- The optimizer: ``clip_by_global_norm(1.0)`` then AdamW with no decay
  where the last path key holds ``ln_`` or ends in ``_b`` or ``bias``
  (``mlm_decayed``), warmup ``max(steps // 20, 10)`` then a linear decay
  over ``steps − warmup``.
- Sequences are fixed-shape packed chunks (``pack_chunks``).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from densephrases_tpu_torch.models.bert import BertConfig, BertModel, _param
from densephrases_tpu_torch.models.encoder import EncoderParams
from densephrases_tpu_torch.train.rc import AdamW, linear_warmup_schedule
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

MASK_RATE = 0.15
N_SPECIAL = 5  # [PAD] [UNK] [CLS] [SEP] [MASK]: never masked, never sampled
POS_THRESHOLD = int(round(MASK_RATE * 256))  # 38
MASK_BELOW, RANDOM_BELOW = 204, 230  # 80% [MASK], 10% random, 10% kept


class MLMHead(nn.Module):
    """The transform (dense + GELU + layer norm) and the output bias; the
    decoder weight is the backbone's word embedding."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        self.dense_w, self.dense_b = _param(h, h), _param(h)
        self.ln_scale, self.ln_bias = _param(h), _param(h)
        self.out_bias = _param(config.vocab_size)


class MLMParams(nn.Module):
    """The reference's ``{"bert": tower, "mlm": head}`` tree as a module."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)
        self.mlm = MLMHead(config)

    @property
    def device(self) -> torch.device:
        return self.mlm.out_bias.device


def init_mlm_params(config: BertConfig,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> MLMParams:
    """Backbone + MLM head, fp32, drawn on the CPU from ``generator`` (seed
    0 when None; the backbone first, then the dense weight), then moved to
    ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = MLMParams(config)
    params.bert.init_weights(generator)
    with torch.no_grad():
        params.mlm.dense_w.copy_(torch.randn(
            params.mlm.dense_w.shape, generator=generator)
            * config.initializer_range)
        params.mlm.ln_scale.fill_(1.0)
    return params.to(device)


def encoder_params_from_backbone(backbone: BertModel, config: BertConfig,
                                 generator: Optional[torch.Generator] = None
                                 ) -> EncoderParams:
    """DensePhrases towers from a pretrained backbone: the phrase and both
    query towers start as copies of it (ref: encoder.py:50-52), the filter
    head fresh, drawn on the CPU from ``generator`` (seed 0 when None). On
    the backbone's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = EncoderParams(config)
    state = backbone.state_dict()
    for tower in ("phrase", "query_start", "query_end"):
        getattr(params, tower).load_state_dict(state)
    with torch.no_grad():
        params.filter.w.copy_(torch.randn(params.filter.w.shape,
                                          generator=generator)
                              * config.initializer_range)
        params.filter.b.zero_()
    return params.to(next(backbone.parameters()).device)


def mlm_draws(shape, vocab_size: int, generator: torch.Generator):
    """The corruption draws of one batch on the generator's device:
    (u_pos uint8, u_act uint8, random ids int64 in [N_SPECIAL, vocab))."""
    dev = generator.device
    u_pos = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=generator)
    u_act = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=generator)
    rand_ids = torch.randint(N_SPECIAL, vocab_size, shape, device=dev,
                             generator=generator)
    return u_pos, u_act, rand_ids


def _layer_norm_f32(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def mlm_loss(params: MLMParams, config: BertConfig, input_ids,
             attention_mask, draws, *, mask_token_id: int,
             deterministic: bool = False, dropout=None,
             attn_impl: str = "auto", remat: str = "full",
             compute_dtype: torch.dtype = torch.bfloat16):
    """Corruption + forward + masked CE (ref: densephrases_tpu mlm_loss).

    draws: (u_pos, u_act, rand_ids) [B, L] tensors on the params' device
    (``mlm_draws``); dropout: as in ``BertModel.forward`` (ignored when
    ``deterministic``). Returns (loss, metrics): ``loss``, ``acc`` (top-1
    over the predicted positions) and ``n_pred``."""
    u_pos, u_act, rand_ids = draws
    input_ids = input_ids.long()
    maskable = (attention_mask > 0) & (input_ids >= N_SPECIAL)
    is_pred = maskable & (u_pos < POS_THRESHOLD)
    corrupted = torch.where(
        u_act < MASK_BELOW, torch.full_like(input_ids, mask_token_id),
        torch.where(u_act < RANDOM_BELOW, rand_ids.long(), input_ids))
    corrupted = torch.where(is_pred, corrupted, input_ids)

    hidden = params.bert(corrupted, attention_mask, attn_impl=attn_impl,
                         compute_dtype=compute_dtype,
                         dropout=None if deterministic else dropout,
                         remat=remat)
    head = params.mlm
    bf16 = torch.bfloat16
    x = hidden.to(bf16) @ head.dense_w.to(bf16) + head.dense_b.to(bf16)
    x = F.gelu(x.to(torch.float32))
    x = _layer_norm_f32(x, head.ln_scale.to(torch.float32),
                        head.ln_bias.to(torch.float32), config.layer_norm_eps)
    # tied decoder: bf16 operands, products exact in fp32, fp32 sums (the
    # reference's preferred_element_type=float32)
    word = params.bert.word_emb.to(bf16).to(torch.float32)
    logits = x.to(bf16).to(torch.float32) @ word.T + head.out_bias

    logp = torch.log_softmax(logits, dim=-1)
    gold = torch.gather(logp, -1, input_ids[..., None])[..., 0]
    w = is_pred.to(torch.float32)
    denom = w.sum().clamp(min=1.0)
    loss = -(gold * w).sum() / denom
    acc = ((logits.argmax(-1) == input_ids).to(torch.float32) * w).sum() / denom
    return loss, {"loss": loss, "acc": acc, "n_pred": w.sum()}


def mlm_decayed(path: str) -> bool:
    """The MLM decay mask (train/mlm.py:152-158): no decay where the last
    key of the path holds ``ln_`` or ends in ``_b`` or ``bias``."""
    last = path.split("/")[-1]
    return not ("ln_" in last or last.endswith("_b") or last.endswith("bias"))


def make_mlm_optimizer(lr: float, warmup_steps: int, total_steps: int,
                       weight_decay: float = 0.01) -> AdamW:
    """clip_by_global_norm(1.0) + AdamW with linear warmup / decay and the
    MLM decay mask (ref: train/mlm.py:143-162)."""
    return AdamW(linear_warmup_schedule(lr, warmup_steps, total_steps),
                 weight_decay=weight_decay, max_grad_norm=1.0,
                 decayed=mlm_decayed)


def make_mlm_step(config: BertConfig, opt: AdamW, *, mask_token_id: int,
                  attn_impl: str = "auto", remat: str = "full",
                  compute_dtype: torch.dtype = torch.bfloat16):
    """The train step ``step(params, opt_state, batch, draws, dropout) ->
    metrics``: one ``mlm_loss`` and one in-place update of every
    parameter. metrics: 0-dim device tensors (no host sync)."""

    def step(params: MLMParams, opt_state, batch, draws, dropout=None):
        named = dict(params.named_parameters())
        loss, metrics = mlm_loss(
            params, config, batch["input_ids"], batch["attention_mask"],
            draws, mask_token_id=mask_token_id, dropout=dropout,
            attn_impl=attn_impl, remat=remat, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, list(named.values()))
        opt.update(dict(zip(named, grads)), opt_state, named)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def pack_chunks(texts: List[str], tok, seq_len: int) -> np.ndarray:
    """Tokenize + pack documents into fixed [n, seq_len] id rows:
    [CLS] tokens... [SEP], documents separated by [SEP], final partial
    chunk padded."""
    ids: List[int] = []
    for t in texts:
        ids.extend(tok.encode_batch_ids([t])[0])
        ids.append(tok.sep_token_id)
    body = seq_len - 2
    n = max((len(ids) + body - 1) // body, 1)
    out = np.full((n, seq_len), tok.pad_token_id, np.int32)
    for i in range(n):
        chunk = ids[i * body:(i + 1) * body]
        out[i, 0] = tok.cls_token_id
        out[i, 1:1 + len(chunk)] = chunk
        out[i, 1 + len(chunk)] = tok.sep_token_id
    return out


def pretrain_mlm(texts: List[str], tok, config: BertConfig, *,
                 steps: int, batch_size: int = 32, seq_len: int = 128,
                 lr: float = 1e-3, seed: int = 0, params=None,
                 attn_impl: str = "auto", remat: str = "full",
                 log_every: int = 100, rng_impl: str = "rbg",
                 holdout_frac: float = 0.0, device="cuda"):
    """Run MLM pretraining; returns (params, history).

    The chunk split and order follow the reference (numpy, from ``seed``).
    params: an ``MLMParams`` to resume (on ``device``), else
    ``init_mlm_params`` from ``seed``. The corruption draws come from a
    generator on ``device`` and the dropout seeds from a CPU generator, both
    seeded with ``seed``; ``rng_impl`` is accepted and has no effect.
    holdout_frac reserves a chunk fraction for a held-out loss probe.
    history: ``loss``, ``acc``, ``dev_loss`` at each log point, rounded to
    4 places as in the reference."""
    device = resolve_device(device)
    chunks = pack_chunks(texts, tok, seq_len)
    rng_data = np.random.default_rng(seed)
    perm = rng_data.permutation(len(chunks))
    n_dev = int(len(chunks) * holdout_frac)
    dev_chunks = chunks[perm[:n_dev]]
    chunks = chunks[perm[n_dev:]]
    logger.info("MLM corpus: %d chunks of %d tokens (%d held out)",
                len(chunks), seq_len, n_dev)
    if params is None:
        params = init_mlm_params(config, torch.Generator().manual_seed(seed),
                                 device=device)
    opt = make_mlm_optimizer(lr, warmup_steps=max(steps // 20, 10),
                             total_steps=steps)
    opt_state = opt.init(dict(params.named_parameters()))
    step_fn = make_mlm_step(config, opt, mask_token_id=tok.mask_token_id,
                            attn_impl=attn_impl, remat=remat)
    draw_gen = torch.Generator(device=device).manual_seed(seed)
    dropout = torch.Generator().manual_seed(seed)

    def device_batch(rows):
        return {"input_ids": torch.as_tensor(rows, device=device),
                "attention_mask": torch.as_tensor(
                    (rows != tok.pad_token_id).astype(np.int32),
                    device=device)}

    dev_loss = None
    if n_dev:
        dev_batch = device_batch(dev_chunks[:min(len(dev_chunks),
                                                 batch_size * 4)])
        dev_draws = mlm_draws(tuple(dev_batch["input_ids"].shape),
                              config.vocab_size,
                              torch.Generator(device=device).manual_seed(
                                  seed + 1))

        @torch.no_grad()
        def dev_loss():
            return float(mlm_loss(
                params, config, dev_batch["input_ids"],
                dev_batch["attention_mask"], dev_draws,
                mask_token_id=tok.mask_token_id, deterministic=True,
                attn_impl=attn_impl, remat="none")[0])

    history = {"loss": [], "acc": [], "dev_loss": []}
    t0 = time.perf_counter()
    n_step = 0
    while n_step < steps:
        if len(chunks) < batch_size:
            raise ValueError(f"corpus too small: {len(chunks)} chunks < "
                             f"batch {batch_size}")
        order = rng_data.permutation(len(chunks))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            batch = device_batch(chunks[order[s:s + batch_size]])
            draws = mlm_draws((batch_size, seq_len), config.vocab_size,
                              draw_gen)
            m = step_fn(params, opt_state, batch, draws, dropout)
            n_step += 1
            if n_step % log_every == 0 or n_step == steps:
                loss, acc = float(m["loss"]), float(m["acc"])
                history["loss"].append(round(loss, 4))
                history["acc"].append(round(acc, 4))
                if dev_loss is not None:
                    history["dev_loss"].append(round(dev_loss(), 4))
                logger.info(
                    "mlm step %d/%d loss %.4f acc %.3f%s (%.0fs)",
                    n_step, steps, loss, acc,
                    (f" dev {history['dev_loss'][-1]:.4f}"
                     if dev_loss is not None else ""),
                    time.perf_counter() - t0)
            if n_step >= steps:
                break
    return params, history
