"""Reading-comprehension training: schedule, optimizer, train state, step.

The counterpart of ``densephrases_tpu/train/rc.py`` on one device. The
reference chains optax's ``clip_by_global_norm`` and ``adamw``; the port
writes the same update out in torch, step for step:

- the global norm is optax's, ``sqrt(sum of squares)`` with no ``+1e-6``
  (``torch.nn.utils.clip_grad_norm_`` adds one), and clipping scales by
  ``max_norm / norm`` only when ``norm >= max_norm``;
- Adam's eps is added outside the square root, after bias correction;
- weight decay is added to the Adam direction (decoupled), on the
  parameters that a predicate over the reference's path names selects:
  the RC mask (train/rc.py:57-63) by default, the port's names mapped to
  the reference's;
- the learning rate is the schedule at the pre-increment count, so with a
  warmup the first update uses lr(0) = 0;
- frozen word embeddings and the teacher (``cross``, ``qa_outputs``) get
  no gradient and no update, so they add nothing to the norm and are not
  decayed (train/rc.py:111-132, :150-154).

The step updates the parameters and the optimizer state in place (torch
modules are mutable) and returns the state with the new step count and
pre-batch ring.

Data-parallel training (``make_train_step(..., mesh=...)``, the reference's
``shard_map`` step, train/rc.py:134-194) runs one process a rank, each on
its contiguous slice of the global batch (``shard_batch``). The step takes
its gradients with ``torch.autograd.grad``, so no ``DistributedDataParallel``
wrapper is used (its hooks would never fire): the gradients are averaged
over the ranks as one flat buffer (JAX's ``pmean``) before the frozen
parameters are dropped and the norm is clipped, and the loss is averaged
the same way; the per-part losses stay the rank's own, as the reference's
are device 0's. Each rank keeps its own pre-batch ring of its local golds
(the reference returns its rings under a replicated spec with the check
off, so a host read sees device 0's). Rank r > 0 draws its dropout from
(the step generator's seed, r), the counterpart of ``fold_in(rng,
axis_index)``; rank 0 draws from the step generator itself, so a mesh of
one equals the single-device step.

``AdamW`` also expresses the other trainers' optimizers: plain
``optax.adamw`` (no clipping, decay on every parameter) for query-side
fine-tuning and the cross-encoder, whose schedule is
``warmup_linear_decay_schedule``, and the MLM chain (train/mlm.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import (
    TEACHER,
    RCLossConfig,
    init_pre_batch,
    pre_batch_update,
    rc_loss,
)
from densephrases_tpu_torch.models.from_jax import reference_path
from densephrases_tpu_torch.parallel import pmean, shard_put

LOSS_PARTS = ("single_loss", "neg_loss", "filter_loss", "kl_loss")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule, in float32 as there."""
    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return schedule


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup then linear decay to 0 (ref: train_rc.py:96-98
    get_linear_schedule_with_warmup), as optax.join_schedules of two linear
    schedules."""
    warmup_steps = max(warmup_steps, 1)
    warm = _linear(0.0, lr, warmup_steps)
    decay = _linear(lr, 0.0, max(total_steps - warmup_steps, 1))
    return lambda count: warm(count) if count < warmup_steps \
        else decay(count - warmup_steps)


def warmup_linear_decay_schedule(lr: float, warmup_steps: int,
                                 total_steps: int):
    """Linear warmup to ``lr`` over ``warmup_steps``, then a linear decay to 0
    over ``total_steps`` counted from the warmup's end (optax.join_schedules
    of linear_schedule(0, lr, warmup) and linear_schedule(lr, 0, total)):
    the query-side and cross-encoder schedules (train/query.py:215-221,
    train/cross_encoder.py:102-106). The caller clamps the warmup, as
    there."""
    warm = _linear(0.0, lr, warmup_steps)
    decay = _linear(lr, 0.0, total_steps)
    return lambda count: warm(count) if count < warmup_steps \
        else decay(count - warmup_steps)


def decay_all(path: str) -> bool:
    """Plain ``optax.adamw``: weight decay on every parameter."""
    return True


def is_decayed(path: str) -> bool:
    """The reference's decay mask on a path of its tree (train/rc.py:57-63):
    no decay on biases and layer norms."""
    if path == "b" or path.endswith("/b"):  # filter / qa_outputs biases
        return False
    return not any(s in path for s in ("_b", "bias", "ln_", "_ln"))


class AdamW:
    """optax.chain(clip_by_global_norm, adamw) over named fp32 tensors, or
    ``adamw`` alone when ``max_grad_norm`` is None.

    ``decayed`` picks the parameters that get weight decay by their path in
    the reference's tree (``reference_path``). ``init`` makes the state;
    ``update`` applies one step in place to the parameters it is given
    gradients for. Parameters without a gradient keep their moments and are
    not touched."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0,
                 decayed: Callable[[str], bool] = is_decayed):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.decayed = decayed

    def init(self, named_params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in named_params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step; returns the global norm of the unclipped gradients."""
        names = list(grads)
        g = [grads[n].to(torch.float32) for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        if self.max_grad_norm is not None:
            factor = torch.where(norm < self.max_grad_norm, 1.0,
                                 self.max_grad_norm / norm)
            g = torch._foreach_mul(g, factor)
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        lr = self.schedule(state["count"])  # the pre-increment count
        state["count"] += 1
        t = state["count"]
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        p = [params[n] for n in names]
        decay = [i for i, n in enumerate(names)
                 if self.decayed(reference_path(n))]
        if self.weight_decay and decay:
            torch._foreach_add_([upd[i] for i in decay], [p[i] for i in decay],
                                alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        return norm


def make_optimizer(lr: float = 3e-5, warmup_steps: int = 0,
                   total_steps: int = 10000, weight_decay: float = 0.01,
                   adam_epsilon: float = 1e-8, max_grad_norm: float = 1.0
                   ) -> AdamW:
    """AdamW with no weight decay on biases/LayerNorm and global-norm
    clipping (ref: train_rc.py:85-94)."""
    return AdamW(linear_warmup_schedule(lr, warmup_steps, total_steps),
                 b1=0.9, b2=0.999, eps=adam_epsilon, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm)


@dataclass
class TrainState:
    params: torch.nn.Module  # EncoderParams, updated in place
    opt_state: dict
    step: int
    pre_batch: Optional[dict] = None


def _optimized(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter but the teacher's, by the port's name."""
    return {n: p for n, p in params.named_parameters()
            if n.split(".")[0] not in TEACHER}


def create_train_state(params, optimizer: AdamW, pbn_size: int = 0,
                       batch_size: int = 0, hidden: int = 0) -> TrainState:
    pre_batch = None
    if pbn_size > 0:
        pre_batch = init_pre_batch(pbn_size, batch_size, hidden,
                                   device=params.device)
    return TrainState(params=params, opt_state=optimizer.init(
        _optimized(params)), step=0, pre_batch=pre_batch)


def make_train_step(config: BertConfig, loss_cfg: RCLossConfig,
                    optimizer: AdamW, mesh=None, dp_axis: str = "dp",
                    attn_impl: str = "auto", frozen_word_embeddings: bool = True,
                    remat: str = "full", *,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Build the train step ``step(state, batch, generator) -> (state,
    metrics)``. ``batch`` is a dict of tensors on the params' device;
    ``generator`` is a CPU ``torch.Generator`` for this step's dropout
    seeds. ``metrics`` holds 0-dim device tensors (no host sync).

    frozen_word_embeddings: the reference freezes word embeddings during RC
    training (ref: train_rc.py:65-70).

    mesh: a ``parallel.Mesh`` for data-parallel training: every rank calls
    the step with its ``shard_batch`` slice and the same generator; the
    loss config's ``axis_name`` must be the mesh axis (global negatives)."""
    if mesh is not None and loss_cfg.axis_name != dp_axis:
        raise ValueError("loss_cfg.axis_name must match the mesh dp axis "
                         "for global negatives")

    def trainable(params) -> Dict[str, torch.Tensor]:
        named = _optimized(params)
        if frozen_word_embeddings:
            named = {n: p for n, p in named.items()
                     if not n.endswith(".word_emb")}
        return named

    def step(state: TrainState, batch, generator: Optional[torch.Generator]):
        named = trainable(state.params)
        if mesh is not None and generator is not None:
            generator = rank_generator(generator, mesh.rank)
        total, aux = rc_loss(
            state.params, config, batch, loss_cfg, pre_batch=state.pre_batch,
            deterministic=False, dropout=generator, attn_impl=attn_impl,
            remat=remat, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(named.values(), grads)]
        loss = total.detach()
        if mesh is not None:
            *grads, loss = pmean(grads + [loss[None]], mesh)
            loss = loss[0]
        grads = dict(zip(named, grads))
        grad_norm = optimizer.update(grads, state.opt_state, named)
        new_pb = state.pre_batch
        if state.pre_batch is not None:
            new_pb = pre_batch_update(state.pre_batch, aux["gold_start"],
                                      aux["gold_end"])
        metrics = {"loss": loss, "grad_norm": grad_norm}
        for k in LOSS_PARTS:
            if k in aux:
                metrics[k] = aux[k].detach()
        return TrainState(state.params, state.opt_state, state.step + 1,
                          new_pb), metrics

    return step


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """Rank r's dropout generator for one step: the step's own for rank 0,
    else one seeded from (the step generator's seed, r)."""
    if rank == 0:
        return generator
    state = np.random.SeedSequence([generator.initial_seed(), rank]) \
        .generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def shard_batch(batch, mesh, dp_axis: str = "dp"):
    """This rank's contiguous slice ``[r*b, (r+1)*b)`` of a global host
    batch, on the rank's device: the rows ``NamedSharding(P(dp_axis))``
    gives a device (not ``DistributedSampler``'s strided split)."""
    return {k: shard_put(v, mesh, dp_axis) for k, v in batch.items()}
