"""RC training driver.

The counterpart of ``densephrases_tpu/cli/train_rc.py`` on one device: load
or init the encoder, tokenizer and features, build the optimizer and train
state, resume from the latest checkpoint, run the train step with logging
and checkpoints, save the encoder, evaluate on the dev file, and sweep the
filter thresholds (ref: train_rc.py:410-431).

Differences from the reference, all deliberate:

- ``device`` is explicit; a CUDA device that is missing raises, and only
  ``device="cpu"`` runs on the CPU;
- data parallelism is one process a device (the reference's ``n_dev``
  path, cli/train_rc.py:106-161, is one controller over a mesh): the world
  is the ``torch.distributed`` process group, joined from ``torchrun``'s
  environment when the caller has not joined one (backend "nccl" for a
  CUDA device, "gloo" for the CPU; under ``torchrun`` a bare "cuda" is
  ``cuda:$LOCAL_RANK``). The global batch is ``per_device_train_batch_size
  x world``, each rank trains on its contiguous slice with global in-batch
  negatives, rank 0 alone logs, checkpoints and saves the encoder and runs
  the dev eval, and every rank resumes from the checkpoint;
- with several ranks and fewer features than one global batch the driver
  raises: the reference falls back to one device, which here would be
  several duplicate trainers;
- each step's dropout generator is seeded from (``--seed``, step), so a
  resumed run draws the same masks as an uninterrupted one (rank r > 0
  folds in r, ``train/rc.py:rank_generator``). ``--rng_impl`` is accepted
  and has no effect.

Usage:
  python -m densephrases_tpu_torch.cli.train_rc --train_file squad.json \\
      --output_dir out/ --lambda_neg 2.0 --lambda_flt 1.0 [--draft]
  torchrun --nproc_per_node 8 -m densephrases_tpu_torch.cli.train_rc ...
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from densephrases_tpu_torch.cli.common import (
    ensure_tokenizer,
    load_encoder,
    save_encoder,
)
from densephrases_tpu_torch.data.qa import load_rc_examples
from densephrases_tpu_torch.data.rc_dataset import batches, convert_rc_examples
from densephrases_tpu_torch.models.encoder import TEACHER, RCLossConfig
from densephrases_tpu_torch.options import Options
from densephrases_tpu_torch.parallel import make_mesh, rank_and_size
from densephrases_tpu_torch.train.rc import (
    create_train_state,
    make_optimizer,
    make_train_step,
    shard_batch,
)
from densephrases_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from densephrases_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def filter_test(params, config, feats, thresholds=(-4, -3, -2, -1, 0, 1, 2)):
    """Sweep filter thresholds → keep-rate per threshold
    (ref: train_rc.py:410-431 + Makefile:233-244 filter-test)."""
    from densephrases_tpu_torch.dump import _phrase_forward

    keep_rates = {}
    am = np.stack([f.attention_mask for f in feats[:64]])
    _, fs, fe = _phrase_forward(
        params, np.stack([f.input_ids for f in feats[:64]]), am,
        np.stack([f.token_type_ids for f in feats[:64]]))
    mask = am > 0
    for th in thresholds:
        keep = ((fs > th) | (fe > th)) & mask
        keep_rates[th] = float(keep.sum() / mask.sum())
    return keep_rates


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step, a function of (seed, step) only."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def join_world(device: str):
    """Join ``torchrun``'s process group when the caller has not joined
    one; returns this rank's device (a bare "cuda" is ``cuda:$LOCAL_RANK``
    under ``torchrun``)."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if (world > 1 and str(device) == "cuda"
            and "LOCAL_RANK" in os.environ):
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    return device


def main(argv=None, device="cuda"):
    device = join_world(device)
    rank, world = rank_and_size()
    lead = rank == 0
    opts = Options().parse(argv, groups=["model", "data", "train"])
    m, d, t = opts.model, opts.data, opts.train

    params, config, tokenizer = load_encoder(m.load_dir, draft=opts.draft,
                                             seed=t.seed, device=device)
    if t.hidden_act and t.hidden_act != config.hidden_act:
        import dataclasses

        config = dataclasses.replace(config, hidden_act=t.hidden_act)
        logger.info("training with hidden_act=%s", config.hidden_act)
    examples = load_rc_examples(d.train_file, draft=opts.draft)
    tokenizer = ensure_tokenizer(
        tokenizer, [e["context"] for e in examples[:5000]],
        vocab_size=config.vocab_size,
        save_path=os.path.join(m.output_dir, "vocab.txt") if m.output_dir else None)
    if config.vocab_size < tokenizer.vocab_size:
        raise SystemExit(
            f"config vocab {config.vocab_size} < tokenizer {tokenizer.vocab_size}")

    with_teacher = t.lambda_kl > 0
    if with_teacher:
        # the teacher joins the student's modules (ref weight surgery:
        # train_rc.py:508-530)
        from densephrases_tpu_torch.train.cross_encoder import init_cross_params

        teacher = init_cross_params(
            config, torch.Generator().manual_seed(t.seed + 1), device=device)
        if t.teacher_dir:
            teacher = restore_checkpoint(os.path.join(t.teacher_dir, "params"),
                                         teacher)
            logger.info("loaded distillation teacher from %s", t.teacher_dir)
        else:
            logger.warning("lambda_kl>0 but no --teacher_dir: random teacher")
        params.cross, params.qa_outputs = teacher.cross, teacher.qa_outputs

    feats = convert_rc_examples(
        examples, tokenizer, max_seq_length=m.max_seq_length,
        doc_stride=m.doc_stride, max_query_length=m.max_query_length,
        with_teacher=with_teacher,
        max_cross_length=min(m.max_seq_length + m.max_query_length,
                             config.max_position_embeddings))
    logger.info("converted %d features", len(feats))

    batch_size = t.per_device_train_batch_size * world
    if world > 1 and len(feats) < batch_size:
        raise ValueError(
            f"only {len(feats)} features for a global batch of {batch_size} "
            f"over {world} ranks: use fewer ranks or a smaller "
            "--per_device_train_batch_size")
    if len(feats) < batch_size:
        # tiny/draft datasets: repeat features so at least one full batch
        # exists (drop_last would otherwise silently train nothing)
        reps = (batch_size + len(feats) - 1) // len(feats)
        feats = (feats * reps)[:max(batch_size, len(feats))]
        logger.warning("repeated features to fill one batch (%d)", len(feats))
    steps_per_epoch = max(len(feats) // batch_size, 1)
    total_steps = (t.max_steps if t.max_steps > 0
                   else int(steps_per_epoch * t.num_train_epochs))

    optimizer = make_optimizer(
        lr=t.learning_rate, warmup_steps=t.warmup_steps,
        total_steps=total_steps, weight_decay=t.weight_decay,
        adam_epsilon=t.adam_epsilon, max_grad_norm=t.max_grad_norm)
    loss_cfg = RCLossConfig(lambda_kl=t.lambda_kl, lambda_neg=t.lambda_neg,
                            lambda_flt=t.lambda_flt)
    mesh = None
    if world > 1:
        mesh = make_mesh(axis="dp", devices=[device] * world)
        loss_cfg.axis_name = "dp"
    state = create_train_state(
        params, optimizer, pbn_size=t.pbn_size,
        batch_size=t.per_device_train_batch_size, hidden=config.hidden_size)
    ckpt_dir = os.path.join(m.output_dir, "ckpt") if m.output_dir else None
    skip_steps = 0
    if ckpt_dir and latest_checkpoint(ckpt_dir):
        state = restore_checkpoint(ckpt_dir, state)
        skip_steps = state.step
        logger.info("resumed at step %d", skip_steps)

    from densephrases_tpu_torch.utils.metrics_log import MetricsLogger

    mlog = MetricsLogger(m.output_dir or None, use_wandb=t.wandb) \
        if lead else None
    step_fn = make_train_step(config, loss_cfg, optimizer, mesh=mesh,
                              remat=t.remat)
    global_step = skip_steps
    for epoch in range(int(np.ceil(t.num_train_epochs))):
        ep_skip = max(0, skip_steps - epoch * steps_per_epoch)
        for batch in batches(feats, batch_size, seed=t.seed + epoch,
                             skip_steps=ep_skip):
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            else:
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()}
            state, metrics = step_fn(state, batch,
                                     step_generator(t.seed, global_step))
            global_step += 1
            if lead and (global_step % max(t.logging_steps, 1) == 0
                         or opts.verbose):
                logger.info("step %d: loss=%.4f", global_step,
                            float(metrics["loss"]))
                mlog.log(global_step,
                         **{k: float(v) for k, v in metrics.items()})
            if ckpt_dir and global_step % t.save_steps == 0:
                save_checkpoint(ckpt_dir, state, step=global_step)
            if global_step >= total_steps:
                break
        if global_step >= total_steps:
            break

    if m.output_dir:
        # strip the frozen teacher before saving (ref: train_rc.py:546-549)
        save_params = {k: v for k, v in state.params.state_dict().items()
                       if k.split(".")[0] not in TEACHER}
        save_encoder(m.output_dir, save_params, config, tokenizer)
        if ckpt_dir:
            save_checkpoint(ckpt_dir, state, step=global_step)
        logger.info("saved to %s", m.output_dir)

    # dev-set RC eval (ref: train_rc.py:307-407 evaluate + eval_logger)
    if d.dev_file and lead:
        from densephrases_tpu_torch.eval.rc import evaluate_rc

        dev_examples = load_rc_examples(d.dev_file, draft=opts.draft)
        metrics = evaluate_rc(
            state.params, config, tokenizer, dev_examples,
            max_seq_length=m.max_seq_length, doc_stride=m.doc_stride,
            max_query_length=m.max_query_length,
            max_answer_length=m.max_answer_length)
        out_dir = m.output_dir or "."
        with open(os.path.join(out_dir, "eval_logger.txt"), "a") as f:
            f.write(f"rc-dev\tEM={metrics['exact_match']:.2f}\t"
                    f"F1={metrics['f1']:.2f}\tstep={global_step}\n")

    rates = filter_test(state.params, config, feats)
    logger.info("filter keep-rates: %s", rates)
    return state, rates


if __name__ == "__main__":
    main()
