"""Profile the RC train step at BERT-base width on one CUDA GPU.

Builds random ``BertConfig()`` towers and a random teacher from seeds, a
synthetic batch at the training shape (12 passages of 384 tokens, queries
of 64, cross inputs of 448; ragged masks) and every loss part, then prints:

- the host-clock step time (median of 5 after 3 warm-ups) through the
  kernels and through the plain attention, in turns (kernel, plain,
  kernel, plain);
- CUDA-event times of the loss forward, the backward and the optimizer;
- ``torch.profiler`` over 3 kernel steps: device time by kernel, the
  number of kernel launches, and the device's busy share of the wall time
  (which the profiler itself stretches).

Usage, from the repository root on a machine with one GPU:
  python -m densephrases_tpu_torch.tools.profile_train [trace.json]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import (
    TEACHER,
    RCLossConfig,
    init_encoder_params,
    rc_loss,
)
from densephrases_tpu_torch.train.cross_encoder import init_cross_params
from densephrases_tpu_torch.train.rc import (
    create_train_state,
    make_optimizer,
    make_train_step,
)

B, L, LQ, LC = 12, 384, 64, 448
LOSS = RCLossConfig(lambda_kl=2.0, lambda_neg=2.0, lambda_flt=1.0)


def synthetic_batch(seed: int = 0, vocab: int = 3000):
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def ids(*shape):
        return torch.as_tensor(rng.integers(5, vocab, shape), device=dev)

    def mask(n, keep):
        m = torch.ones(B, n, dtype=torch.long, device=dev)
        m[:, keep:] = 0
        return m

    am, qam, cam = mask(L, 300), mask(LQ, 20), mask(LC, 320)
    gather = torch.full((B, L), -1, dtype=torch.long, device=dev)
    gather[:, 0] = 0
    gather[:, 2:300] = torch.arange(20, 318, device=dev)
    return {"input_ids": ids(B, L), "attention_mask": am,
            "token_type_ids": torch.zeros_like(am),
            "query_input_ids": ids(B, LQ), "query_attention_mask": qam,
            "query_token_type_ids": torch.zeros_like(qam),
            "start_positions": torch.as_tensor(rng.integers(1, 290, B), device=dev),
            "end_positions": torch.as_tensor(rng.integers(1, 290, B), device=dev),
            "cross_input_ids": ids(B, LC), "cross_attention_mask": cam,
            "cross_token_type_ids": torch.zeros_like(cam),
            "teacher_gather": gather}


def new_step(params, cfg, impl="auto"):
    opt = make_optimizer(lr=3e-5, warmup_steps=1, total_steps=100)
    state = create_train_state(params, opt, pbn_size=2, batch_size=B,
                               hidden=cfg.hidden_size)
    return state, opt, make_train_step(cfg, LOSS, opt, attn_impl=impl)


def main(trace_path: str = "") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = BertConfig()
    params = init_encoder_params(cfg, torch.Generator().manual_seed(0),
                                 device="cuda")
    teacher = init_cross_params(cfg, torch.Generator().manual_seed(1),
                                device="cuda")
    params.cross, params.qa_outputs = teacher.cross, teacher.qa_outputs
    batch = synthetic_batch()
    out = {"device": smi, "step_ms_host": {}}

    for impl in ("cuda", "plain", "cuda", "plain"):
        state, _, step = new_step(params, cfg, impl)
        times = []
        for i in range(8):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator().manual_seed(i))
            float(metrics["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
        out["step_ms_host"].setdefault(impl, []).append(float(np.median(times[3:])))

    named = {n: p for n, p in params.named_parameters()
             if n.split(".")[0] not in TEACHER and not n.endswith(".word_emb")}
    opt = make_optimizer(lr=3e-5, warmup_steps=1, total_steps=100)
    opt_state = opt.init(named)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for rep in range(3):
        ev[0].record()
        total, _ = rc_loss(params, cfg, batch, LOSS,
                           dropout=torch.Generator().manual_seed(rep))
        ev[1].record()
        grads = torch.autograd.grad(total, list(named.values()),
                                    allow_unused=True)
        ev[2].record()
        opt.update({n: torch.zeros_like(p) if g is None else g
                    for (n, p), g in zip(named.items(), grads)}, opt_state,
                   named)
        ev[3].record()
        torch.cuda.synchronize()
        out[f"events_ms_rep{rep}"] = {
            part: ev[i].elapsed_time(ev[i + 1])
            for i, part in enumerate(("loss_forward", "backward", "optimizer"))}

    from torch.profiler import ProfilerActivity, profile

    state, _, step = new_step(params, cfg)
    state, _ = step(state, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            state, _ = step(state, batch, torch.Generator().manual_seed(i))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(d for _, d, _ in kernels)
    out["profiled"] = {
        "steps": n_steps, "wall_ms": wall_ms, "kernel_ms": busy_ms,
        "busy_share": busy_ms / wall_ms,
        "launches": sum(c for _, _, c in kernels),
        "top_kernels_ms": [[k[:100], round(d, 3), c] for k, d, c in
                           sorted(kernels, key=lambda r: -r[1])[:30]]}
    if trace_path:
        prof.export_chrome_trace(trace_path)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
