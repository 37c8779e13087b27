#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``densephrases_tpu_torch``) on one GPU.

Drives the port's main path once at BERT-base width with random seeded
weights, through the entry points a user calls, and checks every hand-
written kernel on that path against its plain PyTorch version:

  0. device      the card's name and power limit
  1. build       compile the CUDA kernels from ``densephrases_tpu_torch/csrc``,
                 one nvcc per source, all started together
  2. kernels     each kernel vs its plain version at the main path's shapes,
                 with the max error against a stated tolerance and both times:
                 attention (A, and its row logsumexp), and the IVF list scans
                 (C: SQ8 / SQ4, D: PQ 8-bit / 4-bit) on a seeded 1M x 768
                 index of 4,096 lists; beside them each row's bound (the
                 card's peak bytes/s and ops/s against the work) and, for A
                 and B, one PyTorch call of the same function as a yardstick
                 (``scaled_dot_product_attention`` and its backward; timed
                 here only, never called by the port); for C the product
                 alone on the gathered rows as a yardstick, and the whole
                 SQ8 and OPQ96-like scans around C and D; then C and D at
                 ragged shapes (``IVF_EDGE_*``)
  3. dump        ``dump_phrases`` of a seeded synthetic corpus into a store
  4. serve       ``DensePhrases.search`` for all four units, the fused server
                 over 4 batches of 64 queries, the brute-force span oracle,
                 and the kernel path's answers against the plain path's
  2b. attn bwd   kernel B (fed A's output and logsumexp) vs
                 ``attention_bwd_plain`` (dq, dk, dv) at the training shapes,
                 bf16 and fp32; A and B at ragged lengths for every head dim;
                 the autograd Function (kernels A + B) vs torch autograd of
                 the plain forward
  5. ivf         ``IVFIndex.build`` of IVF-SQ8 / OPQ96 / SQ4 / OPQ192x4 on
                 phase 3's store, ``DensePhrases.search`` over them, the full-
                 probe check against phase 4's flat path, recall@10 and ms per
                 batch at nprobe 16, and the oracle over full-probe SQ8
  6. train       ``cli.train_rc.main`` at BERT-base width for 6 steps on a
                 synthetic SQuAD file from phase 3's corpus, every loss part
                 and the teacher; dev eval and filter sweep; the saved encoder
                 served; one step through the kernels vs the plain attention
  7. offline     the three drivers on phase 3's corpus (four SQuAD files)
                 and encoder: ``generate_phrase_vecs`` (codes against phase
                 3's store), ``build_phrase_index`` (SQ8 and OPQ96, 128
                 clusters), ``eval_phrase_retrieval`` over each on a
                 synthetic QA file; the OPQ96 index served with the device
                 refine, in decode mode and with the host refine, and the
                 int4 flat index beside the int8 one: ms per batch of 64,
                 the device bytes each holds, host vs device refine ids
  8. scale       the reference-scale IVF build and tiered serving on a
                 seeded 2^20 x 768 int8 blob corpus in 16,384 lists: the
                 two-level coarse build into a coarse cache, hierarchical vs
                 flat assignment, ``build`` and ``build_host_save`` from the
                 cache (byte-equal saves), the in-HBM scan (kernel C) vs
                 ``TieredIVF`` at nprobe 16 and 256, ``TieredFlatIndex`` vs
                 the flat index, and the drivers at their defaults on phase
                 7's dump, evaluated on the device and the host tier
  9. trainers    the trainers at BERT-base width through their entry points:
                 a. ``train_cross_encoder.main`` (the teacher, batch 12 x
                 cross length 448) on phase 6's SQuAD file; b. ``train_rc.
                 main --lambda_kl --teacher_dir`` loading a's teacher; c.
                 ``read_passages`` with it on 64 pairs, against the plain
                 attention; d. ``pretrain_mlm`` at batch 64 x L 128, the
                 backbone saved as an encoder and reloaded, one kernel step
                 against one plain step; e. ``train_query.main`` (query-side
                 fine-tuning, batch 12, top-k 100) over phase 7's OPQ96 index
                 with the device refine, the output served; f. phase 7's
                 encoder as a ``pytorch_model.bin`` through ``load_encoder``.
                 Each trainer's step ms, steps/s and peak device memory

Kernel A's launch counter is zeroed right before phase 3 and read after
phase 4's main-path work; kernels C and D's are zeroed right before phase 5
and read after it; kernels A and B's are zeroed again right before phase 6's
``train_rc.main`` and read right after it, and A, C and D's right before
phase 7 and read at its end; A and C's right before phase 8's drivers
(part g) and read after them; A, B and D's right before each part of phase
9 and read right after it; phases 6, 7, 8 and 9 must equal the counts
their paths imply. A kernel of a path that never launched fails the run.
Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when there is no CUDA device. The second-last
lines are a JSON object of per-kernel results and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
"""

import concurrent.futures
import contextlib
import dataclasses
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
N_DOCS = 64
QUERY_BATCH = 64
N_BATCHES = 4
MAX_QUERY_LENGTH = 32
# kernel vs plain: fp32 differs by summation order and __expf (measured
# ~1e-6); bf16 plain rounds scores and probabilities to bf16, which moves an
# output of magnitude up to 2 by a bf16 ulp or two (ulp 7.8e-3 at 1)
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# kernel A (attention forward) shapes: one query tower at serve batch 64
# (L 32) and both towers' batches together; at train batch 12 the query
# towers (L 64), the phrase tower (L 384) and the teacher's cross input
# (L 448, TrainOptions); a dump batch of 16 windows of 512 tokens; MLM
# pretraining at batch 64 x L 128
ATTN_FWD_SHAPES = ((64, 12, 32, 64), (128, 12, 32, 64), (12, 12, 64, 64),
                   (12, 12, 384, 64), (12, 12, 448, 64), (16, 12, 512, 64),
                   (64, 12, 128, 64))
# kernel B (attention backward) shapes: the phrase tower at train batch 12 x
# L 384, the query towers at L 64, the longest window (16 x L 512), the
# cross tower's backward (the teacher's training, 12 x L 448) and MLM
# (64 x L 128)
ATTN_BWD_SHAPES = ((12, 12, 384, 64), (12, 12, 64, 64), (16, 12, 512, 64),
                   (12, 12, 448, 64), (64, 12, 128, 64))
# every head-dim instance (16, 32, 64, 128) at lengths that end in a
# partial tile, for correctness only: kernel B against ATTN_BWD_RTOL, and
# kernel A against attention_plain with FN_VS_AUTOGRAD_RTOL (in bf16
# attention_plain rounds its probabilities to bf16); the last two take
# kernel A's blocks of 2 cells (L <= 32) with an odd number of cells, so the
# last block holds a cell past the end
ATTN_EDGE_SHAPES = ((3, 2, 130, 16), (2, 3, 77, 32), (3, 2, 100, 64),
                    (2, 2, 200, 128), (5, 3, 13, 64), (3, 3, 29, 32))
# kernel A's logsumexp vs attention_lse_plain, max |err|: fp32 sums of
# exact products in another order and __expf (~1e-6 of |lse| ~ 10)
LSE_TOL = 1e-4
# kernel B vs attention_bwd_plain, max |err| over max |ref| per gradient:
# fp32 sums of the same products in another order (and __expf); in bf16
# both round the fp32 result to bf16 once, so they sit a bf16 ulp
# (2^-8 relative) apart at most
ATTN_BWD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# AttentionCuda (kernels A + B) vs torch autograd of attention_plain: fp32
# as above; in bf16 the plain forward rounds the scores and probabilities to
# bf16 and autograd differentiates that rounded path
FN_VS_AUTOGRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase 6: RC training at BERT-base width, the Makefile's loss weights
# (Makefile:32-36) plus the teacher and a pre-batch ring of 2
TRAIN_DOCS, DEV_DOCS = 40, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_QUERY, TRAIN_STEPS = 12, 384, 64, 6
TRAIN_LOSS = dict(lambda_kl=2.0, lambda_neg=2.0, lambda_flt=1.0)
TRAINED = ("phrase", "query_start", "query_end", "filter")
# one rc_loss through the kernels vs through the plain attention, same
# weights, batch and dropout masks: bf16 towers whose attention rounds its
# scores and probabilities to bf16 (plain) or not (kernels), through 12
# layers, so the loss moves by up to a few 1e-3 and each tower's gradient
# keeps its direction
TRAIN_LOSS_RTOL, TRAIN_GRAD_COS = 3e-2, 0.98
# kernel-path vs plain-path top-1 span score: towers in bf16 through 12
# layers, scores are sums of 768 products of O(1) terms
SCORE_RTOL = 2e-2
# kernels C and D vs their plain twins: fp32 sums of the same exact
# products (C: bf16 x int8) or the same bf16 LUT entries (D), taken in
# another order; the error stays ~1e-6 of the largest |raw| score
IVF_KERNEL_RTOL = 1e-5
# phase 2's synthetic IVF index at the serve shape
IVF_ROWS, IVF_LISTS, IVF_DIM, IVF_NPROBE = 1 << 20, 4096, 768, 16
IVF_BATCH = 2 * QUERY_BATCH  # start and end query rows, stacked
# the whole scans around C and D at that shape: top-10, and for the
# OPQ96-like scan the index's refine factor 4 (IVFConfig.refine_factor)
IVF_SCAN_TOP_K, IVF_REFINE_FACTOR = 10, 4
# C and D at ragged shapes against their plain twins (correctness only):
# batches of 1, 37 and 130 rows (a lone query, a partial query group, more
# than 128 rows); C at dim 64 (SQ8 and SQ4) and at 68 / 72 (rows of 68 and
# 36 bytes, which take 4-byte loads and end in a partial 32-byte chunk); D
# at M 8 and 24 8-bit (rows narrower than, or not a multiple of, its
# 16-byte loads) and M 12 4-bit (6-byte rows, byte loads). The table holds
# 37 real entries of 96 blocks in a budget of 64: a tile that is partly
# junk, then all-junk tiles whose columns must stay unwritten.
IVF_EDGE_BATCHES = (1, 37, 130)
IVF_EDGE_C = ((64, False), (64, True), (68, False), (72, True))
IVF_EDGE_D = ((8, 256), (24, 256), (12, 16))
IVF_EDGE_BLOCKS, IVF_EDGE_REAL, IVF_EDGE_BUDGET = 96, 37, 64
# phase 5: nlist before balancing, and the nprobe of the recall check
IVF_CLUSTERS, SERVE_NPROBE = 128, 16
# full-probe IVF-SQ8 vs flat top-1 span: both score bf16(q) . code in fp32
# and differ only in summation order, so a different top-1 span must be a
# near-tie within fp32 rounding of the span score
FULL_PROBE_RTOL = 1e-4
# phase 7: phase 3's corpus as this many SQuAD-format files, and a QA file
# of this many questions whose answers are corpus phrases, evaluated in
# batches of this many
OFFLINE_FILES, OFFLINE_QUESTIONS, OFFLINE_EVAL_BATCH = 4, 128, 64
# decode mode ranks by the PQ codes alone (no int8 re-rank), so its top-1
# span may differ from the device refine's; this floor only catches a
# broken decode (random phrase vectors, many near-ties)
DECODE_TOP1_FLOOR = 0.1
# phase 8: a corpus of 2^20 rows at BERT-base width (768, never cut) in
# 2^14 lists (the reference's full index: ~10^9 rows in 2^20 lists), made
# of SCALE_BLOBS seeded blob centres (~256 rows and ~4 lists a blob), so
# that recall means something; SCALE_SAMPLE rows check the hierarchical
# assignment; SCALE_QUERIES query rows near the blobs at each nprobe
SCALE_ROWS, SCALE_DIM, SCALE_LISTS = 1 << 20, 768, 16384
SCALE_BLOBS, SCALE_SAMPLE, SCALE_QUERIES = 4096, 1 << 16, 128
SCALE_NPROBES = (16, 256)
# the blobs in int8 code space: centres N(0, 40²), rows ± N(0, 12²),
# queries = (centre ± N(0, 8²)) / the int8 scale
BLOB_SPREAD, BLOB_NOISE, QUERY_NOISE = 40.0, 12.0, 8.0
# the hierarchical assignment's quantization error against the flat
# argmin's on the same centroids (the reference's own bar, test_ivf.py)
HIER_ERR_RATIO = 1.02
# in-HBM (kernel C) vs tiered IVF on one save and one batch: the same
# exact bf16 x int8 products summed in fp32 in another order (the scores of
# equal ids); the ids may differ where the in-HBM scan's boundary blocks
# reach a row of an unprobed neighbouring list, which the tiered scan
# never reads
TIERED_ID_AGREE, TIERED_SCORE_RTOL = 0.99, 1e-4
# the eval driver's device tier vs its host tier: top-1 predictions equal
# for this share of the questions; a miss must be a near-tie of span scores
DRIVER_TOP1_AGREE, NEAR_TIE_RTOL = 0.98, 1e-4
# phase 9: the teacher at batch 12 (cross length TRAIN_SEQ + TRAIN_QUERY =
# 448) for one epoch of phase 6's SQuAD file; the reader on READER_PAIRS
# pairs; MLM at batch 64 x L 128 for MLM_STEPS steps on phase 3's corpus
# (its whole-word vocab at BertConfig() width); one epoch of query-side
# fine-tuning at batch 12, top-k 100, on phase 7's QA file
CROSS_BATCH, READER_PAIRS, READER_LEN = 12, 64, 384
MLM_BATCH, MLM_SEQ, MLM_STEPS = 64, 128, 6
QSFT_BATCH, QSFT_TOP_K = 12, 100
# the reader through the kernels vs through the plain attention, same
# teacher and pairs: bf16 towers through 12 layers, so a span score (a sum
# of two logits) moves by up to a few 1e-3 relative; a span that differs
# must be a near-tie within that
READER_SCORE_RTOL = 2e-2
# phase 7's encoder read back from a pytorch_model.bin: its weights equal
# the source's bit for bit, yet its fp32 query vectors (12 layers of fp32
# GEMMs) sit apart from the source's by fp32 sums taken in another order
# (1.2e-6 of the largest on an H100, while the source against itself gives
# 0; the log prints both)
HF_QUERY_RTOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet, dense rates at
# 700 W): a kernel's bound is the larger of the bytes it must move over the
# memory rate and its operations over the peak rate for their type (bf16
# products on the tensor cores; fp32 products and adds on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log):
    """One dict per compiled function from ``nvcc -Xptxas -v``: its
    (demangled, where c++filt is found) name, registers, spilled bytes and
    static shared memory."""
    blocks = build_log.split("Compiling entry function '")[1:]
    names = [b.split("'", 1)[0] for b in blocks]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    out = []
    for name, block in zip(names, blocks):
        name = name.replace("void ", "").replace("(anonymous namespace)::", "")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out.append({"function": name.split("(")[0].replace(" ", ""),
                    "registers": int(regs.group(1)) if regs else -1,
                    "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                    if spill else -1),
                    "static_smem": int(smem.group(1)) if smem else 0})
    return out


def cuda_ms(fn, iters=50, warmup=3):
    """Mean CUDA-event ms of fn over iters launches after warmup ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes, kind):
    """(bound_ms, bound_by): the least time the card could take for work of
    ``ops`` operations of type ``kind`` that reads and writes ``nbytes``
    (each input read once, each output written once)."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def attention_bound(shape, dtype, tensors, flops_per_pair):
    """Kernels A and B: ``tensors`` [B, H, L, D] tensors of ``dtype`` read or
    written once, plus the fp32 [B, L] mask; ``flops_per_pair`` x B H L^2 D
    operations (A: 4, B: 10, the reference's CostEstimate,
    densephrases_tpu/models/attention.py:85-89, :148-152)."""
    b, h, l, d = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    return bound(flops_per_pair * b * h * l * l * d,
                 tensors * b * h * l * d * esize + 4 * b * l,
                 str(dtype).split(".")[-1])


def sdpa_bias(mask, dtype):
    """The additive mask as ``scaled_dot_product_attention`` takes it."""
    return ((1 - mask) * -1e9)[:, None, None, :].to(dtype)


def attention_inputs(b, h, l, d, dtype, gen):
    """q, k, v ~ N(0, 1); ragged masks, the last row fully masked (the
    dump's all-zero pad windows)."""
    q, k, v = (torch.randn(b, h, l, d, generator=gen).to("cuda", dtype)
               for _ in range(3))
    mask = torch.ones(b, l)
    for i in range(b):
        mask[i, max(1, l - 3 * i):] = 0
    mask[-1] = 0
    return q, k, v, mask.cuda()


def phase_kernels():
    from densephrases_tpu_torch.models.attention import (
        attention_cuda, attention_lse_plain, attention_plain)

    gen = torch.Generator().manual_seed(SEED)
    results = []
    for shape in ATTN_FWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(*shape, dtype, gen)
            out = attention_cuda(q, k, v, mask)
            ref = attention_plain(q, k, v, mask)
            # the training forward also writes the row logsumexp
            out_lse, lse = attention_cuda(q, k, v, mask, return_lse=True)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"non-finite kernel output at {shape}")
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - attention_lse_plain(q, k, mask)).abs().max())
            if not torch.equal(out_lse, out):
                raise AssertionError(f"the lse launch changed out at {shape}")
            tol = KERNEL_TOL[str(dtype).split(".")[-1]]
            # fully masked row: the uniform average of V, as in the reference
            uniform = v[-1].float().mean(dim=1, keepdim=True)
            err_masked = float((out[-1].float() - uniform).abs().max())
            # the yardstick: one PyTorch call of the same function (timed
            # here only; the port never calls it)
            bias = sdpa_bias(mask, dtype)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=bias)
            library_err = float((sdpa().float() - ref.float()).abs().max())
            ms = cuda_ms(lambda: attention_cuda(q, k, v, mask))
            plain_ms = cuda_ms(lambda: attention_plain(q, k, v, mask))
            library_ms = cuda_ms(sdpa)
            bound_ms, bound_by = attention_bound(shape, dtype, 4, 4)
            row = {"shape": "x".join(map(str, shape)),
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "tol": tol, "masked_row_err": err_masked,
                   "lse_err": lse_err, "lse_tol": LSE_TOL, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_err": library_err, "bound_ms": bound_ms,
                   "bound_by": bound_by, "share_of_bound": bound_ms / ms}
            log("2 kernels", kernel="attention_fwd", **row)
            if err > tol or err_masked > tol or lse_err > LSE_TOL:
                raise AssertionError(f"attention_fwd disagrees with plain: {row}")
            results.append(row)
    return results


def rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def phase_attention_bwd():
    """Phase 2b: kernel B against ``attention_bwd_plain``, and the autograd
    Function (kernels A + B) against torch autograd of ``attention_plain``."""
    from densephrases_tpu_torch.models.attention import (
        AttentionCuda, attention_bwd_plain, attention_cuda, attention_cuda_bwd,
        attention_lse_plain, attention_plain)

    gen = torch.Generator().manual_seed(SEED + 1)
    results = []
    for shape in ATTN_BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, mask = attention_inputs(*shape, dtype, gen)
            g = torch.randn(*shape, generator=gen).to("cuda", dtype)
            # B takes A's output and logsumexp, as AttentionCuda saves them
            out, lse = attention_cuda(q, k, v, mask, return_lse=True)
            got = attention_cuda_bwd(q, k, v, mask, g, out, lse)
            want = attention_bwd_plain(q, k, v, mask, g)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in got):
                raise AssertionError(f"non-finite kernel B output at {shape}")
            errs = {f"{n}_rel_err": rel_err(a, b)
                    for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
            # the yardstick: autograd through one PyTorch call of the same
            # forward, the forward outside the timed loop
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=sdpa_bias(mask, dtype))
            ms = cuda_ms(lambda: attention_cuda_bwd(q, k, v, mask, g, out, lse),
                         iters=20)
            bound_ms, bound_by = attention_bound(shape, dtype, 7, 10)
            row = {"shape": "x".join(map(str, shape)), "dtype": name,
                   **errs, "max_abs_err": abs_err,
                   "tol": ATTN_BWD_RTOL[name], "ms": ms,
                   "plain_ms": cuda_ms(
                       lambda: attention_bwd_plain(q, k, v, mask, g), iters=20),
                   "library_ms": cuda_ms(lambda: torch.autograd.grad(
                       lib_out, leaves, g, retain_graph=True), iters=20),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "share_of_bound": bound_ms / ms}
            log("2b attention_bwd", **row)
            if max(errs.values()) > ATTN_BWD_RTOL[name]:
                raise AssertionError(f"attention_bwd disagrees with plain: {row}")
            results.append(row)
            del q, k, v, g, out, lse, got, want, leaves, lib_out
    # every head-dim instance at ragged lengths (tails of partial tiles)
    for shape in ATTN_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, mask = attention_inputs(*shape, dtype, gen)
            g = torch.randn(*shape, generator=gen).to("cuda", dtype)
            out, lse = attention_cuda(q, k, v, mask, return_lse=True)
            errs = {"out_rel_err": rel_err(out, attention_plain(q, k, v, mask))}
            errs.update({f"{n}_rel_err": rel_err(a, b) for n, a, b in zip(
                ("dq", "dk", "dv"),
                attention_cuda_bwd(q, k, v, mask, g, out, lse),
                attention_bwd_plain(q, k, v, mask, g))})
            lse_err = float((lse - attention_lse_plain(q, k, mask)).abs().max())
            torch.cuda.synchronize()
            tols = {part: FN_VS_AUTOGRAD_RTOL[name] if part == "out_rel_err"
                    else ATTN_BWD_RTOL[name] for part in errs}
            log("2b attention_bwd", check="edge", shape="x".join(map(str, shape)),
                dtype=name, out_tol=tols["out_rel_err"],
                grad_tol=tols["dq_rel_err"], lse_err=lse_err, lse_tol=LSE_TOL,
                **errs)
            if not all(errs[part] <= tols[part] for part in errs) \
                    or lse_err > LSE_TOL:
                raise AssertionError(f"attention kernels disagree with plain "
                                     f"at {shape} {name}: {errs}")
    # forward + backward through AttentionCuda vs torch autograd of the plain
    # forward, at the phrase tower's training shape
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        q, k, v, mask = attention_inputs(*ATTN_BWD_SHAPES[0], dtype, gen)
        g = torch.randn(*ATTN_BWD_SHAPES[0], generator=gen).to("cuda", dtype)
        grads = {}
        for impl in ("kernel", "autograd"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fn = AttentionCuda.apply if impl == "kernel" else attention_plain
            out = fn(*leaves, mask)
            out.backward(g)
            grads[impl] = [out.detach()] + [t.grad for t in leaves]
        torch.cuda.synchronize()
        errs = {f"{n}_rel_err": rel_err(a, b) for n, a, b in zip(
            ("out", "dq", "dk", "dv"), grads["kernel"], grads["autograd"])}
        log("2b attention_bwd", check="function_vs_autograd", dtype=name,
            tol=FN_VS_AUTOGRAD_RTOL[name], **errs)
        if max(errs.values()) > FN_VS_AUTOGRAD_RTOL[name]:
            raise AssertionError(f"AttentionCuda disagrees with autograd of "
                                 f"attention_plain ({name}): {errs}")
    torch.cuda.empty_cache()
    return results


def synthetic_ivf():
    """A seeded IVF layout at the serve shape: 1M rows in 4,096 sorted lists
    of 128-384 rows, random centroids and a batch of 128 query rows; the
    batch's real block table at nprobe 16 and the guard budget."""
    from densephrases_tpu_torch.ops import ivf_pack as pack

    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 385, IVF_LISTS)
    lens = (lens * IVF_ROWS // lens.sum()).astype(np.int64)
    lens[-1] += IVF_ROWS - lens.sum()
    offs = np.concatenate([[0], np.cumsum(lens)])
    n_pad = pack._round_up(IVF_ROWS, pack.RB) + pack.RB  # + the pad block
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cents = torch.randn(IVF_LISTS, IVF_DIM, device=DEVICE, generator=gen)
    q = torch.randn(IVF_BATCH, IVF_DIM, device=DEVICE, generator=gen)
    cap = int(lens.max())
    table = pack.pack_budget_table(offs, cap)
    budget = pack._round_up(
        int(table[min(IVF_BATCH * IVF_NPROBE, IVF_LISTS) - 1]), 64)
    blk, total = pack.block_table(
        pack.probe(q, cents, IVF_NPROBE),
        torch.as_tensor(offs, device=DEVICE), nlist=IVF_LISTS, cap=cap,
        pad_blk=n_pad // pack.RB - 1, budget=budget)
    return {"q": q, "blk": blk, "total": int(total), "budget": budget,
            "n_pad": n_pad, "gen": gen, "cents": cents, "cap": cap,
            "offs": torch.as_tensor(offs, device=DEVICE)}


def random_codes(ivf, cols, dtype):
    """[n_pad, cols] random codes with all-zero pad rows, on the card."""
    codes = torch.zeros(ivf["n_pad"], cols, dtype=dtype, device=DEVICE)
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    codes[:IVF_ROWS] = torch.randint(lo, hi, (IVF_ROWS, cols), dtype=dtype,
                                     device=DEVICE, generator=ivf["gen"])
    return codes


def check_ivf_kernel(name, launch, plain, ivf, at, row_bytes, in_bytes,
                     ops_per_col, kind):
    """One kernel against its plain twin on the batch's block table: the
    valid columns agree and stay finite in a NaN-filled output buffer. The
    bound counts the valid rows' codes (``row_bytes`` each), the queries or
    LUTs (``in_bytes``), the block table and the fp32 scores of the valid
    columns, and ``ops_per_col`` operations of ``kind`` per valid column.
    No single PyTorch call computes either scan, so there is no
    ``library_ms``."""
    valid = ivf["total"] * 32
    out = torch.full((IVF_BATCH, ivf["budget"] * 32), float("nan"),
                     device=DEVICE)
    got = launch(out)
    ref = plain()
    torch.cuda.synchronize()
    if got.data_ptr() != out.data_ptr():
        raise AssertionError(f"{name}: the kernel did not write into out")
    if not bool(torch.isfinite(got[:, :valid]).all()):
        raise AssertionError(f"{name}: non-finite values in valid columns")
    err = float((got[:, :valid] - ref[:, :valid]).abs().max())
    tol = IVF_KERNEL_RTOL * float(ref[:, :valid].abs().max())
    ms = cuda_ms(lambda: launch(None), iters=20)
    bound_ms, bound_by = bound(
        ops_per_col * valid, valid * row_bytes + in_bytes
        + 4 * ivf["blk"].numel() + 4 * IVF_BATCH * valid, kind)
    row = {"at": at, "rows": valid, "budget_blocks": ivf["budget"],
           "max_abs_err": err, "tol": tol, "ms": ms,
           "plain_ms": cuda_ms(plain, iters=3, warmup=1), "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    log("2 kernels", kernel=name, **row)
    if err > tol:
        raise AssertionError(f"{name} disagrees with plain: {row}")
    return row


def phase_ivf_kernels():
    """Kernels C and D at the serve shape on the batch's real block table."""
    from densephrases_tpu_torch.ops import ivf_pack as pack

    ivf = synthetic_ivf()
    q_bf, blk = ivf["q"].to(torch.bfloat16), ivf["blk"]
    src, valid = pack._valid_rows(blk, ivf["total"], IVF_ROWS)
    src_valid = src[valid]
    row_perm = torch.arange(IVF_ROWS, dtype=torch.int32, device=DEVICE)
    scan_args = dict(top_k=IVF_SCAN_TOP_K, nprobe=IVF_NPROBE, cap=ivf["cap"],
                     budget=ivf["budget"], n_real=IVF_ROWS)
    rows = {"C": [], "D": []}
    for sq4 in (False, True):
        cols = IVF_DIM // 2 if sq4 else IVF_DIM
        codes = random_codes(ivf, cols, torch.int8)
        row = check_ivf_kernel(
            "ivf_pack_score",
            lambda out: pack.pack_score(q_bf, codes, blk, sq4=sq4, out=out),
            lambda: pack.pack_score_plain(q_bf, codes, blk, sq4=sq4), ivf,
            f"B={IVF_BATCH} D={IVF_DIM} {'SQ4' if sq4 else 'SQ8'}, "
            f"1M rows, {IVF_LISTS} lists, nprobe {IVF_NPROBE}",
            row_bytes=cols, in_bytes=2 * q_bf.numel(),
            ops_per_col=2 * IVF_BATCH * IVF_DIM, kind="bfloat16")
        # the product alone, as a yardstick (never library_ms, never called
        # by the port): the bf16 queries against the already gathered,
        # bf16-converted valid rows, without the gather or the unpacking
        tile = codes[src_valid]
        if sq4:  # the plain twin's unpack: high nibble = first half
            tile = tile.to(torch.int32) & 0xFF
            tile = torch.cat([tile >> 4, tile & 0xF], dim=1)
        tile = tile.to(torch.bfloat16).contiguous()
        row["product_only_ms"] = cuda_ms(lambda: torch.matmul(q_bf, tile.T),
                                         iters=20)
        del tile
        if not sq4:
            ms = cuda_ms(lambda: pack.packed_union_scan(
                ivf["q"], ivf["cents"], ivf["offs"], codes, row_perm, 0.0,
                1.0, **scan_args), iters=10)
            row.update(scan_ms=ms, kernel_share_of_scan=row["ms"] / ms)
        log("2 kernels", kernel="ivf_pack_score", at=row["at"],
            **{k: row[k] for k in ("product_only_ms", "scan_ms",
                                   "kernel_share_of_scan") if k in row})
        rows["C"].append(row)
        del codes
    refine = random_codes(ivf, IVF_DIM, torch.int8)[:IVF_ROWS]
    rot = torch.linalg.qr(torch.randn(IVF_DIM, IVF_DIM, device=DEVICE,
                                      generator=ivf["gen"]))[0]
    for m, ksub in ((96, 256), (192, 16)):
        cols = m if ksub == 256 else m // 2
        codes = random_codes(ivf, cols, torch.uint8)
        lut = torch.randn(IVF_BATCH, m, ksub, device=DEVICE,
                          generator=ivf["gen"]).to(torch.bfloat16)
        row = check_ivf_kernel(
            "pq_pack_score",
            lambda out: pack.pq_pack_score(lut, codes, blk, out=out),
            lambda: pack.pq_pack_score_plain(lut, codes, blk), ivf,
            f"B={IVF_BATCH} M={m} ksub={ksub}, 1M rows, {IVF_LISTS} lists, "
            f"nprobe {IVF_NPROBE}", row_bytes=cols, in_bytes=2 * lut.numel(),
            ops_per_col=IVF_BATCH * m, kind="float32")
        if ksub == 256:
            # OPQ96-like: rotated queries, the LUT from random books, the
            # int8 refine of top_k x refine_factor candidates
            books = torch.randn(m, ksub, IVF_DIM // m, device=DEVICE,
                                generator=ivf["gen"])
            ms = cuda_ms(lambda: pack.packed_pq_scan(
                ivf["q"], ivf["q"] @ rot, ivf["cents"], ivf["offs"], codes,
                row_perm, books, refine, 0.0, 1.0,
                scan_k=IVF_SCAN_TOP_K * IVF_REFINE_FACTOR, **scan_args),
                iters=10)
            row.update(scan_ms=ms, kernel_share_of_scan=row["ms"] / ms)
            log("2 kernels", kernel="pq_pack_score", at=row["at"],
                scan_ms=ms, kernel_share_of_scan=row["ms"] / ms)
        rows["D"].append(row)
        del codes, lut
    del refine
    torch.cuda.empty_cache()
    return rows


def phase_ivf_edges():
    """Kernels C and D at ragged shapes (``IVF_EDGE_*``) against their
    plain twins: the scored columns agree within ``IVF_KERNEL_RTOL`` of max
    |ref| and the all-junk tiles' columns keep the NaN they were filled
    with."""
    from densephrases_tpu_torch.ops import ivf_pack as pack

    gen = torch.Generator().manual_seed(SEED + 2)
    n_rows = IVF_EDGE_BLOCKS * pack.RB
    blk = torch.full((IVF_EDGE_BUDGET,), IVF_EDGE_BLOCKS, dtype=torch.int32)
    blk[:IVF_EDGE_REAL] = torch.randperm(IVF_EDGE_BLOCKS, generator=gen)[
        :IVF_EDGE_REAL].int()
    blk = blk.to(DEVICE)
    # columns of the tiles that hold a real entry, partly junk ones included
    scored = -(-IVF_EDGE_REAL // pack.TPB) * pack.TILE

    def codes_of(cols, dtype):
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        codes = torch.zeros(n_rows + pack.RB, cols, dtype=dtype)
        codes[:n_rows] = torch.randint(lo, hi, (n_rows, cols), dtype=dtype,
                                       generator=gen)
        return codes.to(DEVICE)

    def check(name, b, launch, plain, **at):
        out = torch.full((b, IVF_EDGE_BUDGET * pack.RB), float("nan"),
                         device=DEVICE)
        got, ref = launch(out), plain()
        torch.cuda.synchronize()
        err = rel_err(got[:, :scored], ref[:, :scored])
        untouched = bool(torch.isnan(got[:, scored:]).all())
        finite = bool(torch.isfinite(got[:, :scored]).all())
        log("2 kernels", kernel=name, check="edge", b=b, **at, rel_err=err,
            tol=IVF_KERNEL_RTOL, junk_tiles_unwritten=untouched)
        if not (finite and untouched and err <= IVF_KERNEL_RTOL):
            raise AssertionError(f"{name} at b={b} {at}: rel_err {err}, "
                                 f"finite {finite}, junk unwritten {untouched}")
        return err

    worst = {"C": 0.0, "D": 0.0}
    for b in IVF_EDGE_BATCHES:
        for dim, sq4 in IVF_EDGE_C:
            codes = codes_of(dim // 2 if sq4 else dim, torch.int8)
            q = torch.randn(b, dim, generator=gen).to(DEVICE, torch.bfloat16)
            worst["C"] = max(worst["C"], check(
                "ivf_pack_score", b,
                lambda out: pack.pack_score(q, codes, blk, sq4=sq4, out=out),
                lambda: pack.pack_score_plain(q, codes, blk, sq4=sq4),
                dim=dim, sq4=sq4))
        for m, ksub in IVF_EDGE_D:
            codes = codes_of(m if ksub == 256 else m // 2, torch.uint8)
            lut = torch.randn(b, m, ksub, generator=gen).to(DEVICE,
                                                           torch.bfloat16)
            worst["D"] = max(worst["D"], check(
                "pq_pack_score", b,
                lambda out: pack.pq_pack_score(lut, codes, blk, out=out),
                lambda: pack.pq_pack_score_plain(lut, codes, blk),
                m=m, ksub=ksub))
    return worst


def synthetic_corpus(rng, n_words=3000):
    """Whole-word vocab and ``N_DOCS`` docs of 600-1400 words, so most span
    more than one 512-token window."""
    from densephrases_tpu_torch.data.tokenization import SPECIAL_TOKENS

    words = [f"{a}{b}" for a in ("ka", "lo", "mi", "ru", "se", "ta")
             for b in range(n_words // 6)]
    vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS + words + [".", ","])}
    docs = []
    for i in range(N_DOCS):
        n_total = int(rng.integers(600, 1400))
        cuts = np.sort(rng.choice(np.arange(50, n_total - 50), 2, replace=False))
        bounds = [0, *cuts.tolist(), n_total]
        body = rng.choice(words, n_total)
        paras = [" ".join(body[a:b]) + " ." for a, b in zip(bounds, bounds[1:])]
        docs.append({"doc_id": i, "title": f"{words[i]} title",
                     "paragraphs": paras})
    return vocab, words, docs


def top1_spans(model, queries, top_k=1):
    """(doc, start, end, score) of each query's top phrase."""
    _, rets = model.search(queries, retrieval_unit="phrase", top_k=top_k,
                           return_meta=True)
    return [(r[0]["doc_idx"], r[0]["start_idx"], r[0]["end_idx"], r[0]["score"])
            for r in rets]


def recall_at(got, want):
    """Mean overlap of two [B, K] id arrays, per row."""
    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / len(w)
                          for g, w in zip(got, want)]))


def host_ms(fn, reps=5):
    """Median host-clock ms of fn, which ends with its results on the host,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_ivf(store, params, config, tok, flat_model, queries, rng):
    """Phase 5: build IVF indexes on the dumped store with the port and
    serve through them. Returns the launch counts of kernels C and D."""
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from densephrases_tpu_torch.index.oracle import check_top1
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, NEG_INF, PQ_PACK_SCORE)

    IVF_PACK_SCORE.launches = 0
    PQ_PACK_SCORE.launches = 0
    max_nlist = int(np.ceil(IVFConfig().nlist_growth_cap * IVF_CLUSTERS))

    def build(fq):
        stages = {}
        t0 = time.perf_counter()
        index = IVFIndex.build(store.vecs, IVFConfig(
            num_clusters=IVF_CLUSTERS, fine_quant=fq), device=DEVICE,
            stage_s=stages)
        torch.cuda.synchronize()
        log("5 ivf", build=fq, nlist=index.nlist, cap=index.cap,
            seconds=round(time.perf_counter() - t0, 3), **stages)
        if not IVF_CLUSTERS <= index.nlist <= max_nlist:
            raise AssertionError(f"{fq}: nlist {index.nlist} outside "
                                 f"[{IVF_CLUSTERS}, {max_nlist}]")
        return index

    models = {}
    for fq in ("SQ8", "OPQ96"):
        mips = MIPS(store, index=build(fq))
        models[fq] = DensePhrases(params, config, tok, mips,
                                  serve_dtype="bf16",
                                  max_query_length=MAX_QUERY_LENGTH)
        for unit in ("phrase", "sentence", "paragraph", "document"):
            answers, rets = models[fq].search(queries[:8], retrieval_unit=unit,
                                              top_k=5, return_meta=True)
            if not all(answers) or not all(
                    np.isfinite(r["score"]) for ret in rets for r in ret):
                raise AssertionError(f"{fq} {unit}: empty or non-finite")
            log("5 ivf", index=fq, unit=unit,
                first_answer=repr(answers[0][0][:40]))

    # full probe (the default nprobe 256 >= nlist): IVF-SQ8 = the flat path
    sample = queries[:QUERY_BATCH]
    got = top1_spans(models["SQ8"], sample, top_k=10)
    want = top1_spans(flat_model, sample, top_k=10)
    agree = sum(g[:3] == w[:3] for g, w in zip(got, want)) / len(sample)
    worst = max(abs(g[3] - w[3]) / max(1.0, abs(w[3]))
                for g, w in zip(got, want))
    log("5 ivf", check="full_probe_sq8_vs_flat_top1", agreement=agree,
        max_rel_score_diff=worst, tol=FULL_PROBE_RTOL)
    if worst > FULL_PROBE_RTOL:
        raise AssertionError("full-probe IVF-SQ8 top-1 spans differ from the "
                             "flat path's beyond a near-tie")

    # nprobe 16: recall@10 of the start hits against the flat index, and
    # the wall time of MIPS.search for a batch of 64 query vectors
    qvec = flat_model.query2vec(sample)
    flat_mips = flat_model.mips
    flat_ids = flat_mips.search_dense(qvec, top_k=10)[0].cpu().numpy()
    log("5 ivf", index="flat", batch=QUERY_BATCH,
        mips_search_ms=host_ms(lambda: flat_mips.search(qvec, top_k=10)))
    for fq, model in models.items():
        mips = model.mips
        ids = mips.search_dense(qvec, top_k=10, nprobe=SERVE_NPROBE)[0]
        log("5 ivf", index=fq, nprobe=SERVE_NPROBE, batch=QUERY_BATCH,
            recall_at_10_vs_flat=recall_at(ids.cpu().numpy(), flat_ids),
            mips_search_ms=host_ms(lambda: mips.search(
                qvec, nprobe=SERVE_NPROBE, top_k=10)))

    # the 4-bit branches of kernels C and D on the path
    stacked = torch.cat(qvec.chunk(2, dim=1), 0)
    for fq in ("SQ4", "OPQ192x4"):
        index = build(fq)
        vals, ids = index.search_union(stacked, top_k=10,
                                       nprobe=SERVE_NPROBE, as_numpy=False)
        vals = vals.cpu().numpy()
        live = vals > NEG_INF / 2
        if vals.shape != (IVF_BATCH, 10) or not live[:, 0].all() \
                or not np.isfinite(vals[live]).all():
            raise AssertionError(f"{fq}: malformed search_union results")
        log("5 ivf", index=fq, nprobe=SERVE_NPROBE, rows=IVF_BATCH,
            recall_at_10_vs_flat=recall_at(
                ids[:QUERY_BATCH].cpu().numpy(), flat_ids))

    verdicts = []
    for _ in range(3):
        q = rng.standard_normal(2 * config.hidden_size).astype(np.float32)
        top = models["SQ8"].mips.search(q[None], top_k=50,
                                        return_idxs=True)[0][0]
        verdicts.append(check_top1(store, q, top))
    log("5 ivf", oracle="pass", index="SQ8 full probe",
        verdicts=",".join(verdicts))
    counts = {"C": IVF_PACK_SCORE.launches, "D": PQ_PACK_SCORE.launches}
    log("5 ivf", c_launches=counts["C"], d_launches=counts["D"])
    if min(counts.values()) <= 0:
        raise AssertionError(f"phase 5 did not launch every IVF kernel: "
                             f"{counts}")
    return counts


def synthetic_squad(rng, docs, words_per_q=(4, 13)):
    """SQuAD-format rows from phase 3's corpus: one question per paragraph,
    its words drawn from the paragraph, its answer a 1-5 word span of it."""
    data = []
    for doc in docs:
        paras = []
        for j, para in enumerate(doc["paragraphs"]):
            pw = para.split(" ")
            s = int(rng.integers(0, len(pw) - 6))
            n = int(rng.integers(1, 6))
            question = " ".join(rng.choice(pw[:-1], int(rng.integers(*words_per_q))))
            paras.append({"context": para, "qas": [{
                "id": f"{doc['doc_id']}-{j}", "question": question,
                "answers": [{"text": " ".join(pw[s:s + n]),
                             "answer_start": len(" ".join(pw[:s])) + (1 if s else 0)}]}]})
        data.append({"title": doc["title"], "paragraphs": paras})
    return {"data": data}


def grads_by_tower(params, config, batch, impl, seed):
    """One rc_loss forward + backward over the trainable parameters with a
    fixed dropout seed: (loss, {tower: flat fp32 gradient})."""
    from densephrases_tpu_torch.models.encoder import RCLossConfig, rc_loss

    named = {n: p for n, p in params.named_parameters()
             if n.split(".")[0] in TRAINED and not n.endswith(".word_emb")}
    total, _ = rc_loss(params, config, batch, RCLossConfig(**TRAIN_LOSS),
                       dropout=torch.Generator().manual_seed(seed),
                       attn_impl=impl)
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    by_tower = {}
    for n, g in zip(named, grads):
        if g is not None:
            by_tower.setdefault(n.split(".")[0], []).append(g.float().ravel())
    return float(total.detach()), {k: torch.cat(v) for k, v in by_tower.items()}


def phase_train(tmp, params, config, tok, docs, mips, rng):
    """Phase 6: ``train_rc.main`` at BERT-base width on a synthetic SQuAD
    file, the saved encoder served, and one step through the kernels against
    one through the plain attention. Returns the launch counts of A and B
    in ``train_rc.main``."""
    from densephrases_tpu_torch.cli import train_rc
    from densephrases_tpu_torch.cli.common import load_encoder, save_encoder
    from densephrases_tpu_torch.data.features import convert_context_to_features
    from densephrases_tpu_torch.data.qa import load_rc_examples
    from densephrases_tpu_torch.data.rc_dataset import batches, convert_rc_examples
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.attention import ATTENTION_BWD, ATTENTION_FWD
    from densephrases_tpu_torch.models.encoder import RCLossConfig
    from densephrases_tpu_torch.train.cross_encoder import init_cross_params
    from densephrases_tpu_torch.train.rc import (
        create_train_state, make_optimizer, make_train_step)

    paths = {}
    for split, chunk in (("train", docs[:TRAIN_DOCS]),
                         ("dev", docs[TRAIN_DOCS:TRAIN_DOCS + DEV_DOCS])):
        paths[split] = os.path.join(tmp, f"{split}.json")
        with open(paths[split], "w") as f:
            json.dump(synthetic_squad(rng, chunk), f)
    init_dir, out_dir = os.path.join(tmp, "init"), os.path.join(tmp, "trained")
    save_encoder(init_dir, params, config, tok)
    argv = ["--load_dir", init_dir, "--train_file", paths["train"],
            "--dev_file", paths["dev"], "--output_dir", out_dir,
            "--lambda_neg", "2.0", "--lambda_flt", "1.0",  # Makefile:36
            "--lambda_kl", "2.0", "--pbn_size", "2",
            "--per_device_train_batch_size", str(TRAIN_BATCH),
            "--max_seq_length", str(TRAIN_SEQ), "--max_query_length",
            str(TRAIN_QUERY), "--warmup_steps", "1",
            "--max_steps", str(TRAIN_STEPS), "--logging_steps", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ATTENTION_FWD.launches = 0
    ATTENTION_BWD.launches = 0
    t0 = time.perf_counter()
    state, rates = train_rc.main(argv, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"A": ATTENTION_FWD.launches, "B": ATTENTION_BWD.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    parts = ("loss", "single_loss", "neg_loss", "filter_loss", "kl_loss")
    if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)) or not all(
            np.isfinite(r[k]) for r in rows for k in parts):
        raise AssertionError(f"train_rc: missing or non-finite losses: {rows}")
    for r in rows:
        log("6 train", step=r["step"], **{k: round(r[k], 4) for k in parts},
            grad_norm=round(r["grad_norm"], 3))
    # host clock between two logged steps; each log reads the loss, which
    # waits for the step to finish
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])]
    with open(os.path.join(out_dir, "eval_logger.txt")) as f:
        eval_line = f.read().strip()

    # kernel A: per step 36 tower forwards + 36 remat recomputes + 12 teacher
    # layers; then the dev eval (two query towers per batch of 16 questions,
    # the phrase tower per batch of 16 windows) and filter_test's one batch
    dev = load_rc_examples(paths["dev"])
    n_windows = sum(len(convert_context_to_features(
        i, ex["title"], [ex["context"]], tok, max_seq_length=TRAIN_SEQ,
        stride=128)[0]) for i, ex in enumerate(dev))
    layers = config.num_hidden_layers
    want = {"A": TRAIN_STEPS * 7 * layers + 2 * layers * -(-len(dev) // 16)
            + layers * -(-n_windows // 16) + layers,
            "B": TRAIN_STEPS * 3 * layers}
    log("6 train", steps=TRAIN_STEPS, wall_s=round(wall, 3),
        step_ms_median=float(np.median(step_ms)),
        steps_per_s=1e3 / float(np.median(step_ms)),
        peak_mem_gib=round(peak_gib, 3), a_launches=counts["A"],
        a_expected=want["A"], b_launches=counts["B"], b_expected=want["B"],
        eval=eval_line.replace("\t", " "),
        keep_rate_at_0=rates[0])
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")

    # the saved encoder serves
    trained, cfg2, tok2 = load_encoder(out_dir, device=DEVICE)
    answers, rets = DensePhrases(trained, cfg2, tok2, mips, serve_dtype="bf16",
                                 max_query_length=MAX_QUERY_LENGTH).search(
        [docs[0]["paragraphs"][0].split(" ")[3]], top_k=5, return_meta=True)
    if not answers[0] or not all(np.isfinite(r["score"]) for r in rets[0]):
        raise AssertionError("the trained encoder does not serve")
    log("6 train", served=repr(answers[0][0][:40]))
    del state, trained

    # one state, one batch: the kernels against the plain attention
    base, _, _ = load_encoder(init_dir, device=DEVICE)
    teacher = init_cross_params(config, torch.Generator().manual_seed(43),
                                device=DEVICE)
    base.cross, base.qa_outputs = teacher.cross, teacher.qa_outputs
    feats = convert_rc_examples(
        load_rc_examples(paths["train"]), tok, max_seq_length=TRAIN_SEQ,
        max_query_length=TRAIN_QUERY, with_teacher=True,
        max_cross_length=min(TRAIN_SEQ + TRAIN_QUERY,
                             config.max_position_embeddings))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             next(batches(feats, TRAIN_BATCH, seed=0)).items()}
    loss, grad = {}, {}
    for impl in ("cuda", "plain"):
        loss[impl], grad[impl] = grads_by_tower(base, config, batch, impl, 5)
    rel = abs(loss["cuda"] - loss["plain"]) / abs(loss["plain"])
    cos = {t: float(torch.nn.functional.cosine_similarity(
        grad["cuda"][t], grad["plain"][t], dim=0)) for t in grad["plain"]}
    del grad
    timing = {}
    for impl in ("plain", "cuda", "cuda", "plain"):
        opt = make_optimizer(lr=3e-5, warmup_steps=1, total_steps=100)
        st = create_train_state(base, opt, pbn_size=2,
                                batch_size=TRAIN_BATCH,
                                hidden=config.hidden_size)
        step = make_train_step(config, RCLossConfig(**TRAIN_LOSS), opt,
                               attn_impl=impl)
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = step(st, batch, torch.Generator().manual_seed(i))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        timing.setdefault(impl, []).extend(times[1:])
        del st, opt
    row = {"loss_kernel": loss["cuda"], "loss_plain": loss["plain"],
           "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
           **{f"grad_cos_{t}": c for t, c in cos.items()},
           "cos_min": TRAIN_GRAD_COS,
           "step_ms_kernel": float(np.median(timing["cuda"])),
           "step_ms_plain": float(np.median(timing["plain"]))}
    log("6 compare", **row)
    if rel > TRAIN_LOSS_RTOL or min(cos.values()) < TRAIN_GRAD_COS:
        raise AssertionError(f"train step: kernels and plain disagree: {row}")
    torch.cuda.empty_cache()
    return counts


def synthetic_qa(rng, docs, n):
    """Open-domain QA rows whose answers are corpus phrases: a 1-3 word span
    of a paragraph, asked with 4-9 words drawn from that paragraph."""
    rows = []
    for i in range(n):
        doc = docs[int(rng.integers(0, len(docs)))]
        words = doc["paragraphs"][int(rng.integers(0, len(doc["paragraphs"])))] \
            .split(" ")[:-1]
        s = int(rng.integers(0, len(words) - 3))
        rows.append({"id": f"q{i}",
                     "question": " ".join(rng.choice(words, int(rng.integers(4, 10)))),
                     "answers": [" ".join(words[s:s + int(rng.integers(1, 4))])]})
    return {"data": rows}


def device_bytes(build):
    """(result of build(), device bytes it left allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def refine_ids_agree(store, queries, host_ids, dev_ids):
    """(share of equal ids, max over differing positions of |Δ exact
    score| / bound). The device refine scores bf16(q) · code / scale and
    the host refine fp32 q · code / scale (the offset term is the same for
    every row of a query), so two rows may trade places when their exact
    scores lie within the sum of their bf16 bounds, 2^-8 Σ|q_d code_d| /
    scale each (plus fp32 rounding); a ratio above 1 is a disagreement."""
    worst = 0.0
    for b in range(queries.shape[0]):
        for j in np.nonzero(host_ids[b] != dev_ids[b])[0]:
            codes = np.asarray(store.vecs[[host_ids[b, j], dev_ids[b, j]]],
                               np.float64)
            q = queries[b].astype(np.float64)
            exact = codes @ q / store.scale
            tol = ((2.0 ** -8) * (np.abs(codes) @ np.abs(q)).sum()
                   / store.scale + 1e-5 * np.abs(exact).max())
            worst = max(worst, abs(exact[0] - exact[1]) / tol)
    return float((host_ids == dev_ids).mean()), worst


def phase_offline(tmp, params, config, tok, docs, store, flat_model, queries,
                  rng, windows):
    """Phase 7: the reference's offline workflow through the port's three
    drivers (dump → build index → evaluate) on phase 3's corpus and
    encoder, then the OPQ96 index served three ways (device refine, decode
    mode, host refine) and the int4 flat index beside the int8 one.
    Returns the launch counts of kernels A, C and D in the phase, which
    must equal what its path implies."""
    from densephrases_tpu_torch.cli import (
        build_phrase_index, eval_phrase_retrieval, generate_phrase_vecs)
    from densephrases_tpu_torch.cli.common import save_encoder
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.models.attention import ATTENTION_FWD
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE)

    root = os.path.join(tmp, "offline")
    corpus, enc, dump = (os.path.join(root, d) for d in ("corpus", "enc", "dump"))
    os.makedirs(corpus)
    per_file = -(-len(docs) // OFFLINE_FILES)
    for i in range(OFFLINE_FILES):
        with open(os.path.join(corpus, f"part{i}.json"), "w") as f:
            json.dump({"data": [{"title": d["title"], "paragraphs": [
                {"context": p} for p in d["paragraphs"]]}
                for d in docs[i * per_file:(i + 1) * per_file]]}, f)
    qa_path = os.path.join(root, "qa.json")
    with open(qa_path, "w") as f:
        json.dump(synthetic_qa(rng, docs, OFFLINE_QUESTIONS), f)
    save_encoder(enc, params, config, tok)
    layers = config.num_hidden_layers
    want = {"A": 0, "C": 0, "D": 0}
    ATTENTION_FWD.launches = 0
    IVF_PACK_SCORE.launches = 0
    PQ_PACK_SCORE.launches = 0

    # dump: phase 3's docs and encoder, phase 3's window length and batch
    t0 = time.perf_counter()
    dumped = generate_phrase_vecs.main(
        ["--load_dir", enc, "--data_dir", corpus, "--predict_file",
         f"0:{OFFLINE_FILES}", "--dump_dir", dump, "--max_seq_length", "512"],
        device=DEVICE)
    dump_s = time.perf_counter() - t0
    want["A"] += -(-windows // 16) * layers
    if dumped.vecs.shape != store.vecs.shape or not np.array_equal(
            dumped.doc_bases, store.doc_bases):
        raise AssertionError(f"generate_phrase_vecs' store "
                             f"{dumped.vecs.shape} is not phase 3's "
                             f"{store.vecs.shape}")
    step = np.abs(dumped.vecs.astype(np.int16) - store.vecs.astype(np.int16))
    log("7 offline", driver="generate_phrase_vecs", files=OFFLINE_FILES,
        docs=dumped.num_docs, vectors=dumped.n_vecs, seconds=round(dump_s, 3),
        codes_equal_share=float((step == 0).mean()), max_step=int(step.max()))
    if step.max() > 1:
        raise AssertionError("generate_phrase_vecs' codes differ from phase "
                             "3's by more than one int8 step")

    # two IVF builds (no kernel launches)
    for fq in ("SQ8", "OPQ96"):
        t0 = time.perf_counter()
        index = build_phrase_index.main(
            ["--dump_dir", dump, "--num_clusters", str(IVF_CLUSTERS),
             "--fine_quant", fq], device=DEVICE)
        torch.cuda.synchronize()
        log("7 offline", driver="build_phrase_index", index=fq,
            nlist=index.nlist, seconds=round(time.perf_counter() - t0, 3))
        del index

    # the eval over each index: per batch of questions, two query towers
    # and one union scan (C over SQ8, D over OPQ96 with its device refine)
    batches = -(-OFFLINE_QUESTIONS // OFFLINE_EVAL_BATCH)
    for fq, kernel in (("SQ8", "C"), ("OPQ96", "D")):
        out_dir = os.path.join(root, f"eval_{fq}")
        t0 = time.perf_counter()
        metrics = eval_phrase_retrieval.main(
            ["--load_dir", enc, "--dump_dir", dump, "--index_name",
             f"start/{IVF_CLUSTERS}_flat_{fq}", "--test_path", qa_path,
             "--top_k", "10", "--eval_batch_size", str(OFFLINE_EVAL_BATCH),
             "--save_dir", out_dir, "--max_query_length",
             str(MAX_QUERY_LENGTH)], device=DEVICE)
        want["A"] += batches * 2 * layers
        want[kernel] += batches
        pred = os.path.join(out_dir, "pred_qa.json_10.json")
        with open(pred) as f:
            n_pred = len(json.load(f))
        log("7 offline", driver="eval_phrase_retrieval", index=fq,
            questions=OFFLINE_QUESTIONS, seconds=round(time.perf_counter() - t0, 3),
            **{k: round(metrics[k], 2) for k in ("em_top1", "em_topk",
                                                 "f1_top1", "f1_topk")})
        if n_pred != OFFLINE_QUESTIONS or not all(
                np.isfinite(metrics[k]) for k in ("em_top1", "f1_top1")):
            raise AssertionError(f"eval over {fq}: {n_pred} predictions")

    # OPQ96 served three ways, and the int4 flat index beside the int8 one:
    # ms per batch of 64 query vectors (MIPS.search, results on the host)
    # and the device bytes each index + MIPS holds
    sample = queries[:QUERY_BATCH]
    qvec = flat_model.query2vec(sample)
    want["A"] += 2 * layers
    stacked = torch.cat(qvec.chunk(2, dim=1), 0)
    q_host = stacked.cpu().numpy()
    path = os.path.join(dump, "start", f"{IVF_CLUSTERS}_flat_OPQ96")
    corpus_bytes = store.n_vecs * store.dim
    served, ids = {}, {}
    for mode in ("device", "none", "host"):
        index, index_bytes = device_bytes(
            lambda: IVFIndex.load(path, refine_mode=mode, device=DEVICE))
        mips, mips_bytes = device_bytes(lambda: MIPS(dumped, index=index))
        ms = host_ms(lambda: mips.search(qvec, top_k=10))
        ids[mode] = index.search(stacked, top_k=10, as_numpy=True)[1]
        served[mode] = [r[0] for r in mips.search(qvec, top_k=10)]
        want["D"] += 6 + 1 + 1  # host_ms's 6 searches, the ids, the spans
        log("7 offline", index="OPQ96", refine_mode=mode,
            decode_mode=mips.pq_serve is not None,
            rescore_corpus_on_device=mips.vecs_dev is not None,
            index_bytes=index_bytes, mips_bytes=mips_bytes,
            device_bytes=index_bytes + mips_bytes, batch=QUERY_BATCH,
            ms_per_batch=ms, init_stages=json.dumps(mips.init_stages))
        if (mode == "device") != (mips.vecs_dev is not None) or \
                (mode != "device" and index_bytes + mips_bytes >= corpus_bytes):
            raise AssertionError(f"refine_mode {mode}: a corpus-sized int8 "
                                 f"tensor is on the device")
        del mips, index
    share, worst = refine_ids_agree(dumped, q_host, ids["host"], ids["device"])
    spans = lambda rets: [(r["doc_idx"], r["start_idx"], r["end_idx"])
                          for r in rets]
    overlap = float(np.mean([a == b for a, b in zip(
        spans(served["none"]), spans(served["device"]))]))
    log("7 offline", check="host_refine_vs_device_refine_top10",
        equal_share=share, worst_gap_over_bf16_bound=worst,
        decode_top1_equal_to_refine_top1=overlap,
        decode_top1_floor=DECODE_TOP1_FLOOR)
    if worst > 1.0:
        raise AssertionError("host refine and device refine disagree beyond "
                             "the bf16 rounding of the queries")
    if overlap < DECODE_TOP1_FLOOR:
        raise AssertionError(f"decode-mode top-1 spans equal the refine's "
                             f"for {overlap} of the queries")

    flat_ids = {}
    for quant in ("int8", "int4"):
        index, index_bytes = device_bytes(lambda: FlatIndex(
            dumped.vecs, dumped.offset, dumped.scale, quant=quant,
            device=DEVICE))
        mips, mips_bytes = device_bytes(lambda: MIPS(dumped, index=index))
        ms = host_ms(lambda: mips.search(qvec, top_k=10))
        flat_ids[quant] = mips.search_dense(qvec, top_k=10)[0].cpu().numpy()
        log("7 offline", index=f"flat {quant}", index_bytes=index_bytes,
            mips_bytes=mips_bytes, batch=QUERY_BATCH, ms_per_batch=ms)
        del mips, index
    log("7 offline", check="int4_flat_vs_int8_flat",
        recall_at_10=recall_at(flat_ids["int4"], flat_ids["int8"]))
    torch.cuda.empty_cache()

    counts = {"A": ATTENTION_FWD.launches, "C": IVF_PACK_SCORE.launches,
              "D": PQ_PACK_SCORE.launches}
    log("7 offline", **{f"{k.lower()}_launches": v for k, v in counts.items()},
        **{f"{k.lower()}_expected": v for k, v in want.items()})
    if counts != want:
        raise AssertionError(f"phase 7 launches {counts} != expected {want}")
    return counts


def scale_corpus(path, gen):
    """Write the seeded blob corpus [SCALE_ROWS, SCALE_DIM] int8 into an
    ``.npy`` memmap, made on the card in blocks of 65,536 rows (no corpus-
    sized float array anywhere). Returns the blob centres [SCALE_BLOBS,
    SCALE_DIM] fp32 on the card."""
    centres = (BLOB_SPREAD * torch.randn((SCALE_BLOBS, SCALE_DIM),
                                         generator=gen, device=DEVICE))
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int8,
                                   shape=(SCALE_ROWS, SCALE_DIM))
    step = 1 << 16
    for b0 in range(0, SCALE_ROWS, step):
        blob = torch.randint(0, SCALE_BLOBS, (step,), generator=gen,
                             device=DEVICE)
        rows = centres[blob] + BLOB_NOISE * torch.randn(
            (step, SCALE_DIM), generator=gen, device=DEVICE)
        mm[b0:b0 + step] = rows.round().clamp(-128, 127).to(torch.int8) \
            .cpu().numpy()
    mm.flush()
    del mm
    return centres


def same_files(a, b):
    """Whether two files hold the same bytes."""
    return filecmp.cmp(a, b, shallow=False)


def top1_with_scores(model, questions):
    """(answer, span score) of each question's top prediction, searched in
    the eval driver's batches (a tiered IVF's results depend on them)."""
    out = []
    for b0 in range(0, len(questions), OFFLINE_EVAL_BATCH):
        _, rets = model.search(questions[b0:b0 + OFFLINE_EVAL_BATCH],
                               retrieval_unit="phrase", top_k=10,
                               return_meta=True)
        out.extend((r[0]["answer"], r[0]["score"]) if r else ("", None)
                   for r in rets)
    return out


def phase_scale(tmp, config):
    """Phase 8: the reference-scale IVF build and the tiered serve.

    a. a seeded blob corpus, 2^20 x 768 int8, written as an ``.npy`` memmap;
    b. ``IVFIndex.build_coarse`` at 16,384 lists: two-level k-means,
       hierarchical assignment, balancing, into a coarse cache;
    c. on 65,536 rows, the hierarchical assignment against the flat argmin
       over the final centroids: agreement, and quantization error within
       HIER_ERR_RATIO of the flat one's;
    d. ``IVFIndex.build`` and ``build_host_save`` from that cache (their
       stage clocks are b's), the two save directories equal byte for byte;
    e. the in-HBM index (``search_union``, kernel C) against ``TieredIVF``
       on the host save, 128 query rows near the blobs, top-10, nprobe 16
       and 256: ids, scores, recall@10 against ``FlatIndex``, device bytes
       held after load + search, host-clock ms a batch, the tiered profile;
    f. ``TieredFlatIndex`` with half the corpus on the card against
       ``FlatIndex``;
    g. the drivers at their defaults on phase 7's dump: ``build_phrase_
       index --fine_quant SQ8`` with no ``--num_clusters`` (1,048,576,
       capped at N/4: two-level), then ``eval_phrase_retrieval`` over it on
       the device tier and on the host tier. Kernels A and C count from
       zero before g: A = 2 evals x batches x 2 towers x layers, C =
       batches (the device tier's union scans; the host tier launches no
       C). Then, outside the count, the top-1 predictions of the two tiers
       with their span scores.

    Returns the launch counts of A and C in g."""
    from densephrases_tpu_torch.cli import (
        build_phrase_index, eval_phrase_retrieval)
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from densephrases_tpu_torch.index.tiered import TieredFlatIndex, TieredIVF
    from densephrases_tpu_torch.models.attention import ATTENTION_FWD
    from densephrases_tpu_torch.ops.ivf_pack import IVF_PACK_SCORE, probe
    from densephrases_tpu_torch.ops.kmeans import (
        assign_blocks, assign_corpus_hier, sort_children)
    from densephrases_tpu_torch.ops.quant import DEFAULT_OFFSET, DEFAULT_SCALE

    root = os.path.join(tmp, "scale")
    os.makedirs(root)
    cc, dev_dir, host_dir = (os.path.join(root, d)
                             for d in ("coarse", "dev", "host"))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    # a. corpus
    t0 = time.perf_counter()
    corpus = os.path.join(root, "codes.npy")
    centres = scale_corpus(corpus, gen)
    codes = np.load(corpus, mmap_mode="r")
    log("8 scale", rows=SCALE_ROWS, dim=SCALE_DIM, blobs=SCALE_BLOBS,
        corpus_bytes=codes.nbytes, seconds=round(time.perf_counter() - t0, 3))

    # b. the two-level coarse build
    cfg = IVFConfig(num_clusters=SCALE_LISTS, fine_quant="SQ8")
    stages = {}
    t0 = time.perf_counter()
    centroids, assign, _ = IVFIndex.build_coarse(
        codes, cfg, coarse_cache=cc, stage_s=stages, device=DEVICE)
    torch.cuda.synchronize()
    l1 = np.load(os.path.join(cc, "km_l1.npy"))
    counts = np.bincount(assign, minlength=len(centroids))
    cap_nlist = int(np.ceil(cfg.nlist_growth_cap * SCALE_LISTS))
    log("8 scale", build="coarse", seconds=round(time.perf_counter() - t0, 3),
        k1=len(l1), nlist_requested=SCALE_LISTS, nlist=len(centroids),
        nlist_cap=cap_nlist, list_mean=round(float(counts.mean()), 2),
        longest=int(counts.max()),
        balance_cap=round(cfg.balance_factor * float(counts.mean()), 1),
        **stages)
    if not (cfg.two_level_clusters <= len(centroids) <= cap_nlist):
        raise AssertionError(f"nlist {len(centroids)} outside "
                             f"[{cfg.two_level_clusters}, {cap_nlist}]")
    if counts.max() > cfg.max_list_scan:
        raise AssertionError(f"longest list {counts.max()} would be "
                             f"truncated at {cfg.max_list_scan}")

    # c. hierarchical vs flat assignment on a sample, the final centroids
    sample = np.array(codes[:SCALE_SAMPLE])
    cents, offs, order = sort_children(centroids, l1, device=DEVICE)
    if not np.array_equal(order, np.arange(len(order))):
        raise AssertionError("the built centroids are not sorted by parent")
    hier = assign_corpus_hier(torch.from_numpy(sample).to(DEVICE), l1, cents,
                              offs, probe=cfg.assign_probe,
                              offset=DEFAULT_OFFSET, scale=DEFAULT_SCALE)
    flat = assign_blocks(sample, cents, chunk=2048, offset=DEFAULT_OFFSET,
                         scale=DEFAULT_SCALE, device=DEVICE)
    x = torch.from_numpy(sample).to(DEVICE).float() / DEFAULT_SCALE \
        + DEFAULT_OFFSET
    c_dev = torch.from_numpy(cents).to(DEVICE)

    def qerr(a):
        return float(((x - c_dev[torch.from_numpy(a).long().to(DEVICE)]) ** 2)
                     .sum(1).mean())

    err_h, err_f = qerr(hier), qerr(flat)
    log("8 scale", check="hier_vs_flat_assign", rows=SCALE_SAMPLE,
        agreement=float((hier == flat).mean()), qerr_hier=err_h,
        qerr_flat=err_f, ratio=err_h / err_f, limit=HIER_ERR_RATIO)
    if err_h > HIER_ERR_RATIO * err_f:
        raise AssertionError("hierarchical assignment error too far above "
                             "the flat argmin's")
    del x, c_dev

    # d. both builds from the cache, and their save directories
    s_dev, s_host = {}, {}
    t0 = time.perf_counter()
    index = IVFIndex.build(codes, cfg, coarse_cache=cc, stage_s=s_dev,
                           device=DEVICE)
    index.save(dev_dir)
    dev_s = time.perf_counter() - t0
    del index
    t0 = time.perf_counter()
    IVFIndex.build_host_save(codes, cfg, host_dir, coarse_cache=cc,
                             stage_s=s_host, device=DEVICE)
    host_s = time.perf_counter() - t0
    names = ("centroids", "row_perm", "list_offsets", "codes")
    equal = {n: same_files(os.path.join(dev_dir, f"{n}.npy"),
                           os.path.join(host_dir, f"{n}.npy")) for n in names}
    log("8 scale", build="from_cache", build_save_s=round(dev_s, 3),
        host_save_s=round(host_s, 3), fine_s=s_dev.get("fine_s"),
        files_equal=all(equal.values()))
    hit = {k: v for k, v in s_dev.items() if k != "fine_s"}
    if hit != stages or s_host != stages:
        raise AssertionError(f"coarse cache missed: {s_dev} {s_host} vs "
                             f"{stages}")
    if not all(equal.values()):
        raise AssertionError(f"save directories differ: {equal}")

    # e. in-HBM (kernel C) vs tiered IVF on the host save
    rng = np.random.default_rng(SEED)
    pick = torch.from_numpy(rng.integers(0, SCALE_BLOBS, SCALE_QUERIES)) \
        .to(DEVICE)
    q = ((centres[pick] + QUERY_NOISE * torch.randn(
        centres[pick].shape, generator=gen, device=DEVICE))
        / DEFAULT_SCALE).cpu().numpy()
    flat_index, flat_bytes = device_bytes(lambda: FlatIndex(codes,
                                                            device=DEVICE))
    exact = flat_index.search(q, top_k=10)
    flat_ms = host_ms(lambda: flat_index.search(q, top_k=10))
    os.environ["DPH_TIERED_PROFILE"] = "1"
    served = {}
    for kind in ("in_hbm", "tiered"):
        def load_and_search():
            ix = (IVFIndex.load(host_dir, device=DEVICE) if kind == "in_hbm"
                  else TieredIVF.load(host_dir, device=DEVICE))
            search = ix.search_union if kind == "in_hbm" else ix.search
            return ix, search, search(q, top_k=10, nprobe=SCALE_NPROBES[0])
        (ix, search, _), nbytes = device_bytes(load_and_search)
        for nprobe in SCALE_NPROBES:
            out = search(q, top_k=10, nprobe=nprobe)
            served[kind, nprobe] = out
            ms = host_ms(lambda: search(q, top_k=10, nprobe=nprobe))
            prof = (json.dumps(ix.last_profile) if kind == "tiered"
                    else None)
            log("8 scale", index=kind, nprobe=nprobe, batch=SCALE_QUERIES,
                recall_at_10_vs_flat=recall_at(out[1], exact[1]),
                device_bytes=nbytes, ms_per_batch=ms, profile=prof)
        del ix, search
    del os.environ["DPH_TIERED_PROFILE"]
    log("8 scale", index="flat", batch=SCALE_QUERIES, device_bytes=flat_bytes,
        ms_per_batch=flat_ms)
    tiered = TieredIVF.load(host_dir, device=DEVICE)
    sorted_pos = np.empty(tiered.n_total, np.int64)
    sorted_pos[tiered._row_perm[:tiered.n_total]] = np.arange(tiered.n_total)
    for nprobe in SCALE_NPROBES:
        (hv, hi), (tv, ti) = served["in_hbm", nprobe], served["tiered", nprobe]
        hi, ti = np.asarray(hi, np.int64), np.asarray(ti, np.int64)
        same = hi == ti
        # the same rows' scores: the same exact products, summed in fp32
        # in another order
        rel = float(np.abs(tv - hv)[same].max() / np.abs(hv).max())
        # an in-HBM hit the tiered scan lacks: is its list outside the
        # batch's probed union (an edge row of a neighbouring list, which
        # the in-HBM scan reads with its boundary block)?
        union = np.unique(probe(torch.from_numpy(q).to(DEVICE),
                                tiered.centroids, nprobe).cpu().numpy())
        lacked = [g for b in range(len(hi)) for g in set(hi[b]) - set(ti[b])]
        lists = np.searchsorted(tiered.list_offsets, sorted_pos[lacked],
                                side="right") - 1
        edge = int((~np.isin(lists, union)).sum())
        log("8 scale", check="in_hbm_vs_tiered_top10", nprobe=nprobe,
            id_agreement=float(same.mean()), max_rel_score_diff_same_ids=rel,
            in_hbm_hits_not_in_tiered=len(lacked),
            of_them_outside_the_union=edge,
            limits=f"{TIERED_ID_AGREE}/{TIERED_SCORE_RTOL}")
        if same.mean() < TIERED_ID_AGREE or rel > TIERED_SCORE_RTOL:
            raise AssertionError("tiered IVF and the in-HBM scan disagree")
    del tiered

    # f. tiered flat (half the corpus on the card) vs the flat index
    tflat, tbytes = device_bytes(lambda: TieredFlatIndex(
        codes, hbm_budget_bytes=codes.nbytes // 2, block_rows=1 << 18,
        device=DEVICE))
    got = tflat.search(q, top_k=10)
    agree = float((got[1] == exact[1]).mean())
    rel = float(np.abs(got[0] - exact[0]).max() / np.abs(exact[0]).max())
    log("8 scale", index="tiered_flat", resident_rows=tflat.n_resident,
        device_bytes=tbytes, ms_per_batch=host_ms(lambda: tflat.search(
            q, top_k=10)), id_agreement_vs_flat=agree,
        max_rel_score_diff=rel)
    if rel > TIERED_SCORE_RTOL or agree < TIERED_ID_AGREE:
        raise AssertionError("tiered flat index and the flat index disagree")
    del tflat, flat_index
    torch.cuda.empty_cache()

    # g. the drivers at their defaults on phase 7's dump
    off_root = os.path.join(tmp, "offline")
    enc, dump, qa_path = (os.path.join(off_root, d)
                          for d in ("enc", "dump", "qa.json"))
    layers = config.num_hidden_layers
    batches = -(-OFFLINE_QUESTIONS // OFFLINE_EVAL_BATCH)
    want = {"A": 2 * batches * 2 * layers, "C": batches}
    ATTENTION_FWD.launches = 0
    IVF_PACK_SCORE.launches = 0
    t0 = time.perf_counter()
    built = build_phrase_index.main(
        ["--dump_dir", dump, "--fine_quant", "SQ8"], device=DEVICE)
    name = "start/1048576_flat_SQ8"  # the default --num_clusters, uncapped
    log("8 scale", driver="build_phrase_index", index=name, nlist=built.nlist,
        vectors=built.n_total, seconds=round(time.perf_counter() - t0, 3))
    if built.nlist < IVFConfig().two_level_clusters:
        raise AssertionError(f"the default build made {built.nlist} lists")
    del built
    preds, argv = {}, {}
    for tier in ("device", "host"):
        out_dir = os.path.join(root, f"eval_{tier}")
        argv[tier] = ["--load_dir", enc, "--dump_dir", dump, "--index_name",
                      name, "--test_path", qa_path, "--top_k", "10",
                      "--eval_batch_size", str(OFFLINE_EVAL_BATCH),
                      "--save_dir", out_dir, "--max_query_length",
                      str(MAX_QUERY_LENGTH), "--index_tier", tier]
        t0 = time.perf_counter()
        metrics = eval_phrase_retrieval.main(argv[tier], device=DEVICE)
        preds[tier] = [p[0] if p else "" for p in metrics["predictions"]]
        log("8 scale", driver="eval_phrase_retrieval", index_tier=tier,
            questions=len(preds[tier]),
            seconds=round(time.perf_counter() - t0, 3),
            **{k: round(metrics[k], 2) for k in ("em_top1", "f1_top1")})
    counts = {"A": ATTENTION_FWD.launches, "C": IVF_PACK_SCORE.launches}
    log("8 scale", **{f"{k.lower()}_launches": v for k, v in counts.items()},
        **{f"{k.lower()}_expected": v for k, v in want.items()})
    if counts != want:
        raise AssertionError(f"phase 8 launches {counts} != expected {want}")

    # outside the count: the misses, with both tiers' span scores
    same = [a == b for a, b in zip(preds["device"], preds["host"])]
    with open(qa_path) as f:
        questions = [r["question"] for r in json.load(f)["data"]]
    worst = 0.0
    if not all(same):
        scored = {}
        for tier in ("device", "host"):
            opts = eval_phrase_retrieval.Options().parse(
                argv[tier], groups=["model", "index", "retrieval", "data"])
            scored[tier] = top1_with_scores(
                eval_phrase_retrieval.load_model(opts, device=DEVICE),
                questions)
        for i in np.nonzero(~np.asarray(same))[0]:
            (_, sd), (_, sh) = scored["device"][i], scored["host"][i]
            worst = max(worst, abs(sd - sh) / max(1.0, abs(sd)))
    log("8 scale", check="eval_device_vs_host_top1",
        agreement=float(np.mean(same)), misses=len(same) - sum(same),
        worst_miss_rel_score_gap=worst,
        limits=f"{DRIVER_TOP1_AGREE}/{NEAR_TIE_RTOL}")
    if np.mean(same) < DRIVER_TOP1_AGREE or worst > NEAR_TIE_RTOL:
        raise AssertionError("the eval's device and host tiers disagree")
    return counts


@contextlib.contextmanager
def timed_steps(module, factory):
    """While open, every train step that ``module.factory`` builds is timed
    on the card (a sync before and after; the trainers read each step's
    loss anyway). Yields the list of step ms."""
    times = []
    make = getattr(module, factory)

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    setattr(module, factory, wrapped)
    try:
        yield times
    finally:
        setattr(module, factory, make)


def checksum(*modules):
    """fp64 sum of every parameter of the modules."""
    return sum(float(p.detach().double().sum()) for m in modules
               for p in m.parameters())


def same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


def mlm_grads(params, config, batch, draws, impl, mask_id, seed):
    """One ``mlm_loss`` forward + backward with a fixed dropout seed:
    (loss, {"bert" | "mlm": flat fp32 gradient})."""
    from densephrases_tpu_torch.train.mlm import mlm_loss

    named = dict(params.named_parameters())
    loss, _ = mlm_loss(params, config, batch["input_ids"],
                       batch["attention_mask"], draws, mask_token_id=mask_id,
                       dropout=torch.Generator().manual_seed(seed),
                       attn_impl=impl)
    grads = torch.autograd.grad(loss, list(named.values()))
    parts = {}
    for n, g in zip(named, grads):
        parts.setdefault(n.split(".")[0], []).append(g.float().ravel())
    return float(loss.detach()), {k: torch.cat(v) for k, v in parts.items()}


def phase_trainers(tmp, config, tok, docs, smi):
    """Phase 9: the trainers through their entry points at BERT-base width,
    on phase 6's SQuAD file and phase 7's encoder, dump, OPQ96 index and QA
    file (see the module docstring, a-f). Kernels A, B and D count from
    zero right before each part and are read right after it; each part's
    counts must equal what its path implies. Returns the sums."""
    from densephrases_tpu_torch.cli import (
        train_cross_encoder, train_query, train_rc)
    from densephrases_tpu_torch.cli.common import load_encoder, save_encoder
    from densephrases_tpu_torch.data.features import (
        convert_questions_to_features)
    from densephrases_tpu_torch.data.qa import load_rc_examples
    from densephrases_tpu_torch.eval.reader import read_passages
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.index.store import PhraseStore
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.models.encoder import embed_query
    from densephrases_tpu_torch.models.hf_import import state_dict_from_encoder
    from densephrases_tpu_torch.ops.ivf_pack import PQ_PACK_SCORE
    from densephrases_tpu_torch.train import cross_encoder, mlm, query
    from densephrases_tpu_torch.train.cross_encoder import init_cross_params

    root = os.path.join(tmp, "trainers")
    os.makedirs(root)
    off = os.path.join(tmp, "offline")
    enc, dump, qa_path = (os.path.join(off, d)
                          for d in ("enc", "dump", "qa.json"))
    squad = os.path.join(tmp, "train.json")
    layers = config.num_hidden_layers
    kernels = {"A": ATTENTION_FWD, "B": ATTENTION_BWD, "D": PQ_PACK_SCORE}
    totals = {k: 0 for k in kernels}
    rc_shape = ["--max_seq_length", str(TRAIN_SEQ), "--max_query_length",
                str(TRAIN_QUERY)]

    base = {}

    def start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base["gib"] = torch.cuda.memory_allocated() / 2 ** 30
        for kernel in kernels.values():
            kernel.launches = 0
        return time.perf_counter()

    def finish(part, t0, want):
        """Read the counts right after a part's path; (wall s, peak GiB)."""
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: kernel.launches for k, kernel in kernels.items()}
        log("9 trainers", part=part,
            **{f"{k.lower()}_launches": v for k, v in got.items()},
            **{f"{k.lower()}_expected": v for k, v in want.items()})
        if got != want:
            raise AssertionError(f"phase 9 {part}: launches {got} != "
                                 f"expected {want}")
        for k, v in got.items():
            totals[k] += v
        return wall, torch.cuda.max_memory_allocated() / 2 ** 30

    def report(trainer, times, wall, peak, **extra):
        step_ms = float(np.median(times[1:] if len(times) > 1 else times))
        log("9 trainers", trainer=trainer, steps=len(times),
            wall_s=round(wall, 3), first_step_ms=times[0],
            step_ms_median=step_ms, steps_per_s=1e3 / step_ms,
            peak_mem_gib=round(peak, 3),
            held_before_gib=round(base["gib"], 3), card=repr(smi), **extra)

    # a. the teacher: one epoch at batch 12, cross length 448
    teacher_dir = os.path.join(root, "teacher")
    with timed_steps(cross_encoder, "make_cross_train_step") as times:
        t0 = start()
        teacher, losses = train_cross_encoder.main(
            ["--load_dir", enc, "--train_file", squad, "--output_dir",
             teacher_dir, "--per_device_train_batch_size", str(CROSS_BATCH),
             "--num_train_epochs", "1"] + rc_shape, device=DEVICE)
    steps = len(losses)
    wall, peak = finish("a cross_encoder", t0, {
        "A": 2 * layers * steps, "B": layers * steps, "D": 0})
    report("cross_encoder", times, wall, peak, batch=CROSS_BATCH,
           cross_len=TRAIN_SEQ + TRAIN_QUERY, loss_first=losses[0],
           loss_last=losses[-1])
    if not steps or not np.isfinite(losses).all() or not os.path.isdir(
            os.path.join(teacher_dir, "params")):
        raise AssertionError(f"train_cross_encoder: {steps} steps, losses "
                             f"{losses}, saved {os.listdir(teacher_dir)}")

    # b. the teacher into RC distillation: two steps
    t0 = start()
    state, _ = train_rc.main(
        ["--load_dir", enc, "--train_file", squad, "--output_dir",
         os.path.join(root, "rc_kl"), "--lambda_kl", "2.0", "--teacher_dir",
         teacher_dir, "--per_device_train_batch_size", str(TRAIN_BATCH),
         "--warmup_steps", "1", "--max_steps", "2"] + rc_shape,
        device=DEVICE)
    # per step 3 towers + their remat recomputes + the teacher; then
    # filter_test's one batch
    finish("b teacher_into_rc", t0, {"A": 2 * 7 * layers + layers,
                                     "B": 2 * 3 * layers, "D": 0})
    random = init_cross_params(config, torch.Generator().manual_seed(43),
                               device=DEVICE)  # what no --teacher_dir gives
    sums = {"loaded": checksum(state.params.cross, state.params.qa_outputs),
            "trained": checksum(teacher.cross, teacher.qa_outputs),
            "random": checksum(random.cross, random.qa_outputs)}
    equal = (same_params(state.params.cross, teacher.cross)
             and same_params(state.params.qa_outputs, teacher.qa_outputs))
    log("9 trainers", part="b teacher_into_rc", teacher_checksums=sums,
        teacher_equal_to_a=equal)
    if not equal or sums["loaded"] == sums["random"]:
        raise AssertionError("train_rc did not load the trained teacher")
    del state, random

    # c. the reader: 64 (question, passage) pairs at max_length 384
    examples = load_rc_examples(squad)[:READER_PAIRS]
    qs = [e["question"] for e in examples]
    ps = [e["context"] for e in examples]
    t0 = start()
    got = read_passages(teacher, config, tok, qs, ps, max_length=READER_LEN)
    finish("c reader", t0, {"A": layers, "B": 0, "D": 0})
    want = read_passages(teacher, config, tok, qs, ps, max_length=READER_LEN,
                         attn_impl="plain")
    same = [(g["start_pos"], g["end_pos"]) == (w["start_pos"], w["end_pos"])
            for g, w in zip(got, want)]
    gap = max(abs(g["score"] - w["score"]) / max(1.0, abs(w["score"]))
              for g, w in zip(got, want))
    log("9 trainers", part="c reader", pairs=len(qs), span_agreement=float(
        np.mean(same)), max_rel_score_gap=gap, tol=READER_SCORE_RTOL,
        ms=host_ms(lambda: read_passages(teacher, config, tok, qs, ps,
                                         max_length=READER_LEN), reps=3),
        plain_ms=host_ms(lambda: read_passages(
            teacher, config, tok, qs, ps, max_length=READER_LEN,
            attn_impl="plain"), reps=3),
        first_answer=repr(got[0]["answer"][:40]))
    if len(got) != len(qs) or gap > READER_SCORE_RTOL or not all(
            g["context"][g["start_pos"]:g["end_pos"]] == g["answer"]
            for g in got):
        raise AssertionError("reader: kernel and plain answers disagree")
    del teacher

    # d. MLM at the phase's width (BertConfig()) over phase 3's corpus and
    # whole-word vocab
    mcfg = dataclasses.replace(config, vocab_size=tok.vocab_size)
    texts = [p for d in docs for p in d["paragraphs"]]
    with timed_steps(mlm, "make_mlm_step") as times:
        t0 = start()
        mparams, hist = mlm.pretrain_mlm(
            texts, tok, mcfg, steps=MLM_STEPS, batch_size=MLM_BATCH,
            seq_len=MLM_SEQ, log_every=1, seed=SEED, device=DEVICE)
    wall, peak = finish("d mlm", t0, {"A": 2 * layers * MLM_STEPS,
                                      "B": layers * MLM_STEPS, "D": 0})
    report("mlm", times, wall, peak, batch=MLM_BATCH, seq=MLM_SEQ,
           loss=hist["loss"], acc=hist["acc"])
    if len(hist["loss"]) != MLM_STEPS or not np.isfinite(hist["loss"]).all():
        raise AssertionError(f"pretrain_mlm: {hist}")
    mlm_dir = os.path.join(root, "mlm_enc")
    save_encoder(mlm_dir, mlm.encoder_params_from_backbone(
        mparams.bert, mcfg, torch.Generator().manual_seed(SEED)), mcfg, tok)
    loaded, lcfg, _ = load_encoder(mlm_dir, device=DEVICE)
    if lcfg != mcfg or not all(same_params(getattr(loaded, t), mparams.bert)
                               for t in ("phrase", "query_start", "query_end")):
        raise AssertionError("the MLM backbone did not reload as the towers")
    del loaded
    # one step through the kernels against one through the plain attention
    rows = mlm.pack_chunks(texts, tok, MLM_SEQ)[:MLM_BATCH]
    batch = {"input_ids": torch.as_tensor(rows, device=DEVICE),
             "attention_mask": torch.as_tensor(
                 (rows != tok.pad_token_id).astype(np.int32), device=DEVICE)}
    draws = mlm.mlm_draws(tuple(rows.shape), mcfg.vocab_size,
                          torch.Generator(device=DEVICE).manual_seed(SEED))
    loss, grad = {}, {}
    for impl in ("cuda", "plain"):
        loss[impl], grad[impl] = mlm_grads(mparams, mcfg, batch, draws, impl,
                                           tok.mask_token_id, 5)
    rel = abs(loss["cuda"] - loss["plain"]) / abs(loss["plain"])
    cos = {k: float(torch.nn.functional.cosine_similarity(
        grad["cuda"][k], grad["plain"][k], dim=0)) for k in grad["plain"]}
    del grad
    timing = {}
    for impl in ("plain", "cuda", "cuda", "plain"):
        opt = mlm.make_mlm_optimizer(1e-4, 1, 100)
        st = opt.init(dict(mparams.named_parameters()))
        step = mlm.make_mlm_step(mcfg, opt, mask_token_id=tok.mask_token_id,
                                 attn_impl=impl)
        ms = []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(mparams, st, batch, draws, torch.Generator().manual_seed(i))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
        timing.setdefault(impl, []).extend(ms[1:])
        del opt, st
    row = {"loss_kernel": loss["cuda"], "loss_plain": loss["plain"],
           "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
           **{f"grad_cos_{k}": c for k, c in cos.items()},
           "cos_min": TRAIN_GRAD_COS,
           "step_ms_kernel": float(np.median(timing["cuda"])),
           "step_ms_plain": float(np.median(timing["plain"]))}
    log("9 compare", trainer="mlm", **row)
    if rel > TRAIN_LOSS_RTOL or min(cos.values()) < TRAIN_GRAD_COS:
        raise AssertionError(f"MLM step: kernels and plain disagree: {row}")
    del mparams, batch, draws
    torch.cuda.empty_cache()

    # e. query-side fine-tuning over phase 7's OPQ96 index (device refine)
    index_name = f"start/{IVF_CLUSTERS}_flat_OPQ96"
    out_dir = os.path.join(root, "qsft")
    with timed_steps(query, "make_query_train_step") as times:
        t0 = start()
        hist = train_query.main(
            ["--load_dir", enc, "--dump_dir", dump, "--index_name",
             index_name, "--train_file", qa_path, "--dev_file", qa_path,
             "--per_device_train_batch_size", str(QSFT_BATCH),
             "--qsft_top_k", str(QSFT_TOP_K), "--qsft_epochs", "1",
             "--label_strat", "phrase,doc",
             "--max_query_length", str(MAX_QUERY_LENGTH), "--output_dir",
             out_dir], device=DEVICE)
    steps, skipped = hist["steps"][0], hist["skipped"][0]
    n_batches = -(-OFFLINE_QUESTIONS // QSFT_BATCH)
    dev_batches = -(-OFFLINE_QUESTIONS // 64)  # DensePhrases.evaluate's
    # per batch: the searcher's two query towers and one OPQ96 scan; per
    # step the two towers forward, their remat recomputes and backward;
    # the dev eval's towers and scans
    wall, peak = finish("e query_ft", t0, {
        "A": 2 * layers * (n_batches + dev_batches) + 4 * layers * steps,
        "B": 2 * layers * steps, "D": n_batches + dev_batches})
    report("query_ft", times, wall, peak, batch=QSFT_BATCH, top_k=QSFT_TOP_K,
           batches=n_batches, skipped=skipped, loss=hist["loss"],
           top1=hist["top1"], dev_em=hist["dev_em"])
    if steps + skipped != n_batches or not steps or len(hist["dev_em"]) != 1 \
            or not np.isfinite(hist["loss"]).all():
        raise AssertionError(f"train_query: {hist}")
    trained, cfg2, tok2 = load_encoder(out_dir, device=DEVICE)
    source, _, _ = load_encoder(enc, device=DEVICE)
    with open(qa_path) as f:
        questions = [r["question"] for r in json.load(f)["data"]]
    mips = MIPS(PhraseStore.load(os.path.join(dump, "phrase")),
                index=IVFIndex.load(os.path.join(dump, index_name),
                                    device=DEVICE))
    answers = DensePhrases(trained, cfg2, tok2, mips,
                           max_query_length=MAX_QUERY_LENGTH).search(
        questions[:4], top_k=5)
    moved = not torch.equal(trained.query_start.layers[0].q_w,
                            source.query_start.layers[0].q_w)
    log("9 trainers", part="e query_ft", served=repr(answers[0][:2]),
        query_towers_moved=moved,
        phrase_tower_kept=same_params(trained.phrase, source.phrase))
    if not all(answers) or not moved or not same_params(trained.phrase,
                                                        source.phrase):
        raise AssertionError("the query-FT encoder does not serve")
    del trained, mips

    # f. phase 7's encoder as a pytorch_model.bin (old prefixes, bert level)
    hf_dir = os.path.join(root, "hf")
    os.makedirs(hf_dir)
    torch.save(state_dict_from_encoder(source, spelling=1, bert_level=True),
               os.path.join(hf_dir, "pytorch_model.bin"))
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(enc, name), hf_dir)
    imported, _, _ = load_encoder(hf_dir, device=DEVICE)
    feats = convert_questions_to_features(questions[:QUERY_BATCH], tok,
                                          MAX_QUERY_LENGTH)
    ids, am, tt = (torch.as_tensor(np.stack([getattr(f, k) for f in feats]),
                                   device=DEVICE)
                   for k in ("input_ids", "attention_mask", "token_type_ids"))
    t0 = start()
    want_q = embed_query(source, ids, am, tt, compute_dtype=torch.float32)
    got_q = embed_query(imported, ids, am, tt, compute_dtype=torch.float32)
    finish("f hf_import", t0, {"A": 4 * layers, "B": 0, "D": 0})
    err = max(rel_err(g, w) for g, w in zip(got_q, want_q))
    again = embed_query(source, ids, am, tt, compute_dtype=torch.float32)
    log("9 trainers", part="f hf_import",
        bin_bytes=os.path.getsize(os.path.join(hf_dir, "pytorch_model.bin")),
        weights_equal=same_params(imported, source), query_rel_err=err,
        source_vs_itself=max(rel_err(a, w) for a, w in zip(again, want_q)),
        tol=HF_QUERY_RTOL)
    if not same_params(imported, source) or err > HF_QUERY_RTOL:
        raise AssertionError("pytorch_model.bin import differs from the source")
    del imported, source
    torch.cuda.empty_cache()
    return totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "densephrases_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from densephrases_tpu_torch.data.features import convert_context_to_features
    from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
    from densephrases_tpu_torch.dump import dump_phrases
    from densephrases_tpu_torch.index.oracle import check_top1
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE)
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import (
        embed_phrase, init_encoder_params)
    from densephrases_tpu_torch.serve.fused import FusedServer

    t_start = time.perf_counter()
    # ---- 0. device
    smi = nvidia_smi()
    log("0 device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(smi, flush=True)

    # ---- 1. build: one nvcc per source, all started together
    kernels = {"attention_fwd": ATTENTION_FWD,
               "attention_bwd": ATTENTION_BWD,
               "ivf_pack_score": IVF_PACK_SCORE,
               "pq_pack_score": PQ_PACK_SCORE}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.function(), kernels.values()))
    log("1 build", kernels=len(kernels),
        wall_s=round(time.perf_counter() - t0, 2))
    for name, kernel in kernels.items():
        instances = ptxas_summary(kernel.build_log)
        log("1 build", kernel=name, compiled=kernel.build_seconds is not None,
            seconds=round(kernel.build_seconds or 0.0, 2),
            instances=len(instances),
            spill_bytes=sum(i["spill_bytes"] for i in instances))
        for inst in instances:
            log("1 build", kernel=name, **inst)

    # ---- 2. kernels vs plain
    kernel_rows = phase_kernels()
    bwd_rows = phase_attention_bwd()
    ivf_rows = phase_ivf_kernels()
    ivf_edge_err = phase_ivf_edges()

    # ---- 3. dump (main path starts: launch counters from zero)
    rng = np.random.default_rng(SEED)
    vocab, words, docs = synthetic_corpus(rng)
    tok = WordPieceTokenizer(vocab)
    config = BertConfig()  # BERT-base width and depth
    params = init_encoder_params(config, torch.Generator().manual_seed(SEED),
                                 device="cuda")
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_dir.name
    ATTENTION_FWD.launches = 0
    stats = {}
    t0 = time.perf_counter()
    store = dump_phrases(params, config, tok, docs, os.path.join(tmp, "store"),
                         batch_size=16, _stats=stats)
    dump_s = time.perf_counter() - t0
    dump_launches = ATTENTION_FWD.launches
    log("3 dump", docs=store.num_docs, vectors=store.n_vecs,
        windows=stats["windows"], seconds=round(dump_s, 3),
        windows_per_s=round(stats["windows"] / dump_s, 2),
        attention_launches=dump_launches)
    n_batches = -(-stats["windows"] // 16)
    if dump_launches != n_batches * config.num_hidden_layers:
        raise AssertionError(f"dump launched attention_fwd {dump_launches} "
                             f"times, expected {n_batches} x 12")
    if stats["windows"] <= N_DOCS or store.num_docs != N_DOCS:
        raise AssertionError(f"corpus too small: {stats}")
    if store.vecs.shape != (store.n_vecs, config.hidden_size) \
            or float(store.vecs.std()) < 1.0:
        raise AssertionError("dumped vectors are degenerate")

    # ---- 4. serve
    mips = MIPS(store, device="cuda")
    model = DensePhrases(params, config, tok, mips, serve_dtype="bf16",
                         max_query_length=MAX_QUERY_LENGTH)
    queries = [" ".join(rng.choice(words, int(rng.integers(4, 14))))
               for _ in range(QUERY_BATCH * (N_BATCHES + 1))]
    for unit in ("phrase", "sentence", "paragraph", "document"):
        answers, rets = model.search(queries[:8], retrieval_unit=unit, top_k=5,
                                     return_meta=True)
        if not all(answers) or not all(
                np.isfinite(r["score"]) for ret in rets for r in ret):
            raise AssertionError(f"{unit}: empty or non-finite results")
        log("4 serve", unit=unit, first_answer=repr(answers[0][0][:40]))
    fused = FusedServer(model)
    fused.search(queries[:QUERY_BATCH], top_k=10)  # warm-up
    t0 = time.perf_counter()
    fused.search(queries[:QUERY_BATCH], top_k=10)
    log("4 serve", fused_sync_ms=round(1e3 * (time.perf_counter() - t0), 2),
        batch=QUERY_BATCH)
    batches = [queries[QUERY_BATCH * (i + 1):QUERY_BATCH * (i + 2)]
               for i in range(N_BATCHES)]
    t0 = time.perf_counter()
    outs = fused.search_pipelined(batches, depth=2, top_k=10)
    wall = time.perf_counter() - t0
    if [len(o) for o in outs] != [QUERY_BATCH] * N_BATCHES or not all(
            r and r[0]["answer"] == r[0]["context"][r[0]["start_pos"]:r[0]["end_pos"]]
            for o in outs for r in o):
        raise AssertionError("fused serve returned malformed results")
    log("4 serve", fused_batches=N_BATCHES, batch=QUERY_BATCH,
        wall_s=round(wall, 4), ms_per_batch=round(1e3 * wall / N_BATCHES, 2),
        queries_per_s=round(N_BATCHES * QUERY_BATCH / wall, 1))
    verdicts = []
    for _ in range(3):
        q = rng.standard_normal(2 * config.hidden_size).astype(np.float32)
        top = mips.search(q[None], top_k=50, return_idxs=True)[0][0]
        verdicts.append(check_top1(store, q, top))
    log("4 serve", oracle="pass", verdicts=",".join(verdicts))
    serve_launches = ATTENTION_FWD.launches - dump_launches
    log("4 serve", attention_launches=serve_launches)
    if serve_launches <= 0:
        raise AssertionError("serving never launched attention_fwd")
    main_path_launches = ATTENTION_FWD.launches

    # ---- comparisons with the plain version (launches here do not count)
    feats, _ = convert_context_to_features(
        0, docs[0]["title"], docs[0]["paragraphs"], tok)
    ids, am, tt = (torch.as_tensor(np.stack([getattr(f, k) for f in feats]),
                                   device="cuda")
                   for k in ("input_ids", "attention_mask", "token_type_ids"))
    h_kernel = embed_phrase(params, ids, am, tt)[0]
    h_plain = embed_phrase(params, ids, am, tt, attn_impl="plain")[0]
    dh = (h_kernel - h_plain).abs()
    log("4 compare", what="phrase_tower_hidden", max_abs=float(dh.max()),
        mean_abs=float(dh.mean()))
    if not (float(dh.mean()) < 2e-2 and float(dh.max()) < 0.5):
        raise AssertionError("phrase tower: kernel and plain paths disagree")
    plain_model = DensePhrases(params, config, tok, mips, serve_dtype="bf16",
                               max_query_length=MAX_QUERY_LENGTH,
                               attn_impl="plain")
    sample = queries[:QUERY_BATCH]
    got, want = top1_spans(model, sample), top1_spans(plain_model, sample)
    agree = sum(g[:3] == w[:3] for g, w in zip(got, want)) / len(sample)
    score_err = max(abs(g[3] - w[3]) / max(1.0, abs(w[3]))
                    for g, w in zip(got, want))
    log("4 compare", what="serve_top1", exact_agreement=agree,
        max_rel_score_diff=score_err, tol=SCORE_RTOL)
    if score_err > SCORE_RTOL:
        raise AssertionError("serve: kernel and plain top-1 scores disagree")

    # ---- 5. ivf (main path: C and D launch counters from zero)
    ivf_launches = phase_ivf(store, params, config, tok, model, queries, rng)

    # ---- 6. train (main path: A and B launch counters from zero)
    train_launches = phase_train(tmp, params, config, tok, docs, mips, rng)

    # ---- 7. offline drivers (main path: A, C and D counters from zero)
    offline_launches = phase_offline(tmp, params, config, tok, docs, store,
                                     model, queries, rng, stats["windows"])

    # ---- 8. scale (g's path: A and C counters from zero)
    scale_launches = phase_scale(tmp, config)

    # ---- 9. trainers (A, B and D counters from zero before each part)
    trainer_launches = phase_trainers(tmp, config, tok, docs, smi)

    def timing(row, *rows):
        """The line's numbers for one kernel from its headline row; every
        row's numbers beside them."""
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        out = {k: row[k] for k in keys}
        out["rows"] = [{"at": r.get("shape", r.get("at")),
                        **{k: r[k] for k in ("dtype", *keys) if k in r}}
                       for r in rows]
        return out

    bf16 = lambda rows: [r for r in rows if r["dtype"] == "bfloat16"]
    serve_row = next(r for r in kernel_rows
                     if r["shape"] == "64x12x32x64" and r["dtype"] == "bfloat16")
    bwd_row = next(r for r in bwd_rows
                   if r["shape"] == "12x12x384x64" and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "densephrases_tpu/models/attention.py:44",
        "launches": (main_path_launches + train_launches["A"]
                     + offline_launches["A"] + scale_launches["A"]
                     + trainer_launches["A"]),
        "launches_by_path": {"dump_serve": main_path_launches,
                             "train": train_launches["A"],
                             "offline": offline_launches["A"],
                             "scale": scale_launches["A"],
                             "trainers": trainer_launches["A"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        **timing(serve_row, *bf16(kernel_rows)),
        "at": "B=64 H=12 L=32 D=64 bf16"}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "densephrases_tpu/models/attention.py:94",
        "launches": train_launches["B"] + trainer_launches["B"],
        "launches_by_path": {"train": train_launches["B"],
                             "trainers": trainer_launches["B"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        **timing(bwd_row, *bf16(bwd_rows)),
        "at": "B=12 H=12 L=384 D=64 bf16"}, {
        "name": "ivf_pack_score", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/ivf_pack_score.cu",
        "replaces": "densephrases_tpu/ops/ivf_pack.py:94",
        "launches": (ivf_launches["C"] + offline_launches["C"]
                     + scale_launches["C"]),
        "launches_by_path": {"ivf": ivf_launches["C"],
                             "offline": offline_launches["C"],
                             "scale": scale_launches["C"]},
        "max_abs_err": max(r["max_abs_err"] for r in ivf_rows["C"]),
        **timing(ivf_rows["C"][0], *ivf_rows["C"]),
        "product_only_ms": [r["product_only_ms"] for r in ivf_rows["C"]],
        "edge_rel_err": ivf_edge_err["C"],
        "at": ivf_rows["C"][0]["at"]}, {
        "name": "pq_pack_score", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/pq_pack_score.cu",
        "replaces": "densephrases_tpu/ops/ivf_pack.py:343",
        "launches": (ivf_launches["D"] + offline_launches["D"]
                     + trainer_launches["D"]),
        "launches_by_path": {"ivf": ivf_launches["D"],
                             "offline": offline_launches["D"],
                             "trainers": trainer_launches["D"]},
        "max_abs_err": max(r["max_abs_err"] for r in ivf_rows["D"]),
        **timing(ivf_rows["D"][0], *ivf_rows["D"]),
        "edge_rel_err": ivf_edge_err["D"],
        "at": ivf_rows["D"][0]["at"]}]}), flush=True)
    tmp_dir.cleanup()
    log("done", total_s=round(time.perf_counter() - t_start, 1))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
