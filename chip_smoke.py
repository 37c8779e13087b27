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
                 ragged shapes (``IVF_EDGE_*``); then E (the flat int8 scan
                 with its per-tile top-k) and its merge against the chunked
                 loop at the flat serve shape (``FLAT_*``: 1M x 768, 128
                 query rows, k 10), one launch a scan, with bf16
                 ``torch.matmul`` and ``torch.topk`` as its yardstick
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
  10. scale_out  the multi-device path on one card: a. NCCL at one rank (a
                 mesh ``FlatIndex`` and a DP train step, bit for bit the
                 non-mesh path's); b. 4 gloo ranks sharing the card: phase
                 8's corpus on a mesh ``FlatIndex`` and ``MeshShardedIVF``
                 SQ8 / OPQ96 at 4 x 4,096 lists, against ``FlatIndex`` and
                 ``ShardedIVF`` in this process; c. 2 gloo ranks: ``MIPS(
                 store, mesh=)`` over phase 3's store (four units, oracle),
                 the first DP step against one process on the global batch
                 of 24, a step under each remat mode, ``train_rc.main``
                 (3 steps "full", a resume to 5 under "dots"); d. the
                 parallel dump (2 workers) against phase 7's dump, byte for
                 byte. NCCL refuses two ranks on one GPU, hence gloo there
  11. demo       the serving entry point over HTTP on phase 7's encoder,
                 dump and indexes: a. the index app (fused route) through
                 ``serve()``, ``eval_request`` on 512 questions at batch 64,
                 q/s beside ``FusedServer.search`` in this process, answers
                 equal to it and to ``DensePhrases.search`` for the four
                 units; b. two-process mode (``q_serve`` + ``p_serve`` over
                 the SQ8 and OPQ96 indexes, kernels C and D) against
                 ``MIPS.search``; c. the reader app over phase 9's teacher
                 against ``read_passages``; d. ``python -m ...cli.run_demo``
                 ``single_serve`` as a subprocess and its ``eval_request``
                 (the same EM as a's); e. the native store runtime (built by
                 g++): ``preload_metas`` against per-doc ``meta()`` and
                 plain zlib, ``benchmark_store_read``
  12. tools      the measurement tools and the examples through their
                 ``main``: a. ``bench_ivf_scale`` at 2^21 x 768 in 13,107
                 lists (SQ8 / SQ4 / OPQ96, probes 16 / 64 / 256, C and D
                 alone on their inputs), full-probe SQ8 top-1 vs flat; b.
                 ``bench_cpu_ivf`` on a's OPQ96 save against a numpy
                 recomputation; c. ``bench_ivf_e2e`` (BERT-base towers,
                 OPQ96 in three serve modes, nprobe 16 / 256); d.
                 ``bench_tiered30m`` with its disk check; e. the five
                 examples; f. a corpus of the checkout's own prose,
                 ``cli.train_mlm`` at BERT-base width, ``dsmall``,
                 ``bench_ivf_real`` and ``bench_serve_real``
  13. bench      the repository's serve benchmark and the reference-scale
                 coarse study: a. ``densephrases_tpu_torch.bench.main`` at
                 the root bench.py's size (1M x 768 over 10,000 docs,
                 BERT-base, batch 64; its JSON line printed), then on its
                 store the fused answers against ``DensePhrases.search``,
                 the pipelined modes against the synchronous one and the
                 CPU baseline's ids against the device flat scan's; b.
                 ``bench_ivf_scale --coarse_only`` at 2^20 requested lists
                 over a cut corpus, the probe against an exact top-k
  14. modernbert ModernBERT-large towers (``models/modernbert.py``): A's
                 banded instance (``csrc/attention_band.cu``) against its
                 plain twin at the benchmark cell's shape (8 x 16 x 8,192 x
                 64, half-width 64) and at edge shapes, timed beside the
                 twin, ``scaled_dot_product_attention`` with the same band
                 as an additive mask (the yardstick) and its bound; A's
                 global path at the same shape, timed; then one
                 ``FusedServer.search`` batch of 8 documents of 2,001-8,000
                 words through two ModernBERT-large towers (seeded) over a
                 flat int8 index 1,024 wide, with A's global and banded
                 launches counted (20 and 36), and the towers through the
                 kernels against the plain path at L 1,024

Kernel A's launch counter is zeroed right before phase 3 and read after
phase 4's main-path work; kernels C and D's are zeroed right before phase 5
and read after it; kernels A and B's are zeroed again right before phase 6's
``train_rc.main`` and read right after it, and A, C and D's right before
phase 7 and read at its end; A and C's right before phase 8's drivers
(part g) and read after them; A, B and D's right before each part of phase
9 and read right after it; A-D's in this process and in every rank of
phase 10 from its start to its end (the dump workers, separate driver
processes, are not counted); A, C and D's from the start of phase 11 to
its end, leaving out the in-process runs its served answers are compared
with (the ``run_demo`` subprocesses are not counted); A-D's from the start
of phase 12 to the end of 12d, and again from 12e to its end, each tool's
own part checked; A's from the first warm-up batch of 13a to its last
window; phases 6-13 must equal the counts their paths imply. Kernel E's
is zeroed right before phase 4 and read after its main-path work, and
counted over each of phases 5, 7, 8 and 10 (in this process, and in
every rank of 10b and 10c) and over 13a's benchmark; each must be
positive. A kernel of a path that never launched fails the run.
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
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

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
# D's fused select at the ivf-opq96.nq-b64 cell's shape (2^23 rows)
PQ_SELECT_LISTS, PQ_SELECT_ROWS, PQ_SELECT_NPROBE = 16384, 512, 256
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
# kernel E (the flat int8 scan with its per-tile top-k) and its merge
# against the plain twin, the chunked loop, at the flat serve path's shape:
# the index's 1M rows padded to whole 4,096-row chunks, 768 dims, the start
# and end query rows of a batch of 64 stacked, k 10
FLAT_ROWS, FLAT_VALID, FLAT_DIM = 1003520, 1_000_000, 768
FLAT_BATCH, FLAT_K = 2 * QUERY_BATCH, 10
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
# the drivers' dump window (phase 7, and phase 10's parallel dump)
DUMP_SEQ = 512
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
# phase 10: scale-out on one card. NCCL refuses two ranks on one GPU, so
# the smoke runs NCCL at one rank and the multi-rank parts as gloo ranks
# sharing cuda:0 (gloo stages CUDA tensors through the host): that is this
# script's choice, never a fallback of the library. Serving: phase 8's
# corpus over 4 ranks (~192 MiB of codes a rank) and MeshShardedIVF at 4 x
# 4,096 lists (the build's iterations cut to SO_ITERS); MIPS over 2
# ranks on phase 3's store; DP training over 2 ranks at the reference's
# per-device shape (12 x L 384), a global batch of 24; the parallel dump
# with 2 workers over phase 7's files
SO_SERVE_RANKS, SO_TRAIN_RANKS, SO_DUMP_WORKERS = 4, 2, 2
SO_LISTS, SO_NPROBES = 16384, (16, 256)
SO_ITERS = dict(kmeans_iters=5, pq_iters=3, opq_iters=2)  # cut from 10, 6, 4
SO_RANK_TIMEOUT = 600  # seconds for one spawn of the ranks
SO_LR = 1e-4  # a constant lr: the first step moves the weights
# the ranks' first DP step against one process on the global batch of 24,
# bf16 towers either way: the same products in GEMMs of other row counts,
# summed in other orders, and the loss averaged over 2 ranks. Measured on
# an H100 80GB HBM3 at 700 W: loss 8.0e-8 relative, the unclipped gradient
# norm 1.2e-5, each tower's Adam first moment 3.8e-5 in norm and cosine
# 1 - 3.6e-7. The limits sit 10-40x above those; a gradient-scale fault (a
# sum without the mean over ranks) moves the unclipped norm 2x, which
# clipping hides from the first moment
SO_LOSS_RTOL, SO_GRAD_NORM_RTOL = 1e-6, 5e-4
SO_GRAD_COS, SO_NORM_RTOL = 1 - 1e-5, 5e-4
SO_TOWERS = ("phrase", "query_start", "query_end", "filter")
# phase 11: eval_request's synthetic questions at batch DEMO_BATCH, top-k
# DEMO_TOP_K, 5 warmup batches and DEMO_TIMED_BATCHES timed ones (q/s on
# the host clock wants a window of seconds, not of a few requests); the
# two-process servers answer the first DEMO_IVF_BATCHES batches; the
# run_demo subprocesses get DEMO_CLI_TIMEOUT seconds each; the native
# preload is also timed on a metadata-only store of DEMO_META_DOCS docs
DEMO_BATCH, DEMO_TOP_K, DEMO_TIMED_BATCHES = 64, 10, 64
DEMO_QUESTIONS = DEMO_BATCH * (5 + DEMO_TIMED_BATCHES)
DEMO_IVF_BATCHES = 8
DEMO_CLI_TIMEOUT = 300
DEMO_META_DOCS = 16384
# phase 14: the benchmark cell mbl-flat-sq8.doc-el8k-b8's attention shape
# (batch 8, 16 heads, 8,192 tokens, head dim 64, band half-width 64); the
# band at edge shapes (L < 2w + 1, L not a multiple of 64, w 0, a band
# wider than the row, every head dim); one serve batch of MB_BATCH
# documents of MB_WORDS words over MB_DOCS docs of 100 phrases 1,024 wide;
# the kernel path against the plain one at MB_PLAIN_LEN tokens (the plain
# full attention at 8,192 would hold 34 GB of fp32 scores a launch)
MB_SHAPE, MB_WINDOW = (8, 16, 8192, 64), 64
MB_EDGE_SHAPES = ((3, 2, 12, 16, 8), (2, 3, 130, 32, 8), (3, 2, 200, 64, 64),
                  (2, 2, 65, 16, 0), (2, 1, 50, 128, 70),
                  (1, 4, 1000, 64, 64))
MB_BATCH, MB_WORDS, MB_DOCS, MB_PLAIN_LEN = 8, (2001, 8000), 2000, 1024
# the ModernBERT towers through the kernels against the plain path, bf16:
# A's fp32 scores against the twins' bf16 ones through 28 layers; the
# [CLS] vectors' distance over their norm (the CPU tests read 3.8% at the
# tiny size, and fp8 towers 50%)
MB_TOWER_RTOL = 0.1


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
    (each input read once, each output written once), against the card's
    peaks in ``tools/_bench.py``."""
    from densephrases_tpu_torch.tools import _bench
    return _bench.bound(ops, nbytes, kind)


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
            # at scan_k 40 on 8-bit codes the scan takes D's fused select,
            # which replaces D's scores: the scan's time, not D's share
            row.update(scan_ms=ms)
            log("2 kernels", kernel="pq_pack_score", at=row["at"],
                scan_ms=ms, scan_route="pq_scan8_topk")
        rows["D"].append(row)
        del codes, lut
    del refine
    torch.cuda.empty_cache()
    return rows


def phase_flat_scan():
    """Kernel E and its merge (``index/flat.py:_scan_topk``, the route the
    flat serve path takes) against the chunked loop (``_chunked_topk``) on
    the same CUDA tensors, through ``tools/bench_flat_scan.measure``: one E
    launch a scan, every score within the tool's ``tolerance``, and the
    same ids (as sets) for every query whose twin's k-th and (k+1)-th
    scores lie further apart than it. Times E alone (``ms``), the route,
    the loop and a library yardstick that the port never calls (bf16
    ``torch.matmul`` of all codes, then ``torch.topk``)."""
    from densephrases_tpu_torch.tools.bench_flat_scan import measure

    got = measure(FLAT_ROWS, FLAT_DIM, FLAT_BATCH, FLAT_K, SEED,
                  n_valid=FLAT_VALID)
    keys = ("tiles", "launches_a_scan", "within_tolerance", "clear_share",
            "ids_equal_where_clear", "ids_equal_share", "valid_ids",
            "route_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    row = {"at": f"B={FLAT_BATCH} D={FLAT_DIM} k={FLAT_K}, {FLAT_ROWS} "
                 f"int8 rows ({FLAT_VALID} valid)",
           "max_abs_err": got["score_max_abs_diff"],
           "tol": got["tolerance_max"], "ms": got["kernel_ms"],
           **{k: got[k] for k in keys},
           "share_of_bound": got["bound_ms"] / got["kernel_ms"]}
    log("2 kernels", kernel="flat_scan_topk", **row)
    torch.cuda.empty_cache()
    if not (row["launches_a_scan"] == 1 and row["within_tolerance"]
            and row["clear_share"] > 0.5 and row["ids_equal_where_clear"]
            and row["valid_ids"]):
        raise AssertionError(f"flat_scan_topk disagrees with plain: {row}")
    return row


def phase_pq_select():
    """Kernel D with the select fused (``ops/ivf_pack.pq_scan_topk`` and
    its merge, the route ``packed_pq_scan`` takes for 8-bit codes and k <=
    64) against its plain twin ``pq_pack_score_topk_plain``, and beside D
    with the select after it (the route before), at the
    ``ivf-opq96.nq-b64`` cell's shape, through
    ``tools/bench_pq_select.measure``: one launch of the fused entry and
    none of D's a scan; against the twin and against D with its select,
    every score within the tool's ``tolerance`` and the same ids at every
    rank clear of it; the fused route's allocator peak below a sixteenth of
    one [128, budget·32] fp32 score matrix. Times both routes, the twin, D
    alone and the fused kernel alone."""
    from densephrases_tpu_torch.tools import bench_pq_select as bps

    got = bps.measure(bps.layout(PQ_SELECT_LISTS, PQ_SELECT_ROWS, IVF_BATCH,
                                 PQ_SELECT_NPROBE, 96, SEED),
                      IVF_SCAN_TOP_K * IVF_REFINE_FACTOR)
    agree = ("within_tolerance", "clear_share", "sets_equal_where_clear",
             "alone_share", "ids_equal_where_alone")
    keys = ("launches_a_scan", *agree, *(f"unfused_{k}" for k in agree),
            "unfused_score_max_abs_diff", "fused_ms", "kernel_ms",
            "plain_ms", "unfused_ms", "d_ms", "fused_peak_bytes",
            "unfused_peak_bytes", "scores_bytes", "real_blocks",
            "budget_blocks", "tiles", "bound_ms", "bound_by", "share_pct")
    row = {"at": f"B={IVF_BATCH} M=96 ksub=256, {got['rows']} rows, "
                 f"{PQ_SELECT_LISTS} lists, nprobe {PQ_SELECT_NPROBE}, "
                 f"k {got['k']}",
           "max_abs_err": got["score_max_abs_diff"],
           "tol": got["tolerance_max"], **{k: got[k] for k in keys}}
    log("2 kernels", kernel="pq_scan_topk", **row)
    torch.cuda.empty_cache()
    agrees = lambda pre: (row[f"{pre}within_tolerance"]  # noqa: E731
                          and row[f"{pre}clear_share"] > 0.5
                          and row[f"{pre}sets_equal_where_clear"]
                          and row[f"{pre}ids_equal_where_alone"])
    if not (row["launches_a_scan"] == {"dph_pq_pack_score": 0,
                                       "dph_pq_scan_topk": 1}
            and agrees("") and agrees("unfused_")
            and 16 * row["fused_peak_bytes"] < row["scores_bytes"]):
        raise AssertionError(f"pq_scan_topk disagrees with its plain twin "
                             f"or with D and its select: {row}")
    return row


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
    serve through them. Returns the launch counts of kernels C, D (its
    scores: OPQ192x4's 4-bit codes) and F (D with the select fused:
    OPQ96's 8-bit codes at scan_k 40 or less)."""
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from densephrases_tpu_torch.index.oracle import check_top1
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, NEG_INF, PQ_PACK_SCORE, PQ_SCAN_TOPK)

    IVF_PACK_SCORE.launches = 0
    PQ_PACK_SCORE.launches = 0
    PQ_SCAN_TOPK.launches = 0
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
    counts = {"C": IVF_PACK_SCORE.launches, "D": PQ_PACK_SCORE.launches,
              "F": PQ_SCAN_TOPK.launches}
    log("5 ivf", c_launches=counts["C"], d_launches=counts["D"],
        f_launches=counts["F"])
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
        IVF_PACK_SCORE, PQ_PACK_SCORE, PQ_SCAN_TOPK)

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
    # OPQ96 is served at top_k 10 everywhere here: 8-bit codes at scan_k
    # 40, so D with its fused select (F), and never D's scores alone
    want = {"A": 0, "C": 0, "D": 0, "F": 0}
    ATTENTION_FWD.launches = 0
    IVF_PACK_SCORE.launches = 0
    PQ_PACK_SCORE.launches = 0
    PQ_SCAN_TOPK.launches = 0

    # dump: phase 3's docs and encoder, phase 3's window length and batch
    t0 = time.perf_counter()
    dumped = generate_phrase_vecs.main(
        ["--load_dir", enc, "--data_dir", corpus, "--predict_file",
         f"0:{OFFLINE_FILES}", "--dump_dir", dump, "--max_seq_length",
         str(DUMP_SEQ)],
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
    # and one union scan (C over SQ8, F over OPQ96 with its device refine)
    batches = -(-OFFLINE_QUESTIONS // OFFLINE_EVAL_BATCH)
    for fq, kernel in (("SQ8", "C"), ("OPQ96", "F")):
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
        want["F"] += 6 + 1 + 1  # host_ms's 6 searches, the ids, the spans
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
              "D": PQ_PACK_SCORE.launches, "F": PQ_SCAN_TOPK.launches}
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
    np.save(os.path.join(root, "queries.npy"), q)  # phase 10 serves them
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
    from densephrases_tpu_torch.ops.ivf_pack import (
        PQ_PACK_SCORE, PQ_SCAN_TOPK)
    from densephrases_tpu_torch.train import cross_encoder, mlm, query
    from densephrases_tpu_torch.train.cross_encoder import init_cross_params

    root = os.path.join(tmp, "trainers")
    os.makedirs(root)
    off = os.path.join(tmp, "offline")
    enc, dump, qa_path = (os.path.join(off, d)
                          for d in ("enc", "dump", "qa.json"))
    squad = os.path.join(tmp, "train.json")
    layers = config.num_hidden_layers
    kernels = {"A": ATTENTION_FWD, "B": ATTENTION_BWD, "D": PQ_PACK_SCORE,
               "F": PQ_SCAN_TOPK}
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
        "A": 2 * layers * steps, "B": layers * steps, "D": 0, "F": 0})
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
                                     "B": 2 * 3 * layers, "D": 0, "F": 0})
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
    finish("c reader", t0, {"A": layers, "B": 0, "D": 0, "F": 0})
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
                                      "B": layers * MLM_STEPS, "D": 0,
                                      "F": 0})
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
    # per batch: the searcher's two query towers and one OPQ96 scan (top_k
    # QSFT_TOP_K: scan_k 400, D's scores); per step the two towers
    # forward, their remat recomputes and backward; the dev eval's towers
    # and scans (top_k 10: scan_k 40, the fused select)
    wall, peak = finish("e query_ft", t0, {
        "A": 2 * layers * (n_batches + dev_batches) + 4 * layers * steps,
        "B": 2 * layers * steps, "D": n_batches, "F": dev_batches})
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
    finish("f hf_import", t0, {"A": 4 * layers, "B": 0, "D": 0, "F": 0})
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


# ------------------------------------------------------------- phase 10
def train_step_launches(layers, remat="full", hard_negatives=True,
                        teacher=True):
    """Kernels A and B in one RC train step: A once a tower forward (the
    phrase tower, the two query towers, the hard negatives through the
    phrase tower) and again in its recompute under remat "full" or "dots"
    (attention is no product under "dots"), plus the teacher's forward; B
    once a tower backward."""
    towers = 3 + int(hard_negatives)
    recompute = towers if remat in ("full", "dots") else 0
    return {"A": (towers + recompute + int(teacher)) * layers,
            "B": towers * layers}


def dp_batch(rng, vocab_size, rows):
    """A seeded synthetic global train batch at the reference's shape
    (L TRAIN_SEQ, queries TRAIN_QUERY, cross TRAIN_SEQ + TRAIN_QUERY), every
    loss part's inputs: ragged masks, answer positions, teacher inputs and
    a hard negative passage a row."""
    ids = lambda *s: rng.integers(5, vocab_size, s).astype(np.int32)
    am = np.ones((rows, TRAIN_SEQ), np.int32)
    for i in range(rows):
        am[i, TRAIN_SEQ - TRAIN_SEQ // 32 * (i % 8):] = 0
    lc = TRAIN_SEQ + TRAIN_QUERY
    gather = np.full((rows, TRAIN_SEQ), -1, np.int32)
    gather[:, 0] = 0
    gather[:, 2:] = np.arange(TRAIN_QUERY, lc - 2)[None, :]
    start = rng.integers(1, TRAIN_SEQ // 2, rows).astype(np.int32)
    return {
        "input_ids": ids(rows, TRAIN_SEQ), "attention_mask": am,
        "token_type_ids": np.zeros((rows, TRAIN_SEQ), np.int32),
        "query_input_ids": ids(rows, TRAIN_QUERY),
        "query_attention_mask": np.ones((rows, TRAIN_QUERY), np.int32),
        "query_token_type_ids": np.zeros((rows, TRAIN_QUERY), np.int32),
        "start_positions": start, "end_positions": start + 3,
        "cross_input_ids": ids(rows, lc),
        "cross_attention_mask": np.ones((rows, lc), np.int32),
        "cross_token_type_ids": np.concatenate(
            [np.zeros((rows, TRAIN_QUERY), np.int32),
             np.ones((rows, TRAIN_SEQ), np.int32)], 1),
        "teacher_gather": gather,
        "neg_input_ids": ids(rows, TRAIN_SEQ),
        "neg_attention_mask": am[::-1].copy(),
    }


def dp_summary(state, metrics):
    """What the first DP step is held to: the loss, the gradient norm, and
    per tower the norm and a few whole weight matrices of Adam's first
    moment (the clipped gradient over 10; biases such as the key bias get
    gradients of rounding noise by symmetry, so they are left out)."""
    mu = state.opt_state["mu"]
    last = len([n for n in mu if n.endswith("q_w")]) // 3 - 1
    keep = [n for n in mu if n.endswith("_w") and n.startswith(
        ("phrase.layers.0.", f"phrase.layers.{last}.",
         f"query_start.layers.{last}.q_w", f"query_end.layers.{last}.ffn_out"))
        ] + ["filter.w"]
    norms = {t: float(torch.sqrt(sum(mu[n].double().square().sum()
                                     for n in mu if n.split(".")[0] == t)))
             for t in SO_TOWERS}
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "norms": norms,
            "mu": {n: mu[n].float().cpu() for n in keep}}


def so_serve(rank, world, tmp, device, kernels):
    """Phase 10b, one of SO_SERVE_RANKS gloo ranks: phase 8's corpus on a
    mesh ``FlatIndex``, then ``MeshShardedIVF.build`` SQ8 and OPQ96 (each
    rank's shard saved for the one-process comparison) searched at each
    nprobe; ms a batch of 128 and device bytes. The rank's launch formula:
    one C (SQ8) or D (OPQ96) a search of its own shard, 7 searches an
    nprobe (one, then ``host_ms``'s warm-up and 5 timed)."""
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from densephrases_tpu_torch.index.sharded import MeshShardedIVF
    from densephrases_tpu_torch.parallel import make_mesh
    from densephrases_tpu_torch.parallel.multihost import broadcast_queries

    inp = torch.load(os.path.join(tmp, "serve_in.pt"), weights_only=False)
    mesh = make_mesh(axis="shard", devices=[device] * world)
    codes = np.load(inp["corpus"], mmap_mode="r")
    # each rank offers its own; every rank serves rank 0's
    q = broadcast_queries(np.load(inp["queries"]) + rank)
    out = {"queries": q, "want": {"A": 0, "B": 0, "C": 0, "D": 0, "F": 0}}
    flat, out["flat_bytes"] = device_bytes(lambda: FlatIndex(codes, mesh=mesh))
    out["flat"] = flat.search(q, top_k=10)
    out["flat_ms"] = host_ms(lambda: flat.search(q, top_k=10))
    del flat
    # OPQ96 at top_k 10: scan_k 40 on 8-bit codes, the fused select (F)
    for fq, kernel in (("SQ8", "C"), ("OPQ96", "F")):
        t0 = time.perf_counter()
        cfg = IVFConfig(num_clusters=inp["lists"], fine_quant=fq,
                        **SO_ITERS)
        msh = MeshShardedIVF.build(codes, cfg, mesh)
        torch.cuda.synchronize()
        out[fq, "build_s"] = time.perf_counter() - t0
        out[fq, "bytes"] = sum(
            t.numel() * t.element_size() for t in (
                msh.centroids, msh.list_offsets, msh.codes, msh.row_perm,
                msh.rotation, msh.pq_books, msh.refine_codes) if t is not None)
        out[fq, "nlist"] = (msh.nlist_valid, int(msh.centroids.shape[0]))
        host = lambda t: None if t is None else t.cpu().numpy()
        nv = msh.nlist_valid
        IVFIndex(msh.cfg, host(msh.centroids[:nv]), host(msh.row_perm),
                 host(msh.list_offsets[:nv + 1]), host(msh.codes),
                 rotation=host(msh.rotation), pq=msh.pq, offset=msh.offset,
                 scale=msh.scale, n_total=msh.n_real,
                 refine_codes=host(msh.refine_codes), device="cpu").save(
            os.path.join(tmp, f"shard_{fq}_{rank}"))
        k0 = kernels[kernel].launches
        for nprobe in SO_NPROBES:
            out[fq, nprobe] = msh.search(q, top_k=10, nprobe=nprobe)
            out[fq, nprobe, "ms"] = host_ms(
                lambda: msh.search(q, top_k=10, nprobe=nprobe))
        out[fq, "launches"] = kernels[kernel].launches - k0
        out["want"][kernel] += 7 * len(SO_NPROBES)
        del msh
    return out


def so_train(rank, world, tmp, device, kernels):
    """Phase 10c, one of SO_TRAIN_RANKS gloo ranks: ``MIPS(store, mesh=)``
    with the four retrieval units and the oracle; the first DP step of
    every loss part (hard negatives included) for the one-process check;
    one step under each remat mode (step ms, peak memory); then
    ``train_rc.main`` for 3 steps under remat "full" and a resume to 5
    under "dots". The rank's launch formula (``out["want"]``) sums the
    parts' formulas, each logged beside its own count."""
    from densephrases_tpu_torch.cli import train_rc
    from densephrases_tpu_torch.cli.common import load_encoder
    from densephrases_tpu_torch.index.oracle import check_top1
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.index.store import PhraseStore
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.encoder import (
        RCLossConfig, init_encoder_params, rc_loss)
    from densephrases_tpu_torch.parallel import make_mesh
    from densephrases_tpu_torch.train.rc import (
        AdamW, create_train_state, make_train_step, shard_batch)

    inp = torch.load(os.path.join(tmp, "train_in.pt"), weights_only=False)
    out, count = {}, lambda: {k: kernels[k].launches for k in "AB"}

    # MIPS over the ranks: phase 3's store, phase 7's encoder
    store = PhraseStore.load(inp["store"])
    params, config, tok = load_encoder(inp["enc"], device=device)
    layers = config.num_hidden_layers
    mips = MIPS(store, mesh=make_mesh(axis="shard", devices=[device] * world))
    model = DensePhrases(params, config, tok, mips, serve_dtype="bf16",
                         max_query_length=inp["max_query_length"])
    c0 = count()
    for unit in ("phrase", "sentence", "paragraph", "document"):
        _, rets = model.search(inp["questions"], retrieval_unit=unit, top_k=5,
                               return_meta=True)
        out["units", unit] = [[(r["answer"], float(r["score"])) for r in ret]
                              for ret in rets]
    out["mips_launches"] = (count()["A"] - c0["A"], 4 * 2 * layers)
    out["oracle"] = [check_top1(store, v, mips.search(
        v[None], top_k=50, return_idxs=True)[0][0]) for v in inp["oracle"]]
    del model, mips, params
    torch.cuda.empty_cache()

    # the first DP step (dropout off: the ranks draw apart from one
    # process), then one step under each remat mode
    cfg = dataclasses.replace(inp["config"], hidden_dropout_prob=0.0)
    params = init_encoder_params(cfg, torch.Generator().manual_seed(SEED),
                                 device=device, with_teacher=True)
    batch = dict(np.load(inp["batch"]))
    per_device = inp["shape"]["batch"]
    mesh = make_mesh(axis="dp", devices=[device] * world)
    loss_cfg = RCLossConfig(axis_name="dp", **TRAIN_LOSS)
    opt = AdamW(lambda count: SO_LR)
    state = create_train_state(params, opt, pbn_size=2, batch_size=per_device,
                               hidden=cfg.hidden_size)
    c0 = count()
    step = make_train_step(cfg, loss_cfg, opt, mesh=mesh)
    state, metrics = step(state, shard_batch(batch, mesh),
                          torch.Generator().manual_seed(0))
    out["dp_first"] = dp_summary(state, metrics)
    want = train_step_launches(layers)
    for remat in ("none", "full", "dots"):
        step = make_train_step(cfg, loss_cfg, opt, mesh=mesh, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, shard_batch(batch, mesh),
                              torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        out["remat", remat] = (1e3 * (time.perf_counter() - t0),
                               torch.cuda.max_memory_allocated() / 2 ** 30,
                               float(metrics["loss"]))
        for k, v in train_step_launches(layers, remat).items():
            want[k] += v
    # what a forward keeps for the backward under each mode (the step's
    # peak is the gradient buffers', the same under "full" and "dots")
    for remat in ("none", "full", "dots"):
        graph, saved = device_bytes(lambda: rc_loss(
            state.params, cfg, shard_batch(batch, mesh), loss_cfg,
            pre_batch=state.pre_batch, deterministic=True, remat=remat))
        out["saved", remat] = saved / 2 ** 30
        del graph  # the loss and aux's logits hold the graph
        want["A"] += train_step_launches(layers, "none")["A"]
    got = count()
    out["step_launches"] = ({k: got[k] - c0[k] for k in "AB"}, want)
    del state, params, step, opt
    torch.cuda.empty_cache()

    # the driver: 3 steps under remat "full", then a resume to 5 under
    # "dots" (rank 0 alone logs and writes, every rank restores)
    argv = ["--load_dir", inp["init"], "--train_file", inp["train"],
            "--output_dir", inp["out"], "--lambda_neg", "2.0",
            "--lambda_flt", "1.0", "--lambda_kl", "2.0", "--pbn_size", "2",
            "--per_device_train_batch_size", str(per_device),
            "--max_seq_length", str(inp["shape"]["seq"]), "--max_query_length",
            str(inp["shape"]["query"]), "--warmup_steps", "1",
            "--logging_steps", "1"]
    c0 = count()
    t0 = time.perf_counter()
    state, _ = train_rc.main(argv + ["--max_steps", "3"], device=device)
    out["driver_full_s"] = time.perf_counter() - t0
    out["first_step"] = state.step
    state, _ = train_rc.main(argv + ["--max_steps", "5", "--remat", "dots"],
                             device=device)
    got = count()
    # per step 3 towers + their recomputes + the teacher (no hard negatives
    # in the driver's data); filter_test's one forward a call
    out["driver_launches"] = (
        {k: got[k] - c0[k] for k in "AB"},
        {"A": 5 * train_step_launches(layers, hard_negatives=False)["A"]
         + 2 * layers,
         "B": 5 * train_step_launches(layers, hard_negatives=False)["B"]})
    out["driver"] = (state.step, int(state.pre_batch["count"]),
                     checksum(state.params))
    out["want"] = {"A": out["mips_launches"][1], "B": 0, "C": 0, "D": 0,
                   "F": 0}
    for part in ("step_launches", "driver_launches"):
        for k in "AB":
            out["want"][k] += out[part][1][k]
    return out


def scale_out_rank(rank, world, task, tmp, device):
    """One rank of phase 10 (a fresh process that imports torch and the port
    only): joins the task's gloo group, zeroes the launch counters, runs the
    task (all of it mesh work) and writes its results and counts to
    ``tmp``."""
    import torch.distributed as dist

    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BAND, ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.ops.flat_scan import FLAT_SCAN_TOPK
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE, PQ_SCAN_TOPK)
    from densephrases_tpu_torch.parallel.multihost import init_multihost

    from densephrases_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # a bare "cuda": the current card
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_multihost(f"file://{tmp}/pg_{task}", world, rank, backend="gloo")
    kernels = {"A": ATTENTION_FWD, "B": ATTENTION_BWD, "C": IVF_PACK_SCORE,
               "D": PQ_PACK_SCORE, "F": PQ_SCAN_TOPK}
    try:
        for k in (*kernels.values(), FLAT_SCAN_TOPK):
            k.launches = 0
        out = {"serve": so_serve, "train": so_train}[task](
            rank, world, tmp, device, kernels)
        out["launches"] = {k: v.launches for k, v in kernels.items()}
        out["e_launches"] = FLAT_SCAN_TOPK.launches  # the per-rank scans
        out["foreign"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax",
                                                       "densephrases_tpu"))
        torch.save(out, os.path.join(tmp, f"{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(task, world, tmp, device):
    """Spawn ``world`` ranks of a phase 10 task; a rank that fails or
    outlives SO_RANK_TIMEOUT fails the phase (every rank is ended)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(scale_out_rank, args=(world, task, tmp, device),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SO_RANK_TIMEOUT:
                raise AssertionError(f"phase 10 {task}: ranks still running "
                                     f"after {SO_RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    outs = [torch.load(os.path.join(tmp, f"{task}_{r}.pt"), weights_only=False)
            for r in range(world)]
    for r, o in enumerate(outs):
        if o["foreign"]:
            raise AssertionError(f"phase 10 {task} rank {r} imported "
                                 f"{o['foreign']}")
        if o["launches"] != o["want"]:
            raise AssertionError(f"phase 10 {task} rank {r} launched "
                                 f"{o['launches']}, its formula {o['want']}")
    return outs, time.perf_counter() - t0


def phase_scale_out(tmp, store, model, config, docs, rng):
    """Phase 10: the scale-out path on one card.

    a. NCCL at one rank (this process): ``init_multihost(backend="nccl")``,
       a mesh ``FlatIndex`` over phase 3's store and one DP train step of
       every loss part, each bit for bit the non-mesh path's; the
       collectives themselves called once on the card;
    b. serving over SO_SERVE_RANKS gloo ranks on the card (``so_serve``):
       ids equal the single-device ``FlatIndex``'s and, for SQ8 and OPQ96,
       ``ShardedIVF`` over the ranks' own shards in this process;
    c. over SO_TRAIN_RANKS gloo ranks (``so_train``): ``MIPS(store,
       mesh=)`` answers equal the single-device serve's, the oracle passes;
       the first DP step against this process on the global batch of 24;
       step ms and peak memory per remat mode; ``train_rc.main``;
    d. ``run_parallel_dump`` with SO_DUMP_WORKERS workers over phase 7's
       files, merged, byte for byte phase 7's dump.

    The launches of the scale-out path: in this process, the counters are
    zeroed just before a's mesh work and read just after it; in each rank,
    from the start of its task (all mesh work) to its end. The non-mesh
    and one-process runs that the mesh is compared with are not counted.
    Each count must equal its own formula. Returns the sums."""
    import torch.distributed as dist

    from densephrases_tpu_torch import parallel
    from densephrases_tpu_torch.index.flat import FlatIndex
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.sharded import ShardedIVF
    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.models.encoder import (
        RCLossConfig, init_encoder_params)
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE, PQ_SCAN_TOPK)
    from densephrases_tpu_torch.parallel.multihost import init_multihost
    from densephrases_tpu_torch.tools.parallel_dump import (
        merge_shards, run_parallel_dump)
    from densephrases_tpu_torch.train.rc import (
        AdamW, create_train_state, make_train_step, shard_batch)

    root = os.path.join(tmp, "scale_out")
    os.makedirs(root)
    kernels = {"A": ATTENTION_FWD, "B": ATTENTION_BWD, "C": IVF_PACK_SCORE,
               "D": PQ_PACK_SCORE, "F": PQ_SCAN_TOPK}
    layers = config.num_hidden_layers
    batch = dp_batch(rng, config.vocab_size, SO_TRAIN_RANKS * TRAIN_BATCH)
    np.savez(os.path.join(root, "batch.npz"), **batch)
    cfg = dataclasses.replace(config, hidden_dropout_prob=0.0)

    # a. NCCL at one rank
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    t0 = time.perf_counter()
    init_multihost(f"file://{root}/pg_one", 1, 0, backend=backend)
    try:
        mesh = parallel.make_mesh(axis="shard", devices=[DEVICE])
        q = rng.standard_normal((128, config.hidden_size)).astype(np.float32)
        single = model.mips.index.search(q, top_k=10)
        x = torch.randn(3, 5, device=DEVICE, requires_grad=True)
        g = parallel._AllGatherGrad.apply(x, 0, 1)
        g.backward(torch.ones_like(g))
        y = x.detach().clone()
        dist.all_reduce(y)
        dist.broadcast(y, 0)
        coll_ok = (torch.equal(g, x) and torch.equal(x.grad, torch.ones_like(x))
                   and torch.equal(y, x))
        # one DP step at a mesh of one against the non-mesh step: the same
        # weights, batch and dropout generator (dropout on)
        half = {k: v[:TRAIN_BATCH] for k, v in batch.items()}
        dmesh = parallel.make_mesh(axis="dp", devices=[DEVICE])

        def dp_step(m):
            p = init_encoder_params(config, torch.Generator().manual_seed(SEED),
                                    device=DEVICE, with_teacher=True)
            opt = AdamW(lambda count: SO_LR)
            st = create_train_state(p, opt, pbn_size=2, batch_size=TRAIN_BATCH,
                                    hidden=config.hidden_size)
            step = make_train_step(config, RCLossConfig(
                axis_name="dp" if m else None, **TRAIN_LOSS), opt, mesh=m)
            tb = (shard_batch(half, m) if m else
                  {k: torch.as_tensor(v, device=DEVICE) for k, v in half.items()})
            st, met = step(st, tb, torch.Generator().manual_seed(3))
            return float(met["loss"]), st.params

        plain = dp_step(None)
        # the mesh work, counted
        for k in kernels.values():
            k.launches = 0
        meshed = FlatIndex(store.vecs, store.offset, store.scale, mesh=mesh)
        got = meshed.search(q, top_k=10)
        del meshed
        meshed_step = dp_step(dmesh)
        here = {n: k.launches for n, k in kernels.items()}
        here_want = {"C": 0, "D": 0, "F": 0,
                     **train_step_launches(layers)}
        flat_equal = all(np.array_equal(a, b) for a, b in zip(got, single))
        step_equal = (plain[0] == meshed_step[0]
                      and same_params(plain[1], meshed_step[1]))
        del plain, meshed_step
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log("10 scale_out", part="a", backend=backend, ranks=1,
        flat_ids_equal=flat_equal, collectives_ok=coll_ok,
        dp_step_bit_equal=step_equal, launches=here, expected=here_want,
        seconds=round(time.perf_counter() - t0, 3))
    if not (flat_equal and coll_ok and step_equal):
        raise AssertionError("phase 10a: the one-rank mesh path differs "
                             "from the non-mesh path")
    if here != here_want:
        raise AssertionError(f"phase 10a launched {here}, its formula "
                             f"{here_want}")

    # b. serving over gloo ranks on the card
    torch.save({"corpus": os.path.join(tmp, "scale", "codes.npy"),
                "queries": os.path.join(tmp, "scale", "queries.npy"),
                "lists": SO_LISTS}, os.path.join(root, "serve_in.pt"))
    outs, wall = run_ranks("serve", SO_SERVE_RANKS, root, DEVICE)
    codes = np.load(os.path.join(tmp, "scale", "codes.npy"), mmap_mode="r")
    q = np.load(os.path.join(tmp, "scale", "queries.npy"))
    flat = FlatIndex(codes, device=DEVICE)
    exact = flat.search(q, top_k=10)
    single_ms = host_ms(lambda: flat.search(q, top_k=10))
    del flat
    torch.cuda.empty_cache()
    ok = True
    for r, o in enumerate(outs):
        ok &= np.array_equal(o["queries"], q)
        ok &= np.array_equal(o["flat"][1], exact[1])
    log("10 scale_out", part="b", backend="gloo", ranks=SO_SERVE_RANKS,
        index="flat", rows=codes.shape[0], ids_equal_single=bool(ok),
        ms_per_batch=[round(o["flat_ms"], 3) for o in outs],
        single_device_ms=round(single_ms, 3),
        device_bytes_per_rank=[o["flat_bytes"] for o in outs],
        spawn_wall_s=round(wall, 3))
    if not ok:
        raise AssertionError("phase 10b: the mesh flat index differs from "
                             "the single-device one")
    bases = [i * -(-codes.shape[0] // SO_SERVE_RANKS)
             for i in range(SO_SERVE_RANKS)]
    for fq, kernel in (("SQ8", "C"), ("OPQ96", "D")):
        subs = [IVFIndex.load(os.path.join(root, f"shard_{fq}_{r}"),
                              device=DEVICE) for r in range(SO_SERVE_RANKS)]
        host = ShardedIVF(subs, bases, devices=[DEVICE] * SO_SERVE_RANKS)
        for nprobe in SO_NPROBES:
            want_ids = host.search(q, top_k=10, nprobe=nprobe)[1]
            ids_eq = all(np.array_equal(o[fq, nprobe][1], want_ids)
                         for o in outs)
            log("10 scale_out", part="b", backend="gloo", index=fq,
                lists=[o[fq, "nlist"] for o in outs], nprobe=nprobe,
                batch=q.shape[0], ids_equal_sharded_ivf=ids_eq,
                recall_at_10_vs_flat=recall_at(outs[0][fq, nprobe][1],
                                               exact[1]),
                ms_per_batch=[round(o[fq, nprobe, "ms"], 3) for o in outs],
                build_s=[round(o[fq, "build_s"], 3) for o in outs],
                device_bytes_per_rank=[o[fq, "bytes"] for o in outs],
                launches_per_rank=[o[fq, "launches"] for o in outs])
            if not ids_eq:
                raise AssertionError(f"phase 10b: MeshShardedIVF {fq} ids "
                                     f"differ from ShardedIVF's")
        del subs, host
        torch.cuda.empty_cache()
    serve_launches = {k: sum(o["launches"][k] for o in outs)
                      for k in "ABCDF"}
    serve_launches["E"] = sum(o["e_launches"] for o in outs)
    log("10 scale_out", part="b", launches_per_rank=[o["launches"]
                                                     for o in outs],
        expected_per_rank=[o["want"] for o in outs],
        e_launches_per_rank=[o["e_launches"] for o in outs])
    if DEVICE == "cuda" and min(o["e_launches"] for o in outs) <= 0:
        raise AssertionError("phase 10b: a rank's mesh FlatIndex scan never "
                             "launched kernel E")

    # c. MIPS and DP training over gloo ranks on the card
    questions = [" ".join(rng.choice(docs[0]["paragraphs"][0].split(" "), 6))
                 for _ in range(8)]
    single = {}
    for unit in ("phrase", "sentence", "paragraph", "document"):
        _, rets = model.search(questions, retrieval_unit=unit, top_k=5,
                               return_meta=True)
        single[unit] = [[(r["answer"], float(r["score"])) for r in ret]
                        for ret in rets]
    # this process on the whole global batch: the DP step's reference
    p = init_encoder_params(cfg, torch.Generator().manual_seed(SEED),
                            device=DEVICE, with_teacher=True)
    opt = AdamW(lambda count: SO_LR)
    st = create_train_state(p, opt, pbn_size=2,
                            batch_size=SO_TRAIN_RANKS * TRAIN_BATCH,
                            hidden=config.hidden_size)
    st, met = make_train_step(cfg, RCLossConfig(**TRAIN_LOSS), opt)(
        st, {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    one = dp_summary(st, met)
    del st, p, opt
    torch.cuda.empty_cache()
    oracle = [rng.standard_normal(2 * config.hidden_size).astype(np.float32)
              for _ in range(3)]
    torch.save({"store": os.path.join(tmp, "store"),
                "enc": os.path.join(tmp, "offline", "enc"),
                "questions": questions, "oracle": oracle,
                "batch": os.path.join(root, "batch.npz"),
                "init": os.path.join(tmp, "init"),
                "train": os.path.join(tmp, "train.json"),
                "out": os.path.join(root, "dp_out"), "config": config,
                "max_query_length": MAX_QUERY_LENGTH,
                "shape": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                          "query": TRAIN_QUERY}},
               os.path.join(root, "train_in.pt"))
    outs, wall = run_ranks("train", SO_TRAIN_RANKS, root, DEVICE)
    same_answers = all(o["units", u] == single[u] for o in outs
                       for u in single)
    log("10 scale_out", part="c", backend="gloo", ranks=SO_TRAIN_RANKS,
        what="MIPS mesh", units_equal_single=same_answers,
        oracle=",".join(outs[0]["oracle"]),
        a_launches=[o["mips_launches"] for o in outs])
    if not same_answers:
        raise AssertionError("phase 10c: the mesh MIPS answers differ from "
                             "the single-device serve's")
    dp = outs[0]["dp_first"]
    loss_rel = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    grad_norm_rel = abs(dp["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    norm_rel = {t: abs(dp["norms"][t] - one["norms"][t]) / one["norms"][t]
                for t in SO_TOWERS}
    cos = {n: float(torch.nn.functional.cosine_similarity(
        dp["mu"][n].ravel(), one["mu"][n].ravel(), dim=0)) for n in one["mu"]}
    ranks_equal = all(o["driver"] == outs[0]["driver"] for o in outs)
    log("10 scale_out", part="c", what="dp_first_step", loss_ranks=dp["loss"],
        loss_one_process=one["loss"], loss_rel=loss_rel,
        loss_rtol=SO_LOSS_RTOL, grad_norm_ranks=dp["grad_norm"],
        grad_norm_one=one["grad_norm"], grad_norm_rel=grad_norm_rel,
        grad_norm_rtol=SO_GRAD_NORM_RTOL, norm_rel_max=max(norm_rel.values()), norm_rtol=SO_NORM_RTOL,
        cos_min=min(cos.values()), cos_min_at=min(cos, key=cos.get),
        cos_floor=SO_GRAD_COS)
    for remat in ("none", "full", "dots"):
        log("10 scale_out", part="c", what="dp_step", remat=remat,
            step_ms=[round(o["remat", remat][0], 2) for o in outs],
            peak_gib=[o["remat", remat][1] for o in outs],
            forward_saved_gib=[o["saved", remat] for o in outs],
            loss=outs[0]["remat", remat][2])
    with open(os.path.join(root, "dp_out", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])
               if b["step"] != 4]  # the resume's first step follows a restart
    log("10 scale_out", part="c", what="train_rc.main",
        steps=[r["step"] for r in rows], losses=[round(r["loss"], 4)
                                                 for r in rows],
        step_ms=[round(x, 1) for x in step_ms],
        driver_full_s=round(outs[0]["driver_full_s"], 3),
        ranks_equal=ranks_equal, spawn_wall_s=round(wall, 3))
    if (loss_rel > SO_LOSS_RTOL or grad_norm_rel > SO_GRAD_NORM_RTOL
            or max(norm_rel.values()) > SO_NORM_RTOL
            or min(cos.values()) < SO_GRAD_COS):
        raise AssertionError("phase 10c: the DP step differs from one "
                             "process on the global batch")
    if not ranks_equal or [r["step"] for r in rows] != [1, 2, 3, 4, 5] \
            or outs[0]["driver"][:2] != (5, 5):
        raise AssertionError("phase 10c: train_rc.main over the ranks "
                             f"went wrong: {outs[0]['driver']} {rows}")
    train_launches = {k: sum(o["launches"][k] for o in outs)
                      for k in "ABCDF"}
    train_launches["E"] = sum(o["e_launches"] for o in outs)
    log("10 scale_out", part="c", launches_per_rank=[o["launches"]
                                                     for o in outs],
        expected_per_rank=[o["want"] for o in outs],
        e_launches_per_rank=[o["e_launches"] for o in outs])

    # d. the parallel dump against phase 7's single dump
    offline = os.path.join(tmp, "offline")
    t0 = time.perf_counter()
    run_parallel_dump(os.path.join(offline, "corpus"),
                      os.path.join(root, "pdump"), os.path.join(offline, "enc"),
                      SO_DUMP_WORKERS, DUMP_SEQ, devices=[DEVICE],
                      timeout=300)
    merged = merge_shards(os.path.join(root, "pdump"))
    dump_s = time.perf_counter() - t0
    one_dump = os.path.join(offline, "dump", "phrase")
    names = sorted(os.listdir(one_dump))
    equal = (names == sorted(os.listdir(merged))
             and all(same_files(os.path.join(one_dump, n),
                                os.path.join(merged, n)) for n in names))
    log("10 scale_out", part="d", workers=SO_DUMP_WORKERS, files=len(names),
        byte_equal=equal, seconds=round(dump_s, 3))
    if not equal:
        raise AssertionError("phase 10d: the merged parallel dump differs "
                             "from phase 7's dump")

    counts = {k: here[k] + serve_launches[k] + train_launches[k]
              for k in "ABCDF"}
    log("10 scale_out", **{f"{k.lower()}_launches": v
                           for k, v in counts.items()},
        mesh_work="a's mesh work in this process and every rank's task")
    # kernel E's launches in the ranks (this process's: counted by main)
    counts["E"] = serve_launches["E"] + train_launches["E"]
    return counts


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port, timeout, proc=None):
    """Wait until something accepts connections on ``port``; fail at the
    timeout or when ``proc`` (a server subprocess) exits first."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server process exited ({proc.returncode})"
                                 f" before it served on :{port}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"nothing served on :{port} within {timeout} s")


@contextlib.contextmanager
def serving(app, serve):
    """``serve(app, port)`` (the drivers' blocking loop) in a thread on a
    free port; yields the port, and shuts the server down on every exit."""
    started = []
    port = free_port()
    thread = threading.Thread(target=serve, args=(app, port),
                              kwargs={"started": started.append}, daemon=True)
    thread.start()
    try:
        wait_for_port(port, 30)
        yield port
    finally:
        for server in started:
            server.shutdown()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError(f"the server on :{port} did not stop")


def post_json(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def get_status(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
        resp.read()
        return resp.status


@contextlib.contextmanager
def uncounted(*kernels):
    """Leave the launch counters as they were: for the in-process runs that
    the served answers are compared with."""
    before = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, n in zip(kernels, before):
            k.launches = n


def timed_posts(port, batches, **body):
    """POST each batch to /batch_api: (answers per batch, median ms)."""
    outs, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(post_json(port, "/batch_api", {"query": batch, **body}))
        times.append(1e3 * (time.perf_counter() - t0))
    return outs, float(np.median(times))


def same_served(got, want_rets, top_k):
    """A /batch_api answer (JSON) equals in-process results exactly: the
    answer list and each hit's answer, title, offsets and score."""
    want = [ret[:top_k] for ret in want_rets]
    return got["answers"] == [[r["answer"] for r in ret] for ret in want] \
        and [[(h["answer"], h["title"], h["start_pos"], h["end_pos"],
               h["score"]) for h in ret] for ret in got["ret"]] == \
        [[(r["answer"], r["title"], r["start_pos"], r["end_pos"], r["score"])
          for r in ret] for ret in want]


def meta_bytes(metas):
    """Every field of a list of ``DocMeta``, as bytes where it is an array."""
    return [(m.doc_id, m.title, m.context, m.word2char_start.tobytes(),
             m.word2char_end.tobytes(), m.f2o_start.tobytes()) for m in metas]


def same_metas(a, b):
    """Two lists of ``DocMeta`` byte-equal, one doc at a time (for a store
    whose ``meta_bytes`` would not fit twice in memory)."""
    return len(a) == len(b) and all(
        meta_bytes([x]) == meta_bytes([y]) for x, y in zip(a, b))


def same_answers(got, want):
    """Two /batch_api bodies with the same answers and hits (their ``time``
    keys differ)."""
    return got["answers"] == want["answers"] and got["ret"] == want["ret"]


def phase_demo(tmp, config, docs, rng, smi):
    """Phase 11: the reference's serving entry point end to end on the
    card, over phase 7's encoder, dump and indexes.

    a. ``make_index_app`` (the fused route over the flat int8 index) served
       through ``serve()`` in a thread; ``eval_request`` on DEMO_QUESTIONS
       synthetic questions at batch DEMO_BATCH (5 warmup batches, then
       DEMO_TIMED_BATCHES timed), q/s and ms a batch beside
       ``FusedServer.search`` in this process on the same batches; each
       /batch_api answer equal to ``FusedServer.search``'s,
       the four units to ``DensePhrases.search``'s; /api, /get_examples and
       the page return 200;
    b. two-process mode in two threads: a ``q_serve`` app and ``p_serve``
       index apps (``RemoteQueryEncoder``) over phase 7's SQ8 and OPQ96
       indexes (kernels C and D) on the first DEMO_IVF_BATCHES batches,
       equal to ``MIPS.search`` in this process on the same vectors;
    c. the reader app (``/single_api``) on READER_PAIRS pairs at L 384 over
       phase 9's teacher, equal to ``read_passages`` in this process;
    d. ``python -m densephrases_tpu_torch.cli.run_demo --demo_mode
       single_serve`` as a subprocess: its answers to every batch equal
       a's; then ``--demo_mode eval_request`` against it: the same EM as
       a's (the subprocesses' launches are not counted);
    e. the native store runtime: ``available()``, ``preload_metas`` through
       it byte-equal to per-doc ``meta()`` on phase 3's store and phase 7's
       dump and to plain zlib on a metadata-only store of DEMO_META_DOCS
       docs (phase 3's doc metadata repeated, one vector a doc), its time
       against plain zlib on each, ``benchmark_store_read``.

    Kernels A, C and D count from zero at the phase's start to its end; the
    in-process runs that the served answers are compared with are not
    counted. The counts must equal what the served requests imply. Returns
    them."""
    from densephrases_tpu_torch import native
    from densephrases_tpu_torch.cli.eval_phrase_retrieval import load_model
    from densephrases_tpu_torch.eval.reader import read_passages
    from densephrases_tpu_torch.data.qa import load_rc_examples
    from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.index.store import (
        DocMeta, PhraseStore, StoreWriter)
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.attention import ATTENTION_FWD
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE, PQ_SCAN_TOPK)
    from densephrases_tpu_torch.options import Options
    from densephrases_tpu_torch.serve import server
    from densephrases_tpu_torch.serve.fused import FusedServer
    from densephrases_tpu_torch.tools.benchmark import benchmark_store_read
    from densephrases_tpu_torch.train.cross_encoder import init_cross_params
    from densephrases_tpu_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "demo")
    os.makedirs(root)
    off = os.path.join(tmp, "offline")
    enc, dump = os.path.join(off, "enc"), os.path.join(off, "dump")
    qa_path = os.path.join(root, "qa.json")
    qa = synthetic_qa(rng, docs, DEMO_QUESTIONS)
    with open(qa_path, "w") as f:
        json.dump(qa, f)
    questions = [r["question"] for r in qa["data"]]
    pairs = [(r["question"], r["answers"]) for r in qa["data"]]
    batches = [questions[i:i + DEMO_BATCH]
               for i in range(0, len(questions), DEMO_BATCH)]
    layers = config.num_hidden_layers
    kernels = {"A": ATTENTION_FWD, "C": IVF_PACK_SCORE, "D": PQ_PACK_SCORE,
               "F": PQ_SCAN_TOPK}
    comparing = lambda: uncounted(*kernels.values())
    want = {"A": 0, "C": 0, "D": 0, "F": 0}
    flags = ["--load_dir", enc, "--dump_dir", dump, "--index_name", "flat",
             "--max_query_length", str(MAX_QUERY_LENGTH), "--top_k",
             str(DEMO_TOP_K)]
    for kernel in kernels.values():
        kernel.launches = 0

    # d starts first: the CLI server loads in its own process meanwhile
    cli_port = free_port()
    cli_log = open(os.path.join(root, "run_demo.log"), "w")
    cli = subprocess.Popen(
        [sys.executable, "-m", "densephrases_tpu_torch.cli.run_demo",
         "--demo_mode", "single_serve", "--index_port", str(cli_port),
         *flags], cwd=HERE, stdout=cli_log, stderr=subprocess.STDOUT)
    try:
        # ---- a. the index app through serve(): the fused route
        t0 = time.perf_counter()
        opts = Options().parse(flags, groups=["model", "index", "retrieval",
                                              "demo", "data"])
        model = load_model(opts, device=DEVICE)
        load_s = time.perf_counter() - t0
        fused = FusedServer(model)
        app = server.make_index_app(model, default_top_k=DEMO_TOP_K,
                                    examples=questions[:3])
        wait_for_port(cli_port, DEMO_CLI_TIMEOUT, cli)
        with serving(app, server.serve) as port:
            metrics = server.eval_request("127.0.0.1", port, pairs,
                                          batch_size=DEMO_BATCH,
                                          top_k=DEMO_TOP_K)
            want["A"] += len(batches) * 2 * layers
            a_served, post_ms = timed_posts(port, batches, top_k=DEMO_TOP_K)
            want["A"] += len(batches) * 2 * layers
            units = {unit: post_json(port, "/batch_api", {
                "query": batches[0][:8], "top_k": 5, "retrieval_unit": unit})
                for unit in ("phrase", "sentence", "paragraph", "document")}
            want["A"] += 4 * 2 * layers
            status = [get_status(port, "/api?query=" + urllib.parse.quote(
                questions[0])), get_status(port, "/get_examples"),
                get_status(port, "/")]
            want["A"] += 2 * layers
        with comparing():
            fused_ms = float(np.median([host_ms(
                lambda b=b: fused.search(b, top_k=DEMO_TOP_K), reps=1)
                for b in batches]))
            same = [same_served(got, fused.search(b, top_k=DEMO_TOP_K),
                                DEMO_TOP_K)
                    for got, b in zip(a_served, batches)]
            unit_gap, unit_same = 0.0, True
            for unit, got in units.items():
                answers, rets = model.search(batches[0][:8],
                                             retrieval_unit=unit, top_k=5,
                                             return_meta=True)
                unit_same &= got["answers"] == answers
                unit_gap = max([unit_gap] + [
                    abs(h["score"] - r["score"]) / max(1.0, abs(r["score"]))
                    for hs, rs in zip(got["ret"], rets)
                    for h, r in zip(hs, rs)])
        # the HTTP front's host work on one served batch: the server's
        # json.dumps and the client's json.loads of the /batch_api body,
        # and of the query vectors that p_serve fetches from q_serve (b)
        body_text = json.dumps(a_served[0], default=server._json_default)
        with comparing():
            vec_text = json.dumps({"vec": model.query2vec(
                batches[0]).float().cpu().tolist()})
        json_ms = {name: (host_ms(lambda t=text: json.dumps(json.loads(t))),
                          host_ms(lambda t=text: json.loads(t)), len(text))
                   for name, text in (("batch_api", body_text),
                                      ("query2vec", vec_text))}
        qps = metrics["qps"]
        log("11 demo", part="a index_app", questions=len(questions),
            batch=DEMO_BATCH, batches=len(batches), warmup_batches=5,
            demo_qps=qps, ms_per_batch=1e3 * DEMO_BATCH / qps,
            post_ms_per_batch_median=post_ms,
            fused_in_process_ms_per_batch_median=fused_ms,
            em_top1=metrics["em_top1"], em_topk=metrics["em_topk"],
            model_load_s=round(load_s, 3), card=repr(smi))
        for name, (round_trip, loads, size) in json_ms.items():
            log("11 demo", part="a json", body=name, bytes=size,
                dumps_plus_loads_ms=round_trip, loads_ms=loads)
        log("11 demo", part="a checks", batches_equal_fused=sum(same),
            units_equal=unit_same, units_max_rel_score_gap=unit_gap,
            tol=SCORE_RTOL, statuses=status)
        if not all(same) or not unit_same or unit_gap > SCORE_RTOL \
                or status != [200, 200, 200] or not np.isfinite(qps):
            raise AssertionError("phase 11a: the index app's answers differ "
                                 "from the in-process ones")

        # ---- b. two-process mode: q_serve + p_serve over SQ8 and OPQ96
        ivf_ms, ivf_batches = {}, batches[:DEMO_IVF_BATCHES]
        # OPQ96 at DEMO_TOP_K 10: scan_k 40, the fused select (F)
        for fq, kernel in (("SQ8", "C"), ("OPQ96", "F")):
            index = IVFIndex.load(os.path.join(
                dump, "start", f"{IVF_CLUSTERS}_flat_{fq}"), device=DEVICE)
            ivf_model = DensePhrases(model.params, model.config,
                                     model.tokenizer,
                                     MIPS(model.mips.store, index=index),
                                     max_query_length=MAX_QUERY_LENGTH)
            with serving(server.make_query_encoder_app(model),
                         server.serve) as q_port:
                remote = server.RemoteQueryEncoder("127.0.0.1", q_port)
                p_app = server.make_index_app(ivf_model, DEMO_TOP_K,
                                              remote_encoder=remote)
                with serving(p_app, server.serve) as p_port:
                    served, ivf_ms[fq] = timed_posts(p_port, ivf_batches,
                                                     top_k=DEMO_TOP_K)
            want["A"] += len(ivf_batches) * 2 * layers
            want[kernel] += len(ivf_batches)
            with comparing():
                same = [same_served(got, ivf_model.mips.search(
                    model.query2vec(b).float(), q_texts=b, top_k=DEMO_TOP_K,
                    aggregate=True), DEMO_TOP_K)
                    for got, b in zip(served, ivf_batches)]
            log("11 demo", part="b two_process", index=fq,
                batches_equal_in_process=sum(same), batches=len(ivf_batches),
                ms_per_batch_median=ivf_ms[fq], flat_fused_post_ms=post_ms)
            if not all(same):
                raise AssertionError(f"phase 11b: p_serve over {fq} differs "
                                     f"from MIPS.search in this process")
            del ivf_model, index

        # ---- c. the reader app over phase 9's teacher
        teacher_dir = os.path.join(tmp, "trainers", "teacher")
        teacher = restore_checkpoint(
            os.path.join(teacher_dir, "params"),
            init_cross_params(config, torch.Generator().manual_seed(0),
                              device=DEVICE))
        tok = WordPieceTokenizer.from_vocab_file(
            os.path.join(teacher_dir, "vocab.txt"))
        examples = load_rc_examples(os.path.join(tmp, "train.json"))
        body = {"question": [e["question"] for e in examples[:READER_PAIRS]],
                "passage": [e["context"] for e in examples[:READER_PAIRS]]}
        with serving(server.make_reader_app(teacher, config, tok),
                     server.serve) as port:
            reader_ms = host_ms(lambda: post_json(port, "/single_api", body),
                                reps=3)
            got = post_json(port, "/single_api", body)
        want["A"] += 5 * layers
        with comparing():
            ref = read_passages(teacher, config, tok, body["question"],
                                body["passage"], max_length=READER_LEN)
        same = got["ret"] == json.loads(json.dumps(ref))
        log("11 demo", part="c reader_app", pairs=len(body["question"]),
            max_length=READER_LEN, equal_in_process=same,
            ms_per_request_median=reader_ms)
        if not same:
            raise AssertionError("phase 11c: /single_api differs from "
                                 "read_passages in this process")
        del teacher

        # ---- d. the CLI: its server (started above) and its client; its
        # answers to every batch equal a's (another process, the same
        # weights, store and kernels)
        cli_served, cli_ms = timed_posts(cli_port, batches, top_k=DEMO_TOP_K)
        cli_equal = sum(same_answers(got, want_a)
                        for got, want_a in zip(cli_served, a_served))
        t0 = time.perf_counter()
        client = subprocess.run(
            [sys.executable, "-m", "densephrases_tpu_torch.cli.run_demo",
             "--demo_mode", "eval_request", "--index_port", str(cli_port),
             "--test_path", qa_path, "--eval_batch_size", str(DEMO_BATCH),
             "--top_k", str(DEMO_TOP_K)], cwd=HERE, capture_output=True,
            text=True, timeout=DEMO_CLI_TIMEOUT)
        found = re.search(r"metrics: EM@1=([0-9.]+) qps=([0-9.a-z]+)",
                          client.stderr + client.stdout)
        log("11 demo", part="d run_demo_cli", returncode=client.returncode,
            em_top1=found and found.group(1), qps=found and found.group(2),
            em_top1_in_process_server=f"{metrics['em_top1']:.2f}",
            batches_equal_to_a=cli_equal, batches=len(batches),
            post_ms_per_batch_median=cli_ms,
            seconds=round(time.perf_counter() - t0, 3))
        if client.returncode != 0 or found is None \
                or cli_equal != len(batches) \
                or found.group(1) != f"{metrics['em_top1']:.2f}":
            raise AssertionError(f"phase 11d: run_demo eval_request "
                                 f"({client.returncode}): "
                                 f"{client.stderr[-2000:]}")
    except Exception:
        cli_log.flush()
        with open(cli_log.name) as f:
            print(f"phase 11: the run_demo server's log ends:\n"
                  f"{f.read()[-3000:]}", file=sys.stderr, flush=True)
        raise
    finally:
        cli.terminate()
        try:
            cli.wait(timeout=30)
        except subprocess.TimeoutExpired:
            cli.kill()
            cli.wait()
        cli_log.close()

    # ---- e. the native store runtime
    if not native.available():
        raise AssertionError("phase 11e: the native store runtime did not "
                             "build (g++ and zlib.h)")
    for name, path in (("phase 3 store", os.path.join(tmp, "store")),
                       ("phase 7 dump", os.path.join(dump, "phrase"))):
        fast = PhraseStore.load(path)
        t0 = time.perf_counter()
        fast.preload_metas()
        native_ms = 1e3 * (time.perf_counter() - t0)
        metas = PhraseStore.load(path).metas
        t0 = time.perf_counter()
        plain = [DocMeta.decompress(m) for m in metas]  # plain zlib, per doc
        zlib_ms = 1e3 * (time.perf_counter() - t0)
        each = PhraseStore.load(path)
        equal = (meta_bytes(fast.meta(i) for i in range(fast.num_docs))
                 == meta_bytes(each.meta(i) for i in range(each.num_docs))
                 == meta_bytes(plain))
        log("11 demo", part="e native", store=name, docs=fast.num_docs,
            buffers=4 * fast.num_docs, preload_native_ms=native_ms,
            preload_zlib_ms=zlib_ms, byte_equal=equal)
        if not equal:
            raise AssertionError(f"phase 11e: native preload_metas differs "
                                 f"from per-doc meta() on the {name}")
    # the same against plain zlib at a doc count where the threads have
    # work: phase 3's doc metadata, still compressed, repeated under new ids
    src = PhraseStore.load(os.path.join(tmp, "store"))
    big = os.path.join(root, "meta_store")
    t0 = time.perf_counter()
    writer = StoreWriter(big, src.dim, src.offset, src.scale)
    one_row = np.zeros((1, src.dim), np.int8)
    for i in range(DEMO_META_DOCS):
        writer.add_doc_raw(i, one_row, {
            **src.meta_compressed(i % src.num_docs), "doc_id": i})
    writer.finalize(build_sidecars=False)
    write_s = time.perf_counter() - t0
    fast = PhraseStore.load(big)
    t0 = time.perf_counter()
    fast.preload_metas()
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = [DocMeta.decompress(m) for m in fast.metas]
    zlib_ms = 1e3 * (time.perf_counter() - t0)
    equal = same_metas([fast.meta(i) for i in range(fast.num_docs)], plain)
    raw_mb = sum(sum(m["sizes"].values()) for m in fast.metas) / 1e6
    log("11 demo", part="e native", store="metadata only", docs=fast.num_docs,
        buffers=4 * fast.num_docs, raw_mb=round(raw_mb, 1),
        preload_native_ms=native_ms, preload_zlib_ms=zlib_ms,
        native_speedup=zlib_ms / native_ms, byte_equal=equal,
        write_s=round(write_s, 3), host_cores=os.cpu_count())
    if not equal:
        raise AssertionError("phase 11e: native preload_metas differs from "
                             "plain zlib on the metadata-only store")
    del fast, plain, src
    shutil.rmtree(big)
    log("11 demo", part="e benchmark_store_read",
        **benchmark_store_read(os.path.join(tmp, "store"), seed=SEED))

    counts = {k: kernel.launches for k, kernel in kernels.items()}
    log("11 demo", **{f"{k.lower()}_launches": v for k, v in counts.items()},
        **{f"{k.lower()}_expected": v for k, v in want.items()},
        wall_s=round(time.perf_counter() - t_phase, 3))
    if counts != want:
        raise AssertionError(f"phase 11 launches {counts} != expected {want}")
    return counts


# phase 12: the measurement tools and the examples. a-d at the reference's
# width (768) and list shape (~160 rows a list) on a cut corpus of
# AT_N rows; e the five examples; f the trained-vector study on a corpus
# built from the checkout's own prose (BERT-base towers, REAL_* steps)
AT_N, AT_D = 1 << 21, 768
AT_NLIST = AT_N // 160  # 13,107 lists
AT_QUANTS, AT_PROBES, AT_N_REP = ("SQ8", "SQ4", "OPQ96"), (16, 64, 256), 5
AT_CPU_NPROBE, AT_CPU_RF = 16, 16
AT_E2E_PROBES = (16, 256)
AT_TIER_NLIST, AT_TIER_PROBES, AT_TIER_CHUNK = 8192, (16, 64), 1 << 20
AT_ID_AGREEMENT = 0.99  # numpy recomputation vs the CPU baseline (fp32 sums)
REAL_MLM_STEPS, REAL_MLM_BATCH = 4, 16
REAL_STEPS, REAL_BATCH, REAL_SEQ, REAL_EVAL_EVERY = 20, 12, 192, 10
REAL_QFT_PAIRS, REAL_QFT_TOPK = 96, 20
REAL_NQ, REAL_PROBES = 64, (16, 64)
# bench_ivf_e2e's work per run: the ground truth's encode, the served
# batches (first, 4 warmup, 5 windows of 8), the stage split's encodes (1
# warmup + 4, then one) and searches (1 + 4, then one), the served-vs-
# MIPS.search check and the recall probe's search
E2E_SERVED = 1 + 4 + 5 * 8
E2E_ENCODES = 1 + E2E_SERVED + 5 + 1
E2E_SEARCHES = E2E_SERVED + 5 + 1 + 1 + 1
# bench_serve_real's, beyond its EM batches: the first batch, 4 warmup, 5
# windows of 8, the stage split (5 + 1)
SERVE_REAL_EXTRA = 1 + 4 + 5 * 8 + 5 + 1


def numpy_ivfpq(idx, queries, nprobe, refine_factor, top_k=20):
    """The IVF-PQ search over a saved index written another way than
    ``bench_cpu_ivf.cpu_ivfpq_search``: each probed row decoded to its
    vector (books gathered, not a LUT sum), full sorts; ids [B, top_k]."""
    from densephrases_tpu_torch.ops.pq import unpack_nibbles

    cents, offs = idx["centroids"], idx["list_offsets"]
    books = idx["pq"].codebooks
    m, ksub, dsub = books.shape
    out = []
    for q in queries:
        probe = np.argsort(-(cents @ q), kind="stable")[:nprobe]
        rows = np.concatenate([np.arange(offs[li], offs[li + 1])
                               for li in probe])
        lists = np.concatenate([np.full(offs[li + 1] - offs[li], li)
                                for li in probe])
        codes = np.asarray(idx["codes"][rows])
        if ksub == 16:
            codes = unpack_nibbles(codes)
        recon = books[np.arange(m)[None, :], codes].reshape(len(rows), -1)
        qr = q if idx["rotation"] is None else q @ idx["rotation"]
        s = recon @ qr
        if idx["pq_residual"]:
            s = s + cents[lists] @ q
        sel = np.argsort(-s, kind="stable")[:min(top_k * refine_factor,
                                                 len(s))]
        gids = idx["row_perm"][rows[sel]]
        rs = (np.asarray(idx["refine"][gids], np.float32) @ q / idx["scale"]
              + q.sum() * idx["offset"])
        out.append(gids[np.argsort(-rs, kind="stable")[:top_k]])
    return np.stack(out)


def example_launches(docs, tok, layers, dump_batch, query_batches):
    """Kernel A in one example: its dump (one launch a layer a batch of
    windows) and its query encodes (two towers a batch)."""
    from densephrases_tpu_torch.data.features import convert_context_to_features

    windows = sum(len(convert_context_to_features(
        i, d["title"], d["paragraphs"], tok, max_seq_length=128)[0])
        for i, d in enumerate(docs))
    return layers * (-(-windows // dump_batch) + 2 * query_batches)


def phase_tools(tmp, smi):
    """Phase 12: the measurement tools and the examples through their
    entry points (``main(argv, device="cuda")``).

    a. ``bench_ivf_scale`` at AT_N x 768 in AT_NLIST lists (the reference's
       ~160 rows a list), SQ8 / SQ4 / OPQ96 at probes 16 / 64 / 256, with
       its kernel rows (C, D alone on the batch of 64's own inputs); then,
       outside the count, full-probe SQ8's top-1 against the flat top-1;
    b. ``bench_cpu_ivf`` (host numpy) on a's OPQ96 save at nprobe 16 and
       refine 16, its ids against ``numpy_ivfpq`` on the same save, its q/s
       beside a's device q/s;
    c. ``bench_ivf_e2e`` on a's caches: OPQ96 served in refine, decode and
       host_refine mode at nprobe 16 and 256 (BERT-base towers), each
       served batch equal to ``MIPS.search`` on the same vectors, device
       bytes each;
    d. ``bench_tiered30m --n auto --n_cap AT_N`` (the disk check, then
       capped: the corpus sits within the card), ``TieredIVF`` at p16 /
       p64 beside the same save in memory (kernel C);
    e. the five examples (tiny encoders from scratch, ``--vocab_kind
       whole_word``: the card's machine has no ``tokenizers``);
    f. the corpus from the checkout's own docstrings and ``.md`` files,
       ``cli.train_mlm`` (whole-word vocab) at BERT-base width for
       REAL_MLM_STEPS steps, ``dsmall`` on it (RC training with
       selection, two scales, one query-FT epoch), ``bench_ivf_real``
       (SQ8, SQ4, OPQ96) and ``bench_serve_real`` (flat, OPQ96 decode)
       on its largest store. At these step counts EM only shows that the
       path runs.

    A-D count from zero before a and are read after d ("at_scale"), and
    again from zero before e to after f ("real"); each part's counts must
    meet its formula: a's from the searches it makes, c's from E2E_*, d's
    in-memory searches, e's dumps and encodes, f's MLM (2L A, L B a step),
    RC (6L A with the recompute, 3L B a step) and query-FT (2L B a stepped
    batch), and the grid's and serve's searches. Kernel A's count in f's
    dsmall and examples is also held against the layer forwards run (every
    attention on the path through kernel A)."""
    from densephrases_tpu_torch.cli import train_mlm
    from densephrases_tpu_torch.data.tokenization import build_vocab
    from densephrases_tpu_torch.examples import (
        _common, create_custom_index, entity_linking, fid_reader,
        knowledge_dialogue, slot_filling)
    from densephrases_tpu_torch.index.ivf import IVFIndex
    from densephrases_tpu_torch.models import bert
    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.ops.ivf_pack import (
        IVF_PACK_SCORE, PQ_PACK_SCORE, PQ_SCAN_TOPK)
    from densephrases_tpu_torch.tools import (
        bench_cpu_ivf, bench_ivf_e2e, bench_ivf_real, bench_ivf_scale,
        bench_serve_real, bench_tiered30m, dsmall)

    kernels = {"A": ATTENTION_FWD, "B": ATTENTION_BWD, "C": IVF_PACK_SCORE,
               "D": PQ_PACK_SCORE, "F": PQ_SCAN_TOPK}
    root = os.path.join(tmp, "tools")
    work = os.path.join(root, "work")
    os.makedirs(work)
    out = lambda name: os.path.join(root, name)
    counts = {}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def read():
        torch.cuda.synchronize()
        return {n: k.launches for n, k in kernels.items()}

    def part(name, before, want):
        """Check one part's launches (the counters' growth since
        ``before``) against its formula."""
        now = read()
        got = {n: now[n] - before[n] for n in now}
        log("12 tools", part=name,
            **{f"{n.lower()}_launches": v for n, v in got.items()},
            **{f"{n.lower()}_expected": v for n, v in want.items()})
        if got != {n: want.get(n, 0) for n in got}:
            raise AssertionError(f"phase 12 {name}: launches {got} != {want}")
        return now

    layer_calls = [0]
    real_layer_forward = bert.BertLayer.forward

    def counted_layer(self, *a, **kw):
        layer_calls[0] += 1
        return real_layer_forward(self, *a, **kw)

    # ---- a. the at-scale grid
    zero()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    grid = bench_ivf_scale.main(
        ["--n", str(AT_N), "--d", str(AT_D), "--nlist", str(AT_NLIST),
         "--quants", ",".join(AT_QUANTS),
         "--probes", ",".join(map(str, AT_PROBES)),
         "--n_rep", str(AT_N_REP), "--kernel_rows", "--workdir", work,
         "--out", out("IVF_SCALE.json")], device=DEVICE)
    grid_s = time.perf_counter() - t0
    # per probe: the b1 and b64 searches (one each, then 2 warmup + n_rep
    # timed); SQ8's batch of 1 takes the probe-score path (no C); one
    # counted search of the kernel row at b64. OPQ96 at GT_K 20: scan_k 80
    # > PQ_K_MAX, so D's scores and the select after them, never F
    per = 1 + 2 + AT_N_REP
    want_a = {"C": len(AT_PROBES) * ((per + 1) + (2 * per + 1)),
              "D": len(AT_PROBES) * (2 * per + 1), "F": 0}
    now = part("a bench_ivf_scale", dict.fromkeys(kernels, 0), want_a)
    for quant in AT_QUANTS:
        row = grid[f"ivf_{quant}"]
        for p in AT_PROBES:
            ent = row[f"p{p}"]
            for k in ("recall20_b1", "recall20_b64"):
                if not 0.0 <= ent[k] <= 1.0:
                    raise AssertionError(f"12a {quant} p{p}: {k} {ent[k]}")
            kr = row["kernel"][f"p{p}"]
            log("12 tools", part="a", quant=quant, nprobe=p,
                b1_ms=ent["b1_ms"], b64_ms=ent["b64_ms"],
                b64_qps=ent["b64_qps"], recall20_b1=ent["recall20_b1"],
                recall20_b64=ent["recall20_b64"], kernel=kr["kernel"],
                kernel_ms=kr["ms"], scan_ms=kr["scan_ms"],
                share_of_scan=kr["share_of_scan"], bound_ms=kr["bound_ms"],
                bound_by=kr["bound_by"], rows=kr["rows"],
                kernel_launches=kr["launches"])
            if kr["launches"] != 1:
                raise AssertionError(f"12a {quant} p{p}: {kr}")
        log("12 tools", part="a", quant=quant,
            **{k: row[k] for k in ("build_s", "nlist_actual", "cap",
                                   "list_mean", "list_max", "code_bytes",
                                   "device_bytes") if k in row})
    log("12 tools", part="a", n=AT_N, nlist=AT_NLIST, seconds=grid_s,
        gen_s=grid.get("gen_s"), gt_s=grid["gt_s"],
        flat_b64_ms=grid["flat_b64_ms"], flat_b1_ms=grid["flat_b1_ms"])
    host = np.load(bench_ivf_scale.corpus_path(work, AT_N, AT_D),
                   mmap_mode="r")
    qrows = bench_ivf_scale.corpus_queries(host)
    gt = np.load(bench_ivf_scale.corpus_path(work, AT_N, AT_D)
                  + ".gt20.npz")
    with uncounted(*kernels.values()):
        sq8 = IVFIndex.load(bench_ivf_scale.index_dir(
            work, "SQ8", AT_N, AT_D, AT_NLIST), device=DEVICE)
        _, full = sq8.search(qrows[1:], top_k=1, nprobe=sq8.nlist)
        del sq8
        torch.cuda.empty_cache()
    agree = float((full[:, 0] == gt["ei64"][:, 0]).mean())
    log("12 tools", part="a", full_probe_sq8_top1_agreement=agree)
    if agree != 1.0:
        raise AssertionError(f"12a: full-probe SQ8 top-1 {agree} of flat")

    # ---- b. the CPU baseline on a's OPQ96 save (host only)
    cpu = bench_cpu_ivf.main(
        ["--n", str(AT_N), "--d", str(AT_D), "--nlist", str(AT_NLIST),
         "--quant", "OPQ96", "--nprobe", str(AT_CPU_NPROBE),
         "--refine_factor", str(AT_CPU_RF), "--windows", "3", "--workdir",
         work, "--out", out("BENCH_IVF.json")])
    now = part("b bench_cpu_ivf", now, {})
    idx = bench_cpu_ivf.load_index_host(bench_ivf_scale.index_dir(
        work, "OPQ96", AT_N, AT_D, AT_NLIST))
    got = bench_cpu_ivf.cpu_ivfpq_search(idx, qrows[1:], nprobe=AT_CPU_NPROBE,
                                         refine_factor=AT_CPU_RF)
    want = numpy_ivfpq(idx, qrows[1:], AT_CPU_NPROBE, AT_CPU_RF)
    ids_agree = float(np.mean([len(set(a) & set(b)) / len(b) for a, b in
                               zip(got.tolist(), want.tolist())]))
    exact = float(np.mean([a == b for a, b in zip(got.tolist(),
                                                  want.tolist())]))
    dev_qps = grid["ivf_OPQ96"][f"p{AT_CPU_NPROBE}"]["b64_qps"]
    log("12 tools", part="b", cpu_qps=cpu["qps"],
        cpu_recall20=cpu["recall20_b64"], device_qps_p16=dev_qps,
        device_over_cpu=dev_qps / cpu["qps"], host_threads=cpu["host_threads"],
        ids_agree_with_numpy=ids_agree, queries_exactly_equal=exact,
        tol=AT_ID_AGREEMENT)
    if ids_agree < AT_ID_AGREEMENT:
        raise AssertionError(f"12b: CPU baseline ids {ids_agree} of numpy")

    # ---- c. the whole serve over a's OPQ96 (BERT-base towers)
    layers = bert.BertConfig().num_hidden_layers
    for mode in ("refine", "decode", "host_refine"):
        for p in AT_E2E_PROBES:
            t0 = time.perf_counter()
            e2e = bench_ivf_e2e.main(
                ["--n", str(AT_N), "--d", str(AT_D), "--nlist",
                 str(AT_NLIST), "--quant", "OPQ96", "--serve_mode", mode,
                 "--nprobe", str(p), "--workdir", work, "--out",
                 out("BENCH_IVF.json")], device=DEVICE)
            # top_k 10 (scan_k 40, or 10 without a refine): F; the recall
            # probe's top_k 20 scans 80 columns where a refine widens it
            # (D's scores), 20 in decode mode (F)
            d = 0 if mode == "decode" else 1
            now = part(f"c bench_ivf_e2e {mode} p{p}", now,
                       {"A": 2 * layers * E2E_ENCODES, "D": d,
                        "F": E2E_SEARCHES - d})
            log("12 tools", part="c", mode=mode, nprobe=p,
                seconds=time.perf_counter() - t0, qps=e2e["qps"],
                stages_ms=json.dumps(e2e["stages_ms"]),
                stage1_recall20=e2e["stage1_recall20_indist"],
                device_resident_bytes=e2e["device_resident_bytes"],
                allocated_delta_bytes=e2e["allocated_delta_bytes"],
                mips_init_s=e2e["mips_init_s"],
                served_equal=e2e["served_equals_mips_search"],
                **{k: e2e[k] for k in ("gt_allocated_before",
                                       "gt_allocated_with_flat",
                                       "gt_allocated_after") if k in e2e})
            if not e2e["served_equals_mips_search"]:
                raise AssertionError(f"12c {mode} p{p}: served != MIPS")
            if not 0.0 <= e2e["stage1_recall20_indist"] <= 1.0:
                raise AssertionError(f"12c {mode} p{p}: recall {e2e}")
            if e2e.get("gt_allocated_after", 0) > \
                    e2e.get("gt_allocated_before", 0) + (64 << 20):
                raise AssertionError(f"12c: the flat scan was not freed {e2e}")

    # ---- d. the tiered serve, the disk check, beside the in-memory index
    t0 = time.perf_counter()
    tier = bench_tiered30m.main(
        ["--n", "auto", "--n_cap", str(AT_N), "--d", str(AT_D), "--nlist",
         str(AT_TIER_NLIST), "--probes", ",".join(map(str, AT_TIER_PROBES)),
         "--batch", "64", "--chunk", str(AT_TIER_CHUNK), "--compare_hbm",
         "--workdir", work, "--out", out("BENCH_IVF.json")], device=DEVICE)
    now = part("d bench_tiered30m", now,
               {"C": len(AT_TIER_PROBES) * (1 + 3)})
    for p in AT_TIER_PROBES:
        t, h = tier[f"p{p}"], tier["hbm"][f"p{p}"]
        log("12 tools", part="d", nprobe=p, tiered_qps=t["qps"],
            tiered_recall20=t["recall20_b64"], hbm_qps=h["qps"],
            hbm_recall20=h["recall20_b64"])
        if not (0.0 <= t["recall20_b64"] <= 1.0
                and abs(t["recall20_b64"] - h["recall20_b64"]) <= 0.05):
            raise AssertionError(f"12d p{p}: {t} vs {h}")
    log("12 tools", part="d", seconds=time.perf_counter() - t0,
        sizing=json.dumps(tier["sizing"]),
        device_resident_bytes=tier["device_resident_bytes"],
        build_s=tier["build_s"], gen_s=tier["gen_s"], gt_s=tier["gt_s"])
    counts["at_scale"] = read()
    shutil.rmtree(work)

    # ---- e. the five examples (A only; counted from zero)
    zero()
    bert.BertLayer.forward = counted_layer
    try:
        texts = [d["text"] for d in _common.TINY_WIKI]
        docs = [{"title": d["title"], "paragraphs": [d["text"]]}
                for d in _common.TINY_WIKI]
        ex_tok = build_vocab(texts, vocab_size=1200, kind="whole_word")
        now = dict.fromkeys(kernels, 0)
        for name, mod in (("entity_linking", entity_linking),
                          ("fid_reader", fid_reader),
                          ("knowledge_dialogue", knowledge_dialogue),
                          ("slot_filling", slot_filling)):
            metrics, rows = mod.main(["--workdir", out(name), "--vocab_kind",
                                      "whole_word"], device=DEVICE)
            now = part(f"e {name}", now, {"A": example_launches(
                docs, ex_tok, 2, 4, 1)})
            log("12 tools", part="e", example=name, rows=len(rows),
                metrics=json.dumps(metrics))
        arts = out("articles.json")
        with open(arts, "w") as f:
            json.dump({"data": [{"title": d["title"], "paragraphs": [
                {"context": d["text"]}]} for d in _common.TINY_WIKI]}, f)
        qs = out("questions.json")
        with open(qs, "w") as f:
            json.dump({"data": [{"question": q, "answers": a} for q, a in (
                ("Who discovered radium?", ["Marie Curie"]),
                ("Who wrote the first computer program?", ["Ada Lovelace"]),
                ("Who broke the Enigma code?", ["Alan Turing"]))]}, f)
        cci = create_custom_index.main(
            ["--articles", arts, "--questions", qs, "--workdir",
             out("custom_index"), "--vocab_kind", "whole_word"],
            device=DEVICE)
        cci_tok = build_vocab(texts, vocab_size=4000, kind="whole_word")
        now = part("e create_custom_index", now, {"A": example_launches(
            docs, cci_tok, 2, 16, len(cci))})
        log("12 tools", part="e", example="create_custom_index",
            answers=json.dumps([a for _, _, a in cci]))
        if not all(len(a) for _, _, a in cci):
            raise AssertionError("12e: custom index gave no answers")
        if layer_calls[0] != now["A"]:
            raise AssertionError(f"12e: A {now['A']} != layer forwards "
                                 f"{layer_calls[0]}")

        # ---- f. the trained-vector study
        real = os.path.join(root, "real")
        ds_dir = os.path.join(real, "dsmall")
        md = os.path.join(real, "md")  # the checkout's top-level .md files
        os.makedirs(md)
        for fn in sorted(os.listdir(HERE)):
            if fn.endswith(".md"):
                shutil.copy(os.path.join(HERE, fn), md)
        t0 = time.perf_counter()
        corpus = dsmall.main(
            ["--corpus_only", "--workdir", ds_dir, "--doc_roots",
             os.path.join(HERE, "densephrases_tpu_torch"), "--md_roots", md,
             "--out", out("CORPUS.json")], device=DEVICE)
        corpus_json = os.path.join(ds_dir, "corpus_docs.json")
        n_pars = corpus["n_paragraphs"]
        log("12 tools", part="f", n_docs=corpus["n_docs"],
            n_paragraphs=n_pars, corpus_s=time.perf_counter() - t0)
        before_layers = layer_calls[0]
        mlm_dir = os.path.join(real, "mlm")
        t0 = time.perf_counter()
        blob = train_mlm.main(
            ["--out", mlm_dir, "--corpus", os.path.join(ds_dir, "corpus.txt"),
             "--steps", str(REAL_MLM_STEPS), "--batch", str(REAL_MLM_BATCH),
             "--seq", "128", "--hidden", "768",
             "--layers", str(layers), "--heads", "12", "--vocab", "8000",
             "--vocab_kind", "whole_word", "--max_pos", "512", "--holdout",
             "0"], device=DEVICE)
        now = part("f train_mlm", now, {"A": 2 * layers * REAL_MLM_STEPS,
                                        "B": layers * REAL_MLM_STEPS})
        log("12 tools", part="f", mlm_s=time.perf_counter() - t0,
            mlm_loss_first=blob["loss_first"], mlm_loss_last=blob["loss_last"])
        scales = f"{n_pars // 3},{n_pars}"
        t0 = time.perf_counter()
        ds = dsmall.main(
            ["--workdir", ds_dir, "--corpus", corpus_json, "--pretrained",
             mlm_dir, "--scales", scales, "--dev_pars", "20",
             "--dev_per_par", "8", "--train_per_par",
             "6", "--train_max_pars", "200", "--steps", str(REAL_STEPS),
             "--batch", str(REAL_BATCH), "--seq", str(REAL_SEQ),
             "--pre_batch", "2", "--eval_every", str(REAL_EVAL_EVERY),
             "--patience", "3", "--qft_epochs", "1", "--qft_pairs",
             str(REAL_QFT_PAIRS), "--qft_topk", str(REAL_QFT_TOPK),
             "--qft_batch", str(REAL_BATCH), "--dump_batch", "32", "--out",
             out("DSMALL.json")], device=DEVICE)
        rc_steps = ds["rc_train"]["steps_run"]
        qft_steps = sum(ds["qft"]["steps"])
        fwd = layer_calls[0] - before_layers - 2 * layers * REAL_MLM_STEPS
        now = part("f dsmall", now, {
            "A": fwd, "B": 3 * layers * rc_steps + 2 * layers * qft_steps})
        log("12 tools", part="f", dsmall_s=time.perf_counter() - t0,
            rc_steps=rc_steps, best_step=ds["rc_train"]["best_step"],
            best_dev_loss=ds["rc_train"]["best_dev_loss"],
            qft_steps=qft_steps, n_train=ds["n_train"], n_dev=ds["n_dev"],
            scales=json.dumps({k: {"n_vecs": v["n_vecs"],
                                   "em_top1": v["dev"]["em_top1"],
                                   "em_top10": v["dev"]["em_top10"]}
                               for k, v in ds["scales"].items()}),
            qft_em1_delta=ds["qft"]["em1_delta"],
            note="EM at these step counts only shows that the path runs")
        if rc_steps != REAL_STEPS or qft_steps <= 0:
            raise AssertionError(f"12f dsmall: {ds['rc_train']} {ds['qft']}")
        store = os.path.join(ds_dir, f"store_pars{n_pars}")
        enc = os.path.join(ds_dir, "encoder_qft")
        rv = bench_ivf_real.main(
            ["--store", store, "--encoder", enc, "--nlist", "256", "--nq",
             str(REAL_NQ), "--quants", "SQ8,SQ4,OPQ", "--probes",
             ",".join(map(str, REAL_PROBES)), "--out",
             out("IVF_REAL.json")], device=DEVICE)
        # OPQ96 a probe: top_k 20 at refine 16 (scan_k 320, D's scores),
        # then without the refine matrix (scan_k 20, F)
        np_ = len(REAL_PROBES)
        now = part("f bench_ivf_real", now,
                   {"A": 2 * layers, "C": 2 * np_, "D": np_, "F": np_})
        for key in ("ivf_SQ8", "ivf_SQ4", "ivf_OPQ96"):
            for p in REAL_PROBES:
                r = rv[key][f"p{p}"]
                log("12 tools", part="f", grid=key, nprobe=p,
                    list_max=rv[key]["list_max"],
                    list_mean=rv[key]["list_mean"], **{
                        k: r[k] for k in ("recall20", "recall20_norefine")
                        if k in r})
                if not 0.0 <= r["recall20"] <= 1.0:
                    raise AssertionError(f"12f {key} p{p}: {r}")
        with open(os.path.join(ds_dir, "qa_doc_split.json")) as f:
            n_dev = len(json.load(f)["dev"])
        em_batches = min(12, n_dev // 64)
        for index, k in (("flat", None), ("OPQ", "F")):  # top_k 1 and 10
            sr = bench_serve_real.main(
                ["--store", store, "--encoder", enc, "--index", index,
                 "--nprobe", "64", "--out", out("SERVE_REAL.json")],
                device=DEVICE)
            served = em_batches + SERVE_REAL_EXTRA
            want = {"A": 2 * layers * served}
            if k:
                want[k] = served
            now = part(f"f bench_serve_real {index}", now, want)
            log("12 tools", part="f", serve_real=index, qps=sr["qps"],
                dev_em1=sr["dev_em1"], dev_em1_n=sr["dev_em1_n"],
                meta_preload_s=sr["meta_preload_s"],
                stages_ms=json.dumps(sr["stages_ms"]),
                mips_init_s=sr["mips_init_s"])
        if layer_calls[0] != now["A"]:
            raise AssertionError(f"12e-f: A {now['A']} != layer forwards "
                                 f"{layer_calls[0]}")
    finally:
        bert.BertLayer.forward = real_layer_forward
    counts["real"] = read()
    log("12 tools", seconds=time.perf_counter() - t_phase,
        at_scale=json.dumps(counts["at_scale"]),
        real=json.dumps(counts["real"]), card=repr(smi))
    return counts


# phase 13: the serve benchmark at the root bench.py's size (a) and the
# coarse study at the reference's 2^20 requested lists (b), its corpus cut
# to the rows the phase affords (the reference: 10,485,760; at 2^20 rows
# k-means has too few members for 2^20 children and the balancer too few
# long lists to grow past them)
BENCH_ID_RTOL = 1e-5  # CPU baseline vs device scan: fp32 sums, other order
COARSE_NLIST = 1 << 20
COARSE_N = 5 << 18  # 1,310,720
COARSE_NPROBE = 16


def bench_reference_keys():
    """(keys, stages_ms keys) of the JSON line the root bench.py prints,
    read from its source (it imports jax, so it is parsed, not run)."""
    import ast

    with open(os.path.join(HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            top = node.args[0]
            stages = next(v for k, v in zip(top.keys, top.values)
                          if k.value == "stages_ms")
            return ({k.value for k in top.keys},
                    {k.value for k in stages.keys})
    raise AssertionError("bench.py prints no JSON dict")


def positive_leaves(obj, path="res"):
    """The paths of the numbers in a JSON value that are not positive."""
    if isinstance(obj, dict):
        return [b for k, v in obj.items()
                for b in positive_leaves(v, f"{path}.{k}")]
    if isinstance(obj, list):
        return [b for i, v in enumerate(obj)
                for b in positive_leaves(v, f"{path}[{i}]")]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [] if obj > 0 else [path]
    return []


def spans_of(outs):
    return [[(r["doc_idx"], r["start_idx"], r["end_idx"]) for r in ret]
            for ret in outs]


def topk_lower_id(scores, k):
    """Exact top-k ids of each row, ties to the lower id: ``torch.topk``
    for the k-th value, then every column at or above it ordered by score
    descending and id ascending."""
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    out = []
    for row, t in zip(scores, kth):
        cols = torch.nonzero(row >= t).flatten()  # ascending ids
        order = torch.sort(row[cols], descending=True, stable=True).indices
        out.append(cols[order[:k]])
    return torch.stack(out)


def phase_bench(tmp, smi):
    """Phase 13: the repository's serve benchmark and the reference-scale
    coarse study through their entry points.

    a. ``densephrases_tpu_torch.bench.main`` at its defaults (1M x 768 over
       10,000 docs, BERT-base towers, batch 64, top-k 10), ``--vocab_kind
       whole_word`` (no ``tokenizers`` here), its store kept: the JSON line
       has the root bench.py's keys but ``dispatch_floor`` and every number
       in it is positive (``mips_init_stages``, in whole milliseconds, at
       least 0); kernel A launched 2 x 12 times for each batch
       through the towers (``bench.towered_batches``). Then, outside the
       count, on the kept store: one batch's ``FusedServer`` answers equal
       ``DensePhrases.search``'s, the pipelined (depth 2 and 4) answers
       equal the synchronous ones, and ``cpu_mips_topk``'s ids equal the
       device flat scan's for one batch of the baseline's queries (rounded
       to bf16, as the scan rounds them), but for ids within BENCH_ID_RTOL
       of the k-th score.
    b. ``bench_ivf_scale.main --coarse_only --nlist 2^20`` over COARSE_N
       rows: the list lengths sum to the rows, ``nlist_actual`` >= 2^20,
       ``centroid_bytes`` = nlist_actual x 768 x 2, and the probe's ids at
       batch 64, nprobe 16 equal an exact top-k over the same bf16 scores
       with ties to the lower id.

    Returns {"A": kernel A's launches in a, "E": kernel E's}."""
    from densephrases_tpu_torch import bench
    from densephrases_tpu_torch.index.store import PhraseStore
    from densephrases_tpu_torch.models.attention import ATTENTION_FWD
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.ops.flat_scan import FLAT_SCAN_TOPK
    from densephrases_tpu_torch.ops.ivf_pack import probe
    from densephrases_tpu_torch.ops.kmeans import _bf16
    from densephrases_tpu_torch.tools import bench_ivf_scale

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "bench")
    os.makedirs(root)

    # ---- a. the serve benchmark (A from zero: warm-up to the last window)
    ATTENTION_FWD.launches = 0
    FLAT_SCAN_TOPK.launches = 0
    res = bench.main(["--vocab_kind", "whole_word", "--store_dir", root],
                     device=DEVICE)
    torch.cuda.synchronize()
    launches = ATTENTION_FWD.launches
    e_launches = FLAT_SCAN_TOPK.launches
    config = BertConfig()
    want_a = 2 * config.num_hidden_layers * bench.towered_batches()
    keys, stage_keys = bench_reference_keys()
    log("13 bench", part="a", value=res["value"], mode=res["mode"],
        vs_baseline=res["vs_baseline"], a_launches=launches,
        a_expected=want_a, e_launches=e_launches,
        seconds=round(time.perf_counter() - t_phase, 3))
    if launches != want_a:
        raise AssertionError(f"13a: A launched {launches} != {want_a}")
    if e_launches <= 0:
        raise AssertionError("13a: the fused flat scan never launched E")
    if set(res) != keys or set(res["stages_ms"]) != stage_keys - {
            "dispatch_floor"}:
        raise AssertionError(f"13a: keys {sorted(res)} / "
                             f"{sorted(res['stages_ms'])} != bench.py's")
    # MIPS rounds its stage seconds to the millisecond (as the reference
    # does): a stage under half of one reads 0.0
    bad = positive_leaves({k: v for k, v in res.items()
                           if k != "mips_init_stages"})
    bad += [k for k, v in res["mips_init_stages"].items() if v < 0]
    if bad or any(len(w) != bench.N_WINDOWS
                  for w in res["windows_s"].values()):
        raise AssertionError(f"13a: not positive {bad} or windows "
                             f"{res['windows_s']}")

    with uncounted(ATTENTION_FWD, FLAT_SCAN_TOPK):
        store = PhraseStore.load(os.path.join(root, "store"))
        if (store.num_docs, store.n_vecs) != (
                bench.N_DOCS, bench.N_DOCS * bench.VECS_PER_DOC):
            raise AssertionError(f"13a store: {store.num_docs} docs, "
                                 f"{store.n_vecs} vectors")
        model, fused, _ = bench.serve_model(
            store, config, bench.bench_vocab("whole_word"), device=DEVICE)
        queries = bench.bench_queries()
        sync = fused.search(queries, top_k=bench.TOP_K)
        _, modular = model.search(queries, retrieval_unit="phrase",
                                  top_k=bench.TOP_K, return_meta=True)
        if spans_of([r[:bench.TOP_K] for r in sync]) != spans_of(modular):
            raise AssertionError("13a: FusedServer != DensePhrases.search")
        for depth in (2, 4):
            outs = fused.search_pipelined([queries] * 3, depth=depth,
                                          top_k=bench.TOP_K)
            if [spans_of(o) for o in outs] != [spans_of(sync)] * 3:
                raise AssertionError(f"13a: pipelined depth {depth} != sync")
        q = bench.baseline_queries(np.random.default_rng(7), bench.BATCH,
                                   config.hidden_size)
        q = torch.as_tensor(q).to(torch.bfloat16).float().numpy()
        vecs = np.asarray(store.vecs[:])
        t0 = time.perf_counter()
        cpu_s, cpu_i = bench.cpu_mips_topk(vecs, q, bench.TOP_K,
                                           store.offset, store.scale)
        cpu_s_time = time.perf_counter() - t0
        _, dev_i = model.mips.index.search(q, top_k=bench.TOP_K)
        del model, fused
    swapped = 0
    for b in range(q.shape[0]):
        diff = set(cpu_i[b].tolist()) ^ set(dev_i[b].tolist())
        if not diff:
            continue
        rows = np.array(sorted(diff))
        s = (q[b] @ (vecs[rows].astype(np.float32) / store.scale).T
             + q[b].sum() * store.offset)
        kth = float(cpu_s[b, -1])
        if np.any(np.abs(s - kth) > BENCH_ID_RTOL * abs(kth)):
            raise AssertionError(f"13a: query {b} CPU ids {cpu_i[b]} != "
                                 f"device ids {dev_i[b]}")
        swapped += 1
    del vecs
    log("13 bench", part="a", fused_equals_modular=True,
        pipelined_equal_sync=True, cpu_ids_equal_device=True,
        near_tie_rows=swapped, cpu_topk_s=round(cpu_s_time, 3),
        stages_ms=json.dumps(res["stages_ms"]),
        mips_init_stages=json.dumps(res["mips_init_stages"]))
    shutil.rmtree(root)

    # ---- b. the coarse study at 2^20 requested lists
    t0 = time.perf_counter()
    work = os.path.join(tmp, "coarse")
    out = os.path.join(work, "COARSE.json")
    cres = bench_ivf_scale.main(
        ["--coarse_only", "--n", str(COARSE_N), "--nlist", str(COARSE_NLIST),
         "--workdir", work, "--out", out], device=DEVICE)
    row = cres["coarse"]
    d = cres["d"]
    cdir = bench_ivf_scale.coarse_dir(work, COARSE_N, d, COARSE_NLIST)
    centroids = np.load(os.path.join(cdir, "centroids.npy"))
    assign = np.load(os.path.join(cdir, "assign.npy"))
    k = centroids.shape[0]
    lens = np.bincount(assign, minlength=k)
    if (lens.sum() != COARSE_N or len(lens) != k
            or row["nlist_actual"] != k or k < COARSE_NLIST
            or row["centroid_bytes"] != k * d * 2):
        raise AssertionError(f"13b: {k} lists, {lens.sum()} rows, {row}")
    host = np.load(bench_ivf_scale.corpus_path(work, COARSE_N, d),
                   mmap_mode="r")
    qc = torch.as_tensor(bench_ivf_scale.coarse_queries(host),
                         device=DEVICE)
    cents = torch.as_tensor(centroids, device=DEVICE)
    got = probe(qc, cents, COARSE_NPROBE)
    want = topk_lower_id(_bf16(qc) @ _bf16(cents).T, COARSE_NPROBE)
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError("13b: probe ids != exact top-k")
    del cents, qc
    torch.cuda.empty_cache()
    log("13 bench", part="b", seconds=round(time.perf_counter() - t0, 3),
        rows=COARSE_N, probe_equals_exact_topk=True,
        coarse=json.dumps(row))
    shutil.rmtree(work)
    log("13 bench", seconds=round(time.perf_counter() - t_phase, 3),
        card=repr(smi))
    return {"A": launches, "E": e_launches}


def band_bias(mask, l, w, dtype):
    """The band's mask as ``scaled_dot_product_attention`` takes it: the
    padded keys' -1e9 and -inf off the band, [B, 1, L, L]."""
    pos = torch.arange(l, device=mask.device)
    off = (pos[:, None] - pos[None]).abs() > w
    bias = ((1 - mask) * -1e9)[:, None, None, :].expand(-1, 1, l, -1).clone()
    return bias.masked_fill(off, float("-inf")).to(dtype)


def phase_modernbert(smi):
    """Phase 14: A's banded instance, A's global path at the ModernBERT
    cell's shape, and one serve batch of ModernBERT-large towers. Returns
    {"band": the band's row, "global": A's row, "A", "band_launches", "E":
    the serve batch's launches}."""
    from densephrases_tpu_torch import bench
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.attention import (
        ATTENTION_BAND, ATTENTION_FWD, attention_cuda, attention_plain,
        band_pairs)
    from densephrases_tpu_torch.models.encoder import (
        embed_query, init_encoder_params)
    from densephrases_tpu_torch.models.modernbert import ModernBertConfig
    from densephrases_tpu_torch.ops.flat_scan import FLAT_SCAN_TOPK
    from densephrases_tpu_torch.serve.fused import FusedServer

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    tol = KERNEL_TOL["bfloat16"]
    # a. the band at its edge shapes, then at the cell's shape (timed)
    edge_err = 0.0
    for b, h, l, d, w in MB_EDGE_SHAPES:
        q, k, v, mask = attention_inputs(b, h, l, d, torch.bfloat16, gen)
        err = float((attention_cuda(q, k, v, mask, window=w).float()
                     - attention_plain(q, k, v, mask, window=w).float())
                    .abs().max())
        log("14 modernbert", kernel="attention_band", edge=f"{b}x{h}x{l}x{d}",
            window=w, max_abs_err=err, tol=tol)
        if err > tol:
            raise AssertionError(f"attention_band disagrees at {(b, h, l, d, w)}")
        edge_err = max(edge_err, err)
    b, h, l, d = MB_SHAPE
    w = MB_WINDOW
    q, k, v, mask = attention_inputs(b, h, l, d, torch.bfloat16, gen)
    mask[0] = 1
    out = attention_cuda(q, k, v, mask, window=w)
    ref = attention_plain(q, k, v, mask, window=w)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    bias = band_bias(mask, l, w, torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=bias)
    library_err = float((sdpa().float() - ref.float()).abs().max())
    pairs = band_pairs(l, w)
    bound_ms, bound_by = bound(4 * b * h * d * pairs,
                               4 * b * h * l * d * 2 + 4 * b * l, "bfloat16")
    ms = cuda_ms(lambda: attention_cuda(q, k, v, mask, window=w))
    band = {"shape": "x".join(map(str, MB_SHAPE)), "window": w,
            "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
            "edge_max_abs_err": edge_err, "ms": ms,
            "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, mask,
                                                        window=w), iters=5),
            "library_ms": cuda_ms(sdpa, iters=10), "library_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}
    log("14 modernbert", kernel="attention_band", **band)
    if err > tol:
        raise AssertionError(f"attention_band disagrees with plain: {band}")
    del bias, ref
    # A's global path at the same shape, against its plain twin (which
    # scores its query rows in blocks of PLAIN_SCORES_MAX) and SDPA
    bias = sdpa_bias(mask, torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=bias)
    gl_out = attention_cuda(q, k, v, mask)
    gl_ref = attention_plain(q, k, v, mask)
    err = float((gl_out.float() - gl_ref.float()).abs().max())
    library_err = float((sdpa().float() - gl_ref.float()).abs().max())
    del gl_ref
    bound_ms, bound_by = attention_bound(MB_SHAPE, torch.bfloat16, 4, 4)
    ms = cuda_ms(lambda: attention_cuda(q, k, v, mask), iters=10)
    glob = {"shape": "x".join(map(str, MB_SHAPE)), "dtype": "bfloat16",
            "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, mask),
                                iters=3, warmup=1),
            "library_ms": cuda_ms(sdpa, iters=10),
            "library_err": library_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms}
    log("14 modernbert", kernel="attention_fwd", **glob)
    if err > tol:
        raise AssertionError(f"attention_fwd disagrees with plain: {glob}")
    del q, k, v, mask, out, gl_out, bias
    torch.cuda.empty_cache()

    # b. one serve batch of ModernBERT-large towers through FusedServer
    cfg = ModernBertConfig()
    rng = np.random.default_rng(SEED)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mb_")
    store = bench.build_store(os.path.join(tmp.name, "store"),
                              n_docs=MB_DOCS, vecs_per_doc=100,
                              d=cfg.hidden_size, seed=SEED)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(cfg.vocab_size - 5)]
    from densephrases_tpu_torch.data.tokenization import WordPieceTokenizer
    tok = WordPieceTokenizer({t: i for i, t in enumerate(vocab)})
    params = init_encoder_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cuda")
    model = DensePhrases(params, cfg, tok, MIPS(store, device="cuda"),
                         max_query_length=cfg.max_position_embeddings,
                         serve_dtype="bf16")
    del params
    fused = FusedServer(model)
    texts = [" ".join(f"w{j}" for j in rng.integers(
        0, cfg.vocab_size - 5, int(n)))
        for n in rng.integers(MB_WORDS[0], MB_WORDS[1] + 1, MB_BATCH)]
    fused.search(texts, top_k=10)  # warm-up
    torch.cuda.synchronize()
    for kern in (ATTENTION_FWD, ATTENTION_BAND, FLAT_SCAN_TOPK):
        kern.launches = 0
    t0 = time.perf_counter()
    outs = fused.search(texts, top_k=10)
    batch_ms = 1e3 * (time.perf_counter() - t0)
    launches = {"A": ATTENTION_FWD.launches, "band": ATTENTION_BAND.launches,
                "E": FLAT_SCAN_TOPK.launches}
    n_glob = sum(cfg.is_global(i) for i in range(cfg.num_hidden_layers))
    log("14 modernbert", serve_batch=MB_BATCH, batch_ms=round(batch_ms, 1),
        global_launches=launches["A"], band_launches=launches["band"],
        e_launches=launches["E"],
        first_answer=repr(outs[0][0]["answer"][:40]) if outs[0] else None)
    if (launches["A"] != 2 * n_glob
            or launches["band"] != 2 * (cfg.num_hidden_layers - n_glob)
            or launches["E"] != 1):
        raise AssertionError(f"ModernBERT serve launches: {launches}")
    if len(outs) != MB_BATCH or not all(
            r and r[0]["answer"] == r[0]["context"][r[0]["start_pos"]:r[0]["end_pos"]]
            for r in outs):
        raise AssertionError("ModernBERT serve returned malformed results")
    # c. the towers through the kernels against the plain path
    ids = torch.as_tensor(rng.integers(5, cfg.vocab_size,
                                       (MB_BATCH, MB_PLAIN_LEN)), device="cuda")
    am = torch.ones_like(ids)
    for i in range(MB_BATCH):
        am[i, MB_PLAIN_LEN - 97 * i:] = 0
    got = embed_query(model.params, ids, am)
    want = embed_query(model.params, ids, am, attn_impl="plain")
    rel = max(float((g.float() - w_.float()).norm(dim=-1).max()
                    / w_.float().norm(dim=-1).min())
              for g, w_ in zip(got, want))
    log("14 modernbert", towers_kernel_vs_plain=rel, tol=MB_TOWER_RTOL,
        at=f"B={MB_BATCH} L={MB_PLAIN_LEN}",
        seconds=round(time.perf_counter() - t_phase, 1))
    if rel > MB_TOWER_RTOL:
        raise AssertionError("ModernBERT towers: kernel and plain disagree")
    del model, fused, store
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"band": band, "global": glob, "A": launches["A"],
            "band_launches": launches["band"], "E": launches["E"]}


def band_kernel_row(mb):
    """The JSON row of A's banded instance from phase 14's result."""
    band = mb["band"]
    return {"name": "attention_band", "route": "cuda",
            "source": "densephrases_tpu_torch/csrc/attention_band.cu",
            "replaces": "none (the JAX package has no windowed attention; "
                        "kernel A's tiles restricted to a band)",
            "launches": mb["band_launches"],
            "max_abs_err": max(band["max_abs_err"], band["edge_max_abs_err"]),
            **{k: band[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "global_at_same_shape": mb["global"],
            "at": "B=8 H=16 L=8192 D=64 w=64 bf16"}


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
        ATTENTION_BAND, ATTENTION_BWD, ATTENTION_FWD)
    from densephrases_tpu_torch.ops.flat_scan import FLAT_SCAN_TOPK
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
               "attention_band": ATTENTION_BAND,
               "attention_bwd": ATTENTION_BWD,
               "ivf_pack_score": IVF_PACK_SCORE,
               "pq_pack_score": PQ_PACK_SCORE,
               "flat_scan_topk": FLAT_SCAN_TOPK}
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
    flat_row = phase_flat_scan()
    pq_select_row = phase_pq_select()

    def counted_e(phase, fn, *args):
        """fn's result and kernel E's launches over it, which must be
        positive: the phase's flat int8 scans on the card take E."""
        FLAT_SCAN_TOPK.launches = 0
        out = fn(*args)
        n = FLAT_SCAN_TOPK.launches
        log(phase, e_launches=n)
        if n <= 0:
            raise AssertionError(f"phase {phase}: kernel E never launched")
        return out, n

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

    # ---- 4. serve (E's launch counter from zero)
    FLAT_SCAN_TOPK.launches = 0
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
    serve_e = FLAT_SCAN_TOPK.launches
    log("4 serve", attention_launches=serve_launches, e_launches=serve_e)
    if serve_launches <= 0:
        raise AssertionError("serving never launched attention_fwd")
    if serve_e <= 0:
        raise AssertionError("serving never launched flat_scan_topk")
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
    ivf_launches, ivf_e = counted_e("5 ivf", phase_ivf, store, params,
                                    config, tok, model, queries, rng)

    # ---- 6. train (main path: A and B launch counters from zero)
    train_launches = phase_train(tmp, params, config, tok, docs, mips, rng)

    # ---- 7. offline drivers (main path: A, C and D counters from zero)
    offline_launches, offline_e = counted_e(
        "7 offline", phase_offline, tmp, params, config, tok, docs, store,
        model, queries, rng, stats["windows"])

    # ---- 8. scale (g's path: A and C counters from zero)
    scale_launches, scale_e = counted_e("8 scale", phase_scale, tmp, config)

    # ---- 9. trainers (A, B and D counters from zero before each part)
    trainer_launches = phase_trainers(tmp, config, tok, docs, smi)

    # ---- 10. scale-out (A-D counted in this process and in every rank)
    scale_out_launches, scale_out_e = counted_e(
        "10 scale_out", phase_scale_out, tmp, store, model, config, docs, rng)

    # ---- 11. demo (A, C and D counters from zero; served requests only)
    demo_launches = phase_demo(tmp, config, docs, rng, smi)

    # ---- 12. tools and examples (A-D from zero over a-d, then over e-f)
    tool_launches = phase_tools(tmp, smi)

    # ---- 13. the serve benchmark and the coarse study (A from zero over
    # the benchmark's warm-up and windows)
    bench_launches = phase_bench(tmp, smi)

    # ---- 14. ModernBERT towers: A's band and global path at the cell's
    # shape, one serve batch (A, its band and E counted over that batch)
    mb = phase_modernbert(smi)

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
    fused_row = {**pq_select_row, "ms": pq_select_row["kernel_ms"],
                 "library_ms": None}
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "densephrases_tpu/models/attention.py:44",
        "launches": (main_path_launches + train_launches["A"]
                     + offline_launches["A"] + scale_launches["A"]
                     + trainer_launches["A"] + scale_out_launches["A"]
                     + demo_launches["A"] + tool_launches["at_scale"]["A"]
                     + tool_launches["real"]["A"] + bench_launches["A"]),
        "launches_by_path": {"dump_serve": main_path_launches,
                             "train": train_launches["A"],
                             "offline": offline_launches["A"],
                             "scale": scale_launches["A"],
                             "trainers": trainer_launches["A"],
                             "scale_out": scale_out_launches["A"],
                             "demo": demo_launches["A"],
                             "at_scale": tool_launches["at_scale"]["A"],
                             "real": tool_launches["real"]["A"],
                             "bench": bench_launches["A"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        **timing(serve_row, *bf16(kernel_rows)),
        "at": "B=64 H=12 L=32 D=64 bf16"}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "densephrases_tpu/models/attention.py:94",
        "launches": (train_launches["B"] + trainer_launches["B"]
                     + scale_out_launches["B"] + tool_launches["real"]["B"]),
        "launches_by_path": {"train": train_launches["B"],
                             "trainers": trainer_launches["B"],
                             "scale_out": scale_out_launches["B"],
                             "real": tool_launches["real"]["B"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        **timing(bwd_row, *bf16(bwd_rows)),
        "at": "B=12 H=12 L=384 D=64 bf16"}, {
        "name": "ivf_pack_score", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/ivf_pack_score.cu",
        "replaces": "densephrases_tpu/ops/ivf_pack.py:94",
        "launches": (ivf_launches["C"] + offline_launches["C"]
                     + scale_launches["C"] + scale_out_launches["C"]
                     + demo_launches["C"] + tool_launches["at_scale"]["C"]
                     + tool_launches["real"]["C"]),
        "launches_by_path": {"ivf": ivf_launches["C"],
                             "offline": offline_launches["C"],
                             "scale": scale_launches["C"],
                             "scale_out": scale_out_launches["C"],
                             "demo": demo_launches["C"],
                             "at_scale": tool_launches["at_scale"]["C"],
                             "real": tool_launches["real"]["C"]},
        "max_abs_err": max(r["max_abs_err"] for r in ivf_rows["C"]),
        **timing(ivf_rows["C"][0], *ivf_rows["C"]),
        "product_only_ms": [r["product_only_ms"] for r in ivf_rows["C"]],
        "edge_rel_err": ivf_edge_err["C"],
        "at": ivf_rows["C"][0]["at"]}, {
        "name": "pq_pack_score", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/pq_pack_score.cu",
        "replaces": "densephrases_tpu/ops/ivf_pack.py:343",
        "launches": (ivf_launches["D"] + offline_launches["D"]
                     + trainer_launches["D"] + scale_out_launches["D"]
                     + demo_launches["D"] + tool_launches["at_scale"]["D"]
                     + tool_launches["real"]["D"]),
        "launches_by_path": {"ivf": ivf_launches["D"],
                             "offline": offline_launches["D"],
                             "trainers": trainer_launches["D"],
                             "scale_out": scale_out_launches["D"],
                             "demo": demo_launches["D"],
                             "at_scale": tool_launches["at_scale"]["D"],
                             "real": tool_launches["real"]["D"]},
        "max_abs_err": max(r["max_abs_err"] for r in ivf_rows["D"]),
        **timing(ivf_rows["D"][0], *ivf_rows["D"]),
        "edge_rel_err": ivf_edge_err["D"],
        "at": ivf_rows["D"][0]["at"]}, {
        "name": "pq_scan8_topk", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/pq_pack_score.cu",
        "replaces": "densephrases_tpu/ops/ivf_pack.py:343 with the select "
                    "after it",
        "launches": (ivf_launches["F"] + offline_launches["F"]
                     + trainer_launches["F"] + scale_out_launches["F"]
                     + demo_launches["F"] + tool_launches["at_scale"]["F"]
                     + tool_launches["real"]["F"]),
        "launches_by_path": {"ivf": ivf_launches["F"],
                             "offline": offline_launches["F"],
                             "trainers": trainer_launches["F"],
                             "scale_out": scale_out_launches["F"],
                             "demo": demo_launches["F"],
                             "at_scale": tool_launches["at_scale"]["F"],
                             "real": tool_launches["real"]["F"]},
        "max_abs_err": pq_select_row["max_abs_err"],
        **timing(fused_row, fused_row),
        "route_ms": pq_select_row["fused_ms"],
        "unfused_ms": pq_select_row["unfused_ms"],
        "at": pq_select_row["at"]}, {
        "name": "flat_scan_topk", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/flat_scan_topk.cu",
        "replaces": "none (the reference's flat scan is XLA: "
                    "densephrases_tpu/index/flat.py:103-140)",
        "launches": (serve_e + ivf_e + offline_e + scale_e + scale_out_e
                     + scale_out_launches["E"] + bench_launches["E"]),
        "launches_by_path": {"serve": serve_e, "ivf": ivf_e,
                             "offline": offline_e, "scale": scale_e,
                             "scale_out": scale_out_e
                             + scale_out_launches["E"],
                             "bench": bench_launches["E"]},
        "max_abs_err": flat_row["max_abs_err"],
        **timing(flat_row, flat_row),
        "route_ms": flat_row["route_ms"],
        "ids_equal_share": flat_row["ids_equal_share"],
        "at": flat_row["at"]}, band_kernel_row(mb)]}), flush=True)
    tmp_dir.cleanup()
    log("done", total_s=round(time.perf_counter() - t_start, 1))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
