#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``densephrases_tpu_torch``) on one GPU.

Drives the port's main path once at BERT-base width with random seeded
weights, through the entry points a user calls, and checks every hand-
written kernel on that path against its plain PyTorch version:

  0. device      the card's name and power limit
  1. build       compile the CUDA kernels from ``densephrases_tpu_torch/csrc``
  2. kernels     each kernel vs its plain version at the main path's shapes,
                 with the max error against a stated tolerance and both times
  3. dump        ``dump_phrases`` of a seeded synthetic corpus into a store
  4. serve       ``DensePhrases.search`` for all four units, the fused server
                 over 4 batches of 64 queries, the brute-force span oracle,
                 and the kernel path's answers against the plain path's

Every kernel's launch counter is zeroed right before phase 3 and read after
phase 4's main-path work; a kernel of the path that never launched fails the
run. Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when there is no CUDA device. The second-last
lines are a JSON object of per-kernel results and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_DOCS = 64
QUERY_BATCH = 64
N_BATCHES = 4
MAX_QUERY_LENGTH = 32
# kernel vs plain: fp32 differs by summation order and __expf (measured
# ~1e-6); bf16 plain rounds scores and probabilities to bf16, which moves an
# output of magnitude up to 2 by a bf16 ulp or two (ulp 7.8e-3 at 1)
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# kernel-path vs plain-path top-1 span score: towers in bf16 through 12
# layers, scores are sums of 768 products of O(1) terms
SCORE_RTOL = 2e-2


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=3):
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
        attention_cuda, attention_plain)

    gen = torch.Generator().manual_seed(SEED)
    results = []
    # (64, 12, 32, 64): one query tower at serve batch 64; (128, ...): the two
    # towers' batches together; (16, 12, 512, 64): a dump batch of windows
    for shape in ((64, 12, 32, 64), (128, 12, 32, 64), (16, 12, 512, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(*shape, dtype, gen)
            out = attention_cuda(q, k, v, mask)
            ref = attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"non-finite kernel output at {shape}")
            err = float((out.float() - ref.float()).abs().max())
            tol = KERNEL_TOL[str(dtype).split(".")[-1]]
            # fully masked row: the uniform average of V, as in the reference
            uniform = v[-1].float().mean(dim=1, keepdim=True)
            err_masked = float((out[-1].float() - uniform).abs().max())
            ms = cuda_ms(lambda: attention_cuda(q, k, v, mask))
            plain_ms = cuda_ms(lambda: attention_plain(q, k, v, mask))
            row = {"shape": "x".join(map(str, shape)),
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "tol": tol, "masked_row_err": err_masked, "ms": ms,
                   "plain_ms": plain_ms}
            log("2 kernels", kernel="attention_fwd", **row)
            if err > tol or err_masked > tol:
                raise AssertionError(f"attention_fwd disagrees with plain: {row}")
            results.append(row)
    return results


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


def top1_spans(model, queries):
    """(doc, start, end, score) of each query's top phrase."""
    _, rets = model.search(queries, retrieval_unit="phrase", top_k=1,
                           return_meta=True)
    return [(r[0]["doc_idx"], r[0]["start_idx"], r[0]["end_idx"], r[0]["score"])
            for r in rets]


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
    from densephrases_tpu_torch.models.attention import ATTENTION_FWD
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import (
        embed_phrase, init_encoder_params)
    from densephrases_tpu_torch.serve.fused import FusedServer

    # ---- 0. device
    smi = nvidia_smi()
    log("0 device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(smi, flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    ATTENTION_FWD.function()
    log("1 build", kernel="attention_fwd", seconds=round(time.perf_counter() - t0, 2),
        compiled=ATTENTION_FWD.build_seconds is not None)
    for line in ATTENTION_FWD.build_log.splitlines():
        if "registers" in line:
            log("1 build", ptxas=line.split(":", 1)[-1].strip().replace(" ", "_"))

    # ---- 2. kernels vs plain
    kernel_rows = phase_kernels()

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

    serve_row = next(r for r in kernel_rows
                     if r["shape"] == "64x12x32x64" and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "densephrases_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "densephrases_tpu/models/attention.py:44",
        "launches": main_path_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": serve_row["ms"], "plain_ms": serve_row["plain_ms"],
        "at": "B=64 H=12 L=32 D=64 bf16"}]}), flush=True)
    tmp_dir.cleanup()
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
