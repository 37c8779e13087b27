"""The serve benchmark: queries/s through the whole search pipeline.

The counterpart of the repository's root ``bench.py`` (``make bench``). It
writes 1M x 768 int8 phrase vectors over 10,000 docs into a store, serves
them at batch 64 and top-k 10 through ``FusedServer`` with BERT-base query
towers (kernel A in both) in three modes -- synchronous, two batches in
flight and four -- and prints one JSON line with the root ``bench.py``'s
keys: the best mode's q/s, each mode's, the stage split, ``MIPS``'s set-up
seconds and stages, every window, and a numpy CPU baseline measured over
the same corpus (``cpu_mips_qps``: chunked dequantize, sgemm, top-k; no
query encoding and no span rescore, so it flatters the CPU).

Where it differs from the root ``bench.py`` (its TPU workarounds stay
behind):

- no dispatch floor: each stage is a host-clock mean of calls that each
  end in a device sync, and nothing is subtracted;
- no discarded windows: each mode runs exactly ``N_WINDOWS`` windows of
  ``N_BATCHES`` batches, ``windows_s`` lists them all, and the mode's value
  is their median;
- ``device_step_b64`` times ``FusedServer.submit`` and the wait for its
  copy to land; ``host_assemble_b64`` times ``collect`` of one landed batch
  (unpack, assemble, aggregate);
- ``--vocab_kind whole_word`` takes a vocab that needs no ``tokenizers``
  (the queries pad to 32 tokens either way, so the device work is the
  same);
- ``DPH_TRACE_DIR`` takes a ``torch.profiler`` trace of the windows
  (``utils/profiling.trace``).

Run on the card:
  python -m densephrases_tpu_torch.bench --vocab_kind whole_word
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from densephrases_tpu_torch.tools._bench import sync
from densephrases_tpu_torch.utils.device import resolve_device

N_DOCS, VECS_PER_DOC = 10_000, 100
BLOCK_DOCS = 500  # docs a generated block of vectors
BATCH, TOP_K, MAX_QUERY_LENGTH = 64, 10, 32
WARMUP = 5  # batches before the clock starts (ref run_demo.py:331-335)
N_STAGE = 4  # timed calls of each stage
N_BATCHES, N_WINDOWS = 8, 5  # batches a window, windows a mode
MODES = (("sync", 1), ("pipelined", 2), ("pipelined4", 4))  # name, depth
CPU_CHUNK = 65536  # corpus rows the CPU baseline dequantizes at a time
VOCAB_TEXTS = ["benchmark query words " * 40]
VOCAB_SIZE = 600


def build_store(path: str, n_docs: int = N_DOCS,
                vecs_per_doc: int = VECS_PER_DOC, d: int = 768,
                seed: int = 0):
    """The root bench.py's synthetic store at ``path``: int8 vectors drawn
    as ``integers(-60, 61)`` (~ the int8 code of N(-2, 1)) in blocks of
    ``BLOCK_DOCS`` docs, every doc with ``vecs_per_doc`` one-word phrases
    over a context of ``vecs_per_doc + 2`` words. A last block short of
    ``BLOCK_DOCS`` draws only its own docs' rows. Returns the finalized
    ``PhraseStore``."""
    from densephrases_tpu_torch.index.store import DocMeta, StoreWriter

    rng = np.random.default_rng(seed)
    writer = StoreWriter(path, d)
    w2cs = np.arange(vecs_per_doc, dtype=np.int32) * 5
    w2ce = w2cs + 4
    f2o = np.arange(vecs_per_doc, dtype=np.int32)
    ctx = " ".join(["word"] * (vecs_per_doc + 2))
    for b0 in range(0, n_docs, BLOCK_DOCS):
        nb = min(BLOCK_DOCS, n_docs - b0)
        blk = rng.integers(-60, 61, (nb * vecs_per_doc, d), dtype=np.int8)
        for j in range(nb):
            writer.add_doc(
                DocMeta(doc_id=b0 + j, title=f"doc{b0 + j}", context=ctx,
                        word2char_start=w2cs, word2char_end=w2ce,
                        f2o_start=f2o),
                blk[j * vecs_per_doc:(j + 1) * vecs_per_doc])
    return writer.finalize()


def bench_queries(batch: int = BATCH):
    return [f"benchmark query number {i} words" for i in range(batch)]


def baseline_queries(rng: np.random.Generator, batch: int, d: int):
    """One batch of the CPU baseline's queries: N(-2, 1), as the towers'
    outputs sit near the store's affine offset."""
    q = rng.standard_normal((batch, d), dtype=np.float32)
    q -= 2.0
    return q


def cpu_mips_topk(vecs_int8, q: np.ndarray, top_k: int, offset: float,
                  scale: float, chunk: int = CPU_CHUNK):
    """The CPU baseline's flat SQ8 scan: each chunk of ``chunk`` rows
    dequantized to fp32, one sgemm against the fp32 queries, a partial
    top-k per chunk merged into the running one. Returns (scores [B, k]
    fp32, ids [B, k] int64), by score descending, ties to the lower id."""
    n = vecs_int8.shape[0]
    b = q.shape[0]
    k = min(top_k, n)
    best_s = np.full((b, k), -np.inf, np.float32)
    best_i = np.zeros((b, k), np.int64)
    qsum = q.sum(1, keepdims=True) * offset
    for c0 in range(0, n, chunk):
        blk = vecs_int8[c0:c0 + chunk].astype(np.float32)
        blk /= scale
        s = q @ blk.T + qsum
        kk = min(k, s.shape[1])
        part = np.argpartition(s, -kk, axis=1)[:, -kk:]
        cat_s = np.concatenate(
            [best_s, np.take_along_axis(s, part, axis=1)], axis=1)
        cat_i = np.concatenate([best_i, part + c0], axis=1)
        sel = np.argpartition(cat_s, -k, axis=1)[:, -k:]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    order = np.lexsort((best_i, -best_s), axis=1)
    return (np.take_along_axis(best_s, order, axis=1),
            np.take_along_axis(best_i, order, axis=1))


def cpu_mips_qps(vecs_int8, batch: int, top_k: int, offset: float,
                 scale: float, n_batches: int = 2) -> float:
    """The measured CPU baseline: q/s of ``cpu_mips_topk`` over the same
    corpus, batch and top-k as the served path, on the host's BLAS
    threads; the first batch warms up and is not timed."""
    rng = np.random.default_rng(7)
    times = []
    for bi in range(n_batches + 1):
        q = baseline_queries(rng, batch, vecs_int8.shape[1])
        t0 = time.perf_counter()
        cpu_mips_topk(vecs_int8, q, top_k, offset, scale)
        if bi > 0:
            times.append(time.perf_counter() - t0)
    return batch / (sum(times) / len(times))


def bench_vocab(kind: str = "wordpiece"):
    """The root bench.py's query vocab; ``kind`` "wordpiece" trains it
    with ``tokenizers`` (and raises without the package), "whole_word"
    takes the texts' words."""
    from densephrases_tpu_torch.data.tokenization import build_vocab

    return build_vocab(VOCAB_TEXTS, vocab_size=VOCAB_SIZE, kind=kind)


def serve_model(store, config, tok, *, device="cuda"):
    """(DensePhrases, FusedServer, MIPS set-up seconds) over ``store``:
    towers of ``config`` with random weights from seed 0, served in bf16,
    with the tokenizer ``tok`` and the root bench.py's query length."""
    from densephrases_tpu_torch.index.search import MIPS
    from densephrases_tpu_torch.model import DensePhrases
    from densephrases_tpu_torch.models.encoder import init_encoder_params
    from densephrases_tpu_torch.serve.fused import FusedServer

    params = init_encoder_params(config, torch.Generator().manual_seed(0),
                                 device=device)
    t0 = time.perf_counter()
    mips = MIPS(store, device=device)
    sync(device)
    mips_init_s = time.perf_counter() - t0
    model = DensePhrases(params, config, tok, mips,
                         max_query_length=MAX_QUERY_LENGTH,
                         serve_dtype="bf16")
    return model, FusedServer(model), mips_init_s


def _landed(handle):
    """Wait until a ``submit`` handle's result copy has landed."""
    if handle["done"] is not None:
        handle["done"].synchronize()
    return handle


def one_batch(fused, queries):
    return fused.search(queries, top_k=TOP_K, aggregate=True)


def stage_split(model, fused, queries, *, device) -> dict:
    """Mean ms of each stage of a batch, each call ending in a device
    sync: the two query towers (tokenize included), the device step
    (``submit`` until its copy lands) and the host assembly of one landed
    batch."""
    def mean_ms(fn):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(N_STAGE):
            fn()
        return 1e3 * (time.perf_counter() - t0) / N_STAGE

    def encode():
        model.query2vec(queries)
        sync(device)

    handle = _landed(fused.submit(queries, top_k=TOP_K))
    t0 = time.perf_counter()
    fused.collect(handle)
    assemble_ms = 1e3 * (time.perf_counter() - t0)
    return {"encode_b64": mean_ms(encode),
            "device_step_b64": mean_ms(
                lambda: _landed(fused.submit(queries, top_k=TOP_K))),
            "host_assemble_b64": assemble_ms}


def windows(fused, queries, depth: int):
    """(median, every window's seconds) of ``N_WINDOWS`` windows of
    ``N_BATCHES`` batches at ``depth`` batches in flight (1: one
    ``search`` after another). A window ends when its last batch is
    assembled, which waits for the device."""
    times = []
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        if depth == 1:
            for _ in range(N_BATCHES):
                one_batch(fused, queries)
        else:
            fused.search_pipelined([queries] * N_BATCHES, depth=depth,
                                   top_k=TOP_K, aggregate=True)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def towered_batches() -> int:
    """Batches that go through the query towers in one run from the first
    warm-up batch to the last window: kernel A launches twice a layer for
    each. ``stage_split`` encodes one batch for the assembly, then warms
    and times the towers and the device step."""
    return (WARMUP + 1 + 2 * (1 + N_STAGE)
            + len(MODES) * N_WINDOWS * N_BATCHES)


def parse_args(argv=None):
    from densephrases_tpu_torch.data.tokenization import VOCAB_KINDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_docs", type=int, default=N_DOCS)
    ap.add_argument("--vecs_per_doc", type=int, default=VECS_PER_DOC)
    ap.add_argument("--config", choices=("base", "tiny"), default="base",
                    help="BERT-base towers, or BertConfig.tiny for a "
                         "quick run (the store's width follows)")
    ap.add_argument("--vocab_kind", choices=VOCAB_KINDS, default="wordpiece",
                    help="whole_word needs no `tokenizers`")
    ap.add_argument("--store_dir", default=None,
                    help="write the store here and keep it (default: a "
                         "temp dir, removed at the end)")
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.utils.profiling import trace

    args = parse_args(argv)
    device = resolve_device(device)
    t_setup0 = time.perf_counter()
    config = BertConfig() if args.config == "base" else BertConfig.tiny()
    tok = bench_vocab(args.vocab_kind)
    queries = bench_queries()
    with contextlib.ExitStack() as stack:
        root = args.store_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="dph_bench_"))
        store = build_store(os.path.join(root, "store"), args.n_docs,
                            args.vecs_per_doc, config.hidden_size)
        model, fused, mips_init_s = serve_model(store, config, tok,
                                                device=device)
        for _ in range(WARMUP):
            one_batch(fused, queries)
        setup_s = time.perf_counter() - t_setup0
        stages = stage_split(model, fused, queries, device=device)
        with trace(os.environ.get("DPH_TRACE_DIR")):
            runs = {name: windows(fused, queries, depth)
                    for name, depth in MODES}
        baseline = cpu_mips_qps(np.asarray(store.vecs[:]), BATCH,
                                TOP_K, store.offset, store.scale)
        init_stages = model.mips.init_stages
    qps = {name: N_BATCHES * BATCH / med
           for name, (med, _) in runs.items()}
    mode = max(qps, key=qps.get)
    res = {
        "metric": "queries_per_sec_batch64_e2e",
        "value": qps[mode],
        "unit": "q/s",
        "baseline": baseline,
        "vs_baseline": qps[mode] / baseline,
        "mode": mode,
        **{f"value_{name}": qps[name] for name, _ in MODES},
        "stages_ms": stages,
        "mips_init_s": mips_init_s,
        "mips_init_stages": init_stages,
        "setup_s": setup_s,
        "windows_s": {name: times for name, (_, times) in runs.items()},
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
