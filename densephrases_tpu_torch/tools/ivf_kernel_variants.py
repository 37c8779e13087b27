"""Kernels C and D against variants of their design, and against another
checkout's, at ``chip_smoke.py``'s phase-2 serve shape on one CUDA GPU.

- ``--variants``: edited copies of ``csrc/ivf_pack_score.cu`` and
  ``csrc/pq_pack_score.cu`` (the edits below, applied as exact text
  replacements), built with nvcc into ``_build/variants/``, or the
  checkout's own library launched with another query blocking. Each is
  first checked against the plain twin, then timed with CUDA events, every
  variant of an instance twice, in the order A B .. B A.
- ``--checkout DIR`` (repeatable): ``chip_smoke.phase_ivf_kernels`` of this
  tree run in a subprocess against DIR's package (for example the parent
  commit unpacked with ``git archive``), in the order DIR, this tree, this
  tree, DIR: the kernels, their plain twins, the product alone and the
  whole SQ8 and OPQ96-like scans.
- ``--profile``: ``torch.profiler`` over the whole SQ8 and OPQ96-like
  scans, device time by operation.

Usage, from the repository root on a machine with one GPU:
  python -m densephrases_tpu_torch.tools.ivf_kernel_variants \\
      [--variants] [--checkout DIR] [--profile] [--out results.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from densephrases_tpu_torch.ops import ivf_pack as pack
from densephrases_tpu_torch.utils import cuda_build as cb

REPO = Path(__file__).resolve().parents[2]

# -------------------------------------------------------------- C variants
C_DEPTH = "  constexpr int kDepth = SQ4 ? 1 : 2;"
# two query warps of 64 queries a block (4 row warps), each converting the
# same code rows: the first layout of the redesign
C_TWO_QUERY_WARPS = [
    ("  constexpr int kBQ = NT * 8;  // queries per block\n",
     "  constexpr int kQW = NT == 8 ? 2 : 1;\n"
     "  constexpr int kRW = 8 / kQW;\n"
     "  constexpr int kBQ = kQW * NT * 8;\n"),
    ("  const bf16* qrow = qs + g * stride + 8 * t;",
     "  const int qn0 = (warp / kRW) * NT * 8;\n"
     "  if (q0 + qn0 >= n_q) return;\n"
     "  const bf16* qrow = qs + (qn0 + g) * stride + 8 * t;"),
    ("  for (int e = blockIdx.x * kWarps + warp; e < n_entries;\n"
     "       e += gridDim.x * kWarps) {\n"
     "    if (ivf::junk_tile(blk, e, pad_blk)) break;\n"
     "    const int8_t* rows",
     "  for (int e = blockIdx.x * kRW + warp % kRW; e < n_entries;\n"
     "       e += gridDim.x * kRW) {\n"
     "    if (ivf::junk_tile(blk, e, pad_blk)) break;\n"
     "    const int8_t* rows"),
    ("        const int qi = q0 + nt * 8 + 2 * t;",
     "        const int qi = q0 + qn0 + nt * 8 + 2 * t;"),
    ("  constexpr int kBQ = NT * 8;\n  // the layout",
     "  constexpr int kBQ = (NT == 8 ? 2 : 1) * NT * 8;\n  // the layout"),
    ("groups, kWarps, budget,", "groups, NT == 8 ? 4 : 8, budget,"),
]

# -------------------------------------------------------------- D variants
D_THREADS4 = "constexpr int kThreads4 = 512;"
# the 8-bit path's vector gathers for 4-bit codes: a [M][16][8] query-minor
# LUT, launched for bq == 8
D_GATHER4 = [
    ("template <int BQ, int VEC>\n__device__ __forceinline__ void adc_row(",
     "template <int BQ, int VEC, int KSUB = 256>\n"
     "__device__ __forceinline__ void adc_row("),
    ("template <int BQ, int VEC>\n__global__ void __launch_bounds__(kThreads8, "
     "1)\n    pq_scan8(",
     "template <int BQ, int VEC, int KSUB = 256>\n"
     "__global__ void __launch_bounds__(kThreads8, 1)\n    pq_scan8("),
    ("  load_lut_query_minor<BQ>(lut_s, lut, q0, n_q, m);\n  __syncthreads();",
     "  load_lut_query_minor<BQ, KSUB>(lut_s, lut, q0, n_q, m);\n"
     "  __syncthreads();"),
    ("template <int BQ>\n__device__ void load_lut_query_minor",
     "template <int BQ, int KSUB = 256>\n"
     "__device__ void load_lut_query_minor"),
    ("  const int runs = m * 256 / 8;", "  const int runs = m * KSUB / 8;"),
    ("lut + static_cast<size_t>(q0 + qb) * m * 256) +",
     "lut + static_cast<size_t>(q0 + qb) * m * KSUB) +"),
    ("  const int chunks = m / VEC;  // code_bytes == m, a multiple of VEC",
     "  const int code_bytes = KSUB == 16 ? m / 2 : m;\n"
     "  const int chunks = code_bytes / VEC;"),
    ("    adc_row<BQ, VEC>(\n        acc, lut_s,\n"
     "        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + "
     "lane) * m,",
     "    adc_row<BQ, VEC, KSUB>(\n        acc, lut_s,\n"
     "        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + "
     "lane) * code_bytes,"),
    ("    const int base = c * VEC * 256;\n#pragma unroll\n"
     "    for (int i = 0; i < VEC; ++i)\n"
     "      gather_add<BQ>(acc, lut_s, base + i * 256 + "
     "ivf::chunk_byte(cur, i));",
     "#pragma unroll\n    for (int i = 0; i < VEC; ++i) {\n"
     "      const uint32_t byte = ivf::chunk_byte(cur, i);\n"
     "      if constexpr (KSUB == 16) {\n"
     "        const int base = 2 * (c * VEC + i) * 16;\n"
     "        gather_add<BQ>(acc, lut_s, base + (byte & 0xFu));\n"
     "        gather_add<BQ>(acc, lut_s, base + 16 + (byte >> 4));\n"
     "      } else {\n"
     "        gather_add<BQ>(acc, lut_s, (c * VEC + i) * 256 + byte);\n"
     "      }\n    }"),
    ("      case 16: return launch(pq_scan4<2, VEC>",
     "      case 8: return launch(pq_scan8<8, VEC, 16>, kThreads8, "
     "static_cast<size_t>(8) * m * 16 * 2, bq, lut, codes, blk, out, n_q, "
     "m, budget, n_rows, s);\n"
     "      case 16: return launch(pq_scan4<2, VEC>"),
]
# four m16 row tiles a warp (two entries), so each ldmatrix'd B fragment
# feeds 8 products instead of 4; code loads narrowed to 4 bytes
D_FOUR_ROW_TILES = [
    ("    const uint8_t* rows =\n"
     "        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + g) *\n"
     "                    code_bytes;\n",
     "    const uint8_t* rows[8];\n#pragma unroll\n"
     "    for (int s = 0; s < 8; ++s)\n"
     "      rows[s] = codes + static_cast<size_t>(ivf::entry_row0(\n"
     "          blk, e + s / 4, pad_blk) + g + 8 * (s % 4)) * code_bytes;\n"),
    ("  for (int e = blockIdx.x * kWarps + warp; e < n_entries;\n"
     "       e += gridDim.x * kWarps) {\n"
     "    if (ivf::junk_tile(blk, e, pad_blk)) break;\n"
     "    const uint8_t* rows[8]",
     "  for (int e = (blockIdx.x * kWarps + warp) * 2; e < n_entries;\n"
     "       e += gridDim.x * kWarps * 2) {\n"
     "    if (ivf::junk_tile(blk, e, pad_blk)) break;\n"
     "    const uint8_t* rows[8]"),
    ("  const int chunks = code_bytes / VEC;\n  // ldmatrix",
     "  constexpr int V = VEC > 4 ? 4 : VEC;\n"
     "  const int chunks = code_bytes / V;\n  // ldmatrix"),
    ("    ivf::Chunk<VEC> cur[4], nxt[4];\n#pragma unroll\n"
     "    for (int s = 0; s < 4; ++s)\n"
     "      cur[s] = ivf::load_chunk<VEC>(rows + 8 * s * code_bytes);\n"
     "    float acc[2][NT][4] = {};",
     "    ivf::Chunk<V> cur[8], nxt[8];\n#pragma unroll\n"
     "    for (int s = 0; s < 8; ++s) cur[s] = ivf::load_chunk<V>(rows[s]);\n"
     "    float acc[4][NT][4] = {};"),
    ("      for (int s = 0; s < 4; ++s) {\n"
     "        nxt[s] = ivf::zero_chunk<VEC>();\n"
     "        if (c + 1 < chunks)\n"
     "          nxt[s] = ivf::load_chunk<VEC>(rows + 8 * s * code_bytes +\n"
     "                                        (c + 1) * VEC);\n      }",
     "      for (int s = 0; s < 8; ++s) {\n"
     "        nxt[s] = ivf::zero_chunk<V>();\n"
     "        if (c + 1 < chunks)\n"
     "          nxt[s] = ivf::load_chunk<V>(rows[s] + (c + 1) * V);\n      }"),
    ("      for (int i = 0; i < VEC; ++i) {\n        uint32_t byte[4];\n"
     "#pragma unroll\n"
     "        for (int s = 0; s < 4; ++s) byte[s] = ivf::chunk_byte(cur[s], i);",
     "      for (int i = 0; i < V; ++i) {\n        uint32_t byte[8];\n"
     "#pragma unroll\n"
     "        for (int s = 0; s < 8; ++s) byte[s] = ivf::chunk_byte(cur[s], i);"),
    ("          const int sub = 2 * (c * VEC + i) + h;\n"
     "          uint32_t a[2][4];\n#pragma unroll\n"
     "          for (int mt = 0; mt < 2; ++mt) {",
     "          const int sub = 2 * (c * V + i) + h;\n"
     "          uint32_t a[4][4];\n#pragma unroll\n"
     "          for (int mt = 0; mt < 4; ++mt) {"),
    ("#pragma unroll\n            for (int mt = 0; mt < 2; ++mt) {\n"
     "              attn::mma_bf16(acc[mt][np]",
     "#pragma unroll\n            for (int mt = 0; mt < 4; ++mt) {\n"
     "              attn::mma_bf16(acc[mt][np]"),
    ("      for (int s = 0; s < 4; ++s) cur[s] = nxt[s];\n    }\n"
     "    // C fragment: (row g, queries 2t, 2t+1) and (row g + 8, the same)\n"
     "#pragma unroll\n    for (int mt = 0; mt < 2; ++mt) {\n"
     "      const size_t col = static_cast<size_t>(e) * kRB + mt * 16 + g;",
     "      for (int s = 0; s < 8; ++s) cur[s] = nxt[s];\n    }\n"
     "#pragma unroll\n    for (int mt = 0; mt < 4; ++mt) {\n"
     "      const size_t col = static_cast<size_t>(e + mt / 2) * kRB +\n"
     "                         (mt % 2) * 16 + g;"),
]

VARIANT_SOURCES = {
    "c_depth1": ("ivf_pack_score.cu", [(C_DEPTH, "  constexpr int kDepth = 1;")]),
    "c_depth2": ("ivf_pack_score.cu", [(C_DEPTH, "  constexpr int kDepth = 2;")]),
    "c_depth4": ("ivf_pack_score.cu", [(C_DEPTH, "  constexpr int kDepth = 4;")]),
    "c_two_query_warps": ("ivf_pack_score.cu", C_TWO_QUERY_WARPS),
    "d_threads256": ("pq_pack_score.cu",
                     [(D_THREADS4, "constexpr int kThreads4 = 256;")]),
    "d_gather4": ("pq_pack_score.cu", D_GATHER4),
    "d_four_row_tiles": ("pq_pack_score.cu", D_FOUR_ROW_TILES),
}

# instance -> [(label, library, queries per block or n-tiles)]; "base" is
# the checkout's own library
VARIANTS = {
    "C SQ8": [("design (nt 16, depth 2)", "base", 16),
              ("two 64-query blocks (nt 8)", "base", 8),
              ("two query warps a block", "c_two_query_warps", 8),
              ("depth 1", "c_depth1", 16), ("depth 4", "c_depth4", 16)],
    "C SQ4": [("design (nt 16, depth 1)", "base", 16),
              ("two 64-query blocks (nt 8)", "base", 8),
              ("two query warps a block", "c_two_query_warps", 8),
              ("depth 2", "c_depth2", 16), ("depth 4", "c_depth4", 16)],
    "D M=96 8-bit": [("design (bq 4)", "base", 4), ("bq 2", "base", 2)],
    "D M=192 4-bit": [("design (bq 32, 16 warps, 2 row tiles)", "base", 32),
                      ("bq 16", "base", 16),
                      ("8 warps a block", "d_threads256", 32),
                      ("4 row tiles a warp", "d_four_row_tiles", 32),
                      ("vector gathers, [M][16][8] LUT", "d_gather4", 8)],
}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build_variant(name: str, cs):
    """An edited copy of a kernel source built with nvcc: its C entry point
    and its ptxas summary."""
    source, edits = VARIANT_SOURCES[name]
    text = (cb.CSRC_DIR / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit target not found once: {old!r}")
        text = text.replace(old, new)
    out_dir = cb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"{name}.so"
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    kernel = pack.IVF_PACK_SCORE if source.startswith("ivf") \
        else pack.PQ_PACK_SCORE
    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn, cs.ptxas_summary(proc.stdout + proc.stderr)


def time_variants(cs) -> list:
    """Every variant of every instance: checked, then timed in turns."""
    with concurrent.futures.ThreadPoolExecutor(len(VARIANT_SOURCES)) as pool:
        built = dict(zip(VARIANT_SOURCES, pool.map(
            lambda n: build_variant(n, cs), VARIANT_SOURCES)))
    libs = {"base_c": pack.IVF_PACK_SCORE.function(),
            "base_d": pack.PQ_PACK_SCORE.function()}
    for name, (fn, ptxas) in built.items():
        libs[name] = fn
        for inst in ptxas:
            print(json.dumps({"variant": name, **inst}), flush=True)
    ivf = cs.synthetic_ivf()
    blk, valid = ivf["blk"], ivf["total"] * pack.RB
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []
    for inst, variants in VARIANTS.items():
        if inst.startswith("C"):
            sq4 = "SQ4" in inst
            cols = cs.IVF_DIM // 2 if sq4 else cs.IVF_DIM
            codes = cs.random_codes(ivf, cols, torch.int8)
            x = ivf["q"].to(torch.bfloat16)
            ref = pack.pack_score_plain(x, codes, blk, sq4=sq4)
            args = lambda out, nt: (
                x.data_ptr(), codes.data_ptr(), blk.data_ptr(),
                out.data_ptr(), cs.IVF_BATCH, cs.IVF_DIM, cols, int(sq4),
                blk.numel(), codes.shape[0], nt, 8, stream())
            base = libs["base_c"]
        else:
            m, ksub = (96, 256) if "8-bit" in inst else (192, 16)
            cols = m if ksub == 256 else m // 2
            codes = cs.random_codes(ivf, cols, torch.uint8)
            x = torch.randn(cs.IVF_BATCH, m, ksub, device="cuda",
                            generator=ivf["gen"]).to(torch.bfloat16)
            ref = pack.pq_pack_score_plain(x, codes, blk)
            args = lambda out, bq: (
                x.data_ptr(), codes.data_ptr(), blk.data_ptr(),
                out.data_ptr(), cs.IVF_BATCH, m, ksub, cols, blk.numel(),
                codes.shape[0], bq, 16, stream())
            base = libs["base_d"]
        times = {}
        for label, lib, q in variants + variants[::-1]:
            fn = base if lib == "base" else libs[lib]
            out = torch.full((cs.IVF_BATCH, blk.numel() * pack.RB),
                             float("nan"), device="cuda")
            call = lambda: fn(*args(out, q))
            if call() != 0:
                raise RuntimeError(f"{inst} {label}: launch failed")
            torch.cuda.synchronize()
            err = cs.rel_err(out[:, :valid], ref[:, :valid])
            if err > cs.IVF_KERNEL_RTOL:
                raise AssertionError(f"{inst} {label}: rel_err {err}")
            times.setdefault(label, []).append(cs.cuda_ms(call, iters=20))
        for label, ms in times.items():
            row = {"instance": inst, "variant": label, "ms": ms}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del codes, x, ref
        torch.cuda.empty_cache()
    return rows


def profile_scans(cs, top: int = 12) -> dict:
    """``torch.profiler`` over 3 whole SQ8 and OPQ96-like scans each at the
    serve shape: device time (ms a scan) by the host operation that
    launched it and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    ivf = cs.synthetic_ivf()
    row_perm = torch.arange(cs.IVF_ROWS, dtype=torch.int32, device="cuda")
    common = dict(top_k=cs.IVF_SCAN_TOP_K, nprobe=cs.IVF_NPROBE,
                  cap=ivf["cap"], budget=ivf["budget"], n_real=cs.IVF_ROWS)
    sq8 = cs.random_codes(ivf, cs.IVF_DIM, torch.int8)
    pq = cs.random_codes(ivf, 96, torch.uint8)
    refine = cs.random_codes(ivf, cs.IVF_DIM, torch.int8)[:cs.IVF_ROWS]
    books = torch.randn(96, 256, cs.IVF_DIM // 96, device="cuda",
                        generator=ivf["gen"])
    scans = {
        "SQ8": lambda: pack.packed_union_scan(
            ivf["q"], ivf["cents"], ivf["offs"], sq8, row_perm, 0.0, 1.0,
            **common),
        "OPQ96": lambda: pack.packed_pq_scan(
            ivf["q"], ivf["q"], ivf["cents"], ivf["offs"], pq, row_perm,
            books, refine, 0.0, 1.0,
            scan_k=cs.IVF_SCAN_TOP_K * cs.IVF_REFINE_FACTOR, **common)}
    out = {}
    for name, scan in scans.items():
        scan()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                scan()
            torch.cuda.synchronize()
        # by the torch operation that launched each kernel (the innermost;
        # kernels C and D launch through ctypes, outside any), and by kernel
        events = prof.key_averages()
        by_op = sorted(((e.key, e.self_device_time_total / 3e3, e.count // 3)
                        for e in events if e.device_type.name == "CPU"
                        and e.self_device_time_total), key=lambda r: -r[1])
        by_kernel = sorted(((e.key, e.self_device_time_total / 3e3,
                             e.count // 3) for e in events
                            if e.device_type.name == "CUDA"),
                           key=lambda r: -r[1])
        out[name] = {
            "device_ms_per_scan": sum(r[1] for r in by_kernel),
            "by_op": [{"op": k[:60], "ms": ms, "calls": n}
                      for k, ms, n in by_op[:top]],
            "by_kernel": [{"kernel": k[:100], "ms": ms, "calls": n}
                          for k, ms, n in by_kernel[:top]]}
        print(json.dumps({"profile": name, **out[name]}), flush=True)
    return out


PHASE_CODE = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import densephrases_tpu_torch
print("PACKAGE", densephrases_tpu_torch.__file__, flush=True)
print("ROWS", json.dumps(cs.phase_ivf_kernels()), flush=True)
"""


def phase_rows(root: Path) -> dict:
    """This tree's phase-2 IVF rows against the package of checkout root."""
    root = root.resolve()
    proc = subprocess.run([sys.executable, "-c", PHASE_CODE, str(root),
                           str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, check=True)
    lines = proc.stdout.splitlines()
    package = next(l for l in lines if l.startswith("PACKAGE "))
    if not Path(package.split(" ", 1)[1]).resolve().is_relative_to(root):
        raise RuntimeError(f"imported the wrong package: {package}")
    return json.loads(next(l for l in lines if l.startswith("ROWS "))[5:])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", action="append", default=[], type=Path)
    ap.add_argument("--variants", action="store_true",
                    help="time the design variants")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the whole SQ8 and OPQ96-like scans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ivf_kernel_variants needs a CUDA GPU")
    cs = load_chip_smoke()
    result = {"card": cs.nvidia_smi(), "checkouts": {}}
    if args.variants:
        result["variants"] = time_variants(cs)
    print(result["card"], flush=True)
    if args.profile:
        result["profile"] = profile_scans(cs)
    for root in args.checkout:
        runs = {}
        for which in (root, REPO, REPO, root):
            tag = "this tree" if which == REPO else str(which)
            runs.setdefault(tag, []).append(phase_rows(which))
            print(json.dumps({"checkout": tag, "rows": runs[tag][-1]}),
                  flush=True)
        result["checkouts"][str(root)] = runs
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
