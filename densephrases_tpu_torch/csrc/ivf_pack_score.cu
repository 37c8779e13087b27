// Kernel C: raw scores of a query batch against the IVF code rows that a
// 32-row block table names (the packed union scan of SQ8 / SQ4 lists).
//
// Replaces the Pallas TPU kernel densephrases_tpu/ops/ivf_pack.py:
// _pack_score_kernel (launched by _pack_score). Same math:
//
//   raw[b, j*32 + r] = sum_d q[b, d] * code[blk[j]*32 + r, d]
//
// q: [n_q, dim] bf16; codes: [n_rows, code_bytes] int8, n_rows % 32 == 0,
// the last 32-row block all zeros (pad_blk); blk: [budget] int32,
// budget % 8 == 0, junk entries (== pad_blk) form a suffix; out: [n_q,
// budget*32] fp32. SQ8: code_bytes == dim, signed codes. SQ4: code_bytes ==
// dim/2 packed bytes, dim j < dim/2 in the high nibble of byte j and dim
// j >= dim/2 in the low nibble of byte j - dim/2, both unsigned 0..15.
// A tile whose first entry is pad_blk is left unwritten, as the TPU kernel
// leaves it; the caller masks those columns.
//
// What bounds it on an H100: at the serve shape (128 stacked queries, 768
// dims, 443,040 gathered rows at nprobe 16 over 1M rows) the function moves
// ~0.57 GB (the codes once, 0.23 GB of fp32 scores) and does 8.7e10 bf16
// operations, so the bytes bound it (~0.17 ms) if the products run on the
// tensor cores.
//
// Design: the products run on mma.sync.m16n8k16 (bf16 operands, fp32
// accumulation). A is a tile of code rows: a lane reads 8 code bytes of
// each of its rows straight from device memory and converts them to bf16
// in registers, exactly (ivf_tiles.cuh: s8x2_to_bf16x2, u4x2_to_bf16x2).
// B is the queries, kept whole in shared memory for the block's life. The
// reduction runs over the dims in any order, so a k-block of 16 takes the
// dims {8t .. 8t+3 : t = 0..3} of a 32-dim chunk (the next the other 16),
// which lets a lane feed its A fragment from one 8-byte code load and its
// B fragments of both k-blocks from one 16-byte shared load.
//   - All the batch's query rows sit in one block, up to 128 (NT = 16
//     n-tiles of 8), so every code row leaves device memory once; past
//     128, more query groups along grid y. Smaller batches take NT = 2, 4
//     or 8.
//   - Each of the 8 warps takes one 32-row block-table entry (two m16
//     tiles) against all the block's queries at a time, with a grid stride
//     over the table, so a code row is loaded and converted once, and
//     keeps the next 2 chunks (SQ4: 1) of its rows' codes in flight in
//     registers ahead of the products. No barrier after the queries are
//     loaded (with cp.async).
//   - SQ4: one 8-byte load holds 8 packed bytes; the high nibbles are dims
//     of the first half, the low nibbles the same dims of the second half.
//     The query rows are stored as [first half | second half], each padded
//     to 32 dims, so both halves take the same chunk offsets.
//   - Query rows are padded so their stride is 64 bytes past a multiple of
//     128: the 16-byte B loads of a quarter warp (2 rows x 64 bytes) hit
//     distinct banks.
//   - Output: each C fragment store writes 8 consecutive columns of 4
//     query rows, whole 32-byte sectors.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"  // mma_bf16, cp_async_commit / _wait
#include "ivf_tiles.cuh"

namespace {

using ivf::bf16;
using ivf::kRB;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

// 8 code bytes of a row (dims 32c + 8t .. +8 of a chunk), zeros past the
// row's end: one 8-byte load (VEC 8) or two 4-byte loads (VEC 4).
template <int VEC>
__device__ __forceinline__ uint2 load8(const int8_t* row, int o,
                                       int code_bytes) {
  uint2 v = make_uint2(0, 0);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row) + o;
  if constexpr (VEC == 8) {
    if (o < code_bytes) v = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    if (o < code_bytes) v.x = __ldg(reinterpret_cast<const uint32_t*>(p));
    if (o + 4 < code_bytes) v.y = __ldg(reinterpret_cast<const uint32_t*>(p + 4));
  }
  return v;
}

// 8 code values as 4 bf16 pairs (byte pairs 0-1, 2-3, 4-5, 6-7). SQ8:
// the signed bytes; SQ4: their high (hi) or low nibbles.
template <bool SQ4>
__device__ __forceinline__ void to_bf16(const uint2 v, uint32_t* r, bool hi) {
  const uint32_t p[4] = {ivf::spread_pair(v.x, 0), ivf::spread_pair(v.x, 1),
                         ivf::spread_pair(v.y, 0), ivf::spread_pair(v.y, 1)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = SQ4 ? ivf::u4x2_to_bf16x2(p[i], hi) : ivf::s8x2_to_bf16x2(p[i]);
}

// acc[mt][nt] += rows x queries over one 32-dim chunk. r[s]: slot s's 4
// bf16 pairs (slot s = row g + 8 s); qrow: this lane's query row at the
// chunk's offset in the segment; nt-tiles 8 query rows apart.
template <int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][NT][4],
                                          const uint32_t (&r)[4][4],
                                          const bf16* qrow, int stride) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint4 b = *reinterpret_cast<const uint4*>(qrow + nt * 8 * stride);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* lo = r[2 * mt];      // row g (+16 mt)
      const uint32_t* hi = r[2 * mt + 1];  // row g + 8 (+16 mt)
      const uint32_t a0[4] = {lo[0], hi[0], lo[1], hi[1]};
      const uint32_t a1[4] = {lo[2], hi[2], lo[3], hi[3]};
      attn::mma_bf16(acc[mt][nt], a0, b.x, b.y);
      attn::mma_bf16(acc[mt][nt], a1, b.z, b.w);
    }
  }
}

template <int NT, int VEC, bool SQ4>
__global__ void __launch_bounds__(kThreads, 1)
    ivf_scan(const bf16* __restrict__ q, const int8_t* __restrict__ codes,
             const int* __restrict__ blk, float* __restrict__ out, int n_q,
             int dim, int code_bytes, int pad_blk, int n_entries, int n_cols,
             int seg_w, int stride) {
  constexpr int kBQ = NT * 8;  // queries per block
  // code chunks in flight per warp ahead of the products (an SQ4 chunk
  // feeds twice the products)
  constexpr int kDepth = SQ4 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  const int q0 = blockIdx.y * kBQ;

  // the query bank: row qb = [segment 0 | segment 1 (SQ4)], each seg_w
  // wide, zeros past a segment's dims and for queries past n_q; 4 dims (8
  // bytes) a copy, all in flight at once
  {
    const int seg_dims = SQ4 ? dim / 2 : dim;
    const int units = stride / 4;
    for (int i = threadIdx.x; i < kBQ * units; i += kThreads) {
      const int qb = i / units, d0 = (i % units) * 4;
      const int seg = d0 / seg_w, d = d0 % seg_w;
      const bool ok = q0 + qb < n_q && seg < (SQ4 ? 2 : 1) && d < seg_dims;
      ivf::cp_async8(qs + qb * stride + d0,
                     ok ? q + static_cast<size_t>(q0 + qb) * dim +
                              seg * seg_dims + d
                        : q,
                     ok);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qrow = qs + g * stride + 8 * t;
  const int chunks = (code_bytes + 31) / 32;
  for (int e = blockIdx.x * kWarps + warp; e < n_entries;
       e += gridDim.x * kWarps) {
    if (ivf::junk_tile(blk, e, pad_blk)) break;
    const int8_t* rows =
        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + g) *
                    code_bytes;
    float acc[2][NT][4] = {};
    uint2 buf[kDepth][4];
#pragma unroll
    for (int p = 0; p < kDepth; ++p)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        buf[p][s] = load8<VEC>(rows + 8 * s * code_bytes, 32 * p + 8 * t,
                               code_bytes);
    for (int c0 = 0; c0 < chunks; c0 += kDepth) {
#pragma unroll
      for (int p = 0; p < kDepth; ++p) {
        const int c = c0 + p;
        if (c >= chunks) break;
        uint2 cur[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          cur[s] = buf[p][s];
          buf[p][s] = load8<VEC>(rows + 8 * s * code_bytes,
                                 32 * (c + kDepth) + 8 * t, code_bytes);
        }
        uint32_t r[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) to_bf16<SQ4>(cur[s], r[s], true);
        chunk_mma<NT>(acc, r, qrow + 32 * c, stride);
        if constexpr (SQ4) {
#pragma unroll
          for (int s = 0; s < 4; ++s) to_bf16<SQ4>(cur[s], r[s], false);
          chunk_mma<NT>(acc, r, qrow + seg_w + 32 * c, stride);
        }
      }
    }
    // C fragment: (row g, queries 2t, 2t+1) and (row g + 8, the same)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const size_t col = static_cast<size_t>(e) * kRB + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int qi = q0 + nt * 8 + 2 * t;
        if (qi < n_q) {
          out[static_cast<size_t>(qi) * n_cols + col] = acc[mt][nt][0];
          out[static_cast<size_t>(qi) * n_cols + col + 8] = acc[mt][nt][2];
        }
        if (qi + 1 < n_q) {
          out[static_cast<size_t>(qi + 1) * n_cols + col] = acc[mt][nt][1];
          out[static_cast<size_t>(qi + 1) * n_cols + col + 8] = acc[mt][nt][3];
        }
      }
    }
  }
}

template <int NT, int VEC, bool SQ4>
int launch(const void* q, const void* codes, const int* blk, float* out,
           int n_q, int dim, int code_bytes, int budget, int n_rows,
           cudaStream_t stream) {
  auto kernel = ivf_scan<NT, VEC, SQ4>;
  constexpr int kBQ = NT * 8;
  // the layout ops/ivf_pack.py:scan_plan sizes
  const int seg_w = (code_bytes + 31) / 32 * 32;
  const int width = (SQ4 ? 2 : 1) * seg_w;
  const int stride = width + (width % 64 == 0 ? 32 : 0);
  const size_t smem = static_cast<size_t>(kBQ) * stride * 2;
  if (smem > ivf::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ivf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_q + kBQ - 1) / kBQ;
  int gx = 1;
  err = ivf::resident_grid_x(kernel, kThreads, smem, groups, kWarps, budget,
                             &gx);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(gx, groups), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(codes), blk, out,
      n_q, dim, code_bytes, n_rows / kRB - 1, budget, budget * kRB, seg_w,
      stride);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int VEC>
int launch_sq(int sq4, const void* q, const void* codes, const int* blk,
              float* out, int n_q, int dim, int code_bytes, int budget,
              int n_rows, cudaStream_t s) {
  if (sq4)
    return launch<NT, VEC, true>(q, codes, blk, out, n_q, dim, code_bytes,
                                 budget, n_rows, s);
  return launch<NT, VEC, false>(q, codes, blk, out, n_q, dim, code_bytes,
                                budget, n_rows, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks devices, types, shapes, contiguity and alignment and picks nt
// (blocks of 8 nt queries: 2, 4, 8 or 16) and vec (bytes per code load: 8
// or 4, dividing code_bytes and the codes' address) with
// ops/ivf_pack.py:scan_plan; this only refuses what it cannot dispatch.
// Nothing is synchronised.
extern "C" int dph_ivf_pack_score(const void* q, const void* codes,
                                  const int* blk, float* out, int n_q,
                                  int dim, int code_bytes, int sq4,
                                  int budget, int n_rows, int nt, int vec,
                                  void* stream) {
  if (n_q <= 0 || budget <= 0 || budget % ivf::kTPB || n_rows < kRB ||
      n_rows % kRB || code_bytes <= 0 || code_bytes % 4 ||
      code_bytes != (sq4 ? dim / 2 : dim) || (sq4 && dim % 2) ||
      code_bytes % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt * 100 + vec) {
    case 1608: return launch_sq<16, 8>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 1604: return launch_sq<16, 4>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 808: return launch_sq<8, 8>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 804: return launch_sq<8, 4>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 408: return launch_sq<4, 8>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 404: return launch_sq<4, 4>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 208: return launch_sq<2, 8>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    case 204: return launch_sq<2, 4>(sq4, q, codes, blk, out, n_q, dim, code_bytes, budget, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
