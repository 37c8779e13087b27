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
// What bounds it on an H100: the serve shape (2 x 64 stacked queries, 768
// dims, ~0.6M gathered rows at nprobe 16 over 1M rows) is 2*128*768*0.6M
// = 0.12 TFLOP against ~0.45 GB of code rows. On the tensor cores the
// code reads would bound it; this first version multiplies on the fp32
// CUDA cores (exact: a bf16 x int8 product fits fp32), so the fp32 FMA
// rate bounds it, ~2 ms at best.
// What the design does about it:
//   - one block per (256-row tile, group of BQ queries); a block reads its
//     own 8 block-table entries (no scalar prefetch on this card) and
//     clamps them into [0, pad_blk], so it never reads past n_rows;
//   - each of the 256 threads owns one row of the tile and keeps its BQ
//     query sums in registers; code chunks of 64 bytes per row are staged
//     in shared memory with a padded row stride (17 words, no bank
//     conflicts), the query chunk as fp32 is read as 16-byte broadcasts;
//   - the code rows of a tile leave device memory once per query group:
//     BQ = 32 reads them 4 times at the serve shape.
// Tensor-core products (mma / wgmma) and cp.async / TMA staging are later
// work.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRB = 32;              // rows per block-table entry
constexpr int kTPB = 8;              // entries per scored tile
constexpr int kTile = kRB * kTPB;    // 256 rows, one per thread
constexpr int kChunk = 64;           // code bytes of a row staged per step
constexpr int kWords = kChunk / 4;   // 16 words
constexpr int kStride = kWords + 1;  // padded row stride in words

template <int BQ, bool SQ4>
__global__ void __launch_bounds__(kTile)
    ivf_pack_score_kernel(const __nv_bfloat16* __restrict__ q,
                          const int8_t* __restrict__ codes,
                          const int* __restrict__ blk, float* __restrict__ out,
                          int n_q, int dim, int code_bytes, int pad_blk,
                          int n_cols) {
  constexpr int kQDims = SQ4 ? 2 * kChunk : kChunk;
  __shared__ uint32_t cs[kTile * kStride];
  __shared__ __align__(16) float qs[BQ][kQDims];
  __shared__ int rows0[kTPB];

  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int t = threadIdx.x;
  // an all-junk tile: every thread reads the same entry, so all return
  if (blk[tile * kTPB] == pad_blk) return;
  if (t < kTPB) {
    const int b = blk[tile * kTPB + t];
    rows0[t] = min(max(b, 0), pad_blk) * kRB;
  }
  const int half = dim / 2;

  float acc[BQ];
#pragma unroll
  for (int i = 0; i < BQ; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < code_bytes; c0 += kChunk) {
    const int width = min(kChunk, code_bytes - c0);  // a multiple of 4
    const int wpr = width / 4;
    __syncthreads();  // rows0 written; the previous chunk fully consumed
    for (int i = t; i < kTile * kWords; i += kTile) {
      const int r = i / kWords;
      const int w = i % kWords;
      uint32_t v = 0;
      if (w < wpr) {
        const size_t row = static_cast<size_t>(rows0[r / kRB] + r % kRB);
        v = *reinterpret_cast<const uint32_t*>(codes + row * code_bytes + c0 +
                                               4 * w);
      }
      cs[r * kStride + w] = v;
    }
    for (int i = t; i < BQ * kQDims; i += kTile) {
      const int qb = i / kQDims;
      const int k = i % kQDims;
      const int kk = k % kChunk;
      float v = 0.f;
      if (q0 + qb < n_q && kk < width) {
        const int d = (SQ4 && k >= kChunk) ? half + c0 + kk : c0 + kk;
        v = __bfloat162float(q[static_cast<size_t>(q0 + qb) * dim + d]);
      }
      qs[qb][k] = v;
    }
    __syncthreads();

    const uint32_t* row = cs + t * kStride;
    for (int w = 0; w < wpr; ++w) {
      const uint32_t word = row[w];
      if (SQ4) {
        float hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (word >> (8 * j)) & 0xFFu;
          hi[j] = static_cast<float>(byte >> 4);
          lo[j] = static_cast<float>(byte & 0xFu);
        }
#pragma unroll
        for (int qb = 0; qb < BQ; ++qb) {
          const float4 qh = *reinterpret_cast<const float4*>(&qs[qb][4 * w]);
          const float4 ql =
              *reinterpret_cast<const float4*>(&qs[qb][kChunk + 4 * w]);
          float a = acc[qb];
          a = fmaf(qh.x, hi[0], a);
          a = fmaf(qh.y, hi[1], a);
          a = fmaf(qh.z, hi[2], a);
          a = fmaf(qh.w, hi[3], a);
          a = fmaf(ql.x, lo[0], a);
          a = fmaf(ql.y, lo[1], a);
          a = fmaf(ql.z, lo[2], a);
          a = fmaf(ql.w, lo[3], a);
          acc[qb] = a;
        }
      } else {
        float c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // sign-extend each int8 code
          c[j] = static_cast<float>(
              static_cast<int8_t>((word >> (8 * j)) & 0xFFu));
#pragma unroll
        for (int qb = 0; qb < BQ; ++qb) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[qb][4 * w]);
          float a = acc[qb];
          a = fmaf(qv.x, c[0], a);
          a = fmaf(qv.y, c[1], a);
          a = fmaf(qv.z, c[2], a);
          a = fmaf(qv.w, c[3], a);
          acc[qb] = a;
        }
      }
    }
  }

  const size_t col = static_cast<size_t>(tile) * kTile + t;
#pragma unroll
  for (int qb = 0; qb < BQ; ++qb)
    if (q0 + qb < n_q) out[static_cast<size_t>(q0 + qb) * n_cols + col] = acc[qb];
}

template <int BQ>
int launch(const void* q, const void* codes, const int* blk, float* out,
           int n_q, int dim, int code_bytes, int sq4, int budget, int n_rows,
           cudaStream_t stream) {
  const dim3 grid(budget / kTPB, (n_q + BQ - 1) / BQ);
  const int pad_blk = n_rows / kRB - 1;
  const int n_cols = budget * kRB;
  if (sq4)
    ivf_pack_score_kernel<BQ, true><<<grid, kTile, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(codes), blk, out, n_q, dim, code_bytes,
        pad_blk, n_cols);
  else
    ivf_pack_score_kernel<BQ, false><<<grid, kTile, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const int8_t*>(codes), blk, out, n_q, dim, code_bytes,
        pad_blk, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks devices, types, shapes and contiguity; this only refuses what it
// cannot dispatch. Nothing is synchronised.
extern "C" int dph_ivf_pack_score(const void* q, const void* codes,
                                  const int* blk, float* out, int n_q,
                                  int dim, int code_bytes, int sq4,
                                  int budget, int n_rows, int bq,
                                  void* stream) {
  if (n_q <= 0 || budget <= 0 || budget % kTPB || n_rows < kRB ||
      n_rows % kRB || code_bytes % 4 ||
      code_bytes != (sq4 ? dim / 2 : dim) || (sq4 && dim % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bq) {
    case 4: return launch<4>(q, codes, blk, out, n_q, dim, code_bytes, sq4, budget, n_rows, s);
    case 8: return launch<8>(q, codes, blk, out, n_q, dim, code_bytes, sq4, budget, n_rows, s);
    case 16: return launch<16>(q, codes, blk, out, n_q, dim, code_bytes, sq4, budget, n_rows, s);
    case 32: return launch<32>(q, codes, blk, out, n_q, dim, code_bytes, sq4, budget, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
