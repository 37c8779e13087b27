// Kernel D: PQ / OPQ asymmetric-distance scores of a query batch against
// the IVF code rows that a 32-row block table names (the packed PQ scan).
//
// Replaces the Pallas TPU kernel densephrases_tpu/ops/ivf_pack.py:
// _pq_pack_score_kernel (launched by _pq_pack_score). Same math:
//
//   raw[b, j*32 + r] = sum_m LUT[b, m, code[blk[j]*32 + r, m]]
//
// lut: [n_q, M, ksub] bf16 in its natural layout (the TPU kernel's k-major
// and one-hot permutations were a matrix-unit layout and are not carried
// over); codes: [n_rows, code_bytes] uint8, n_rows % 32 == 0, the last
// 32-row block all zeros (pad_blk). 8-bit: ksub = 256, one byte a
// subspace (code_bytes == M). 4-bit: ksub = 16, byte i holds subspace 2i
// in its low nibble and 2i+1 in its high nibble (code_bytes == M/2).
// blk: [budget] int32, budget % 8 == 0, junk entries (== pad_blk) form a
// suffix; out: [n_q, budget*32] fp32. Tiles from the first junk one on are
// left unwritten; the caller masks those columns.
//
// What bounds it on an H100: at the serve shape (128 stacked queries,
// OPQ96 or OPQ192x4, ~0.6M gathered rows) the code rows are only ~57 MB,
// but every (query, row) pair costs M lookups: ~7e9 (8-bit) or ~1.5e10
// (4-bit) gathers from shared memory, so shared-memory gather throughput
// and its bank conflicts bound it.
// What the design does about it:
//   - the LUTs of a group of BQ queries sit in dynamic shared memory (48 KB
//     a query at M=96 x 256, 6 KB at M=192 x 16; BQ sized by the wrapper
//     to stay under 227 KB), and each block walks many 256-row tiles
//     (grid-stride), so a LUT is loaded into shared memory once per block
//     and not once per tile;
//   - a tile's code rows are staged in shared memory with coalesced 4-byte
//     loads (a 32-row block is one contiguous run of bytes) and stored
//     transposed, [byte][row], so the 256 threads, one per row, read
//     consecutive bytes without conflicts;
//   - each thread sums LUT[q][m][code] over m in fp32 for its row and its
//     BQ queries, in subspace order.
// One-hot tensor-core formulations, cp.async / TMA staging and a fused
// per-tile top-k are later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRB = 32;            // rows per block-table entry
constexpr int kTPB = 8;            // entries per scored tile
constexpr int kTile = kRB * kTPB;  // 256 rows, one per thread
// a block's shared-memory ceiling (232,448 bytes), less room for the
// static rows0 table
constexpr int kMaxSmem = 232448 - 1024;

__host__ __device__ size_t lut_bytes(int bq, int m, int ksub) {
  return static_cast<size_t>(bq) * m * ksub * sizeof(__nv_bfloat16);
}

__host__ __device__ size_t smem_bytes(int bq, int m, int ksub, int code_bytes) {
  return lut_bytes(bq, m, ksub) + static_cast<size_t>(code_bytes) * kTile;
}

template <int BQ, bool NIB>
__global__ void __launch_bounds__(kTile)
    pq_pack_score_kernel(const __nv_bfloat16* __restrict__ lut,
                         const uint8_t* __restrict__ codes,
                         const int* __restrict__ blk, float* __restrict__ out,
                         int n_q, int m, int ksub, int code_bytes,
                         int pad_blk, int n_tiles, int n_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows0[kTPB];
  const int lut_elems = m * ksub;  // a multiple of 8 (ksub is 16 or 256)
  __nv_bfloat16* lut_s = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* codes_s = smem + lut_bytes(BQ, m, ksub);  // [code_bytes][256]

  const int t = threadIdx.x;
  const int q0 = blockIdx.y * BQ;

  // the group's LUTs, 16 bytes at a time; queries past n_q read as zeros
  {
    const int vecs = lut_elems / 8;
    uint4* dst = reinterpret_cast<uint4*>(lut_s);
    const uint4* src = reinterpret_cast<const uint4*>(lut);
    for (int i = t; i < BQ * vecs; i += kTile) {
      const int qb = i / vecs;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q0 + qb < n_q) v = src[static_cast<size_t>(q0) * vecs + i];
      dst[i] = v;
    }
  }

  const int words_per_slot = kRB * code_bytes / 4;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the LUT is loaded; the previous tile is consumed
    // junk entries form a suffix, so every later tile of this block is junk
    if (blk[tile * kTPB] == pad_blk) break;
    if (t < kTPB) {
      const int b = blk[tile * kTPB + t];
      rows0[t] = min(max(b, 0), pad_blk) * kRB;
    }
    __syncthreads();
    for (int i = t; i < kTPB * words_per_slot; i += kTile) {
      const int s = i / words_per_slot;
      const int w = i % words_per_slot;
      const uint32_t v = reinterpret_cast<const uint32_t*>(
          codes + static_cast<size_t>(rows0[s]) * code_bytes)[w];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = 4 * w + j;
        const int r = s * kRB + o / code_bytes;
        codes_s[(o % code_bytes) * kTile + r] =
            static_cast<uint8_t>((v >> (8 * j)) & 0xFFu);
      }
    }
    __syncthreads();

    float acc[BQ];
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb) acc[qb] = 0.f;
    for (int i = 0; i < code_bytes; ++i) {
      const int byte = codes_s[i * kTile + t];
      if (NIB) {
        const int e0 = (2 * i) * ksub + (byte & 0xF);
        const int e1 = (2 * i + 1) * ksub + (byte >> 4);
#pragma unroll
        for (int qb = 0; qb < BQ; ++qb) {
          const __nv_bfloat16* l = lut_s + qb * lut_elems;
          acc[qb] += __bfloat162float(l[e0]);
          acc[qb] += __bfloat162float(l[e1]);
        }
      } else {
        const int e = i * ksub + byte;
#pragma unroll
        for (int qb = 0; qb < BQ; ++qb)
          acc[qb] += __bfloat162float(lut_s[qb * lut_elems + e]);
      }
    }
    const size_t col = static_cast<size_t>(tile) * kTile + t;
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb)
      if (q0 + qb < n_q)
        out[static_cast<size_t>(q0 + qb) * n_cols + col] = acc[qb];
  }
}

template <int BQ, bool NIB>
int launch_one(const void* lut, const void* codes, const int* blk, float* out,
               int n_q, int m, int ksub, int code_bytes, int budget,
               int n_rows, cudaStream_t stream) {
  auto kernel = pq_pack_score_kernel<BQ, NIB>;
  const size_t smem = smem_bytes(BQ, m, ksub, code_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTile, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_tiles = budget / kTPB;
  const int groups = (n_q + BQ - 1) / BQ;
  // one wave of resident blocks: every block walks n_tiles / grid.x tiles
  const int gx =
      std::max(1, std::min(n_tiles, std::max(per_sm, 1) * n_sm / groups));
  pq_pack_score_kernel<BQ, NIB><<<dim3(gx, groups), kTile, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(lut),
      static_cast<const uint8_t*>(codes), blk, out, n_q, m, ksub, code_bytes,
      n_rows / kRB - 1, n_tiles, budget * kRB);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ>
int launch(const void* lut, const void* codes, const int* blk, float* out,
           int n_q, int m, int ksub, int code_bytes, int budget, int n_rows,
           cudaStream_t stream) {
  if (ksub == 16)
    return launch_one<BQ, true>(lut, codes, blk, out, n_q, m, ksub,
                                code_bytes, budget, n_rows, stream);
  return launch_one<BQ, false>(lut, codes, blk, out, n_q, m, ksub, code_bytes,
                               budget, n_rows, stream);
}

}  // namespace

// Returns a CUDA error code (0 = launched). The caller checks devices,
// types, shapes and contiguity and picks bq so the LUTs fit in shared
// memory; this only refuses what it cannot dispatch. Nothing is
// synchronised.
extern "C" int dph_pq_pack_score(const void* lut, const void* codes,
                                 const int* blk, float* out, int n_q, int m,
                                 int ksub, int code_bytes, int budget,
                                 int n_rows, int bq, void* stream) {
  const bool nib = ksub == 16;
  if (n_q <= 0 || budget <= 0 || budget % kTPB || n_rows < kRB ||
      n_rows % kRB || !(ksub == 16 || ksub == 256) ||
      code_bytes != (nib ? m / 2 : m) || (nib && m % 2) ||
      smem_bytes(bq, m, ksub, code_bytes) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bq) {
    case 1: return launch<1>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    case 2: return launch<2>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    case 4: return launch<4>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    case 8: return launch<8>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    case 16: return launch<16>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    case 32: return launch<32>(lut, codes, blk, out, n_q, m, ksub, code_bytes, budget, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
