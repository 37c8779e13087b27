// Helpers shared by the IVF list-scan kernels (ivf_pack_score.cu, kernel C,
// and pq_pack_score.cu, kernel D): the block table, code rows read straight
// into registers, exact int8 / nibble -> bf16 conversions, and the size of a
// grid of resident blocks.
//
// The block table names 32-row blocks of the code matrix; a tile is 8
// consecutive entries (256 rows). Entries past the batch's total name the
// all-zero pad block (pad_blk) and form a suffix, and a tile whose first
// entry is pad_blk is all junk: the kernels leave its columns unwritten and
// the caller masks them. A kernel's warp takes one entry (32 contiguous
// rows) at a time, walking the table with a grid stride, so once it meets
// an all-junk tile every later entry it would take is junk too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace ivf {

using bf16 = __nv_bfloat16;

constexpr int kRB = 32;             // rows per block-table entry
constexpr int kTPB = 8;             // entries per tile
constexpr int kMaxSmem = 232448;    // a block's shared-memory ceiling (227 KB)

// True when entry e lies in an all-junk tile.
__device__ __forceinline__ bool junk_tile(const int* blk, int e, int pad_blk) {
  return __ldg(blk + (e / kTPB) * kTPB) == pad_blk;
}

// The first code row of entry e, its block clamped into [0, pad_blk] so a
// corrupt table never reads past the codes.
__device__ __forceinline__ int entry_row0(const int* blk, int e, int pad_blk) {
  return min(max(__ldg(blk + e), 0), pad_blk) * kRB;
}

// VEC bytes of a code row (VEC = 1, 4 or 16), read with one load of that
// width from device memory into little-endian 32-bit words.
template <int VEC>
struct Chunk {
  uint32_t w[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ Chunk<VEC> load_chunk(const uint8_t* p) {
  Chunk<VEC> c;
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = v.x; c.w[1] = v.y; c.w[2] = v.z; c.w[3] = v.w;
  } else if constexpr (VEC == 4) {
    c.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    c.w[0] = __ldg(p);
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ Chunk<VEC> zero_chunk() {
  Chunk<VEC> c;
#pragma unroll
  for (int i = 0; i < (VEC >= 4 ? VEC / 4 : 1); ++i) c.w[i] = 0;
  return c;
}

// Byte i of a chunk (i a compile-time index after unrolling).
template <int VEC>
__device__ __forceinline__ uint32_t chunk_byte(const Chunk<VEC>& c, int i) {
  return (c.w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// Bytes 2j and 2j+1 of a word into the low bytes of its two 16-bit halves.
__device__ __forceinline__ uint32_t spread_pair(uint32_t w, int j) {
  return __byte_perm(w, 0u, j ? 0x4342u : 0x4140u);
}

// a - b on a bf16 pair as one fma (a * 1 + (-b)), rounded to nearest: exact
// wherever the difference is a bf16, as it is for every use below.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(b ^ 0x80008000u));
  return d;
}

// Two int8 codes (the low bytes of v's 16-bit halves) as an exact bf16 pair.
// 0x4300 | n is the bf16 128 + n for n < 128, so with the 7 low bits n and
// the sign bit s of a code, (128 + n) - (s ? 256 : 128) is the code itself:
// n - 128 s. Both operands and the result are bf16 integers, so the
// subtraction is exact. tests/test_torch_ivf_kernels.py models it in numpy
// on all 256 byte values.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t v) {
  return bf16x2_sub((v & 0x007F007Fu) | 0x43004300u,
                    (v & 0x00800080u) | 0x43004300u);
}

// The high (hi = true) or low nibbles of two bytes (the low bytes of v's
// 16-bit halves) as an exact bf16 pair: (128 + n) - 128.
__device__ __forceinline__ uint32_t u4x2_to_bf16x2(uint32_t v, bool hi) {
  const uint32_t n = (hi ? v >> 4 : v) & 0x000F000Fu;
  return bf16x2_sub(n | 0x43004300u, 0x43004300u);
}

// 8 bytes from device memory to shared memory without passing through
// registers; when !valid nothing is read and the 8 bytes are zero-filled.
// Completes at cp.async.wait_group (attn::cp_async_wait).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 8 : 0));
}

// Raise a kernel's dynamic shared-memory limit when it needs more than 48 KB.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Blocks along x for a grid of `groups` query groups: one wave of resident
// blocks shared among the groups, and no more than the entries need.
template <typename Kernel>
__host__ cudaError_t resident_grid_x(Kernel kernel, int threads, size_t smem,
                                     int groups, int warps_per_block_x,
                                     int n_entries, int* gx) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const int need = (n_entries + warps_per_block_x - 1) / warps_per_block_x;
  *gx = std::max(1, std::min(need, std::max(per_sm, 1) * n_sm / groups));
  return cudaSuccess;
}

}  // namespace ivf
