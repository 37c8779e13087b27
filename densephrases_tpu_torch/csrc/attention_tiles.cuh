// Tile helpers shared by the attention kernels (attention_fwd.cu and
// attention_bwd.cu): bf16 tensor-core products with mma.sync m16n8k16,
// fragments loaded from shared memory with ldmatrix, and 16-byte cp.async
// copies from device memory.
//
// Fragment layouts of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// l of a warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"):
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 = (g, 2t..2t+1),
//     a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8, 8+2t..)
//   B (16 x 8, k x n), 2 regs: b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g)
//   C (16 x 8, fp32), 4 regs: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..)
// So the C fragments of two neighbouring n8 tiles (columns 0-7 and 8-15)
// are, rounded to bf16 in pairs, the A fragment of a 16 x 16 tile whose k
// runs over those columns: a0 = c0c1 and a1 = c2c3 of the first tile, a2
// and a3 the same of the second. This is how P and dS go from one product
// into the next without a trip through shared memory.
//
// Shared-memory tiles are row-major [rows][D + kPad] bf16. A row of D = 64
// is 128 bytes, so the 8 rows an ldmatrix reads would all start in the same
// bank; 8 elements (16 bytes) of padding shift each row by one 16-byte bank
// group, and (D + 8) / 8 is odd for every D here, so the 8 rows fall in 8
// different groups: no bank conflicts, and every row stays 16-byte aligned
// for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of a staged tile (queries or keys)
constexpr int kPad = 8;        // bf16 elements of padding per shared row
constexpr float kMaskNeg = -1e9f;  // densephrases_tpu/models/attention.py:31

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory; when !valid nothing is read
// and the 16 bytes are zero-filled (cp.async's src-size operand of 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds (row l / 4, cols 2(l % 4)..+1) of
// matrix i -- or, with .trans, (rows 2(l % 4)..+1, col l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores (fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address of lane's row for an ldmatrix.x4 of a 16 x 16 A fragment at
// (row0, col0) of a row-major tile: matrices (rows 0-7 | 8-15) x (cols 0-7 |
// 8-15) in the order a0, a1, a2, a3.
template <int kStride>
__device__ __forceinline__ const bf16* a_frag_addr(const bf16* tile, int row0,
                                                   int col0, int lane) {
  return tile + (row0 + (lane & 15)) * kStride + col0 + (lane >> 4) * 8;
}
// ldmatrix.x4 (no .trans) of the B fragments of two n8 tiles from a
// row-major [n][k] tile (the n rows are keys or queries, k runs over D):
// registers b0, b1 of tile n0..n0+7, then b0, b1 of tile n0+8..n0+15.
template <int kStride>
__device__ __forceinline__ const bf16* b_frag_addr(const bf16* tile, int n0,
                                                   int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kStride + k0 +
         ((lane >> 3) & 1) * 8;
}
// ldmatrix.x4.trans of the B fragments of two n8 tiles from a row-major
// [k][n] tile (k runs over keys or queries, n over D): registers b0, b1 of
// columns n0..n0+7, then b0, b1 of n0+8..n0+15.
template <int kStride>
__device__ __forceinline__ const bf16* bt_frag_addr(const bf16* tile, int k0,
                                                    int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + n0 +
         (lane >> 4) * 8;
}

// Stage kTile rows of D bf16 into a padded shared tile with cp.async. Row r
// of the tile is position pos0 + r % kRowsPerCell of cell cell0 + r /
// kRowsPerCell of a [cells, seq, D] tensor; rows past either end are zero.
template <int D, int kRowsPerCell, int kRows = kTile>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int cell0, int cells, int pos0,
                                           int seq) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int cell = cell0 + r / kRowsPerCell;
    const int pos = pos0 + r % kRowsPerCell;
    const bool ok = cell < cells && pos < seq;
    const bf16* from =
        ok ? src + (static_cast<size_t>(cell) * seq + pos) * D + c * 8 : src;
    cp_async16(dst + r * (D + kPad) + c * 8, from, ok);
  }
}

// The row offset of the stored logsumexp, per batch row of the mask: 0,
// unless every key is masked, then -1e9. Such a row's scores all sit at
// about -1e9 and its softmax is uniform, as in the reference; but fp32
// cannot hold -1e9 + log L (its ulp there is 64), so the kernels subtract
// this offset from the scores before the softmax and store the logsumexp of
// the shifted scores. The shift is the same for every key of a row, so P is
// unchanged. Warp-wide: every lane of the warp must call it.
__device__ __forceinline__ float mask_offset(const float* mrow, int seq) {
  bool any = false;
  for (int i = threadIdx.x % 32; i < seq; i += 32) any |= mrow[i] != 0.f;
  return __any_sync(0xffffffffu, any) ? 0.f : kMaskNeg;
}

// The dynamic shared memory above 48 KB a kernel needs, set once per
// instance before its first launch.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

}  // namespace attn
