// Fused bidirectional multi-head attention backward for the BERT towers.
//
// Replaces the Pallas TPU kernel densephrases_tpu/models/attention.py:
// _fused_attn_bwd_kernel (launched by attention_pallas_bwd, the backward of
// the custom VJP around attention_pallas). Same math:
//
//   S  = Q K^T / sqrt(D) + (1 - mask) * (-1e9),  P = softmax(S) (fp32)
//   dV = P^T G
//   dS = P o (G V^T - rowsum(G V^T o P)) / sqrt(D)
//   dQ = dS K,  dK = dS^T Q
//
// q, k, v, g, out, dq, dk, dv: [B, H, L, D] contiguous, bf16 or fp32 (out is
// the forward's output, outputs in q's dtype); lse: fp32 [B, H, L], the
// forward's row logsumexp (attention_fwd.cu); mask: [B, L] fp32 (1 = keep).
// The additive -1e9 mask is kept as the reference has it, so a fully masked
// row has a uniform P and nonzero gradients, as there. P is rebuilt from
// lse as exp(S - offset - lse), with the row's mask offset of
// attention_tiles.cuh (fp32 cannot hold -1e9 + log L, so the forward stores
// the logsumexp of the offset scores). rowsum(dP o P) = rowsum(G o O), so
// delta = g . out per row, from the saved output, as FlashAttention-2 does.
//
// What bounds it on an H100: the TPU kernel holds a cell's whole [L, L] P
// in VMEM; at the phrase tower's L = 384 an fp32 P is 576 KB, far above a
// block's 227 KB of shared memory, so this kernel tiles and never holds P.
// Its work is 10 L^2 D flops per cell in the reference's count: 13.6 GFLOP
// at 12x12x384x64, about 14 us on the bf16 tensor cores, level with the
// ~50 MB of bytes it must move.
// What the design does about it, in two launches on one stream, with every
// output element written by one thread (no atomics, a deterministic result):
//   1. dq pass, one block of 4 warps per (cell, 64-row query tile), each
//      warp 16 rows: its prologue computes delta for its rows (and writes it
//      for pass 2); then K/V tiles of 64 keys stream through a two-stage
//      cp.async ring and each tile takes 3 products: S = Q K^T, dP = G V^T,
//      then dq += dS K, with P = exp(S - lse) and dS = P o (dP - delta)/sqrt(D)
//      in fp32 registers and dS rounded to bf16 as the A operand;
//   2. dk/dv pass, one block per (cell, 64-key tile), each warp 16 keys: Q/G
//      tiles with their rows' lse and delta stream through the ring, and each
//      takes 4 products: S^T = K Q^T and dP^T = V G^T directly, so P^T and
//      dS^T land in accumulator layout and repack in registers as A
//      operands of dv += P^T G and dk += dS^T Q.
// That is 7 D-long products per (query, key) pair against the first
// design's 9, all on the tensor cores (mma.sync m16n8k16 bf16, fp32
// accumulators, ldmatrix fragments, .trans for the B operands of dq, dv and
// dk). The reference's 5 would need all of P held, or atomics on dq.
// Rounding points the reference lacks: delta from the bf16 output, and bf16
// P^T and dS into the products. tests/test_torch_attention_bwd.py models
// them on the CPU against the reference at chip_smoke.py's tolerances.
// The fp32 instances are off the main path and keep the CUDA-core design
// of the first version, with delta and lse taken the same way.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

using attn::bf16;
using attn::kMaskNeg;
using attn::kPad;
using attn::kThreads;
using attn::kTile;

// ---------------------------------------------------------------- bf16, mma

// 8 bf16 pairs (two 16-byte words) multiplied and summed in fp32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

template <int D>
constexpr int dq_smem_bytes() {
  // Q and G tiles, two stages of K and V, two stages of the keys' mask,
  // the rows' lse and delta
  return 6 * kTile * (D + kPad) * 2 + 2 * kTile * 4 + 2 * kTile * 4;
}

// Pass 1: delta for this tile's rows, then dq.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ mask,
                         const bf16* __restrict__ g,
                         const bf16* __restrict__ out,
                         const float* __restrict__ lse, bf16* __restrict__ dq,
                         float* __restrict__ delta, int heads, int seq,
                         float scale) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kTile * kStride;
  bf16* ks = gs + kTile * kStride;      // [2][kTile][kStride]
  bf16* vs = ks + 2 * kTile * kStride;  // [2][kTile][kStride]
  float* bias = reinterpret_cast<float*>(vs + 2 * kTile * kStride);  // [2][kTile]
  float* lse_s = bias + 2 * kTile;
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cell = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(cell) * seq;
  const float* mrow = mask + static_cast<size_t>(cell / heads) * seq;
  const int n_tiles = (seq + kTile - 1) / kTile;

  attn::stage_rows<D, kTile>(qs, q, cell, cell + 1, q0, seq);
  attn::stage_rows<D, kTile>(gs, g, cell, cell + 1, q0, seq);
  attn::stage_rows<D, kTile>(ks, k, cell, cell + 1, 0, seq);
  attn::stage_rows<D, kTile>(vs, v, cell, cell + 1, 0, seq);
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    bias[j] = j < seq ? (1.f - mrow[j]) * kMaskNeg : -INFINITY;
  attn::cp_async_commit();

  // delta = g . out of the tile's rows, two threads a row
  {
    const int r = threadIdx.x / 2;
    const int pos = q0 + r;
    float part = 0.f;
    if (pos < seq) {
      const uint4* gp =
          reinterpret_cast<const uint4*>(g + (base + pos) * D) + (threadIdx.x % 2) * (D / 16);
      const uint4* op =
          reinterpret_cast<const uint4*>(out + (base + pos) * D) + (threadIdx.x % 2) * (D / 16);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) part += dot8(gp[c], op[c]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      delta_s[r] = part;
      lse_s[r] = pos < seq ? lse[base + pos] : 0.f;
      if (pos < seq) delta[base + pos] = part;
    }
  }
  const float moff = attn::mask_offset(mrow, seq);
  __syncthreads();  // the rows' lse and delta are in shared memory
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = lse_s[warp * 16 + lane / 4 + r * 8];
    row_delta[r] = delta_s[warp * 16 + lane / 4 + r * 8];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int ns = st ^ 1;
      const int k0 = (t + 1) * kTile;
      attn::stage_rows<D, kTile>(ks + ns * kTile * kStride, k, cell, cell + 1, k0, seq);
      attn::stage_rows<D, kTile>(vs + ns * kTile * kStride, v, cell, cell + 1, k0, seq);
      for (int j = threadIdx.x; j < kTile; j += kThreads)
        bias[ns * kTile + j] =
            k0 + j < seq ? (1.f - mrow[k0 + j]) * kMaskNeg : -INFINITY;
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * kTile * kStride;
    const bf16* vt = vs + st * kTile * kStride;
    const float* bt = bias + st * kTile;

    // S = Q K^T and dP = G V^T over the tile's 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      attn::ldsm_x4(qa, attn::a_frag_addr<kStride>(qs, warp * 16, kk * 16, lane));
      attn::ldsm_x4(ga, attn::a_frag_addr<kStride>(gs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(kt, np * 16, kk * 16, lane));
        attn::mma_bf16(s[2 * np], qa, b[0], b[1]);
        attn::mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(vt, np * 16, kk * 16, lane));
        attn::mma_bf16(dp[2 * np], ga, b[0], b[1]);
        attn::mma_bf16(dp[2 * np + 1], ga, b[2], b[3]);
      }
    }
    // P = exp(S - offset - lse), dS = P o (dP - delta) / sqrt(D), as bf16
    // A fragments of dS K
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      const float b0 = bt[col], b1 = bt[col + 1];
      const float p0 = __expf(fmaf(s[nt][0], scale, b0) - moff - row_lse[0]);
      const float p1 = __expf(fmaf(s[nt][1], scale, b1) - moff - row_lse[0]);
      const float p2 = __expf(fmaf(s[nt][2], scale, b0) - moff - row_lse[1]);
      const float p3 = __expf(fmaf(s[nt][3], scale, b1) - moff - row_lse[1]);
      dsf[nt / 2][(nt & 1) * 2] =
          attn::pack_bf16(p0 * (dp[nt][0] - row_delta[0]) * scale,
                          p1 * (dp[nt][1] - row_delta[0]) * scale);
      dsf[nt / 2][(nt & 1) * 2 + 1] =
          attn::pack_bf16(p2 * (dp[nt][2] - row_delta[1]) * scale,
                          p3 * (dp[nt][3] - row_delta[1]) * scale);
    }
    // dq += dS K
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        attn::ldsm_x4_trans(b, attn::bt_frag_addr<kStride>(kt, j * 16, dn * 16, lane));
        attn::mma_bf16(acc[2 * dn], dsf[j], b[0], b[1]);
        attn::mma_bf16(acc[2 * dn + 1], dsf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refilling
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + warp * 16 + lane / 4 + r * 8;
    if (pos < seq) {
      uint32_t* row = reinterpret_cast<uint32_t*>(dq + (base + pos) * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        row[i * 4 + (lane & 3)] =
            attn::pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
    }
  }
}

// Query rows per staged Q/G tile of the dk/dv pass: 32 at D = 128 keeps the
// dk and dv accumulators (64 fp32 registers each) and S^T in registers.
template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K and V tiles, two stages of Q and G, two stages of the rows' lse and
  // delta
  return 2 * kTile * (D + kPad) * 2 + 4 * dkv_rows<D>() * (D + kPad) * 2 +
         4 * dkv_rows<D>() * 4;
}

// Pass 2: dk and dv, each warp 16 keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ mask,
                          const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int heads, int seq, float scale) {
  constexpr int kStride = D + kPad;
  constexpr int kBQ = dkv_rows<D>();
  constexpr int kNT = kBQ / 8;  // n8 tiles of queries
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kStride;
  bf16* qs = vs + kTile * kStride;     // [2][kBQ][kStride]
  bf16* gs = qs + 2 * kBQ * kStride;   // [2][kBQ][kStride]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kBQ * kStride);  // [2][kBQ]
  float* delta_s = lse_s + 2 * kBQ;                                  // [2][kBQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cell = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(cell) * seq;
  const float* mrow = mask + static_cast<size_t>(cell / heads) * seq;
  const int n_tiles = (seq + kBQ - 1) / kBQ;

  // The rows' lse and delta of one Q/G tile; rows past the end get 0 (their
  // Q and G rows are zero, so they add nothing).
  auto stage_stats = [&](int s, int q0) {
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool ok = q0 + i < seq;
      lse_s[s * kBQ + i] = ok ? lse[base + q0 + i] : 0.f;
      delta_s[s * kBQ + i] = ok ? delta[base + q0 + i] : 0.f;
    }
  };
  attn::stage_rows<D, kTile>(ks, k, cell, cell + 1, k0, seq);
  attn::stage_rows<D, kTile>(vs, v, cell, cell + 1, k0, seq);
  attn::stage_rows<D, kBQ, kBQ>(qs, q, cell, cell + 1, 0, seq);
  attn::stage_rows<D, kBQ, kBQ>(gs, g, cell, cell + 1, 0, seq);
  stage_stats(0, 0);
  attn::cp_async_commit();

  const float moff = attn::mask_offset(mrow, seq);
  // the mask of this thread's two keys (rows g and g + 8 of the warp's 16)
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + lane / 4 + r * 8;
    key_bias[r] = key < seq ? (1.f - mrow[key]) * kMaskNeg : -INFINITY;
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int ns = st ^ 1;
      const int q0 = (t + 1) * kBQ;
      attn::stage_rows<D, kBQ, kBQ>(qs + ns * kBQ * kStride, q, cell, cell + 1, q0, seq);
      attn::stage_rows<D, kBQ, kBQ>(gs + ns * kBQ * kStride, g, cell, cell + 1, q0, seq);
      stage_stats(ns, q0);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * kBQ * kStride;
    const bf16* gt = gs + st * kBQ * kStride;
    const float* lt = lse_s + st * kBQ;
    const float* dt = delta_s + st * kBQ;

    // S^T = K Q^T and dP^T = V G^T: the warp's 16 keys x the tile's queries
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      attn::ldsm_x4(ka, attn::a_frag_addr<kStride>(ks, warp * 16, kk * 16, lane));
      attn::ldsm_x4(va, attn::a_frag_addr<kStride>(vs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(qt, np * 16, kk * 16, lane));
        attn::mma_bf16(s[2 * np], ka, b[0], b[1]);
        attn::mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(gt, np * 16, kk * 16, lane));
        attn::mma_bf16(dp[2 * np], va, b[0], b[1]);
        attn::mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
      }
    }
    // P^T and dS^T: rows are keys (their mask), columns queries (their lse
    // and delta); bf16 A fragments of P^T G and dS^T Q
    uint32_t pf[kNT / 2][4], dsf[kNT / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      const float l0 = lt[col], l1 = lt[col + 1];
      const float d0 = dt[col], d1 = dt[col + 1];
      const float p0 = __expf(fmaf(s[nt][0], scale, key_bias[0]) - moff - l0);
      const float p1 = __expf(fmaf(s[nt][1], scale, key_bias[0]) - moff - l1);
      const float p2 = __expf(fmaf(s[nt][2], scale, key_bias[1]) - moff - l0);
      const float p3 = __expf(fmaf(s[nt][3], scale, key_bias[1]) - moff - l1);
      pf[nt / 2][(nt & 1) * 2] = attn::pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = attn::pack_bf16(p2, p3);
      dsf[nt / 2][(nt & 1) * 2] = attn::pack_bf16(
          p0 * (dp[nt][0] - d0) * scale, p1 * (dp[nt][1] - d1) * scale);
      dsf[nt / 2][(nt & 1) * 2 + 1] = attn::pack_bf16(
          p2 * (dp[nt][2] - d0) * scale, p3 * (dp[nt][3] - d1) * scale);
    }
    // dv += P^T G, dk += dS^T Q
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        attn::ldsm_x4_trans(b, attn::bt_frag_addr<kStride>(gt, j * 16, dn * 16, lane));
        attn::mma_bf16(dv_acc[2 * dn], pf[j], b[0], b[1]);
        attn::mma_bf16(dv_acc[2 * dn + 1], pf[j], b[2], b[3]);
        attn::ldsm_x4_trans(b, attn::bt_frag_addr<kStride>(qt, j * 16, dn * 16, lane));
        attn::mma_bf16(dk_acc[2 * dn], dsf[j], b[0], b[1]);
        attn::mma_bf16(dk_acc[2 * dn + 1], dsf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refilling
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + lane / 4 + r * 8;
    if (key < seq) {
      uint32_t* krow = reinterpret_cast<uint32_t*>(dk + (base + key) * D);
      uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + (base + key) * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        krow[i * 4 + (lane & 3)] =
            attn::pack_bf16(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
        vrow[i * 4 + (lane & 3)] =
            attn::pack_bf16(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const float* mask,
                const void* g, const void* out, const float* lse, void* dq,
                void* dk, void* dv, float* delta, int batch, int heads,
                int seq, cudaStream_t stream) {
  static bool dq_smem_set = false, dkv_smem_set = false;
  constexpr int kDqSmem = dq_smem_bytes<D>();
  constexpr int kDkvSmem = dkv_smem_bytes<D>();
  cudaError_t err = attn::allow_smem(attention_bwd_dq_mma<D>, kDqSmem, &dq_smem_set);
  if (err == cudaSuccess)
    err = attn::allow_smem(attention_bwd_dkv_mma<D>, kDkvSmem, &dkv_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  attention_bwd_dq_mma<D><<<grid, kThreads, kDqSmem, stream>>>(
      qt, kt, vt, mask, gt, static_cast<const bf16*>(out), lse,
      static_cast<bf16*>(dq), delta, heads, seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_mma<D><<<grid, kThreads, kDkvSmem, stream>>>(
      qt, kt, vt, mask, gt, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), heads, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- fp32, CUDA cores

constexpr int kDimsPerThread = 16;

// Sum of a row's partial dot products over its kRowThreads lanes.
template <int kRowThreads>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// Stage rows [r0, r0 + kRows) of two [L, D] matrices in shared memory; rows
// past the end are zero.
template <int D, int kRows>
__device__ __forceinline__ void stage_pair(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float (*as)[D], float (*bs)[D],
                                           size_t base, int r0, int seq) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx % D;
    const int r = r0 + j;
    float av = 0.f, bv = 0.f;
    if (r < seq) {
      const size_t at = base + static_cast<size_t>(r) * D + d;
      av = a[at];
      bv = b[at];
    }
    as[j][d] = av;
    bs[j][d] = bv;
  }
}

// Pass 1: delta, then dq, one query row per kRowThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         const float* __restrict__ g,
                         const float* __restrict__ out,
                         const float* __restrict__ lse, float* __restrict__ dq,
                         float* __restrict__ delta, int heads, int seq,
                         float scale) {
  constexpr int kRowThreads = D / kDimsPerThread;
  constexpr int kRows = kThreads / kRowThreads;
  constexpr int kKeys = D <= 64 ? 64 : 32;
  __shared__ float ks[kKeys][D];
  __shared__ float vs[kKeys][D];
  __shared__ float bias[kKeys];

  const int bh = blockIdx.x;
  const int lane = threadIdx.x % kRowThreads;
  const int row = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const bool row_ok = row < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const float* mrow = mask + static_cast<size_t>(bh / heads) * seq;
  const float moff = attn::mask_offset(mrow, seq);

  float qr[kDimsPerThread], gr[kDimsPerThread], acc[kDimsPerThread];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const size_t at = base + static_cast<size_t>(row) * D + i * kRowThreads + lane;
    qr[i] = row_ok ? q[at] : 0.f;
    gr[i] = row_ok ? g[at] : 0.f;
    part = fmaf(gr[i], row_ok ? out[at] : 0.f, part);
    acc[i] = 0.f;
  }
  const float row_delta = row_sum<kRowThreads>(part);  // g . out
  const float row_lse = row_ok ? lse[static_cast<size_t>(bh) * seq + row] : 0.f;
  if (row_ok && lane == 0) delta[static_cast<size_t>(bh) * seq + row] = row_delta;

  // dq = sum_j dS_ij k_j
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // every row is done with the previous tile
    stage_pair<D, kKeys>(k, v, ks, vs, base, k0, seq);
    for (int j = threadIdx.x; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      bias[j] = key < seq ? (1.f - mrow[key]) * kMaskNeg : 0.f;
    }
    __syncthreads();
    const int n_keys = min(kKeys, seq - k0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        sp = fmaf(qr[i], ks[j][i * kRowThreads + lane], sp);
        dp = fmaf(gr[i], vs[j][i * kRowThreads + lane], dp);
      }
      sp = row_sum<kRowThreads>(sp);
      dp = row_sum<kRowThreads>(dp);
      const float p = __expf(fmaf(sp, scale, bias[j]) - moff - row_lse);
      const float ds = p * (dp - row_delta) * scale;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(ds, ks[j][i * kRowThreads + lane], acc[i]);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      dq[base + static_cast<size_t>(row) * D + i * kRowThreads + lane] = acc[i];
  }
}

// Pass 2: dk and dv, one key row per kRowThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ mask,
                          const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int heads, int seq, float scale) {
  constexpr int kRowThreads = D / kDimsPerThread;
  constexpr int kRows = kThreads / kRowThreads;
  constexpr int kQueries = D <= 64 ? 64 : 32;
  __shared__ float qs[kQueries][D];
  __shared__ float gs[kQueries][D];
  __shared__ float st[kQueries][2];  // lse and delta of each query row

  const int bh = blockIdx.x;
  const int lane = threadIdx.x % kRowThreads;
  const int key = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const bool key_ok = key < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const float* mrow = mask + static_cast<size_t>(bh / heads) * seq;
  const float moff = attn::mask_offset(mrow, seq);
  const float bias = key_ok ? (1.f - mrow[key]) * kMaskNeg : 0.f;

  float kr[kDimsPerThread], vr[kDimsPerThread];
  float dk_acc[kDimsPerThread], dv_acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const size_t at = base + static_cast<size_t>(key) * D + i * kRowThreads + lane;
    kr[i] = key_ok ? k[at] : 0.f;
    vr[i] = key_ok ? v[at] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += kQueries) {
    __syncthreads();
    stage_pair<D, kQueries>(q, g, qs, gs, base, q0, seq);
    for (int i = threadIdx.x; i < kQueries; i += kThreads) {
      const size_t at = static_cast<size_t>(bh) * seq + q0 + i;
      st[i][0] = q0 + i < seq ? lse[at] : 0.f;
      st[i][1] = q0 + i < seq ? delta[at] : 0.f;
    }
    __syncthreads();
    const int n_q = min(kQueries, seq - q0);
#pragma unroll 4
    for (int i = 0; i < n_q; ++i) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < kDimsPerThread; ++t) {
        sp = fmaf(qs[i][t * kRowThreads + lane], kr[t], sp);
        dp = fmaf(gs[i][t * kRowThreads + lane], vr[t], dp);
      }
      sp = row_sum<kRowThreads>(sp);
      dp = row_sum<kRowThreads>(dp);
      const float p =
          key_ok ? __expf(fmaf(sp, scale, bias) - moff - st[i][0]) : 0.f;
      const float ds = p * (dp - st[i][1]) * scale;
#pragma unroll
      for (int t = 0; t < kDimsPerThread; ++t) {
        dv_acc[t] = fmaf(p, gs[i][t * kRowThreads + lane], dv_acc[t]);
        dk_acc[t] = fmaf(ds, qs[i][t * kRowThreads + lane], dk_acc[t]);
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int t = 0; t < kDimsPerThread; ++t) {
      const size_t at = base + static_cast<size_t>(key) * D + t * kRowThreads + lane;
      dk[at] = dk_acc[t];
      dv[at] = dv_acc[t];
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const float* mask,
               const void* g, const void* out, const float* lse, void* dq,
               void* dk, void* dv, float* delta, int batch, int heads, int seq,
               cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / kDimsPerThread);
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  attention_bwd_dq_f32<D><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, mask, gt, static_cast<const float*>(out), lse,
      static_cast<float*>(dq), delta, heads, seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_f32<D><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, mask, gt, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), heads, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const void* g, const void* out, const float* lse, void* dq,
           void* dk, void* dv, float* delta, int batch, int heads, int seq,
           int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, mask, g, out, lse, dq, dk, dv,
                                  delta, batch, heads, seq, s)
                 : launch_f32<D>(q, k, v, mask, g, out, lse, dq, dk, dv,
                                 delta, batch, heads, seq, s);
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 = launched). delta
// is caller-allocated fp32 scratch of B * H * L floats (pass 1 writes it,
// pass 2 reads it). The caller checks shapes, types and contiguity; this
// only refuses what it cannot dispatch. Nothing is synchronised.
extern "C" int dph_attention_bwd(const void* q, const void* k, const void* v,
                                 const float* mask, const void* g,
                                 const void* out, const float* lse, void* dq,
                                 void* dk, void* dv, float* delta, int batch,
                                 int heads, int seq, int head_dim, int is_bf16,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, mask, g, out, lse, dq, dk, dv, delta, batch, heads, seq, is_bf16, s);
    case 32: return launch<32>(q, k, v, mask, g, out, lse, dq, dk, dv, delta, batch, heads, seq, is_bf16, s);
    case 64: return launch<64>(q, k, v, mask, g, out, lse, dq, dk, dv, delta, batch, heads, seq, is_bf16, s);
    case 128: return launch<128>(q, k, v, mask, g, out, lse, dq, dk, dv, delta, batch, heads, seq, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
