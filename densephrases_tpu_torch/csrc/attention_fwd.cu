// Fused bidirectional multi-head attention forward for the BERT towers.
//
// Replaces the Pallas TPU kernel densephrases_tpu/models/attention.py:
// _fused_attn_kernel (launched by attention_pallas). Same math:
//
//   S = Q K^T / sqrt(D) + (1 - mask) * (-1e9),  softmax in fp32,  O = P V
//
// q, k, v, out: [B, H, L, D] contiguous, bf16 or fp32; mask: [B, L] fp32
// (1 = keep). The additive -1e9 mask is kept exactly as the reference has
// it (not -inf, and masked keys are not skipped), so a fully masked row --
// the dump's all-zero pad windows -- averages V uniformly, as there. Keys
// past L do not exist and get -inf. Optionally (lse != nullptr) it writes
// the row logsumexp, fp32 [B, H, L], for the backward (attention_bwd.cu);
// it is taken of the scores less the row's mask offset (attention_tiles.cuh:
// mask_offset), because fp32 cannot hold -1e9 + log L.
//
// What bounds it on an H100: the TPU kernel holds a whole (batch, head)
// cell's [L, L] scores in VMEM. Here a cell's work is 4 L^2 D flops over
// 4 L D bf16 of traffic: at L = 512, D = 64 that is 256 flops a byte, so
// the bound is set about evenly by bytes and tensor-core flops (16x12x512x64:
// 50 MB, 15 us; 12.9 GFLOP, 13 us). The serve path's L = 32 cells are tiny
// (0.26 MFLOP); there occupancy and launch count bound it.
// What the design does about it (bf16, the towers' compute type):
//   - FlashAttention-2 shape: a block of 4 warps takes 64 query rows of a
//     cell, each warp 16 rows; S = Q K^T and O = P V run on the tensor cores
//     (mma.sync m16n8k16 bf16, fp32 accumulators), fragments from shared
//     memory by ldmatrix (.trans for V);
//   - K/V tiles of 64 keys stream through a two-stage cp.async ring, so the
//     next tile's copy overlaps this tile's products; shared rows are padded
//     by 16 bytes, so ldmatrix has no bank conflicts;
//   - online softmax in fp32 registers over the accumulator fragments; the
//     unnormalised P is rounded to bf16 and repacked as the A operand of
//     P V in registers; O is normalised once at the end. No [L, L] block is
//     ever held, at any L;
//   - at L <= 32 a block takes 2 cells, so all 4 warps work and a cell is
//     one K/V pass.
// The fp32 instances are off the main path (the towers compute in bf16) and
// keep the first design: the products on the CUDA cores, a row split over
// D/16 threads.
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

// Dynamic shared memory of one block: the Q tile, two K and two V tiles,
// and two stages of the keys' additive mask.
template <int D>
constexpr int fwd_smem_bytes() {
  return 5 * kTile * (D + kPad) * 2 + 2 * kTile * 4;
}

// Stage the additive mask of one key tile: slot j is key pos0 + j % kKW of
// cell cell0 + j / kKW; -inf past the sequence or the cells.
template <int kKW>
__device__ __forceinline__ void stage_bias(float* dst,
                                           const float* __restrict__ mask,
                                           int cell0, int cells, int heads,
                                           int pos0, int seq) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int cell = cell0 + j / kKW;
    const int pos = pos0 + j % kKW;
    dst[j] = cell < cells && pos < seq
                 ? (1.f - mask[static_cast<size_t>(cell / heads) * seq + pos]) *
                       kMaskNeg
                 : -INFINITY;
  }
}

// kCPB cells per block (1 or 2). Each cell's query rows and keys come in
// tiles of kKW = 64 / kCPB; with kCPB = 2 the whole sequence is one tile.
template <int D, int kCPB>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ lse, int cells, int heads, int seq,
                      float scale) {
  constexpr int kKW = kTile / kCPB;  // keys (and query rows) per cell per tile
  constexpr int kWPC = 4 / kCPB;     // warps per cell
  constexpr int kStride = D + kPad;
  constexpr int kNT = kKW / 8;       // n8 tiles of keys a warp scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kStride;       // [2][kTile][kStride]
  bf16* vs = ks + 2 * kTile * kStride;   // [2][kTile][kStride]
  float* bias = reinterpret_cast<float*>(vs + 2 * kTile * kStride);  // [2][kTile]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cell0 = blockIdx.x * kCPB;
  const int q0 = blockIdx.y * kKW;  // first query position of this tile
  const int my_cell = cell0 + warp / kWPC;
  const bool cell_ok = my_cell < cells;
  const int row_base = (warp / kWPC) * kKW + (warp % kWPC) * 16;  // in qs
  const int key_base = (warp / kWPC) * kKW;                       // in ks, vs
  const int n_tiles = (seq + kKW - 1) / kKW;

  attn::stage_rows<D, kKW>(qs, q, cell0, cells, q0, seq);
  attn::cp_async_commit();
  attn::stage_rows<D, kKW>(ks, k, cell0, cells, 0, seq);
  attn::stage_rows<D, kKW>(vs, v, cell0, cells, 0, seq);
  stage_bias<kKW>(bias, mask, cell0, cells, heads, 0, seq);
  attn::cp_async_commit();

  const float moff =
      cell_ok ? attn::mask_offset(mask + static_cast<size_t>(my_cell / heads) * seq, seq)
              : 0.f;
  attn::cp_async_wait<1>();  // the Q tile, not yet the first K/V tile
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    attn::ldsm_x4(qf[kk], attn::a_frag_addr<kStride>(qs, row_base, kk * 16, lane));
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // rows g and g + 8 of the warp's 16 (g = lane / 4): running max and this
  // thread's part of the running sum
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int ns = st ^ 1;
      attn::stage_rows<D, kKW>(ks + ns * kTile * kStride, k, cell0, cells,
                               (t + 1) * kKW, seq);
      attn::stage_rows<D, kKW>(vs + ns * kTile * kStride, v, cell0, cells,
                               (t + 1) * kKW, seq);
      stage_bias<kKW>(bias + ns * kTile, mask, cell0, cells, heads,
                      (t + 1) * kKW, seq);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * kTile * kStride;
    const bf16* vt = vs + st * kTile * kStride;
    const float* bt = bias + st * kTile + key_base;

    // S = Q K^T over this cell's kKW keys of the tile
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(kt, key_base + np * 16,
                                                    kk * 16, lane));
        attn::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        attn::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax: scale, add the mask, less the row's mask offset
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      const float b0 = bt[col], b1 = bt[col + 1];
      s[nt][0] = fmaf(s[nt][0], scale, b0) - moff;
      s[nt][1] = fmaf(s[nt][1], scale, b1) - moff;
      s[nt][2] = fmaf(s[nt][2], scale, b0) - moff;
      s[nt][3] = fmaf(s[nt][3], scale, b1) - moff;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds a real key, so the max is finite from the first
      // tile on and exp(-inf - max) is 0
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    // P = exp(S - max): fp32 sums, bf16 A fragments of P V
    uint32_t pf[kNT / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = __expf(s[nt][0] - m_run[0]);
      const float p1 = __expf(s[nt][1] - m_run[0]);
      const float p2 = __expf(s[nt][2] - m_run[1]);
      const float p3 = __expf(s[nt][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pf[nt / 2][(nt & 1) * 2] = attn::pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = attn::pack_bf16(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        attn::ldsm_x4_trans(b, attn::bt_frag_addr<kStride>(
                                   vt, key_base + j * 16, dp * 16, lane));
        attn::mma_bf16(o[2 * dp], pf[j], b[0], b[1]);
        attn::mma_bf16(o[2 * dp + 1], pf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refilling
  }

  if (!cell_ok) return;
  const size_t base = static_cast<size_t>(my_cell) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int pos = q0 + (warp % kWPC) * 16 + lane / 4 + r * 8;
    if (pos < seq) {
      const float inv = 1.f / l_run[r];
      uint32_t* orow = reinterpret_cast<uint32_t*>(out + (base + pos) * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        orow[i * 4 + (lane & 3)] =
            attn::pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[base + pos] = m_run[r] + logf(l_run[r]);
    }
  }
}

template <int D, int kCPB>
int launch_mma(const void* q, const void* k, const void* v, const float* mask,
               void* out, float* lse, int batch, int heads, int seq,
               cudaStream_t stream) {
  constexpr int kKW = kTile / kCPB;
  constexpr int kSmem = fwd_smem_bytes<D>();
  static bool smem_set = false;
  const cudaError_t err =
      attn::allow_smem(attention_fwd_mma<D, kCPB>, kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = batch * heads;
  const dim3 grid((cells + kCPB - 1) / kCPB, (seq + kKW - 1) / kKW);
  attention_fwd_mma<D, kCPB><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), lse, cells,
      heads, seq, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const float* mask,
                void* out, float* lse, int batch, int heads, int seq,
                cudaStream_t stream) {
  if (seq <= 32)
    return launch_mma<D, 2>(q, k, v, mask, out, lse, batch, heads, seq, stream);
  return launch_mma<D, 1>(q, k, v, mask, out, lse, batch, heads, seq, stream);
}

// ------------------------------------------------------- fp32, CUDA cores

// Each thread owns 16 of a query row's D dims (interleaved with its
// neighbours, so the threads of one row read consecutive shared words).
constexpr int kDimsPerThread = 16;

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask, float* __restrict__ out,
                      float* __restrict__ lse, int heads, int seq,
                      float scale) {
  constexpr int kRowThreads = D / kDimsPerThread;  // threads per query row
  constexpr int kRows = kThreads / kRowThreads;    // query rows per block
  constexpr int kKeys = D <= 64 ? 64 : 32;         // keys per shared tile
  __shared__ float ks[kKeys][D];
  __shared__ float vs[kKeys][D];
  __shared__ float bias[kKeys];

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int lane = threadIdx.x % kRowThreads;
  const int row = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const bool row_ok = row < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const float* mrow = mask + static_cast<size_t>(batch) * seq;
  const float moff = attn::mask_offset(mrow, seq);

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int d = i * kRowThreads + lane;
    qr[i] = row_ok ? q[base + static_cast<size_t>(row) * D + d] : 0.f;
    acc[i] = 0.f;
  }
  float run_max = -INFINITY;
  float run_sum = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < kKeys * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < seq) {
        const size_t at = base + static_cast<size_t>(key) * D + d;
        kv = k[at];
        vv = v[at];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int j = threadIdx.x; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      bias[j] = key < seq ? (1.f - mrow[key]) * kMaskNeg : 0.f;
    }
    __syncthreads();

    // Keys past the end of the sequence do not exist: they get -inf, so
    // they carry no weight (unlike masked keys, which carry -1e9).
    const int n_keys = min(kKeys, seq - k0);
    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        part = fmaf(qr[i], ks[j][i * kRowThreads + lane], part);
      // Every lane of a warp takes part, so the full mask is right.
#pragma unroll
      for (int off = kRowThreads / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float sj = j < n_keys ? fmaf(part, scale, bias[j]) - moff : -INFINITY;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    // The first tile always holds at least one real key, so new_max is
    // finite from then on and exp(-inf - new_max) is 0.
    const float new_max = fmaxf(run_max, tile_max);
    const float alpha = __expf(run_max - new_max);
    run_sum *= alpha;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = __expf(s[j] - new_max);
      run_sum += p;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(p, vs[j][i * kRowThreads + lane], acc[i]);
    }
    run_max = new_max;
  }

  if (row_ok) {
    const float inv = 1.f / run_sum;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = i * kRowThreads + lane;
      out[base + static_cast<size_t>(row) * D + d] = acc[i] * inv;
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * seq + row] = run_max + logf(run_sum);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const float* mask,
               void* out, float* lse, int batch, int heads, int seq,
               cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / kDimsPerThread);
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  attention_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), lse,
      heads, seq, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, float* lse, int batch, int heads, int seq, int is_bf16,
           cudaStream_t stream) {
  return is_bf16
             ? launch_bf16<D>(q, k, v, mask, out, lse, batch, heads, seq, stream)
             : launch_f32<D>(q, k, v, mask, out, lse, batch, heads, seq, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). lse may be
// null (serve and dump); else fp32 [B, H, L]. The caller checks shapes,
// types and contiguity; this only refuses what it cannot dispatch. Nothing
// is synchronised.
extern "C" int dph_attention_fwd(const void* q, const void* k, const void* v,
                                 const float* mask, void* out, float* lse,
                                 int batch, int heads, int seq, int head_dim,
                                 int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, mask, out, lse, batch, heads, seq, is_bf16, s);
    case 32: return launch<32>(q, k, v, mask, out, lse, batch, heads, seq, is_bf16, s);
    case 64: return launch<64>(q, k, v, mask, out, lse, batch, heads, seq, is_bf16, s);
    case 128: return launch<128>(q, k, v, mask, out, lse, batch, heads, seq, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
