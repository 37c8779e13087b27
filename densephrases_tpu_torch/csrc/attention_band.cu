// Banded bidirectional multi-head attention forward: kernel A's tiles for
// windowed (local) attention layers, as ModernBERT's local layers use it.
//
// Replaces no TPU kernel: the JAX package has no windowed attention. It
// is kernel A (attention_fwd.cu) restricted to a band, built from the same
// tile code (attention_tiles.cuh) and the same online softmax:
//
//   S = Q K^T / sqrt(D) + (1 - mask) * (-1e9),  S_ij = -inf where |i - j| > w,
//   softmax in fp32,  O = P V
//
// q, k, v, out: [B, H, L, D] contiguous bf16; mask: [B, L] fp32 (1 = keep);
// w >= 0 the half-width of the band (ModernBERT's local_attention / 2, so
// 2w + 1 keys a query). Padded keys keep A's additive -1e9 (not -inf), and
// a batch row whose every key is masked averages V uniformly over each
// query's band, as the plain twin (models/attention.py: attention_plain
// with a window) gives. Keys past L do not exist and get -inf. No row
// logsumexp: the band serves only, with no backward.
//
// What bounds it on an H100: a cell's work is 4 D sum_i |band_i| ~ 4 L (2w
// + 1) D flops over 4 L D bf16 (8 L D bytes) of traffic, (2w + 1) / 2 = 64.5
// flops a byte at w = 64 against the card's ~295, so bytes bound it (8 x 16
// x 8192 x 64: 537 MB, 0.160 ms; 34.5 GFLOP, 0.035 ms). What the design
// does about it:
//   - a block of 4 warps takes 64 query rows of a cell, as A does, and
//     streams only the key tiles of 64 that meet [q0 - w, q0 + 63 + w]:
//     3 tiles at w = 64, not L / 64, so each K/V row is read by 3 blocks
//     and the traffic stays near one pass over q, k, v, out;
//   - inside those tiles the pairs outside the band get -inf in registers,
//     after the product, so the tile code (cp.async ring, ldmatrix,
//     mma.sync m16n8k16, P repacked in registers) is A's unchanged;
//   - with w < 64 a row can meet a tile where none of its keys is in the
//     band: its running max stays -inf and that tile adds nothing (the
//     exponent's shift is taken as 0 there, never -inf - -inf).
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

// Dynamic shared memory of one block: the Q tile, two K and two V tiles,
// and two stages of the keys' additive mask (as kernel A's).
template <int D>
constexpr int band_smem_bytes() {
  return 5 * kTile * (D + kPad) * 2 + 2 * kTile * 4;
}

// The additive mask of the key tile at pos0 of a cell: -inf past the
// sequence.
__device__ __forceinline__ void stage_band_bias(float* dst,
                                                const float* __restrict__ mrow,
                                                int pos0, int seq) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int pos = pos0 + j;
    dst[j] = pos < seq ? (1.f - mrow[pos]) * kMaskNeg : -INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_band_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       int heads, int seq, int window, float scale) {
  constexpr int kStride = D + kPad;
  constexpr int kNT = kTile / 8;  // n8 tiles of keys a warp scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kStride;      // [2][kTile][kStride]
  bf16* vs = ks + 2 * kTile * kStride;  // [2][kTile][kStride]
  float* bias = reinterpret_cast<float*>(vs + 2 * kTile * kStride);  // [2][kTile]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cell = blockIdx.x;
  const int q0 = blockIdx.y * kTile;  // first query position of this tile
  const float* mrow = mask + static_cast<size_t>(cell / heads) * seq;
  // the key tiles that meet the block's band [q0 - w, q0 + 63 + w]
  const int t_lo = max(q0 - window, 0) / kTile;
  const int t_hi = min(q0 + kTile - 1 + window, seq - 1) / kTile;
  // rows g and g + 8 of the warp's 16 (g = lane / 4)
  const int row0 = q0 + warp * 16 + lane / 4;

  attn::stage_rows<D, kTile>(qs, q, cell, cell + 1, q0, seq);
  attn::cp_async_commit();
  attn::stage_rows<D, kTile>(ks, k, cell, cell + 1, t_lo * kTile, seq);
  attn::stage_rows<D, kTile>(vs, v, cell, cell + 1, t_lo * kTile, seq);
  stage_band_bias(bias, mrow, t_lo * kTile, seq);
  attn::cp_async_commit();

  const float moff = attn::mask_offset(mrow, seq);
  attn::cp_async_wait<1>();  // the Q tile, not yet the first K/V tile
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    attn::ldsm_x4(qf[kk], attn::a_frag_addr<kStride>(qs, warp * 16, kk * 16, lane));
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t < t_hi) {
      const int ns = st ^ 1;
      attn::stage_rows<D, kTile>(ks + ns * kTile * kStride, k, cell, cell + 1,
                                 (t + 1) * kTile, seq);
      attn::stage_rows<D, kTile>(vs + ns * kTile * kStride, v, cell, cell + 1,
                                 (t + 1) * kTile, seq);
      stage_band_bias(bias + ns * kTile, mrow, (t + 1) * kTile, seq);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * kTile * kStride;
    const bf16* vt = vs + st * kTile * kStride;
    const float* bt = bias + st * kTile;

    // S = Q K^T over the tile's 64 keys
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        attn::ldsm_x4(b, attn::b_frag_addr<kStride>(kt, np * 16, kk * 16, lane));
        attn::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        attn::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, add the mask, less the row's mask offset; -inf off the band
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      const int key = t * kTile + col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int dist = row0 + r * 8 - (key + (e & 1));
        const float val = fmaf(s[nt][e], scale, bt[col + (e & 1)]) - moff;
        s[nt][e] = abs(dist) <= window ? val : -INFINITY;
        mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // a row with no key of its band seen yet keeps -inf; shift by 0 then
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][2 * r] *= alpha;
        o[i][2 * r + 1] *= alpha;
      }
    }
    // P = exp(S - max): fp32 sums, bf16 A fragments of P V
    uint32_t pf[kNT / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = __expf(s[nt][0] - m_use[0]);
      const float p1 = __expf(s[nt][1] - m_use[0]);
      const float p2 = __expf(s[nt][2] - m_use[1]);
      const float p3 = __expf(s[nt][3] - m_use[1]);
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
        attn::ldsm_x4_trans(b, attn::bt_frag_addr<kStride>(vt, j * 16, dp * 16, lane));
        attn::mma_bf16(o[2 * dp], pf[j], b[0], b[1]);
        attn::mma_bf16(o[2 * dp + 1], pf[j], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refilling
  }

  const size_t base = static_cast<size_t>(cell) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int pos = row0 + r * 8;
    if (pos < seq) {
      // the query itself is in its band, so l_run > 0
      const float inv = 1.f / l_run[r];
      uint32_t* orow = reinterpret_cast<uint32_t*>(out + (base + pos) * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        orow[i * 4 + (lane & 3)] =
            attn::pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int batch, int heads, int seq, int window,
           cudaStream_t stream) {
  constexpr int kSmem = band_smem_bytes<D>();
  static bool smem_set = false;
  const cudaError_t err =
      attn::allow_smem(attention_band_mma<D>, kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  attention_band_mma<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), heads, seq,
      window, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). bf16 only.
// The caller checks shapes, types and contiguity; this only refuses what it
// cannot dispatch. Nothing is synchronised.
extern "C" int dph_attention_band(const void* q, const void* k, const void* v,
                                  const float* mask, void* out, int batch,
                                  int heads, int seq, int head_dim, int window,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || window < 0 || window > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, mask, out, batch, heads, seq, window, s);
    case 32: return launch<32>(q, k, v, mask, out, batch, heads, seq, window, s);
    case 64: return launch<64>(q, k, v, mask, out, batch, heads, seq, window, s);
    case 128: return launch<128>(q, k, v, mask, out, batch, heads, seq, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
