// Fused bidirectional multi-head attention backward for the BERT towers.
//
// Replaces the Pallas TPU kernel densephrases_tpu/models/attention.py:
// _fused_attn_bwd_kernel (launched by attention_pallas_bwd, the backward of
// the custom VJP around attention_pallas). Same math, with P recomputed from
// (q, k, v, mask) in fp32:
//
//   S  = Q K^T / sqrt(D) + (1 - mask) * (-1e9),  P = softmax(S) (fp32)
//   dV = P^T G
//   dS = P o (G V^T - rowsum(G V^T o P)) / sqrt(D)
//   dQ = dS K,  dK = dS^T Q
//
// q, k, v, g, dq, dk, dv: [B, H, L, D] contiguous, fp32 or bf16 (outputs in
// q's dtype); mask: [B, L] fp32 (1 = keep). The additive -1e9 mask is kept
// as the reference has it, so a fully masked row has a uniform P and
// nonzero gradients, as there.
//
// What bounds it on an H100: the TPU kernel holds the whole [L, L] P in
// VMEM per (batch, head). At the phrase tower's L = 384 an fp32 P is 576 KB,
// far above a block's 227 KB of shared memory, so this kernel tiles and
// never holds P. It recomputes S instead: 9 D-long products per (query,
// key) pair against the TPU kernel's 5, all on the fp32 CUDA cores, so
// it is bound by FMAs (12 x 12 x 384 x 64 is ~24 GFLOP).
// What the design does about it, in two launches on one stream:
//   1. dq pass, one block per (batch*head, query tile): a first sweep over
//      the K/V tiles recomputes the row max m, the row sum and the fp32
//      output o with an online softmax, giving delta = g . o (which equals
//      rowsum(dP o P)); m, 1/sum and delta go to a [B*H, L, 3] scratch. A
//      second sweep recomputes P and dP tile by tile and sums dq.
//   2. dk/dv pass, one block per (batch*head, key tile): each thread holds a
//      key row's k, v, dk and dv; the Q and G tiles and the rows' stats are
//      staged in shared memory and every query row is swept once.
// Each output element is written by one thread: no atomics, and the result
// does not depend on the schedule. A row is split over D/16 threads that
// reduce their partial dot products with warp shuffles, as in
// attention_fwd.cu. Shared memory stays at 2 x 64 x D x 4 bytes (32 KB at
// D = 64). Tensor-core products (mma / wgmma) are later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDimsPerThread = 16;
constexpr float kMaskNeg = -1e9f;  // densephrases_tpu/models/attention.py:31

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Sum of a row's partial dot products over its kRowThreads lanes.
template <int kRowThreads>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// Stage rows [r0, r0 + kTile) of two [L, D] matrices as fp32 in shared
// memory; rows past the end are zero.
template <typename T, int D, int kTile>
__device__ __forceinline__ void stage_pair(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           float (*as)[D], float (*bs)[D],
                                           size_t base, int r0, int seq) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx % D;
    const int r = r0 + j;
    float av = 0.f, bv = 0.f;
    if (r < seq) {
      const size_t at = base + static_cast<size_t>(r) * D + d;
      av = to_float(a[at]);
      bv = to_float(b[at]);
    }
    as[j][d] = av;
    bs[j][d] = bv;
  }
}

// One K/V tile and its mask bias, between two barriers (every row is done
// with the previous tile before it is overwritten).
template <typename T, int D, int kKeys>
__device__ __forceinline__ void stage_keys(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ mrow,
                                           float (*ks)[D], float (*vs)[D],
                                           float* bias, size_t base, int k0,
                                           int seq) {
  __syncthreads();
  stage_pair<T, D, kKeys>(k, v, ks, vs, base, k0, seq);
  for (int j = threadIdx.x; j < kKeys; j += kThreads) {
    const int key = k0 + j;
    bias[j] = key < seq ? (1.f - mrow[key]) * kMaskNeg : 0.f;
  }
  __syncthreads();
}

// Pass 1: dq, and the per-row stats that pass 2 reads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ mask,
                            const T* __restrict__ g, T* __restrict__ dq,
                            float* __restrict__ stats, int heads, int seq,
                            float scale) {
  constexpr int kRowThreads = D / kDimsPerThread;
  constexpr int kRows = kThreads / kRowThreads;
  constexpr int kKeys = D <= 64 ? 64 : 32;
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

  float qr[kDimsPerThread], gr[kDimsPerThread], acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const size_t at = base + static_cast<size_t>(row) * D + i * kRowThreads + lane;
    qr[i] = row_ok ? to_float(q[at]) : 0.f;
    gr[i] = row_ok ? to_float(g[at]) : 0.f;
    acc[i] = 0.f;
  }

  // Sweep 1: the forward's online softmax, keeping the fp32 output.
  float run_max = -INFINITY;
  float run_sum = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    stage_keys<T, D, kKeys>(k, v, mrow, ks, vs, bias, base, k0, seq);
    const int n_keys = min(kKeys, seq - k0);
    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        part = fmaf(qr[i], ks[j][i * kRowThreads + lane], part);
      part = row_sum<kRowThreads>(part);
      // keys past the end do not exist (-inf); masked keys carry -1e9
      const float sj = j < n_keys ? fmaf(part, scale, bias[j]) : -INFINITY;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
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
  const float inv_sum = 1.f / run_sum;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) part = fmaf(gr[i], acc[i], part);
  const float delta = row_sum<kRowThreads>(part) * inv_sum;  // g . o
  if (row_ok && lane == 0) {
    float* st = stats + (static_cast<size_t>(bh) * seq + row) * 3;
    st[0] = run_max;
    st[1] = inv_sum;
    st[2] = delta;
  }

  // Sweep 2: dq = sum_j dS_ij k_j.
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    stage_keys<T, D, kKeys>(k, v, mrow, ks, vs, bias, base, k0, seq);
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
      const float p = __expf(fmaf(sp, scale, bias[j]) - run_max) * inv_sum;
      const float ds = p * (dp - delta) * scale;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(ds, ks[j][i * kRowThreads + lane], acc[i]);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      store(&dq[base + static_cast<size_t>(row) * D + i * kRowThreads + lane],
            acc[i]);
  }
}

// Pass 2: dk and dv, one key row per kRowThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ mask,
                             const T* __restrict__ g,
                             const float* __restrict__ stats,
                             T* __restrict__ dk, T* __restrict__ dv, int heads,
                             int seq, float scale) {
  constexpr int kRowThreads = D / kDimsPerThread;
  constexpr int kRows = kThreads / kRowThreads;
  constexpr int kQueries = D <= 64 ? 64 : 32;
  __shared__ float qs[kQueries][D];
  __shared__ float gs[kQueries][D];
  __shared__ float st[kQueries][3];  // m, 1/sum, delta of each query row

  const int bh = blockIdx.x;
  const int batch = bh / heads;
  const int lane = threadIdx.x % kRowThreads;
  const int key = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const bool key_ok = key < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const float bias =
      key_ok ? (1.f - mask[static_cast<size_t>(batch) * seq + key]) * kMaskNeg
             : 0.f;

  float kr[kDimsPerThread], vr[kDimsPerThread];
  float dk_acc[kDimsPerThread], dv_acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const size_t at = base + static_cast<size_t>(key) * D + i * kRowThreads + lane;
    kr[i] = key_ok ? to_float(k[at]) : 0.f;
    vr[i] = key_ok ? to_float(v[at]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += kQueries) {
    __syncthreads();
    stage_pair<T, D, kQueries>(q, g, qs, gs, base, q0, seq);
    for (int idx = threadIdx.x; idx < kQueries * 3; idx += kThreads) {
      const int r = q0 + idx / 3;
      st[idx / 3][idx % 3] =
          r < seq ? stats[(static_cast<size_t>(bh) * seq + q0) * 3 + idx] : 0.f;
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
          key_ok ? __expf(fmaf(sp, scale, bias) - st[i][0]) * st[i][1] : 0.f;
      const float ds = p * (dp - st[i][2]) * scale;
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
      store(&dk[at], dk_acc[t]);
      store(&dv[at], dv_acc[t]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const void* g, void* dq, void* dk, void* dv, float* stats,
           int batch, int heads, int seq, cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / kDimsPerThread);
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, mask, gt, static_cast<T*>(dq), stats, heads, seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, mask, gt, stats, static_cast<T*>(dk), static_cast<T*>(dv),
      heads, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v,
                 const float* mask, const void* g, void* dq, void* dk, void* dv,
                 float* stats, int batch, int heads, int seq, int head_dim,
                 cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, mask, g, dq, dk, dv, stats, batch, heads, seq, s);
    case 32: return launch<T, 32>(q, k, v, mask, g, dq, dk, dv, stats, batch, heads, seq, s);
    case 64: return launch<T, 64>(q, k, v, mask, g, dq, dk, dv, stats, batch, heads, seq, s);
    case 128: return launch<T, 128>(q, k, v, mask, g, dq, dk, dv, stats, batch, heads, seq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 = launched). stats
// is caller-allocated fp32 scratch of B * H * L * 3 floats. The caller
// checks shapes, types and contiguity; this only refuses what it cannot
// dispatch. Nothing is synchronised.
extern "C" int dph_attention_bwd(const void* q, const void* k, const void* v,
                                 const float* mask, const void* g, void* dq,
                                 void* dk, void* dv, float* stats, int batch,
                                 int heads, int seq, int head_dim, int is_bf16,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dim<__nv_bfloat16>(q, k, v, mask, g, dq, dk, dv, stats,
                                       batch, heads, seq, head_dim, s);
  return dispatch_dim<float>(q, k, v, mask, g, dq, dk, dv, stats, batch, heads,
                             seq, head_dim, s);
}
