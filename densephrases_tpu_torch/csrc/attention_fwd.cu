// Fused bidirectional multi-head attention forward for the BERT towers.
//
// Replaces the Pallas TPU kernel densephrases_tpu/models/attention.py:
// _fused_attn_kernel (launched by attention_pallas). Same math:
//
//   S = Q K^T / sqrt(D) + (1 - mask) * (-1e9),  softmax in fp32,  O = P V
//
// q, k, v, out: [B, H, L, D] contiguous, fp32 or bf16; mask: [B, L] fp32
// (1 = keep). The additive -1e9 mask is kept exactly as the reference has
// it (not -inf, and masked keys are not skipped), so a fully masked row --
// the dump's all-zero pad windows -- averages V uniformly, as there.
//
// What bounds it on an H100:
//   - serve path, L = 32 query towers: 64 queries x 12 heads = 768 cells
//     of ~0.26 MFLOP per launch, 24 launches per query batch (12 layers x
//     2 towers). Latency and launch count bound it, not FLOPs or bytes.
//   - dump path, L = 512 windows: 2*2*L*L*D = 67 MFLOP per cell, 192
//     cells at batch 16. Compute bounds it; this first version runs both
//     products on the fp32 CUDA cores, not on the tensor cores.
// What the design does about it:
//   - one block per (batch*head, 32-row query tile). At L = 32 the grid is
//     one tile deep with a single K/V pass, and the Q row, running max, sum
//     and output accumulators all live in registers;
//   - K/V tiles are staged once per block in shared memory as fp32 and read
//     as broadcasts by every query row of the block, so each K and V element
//     leaves device memory once per query tile;
//   - online softmax over the K/V tiles: any L works, ragged tails included,
//     and no L x L block is ever held. Shared memory is 2 * BK * D * 4 bytes,
//     32 KB at most.
// Tensor-core products (mma / wgmma) and TMA loads are later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// Each thread owns 16 of a query row's D dims (interleaved with its
// neighbours, so the threads of one row read consecutive shared words).
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ mask, T* __restrict__ out,
                         int heads, int seq, float scale) {
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

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int d = i * kRowThreads + lane;
    qr[i] = row_ok ? to_float(q[base + static_cast<size_t>(row) * D + d]) : 0.f;
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
        kv = to_float(k[at]);
        vv = to_float(v[at]);
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
      const float sj = j < n_keys ? part * scale + bias[j] : -INFINITY;
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
      store(&out[base + static_cast<size_t>(row) * D + d], acc[i] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int batch, int heads, int seq, cudaStream_t stream) {
  constexpr int kRows = kThreads / (D / kDimsPerThread);
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), heads, seq,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v,
                 const float* mask, void* out, int batch, int heads, int seq,
                 int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, mask, out, batch, heads, seq, stream);
    case 32: return launch<T, 32>(q, k, v, mask, out, batch, heads, seq, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, batch, heads, seq, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, batch, heads, seq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks shapes, types and contiguity; this only refuses what it cannot
// dispatch. Nothing is synchronised.
extern "C" int dph_attention_fwd(const void* q, const void* k, const void* v,
                                 const float* mask, void* out, int batch,
                                 int heads, int seq, int head_dim, int is_bf16,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dim<__nv_bfloat16>(q, k, v, mask, out, batch, heads, seq,
                                       head_dim, s);
  return dispatch_dim<float>(q, k, v, mask, out, batch, heads, seq, head_dim, s);
}
