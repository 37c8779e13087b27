// Kernel D: PQ / OPQ asymmetric-distance scores of a query batch against
// the IVF code rows that a 32-row block table names (the packed PQ scan).
//
// Replaces the Pallas TPU kernel densephrases_tpu/ops/ivf_pack.py:
// _pq_pack_score_kernel (launched by _pq_pack_score). Same math:
//
//   raw[b, j*32 + r] = sum_m LUT[b, m, code[blk[j]*32 + r, m]]
//
// lut: [n_q, M, ksub] bf16 in its natural layout; codes: [n_rows,
// code_bytes] uint8, n_rows % 32 == 0, the last 32-row block all zeros
// (pad_blk). 8-bit: ksub = 256, one byte a subspace (code_bytes == M).
// 4-bit: ksub = 16, byte i holds subspace 2i in its low nibble and 2i+1 in
// its high nibble (code_bytes == M/2). blk: [budget] int32, budget % 8 ==
// 0, junk entries (== pad_blk) form a suffix; out: [n_q, budget*32] fp32.
// Tiles from the first all-junk one on are left unwritten; the caller masks
// those columns.
//
// What bounds it on an H100: at the serve shape (128 stacked queries,
// OPQ96 or OPQ192x4, 443,040 gathered rows) the code rows are only ~42 MB,
// but every (query, row) pair costs M lookups: 5.4e9 (8-bit) or 1.1e10
// (4-bit). The 8-bit path is bound by shared-memory gathers and their bank
// conflicts; the 4-bit path runs the lookups as products on the tensor
// cores, 3.5e14 bf16 operations.
//
// 8-bit design (pq_scan8): the block's BQ queries' LUTs sit in shared
// memory query-minor, [M][256][BQ] bf16, re-laid by the block as it loads
// them, so a code byte names one contiguous BQ-vector: one 8-byte load
// (BQ = 4) replaces four 2-byte ones and a bank conflict costs once per
// vector. 1,024 threads (32 warps) a block, one code row a thread; a warp
// takes one 32-row block-table entry at a time, reads its rows' code bytes
// straight into registers with VEC-byte loads (VEC = 16, 4 or 1 by the row
// width) and prefetches the next chunk of the row behind the current
// chunk's gathers. No code tile in shared memory and no barrier after the
// LUT is loaded.
//
// 4-bit design (pq_scan4): the TPU kernel's one-hot product in Hopper form.
// For subspace m, the A operand of mma.sync.m16n8k16 (bf16, fp32
// accumulation) is the one-hot of 16 rows' nibbles over the 16 codes (k =
// code), built in registers with one funnel shift per bf16 pair; the B
// operand is LUT[queries, m, 0:16] from shared memory via ldmatrix (the
// natural layout is B's own [n][k] layout; a 16-byte pad per query row
// keeps ldmatrix free of bank conflicts). Each row has one non-zero per
// k-block, so every product is an exact LUT entry and the result is the
// plain twin's fp32 sum in another order. A warp takes a 32-row entry (two
// m16 tiles) against the block's BQ = 16 or 32 queries; one A fragment
// serves every 8-query n-tile and one B fragment both row tiles. 16 warps
// a block. Measured at M = 192 (PERF.md): the 8-bit path's vector gathers
// from a [M][16][8] LUT took 1.30 ms against this design's 0.85; four m16
// tiles a warp (halving the ldmatrix reads) 0.91 against two tiles' 0.83.
//
// 8-bit with the select fused (pq_scan8_topk, entry dph_pq_scan_topk): the
// scores above, finished in registers and never written. At the serve shape
// the block table covers every list (the guard budget), so the unfused path
// writes a [128, 8.4M] fp32 matrix of which 12-16% are real rows, and the
// select after it (the residual gather, the mask, a stable sort) cost about
// ten times D's own time. Here a lane adds its row's residual base
// q_raw . c_l (l from a per-row list id, the base from a [n_q, nlist] table
// in L2) to each query's sum, drops rows at or past n_real, and offers the
// score to the block's list for that query: the tile's k best (score,
// packed column) pairs, ties to the lower column (ops/topk.topk's rule), k
// up to 64, two slots a lane. As in kernel E (flat_scan_topk.cu), a cheap
// test comes first: each query's k-th pair is one 64-bit word in shared
// memory, read without a lock and compared once a warp round (one vote a
// query); only rows above it take the query's lock and go in by ballot and
// shuffle. Few do: a list's k-th rises fast, k (1 + ln(rows / k)) of a
// tile's rows a query in a random order. Tiles are equal contiguous runs of
// the real entries (the device count total, read by the kernel), one block
// each, one wave over the SMs; the [n_q, tiles, k] lists are ~160 KB at the
// serve shape and one stable top-k over them (ops/ivf_pack.py) finishes the
// select.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "attention_tiles.cuh"  // mma_bf16, ldsm_x4, cp_async16
#include "ivf_tiles.cuh"

namespace {

using ivf::bf16;
using ivf::kRB;

constexpr int kThreads8 = 1024;  // 8-bit: 32 warps, one row a thread
constexpr int kThreads4 = 512;   // 4-bit: 16 warps, 32 rows a warp
constexpr int kPad4 = 8;         // bf16 of padding per query row (4-bit)
constexpr int kMaxK = 64;        // fused select: two list slots a lane
constexpr unsigned kAll = 0xffffffffu;

// ------------------------------------------------------------------ 8-bit
// Two bf16 (the halves of w, the first in the low half) added in fp32.
__device__ __forceinline__ void add_pair(float* acc, uint32_t w) {
  acc[0] += __uint_as_float(w << 16);
  acc[1] += __uint_as_float(w & 0xFFFF0000u);
}

// acc[0:BQ] += the BQ-vector at element e of the query-minor LUT.
template <int BQ>
__device__ __forceinline__ void gather_add(float* acc, const bf16* lut_s,
                                           int e) {
  if constexpr (BQ == 1) {
    acc[0] += __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(lut_s)[e])
        << 16);
  } else if constexpr (BQ == 2) {
    add_pair(acc, reinterpret_cast<const uint32_t*>(lut_s)[e]);
  } else if constexpr (BQ == 4) {
    const uint2 v = reinterpret_cast<const uint2*>(lut_s)[e];
    add_pair(acc, v.x);
    add_pair(acc + 2, v.y);
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(lut_s)[e];
    add_pair(acc, v.x);
    add_pair(acc + 2, v.y);
    add_pair(acc + 4, v.z);
    add_pair(acc + 6, v.w);
  }
}

// Store BQ bf16 (packed two a word, the first query in the low half) as
// the vector at element e of the query-minor LUT.
template <int BQ>
__device__ __forceinline__ void store_vec(bf16* lut_s, int e,
                                          const uint32_t* p) {
  if constexpr (BQ == 1) {
    reinterpret_cast<uint16_t*>(lut_s)[e] = static_cast<uint16_t>(p[0]);
  } else if constexpr (BQ == 2) {
    reinterpret_cast<uint32_t*>(lut_s)[e] = p[0];
  } else if constexpr (BQ == 4) {
    reinterpret_cast<uint2*>(lut_s)[e] = make_uint2(p[0], p[1]);
  } else {
    reinterpret_cast<uint4*>(lut_s)[e] = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// The group's natural-layout LUTs [BQ][M][256] into shared memory as
// [M][256][BQ]: a thread reads 8 codes of one subspace for each query (16
// bytes each) and writes 8 BQ-vectors. Queries past n_q read as zeros.
template <int BQ>
__device__ void load_lut_query_minor(bf16* lut_s, const bf16* lut, int q0,
                                     int n_q, int m) {
  const int runs = m * 256 / 8;
  for (int i = threadIdx.x; i < runs; i += blockDim.x) {
    uint4 v[BQ];
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb) {
      v[qb] = make_uint4(0, 0, 0, 0);
      if (q0 + qb < n_q)
        v[qb] = __ldg(reinterpret_cast<const uint4*>(
                          lut + static_cast<size_t>(q0 + qb) * m * 256) +
                      i);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t p[BQ > 1 ? BQ / 2 : 1] = {};
#pragma unroll
      for (int qb = 0; qb < BQ; ++qb) {
        const uint32_t w = (j >> 1) == 0   ? v[qb].x
                           : (j >> 1) == 1 ? v[qb].y
                           : (j >> 1) == 2 ? v[qb].z
                                           : v[qb].w;
        const uint32_t h = (w >> (16 * (j & 1))) & 0xFFFFu;
        p[qb >> 1] |= h << (16 * (qb & 1));
      }
      store_vec<BQ>(lut_s, i * 8 + j, p);
    }
  }
}

// acc[0:BQ] = the ADC sums of one code row of m bytes (m / VEC chunks)
// against the block's BQ query-minor LUTs, each chunk's gathers behind the
// next chunk's load.
template <int BQ, int VEC>
__device__ __forceinline__ void adc_row(float (&acc)[BQ], const bf16* lut_s,
                                        const uint8_t* row, int chunks) {
#pragma unroll
  for (int qb = 0; qb < BQ; ++qb) acc[qb] = 0.f;
  ivf::Chunk<VEC> cur = ivf::load_chunk<VEC>(row);
  for (int c = 0; c < chunks; ++c) {
    ivf::Chunk<VEC> nxt = ivf::zero_chunk<VEC>();
    if (c + 1 < chunks) nxt = ivf::load_chunk<VEC>(row + (c + 1) * VEC);
    const int base = c * VEC * 256;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      gather_add<BQ>(acc, lut_s, base + i * 256 + ivf::chunk_byte(cur, i));
    cur = nxt;
  }
}

template <int BQ, int VEC>
__global__ void __launch_bounds__(kThreads8, 1)
    pq_scan8(const bf16* __restrict__ lut, const uint8_t* __restrict__ codes,
             const int* __restrict__ blk, float* __restrict__ out, int n_q,
             int m, int pad_blk, int n_entries, int n_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* lut_s = reinterpret_cast<bf16*>(smem);
  const int q0 = blockIdx.y * BQ;
  load_lut_query_minor<BQ>(lut_s, lut, q0, n_q, m);
  __syncthreads();

  constexpr int kWarps = kThreads8 / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = m / VEC;  // code_bytes == m, a multiple of VEC
  for (int e = blockIdx.x * kWarps + warp; e < n_entries;
       e += gridDim.x * kWarps) {
    if (ivf::junk_tile(blk, e, pad_blk)) break;
    float acc[BQ];
    adc_row<BQ, VEC>(
        acc, lut_s,
        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + lane) * m,
        chunks);
    const size_t col = static_cast<size_t>(e) * kRB + lane;
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb)
      if (q0 + qb < n_q) out[static_cast<size_t>(q0 + qb) * n_cols + col] = acc[qb];
  }
}

// ------------------------------------------------- 8-bit, fused select
// A block's lists in shared memory: for each of its BQ queries the k best
// (score, packed column) pairs of its tile so far, best first, and the k-th
// pair packed in one 64-bit word (score bits low, column high), so a warp
// reads it whole without the lock.
struct Lists {
  float* v;                 // [BQ][k] scores (-inf: an empty slot)
  int* col;                 // [BQ][k] their packed columns (INT_MAX: empty)
  unsigned long long* kth;  // [BQ] the k-th pair
  int* lock;                // [BQ] 1 while a warp holds the query's list
};

__device__ __forceinline__ unsigned long long pack_pair(float v, int c) {
  return static_cast<unsigned long long>(__float_as_uint(v)) |
         (static_cast<unsigned long long>(static_cast<uint32_t>(c)) << 32);
}

// (s, c) ranks above (v, i): a higher score, or the same and a lower
// column; ops/topk.topk's order over the packed columns.
__device__ __forceinline__ bool beats(float s, int c, float v, int i) {
  return s > v || (s == v && c < i);
}

// Under query qi's lock, the warp inserts the pairs (s, c) of the lanes
// with hit set that rank above the list's k-th, one at a time. The list
// sits in registers two slots a lane (slot j: set j / 32, lane j % 32); a
// ballot finds a pair's place and shuffles shift the slots behind it. All
// 32 lanes call.
__device__ __noinline__ void insert(Lists L, int qi, int k, float s, int c,
                                    bool hit) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    while (atomicCAS(L.lock + qi, 0, 1) != 0) __nanosleep(64);
  __syncwarp();
  __threadfence_block();
  volatile float* lv = L.v + qi * k;
  volatile int* lc = L.col + qi * k;
  const bool two = k > 32;
  const int kl = (k - 1) & 31;  // the k-th slot's lane
  float v0 = -INFINITY, v1 = -INFINITY;
  int i0 = INT_MAX, i1 = INT_MAX;
  if (lane < k) {
    v0 = lv[lane];
    i0 = lc[lane];
  }
  if (lane + 32 < k) {
    v1 = lv[lane + 32];
    i1 = lc[lane + 32];
  }
  float kv = __shfl_sync(kAll, two ? v1 : v0, kl);
  int ki = __shfl_sync(kAll, two ? i1 : i0, kl);
  bool pend = hit && beats(s, c, kv, ki);
  const bool changed = __any_sync(kAll, pend);
  for (;;) {
    const unsigned b = __ballot_sync(kAll, pend);
    if (b == 0) break;
    const int src = __ffs(b) - 1;
    const float ps = __shfl_sync(kAll, s, src);
    const int pc = __shfl_sync(kAll, c, src);
    if (lane == src) pend = false;
    // the pair ranks above the k-th, so it takes the first slot it beats
    const unsigned b0 = __ballot_sync(kAll, lane < k && beats(ps, pc, v0, i0));
    int pos = __ffs(b0) - 1;
    if (two) {
      const unsigned b1 =
          __ballot_sync(kAll, lane + 32 < k && beats(ps, pc, v1, i1));
      if (b0 == 0) pos = 32 + __ffs(b1) - 1;
      float pv1 = __shfl_up_sync(kAll, v1, 1);
      int pi1 = __shfl_up_sync(kAll, i1, 1);
      const float t = __shfl_sync(kAll, v0, 31);  // slot 31 moves to 32
      const int ti = __shfl_sync(kAll, i0, 31);
      if (lane == 0) {
        pv1 = t;
        pi1 = ti;
      }
      if (lane + 32 == pos) {
        v1 = ps;
        i1 = pc;
      } else if (lane + 32 > pos) {
        v1 = pv1;
        i1 = pi1;
      }
    }
    const float pv0 = __shfl_up_sync(kAll, v0, 1);
    const int pi0 = __shfl_up_sync(kAll, i0, 1);
    if (lane == pos) {
      v0 = ps;
      i0 = pc;
    } else if (lane > pos) {
      v0 = pv0;
      i0 = pi0;
    }
    kv = __shfl_sync(kAll, two ? v1 : v0, kl);
    ki = __shfl_sync(kAll, two ? i1 : i0, kl);
    if (pend && !beats(s, c, kv, ki)) pend = false;
  }
  if (changed) {
    if (lane < k) {
      lv[lane] = v0;
      lc[lane] = i0;
    }
    if (lane + 32 < k) {
      lv[lane + 32] = v1;
      lc[lane + 32] = i1;
    }
    if (lane == 0)
      static_cast<volatile unsigned long long*>(L.kth)[qi] = pack_pair(kv, ki);
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(L.lock + qi, 0);
}

// Kernel D's 8-bit path with the select in its epilogue. Block (x, y) is
// tile x of query group y: an equal share of the batch's real entries
// (those before *total), a contiguous run, so the tiles follow the packed
// columns in order. Its 32 warps walk the run an entry at a time; a lane
// scores its row as pq_scan8 does, then adds each query's residual base
// base[q, row_list[row]] (when base is given) and offers the score to the
// query's list if its row is real (< n_real) and it ranks above the list's
// k-th as last read. Only the lists are written: out_v / out_c [n_q, tiles,
// k], best first; empty slots -inf and -1.
template <int BQ, int VEC>
__global__ void __launch_bounds__(kThreads8, 1)
    pq_scan8_topk(const bf16* __restrict__ lut,
                  const uint8_t* __restrict__ codes,
                  const int* __restrict__ blk,
                  const long long* __restrict__ total_p,
                  const float* __restrict__ base,
                  const int* __restrict__ row_list, float* __restrict__ out_v,
                  int* __restrict__ out_c, int n_q, int m, int pad_blk,
                  int budget, int n_real, int base_stride, int k, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* lut_s = reinterpret_cast<bf16*>(smem);
  float* f = reinterpret_cast<float*>(smem + static_cast<size_t>(BQ) * m *
                                                 256 * sizeof(bf16));
  const Lists L{f, reinterpret_cast<int*>(f + BQ * k),
                reinterpret_cast<unsigned long long*>(f + 2 * BQ * k),
                reinterpret_cast<int*>(f + 2 * BQ * k + 2 * BQ)};
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, n_q - q0);
  load_lut_query_minor<BQ>(lut_s, lut, q0, n_q, m);
  for (int i = threadIdx.x; i < BQ * k; i += blockDim.x) {
    L.v[i] = -INFINITY;
    L.col[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    L.kth[i] = pack_pair(-INFINITY, INT_MAX);
    L.lock[i] = 0;
  }
  __syncthreads();

  constexpr int kWarps = kThreads8 / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = m / VEC;
  const int total = static_cast<int>(
      min(max(__ldg(total_p), 0LL), static_cast<long long>(budget)));
  const int per = (total + tiles - 1) / tiles;
  const int e1 = min(total, (blockIdx.x + 1) * per);
  for (int e = blockIdx.x * per + warp; e < e1; e += kWarps) {
    const int row = ivf::entry_row0(blk, e, pad_blk) + lane;
    float b[BQ];
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb) b[qb] = 0.f;
    if (base != nullptr) {
      const float* bl = base + __ldg(row_list + row);
#pragma unroll
      for (int qb = 0; qb < BQ; ++qb)
        if (qb < nq)
          b[qb] = __ldg(bl + static_cast<size_t>(q0 + qb) * base_stride);
    }
    float acc[BQ];
    adc_row<BQ, VEC>(acc, lut_s, codes + static_cast<size_t>(row) * m,
                     chunks);
    const bool real = row < n_real;
    const int col = e * kRB + lane;
#pragma unroll
    for (int qb = 0; qb < BQ; ++qb) {
      if (qb >= nq) break;
      const float s = base != nullptr ? acc[qb] + b[qb] : acc[qb];
      const unsigned long long kp =
          static_cast<const volatile unsigned long long*>(L.kth)[qb];
      const bool hit =
          real && beats(s, col, __uint_as_float(static_cast<uint32_t>(kp)),
                        static_cast<int>(kp >> 32));
      if (__any_sync(kAll, hit)) insert(L, qb, k, s, col, hit);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nq * k; i += blockDim.x) {
    const size_t o =
        (static_cast<size_t>(q0 + i / k) * tiles + blockIdx.x) * k + i % k;
    out_v[o] = L.v[i];
    out_c[o] = L.col[i] == INT_MAX ? -1 : L.col[i];
  }
}

// ------------------------------------------------------------------ 4-bit
// A bf16 pair of the one-hot of a nibble over codes k and k+1, from s = 16
// (nibble - k) as an unsigned shift: 1.0 (0x3F80) in the low half when s is
// 0, in the high half when s is 16, else 0. One funnel shift: the high word
// of {0x3F80 : 0} << min(s, 32); a negative difference wraps to a shift
// past 32, which clamps to 32 and gives 0.
__device__ __forceinline__ uint32_t onehot2(uint32_t s) {
  return __funnelshift_lc(0u, 0x3F80u, s);
}

template <int NT, int VEC>
__global__ void __launch_bounds__(kThreads4, 1)
    pq_scan4(const bf16* __restrict__ lut, const uint8_t* __restrict__ codes,
             const int* __restrict__ blk, float* __restrict__ out, int n_q,
             int m, int pad_blk, int n_entries, int n_cols) {
  static_assert(NT % 2 == 0, "n-tiles are read two at a time by ldmatrix");
  constexpr int BQ = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* lut_s = reinterpret_cast<bf16*>(smem);
  const int stride = m * 16 + kPad4;  // bf16 per query row
  const int q0 = blockIdx.y * BQ;
  {
    const int vecs = m * 2;  // 16-byte vectors per query's LUT
    for (int i = threadIdx.x; i < BQ * vecs; i += blockDim.x) {
      const int qb = i / vecs, v = i % vecs;
      const bool ok = q0 + qb < n_q;
      attn::cp_async16(lut_s + qb * stride + 8 * v,
                       ok ? lut + (static_cast<size_t>(q0 + qb) * m * 2 + v) * 8
                          : lut,
                       ok);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
  }
  __syncthreads();

  constexpr int kWarps = kThreads4 / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t g = lane >> 2, t2 = 2 * (lane & 3), t32 = 16 * t2;
  const int code_bytes = m / 2;
  const int chunks = code_bytes / VEC;
  // ldmatrix.x4 rows: (queries 0-7, codes 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15) of a pair of n-tiles and one subspace
  const bf16* b_lane =
      lut_s + ((lane & 7) + (lane >> 4) * 8) * stride + ((lane >> 3) & 1) * 8;
  for (int e = blockIdx.x * kWarps + warp; e < n_entries;
       e += gridDim.x * kWarps) {
    if (ivf::junk_tile(blk, e, pad_blk)) break;
    const uint8_t* rows =
        codes + static_cast<size_t>(ivf::entry_row0(blk, e, pad_blk) + g) *
                    code_bytes;
    // slot s: row g + 8 s of the entry; m-tile mt takes slots 2 mt (row g)
    // and 2 mt + 1 (row g + 8)
    ivf::Chunk<VEC> cur[4], nxt[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      cur[s] = ivf::load_chunk<VEC>(rows + 8 * s * code_bytes);
    float acc[2][NT][4] = {};
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        nxt[s] = ivf::zero_chunk<VEC>();
        if (c + 1 < chunks)
          nxt[s] = ivf::load_chunk<VEC>(rows + 8 * s * code_bytes +
                                        (c + 1) * VEC);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        uint32_t byte[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) byte[s] = ivf::chunk_byte(cur[s], i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // low nibble: subspace 2i, high: 2i+1
          const int sub = 2 * (c * VEC + i) + h;
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // 16 x nibble of row g (lo) and row g + 8 (hi), less 16 x 2t
            const uint32_t lo = (h ? byte[2 * mt] : byte[2 * mt] << 4) & 0xF0u;
            const uint32_t hi =
                (h ? byte[2 * mt + 1] : byte[2 * mt + 1] << 4) & 0xF0u;
            a[mt][0] = onehot2(lo - t32);
            a[mt][1] = onehot2(hi - t32);
            a[mt][2] = onehot2(lo - t32 - 128u);  // codes 8 + 2t, 9 + 2t
            a[mt][3] = onehot2(hi - t32 - 128u);
          }
#pragma unroll
          for (int np = 0; np < NT; np += 2) {
            uint32_t b[4];
            attn::ldsm_x4(b, b_lane + np * 8 * stride + sub * 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              attn::mma_bf16(acc[mt][np], a[mt], b[0], b[1]);
              attn::mma_bf16(acc[mt][np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) cur[s] = nxt[s];
    }
    // C fragment: (row g, queries 2t, 2t+1) and (row g + 8, the same)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const size_t col = static_cast<size_t>(e) * kRB + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int q = q0 + nt * 8 + static_cast<int>(t2);
        if (q < n_q) {
          out[static_cast<size_t>(q) * n_cols + col] = acc[mt][nt][0];
          out[static_cast<size_t>(q) * n_cols + col + 8] = acc[mt][nt][2];
        }
        if (q + 1 < n_q) {
          out[static_cast<size_t>(q + 1) * n_cols + col] = acc[mt][nt][1];
          out[static_cast<size_t>(q + 1) * n_cols + col + 8] = acc[mt][nt][3];
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int bq, const void* lut,
           const void* codes, const int* blk, float* out, int n_q, int m,
           int budget, int n_rows, cudaStream_t stream) {
  cudaError_t err = ivf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_q + bq - 1) / bq;
  int gx = 1;
  err = ivf::resident_grid_x(kernel, threads, smem, groups, threads / 32,
                             budget, &gx);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(gx, groups), threads, smem, stream>>>(
      static_cast<const bf16*>(lut), static_cast<const uint8_t*>(codes), blk,
      out, n_q, m, n_rows / kRB - 1, budget, budget * kRB);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch(int bq, int ksub, const void* lut, const void* codes,
             const int* blk, float* out, int n_q, int m, int budget,
             int n_rows, cudaStream_t s) {
  if (ksub == 16) {
    const size_t smem = static_cast<size_t>(bq) * (m * 16 + kPad4) * 2;
    if (smem > ivf::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    switch (bq) {
      case 16: return launch(pq_scan4<2, VEC>, kThreads4, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
      case 32: return launch(pq_scan4<4, VEC>, kThreads4, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t smem = static_cast<size_t>(bq) * m * 256 * 2;
  if (smem > ivf::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  switch (bq) {
    case 1: return launch(pq_scan8<1, VEC>, kThreads8, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    case 2: return launch(pq_scan8<2, VEC>, kThreads8, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    case 4: return launch(pq_scan8<4, VEC>, kThreads8, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    case 8: return launch(pq_scan8<8, VEC>, kThreads8, smem, bq, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Kernel>
int launch_topk(Kernel kernel, size_t smem, int bq, const void* lut,
                const void* codes, const int* blk, const long long* total,
                const float* base, const int* row_list, float* out_v,
                int* out_c, int n_q, int m, int budget, int n_rows,
                int n_real, int base_stride, int k, int tiles,
                cudaStream_t stream) {
  cudaError_t err = ivf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_q + bq - 1) / bq;
  kernel<<<dim3(tiles, groups), kThreads8, smem, stream>>>(
      static_cast<const bf16*>(lut), static_cast<const uint8_t*>(codes), blk,
      total, base, row_list, out_v, out_c, n_q, m, n_rows / kRB - 1, budget,
      n_real, base_stride, k, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_topk(int bq, const void* lut, const void* codes, const int* blk,
                  const long long* total, const float* base,
                  const int* row_list, float* out_v, int* out_c, int n_q,
                  int m, int budget, int n_rows, int n_real, int base_stride,
                  int k, int tiles, cudaStream_t s) {
  // the LUTs, then each query's list, k-th pair and lock
  const size_t smem = static_cast<size_t>(bq) *
                      (static_cast<size_t>(m) * 256 * 2 + 8 * k + 12);
  if (smem > ivf::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
#define DPH_D(BQ)                                                          \
  return launch_topk(pq_scan8_topk<BQ, VEC>, smem, bq, lut, codes, blk,    \
                     total, base, row_list, out_v, out_c, n_q, m, budget,  \
                     n_rows, n_real, base_stride, k, tiles, s)
  switch (bq) {
    case 1: DPH_D(1);
    case 2: DPH_D(2);
    case 4: DPH_D(4);
    case 8: DPH_D(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DPH_D
}

}  // namespace

// Returns a CUDA error code (0 = launched). The caller checks devices,
// types, shapes, contiguity and alignment and picks bq (queries per block:
// 1, 2, 4 or 8 for ksub 256; 16 or 32 for ksub 16) and vec (bytes per code
// load: 16, 4 or 1, dividing code_bytes and the codes' address) with
// ops/ivf_pack.py:pq_plan; this only refuses what it cannot dispatch.
// Nothing is synchronised.
extern "C" int dph_pq_pack_score(const void* lut, const void* codes,
                                 const int* blk, float* out, int n_q, int m,
                                 int ksub, int code_bytes, int budget,
                                 int n_rows, int bq, int vec, void* stream) {
  const bool nib = ksub == 16;
  if (n_q <= 0 || budget <= 0 || budget % ivf::kTPB || n_rows < kRB ||
      n_rows % kRB || !(ksub == 16 || ksub == 256) ||
      code_bytes != (nib ? m / 2 : m) || (nib && m % 2) || code_bytes <= 0 ||
      code_bytes % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return dispatch<16>(bq, ksub, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    case 4: return dispatch<4>(bq, ksub, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    case 1: return dispatch<1>(bq, ksub, lut, codes, blk, out, n_q, m, budget, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel D's 8-bit path with the select fused (pq_scan8_topk). lut, codes,
// blk, bq and vec as for dph_pq_pack_score with ksub 256 (bq from
// ops/ivf_pack.py:pq_topk_plan, which counts the lists' shared memory);
// total: the device int64 count of the table's real entries; base
// (optional, with row_list): [n_q, base_stride] fp32 residual bases by
// list, row_list [n_rows] int32 each code row's list; out_v / out_c: [n_q,
// tiles, k] fp32 and int32. Returns a CUDA error code (0 = launched);
// nothing is synchronised.
extern "C" int dph_pq_scan_topk(const void* lut, const void* codes,
                                const int* blk, const long long* total,
                                const float* base, const int* row_list,
                                float* out_v, int* out_c, int n_q, int m,
                                int budget, int n_rows, int n_real,
                                int base_stride, int k, int tiles, int bq,
                                int vec, void* stream) {
  if (n_q <= 0 || m <= 0 || budget <= 0 || budget % ivf::kTPB ||
      n_rows < kRB || n_rows % kRB || k < 1 || k > kMaxK || tiles < 1 ||
      vec <= 0 || m % vec || (base == nullptr) != (row_list == nullptr) ||
      (base != nullptr && base_stride <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DPH_V(V)                                                          \
  return dispatch_topk<V>(bq, lut, codes, blk, total, base, row_list,     \
                          out_v, out_c, n_q, m, budget, n_rows, n_real,   \
                          base_stride, k, tiles, s)
  switch (vec) {
    case 16: DPH_V(16);
    case 4: DPH_V(4);
    case 1: DPH_V(1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DPH_V
}
