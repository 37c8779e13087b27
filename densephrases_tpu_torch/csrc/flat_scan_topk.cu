// Kernel E: the flat int8 scan of a query batch, keeping for each tile of
// code rows each query's exact top-k.
//
// Replaces no Pallas kernel. The reference's flat scan
// (densephrases_tpu/index/flat.py:103-140) is XLA: a loop over corpus
// chunks, each an int8 product and a per-chunk top-k, that the TPU compiles
// into one program. Run as PyTorch operations on the card it is a Python
// loop of 13 launches a chunk (245 chunks at 1M rows), so the host's
// launches, not the card, set its time. This kernel is the whole scan in
// one launch; one merge of the tiles' lists (ops/topk.topk) follows it.
//
// Same math as its plain twin (index/flat.py:_chunked_topk):
//
//   raw[b, r]   = sum_d bf16(q[b, d]) * code[r, d]
//   score[b, r] = raw[b, r] / scale + offset * qsum[b]  for r < n_valid,
//                 -1e30 (the padding score)             for r >= n_valid,
//
// q: [n_q, dim] fp32, rounded to bf16 (to nearest, ties to even, as
// torch's .to(torch.bfloat16)) as the block loads it; codes: [n_rows, dim]
// int8; qsum: [n_q] fp32, the sum of each fp32 query row, which the kernel
// multiplies by offset (rounded to nearest, as the twin's sum * offset).
// out_v / out_i: [n_q, tiles, k] fp32 scores and int32 rows: tile j's k
// best rows of each query, best first, ties to the lower row; slots past a
// tile's rows hold -inf and -1.
// Only the summation order of raw differs from the twin's fp32 product:
// bf16 x int8 products are exact in fp32 and summed in fp32. At the serve
// shape E measured 1.41 ms on an H100 (16% of the bound below), of which
// the products and the floor filter take 0.73 ms.
//
// What bounds it on an H100: at the serve shape (128 stacked query rows,
// 1M rows of 768 dims, k 10) it reads 0.77 GB of codes once (~0.23 ms at
// 3.35 TB/s) and does 2.0e11 bf16 operations (~0.2 ms at 989 TFLOP/s), so
// both bounds are near: the products must run on the tensor cores, every
// code row must leave device memory once for all the batch's queries, and
// no score may go back to device memory (the [128, 1M] fp32 scores alone
// are 0.5 GB).
//
// Design:
//   - The products are kernel C's (ivf_pack_score.cu): mma.sync.m16n8k16,
//     bf16 operands, fp32 accumulation; a lane reads 8 code bytes of each
//     of its rows straight from device memory and converts them exactly to
//     bf16 in registers (ivf_tiles.cuh); the batch's queries, up to 128 (NT
//     = 16 n-tiles of 8), stay in shared memory for the block's life, and
//     each of the 8 warps scores 32 contiguous rows against all of them at a
//     time, 2 chunks of codes in flight ahead of the products. Past 128
//     queries, more query groups along grid y.
//   - The query bank is swizzled, not padded: the 16-byte unit u of query
//     row r sits at unit u ^ 4 (r & 1), so the two rows a quarter warp's
//     16-byte B loads touch fall in the two halves of the banks. Rows are
//     whole multiples of 64 dims, so at 768 dims the bank is 192 KB and the
//     lists fit beside it, k up to 32.
//   - One block a tile of consecutive rows; the wrapper sizes the tiles so
//     that the grid is one wave of one block an SM (ops/flat_scan.py:
//     flat_scan_plan). A block keeps, in shared memory, each query's sorted
//     list of the tile's k best (score, row) pairs, and writes only the
//     lists: [B, tiles, k], ~1.3 MB at the serve shape.
//   - A list's k-th score rises fast, so few rows enter it: at the serve
//     shape ~76 a query a tile of 7,680 rows, k (1 + ln(rows / k)), most in
//     the first rows. Beside the k-th score each query keeps a raw floor: a
//     raw sum below which the score is below the k-th for certain, with a
//     margin for the division's and the addition's roundings (raw_floor).
//     After its 32 rows a warp compares each lane's 4 raw sums of a query
//     with the floor (3 max, 1 compare, 1 vote a query pair), so the
//     division and the list are touched for the few rows above it.
//   - The rows above it are inserted by their warp, one at a time. The
//     list sits one slot a lane; a row goes in by a ballot (its place) and
//     a shuffle (the shift). (A bitonic sort and merge of 6 or more pending
//     rows at once measured 0.13-0.25 ms slower at k 1, 10 and 32.) The
//     order is the score, then the lower row, so ties go to the lower row
//     as in ops/topk.topk and the reference's lax.top_k. A list has one
//     writer at a time: in a tile's first round of 8 x 32 rows, where every
//     warp's rows enter every list, by 8 phases with a barrier after each
//     (in phase i warp w owns n-tiles (w + i) mod 8); later, where few rows
//     enter, by a lock a query, taken with backoff and held for one
//     insertion call, the warps starting on different queries. Locks alone made the warps queue behind each other
//     in the first round, and phases alone made each later phase wait for
//     its one busy warp (both measured about 1.5 ms more at the serve shape).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes (densephrases_tpu_torch/utils/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "attention_tiles.cuh"  // mma_bf16
#include "ivf_tiles.cuh"

namespace {

using ivf::bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // rows a warp scores at a time
constexpr int kMaxK = 32;      // one list slot a lane
constexpr int kDepth = 2;      // code chunks in flight ahead of the products
constexpr float kNegInf = -1e30f;  // a padding row's score (index/flat.py)
constexpr unsigned kAll = 0xffffffffu;

// A block's lists and per-query state in shared memory, bq queries.
struct Lists {
  float* v;      // [bq][k] scores, best first
  int* id;       // [bq][k] their rows (INT_MAX: an empty slot)
  float* kth;    // [bq] the k-th score
  float* floor;  // [bq] the raw floor (raw_floor of kth)
  float* qsum;   // [bq]
  int* lock;     // [bq] 1 while a warp holds the query's list
};

__device__ __forceinline__ float vload(const float* p) {
  return *static_cast<const volatile float*>(p);
}

// (c, r) ranks above (v, i): a higher score, or the same and a lower row.
__device__ __forceinline__ bool beats(float c, int r, float v, int i) {
  return c > v || (c == v && r < i);
}

// The twin's order: the product over the scale, then the query's sum.
__device__ __forceinline__ float score(float raw, float scale, float qsum) {
  return __fadd_rn(__fdiv_rn(raw, scale), qsum);
}

// A raw sum R with score(raw) < kth for every raw < R (scale > 0). Rounding
// is monotone, so raw / scale < x - eps with x = kth - qsum gives
// score(raw) <= fl(kth - eps + |x - eps| 2^-24); eps = (|x| + |kth|) 2^-22
// exceeds that rounding and half the gap below kth four times over. The
// product is taken in double and rounded down.
__device__ float raw_floor(float kth, float qsum, float scale) {
  if (kth == -INFINITY) return -INFINITY;
  const double x = static_cast<double>(kth) - static_cast<double>(qsum);
  const double eps =
      (fabs(x) + fabs(static_cast<double>(kth))) * 0x1p-22 + 1e-37;
  return __double2float_rd((x - eps) * static_cast<double>(scale));
}

// 8 code bytes of a row at byte o (dims o .. o+7) in one 8-byte load
// (rows of whole 8-byte words), zeros at or past lim.
__device__ __forceinline__ uint2 load8(const int8_t* row, int o, int lim) {
  if (o >= lim) return make_uint2(0, 0);
  return __ldg(reinterpret_cast<const uint2*>(row + o));
}

// 8 signed codes as 4 exact bf16 pairs (byte pairs 0-1, 2-3, 4-5, 6-7).
__device__ __forceinline__ void to_bf16(const uint2 v, uint32_t* r) {
  r[0] = ivf::s8x2_to_bf16x2(ivf::spread_pair(v.x, 0));
  r[1] = ivf::s8x2_to_bf16x2(ivf::spread_pair(v.x, 1));
  r[2] = ivf::s8x2_to_bf16x2(ivf::spread_pair(v.y, 0));
  r[3] = ivf::s8x2_to_bf16x2(ivf::spread_pair(v.y, 1));
}

// acc[mt][nt] += rows x queries over one 32-dim chunk, as in kernel C: a
// k-block of 16 takes the dims {8t .. 8t+3} of the chunk (the next one
// {8t+4 .. 8t+7}). r[s]: slot s's 4 bf16 pairs (row g + 8 s); qrow: this
// lane's 16 bytes of query row g in the chunk, n-tiles 8 rows apart (rows
// of g's parity, so the same swizzle).
template <int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][NT][4],
                                          const uint32_t (&r)[4][4],
                                          const bf16* qrow, int stride) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint4 b = *reinterpret_cast<const uint4*>(qrow + nt * 8 * stride);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* lo = r[2 * mt];      // row g (+16 mt)
      const uint32_t* hi = r[2 * mt + 1];  // row g + 8 (+16 mt)
      const uint32_t a0[4] = {lo[0], hi[0], lo[1], hi[1]};
      const uint32_t a1[4] = {lo[2], hi[2], lo[3], hi[3]};
      attn::mma_bf16(acc[mt][nt], a0, b.x, b.y);
      attn::mma_bf16(acc[mt][nt], a1, b.z, b.w);
    }
  }
}

// The raw sums of query pair p = 2 nt + j that a lane holds: queries
// 8 nt + 2t + j, rows g, g + 8, g + 16, g + 24 of the warp's 32 (the C
// fragment: acc[mt][nt] = rows g + 16 mt and g + 8 + 16 mt, queries 2t and
// 2t + 1 of the n-tile). A switch, so p costs a jump, not a select of each
// of acc's registers.
template <int NT>
__device__ __forceinline__ void pair_raw(const float (&acc)[2][NT][4], int p,
                                         float (&raw)[4]) {
#define DPH_PAIR(NT_, J_)                                \
  case 2 * NT_ + J_:                                     \
    if constexpr (NT_ < NT) {                            \
      raw[0] = acc[0][NT_][J_];                          \
      raw[1] = acc[0][NT_][J_ + 2];                      \
      raw[2] = acc[1][NT_][J_];                          \
      raw[3] = acc[1][NT_][J_ + 2];                      \
    }                                                    \
    break;
#define DPH_NT(NT_) DPH_PAIR(NT_, 0) DPH_PAIR(NT_, 1)
  switch (p) {
    DPH_NT(0) DPH_NT(1) DPH_NT(2) DPH_NT(3) DPH_NT(4) DPH_NT(5) DPH_NT(6)
    DPH_NT(7) DPH_NT(8) DPH_NT(9) DPH_NT(10) DPH_NT(11) DPH_NT(12)
    DPH_NT(13) DPH_NT(14) DPH_NT(15)
    default: break;
  }
#undef DPH_NT
#undef DPH_PAIR
}

// Whether one of a lane's 4 rows (row, row + 8, ..) may enter query qi's
// list: a valid row's raw sum at or above the floor; a padding row's score
// at or above the k-th. full: all 32 of the warp's rows are valid.
__device__ __forceinline__ bool above(const float (&raw)[4], const Lists& L,
                                      int qi, int nq, int row, int n_valid,
                                      int n_rows, bool full) {
  if (qi >= nq) return false;
  const float fl = vload(L.floor + qi);
  if (full)
    return fmaxf(fmaxf(raw[0], raw[1]), fmaxf(raw[2], raw[3])) >= fl;
  const float kth = vload(L.kth + qi);
  bool any = false;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = row + 8 * h;
    any |= r < n_rows && (r < n_valid ? raw[h] >= fl : kNegInf >= kth);
  }
  return any;
}

// The warp inserts into query qi's list the rows of group tt's lanes (lane
// 4g + tt: rows row0 + g + 8h) that rank above the list's k-th, one at a
// time: a ballot finds the place, a shuffle shifts the slots behind it.
// The warp owns the list: for the phase, or, with locked, while it holds
// the query's lock, which it waits for (backing off) and holds for this
// call only, so a holder never waits. All 32 lanes call.
template <bool kLocked>
__device__ __forceinline__ void insert(const Lists& L, int qi, int k, int tt,
                                       const float (&raw)[4], int row0,
                                       int n_valid, int n_rows, float scale) {
  const int lane = threadIdx.x & 31;
  if (kLocked) {
    if (lane == 0)
      while (atomicCAS(L.lock + qi, 0, 1) != 0) __nanosleep(64);
    __syncwarp();
    __threadfence_block();
  }
  volatile float* lv = L.v + qi * k;
  volatile int* li = L.id + qi * k;
  float v = -INFINITY;  // the list, one slot a lane, -inf past k
  int id = INT_MAX;
  if (lane < k) {
    v = lv[lane];
    id = li[lane];
  }
  float kth = __shfl_sync(kAll, v, k - 1);
  int kid = __shfl_sync(kAll, id, k - 1);
  const float qs = L.qsum[qi];
  const float fl = vload(L.floor + qi);
  const int row = row0 + (lane >> 2);
  float cs[4];  // scores of the rows at or above the floor
  unsigned pend = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = row + 8 * h;
    cs[h] = kNegInf;
    if ((lane & 3) == tt && r < n_rows && (r >= n_valid || raw[h] >= fl)) {
      if (r < n_valid) cs[h] = score(raw[h], scale, qs);
      if (beats(cs[h], r, kth, kid)) pend |= 1u << h;
    }
  }
  const bool changed = __any_sync(kAll, pend != 0);
  for (;;) {
    const unsigned b = __ballot_sync(kAll, pend != 0);
    if (b == 0) break;
    const int src = __ffs(b) - 1;
    const int h = pend ? __ffs(pend) - 1 : 0;
    float c = cs[0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (h == i) c = cs[i];
    c = __shfl_sync(kAll, c, src);
    const int r = __shfl_sync(kAll, row + 8 * h, src);
    if (lane == src) pend &= pend - 1;
    // (c, r) ranks above the k-th, so it takes the first slot it beats
    const int pos =
        __ffs(__ballot_sync(kAll, lane < k && beats(c, r, v, id))) - 1;
    const float pv = __shfl_up_sync(kAll, v, 1);
    const int pi = __shfl_up_sync(kAll, id, 1);
    if (lane == pos) {
      v = c;
      id = r;
    } else if (lane > pos) {
      v = pv;
      id = pi;
    }
    kth = __shfl_sync(kAll, v, k - 1);
    kid = __shfl_sync(kAll, id, k - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (((pend >> i) & 1u) && !beats(cs[i], row + 8 * i, kth, kid))
        pend &= ~(1u << i);
  }
  if (changed) {
    if (lane < k) {
      lv[lane] = v;
      li[lane] = id;
    }
    if (lane == k - 1) {
      static_cast<volatile float*>(L.kth)[qi] = v;
      static_cast<volatile float*>(L.floor)[qi] = raw_floor(v, qs, scale);
    }
  }
  if (kLocked) {
    __threadfence_block();
    __syncwarp();
    if (lane == 0) atomicExch(L.lock + qi, 0);
  }
}

// The query pairs (bit 2 nt + j) for which a lane of the warp has a row
// above the floor.
template <int NT>
__device__ __forceinline__ unsigned filter(const float (&acc)[2][NT][4],
                                           const Lists& L, int nq, int row0,
                                           int n_valid, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3, row = row0 + (lane >> 2);
  const bool full = row0 + kRows <= n_valid;
  unsigned pairs = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float raw[4] = {acc[0][nt][j], acc[0][nt][j + 2], acc[1][nt][j],
                            acc[1][nt][j + 2]};
      if (__any_sync(kAll, above(raw, L, 8 * nt + 2 * t + j, nq, row,
                                 n_valid, n_rows, full)))
        pairs |= 1u << (2 * nt + j);
    }
  return pairs;
}

// The rows of query pair p above the floor as it stands, inserted group by
// group (lanes of one t: one query each).
template <bool kLocked, int NT>
__device__ __forceinline__ void insert_pair(const float (&acc)[2][NT][4],
                                            const Lists& L, int p, int k,
                                            int nq, int row0, int n_valid,
                                            int n_rows, float scale) {
  const int t = threadIdx.x & 3, row = row0 + ((threadIdx.x & 31) >> 2);
  float raw[4];
  pair_raw<NT>(acc, p, raw);
  const int q0 = (p >> 1) * 8 + (p & 1);  // group t's query: q0 + 2t
  unsigned groups = __ballot_sync(
      kAll, above(raw, L, q0 + 2 * t, nq, row, n_valid, n_rows,
                  row0 + kRows <= n_valid));
  while (groups) {
    const int tt = (__ffs(groups) - 1) & 3;
    groups &= ~(0x11111111u << tt);
    insert<kLocked>(L, q0 + 2 * tt, k, tt, raw, row0, n_valid, n_rows, scale);
  }
}

// The lists' side of a round. The first round of a tile, where every
// warp's rows enter every list, runs in 8 phases with a barrier after each:
// in phase i warp w owns the queries of n-tiles (w + i) mod 8 (+ 8), so a
// list has one writer at a time. Later rounds, where few rows enter and
// warps seldom meet, insert under each query's lock, warp w starting at
// n-tile 2w, without barriers.
template <int NT>
__device__ __forceinline__ void epilogue(const float (&acc)[2][NT][4],
                                         const Lists& L, unsigned pairs,
                                         bool first, int k, int nq, int row0,
                                         int n_valid, int n_rows,
                                         float scale) {
  const int warp = threadIdx.x >> 5;
  if (first) {
    for (int i = 0; i < kWarps; ++i) {
      for (int nt = (warp + i) % kWarps; nt < NT; nt += kWarps)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if ((pairs >> (2 * nt + j)) & 1u)
            insert_pair<false, NT>(acc, L, 2 * nt + j, k, nq, row0, n_valid,
                                   n_rows, scale);
      __syncthreads();
    }
    return;
  }
  const int off = warp * 4 % (2 * NT);
  pairs = off ? (pairs >> off) | (pairs << (32 - off)) : pairs;
  while (pairs) {
    const int p = (__ffs(pairs) - 1 + off) & 31;
    pairs &= pairs - 1;
    insert_pair<true, NT>(acc, L, p, k, nq, row0, n_valid, n_rows, scale);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    flat_scan_topk(const float* __restrict__ q,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ qsum, float* __restrict__ out_v,
                   int* __restrict__ out_i, int n_q, int dim, int n_rows,
                   int n_valid, float offset, float scale, int k,
                   int tile_rows, int tiles, int stride) {
  constexpr int kBQ = NT * 8;  // queries per block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* f = reinterpret_cast<float*>(smem + static_cast<size_t>(kBQ) *
                                                 stride * sizeof(bf16));
  const Lists L{f,
                reinterpret_cast<int*>(f + kBQ * k),
                f + 2 * kBQ * k,
                f + 2 * kBQ * k + kBQ,
                f + 2 * kBQ * k + 2 * kBQ,
                reinterpret_cast<int*>(f + 2 * kBQ * k + 3 * kBQ)};
  const int q0 = blockIdx.y * kBQ;
  const int nq = min(kBQ, n_q - q0);
  const int tile = blockIdx.x;
  const int r0 = tile * tile_rows;
  const int r1 = min(r0 + tile_rows, n_rows);

  // the query bank, swizzled: 4 dims a thread (16 bytes of fp32 in, 8 of
  // bf16 out), zeros past the dims and for queries past n_q
  {
    const int units = stride / 4;
    for (int i = threadIdx.x; i < kBQ * units; i += kThreads) {
      const int qb = i / units, d0 = (i % units) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qb < nq && d0 < dim)
        x = __ldg(reinterpret_cast<const float4*>(
            q + static_cast<size_t>(q0 + qb) * dim + d0));
      const int pd = ((((d0 >> 3) ^ ((qb & 1) << 2))) << 3) | (d0 & 7);
      auto* dst = reinterpret_cast<__nv_bfloat162*>(qs + qb * stride + pd);
      dst[0] = __floats2bfloat162_rn(x.x, x.y);
      dst[1] = __floats2bfloat162_rn(x.z, x.w);
    }
  }
  for (int i = threadIdx.x; i < kBQ * k; i += kThreads) {
    L.v[i] = -INFINITY;
    L.id[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    L.kth[i] = -INFINITY;
    L.floor[i] = -INFINITY;
    L.qsum[i] = i < nq ? __fmul_rn(qsum[q0 + i], offset) : 0.0f;
    L.lock[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qrow = qs + g * stride;
  const int sw = (g & 1) << 2;
  const int chunks = (dim + 31) / 32;
  // rounds of 8 x 32 rows, one a warp; every warp takes part in the first
  // round's phases, rows or none
  for (int base = r0; base < r1; base += kWarps * kRows) {
    const int row0 = base + warp * kRows;
    const int8_t* rows = codes + static_cast<size_t>(row0 + g) * dim;
    int lim[4];  // a missing row (past n_rows) reads as zeros
#pragma unroll
    for (int s = 0; s < 4; ++s) lim[s] = row0 + g + 8 * s < n_rows ? dim : 0;
    float acc[2][NT][4] = {};
    uint2 buf[kDepth][4];
#pragma unroll
    for (int p = 0; p < kDepth; ++p)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        buf[p][s] = load8(rows + static_cast<size_t>(8 * s) * dim,
                          32 * p + 8 * t, lim[s]);
    for (int c0 = 0; row0 < r1 && c0 < chunks; c0 += kDepth) {
#pragma unroll
      for (int p = 0; p < kDepth; ++p) {
        const int c = c0 + p;
        if (c >= chunks) break;
        uint32_t r[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          to_bf16(buf[p][s], r[s]);
          buf[p][s] = load8(rows + static_cast<size_t>(8 * s) * dim,
                            32 * (c + kDepth) + 8 * t, lim[s]);
        }
        chunk_mma<NT>(acc, r, qrow + (((4 * c + t) ^ sw) << 3), stride);
      }
    }
    const unsigned pairs =
        row0 < r1 ? filter<NT>(acc, L, nq, row0, n_valid, n_rows) : 0u;
    epilogue<NT>(acc, L, pairs, base == r0, k, nq, row0, n_valid, n_rows,
                 scale);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nq * k; i += kThreads) {
    const size_t o =
        (static_cast<size_t>(q0 + i / k) * tiles + tile) * k + i % k;
    out_v[o] = L.v[i];
    out_i[o] = L.id[i] == INT_MAX ? -1 : L.id[i];
  }
}

template <int NT>
int launch(const void* q, const void* codes, const void* qsum, void* out_v,
           void* out_i, int n_q, int dim, int n_rows, int n_valid,
           float offset, float scale, int k, int tile_rows, int tiles,
           cudaStream_t stream) {
  auto kernel = flat_scan_topk<NT>;
  constexpr int kBQ = NT * 8;
  // the layout ops/flat_scan.py:flat_scan_plan sizes
  const int stride = (dim + 63) / 64 * 64;
  const size_t smem = static_cast<size_t>(kBQ) *
                      (stride * sizeof(bf16) + (2 * k + 4) * sizeof(float));
  if (smem > ivf::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ivf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_q + kBQ - 1) / kBQ;
  kernel<<<dim3(tiles, groups), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(codes),
      static_cast<const float*>(qsum), static_cast<float*>(out_v),
      static_cast<int*>(out_i), n_q, dim, n_rows, n_valid, offset, scale, k,
      tile_rows, tiles, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The caller
// checks devices, types, shapes, contiguity and alignment (dim a multiple
// of 8, the codes 8-byte aligned) and picks nt (blocks of 8 nt queries: 2,
// 4, 8 or 16) and the tiles with ops/flat_scan.py:flat_scan_plan; this
// only refuses what it cannot dispatch. Nothing is synchronised.
extern "C" int dph_flat_scan_topk(const void* q, const void* codes,
                                  const void* qsum, void* out_v, void* out_i,
                                  int n_q, int dim, int n_rows, int n_valid,
                                  float offset, float scale, int k,
                                  int tile_rows, int tiles, int nt,
                                  void* stream) {
  if (n_q <= 0 || dim <= 0 || dim % 8 || k < 1 || k > kMaxK ||
      n_rows < k || n_valid < 0 || n_valid > n_rows || !(scale > 0.0f) ||
      tile_rows <= 0 || tile_rows % kRows ||
      tiles != (n_rows + tile_rows - 1) / tile_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DPH_E(NT)                                                           \
  return launch<NT>(q, codes, qsum, out_v, out_i, n_q, dim, n_rows, n_valid, \
                    offset, scale, k, tile_rows, tiles, s)
  switch (nt) {
    case 16: DPH_E(16);
    case 8: DPH_E(8);
    case 4: DPH_E(4);
    case 2: DPH_E(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DPH_E
}
