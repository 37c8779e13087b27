// Native store runtime: threaded row gather, batch zlib codec, fast file IO.
//
// Host copy of densephrases_tpu/native/src/store_native.cpp: the port never
// imports the JAX package. Keep the two in step. This is host code, not a
// kernel: it runs on the CPU beside the card.
//
// Role parity with the reference's native dependencies: HDF5 (C) provided
// random-access vector storage (ref: densephrases/utils/embed_utils.py
// 222-247 writes, densephrases/index.py:246-273 reads) and blosc (C)
// provided metadata compression (ref: scripts/preprocess/compress_metadata.py
// 45-53, index.py:106-122). This library provides those capabilities for the
// flat store layout: all functions release the GIL (called via ctypes) and
// use a thread pool sized to the machine.
//
// Exported C ABI:
//   dp_gather_rows      — parallel gather of rows from a (possibly mmapped)
//                         int8 matrix into a contiguous output buffer; the
//                         host side of serve-time window fetches when the
//                         corpus is disk/host-tiered instead of HBM-resident.
//   dp_zlib_compress_batch / dp_zlib_decompress_batch
//                       — many independent buffers (de)compressed across
//                         threads (Python's zlib serializes on one buffer at
//                         a time; doc metadata is thousands of small blobs).
//   dp_write_file / dp_read_file — large sequential IO with 16 MiB chunks.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Simple static-partition parallel-for over [0, n).
template <typename F>
void parallel_for(int64_t n, F&& fn, int max_threads = 0) {
  int nt = max_threads > 0 ? max_threads : hw_threads();
  if (nt > n) nt = static_cast<int>(n > 0 ? n : 1);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t grain = (n + nt * 8 - 1) / (nt * 8);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t start = next.fetch_add(grain);
        if (start >= n) return;
        int64_t end = start + grain < n ? start + grain : n;
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `n_idx` rows of width `row_bytes` from `base` at positions `indices`
// into `out` (contiguous). Returns 0 on success.
int dp_gather_rows(const int8_t* base, int64_t n_rows, int64_t row_bytes,
                   const int64_t* indices, int64_t n_idx, int8_t* out) {
  std::atomic<int> bad(0);
  parallel_for(n_idx, [&](int64_t i) {
    int64_t r = indices[i];
    if (r < 0 || r >= n_rows) {
      memset(out + i * row_bytes, 0, row_bytes);
      bad.store(1, std::memory_order_relaxed);
      return;
    }
    memcpy(out + i * row_bytes, base + r * row_bytes, row_bytes);
  });
  return bad.load() ? 1 : 0;
}

// Compress n buffers. in_offsets/out caps are element offsets into the
// concatenated byte arrays. out_sizes receives actual compressed sizes.
// Each output slot has capacity `out_cap` bytes. Returns count of failures.
int dp_zlib_compress_batch(const uint8_t* in, const int64_t* in_offsets,
                           int n, uint8_t* out, int64_t out_cap,
                           int64_t* out_sizes, int level) {
  std::atomic<int> failures(0);
  parallel_for(n, [&](int64_t i) {
    const uint8_t* src = in + in_offsets[i];
    uLong src_len = static_cast<uLong>(in_offsets[i + 1] - in_offsets[i]);
    uLongf dst_len = static_cast<uLongf>(out_cap);
    uint8_t* dst = out + i * out_cap;
    int rc = compress2(dst, &dst_len, src, src_len, level);
    if (rc != Z_OK) {
      failures.fetch_add(1);
      out_sizes[i] = -1;
    } else {
      out_sizes[i] = static_cast<int64_t>(dst_len);
    }
  });
  return failures.load();
}

// Decompress n buffers; out_offsets give the expected decompressed offsets
// (callers know original sizes). Returns count of failures.
int dp_zlib_decompress_batch(const uint8_t* in, const int64_t* in_offsets,
                             int n, uint8_t* out, const int64_t* out_offsets) {
  std::atomic<int> failures(0);
  parallel_for(n, [&](int64_t i) {
    const uint8_t* src = in + in_offsets[i];
    uLong src_len = static_cast<uLong>(in_offsets[i + 1] - in_offsets[i]);
    uint8_t* dst = out + out_offsets[i];
    uLongf dst_len = static_cast<uLongf>(out_offsets[i + 1] - out_offsets[i]);
    int rc = uncompress(dst, &dst_len, src, src_len);
    if (rc != Z_OK) failures.fetch_add(1);
  });
  return failures.load();
}

// Sequential large-file write in 16 MiB chunks. Returns bytes written.
int64_t dp_write_file(const char* path, const uint8_t* data, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int64_t chunk = 16 << 20;
  int64_t written = 0;
  while (written < n) {
    int64_t take = n - written < chunk ? n - written : chunk;
    if (fwrite(data + written, 1, static_cast<size_t>(take), f) !=
        static_cast<size_t>(take)) {
      fclose(f);
      return -1;
    }
    written += take;
  }
  fclose(f);
  return written;
}

int64_t dp_read_file(const char* path, uint8_t* out, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t got = static_cast<int64_t>(fread(out, 1, static_cast<size_t>(n), f));
  fclose(f);
  return got;
}

int dp_num_threads() { return hw_threads(); }

}  // extern "C"
