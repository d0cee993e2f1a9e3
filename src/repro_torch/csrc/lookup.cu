// Batched binary search: left insertion points of int32 queries into the
// sorted prefix keys[:n_keys] of a run's vertex keys, for one run or for
// every run of a store laid end to end.
//
// Replaces the TPU kernel src/repro/kernels/lookup.py::batched_searchsorted
// (body _kernel): the no-multi-level-index probe of the paper's Fig 16
// ablation, reached through core/csr.py::run_lookup_batch(use_pallas=True)
// one run at a time, and through core/csr.py::runs_lookup_batch for every
// run in one launch.  out[i] = #{ j < n_keys : keys[j] < queries[i] },
// which for sorted keys is the left insertion point into keys[:n_keys] with
// every slot past n_keys read as INT32_MAX (kernels/ref.py::
// searchsorted_ref).  The TPU kernel runs a fixed bit_length(cap)+1
// bisection steps and so overshoots to n_keys+1 when keys[n_keys] < q; this
// search stops at lo == hi and never returns more than n_keys (ROADMAP,
// faults of the reference).  n_keys outside [0, cap] is clamped to it.
//
// What bounds it on an H100.  One run (the Fig 16 L0 run: 504,073 keys,
// 65,600 queries): the chain of dependent loads of a bisection, 19 a
// query, each a round trip to L1 or L2, against 0.8 µs of bytes.  Every
// run at once (1,935 runs x 65,600 queries): by bytes, the 0.5 GB of
// insertion points written (0.16 ms); in practice the search steps.
// Design: a CTA owns one run and a tile of queries and stages the run's
// keys in shared memory once, for all its queries.
//   - A query at or below the run's first key, or above its last, is
//     answered with no search.  An L1 or L2 run covers one segment of the
//     vertex range, which most queries of a probe pass miss.
//   - A run of at most kStageKeys keys (every segment-sized L1 run) is
//     staged whole, with coalesced loads, and bisected in shared memory.
//   - A larger run stages a strided sample of at most kSample keys; a
//     query's bisection of the sample bounds it to a window of fewer than
//     n / kSample keys, and only that window's steps go to device memory:
//     10 dependent loads at 504,073 keys instead of 19.  Larger samples
//     (1,024 and 2,048 keys) cut the chain further but cost more to stage
//     than they save (PERF.md, section 6).
// The single-run entry is the same kernel over one run, a query a thread.
// The multi-run entry covers every (run, query tile) pair in one launch and
// writes the [R, B] insertion points with streaming stores, so the
// 0.5 GB matrix of the Fig 16 pass does not evict the keys from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kStageKeys = 4096;        // keys staged whole (16 KB)
constexpr int kSample = 512;            // <= kStageKeys
constexpr int kRunsTile = 8192;         // queries a CTA of the multi-run form
static_assert(kSample <= kStageKeys, "the sample must fit the stage");

__device__ __forceinline__ int64_t clamp(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// First index in [lo, hi) whose key is not below q, or hi.
template <typename Load>
__device__ __forceinline__ int bisect(Load key, int lo, int hi, int32_t q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const bool right = key(mid) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  return lo;
}

// Grid: x over query tiles of `tile` queries, y (strided) over runs.  Run r
// holds keys[offs[r] : offs[r + 1]] (the last run up to n_total); without
// offs there is one run, keys[0 : n_total].  n_keys[r] is its fill count;
// without n_keys a run's count is its length.  A query at or below the
// run's first key, or above its last, is answered without a search: an L1
// run covers one segment of the vertex range, which most queries miss.
__global__ void __launch_bounds__(kThreads)
searchsorted_kernel(const int32_t* __restrict__ keys,
                    const int64_t* __restrict__ offs,
                    const int32_t* __restrict__ n_keys,
                    const int32_t* __restrict__ queries,
                    int32_t* __restrict__ out, int n_runs, int n_queries,
                    int64_t n_total, int tile) {
  __shared__ int32_t stage[kStageKeys];
  const int q_begin = blockIdx.x * tile;
  const int q_end = min(n_queries, q_begin + tile);
  for (int r = blockIdx.y; r < n_runs; r += gridDim.y) {
    // Offsets out of order or out of range read nothing outside keys.
    const int64_t base = offs ? clamp(offs[r], 0, n_total) : 0;
    const int64_t end =
        offs && r + 1 < n_runs ? clamp(offs[r + 1], base, n_total) : n_total;
    const int64_t cap = end - base;
    const int n = static_cast<int>(
        clamp(n_keys ? static_cast<int64_t>(n_keys[r]) : cap, 0, cap));
    const int32_t* __restrict__ k = keys + base;
    int32_t* __restrict__ row = out + static_cast<int64_t>(r) * n_queries;
    const int32_t first = n > 0 ? __ldg(k) : INT32_MAX;
    const int32_t last = n > 0 ? __ldg(k + n - 1) : INT32_MIN;
    if (n <= kStageKeys) {
      for (int i = threadIdx.x; i < n; i += kThreads) stage[i] = __ldg(k + i);
      __syncthreads();
      for (int q = q_begin + threadIdx.x; q < q_end; q += kThreads) {
        const int32_t v = __ldg(queries + q);
        __stcs(row + q, v <= first ? 0 : v > last ? n : bisect(
            [&](int m) { return stage[m]; }, 1, n - 1, v));
      }
    } else {
      // Sample i is keys[(i + 1) * stride], i < m: every window between two
      // samples holds fewer than stride keys.
      const int stride = (n + kSample) / (kSample + 1);
      const int m = min(kSample, (n - 1) / stride);
      for (int i = threadIdx.x; i < m; i += kThreads)
        stage[i] = __ldg(k + (i + 1) * stride);
      __syncthreads();
      for (int q = q_begin + threadIdx.x; q < q_end; q += kThreads) {
        const int32_t v = __ldg(queries + q);
        int at = v <= first ? 0 : n;
        if (v > first && v <= last) {
          const int c = bisect([&](int i) { return stage[i]; }, 0, m, v);
          at = bisect([&](int i) { return __ldg(k + i); },
                      c > 0 ? c * stride + 1 : 0, c < m ? (c + 1) * stride : n,
                      v);
        }
        __stcs(row + q, at);
      }
    }
    __syncthreads();   // the stage is refilled for the next run
  }
}

cudaError_t launch(const void* keys, const void* offs, const void* n_keys,
                   const void* queries, void* out, int n_runs, int n_queries,
                   long long n_total, int tile, void* stream) {
  if (n_runs > 0 && n_queries > 0) {
    dim3 grid((n_queries + tile - 1) / tile,
              n_runs < 65535 ? n_runs : 65535);
    searchsorted_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<const int64_t*>(offs),
        static_cast<const int32_t*>(n_keys),
        static_cast<const int32_t*>(queries), static_cast<int32_t*>(out),
        n_runs, n_queries, n_total, tile);
  }
  return cudaGetLastError();
}

}  // namespace

// One run: out[i] for queries[:n_queries] into keys[:n], n = *n_keys (read
// on the card: a run's 0-d fill count) clamped to [0, cap].  n_keys may be
// NULL, and then n = cap: a caller that knows n on the host passes it as
// cap, with no copy to the card.
extern "C" int batched_searchsorted_launch(const void* keys,
                                           const void* queries,
                                           const void* n_keys, void* out,
                                           int n_queries, int cap,
                                           void* stream) {
  return static_cast<int>(launch(keys, nullptr, n_keys, queries, out, 1,
                                 n_queries, cap, kThreads, stream));
}

// Every run at once: out[r * n_queries + i] for queries[:n_queries] into
// run r, whose keys start at keys[offs[r]] (int64) and end where run r + 1
// starts (the last at keys[n_total]), with n_keys[r] (int32) its fill
// count, clamped to the run's length.
extern "C" int batched_searchsorted_runs_launch(
    const void* keys, const void* offs, const void* n_keys,
    const void* queries, void* out, int n_runs, int n_queries,
    long long n_total, void* stream) {
  return static_cast<int>(launch(keys, offs, n_keys, queries, out, n_runs,
                                 n_queries, n_total, kRunsTile, stream));
}
