// Batched binary search: left insertion points of int32 queries into the
// sorted prefix keys[:n_keys] of a run's vertex keys.
//
// Replaces the TPU kernel src/repro/kernels/lookup.py::batched_searchsorted
// (body _kernel): the no-multi-level-index probe of the paper's Fig 16
// ablation, reached through core/csr.py::run_lookup_batch(use_pallas=True).
// out[i] = #{ j < n_keys : keys[j] < queries[i] }, which for sorted keys is
// the left insertion point into keys[:n_keys] with every slot past n_keys
// read as INT32_MAX (kernels/ref.py::searchsorted_ref).  The TPU kernel runs
// a fixed bit_length(cap)+1 bisection steps and so overshoots to n_keys+1
// when keys[n_keys] < q; this loop stops at lo == hi and never returns more
// than n_keys (ROADMAP, faults of the reference).
//
// n_keys is read on the card from a 1-element int32 buffer (the run's 0-d
// fill count), as the TPU kernel reads nk_ref, so the caller never copies
// it to the host.  Values outside [0, cap] are clamped to it.
//
// What bounds it on an H100: the dependent loads of the bisection, about
// log2(n_keys) of them per query.  The whole key vector of a run is at most
// a few MB and stays in L2; the first steps of every query touch the same
// few keys, which stay in L1.  Design: one thread per query (no padding of
// the query vector; the tail is guarded by i < n_queries), read-only loads
// through the texture path, and a branch-free step so that the threads of a
// warp stay converged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void searchsorted_kernel(const int32_t* __restrict__ keys,
                                    const int32_t* __restrict__ queries,
                                    const int32_t* __restrict__ n_keys,
                                    int32_t* __restrict__ out, int n_queries,
                                    int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_queries) return;
  int hi = __ldg(n_keys);
  hi = hi < 0 ? 0 : (hi > cap ? cap : hi);
  const int32_t q = __ldg(queries + i);
  int lo = 0;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const bool right = __ldg(keys + mid) < q;
    lo = right ? mid + 1 : lo;
    hi = right ? hi : mid;
  }
  out[i] = lo;
}

}  // namespace

extern "C" int batched_searchsorted_launch(const void* keys,
                                           const void* queries,
                                           const void* n_keys, void* out,
                                           int n_queries, int cap,
                                           void* stream) {
  if (n_queries > 0) {
    const int threads = 256;
    const int blocks = (n_queries + threads - 1) / threads;
    searchsorted_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(queries),
        static_cast<const int32_t*>(n_keys), static_cast<int32_t*>(out),
        n_queries, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
