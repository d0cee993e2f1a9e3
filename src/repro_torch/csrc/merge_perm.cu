// Stable merge permutation of two (k1, k2, k3)-lexicographically sorted
// int32 key streams.
//
// Replaces the TPU kernel src/repro/kernels/merge.py::merge_perm (body
// _merge_kernel): perm[o] is the index into concat(A, B) of the record that
// lands at output slot o; ties go to A; slots o >= na + nb hold acap + bcap.
//
// The TPU kernel ranks a 256-wide output tile with a one-hot (BT x BT)
// compare matrix, which suits its vector unit.  Here each input element
// finds its own output slot instead: A[i] goes to i + #{j < nb : B[j] < A[i]}
// and B[j] to j + #{i < na : A[i] <= B[j]} (strict for A, non-strict for B,
// which puts A first on ties).  Each count is one lexicographic binary search
// into the other stream, and the element is scattered to its slot.  Every
// slot below na + nb is written exactly once, and the pad slots by the
// thread of the same index, so no two threads write one slot.
//
// What bounds it on an H100: device memory latency, not bandwidth.  The
// least traffic is 16 bytes per record (three keys in, one index out), but a
// binary search makes log2(n) dependent reads.  Neighbouring threads search
// neighbouring keys, so their paths share the top levels of the search tree,
// which stay in L2; only the last few steps of each search go to device
// memory.  A later design may first split the output into tiles along the
// merge path and merge each tile in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool lex_less(int32_t a1, int32_t a2, int32_t a3,
                                         int32_t b1, int32_t b2, int32_t b3) {
  return a1 < b1 || (a1 == b1 && (a2 < b2 || (a2 == b2 && a3 < b3)));
}

// Number of keys among k[0, n) that are < q (inclusive = false) or <= q
// (inclusive = true).
__device__ __forceinline__ int64_t lex_rank(const int32_t* __restrict__ k1,
                                            const int32_t* __restrict__ k2,
                                            const int32_t* __restrict__ k3,
                                            int64_t n, int32_t q1, int32_t q2,
                                            int32_t q3, bool inclusive) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int32_t a1 = __ldg(k1 + mid), a2 = __ldg(k2 + mid),
                  a3 = __ldg(k3 + mid);
    const bool right = inclusive ? !lex_less(q1, q2, q3, a1, a2, a3)
                                 : lex_less(a1, a2, a3, q1, q2, q3);
    if (right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_perm_kernel(const int32_t* __restrict__ a1,
                                  const int32_t* __restrict__ a2,
                                  const int32_t* __restrict__ a3,
                                  const int32_t* __restrict__ b1,
                                  const int32_t* __restrict__ b2,
                                  const int32_t* __restrict__ b3, int64_t na,
                                  int64_t nb, int64_t acap, int64_t bcap,
                                  int32_t* __restrict__ perm) {
  const int64_t cap = acap + bcap;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= cap) return;
  if (t < na) {
    const int64_t r = lex_rank(b1, b2, b3, nb, a1[t], a2[t], a3[t], false);
    perm[t + r] = static_cast<int32_t>(t);
  } else if (t >= acap && t - acap < nb) {
    const int64_t j = t - acap;
    const int64_t r = lex_rank(a1, a2, a3, na, b1[j], b2[j], b3[j], true);
    perm[j + r] = static_cast<int32_t>(t);
  }
  if (t >= na + nb) perm[t] = static_cast<int32_t>(cap);
}

}  // namespace

extern "C" int merge_perm_launch(const void* a1, const void* a2,
                                 const void* a3, const void* b1,
                                 const void* b2, const void* b3, long long na,
                                 long long nb, long long acap, long long bcap,
                                 void* perm, void* stream) {
  const long long cap = acap + bcap;
  if (cap > 0) {
    const int threads = 256;
    const long long blocks = (cap + threads - 1) / threads;
    merge_perm_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a1), static_cast<const int32_t*>(a2),
        static_cast<const int32_t*>(a3), static_cast<const int32_t*>(b1),
        static_cast<const int32_t*>(b2), static_cast<const int32_t*>(b3), na,
        nb, acap, bcap, static_cast<int32_t*>(perm));
  }
  return static_cast<int>(cudaGetLastError());
}
