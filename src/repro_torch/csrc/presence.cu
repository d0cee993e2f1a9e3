// Vertex-presence test of a query vector against every run's bloom filter.
//
// Replaces the TPU kernel src/repro/kernels/presence.py::presence_matrix_pallas
// (body _kernel): out[r, q] = AND over k probes of bit (h1 + i*h2) & mask[r]
// in run r's packed words, with h1 = mix(q), h2 = mix(q ^ salt) | 1 and mix
// the splitmix32 finalizer of core/filters.py::_mix32 (uint32 wraparound).
//
// Layout: the filters are ragged, not padded to the widest one.  words holds
// every run's packed bits back to back (int32 bit patterns, reinterpreted as
// uint32 here), offs[r] is the first word of run r and masks[r] = mbits-1.
// A run without a filter is given a row of all-ones words by the caller.
//
// What bounds it on an H100: device memory.  Each (run, query) pair writes
// one output byte and makes k scattered 4-byte reads into the run's words;
// the hash is a handful of integer operations.  Design: one thread per
// (run, query) pair, with the query index on x so that a warp writes 32
// neighbouring output bytes and reads 32 neighbouring queries; the run on y,
// so that the threads of a block probe one run's words, which stay in L1/L2
// while the block runs.  The hash of the query is computed once per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__global__ void presence_kernel(const int32_t* __restrict__ words,
                                const int64_t* __restrict__ offs,
                                const int32_t* __restrict__ masks,
                                const int32_t* __restrict__ queries,
                                uint8_t* __restrict__ out, int n_runs,
                                int n_queries, int n_probes, uint32_t salt) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  const uint32_t v = static_cast<uint32_t>(queries[q]);
  const uint32_t h1 = mix32(v);
  const uint32_t h2 = mix32(v ^ salt) | 1u;
  for (int r = blockIdx.y; r < n_runs; r += gridDim.y) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(words + offs[r]);
    const uint32_t mask = static_cast<uint32_t>(masks[r]);
    uint32_t hit = 1u;
    for (int i = 0; i < n_probes; ++i) {
      const uint32_t pos = (h1 + static_cast<uint32_t>(i) * h2) & mask;
      hit &= (__ldg(row + (pos >> 5)) >> (pos & 31u)) & 1u;
    }
    out[static_cast<int64_t>(r) * n_queries + q] = static_cast<uint8_t>(hit);
  }
}

}  // namespace

extern "C" int presence_matrix_launch(const void* words, const void* offs,
                                      const void* masks, const void* queries,
                                      void* out, int n_runs, int n_queries,
                                      int n_probes, unsigned int salt,
                                      void* stream) {
  if (n_runs > 0 && n_queries > 0) {
    const int threads = 256;
    dim3 grid((n_queries + threads - 1) / threads,
              n_runs < 65535 ? n_runs : 65535);
    presence_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), static_cast<const int64_t*>(offs),
        static_cast<const int32_t*>(masks),
        static_cast<const int32_t*>(queries), static_cast<uint8_t*>(out),
        n_runs, n_queries, n_probes, salt);
  }
  return static_cast<int>(cudaGetLastError());
}
