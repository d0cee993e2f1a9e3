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
// What bounds it on an H100.  By bytes, device memory: every filter word
// read once and one output byte a (run, query) pair (0.016 ms at 2,048 runs
// x 16,384 queries).  In practice, where the filter words are read from
// and how the output leaves.  A probe is a random 4-byte read anywhere in
// the run's filter, so a CTA that probes a run pulls nearly all of its
// filter through its own L1: the first kernel (a thread a pair, 64 CTAs a
// run, one-byte stores) moved each filter through 64 L1s, and its one-byte
// stores alone took 0.08 ms.  Here a filter leaves L2 once for each tile of
// 4,096 queries, and the output leaves in 16-byte stores:
//   - A CTA owns a tile of kTileQ queries and walks a strided set of runs.
//     Each thread hashes its kQpt queries once and keeps h1/h2 in registers
//     for every run the CTA walks.
//   - A filter of at most kStageWords words (every segment-sized L1 run) is
//     copied into shared memory with cp.async, double-buffered: the next
//     run's copy is in flight while this run is probed, and the run after
//     that has its first word and mask on the way to registers.
//   - A larger filter (L0 and L2 runs, megabytes) is probed through L2 with
//     read-only loads; the query tiles split its row across CTAs.
//   - A thread's kQpt hits leave as one 16-byte streaming store where the
//     row allows it (aligned, whole), else byte by byte.
// What holds it now is the probing itself, about 450 instructions a thread
// a run: with every row cut to 8 words (no bank conflicts, no staging) it
// takes as long as at the real filters' shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQpt = 16;                  // queries a thread: one 16-byte store
constexpr int kTileQ = kThreads * kQpt;   // queries a CTA
constexpr int kStageWords = 4096;         // 16 KB a buffer, two buffers
constexpr int kCtasPerSm = 4;             // at 32 KB of shared memory each

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Words of a filter: enough for every position under its mask.
__device__ __forceinline__ uint32_t row_words(uint32_t mask) {
  return (mask >> 5) + 1u;
}

// A run's filter: its first word and its mask, loaded a run ahead of use.
struct Row {
  const int32_t* words;
  uint32_t mask;
};

__device__ __forceinline__ Row load_row(const int32_t* words,
                                        const int64_t* offs,
                                        const int32_t* masks, int r,
                                        int n_runs) {
  if (r >= n_runs) return Row{words, 0u};
  return Row{words + __ldg(offs + r), static_cast<uint32_t>(__ldg(masks + r))};
}

// Start the copy of a filter into buf when it fits there.
__device__ __forceinline__ void stage_row(Row row, uint32_t* buf) {
  const uint32_t nw = row_words(row.mask);
  if (nw > kStageWords) return;
  if ((reinterpret_cast<uintptr_t>(row.words) & 15u) == 0 && (nw & 3u) == 0) {
    for (uint32_t i = threadIdx.x * 4u; i < nw; i += kThreads * 4u)
      cp_async16(buf + i, row.words + i);
  } else {
    for (uint32_t i = threadIdx.x; i < nw; i += kThreads)
      cp_async4(buf + i, row.words + i);
  }
}

// The kQpt hits of this thread's queries in one filter as bit j of the
// result.  Load reads one filter word (shared or global); the rotate takes
// bit p & 31 of it, which is bit (p & mask) & 31 for any mask.
template <typename Load>
__device__ __forceinline__ uint32_t probe_row(Load load, uint32_t mask,
                                              const uint32_t (&h1)[kQpt],
                                              const uint32_t (&h2)[kQpt],
                                              int n_probes) {
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    uint32_t pos = h1[j], hit = 1u;
#pragma unroll 4
    for (int i = 0; i < n_probes; ++i) {
      const uint32_t p = pos & mask;
      const uint32_t w = load(p >> 5);
      hit &= __funnelshift_r(w, w, p);
      pos += h2[j];
    }
    bits |= (hit & 1u) << j;
  }
  return bits;
}

// Four bits to four bytes of 0 or 1, bit k to byte k.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
presence_kernel(const int32_t* __restrict__ words,
                const int64_t* __restrict__ offs,
                const int32_t* __restrict__ masks,
                const int32_t* __restrict__ queries,
                uint8_t* __restrict__ out, int n_runs, int n_queries,
                int n_probes, uint32_t salt) {
  __shared__ __align__(16) uint32_t stage[2][kStageWords];
  const int q0 = blockIdx.x * kTileQ + threadIdx.x * kQpt;
  uint32_t h1[kQpt], h2[kQpt];
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const uint32_t v =
        q0 + j < n_queries ? static_cast<uint32_t>(__ldg(queries + q0 + j))
                           : 0u;
    h1[j] = mix32(v);
    h2[j] = mix32(v ^ salt) | 1u;
  }
  // Run r is probed while run r + step is copied in and run r + 2 step's
  // first word and mask are on their way to registers.
  const int step = gridDim.y;
  int r = blockIdx.y;
  Row cur = load_row(words, offs, masks, r, n_runs);
  Row next = load_row(words, offs, masks, r + step, n_runs);
  if (r < n_runs) stage_row(cur, stage[0]);
  cp_async_commit();
  for (int k = 0; r < n_runs; ++k, r += step) {
    const Row after = load_row(words, offs, masks, r + 2 * step, n_runs);
    if (r + step < n_runs) stage_row(next, stage[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait_all_but_one();   // run r's copy has landed
    __syncthreads();
    uint32_t bits;
    if (row_words(cur.mask) <= kStageWords) {
      const uint32_t* buf = stage[k & 1];
      bits = probe_row([&](uint32_t w) { return buf[w]; }, cur.mask, h1, h2,
                       n_probes);
    } else {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(cur.words);
      bits = probe_row([&](uint32_t w) { return __ldg(row + w); }, cur.mask,
                       h1, h2, n_probes);
    }
    uint8_t* dst = out + static_cast<int64_t>(r) * n_queries + q0;
    if (q0 + kQpt <= n_queries &&
        (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
      __stcs(reinterpret_cast<uint4*>(dst),
             make_uint4(spread4(bits & 15u), spread4((bits >> 4) & 15u),
                        spread4((bits >> 8) & 15u), spread4(bits >> 12)));
    } else {
      for (int j = 0; j < kQpt && q0 + j < n_queries; ++j)
        dst[j] = static_cast<uint8_t>((bits >> j) & 1u);
    }
    cur = next;
    next = after;
    __syncthreads();   // the buffer is refilled two runs on
  }
}

}  // namespace

extern "C" int presence_matrix_launch(const void* words, const void* offs,
                                      const void* masks, const void* queries,
                                      void* out, int n_runs, int n_queries,
                                      int n_probes, unsigned int salt,
                                      void* stream) {
  if (n_runs > 0 && n_queries > 0) {
    static int sms = 0;
    if (sms == 0) {
      int device = 0;
      cudaGetDevice(&device);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    // Query tiles on x; on y enough run columns for one wave of CTAs over
    // every slot of the card, each CTA walking runs y, y + grid.y, ...: a
    // second wave (twice the columns, half the runs a CTA) took 7 % longer.
    const int tiles = (n_queries + kTileQ - 1) / kTileQ;
    const int want = (kCtasPerSm * (sms > 0 ? sms : 132) + tiles - 1) /
                     tiles;
    const int cols = n_runs < want ? n_runs : (want < 65535 ? want : 65535);
    dim3 grid(tiles, cols > 0 ? cols : 1);
    presence_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), static_cast<const int64_t*>(offs),
        static_cast<const int32_t*>(masks),
        static_cast<const int32_t*>(queries), static_cast<uint8_t*>(out),
        n_runs, n_queries, n_probes, salt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Words of the largest filter the kernel stages in shared memory.
extern "C" int presence_stage_words() { return kStageWords; }
