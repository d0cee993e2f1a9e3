// Stable merges of (k1, k2, k3)-lexicographically sorted int32 key streams,
// by the merge path, in shared memory.
//
// Replaces the TPU kernel src/repro/kernels/merge.py::merge_perm (body
// _merge_kernel) in two forms that share one device routine, merge_tile:
//
// - merge_perm_launch: the permutation.  perm[o] is the index into
//   concat(A, B) of the record that lands at output slot o; ties go to A;
//   slots o >= na + nb hold acap + bcap.
// - merge_pairs_launch: one round of the read spine's tournament
//   (kernels/merge.py::tournament_merge) over every pair at once.  The k
//   streams lie end to end, one buffer a column; a pair is two adjacent
//   streams, and its merge lands on the same range of the other half of a
//   ping-pong buffer, keys and payload alike.  A straggler is a pair whose
//   B is empty: the same code copies it.  The host computes each round's
//   tables from the streams' capacities: pairs (offset, na, nb, first
//   tile) and, for each tile, its pair.
//
// Design, as the reference splits it (src/repro/kernels/merge.py:199-258):
// the output is cut into tiles of kTile = 2048 slots, and tiles never cross
// a pair.  A split pass (one thread a tile) finds each tile's start on the
// merge path: the number of A records among the pair's first d outputs, a
// lexicographic binary search along the diagonal in device memory, ties to
// A.  The merge kernel then gives each tile one CTA of 256 threads: the
// tile's A and B windows, together exactly as long as the tile, are copied
// into shared memory with cp.async; each thread finds the start of its 8
// outputs by a second merge-path search inside shared memory and merges
// them serially, writing the window slot of each output to shared memory;
// after a barrier the CTA writes the tile out coalesced, thread t taking
// slots t, t + 256, ..., the keys from shared memory and each payload
// column (1, 4 or 8 bytes a record) from the window in device memory.
//
// What bounds it on an H100: device memory bandwidth.  The least traffic is
// 16 bytes a record for the permutation (three keys in, one index out) and,
// for a tournament round, every record's keys and payload read once and
// written once (21 bytes in and 21 out for the read spine's six columns).
// Each key is read once, from a contiguous window, where a search per
// element (the design this replaces) makes log2(n) dependent reads a
// record.  The split pass reads about log2(n) keys a tile, under 0.1 % of
// the traffic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxPayload = 8;

// One tile's windows: A's records at slots [0, nA), B's at [nA, nA + nB),
// and the window slot of the record at each of the tile's outputs.
struct Window {
  int32_t k1[kTile];
  int32_t k2[kTile];
  int32_t k3[kTile];
  int16_t src[kTile];
};

struct Keys {
  const int32_t* in[3];
  int32_t* out[3];
};

struct Payload {
  const void* in[kMaxPayload];
  void* out[kMaxPayload];
  int size[kMaxPayload];
  int n;
};

__device__ __forceinline__ bool lex_less(int32_t a1, int32_t a2, int32_t a3,
                                         int32_t b1, int32_t b2, int32_t b3) {
  return a1 < b1 || (a1 == b1 && (a2 < b2 || (a2 == b2 && a3 < b3)));
}

// The number of A records among the first d outputs of the stable merge of
// A[0, na) and B[0, nb): the largest x with A[x - 1] <= B[d - x] (A first on
// ties).  A[mid] precedes B[d - 1 - mid] exactly when mid < x.
__device__ long long path_split(const int32_t* __restrict__ a1,
                                const int32_t* __restrict__ a2,
                                const int32_t* __restrict__ a3,
                                const int32_t* __restrict__ b1,
                                const int32_t* __restrict__ b2,
                                const int32_t* __restrict__ b3, long long na,
                                long long nb, long long d) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long j = d - 1 - mid;
    if (!lex_less(__ldg(b1 + j), __ldg(b2 + j), __ldg(b3 + j),
                  __ldg(a1 + mid), __ldg(a2 + mid), __ldg(a3 + mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Merge one tile: A's window a*[0, nA) and B's window b*[0, nB), with
// nA + nB <= kTile.  Leaves the keys in w.k*, and in w.src[o] the window
// slot of the record at output o.  Every thread of the CTA must call it.
__device__ void merge_tile(Window& w, const int32_t* __restrict__ a1,
                           const int32_t* __restrict__ a2,
                           const int32_t* __restrict__ a3,
                           const int32_t* __restrict__ b1,
                           const int32_t* __restrict__ b2,
                           const int32_t* __restrict__ b3, int nA, int nB) {
  const int len = nA + nB;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const bool in_a = i < nA;
    const int j = in_a ? i : i - nA;
    cp_async4(&w.k1[i], (in_a ? a1 : b1) + j);
    cp_async4(&w.k2[i], (in_a ? a2 : b2) + j);
    cp_async4(&w.k3[i], (in_a ? a3 : b3) + j);
  }
  cp_async_wait_all();
  __syncthreads();

  const int d = min(static_cast<int>(threadIdx.x) * kItems, len);
  int lo = d > nB ? d - nB : 0;
  int hi = d < nA ? d : nA;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = nA + d - 1 - mid;
    if (!lex_less(w.k1[j], w.k2[j], w.k3[j], w.k1[mid], w.k2[mid],
                  w.k3[mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // Each step reads both heads from shared memory.  (A loop that kept
  // the heads in registers between steps merged wrongly when built with
  // ptxas -O1 and above, CUDA 12.8, and rightly at -O0.)
  int ai = lo, bi = nA + d - lo;
  const int end = min(d + kItems, len);
  for (int o = d; o < end; ++o) {
    bool take_a;
    if (ai >= nA) {
      take_a = false;
    } else if (bi >= len) {
      take_a = true;
    } else {
      take_a = !lex_less(w.k1[bi], w.k2[bi], w.k3[bi], w.k1[ai], w.k2[ai],
                         w.k3[ai]);
    }
    w.src[o] = static_cast<int16_t>(take_a ? ai : bi);
    ai += take_a;
    bi += !take_a;
  }
  __syncthreads();
}

// ---------------------------------------------------------- merge_perm

__global__ void perm_split_kernel(const int32_t* __restrict__ a1,
                                  const int32_t* __restrict__ a2,
                                  const int32_t* __restrict__ a3,
                                  const int32_t* __restrict__ b1,
                                  const int32_t* __restrict__ b2,
                                  const int32_t* __restrict__ b3,
                                  long long na, long long nb, int n_tiles,
                                  long long* __restrict__ split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  split[t] = path_split(a1, a2, a3, b1, b2, b3, na, nb,
                        static_cast<long long>(t) * kTile);
}

__global__ void __launch_bounds__(kThreads)
    perm_merge_kernel(const int32_t* __restrict__ a1,
                      const int32_t* __restrict__ a2,
                      const int32_t* __restrict__ a3,
                      const int32_t* __restrict__ b1,
                      const int32_t* __restrict__ b2,
                      const int32_t* __restrict__ b3, long long na,
                      long long nb, long long acap, long long bcap,
                      const long long* __restrict__ split,
                      int32_t* __restrict__ perm) {
  __shared__ Window w;
  const long long cap = acap + bcap, n = na + nb;
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile;
  const int width = static_cast<int>(cap - d0 < kTile ? cap - d0 : kTile);
  int len = 0, nA = 0;
  long long as = 0, bs = 0;
  if (d0 < n) {   // uniform across the CTA
    as = split[blockIdx.x];
    const long long d1 = d0 + kTile < n ? d0 + kTile : n;
    const long long ae = d0 + kTile < n ? split[blockIdx.x + 1] : na;
    bs = d0 - as;
    nA = static_cast<int>(ae - as);
    len = static_cast<int>(d1 - d0);
    merge_tile(w, a1 + as, a2 + as, a3 + as, b1 + bs, b2 + bs, b3 + bs, nA,
               len - nA);
  }
  for (int o = threadIdx.x; o < width; o += kThreads) {
    int32_t v = static_cast<int32_t>(cap);
    if (o < len) {
      const int s = w.src[o];
      v = static_cast<int32_t>(s < nA ? as + s : acap + bs + (s - nA));
    }
    perm[d0 + o] = v;
  }
}

// -------------------------------------------------- merge_pairs (a round)

// pairs[p] = {offset, na, nb, first tile}: A at [offset, offset + na), B
// right after it, the merge at [offset, offset + na + nb) of the output.
__device__ __forceinline__ void tile_of(const long long* __restrict__ pairs,
                                        const int32_t* __restrict__ tile_pair,
                                        int t, long long* off, long long* na,
                                        long long* nb, long long* d0) {
  const long long* p =
      pairs + 4 * static_cast<long long>(__ldg(tile_pair + t));
  *off = __ldg(p);
  *na = __ldg(p + 1);
  *nb = __ldg(p + 2);
  *d0 = (t - __ldg(p + 3)) * static_cast<long long>(kTile);
}

__global__ void pairs_split_kernel(Keys keys,
                                   const long long* __restrict__ pairs,
                                   const int32_t* __restrict__ tile_pair,
                                   int n_tiles,
                                   long long* __restrict__ split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  long long off, na, nb, d0;
  tile_of(pairs, tile_pair, t, &off, &na, &nb, &d0);
  const long long bo = off + na;
  split[t] = path_split(keys.in[0] + off, keys.in[1] + off, keys.in[2] + off,
                        keys.in[0] + bo, keys.in[1] + bo, keys.in[2] + bo, na,
                        nb, d0);
}

template <typename T>
__device__ __forceinline__ void copy_column(const Window& w, const void* in,
                                            void* out, long long a_at,
                                            long long b_at, long long o_at,
                                            int nA, int len) {
  const T* __restrict__ src = static_cast<const T*>(in);
  T* __restrict__ dst = static_cast<T*>(out);
  for (int o = threadIdx.x; o < len; o += kThreads) {
    const int s = w.src[o];
    dst[o_at + o] = src[s < nA ? a_at + s : b_at + (s - nA)];
  }
}

__global__ void __launch_bounds__(kThreads)
    pairs_merge_kernel(Keys keys, Payload pay,
                       const long long* __restrict__ pairs,
                       const int32_t* __restrict__ tile_pair,
                       const long long* __restrict__ split) {
  __shared__ Window w;
  const int t = blockIdx.x;
  long long off, na, nb, d0;
  tile_of(pairs, tile_pair, t, &off, &na, &nb, &d0);
  const long long n = na + nb;
  const long long as = split[t];
  const long long ae = d0 + kTile < n ? split[t + 1] : na;
  const long long d1 = d0 + kTile < n ? d0 + kTile : n;
  const long long bs = d0 - as;
  const int nA = static_cast<int>(ae - as);
  const int len = static_cast<int>(d1 - d0);
  const long long a_at = off + as, b_at = off + na + bs, o_at = off + d0;
  merge_tile(w, keys.in[0] + a_at, keys.in[1] + a_at, keys.in[2] + a_at,
             keys.in[0] + b_at, keys.in[1] + b_at, keys.in[2] + b_at, nA,
             len - nA);
  for (int o = threadIdx.x; o < len; o += kThreads) {
    const int s = w.src[o];
    keys.out[0][o_at + o] = w.k1[s];
    keys.out[1][o_at + o] = w.k2[s];
    keys.out[2][o_at + o] = w.k3[s];
  }
  for (int c = 0; c < pay.n; ++c) {
    switch (pay.size[c]) {
      case 1:
        copy_column<uint8_t>(w, pay.in[c], pay.out[c], a_at, b_at, o_at, nA,
                             len);
        break;
      case 4:
        copy_column<uint32_t>(w, pay.in[c], pay.out[c], a_at, b_at, o_at,
                              nA, len);
        break;
      default:
        copy_column<unsigned long long>(w, pay.in[c], pay.out[c], a_at, b_at,
                                        o_at, nA, len);
        break;
    }
  }
}

}  // namespace

extern "C" int merge_perm_launch(const void* a1, const void* a2,
                                 const void* a3, const void* b1,
                                 const void* b2, const void* b3, long long na,
                                 long long nb, long long acap, long long bcap,
                                 void* split, void* perm, void* stream) {
  // split: int64 scratch of (na + nb + kTile - 1) / kTile entries.
  const long long cap = acap + bcap;
  if (cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t *ka1 = static_cast<const int32_t*>(a1),
                *ka2 = static_cast<const int32_t*>(a2),
                *ka3 = static_cast<const int32_t*>(a3),
                *kb1 = static_cast<const int32_t*>(b1),
                *kb2 = static_cast<const int32_t*>(b2),
                *kb3 = static_cast<const int32_t*>(b3);
  const int n_split = static_cast<int>((na + nb + kTile - 1) / kTile);
  if (n_split > 0) {
    perm_split_kernel<<<(n_split + kThreads - 1) / kThreads, kThreads, 0,
                        s>>>(ka1, ka2, ka3, kb1, kb2, kb3, na, nb, n_split,
                             static_cast<long long*>(split));
  }
  const long long blocks = (cap + kTile - 1) / kTile;
  perm_merge_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      ka1, ka2, ka3, kb1, kb2, kb3, na, nb, acap, bcap,
      static_cast<const long long*>(split), static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merge_pairs_launch(const void* const* key_in,
                                  void* const* key_out,
                                  const void* const* pay_in,
                                  void* const* pay_out, const int* pay_size,
                                  int n_pay, const void* pairs,
                                  const void* tile_pair, int n_tiles,
                                  void* split, void* stream) {
  // One tournament round.  pairs: int64 [n_pairs][4] and tile_pair: int32
  // [n_tiles], both on the card; split: int64 scratch of n_tiles entries.
  if (n_pay < 0 || n_pay > kMaxPayload) return cudaErrorInvalidValue;
  Keys keys;
  for (int i = 0; i < 3; ++i) {
    keys.in[i] = static_cast<const int32_t*>(key_in[i]);
    keys.out[i] = static_cast<int32_t*>(key_out[i]);
  }
  Payload pay;
  pay.n = n_pay;
  for (int c = 0; c < kMaxPayload; ++c) {
    pay.in[c] = c < n_pay ? pay_in[c] : nullptr;
    pay.out[c] = c < n_pay ? pay_out[c] : nullptr;
    pay.size[c] = c < n_pay ? pay_size[c] : 0;
    if (c < n_pay && pay.size[c] != 1 && pay.size[c] != 4 &&
        pay.size[c] != 8) {
      return cudaErrorInvalidValue;
    }
  }
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(pairs);
  const int32_t* tp = static_cast<const int32_t*>(tile_pair);
  long long* sp = static_cast<long long*>(split);
  pairs_split_kernel<<<(n_tiles + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      keys, tab, tp, n_tiles, sp);
  pairs_merge_kernel<<<n_tiles, kThreads, 0, s>>>(keys, pay, tab, tp, sp);
  return static_cast<int>(cudaGetLastError());
}
