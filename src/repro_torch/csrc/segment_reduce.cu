// Fused gather + sorted-segment reduction: the analytics inner loop.
//
// Replaces the TPU kernels src/repro/kernels/segment_reduce.py::gather_segsum
// (body _kernel) and ::gather_segmin (body _kernel_min):
//   segsum: y[s] = sum over edges e with seg_id[e] == s of wt[e] * x[dst[e]]
//   segmin: y[s] = min(3.0e38, min over those edges of wt[e] + x[dst[e]])
// seg_id must not decrease (CSR order).  As in the reference's ref.py, dst is
// clipped to [0, n_x - 1], a negative seg_id counts as segment 0 and an edge
// with seg_id >= n_out is dropped; a segment with no edge gets 0 (sum) or
// 3.0e38 (min: the float32 value of the reference's _INF, not inf).
//
// What bounds it on an H100: device memory.  It reads dst, seg_id and wt once
// (12 bytes an edge), x once (4 bytes a vertex, gathered: at Graph500 scale
// 22 x is 16 MB and stays in the 50 MB L2) and writes y once (4 bytes a
// segment): about 12*E + 8*n_out bytes.  There is one multiply-add or
// add-min an edge, far below the card's arithmetic rate.
//
// Design.  The TPU kernel turns each 512-edge tile into a one-hot matrix for
// the MXU and combines tiles with an XLA scatter; neither fits Hopper.  Here
// each warp owns a contiguous range of kSubTiles * 32 edges and walks it in
// 32-edge steps: every lane reads one edge (coalesced) and gathers x[dst].
// One ballot marks the lanes where a segment starts, and a segmented suffix
// reduction over __shfl_down_sync, each lane combining only up to the last
// lane of its own segment, leaves each segment's partial in the segment's
// first lane.  The segment still open at the end of a step is carried in
// registers into the next step.  A segment that lies wholly inside the
// warp's range has no other writer and is stored directly; only a segment
// that touches the range's first or last edge (a hub spans many ranges)
// goes through an atomic.  Float atomicAdd makes the order of a hub's
// partial sums vary from run to run; min is order-free, so segmin is exact.
// CUDA has no float atomicMin: the sign-aware integer trick below (int
// atomicMin for a value >= 0, unsigned atomicMax for a negative one) orders
// IEEE floats correctly.  A first kernel fills y with the identity.
//
// What holds it back on the H100 is the gather of x through L1, not the
// shuffles: at scale 22 x is 16 MB and stays in L2, but a gather that misses
// L1 moves a 32-byte sector for 4 useful bytes.  Measured with
// tools/segment_bench.py and tools/segment_variants.py, the kernel takes
// about 0.35 ms with every dst = 0 and about 0.49 ms with the real dst, and
// anything that takes L1 from x costs more than it saves: 8.5 KB of unused
// shared memory a CTA made the first design 0.05 to 0.08 ms slower, and an
// L1::evict_last hint on the gathers 0.04 to 0.06 ms.  Designs tried on the
// card that staged edges in shared memory, read several edges a lane with
// 16-byte loads and kept several gathers a lane in flight, or made the sum
// deterministic (cross-warp partials combined in the CTA and across tiles
// by a second pass, y written once without the fill) all ran slower than
// the first design.  So the layout stays, and three changes remain: the
// ballot replaces the per-round comparison of segment ids (five shuffles a
// step fewer; segmin's dst = 0 time falls from 0.43 to 0.36 ms), dst,
// seg_id and wt are read evict-first (__ldcs), which leaves more of L1 to
// x (3 % faster), and CTAs have 512 threads (1 %).
//
// Multi-run segment sum (gather_segsum_runs_launch): the merge-free
// multi-level PageRank of src/repro/analytics/multilevel.py::multilevel_spmv
// calls the TPU kernel gather_segsum once per run and adds the partial
// outputs.  Here every run's records are laid end to end (one concatenation
// made once per PageRank or degree call by the caller: three flat arrays
// that the kernel walks like one CSR; a table of per-run pointers would save
// that copy, about 12 bytes a record, but every warp would first have to
// find its run) and one launch computes
//   y[s] = sum over every run r, every record e of r with src[e] == s,
//          of wt[e] * x[dst[e]].
// seg_id is sorted inside each run but falls at a run boundary, and a
// source id recurs in other runs, so two things change from the single-run
// kernel.  (1) The in-step reduction scans with segment flags (a lane ends a
// segment when the next lane's id differs), not by comparing ids at a
// distance, which is only right for sorted ids.  Equal ids on both sides of
// a run boundary merge into one partial, which is still their sum.  (2)
// Every segment partial goes through atomicAdd: no warp owns a segment.  The
// fill of y happens once a sweep, not once a run, and the launch covers
// every record, so 132 SMs have work.  The byte bound is 12 bytes a record
// plus 8 a vertex; the atomics add one per segment piece, about one per 16
// records on R-MAT scale 22.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// CTA of the single-run kernel: 512 threads ran 1 % faster than 256
// (tools/segment_variants.py); occupancy is 64 warps an SM for both.
constexpr int kSingleThreads = 512;
constexpr int kSubTiles = 8;
constexpr int kWarpEdges = 32 * kSubTiles;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.0f) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

struct SumOp {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float edge(float w, float xv) {
    return w * xv;
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ void store(float* y, float v) { *y = v; }
  static __device__ __forceinline__ void atomic(float* y, float v) {
    atomicAdd(y, v);
  }
};

struct MinOp {
  static __device__ __forceinline__ float identity() { return INFINITY; }
  static __device__ __forceinline__ float edge(float w, float xv) {
    return w + xv;
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fminf(a, b);
  }
  static __device__ __forceinline__ void store(float* y, float v) {
    *y = fminf(v, kInf);
  }
  static __device__ __forceinline__ void atomic(float* y, float v) {
    atomic_min_float(y, v);
  }
};

__global__ void fill_kernel(float* __restrict__ y, int n, float value) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    y[i] = value;
  }
}

// Write one segment's partial: directly when this warp is its only writer,
// else through an atomic.  Segments >= n_out (and the tail sentinel) drop.
template <class Op>
__device__ __forceinline__ void emit(float* y, int seg, float v, bool shared,
                                     int n_out) {
  if (seg >= n_out) return;
  if (shared) {
    Op::atomic(y + seg, v);
  } else {
    Op::store(y + seg, v);
  }
}

template <class Op>
__global__ void __launch_bounds__(kSingleThreads)
seg_reduce_kernel(const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ seg_id,
                  const float* __restrict__ wt, const float* __restrict__ x,
                  float* __restrict__ y, long long n_edges, int n_x,
                  int n_out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * kWarpEdges;
  if (begin >= n_edges) return;  // whole warp: every lane agrees
  // The segment still open at the end of the previous step: its id (-1 for
  // none), its partial, and whether it touches the range's first edge.
  int open_seg = -1;
  float open_val = Op::identity();
  bool open_shared = false;
  for (int t = 0; t < kSubTiles; ++t) {
    const long long base = begin + static_cast<long long>(t) * 32;
    if (base >= n_edges) break;  // uniform across the warp
    const long long i = base + lane;
    // Lanes past the end carry INT_MAX, which keeps seg non-decreasing and
    // is >= n_out, so it is never written.
    int s = INT_MAX;
    float v = Op::identity();
    if (i < n_edges) {
      s = max(__ldcs(seg_id + i), 0);
      if (s < n_out) {
        const int d = min(max(__ldcs(dst + i), 0), n_x - 1);
        v = Op::edge(__ldcs(wt + i), __ldg(x + d));
      }
    }
    // Segment heads by one ballot; then a segmented suffix reduction over
    // the lanes up to the last of this lane's segment: afterwards each lane
    // holds the partial of its segment over itself and the lanes after it
    // in this step.
    const int s_prev = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_prev != s;
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned after = lane < 31 ? heads >> (lane + 1) : 0u;
    const int seg_end = after ? lane + __ffs(after) - 1 : 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vo = __shfl_down_sync(kFull, v, off);
      if (lane + off <= seg_end) v = Op::combine(v, vo);
    }
    const int s_first = __shfl_sync(kFull, s, 0);
    const int s_last = __shfl_sync(kFull, s, 31);
    // Lane 0's segment: a continuation of the open one, or a new segment
    // that may have begun in the previous range only when t == 0.
    bool lane0_shared = t == 0;
    if (open_seg >= 0) {
      if (s_first == open_seg) {
        if (lane == 0) v = Op::combine(open_val, v);
        lane0_shared = open_shared;
      } else {
        if (lane == 0) emit<Op>(y, open_seg, open_val, open_shared, n_out);
        lane0_shared = false;
      }
    }
    // Segments that end inside this step are complete.
    if (head && s != s_last) {
      emit<Op>(y, s, v, lane == 0 && lane0_shared, n_out);
    }
    // The segment holding lane 31 stays open.
    const int last_head = 31 - __clz(heads);
    open_val = __shfl_sync(kFull, v, last_head);
    open_seg = s_last;
    open_shared = last_head == 0 && lane0_shared;
  }
  // The open segment touches the range's last edge: the next range may hold
  // more of it.
  if (lane == 0) emit<Op>(y, open_seg, open_val, true, n_out);
}

// The multi-run segment sum: like seg_reduce_kernel<SumOp>, but seg_id is
// sorted only within runs and every segment partial is added atomically.
__global__ void __launch_bounds__(kThreads)
seg_sum_runs_kernel(const int32_t* __restrict__ dst,
                    const int32_t* __restrict__ seg_id,
                    const float* __restrict__ wt, const float* __restrict__ x,
                    float* __restrict__ y, long long n_edges, int n_x,
                    int n_out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long begin = warp * kWarpEdges;
  if (begin >= n_edges) return;  // whole warp: every lane agrees
  int open_seg = -1;  // the segment holding the previous step's lane 31
  float open_val = 0.0f;
  for (int t = 0; t < kSubTiles; ++t) {
    const long long base = begin + static_cast<long long>(t) * 32;
    if (base >= n_edges) break;  // uniform across the warp
    const long long i = base + lane;
    // Lanes past the end carry INT_MAX (>= n_out: never written).
    int s = INT_MAX;
    float v = 0.0f;
    if (i < n_edges) {
      s = max(__ldg(seg_id + i), 0);
      if (s < n_out) {
        const int d = min(max(__ldg(dst + i), 0), n_x - 1);
        v = __ldg(wt + i) * __ldg(x + d);
      }
    }
    // Segmented suffix sum with flags: ends is true when a segment ends
    // within [lane, lane + off); lane 31 always ends one.  Afterwards each
    // lane holds the sum of its segment from itself to the segment's end.
    const int s_next = __shfl_down_sync(kFull, s, 1);
    bool ends = lane == 31 || s_next != s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vo = __shfl_down_sync(kFull, v, off);
      const bool eo = __shfl_down_sync(kFull, ends, off);
      if (!ends) {
        v += vo;
        ends = eo;
      }
    }
    const int s_prev = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_prev != s;
    const int s_first = __shfl_sync(kFull, s, 0);
    const int s_last = __shfl_sync(kFull, s, 31);
    const unsigned heads = __ballot_sync(kFull, head);
    const int last_head = 31 - __clz(heads);
    // The open segment continues into lane 0's, or is complete.
    if (lane == 0 && open_seg >= 0) {
      if (s_first == open_seg) {
        v += open_val;
      } else if (open_seg < n_out) {
        atomicAdd(y + open_seg, open_val);
      }
    }
    // Every segment but the one holding lane 31 is complete in this step.
    if (head && lane != last_head && s < n_out) atomicAdd(y + s, v);
    open_val = __shfl_sync(kFull, v, last_head);
    open_seg = s_last;
  }
  if (lane == 0 && open_seg >= 0 && open_seg < n_out) {
    atomicAdd(y + open_seg, open_val);
  }
}

using SegKernel = void (*)(const int32_t*, const int32_t*, const float*,
                          const float*, float*, long long, int, int);

// Fill y with the identity, then run the reduction kernel over the edges in
// CTAs of the given number of threads.
int launch(SegKernel kernel, int threads, const void* dst,
           const void* seg_id, const void* wt, const void* x, void* y,
           long long n_edges, int n_x, int n_out, float fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  if (n_out > 0) {
    const int needed = (n_out + kThreads - 1) / kThreads;
    const int blocks = needed < 4096 ? needed : 4096;
    fill_kernel<<<blocks, kThreads, 0, st>>>(out, n_out, fill);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_edges > 0 && n_out > 0) {
    const long long warps = (n_edges + kWarpEdges - 1) / kWarpEdges;
    const long long blocks = (warps * 32 + threads - 1) / threads;
    kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(seg_id),
        static_cast<const float*>(wt), static_cast<const float*>(x), out,
        n_edges, n_x, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_segsum_launch(const void* dst, const void* seg_id,
                                    const void* wt, const void* x, void* y,
                                    long long n_edges, int n_x, int n_out,
                                    void* stream) {
  return launch(seg_reduce_kernel<SumOp>, kSingleThreads, dst, seg_id, wt, x,
                y, n_edges, n_x, n_out, 0.0f, stream);
}

extern "C" int gather_segmin_launch(const void* dst, const void* seg_id,
                                    const void* wt, const void* x, void* y,
                                    long long n_edges, int n_x, int n_out,
                                    void* stream) {
  return launch(seg_reduce_kernel<MinOp>, kSingleThreads, dst, seg_id, wt, x,
                y, n_edges, n_x, n_out, kInf, stream);
}

// Every run's records laid end to end: seg_id sorted within each run.
extern "C" int gather_segsum_runs_launch(const void* dst, const void* seg_id,
                                         const void* wt, const void* x,
                                         void* y, long long n_edges, int n_x,
                                         int n_out, void* stream) {
  return launch(seg_sum_runs_kernel, kThreads, dst, seg_id, wt, x, y, n_edges,
                n_x, n_out, 0.0f, stream);
}
