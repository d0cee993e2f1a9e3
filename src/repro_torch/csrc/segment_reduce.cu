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
// 32-edge steps: every lane reads one edge (coalesced), gathers x[dst], and a
// segmented suffix reduction over __shfl_down_sync (combining a neighbour's
// value only when it belongs to the same segment) leaves each segment's
// partial in the segment's first lane.  The segment still open at the end of
// a step is carried in registers into the next step.  A segment that lies
// wholly inside the warp's range has no other writer and is stored directly;
// only a segment that touches the range's first or last edge (a hub spans
// many ranges) goes through an atomic.  Float atomicAdd makes the order of a
// hub's partial sums vary from run to run; min is order-free, so segmin is
// exact.  CUDA has no float atomicMin: the sign-aware integer trick below
// (int atomicMin for a value >= 0, unsigned atomicMax for a negative one)
// orders IEEE floats correctly.  A first kernel fills y with the identity.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
__global__ void __launch_bounds__(kThreads)
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
      s = max(__ldg(seg_id + i), 0);
      if (s < n_out) {
        const int d = min(max(__ldg(dst + i), 0), n_x - 1);
        v = Op::edge(__ldg(wt + i), __ldg(x + d));
      }
    }
    // Segmented suffix reduction: afterwards each lane holds the partial of
    // its segment over itself and the lanes after it in this step.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vo = __shfl_down_sync(kFull, v, off);
      const int so = __shfl_down_sync(kFull, s, off);
      if (lane + off < 32 && so == s) v = Op::combine(v, vo);
    }
    const int s_prev = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_prev != s;
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
    const unsigned heads = __ballot_sync(kFull, head);
    const int last_head = 31 - __clz(heads);
    open_val = __shfl_sync(kFull, v, last_head);
    open_seg = s_last;
    open_shared = last_head == 0 && lane0_shared;
  }
  // The open segment touches the range's last edge: the next range may hold
  // more of it.
  if (lane == 0) emit<Op>(y, open_seg, open_val, true, n_out);
}

template <class Op>
int launch(const void* dst, const void* seg_id, const void* wt, const void* x,
           void* y, long long n_edges, int n_x, int n_out, float fill,
           void* stream) {
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
    const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
    seg_reduce_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
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
  return launch<SumOp>(dst, seg_id, wt, x, y, n_edges, n_x, n_out, 0.0f,
                       stream);
}

extern "C" int gather_segmin_launch(const void* dst, const void* seg_id,
                                    const void* wt, const void* x, void* y,
                                    long long n_edges, int n_x, int n_out,
                                    void* stream) {
  return launch<MinOp>(dst, seg_id, wt, x, y, n_edges, n_x, n_out, kInf,
                       stream);
}
