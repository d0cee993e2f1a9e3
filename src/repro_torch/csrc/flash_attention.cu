// Blocked (flash) attention with GQA and an optional causal mask.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel): o = softmax(scale * q k^T + mask) v, with
// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], query head h reading kv head
// h / (Hq / Hkv), and the causal mask letting query row i see key j only if
// j <= i + Skv - Sq.  Logits, the running max, the denominator and the
// accumulator are float32 whatever the input type; the output has q's type.
// As in the reference, a masked logit is -1e30 (not -inf) and the
// denominator is max(l, 1e-20): a row that sees no key at all (Sq > Skv)
// then gets the mean of v over every key, exactly as the reference gives.
//
// Work split: one CTA of 256 threads per (query tile of BQ = 64 rows, query
// head, batch), looping over key tiles of BK rows.  The 256 threads form a
// 16 x 16 grid (ty, tx): thread (ty, tx) owns query rows 4*ty .. 4*ty+3 of
// the tile, score columns tx + 16*j of the key tile, and output columns
// tx + 16*k.  A row's 16 threads sit in one half of a warp, so the row max
// and row sum are shuffle reductions.  The q tile (pre-scaled), the k and v
// tiles and the probabilities are staged in shared memory as float32, with
// rows padded by one float so that the column reads do not collide in the
// banks.  Both products (q k^T and p v) are fused multiply-adds on the CUDA
// cores in this kernel's own body.
//
// Causal tiles past the tile's last visible key are skipped, but only when
// every row of the tile sees key 0 (q0 + Skv - Sq >= 0): a row with no
// visible key must take every key tile to give the reference's mean of v.
//
// What bounds it on an H100: arithmetic.  4 * B * Hq * Sq * Skv * D FLOPs
// (about half with the causal mask) against 3 to 4 bytes of q, k, v and o
// per 1,000 FLOPs at the shapes it runs, far above the card's ratio of
// operations to bytes.  On CUDA cores each step of the score product makes
// 8 shared-memory loads for 16 FMAs, so shared-memory bandwidth, not the
// FMA rate, sets its speed; the tensor cores (mma.sync, then wgmma fed by
// TMA) are the redesign that brings it toward the bf16 tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <int D>
struct Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;  // key rows per tile
  static constexpr int NJ = BK / 16;            // score columns a thread
  static constexpr int NK = D / 16;             // output columns a thread
  static constexpr int QS = D + 1;              // padded row of q and k
  static constexpr int PS = BK + 1;             // padded row of p
  static constexpr int kFloats = kBQ * QS + BK * QS + BK * D + kBQ * PS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, float scale, int causal) {
  using L = Tile<D>;
  constexpr int BK = L::BK, NJ = L::NJ, NK = L::NK, QS = L::QS, PS = L::PS;
  extern __shared__ float smem[];
  float* qs = smem;            // [kBQ][QS], pre-scaled
  float* ks = qs + kBQ * QS;   // [BK][QS]
  float* vs = ks + BK * QS;    // [BK][D]
  float* ps = vs + BK * D;     // [kBQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_base = ((int64_t)b * hq + h) * sq + q0;
  const int64_t kv_base = ((int64_t)b * hkv + hk) * skv;
  const T* qp = q + q_base * D;
  const T* kp = k + kv_base * D;
  const T* vp = v + kv_base * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    qs[(i / D) * QS + i % D] = to_float(qp[i]) * scale;
  }

  const int offs = skv - sq;  // row i sees key j iff j <= i + offs
  int n_tiles = skv / BK;
  if (causal && q0 + offs >= 0) {
    const int last = q0 + kBQ - 1 + offs;  // last key the tile can see
    n_tiles = min(n_tiles, last / BK + 1);
  }

  float m[4], l[4], acc[4][NK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NK; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    const T* kt_p = kp + (int64_t)k0 * D;
    const T* vt_p = vp + (int64_t)k0 * D;
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      ks[r * QS + c] = to_float(kt_p[i]);
      vs[r * D + c] = to_float(vt_p[i]);
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bk[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (causal && k0 + tx + 16 * j > row + offs) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NK; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const float vv = vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* op = o + q_base * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      op[(ty * 4 + i) * D + tx + 16 * c] = from_float<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = Tile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(sq / kBQ, hq, b);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int d, float scale,
             int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  The caller checks the shapes:
// contiguous [B, H, S, D] tensors, Hq % Hkv == 0, Sq % 64 == 0 and Skv a
// multiple of the key tile (both sequence lengths multiples of 128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int b, int hq, int hkv, int sq,
                                      int skv, int d, float scale,
                                      int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0 || skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, b, hq, hkv, sq, skv, d, scale,
                             causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d,
                                     scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, o, b, hq, hkv, sq, skv, d, scale,
                              causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
