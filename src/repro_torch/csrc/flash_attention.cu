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
// Causal tiles past the tile's last visible key are skipped, but only when
// every row of the tile sees key 0 (q0 + Skv - Sq >= 0): a row with no
// visible key must take every key tile to give the reference's mean of v.
//
// What bounds it on an H100: arithmetic.  4 * B * Hq * Sq * Skv * D FLOPs
// (about half with the causal mask) against 3 to 4 bytes of q, k, v and o
// per 1,000 FLOPs at the shapes it runs, far above the card's ratio of
// operations to bytes: the bound is the FLOPs over the dense bf16
// tensor-core peak.
//
// Two kernels; the caller picks by dtype and head dim, nothing else.
//
// flash_mma_kernel (bfloat16 and float16, D 64 and 128): the tensor cores,
// through mma.sync.m16n8k16 with float32 accumulators (an FA2-style
// forward).  One CTA of 4 warps per (64-query tile, query head, batch); each
// warp owns 16 query rows, whose q fragments it loads once with ldmatrix.
// K and V tiles of 64 keys sit in shared memory in the input type, rows
// padded by 16 bytes so that the 8 row addresses of an ldmatrix phase fall
// in 8 different bank groups; they are double-buffered with 16-byte
// cp.async, tile kt+1 loading while tile kt computes.  S = q k^T comes from
// ldmatrix'd k fragments; the scale (times log2 e, for exp2) is applied to
// S in float32; the online softmax runs in registers, a row's max and sum
// being two quad shuffles, since a row of the m16n8 accumulator lives in 4
// threads.  For P V the S accumulators become A fragments in registers and
// V is read with ldmatrix.trans.  The Pallas kernel keeps p in float32, and
// rounding p to 16 bits would err by up to 1.8x the check's limit at 4,096
// keys, so p is split in two: p_hi = T(p), p_lo = T(p - p_hi), and both
// products go into O.  That costs 1.5x the tensor-core work of one
// rounding; the denominator sums the unrounded p.  Causal q tiles are
// handed out heaviest first (blockIdx.x reversed).
//
// flash_kernel (float32 at every D, and D 32 and 256): CUDA cores.  One CTA
// of 256 threads per (query tile of BQ = 64 rows, query head, batch),
// looping over key tiles of BK rows.  The 256 threads form a 16 x 16 grid
// (ty, tx): thread (ty, tx) owns query rows 4*ty .. 4*ty+3 of the tile,
// score columns tx + 16*j of the key tile, and output columns tx + 16*k.  A
// row's 16 threads sit in one half of a warp, so the row max and row sum
// are shuffle reductions.  The q tile (pre-scaled), the k and v tiles and
// the probabilities are staged in shared memory as float32, with rows
// padded by one float so that the column reads do not collide in the
// banks.  Both products are fused multiply-adds; each step of the score
// product makes 8 shared-memory loads for 16 FMAs, so shared-memory
// bandwidth, not the FMA rate, sets its speed.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------- tensor cores
constexpr int kMmaBQ = 64;        // query rows a CTA (16 a warp)
constexpr int kMmaBK = 64;        // keys a tile
constexpr int kMmaThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaTile {
  static constexpr int RS = D + 8;  // padded row (elements): +16 bytes
  // q, then two stages of k, then two stages of v.
  static constexpr size_t kBytes =
      sizeof(uint16_t) * (kMmaBQ + 4 * kMmaBK) * RS;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The 16-bit input type's packing and its m16n8k16 product (D += A B).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    __nv_bfloat162 v;
    memcpy(&v, &u, 4);
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    __half2 v;
    memcpy(&v, &u, 4);
    return __half22float2(v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Copy `rows` rows of D elements (row stride D in global memory) into
// shared memory rows of stride RS, 16 bytes a thread per step.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    cp_async16(dst + r * MmaTile<D>::RS + cc * 8,
               src + static_cast<int64_t>(r) * D + cc * 8);
  }
}

// Two float32 values of p as the two 16-bit halves of an A register: the
// rounded value and the rounded rest.
template <typename T>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Mma<T>::pack(a, b);
  const float2 r = Mma<T>::unpack(hi);
  lo = Mma<T>::pack(a - r.x, b - r.y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int hq,
                     int hkv, int sq, int skv, float scale_log2,
                     int causal) {
  constexpr int RS = MmaTile<D>::RS;
  constexpr int KD = D / 16;       // k16 steps over the head dim
  constexpr int NS = kMmaBK / 8;   // n8 tiles of S (keys)
  constexpr int KK = kMmaBK / 16;  // k16 steps over the keys
  constexpr int NO = D / 8;        // n8 tiles of O (head dim)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kMmaBQ][RS]
  T* ks = qs + kMmaBQ * RS;                // [2][kMmaBK][RS]
  T* vs = ks + 2 * kMmaBK * RS;            // [2][kMmaBK][RS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // Causal: the last q tiles see the most keys; start them first.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kMmaBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_base = ((int64_t)b * hq + h) * sq + q0;
  const int64_t kv_base = ((int64_t)b * hkv + hk) * skv;
  const T* kp = k + kv_base * D;
  const T* vp = v + kv_base * D;

  const int offs = skv - sq;  // row i sees key j iff j <= i + offs
  int n_tiles = skv / kMmaBK;
  if (causal && q0 + offs >= 0) {
    const int last = q0 + kMmaBQ - 1 + offs;  // last key the tile can see
    n_tiles = min(n_tiles, last / kMmaBK + 1);
  }

  load_rows<T, D>(qs, q + q_base * D, kMmaBQ);
  load_rows<T, D>(ks, kp, kMmaBK);
  load_rows<T, D>(vs, vp, kMmaBK);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A fragments of this warp's 16 q rows, one set per k16 step of D.
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    ldsm_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * RS + kd * 16 +
                        (lane >> 4) * 8);
  }

  // Rows g and g + 8 of the warp's 16: [0] and [1] below.
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      const int64_t next = static_cast<int64_t>(kt + 1) * kMmaBK * D;
      load_rows<T, D>(ks + (st ^ 1) * kMmaBK * RS, kp + next, kMmaBK);
      load_rows<T, D>(vs + (st ^ 1) * kMmaBK * RS, vp + next, kMmaBK);
      cp_async_commit();
      cp_async_wait<1>();  // tile kt has landed; kt + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + st * kMmaBK * RS;
    const T* vst = vs + st * kMmaBK * RS;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        // Keys 16*np .. +15 as the B fragments of two n8 tiles.
        uint32_t bf[4];
        ldsm_x4(bf, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        Mma<T>::mma(s[2 * np], qf[kd], bf[0], bf[1]);
        Mma<T>::mma(s[2 * np + 1], qf[kd], bf[2], bf[3]);
      }
    }

    // Scale (in the log2 domain), mask, and the online softmax.
    const int k0 = kt * kMmaBK;
    const bool masked = causal && k0 + kMmaBK - 1 > q0 + offs;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked && k0 + n * 8 + 2 * tig + (e & 1) > row0 + (e >> 1) * 8 +
                                                          offs) {
          x = kNeg;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }

    // O += P V, p in two 16-bit parts.
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int cp = 0; cp < NO / 2; ++cp) {
        // Keys 16*kk .. +15, columns 16*cp .. +15, transposed.
        uint32_t bf[4];
        ldsm_x4_trans(bf, vst + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * RS +
                              cp * 16 + (lane >> 4) * 8);
        Mma<T>::mma(acc[2 * cp], ph, bf[0], bf[1]);
        Mma<T>::mma(acc[2 * cp], pl, bf[0], bf[1]);
        Mma<T>::mma(acc[2 * cp + 1], ph, bf[2], bf[3]);
        Mma<T>::mma(acc[2 * cp + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is read; the next loads may reuse it
  }

  T* op = o + q_base * D;
  const float den0 = fmaxf(l[0], 1e-20f), den1 = fmaxf(l[1], 1e-20f);
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = c * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(op + r0 * D + col) =
        Mma<T>::pack(acc[c][0] / den0, acc[c][1] / den0);
    *reinterpret_cast<uint32_t*>(op + (r0 + 8) * D + col) =
        Mma<T>::pack(acc[c][2] / den1, acc[c][3] / den1);
  }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, float scale, int causal,
               cudaStream_t stream) {
  const size_t bytes = MmaTile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(sq / kMmaBQ, hq, b);
  flash_mma_kernel<T, D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma_d(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int sq, int skv, int d, float scale,
                 int causal, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_mma<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                               causal, stream);
    case 128:
      return launch_mma<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                                causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------- CUDA cores
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

// The tensor-core kernel: dtype 1 bfloat16, 2 float16; d 64 or 128.  Shapes
// as for flash_attention_launch (Sq and Skv multiples of 64 suffice).
extern "C" int flash_attention_mma_launch(const void* q, const void* k,
                                          const void* v, void* o, int dtype,
                                          int b, int hq, int hkv, int sq,
                                          int skv, int d, float scale,
                                          int causal, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0 || skv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_mma_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d,
                                         scale, causal, s);
    case 2:
      return launch_mma_d<__half>(q, k, v, o, b, hq, hkv, sq, skv, d, scale,
                                  causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
