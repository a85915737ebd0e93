// Flash attention backward for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: nothing in Pallas.  The TPU kernel
// (src/repro/kernels/flash_attention.py::_attn_kernel) has no backward, and
// the JAX package trains by differentiating its jnp attention
// (src/repro/models/layers.py, jax.value_and_grad in train/steps.py).  The
// port's model sends attention through the hand-written forward
// (flash_attention.cu) on the card, so training needs this kernel: dq, dk
// and dv of the function kernels/ref.py::attention_ref defines.  With
// s = (q . k) / sqrt(D), the softcap t = tanh(s / c), s' = c t, the causal
// mask k <= q and the window mask k > q - window (both top-left), and
// P = softmax(s') over the visible keys:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)) * (1 - t^2),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
// with GQA summing dK / dV over the H / KV query heads of a KV head, and a
// fully masked row contributing nothing (no NaN).
//
// What bounds it.  At stablelm_3b's train shape (B 8, H = KV = 32, S 512,
// D 80, causal) the call must read q, k, v, o, dO and write dq, dk, dv:
// 168 MB in bf16 (50 us at 3.35 TB/s), 336 MB in fp32 (100 us); the
// function is five S^2 D products, halved by the causal mask, 26.8 GFLOP
// (27 us at the dense bf16 tensor-core peak, 400 us at the 67 TFLOP/s of
// fp32 FMA).  This first kernel computes in scalar fp32 FMAs for both
// dtypes, so fp32 FMA is its roof; and its three launches form q k^T three
// times and dO v^T twice: ~43 GFLOP of FMA work, so it cannot beat
// ~0.64 ms a call.  Tensor cores (mma.sync / wgmma) are later work.
//
// The design: deterministic, no atomics, nothing of the forward changed
// (flash_attention.cu is not edited, so the forward does not save lse).
//   Launch 1, a block per (b, h, 32 query rows): recompute each row's
//     log-sum-exp under the mask (online max / sum over 32-key tiles, a
//     lane per key) and write lse and delta = rowsum(dO * O), fp32.
//   Launch 2, a block per (b, KV head, 32 keys): K and V of the tile stay
//     in shared memory as fp32; for each query head of the GQA group, the
//     query rows the masks let see the tile are staged 32 at a time with
//     their dO.  A score phase (a lane per key, a warp per 8 rows) forms
//     s and dP, then P and dS, into shared memory; an accumulate phase
//     (4 threads per key, each a quarter of the columns) adds P^T dO to dV
//     and dS^T Q to dK in registers.  One block owns its keys' dk / dv, so
//     no two blocks write the same element.
//   Launch 3, a block per (b, h, 32 query rows): the same score phase for
//     each visible key tile, then dQ += dS K (4 threads per row).
// Shared-memory rows of K and V are padded to D + 4 floats and the P / dS
// rows to 33, so neither phase's reads collide in a bank.
//
// Strides are element strides of the (b, head, seq) axes; the last axis
// is contiguous, and every input pointer and stride 16-byte aligned (the
// Python wrapper checks, and makes dO contiguous where it is not).  dq,
// dk and dv are written element by element in q's / k's / v's dtype.
// Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;                 // keys per tile
constexpr int BQ = 32;                 // query rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;       // rows per warp in the score phase
constexpr int PSTR = BK + 1;           // row stride of the P and dS tiles
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, H, Sq) fp32, contiguous
  float* delta;  // (B, H, Sq) fp32, contiguous
  int B, H, KV, Sq, Sk;
  // (b, head, seq) element strides of q, k, v, o, dout, dq, dk, dv
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int causal, window;
  float softcap, scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  __device__ static void to_float(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void to_float(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy ROWS x D elements (row stride `src_stride` elements) into fp32 shared
// memory (row stride `dst_stride` floats, a multiple of 4).  Rows at or past
// `rows_valid` are zero.  All NTHREADS threads of the block share the work.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* src,
                                          int64_t src_stride, int rows_valid) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int VPR = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NTHREADS) {
    const int row = idx / VPR;
    const int c = idx - row * VPR;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_valid) raw = __ldg(reinterpret_cast<const uint4*>(src + row * src_stride + c * VEC));
    float f[VEC];
    Elem<T>::to_float(raw, f);
    float* d = dst + row * dst_stride + c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) *reinterpret_cast<float4*>(d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// The scaled, soft-capped score and tanh of a raw product q . k.
__device__ __forceinline__ float capped(const Params& p, float dot, float& t) {
  const float s = dot * p.scale;
  if (p.softcap > 0.f) {
    t = tanhf(s / p.softcap);
    return p.softcap * t;
  }
  t = 0.f;
  return s;
}

// Keys any of the query rows [q0, q0 + BQ) can see: [k_lo, k_hi).
__device__ __forceinline__ void key_range(const Params& p, int q0, int& k_lo, int& k_hi) {
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
}

template <int D>
struct Tiles {
  static constexpr int KSTR = D + 4;  // K / V row stride in floats
  static constexpr int K = 0;
  static constexpr int V = K + BK * KSTR;
  static constexpr int Q = V + BK * KSTR;
  static constexpr int DO = Q + BQ * D;
  static constexpr int P = DO + BQ * D;
  static constexpr int DS = P + BQ * PSTR;
  static constexpr int L = DS + BQ * PSTR;
  static constexpr int DL = L + BQ;
  static constexpr int FLOATS = DL + BQ;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Score phase of launches 2 and 3: for the BQ staged query rows (query
// positions q0 + r) against the BK staged keys (positions key0 + j), write
// P (when Ps is not null) and dS (before the 1 / sqrt(D)) into shared
// memory, [r][PSTR].  Warp w takes rows w * RPW .. + RPW, lane j key j.
template <int D>
__device__ __forceinline__ void score_phase(const Params& p, const float* sm, float* Ps,
                                            float* dSs, int q0, int key0) {
  using S = Tiles<D>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * RPW;
  float s[RPW], dp[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
  const float* krow = sm + S::K + lane * S::KSTR;
  const float* vrow = sm + S::V + lane * S::KSTR;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(krow + d);
    const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 qq = *reinterpret_cast<const float4*>(sm + S::Q + (row0 + i) * D + d);
      const float4 oo = *reinterpret_cast<const float4*>(sm + S::DO + (row0 + i) * D + d);
      s[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[i]))));
      dp[i] = fmaf(oo.x, vv.x, fmaf(oo.y, vv.y, fmaf(oo.z, vv.z, fmaf(oo.w, vv.w, dp[i]))));
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + i;
    float t;
    const float sv = capped(p, s[i], t);
    const float pr = visible(p, q0 + r, key0 + lane) ? expf(sv - sm[S::L + r]) : 0.f;
    float ds = pr * (dp[i] - sm[S::DL + r]);
    if (p.softcap > 0.f) ds *= 1.f - t * t;
    if (Ps) Ps[r * PSTR + lane] = pr;
    dSs[r * PSTR + lane] = ds;
  }
}

// Stage rows [q0, q0 + BQ) of one head's q and dO, and their lse / delta.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const Params& p, float* sm, int b, int h, int q0) {
  using S = Tiles<D>;
  const int rows = p.Sq - q0;
  load_rows<T, D, BQ>(sm + S::Q, D, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2],
                      p.qs[2], rows);
  load_rows<T, D, BQ>(sm + S::DO, D,
                      static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2],
                      p.dos[2], rows);
  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    sm[S::L + r] = r < rows ? p.lse[row + r] : 0.f;
    sm[S::DL + r] = r < rows ? p.delta[row + r] : 0.f;
  }
}

// Launch 1: lse and delta of 32 query rows of one (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_prep(const Params p) {
  constexpr int KSTR = D + 4;
  __shared__ __align__(16) float Qs[BQ * D];
  __shared__ __align__(16) float Ks[BK * KSTR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (p.H / p.KV);
  const int row0 = warp * RPW;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];

  load_rows<T, D, BQ>(Qs, D, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2],
                      p.qs[2], p.Sq - q0);
  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  for (int key0 = (k_lo / BK) * BK; key0 < k_hi; key0 += BK) {
    __syncthreads();
    load_rows<T, D, BK>(Ks, KSTR, kg + key0 * p.ks[2], p.ks[2], p.Sk - key0);
    __syncthreads();
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + lane * KSTR + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (row0 + i) * D + d);
        s[i] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, s[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float t;
      const bool ok = visible(p, q0 + row0 + i, key0 + lane);
      const float sv = ok ? capped(p, s[i], t) : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float e = ok ? expf(sv - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(e);
      m[i] = m_new;
    }
  }

  const T* og = static_cast<const T*>(p.o) + b * p.os[0] + h * p.os[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1];
  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + i;
    if (q0 + r >= p.Sq) break;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(Elem<T>::load(dog + (q0 + r) * p.dos[2] + d), Elem<T>::load(og + (q0 + r) * p.os[2] + d), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      p.lse[row + r] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      p.delta[row + r] = acc;
    }
  }
}

// Launch 2: dK and dV of 32 keys of one (b, KV head).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv(const Params p) {
  using S = Tiles<D>;
  constexpr int NC = D / 16;  // float4 column chunks a thread accumulates
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int key0 = blockIdx.x * BK;
  const int nkeys = min(BK, p.Sk - key0);
  const int group = p.H / p.KV;
  const int j = threadIdx.x >> 2;  // this thread's key in the accumulate phase
  const int cg = threadIdx.x & 3;  // and its column chunks cg + 4 i

  load_rows<T, D, BK>(sm + S::K, S::KSTR, static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1] + key0 * p.ks[2],
                      p.ks[2], nkeys);
  load_rows<T, D, BK>(sm + S::V, S::KSTR, static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1] + key0 * p.vs[2],
                      p.vs[2], nkeys);

  float4 dk[NC], dv[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Query rows that can see a key of this tile: causal q >= key0; window
  // q < key_last + window.
  const int q_begin = p.causal ? key0 : 0;
  const int q_end = p.window > 0 ? min(p.Sq, key0 + nkeys - 1 + p.window) : p.Sq;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous rows' accumulate phase is done
      stage_rows<T, D>(p, sm, b, h, q0);
      __syncthreads();
      score_phase<D>(p, sm, sm + S::P, sm + S::DS, q0, key0);
      __syncthreads();
      const int rows = min(BQ, p.Sq - q0);
      for (int r = 0; r < rows; ++r) {
        const float pr = sm[S::P + r * PSTR + j];
        const float ds = sm[S::DS + r * PSTR + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = 4 * (cg + 4 * i);
          const float4 oo = *reinterpret_cast<const float4*>(sm + S::DO + r * D + c);
          const float4 qq = *reinterpret_cast<const float4*>(sm + S::Q + r * D + c);
          dv[i].x = fmaf(pr, oo.x, dv[i].x);
          dv[i].y = fmaf(pr, oo.y, dv[i].y);
          dv[i].z = fmaf(pr, oo.z, dv[i].z);
          dv[i].w = fmaf(pr, oo.w, dv[i].w);
          dk[i].x = fmaf(ds, qq.x, dk[i].x);
          dk[i].y = fmaf(ds, qq.y, dk[i].y);
          dk[i].z = fmaf(ds, qq.z, dk[i].z);
          dk[i].w = fmaf(ds, qq.w, dk[i].w);
        }
      }
    }
  }

  if (j >= nkeys) return;
  T* dkg = static_cast<T*>(p.dk) + b * p.dks[0] + kvh * p.dks[1] + (key0 + j) * p.dks[2];
  T* dvg = static_cast<T*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[1] + (key0 + j) * p.dvs[2];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (cg + 4 * i);
    dkg[c] = Elem<T>::from_float(dk[i].x * p.scale);
    dkg[c + 1] = Elem<T>::from_float(dk[i].y * p.scale);
    dkg[c + 2] = Elem<T>::from_float(dk[i].z * p.scale);
    dkg[c + 3] = Elem<T>::from_float(dk[i].w * p.scale);
    dvg[c] = Elem<T>::from_float(dv[i].x);
    dvg[c + 1] = Elem<T>::from_float(dv[i].y);
    dvg[c + 2] = Elem<T>::from_float(dv[i].z);
    dvg[c + 3] = Elem<T>::from_float(dv[i].w);
  }
}

// Launch 3: dQ of 32 query rows of one (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq(const Params p) {
  using S = Tiles<D>;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (p.H / p.KV);
  const int r = threadIdx.x >> 2;  // this thread's row in the accumulate phase
  const int cg = threadIdx.x & 3;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];

  stage_rows<T, D>(p, sm, b, h, q0);
  float4 dq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  for (int key0 = (k_lo / BK) * BK; key0 < k_hi; key0 += BK) {
    const int nkeys = min(BK, p.Sk - key0);
    __syncthreads();  // the previous tile's accumulate phase is done
    load_rows<T, D, BK>(sm + S::K, S::KSTR, kg + key0 * p.ks[2], p.ks[2], nkeys);
    load_rows<T, D, BK>(sm + S::V, S::KSTR, vg + key0 * p.vs[2], p.vs[2], nkeys);
    __syncthreads();
    score_phase<D>(p, sm, nullptr, sm + S::DS, q0, key0);
    __syncthreads();
    for (int jj = 0; jj < nkeys; ++jj) {
      const float ds = sm[S::DS + r * PSTR + jj];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(sm + S::K + jj * S::KSTR + 4 * (cg + 4 * i));
        dq[i].x = fmaf(ds, kk.x, dq[i].x);
        dq[i].y = fmaf(ds, kk.y, dq[i].y);
        dq[i].z = fmaf(ds, kk.z, dq[i].z);
        dq[i].w = fmaf(ds, kk.w, dq[i].w);
      }
    }
  }

  if (q0 + r >= p.Sq) return;
  T* dqg = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1] + (q0 + r) * p.dqs[2];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (cg + 4 * i);
    dqg[c] = Elem<T>::from_float(dq[i].x * p.scale);
    dqg[c + 1] = Elem<T>::from_float(dq[i].y * p.scale);
    dqg[c + 2] = Elem<T>::from_float(dq[i].z * p.scale);
    dqg[c + 3] = Elem<T>::from_float(dq[i].w * p.scale);
  }
}

// Launches Kern with `bytes` of dynamic shared memory; the opt-in above
// 48 KB is set once per kernel.
template <auto Kern>
cudaError_t launch_with_smem(dim3 grid, size_t bytes, const Params& p, cudaStream_t stream) {
  static const cudaError_t attr =
      bytes > 48 * 1024 ? cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes))
                        : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  Kern<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  static_assert(D % 16 == 0, "the accumulate phases split D into 4 x float4 columns");
  const dim3 rows_grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  attn_bwd_prep<T, D><<<rows_grid, NTHREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.Sk > 0) {
    err = launch_with_smem<attn_bwd_dkdv<T, D>>(dim3((p.Sk + BK - 1) / BK, p.KV, p.B),
                                                Tiles<D>::BYTES, p, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_with_smem<attn_bwd_dq<T, D>>(rows_grid, Tiles<D>::BYTES, p, stream);
}

template <typename T>
cudaError_t launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_all<T, 16>(p, stream);
    case 32: return launch_all<T, 32>(p, stream);
    case 64: return launch_all<T, 64>(p, stream);
    case 80: return launch_all<T, 80>(p, stream);
    case 128: return launch_all<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `strides` holds 24 element strides,
// the (b, head, seq) strides of q, k, v, o, dout, dq, dk, dv in that order.
// lse and delta are (B, H, Sq) fp32 scratch.  Returns a cudaError_t (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, int dtype, int B, int H, int KV, int Sq, int Sk,
                                   int D, const int64_t* strides, int causal, int window,
                                   float softcap, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, Sq, Sk};
  int64_t* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = strides[3 * t + a];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dim<float>(p, D, s); break;
    case 1: err = launch_dim<__nv_bfloat16>(p, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
