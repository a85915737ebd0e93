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
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(P * dP)) * (1 - t^2),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
// with GQA summing dK / dV over the H / KV query heads of a KV head, and a
// fully masked row contributing nothing (no NaN).  rowsum(P * dP) equals
// rowsum(dO * O) for the exact O.
//
// Two paths, chosen by dtype alone in flash_attention_bwd:
//   fp32 -> attn_bwd_prep, attn_bwd_dkdv, attn_bwd_dq: scalar fp32 FMAs
//           in three launches (TF32 products would miss the 1e-4 fp32
//           gradient tolerance);
//   bf16 -> attn_bwd_dq_bf16, attn_bwd_dkdv_bf16: tensor-core products
//           (mma.sync m16n8k16, bf16 operands, fp32 accumulators; helpers
//           in mma_bf16.cuh) in two launches (three at D 256, below).
//
// What bounds it.  At stablelm_3b's train shape (B 8, H = KV = 32, S 512,
// D 80, causal) the call must read q, k, v, o, dO and write dq, dk, dv:
// 168 MB in bf16 (50 us at 3.35 TB/s), 336 MB in fp32 (100 us); the
// function is five S^2 D products, halved by the causal mask, 26.8 GFLOP
// (27 us at the dense bf16 tensor-core peak, 400 us at the 67 TFLOP/s of
// fp32 FMA).  The scalar path's three launches form q k^T and dO v^T
// three times each: ~48 GFLOP of FMA work, so it cannot beat ~0.72 ms a
// call; it took 2.86-2.93 ms in either dtype (chip_smoke.py, H100 80GB
// HBM3 at 700 W), which is why bf16 moved to the tensor cores.
//
// The scalar design (fp32): deterministic, no atomics, nothing of the
// forward changed (the forward does not save lse).
//   Launch 1, a block per (b, h, 32 query rows): recompute each row's
//     log-sum-exp under the mask (online max / sum over 32-key tiles, a
//     lane per key) and, beside it, delta = rowsum(P * dP); write both,
//     fp32.
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
// The tensor-core design (bf16): FlashAttention-2's backward without
// atomics, so it stays deterministic.  Operand tiles live in bf16 shared
// memory (rows padded to D + 8, which keeps ldmatrix conflict-free) and
// stream by 16-byte cp.async, double-buffered: the next tile is in flight
// while this one computes, so one barrier a tile suffices.  Scores stay in
// fp32 accumulators and are turned into the A operands of the next
// products in registers (mma_bf16.cuh's fragment identity).
//   Launch 1, attn_bwd_dq_bf16, a block per (b, h, 64 query rows), a warp
//     per 16 rows, causal tiles longest first.  Two sweeps over the
//     64-key K/V tiles the masks admit, each forming S = Q K^T and
//     dP = dO V^T.  Sweep 1 keeps an online max m, l = sum 2^(x - m) and
//     sum 2^(x - m) dP per row (x = the score in log2 units), which give
//     lse and delta = rowsum(P * dP), written to the fp32 scratch for
//     launch 2 (lse in log2 units).  Sweep 2 forms P = 2^(x - lse) and dS,
//     and adds dS K to dQ.
//   Launch 2, attn_bwd_dkdv_bf16, a block per (b, KV head, 64 keys), a
//     warp per 16 keys; K and V of the block stay in shared memory, and
//     Q, dO, lse and delta stream in tiles of BQ query rows (64, or 32 at
//     D 128 to keep the dK and dV accumulators, 16 keys x D each, in
//     registers) over the GQA group's heads and the rows the masks admit.
//     A warp forms S^T = K Q^T and dP^T = V dO^T with keys on the
//     accumulator rows, then P^T and dS^T, and adds P^T dO to dV and
//     dS^T Q to dK.  One block owns its keys' dk / dv.
// Warps whose rows (keys) the masks hide from a whole tile skip its
// products; only tiles that straddle a mask or a ragged edge evaluate it.
//
// Head dim 256 (gemma2; every other config has D <= 128).  What bounds it:
// at gemma2's train shape (B 1, H 16, KV 8, S 8192, softcap 50) the
// global layer's causal mask admits 33,558,528 (query, key) pairs a head,
// five 2 D-flop products each: 1.374 TFLOP, 1.39 ms at 989 TFLOP/s; the
// local layer (window 4096) 25,167,872 pairs, 1.04 ms; the bytes (q, k,
// v, o, dO read, dq, dk, dv written) 0.12 ms.  Operations bound both.
// Registers bound the design: a warp's 16 x D fp32 accumulator is D / 2 =
// 128 registers a lane, of the 255 a thread may have.
//   fp32: the same three launches; Tiles<256> is 140,800 bytes (one block
//     an SM), and attn_bwd_dkdv's accumulate phase holds 2 x 16 float4
//     (dK and dV: 128 floats) a thread.
//   bf16 launch 1: dQ takes 128 registers, so K/V tiles shrink to 32 keys
//     (DqSmem::BK), which halves S and dP (32 registers, from 64); shared
//     memory 135,168 bytes (Q, dO: 2 x 64 rows; K, V: 2 x 2 x 32 rows; rows
//     of 264 bf16).  The D <= 128 instantiations keep 64-key tiles.
//   bf16 launch 2: dK and dV together would be 256 registers a lane, so at
//     D 256 the kernel runs twice over the same grid (PART): first dV
//     alone (S^T = K Q^T, P^T, dV += P^T dO as hi + lo: 3 products; V and
//     delta not read), then dK alone (S^T and dP^T, dS^T, dK += dS^T Q as
//     hi + lo: 4 products), each holding one 128-register accumulator
//     beside S^T / dP^T of a 32-query tile (32 registers).  KvSmem<256> is
//     135,680 bytes (K, V: 64 rows; Q, dO: 2 x 2 x 32 rows; lse, delta).
//     The cost: S^T = K Q^T is formed twice and Q, dO and lse are read
//     twice (from L2 mostly), so a pair costs 13 products of the 5 (6 in
//     launch 1, 3 + 4 in launch 2) where D <= 128 costs 12.  Splitting D's
//     columns between two warps instead would form S^T and dP^T twice (14
//     products) or pass them through shared memory.  No atomics: each
//     launch owns its keys' dk or dv, so the result stays deterministic.
//   Measured (chip_smoke.py's attention backward phase, H100 80GB HBM3 at
//   700 W): bf16 26.85 ms global, 20.57 ms local, 19.3-19.7x the bound
//   (cuDNN's SDPA backward without softcap, not the same function: 3.6-3.7
//   ms); ptxas at D 256 254 registers (launch 1), 240 / 242 (dV / dK), fp32
//   attn_bwd_dkdv 253, no spill.
//
// Rounding.  A CPU emulation of the bf16 roundings against an fp64
// gradient chose three things (PERF.md).  delta is rowsum(P * dP) in fp32
// from sweep 1, not rowsum(dO * O): O reaches the backward rounded to
// bf16, and with q and k scaled by 4 (a peaked softmax, where dS cancels)
// that put dq and dk 3-5x past the 2e-2 tolerance.  dS enters dS K and
// dS^T Q as bf16 hi + lo (one rounding left dq 1.16x past it), and P
// enters P^T dO as hi + lo (one rounding left dv at 0.80 of it under
// MQA).  So the bf16 path issues per admitted (query, key) pair
// 2 D x (2 + 4 + 6) flops: 12 products of the 5 the function needs (13 at
// D 256).  The fp32 path's delta is rowsum(P * dP) too: from the fp32 O
// it put dq up to 1.3x past 1e-4 at the same logits.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W) at the train shape:
// bf16 0.475 ms (the scalar kernels took 2.86 ms; SDPA's backward 0.28
// ms), ptxas 168 / 236 registers at D 80 and no spill; fp32 3.32 ms.
//
// Strides are element strides of the (b, head, seq) axes; the last axis
// is contiguous, and every input pointer and stride 16-byte aligned (the
// Python wrapper checks, and makes dO contiguous where it is not).  dq,
// dk and dv are written in q's / k's / v's dtype.  Neither path reads O.
// Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
  __device__ static float from_float(float x) { return x; }
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

// Launch 1: lse and delta of 32 query rows of one (b, h).  delta is
// rowsum(P * dP), kept online beside l from the same scores (dP = dO v^T
// a lane per key): rowsum(dO * O) from the forward's O put dq up to 1.3x
// past the 1e-4 tolerance with q and k scaled by 4.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_prep(const Params p) {
  using S = Tiles<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (p.H / p.KV);
  const int row0 = warp * RPW;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];

  load_rows<T, D, BQ>(sm + S::Q, D, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] +
                                        q0 * p.qs[2], p.qs[2], p.Sq - q0);
  load_rows<T, D, BQ>(sm + S::DO, D, static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1] +
                                         q0 * p.dos[2], p.dos[2], p.Sq - q0);
  float m[RPW], l[RPW], dd[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = dd[i] = 0.f;
  }
  int k_lo, k_hi;
  key_range(p, q0, k_lo, k_hi);
  for (int key0 = (k_lo / BK) * BK; key0 < k_hi; key0 += BK) {
    __syncthreads();
    load_rows<T, D, BK>(sm + S::K, S::KSTR, kg + key0 * p.ks[2], p.ks[2], p.Sk - key0);
    load_rows<T, D, BK>(sm + S::V, S::KSTR, vg + key0 * p.vs[2], p.vs[2], p.Sk - key0);
    __syncthreads();
    float s[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(sm + S::K + lane * S::KSTR + d);
      const float4 vv = *reinterpret_cast<const float4*>(sm + S::V + lane * S::KSTR + d);
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
      float t;
      const bool ok = visible(p, q0 + row0 + i, key0 + lane);
      const float sv = ok ? capped(p, s[i], t) : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float e = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(e);
      dd[i] = dd[i] * alpha + warp_sum(e * dp[i]);
      m[i] = m_new;
    }
  }

  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + i;
    if (q0 + r >= p.Sq) break;
    if (lane == 0) {
      p.lse[row + r] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
      p.delta[row + r] = l[i] > 0.f ? dd[i] / l[i] : 0.f;
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
  cudaError_t err = launch_with_smem<attn_bwd_prep<T, D>>(rows_grid, Tiles<D>::BYTES, p, stream);
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
    case 256: return launch_all<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, fp32 accumulators).

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DQ_BQ = NWARPS * 16;     // query rows of a launch-1 block, 16 a warp
constexpr int KV_BK = NWARPS * 16;     // keys of a launch-2 block, 16 a warp
// What a launch-2 block accumulates: dK and dV together up to D 128; at
// D 256 the two (256 registers a lane) do not fit, so dV and dK are two
// launches of the same kernel.
constexpr int DV_PART = 1, DK_PART = 2, DKDV_PART = DV_PART | DK_PART;

// The score of a raw product q . k in log2 units (scale, then softcap), and
// the softcap's derivative 1 - t^2 in `dcap` (1 without a softcap).
__device__ __forceinline__ float score2(float acc, const Params& p, float& dcap) {
  if (p.softcap > 0.f) {
    const float t = tanhf(acc * (p.scale / p.softcap));
    dcap = 1.f - t * t;
    return p.softcap * LOG2E * t;
  }
  dcap = 1.f;
  return acc * (p.scale * LOG2E);
}

// ROWS x D bf16 (row stride `stride`) into shared rows of stride LD by
// 16-byte cp.async; rows at or past rows_valid are zero-filled.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* src, int64_t stride,
                                           int rows_valid) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = idx - r * VPR;
    const bool ok = r < rows_valid;
    mma::cp_async16(dst + r * LD + c * 8, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// 4-byte cp.async (lse and delta rows start at any float); with `valid`
// false the word is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Accumulator tiles 2kk and 2kk + 1 (16 columns) as the hi and lo bf16 A
// fragments of the next product, the columns becoming its k index.
template <int N>
__device__ __forceinline__ void split_fragment(const float (&s)[N][4], int kk, uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  mma::split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
  mma::split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
  mma::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
  mma::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
}

// s += A B^T and dp += A2 B2^T for one warp: A and A2 are 16 rows of the
// shared tiles `a` and `a2` (row stride LD, k = D), B and B2 the N8 * 8
// rows of `bm` and `bm2`.  The two products share their loop and index maths.
// With SECOND false only s is formed (a2, bm2 and dp are not touched).
template <int D, int N8, int LD, bool SECOND = true>
__device__ __forceinline__ void two_products(float (&s)[N8][4], float (&dp)[N8][4], const bf16* a,
                                             const bf16* a2, const bf16* bm, const bf16* bm2,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4], fa2[4];
    const int a_off = (lane & 15) * LD + ks * 16 + (lane >> 4) * 8;
    mma::ldmatrix_x4(fa, a + a_off);
    if constexpr (SECOND) mma::ldmatrix_x4(fa2, a2 + a_off);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t fb[4], fb2[4];
      const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
      mma::ldmatrix_x4(fb, bm + b_off);
      if constexpr (SECOND) mma::ldmatrix_x4(fb2, bm2 + b_off);
      mma::mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma::mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
      if constexpr (SECOND) {
        mma::mma_bf16(dp[2 * np], fa2, fb2[0], fb2[1]);
        mma::mma_bf16(dp[2 * np + 1], fa2, fb2[2], fb2[3]);
      }
    }
  }
}

// acc += (hi + lo) M for one warp, M the 16 rows kk * 16.. of the shared
// tile `m` (row stride LD, n = D), read transposed by ldmatrix.
template <int D, int LD>
__device__ __forceinline__ void split_product(float (&acc)[D / 8][4], const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4], const bf16* m, int kk,
                                              int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t fb[4];
    mma::ldmatrix_x4_trans(fb, m + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                   (lane >> 4) * 8);
    mma::mma_bf16(acc[2 * dp], hi, fb[0], fb[1]);
    mma::mma_bf16(acc[2 * dp + 1], hi, fb[2], fb[3]);
    mma::mma_bf16(acc[2 * dp], lo, fb[0], fb[1]);
    mma::mma_bf16(acc[2 * dp + 1], lo, fb[2], fb[3]);
  }
}

// 16 rows of fp32 accumulators (rows row0 + g, + 8) times `mul` as bf16
// into global rows of stride `stride`; rows at or past `rows` are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t stride, const float (&acc)[D / 8][4],
                                           float mul, int row0, int rows, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + row * stride + nt * 8 + 2 * (lane & 3)) =
          mma::pack_bf16(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

template <int D>
struct DqSmem {  // in bf16 elements
  // Keys a K/V tile: 64, or 32 at D 256, where a warp's dQ (16 rows x D)
  // already takes 128 registers a lane and S and dP of 64 keys 64 more.
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int LD = D + 8;  // row stride: 16 bytes of padding keep ldmatrix conflict-free
  static constexpr int TILE = BK * LD;
  static constexpr int DO = DQ_BQ * LD;       // Q tile at 0, dO tile here
  static constexpr int KV0 = 2 * DQ_BQ * LD;  // K[i] = KV0 + i TILE, V[i] = K[2 + i]
  static constexpr size_t BYTES = sizeof(bf16) * (KV0 + 4 * TILE);
};

// Launch 1: lse, delta and dQ of 64 query rows of one (b, h).
template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_bf16(const Params p) {
  using S = DqSmem<D>;
  constexpr int LD = S::LD;
  constexpr int DQ_BK = S::BK;
  constexpr int NKT = DQ_BK / 8;  // n8 tiles of a score tile
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  // Causal q-tiles in decreasing length: the longest are scheduled first.
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * DQ_BQ;
  const int kvh = h / (p.H / p.KV);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] + kvh * p.vs[1];

  // Keys any row of this block can see: tiles t_lo .. t_lo + ntiles - 1,
  // walked twice (steps 0 .. ntiles - 1 and ntiles .. 2 ntiles - 1).
  const int q_last = min(q0 + DQ_BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / DQ_BK;
  const int ntiles = k_hi > k_lo ? (k_hi + DQ_BK - 1) / DQ_BK - t_lo : 0;
  auto tile_key0 = [&](int step) { return (t_lo + step % ntiles) * DQ_BK; };
  // K and V of a step's tile into buffer step & 1, as one cp.async group.
  auto load = [&](int step) {
    const int key0 = tile_key0(step);
    bf16* dst = sm + S::KV0 + (step & 1) * S::TILE;
    async_rows<D, DQ_BK, LD>(dst, kg + key0 * p.ks[2], p.ks[2], p.Sk - key0);
    async_rows<D, DQ_BK, LD>(dst + 2 * S::TILE, vg + key0 * p.vs[2], p.vs[2], p.Sk - key0);
    mma::cp_async_commit();
  };
  async_rows<D, DQ_BQ, LD>(sm, static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[1] +
                                   q0 * p.qs[2], p.qs[2], p.Sq - q0);
  async_rows<D, DQ_BQ, LD>(sm + S::DO, static_cast<const bf16*>(p.dout) + b * p.dos[0] +
                                           h * p.dos[1] + q0 * p.dos[2], p.dos[2], p.Sq - q0);
  mma::cp_async_commit();
  if (ntiles > 0) load(0);

  const int wq0 = q0 + warp * 16;  // this warp's first query row
  const bf16* Qw = sm + warp * 16 * LD;
  const bf16* dOw = sm + S::DO + warp * 16 * LD;
  // S = Q K^T and dP = dO V^T of a step's tile for this warp's rows, raw
  // fp32 accumulators; false where the masks hide the whole tile from the
  // warp's rows.  `need_mask`: whether any element of it is masked.  The
  // caller has waited for the tile.
  auto products = [&](int step, int key0, float (&s)[NKT][4], float (&dp)[NKT][4],
                      bool& need_mask) {
    if (wq0 >= p.Sq || (p.causal && key0 > wq0 + 15) ||
        (p.window > 0 && key0 + DQ_BK - 1 <= wq0 - p.window))
      return false;
    const bf16* Ks = sm + S::KV0 + (step & 1) * S::TILE;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    two_products<D, NKT, LD>(s, dp, Qw, dOw, Ks, Ks + 2 * S::TILE, lane);
    need_mask = key0 + DQ_BK > p.Sk || (p.causal && key0 + DQ_BK - 1 > wq0) ||
                (p.window > 0 && key0 <= wq0 + 15 - p.window);
    return true;
  };
  auto hidden = [&](int key0, int j, int e) {
    return !visible(p, wq0 + mma::acc_row(lane, e), key0 + 8 * j + mma::acc_col(lane, e));
  };
  // At the top of a step the only copy in flight is K/V of this step's
  // tile.  After the barrier every warp is done with the previous step,
  // whose buffers then take K/V of the next one.
  auto begin_step = [&](int step) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < 2 * ntiles) load(step + 1);
  };

  // Sweep 1: online max m, l = sum 2^(x - m) and dd = sum 2^(x - m) dP for
  // rows g and g + 8 of the warp (m quad-uniform, l and dd this lane's part).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int step = 0; step < ntiles; ++step) {
    begin_step(step);
    float s[NKT][4], dp[NKT][4];
    const int key0 = tile_key0(step);
    bool need_mask;
    if (!products(step, key0, s, dp, need_mask)) continue;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        s[j][e] = need_mask && hidden(key0, j, e) ? -INFINITY : score2(s[j][e], p, dcap);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = mma::exp2_approx(m[r] - m_use);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = mma::exp2_approx(s[j][e] - m_use);
          sum += pe;
          dsum = fmaf(pe, dp[j][e], dsum);
        }
      l[r] = l[r] * alpha + sum;
      dd[r] = dd[r] * alpha + dsum;
      m[r] = m_new;
    }
  }
  // lse (log2 units) and delta = rowsum(P dP) of the two rows; a row that
  // sees no key keeps lse 0 and delta 0 (its P is 0 everywhere).
  float lse[2], delta[2];
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r], dr = dd[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    dr += __shfl_xor_sync(0xffffffffu, dr, 1);
    dr += __shfl_xor_sync(0xffffffffu, dr, 2);
    lse[r] = lr > 0.f ? m[r] + log2f(lr) : 0.f;
    delta[r] = lr > 0.f ? dr / lr : 0.f;
    const int row = wq0 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < p.Sq) {
      p.lse[stat0 + row] = lse[r];
      p.delta[stat0 + row] = delta[r];
    }
  }

  // Sweep 2: P = 2^(x - lse), dS = P (dP - delta) (1 - t^2), dQ += dS K.
  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  for (int step = ntiles; step < 2 * ntiles; ++step) {
    begin_step(step);
    float s[NKT][4], dp[NKT][4];
    const int key0 = tile_key0(step);
    bool need_mask;
    if (!products(step, key0, s, dp, need_mask)) continue;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        const float x = score2(s[j][e], p, dcap);
        const float pe = need_mask && hidden(key0, j, e) ? 0.f : mma::exp2_approx(x - lse[e >> 1]);
        s[j][e] = pe * (dp[j][e] - delta[e >> 1]) * dcap;
      }
    const bf16* Ks = sm + S::KV0 + (step & 1) * S::TILE;
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      split_fragment<NKT>(s, kk, hi, lo);
      split_product<D, LD>(dq, hi, lo, Ks, kk, lane);
    }
  }
  mma::cp_async_wait<0>();  // Q and dO, copied by every thread, where the block saw no key
  store_rows<D>(static_cast<bf16*>(p.dq) + b * p.dqs[0] + h * p.dqs[1], p.dqs[2], dq, p.scale,
                wq0, p.Sq, lane);
}

template <int D>
struct KvSmem {  // in bf16 elements; lse and delta as fp32 after the tiles
  static constexpr int BQ = D <= 80 ? 64 : 32;  // query rows a tile
  static constexpr int LD = D + 8;
  static constexpr int QT = BQ * LD;               // one Q or dO tile
  static constexpr int V = KV_BK * LD;             // the block's K at 0, V here
  static constexpr int Q0 = 2 * KV_BK * LD;        // Q[i] = Q0 + i QT, dO[i] = Q[2 + i]
  static constexpr int STATS = Q0 + 4 * QT;        // lse[i] = i BQ, delta[i] = (2 + i) BQ floats
  static constexpr size_t BYTES = sizeof(bf16) * STATS + sizeof(float) * 4 * BQ;
};

// Launch 2: dK and dV (PART: DKDV_PART), or dV alone (DV_PART: S^T only,
// no V and no delta read) or dK alone (DK_PART), of 64 keys of one
// (b, KV head).
template <int D, int PART>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_bf16(const Params p) {
  using S = KvSmem<D>;
  constexpr int LD = S::LD;
  constexpr int BQ = S::BQ;
  constexpr int NQT = BQ / 8;  // n8 tiles of a (transposed) score tile
  constexpr bool WANT_DV = (PART & DV_PART) != 0;
  constexpr bool WANT_DK = (PART & DK_PART) != 0;
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);
  float* stats = reinterpret_cast<float*>(sm + S::STATS);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int key0 = blockIdx.y * KV_BK;
  const int nkeys = min(KV_BK, p.Sk - key0);
  const int group = p.H / p.KV;

  async_rows<D, KV_BK, LD>(sm, static_cast<const bf16*>(p.k) + b * p.ks[0] + kvh * p.ks[1] +
                                   key0 * p.ks[2], p.ks[2], nkeys);
  if constexpr (WANT_DK)
    async_rows<D, KV_BK, LD>(sm + S::V, static_cast<const bf16*>(p.v) + b * p.vs[0] +
                                            kvh * p.vs[1] + key0 * p.vs[2], p.vs[2], nkeys);
  mma::cp_async_commit();

  // Query rows that can see a key of this block: causal q >= key0; window
  // q < key_last + window.  Steps walk the GQA group's heads, and each
  // head's rows in tiles of BQ.
  const int q_begin = p.causal ? key0 : 0;
  const int q_end = p.window > 0 ? min(p.Sq, key0 + nkeys - 1 + p.window) : p.Sq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int steps = group * nqt;
  // Q, dO, lse and delta of a step's tile into buffer step & 1, as one
  // cp.async group.
  auto load = [&](int step) {
    const int gi = step / nqt;
    const int h = kvh * group + gi;
    const int q0 = q_begin + (step - gi * nqt) * BQ;
    const int buf = step & 1;
    async_rows<D, BQ, LD>(sm + S::Q0 + buf * S::QT, static_cast<const bf16*>(p.q) + b * p.qs[0] +
                                                       h * p.qs[1] + q0 * p.qs[2],
                          p.qs[2], p.Sq - q0);
    async_rows<D, BQ, LD>(sm + S::Q0 + (2 + buf) * S::QT, static_cast<const bf16*>(p.dout) +
                                                             b * p.dos[0] + h * p.dos[1] +
                                                             q0 * p.dos[2],
                          p.dos[2], p.Sq - q0);
    const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool ok = q0 + i < p.Sq;
      cp_async4(stats + buf * BQ + i, ok ? p.lse + row0 + i : p.lse, ok);
      if constexpr (WANT_DK)
        cp_async4(stats + (2 + buf) * BQ + i, ok ? p.delta + row0 + i : p.delta, ok);
    }
    mma::cp_async_commit();
  };
  if (steps > 0) load(0);

  const int kw0 = key0 + warp * 16;  // this warp's first key
  const bf16* Kw = sm + warp * 16 * LD;
  const bf16* Vw = sm + S::V + warp * 16 * LD;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  // At the top of a step the only copy in flight is this step's tile (and,
  // at step 0, K and V).  After the barrier every warp is done with the
  // previous step, whose buffers then take the next one.
  for (int step = 0; step < steps; ++step) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    const int q0 = q_begin + (step % nqt) * BQ;
    // Nothing of this tile is visible to this warp's keys: skip its products.
    if (kw0 >= p.Sk || (p.causal && kw0 > q0 + BQ - 1) ||
        (p.window > 0 && kw0 + 15 <= q0 - p.window))
      continue;
    const int buf = step & 1;
    const bf16* Qs = sm + S::Q0 + buf * S::QT;
    const bf16* dOs = sm + S::Q0 + (2 + buf) * S::QT;
    const float* lse = stats + buf * BQ;
    const float* delta = stats + (2 + buf) * BQ;
    float st[NQT][4], dpt[NQT][4];  // S^T and dP^T: keys on rows, queries on columns
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    two_products<D, NQT, LD, WANT_DK>(st, dpt, Kw, Vw, Qs, dOs, lane);
    const bool need_mask = kw0 + 16 > p.Sk || q0 + BQ > p.Sq || (p.causal && kw0 + 15 > q0) ||
                           (p.window > 0 && q0 + BQ - 1 - p.window >= kw0);
    // P^T into st, dS^T = P^T (dP^T - delta) (1 - t^2) into dpt.
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + mma::acc_col(lane, e);
        float dcap;
        const float x = score2(st[j][e], p, dcap);
        const float pe = need_mask && !visible(p, q0 + col, kw0 + mma::acc_row(lane, e))
                             ? 0.f
                             : mma::exp2_approx(x - lse[col]);
        st[j][e] = pe;
        if constexpr (WANT_DK) dpt[j][e] = pe * (dpt[j][e] - delta[col]) * dcap;
      }
#pragma unroll
    for (int kk = 0; kk < NQT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      if constexpr (WANT_DV) {
        split_fragment<NQT>(st, kk, hi, lo);
        split_product<D, LD>(dv, hi, lo, dOs, kk, lane);
      }
      if constexpr (WANT_DK) {
        split_fragment<NQT>(dpt, kk, hi, lo);
        split_product<D, LD>(dk, hi, lo, Qs, kk, lane);
      }
    }
  }
  mma::cp_async_wait<0>();  // K and V, where the block saw no query
  if constexpr (WANT_DK)
    store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dks[0] + kvh * p.dks[1], p.dks[2], dk, p.scale,
                  kw0, p.Sk, lane);
  if constexpr (WANT_DV)
    store_rows<D>(static_cast<bf16*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[1], p.dvs[2], dv, 1.f, kw0,
                  p.Sk, lane);
}

template <int D>
cudaError_t launch_bf16_dim(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_with_smem<attn_bwd_dq_bf16<D>>(
      dim3(p.B * p.H, (p.Sq + DQ_BQ - 1) / DQ_BQ), DqSmem<D>::BYTES, p, stream);
  if (err != cudaSuccess || p.Sk == 0) return err;
  const dim3 grid(p.B * p.KV, (p.Sk + KV_BK - 1) / KV_BK);
  if constexpr (D <= 128) {
    return launch_with_smem<attn_bwd_dkdv_bf16<D, DKDV_PART>>(grid, KvSmem<D>::BYTES, p, stream);
  } else {
    err = launch_with_smem<attn_bwd_dkdv_bf16<D, DV_PART>>(grid, KvSmem<D>::BYTES, p, stream);
    if (err != cudaSuccess) return err;
    return launch_with_smem<attn_bwd_dkdv_bf16<D, DK_PART>>(grid, KvSmem<D>::BYTES, p, stream);
  }
}

cudaError_t launch_bf16(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bf16_dim<16>(p, stream);
    case 32: return launch_bf16_dim<32>(p, stream);
    case 64: return launch_bf16_dim<64>(p, stream);
    case 80: return launch_bf16_dim<80>(p, stream);
    case 128: return launch_bf16_dim<128>(p, stream);
    case 256: return launch_bf16_dim<256>(p, stream);
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
    case 1: err = launch_bf16(p, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
