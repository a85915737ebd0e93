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
//           in mma_bf16.cuh) in two launches; at D 256
//           attn_bwd_dq_wgmma, attn_bwd_dkdv_wgmma: warpgroup products
//           (wgmma), operands by TMA, warps specialised (below).
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
//   fp32: the same three scalar launches; Tiles<256> is 140,800 bytes (one
//     block an SM), and attn_bwd_dkdv's accumulate phase holds 2 x 16
//     float4 (dK and dV: 128 floats) a thread.
//   bf16: the mma.sync plan did not fit.  A warp's 16 x 256 fp32
//     accumulator is 128 registers a lane, so dQ ran 32-key tiles and dK /
//     dV ran as two launches over the same grid (dV alone, then dK alone),
//     each block 4 warps at 240-254 registers and 135 KB of shared memory:
//     one warp a scheduler, every ldmatrix -> mma -> exp chain exposed, S^T
//     formed twice and Q, dO, lse read twice (13 products a pair): 26.87 /
//     20.57 ms, 19.3-19.7x the bound.  The warpgroup plan (attn_bwd_*_wgmma,
//     below WgParams) is two launches of three warpgroups a block, one
//     block an SM (384 threads, 168 registers each at launch):
//     - warpgroup 0, the producer, cuts its registers to 24 (setmaxnreg);
//       one thread keeps the operand tiles in flight by TMA (4-D tensor
//       maps of q, k, v, dO, boxes of 64 rows x 64 columns, 128-byte
//       swizzle) into an mbarrier ring, each slot released by the
//       consumers' arrivals;
//     - warpgroups 1 and 2, the consumers, raise theirs to 240 and run
//       wgmma: m64n64k16 with A and B in shared memory for the scores
//       (S = Q K^T, dP = dO V^T, or their transposes), m64n256k16 with A in
//       registers and B (MN-major) in shared memory for the accumulations.
//       P^T and dS^T enter the second product from the registers that hold
//       them (the accumulator layout of m64nN is the A fragment layout of
//       the next k step, mma_bf16.cuh), not through shared memory: no
//       store, fence or barrier between the two products;
//     - attn_bwd_dq_wgmma: a block owns 128 query rows of one (b, h), 64 a
//       consumer; Q and dO stay in shared memory (128 KB), K and V tiles of
//       64 keys stream through three 32 KB slots, twice (sweep 1: S, dP,
//       online lse and delta = rowsum(P dP); sweep 2: S, dP, dS, dQ +=
//       dS K), 224 KB in all; S runs while V's tile is still in flight;
//     - attn_bwd_dkdv_wgmma: a block owns 64 keys of one (b, KV head); K
//       and V stay in shared memory, Q and dO tiles of 64 rows stream
//       through two stages over the group's heads and the rows the masks
//       admit; consumer 1 forms S^T and P^T and accumulates dV += P^T dO,
//       consumer 2 forms dP^T and accumulates dK += dS^T Q, with dS^T =
//       P^T (1 - t^2) (dP^T - delta), P^T (1 - t^2) handed over in fp32
//       through shared memory (one 16 KB buffer a stage, one named barrier
//       a stage).  Each consumer holds one 64 x 256 accumulator (128
//       registers a thread); S^T and dP^T are formed once, and Q, dO and
//       lse read once, a tile.
//     A pair costs 12 products of the 5 (6 a launch, the hi + lo pairs
//     included).  No atomics: each launch owns its rows of dq or its keys'
//     dk and dv, so two calls give the same bits.
//   Measured (scripts/attention_fwd_ab.py --bwd, in turns beside the
//   mma.sync plan; H100 80GB HBM3 at 700.00 W): global 11.78-11.83 ms
//   against 26.84-26.85 (2.28x), local 8.95-9.12 against 20.53-20.55
//   (2.28x), 8.5-8.6x the bound; the two launches take about the same time
//   (chip_smoke.py's profiled gemma2 train step), and the 12 products
//   issued a pair (3.3 TFLOP at the global shape) run at ~28% of the
//   tensor cores' peak.  ptxas: 168 registers at launch, no spill.  What is left: a consumer's exp and tanh do not
//   overlap its own products, and the dQ launch's V tile waits for the K
//   tile before it, three slots deep.
//
// Rounding.  A CPU emulation of the bf16 roundings against an fp64
// gradient chose three things (PERF.md).  delta is rowsum(P * dP) in fp32
// from sweep 1, not rowsum(dO * O): O reaches the backward rounded to
// bf16, and with q and k scaled by 4 (a peaked softmax, where dS cancels)
// that put dq and dk 3-5x past the 2e-2 tolerance.  dS enters dS K and
// dS^T Q as bf16 hi + lo (one rounding left dq 1.16x past it), and P
// enters P^T dO as hi + lo (one rounding left dv at 0.80 of it under
// MQA).  So the bf16 path issues per admitted (query, key) pair
// 2 D x (2 + 4 + 6) flops: 12 products of the 5 the function needs (so does
// the wgmma plan at D 256).  The fp32 path's delta is rowsum(P * dP) too: from the fp32 O
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

#include <cuda.h>
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

// Launches Kern (THREADS a block) with `bytes` of dynamic shared memory;
// the opt-in above 48 KB is set once per kernel.
template <auto Kern, int THREADS = NTHREADS, typename P>
cudaError_t launch_with_smem(dim3 grid, size_t bytes, const P& p, cudaStream_t stream) {
  static const cudaError_t attr =
      bytes > 48 * 1024 ? cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes))
                        : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  Kern<<<grid, THREADS, bytes, stream>>>(p);
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
template <int D, int N8, int LD>
__device__ __forceinline__ void two_products(float (&s)[N8][4], float (&dp)[N8][4], const bf16* a,
                                             const bf16* a2, const bf16* bm, const bf16* bm2,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t fa[4], fa2[4];
    const int a_off = (lane & 15) * LD + ks * 16 + (lane >> 4) * 8;
    mma::ldmatrix_x4(fa, a + a_off);
    mma::ldmatrix_x4(fa2, a2 + a_off);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t fb[4], fb2[4];
      const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
      mma::ldmatrix_x4(fb, bm + b_off);
      mma::ldmatrix_x4(fb2, bm2 + b_off);
      mma::mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      mma::mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
      mma::mma_bf16(dp[2 * np], fa2, fb2[0], fb2[1]);
      mma::mma_bf16(dp[2 * np + 1], fa2, fb2[2], fb2[3]);
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
  static constexpr int BK = 64;     // keys a K/V tile
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

// Launch 2: dK and dV of 64 keys of one (b, KV head).
template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_bf16(const Params p) {
  using S = KvSmem<D>;
  constexpr int LD = S::LD;
  constexpr int BQ = S::BQ;
  constexpr int NQT = BQ / 8;  // n8 tiles of a (transposed) score tile
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
    two_products<D, NQT, LD>(st, dpt, Kw, Vw, Qs, dOs, lane);
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
        dpt[j][e] = pe * (dpt[j][e] - delta[col]) * dcap;
      }
#pragma unroll
    for (int kk = 0; kk < NQT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      split_fragment<NQT>(st, kk, hi, lo);
      split_product<D, LD>(dv, hi, lo, dOs, kk, lane);
      split_fragment<NQT>(dpt, kk, hi, lo);
      split_product<D, LD>(dk, hi, lo, Qs, kk, lane);
    }
  }
  mma::cp_async_wait<0>();  // K and V, where the block saw no query
  store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dks[0] + kvh * p.dks[1], p.dks[2], dk, p.scale,
                kw0, p.Sk, lane);
  store_rows<D>(static_cast<bf16*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[1], p.dvs[2], dv, 1.f, kw0,
                p.Sk, lane);
}

// ---------------------------------------------------------------------------
// bf16 at head dim 256: warpgroup kernels (wgmma), operands by TMA, warps
// specialised.  A block is three warpgroups: warpgroup 0 is the producer
// (one thread keeps TMA loads in flight into an mbarrier ring; its
// registers cut to W_PRODUCER_REGS), warpgroups 1 and 2 the consumers
// (W_CONSUMER_REGS each), which run the products.  Every operand tile is
// 64 rows of D 256 as four 128-byte-swizzled 64-column slabs
// (mma_bf16.cuh, namespace wgmma), loaded by four TMA boxes of 64 x 64.

constexpr int W_D = 256;
constexpr int W_ROWS = 64;                       // rows of a box, of a tile, of a consumer
constexpr int W_THREADS = 3 * 128;
constexpr uint32_t W_BOX = W_ROWS * 128;         // one 64 x 64 bf16 box: 8 KB
constexpr uint32_t W_TILE = (W_D / 64) * W_BOX;  // a 64-row tile of D 256: 32 KB
constexpr int W_PRODUCER_REGS = 24, W_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536

struct WgParams {
  CUtensorMap q, k, v, dout;  // (D, heads, seq, B) bf16, boxes of 64 x 1 x 64 x 1, 128-byte swizzle
  Params p;
};

// Accumulator columns 16 kk .. 16 kk + 15 of a m64nN tile as the hi and lo
// bf16 A fragments of k step kk of the next product.
template <int N>
__device__ __forceinline__ void wg_split(const float (&s)[N], int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mma::split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], hi[i], lo[i]);
}

// acc (64 x 256) += (hi + lo) B, k steps 0..3 (64 rows of B, MN-major in
// `tile`): eight asynchronous products, then waited for.
__device__ __forceinline__ void wg_split_products(float (&acc)[128], const float (&s)[32],
                                                  const char* tile) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg_split<32>(s, kk, hi[kk], lo[kk]);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = wgmma::desc_mn(tile, kk, W_BOX);
    wgmma::m64n256k16_rs(acc, hi[kk], b);
    wgmma::m64n256k16_rs(acc, lo[kk], b);
  }
  wgmma::commit();
  wgmma::wait<0>();
}

// s (64 x 64) = A B^T over k = D 256, A the 64 rows at `a` (slabs
// `a_slab` bytes apart), B the tile at `bt` (slabs W_BOX apart), issued
// and committed (not waited for).
__device__ __forceinline__ void wg_scores(float (&s)[32], const char* a, uint32_t a_slab,
                                          const char* bt) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma::fence();
#pragma unroll
  for (int ks = 0; ks < W_D / 16; ++ks)
    wgmma::m64n64k16_ss(s, wgmma::desc_k(a, ks, a_slab), wgmma::desc_k(bt, ks, W_BOX));
  wgmma::commit();
}

// 64 rows of fp32 accumulators (rows row0 + 16 warp + g, + 8; 256 columns)
// times `mul` as bf16 into global rows of stride `stride`, rows < rows.
__device__ __forceinline__ void wg_store(bf16* dst, int64_t stride, const float (&acc)[128],
                                         float mul, int row0, int rows) {
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * w + (lane >> 2) + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(dst + row * stride + 8 * j + 2 * (lane & 3)) =
          mma::pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// Launch 1 at D 256, attn_bwd_dq_wgmma: lse, delta and dQ of 128 query
// rows of one (b, h), 64 a consumer warpgroup.  Q and dO stay in shared
// memory; K and V tiles of 64 keys stream through a ring of three 32 KB
// slots, K then V of each tile, twice (sweep 1: S and dP for lse and
// delta; sweep 2: S and dP again, dS, dQ += dS K).
struct DqWg {  // bytes from the aligned base
  static constexpr int BQ = 2 * W_ROWS;
  static constexpr int SLOTS = 3;
  static constexpr uint32_t SLAB = BQ * 128;              // a 128-row slab of Q or dO
  static constexpr uint32_t Q = 0, DO = Q + 4 * SLAB, RING = DO + 4 * SLAB;
  static constexpr uint32_t BARS = RING + SLOTS * W_TILE;  // qbar, full[SLOTS], empty[SLOTS]
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * SLOTS) + 1024;
};

__global__ void __launch_bounds__(W_THREADS, 1) attn_bwd_dq_wgmma(const __grid_constant__ WgParams wp) {
  using S = DqWg;
  const Params& p = wp.p;
  char* sm = wgmma::aligned_smem();
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S::SLOTS;
  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest causal tiles first
  const int q0 = qt * S::BQ;
  const int kvh = h / (p.H / p.KV);
  // Keys any row of the block can see: tiles t_lo .. t_lo + ntiles - 1.
  const int q_last = min(q0 + S::BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / W_ROWS;
  const int ntiles = k_hi > k_lo ? (k_hi + W_ROWS - 1) / W_ROWS - t_lo : 0;
  if (threadIdx.x == 0) {
    mma::mbar_init(qbar, 1);
    for (int i = 0; i < S::SLOTS; ++i) {
      mma::mbar_init(&full[i], 1);
      mma::mbar_init(&empty[i], 2 * 128);
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: Q and dO once, then K_t, V_t of every tile, twice
    wgmma::regs_dec<W_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mma::mbar_expect_tx(qbar, 8 * 2 * W_BOX);
      for (int half = 0; half < 2; ++half) {
        wgmma::tma_tile<W_D>(sm + S::Q + half * W_BOX, S::SLAB, &wp.q, qbar, h,
                             q0 + W_ROWS * half, b);
        wgmma::tma_tile<W_D>(sm + S::DO + half * W_BOX, S::SLAB, &wp.dout, qbar, h,
                             q0 + W_ROWS * half, b);
      }
      for (int it = 0; it < 4 * ntiles; ++it) {
        const int slot = it % S::SLOTS;
        if (it >= S::SLOTS) mma::mbar_wait(&empty[slot], (it / S::SLOTS - 1) & 1);
        mma::mbar_expect_tx(&full[slot], W_TILE);
        wgmma::tma_tile<W_D>(sm + S::RING + slot * W_TILE, W_BOX, (it & 1) ? &wp.v : &wp.k,
                             &full[slot], kvh, (t_lo + (it >> 1) % ntiles) * W_ROWS, b);
      }
    }
    return;
  }

  wgmma::regs_inc<W_CONSUMER_REGS>();
  const int cw = wg - 1;  // this consumer's 64 rows: q0 + 64 cw ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int wq0 = q0 + W_ROWS * cw + 16 * warp;  // this warp's first row
  const int wg_q0 = q0 + W_ROWS * cw;
  const char* Qw = sm + S::Q + cw * W_BOX;
  const char* dOw = sm + S::DO + cw * W_BOX;
  auto slot_of = [&](int it) { return sm + S::RING + (it % S::SLOTS) * W_TILE; };
  auto wait_item = [&](int it) { mma::mbar_wait(&full[it % S::SLOTS], (it / S::SLOTS) & 1); };
  auto release = [&](int it) { mma::mbar_arrive(&empty[it % S::SLOTS]); };
  mma::mbar_wait(qbar, 0);

  // S and dP of a step's tile (items 2 step, 2 step + 1) for this
  // warpgroup's rows, waited for; false (both items released) where the
  // masks hide the whole tile from them.  The caller releases V's item.
  auto products = [&](int step, int key0, float (&s)[32], float (&dp)[32]) {
    const int ik = 2 * step;
    if (wg_q0 >= p.Sq || (p.causal && key0 > wg_q0 + W_ROWS - 1) ||
        (p.window > 0 && key0 + W_ROWS - 1 <= wg_q0 - p.window)) {
      wait_item(ik);
      wait_item(ik + 1);
      release(ik);
      release(ik + 1);
      return false;
    }
    wait_item(ik);
    wg_scores(s, Qw, S::SLAB, slot_of(ik));  // S runs while V's tile may still be in flight
    wait_item(ik + 1);
    wg_scores(dp, dOw, S::SLAB, slot_of(ik + 1));
    wgmma::wait<0>();
    return true;
  };
  auto need_mask = [&](int key0) {
    return key0 + W_ROWS > p.Sk || (p.causal && key0 + W_ROWS - 1 > wq0) ||
           (p.window > 0 && key0 <= wq0 + 15 - p.window);
  };
  auto hidden = [&](int key0, int i) {  // accumulator element i = 4 j + e
    return !visible(p, wq0 + mma::acc_row(lane, i & 3), key0 + 8 * (i >> 2) + mma::acc_col(lane, i & 3));
  };

  // Sweep 1: online max m, l = sum 2^(x - m) and dd = sum 2^(x - m) dP for
  // rows g and g + 8 of the warp (m quad-uniform, l and dd this lane's part).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int step = 0; step < ntiles; ++step) {
    const int key0 = (t_lo + step) * W_ROWS;
    float s[32], dp[32];
    if (!products(step, key0, s, dp)) continue;
    release(2 * step);
    release(2 * step + 1);
    const bool masked = need_mask(key0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float dcap;
      s[i] = masked && hidden(key0, i) ? -INFINITY : score2(s[i], p, dcap);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = mma::exp2_approx(m[r] - m_use);
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = mma::exp2_approx(s[4 * j + e] - m_use);
          sum += pe;
          dsum = fmaf(pe, dp[4 * j + e], dsum);
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
  float dq[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) dq[i] = 0.f;
  for (int step = ntiles; step < 2 * ntiles; ++step) {
    const int key0 = (t_lo + step - ntiles) * W_ROWS;
    float s[32], dp[32];
    if (!products(step, key0, s, dp)) continue;
    release(2 * step + 1);
    const bool masked = need_mask(key0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float dcap;
      const float x = score2(s[i], p, dcap);
      const int r = (i >> 1) & 1;
      const float pe = masked && hidden(key0, i) ? 0.f : mma::exp2_approx(x - lse[r]);
      s[i] = pe * (dp[i] - delta[r]) * dcap;
    }
    wg_split_products(dq, s, slot_of(2 * step));
    release(2 * step);
  }
  wg_store(static_cast<bf16*>(p.dq) + b * p.dqs[0] + h * p.dqs[1], p.dqs[2], dq, p.scale,
           wg_q0, p.Sq);
}

// Launch 2 at D 256, attn_bwd_dkdv_wgmma: dK and dV of 64 keys of one
// (b, KV head).  K and V stay in shared memory; Q, dO of 64 query rows
// stream through two stages over the GQA group's heads and the rows the
// masks admit.  Consumer 1 forms S^T = K Q^T, P^T and dV += P^T dO;
// consumer 2 forms dP^T = V dO^T, then dS^T from P^T (1 - t^2), which
// consumer 1 hands it through shared memory (Y, one buffer a stage, a
// named barrier a stage), and dK += dS^T Q.  S^T and dP^T are formed once,
// and Q, dO and lse read once.
struct KvWg {  // bytes from the aligned base
  static constexpr int STAGES = 2;
  static constexpr uint32_t K = 0, V = W_TILE, STAGE0 = 2 * W_TILE;  // stage i: Q, then dO
  static constexpr uint32_t Y = STAGE0 + STAGES * 2 * W_TILE;        // P^T (1 - t^2), fp32
  static constexpr uint32_t Y_BYTES = 32 * 128 * 4;
  static constexpr uint32_t BARS = Y + STAGES * Y_BYTES;  // kvbar, full[STAGES], empty[STAGES]
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

__global__ void __launch_bounds__(W_THREADS, 1) attn_bwd_dkdv_wgmma(const __grid_constant__ WgParams wp) {
  using S = KvWg;
  const Params& p = wp.p;
  char* sm = wgmma::aligned_smem();
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S::STAGES;
  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int key0 = blockIdx.y * W_ROWS;
  const int nkeys = min(W_ROWS, p.Sk - key0);
  const int group = p.H / p.KV;
  // Query rows that can see a key of this block: causal q >= key0; window
  // q < key_last + window.  Steps walk the group's heads, and each head's
  // rows in tiles of 64.
  const int q_begin = p.causal ? key0 : 0;
  const int q_end = p.window > 0 ? min(p.Sq, key0 + nkeys - 1 + p.window) : p.Sq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + W_ROWS - 1) / W_ROWS : 0;
  const int steps = group * nqt;
  if (threadIdx.x == 0) {
    mma::mbar_init(kvbar, 1);
    for (int i = 0; i < S::STAGES; ++i) {
      mma::mbar_init(&full[i], 1);
      mma::mbar_init(&empty[i], 2 * 128);
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: K and V once, then Q and dO of every step
    wgmma::regs_dec<W_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mma::mbar_expect_tx(kvbar, 2 * W_TILE);
      wgmma::tma_tile<W_D>(sm + S::K, W_BOX, &wp.k, kvbar, kvh, key0, b);
      wgmma::tma_tile<W_D>(sm + S::V, W_BOX, &wp.v, kvbar, kvh, key0, b);
      for (int step = 0; step < steps; ++step) {
        const int st = step % S::STAGES;
        if (step >= S::STAGES) mma::mbar_wait(&empty[st], (step / S::STAGES - 1) & 1);
        const int gi = step / nqt;
        const int q0 = q_begin + (step - gi * nqt) * W_ROWS;
        char* stage = sm + S::STAGE0 + st * 2 * W_TILE;
        mma::mbar_expect_tx(&full[st], 2 * W_TILE);
        wgmma::tma_tile<W_D>(stage, W_BOX, &wp.q, &full[st], kvh * group + gi, q0, b);
        wgmma::tma_tile<W_D>(stage + W_TILE, W_BOX, &wp.dout, &full[st], kvh * group + gi, q0, b);
      }
    }
    return;
  }

  wgmma::regs_inc<W_CONSUMER_REGS>();
  const int cw = wg - 1;  // 0: dV, 1: dK
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int kw0 = key0 + 16 * warp;  // this warp's first key (accumulator rows)
  float acc[128];  // dV (cw 0) or dK (cw 1): 64 keys x 256
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mma::mbar_wait(kvbar, 0);

  for (int step = 0; step < steps; ++step) {
    const int st = step % S::STAGES;
    const int gi = step / nqt;
    const int h = kvh * group + gi;
    const int q0 = q_begin + (step - gi * nqt) * W_ROWS;
    const char* Qs = sm + S::STAGE0 + st * 2 * W_TILE;
    const char* dOs = Qs + W_TILE;
    float* Y = reinterpret_cast<float*>(sm + S::Y + st * S::Y_BYTES);
    mma::mbar_wait(&full[st], (step / S::STAGES) & 1);
    // Nothing of this tile is visible to the block's keys (both consumers
    // agree): skip its products.
    if (!(key0 >= p.Sk || (p.causal && key0 > q0 + W_ROWS - 1) ||
          (p.window > 0 && key0 + W_ROWS - 1 <= q0 - p.window))) {
      const bool masked = kw0 + 16 > p.Sk || q0 + W_ROWS > p.Sq || (p.causal && kw0 + 15 > q0) ||
                          (p.window > 0 && q0 + W_ROWS - 1 - p.window >= kw0);
      const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
      float t[32];  // S^T (consumer 1) or dP^T (consumer 2): keys on rows, queries on columns
      if (cw == 0) {
        wg_scores(t, sm + S::K, W_BOX, Qs);
        float lse[16];  // of this thread's 16 query columns 8 j + 2 (lane & 3) + c
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = q0 + 8 * j + 2 * (lane & 3) + c;
            lse[2 * j + c] = q < p.Sq ? p.lse[row0 + q] : 0.f;
          }
        wgmma::wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + mma::acc_col(lane, i & 3);
          float dcap;
          const float x = score2(t[i], p, dcap);
          const float pe = masked && !visible(p, q0 + col, kw0 + mma::acc_row(lane, i & 3))
                               ? 0.f
                               : mma::exp2_approx(x - lse[(i >> 2) * 2 + (i & 1)]);
          t[i] = pe;
          Y[i * 128 + tid] = pe * dcap;
        }
        wgmma::bar_arrive(1 + st, 2 * 128);
        wg_split_products(acc, t, dOs);
      } else {
        wg_scores(t, sm + S::V, W_BOX, dOs);
        float delta[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = q0 + 8 * j + 2 * (lane & 3) + c;
            delta[2 * j + c] = q < p.Sq ? p.delta[row0 + q] : 0.f;
          }
        wgmma::wait<0>();
        wgmma::bar_sync(1 + st, 2 * 128);
#pragma unroll
        for (int i = 0; i < 32; ++i) t[i] = Y[i * 128 + tid] * (t[i] - delta[(i >> 2) * 2 + (i & 1)]);
        wg_split_products(acc, t, Qs);
      }
    }
    mma::mbar_arrive(&empty[st]);
  }
  if (cw == 0)
    wg_store(static_cast<bf16*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[1], p.dvs[2], acc, 1.f, key0,
             p.Sk);
  else
    wg_store(static_cast<bf16*>(p.dk) + b * p.dks[0] + kvh * p.dks[1], p.dks[2], acc, p.scale,
             key0, p.Sk);
}

// Head dim 256 in bf16: the two warpgroup launches.  A tensor map that
// cannot be encoded (no cuTensorMapEncodeTiled) is an error, not a
// fallback.
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  WgParams wp{};
  wp.p = p;
  if (!mma::encode_map(&wp.q, p.q, p.qs, W_D, p.H, p.Sq, p.B) ||
      !mma::encode_map(&wp.dout, p.dout, p.dos, W_D, p.H, p.Sq, p.B) ||
      !mma::encode_map(&wp.k, p.k, p.ks, W_D, p.KV, p.Sk, p.B) ||
      !mma::encode_map(&wp.v, p.v, p.vs, W_D, p.KV, p.Sk, p.B))
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_with_smem<attn_bwd_dq_wgmma, W_THREADS>(
      dim3(p.B * p.H, (p.Sq + DqWg::BQ - 1) / DqWg::BQ), DqWg::BYTES, wp, stream);
  if (err != cudaSuccess) return err;
  return launch_with_smem<attn_bwd_dkdv_wgmma, W_THREADS>(
      dim3(p.B * p.KV, (p.Sk + W_ROWS - 1) / W_ROWS), KvWg::BYTES, wp, stream);
}

template <int D>
cudaError_t launch_bf16_dim(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_with_smem<attn_bwd_dq_bf16<D>>(
      dim3(p.B * p.H, (p.Sq + DQ_BQ - 1) / DQ_BQ), DqSmem<D>::BYTES, p, stream);
  if (err != cudaSuccess || p.Sk == 0) return err;
  return launch_with_smem<attn_bwd_dkdv_bf16<D>>(dim3(p.B * p.KV, (p.Sk + KV_BK - 1) / KV_BK),
                                                 KvSmem<D>::BYTES, p, stream);
}

cudaError_t launch_bf16(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bf16_dim<16>(p, stream);
    case 32: return launch_bf16_dim<32>(p, stream);
    case 64: return launch_bf16_dim<64>(p, stream);
    case 80: return launch_bf16_dim<80>(p, stream);
    case 128: return launch_bf16_dim<128>(p, stream);
    case 256: return launch_wgmma(p, stream);
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
