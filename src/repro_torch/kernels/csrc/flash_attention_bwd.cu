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
//   bf16 -> attn_bwd_dq_wgmma<D>, attn_bwd_dkdv_wgmma<D>: warpgroup
//           products (wgmma, bf16 operands, fp32 accumulators), operands
//           by TMA, warps specialised, in two launches at every head dim
//           (helpers in mma_bf16.cuh); D <= 128 one plan, D 256 the
//           specialisations' own (both below).
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
// The bf16 design below D 256 (attn_bwd_*_wgmma<D>, the plan above Bw):
// FlashAttention-2's backward without atomics, so it stays deterministic,
// on Hopper's warpgroup products.  At the train shapes every pair costs 12
// products of 2 D flops (the rounding notes below), so stablelm's call
// issues 64.5 GFLOP, 65 us at the bf16 peak against 50 us of bytes; and
// at 512 tokens an item sees only 1 to 8 tiles, so its loads and its
// epilogue weigh as much as its products.  A block is a TMA producer
// warpgroup (registers cut to 24) and two consumer warpgroups (240).
//   Launch 1, attn_bwd_dq_wgmma: items of 128 query rows of one (b, h), 64
//     a consumer, causal items longest first, one block an SM walking
//     them; Q and dO of the next item load into a second buffer while
//     this one runs, and K / V tiles of 64 keys stream through a ring of
//     6 (D 80, 128) or 12 slots that runs on across items.  Two sweeps
//     over the keys a consumer's rows see (consumer 0 skips the causal
//     diagonal's last tile): sweep 1 forms S = Q K^T and dP = dO
//     V^T (m64n64k16, both operands in shared memory) and keeps each
//     row's online max, sum and sum of P dP, which give lse and delta =
//     rowsum(P dP), written to the fp32 scratch for launch 2; sweep 2
//     forms S and dP again, dS, and dQ += dS K (m64nNk16, dS from
//     registers, N = max(64, D)), issued with the next tile's S and dP so
//     that its exp2 runs under dQ's products.  dQ leaves through the
//     consumer's rows of the Q slabs by TMA stores.
//   Launch 2, attn_bwd_dkdv_wgmma: items of 64 keys of one (b, KV head),
//     steps of 64 query rows over the GQA group's heads; each consumer
//     runs its own items from its own region of shared memory (K, V and
//     the stages of Q, dO, lse and delta, fed by its own producer thread
//     and warp), and holds dK and dV of its keys in registers (2 x D / 2
//     fp32 a thread: 128 at D 128).  With few items (below 4 an
//     SM: the GQA shapes) a block takes one item and its two consumers
//     split the steps, their partial sums meeting in shared memory at the
//     end; with many (MHA) a block an SM walks them, each consumer its own.
//     dK and dV leave through the consumer's K / V region by TMA stores.
// S^T, P^T and dS^T enter the next product from the registers that hold
// them (the accumulator layout of m64nN is the A fragment layout of the
// next k step, mma_bf16.cuh).  Products are issued on no condition; the
// masks are evaluated only on tiles that straddle them, one comparison a
// score against a bound the lane computes once.  The head-dim padding:
// the tensor maps keep the true D and TMA zero-fills a box's columns past
// it, so D 16, 32 and 80 read 64-column slabs, S takes D / 16 k steps,
// and the accumulations run N = max(64, D) (N 80 at D 80: a B operand
// over 1.25 swizzle atoms); the stores drop the columns past D.
// What was chosen on the card, in turns against the alternative
// (scripts/attention_fwd_ab.py --bwd, H100 80GB HBM3 at 700.00 W): the
// dq launch persistent over its items (a block an item was 1-3% slower);
// the dkdv consumers on items of their own for MHA (0.111 ms against
// 0.160 at stablelm's shape with both on one item of 128-row steps) but
// splitting an item for GQA (0.109 against 0.162 at qwen2_vl's, where
// 256 items leave the longest to one consumer); a dq consumer skipping
// the tiles its rows do not see (2-5%); the outputs by TMA stores through
// shared memory (5-9%: clock64 counters in a throwaway copy put a dkdv
// item's register-to-global stores at 3,430 cycles at stablelm's shape).
// No faster, each at every shape within noise or slower: S and dP of
// sweep 1's next tile issued before a tile's statistics (stablelm's dq
// 0.127 -> 0.153 ms), named-barrier turns between the consumers, a dkdv
// step's S^T and dP^T issued before the last step's accumulations (D 64
// and 80; at D 80 two stages a consumer starve it), five stages at D 64,
// and lse / delta read in pairs.  The same counters put a dkdv step at
// stablelm's shape at ~3,800 cycles: ~700 waiting for its stage (two at
// D 80), ~670 for S^T and dP^T, ~1,550 for P^T, dS^T and their hi + lo
// splits, ~880 for the accumulations.
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
//     20.57 ms, 19.3-19.7x the bound.  The warpgroup plan (the
//     specialisations attn_bwd_*_wgmma<256>) is two launches of three warpgroups a block, one
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
// gradient chose three things (tests/test_torch_flash_attention.py keeps
// it at D 80 and 128).  delta is rowsum(P * dP) in fp32
// from sweep 1, not rowsum(dO * O): O reaches the backward rounded to
// bf16, and with q and k scaled by 4 (a peaked softmax, where dS cancels)
// that put dq and dk 3-5x past the 2e-2 tolerance.  dS enters dS K and
// dS^T Q as bf16 hi + lo (one rounding left dq 1.16x past it), and P
// enters P^T dO as hi + lo (one rounding left dv at 0.80 of it under
// MQA).  So the bf16 path issues per admitted (query, key) pair
// 2 D x (2 + 4 + 6) flops: 12 products of the 5 the function needs, at
// every head dim.  The fp32 path's delta is rowsum(P * dP) too: from the fp32 O
// it put dq up to 1.3x past 1e-4 at the same logits.
//
// Measured (scripts/attention_fwd_ab.py --bwd, in turns beside the
// mma.sync plan this replaced, CUDA graphs of calls; H100 80GB HBM3 at
// 700.00 W), causal 8 x 512, ms (mma.sync plan; SDPA's backward; bound of
// bytes): stablelm (32, D 80) 0.2200-0.2242 (0.4502-0.4506; 0.2008;
// 0.0501), zamba2 (32, D 64) 0.1905-0.1918 (0.4041-0.4057; 0.1570;
// 0.0401), musicgen (24, D 64) 0.1533-0.1536 (0.3191-0.3198; 0.1231;
// 0.0301), phi3.5 (32 / 8, D 128) 0.2415-0.2445 (0.5883-0.5887; 0.2791;
// 0.0501), qwen2_vl (28 / 4) 0.2144-0.2160 (0.6497-0.6502; 0.2475;
// 0.0401), yi (56 / 8) 0.4048-0.4128 (1.0087-1.0158; 0.4618; 0.0801):
// 2.0-3.0x the mma.sync plan, 0.87-1.25x SDPA, the 12 products issued at
// 26-45% of the bf16 peak, 4.4-5.4x the bound; the two launches take
// about the same time.  The scalar kernels took 2.86 ms at stablelm's
// shape; fp32 3.33-3.34 ms.  ptxas: 168 registers at launch in both
// kernels; dq spills nothing, dkdv 32-44 bytes (its producer, at 24
// registers, spills the same at every D).

// Strides are element strides of the (b, head, seq) axes; the last axis
// is contiguous, and every input pointer and stride 16-byte aligned (the
// Python wrapper checks, and makes dO contiguous where it is not).  dq,
// dk and dv are written in q's / k's / v's dtype.  Neither path reads O.
// Launch errors are returned, never swallowed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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
// bf16: warpgroup kernels (wgmma) at every head dim, operands by TMA, warps
// specialised.  A block is three warpgroups: warpgroup 0 is the producer
// (its registers cut to W_PRODUCER_REGS; one thread keeps TMA loads in
// flight into an mbarrier ring), warpgroups 1 and 2 the consumers
// (W_CONSUMER_REGS each), which run the products.  Operand tiles are
// 128-byte-swizzled 64-column slabs (mma_bf16.cuh, namespace wgmma),
// loaded by TMA boxes of 64 rows x 64 columns; the maps keep the true D,
// and TMA fills a box's columns at or past it with zeros (D 16, 32, 80).
// Two kernel templates, attn_bwd_dq_wgmma<D> and attn_bwd_dkdv_wgmma<D>:
// the plan below serves D <= 128, and their D 256 specialisations keep
// the plan of gemma2's head dim (after them).

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// The score of a raw product q . k in log2 units (scale, then softcap), and
// the softcap's derivative 1 - t^2 in `dcap` (1 without a softcap).  The
// D 256 kernels' form.
__device__ __forceinline__ float score2(float acc, const Params& p, float& dcap) {
  if (p.softcap > 0.f) {
    const float t = tanhf(acc * (p.scale / p.softcap));
    dcap = 1.f - t * t;
    return p.softcap * LOG2E * t;
  }
  dcap = 1.f;
  return acc * (p.scale * LOG2E);
}

constexpr int W_D = 256;
constexpr int W_ROWS = 64;                       // rows of a box, of a K / V tile, of a consumer
constexpr int W_THREADS = 3 * 128;
constexpr uint32_t W_BOX = W_ROWS * 128;         // one 64 x 64 bf16 box: 8 KB
constexpr uint32_t W_TILE = (W_D / 64) * W_BOX;  // a 64-row tile of D 256: 32 KB
constexpr int W_PRODUCER_REGS = 24, W_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536

struct WgParams {
  CUtensorMap q, k, v, dout;  // (D, heads, seq, B) bf16, boxes of 64 x 1 x 64 x 1, 128-byte swizzle
  CUtensorMap dq, dk, dv;     // the same maps of the outputs (below D 256: TMA stores)
  Params p;
  int split;  // dkdv below D 256: the two consumers share each item (a block an item)
};

// Accumulator columns 16 kk .. 16 kk + 15 of a m64nN tile as the hi and lo
// bf16 A fragments of k step kk of the next product.
template <int N>
__device__ __forceinline__ void wg_split(const float (&s)[N], int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mma::split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], hi[i], lo[i]);
}

// 64 rows of fp32 accumulators of a m64nN product (NH = N / 2) times
// `mul` as bf16 into a 64-row tile of 128-byte-swizzled slabs `slab_bytes`
// apart, as a TMA store reads it (mma_bf16.cuh); the caller makes the
// writes visible to the async proxy.
template <int NH>
__device__ __forceinline__ void wg_to_smem(char* tile, uint32_t slab_bytes, const float (&acc)[NH],
                                           float mul) {
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * w + (lane >> 2) + 8 * r;
    char* dst = tile + row * 128 + 4 * (lane & 3);
#pragma unroll
    for (int e = 0; e < NH / 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + (e >> 3) * slab_bytes + (((e & 7) ^ (row & 7)) << 4)) =
          mma::pack_bf16(acc[4 * e + 2 * r] * mul, acc[4 * e + 2 * r + 1] * mul);
  }
}

// The D / 64 slabs of a 64-row tile (as wg_to_smem writes it) stored by TMA
// at row row0 of head h, batch b of `map`, in one bulk group; rows and
// columns past the tensor's bounds are not written.
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const char* tile,
                                               uint32_t slab_bytes, int h, int row0, int b) {
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c) mma::tma_store_4d(map, tile + c * slab_bytes, 64 * c, h, row0, b);
  mma::bulk_commit();
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ---------------------------------------------------------------------------
// D <= 128.  What bounds it, and what the plan does about it, is set out at
// the top of the file.  Bw<D> holds the plan's sizes.
//
// attn_bwd_dq_wgmma<D>: a work item is 128 query rows of one (b, h), 64 a
// consumer (causal items longest first); one block an SM walks the items
// i = blockIdx.x, + gridDim.x, ...  Producer thread 64 loads each item's
// Q and dO into the other of two buffers as soon as the item before last
// has released it; producer thread 0 streams the K and V tiles (64 keys)
// of every item, twice, through a ring of SLOTS slots, K then V, across
// items.  A consumer's sweep 1 forms S = Q K^T and dP = dO V^T a tile and
// keeps an online max m, l = sum 2^(x - m) and sum 2^(x - m) dP a row,
// which give lse (log2 units) and delta = rowsum(P dP), written to the
// fp32 scratch; sweep 2 forms them again, dS = P (dP - delta) (1 - t^2),
// and dQ += dS K, issued together with the next tile's S and dP so that
// the next tile's exp2 runs while it is in flight.  A consumer runs only
// the tiles its own rows see, and waits for and releases the others'.
// dQ leaves through the consumer's rows of the Q slabs by TMA stores.
//
// attn_bwd_dkdv_wgmma<D>: a work item is 64 keys of one (b, KV head)
// (causal key tiles from the first, the longest, on); its steps walk the
// GQA group's heads and, in steps of 64, the query rows the masks admit.
// Each consumer has its own region of shared memory (K and V of its item,
// STAGES stages of Q, dO and the step's lse and delta) and its own
// producer thread (0 or 32: K and V once an item, Q and dO a step, by
// TMA) and producer warp (2 or 3: the step's lse and delta).  A step:
// S^T = K Q^T and dP^T = V dO^T (keys on the accumulator rows), P^T and
// dS^T, then dV += P^T dO and dK += dS^T Q, both accumulators (D / 2 fp32
// each a thread) the consumer's own.  Two ways to share out the items:
//   - many (at least KV_SPLIT_BELOW an SM: MHA): one block an SM, each
//     consumer walking its own items, so an item's K / V load and
//     epilogue hide under the other consumer's products;
//   - few, long ones (GQA): a block an item, the hardware handing items
//     out as blocks finish; consumer c takes the steps of parity c, and
//     the two partial sums meet in the K / V regions at the end, in a
//     fixed order (consumer 0 stores dV, consumer 1 dK).
//
// Products run on no condition but loop bounds of the warpgroup (ptxas
// serialises a product under a condition it cannot prove uniform, warning
// C7520): the masks hide what a consumer's rows or keys do not see,
// evaluated only where a tile straddles one.  dS and P enter the accumulations as bf16 hi + lo.  The
// softcap's tanh y is 1 - 2 r, r = 1 / (1 + 2^(2 y log2 e)) (two
// special-function operations, as in the forward), and its derivative
// 1 - t^2 = 4 r (1 - r).

template <int D>
struct Bw {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns of every tile in shared memory
  static constexpr int NA = D < 64 ? 64 : D;      // columns of the accumulations dQ, dK, dV
  static constexpr int BQ = 2 * W_ROWS;           // query rows of a dq item
  static constexpr uint32_t KTILE = DP / 64 * W_BOX;   // 64 rows (K, V; dkdv's Q, dO): slabs 8 KB apart
  static constexpr uint32_t QSLAB = BQ * 128;          // a 128-row slab: 16 KB
  static constexpr uint32_t QTILE = DP / 64 * QSLAB;   // 128 rows (Q, dO)
  // dq: two items' Q and dO, then the K / V ring; barriers qfull,
  // qempty [QBUF], full, empty [SLOTS].
  static constexpr int QBUF = 2;
  static constexpr int SLOTS = DP == 128 ? 6 : 12;
  static constexpr uint32_t DQ_RING = QBUF * 2 * QTILE;
  static constexpr uint32_t DQ_BARS = DQ_RING + SLOTS * KTILE;
  static constexpr size_t DQ_BYTES = DQ_BARS + 8 * (2 * QBUF + 2 * SLOTS) + 1024;
  // dkdv: each consumer its own region: K, V, then the stages (Q, dO of 64
  // rows, lse[64], delta[64]); barriers kvfull, kvempty, full, empty
  // [STAGES] a consumer.
  static constexpr int STAGES = DP == 128 ? 2 : 4;
  static constexpr uint32_t STATS = 2 * KTILE;    // in a stage
  static constexpr uint32_t STAGE = 2 * KTILE + 1024;
  static constexpr uint32_t KV_STAGE0 = 2 * KTILE;
  static constexpr uint32_t KV_REGION = KV_STAGE0 + STAGES * STAGE;
  static constexpr uint32_t KV_BARS = 2 * KV_REGION;
  static constexpr size_t KV_BYTES = KV_BARS + 2 * 8 * (2 + 2 * STAGES) + 1024;
  static_assert(D % 16 == 0 && D <= 128, "the plan's head dims");
  static_assert(DQ_BYTES <= 232448 && KV_BYTES <= 232448, "shared memory of a block");
};

// Producer thread 0 (or 32)'s arrival and producer warp 2 (or 3), the
// step's lse and delta, on a dkdv stage's full barrier.
constexpr int KV_FULL_ARRIVALS = 1 + 32;
// Named barrier of the dkdv consumers' exchange (split items).
constexpr int KV_BAR_EXCHANGE = 1;
// Below this many items an SM, the dkdv consumers split each item.
constexpr int KV_SPLIT_BELOW = 4;

// Named barriers: each dq consumer's epilogue (1, 2); each dkdv
// consumer's epilogue (2, 3).
constexpr int DQ_BAR_EPILOGUE = 1, KV_BAR_EPILOGUE = 2;

// Work item i of the dq launch: (b, h), its first query row and the key
// tiles t_lo .. t_lo + ntiles - 1 any of its rows can see.
struct BwItem {
  int b, h, q0, t_lo, ntiles;
};

__device__ __forceinline__ BwItem bw_item(const Params& p, int i) {
  constexpr int BQ = 2 * W_ROWS;
  const int bh = p.B * p.H, ntq = (p.Sq + BQ - 1) / BQ;
  const int qt = p.causal ? ntq - 1 - i / bh : i / bh;  // longest causal items first
  const int r = i % bh;
  BwItem it;
  it.b = r / p.H;
  it.h = r - it.b * p.H;
  it.q0 = qt * BQ;
  const int q_last = min(it.q0 + BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, it.q0 - p.window + 1) : 0;
  it.t_lo = k_lo / W_ROWS;
  it.ntiles = k_hi > k_lo ? (k_hi + W_ROWS - 1) / W_ROWS - it.t_lo : 0;
  return it;
}

// Scores of a m64n64 accumulator in place into log2 units: c tanh(a scale
// / c) log2 e as cap (1 - 2 r), r = 1 / (1 + 2^(a mul)), or a scale log2 e
// (mul, cap as the kernels set them).  Two loops under a uniform branch.
__device__ __forceinline__ void to_log2(float (&s)[32], bool softcap, float mul, float cap) {
  if (softcap) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = cap - 2.f * cap * mma::rcp_approx(1.f + mma::exp2_approx(s[i] * mul));
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= mul;
  }
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    attn_bwd_dq_wgmma(const __grid_constant__ WgParams wp) {
  using S = Bw<D>;
  constexpr int QBUF = S::QBUF, SLOTS = S::SLOTS;
  const Params& p = wp.p;
  char* sm = wgmma::aligned_smem();
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + S::DQ_BARS);
  uint64_t* qempty = qfull + QBUF;
  uint64_t* full = qempty + QBUF;
  uint64_t* empty = full + SLOTS;
  // The warpgroup, by a shuffle: uniform to ptxas.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int nitems = p.B * p.H * ((p.Sq + S::BQ - 1) / S::BQ);
  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mma::mbar_init(&qfull[i], 1);
      mma::mbar_init(&qempty[i], 2);  // thread 0 of each consumer, its rows' store read
    }
    for (int i = 0; i < SLOTS; ++i) {
      mma::mbar_init(&full[i], 1);
      mma::mbar_init(&empty[i], 2 * 128);
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: thread 0 K and V, thread 64 Q and dO, item after item
    wgmma::regs_dec<W_PRODUCER_REGS>();
    if (threadIdx.x == 64) {
      for (int i = blockIdx.x, j = 0; i < nitems; i += gridDim.x, ++j) {
        const BwItem it = bw_item(p, i);
        const int qb = j % QBUF;
        if (j >= QBUF) mma::mbar_wait(&qempty[qb], (j / QBUF - 1) & 1);
        char* Qb = sm + qb * 2 * S::QTILE;
        mma::mbar_expect_tx(&qfull[qb], 2 * S::QTILE);
        wgmma::tma_tile<S::DP, S::BQ>(Qb, S::QSLAB, &wp.q, &qfull[qb], it.h, it.q0, it.b);
        wgmma::tma_tile<S::DP, S::BQ>(Qb + S::QTILE, S::QSLAB, &wp.dout, &qfull[qb], it.h, it.q0,
                                      it.b);
      }
    }
    if (threadIdx.x == 0) {
      int n = 0;  // tiles loaded so far: the ring's position
      for (int i = blockIdx.x; i < nitems; i += gridDim.x) {
        const BwItem it = bw_item(p, i);
        const int kvh = it.h / (p.H / p.KV);
        for (int x = 0; x < 4 * it.ntiles; ++x, ++n) {  // K_t, V_t of every tile, twice
          const int slot = n % SLOTS;
          if (n >= SLOTS) mma::mbar_wait(&empty[slot], (n / SLOTS - 1) & 1);
          mma::mbar_expect_tx(&full[slot], S::KTILE);
          wgmma::tma_tile<S::DP>(sm + S::DQ_RING + slot * S::KTILE, W_BOX, (x & 1) ? &wp.v : &wp.k,
                                 &full[slot], kvh, (it.t_lo + (x >> 1) % it.ntiles) * W_ROWS, it.b);
        }
      }
    }
    return;
  }

  wgmma::regs_inc<W_CONSUMER_REGS>();
  const int cw = wg - 1;  // this consumer's rows: 64 cw .. 64 cw + 63 of each item
  const int tid = threadIdx.x & 127;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const bool softcap = p.softcap > 0.f;
  const float mul = softcap ? 2.f * LOG2E * p.scale / p.softcap : p.scale * LOG2E;
  const float cap = p.softcap * LOG2E;
  float s[32], dp[32], dq[S::NA / 2];
  uint32_t hi[4][4], lo[4][4];  // dS of the tile before, the A operand of dQ += dS K

  auto slot = [&](int pos) { return sm + S::DQ_RING + (pos % SLOTS) * S::KTILE; };
  auto wait_full = [&](int pos) { mma::mbar_wait(&full[pos % SLOTS], (pos / SLOTS) & 1); };
  auto release = [&](int pos) { mma::mbar_arrive(&empty[pos % SLOTS]); };

  int n = 0;  // tiles consumed so far: the ring's position
  // (thread 0) the Q buffer whose rows the last item's dQ store may still
  // read; released to the producer once the store has read them, after the
  // next item's first products (which hide the wait) or before its store.
  int stored = -1;
  auto release_q = [&]() {
    if (tid == 0 && stored >= 0) {
      mma::bulk_wait_read<0>();
      mma::mbar_arrive(&qempty[stored]);
      stored = -1;
    }
  };
  for (int i = blockIdx.x, j = 0; i < nitems; i += gridDim.x, ++j) {
    const BwItem it = bw_item(p, i);
    const int qb = j % QBUF;
    const char* Qc = sm + qb * 2 * S::QTILE + cw * W_BOX;
    const char* dOc = Qc + S::QTILE;
    const int wq0 = it.q0 + W_ROWS * cw + 16 * warp;  // this warp's first row

    // S and dP of the tile whose K sits at ring position pos (V at pos +
    // 1), issued as two groups once both have landed.
    auto issue_scores = [&](int pos) {
      zero(s);
      zero(dp);
      wait_full(pos);
      wait_full(pos + 1);
      wgmma::fence();
      const char* Kt = slot(pos);
      const char* Vt = slot(pos + 1);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma::ss(s, wgmma::desc_k(Qc, ks, S::QSLAB), wgmma::desc_k(Kt, ks, W_BOX));
      wgmma::commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma::ss(dp, wgmma::desc_k(dOc, ks, S::QSLAB), wgmma::desc_k(Vt, ks, W_BOX));
      wgmma::commit();
    };
    // dQ += (hi + lo) K, K the tile at ring position pos; one group.
    auto issue_dq = [&](int pos) {
      const char* Kt = slot(pos);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = wgmma::desc_mn(Kt, kk, W_BOX);
        wgmma::rs(dq, hi[kk], bd);
        wgmma::rs(dq, lo[kk], bd);
      }
      wgmma::commit();
    };
    // Whether the masks or Sk reach into the tile at key0 for this warp's
    // rows, and the masks on it: score i of this lane sits at key kb + dk
    // and row qr + dr, dk and dr constants of i, so each mask is one
    // comparison of dk or dk - dr with a bound the lane computes once.
    auto need_mask = [&](int key0) {
      return key0 + W_ROWS > p.Sk || (p.causal && key0 + W_ROWS - 1 > wq0) ||
             (p.window > 0 && key0 <= wq0 + 15 - p.window);
    };
    auto mask = [&](int key0, float hidden) {
      const int kb = key0 + 2 * (lane & 3), qr = wq0 + (lane >> 2);
      const int k_end = p.Sk - kb;
      const int diag = p.causal ? qr - kb : INT_MAX;
      const int wedge = p.window > 0 ? qr - kb - p.window : INT_MIN;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int dk = 8 * (e >> 2) + (e & 1), dr = 8 * ((e >> 1) & 1);
        if (!(dk < k_end && dk - dr <= diag && dk - dr > wedge)) s[e] = hidden;
      }
    };

    // This consumer's tiles ta .. tb - 1 of the item's: those its rows can
    // see (at the causal diagonal the item's last tile is hidden from
    // consumer 0's rows).  The others' slots are waited for and released.
    int ta = 0, tb = 0;
    const int c0 = it.q0 + W_ROWS * cw;
    if (c0 < p.Sq) {
      const int c_last = min(c0 + W_ROWS, p.Sq) - 1;
      const int k_hi = p.causal ? min(p.Sk, c_last + 1) : p.Sk;
      const int k_lo = p.window > 0 ? max(0, c0 - p.window + 1) : 0;
      if (k_hi > k_lo) {
        ta = k_lo / W_ROWS - it.t_lo;
        tb = (k_hi + W_ROWS - 1) / W_ROWS - it.t_lo;
      }
    }
    auto skip = [&](int pos) {
      wait_full(pos);
      wait_full(pos + 1);
      release(pos);
      release(pos + 1);
    };

    mma::mbar_wait(&qfull[qb], (j / QBUF) & 1);

    // Sweep 1: online max m, l = sum 2^(x - m) and dd = sum 2^(x - m) dP for
    // rows g and g + 8 of the warp (m quad-uniform, l and dd this lane's part).
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    for (int t = 0; t < ta; ++t) skip(n + 2 * t);
    for (int t = ta; t < tb; ++t) {
      const int pos = n + 2 * t;
      issue_scores(pos);
      if (t == ta) release_q();
      wgmma::wait<0>();
      wgmma::fence_regs(s);
      wgmma::fence_regs(dp);
      release(pos);
      release(pos + 1);
      const int key0 = (it.t_lo + t) * W_ROWS;
      to_log2(s, softcap, mul, cap);
      if (need_mask(key0)) mask(key0, -INFINITY);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mj[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains: max is exact
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          mj[jj & 3] = fmaxf(mj[jj & 3], fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
        float mx = fmaxf(fmaxf(mj[0], mj[1]), fmaxf(mj[2], mj[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = mma::exp2_approx(m[r] - m_use);
        float sum = 0.f, dsum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float pe = mma::exp2_approx(s[4 * jj + e] - m_use);
            sum += pe;
            dsum = fmaf(pe, dp[4 * jj + e], dsum);
          }
        l[r] = l[r] * alpha + sum;
        dd[r] = dd[r] * alpha + dsum;
        m[r] = m_new;
      }
    }
    for (int t = tb; t < it.ntiles; ++t) skip(n + 2 * t);
    // lse (log2 units) and delta = rowsum(P dP) of the two rows; a row that
    // sees no key keeps lse 0 and delta 0 (its P is 0 everywhere).
    float lse[2], delta[2];
    const int64_t stat0 = (static_cast<int64_t>(it.b) * p.H + it.h) * p.Sq;
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

    // Sweep 2: P = 2^(x - lse), dS = P (dP - delta) (1 - t^2) into s, then
    // split into hi and lo.  Masked scores give dS 0.
    auto ds_split = [&](int key0) {
      if (softcap) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float r = mma::rcp_approx(1.f + mma::exp2_approx(s[e] * mul));
          const int row = (e >> 1) & 1;
          const float pe = mma::exp2_approx(cap - 2.f * cap * r - lse[row]);
          s[e] = pe * (dp[e] - delta[row]) * (4.f * r * (1.f - r));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int row = (e >> 1) & 1;
          s[e] = mma::exp2_approx(s[e] * mul - lse[row]) * (dp[e] - delta[row]);
        }
      }
      if (need_mask(key0)) mask(key0, 0.f);
    };
    auto split = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg_split<32>(s, kk, hi[kk], lo[kk]);
    };
    zero(dq);
    const int n2 = n + 2 * it.ntiles;  // sweep 2's first ring position
    for (int t = 0; t < ta; ++t) skip(n2 + 2 * t);
    if (tb > ta) {
      issue_scores(n2 + 2 * ta);
      wgmma::wait<0>();
      wgmma::fence_regs(s);
      wgmma::fence_regs(dp);
      release(n2 + 2 * ta + 1);
      ds_split((it.t_lo + ta) * W_ROWS);
      split();
      for (int t = ta + 1; t < tb; ++t) {
        const int pos = n2 + 2 * t;
        wgmma::fence_regs(dq);
        wgmma::fence_regs(hi);
        wgmma::fence_regs(lo);
        issue_scores(pos);   // S_t, dP_t, then dQ += dS_{t-1} K_{t-1}
        issue_dq(pos - 2);
        wgmma::wait<1>();    // S_t and dP_t done; dQ runs under dS_t
        wgmma::fence_regs(s);
        wgmma::fence_regs(dp);
        release(pos + 1);
        ds_split((it.t_lo + t) * W_ROWS);
        wgmma::wait<0>();
        wgmma::fence_regs(dq);
        wgmma::fence_regs(hi);
        wgmma::fence_regs(lo);
        release(pos - 2);
        split();
      }
      const int last = n2 + 2 * (tb - 1);
      wgmma::fence_regs(dq);
      wgmma::fence_regs(hi);
      wgmma::fence_regs(lo);
      wgmma::fence();
      issue_dq(last);
      wgmma::wait<0>();
      wgmma::fence_regs(dq);
      release(last);
    }
    for (int t = tb; t < it.ntiles; ++t) skip(n2 + 2 * t);
    // Epilogue: dQ as bf16 into this consumer's rows of the item's Q slabs
    // (its own, read by no one else, done with after its last product),
    // then stored by TMA; the buffer goes back to the producer once the
    // store has read it.
    char* Qw = sm + qb * 2 * S::QTILE + cw * W_BOX;
    wg_to_smem(Qw, S::QSLAB, dq, p.scale);
    mma::fence_proxy_async();
    wgmma::bar_sync(DQ_BAR_EPILOGUE + cw, 128);
    release_q();
    if (tid == 0) {
      if (c0 < p.Sq) tma_store_tile<D>(&wp.dq, Qw, S::QSLAB, it.h, c0, it.b);
      stored = qb;
    }
    n += 4 * it.ntiles;
  }
  release_q();  // shared memory stays until the last store has read it
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    attn_bwd_dkdv_wgmma(const __grid_constant__ WgParams wp) {
  using S = Bw<D>;
  constexpr int STAGES = S::STAGES;
  const Params& p = wp.p;
  char* sm = wgmma::aligned_smem();
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int group = p.H / p.KV;
  const int nkt = (p.Sk + W_ROWS - 1) / W_ROWS;
  const int nitems = p.B * p.KV * nkt;
  // Item i: 64 keys of one (b, KV head); causal key tiles from the first
  // (the longest) on.  Its steps walk the group's heads, and each head's
  // query rows that can see a key of it (causal q >= key0; window q <
  // key_last + window) in steps of 64.
  struct Item {
    int b, kvh, key0, q_begin, nqt, steps;
  };
  auto item = [&](int i) {
    Item it;
    const int bkv = i % (p.B * p.KV);
    it.b = bkv / p.KV;
    it.kvh = bkv - it.b * p.KV;
    it.key0 = (i / (p.B * p.KV)) * W_ROWS;
    const int nkeys = min(W_ROWS, p.Sk - it.key0);
    it.q_begin = p.causal ? it.key0 : 0;
    const int q_end = p.window > 0 ? min(p.Sq, it.key0 + nkeys - 1 + p.window) : p.Sq;
    it.nqt = q_end > it.q_begin ? (q_end - it.q_begin + W_ROWS - 1) / W_ROWS : 0;
    it.steps = group * it.nqt;
    return it;
  };
  // Consumer c's items and its steps of each: its own items, every step;
  // or, split, the block's items, the steps of c's parity.
  const int first = wp.split ? blockIdx.x : 2 * blockIdx.x;
  const int stride = wp.split ? gridDim.x : 2 * gridDim.x;
  const int step_stride = wp.split ? 2 : 1;
  // Each consumer's barriers: kvfull, kvempty, full[STAGES], empty[STAGES].
  auto bars = [&](int c) { return reinterpret_cast<uint64_t*>(sm + S::KV_BARS) + c * (2 + 2 * STAGES); };
  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      uint64_t* bc = bars(c);
      mma::mbar_init(&bc[0], 1);
      mma::mbar_init(&bc[1], 1);  // thread 0 of the consumer, its store read
      for (int i = 0; i < STAGES; ++i) {
        mma::mbar_init(&bc[2 + i], KV_FULL_ARRIVALS);
        mma::mbar_init(&bc[2 + STAGES + i], 128);
      }
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: for consumer c, thread 32 c its K, V and Q, dO; warp 2 + c the rows' lse, delta
    wgmma::regs_dec<W_PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5;
    const bool tma = threadIdx.x == 0 || threadIdx.x == 32;
    if (!tma && warp < 2) return;
    const int c = tma ? warp : warp - 2;
    char* region = sm + c * S::KV_REGION;
    uint64_t* bc = bars(c);
    int n = 0;  // steps loaded so far: the stages' position
    for (int i = first + (wp.split ? 0 : c), j = 0; i < nitems; i += stride, ++j) {
      const Item it = item(i);
      if (tma) {
        if (j > 0) mma::mbar_wait(&bc[1], (j - 1) & 1);
        mma::mbar_expect_tx(&bc[0], 2 * S::KTILE);
        wgmma::tma_tile<S::DP>(region, W_BOX, &wp.k, &bc[0], it.kvh, it.key0, it.b);
        wgmma::tma_tile<S::DP>(region + S::KTILE, W_BOX, &wp.v, &bc[0], it.kvh, it.key0, it.b);
      }
      for (int step = wp.split ? c : 0; step < it.steps; step += step_stride, ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mma::mbar_wait(&bc[2 + STAGES + st], (n / STAGES - 1) & 1);
        const int gi = step / it.nqt;
        const int h = it.kvh * group + gi;
        const int q0 = it.q_begin + (step - gi * it.nqt) * W_ROWS;
        char* stage = region + S::KV_STAGE0 + st * S::STAGE;
        if (tma) {
          mma::mbar_expect_tx(&bc[2 + st], 2 * S::KTILE);
          wgmma::tma_tile<S::DP>(stage, W_BOX, &wp.q, &bc[2 + st], h, q0, it.b);
          wgmma::tma_tile<S::DP>(stage + S::KTILE, W_BOX, &wp.dout, &bc[2 + st], h, q0, it.b);
        } else {  // the rows' lse and delta, 0 past Sq
          const int64_t row0 = (static_cast<int64_t>(it.b) * p.H + h) * p.Sq;
          float* dst = reinterpret_cast<float*>(stage + S::STATS);
          const int lane = threadIdx.x & 31;
          float x[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int q = q0 + lane + 32 * (r & 1);
            x[r] = q < p.Sq ? (r < 2 ? p.lse : p.delta)[row0 + q] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) dst[lane + 32 * r] = x[r];
          mma::mbar_arrive(&bc[2 + st]);
        }
      }
    }
    return;
  }

  wgmma::regs_inc<W_CONSUMER_REGS>();
  const int cw = wg - 1;  // this consumer's items: 2 blockIdx.x + cw, + 2 gridDim.x, ...
  const int tid = threadIdx.x & 127;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const bool softcap = p.softcap > 0.f;
  const float mul = softcap ? 2.f * LOG2E * p.scale / p.softcap : p.scale * LOG2E;
  const float cap = p.softcap * LOG2E;
  char* region = sm + cw * S::KV_REGION;
  const char* Ks = region;
  const char* Vs = region + S::KTILE;
  uint64_t* bc = bars(cw);
  float dk[S::NA / 2], dv[S::NA / 2];
  float st[32], dpt[32];  // S^T, dP^T: keys on rows, 64 query rows on columns
  int n = 0;  // steps consumed so far
  for (int i = first + (wp.split ? 0 : cw), j = 0; i < nitems; i += stride, ++j) {
    const Item it = item(i);
    const int kw0 = it.key0 + 16 * warp;  // this warp's first key (accumulator rows)
    zero(dk);
    zero(dv);
    mma::mbar_wait(&bc[0], j & 1);
    for (int step = wp.split ? cw : 0; step < it.steps; step += step_stride, ++n) {
      const int sg = n % STAGES;
      const int gi = step / it.nqt;
      const int q0 = it.q_begin + (step - gi * it.nqt) * W_ROWS;
      const char* Qs = region + S::KV_STAGE0 + sg * S::STAGE;
      const char* dOs = Qs + S::KTILE;
      const float* lse = reinterpret_cast<const float*>(Qs + S::STATS);
      const float* delta = lse + W_ROWS;
      zero(st);
      zero(dpt);
      mma::mbar_wait(&bc[2 + sg], (n / STAGES) & 1);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma::ss(st, wgmma::desc_k(Ks, ks, W_BOX), wgmma::desc_k(Qs, ks, W_BOX));
      wgmma::commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma::ss(dpt, wgmma::desc_k(Vs, ks, W_BOX), wgmma::desc_k(dOs, ks, W_BOX));
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(st);
      wgmma::fence_regs(dpt);

      // P^T into st, dS^T = P^T (dP^T - delta) (1 - t^2) into dpt.  Element
      // e of this lane: key kr + dkey, query qr + dq (dkey, dq constants of e).
      const int qc = 2 * (lane & 3);
      if (softcap) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = qc + 8 * (e >> 2) + (e & 1);
          const float r = mma::rcp_approx(1.f + mma::exp2_approx(st[e] * mul));
          const float pe = mma::exp2_approx(cap - 2.f * cap * r - lse[col]);
          st[e] = pe;
          dpt[e] = pe * (dpt[e] - delta[col]) * (4.f * r * (1.f - r));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = qc + 8 * (e >> 2) + (e & 1);
          const float pe = mma::exp2_approx(st[e] * mul - lse[col]);
          st[e] = pe;
          dpt[e] = pe * (dpt[e] - delta[col]);
        }
      }
      if (kw0 + 16 > p.Sk || q0 + W_ROWS > p.Sq || (p.causal && kw0 + 15 > q0) ||
          (p.window > 0 && q0 + W_ROWS - 1 - p.window >= kw0)) {
        const int kr = kw0 + (lane >> 2), qr = q0 + qc;
        const int k_end = p.Sk - kr, q_end = p.Sq - qr;
        const int diag = p.causal ? qr - kr : INT_MAX;
        const int wedge = p.window > 0 ? qr - kr - p.window : INT_MIN;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int dkey = 8 * ((e >> 1) & 1), dq = 8 * (e >> 2) + (e & 1);
          if (!(dkey < k_end && dq < q_end && dkey - dq <= diag && dkey - dq > wedge))
            st[e] = dpt[e] = 0.f;
        }
      }
      uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg_split<32>(st, kk, phi[kk], plo[kk]);
        wg_split<32>(dpt, kk, shi[kk], slo[kk]);
      }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = wgmma::desc_mn(dOs, kk, W_BOX);
        wgmma::rs(dv, phi[kk], bd);
        wgmma::rs(dv, plo[kk], bd);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = wgmma::desc_mn(Qs, kk, W_BOX);
        wgmma::rs(dk, shi[kk], bd);
        wgmma::rs(dk, slo[kk], bd);
      }
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(dk);
      wgmma::fence_regs(dv);
      mma::mbar_arrive(&bc[2 + STAGES + sg]);
    }
    // Epilogue: dK and dV as bf16 into this consumer's K / V region (read
    // for the last time), then stored by TMA; the region goes back to the
    // producer once the stores have read it.
    if (wp.split) {
      // The partial sums meet in the K / V regions first: consumer 0 hands
      // over its dK, consumer 1 its dV, each in its accumulator layout;
      // then consumer 0 stores dV, consumer 1 dK.
      float* mine = reinterpret_cast<float*>(region);
      const float* theirs = reinterpret_cast<const float*>(sm + (cw ^ 1) * S::KV_REGION);
      if (cw == 0) {
#pragma unroll
        for (int e = 0; e < S::NA / 2; ++e) mine[e * 128 + tid] = dk[e];
      } else {
#pragma unroll
        for (int e = 0; e < S::NA / 2; ++e) mine[e * 128 + tid] = dv[e];
      }
      wgmma::bar_sync(KV_BAR_EXCHANGE, 2 * 128);
      if (cw == 0) {
#pragma unroll
        for (int e = 0; e < S::NA / 2; ++e) dv[e] += theirs[e * 128 + tid];
      } else {
#pragma unroll
        for (int e = 0; e < S::NA / 2; ++e) dk[e] += theirs[e * 128 + tid];
      }
      wgmma::bar_sync(KV_BAR_EXCHANGE, 2 * 128);
      if (cw == 0)
        wg_to_smem(region, W_BOX, dv, 1.f);
      else
        wg_to_smem(region, W_BOX, dk, p.scale);
    } else {
      wg_to_smem(region, W_BOX, dk, p.scale);
      wg_to_smem(region + S::KTILE, W_BOX, dv, 1.f);
    }
    mma::fence_proxy_async();
    wgmma::bar_sync(KV_BAR_EPILOGUE + cw, 128);
    if (tid == 0) {
      if (!wp.split || cw == 1) tma_store_tile<D>(&wp.dk, region, W_BOX, it.kvh, it.key0, it.b);
      if (!wp.split) tma_store_tile<D>(&wp.dv, region + S::KTILE, W_BOX, it.kvh, it.key0, it.b);
      if (wp.split && cw == 0) tma_store_tile<D>(&wp.dv, region, W_BOX, it.kvh, it.key0, it.b);
      mma::bulk_wait_read<0>();
      mma::mbar_arrive(&bc[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// D 256 (gemma2): the specialisations keep their own plan, below WgParams'
// notes at the top of the file (their accumulators, 128 registers a
// thread, leave no room for the plan above).

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

// Launch 1 at D 256, attn_bwd_dq_wgmma<256>: lse, delta and dQ of 128 query
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

template <>
__global__ void __launch_bounds__(W_THREADS, 1)
    attn_bwd_dq_wgmma<W_D>(const __grid_constant__ WgParams wp) {
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

// Launch 2 at D 256, attn_bwd_dkdv_wgmma<256>: dK and dV of 64 keys of one
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

template <>
__global__ void __launch_bounds__(W_THREADS, 1)
    attn_bwd_dkdv_wgmma<W_D>(const __grid_constant__ WgParams wp) {
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

// The current device's SM count, read once a device: the dq launch's grid
// below D 256 is one block an SM.
inline cudaError_t current_sm_count(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*sms = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cache[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// bf16 at every head dim: the tensor maps from the strides (the true head
// dim; TMA zero-fills a box's columns past it), then the two warpgroup
// launches: the dq one on one block an SM walking the items (D <= 128) or
// on a block an item (D 256), the dkdv one on a block per 64 keys of a (b,
// KV head).  A tensor map that cannot be encoded (no
// cuTensorMapEncodeTiled) is an error, not a fallback.  With Sk 0 no K or
// V tile is loaded (their maps stay empty) and dkdv has no key.
template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  WgParams wp{};
  wp.p = p;
  if (!mma::encode_map(&wp.q, p.q, p.qs, D, p.H, p.Sq, p.B) ||
      !mma::encode_map(&wp.dout, p.dout, p.dos, D, p.H, p.Sq, p.B) ||
      (p.Sk > 0 && (!mma::encode_map(&wp.k, p.k, p.ks, D, p.KV, p.Sk, p.B) ||
                    !mma::encode_map(&wp.v, p.v, p.vs, D, p.KV, p.Sk, p.B))))
    return cudaErrorInvalidValue;
  if constexpr (D == W_D) {
    const cudaError_t err = launch_with_smem<attn_bwd_dq_wgmma<W_D>, W_THREADS>(
        dim3(p.B * p.H, (p.Sq + DqWg::BQ - 1) / DqWg::BQ), DqWg::BYTES, wp, stream);
    if (err != cudaSuccess || p.Sk == 0) return err;
    return launch_with_smem<attn_bwd_dkdv_wgmma<W_D>, W_THREADS>(
        dim3(p.B * p.KV, (p.Sk + W_ROWS - 1) / W_ROWS), KvWg::BYTES, wp, stream);
  } else {
    if (!mma::encode_map(&wp.dq, p.dq, p.dqs, D, p.H, p.Sq, p.B) ||
        (p.Sk > 0 && (!mma::encode_map(&wp.dk, p.dk, p.dks, D, p.KV, p.Sk, p.B) ||
                      !mma::encode_map(&wp.dv, p.dv, p.dvs, D, p.KV, p.Sk, p.B))))
      return cudaErrorInvalidValue;
    const int64_t dq_items = static_cast<int64_t>(p.B) * p.H * ((p.Sq + Bw<D>::BQ - 1) / Bw<D>::BQ);
    const int64_t kv_items = static_cast<int64_t>(p.B) * p.KV * ((p.Sk + W_ROWS - 1) / W_ROWS);
    if (dq_items > 0x7fffffff || kv_items > 0x7fffffff) return cudaErrorInvalidValue;
    int sms = 0;
    cudaError_t err = current_sm_count(&sms);
    if (err != cudaSuccess) return err;
    err = launch_with_smem<attn_bwd_dq_wgmma<D>, W_THREADS>(
        dim3(static_cast<unsigned>(dq_items < sms ? dq_items : sms)), Bw<D>::DQ_BYTES, wp, stream);
    if (err != cudaSuccess || p.Sk == 0) return err;
    // Few items (long ones, GQA): a block an item, its steps split between
    // the consumers, the hardware handing out items as blocks finish; many
    // (MHA): one block an SM, each consumer walking its own items.
    wp.split = kv_items < static_cast<int64_t>(KV_SPLIT_BELOW) * sms;
    const int64_t pairs = (kv_items + 1) / 2;
    const int64_t grid = wp.split ? kv_items : pairs < sms ? pairs : sms;
    return launch_with_smem<attn_bwd_dkdv_wgmma<D>, W_THREADS>(dim3(static_cast<unsigned>(grid)),
                                                              Bw<D>::KV_BYTES, wp, stream);
  }
}

cudaError_t launch_bf16(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_wgmma<16>(p, stream);
    case 32: return launch_wgmma<32>(p, stream);
    case 64: return launch_wgmma<64>(p, stream);
    case 80: return launch_wgmma<80>(p, stream);
    case 128: return launch_wgmma<128>(p, stream);
    case 256: return launch_wgmma<256>(p, stream);
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
