// Flash attention forward for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel, launched by
// flash_attention_pallas.  It computes the same function: blockwise
// online-softmax attention with scale 1/sqrt(D), an optional tanh softcap
// before the mask, the causal mask k_pos <= q_pos and the window mask
// k_pos > q_pos - window (both counted from 0 at the top left), GQA
// reading KV head h / (H / KV) without repeating it, running m / l / acc
// in fp32, a fully masked row giving 0, output in q's dtype.
//
// Two paths, chosen by dtype alone in flash_attention_fwd:
//   fp32 -> attn_fwd, scalar fp32 FMAs (unchanged since it was first
//           written; TF32 products would miss the 2e-5 fp32 tolerance):
//           a block per (b, h, q-tile) walks KV tiles of 32 keys staged
//           as fp32 in shared memory, a lane per key for the scores;
//           decode splits the tiles over 4 warps and merges them (not at
//           D 256, where four warps' slabs would not fit: see launch_mode);
//   bf16 -> attn_prefill_wgmma<D> (Sq >= 16, every head dim: one
//           warpgroup kernel, wgmma fed by TMA); decode (Sq < 16) below D
//           256 attn_decode_tma<D> (one launch a call, K and V by TMA,
//           mma.sync m16n8k16, its ranges of keys merged on chip in a
//           cluster), at D 256 attn_decode_bf16 (mma.sync on K and V
//           loaded into registers; with its keys split over blocks,
//           attn_decode_bf16<256, true> then attn_decode_merge); bf16
//           operands, fp32 accumulators; helpers in mma_bf16.cuh.
//
// What bounds it.  At stablelm_3b's prefill shape (B 8, H 32, S 512, D 80,
// causal, bf16) the call does ~10.7 GFLOP (11 us at the H100 SXM's dense
// bf16 tensor-core peak) and must move 84 MB of q/k/v/o (25 us at 3.35
// TB/s): bound by memory, as is every D <= 128 prefill of the models at
// 512 tokens (15-65 us of bytes).  gemma2's D 256 prefill at 5120 tokens
// is bound by operations: 4 D flops an admitted (query, key) pair, 0.434 /
// 0.417 ms at 989 TFLOP/s global / local, against 0.038 ms for its 126
// MB.  A decode step (Sq 1) reads B * KV * Sk * D * 2 * 2 bytes of cache
// (47 MB at Sk 575, 14 us) and does ~1 FLOP per byte: bound by memory by
// far.  The scalar path's FMAs (67 TFLOP/s) alone put the prefill at >=
// 0.16 ms; it took 0.70-0.71 ms there and 0.053-0.072 ms per decode
// launch (H100 80GB HBM3 at 700 W, chip_smoke.py), 12.8x SDPA.
//
// The bf16 prefill, attn_prefill_wgmma<D> (the design is set out above
// the kernel).  A TMA producer warpgroup (24 registers) and two consumer
// warpgroups of 64 query rows (240 registers) issue S = Q K^T (both
// operands in shared memory) together with the previous tile's P V (P
// from registers) and run this tile's scale, softcap, masks and online
// softmax while that P V is in flight, the two consumers taking turns
// under named barriers; products are issued on no condition (a condition
// serialises them: ptxas C7520), the masks hiding what a consumer's rows
// do not see.  The softcap's tanh y is 1 - 2 / (1 + 2^(2 y log2 e)), two
// special-function operations; tanh.approx.f32, one, would miss the bf16
// tolerance at its documented error (tests/test_torch_flash_attention.py
// emulates both).  O / l leaves through Q's shared memory by TMA stores.
//   At D 256 (gemma2_9b) a block takes one 128-row item, 64-key tiles,
// 197,712 bytes of shared memory.  It replaced the mma.sync plan
// stretched to D 256, which reached 18% of the bf16 peak (2.3799 / 2.3041
// ms at gemma2's prefill (2, 16, 5120, 256) KV 8 softcap 50); measured
// (scripts/attention_fwd_ab.py, in turns beside it; H100 80GB HBM3 at
// 700.00 W): 0.8855-0.8889 / 0.8601-0.8731 ms, 2.7x, about half the peak.
//   At D <= 128 it replaced the mma.sync plan of 8 warps x 16 rows (64-key
// tiles by cp.async, Q's fragments by ldmatrix, two blocks an SM), which
// ran at 1.6-2.8x its time.  What was chosen there, and why (each held
// on the card against the alternative, in turns): 128-key tiles, 64
// scores a thread, half the turns and barriers of 64-key tiles; one block
// an SM walking the items, two Q buffers (the next item's Q loads a whole
// item ahead; its first products hide the wait for the last output
// store's reads), the K / V ring running on across items: at 512 tokens
// an item reads 1 to 4 tiles, and its Q load and epilogue cost as much as
// its products when each item has a block of its own; two stages (a third
// does not fit beside two Q buffers, and one Q buffer with three stages
// was slower at 512 tokens); P V at N = D from D 64 up (at D 80 a B
// operand over 1.25 swizzle atoms, read right on the card and faster than
// N 128 over zero columns), N 64 at D 16 and 32; a mask is one
// comparison a score against a bound the lane computes once, and the
// softcap's and the plain scale's loops are apart (one loop with a select
// computed both).  What holds it back at 512 tokens: the softmax's exp2,
// 64 a thread a tile, on the special-function units, and each item's
// fixed costs (its Q, the K / V ring's refill and its epilogue), which a
// longer sequence spreads.  Measured below D 256 (scripts/attention_fwd_ab.py,
// in turns beside the mma.sync plan, CUDA graphs of calls; H100 80GB HBM3
// at 700.00 W), causal 8 x 512, ms (mma.sync plan; SDPA; bound of bytes):
// stablelm (32, D 80) 0.0528-0.0532 (0.0861-0.0864; 0.0531; 0.0250),
// zamba2 (32, D 64) 0.0445-0.0446 (0.0765-0.0766; 0.0402; 0.0200),
// musicgen (24, D 64) 0.0347-0.0357 (0.0578-0.0588; 0.0332; 0.0150), and
// at D 128 phi3.5 (32 / 8) 0.0551-0.0559 (0.1450-0.1452; 0.0531; 0.0250),
// qwen2_vl (28 / 4) 0.0498 (0.1262-0.1267; 0.0488; 0.0200), yi (56 / 8)
// 0.0933-0.0939 (0.2466-0.2467; 0.0854; 0.0401), command_r (96 / 8)
// 0.1491-0.1531 (0.4177-0.4181; 0.1390; 0.0651), llama4 (40 / 8)
// 0.0695-0.0698 (0.1809-0.1811; 0.0639; 0.0300): 1.6-2.8x the earlier
// plan, 0-11% above SDPA, 2.1-2.4x the bound.
//
// The bf16 decode below D 256, attn_decode_tma<D> (the plan is set out
// above the kernel).  A decode step reads the cache once: B * KV * Sk * D
// * 2 * 2 bytes (2.85-14.09 us at 3.35 TB/s for the served calls at Sk
// 575), ~1 FLOP a byte, bound by memory by far; the rows of a (b, KV
// head) are at most 16 (GQA groups of 1-12 at Sq 1), so the tensor cores
// idle either way.  It replaced the earlier per-block plan (each warp loading
// a step's K and V into registers, then its products: one dependent round
// trip to HBM after another) and, for split calls, that plan's second
// launch, attn_decode_merge, with its fp32 partials through HBM.  What
// its design does about the bound: a producer warp requests every stage
// of a TMA ring as the block starts (the bytes in flight from the first
// microsecond), the ranges merge through distributed shared memory in the
// same launch, and the wrapper's rule (flash_attention.py::decode_split)
// cuts the keys so that a block streams the fewest 64-key tiles with no
// more blocks than SMs: a cluster's blocks are placed together, and
// grids past that (clusters of 4-8 at 128-256 blocks) waited for a
// second wave on the card (%globaltimer stamps a block, a throwaway copy).
//   Products by mma.sync, not wgmma: wgmma takes 64 rows, so it would put
// the keys on M (S^T = K Q^T, then O^T = V^T P^T with P^T through shared
// memory and each row's softmax across the warpgroup's four warps); with
// 16 rows the products are a small share of a tile's time and the loop
// streams at the card's bandwidth (measured below), so mma.sync from
// ldmatrix keeps P in registers and the softmax inside a warp.
//   Measured (scripts/attention_fwd_ab.py, in turns beside the earlier plan
// and SDPA, cold L2, CUDA graphs of calls; H100 80GB HBM3 at 700.00 W),
// ms at Sk 575 (the earlier plan; SDPA; bound of bytes): qwen2_vl
// (8,28,1,128) kv 4, 3 ranges of 192, 0.0090 (0.0147; 0.0106; 0.0028),
// phi3.5 / yi / command_r / llama4 (kv 8, D 128; 2 of 288) 0.0113-0.0133
// (0.0176-0.0205; 0.0142-0.0146; 0.0057), musicgen (8,24,1,64)
// unsplit 0.0139 (0.0166-0.0169; 0.0137; 0.0085), zamba2 (8,32,1,64)
// 0.0173-0.0174 (0.0189-0.0190; 0.0160; 0.0113), stablelm (8,32,1,80)
// 0.0204 (0.0221-0.0222; 0.0215-0.0217; 0.0141), the lse entry over
// stablelm's half cache 0.0126 (0.0150; efficient attention with its lse
// 0.0217; 0.0071).  With the products replaced by a register XOR (a
// throwaway copy) the GQA calls took 4-9% less.  What holds it back:
// about 2-3 us before a block's first K lands (the tensor map, HBM's
// latency under every block's requests at once) and 1-2 us of merge and
// spread after the median block's last tile; at the MHA shapes (192-256
// blocks, one row each) that leaves zamba2 and musicgen 8% and 1% above
// SDPA.
//
// The D 256 decode, attn_decode_bf16<256, *> (DcMap).  A block owns
// one (b, KV head) and up to 16 query rows of its GQA group, so the group
// shares every K/V read; its 4 warps split the keys in steps of 16 and
// read K and V straight from global memory into registers with 16-byte
// loads; the inner index of each product is permuted so that a lane's
// share of a row is contiguous.  The warps merge their (m, l, o) in shared
// memory.  O is 128 registers a lane, Q's fragments would be 64 more and
// a step's K and V words 64 each: Q's fragments go to shared memory once
// for the block (8 KB, read back 16 bytes a lane a k-step) and a step
// loads V only after its scores are formed, when K's registers are free.
//
// The D 256 split decode (flash_attention_decode_split).  A decode block
// owns a (b, KV head), so gemma2's decode (B 2, KV 8) is 16 blocks for 132
// SMs: each streams its whole 4-5 MB of cache alone, and the call took
// 0.1741 / 0.1894 ms (ring Sk 4096 / global Sk 5183) against a bytes bound
// of 20.04 / 25.36 us.  The wrapper's rule
// (flash_attention.py::d256_decode_split, a pure function of B, KV, rows,
// Sk and the SM count) cuts the keys into ranges of a whole number of 64
// keys, enough for about two blocks an SM, where the unsplit grid has
// fewer blocks than SMs.  Each block runs the per-block plan above over
// its range and writes its unnormalised o with the rows' m (log2 units)
// and l to fp32 scratch the wrapper allocates; a second launch,
// attn_decode_merge, a block a row, merges the ranges as the block merges
// its warps (and as models/layers.py merges ranks) and writes o, and the
// lse when asked.  It is a programmatic dependent launch: its blocks are
// scheduled while the split blocks run and wait (griddepcontrol.wait) for
// their writes.  A range with no admitted key has m = -inf and adds
// nothing; a row with no key anywhere gives 0 and lse -inf.  Measured
// (scripts/attention_fwd_ab.py, in turns beside the unsplit kernel, cold
// L2, CUDA graphs of calls; H100 80GB HBM3 at 700.00 W): gemma2's ring
// decode 0.0397-0.0399 ms against the unsplit kernel's 0.1412-0.1413
// (3.55x; 16 ranges of 256 keys; bound 20.04 us, bytes), the global
// 0.0457-0.0461 against 0.1732-0.1742 (3.78x; 17 of 320; 25.36 us), the
// lse entry over half the global cache 0.0312-0.0313 against
// 0.0936-0.0940 (3.00x; 14 of 192; 12.69 us).
//
// A second entry, flash_attention_lse, runs the same kernels with the flag
// Params::lse set: each also writes its rows' fp32 log-sum-exp, so that the
// partial outputs of keys split over ranks can be merged (decode with the
// cache's sequence split, repro_torch.models.layers).  A third,
// flash_attention_decode_split, is the split decode above (either
// design), with or without the lse; flash_attention_sm_count gives the
// rules their SM count.
//
// Strides are element strides of the (b, head, seq) axes; the last axis
// must be contiguous, and every pointer and stride 16-byte aligned (the
// Python wrapper checks).  Launch errors are returned, never swallowed.

#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BK = 32;  // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPLIT_BELOW_SQ = 16;  // decode mode for Sq < 16
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  int64_t qsb, qsh, qss;
  int64_t ksb, ksh, kss;
  int64_t vsb, vsh, vss;
  int64_t osb, osh, oss;
  int causal, window;
  float softcap, scale;
  float* lse;  // (B, H, Sq) fp32 log-sum-exp of each row's scores, or null (flash_attention_fwd)
  // Decode with its keys split over blocks (flash_attention_decode_split):
  // `splits` ranges of `chunk` keys, each block's partial (o, m, l) in
  // `part` (fp32 scratch); null / 0 otherwise.
  float* part;
  int splits, chunk;
};

constexpr float LN2 = 0.6931471805599453f;

// Row (b, h, qpos)'s log-sum-exp, natural units, into p.lse (when asked):
// m + log(l) for a row max m (natural units) and a sum l of exp(s - m);
// -inf for a row that admitted no key (l = 0).
__device__ __forceinline__ void write_lse(const Params& p, int b, int h, int qpos, float m,
                                          float l) {
  p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + qpos] = l > 0.f ? m + logf(l) : -INFINITY;
}

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
// memory (row stride `dst_stride` floats), times `mul`.  Rows at or past
// `rows_valid` are filled with zeros.  Threads tid = 0..nthr-1 share the work.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride, const T* src,
                                          int64_t src_stride, int rows_valid, float mul,
                                          int tid, int nthr) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int VPR = D / VEC;
  constexpr int NV = ROWS * VPR;
  constexpr int UNR = 4;
  for (int base = 0; base < NV; base += nthr * UNR) {
    uint4 raw[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int idx = base + u * nthr + tid;
      const int row = idx / VPR;
      const int c = idx - row * VPR;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < NV && row < rows_valid)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + row * src_stride + c * VEC));
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int idx = base + u * nthr + tid;
      if (idx < NV) {
        const int row = idx / VPR;
        const int c = idx - row * VPR;
        float f[VEC];
        Elem<T>::to_float(raw[u], f);
        float* d = dst + row * dst_stride + c * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(d + e) =
              make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
      }
    }
  }
}

// Shared-memory plan, in floats.  Every piece is a multiple of 4 floats, so
// float4 accesses stay aligned.  K rows are padded to D + 4 floats: a lane
// reads its own key row with float4 loads, and the padding spreads the 8
// lanes of each load phase over distinct banks.
template <int D, int RPW, bool SPLIT>
struct Smem {
  static constexpr int BQ = SPLIT ? RPW : NWARPS * RPW;  // query rows per block
  static constexpr int NSLAB = SPLIT ? NWARPS : 1;       // K/V tiles in flight
  static constexpr int KSTR = D + 4;
  static constexpr int Q = 0;
  static constexpr int SLABS = Q + BQ * D;
  static constexpr int SLAB = BK * KSTR + BK * D;  // K tile, then V tile
  static constexpr int P = SLABS + NSLAB * SLAB;    // per warp: [BK][RPW]
  static constexpr int FLOATS = P + NWARPS * BK * RPW;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  // Decode mode merges the warps' (m, l, acc) in the slab region afterwards.
  static_assert(!SPLIT || NWARPS * RPW * (2 + D) <= NSLAB * SLAB, "merge area");
};

// Decode mode: each warp walked a different subset of the KV tiles.  Merge
// their partial (m, l, acc) for each row in shared memory `buf` (the K/V
// slabs, free by now) and write the normalised rows.
template <typename T, int D, int RPW>
__device__ __forceinline__ void merge_warps(float* buf, const float (&m)[RPW],
                                            const float (&l)[RPW],
                                            const float (&acc)[RPW][(D + 31) / 32], T* og,
                                            int64_t oss, int q0, int Sq, const Params& p, int b,
                                            int h) {
  constexpr int NI = (D + 31) / 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* Ms = buf;
  float* Ls = Ms + NWARPS * RPW;
  float* As = Ls + NWARPS * RPW;  // [warp][row][D]
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (lane == 0) {
      Ms[warp * RPW + r] = m[r];
      Ls[warp * RPW + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
      if (i < D / 32 || lane < D % 32) As[(warp * RPW + r) * D + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = tid; idx < RPW * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    if (q0 + r >= Sq) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, Ms[w * RPW + r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = Ms[w * RPW + r];
      const float a = mw <= NEG_INF ? 0.f : expf(mw - mx);
      lsum += Ls[w * RPW + r] * a;
      o += As[(w * RPW + r) * D + d] * a;
    }
    og[(q0 + r) * oss + d] = Elem<T>::from_float(o / fmaxf(lsum, 1e-30f));
    if (p.lse != nullptr && d == 0) write_lse(p, b, h, q0 + r, mx, lsum);
  }
}

template <typename T, int D, int RPW, bool SPLIT>
__global__ void __launch_bounds__(NTHREADS) attn_fwd(const Params p) {
  using S = Smem<D, RPW, SPLIT>;
  constexpr int NI = (D + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * S::BQ;
  const int kvh = h / (p.H / p.KV);

  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  T* og = static_cast<T*>(p.o) + b * p.osb + h * p.osh;

  // Keys any row of this block can see: [k_lo, k_hi).
  const int q_last = min(q0 + S::BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;

  float* Qs = smem + S::Q;
  load_rows<T, D, S::BQ>(Qs, D, qg + q0 * p.qss, p.qss, p.Sq - q0, p.scale, tid, NTHREADS);
  __syncthreads();

  // This warp's query rows (in Qs) and its K/V slab and P buffer.
  const int row0 = SPLIT ? 0 : warp * RPW;
  float* Ks = smem + S::SLABS + (SPLIT ? warp * S::SLAB : 0);
  float* Vs = Ks + BK * S::KSTR;
  float* Ps = smem + S::P + warp * BK * RPW;

  float m[RPW], l[RPW], acc[RPW][NI];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int t_first = SPLIT ? t_lo + warp : t_lo;
  const int t_step = SPLIT ? NWARPS : 1;
  for (int t = t_first; t < t_hi; t += t_step) {
    const int key0 = t * BK;
    const int nkeys = min(BK, p.Sk - key0);
    if constexpr (SPLIT) {
      load_rows<T, D, BK>(Ks, S::KSTR, kg + key0 * p.kss, p.kss, nkeys, 1.f, lane, 32);
      load_rows<T, D, BK>(Vs, D, vg + key0 * p.vss, p.vss, nkeys, 1.f, lane, 32);
      __syncwarp();
    } else {
      load_rows<T, D, BK>(Ks, S::KSTR, kg + key0 * p.kss, p.kss, nkeys, 1.f, tid, NTHREADS);
      load_rows<T, D, BK>(Vs, D, vg + key0 * p.vss, p.vss, nkeys, 1.f, tid, NTHREADS);
      __syncthreads();
    }

    // Scores: lane j holds s[r] = q_r . k_j for its key j.
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * S::KSTR;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax, one row at a time; p goes to Ps[key][row].
    const int kpos = key0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + row0 + r;
      bool valid = kpos < p.Sk && qpos < p.Sq;
      if (p.causal) valid = valid && kpos <= qpos;
      if (p.window > 0) valid = valid && kpos > qpos - p.window;
      float sv = s[r];
      if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
      sv = valid ? sv : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float pr = valid ? expf(sv - m_new) : 0.f;
      const float alpha = m[r] <= NEG_INF ? 0.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      Ps[lane * RPW + r] = pr;
    }
    __syncwarp();

    // acc[r][:] += sum_j p[j][r] * v[j][:]; lane owns columns lane + 32 i.
    for (int j = 0; j < nkeys; ++j) {
      float pj[RPW];
      if constexpr (RPW == 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + j * RPW);
        pj[0] = p4.x;
        pj[1] = p4.y;
        pj[2] = p4.z;
        pj[3] = p4.w;
      } else {
#pragma unroll
        for (int r = 0; r < RPW; ++r) pj[r] = Ps[j * RPW + r];
      }
      const float* vrow = Vs + j * D;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i < D / 32 || lane < D % 32) {
          const float vv = vrow[lane + 32 * i];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
        }
      }
    }
    if constexpr (SPLIT) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }

  if constexpr (!SPLIT) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + row0 + r;
      if (qpos >= p.Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        if (i < D / 32 || lane < D % 32)
          og[qpos * p.oss + lane + 32 * i] = Elem<T>::from_float(acc[r][i] * inv);
      if (p.lse != nullptr && lane == 0) write_lse(p, b, h, qpos, m[r], l[r]);
    }
  } else {
    merge_warps<T, D, RPW>(smem + S::SLABS, m, l, acc, og, p.oss, q0, p.Sq, p, b, h);
  }
}

template <typename T, int D, int RPW, bool SPLIT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Smem<D, RPW, SPLIT>;
  auto kern = attn_fwd<T, D, RPW, SPLIT>;
  if (S::BYTES > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::BYTES));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((p.Sq + S::BQ - 1) / S::BQ, p.H, p.B);
  kern<<<grid, NTHREADS, S::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// Decode mode gives each warp a K/V slab of its own; at D 256 four slabs
// (264 KB) pass the 227 KB a block may have, so D 256 always runs the
// shared-slab mode (at Sq < 16 with rows of the block left empty).
template <typename T, int D>
cudaError_t launch_mode(const Params& p, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (p.Sq < SPLIT_BELOW_SQ) return launch<T, D, 1, true>(p, stream);
  }
  return launch<T, D, 4, false>(p, stream);
}

template <typename T>
cudaError_t launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mode<T, 16>(p, stream);
    case 32: return launch_mode<T, 32>(p, stream);
    case 64: return launch_mode<T, 64>(p, stream);
    case 80: return launch_mode<T, 80>(p, stream);
    case 128: return launch_mode<T, 128>(p, stream);
    case 256: return launch_mode<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, fp32 accumulators).

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

// Scale, softcap and mask of one fp32 score q.k, in log2 units (times
// log2 e, so the softmax takes exp2); -inf where masked.  The scale is
// applied here, to the fp32 scores: q enters the product as it is.
__device__ __forceinline__ float score(float acc, const Params& p, bool need_mask, int kpos,
                                       int qpos) {
  float x = p.softcap > 0.f ? p.softcap * LOG2E * tanhf(acc * (p.scale / p.softcap))
                            : acc * (p.scale * LOG2E);
  if (need_mask) {
    bool valid = kpos < p.Sk;
    if (p.causal) valid = valid && kpos <= qpos;
    if (p.window > 0) valid = valid && kpos > qpos - p.window;
    if (!valid) x = -INFINITY;
  }
  return x;
}

// One online-softmax step for the two rows (g and g + 8) a lane holds of
// NKT n8 tiles of scores s (log2 units): updates m (row max, quad-uniform)
// and the lane's partial l, rescales the NT output tiles o, and leaves
// p = 2^(s - m) in s.  A row masked so far keeps m = -inf and p = 0.
template <int NKT, int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NKT][4], float (&m)[2], float (&l)[2],
                                               float (&o)[NT][4]) {
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
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = mma::exp2_approx(s[j][e] - m_use);
        sum += s[j][e];
      }
    }
    l[r] = l[r] * alpha + sum;
    m[r] = m_new;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][2 * r] *= alpha;
      o[nt][2 * r + 1] *= alpha;
    }
  }
}

// p of key tiles 2kk and 2kk + 1 as the A fragment of P V (k = 16 keys).
template <int NKT>
__device__ __forceinline__ void p_fragment(const float (&s)[NKT][4], int kk, uint32_t (&a)[4]) {
  a[0] = mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// ---------------------------------------------------------------------------
// bf16 prefill (Sq >= 16) at every head dim: attn_prefill_wgmma<D>,
// warpgroup products (wgmma) fed by TMA, warps specialised.  A work item
// is 128 query rows of one (b, h) (causal q-tiles longest first); a block
// is three warpgroups: warpgroup 0 the producer (registers cut to
// PW_PRODUCER_REGS; one thread loads K of every tile, another V, a third
// each item's Q, by TMA into mbarrier-guarded stages and buffers),
// warpgroups 1 and 2 the consumers (PW_CONSUMER_REGS each), 64 query rows
// each.  Q is Pw::DP / 64 128-row slabs of 64 columns, a consumer's rows
// the half of each slab at 64 cw; K and V stream through Pw::STAGES
// stages of Pw::BN keys, each tile DP / 64 slabs, with full and empty
// barriers of their own so that S = Q K^T starts before V lands.  Operands
// are 128-byte-swizzled slabs (mma_bf16.cuh, namespace wgmma).
//
// Widths below 64 columns or between multiples of 64 (D 16, 32, 80): the
// tensor maps keep the true D, and TMA fills the box's columns at or past
// D with zeros.  S = Q K^T takes D / 16 k steps, so it never reads them;
// P V runs N = Pw::NPV columns over V's zero columns, and the output's TMA
// stores drop the columns at or past D.  The scale is Params::scale,
// 1 / sqrt(D) of the true D, from the wrapper.
//
// A consumer's tile t: S_t = Q K_t^T (m64nBNk16, D / 16 k steps, both
// operands in shared memory) is issued together with O += P_{t-1} V_{t-1}
// (m64nNPVk16 with P as the register A operand, V MN-major); the scores'
// scale, softcap and masks and the online softmax of S_t run while that
// P V is still in flight, then O is rescaled and P_t rounded to bf16 in
// registers for the next tile.  The two consumers issue their products in
// turns, under two named barriers, so that one's softmax runs while the
// other's products keep the tensor cores busy.
//
// D <= 128 (Pw::QBUF 2): one block an SM walks the items i = blockIdx.x,
// + gridDim.x, ...; the producer loads the next item's Q into the other of
// two Q buffers as soon as the output store of the item before has read
// it, and its K and V ring runs on across items, while the consumers
// finish this one, so an item's loads and epilogue hide under the
// products of its neighbours.  D 256 (QBUF 1: two Q buffers would pass the
// shared memory a block may have) runs one item a block, the grid all of
// them; a block that walked more would free its one Q buffer at the end
// of each item.

constexpr int PW_ROWS = 64;                          // query rows of a consumer; rows of a TMA box
constexpr int PW_BQ = 2 * PW_ROWS;                   // query rows of an item
constexpr int PW_THREADS = 3 * 128;
constexpr uint32_t PW_BOX = PW_ROWS * 128;           // a 64 x 64 bf16 box: 8 KB
constexpr uint32_t PW_QSLAB = PW_BQ * 128;           // a 128-row slab of Q: 16 KB
constexpr int PW_PRODUCER_REGS = 24, PW_CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
// Named barriers: the consumers' turns (1, 2), each consumer's epilogue (3, 4).
constexpr int PW_BAR_TURN = 1, PW_BAR_EPILOGUE = 3;

template <int D>
struct Pw {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns of Q, K, V in shared memory
  static constexpr int NPV = D < 64 ? 64 : D;     // columns of P V
  static constexpr int BN = D == 256 ? 64 : 128;  // keys of a tile
  static constexpr int STAGES = 2;
  static constexpr int QBUF = D == 256 ? 1 : 2;
  static constexpr uint32_t KSLAB = BN * 128;     // a 64-column slab of a K or V tile
  static constexpr uint32_t QTILE = DP / 64 * PW_QSLAB, TILE = DP / 64 * KSLAB;
  // Bytes from the 1024-aligned base: Q buffers, K stages, V stages, then
  // the barriers qfull, qempty [QBUF]; kfull, kempty, vfull, vempty [STAGES].
  static constexpr uint32_t Q = 0, K = Q + QBUF * QTILE, V = K + STAGES * TILE;
  static constexpr uint32_t BARS = V + STAGES * TILE;
  static constexpr size_t BYTES = BARS + 8 * (2 * QBUF + 4 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "shared memory of a block");
};

struct PwParams {
  CUtensorMap q, k, v, o;  // (D, heads, seq, B) bf16, mma::encode_map's boxes
  Params p;
};

// Work item i: (b, h), its first query row and the key tiles t_lo ..
// t_lo + ntiles - 1 any of its rows can see.
struct PwItem {
  int b, h, q0, t_lo, ntiles;
};

template <int BN>
__device__ __forceinline__ PwItem pw_item(const Params& p, int i) {
  const int bh = p.B * p.H, ntq = (p.Sq + PW_BQ - 1) / PW_BQ;
  const int qt = p.causal ? ntq - 1 - i / bh : i / bh;  // longest causal tiles first
  const int r = i % bh;
  PwItem it;
  it.b = r / p.H;
  it.h = r - it.b * p.H;
  it.q0 = qt * PW_BQ;
  const int q_last = min(it.q0 + PW_BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, it.q0 - p.window + 1) : 0;
  it.t_lo = k_lo / BN;
  it.ntiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - it.t_lo : 0;
  return it;
}

template <int D>
__global__ void __launch_bounds__(PW_THREADS, 1)
    attn_prefill_wgmma(const __grid_constant__ PwParams wp) {
  using S = Pw<D>;
  constexpr int BN = S::BN, STAGES = S::STAGES, QBUF = S::QBUF;
  const Params& p = wp.p;
  char* sm = wgmma::aligned_smem();
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* qempty = qfull + QBUF;
  uint64_t* kfull = qempty + QBUF;
  uint64_t* kempty = kfull + STAGES;
  uint64_t* vfull = kempty + STAGES;
  uint64_t* vempty = vfull + STAGES;
  // The warpgroup, by a shuffle: uniform to ptxas, which would serialise
  // products under conditions that derive from threadIdx.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int nitems = p.B * p.H * ((p.Sq + PW_BQ - 1) / PW_BQ);
  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mma::mbar_init(&qfull[i], 1);
      mma::mbar_init(&qempty[i], 2);  // a thread of each consumer, its rows stored
    }
    for (int i = 0; i < STAGES; ++i) {
      mma::mbar_init(&kfull[i], 1);
      mma::mbar_init(&vfull[i], 1);
      mma::mbar_init(&kempty[i], 2 * 128);
      mma::mbar_init(&vempty[i], 2 * 128);
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: thread 0 K, thread 32 V, thread 64 Q, item after item
    wgmma::regs_dec<PW_PRODUCER_REGS>();
    if (threadIdx.x == 64) {  // an item's Q as soon as a buffer is free: a whole item ahead
      for (int i = blockIdx.x, j = 0; i < nitems; i += gridDim.x, ++j) {
        const PwItem it = pw_item<BN>(p, i);
        const int qb = j % QBUF;
        if (j >= QBUF) mma::mbar_wait(&qempty[qb], (j / QBUF - 1) & 1);
        mma::mbar_expect_tx(&qfull[qb], S::QTILE);
        wgmma::tma_tile<S::DP, PW_BQ>(sm + S::Q + qb * S::QTILE, PW_QSLAB, &wp.q, &qfull[qb], it.h,
                                      it.q0, it.b);
      }
    }
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool is_k = threadIdx.x == 0;
      uint64_t* full = is_k ? kfull : vfull;
      uint64_t* empty = is_k ? kempty : vempty;
      char* ring = sm + (is_k ? S::K : S::V);
      int n = 0;  // tiles loaded so far: the ring's position
      for (int i = blockIdx.x; i < nitems; i += gridDim.x) {
        const PwItem it = pw_item<BN>(p, i);
        const int kvh = it.h / (p.H / p.KV);
        for (int t = 0; t < it.ntiles; ++t, ++n) {
          const int st = n % STAGES;
          if (n >= STAGES) mma::mbar_wait(&empty[st], (n / STAGES - 1) & 1);
          mma::mbar_expect_tx(&full[st], S::TILE);
          wgmma::tma_tile<S::DP, BN>(ring + st * S::TILE, S::KSLAB, is_k ? &wp.k : &wp.v,
                                     &full[st], kvh, (it.t_lo + t) * BN, it.b);
        }
      }
    }
    return;
  }

  wgmma::regs_inc<PW_CONSUMER_REGS>();
  const int cw = wg - 1;  // this consumer's rows: c0 .. c0 + 63 of each item
  const int tid = threadIdx.x & 127;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const bool softcap = p.softcap > 0.f;
  // Scores in log2 units: softcap c tanh(a scale / c) log2 e, tanh y as
  // 1 - 2 / (1 + 2^(2 y log2 e)) (two special-function operations), or
  // a scale log2 e.
  const float mul = softcap ? 2.f * LOG2E * p.scale / p.softcap : p.scale * LOG2E;
  const float cap = p.softcap * LOG2E;

  float o[S::NPV / 2];
  float s[BN / 2];
  uint32_t pa[BN / 16][4] = {};
  float m[2], l[2];
  int wq0 = 0;  // this warp's first row in the item

  // Scale, softcap, mask and online softmax of S (the tile at key0) in
  // place: s becomes p = 2^(x - m) of rows g and g + 8 of the warp (m
  // quad-uniform, l this lane's part); alpha the factor O takes.  Masks
  // apply only where the tile crosses the diagonal, the window's edge or
  // Sk for this warp's rows; a row masked so far keeps m = -inf and p = 0.
  auto softmax = [&](int key0, float (&alpha)[2]) {
    const bool need_mask = key0 + BN > p.Sk || (p.causal && key0 + BN - 1 > wq0) ||
                           (p.window > 0 && key0 <= wq0 + 15 - p.window);
    // Two loops under a uniform branch: one loop with a select between
    // the forms computes both, two special-function operations a score
    // that the plain form does not need.
    if (softcap) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s[i] = cap - 2.f * cap * mma::rcp_approx(1.f + mma::exp2_approx(s[i] * mul));
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] *= mul;
    }
    if (need_mask) {
      // Score i of this lane sits at key kb + dk and query row qb + dq, dk
      // and dq constants of i: each mask is one comparison of dk or dk - dq
      // with a bound the lane computes once (none where its mask is off).
      const int kb = key0 + 2 * (lane & 3), qb = wq0 + (lane >> 2);
      const int k_end = p.Sk - kb;
      const int diag = p.causal ? qb - kb : INT_MAX;
      const int wedge = p.window > 0 ? qb - kb - p.window : INT_MIN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int dk = 8 * (i >> 2) + (i & 1), dq = 8 * ((i >> 1) & 1);
        if (!(dk < k_end && dk - dq <= diag && dk - dq > wedge)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
      float mj[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // four chains: max is exact
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mj[j & 3] = fmaxf(mj[j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(fmaxf(mj[0], mj[1]), fmaxf(mj[2], mj[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = mma::exp2_approx(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * j + e] = mma::exp2_approx(s[4 * j + e] - m_use);
          sum += s[4 * j + e];
        }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
  };
  // S = Q K^T of the tile in stage st (the consumer's Q rows at Qc), issued
  // and committed.
  auto issue_s = [&](const char* Qc, int st) {
    const char* Kt = sm + S::K + st * S::TILE;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma::ss(s, wgmma::desc_k(Qc, ks, PW_QSLAB), wgmma::desc_k(Kt, ks, S::KSLAB));
    wgmma::commit();
  };
  // O += P V of the tile in stage st, issued and committed.
  auto issue_pv = [&](int st) {
    const char* Vt = sm + S::V + st * S::TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma::rs(o, pa[kk], wgmma::desc_mn(Vt, kk, S::KSLAB));
    wgmma::commit();
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = mma::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };
  auto zero_s = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma::fence_regs(s);
  };

  int n = 0;         // tiles consumed so far: the ring's position
  int stored = -1;   // (thread 0) the Q buffer an output store of the last item may still read
  // Thread 0 waits for that store's reads and frees the buffer for the
  // producer's next Q: after the next item's first products, which hide the
  // wait, or before its own store.  With one Q buffer the next item's Q
  // waits for that release, so it comes at the end of the item instead.
  auto release = [&]() {
    if (tid == 0 && stored >= 0) {
      mma::bulk_wait_read<0>();
      mma::mbar_arrive(&qempty[stored]);
      stored = -1;
    }
  };
  for (int i = blockIdx.x, j = 0; i < nitems; i += gridDim.x, ++j) {
    const PwItem it = pw_item<BN>(p, i);
    const int qb = j % QBUF;
    char* Qb = sm + S::Q + qb * S::QTILE;
    const char* Qc = Qb + cw * PW_BOX;
    const int c0 = it.q0 + PW_ROWS * cw;
    wq0 = c0 + 16 * warp;
#pragma unroll
    for (int e = 0; e < S::NPV / 2; ++e) o[e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    mma::mbar_wait(&qfull[qb], (j / QBUF) & 1);

    // Products are issued in sections, one a turn: S_0; then S_t with
    // P_{t-1} V_{t-1}; then the last P V.  Every tile the item reads is
    // multiplied by both consumers, whose masks hide what their rows do not
    // see (at most a tile a consumer at the causal diagonal or the window's
    // edge): products under a condition would be serialised.
    if (it.ntiles > 0) {
      if (cw == 1) wgmma::bar_arrive(PW_BAR_TURN, 2 * 128);  // consumer 0 takes the first turn
      float alpha[2];
      const int st0 = n % STAGES;
      mma::mbar_wait(&kfull[st0], (n / STAGES) & 1);
      zero_s();
      wgmma::bar_sync(PW_BAR_TURN + cw, 2 * 128);
      wgmma::fence();
      issue_s(Qc, st0);
      wgmma::bar_arrive(PW_BAR_TURN + (cw ^ 1), 2 * 128);
      wgmma::wait<0>();
      wgmma::fence_regs(s);
      mma::mbar_arrive(&kempty[st0]);
      release();
      softmax(it.t_lo * BN, alpha);
      pack_p();
      for (int t = 1; t < it.ntiles; ++t) {
        const int a = n + t, st = a % STAGES, pst = (a - 1) % STAGES;
        mma::mbar_wait(&kfull[st], (a / STAGES) & 1);
        mma::mbar_wait(&vfull[pst], ((a - 1) / STAGES) & 1);
        wgmma::fence_regs(o);
        wgmma::fence_regs(pa);
        zero_s();
        wgmma::bar_sync(PW_BAR_TURN + cw, 2 * 128);
        wgmma::fence();
        issue_s(Qc, st);
        issue_pv(pst);
        wgmma::bar_arrive(PW_BAR_TURN + (cw ^ 1), 2 * 128);
        wgmma::wait<1>();  // S_t done; P_{t-1} V_{t-1} runs under the softmax
        wgmma::fence_regs(s);
        mma::mbar_arrive(&kempty[st]);
        softmax((it.t_lo + t) * BN, alpha);
        wgmma::wait<0>();
        wgmma::fence_regs(o);
        wgmma::fence_regs(pa);
        mma::mbar_arrive(&vempty[pst]);
#pragma unroll
        for (int e = 0; e < S::NPV / 8; ++e) {
          o[4 * e] *= alpha[0];
          o[4 * e + 1] *= alpha[0];
          o[4 * e + 2] *= alpha[1];
          o[4 * e + 3] *= alpha[1];
        }
        pack_p();
      }
      const int last = n + it.ntiles - 1, pst = last % STAGES;
      mma::mbar_wait(&vfull[pst], (last / STAGES) & 1);
      wgmma::fence_regs(o);
      wgmma::fence_regs(pa);
      wgmma::bar_sync(PW_BAR_TURN + cw, 2 * 128);
      wgmma::fence();
      issue_pv(pst);
      if (cw == 0) wgmma::bar_arrive(PW_BAR_TURN + 1, 2 * 128);
      wgmma::wait<0>();
      wgmma::fence_regs(o);
      mma::mbar_arrive(&vempty[pst]);
      n += it.ntiles;
    }

    // Epilogue: o / l as bf16 into this consumer's half of the item's Q
    // slabs (its own rows, read by no one else, done with after its last
    // product) in the slabs' swizzled layout, then a TMA store a slab;
    // rows past Sq and columns past D are not written.  The lse (natural
    // log) where asked.  The Q buffer is released once the stores have
    // read it.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      const int row = 16 * warp + g + 8 * r;  // of the consumer's 64
      char* dst = Qb + cw * PW_BOX + row * 128 + 4 * t;
#pragma unroll
      for (int e = 0; e < S::NPV / 8; ++e)
        *reinterpret_cast<uint32_t*>(dst + (e >> 3) * PW_QSLAB + (((e & 7) ^ (row & 7)) << 4)) =
            mma::pack_bf16(o[4 * e + 2 * r] * inv, o[4 * e + 2 * r + 1] * inv);
      // m is in log2 units here (the scores carry log2 e)
      if (p.lse != nullptr && t == 0 && c0 + row < p.Sq)
        write_lse(p, it.b, it.h, c0 + row, m[r] * LN2, lr);
    }
    mma::fence_proxy_async();
    wgmma::bar_sync(PW_BAR_EPILOGUE + cw, 128);
    release();
    if (tid == 0) {
      if (c0 < p.Sq) {
#pragma unroll
        for (int c = 0; c < S::DP / 64; ++c)
          mma::tma_store_4d(&wp.o, Qb + c * PW_QSLAB + cw * PW_BOX, 64 * c, it.h, c0, it.b);
        mma::bulk_commit();
      }
      stored = qb;
    }
    if constexpr (QBUF == 1) release();
  }
  release();  // the last store's reads: shared memory stays until they finish
}

// Decode (Sq < 16) at D 256: a block owns one (b, KV head) and up to 16
// query rows of its GQA group (rows r = head-in-group * Sq + position), so
// the group shares every K/V read.  Its 4 warps split the keys in steps of
// KEYS and read K and V straight from global memory into registers with
// wide loads, then merge their partial (m, l, o) in shared memory.  The
// inner index of each product is permuted so that a lane's share of a key
// row is contiguous (DcMap); both operands of a product use the same
// permutation.
constexpr int DC_WARPS = 4;

template <int D>
struct DcMap {
  static_assert(D % 64 == 0, "whole 16-byte loads a lane");
  // Q K^T, inner index d: a 32-wide chunk c is one 16-byte load of
  // d = 32 c + 8 t .. + 7 per lane (k-steps 2c and 2c + 1).
  static constexpr int C32 = D / 32;
  static constexpr int KW = 4 * C32;  // words of a key row per lane
  // P V, output column: n8 tile nt, column c is d = col(nt, c), so a lane
  // (column g) reads d = 64 i + 8 g .. + 7 of each 64-wide block i (16
  // bytes).
  static constexpr int W64 = D / 64;
  static constexpr int VW = D / 16;  // words of a value row per lane
  static constexpr int KEYS = 16;    // keys a warp takes per step (registers)
  static constexpr int NKT = KEYS / 8;
  // The output alone is D / 2 registers a lane: Q's fragments live in
  // shared memory (one copy for the block's 4 warps) and a step's V loads
  // wait until its scores are formed and its K registers free.
  __device__ static int col(int nt, int c) { return 64 * (nt / 8) + 8 * c + nt % 8; }
  // The (word, word + 1) pair of a row's KW words that holds k-step ks.
  __device__ static int kword(int ks) { return 4 * (ks / 2) + 2 * (ks & 1); }
};

template <int D>
__device__ __forceinline__ void load_krow(uint32_t (&w)[DcMap<D>::KW], const bf16* row, bool ok,
                                          int t) {
  using M = DcMap<D>;
#pragma unroll
  for (int c = 0; c < M::C32; ++c) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(row + 32 * c + 8 * t))
                       : make_uint4(0u, 0u, 0u, 0u);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void load_vrow(uint32_t (&w)[DcMap<D>::VW], const bf16* row, bool ok,
                                          int g) {
  using M = DcMap<D>;
#pragma unroll
  for (int i = 0; i < M::W64; ++i) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(row + 64 * i + 8 * g))
                       : make_uint4(0u, 0u, 0u, 0u);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// V rows of one step's keys kb.. as the B fragments of P V: for k-step kk,
// the lane's keys 16 kk + 2 t + {0, 1, 8, 9}.
template <int D>
__device__ __forceinline__ void load_vstep(uint32_t (&w)[DcMap<D>::NKT / 2][4][DcMap<D>::VW],
                                           const bf16* vg, int64_t vss, int kb, int k_hi,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < DcMap<D>::NKT / 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 16 * kk + 2 * (lane & 3) + (i & 1) + 8 * (i >> 1);
      load_vrow<D>(w[kk][i], vg + key * vss, key < k_hi, lane >> 2);
    }
}

template <int D>
struct DcSmem {  // in floats: each warp's m and l of 16 rows, then its 16 x D partial o,
                 // then Q's A fragments, [k-step][lane] as 16 bytes each
  static constexpr int L = DC_WARPS * 16;
  static constexpr int O = 2 * DC_WARPS * 16;
  static constexpr int QF = O + DC_WARPS * 16 * D;
  static constexpr size_t BYTES = sizeof(float) * (QF + D / 16 * 32 * 4);
};

// SPLIT: the block takes only keys split * chunk .. + chunk (blockIdx.z =
// b * splits + split) and writes its unnormalised partial o with its rows'
// max m (log2 units) and sum l to p.part, for attn_decode_merge.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(DC_WARPS * 32) attn_decode_bf16(const Params p) {
  using M = DcMap<D>;
  using S = DcSmem<D>;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int NKT = M::NKT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (SPLIT) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kvh = blockIdx.y;
  const int b = SPLIT ? blockIdx.z / p.splits : blockIdx.z;
  const int split = SPLIT ? blockIdx.z - b * p.splits : 0;
  const int group = p.H / p.KV;
  const int rows = group * p.Sq;
  const int r0 = blockIdx.x * 16;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;

  // This lane's two query rows (g and g + 8) as A fragments of Q K^T, in
  // shared memory, where warp 0 writes them.
  int qpos[2];
  uint4* Qs = reinterpret_cast<uint4*>(sm + S::QF);
  {
    uint32_t qw[2][M::KW];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      const bool ok = row < rows;
      const int hh = kvh * group + (ok ? row / p.Sq : 0);
      qpos[r] = ok ? row % p.Sq : 0;
      load_krow<D>(qw[r], static_cast<const bf16*>(p.q) + b * p.qsb + hh * p.qsh + qpos[r] * p.qss,
                   ok, t);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int w = M::kword(ks);
      const uint4 f = make_uint4(qw[0][w], qw[1][w], qw[0][w + 1], qw[1][w + 1]);
      if (warp == 0) Qs[ks * 32 + lane] = f;
    }
  }
  __syncthreads();

  const int k_hi = p.causal ? min(p.Sk, p.Sq) : p.Sk;
  // This block's steps: all, or (SPLIT) those of its chunk of keys, which
  // is a whole number of steps.
  const int s_lo = SPLIT ? split * p.chunk / M::KEYS : 0;
  const int s_hi = SPLIT ? (min(k_hi, (split + 1) * p.chunk) + M::KEYS - 1) / M::KEYS
                         : (k_hi + M::KEYS - 1) / M::KEYS;
  float o[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int step = s_lo + warp; step < s_hi; step += DC_WARPS) {
    const int kb = step * M::KEYS;
    // K for the scores first, V for P V after them.
    uint32_t kw[NKT][M::KW];
    uint32_t vw[NKT / 2][4][M::VW];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = kb + 8 * j + g;
      load_krow<D>(kw[j], kg + key * p.kss, key < k_hi, t);
    }

    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int w = M::kword(ks);
        const uint4 f = Qs[ks * 32 + lane];
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
        mma::mma_bf16(s[j], a, kw[j][w], kw[j][w + 1]);
      }
    }
    load_vstep<D>(vw, vg, p.vss, kb, k_hi, lane);
    const bool need_mask = p.causal || p.window > 0 || kb + M::KEYS > p.Sk;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = score(s[j][e], p, need_mask, kb + 8 * j + mma::acc_col(lane, e),
                        qpos[e >> 1]);
    online_softmax<NKT, NT>(s, m, l, o);
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t a[4];
      p_fragment<NKT>(s, kk, a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int w = nt >> 1;
        const uint32_t b0 = nt & 1 ? mma::pair_hi(vw[kk][0][w], vw[kk][1][w])
                                   : mma::pair_lo(vw[kk][0][w], vw[kk][1][w]);
        const uint32_t b1 = nt & 1 ? mma::pair_hi(vw[kk][2][w], vw[kk][3][w])
                                   : mma::pair_lo(vw[kk][2][w], vw[kk][3][w]);
        mma::mma_bf16(o[nt], a, b0, b1);
      }
    }
  }

  // Merge the warps' partial (m, l, o) and write o / l.
  float* Ms = sm;
  float* Ls = sm + S::L;
  float* Os = sm + S::O + warp * 16 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (t == 0) {
      Ms[warp * 16 + g + 8 * r] = m[r];
      Ls[warp * 16 + g + 8 * r] = lr;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      Os[(g + 8 * r) * D + M::col(nt, 2 * t)] = o[nt][2 * r];
      Os[(g + 8 * r) * D + M::col(nt, 2 * t + 1)] = o[nt][2 * r + 1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 16 * D; idx += DC_WARPS * 32) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    if (row >= rows) break;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) mx = fmaxf(mx, Ms[w * 16 + r]);
    float lsum = 0.f, acc = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < DC_WARPS; ++w) {
        const float a = mma::exp2_approx(Ms[w * 16 + r] - mx);
        lsum += Ls[w * 16 + r] * a;
        acc += sm[S::O + (w * 16 + r) * D + d] * a;
      }
    }
    const int hh = kvh * group + row / p.Sq;
    if constexpr (SPLIT) {
      const int64_t part = ((static_cast<int64_t>(b) * p.H + hh) * p.Sq + row % p.Sq) * p.splits +
                           split;
      const int64_t all = static_cast<int64_t>(p.B) * p.H * p.Sq * p.splits;
      p.part[part * D + d] = acc;
      if (d == 0) {
        p.part[all * D + 2 * part] = mx;
        p.part[all * D + 2 * part + 1] = lsum;
      }
    } else {
      bf16* og = static_cast<bf16*>(p.o) + b * p.osb + hh * p.osh + (row % p.Sq) * p.oss;
      og[d] = __float2bfloat16_rn(lsum > 0.f ? acc / lsum : 0.f);
      // mx is in log2 units (the scores carry log2 e)
      if (p.lse != nullptr && d == 0) write_lse(p, b, hh, row % p.Sq, mx * LN2, lsum);
    }
  }
}

// The split decode's second launch: one block a row (b, h, position) and a
// thread a column merges the row's `splits` partials (o, m, l) as the
// block's warps merge theirs, o = sum_s 2^(m_s - M) o_s / L with M the
// largest m_s and L = sum_s 2^(m_s - M) l_s, and writes o in bf16 and (when
// asked) the fp32 log-sum-exp.  A split that admitted no key has m = -inf
// and adds nothing; a row with none in any split gives 0 and lse -inf.
__global__ void attn_decode_merge(const Params p, int D) {
  extern __shared__ float ml[];  // the row's (m, l) of each split, 2 * splits floats
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split blocks' partials
  const int row = blockIdx.x;  // (b * H + h) * Sq + position
  const int d = threadIdx.x;
  const int qpos = row % p.Sq;
  const int hh = (row / p.Sq) % p.H;
  const int b = row / (p.Sq * p.H);
  const int64_t all = static_cast<int64_t>(p.B) * p.H * p.Sq * p.splits;
  const float* part_ml = p.part + all * D + 2 * static_cast<int64_t>(row) * p.splits;
  const float* po = p.part + static_cast<int64_t>(row) * p.splits * D + d;
  for (int i = d; i < 2 * p.splits; i += blockDim.x) ml[i] = part_ml[i];
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) {  // the partials' loads, 8 in flight
      const float a = mma::exp2_approx(ml[2 * s] - mx);
      lsum += ml[2 * s + 1] * a;
      acc += po[s * D] * a;
    }
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.osb + hh * p.osh + qpos * p.oss;
  og[d] = __float2bfloat16_rn(lsum > 0.f ? acc / lsum : 0.f);
  if (p.lse != nullptr && d == 0) write_lse(p, b, hh, qpos, mx * LN2, lsum);
}

// ---------------------------------------------------------------------------
// bf16 decode (Sq < 16) below D 256: attn_decode_tma<D>, one launch a call.
// A block owns one (b, KV head), 16 rows of its GQA group (rows r = head in
// group * Sq + position, so the group shares every K / V read) and one
// range of keys: blockIdx.x = the range (`splits` of `chunk` keys, chunk a
// multiple of DT_GROUP; one range, all keys, from the unsplit entries),
// blockIdx.y = KV head * row tiles + row tile, blockIdx.z = b.  The ranges
// of one (b, KV head, rows) are the CTAs of one thread-block cluster, the
// range 0 its leader.
//
// Warps: DT_CONSUMERS consumer warps and one producer warp.  The
// producer's lane 0 prefetches the tensor maps, sets up the barriers and
// requests every stage of a ring of Dt::STAGES stages of DT_TILE_KEYS keys
// by TMA (64-row boxes; a range's last, partial tile as 16-row boxes), K
// and V on barriers of their own, before the block's first barrier; then
// it refills each stage as the consumers release it.  Consumer warp w
// takes keys 16 w .. 16 w + 15 of every tile: S = Q K^T by mma.sync
// m16n8k16 (Q's fragments by ldmatrix once, K's by ldmatrix from the
// swizzled slabs), scale, softcap, masks and online softmax in registers,
// O += P V (V's fragments by ldmatrix.trans), and keeps its own (m, l, o).
// After the last tile the ring holds the merge: the warps' partials merge
// into the block's (m, l, o), each consumer thread a few (row, 4 columns)
// items, in warp order.  One range: o / l is written there.  Split: the
// consumer threads of every block but the leader store their items'
// (m, l, o) into the leader's shared memory (st.shared::cluster) and
// arrive on its mbarrier, releasing the stores to the cluster (after one
// cluster barrier, arrived at as the blocks start and waited on after
// their loops, so the barrier is known set up), and leave; the leader's
// threads merge their items with the other ranges' in the order of the
// ranges' index, whatever the order they arrived in (a call's bits
// repeat), and write o and the lse.  No fp32 partial goes through global
// memory.
constexpr int DT_CONSUMERS = 4;
constexpr int DT_THREADS = 32 * (DT_CONSUMERS + 1);
constexpr int DT_PRODUCER = 32 * DT_CONSUMERS;  // the producer warp's lane 0
constexpr int DT_TILE_KEYS = 64;  // keys of a ring stage: one 64-row TMA box a slab
constexpr int DT_GROUP = 16;      // keys of a consumer warp's share of a tile; a range's grain
constexpr int DT_MAX_SPLITS = 8;  // CTAs of a cluster (the portable limit)
constexpr int DT_BAR_CONSUMERS = 1;  // named barrier of the consumer warps

template <int D>
struct Dt {
  static constexpr int DP = (D + 63) / 64 * 64;  // columns of a K or V tile in shared memory
  static constexpr uint32_t SLAB = DT_TILE_KEYS * 128;
  static constexpr uint32_t TILE = DP / 64 * SLAB;
  static constexpr int STAGES = DP == 64 ? 3 : 2;  // 48-64 KB of ring: 3-4 blocks an SM
  static constexpr uint32_t QROW = (D + 8) * 2;    // a padded Q row: ldmatrix without conflicts
  // A block's partial, in floats: m and l of 16 rows, then o, rows x D
  // (the rows a block holds, at most 16: part(rows) bytes).
  static constexpr int PM = 0, PL = 16, PO = 32;
  __host__ __device__ static constexpr uint32_t part(int rows) { return 4 * (32 + (rows < 16 ? rows : 16) * D); }
  // Bytes from the 1024-aligned base: K stages, V stages, Q, the barriers
  // kfull, vfull, empty [STAGES] and recv, then (the leader of a split
  // call) the other ranges' partials, part(rows) bytes apart.
  static constexpr uint32_t K = 0, V = STAGES * TILE, Q = 2 * STAGES * TILE;
  static constexpr uint32_t BARS = Q + 16 * QROW;
  static constexpr uint32_t RECV = (BARS + 8 * (3 * STAGES + 1) + 15) / 16 * 16;
  static constexpr size_t bytes(int splits, int rows) {
    return RECV + (splits - 1) * part(rows) + 1024;
  }
  // The warps' merge, in floats over the ring: each warp's m and l of 16
  // rows and its 16 x D partial o (rows WROW apart).
  static constexpr int WROW = D + 8;
  static constexpr int WM = 0, WL = WM + DT_CONSUMERS * 16, WO = WL + DT_CONSUMERS * 16;
  static_assert(4 * (WO + DT_CONSUMERS * 16 * WROW) <= 2 * STAGES * TILE, "merge area");
  static_assert(bytes(1, 16) <= 232448 / 2 && bytes(DT_MAX_SPLITS, 16) <= 232448, "shared memory");
};

struct DtParams {
  CUtensorMap k, v;      // 64-row boxes: a whole tile
  CUtensorMap k16, v16;  // 16-row boxes: a range's last, partial tile
  Params p;
};

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// The cluster barrier in two halves: every thread of the cluster arrives,
// then waits.  The arrival is relaxed: it orders nothing but the mbarrier
// initialisation, which fence_mbar_init has released to the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// `p` of this CTA's shared memory at the same place in CTA `rank`'s.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(mma::smem_addr(p)), "r"(rank));
  return a;
}
// Stores to another CTA's shared memory (addresses from cluster_addr), and
// an arrival on its mbarrier that releases them to the cluster.
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// mma::mbar_wait, acquiring at cluster scope what other CTAs released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(DT_THREADS) attn_decode_tma(const __grid_constant__ DtParams dp) {
  using S = Dt<D>;
  constexpr int KS = D / 16, NT = D / 8, STAGES = S::STAGES;
  const Params& p = dp.p;
  char* sm = wgmma::aligned_smem();
  float* f = reinterpret_cast<float*>(sm);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;
  uint64_t* recv = empty + STAGES;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int splits = p.splits > 1 ? p.splits : 1;
  const int split = blockIdx.x;
  const int group = p.H / p.KV;
  const int rows = group * p.Sq;
  const int mtiles = (rows + 15) / 16;
  const int kvh = blockIdx.y / mtiles;
  const int r0 = (blockIdx.y - kvh * mtiles) * 16;
  const int b = blockIdx.z;
  const int nrows = min(16, rows - r0);
  const uint32_t slot = S::part(rows);  // the leader's stride between received partials

  // The block's keys [lo, hi): its range, cut to what its rows can see
  // (lo a multiple of DT_GROUP).
  const bool one_head = r0 / p.Sq == (r0 + nrows - 1) / p.Sq;
  const int qmin = one_head ? r0 % p.Sq : 0;
  const int qmax = one_head ? (r0 + nrows - 1) % p.Sq : p.Sq - 1;
  const int chunk = splits > 1 ? p.chunk : p.Sk;
  const int k_hi = p.causal ? min(p.Sk, qmax + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, qmin - p.window + 1) / DT_GROUP * DT_GROUP : 0;
  const int lo = max(split * chunk, k_lo);
  const int hi = min(split * chunk + chunk, k_hi);
  const int ngroups = hi > lo ? (hi - lo + DT_GROUP - 1) / DT_GROUP : 0;
  const int ntiles = (ngroups + DT_CONSUMERS - 1) / DT_CONSUMERS;

  // Tile t's K and V into its stage (the producer's lane 0).
  auto load_tile = [&](int t) {
    const int st = t % STAGES;
    const int g = min(DT_CONSUMERS, ngroups - DT_CONSUMERS * t);
    const int key0 = lo + t * DT_TILE_KEYS;
    for (int kv = 0; kv < 2; ++kv) {
      uint64_t* bar = (kv ? vfull : kfull) + st;
      char* dst = sm + (kv ? S::V : S::K) + st * S::TILE;
      mma::mbar_expect_tx(bar, g * DT_GROUP * 128 * (S::DP / 64));
#pragma unroll
      for (int c = 0; c < S::DP / 64; ++c) {
        if (g == DT_CONSUMERS) {
          mma::tma_load_4d(dst + c * S::SLAB, kv ? &dp.v : &dp.k, bar, 64 * c, kvh, key0, b);
        } else {
          for (int j = 0; j < g; ++j)
            mma::tma_load_4d(dst + c * S::SLAB + j * DT_GROUP * 128, kv ? &dp.v16 : &dp.k16, bar,
                             64 * c, kvh, key0 + DT_GROUP * j, b);
        }
      }
    }
  };

  char* Qs = sm + S::Q;
  if (threadIdx.x == DT_PRODUCER) {
    if (ntiles > 0) {
      prefetch_map(&dp.k);
      prefetch_map(&dp.v);
      prefetch_map(&dp.k16);
      prefetch_map(&dp.v16);
    }
    for (int i = 0; i < STAGES; ++i) {
      mma::mbar_init(&kfull[i], 1);
      mma::mbar_init(&vfull[i], 1);
      mma::mbar_init(&empty[i], DT_CONSUMERS);
    }
    // the leader's: every consumer thread of the other ranges arrives once
    mma::mbar_init(recv, splits > 1 && split == 0 ? (splits - 1) * 32 * DT_CONSUMERS : 1);
    mma::fence_mbar_init();
    for (int t = 0; t < min(ntiles, STAGES); ++t) load_tile(t);
  } else if (warp < DT_CONSUMERS) {
    // Q's 16 rows (zeros past the block's) into shared memory.
    for (int i = threadIdx.x; i < 16 * (D / 8); i += 32 * DT_CONSUMERS) {
      const int r = i / (D / 8), c = i - r * (D / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        const int row = r0 + r;
        const int hh = kvh * group + row / p.Sq;
        v = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.q) + b * p.qsb +
                                                 hh * p.qsh + (row % p.Sq) * p.qss + 8 * c));
      }
      *reinterpret_cast<uint4*>(Qs + r * S::QROW + 16 * c) = v;
    }
  }
  __syncthreads();
  if (splits > 1) cluster_arrive();

  if (warp == DT_CONSUMERS) {  // the producer: each further stage as it frees
    if (lane == 0) {
      for (int t = STAGES; t < ntiles; ++t) {
        mma::mbar_wait(&empty[t % STAGES], (t / STAGES - 1) & 1);
        load_tile(t);
      }
    }
    __syncwarp();
    if (splits > 1) cluster_wait();
  } else {
    const int tid = threadIdx.x;  // 0 .. 127
    const int g = lane >> 2, t4 = lane & 3;
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma::ldmatrix_x4(qf[ks], Qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * S::QROW +
                                   (2 * ks + (lane >> 4)) * 16);
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      qpos[r] = row < rows ? row % p.Sq : 0;
    }

    float o[NT][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    // This lane's rows of the x4 loads: K as (keys 0-7, 0-7, 8-15, 8-15)
    // x (columns lo, hi) of a k step; V as (keys 0-7, 8-15) x two n8 tiles.
    const int krow = DT_GROUP * warp + (lane & 7) + 8 * (lane >> 4);
    const int vrow = DT_GROUP * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const uint32_t par = (t / STAGES) & 1;
      if (warp < min(DT_CONSUMERS, ngroups - DT_CONSUMERS * t)) {
        const int kb = lo + t * DT_TILE_KEYS + DT_GROUP * warp;  // this warp's first key
        const char* Kt = sm + S::K + st * S::TILE;
        const char* Vt = sm + S::V + st * S::TILE;
        float s[2][4] = {};
        mma::mbar_wait(&kfull[st], par);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int u = 2 * ks + ((lane >> 3) & 1);  // 16-byte unit of the row
          uint32_t kf[4];
          mma::ldmatrix_x4(kf, Kt + (u >> 3) * S::SLAB + krow * 128 + (((u & 7) ^ (krow & 7)) << 4));
          mma::mma_bf16(s[0], qf[ks], kf[0], kf[1]);
          mma::mma_bf16(s[1], qf[ks], kf[2], kf[3]);
        }
        // Keys past the range's end are past Sk or, causal, past every
        // row's position: the masks below remove them.
        const bool need_mask = p.causal || p.window > 0 || kb + DT_GROUP > hi;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = score(s[j][e], p, need_mask, kb + 8 * j + mma::acc_col(lane, e), qpos[e >> 1]);
        online_softmax<2, NT>(s, m, l, o);
        uint32_t a[4];
        p_fragment<2>(s, 0, a);
        mma::mbar_wait(&vfull[st], par);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int u = 2 * np + (lane >> 4);
          uint32_t vf[4];
          mma::ldmatrix_x4_trans(vf, Vt + (u >> 3) * S::SLAB + vrow * 128 +
                                         (((u & 7) ^ (vrow & 7)) << 4));
          mma::mma_bf16(o[2 * np], a, vf[0], vf[1]);
          mma::mma_bf16(o[2 * np + 1], a, vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mma::mbar_arrive(&empty[st]);
    }

    // Every consumer past its last tile (warp 0 waited for each tile's
    // loads): the ring is free.  The warps' partials into it, then each
    // thread's items (row r, columns 4 c .. 4 c + 3) merged over the warps.
    if (splits > 1) cluster_wait();  // the leader's recv barrier is set up
    wgmma::bar_sync(DT_BAR_CONSUMERS, 32 * DT_CONSUMERS);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = g + 8 * r;
      if (t4 == 0) {
        f[S::WM + warp * 16 + row] = m[r];
        f[S::WL + warp * 16 + row] = lr;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(f + S::WO + (warp * 16 + row) * S::WROW + 8 * nt + 2 * t4) =
            make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    }
    wgmma::bar_sync(DT_BAR_CONSUMERS, 32 * DT_CONSUMERS);
    // A range the leader merges: its slot in the leader's shared memory.
    const uint32_t to = split > 0 ? cluster_addr(sm + S::RECV + (split - 1) * slot, 0) : 0u;
    for (int idx = tid; idx < nrows * (D / 4); idx += 32 * DT_CONSUMERS) {
      const int r = idx / (D / 4), c = idx - r * (D / 4);
      float mw[DT_CONSUMERS];
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < DT_CONSUMERS; ++w) {
        mw[w] = f[S::WM + w * 16 + r];
        mx = fmaxf(mx, mw[w]);
      }
      float lsum = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < DT_CONSUMERS; ++w) {
          const float a = mma::exp2_approx(mw[w] - mx);
          const float4 ow = *reinterpret_cast<const float4*>(f + S::WO + (w * 16 + r) * S::WROW + 4 * c);
          lsum += f[S::WL + w * 16 + r] * a;
          acc.x += ow.x * a;
          acc.y += ow.y * a;
          acc.z += ow.z * a;
          acc.w += ow.w * a;
        }
      }
      if (split > 0) {  // a range the leader merges: its partial, into the leader
        st_cluster4(to + 4 * (S::PO + r * D + 4 * c), acc);
        if (c == 0) {
          st_cluster(to + 4 * (S::PM + r), mx);
          st_cluster(to + 4 * (S::PL + r), lsum);
        }
        continue;
      }
      if (splits > 1) {  // the leader: the other ranges' partials, in order
        mbar_wait_cluster(recv, 0);
        float mr = mx;
        for (int sp = 1; sp < splits; ++sp)
          mr = fmaxf(mr, reinterpret_cast<const float*>(sm + S::RECV + (sp - 1) * slot)[S::PM + r]);
        if (mr != -INFINITY) {
          const float a0 = mma::exp2_approx(mx - mr);
          lsum *= a0;
          acc.x *= a0;
          acc.y *= a0;
          acc.z *= a0;
          acc.w *= a0;
          for (int sp = 1; sp < splits; ++sp) {
            const float* pr = reinterpret_cast<const float*>(sm + S::RECV + (sp - 1) * slot);
            const float a = mma::exp2_approx(pr[S::PM + r] - mr);
            const float4 os = *reinterpret_cast<const float4*>(pr + S::PO + r * D + 4 * c);
            lsum += pr[S::PL + r] * a;
            acc.x += os.x * a;
            acc.y += os.y * a;
            acc.z += os.z * a;
            acc.w += os.w * a;
          }
        }
        mx = mr;
      }
      const int row = r0 + r;
      const int hh = kvh * group + row / p.Sq;
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      bf16* og = static_cast<bf16*>(p.o) + b * p.osb + hh * p.osh + (row % p.Sq) * p.oss + 4 * c;
      *reinterpret_cast<uint2*>(og) = make_uint2(mma::pack_bf16(acc.x * inv, acc.y * inv),
                                                 mma::pack_bf16(acc.z * inv, acc.w * inv));
      // mx is in log2 units (the scores carry log2 e)
      if (p.lse != nullptr && c == 0) write_lse(p, b, hh, row % p.Sq, mx * LN2, lsum);
    }
    if (split > 0) mbar_arrive_cluster(cluster_addr(recv, 0));
  }
}

// Launches Kern with `bytes` of dynamic shared memory; the opt-in above
// 48 KB is set once per kernel.
template <auto Kern, typename P>
cudaError_t launch_with_smem(dim3 grid, int threads, size_t bytes, const P& p,
                             cudaStream_t stream) {
  static const cudaError_t attr =
      bytes > 48 * 1024 ? cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes))
                        : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  Kern<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The current device's SM count, read once a device: the prefill's grid
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

// The bf16 prefill: its four tensor maps from the strides (the true head
// dim; TMA zero-fills the columns of a box past it), then the warpgroup
// kernel, on every item (D 256) or on one block an SM walking them.  A map
// that cannot be encoded is an error, never a fallback; with Sk 0 no K or
// V tile is loaded and their maps stay empty.
template <int D>
cudaError_t launch_prefill_wgmma(const Params& p, cudaStream_t stream) {
  using S = Pw<D>;
  PwParams wp{};
  wp.p = p;
  const int64_t qs[3] = {p.qsb, p.qsh, p.qss}, ks[3] = {p.ksb, p.ksh, p.kss},
                vs[3] = {p.vsb, p.vsh, p.vss}, os[3] = {p.osb, p.osh, p.oss};
  if (!mma::encode_map(&wp.q, p.q, qs, D, p.H, p.Sq, p.B) ||
      !mma::encode_map(&wp.o, p.o, os, D, p.H, p.Sq, p.B) ||
      (p.Sk > 0 && (!mma::encode_map(&wp.k, p.k, ks, D, p.KV, p.Sk, p.B) ||
                    !mma::encode_map(&wp.v, p.v, vs, D, p.KV, p.Sk, p.B))))
    return cudaErrorInvalidValue;
  const int64_t items = static_cast<int64_t>(p.B) * p.H * ((p.Sq + PW_BQ - 1) / PW_BQ);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  int grid = static_cast<int>(items);
  if constexpr (S::QBUF > 1) {
    int sms = 0;
    const cudaError_t err = current_sm_count(&sms);
    if (err != cudaSuccess) return err;
    grid = static_cast<int>(items < sms ? items : sms);
  }
  return launch_with_smem<attn_prefill_wgmma<D>>(dim3(grid), PW_THREADS, S::BYTES, wp, stream);
}

// The bf16 decode below D 256: the four K / V tensor maps (64-row and
// 16-row boxes; none with Sk 0, where no tile is loaded), then one launch
// whose ranges of one (b, KV head, rows) form a cluster.  A map that cannot
// be encoded, or more ranges than a cluster holds, is an error, never a
// fallback.
template <int D>
cudaError_t launch_decode_tma(const Params& p, cudaStream_t stream) {
  using S = Dt<D>;
  DtParams dp{};
  dp.p = p;
  const int splits = p.splits > 1 ? p.splits : 1;
  const int64_t ks[3] = {p.ksb, p.ksh, p.kss}, vs[3] = {p.vsb, p.vsh, p.vss};
  if (p.Sk > 0 && (!mma::encode_map(&dp.k, p.k, ks, D, p.KV, p.Sk, p.B) ||
                   !mma::encode_map(&dp.v, p.v, vs, D, p.KV, p.Sk, p.B) ||
                   !mma::encode_map(&dp.k16, p.k, ks, D, p.KV, p.Sk, p.B, DT_GROUP) ||
                   !mma::encode_map(&dp.v16, p.v, vs, D, p.KV, p.Sk, p.B, DT_GROUP)))
    return cudaErrorInvalidValue;
  const int64_t ytiles = static_cast<int64_t>((p.H / p.KV * p.Sq + 15) / 16) * p.KV;
  if (splits > DT_MAX_SPLITS || ytiles > 65535 || p.B > 65535) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_decode_tma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::bytes(DT_MAX_SPLITS, 16)));
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(splits, static_cast<unsigned>(ytiles), p.B);
  cfg.blockDim = dim3(DT_THREADS);
  cfg.dynamicSmemBytes = S::bytes(splits, p.H / p.KV * p.Sq);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, attn_decode_tma<D>, dp);
}

// A bf16 call's kernels: the prefill (Sq >= 16) at every head dim; the
// decode by attn_decode_tma below D 256, and at D 256 by attn_decode_bf16,
// with `part` (split) followed by attn_decode_merge.
template <int D>
cudaError_t launch_bf16_mode(const Params& p, cudaStream_t stream) {
  if (p.Sq >= SPLIT_BELOW_SQ) return launch_prefill_wgmma<D>(p, stream);
  if constexpr (D < 256) {
    return launch_decode_tma<D>(p, stream);
  } else {
    const int mtiles = (p.H / p.KV * p.Sq + 15) / 16;
    if (p.part != nullptr) {
      const cudaError_t err = launch_with_smem<attn_decode_bf16<D, true>>(
          dim3(mtiles, p.KV, p.B * p.splits), DC_WARPS * 32, DcSmem<D>::BYTES, p, stream);
      if (err != cudaSuccess) return err;
      // The merge as a programmatic dependent launch: its blocks are
      // scheduled while the split blocks finish and wait for their writes
      // (griddepcontrol.wait) instead of for a launch after them.
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg{};
      cfg.gridDim = dim3(p.B * p.H * p.Sq);
      cfg.blockDim = dim3(D);
      cfg.dynamicSmemBytes = 2 * sizeof(float) * p.splits;
      cfg.stream = stream;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return cudaLaunchKernelEx(&cfg, attn_decode_merge, p, D);
    }
    return launch_with_smem<attn_decode_bf16<D, false>>(dim3(mtiles, p.KV, p.B), DC_WARPS * 32,
                                                        DcSmem<D>::BYTES, p, stream);
  }
}

cudaError_t launch_bf16(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bf16_mode<16>(p, stream);
    case 32: return launch_bf16_mode<32>(p, stream);
    case 64: return launch_bf16_mode<64>(p, stream);
    case 80: return launch_bf16_mode<80>(p, stream);
    case 128: return launch_bf16_mode<128>(p, stream);
    case 256: return launch_bf16_mode<256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int dtype, int D, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.Sq <= 0 || p.Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dim<float>(p, D, s); break;
    case 1: err = launch_bf16(p, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                                   int64_t qsb, int64_t qsh, int64_t qss,
                                   int64_t ksb, int64_t ksh, int64_t kss,
                                   int64_t vsb, int64_t vsh, int64_t vss,
                                   int64_t osb, int64_t osh, int64_t oss,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  const Params p{q, k, v, o, B, H, KV, Sq, Sk,
                 qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                 causal, window, softcap, scale, nullptr, nullptr, 0, 0};
  return run(p, dtype, D, stream);
}

// flash_attention_fwd, also writing each row's fp32 log-sum-exp of its
// scaled, soft-capped, masked scores to `lse`, a contiguous (B, H, Sq)
// tensor (-inf for a row that admits no key, whose output is 0).  The
// same kernels run, with the flag Params::lse set: attention whose keys
// are split over ranks merges the ranks' (o, lse) by
// o = sum_r exp(lse_r - L) o_r, L = logsumexp_r(lse_r).  What bounds it is
// what bounds the forward (a decode step reads the cache: bytes); the
// log-sum-exp adds 4 bytes a row.
extern "C" int flash_attention_lse(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int dtype, int B, int H, int KV, int Sq, int Sk,
                                   int D, int64_t qsb, int64_t qsh, int64_t qss,
                                   int64_t ksb, int64_t ksh, int64_t kss,
                                   int64_t vsb, int64_t vsh, int64_t vss,
                                   int64_t osb, int64_t osh, int64_t oss,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  const Params p{q, k, v, o, B, H, KV, Sq, Sk,
                 qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                 causal, window, softcap, scale, static_cast<float*>(lse), nullptr, 0, 0};
  return run(p, dtype, D, stream);
}

// bf16 decode (Sq < 16) with its keys split over blocks: `splits` blocks
// per (b, KV head, 16 rows), block s taking keys s * chunk .. + chunk
// (splits * chunk >= Sk), and o written, and if `lse` is not null the
// log-sum-exp as flash_attention_lse does.  The same function as
// flash_attention_fwd / flash_attention_lse; it fills the card where (b,
// KV head, rows) alone gives too few blocks (the wrapper's rule).
//   Below D 256 (attn_decode_tma): chunk a multiple of 16, at most 8
// splits, one launch whose ranges merge on chip, in a cluster: `part` is
// not used (it may be null).  At D 256: chunk a multiple of 64, each
// block writing its partial (o, m, l) to `part`, fp32 scratch of B * H *
// Sq * splits * (D + 2) floats the caller allocates, then
// attn_decode_merge.
extern "C" int flash_attention_decode_split(const void* q, const void* k, const void* v, void* o,
                                            void* lse, void* part, int splits, int chunk,
                                            int dtype, int B, int H, int KV, int Sq, int Sk,
                                            int D, int64_t qsb, int64_t qsh, int64_t qss,
                                            int64_t ksb, int64_t ksh, int64_t kss,
                                            int64_t vsb, int64_t vsh, int64_t vss,
                                            int64_t osb, int64_t osh, int64_t oss,
                                            int causal, int window, float softcap, float scale,
                                            void* stream) {
  const bool wide = D == 256;
  if (dtype != 1 || Sq >= SPLIT_BELOW_SQ || splits < 1 || chunk <= 0 ||
      chunk % (wide ? 64 : DT_GROUP) != 0 || static_cast<int64_t>(splits) * chunk < Sk ||
      (wide ? part == nullptr || static_cast<int64_t>(B) * splits > 65535
            : splits > DT_MAX_SPLITS))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, B, H, KV, Sq, Sk,
                 qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                 causal, window, softcap, scale, static_cast<float*>(lse),
                 static_cast<float*>(part), splits, chunk};
  return run(p, dtype, D, stream);
}

// The card's streaming multiprocessors (cudaDevAttrMultiProcessorCount),
// the input of the wrapper's split rule; -1 on error.
extern "C" int flash_attention_sm_count(int device) {
  int n = 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? n : -1;
}
