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
//   bf16 -> attn_prefill_bf16 (Sq >= 16) and attn_decode_bf16 (Sq < 16),
//           tensor-core products (mma.sync m16n8k16, bf16 operands, fp32
//           accumulators; helpers in mma_bf16.cuh).
//
// What bounds it.  At stablelm_3b's prefill shape (B 8, H 32, S 512, D 80,
// causal, bf16) the call does ~10.7 GFLOP (11 us at the H100 SXM's dense
// bf16 tensor-core peak) and must move 84 MB of q/k/v/o (25 us at 3.35
// TB/s): bound by memory.  A decode step (Sq 1) reads B * KV * Sk * D * 2 * 2
// bytes of cache (47 MB at Sk 575, 14 us) and does ~1 FLOP per byte: bound
// by memory by far.  The scalar path's FMAs (67 TFLOP/s) alone put the
// prefill at >= 0.16 ms; it took 0.70-0.71 ms there and 0.053-0.072 ms per
// decode launch (H100 80GB HBM3 at 700 W, chip_smoke.py), 12.8x SDPA.
//
// The bf16 prefill design.  A block owns 128 query rows of one (b, h)
// (8 warps x 16 rows; causal q-tiles longest first) and walks 64-key K/V
// tiles in bf16 shared memory, double-buffered: K and V of the next tile
// are in flight by cp.async while this tile computes, so one barrier a
// tile suffices; tiles the causal / window bounds mask out for a whole
// warp are skipped.  Per tile a warp forms S = Q K^T by mma (D / 16
// k-steps, Q's A fragments re-read from shared memory by ldmatrix, which
// leaves the registers to S and O and measured faster than holding them),
// applies scale, softcap and masks to the fp32 accumulators, runs an
// online softmax in exp2 whose row statistics are reductions within a
// lane quad, and rounds P to bf16 straight into the A operand of P V,
// with V through ldmatrix.trans: no score leaves the registers.  The
// scale is applied to the fp32 scores, not to q.  The epilogue divides by
// l and writes bf16 rows through the block's Q tile with 16-byte stores.
// 67,584 bytes of shared memory at D 80, two blocks an SM (128 registers;
// ptxas spills 52 bytes at D 80 and 20 at D 64).
//
// At D 256 (gemma2_9b) the same plan is kept, one block an SM.  What is
// scarce there: a warp's 16-row fp32 O is D / 2 = 128 registers a lane and
// its 64-key S 32 more, so the launch bounds give the kernel the whole 255
// registers a thread (8 warps an SM, the occupancy the register file
// allows with O whole in registers); the Q tile (128 rows) and the four
// 64-key K/V buffers take 202,752 bytes, under the 227 KB a block may
// have.  Halving the rows (64 a block) or the keys (32 a tile) would
// free shared memory that the registers could not use, and splitting O's D
// over warp pairs would double each pair's Q K^T work or pass S through
// shared memory.  gemma2's prefill at (2, 16, 5120, 256) causal is bound by
// the tensor cores (4 D flops a pair: 0.434 ms at 989 TFLOP/s against
// 0.038 ms for its 126 MB), softcap adding a tanh a score.
//
// The bf16 decode design.  A block owns one (b, KV head) and up to 16
// query rows of its GQA group (head-in-group x position), so the group
// shares every K/V read; its 4 warps split the keys in steps of 32 (16 at
// D 128) and read K and V straight from global memory into registers with
// 16-byte loads, all of a step's loads issued before its products; the
// inner index of each product is permuted so that a lane's share of a row
// is contiguous.  The warps merge their (m, l, o) in shared memory.  At
// D 256 (DcMap::LEAN) O is 128 registers a lane, Q's fragments would be 64
// more and a step's K and V words 64 each: Q's fragments go to shared
// memory once for the block (8 KB, read back 16 bytes a lane a k-step) and
// a step loads V only after its scores are formed, when K's registers are
// free; 16 keys a step as at D 128.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): prefill 0.0906 ms
// against SDPA's 0.0571 (stablelm shape) and 0.0801 against 0.0418 (D 64,
// zamba2); decode at Sk 575 with a cold L2, as a CUDA graph of calls,
// 0.0229 ms against SDPA's 0.0227 (D 80) and 0.0198 against 0.0165 (D 64).
//
// A second entry, flash_attention_lse, runs the same kernels with the flag
// Params::lse set: each also writes its rows' fp32 log-sum-exp, so that the
// partial outputs of keys split over ranks can be merged (decode with the
// cache's sequence split, repro_torch.models.layers).
//
// Strides are element strides of the (b, head, seq) axes; the last axis
// must be contiguous, and every pointer and stride 16-byte aligned (the
// Python wrapper checks).  Launch errors are returned, never swallowed.

#include <cuda_runtime.h>
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

// Prefill (Sq >= 16): a block owns PF_BQ query rows of one (b, h), 16 per
// warp, and walks 64-key K/V tiles through two bf16 shared-memory buffers
// each for K and V: K and V of the next tile load while this one computes,
// so one barrier a tile suffices.
constexpr int PF_WARPS = 8;
constexpr int PF_BQ = PF_WARPS * 16;
constexpr int PF_BK = 64;

template <int D>
struct PfSmem {  // in bf16 elements
  static constexpr int LD = D + 8;  // row stride: 16 bytes of padding keep ldmatrix conflict-free
  static constexpr int TILE = PF_BK * LD;
  static constexpr int KV0 = PF_BQ * LD;  // Q tile first; K[i] = KV0 + i TILE, V[i] = K[2 + i]
  static constexpr size_t BYTES = sizeof(bf16) * (KV0 + 4 * TILE);
};

// ROWS x D bf16 (row stride `stride`) into shared rows of stride LD by
// 16-byte cp.async; rows at or past rows_valid are zero-filled.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* src, int64_t stride,
                                           int rows_valid, int tid, int nthr) {
  constexpr int VPR = D / 8;
  for (int idx = tid; idx < ROWS * VPR; idx += nthr) {
    const int r = idx / VPR;
    const int c = idx - r * VPR;
    const bool ok = r < rows_valid;
    mma::cp_async16(dst + r * LD + c * 8, ok ? src + r * stride + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(PF_WARPS * 32, D <= 80 ? 2 : 1) attn_prefill_bf16(const Params p) {
  using S = PfSmem<D>;
  constexpr int LD = S::LD;
  constexpr int NTHR = PF_WARPS * 32;
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NT = D / 8;      // n8 tiles of the output
  constexpr int NKT = PF_BK / 8; // n8 tiles of a score tile
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  // Causal q-tiles in decreasing length: the longest are scheduled first.
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * PF_BQ;
  const int kvh = h / (p.H / p.KV);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.osb + h * p.osh;

  // Keys any row of this block can see: tiles [t_lo, t_hi).
  const int q_last = min(q0 + PF_BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = k_lo / PF_BK;
  const int t_hi = k_hi > k_lo ? (k_hi + PF_BK - 1) / PF_BK : t_lo;

  bf16* Qs = sm;
  // K and V of a tile into buffer (tile - t_lo) & 1, as one cp.async group.
  auto load = [&](int tile) {
    const int key0 = tile * PF_BK;
    bf16* dst = sm + S::KV0 + ((tile - t_lo) & 1) * S::TILE;
    async_rows<D, PF_BK, LD>(dst, kg + key0 * p.kss, p.kss, p.Sk - key0, tid, NTHR);
    async_rows<D, PF_BK, LD>(dst + 2 * S::TILE, vg + key0 * p.vss, p.vss, p.Sk - key0, tid, NTHR);
    mma::cp_async_commit();
  };
  async_rows<D, PF_BQ, LD>(Qs, qg + q0 * p.qss, p.qss, p.Sq - q0, tid, NTHR);
  mma::cp_async_commit();
  if (t_lo < t_hi) load(t_lo);

  const int wq0 = q0 + warp * 16;     // this warp's first query row
  const bf16* Qw = Qs + warp * 16 * LD;
  float o[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  // At the top of an iteration the only copy in flight is K/V of this
  // tile.  After the barrier every warp is done with tile - 1, whose
  // buffers then take K/V of tile + 1.
  for (int tile = t_lo; tile < t_hi; ++tile) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < t_hi) load(tile + 1);
    const int key0 = tile * PF_BK;
    // Nothing of this tile is visible to this warp's rows: skip its products.
    if (wq0 >= p.Sq || (p.causal && key0 > wq0 + 15) ||
        (p.window > 0 && key0 + PF_BK - 1 <= wq0 - p.window))
      continue;
    const bf16* Ks = sm + S::KV0 + ((tile - t_lo) & 1) * S::TILE;
    const bf16* Vs = Ks + 2 * S::TILE;
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // Q stays in shared memory: its A fragments are re-read each tile,
      // which leaves the registers to S and O (measured faster than
      // holding all D / 16 fragments).
      uint32_t qa[4];
      mma::ldmatrix_x4(qa, Qw + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t kb[4];
        mma::ldmatrix_x4(kb, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                                 ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    const bool need_mask = key0 + PF_BK > p.Sk || (p.causal && key0 + PF_BK - 1 > wq0) ||
                           (p.window > 0 && key0 <= wq0 + 15 - p.window);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = score(s[j][e], p, need_mask, key0 + 8 * j + mma::acc_col(lane, e),
                        wq0 + mma::acc_row(lane, e));
    online_softmax<NKT, NT>(s, m, l, o);
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t a[4];
      p_fragment<NKT>(s, kk, a);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        mma::ldmatrix_x4_trans(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(o[2 * dp], a, vb[0], vb[1]);
        mma::mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
  }
  mma::cp_async_wait<0>();  // Q, copied by every thread, where the block saw no key
  __syncthreads();

  // Epilogue: o / l as bf16 through this warp's rows of the Q tile (no
  // other warp reads them), then 16-byte stores of the rows that exist.
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * r) * LD + nt * 8 + 2 * t) =
          mma::pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    // m is in log2 units here (the scores carry log2 e)
    if (p.lse != nullptr && t == 0 && wq0 + g + 8 * r < p.Sq)
      write_lse(p, b, h, wq0 + g + 8 * r, m[r] * LN2, lr);
  }
  __syncwarp();
  constexpr int VPR = D / 8;
  for (int idx = lane; idx < 16 * VPR; idx += 32) {
    const int r = idx / VPR;
    const int c = idx - r * VPR;
    if (wq0 + r < p.Sq)
      *reinterpret_cast<uint4*>(og + (wq0 + r) * p.oss + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

// Decode (Sq < 16): a block owns one (b, KV head) and up to 16 query rows
// of its GQA group (rows r = head-in-group * Sq + position), so the group
// shares every K/V read.  Its 4 warps split the keys in steps of KEYS and
// read K and V straight from global memory into registers with wide loads,
// then merge their partial (m, l, o) in shared memory.  The inner index
// of each product is permuted so that a lane's share of a key row is
// contiguous (DcMap); both operands of a product use the same permutation.
constexpr int DC_WARPS = 4;

template <int D>
struct DcMap {
  // Q K^T, inner index d: a 32-wide chunk c is one 16-byte load of
  // d = 32 c + 8 t .. + 7 per lane (k-steps 2c and 2c + 1); a 16-wide tail
  // one 8-byte load of d = 32 C32 + 4 t .. + 3.
  static constexpr int C32 = D / 32;
  static constexpr int T16 = (D % 32) / 16;
  static constexpr int KW = 4 * C32 + 2 * T16;  // words of a key row per lane
  // P V, output column: n8 tile nt, column c is d = col(nt, c), so a lane
  // (column g) reads d = 64 i + 8 g .. + 7 of each 64-wide block i (16
  // bytes) and a tail of R / 8 columns (4 or 8 bytes).
  static constexpr int W64 = D / 64;
  static constexpr int R = D % 64;
  static constexpr int VW = D / 16;  // words of a value row per lane
  static constexpr int KEYS = D > 80 ? 16 : 32;  // keys a warp takes per step (registers)
  static constexpr int NKT = KEYS / 8;
  // Above D 128 the output alone is D / 2 registers a lane: Q's fragments
  // move to shared memory (one copy for the block's 4 warps) and a step's
  // V loads wait until its scores are formed and its K registers free.
  static constexpr bool LEAN = D > 128;
  __device__ static int col(int nt, int c) {
    return nt < 8 * W64 ? 64 * (nt / 8) + 8 * c + nt % 8 : 64 * W64 + (R / 8) * c + nt - 8 * W64;
  }
  // The (word, word + 1) pair of a row's KW words that holds k-step ks.
  __device__ static int kword(int ks) { return ks < 2 * C32 ? 4 * (ks / 2) + 2 * (ks & 1) : 4 * C32; }
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
  if constexpr (M::T16) {
    const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(row + 32 * M::C32 + 4 * t))
                       : make_uint2(0u, 0u);
    w[4 * M::C32] = v.x;
    w[4 * M::C32 + 1] = v.y;
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
  if constexpr (M::R == 32) {
    const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(row + 64 * M::W64 + 4 * g))
                       : make_uint2(0u, 0u);
    w[4 * M::W64] = v.x;
    w[4 * M::W64 + 1] = v.y;
  } else if constexpr (M::R == 16) {
    w[4 * M::W64] = ok ? __ldg(reinterpret_cast<const uint32_t*>(row + 64 * M::W64 + 2 * g)) : 0u;
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
                 // then (LEAN) Q's A fragments, [k-step][lane] as 16 bytes each
  static constexpr int L = DC_WARPS * 16;
  static constexpr int O = 2 * DC_WARPS * 16;
  static constexpr int QF = O + DC_WARPS * 16 * D;
  static constexpr size_t BYTES = sizeof(float) * (QF + (DcMap<D>::LEAN ? D / 16 * 32 * 4 : 0));
};

template <int D>
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
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.KV;
  const int rows = group * p.Sq;
  const int r0 = blockIdx.x * 16;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;

  // This lane's two query rows (g and g + 8) as A fragments of Q K^T: in
  // registers, or (LEAN) in shared memory, where warp 0 writes them.
  int qpos[2];
  uint32_t qf[M::LEAN ? 1 : KS][4];
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
      if constexpr (M::LEAN) {
        if (warp == 0) Qs[ks * 32 + lane] = f;
      } else {
        qf[ks][0] = f.x;
        qf[ks][1] = f.y;
        qf[ks][2] = f.z;
        qf[ks][3] = f.w;
      }
    }
  }
  if constexpr (M::LEAN) __syncthreads();

  const int k_hi = p.causal ? min(p.Sk, p.Sq) : p.Sk;
  const int nsteps = (k_hi + M::KEYS - 1) / M::KEYS;
  float o[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int step = warp; step < nsteps; step += DC_WARPS) {
    const int kb = step * M::KEYS;
    // Every load of the step first (LEAN: V after the scores): K for the
    // scores, V for P V.
    uint32_t kw[NKT][M::KW];
    uint32_t vw[NKT / 2][4][M::VW];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = kb + 8 * j + g;
      load_krow<D>(kw[j], kg + key * p.kss, key < k_hi, t);
    }
    if constexpr (!M::LEAN) load_vstep<D>(vw, vg, p.vss, kb, k_hi, lane);

    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int w = M::kword(ks);
        if constexpr (M::LEAN) {
          const uint4 f = Qs[ks * 32 + lane];
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
          mma::mma_bf16(s[j], a, kw[j][w], kw[j][w + 1]);
        } else {
          mma::mma_bf16(s[j], qf[ks], kw[j][w], kw[j][w + 1]);
        }
      }
    }
    if constexpr (M::LEAN) load_vstep<D>(vw, vg, p.vss, kb, k_hi, lane);
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
    bf16* og = static_cast<bf16*>(p.o) + b * p.osb + hh * p.osh + (row % p.Sq) * p.oss;
    og[d] = __float2bfloat16_rn(lsum > 0.f ? acc / lsum : 0.f);
    // mx is in log2 units (the scores carry log2 e)
    if (p.lse != nullptr && d == 0) write_lse(p, b, hh, row % p.Sq, mx * LN2, lsum);
  }
}

// Launches Kern with `bytes` of dynamic shared memory; the opt-in above
// 48 KB is set once per kernel.
template <auto Kern>
cudaError_t launch_with_smem(dim3 grid, int threads, size_t bytes, const Params& p,
                             cudaStream_t stream) {
  static const cudaError_t attr =
      bytes > 48 * 1024 ? cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes))
                        : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  Kern<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_mode(const Params& p, cudaStream_t stream) {
  if (p.Sq < SPLIT_BELOW_SQ) {
    const int mtiles = (p.H / p.KV * p.Sq + 15) / 16;
    return launch_with_smem<attn_decode_bf16<D>>(dim3(mtiles, p.KV, p.B), DC_WARPS * 32,
                                                 DcSmem<D>::BYTES, p, stream);
  }
  return launch_with_smem<attn_prefill_bf16<D>>(dim3(p.B * p.H, (p.Sq + PF_BQ - 1) / PF_BQ),
                                                PF_WARPS * 32, PfSmem<D>::BYTES, p, stream);
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
                 causal, window, softcap, scale, nullptr};
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
                 causal, window, softcap, scale, static_cast<float*>(lse)};
  return run(p, dtype, D, stream);
}
