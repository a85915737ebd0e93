// Flash attention forward for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel, launched by
// flash_attention_pallas.  It computes the same function: blockwise
// online-softmax attention with scale 1/sqrt(D) applied to q in fp32, an
// optional tanh softcap before the mask, the causal mask k_pos <= q_pos and
// the window mask k_pos > q_pos - window (both counted from 0 at the top
// left), GQA reading KV head h / (H / KV) without repeating it, running
// m / l / acc in fp32, a fully masked row giving 0, output in q's dtype.
//
// What bounds it.  At the serve path's prefill shape (B 8, H 32, S 512,
// D 80, causal, bf16) the call does ~10.7 GFLOP (11 us at the H100 SXM's
// dense bf16 tensor-core peak) and must move 84 MB of q/k/v/o (25 us at
// 3.35 TB/s): it is bound by memory.  A decode step (Sq 1) reads
// B * KV * Sk * D * 2 * 2 bytes of cache and does ~1 FLOP per byte: bound
// by memory by far.  This first version does its products as scalar fp32
// FMAs (67 TFLOP/s), which alone put its prefill floor at ~0.16 ms; on an
// H100 80GB HBM3 at 700 W it takes ~0.7 ms there and ~50 us per decode
// launch at Sk 575.
//
// What the design does about it.  Each block owns one (b, h, q-tile) and
// walks the KV tiles itself (the Pallas kernel's sequential fourth grid
// axis becomes a loop; Hopper blocks run in no order), so q is read once
// and o written once, and the (Sq, Sk) scores never leave the SM.  K/V
// tiles of 32 keys are staged in shared memory with 16-byte loads and
// converted to fp32 there; one lane owns one key for the scores and one
// slice of D for the output, so softmax statistics are warp reductions.
// Prefill (Sq >= 16): 4 warps x 4 query rows share each K/V tile, and
// causal / window bounds skip tiles that are fully masked.  Decode
// (Sq < 16): one query row per block and the 4 warps split the KV tiles
// among themselves, then merge their (m, l, acc) in shared memory, so a
// single query row still keeps 4 warps of loads in flight.  The products
// are scalar fp32 FMAs: simple and exact enough for the 2e-5 fp32
// tolerance; wgmma / TMA are later work.  Sq and Sk are masked at the
// ragged edge, so neither has to divide a tile.
//
// Strides are element strides of the (b, head, seq) axes; the last axis
// must be contiguous, and every pointer and stride 16-byte aligned (the
// Python wrapper checks).  Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void to_float(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
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
                                            int64_t oss, int q0, int Sq) {
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
    }
  } else {
    merge_warps<T, D, RPW>(smem + S::SLABS, m, l, acc, og, p.oss, q0, p.Sq);
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

template <typename T, int D>
cudaError_t launch_mode(const Params& p, cudaStream_t stream) {
  if (p.Sq < SPLIT_BELOW_SQ) return launch<T, D, 1, true>(p, stream);
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
    default: return cudaErrorInvalidValue;
  }
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
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, B, H, KV, Sq, Sk,
                 qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                 causal, window, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dim<float>(p, D, s); break;
    case 1: err = launch_dim<__nv_bfloat16>(p, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
