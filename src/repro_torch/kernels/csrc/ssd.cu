// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel, launched by
// ssd_scan_pallas.  It computes the function of
// repro_torch.kernels.ref.ssd_chunked (y and the final state) with fp32
// accumulation.  Per (b, h) and chunk of Q steps, with the (N, P) state S
// carried from chunk to chunk:
//   cum_i = sum_{j<=i} dt_j A,  total = cum_{Q-1}
//   w_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i   = sum_j w_ij x_j + exp(cum_i) (C_i S)
//   S    <- exp(total) S + sum_j exp(total - cum_j) dt_j B_j x_j^T
// x, B, C are fp32 or bf16 (one type), dt and A fp32; y is in x's type and
// the final state (B, H, N, P) fp32.  B and C are shared by all heads.
// Unlike the Pallas kernel, which drops its state, this one writes the
// final state out: the serve path's one-pass prefill hands it to decode.
//
// Two kernels, chosen by dtype alone in ssd_scan_fwd: fp32 -> ssd_fwd,
// scalar fp32 FMAs (unchanged since it was first written; TF32 products
// would miss the 1e-4 fp32 tolerance); bf16 -> ssd_fwd_bf16, tensor-core
// products (mma.sync m16n8k16, bf16 operands, fp32 accumulators; helpers
// in mma_bf16.cuh).
//
// What bounds it.  At zamba2_1p2b's shape (B 8, S 512, H 64, P 64, N 64,
// Q 128, bf16) the call must read x (33.5 MB) and write y (33.5 MB), read
// dt, B and C (~2 MB) and write the fp32 final state (8.4 MB): ~77 MB,
// 23 us at 3.35 TB/s.  It does 2 Q (Q N + Q P + 2 N P) = 6.3 MFLOP per
// (b, h, chunk), x 2,048 = 12.9 GFLOP: 13 us at the dense bf16 tensor-core
// peak.  So the bound is bytes, 23 us.  The scalar kernel does ~8.6 GFLOP
// of fp32 FMAs (67 TFLOP/s) in 186 KB of fp32 shared memory, one block an
// SM: 0.78 ms in bf16 at that shape (H100 80GB HBM3 at 700 W,
// chip_smoke.py).
//
// The scalar design.  The TPU kernel's sequential chunk axis becomes a
// loop over chunks inside one block per (b, h), so nothing carries
// between blocks and x is read once and y written once.  The block holds
// the state and the chunk as fp32 in shared memory: x [Q][P], B and C
// transposed [N][Q+4], w transposed [Q][Q+4], S [N][P]; each product is a
// loop over its inner dimension in which a thread owns a 4 x 4 register
// tile.  w is formed only on the 4 x 4 tiles on or below the diagonal, and
// exp only where j <= i, so the masked upper triangle (where cum_i - cum_j
// > 0 can overflow) is never evaluated.
//
// The bf16 design.  Still one block (8 warps) per (b, h) looping over the
// chunks, but every product is an mma on bf16 operands in shared memory:
// x, B and C as loaded (rows padded to 16-wide tiles with zeros; 64-wide
// rows XOR-swizzled, narrower ones padded by 16 bytes, so ldmatrix hits
// distinct banks), the next chunk's x/B/C landing by cp.async in a second
// buffer while this chunk computes.  cum is formed in log2 units (exp2 on
// the special-function unit).  For y, warps take pairs of 16-row tiles
// (it, QT - 1 - it), balancing the triangle, and a slice of P:
//   C B^T over N on the tiles on or below the diagonal only; w_ij =
//   (C_i . B_j) 2^(cum_i - cum_j) dt_j in fp32 only where j <= i; w x with
//   w straight from the accumulators as the A operand; C S_prev from a
//   bf16 copy of the state; y = 2^cum_i (C S_prev) + w x, stored as bf16.
// The state stays fp32 as mma accumulators spread over the 8 warps
// (16 rows of N x up to 4 n8 tiles of P each), decays by 2^total each
// chunk, gains B^T (coef x) with coef_j = 2^(total - cum_j) dt_j, and is
// written out in fp32.  Rounding w, the state copy and coef x to one bf16
// each would miss the 3e-2 tolerance at the serve shape: y reaches ~250
// there and single outputs come from terms of ~100 that cancel, so an
// emulation of the kernel's rounding put y up to 3x past the tolerance.
// Each of the three is therefore split into hi = bf16(v) and lo =
// bf16(v - hi) and enters its product twice (two mma, one accumulator),
// carrying it to ~2^-16 of itself; the emulation then stays within 0.25
// of the tolerance.  That doubles three of the four products, which are
// cheap beside the memory bound.  C B^T is recomputed per head, as the
// TPU kernel does: sharing it across the heads of a (b, chunk) would need
// those heads in one block or a second launch, and was not tried.
// Shared memory: 115,712 bytes at Q 128, N = P = 64 (two blocks an SM);
// 128 registers, ptxas spills 112 bytes.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.1821 ms at the
// serve shape against the scalar kernel's 0.78 and a 23 us bound.
//
// Sizes are runtime values: N and P multiples of 4 in [4, 64], Q a
// multiple of 4 in [4, 128] (the Python wrapper checks; so does the C
// entry).  x, B and C may be strided views (element strides of their
// leading axes, last axis contiguous); y is written through its strides.
// The bf16 kernel copies x, B and C with 16-byte cp.async where every
// row starts 16-byte aligned in whole units, and element by element
// otherwise.  Launch errors are returned, never swallowed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_Q = 128;
constexpr int MAX_NP = 64;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  void* y;
  float* state;
  int B, S, H, P, N, Q;
  int64_t xsb, xss, xsh;
  int64_t dsb, dss, dsh;
  int64_t bsb, bss;
  int64_t csb, css;
  int64_t ysb, yss, ysh;
};

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// Shared-memory plan, in floats.  Every offset is a multiple of 4 floats
// (Q, N, P are), so float4 accesses stay aligned.
struct Layout {
  int LQ, xs, bt, ct, wt, ss, cum, ecum, coef, dtq, total;
  __host__ __device__ constexpr Layout(int Q, int N, int P)
      : LQ(Q + 4),
        xs(0),
        bt(Q * P),
        ct(Q * P + N * (Q + 4)),
        wt(Q * P + 2 * N * (Q + 4)),
        ss(Q * P + 2 * N * (Q + 4) + Q * (Q + 4)),
        cum(Q * P + 2 * N * (Q + 4) + Q * (Q + 4) + N * P),
        ecum(cum + Q),
        coef(cum + 2 * Q),
        dtq(cum + 3 * Q),
        total(cum + 4 * Q) {}
};

constexpr size_t MAX_BYTES = sizeof(float) * Layout(MAX_Q, MAX_NP, MAX_NP).total;
static_assert(MAX_BYTES <= 232448, "shared memory plan exceeds 227 KB");

__device__ __forceinline__ void unpack(const float4 v, float (&r)[4]) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ssd_fwd(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, N = p.N, P = p.P;
  const Layout L(Q, N, P);
  const int LQ = L.LQ;
  float* Xs = sm + L.xs;     // [Q][P]    x of the chunk
  float* Bt = sm + L.bt;     // [N][LQ]   B^T
  float* Ct = sm + L.ct;     // [N][LQ]   C^T
  float* Wt = sm + L.wt;     // [Q][LQ]   Wt[j][i] = w_ij (tiles with j0 <= i0 only)
  float* Ss = sm + L.ss;     // [N][P]    the state
  float* cum = sm + L.cum;   // [Q]
  float* ecum = sm + L.ecum; // [Q] exp(cum_i)
  float* coef = sm + L.coef; // [Q] exp(total - cum_j) dt_j
  float* dtq = sm + L.dtq;   // [Q]

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* xg = static_cast<const T*>(p.x) + b * p.xsb + h * p.xsh;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const T* bg = static_cast<const T*>(p.b) + b * p.bsb;
  const T* cg = static_cast<const T*>(p.c) + b * p.csb;
  T* yg = static_cast<T*>(p.y) + b * p.ysb + h * p.ysh;
  const float a = p.A[h];

  const int T4 = Q / 4, P4 = P / 4, N4 = N / 4;
  const int n8 = (N + 7) / 8;

  for (int i = tid; i < N * P; i += NTHREADS) Ss[i] = 0.f;

  const int nchunks = (p.S + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.S - t0);  // valid rows of this chunk

    // 1. Stage the chunk as fp32; rows past the end are zeros.
    for (int i = tid; i < Q * P; i += NTHREADS) {
      const int j = i / P;
      const int c = i - j * P;
      Xs[i] = j < qv ? to_f(__ldg(xg + (t0 + j) * p.xss + c)) : 0.f;
    }
    // B and C transposed: a warp covers 8 state columns x 4 rows, so the
    // global reads are row segments and the shared stores hit 32 banks.
    for (int i = tid; i < n8 * 8 * Q; i += NTHREADS) {
      const int g = i >> 5;
      const int l = i & 31;
      const int n = (g % n8) * 8 + (l & 7);
      const int j = (g / n8) * 4 + (l >> 3);
      if (n < N) {
        float bv = 0.f, cv = 0.f;
        if (j < qv) {
          bv = to_f(__ldg(bg + (t0 + j) * p.bss + n));
          cv = to_f(__ldg(cg + (t0 + j) * p.css + n));
        }
        Bt[n * LQ + j] = bv;
        Ct[n * LQ + j] = cv;
      }
    }
    for (int j = tid; j < Q; j += NTHREADS) dtq[j] = j < qv ? __ldg(dg + (t0 + j) * p.dss) : 0.f;
    __syncthreads();

    // 2. cum = cumsum(dt A) over the chunk: warp 0, up to 4 rows a lane.
    if (tid < 32) {
      const int E = (Q + 31) / 32;
      const int j0 = tid * E;
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < Q) run += dtq[j] * a;
        loc[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < Q) cum[j] = excl + loc[e];
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += NTHREADS) {
      ecum[j] = expf(cum[j]);
      coef[j] = expf(total - cum[j]) * dtq[j];
    }

    // 3. w on the 4 x 4 tiles on or below the diagonal, stored transposed.
    const int ntri = T4 * (T4 + 1) / 2;
    for (int k = tid; k < ntri; k += NTHREADS) {
      int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
      while (ti * (ti + 1) / 2 > k) --ti;
      const int i0 = ti * 4;
      const int j0 = (k - ti * (ti + 1) / 2) * 4;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cr[4], br[4];
        unpack(*reinterpret_cast<const float4*>(Ct + n * LQ + i0), cr);
        unpack(*reinterpret_cast<const float4*>(Bt + n * LQ + j0), br);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cr[u], br[v], acc[u][v]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = j0 + v;
        const float cj = cum[j];
        const float dj = dtq[j];
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          w[u] = j <= i ? acc[u][v] * expf(cum[i] - cj) * dj : 0.f;
        }
        *reinterpret_cast<float4*>(Wt + j * LQ + i0) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // 4. y = w x + exp(cum_i) (C S), from the state before this chunk.
    //    Row tiles go in the order 0, T4-1, 1, T4-2, ... over the rounds
    //    of the loop, so the long (late) rows pair with the short ones.
    const int half = (T4 + 1) / 2;
    for (int k = tid; k < T4 * P4; k += NTHREADS) {
      const int q = k / P4;
      const int ti = q < half ? q : T4 - 1 - (q - half);
      const int i0 = ti * 4;
      const int p0 = (k - q * P4) * 4;
      if (i0 >= qv) continue;
      float acc[4][4] = {};
      float acs[4][4] = {};
      const int jend = min(i0 + 4, qv);
      for (int j = 0; j < jend; ++j) {
        float wr[4], xr[4];
        unpack(*reinterpret_cast<const float4*>(Wt + j * LQ + i0), wr);
        unpack(*reinterpret_cast<const float4*>(Xs + j * P + p0), xr);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(wr[u], xr[v], acc[u][v]);
      }
      for (int n = 0; n < N; ++n) {
        float cr[4], sr[4];
        unpack(*reinterpret_cast<const float4*>(Ct + n * LQ + i0), cr);
        unpack(*reinterpret_cast<const float4*>(Ss + n * P + p0), sr);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acs[u][v] = fmaf(cr[u], sr[v], acs[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= qv) break;
        const float e = ecum[i];
        T* yrow = yg + (t0 + i) * p.yss + p0;
#pragma unroll
        for (int v = 0; v < 4; ++v) yrow[v] = from_f<T>(fmaf(e, acs[u][v], acc[u][v]));
      }
    }
    __syncthreads();

    // 5. S <- exp(total) S + sum_j coef_j B_j x_j^T; a thread owns a tile.
    const float decay = expf(total);
    for (int k = tid; k < N4 * P4; k += NTHREADS) {
      const int n0 = (k / P4) * 4;
      const int p0 = (k % P4) * 4;
      float s[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unpack(*reinterpret_cast<const float4*>(Ss + (n0 + u) * P + p0), s[u]);
#pragma unroll
        for (int v = 0; v < 4; ++v) s[u][v] *= decay;
      }
      for (int j = 0; j < qv; ++j) {
        const float cj = coef[j];
        float xr[4], br[4];
        unpack(*reinterpret_cast<const float4*>(Xs + j * P + p0), xr);
#pragma unroll
        for (int u = 0; u < 4; ++u) br[u] = Bt[(n0 + u) * LQ + j] * cj;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = fmaf(br[u], xr[v], s[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(Ss + (n0 + u) * P + p0) =
            make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
    }
    __syncthreads();
  }

  float* sg = p.state + (static_cast<int64_t>(b) * p.H + h) * N * P;
  for (int i = tid; i < N * P; i += NTHREADS) sg[i] = Ss[i];
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = ssd_fwd<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_BYTES));
  if (attr != cudaSuccess) return attr;
  const size_t bytes = sizeof(float) * Layout(p.Q, p.N, p.P).total;
  const dim3 grid(p.H, p.B);
  kern<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (mma.sync m16n8k16, fp32 accumulators).

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// A bf16 tile of rows of `units` 16-byte units (a width rounded up to 16,
// so units is 2, 4, 6 or 8).  Rows of 8 units are XOR-swizzled (unit
// u of row r at u ^ (r & 7)); narrower rows are padded by one unit.
// Either way the 8 row addresses of an ldmatrix fall in distinct banks.
struct Tile {
  int units, stride;  // stride in elements
  __host__ __device__ constexpr Tile(int width)
      : units(round16(width) / 8), stride(round16(width) == 64 ? 64 : round16(width) + 8) {}
  __device__ int off(int row, int unit) const {
    return row * stride + (units == 8 ? unit ^ (row & 7) : unit) * 8;
  }
};

// Shared-memory plan, in bytes: x, B and C of a chunk in two buffers (the
// next chunk's lands while this one computes), the hi and lo bf16 halves
// of the state before the chunk, then dt and cum of the chunk in fp32.
struct TcLayout {
  int QP, NP, PP;
  Tile xt, nt, st;
  int x, bm, cm, shi, slo, dt, cum, bytes;
  __host__ __device__ constexpr TcLayout(int Q, int N, int P)
      : QP(round16(Q)), NP(round16(N)), PP(round16(P)), xt(P), nt(N), st(P),
        x(0),
        bm(2 * QP * xt.stride),
        cm(2 * QP * xt.stride + 2 * QP * nt.stride),
        shi(2 * QP * xt.stride + 4 * QP * nt.stride),
        slo(shi + round16(N) * st.stride),
        dt(2 * (slo + round16(N) * st.stride)),
        cum(dt + 4 * round16(Q)),
        bytes(cum + 4 * round16(Q)) {}
  // Element offsets of x / B / C of buffer `b`.
  __device__ int xo(int b) const { return x + b * QP * xt.stride; }
  __device__ int bo(int b) const { return bm + b * QP * nt.stride; }
  __device__ int co(int b) const { return cm + b * QP * nt.stride; }
};

constexpr int TC_MAX_BYTES = TcLayout(MAX_Q, MAX_NP, MAX_NP).bytes;
// Two blocks an SM: 2 x (bytes + 1 KB reserved) within the SM's 228 KB.
static_assert(2 * (TC_MAX_BYTES + 1024) <= 233472, "two blocks must fit an SM");

struct TcParams {
  Params p;
  int vec16;  // x, B, C rows 16-byte aligned in whole units: cp.async
};

__global__ void __launch_bounds__(TC_THREADS, 2) ssd_fwd_bf16(const TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);
  const int Q = p.Q, N = p.N, P = p.P;
  const TcLayout L(Q, N, P);
  const int QP = L.QP, NP = L.NP, PP = L.PP;
  float* dts = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L.dt);
  float* cum = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + L.cum);
  bf16* Shi = sm + L.shi;
  bf16* Slo = sm + L.slo;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.xsb + h * p.xsh;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const bf16* bg = static_cast<const bf16*>(p.b) + b * p.bsb;
  const bf16* cg = static_cast<const bf16*>(p.c) + b * p.csb;
  bf16* yg = static_cast<bf16*>(p.y) + b * p.ysb + h * p.ysh;
  const float a2 = p.A[h] * 1.4426950408889634f;  // A log2 e: cum in log2 units, exp2 below
  const int nchunks = (p.S + Q - 1) / Q;

  // x, B, C of chunk ch into buffer bi; rows past the sequence and columns
  // past P or N are zeros.  cp.async where the rows allow, else plain loads.
  auto stage = [&](const bf16* src, int64_t rstride, int width, const Tile& tl, bf16* dst,
                   int t0, int qv) {
    if (tp.vec16) {
      for (int idx = tid; idx < QP * tl.units; idx += TC_THREADS) {
        const int j = idx / tl.units;
        const int u = idx - j * tl.units;
        const bool ok = j < qv && u * 8 < width;
        mma::cp_async16(dst + tl.off(j, u), ok ? src + (t0 + j) * rstride + u * 8 : src, ok);
      }
    } else {
      for (int idx = tid; idx < QP * tl.units * 8; idx += TC_THREADS) {
        const int j = idx / (tl.units * 8);
        const int c = idx - j * tl.units * 8;
        dst[tl.off(j, c >> 3) + (c & 7)] =
            j < qv && c < width ? src[(t0 + j) * rstride + c] : __float2bfloat16_rn(0.f);
      }
    }
  };
  auto stage_chunk = [&](int ch, int bi) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.S - t0);
    stage(xg, p.xss, P, L.xt, sm + L.xo(bi), t0, qv);
    stage(bg, p.bss, N, L.nt, sm + L.bo(bi), t0, qv);
    stage(cg, p.css, N, L.nt, sm + L.co(bi), t0, qv);
  };
  auto dt_of = [&](int ch, int j) -> float {
    const int t0 = ch * Q;
    return j < min(Q, p.S - t0) ? __ldg(dg + (t0 + j) * p.dss) : 0.f;
  };

  // The state lives in mma accumulators: warp w owns m-tile w % MT (16
  // rows of N) and a run of n8 tiles of P.
  const int MT = NP / 16;
  const int groups = TC_WARPS / MT;
  const int PT8 = PP / 8;
  const int per = (PT8 + groups - 1) / groups;  // <= 4
  const int s_m = warp % MT;
  const int s_n0 = (warp / MT) * per;
  const int s_cnt = warp / MT < groups ? max(0, min(per, PT8 - s_n0)) : 0;
  float st[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) st[c][0] = st[c][1] = st[c][2] = st[c][3] = 0.f;

  // y work: pairs of 16-row tiles (it, QT - 1 - it) balance the triangle;
  // NS warps share a pair, each a slice of <= 4 n8 tiles of P.
  const int QT = QP / 16;
  const int npair = (QT + 1) / 2;
  const int NS = TC_WARPS / npair;
  const int SW = (PT8 + NS - 1) / NS;
  const int y_pair = warp / NS;
  const int y_n0 = (warp % NS) * SW;
  const int y_cnt = y_pair < npair ? max(0, min(SW, PT8 - y_n0)) : 0;

  {
    uint32_t* s32 = reinterpret_cast<uint32_t*>(Shi);
    for (int i = tid; i < NP * L.st.stride; i += TC_THREADS) s32[i] = 0u;  // hi and lo
  }
  if (tid < QP) dts[tid] = dt_of(0, tid);
  stage_chunk(0, 0);
  mma::cp_async_commit();

  for (int ch = 0; ch < nchunks; ++ch) {
    const int bi = ch & 1;
    const int t0 = ch * Q;
    const int qv = min(Q, p.S - t0);
    mma::cp_async_wait<0>();
    __syncthreads();
    float dt_next = 0.f;
    if (ch + 1 < nchunks) {
      stage_chunk(ch + 1, bi ^ 1);
      mma::cp_async_commit();
      if (tid < QP) dt_next = dt_of(ch + 1, tid);
    }
    // cum = cumsum(dt A) log2 e over the chunk: warp 0, up to 4 rows a lane.
    if (warp == 0) {
      const int E = (QP + 31) / 32;
      const int j0 = lane * E;
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < QP) run += dts[j] * a2;
        loc[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < QP) cum[j] = excl + loc[e];
      }
    }
    __syncthreads();
    const float total = cum[QP - 1];
    const bf16* Xs = sm + L.xo(bi);
    const bf16* Bs = sm + L.bo(bi);
    const bf16* Cs = sm + L.co(bi);

    // y = 2^cum_i (C S) + w x for this warp's row tiles and P slice.
    for (int pi = 0; pi < 2 && y_cnt > 0; ++pi) {
      const int it = pi == 0 ? y_pair : QT - 1 - y_pair;
      if ((pi == 1 && it == y_pair) || it * 16 >= qv) continue;
      const int i0 = it * 16;
      uint32_t cf[4][4];
#pragma unroll
      for (int kn = 0; kn < 4; ++kn)
        if (kn < NP / 16)
          mma::ldmatrix_x4(cf[kn], Cs + L.nt.off(i0 + (lane & 15), 2 * kn + (lane >> 4)));
      float y[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c][0] = y[c][1] = y[c][2] = y[c][3] = 0.f;
      if (ch > 0) {
#pragma unroll
        for (int kn = 0; kn < 4; ++kn) {
          if (kn >= NP / 16) break;
          const int srow = kn * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c >= y_cnt) break;
            uint32_t sh[2], sl[2];
            mma::ldmatrix_x2_trans(sh, Shi + L.st.off(srow, y_n0 + c));
            mma::ldmatrix_x2_trans(sl, Slo + L.st.off(srow, y_n0 + c));
            mma::mma_bf16(y[c], cf[kn], sh[0], sh[1]);
            mma::mma_bf16(y[c], cf[kn], sl[0], sl[1]);
          }
        }
        const float e0 = mma::exp2_approx(cum[i0 + g]);
        const float e1 = mma::exp2_approx(cum[i0 + g + 8]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y[c][0] *= e0;
          y[c][1] *= e0;
          y[c][2] *= e1;
          y[c][3] *= e1;
        }
      }
      const float ci[2] = {cum[i0 + g], cum[i0 + g + 8]};
      for (int jt = 0; jt <= it && jt * 16 < qv; ++jt) {
        const int j0 = jt * 16;
        // C_i . B_j over N, then w_ij = (C_i . B_j) 2^(cum_i - cum_j) dt_j for j <= i.
        float cb[2][4] = {};
#pragma unroll
        for (int kn = 0; kn < 4; ++kn) {
          if (kn >= NP / 16) break;
          uint32_t bb[4];
          mma::ldmatrix_x4(bb, Bs + L.nt.off(j0 + (lane & 7) + ((lane >> 4) << 3),
                                             2 * kn + ((lane >> 3) & 1)));
          mma::mma_bf16(cb[0], cf[kn], bb[0], bb[1]);
          mma::mma_bf16(cb[1], cf[kn], bb[2], bb[3]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + mma::acc_row(lane, e);
            const int j = j0 + 8 * jj + mma::acc_col(lane, e);
            cb[jj][e] = j <= i ? cb[jj][e] * mma::exp2_approx(ci[e >> 1] - cum[j]) * dts[j] : 0.f;
          }
        uint32_t wh[4], wl[4];
        mma::split_bf16(cb[0][0], cb[0][1], wh[0], wl[0]);
        mma::split_bf16(cb[0][2], cb[0][3], wh[1], wl[1]);
        mma::split_bf16(cb[1][0], cb[1][1], wh[2], wl[2]);
        mma::split_bf16(cb[1][2], cb[1][3], wh[3], wl[3]);
        const int xrow = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= y_cnt) break;
          uint32_t xb[2];
          mma::ldmatrix_x2_trans(xb, Xs + L.xt.off(xrow, y_n0 + c));
          mma::mma_bf16(y[c], wh, xb[0], xb[1]);
          mma::mma_bf16(y[c], wl, xb[0], xb[1]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (y_n0 + c) * 8 + 2 * t;
        if (c >= y_cnt || col >= P) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + g + 8 * r;
          if (i < qv)
            *reinterpret_cast<__nv_bfloat162*>(yg + (t0 + i) * p.yss + col) =
                __floats2bfloat162_rn(y[c][2 * r], y[c][2 * r + 1]);
        }
      }
    }

    // S <- 2^total S + sum_j B_j (coef_j x_j)^T, coef_j = 2^(total - cum_j) dt_j;
    // coef x is split into bf16 hi + lo in registers.
    if (s_cnt > 0) {
      const float decay = mma::exp2_approx(total);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[c][e] *= decay;
      for (int j0 = 0; j0 < qv; j0 += 16) {
        uint32_t ab[4];
        mma::ldmatrix_x4_trans(ab, Bs + L.nt.off(j0 + (lane & 7) + ((lane >> 4) << 3),
                                                 2 * s_m + ((lane >> 3) & 1)));
        float cf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 2 * t + (e & 1) + 8 * (e >> 1);
          cf[e] = mma::exp2_approx(total - cum[j]) * dts[j];
        }
        const int xrow = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= s_cnt) break;
          uint32_t xb[2];
          mma::ldmatrix_x2_trans(xb, Xs + L.xt.off(xrow, s_n0 + c));
          const float2 x0 = mma::unpack_bf16(xb[0]);
          const float2 x1 = mma::unpack_bf16(xb[1]);
          uint32_t bh0, bl0, bh1, bl1;
          mma::split_bf16(x0.x * cf[0], x0.y * cf[1], bh0, bl0);
          mma::split_bf16(x1.x * cf[2], x1.y * cf[3], bh1, bl1);
          mma::mma_bf16(st[c], ab, bh0, bh1);
          mma::mma_bf16(st[c], ab, bl0, bl1);
        }
      }
    }
    __syncthreads();
    // The state for the next chunk's C S, as bf16 hi + lo; and its dt.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= s_cnt) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = L.st.off(s_m * 16 + g + 8 * r, s_n0 + c) + 2 * t;
        uint32_t hi, lo;
        mma::split_bf16(st[c][2 * r], st[c][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(Shi + o) = hi;
        *reinterpret_cast<uint32_t*>(Slo + o) = lo;
      }
    }
    if (tid < QP) dts[tid] = dt_next;
  }

  float* sg = p.state + (static_cast<int64_t>(b) * p.H + h) * N * P;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = (s_n0 + c) * 8 + 2 * t;
    if (c >= s_cnt || col >= P) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = s_m * 16 + g + 8 * r;
      if (n < N) *reinterpret_cast<float2*>(sg + n * P + col) = make_float2(st[c][2 * r], st[c][2 * r + 1]);
    }
  }
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(ssd_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TC_MAX_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_fwd_bf16, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec16 = al16(p.x) && al16(p.b) && al16(p.c) && p.P % 8 == 0 && p.N % 8 == 0 &&
                     p.xsb % 8 == 0 && p.xss % 8 == 0 && p.xsh % 8 == 0 && p.bsb % 8 == 0 &&
                     p.bss % 8 == 0 && p.csb % 8 == 0 && p.css % 8 == 0;
  const TcParams tp{p, vec16 ? 1 : 0};
  ssd_fwd_bf16<<<dim3(p.H, p.B), TC_THREADS, TcLayout(p.Q, p.N, p.P).bytes, stream>>>(tp);
  return cudaGetLastError();
}

bool supported(int v, int hi) { return v >= 4 && v <= hi && v % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block takes at these sizes.
// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the tensor-core one).
extern "C" int ssd_scan_smem_bytes(int Q, int N, int P, int dtype) {
  if (dtype == 1) return TcLayout(Q, N, P).bytes;
  return static_cast<int>(sizeof(float) * Layout(Q, N, P).total);
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  dt and A are
// float32, state (B, H, N, P) float32 contiguous.  Returns a cudaError_t
// (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* b,
                            const void* c, void* y, void* state, int dtype, int B, int S,
                            int H, int P, int N, int Q,
                            int64_t xsb, int64_t xss, int64_t xsh,
                            int64_t dsb, int64_t dss, int64_t dsh,
                            int64_t bsb, int64_t bss, int64_t csb, int64_t css,
                            int64_t ysb, int64_t yss, int64_t ysh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || !supported(P, MAX_NP) ||
      !supported(N, MAX_NP) || !supported(Q, MAX_Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c, y,
                 static_cast<float*>(state), B, S, H, P, N, Q,
                 xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css, ysb, yss, ysh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(p, s); break;
    case 1: err = launch_bf16(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
