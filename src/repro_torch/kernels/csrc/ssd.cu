// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel, launched by
// ssd_scan_pallas.  It computes the function of
// repro_torch.kernels.ref.ssd_chunked (y and the final state) in fp32
// arithmetic.  Per (b, h) and chunk of Q steps, with the (N, P) state S
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
// What bounds it.  At the serve path's shape (B 8, S 512, H 64, P 64,
// N 64, Q 128, bf16) the call must read x (33.5 MB) and write y (33.5 MB),
// read dt, B and C (~2 MB) and write the fp32 final state (8.4 MB): ~77 MB,
// 23 us at 3.35 TB/s.  It does 2 Q (Q N + Q P + 2 N P) = 6.3 MFLOP per
// (b, h, chunk), x 2,048 = 12.9 GFLOP: 13 us at the dense bf16 tensor-core
// peak.  So the bound is bytes, 23 us.  This first version does its
// products as scalar fp32 FMAs (67 TFLOP/s), which alone cost at least
// 0.19 ms for 12.9 GFLOP; skipping the tiles above the diagonal of w cuts
// the work it does to ~8.6 GFLOP (0.13 ms at that rate).
//
// What the design does about it.  The TPU kernel's sequential chunk axis
// (grid (B, H, chunks), state in VMEM scratch) becomes a loop over chunks
// inside one block per (b, h): Hopper blocks run in no order, so nothing
// carries between blocks, and x is read once and y written once.  The
// block holds the state and everything a chunk needs in shared memory as
// fp32 (186 KB at the serve shape, so dynamic shared memory set with
// cudaFuncSetAttribute): x [Q][P], B and C transposed [N][Q+4], w
// transposed [Q][Q+4], S [N][P].  Each product is a loop over its inner
// dimension in which a thread owns a 4 x 4 register tile and reads two
// float4 rows; the +4 padding keeps the transposed stores and the scalar
// B reads of the state update off shared banks.  w is computed only on
// the 4 x 4 tiles on or below the diagonal, and exp only where j <= i,
// so the masked upper triangle (where cum_i - cum_j > 0 can overflow) is
// never evaluated.  A ragged last chunk is masked where it is loaded
// (dt = x = B = C = 0, which neither decays nor feeds the state) and
// where y is stored.  C B^T is the same for every head of a (b, chunk) and
// is recomputed per head, as the TPU kernel does; sharing it, mma/wgmma
// products and overlapping the next chunk's loads are later work.
//
// Sizes are runtime values: N and P multiples of 4 in [4, 64], Q a
// multiple of 4 in [4, 128] (the Python wrapper checks; so does the C
// entry).  x, B and C may be strided views (element strides of their
// leading axes, last axis contiguous); y is written through its strides.
// Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

bool supported(int v, int hi) { return v >= 4 && v <= hi && v % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block takes at these sizes.
extern "C" int ssd_scan_smem_bytes(int Q, int N, int P) {
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
    case 1: err = launch<__nv_bfloat16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
