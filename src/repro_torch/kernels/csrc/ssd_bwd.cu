// Backward of the Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), fp32
// and bf16 inputs.
//
// Replaces: no Pallas kernel.  src/repro/kernels/ssd.py::_ssd_kernel has no
// backward; the JAX package differentiates the jnp oracle
// repro.models.ssm.ssd_chunked with jax.value_and_grad
// (src/repro/train/steps.py:75).  This computes the vjp of
// repro_torch.kernels.ref.ssd_chunked (y and the final state) at (x, dt, A,
// B, C), given dy and, optionally, the final state's cotangent.  Per (b, h)
// and chunk, in the forward's quantities (a_t = dt_t A, cum_i = sum_{t<=i}
// a_t within the chunk, tot = cum_{Q-1}, S_{c-1} the state before the chunk,
// dS the cotangent of the state after it), every sum over j <= i:
//   dx_j   = dt_j sum_{i>=j} (C_i.B_j) e^{cum_i-cum_j} dy_i + u_j dS^T B_j
//   dC_i   = sum_j e^{cum_i-cum_j} dt_j (dy_i.x_j) B_j + e^{cum_i} S_{c-1} dy_i
//   dB_j   = sum_i e^{cum_i-cum_j} dt_j (dy_i.x_j) C_i + u_j dS x_j
//   ddt_j  = sum_i (C_i.B_j) e^{cum_i-cum_j} (dy_i.x_j) + e^{tot-cum_j} B_j^T dS x_j
//            + A sum_{k>=j} dcum_k
//   dcum   : each intra term T_ij adds to i and subtracts from j; the inter
//            term e^{cum_i} C_i^T S_{c-1} dy_i adds to i; each contribution
//            u_j B_j^T dS x_j adds to tot and subtracts from j; e^{tot}
//            <dS, S_{c-1}> adds to tot; dtot adds to cum_{Q-1}
//   dA_h  += sum_t dt_t sum_{k>=t} dcum_k
//   dS    <- e^{tot} dS + sum_i e^{cum_i} C_i dy_i^T
// with u_j = e^{tot-cum_j} dt_j.  Every exponent is <= 0 (A < 0, dt > 0),
// and e^{cum_i-cum_j} is formed only where j <= i, so no exp can overflow
// and the gradient stays finite where the vjp of JAX's ssd_chunked, which
// evaluates exp above the diagonal and masks after it, is NaN (a chunk
// whose log-decay spans more than ~88.7).
//
// Launches, all on the caller's stream:
//   1. ssd_bwd: one block (256 threads) per (b, h).  Sweep 1 walks the
//      chunks forward and writes the state before each, S_{c-1}, to an
//      fp32 scratch (B, nc, H, N, P) that the wrapper allocates (33.5 MB at
//      zamba2_1p2b's shape; the forward kernel and its C interface stay as
//      they are).  Sweep 2 walks the chunks backward carrying dS (N, P) in
//      shared memory and writes dx and ddt, and per-head fp32 partials of
//      dB and dC (B, H, S, N) and of dA (B, H) to the same scratch, since
//      B and C are shared by the heads and A by the batch.
//   2. ssd_bwd_reduce: sums the partials over heads (dB, dC) and over the
//      batch (dA) in a fixed order.  No atomics anywhere, so two calls give
//      the same bits.
//
// What bounds it.  At zamba2_1p2b's train shape (B 8, S 512, H 64, P 64,
// N 64, Q 128, bf16) the call must read x, dy (33.5 MB each), dt, B, C and
// write dx (33.5 MB), ddt, dB, dC: ~105 MB, 31 us at 3.35 TB/s.  Its
// products per (b, h, chunk) are C B^T, dy x^T (each over the lower
// triangle), W^T dy, E B, E^T C, C^T dy, the two state products and
// S_{c-1} dy: Q^2 (3 N + 2 P) over the lower triangle and 10 Q N P
// (chip_smoke.py's ``ssd_bwd_bound_ms``) = 10.5 MFLOP, x 2,048 = 21.5
// GFLOP: 22 us at the bf16 tensor-core peak, so bytes bound it.  This
// kernel does all of it in scalar fp32 FMAs (67 TFLOP/s at most; bf16
// inputs are converted where they are loaded), which puts it at ~0.3 ms at
// best; putting the products on the tensor cores is later work.
//
// The design.  The TPU's sequential chunk axis is a loop inside the block
// (Hopper blocks run in no order).  The chunk lives in shared memory as
// fp32, rows in their natural order: x and dy [Q][P], B and C [Q][N]; one
// Q x Q matrix M [Q][Q+4] holds in turn V = (C B^T)(.)L(.)(dy x^T) (whose
// column sums give ddt's direct intra part and whose row sums, weighted by
// dt, give dcum's), W = (C B^T)(.)L(.)dt (for dx), and E = L(.)dt(.)(dy x^T)
// (for dB and dC), each formed on the 4 x 4 tiles on or below the diagonal
// only and recomputed rather than kept.  A thread owns 4 x 4 register tiles
// and walks every inner dimension in steps of 4 with float4 loads.  Sums
// across tiles go through small shared buffers in a fixed order.  S_{c-1}
// is read back from the scratch through L2 (__ldcg: this block wrote it).
// The short sums that cancel (row and column sums of V, the per-row
// partials, dtot, the reverse cumsum of dcum and dA) run in fp64: in fp32
// dA came out many times farther from the fp64 gradient than autograd of
// the plain version at the train shape, and in fp64 they cost nothing
// beside the products.
// Shared memory: 229,376 bytes at Q 128, N = P = 64 (x, dy, B, C 131,072;
// M 67,584; dS 16,384; partial sums and vectors 14,336): one block an SM,
// 512 blocks at the train shape.
//
// Sizes are runtime values: N and P multiples of 4 in [4, 64], Q a
// multiple of 4 in [4, 128], any S >= 1; a ragged last chunk is zero-filled
// where it is loaded (dt = x = B = C = dy = 0: a padded step adds nothing)
// and only valid rows are written.  x, B, C and dy may be strided views
// (element strides of their leading axes, last axis contiguous); dt is
// read through its strides.  dx (B,S,H,P) and dB, dC (B,S,N) are written
// contiguous in x's type, ddt (B,S,H) and dA (H,) contiguous in fp32.
// Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_Q = 128;
constexpr int MAX_NP = 64;
constexpr int RED_THREADS = 256;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const void* dy;
  const float* dfinal;  // (B, H, N, P) fp32 contiguous, or null (zero)
  void* dx;             // (B, S, H, P) contiguous, x's type
  float* ddt;           // (B, S, H) contiguous
  float* states;        // (B, nc, H, N, P) scratch
  float* dbh;           // (B, H, S, N) scratch
  float* dch;           // (B, H, S, N) scratch
  float* dah;           // (B, H) scratch
  int B, S, H, P, N, Q, nc;
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
  return __float2bfloat16(v);
}

// Shared-memory plan, in floats.  Every offset is a multiple of 4 floats
// (Q, N, P are), so float4 accesses stay aligned.
struct Layout {
  int LQ, W4, xs, ys, bs, cs, mm, ds, part, cum, ecum, erem, uu, dtq, colv, rowt, du, dcum,
      red, total;
  __host__ __device__ constexpr Layout(int Q, int N, int P)
      : LQ(Q + 4),
        W4((N > P ? N : P) / 4),
        xs(0),                          // [Q][P]   x
        ys(Q * P),                      // [Q][P]   dy
        bs(2 * Q * P),                  // [Q][N]   B
        cs(2 * Q * P + Q * N),          // [Q][N]   C
        mm(2 * Q * P + 2 * Q * N),      // [Q][LQ]  V, then W, then E (M[i][j], j <= i)
        ds(mm + Q * (Q + 4)),           // [N][P]   S in sweep 1, dS in sweep 2
        part(ds + N * P),               // [Q][W4]  per-row partial sums over 4-wide tiles
        cum(part + Q * ((N > P ? N : P) / 4)),
        ecum(cum + Q),                  // e^{cum_i}
        erem(cum + 2 * Q),              // e^{tot - cum_j}
        uu(cum + 3 * Q),                // u_j = e^{tot - cum_j} dt_j
        dtq(cum + 4 * Q),               // dt
        colv(cum + 5 * Q),              // column sums of V, then ddt's direct part
        rowt(cum + 6 * Q),              // row sums of V dt
        du(cum + 7 * Q),                // B_j^T dS x_j
        dcum(cum + 8 * Q),              // dcum
        red(cum + 9 * Q),               // [NTHREADS] block reduction
        total(cum + 9 * Q + NTHREADS) {}
};

constexpr size_t MAX_BYTES = sizeof(float) * Layout(MAX_Q, MAX_NP, MAX_NP).total;
static_assert(MAX_BYTES <= 232448, "shared memory plan exceeds 227 KB");

__device__ __forceinline__ void unpack(const float4 v, float (&r)[4]) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Tile k of the lower triangle of 4 x 4 tiles: (ti, tj) with tj <= ti.
__device__ __forceinline__ void tri_tile(int k, int& i0, int& j0) {
  int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  while (ti * (ti + 1) / 2 > k) --ti;
  i0 = ti * 4;
  j0 = (k - ti * (ti + 1) / 2) * 4;
}

// acc[u][w] += sum over a 4-wide step of the inner axis of a_u . b_w, rows
// a0 + u of A and b0 + w of Bm, both row-major with row length ld.
__device__ __forceinline__ void dot_tile(const float* A, int a0, const float* Bm, int b0,
                                         int ld, int len, float (&acc)[4][4]) {
  for (int c = 0; c < len; c += 4) {
    float ar[4][4], br[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unpack(ld4(A + (a0 + u) * ld + c), ar[u]);
      unpack(ld4(Bm + (b0 + u) * ld + c), br[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][w] = fmaf(ar[u][e], br[w][e], acc[u][w]);
  }
}

// cum = inclusive scan of dt * a over the chunk, in warp 0 (up to 4 rows a lane).
__device__ __forceinline__ void chunk_cumsum(const float* dtq, float* cum, int Q, float a,
                                             int tid) {
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
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ssd_bwd(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, N = p.N, P = p.P;
  const Layout L(Q, N, P);
  const int LQ = L.LQ, W4 = L.W4;
  float* Xs = sm + L.xs;
  float* Ys = sm + L.ys;
  float* Bs = sm + L.bs;
  float* Cs = sm + L.cs;
  float* M = sm + L.mm;
  float* dS = sm + L.ds;
  float* part = sm + L.part;
  float* cum = sm + L.cum;
  float* ecum = sm + L.ecum;
  float* erem = sm + L.erem;
  float* uu = sm + L.uu;
  float* dtq = sm + L.dtq;
  float* colv = sm + L.colv;
  float* rowt = sm + L.rowt;
  float* du = sm + L.du;
  float* dcum = sm + L.dcum;
  float* red = sm + L.red;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* xg = static_cast<const T*>(p.x) + b * p.xsb + h * p.xsh;
  const float* dg = p.dt + b * p.dsb + h * p.dsh;
  const T* bg = static_cast<const T*>(p.b) + b * p.bsb;
  const T* cg = static_cast<const T*>(p.c) + b * p.csb;
  const T* yg = static_cast<const T*>(p.dy) + b * p.ysb + h * p.ysh;
  T* dxg = static_cast<T*>(p.dx) + (static_cast<int64_t>(b) * p.S * p.H + h) * P;
  float* ddtg = p.ddt + static_cast<int64_t>(b) * p.S * p.H + h;
  float* dbg = p.dbh + (static_cast<int64_t>(b) * p.H + h) * p.S * N;
  float* dcg = p.dch + (static_cast<int64_t>(b) * p.H + h) * p.S * N;
  const float a = p.A[h];
  const int T4 = Q / 4, P4 = P / 4, N4 = N / 4;
  const int ntri = T4 * (T4 + 1) / 2;
  const int64_t NP = static_cast<int64_t>(N) * P;
  auto state_at = [&](int ch) {
    return p.states + ((static_cast<int64_t>(b) * p.nc + ch) * p.H + h) * NP;
  };

  // Stage chunk ch as fp32, rows past the end zero; dy only when asked.
  auto load_chunk = [&](int t0, int qv, bool with_dy) {
    for (int e = tid; e < Q * P; e += NTHREADS) {
      const int j = e / P;
      const int c = e - j * P;
      const bool in = j < qv;
      Xs[e] = in ? to_f(__ldg(xg + (t0 + j) * p.xss + c)) : 0.f;
      if (with_dy) Ys[e] = in ? to_f(__ldg(yg + (t0 + j) * p.yss + c)) : 0.f;
    }
    for (int e = tid; e < Q * N; e += NTHREADS) {
      const int j = e / N;
      const int n = e - j * N;
      const bool in = j < qv;
      Bs[e] = in ? to_f(__ldg(bg + (t0 + j) * p.bss + n)) : 0.f;
      Cs[e] = in ? to_f(__ldg(cg + (t0 + j) * p.css + n)) : 0.f;
    }
    for (int j = tid; j < Q; j += NTHREADS) dtq[j] = j < qv ? __ldg(dg + (t0 + j) * p.dss) : 0.f;
  };

  // ---- Sweep 1: the state before each chunk, into the scratch. ----------
  for (int e = tid; e < N * P; e += NTHREADS) dS[e] = 0.f;
  __syncthreads();
  for (int ch = 0; ch < p.nc; ++ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.S - t0);
    float* sg = state_at(ch);
    for (int e = tid; e < N * P; e += NTHREADS) sg[e] = dS[e];
    load_chunk(t0, qv, false);
    __syncthreads();
    chunk_cumsum(dtq, cum, Q, a, tid);
    __syncthreads();
    const float tot = cum[Q - 1];
    for (int j = tid; j < Q; j += NTHREADS) uu[j] = expf(tot - cum[j]) * dtq[j];
    __syncthreads();
    const float decay = expf(tot);
    for (int k = tid; k < N4 * P4; k += NTHREADS) {
      const int n0 = (k / P4) * 4;
      const int p0 = (k % P4) * 4;
      float s[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unpack(ld4(dS + (n0 + u) * P + p0), s[u]);
#pragma unroll
        for (int v = 0; v < 4; ++v) s[u][v] *= decay;
      }
      for (int j = 0; j < qv; ++j) {
        float br[4], xr[4];
        unpack(ld4(Bs + j * N + n0), br);
        unpack(ld4(Xs + j * P + p0), xr);
        const float cj = uu[j];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = fmaf(br[u] * cj, xr[v], s[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(dS + (n0 + u) * P + p0) =
            make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
    }
    __syncthreads();
  }

  // ---- Sweep 2: backward over the chunks, carrying dS. --------------------
  const float* dfg =
      p.dfinal ? p.dfinal + (static_cast<int64_t>(b) * p.H + h) * NP : nullptr;
  for (int e = tid; e < N * P; e += NTHREADS) dS[e] = dfg ? dfg[e] : 0.f;
  double dA_acc = 0.0;  // warp 0, lane 0
  for (int ch = p.nc - 1; ch >= 0; --ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.S - t0);
    const float* Sp = state_at(ch);
    load_chunk(t0, qv, true);
    __syncthreads();
    chunk_cumsum(dtq, cum, Q, a, tid);
    __syncthreads();
    const float tot = cum[Q - 1];
    for (int j = tid; j < Q; j += NTHREADS) {
      ecum[j] = expf(cum[j]);
      erem[j] = expf(tot - cum[j]);
      uu[j] = erem[j] * dtq[j];
    }

    // Pass 1: V_ij = (C_i.B_j) e^{cum_i-cum_j} (dy_i.x_j) on the lower triangle.
    for (int k = tid; k < ntri; k += NTHREADS) {
      int i0, j0;
      tri_tile(k, i0, j0);
      float g[4][4] = {}, d[4][4] = {};
      dot_tile(Cs, i0, Bs, j0, N, N, g);
      dot_tile(Ys, i0, Xs, j0, P, P, d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        float out[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          out[w] = j <= i ? g[u][w] * expf(cum[i] - cum[j]) * d[u][w] : 0.f;
        }
        *reinterpret_cast<float4*>(M + i * LQ + j0) = make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();
    // Column sums of V (ddt's direct intra part) and row sums of V dt.
    for (int r = tid; r < 2 * Q; r += NTHREADS) {
      double s = 0.0;
      if (r < Q) {
        for (int i = r; i < Q; ++i) s += M[i * LQ + r];
        colv[r] = static_cast<float>(s);
      } else {
        const int i = r - Q;
        for (int j = 0; j <= i; ++j) s += static_cast<double>(M[i * LQ + j]) * dtq[j];
        rowt[i] = static_cast<float>(s);
      }
    }
    __syncthreads();

    // Pass 2: W_ij = (C_i.B_j) e^{cum_i-cum_j} dt_j.
    for (int k = tid; k < ntri; k += NTHREADS) {
      int i0, j0;
      tri_tile(k, i0, j0);
      float g[4][4] = {};
      dot_tile(Cs, i0, Bs, j0, N, N, g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        float out[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          out[w] = j <= i ? g[u][w] * expf(cum[i] - cum[j]) * dtq[j] : 0.f;
        }
        *reinterpret_cast<float4*>(M + i * LQ + j0) = make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();
    // dx_j = sum_{i>=j} W_ij dy_i + u_j dS^T B_j; partial sums of x_j . (dS^T B_j).
    for (int k = tid; k < T4 * P4; k += NTHREADS) {
      const int j0 = (k / P4) * 4;
      const int p0 = (k % P4) * 4;
      float acc[4][4] = {}, sb[4][4] = {};
      for (int i = j0; i < qv; ++i) {
        float wr[4], yr[4];
        unpack(ld4(M + i * LQ + j0), wr);
        unpack(ld4(Ys + i * P + p0), yr);
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[w][v] = fmaf(wr[w], yr[v], acc[w][v]);
      }
      for (int n = 0; n < N; n += 4) {
        float br[4][4], sr[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          unpack(ld4(Bs + (j0 + u) * N + n), br[u]);
          unpack(ld4(dS + (n + u) * P + p0), sr[u]);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int v = 0; v < 4; ++v) sb[w][v] = fmaf(br[w][e], sr[e][v], sb[w][v]);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = j0 + w;
        float xr[4];
        unpack(ld4(Xs + j * P + p0), xr);
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) s = fmaf(xr[v], sb[w][v], s);
        part[j * W4 + p0 / 4] = s;
        if (j < qv) {
          const float uj = uu[j];
          T* row = dxg + static_cast<int64_t>(t0 + j) * p.H * P + p0;
#pragma unroll
          for (int v = 0; v < 4; ++v) row[v] = from_f<T>(fmaf(uj, sb[w][v], acc[w][v]));
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += NTHREADS) {
      double s = 0.0;
      for (int t = 0; t < P4; ++t) s += part[j * W4 + t];
      du[j] = static_cast<float>(s);
    }

    // Pass 3: E_ij = e^{cum_i-cum_j} dt_j (dy_i.x_j).
    for (int k = tid; k < ntri; k += NTHREADS) {
      int i0, j0;
      tri_tile(k, i0, j0);
      float d[4][4] = {};
      dot_tile(Ys, i0, Xs, j0, P, P, d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        float out[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          out[w] = j <= i ? expf(cum[i] - cum[j]) * dtq[j] * d[u][w] : 0.f;
        }
        *reinterpret_cast<float4*>(M + i * LQ + j0) = make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();
    // dC_i = sum_{j<=i} E_ij B_j + e^{cum_i} S_{c-1} dy_i, with partial sums of
    // C_i . (e^{cum_i} S_{c-1} dy_i) for dcum; dB_j = sum_{i>=j} E_ij C_i + u_j dS x_j.
    for (int k = tid; k < 2 * T4 * N4; k += NTHREADS) {
      const bool is_c = k < T4 * N4;
      const int kk = is_c ? k : k - T4 * N4;
      const int r0 = (kk / N4) * 4;
      const int n0 = (kk % N4) * 4;
      float acc[4][4] = {}, sx[4][4] = {};
      if (is_c) {
        for (int j = 0; j <= r0; j += 4) {
          float er[4][4], br[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unpack(ld4(M + (r0 + u) * LQ + j), er[u]);
            unpack(ld4(Bs + (j + u) * N + n0), br[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(er[u][e], br[e][v], acc[u][v]);
        }
        // sx[u][v] = sum_p dy_{r0+u}[p] S_{c-1}[n0+v][p]
        for (int q = 0; q < P; q += 4) {
          float yr[4][4], sr[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unpack(ld4(Ys + (r0 + u) * P + q), yr[u]);
            unpack(__ldcg(reinterpret_cast<const float4*>(Sp + (n0 + u) * P + q)), sr[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
#pragma unroll
              for (int e = 0; e < 4; ++e) sx[u][v] = fmaf(yr[u][e], sr[v][e], sx[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = r0 + u;
          const float ec = ecum[i];
          float cr[4];
          unpack(ld4(Cs + i * N + n0), cr);
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) s = fmaf(cr[v], sx[u][v], s);
          part[i * W4 + n0 / 4] = ec * s;
          if (i < qv) {
            float* row = dcg + static_cast<int64_t>(t0 + i) * N + n0;
            *reinterpret_cast<float4*>(row) =
                make_float4(fmaf(ec, sx[u][0], acc[u][0]), fmaf(ec, sx[u][1], acc[u][1]),
                            fmaf(ec, sx[u][2], acc[u][2]), fmaf(ec, sx[u][3], acc[u][3]));
          }
        }
      } else {
        for (int i = r0; i < qv; ++i) {
          float er[4], cr[4];
          unpack(ld4(M + i * LQ + r0), er);
          unpack(ld4(Cs + i * N + n0), cr);
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[w][v] = fmaf(er[w], cr[v], acc[w][v]);
        }
        // sx[w][v] = sum_p dS[n0+v][p] x_{r0+w}[p]
        for (int q = 0; q < P; q += 4) {
          float xr[4][4], sr[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unpack(ld4(Xs + (r0 + u) * P + q), xr[u]);
            unpack(ld4(dS + (n0 + u) * P + q), sr[u]);
          }
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int v = 0; v < 4; ++v)
#pragma unroll
              for (int e = 0; e < 4; ++e) sx[w][v] = fmaf(xr[w][e], sr[v][e], sx[w][v]);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = r0 + w;
          if (j < qv) {
            const float uj = uu[j];
            float* row = dbg + static_cast<int64_t>(t0 + j) * N + n0;
            *reinterpret_cast<float4*>(row) =
                make_float4(fmaf(uj, sx[w][0], acc[w][0]), fmaf(uj, sx[w][1], acc[w][1]),
                            fmaf(uj, sx[w][2], acc[w][2]), fmaf(uj, sx[w][3], acc[w][3]));
          }
        }
      }
    }
    // <dS, S_{c-1}>: per-thread sums, then a fixed-order tree.
    {
      double s = 0.0;
      for (int e = tid; e < N * P; e += NTHREADS) s += static_cast<double>(dS[e]) * __ldcg(Sp + e);
      red[tid] = static_cast<float>(s);
    }
    __syncthreads();
    for (int off = NTHREADS / 2; off > 0; off >>= 1) {
      if (tid < off) red[tid] += red[tid + off];
      __syncthreads();
    }
    // dcum per row, and ddt's direct parts.
    for (int i = tid; i < Q; i += NTHREADS) {
      double s = 0.0;
      for (int t = 0; t < N4; ++t) s += part[i * W4 + t];
      dcum[i] = static_cast<float>(s + rowt[i] - static_cast<double>(dtq[i]) * colv[i] -
                                   static_cast<double>(uu[i]) * du[i]);
      colv[i] = static_cast<float>(static_cast<double>(erem[i]) * du[i] + colv[i]);
    }
    __syncthreads();
    // Warp 0: dtot into dcum_{Q-1}, the reverse scan (d(dt a)_t = sum_{k>=t}
    // dcum_k), ddt and this chunk's share of dA.
    if (tid < 32) {
      const int E = (Q + 31) / 32;
      const int j0 = tid * E;
      // In fp64: these few sums cancel, and cost nothing beside the products.
      double s = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < Q) s += static_cast<double>(uu[j]) * du[j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const double dtot = static_cast<double>(expf(tot)) * red[0] + s;
      double loc[4];
      double run = 0.0;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int j = j0 + e;
        if (e < E && j < Q) run += dcum[j] + (j == Q - 1 ? dtot : 0.0);
        loc[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_down_sync(0xffffffffu, incl, off);
        if (tid + off < 32) incl += v;
      }
      const double excl = incl - run;
      double da_sum = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < qv) {
          const double da = loc[e] + excl;
          ddtg[static_cast<int64_t>(t0 + j) * p.H] = static_cast<float>(a * da + colv[j]);
          da_sum += dtq[j] * da;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da_sum += __shfl_xor_sync(0xffffffffu, da_sum, off);
      if (tid == 0) dA_acc += da_sum;
    }
    // dS <- e^{tot} dS + sum_i e^{cum_i} C_i dy_i^T (every read of dS is done).
    const float decay = expf(tot);
    for (int k = tid; k < N4 * P4; k += NTHREADS) {
      const int n0 = (k / P4) * 4;
      const int p0 = (k % P4) * 4;
      float s[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unpack(ld4(dS + (n0 + u) * P + p0), s[u]);
#pragma unroll
        for (int v = 0; v < 4; ++v) s[u][v] *= decay;
      }
      for (int i = 0; i < qv; ++i) {
        float cr[4], yr[4];
        unpack(ld4(Cs + i * N + n0), cr);
        unpack(ld4(Ys + i * P + p0), yr);
        const float ec = ecum[i];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = fmaf(cr[u] * ec, yr[v], s[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(dS + (n0 + u) * P + p0) =
            make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
    }
    __syncthreads();
  }
  if (tid == 0) p.dah[static_cast<int64_t>(b) * p.H + h] = static_cast<float>(dA_acc);
}

// dB and dC: sums over the heads of the partials; dA: sum over the batch.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    ssd_bwd_reduce(const float* dbh, const float* dch, const float* dah, T* db, T* dc,
                   float* dA, int B, int S, int H, int N) {
  const int64_t SN = static_cast<int64_t>(S) * N;
  const int64_t BSN = B * SN;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (idx < 2 * BSN) {
    const bool is_c = idx >= BSN;
    const int64_t e = is_c ? idx - BSN : idx;
    const int64_t b = e / SN;
    const int64_t rest = e - b * SN;
    const float* src = (is_c ? dch : dbh) + b * H * SN + rest;
    double s = 0.0;
    for (int h = 0; h < H; ++h) s += src[h * SN];
    (is_c ? dc : db)[e] = from_f<T>(static_cast<float>(s));
  } else if (idx < 2 * BSN + H) {
    const int h = static_cast<int>(idx - 2 * BSN);
    double s = 0.0;
    for (int b = 0; b < B; ++b) s += dah[static_cast<int64_t>(b) * H + h];
    dA[h] = static_cast<float>(s);
  }
}

struct Scratch {
  int64_t states, dbh, dch, dah, total;  // offsets in floats
  Scratch(int B, int S, int H, int P, int N, int Q) {
    const int64_t nc = (S + Q - 1) / Q;
    states = 0;
    dbh = states + static_cast<int64_t>(B) * nc * H * N * P;
    dch = dbh + static_cast<int64_t>(B) * H * S * N;
    dah = dch + static_cast<int64_t>(B) * H * S * N;
    total = dah + static_cast<int64_t>(B) * H;
  }
};

template <typename T>
cudaError_t launch(Params p, void* db, void* dc, float* dA, cudaStream_t stream) {
  auto kern = ssd_bwd<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_BYTES));
  if (attr != cudaSuccess) return attr;
  const size_t bytes = sizeof(float) * Layout(p.Q, p.N, p.P).total;
  kern<<<dim3(p.H, p.B), NTHREADS, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = 2 * static_cast<int64_t>(p.B) * p.S * p.N + p.H;
  const int64_t blocks = (n + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(blocks), RED_THREADS, 0, stream>>>(
      p.dbh, p.dch, p.dah, static_cast<T*>(db), static_cast<T*>(dc), dA, p.B, p.S, p.H, p.N);
  return cudaGetLastError();
}

bool supported(int v, int hi) { return v >= 4 && v <= hi && v % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block of the main kernel takes.
extern "C" int ssd_scan_bwd_smem_bytes(int Q, int N, int P) {
  return static_cast<int>(sizeof(float) * Layout(Q, N, P).total);
}

// Bytes of fp32 device scratch a call takes: the states before each chunk
// and the per-head partials of dB, dC and dA.
extern "C" int64_t ssd_scan_bwd_scratch_bytes(int B, int S, int H, int P, int N, int Q) {
  return static_cast<int64_t>(sizeof(float)) * Scratch(B, S, H, P, N, Q).total;
}

// dtype (of x, B, C, dy, dx, dB, dC): 0 = float32, 1 = bfloat16.  dt, A,
// dfinal (B, H, N, P; may be null for zero), ddt (B, S, H) and dA (H,) are
// float32.  dx (B, S, H, P), dB and dC (B, S, N) and ddt are contiguous.
// scratch holds ssd_scan_bwd_scratch_bytes bytes.  Returns a cudaError_t
// (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* b,
                            const void* c, const void* dy, const void* dfinal, void* dx,
                            void* ddt, void* dA, void* db, void* dc, void* scratch, int dtype,
                            int B, int S, int H, int P, int N, int Q,
                            int64_t xsb, int64_t xss, int64_t xsh,
                            int64_t dsb, int64_t dss, int64_t dsh,
                            int64_t bsb, int64_t bss, int64_t csb, int64_t css,
                            int64_t ysb, int64_t yss, int64_t ysh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || !supported(P, MAX_NP) ||
      !supported(N, MAX_NP) || !supported(Q, MAX_Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc(B, S, H, P, N, Q);
  float* base = static_cast<float*>(scratch);
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c, dy,
           static_cast<const float*>(dfinal), dx, static_cast<float*>(ddt),
           base + sc.states, base + sc.dbh, base + sc.dch, base + sc.dah,
           B, S, H, P, N, Q, (S + Q - 1) / Q,
           xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css, ysb, yss, ysh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(p, db, dc, static_cast<float*>(dA), s); break;
    case 1: err = launch<__nv_bfloat16>(p, db, dc, static_cast<float*>(dA), s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
