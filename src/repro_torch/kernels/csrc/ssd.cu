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
// would miss the 1e-4 fp32 tolerance); bf16 -> ssd_fwd_wgmma, warpgroup
// products (wgmma, bf16 operands, fp32 accumulators) on tiles that TMA
// loads, in thread-block clusters along the chunk axis.
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
// The bf16 design (ssd_fwd_wgmma).  The design it replaces ran one block
// per (b, h) walking the chunks in order (512 chains of 4 chunks at
// zamba2's shape, each chunk a chain of dependent mma.sync products
// between block barriers), formed C B^T once per head although B and C
// are shared by the heads, and read B and C once per head: 0.18 ms, 8x
// its bound.  This one:
//   1. Parallel over chunks.  The scan is linear in the state: S after a
//      run of chunks is 2^(sum of tot) S_in + L, L the run's local state
//      (the same recurrence from zero).  The nc chunks of a (b, head
//      group) go to the blocks of one thread-block cluster
//      (cudaLaunchAttributeClusterDimension), at most 8, each taking k =
//      ceil(nc / 8) consecutive chunks (zamba2: 4 blocks of one chunk;
//      the long serve mode's 4,096 steps: 8 blocks of 4).  Pass A: each
//      block forms its heads' L; block r waits on its inbox mbarrier for
//      S_in from block r - 1 (zero in block 0), stores S_out = 2^(sum
//      tot) S_in + L into block r + 1's shared memory (mapa,
//      cp.async.bulk) as fp32 in fragment order, one 16 KB bulk copy
//      that completes on that block's inbox mbarrier as transaction
//      bytes (per-thread st.shared::cluster stores and release arrivals
//      made the call 1.03x slower); the last block writes S_out, the
//      final state.  Pass B: y of each chunk from the state before it.
//      The hand-off is one fixed order of copies: no atomics, and a
//      call's bits repeat.
//   2. A block holds G heads of one (b, chunk range).  B and C are loaded
//      once for them; C B^T (Q x Q over N) is formed once a chunk, kept in
//      fp32 in shared memory, and each head applies its own decay and dt
//      to it.  G is ssd_wgmma.cuh's group_size: of G <= 4 the one that
//      minimises the waves of the grid over the blocks that run at once
//      (whole clusters, from the occupancy query: 120 on an H100 in
//      clusters of 4 or 8) times a block's time (a fixed part and a unit
//      a pair of heads), ties to the larger G: zamba2's 8 x 16 groups x 4
//      blocks = 512 blocks of 4 heads; a (2, 2) mesh rank's 32 heads 256
//      blocks of 2 and the long serve mode's 256 blocks of 2, 1.15x and
//      1.22x faster than G 4's 128 blocks in two waves.  H need not
//      divide by G: the last group is smaller.
//   3. Products on wgmma, operands by TMA.  Two warpgroups; warpgroup w
//      takes heads w, w + 2 of the group.  A chunk's tiles (B, C, each
//      head's x: 128 rows x 64 columns, 128-byte swizzled) land by
//      cp.async.bulk.tensor on one mbarrier from 4-D tensor maps over the
//      strided views (mma::encode_map), rows past S zero-filled; a view
//      TMA cannot describe (a base or row stride not in whole 16 bytes) is
//      loaded by plain loads in the same kernel.  Chunk rows go on M as
//      m64n64k16 products: rows past the chunk (Q < 128, a ragged last
//      chunk) and columns past N and P (padded to the slab's 64) carry
//      zero weights and are not stored.  C B^T: A = C, B = B, both
//      K-major.  L^T = (coef x)^T B with (coef x)^T from registers
//      (ldmatrix.trans of x, scaled) and B MN-major.  y: w x with w from
//      registers (the C B^T block scaled by 2^(cum_i - cum_j) dt_j only
//      where j <= i) and x MN-major; C S with S^T as the K-major B
//      operand, scaled by 2^cum_i in a second accumulator.  Building w is
//      the element-wise work that holds a block (8 warps an SM hide
//      little latency): off the 16-row diagonal bands its decay is a row
//      factor times a column one (ssd_wgmma.cuh's chunk_cum: coef and
//      kend formed once a chunk), so exp2 runs an element only on those
//      bands, and bands above them are zeros without loads.  y leaves in
//      8-byte stores: neighbour threads swap one bf16 pair (quad_pair).
//      With 4-byte stores a row tile's stores took 1,676 cycles, and the
//      8-byte ones made the call 1.12x faster (H100 80GB HBM3, 700 W).
//   4. Rounding.  At the serve shape y reaches ~250 and single outputs
//      come from terms of ~100 that cancel: an emulation of one bf16
//      rounding each of w, the state copy and coef x put y up to 3x past
//      the 3e-2 tolerance.  So each of the three is split into hi =
//      bf16(v) and lo = bf16(v - hi) and enters its product twice,
//      carrying it to ~2^-16 of itself.  The states stay fp32 where they
//      are accumulated, and the hand-off carries them in fp32.
// Shared memory: B, C 32 KB; x of 4 heads 64 KB; 4 states as hi + lo
// slabs 64 KB; C B^T 54 KB; 4 row vectors a head 8 KB; barriers: ~225 KB,
// one block an SM.  At zamba2's shape the call takes 0.114 ms on an H100
// 80GB HBM3 at 700 W, 4.9x its bound: what holds it is the element-wise
// build of w on 8 warps an SM, ~1.3 us a cluster hop, and 5 waves of the
// 120 blocks that clusters of 4 place at once.
// A group of fewer than 2 heads a pair leaves warpgroup 1 repeating
// warpgroup 0's head and keeping nothing: products stay unconditional.
//
// Sizes are runtime values: N and P multiples of 4 in [4, 64], Q a
// multiple of 4 in [4, 128] (the Python wrapper checks; so does the C
// entry), any S >= 1.  x, B and C may be strided views (element strides of
// their leading axes, last axis contiguous); y is written through its
// strides, which (in bf16) must be whole 4 elements, as the wrapper's
// allocation gives.  Launch errors are returned, never swallowed: a tensor
// map that cannot be encoded or a cluster that cannot be placed fails the
// call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "ssd_wgmma.cuh"

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
// bf16: ssd_fwd_wgmma (see the note at the top).

using ssdw::bf16;
using ssdw::ROWS;
using ssdw::SLAB_BYTES;
using ssdw::TILE_BYTES;
constexpr int FW_MAX_G = 4;
constexpr int FW_NV = ssdw::NV;  // row vectors a head (ssdw::Vec)

// Shared-memory plan, bytes from the 1024-aligned base: the chunk's B and
// C tiles; x of the group's heads; each head's state S^T (rows p, columns
// n) as bf16 hi and lo slabs (the inbox the cluster's previous block
// writes); C B^T in fp32 (blocks (0,0), (1,0), (1,1)); each head's row
// vectors; the load barrier and one inbox barrier a head.
struct Fw {
  static constexpr int B = 0;
  static constexpr int C = TILE_BYTES;
  static constexpr int X = 2 * TILE_BYTES;
  static constexpr int ST = X + FW_MAX_G * TILE_BYTES;
  static constexpr int CB = ST + FW_MAX_G * 2 * SLAB_BYTES;
  static constexpr int VEC = CB + ssdw::CB_BYTES;
  static constexpr int BAR = VEC + FW_MAX_G * FW_NV * ROWS * 4;
  static constexpr int BYTES = BAR + 8 * (1 + FW_MAX_G) + 1024;
};
static_assert(Fw::BYTES <= 232448, "shared memory plan exceeds 227 KB");

struct FwParams {
  Params p;
  CUtensorMap mx, mb, mc;
  int tma;  // 1: tiles by TMA; 0: by plain loads (a view TMA cannot describe)
  int G, cs, k, nc;
};

__global__ void __launch_bounds__(ssdw::THREADS, 1)
    ssd_fwd_wgmma(const __grid_constant__ FwParams fp) {
  const Params& p = fp.p;
  char* sm = wgmma::aligned_smem();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cs = fp.cs, r = blockIdx.x % cs, b = blockIdx.y;
  const int h0 = (blockIdx.x / cs) * fp.G, Gv = min(fp.G, p.H - h0);
  const int c0 = r * fp.k, c1 = min(fp.nc, c0 + fp.k);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Fw::BAR);  // [0] loads, [1 + hh] inboxes
  float* vecs = reinterpret_cast<float*>(sm + Fw::VEC);  // [head][FW_NV][ROWS]
  auto vec = [&](int hh, int k) { return vecs + (hh * FW_NV + k) * ROWS; };
  float* cbs = reinterpret_cast<float*>(sm + Fw::CB);
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.xsb;
  const bf16* bg = static_cast<const bf16*>(p.b) + b * p.bsb;
  const bf16* cg = static_cast<const bf16*>(p.c) + b * p.csb;

  if (tid == 0) {
    mma::mbar_init(&bars[0], 1);
    // An inbox's barrier completes when the previous block's bulk copy of
    // S_in (16 KB) has landed.
    for (int hh = 0; hh < Gv; ++hh) {
      mma::mbar_init(&bars[1 + hh], 1);
      if (r > 0) mma::mbar_expect_tx(&bars[1 + hh], ssdw::STATE_BYTES);
    }
    mma::fence_mbar_init();
  }
  __syncthreads();
  ssdw::cluster_arrive();
  ssdw::cluster_wait();

  // Chunk c's B, C and the group's x into shared memory, each head's row
  // vectors; nothing when chunk c is already there.
  int loaded = -1;
  uint32_t phase = 0;
  auto load_chunk = [&](int c) {
    if (c == loaded) return;
    __syncthreads();  // every read of the tiles there is done
    const int t0 = c * p.Q, qv = min(p.Q, p.S - t0);
    if (fp.tma) {
      if (tid == 0) {
        mma::fence_proxy_async();
        mma::mbar_expect_tx(&bars[0], (2 + Gv) * TILE_BYTES);
        ssdw::tma_rows(sm + Fw::B, &fp.mb, &bars[0], 0, t0, b);
        ssdw::tma_rows(sm + Fw::C, &fp.mc, &bars[0], 0, t0, b);
        for (int hh = 0; hh < Gv; ++hh)
          ssdw::tma_rows(sm + Fw::X + hh * TILE_BYTES, &fp.mx, &bars[0], h0 + hh, t0, b);
      }
    } else {
      ssdw::plain_rows(sm + Fw::B, bg + t0 * p.bss, p.bss, p.N, qv);
      ssdw::plain_rows(sm + Fw::C, cg + t0 * p.css, p.css, p.N, qv);
      for (int hh = 0; hh < Gv; ++hh)
        ssdw::plain_rows(sm + Fw::X + hh * TILE_BYTES, xg + (h0 + hh) * p.xsh + t0 * p.xss, p.xss,
                         p.P, qv);
      mma::fence_proxy_async();
    }
    const int hw = tid >> 5;
    if (hw < Gv)
      ssdw::chunk_cum<true>(p.dt + b * p.dsb + (h0 + hw) * p.dsh + t0 * p.dss, p.dss, qv,
                            p.A[h0 + hw] * ssdw::LOG2E, vec(hw, 0));
    __syncthreads();
    if (fp.tma) {
      mma::mbar_wait(&bars[0], phase);
      phase ^= 1;
    }
    loaded = c;
  };

  // L (S^T: rows p, columns n) <- 2^tot L + sum_j (coef_j x_j)^T B_j with
  // coef_j = 2^(tot - cum_j) dt_j, for head hh of the loaded chunk; coef x
  // enters as bf16 hi + lo.  This warpgroup's products.
  auto local_state = [&](float(&L)[32], int hh) {
    const char* xt = sm + Fw::X + hh * TILE_BYTES;
    const float* cf = vec(hh, ssdw::V_COEF);
    const float decay = mma::exp2_approx(vec(hh, ssdw::V_CUM)[ROWS - 1]);
#pragma unroll
    for (int e = 0; e < 32; ++e) L[e] *= decay;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ssdw::xt_frag(xt, 4 * half + q, warp, cf, hi[q], lo[q]);
      wgmma::fence_regs(hi);
      wgmma::fence_regs(lo);
      wgmma::fence_regs(L);
      wgmma::fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t bd = wgmma::desc_mn(sm + Fw::B, 4 * half + q, TILE_BYTES);
        wgmma::rs(L, hi[q], bd);
        wgmma::rs(L, lo[q], bd);
      }
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(L);
    }
  };

  // A thread's places in a 64 x 64 accumulator: rows 16 warp + g + 8 hf,
  // columns 8 jn + 2 t and + 1 (element 4 jn + 2 hf and + 1).  A head pair
  // pr is heads 2 pr (warpgroup 0) and 2 pr + 1 (warpgroup 1); where the
  // second is past the group, warpgroup 1 repeats the first's products and
  // keeps none of them (products stay unconditional).
  const int npairs = (Gv + 1) / 2;

  // ---- Pass A: each head's local state over the block's chunks, then the
  // hand-off S_out = 2^(sum of tot) S_in + L, S_in from the previous
  // block's write into this inbox (zero in the first block), S_out into
  // the next block's inbox (the final state in the last block).
  for (int pr = 0; pr < npairs; ++pr) {
    const bool live = 2 * pr + wg < Gv;
    const int hh = live ? 2 * pr + wg : Gv - 1;
    float L[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) L[e] = 0.f;
    float dl = 0.f;  // sum of tot, log2 units
    for (int c = c0; c < c1; ++c) {
      load_chunk(c);
      local_state(L, hh);
      dl += vec(hh, ssdw::V_CUM)[ROWS - 1];
    }
    if (!live) continue;
    // The inbox holds S_in in fp32 (fragment order) until this warpgroup
    // has read it, then S_in as the bf16 hi and lo slabs of pass B's C S.
    char* ib = sm + Fw::ST + hh * 2 * SLAB_BYTES;
    float S[32];
    if (r > 0) {
      ssdw::mbar_wait_cluster(&bars[1 + hh], 0);
      ssdw::recv_frag(S, ib, tid & 127);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) S[e] = 0.f;
    }
    const float D = mma::exp2_approx(dl);
#pragma unroll
    for (int e = 0; e < 32; ++e) L[e] = fmaf(D, S[e], L[e]);
    if (r + 1 < cs) {
      // S_out into this inbox (S_in is in registers), then one bulk copy
      // into the next block's; the slabs below overwrite it once read.
      ssdw::wg_sync(wg);
      ssdw::put_frag(L, ib, tid & 127);
      mma::fence_proxy_async();
      ssdw::wg_sync(wg);
      if ((tid & 127) == 0)
        ssdw::bulk_to_cluster(ssdw::cluster_addr(ib, r + 1), ib, ssdw::STATE_BYTES,
                              ssdw::cluster_addr(&bars[1 + hh], r + 1));
    } else {
      float* sg = p.state + (static_cast<int64_t>(b) * p.H + h0 + hh) * p.N * p.P;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pp = 16 * warp + g + 8 * (e >> 1), n = 8 * jn + 2 * t + (e & 1);
          if (pp < p.P && n < p.N) sg[n * p.P + pp] = L[4 * jn + e];
        }
    }
    ssdw::wg_sync(wg);
    ssdw::put_slabs(S, ib, ib + SLAB_BYTES);
    mma::fence_proxy_async();
  }

  // ---- Pass B: per chunk, C B^T once for the group (fp32, in shared
  // memory), then per head y = w x + 2^cum (C S) from the state before the
  // chunk; then, for a chunk before the block's last, the state after it.
  for (int c = c0; c < c1; ++c) {
    load_chunk(c);
    const int t0 = c * p.Q, qv = min(p.Q, p.S - t0);
    // Blocks (0,0) and (1,1) on warpgroup 0, (1,0) on warpgroup 1.
    for (int q = wg; q < 3; q += 2) {
      const int it = q == 0 ? 0 : 1, jt = q == 2 ? 1 : 0;
      float d[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) d[e] = 0.f;
      wgmma::fence_regs(d);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma::ss(d, wgmma::desc_k(sm + Fw::C + it * 8192, ks, TILE_BYTES),
                  wgmma::desc_k(sm + Fw::B + jt * 8192, ks, TILE_BYTES));
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(d);
      float* blk = cbs + q * 64 * ssdw::CB_LD;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(blk + (16 * warp + g + 8 * hf) * ssdw::CB_LD + 8 * jn +
                                     2 * t) = make_float2(d[4 * jn + 2 * hf], d[4 * jn + 2 * hf + 1]);
    }
    __syncthreads();

    for (int pr = 0; pr < npairs; ++pr) {
      const bool live = 2 * pr + wg < Gv;
      const int hh = live ? 2 * pr + wg : Gv - 1;
      const char* xt = sm + Fw::X + hh * TILE_BYTES;
      const char* shi = sm + Fw::ST + hh * 2 * SLAB_BYTES;
      const float* cm = vec(hh, ssdw::V_CUM);
      const float* dv = vec(hh, ssdw::V_DT);
      const float* ke = vec(hh, ssdw::V_KEND);
      bf16* yg = static_cast<bf16*>(p.y) + b * p.ysb + (h0 + hh) * p.ysh + t0 * p.yss;
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        float y[32], cy[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) y[e] = cy[e] = 0.f;
        wgmma::fence_regs(y);
        wgmma::fence_regs(cy);
        wgmma::fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t ad = wgmma::desc_k(sm + Fw::C + it * 8192, ks, TILE_BYTES);
          wgmma::ss(cy, ad, wgmma::desc_k(shi, ks, SLAB_BYTES));
          wgmma::ss(cy, ad, wgmma::desc_k(shi + SLAB_BYTES, ks, SLAB_BYTES));
        }
        wgmma::commit();
        const int i0 = 64 * it + 16 * warp + g;
        const float ci[2] = {cm[i0], cm[i0 + 8]};
        // The tiles' w fragments, each set built while the products of the
        // one before run (one wait for all).  w_ij = (C_i . B_j) 2^(cum_i -
        // cum_j) dt_j where j <= i: by 16-column band J against this warp's
        // row band I, 2^(cum_i - cum_e) kend_j below the diagonal band (e
        // the band's last row), exp2 an element on it, zero above.
        uint32_t wh[2][4][4], wl[2][4][4];
#pragma unroll
        for (int jt = 0; jt <= it; ++jt) {
          const float* blk = cbs + (it == 0 ? 0 : jt == 0 ? 1 : 2) * 64 * ssdw::CB_LD;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int band = 16 * (4 * jt + kk);
            const bool below = jt < it || kk < warp, diag = jt == it && kk == warp;
            float rf[2] = {0.f, 0.f};
            if (below) {
              const float ce = cm[band + 15];
              rf[0] = mma::exp2_approx(ci[0] - ce);
              rf[1] = mma::exp2_approx(ci[1] - ce);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int hf = q & 1;
              const int i = i0 + 8 * hf;
              const int jl = 16 * kk + 8 * (q >> 1) + 2 * t;
              const int j = 64 * jt + jl;
              float w0 = 0.f, w1 = 0.f;
              if (below || diag) {
                const float2 v = *reinterpret_cast<const float2*>(
                    blk + (16 * warp + g + 8 * hf) * ssdw::CB_LD + jl);
                if (below) {
                  const float2 k = *reinterpret_cast<const float2*>(ke + j);
                  w0 = v.x * rf[hf] * k.x;
                  w1 = v.y * rf[hf] * k.y;
                } else {
                  w0 = j <= i ? v.x * mma::exp2_approx(ci[hf] - cm[j]) * dv[j] : 0.f;
                  w1 = j + 1 <= i ? v.y * mma::exp2_approx(ci[hf] - cm[j + 1]) * dv[j + 1] : 0.f;
                }
              }
              mma::split_bf16(w0, w1, wh[jt][kk][q], wl[jt][kk][q]);
            }
          }
          wgmma::fence_regs(wh[jt]);
          wgmma::fence_regs(wl[jt]);
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bd = wgmma::desc_mn(xt + jt * 8192, kk, TILE_BYTES);
            wgmma::rs(y, wh[jt][kk], bd);
            wgmma::rs(y, wl[jt][kk], bd);
          }
          wgmma::commit();
        }
        wgmma::wait<0>();
        wgmma::fence_regs(y);
        wgmma::fence_regs(cy);
#pragma unroll
        for (int jt = 0; jt <= it; ++jt) {
          wgmma::fence_regs(wh[jt]);
          wgmma::fence_regs(wl[jt]);
        }
        if (!live) continue;
        // y = w x + 2^cum_i (C S) as bf16, 8 bytes a store
        // (ssdw::quad_pair).
        const float e0 = mma::exp2_approx(ci[0]), e1 = mma::exp2_approx(ci[1]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = i0 + 8 * hf, a = 8 * m + 2 * hf, c = a + 4;
            const float e = hf ? e1 : e0;
            const uint2 v = ssdw::quad_pair(
                mma::pack_bf16(fmaf(e, cy[a], y[a]), fmaf(e, cy[a + 1], y[a + 1])),
                mma::pack_bf16(fmaf(e, cy[c], y[c]), fmaf(e, cy[c + 1], y[c + 1])), t);
            const int col = 16 * m + ssdw::quad_col(t);
            if (i < qv && col < p.P) *reinterpret_cast<uint2*>(yg + i * p.yss + col) = v;
          }
      }
      if (c + 1 == c1) continue;
      // The state after this chunk (not the block's last): S <- 2^tot S + L_c.
      float L[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) L[e] = 0.f;
      local_state(L, hh);
      if (!live) continue;
      const float decay = mma::exp2_approx(cm[ROWS - 1]);
      char* sb = sm + Fw::ST + hh * 2 * SLAB_BYTES;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int off = ssdw::sw(16 * warp + g + 8 * hf, 8 * jn + 2 * t);
          uint32_t* ph = reinterpret_cast<uint32_t*>(sb + off);
          uint32_t* pl = reinterpret_cast<uint32_t*>(sb + SLAB_BYTES + off);
          const float2 a = mma::unpack_bf16(*ph), l = mma::unpack_bf16(*pl);
          uint32_t nh, nl;
          mma::split_bf16(fmaf(decay, a.x + l.x, L[4 * jn + 2 * hf]),
                          fmaf(decay, a.y + l.y, L[4 * jn + 2 * hf + 1]), nh, nl);
          *ph = nh;
          *pl = nl;
        }
      mma::fence_proxy_async();
    }
  }
}

// The plan of a bf16 call: heads a block (G), chunks a block (k), blocks a
// cluster (cs), on the current device.
cudaError_t fw_plan(int B, int S, int H, int Q, int& G, int& k, int& cs) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, Fw::BYTES);
  if (attr != cudaSuccess) return attr;
  ssdw::chunk_plan((S + Q - 1) / Q, k, cs);
  int slots = 0;
  const cudaError_t err = ssdw::cluster_slots(ssd_fwd_wgmma, cs, Fw::BYTES, slots);
  if (err != cudaSuccess) return err;
  G = ssdw::group_size(B, cs, H, FW_MAX_G, slots);
  return cudaSuccess;
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  FwParams fp{};
  fp.p = p;
  fp.nc = (p.S + p.Q - 1) / p.Q;
  const cudaError_t err = fw_plan(p.B, p.S, p.H, p.Q, fp.G, fp.k, fp.cs);
  if (err != cudaSuccess) return err;
  const int64_t xs[3] = {p.xsb, p.xsh, p.xss}, bs[3] = {p.bsb, p.bss, p.bss},
                cs[3] = {p.csb, p.css, p.css};
  fp.tma = ssdw::describable(p.x, xs) && ssdw::describable(p.b, bs) && ssdw::describable(p.c, cs);
  // y takes 8-byte stores: its base and strides in whole 4 elements (as
  // the wrapper allocates it).
  if (reinterpret_cast<uintptr_t>(p.y) % 8 != 0 || p.ysb % 4 != 0 || p.yss % 4 != 0 ||
      p.ysh % 4 != 0)
    return cudaErrorInvalidValue;
  if (fp.tma && !(mma::encode_map(&fp.mx, p.x, xs, p.P, p.H, p.S, p.B) &&
                  mma::encode_map(&fp.mb, p.b, bs, p.N, 1, p.S, p.B) &&
                  mma::encode_map(&fp.mc, p.c, cs, p.N, 1, p.S, p.B)))
    return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>(fp.cs) * ((p.H + fp.G - 1) / fp.G);
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = fp.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), p.B);
  cfg.blockDim = dim3(ssdw::THREADS);
  cfg.dynamicSmemBytes = Fw::BYTES;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_fwd_wgmma, fp);
}

bool supported(int v, int hi) { return v >= 4 && v <= hi && v % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block takes at these sizes.  dtype:
// 0 = float32 (the scalar kernel), 1 = bfloat16 (ssd_fwd_wgmma, whose plan
// is fixed: 128-row chunk tiles, 64-column slabs, up to 4 heads).
extern "C" int ssd_scan_smem_bytes(int Q, int N, int P, int dtype) {
  if (dtype == 1) return Fw::BYTES;
  return static_cast<int>(sizeof(float) * Layout(Q, N, P).total);
}

// The bf16 kernel's plan on the current device: through G, k and cs the
// heads a block holds, the chunks a block takes and the blocks a cluster,
// and through slots the blocks that run at once.  Returns a cudaError_t.
extern "C" int ssd_scan_plan(int B, int S, int H, int Q, int* G, int* k, int* cs, int* slots) {
  cudaError_t err = fw_plan(B, S, H, Q, *G, *k, *cs);
  if (err == cudaSuccess) err = ssdw::cluster_slots(ssd_fwd_wgmma, *cs, Fw::BYTES, *slots);
  return static_cast<int>(err);
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
