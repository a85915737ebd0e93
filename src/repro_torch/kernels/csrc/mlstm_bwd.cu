// Backward of the chunked stabilised mLSTM for NVIDIA Hopper (sm_90a), fp32
// and bf16 inputs.
//
// Replaces: no Pallas kernel.  src/repro/kernels/mlstm.py::_mlstm_kernel has
// no backward; the JAX package differentiates the jnp oracle
// repro.models.xlstm.mlstm_chunked with jax.value_and_grad
// (src/repro/train/steps.py:75).  This computes the vjp of h =
// repro_torch.kernels.ref.mlstm_chunked(q, k, v, i_gate, f_gate)[0] given
// dh: dq, dk, dv and the gates' gradients.  The final state carries none
// (the autograd Function marks it non-differentiable).
//
// The stabilisers carry no gradient, exactly.  m_prev, m_i and the update's
// m' are recomputed as in the forward and held constant: num_i and den_i
// both carry e^{-m_i}, so h_i = N_i / max(|D_i|, 1) with N, D unstabilised,
// and h does not depend on any m.  Per chunk, in the forward's quantities
// (qq = q / sqrt(D); b_i the cumsum of log-forget; A_ij = e^{b_i - b_j +
// ig_j - m_i} for j <= i; s_i = e^{m_prev + b_i - m_i}; c_j = e^{w_j - m'},
// w_j = tot - b_j + ig_j; so = e^{m_prev + tot - m'}; S_p, n_p the state
// before the chunk; dS, dn the cotangent of the state after it):
//   g_i = max(|den_i|, e^{-m_i}); dnum_i = dh_i / g_i;
//   dden_i = -sign(den_i) (dh_i . h_i) / g_i where |den_i| wins, else 0
//   dP_ij = dnum_i . v_j + dden_i;  P_ij = (qq_i . k_j) A_ij
//   dv_j  = sum_i P_ij dnum_i + c_j dS^T k_j
//   dqq_i = sum_j A_ij dP_ij k_j + s_i (S_p dnum_i + n_p dden_i)
//   dk_j  = sum_i A_ij dP_ij qq_i + c_j (dS v_j + dn)
//   G_ij  = P_ij dP_ij: + to db_i and dig_j, - to db_j
//   db_i += s_i (qq_i^T S_p dnum_i + qq_i . n_p dden_i)
//   dw_j  = c_j (k_j^T dS v_j + k_j . dn): + to dtot and dig_j, - to db_j
//   dtot += so (<dS, S_p> + <dn, n_p>);  db_{Q-1} += dtot
//   dS <- so dS + sum_i s_i qq_i dnum_i^T;  dn <- so dn + sum_i s_i qq_i dden_i
//   dlogf = reverse cumsum of db within the chunk; df = dlogf sigmoid(-f);
//   dq = dqq / sqrt(D)
// dh_i . h_i takes h in fp32, recomputed: the forward's saved h has the
// inputs' type, and in bf16 its rounding, amplified where gates of +-20
// make the gate gradients cancel, put d f_gate several percent (relative
// rms) off autograd of the plain version on the card.
//
// Launches, all on the caller's stream, sharing one fp32 scratch that the
// wrapper allocates:
//   1. mlstm_bwd_states: the forward's scalar kernel (csrc/mlstm.cu) run
//      again, writing instead of h the states before each chunk, S_p
//      (B, nc, H, D, D), n_p (B, nc, H, D) and m_prev (B, nc, H) (75.5 MB at
//      xlstm_125m's train shape; recomputed rather than saved by the
//      forward, whose kernel and C interface stay as they are), and each
//      column block's share of dh_i . h_i (ncb, B, S, H).
//   2. mlstm_bwd_main: S is split over blocks of VB value columns, as in the
//      forward (dS (D, D) is 576 KB in fp32 at D 384; a block may have
//      227 KB): block (vb, h, b) owns dS[:, v0:v0+VB] and walks the chunks
//      backward.  Everything that needs a full value row (dP, hence G, dqq,
//      dk) it computes over its own columns only, as an fp32 partial; the
//      terms in dden and dn, which need no value column, only block 0 adds.
//      dv, which is per column, it writes whole.  It recomputes q k^T over
//      all key columns, streaming q and k 32 columns at a time.
//   3. mlstm_bwd_reduce_qk: dq and dk, the partials summed over the column
//      blocks in a fixed order.
//   4. mlstm_bwd_reduce_gates: dig, and db reverse-summed within each chunk
//      into dlogf, then df; one thread a (b, h, chunk).
// No atomics anywhere, so two calls give the same bits.
//
// What bounds it.  At xlstm_125m's train shape (B 8, S 512, H 4, D 384,
// Q 128, bf16) the call must read q, k, v, dh (4 x 12.6 MB) and the gates,
// and write dq, dk, dv (3 x 12.6 MB) and the gates' gradients: ~88 MB,
// 26 us at 3.35 TB/s.  Its products per (b, h, chunk) are q k^T, dnum v^T,
// P^T dnum, dqk k and dqk^T q over the lower triangle (5 Q^2 D), and the
// states, q S_p, S_p dnum, dS v, dS^T k and the dS update (12 Q D^2):
// 258 MFLOP, x 128 = 33 GFLOP: 33 us at the bf16 tensor-core peak, so
// operations bound it, barely (chip_smoke.py's ``mlstm_bwd_bound_ms``).
// This kernel does it all in scalar fp32 FMAs (bf16 inputs converted where
// they are loaded), with q k^T recomputed by each of the D / 32 column
// blocks twice (the states launch and the main one), and writes and reads
// the dq, dk partials (12 x 12.6 MB each in fp32 at that shape); putting
// the products on the tensor cores is later work (ROADMAP.md B3d).
//
// The design of the main kernel.  One block (256 threads) per (column
// block, h, b) with a loop over the chunks inside (the TPU's sequential
// axis; Hopper blocks run in no order).  Shared memory holds dS[:, cols],
// one Q x Q matrix M [Q][Q+4] (in turn P, G and A dP, on the 4 x 4 tiles on
// or below the diagonal), v and dnum of its columns [Q][VB], q and k tiles
// [Q][36], dn and n_p (D) and the per-row vectors.  A thread owns 4 x 4
// register tiles; every inner dimension is walked 4 wide with float4 loads.
// S_p is read from the scratch through L2.  Sums across tiles go through
// small shared buffers in a fixed order; the short sums that cancel (row
// and column sums of Q x Q matrices, the partials across column blocks,
// the reverse cumsum of db) run in fp64, which costs nothing beside the
// products.  The gate math (b, the stabilisers) runs in fp64 in both
// launches, and every exponent b_i - b_j + ig_j - m_i (and those of s_i,
// c_j and the state's decay) is formed in fp64 and rounded once before
// expf: an fp32 b, down to ~-50 over a chunk of 128, carried an absolute
// error of ~1e-5 into them, which put single entries of dk 1.15x past err
// / (1e-4 + 1e-4 |exact|) <= 1 against the fp64 gradient at D 384, chunk
// 128, where the sequential plain version stays under 0.12 (ROADMAP C2,
// found by a CPU emulation; after the repair the kernel's worst there is
// 0.24 on the card).  m' is rounded to fp32 before the exponents that use
// it, as the states scratch keeps it, so the state stays exactly
// stabilised by the value the next chunk reads.  Shared memory: 206,352
// bytes at Q 128, D 384 (dS 49,152; M 67,584; v, dnum 32,768; q, k tiles
// 36,864; vectors and partial sums 19,984): one block an SM, 384 blocks.
//
// The stabiliser's start: m_prev is -inf before the first chunk; s_i and
// so are set to 0 there instead of evaluating exp(-inf - m), so -inf -
// (-inf) is never formed.  A ragged last chunk is zero-filled where it is
// loaded, with log-forget 0 and input gate -inf; its rows have dh = 0,
// 1/g = 0 and dden = 0, so they add nothing, and only valid rows are
// written.  The build does not use --use_fast_math: inf stays IEEE.
//
// Sizes are runtime values, as in the forward: D a multiple of 4 up to 32,
// or of 32 up to 512; Q a multiple of 4 in [4, 128]; any length S >= 1.
// q, k, v, dh and the gates may be strided views (element strides of
// their leading axes; last axis of q, k, v, dh contiguous).  dq, dk, dv
// (B, S, H, D) and dig, df (B, S, H) are written contiguous in the inputs'
// type.  Launch errors are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_Q = 128;
constexpr int MAX_D = 512;
constexpr int COLS = 32;    // value columns a block owns (VB) and key columns a tile holds (KT)
constexpr int MAX_TRI = 3;  // lower-triangle 4x4 tiles a thread: ceil(32*33/2 / 256)
constexpr int RED_THREADS = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* ig;
  const void* fg;
  const void* dh;
  void* dv;         // (B, S, H, D) contiguous
  float* Sp;        // (B, nc, H, D, D)
  float* np;        // (B, nc, H, D)
  float* mp;        // (B, nc, H)
  float* ddp;       // (ncb, B, S, H): dh . h over each block's columns
  float* dqp;       // (ncb, B, S, H, D)
  float* dkp;       // (ncb, B, S, H, D)
  float* dbp;       // (ncb, B, S, H)
  float* digp;      // (ncb, B, S, H)
  int B, L, H, D, Q, nc;
  float sqrt_d;
  int64_t qsb, qss, qsh;
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t isb, iss, ish;
  int64_t fsb, fss, fsh;
  int64_t dsb, dss, dsh;
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

// e^{v} of an exponent formed in fp64.
__device__ __forceinline__ float exp_of(double v) { return expf(static_cast<float>(v)); }

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void unpack(const float4 v, float (&r)[4]) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void tri_tile(int k, int& i0, int& j0) {
  int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  while (ti * (ti + 1) / 2 > k) --ti;
  i0 = ti * 4;
  j0 = (k - ti * (ti + 1) / 2) * 4;
}

// acc[u][w] += a_{a0+u} . b_{b0+w} over len, both row-major with rows of ld.
__device__ __forceinline__ void dot_tile(const float* A, int a0, int lda, const float* Bm,
                                         int b0, int ldb, int len, float (&acc)[4][4]) {
  for (int c = 0; c < len; c += 4) {
    float ar[4][4], br[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unpack(ld4(A + (a0 + u) * lda + c), ar[u]);
      unpack(ld4(Bm + (b0 + u) * ldb + c), br[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][w] = fmaf(ar[u][e], br[w][e], acc[u][w]);
  }
}

// The chunk's gate math, in warp 0 (up to 4 rows a lane), as the forward's
// but in fp64: b (bq, double), the input gate (igs, -inf past the end), m_i
// (mi, double), s_i (isc), the update's weights c_j (cw).  Returns m' (the
// stabiliser after the chunk, rounded to fp32, as the states scratch keeps
// it; every exponent that involves it uses that rounded value, so the state
// stays exactly stabilised by it) and sets *scale_old = e^{m_prev + tot - m'}
// (0 while m_prev is -inf).  In fp32, b (down to ~-50 over a chunk of 128)
// carries an absolute error of ~1e-5 into every exponent b_i - b_j + ig_j -
// m_i, which put single gradient entries past (1e-4 + 1e-4 |exact|) of the
// fp64 gradient; each exponent is therefore formed in fp64 and rounded once.
template <typename T>
__device__ float gate_math(const T* ig_g, const T* fg_g, int64_t iss, int64_t fss, int t0,
                           int qv, int Q, float m_prev, double* bq, float* igs, double* mi,
                           float* isc, float* cw, float* scale_old, int lane) {
  const int E = (Q + 31) / 32;
  const int j0 = lane * E;
  const double mp = m_prev;
  double lf[4], igv[4], bl[4], am[4];
  double run = 0.0, amax = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    igv[e] = -INFINITY;
    lf[e] = 0.0;
    if (e < E && j < qv) {
      igv[e] = to_f(__ldg(ig_g + (t0 + j) * iss));
      lf[e] = log_sigmoid(to_f(__ldg(fg_g + (t0 + j) * fss)));
    }
    run += lf[e];
    bl[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bl[e] += excl;
    amax = fmax(amax, igv[e] - bl[e]);
    am[e] = amax;
    const int j = j0 + e;
    if (e < E && j < Q) {
      bq[j] = bl[e];
      igs[j] = static_cast<float>(igv[e]);
    }
  }
  double mincl = amax;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, mincl, off);
    if (lane >= off) mincl = fmax(mincl, o);
  }
  double mexcl = __shfl_up_sync(0xffffffffu, mincl, 1);
  if (lane == 0) mexcl = -INFINITY;
  __syncwarp();
  const double total = bq[Q - 1];
  double wmax = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    if (e < E && j < Q) {
      const double m_intra = bl[e] + fmax(mexcl, am[e]);
      const double m_i = fmax(mp + bl[e], m_intra);
      mi[j] = m_i;
      isc[j] = m_prev == -INFINITY ? 0.f : exp_of(mp + bl[e] - m_i);
      wmax = fmax(wmax, total - bl[e] + igv[e]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = fmax(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
  const float m_new = static_cast<float>(fmax(mp + total, wmax));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    if (e < E && j < Q) cw[j] = exp_of(total - bl[e] + igv[e] - m_new);
  }
  if (lane == 0)
    *scale_old = m_prev == -INFINITY ? 0.f : exp_of(mp + total - m_new);
  return m_new;
}

// ---------------------------------------------------------------------------
// Launch 1: the states before each chunk.
// ---------------------------------------------------------------------------

struct StLayout {
  int VB, KT, LQ, V4, ss, wt, vs, dhs, qt, kt, part, nv, bq, ig, mi, isc, cw, scal, total;
  __host__ __device__ constexpr StLayout(int Q, int D)
      : VB(D < COLS ? D : COLS),
        KT(D < COLS ? D : COLS),
        LQ(Q + 4),
        V4((D < COLS ? D : COLS) / 4),
        ss(0),                                          // [D][VB]  S[:, v0:v0+VB]
        wt(D * (D < COLS ? D : COLS)),                  // [Q][LQ]  Wt[j][i] = W_ij
        vs(wt + Q * (Q + 4)),                           // [Q][VB]  v, own columns
        dhs(vs + Q * (D < COLS ? D : COLS)),            // [Q][VB]  dh, own columns
        qt(dhs + Q * (D < COLS ? D : COLS)),            // [KT][LQ] q^T tile (scaled)
        kt(qt + (D < COLS ? D : COLS) * (Q + 4)),       // [KT][LQ] k^T tile
        part(kt + (D < COLS ? D : COLS) * (Q + 4)),     // [Q][V4]  dh . h over 4 columns
        nv(part + Q * ((D < COLS ? D : COLS) / 4)),     // [D]      n
        bq(nv + D),                                     // double[Q]
        ig(bq + 2 * Q),                                 // [Q] each below
        mi(bq + 3 * Q),                                 // double[Q]
        isc(bq + 5 * Q),
        cw(bq + 6 * Q),
        scal(bq + 7 * Q),
        total(scal + 4) {}
};

// The forward recomputed, block (vb, h, b) owning S[:, v0:v0+VB] as in the
// forward's scalar kernel (csrc/mlstm.cu): it writes the state before each
// chunk (S_p, and from block 0 n_p and m_prev) and, in place of h, this
// block's share of dh_i . h_i over its columns, h computed in fp32 (the
// saved h has the inputs' type; in bf16 its rounding, amplified where
// gates of +-20 make the gate gradients cancel, would reach them).
template <typename T>
__global__ void __launch_bounds__(NTHREADS) mlstm_bwd_states(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, D = p.D;
  const StLayout L(Q, D);
  const int LQ = L.LQ, VB = L.VB, KT = L.KT, V4 = L.V4;
  float* Ss = sm + L.ss;
  float* Wt = sm + L.wt;
  float* Vs = sm + L.vs;
  float* dHs = sm + L.dhs;
  float* Qt = sm + L.qt;
  float* Kt = sm + L.kt;
  float* part = sm + L.part;
  float* nv = sm + L.nv;
  double* bq = reinterpret_cast<double*>(sm + L.bq);
  float* igs = sm + L.ig;
  double* mi = reinterpret_cast<double*>(sm + L.mi);
  float* isc = sm + L.isc;
  float* cw = sm + L.cw;
  float* scal = sm + L.scal;
  const int tid = threadIdx.x;
  const int vblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = vblk * VB;
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh + c0;
  const T* dhg = static_cast<const T*>(p.dh) + b * p.dsb + h * p.dsh + c0;
  const T* ig_g = static_cast<const T*>(p.ig) + b * p.isb + h * p.ish;
  const T* fg_g = static_cast<const T*>(p.fg) + b * p.fsb + h * p.fsh;
  float* ddg = p.ddp + (static_cast<int64_t>(vblk) * p.B + b) * p.L * p.H + h;
  const float sqrt_d = p.sqrt_d;

  const int T4 = Q / 4;
  const int ntri = T4 * (T4 + 1) / 2;
  int tri_i[MAX_TRI], tri_j[MAX_TRI];
#pragma unroll
  for (int r = 0; r < MAX_TRI; ++r) tri_tile(tid + r * NTHREADS, tri_i[r], tri_j[r]);
  const bool own = tid < T4 * V4;
  const int oi = (tid / V4) * 4;
  const int ov = (tid % V4) * 4;

  for (int e = tid; e < D * VB; e += NTHREADS) Ss[e] = 0.f;
  for (int e = tid; e < D; e += NTHREADS) nv[e] = 0.f;
  float m_prev = -INFINITY;  // warp 0 keeps it
  __syncthreads();
  for (int ch = 0; ch < p.nc; ++ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.L - t0);
    const int64_t st = (static_cast<int64_t>(b) * p.nc + ch) * p.H + h;
    float* sg = p.Sp + st * D * D + c0;
    for (int e = tid; e < D * VB; e += NTHREADS) {
      const int row = e / VB;
      sg[static_cast<int64_t>(row) * D + (e - row * VB)] = Ss[e];
    }
    if (vblk == 0) {
      for (int e = tid; e < D; e += NTHREADS) p.np[st * D + e] = nv[e];
      if (tid == 0) p.mp[st] = m_prev;
    }
    for (int e = tid; e < Q * VB; e += NTHREADS) {
      const int j = e / VB;
      const int c = e - j * VB;
      const bool in = j < qv;
      Vs[e] = in ? to_f(__ldg(vg + (t0 + j) * p.vss + c)) : 0.f;
      dHs[e] = in ? to_f(__ldg(dhg + (t0 + j) * p.dss + c)) : 0.f;
    }
    if (tid < 32)
      m_prev = gate_math<T>(ig_g, fg_g, p.iss, p.fss, t0, qv, Q, m_prev, bq, igs, mi, isc, cw,
                            scal, tid);
    __syncthreads();
    const float so = scal[0];

    // q k^T on the lower triangle, q S and q . n on this thread's tile, and
    // the update of each tile's rows of S and n once they are read.
    float acc[MAX_TRI][4][4] = {};
    float aqs[4][4] = {};
    float aqn[4] = {};
    for (int k0 = 0; k0 < D; k0 += KT) {
      for (int e = tid; e < Q * KT; e += NTHREADS) {
        const int j = e / KT;
        const int c = e - j * KT;
        float qx = 0.f, kx = 0.f;
        if (j < qv) {
          qx = to_f(__ldg(qg + (t0 + j) * p.qss + k0 + c)) / sqrt_d;
          kx = to_f(__ldg(kg + (t0 + j) * p.kss + k0 + c));
        }
        Qt[c * LQ + j] = qx;
        Kt[c * LQ + j] = kx;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < MAX_TRI; ++r) {
        if (tid + r * NTHREADS < ntri) {
          const int i0 = tri_i[r], j0 = tri_j[r];
          for (int c = 0; c < KT; ++c) {
            float qr[4], kr[4];
            unpack(ld4(Qt + c * LQ + i0), qr);
            unpack(ld4(Kt + c * LQ + j0), kr);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int w = 0; w < 4; ++w) acc[r][u][w] = fmaf(qr[u], kr[w], acc[r][u][w]);
          }
        }
      }
      if (own) {
        for (int c = 0; c < KT; ++c) {
          float qr[4], sr[4];
          unpack(ld4(Qt + c * LQ + oi), qr);
          unpack(ld4(Ss + (k0 + c) * VB + ov), sr);
          const float nc = nv[k0 + c];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            aqn[u] = fmaf(qr[u], nc, aqn[u]);
#pragma unroll
            for (int w = 0; w < 4; ++w) aqs[u][w] = fmaf(qr[u], sr[w], aqs[u][w]);
          }
        }
      }
      __syncthreads();
      for (int e = tid; e < KT * V4; e += NTHREADS) {
        const int c = e / V4;
        const int v0 = (e - c * V4) * 4;
        float* srow = Ss + (k0 + c) * VB + v0;
        float sv[4];
        unpack(ld4(srow), sv);
#pragma unroll
        for (int w = 0; w < 4; ++w) sv[w] *= so;
        float nn = nv[k0 + c] * so;
        for (int j = 0; j < qv; ++j) {
          const float kc = Kt[c * LQ + j] * cw[j];
          float vr[4];
          unpack(ld4(Vs + j * VB + v0), vr);
#pragma unroll
          for (int w = 0; w < 4; ++w) sv[w] = fmaf(kc, vr[w], sv[w]);
          nn += kc;
        }
        *reinterpret_cast<float4*>(srow) = make_float4(sv[0], sv[1], sv[2], sv[3]);
        if (v0 == 0) nv[k0 + c] = nn;
      }
      __syncthreads();
    }

    // W on the lower triangle, stored transposed.
#pragma unroll
    for (int r = 0; r < MAX_TRI; ++r) {
      if (tid + r * NTHREADS < ntri) {
        const int i0 = tri_i[r], j0 = tri_j[r];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          float out[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u;
            out[u] = j <= i ? acc[r][u][w] * exp_of(bq[i] - bq[j] + igs[j] - mi[i]) : 0.f;
          }
          *reinterpret_cast<float4*>(Wt + j * LQ + i0) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    __syncthreads();

    // h on this thread's tile, in fp32, dotted with dh.
    if (own) {
      float awv[4][4] = {};
      float rs[4] = {};
      const int jend = min(oi + 4, qv);
      for (int j = 0; j < jend; ++j) {
        float wr[4], vr[4];
        unpack(ld4(Wt + j * LQ + oi), wr);
        unpack(ld4(Vs + j * VB + ov), vr);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          rs[u] += wr[u];
#pragma unroll
          for (int w = 0; w < 4; ++w) awv[u][w] = fmaf(wr[u], vr[w], awv[u][w]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = oi + u;
        const float e_i = isc[i];
        const float den = fmaxf(fabsf(aqn[u] * e_i + rs[u]), exp_of(-mi[i]));
        float dr[4];
        unpack(ld4(dHs + i * VB + ov), dr);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s = fmaf(dr[w], (aqs[u][w] * e_i + awv[u][w]) / den, s);
        part[i * V4 + ov / 4] = i < qv ? s : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < qv; i += NTHREADS) {
      double s = 0.0;
      for (int t = 0; t < V4; ++t) s += part[i * V4 + t];
      ddg[static_cast<int64_t>(t0 + i) * p.H] = static_cast<float>(s);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch 2: the backward over the chunks, per block of value columns.
// ---------------------------------------------------------------------------

struct Layout {
  int VB, KT, KP, LQ, V4, ds, mm, vs, dn_, qs, ks, dnv, npv, bq, ig, mi, isc, cw, aqn, ginv,
      dden, dd, rowg, colg, dbf, dwv, part1, part2, red, scal, total;
  __host__ __device__ constexpr Layout(int Q, int D)
      : VB(D < COLS ? D : COLS),
        KT(D < COLS ? D : COLS),
        KP((D < COLS ? D : COLS) + 4),
        LQ(Q + 4),
        V4((D < COLS ? D : COLS) / 4),
        ds(0),                                          // [D][VB]  dS[:, v0:v0+VB]
        mm(D * VB),                                     // [Q][LQ]  P, then G, then A dP
        vs(mm + Q * (Q + 4)),                           // [Q][VB]  v, own columns
        dn_(vs + Q * VB),                               // [Q][VB]  dh, then dnum
        qs(dn_ + Q * VB),                               // [Q][KP]  q tile (scaled)
        ks(qs + Q * ((D < COLS ? D : COLS) + 4)),       // [Q][KP]  k tile
        dnv(ks + Q * ((D < COLS ? D : COLS) + 4)),      // [D]      dn
        npv(dnv + D),                                   // [D]      n_p
        bq(npv + D),                                    // double[Q]
        ig(bq + 2 * Q),                                 // [Q] each below
        mi(bq + 3 * Q),                                 // double[Q]
        isc(bq + 5 * Q),
        cw(bq + 6 * Q),
        aqn(bq + 7 * Q),                                // qq_i . n_p
        ginv(bq + 8 * Q),                               // 1 / g_i (0 past the end)
        dden(bq + 9 * Q),
        dd(bq + 10 * Q),                                // dh_i . h_i
        rowg(bq + 11 * Q),                              // row sums of G
        colg(bq + 12 * Q),                              // column sums of G
        dbf(bq + 13 * Q),                               // db, this block's share
        dwv(bq + 14 * Q),                               // dw_j
        part1(bq + 15 * Q),                             // [Q][V4]
        part2(bq + 15 * Q + Q * ((D < COLS ? D : COLS) / 4)),
        red(bq + 15 * Q + 2 * Q * ((D < COLS ? D : COLS) / 4)),  // [NTHREADS]
        scal(bq + 15 * Q + 2 * Q * ((D < COLS ? D : COLS) / 4) + NTHREADS),
        total(bq + 15 * Q + 2 * Q * ((D < COLS ? D : COLS) / 4) + NTHREADS + 4) {}
};

constexpr size_t MAX_BYTES = sizeof(float) * Layout(MAX_Q, MAX_D).total;
static_assert(MAX_BYTES <= 232448, "shared memory plan exceeds 227 KB");
constexpr size_t ST_MAX_BYTES = sizeof(float) * StLayout(MAX_Q, MAX_D).total;
static_assert(ST_MAX_BYTES <= 232448, "shared memory plan exceeds 227 KB");

template <typename T>
__global__ void __launch_bounds__(NTHREADS) mlstm_bwd_main(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, D = p.D;
  const Layout L(Q, D);
  const int LQ = L.LQ, VB = L.VB, KT = L.KT, KP = L.KP, V4 = L.V4;
  float* dS = sm + L.ds;
  float* M = sm + L.mm;
  float* Vs = sm + L.vs;
  float* DN = sm + L.dn_;
  float* Qs = sm + L.qs;
  float* Ks = sm + L.ks;
  float* dnv = sm + L.dnv;
  float* npv = sm + L.npv;
  double* bq = reinterpret_cast<double*>(sm + L.bq);
  float* igs = sm + L.ig;
  double* mi = reinterpret_cast<double*>(sm + L.mi);
  float* isc = sm + L.isc;
  float* cw = sm + L.cw;
  float* aqnv = sm + L.aqn;
  float* ginv = sm + L.ginv;
  float* dden = sm + L.dden;
  float* dd = sm + L.dd;
  float* rowg = sm + L.rowg;
  float* colg = sm + L.colg;
  float* dbf = sm + L.dbf;
  float* dwv = sm + L.dwv;
  float* part1 = sm + L.part1;
  float* part2 = sm + L.part2;
  float* red = sm + L.red;
  float* scal = sm + L.scal;

  const int tid = threadIdx.x;
  const int vblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const bool first = vblk == 0;
  const int c0 = vblk * VB;
  const int ncb = D / VB;
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh + c0;
  const T* ig_g = static_cast<const T*>(p.ig) + b * p.isb + h * p.ish;
  const T* fg_g = static_cast<const T*>(p.fg) + b * p.fsb + h * p.fsh;
  const T* dhg = static_cast<const T*>(p.dh) + b * p.dsb + h * p.dsh;
  const int64_t SH = static_cast<int64_t>(p.L) * p.H;
  // (cb, b, t, h, d) offsets of the partials; (b, t, h, d) of dv.
  const int64_t row_stride = static_cast<int64_t>(p.H) * D;  // one t
  float* dqg = p.dqp + ((static_cast<int64_t>(vblk) * p.B + b) * SH + h) * D;
  float* dkg = p.dkp + ((static_cast<int64_t>(vblk) * p.B + b) * SH + h) * D;
  float* dbg = p.dbp + (static_cast<int64_t>(vblk) * p.B + b) * SH + h;
  float* digg = p.digp + (static_cast<int64_t>(vblk) * p.B + b) * SH + h;
  T* dvg = static_cast<T*>(p.dv) + (static_cast<int64_t>(b) * SH + h) * D + c0;
  const float sqrt_d = p.sqrt_d;

  const int T4 = Q / 4, KT4 = KT / 4;
  const int ntri = T4 * (T4 + 1) / 2;
  // This thread's (row, value column) 4x4 tile: q S_p, and dv.
  const bool own = tid < T4 * V4;
  const int oi = (tid / V4) * 4;
  const int ov = (tid % V4) * 4;

  for (int e = tid; e < D * VB; e += NTHREADS) dS[e] = 0.f;
  for (int e = tid; e < D; e += NTHREADS) dnv[e] = 0.f;

  for (int ch = p.nc - 1; ch >= 0; --ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.L - t0);
    const int64_t st = (static_cast<int64_t>(b) * p.nc + ch) * p.H + h;
    const float* Spg = p.Sp + st * D * D + c0;  // row k: Spg + k * D

    // 1. Gate math, own columns of v and dh, n_p, and dh_i . h_i.
    if (tid < 32)
      gate_math<T>(ig_g, fg_g, p.iss, p.fss, t0, qv, Q, p.mp[st], bq, igs, mi, isc, cw,
                   scal, tid);
    for (int e = tid; e < Q * VB; e += NTHREADS) {
      const int j = e / VB;
      const int c = e - j * VB;
      const bool in = j < qv;
      Vs[e] = in ? to_f(__ldg(vg + (t0 + j) * p.vss + c)) : 0.f;
      DN[e] = in ? to_f(__ldg(dhg + (t0 + j) * p.dss + c0 + c)) : 0.f;
    }
    for (int e = tid; e < D; e += NTHREADS) npv[e] = p.np[st * D + e];
    // dh_i . h_i: the states launch's partials, summed over the column blocks.
    for (int i = tid; i < Q; i += NTHREADS) {
      double s = 0.0;
      if (i < qv)
        for (int c = 0; c < ncb; ++c)
          s += p.ddp[(static_cast<int64_t>(c) * p.B + b) * SH + (t0 + i) * p.H + h];
      dd[i] = static_cast<float>(s);
    }
    __syncthreads();
    const float so = scal[0];

    // 2. Stream q and k over the key columns: q k^T on the lower triangle,
    //    q S_p on this thread's (row, value) tile, q . n_p.
    float acc[MAX_TRI][4][4] = {};
    float aqs[4][4] = {};
    float aqn[4] = {};
    for (int k0 = 0; k0 < D; k0 += KT) {
      for (int e = tid; e < Q * KT; e += NTHREADS) {
        const int j = e / KT;
        const int c = e - j * KT;
        float qx = 0.f, kx = 0.f;
        if (j < qv) {
          qx = to_f(__ldg(qg + (t0 + j) * p.qss + k0 + c)) / sqrt_d;
          kx = to_f(__ldg(kg + (t0 + j) * p.kss + k0 + c));
        }
        Qs[j * KP + c] = qx;
        Ks[j * KP + c] = kx;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < MAX_TRI; ++r) {
        const int kk = tid + r * NTHREADS;
        if (kk < ntri) {
          int i0, j0;
          tri_tile(kk, i0, j0);
          dot_tile(Qs, i0, KP, Ks, j0, KP, KT, acc[r]);
        }
      }
      if (own) {
        for (int c = 0; c < KT; c += 4) {
          float qr[4][4], sr[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unpack(ld4(Qs + (oi + u) * KP + c), qr[u]);
            unpack(__ldg(reinterpret_cast<const float4*>(Spg + static_cast<int64_t>(k0 + c + u) * D
                                                         + ov)),
                   sr[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              aqn[u] = fmaf(qr[u][e], npv[k0 + c + e], aqn[u]);
#pragma unroll
              for (int w = 0; w < 4; ++w) aqs[u][w] = fmaf(qr[u][e], sr[e][w], aqs[u][w]);
            }
        }
      }
      __syncthreads();
    }

    // 3. P = q k^T (.) A on the lower triangle, into M.
#pragma unroll
    for (int r = 0; r < MAX_TRI; ++r) {
      const int kk = tid + r * NTHREADS;
      if (kk < ntri) {
        int i0, j0;
        tri_tile(kk, i0, j0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          float out[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int j = j0 + w;
            out[w] = j <= i ? acc[r][u][w] * exp_of(bq[i] - bq[j] + igs[j] - mi[i]) : 0.f;
          }
          *reinterpret_cast<float4*>(M + i * LQ + j0) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    if (own && ov == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) aqnv[oi + u] = aqn[u];
    __syncthreads();
    // 4. den_i, g_i, dden_i.
    for (int i = tid; i < Q; i += NTHREADS) {
      double s = 0.0;
      for (int j = 0; j <= i; ++j) s += M[i * LQ + j];
      const float den = fmaf(isc[i], aqnv[i], static_cast<float>(s));
      const float floor_i = exp_of(-mi[i]);
      const float g = fmaxf(fabsf(den), floor_i);
      const bool in = i < qv;
      ginv[i] = in ? 1.f / g : 0.f;
      dden[i] = in && fabsf(den) > floor_i ? -copysignf(1.f, den) * dd[i] / g : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < Q * VB; e += NTHREADS) DN[e] *= ginv[e / VB];
    __syncthreads();
    // 5. dv_j = sum_{i>=j} P_ij dnum_i (own tile; the state's part comes in 8).
    float dva[4][4] = {};
    if (own) {
      for (int i = oi; i < qv; ++i) {
        float pr[4], nr[4];
        unpack(ld4(M + i * LQ + oi), pr);
        unpack(ld4(DN + i * VB + ov), nr);
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int v = 0; v < 4; ++v) dva[w][v] = fmaf(pr[w], nr[v], dva[w][v]);
      }
    }
    __syncthreads();
    // 6. G = P (.) dP in place, dP_ij = dnum_i . v_j (own columns) + dden_i (block 0).
    for (int kk = tid; kk < ntri; kk += NTHREADS) {
      int i0, j0;
      tri_tile(kk, i0, j0);
      float dp[4][4] = {};
      dot_tile(DN, i0, VB, Vs, j0, VB, VB, dp);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        const float extra = first ? dden[i] : 0.f;
        float pr[4];
        unpack(ld4(M + i * LQ + j0), pr);
        *reinterpret_cast<float4*>(M + i * LQ + j0) =
            make_float4(pr[0] * (dp[u][0] + extra), pr[1] * (dp[u][1] + extra),
                        pr[2] * (dp[u][2] + extra), pr[3] * (dp[u][3] + extra));
      }
    }
    __syncthreads();
    for (int r = tid; r < 2 * Q; r += NTHREADS) {
      double s = 0.0;
      if (r < Q) {
        for (int j = 0; j <= r; ++j) s += M[r * LQ + j];
        rowg[r] = static_cast<float>(s);
      } else {
        const int j = r - Q;
        for (int i = j; i < Q; ++i) s += M[i * LQ + j];
        colg[j] = static_cast<float>(s);
      }
    }
    __syncthreads();
    // 7. A (.) dP into M.
    for (int kk = tid; kk < ntri; kk += NTHREADS) {
      int i0, j0;
      tri_tile(kk, i0, j0);
      float dp[4][4] = {};
      dot_tile(DN, i0, VB, Vs, j0, VB, VB, dp);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        const float extra = first ? dden[i] : 0.f;
        float out[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          out[w] = j <= i ? exp_of(bq[i] - bq[j] + igs[j] - mi[i]) * (dp[u][w] + extra) : 0.f;
        }
        *reinterpret_cast<float4*>(M + i * LQ + j0) = make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // 8. Stream q and k again: dqq and dk partials, the state's part of dv,
    //    k . dn, <dS, S_p> + <dn, n_p>; then this tile's rows of dS and dn.
    float ys[4][4] = {};  // (dS^T k_j) on the own tile, over all key columns
    float kdn = 0.f;      // k_tid . dn (block 0)
    float tsum = 0.f;     // <dS, S_p> + <dn, n_p> (block 0), this thread's share
    for (int k0 = 0; k0 < D; k0 += KT) {
      for (int e = tid; e < Q * KT; e += NTHREADS) {
        const int j = e / KT;
        const int c = e - j * KT;
        float qx = 0.f, kx = 0.f;
        if (j < qv) {
          qx = to_f(__ldg(qg + (t0 + j) * p.qss + k0 + c)) / sqrt_d;
          kx = to_f(__ldg(kg + (t0 + j) * p.kss + k0 + c));
        }
        Qs[j * KP + c] = qx;
        Ks[j * KP + c] = kx;
      }
      __syncthreads();
      for (int kk = tid; kk < 2 * T4 * KT4; kk += NTHREADS) {
        const bool is_q = kk < T4 * KT4;
        const int k2 = is_q ? kk : kk - T4 * KT4;
        const int r0 = (k2 / KT4) * 4;
        const int cc = (k2 % KT4) * 4;
        float a[4][4] = {}, s2[4][4] = {};
        if (is_q) {
          // sum_{j<=i} (A dP)_ij k_j  and  S_p dnum_i over own value columns.
          for (int j = 0; j <= r0; j += 4) {
            float mr[4][4], kr[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              unpack(ld4(M + (r0 + u) * LQ + j), mr[u]);
              unpack(ld4(Ks + (j + u) * KP + cc), kr[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int w = 0; w < 4; ++w) a[u][w] = fmaf(mr[u][e], kr[e][w], a[u][w]);
          }
          for (int v = 0; v < VB; v += 4) {
            float nr[4][4], sr[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              unpack(ld4(DN + (r0 + u) * VB + v), nr[u]);
              unpack(__ldg(reinterpret_cast<const float4*>(
                         Spg + static_cast<int64_t>(k0 + cc + u) * D + v)),
                     sr[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int w = 0; w < 4; ++w)
#pragma unroll
                for (int e = 0; e < 4; ++e) s2[u][w] = fmaf(nr[u][e], sr[w][e], s2[u][w]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = r0 + u;
            if (i < qv) {
              const float si = isc[i];
              const float nd = first ? si * dden[i] : 0.f;
              float* row = dqg + (t0 + i) * row_stride + k0 + cc;
              *reinterpret_cast<float4*>(row) = make_float4(
                  fmaf(si, s2[u][0], fmaf(nd, npv[k0 + cc], a[u][0])),
                  fmaf(si, s2[u][1], fmaf(nd, npv[k0 + cc + 1], a[u][1])),
                  fmaf(si, s2[u][2], fmaf(nd, npv[k0 + cc + 2], a[u][2])),
                  fmaf(si, s2[u][3], fmaf(nd, npv[k0 + cc + 3], a[u][3])));
            }
          }
        } else {
          // sum_{i>=j} (A dP)_ij qq_i  and  dS v_j over own value columns.
          for (int i = r0; i < qv; i += 4) {
            float mr[4][4], qr[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              unpack(ld4(M + (i + u) * LQ + r0), mr[u]);
              unpack(ld4(Qs + (i + u) * KP + cc), qr[u]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int w = 0; w < 4; ++w)
#pragma unroll
                for (int u = 0; u < 4; ++u) a[w][u] = fmaf(mr[e][w], qr[e][u], a[w][u]);
          }
          for (int v = 0; v < VB; v += 4) {
            float vr[4][4], sr[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              unpack(ld4(Vs + (r0 + u) * VB + v), vr[u]);
              unpack(ld4(dS + (k0 + cc + u) * VB + v), sr[u]);
            }
#pragma unroll
            for (int w = 0; w < 4; ++w)
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) s2[w][u] = fmaf(vr[w][e], sr[u][e], s2[w][u]);
          }
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int j = r0 + w;
            if (j < qv) {
              const float cj = cw[j];
              float* row = dkg + (t0 + j) * row_stride + k0 + cc;
              float o[4];
#pragma unroll
              for (int u = 0; u < 4; ++u)
                o[u] = fmaf(cj, s2[w][u] + (first ? dnv[k0 + cc + u] : 0.f), a[w][u]);
              *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
            }
          }
        }
      }
      if (own) {
        // ys[w][v] += sum_c k_{oi+w}[c] dS[k0+c][ov+v]
        for (int c = 0; c < KT; c += 4) {
          float kr[4][4], sr[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unpack(ld4(Ks + (oi + u) * KP + c), kr[u]);
            unpack(ld4(dS + (k0 + c + u) * VB + ov), sr[u]);
          }
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int v = 0; v < 4; ++v) ys[w][v] = fmaf(kr[w][e], sr[e][v], ys[w][v]);
        }
      }
      if (first && tid < Q)
        for (int c = 0; c < KT; ++c) kdn = fmaf(Ks[tid * KP + c], dnv[k0 + c], kdn);
      for (int e = tid; e < KT * VB; e += NTHREADS) {
        const int c = e / VB;
        const int v = e - c * VB;
        tsum = fmaf(dS[(k0 + c) * VB + v], __ldg(Spg + static_cast<int64_t>(k0 + c) * D + v), tsum);
      }
      if (first)
        for (int c = tid; c < KT; c += NTHREADS) tsum = fmaf(dnv[k0 + c], npv[k0 + c], tsum);
      __syncthreads();
      // dS rows k0..k0+KT <- so dS + sum_i s_i qq_i dnum_i^T; dn alike.
      for (int e = tid; e < KT * V4; e += NTHREADS) {
        const int c = e / V4;
        const int v0 = (e - c * V4) * 4;
        float* srow = dS + (k0 + c) * VB + v0;
        float s[4];
        unpack(ld4(srow), s);
#pragma unroll
        for (int w = 0; w < 4; ++w) s[w] *= so;
        for (int i = 0; i < qv; ++i) {
          const float qc = Qs[i * KP + c] * isc[i];
          float nr[4];
          unpack(ld4(DN + i * VB + v0), nr);
#pragma unroll
          for (int w = 0; w < 4; ++w) s[w] = fmaf(qc, nr[w], s[w]);
        }
        *reinterpret_cast<float4*>(srow) = make_float4(s[0], s[1], s[2], s[3]);
      }
      for (int c = tid; c < KT; c += NTHREADS) {
        float s = dnv[k0 + c] * so;
        for (int i = 0; i < qv; ++i) s = fmaf(Qs[i * KP + c] * isc[i], dden[i], s);
        dnv[k0 + c] = s;
      }
      __syncthreads();
    }

    // 9. dv (own tile, written whole), and the per-row partial sums.
    if (own) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = oi + w;
        const float cj = cw[j];
        float vr[4], nr[4];
        unpack(ld4(Vs + j * VB + ov), vr);
        unpack(ld4(DN + j * VB + ov), nr);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s1 = fmaf(ys[w][v], vr[v], s1);
          s2 = fmaf(aqs[w][v], nr[v], s2);
        }
        part1[j * V4 + ov / 4] = s1;
        part2[j * V4 + ov / 4] = s2;
        if (j < qv) {
          T* row = dvg + (t0 + j) * row_stride + ov;
#pragma unroll
          for (int v = 0; v < 4; ++v) row[v] = from_f<T>(fmaf(cj, ys[w][v], dva[w][v]));
        }
      }
    }
    red[tid] = tsum;
    __syncthreads();
    for (int off = NTHREADS / 2; off > 0; off >>= 1) {
      if (tid < off) red[tid] += red[tid + off];
      __syncthreads();
    }
    for (int i = tid; i < Q; i += NTHREADS) {
      double s1 = 0.0, s2 = 0.0;
      for (int t = 0; t < V4; ++t) {
        s1 += part1[i * V4 + t];
        s2 += part2[i * V4 + t];
      }
      const float dw = cw[i] * static_cast<float>(s1 + (first ? kdn : 0.f));
      const float binter = isc[i] * static_cast<float>(s2 + (first ? aqnv[i] * dden[i] : 0.f));
      dwv[i] = i < qv ? dw : 0.f;
      const float db = static_cast<float>(static_cast<double>(rowg[i]) - colg[i] + binter - dw);
      dbf[i] = db;
      if (i < qv) {
        digg[(t0 + i) * p.H] = colg[i] + dw;
        if (i != qv - 1) dbg[(t0 + i) * p.H] = db;
      }
    }
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int i = 0; i < Q; ++i) s += dwv[i];
      dbg[(t0 + qv - 1) * p.H] = static_cast<float>(dbf[qv - 1] + s + static_cast<double>(so) *
                                                    red[0]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launches 3 and 4: sums over the column blocks.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    mlstm_bwd_reduce_qk(const float* dqp, const float* dkp, T* dq, T* dk, int64_t n, int ncb,
                        float inv_sqrt_d) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (idx >= 2 * n) return;
  const bool is_k = idx >= n;
  const int64_t e = is_k ? idx - n : idx;
  const float* src = (is_k ? dkp : dqp) + e;
  double s = 0.0;
  for (int c = 0; c < ncb; ++c) s += src[c * n];
  if (is_k)
    dk[e] = from_f<T>(static_cast<float>(s));
  else
    dq[e] = from_f<T>(static_cast<float>(s * inv_sqrt_d));
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    mlstm_bwd_reduce_gates(const float* dbp, const float* digp, const void* fg, T* dig, T* df,
                           int B, int L, int H, int Q, int nc, int ncb, int64_t fsb,
                           int64_t fss, int64_t fsh) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * H * nc) return;
  const int ch = static_cast<int>(idx % nc);
  const int h = static_cast<int>((idx / nc) % H);
  const int b = static_cast<int>(idx / (static_cast<int64_t>(nc) * H));
  const int64_t n = static_cast<int64_t>(B) * L * H;
  const T* fgp = static_cast<const T*>(fg) + b * fsb + h * fsh;
  const int t0 = ch * Q;
  const int t1 = min(L, t0 + Q);
  double run = 0.0;
  for (int t = t1 - 1; t >= t0; --t) {
    const int64_t e = (static_cast<int64_t>(b) * L + t) * H + h;
    double db = 0.0, dg = 0.0;
    for (int c = 0; c < ncb; ++c) {
      db += dbp[c * n + e];
      dg += digp[c * n + e];
    }
    run += db;
    const float f = to_f(fgp[t * fss]);
    dig[e] = from_f<T>(static_cast<float>(dg));
    df[e] = from_f<T>(static_cast<float>(run) / (1.f + expf(f)));  // dlogf sigmoid(-f)
  }
}

struct Scratch {
  int64_t Sp, np, mp, ddp, dqp, dkp, dbp, digp, total;  // offsets in floats
  Scratch(int B, int L, int H, int D, int Q) {
    const int64_t nc = (L + Q - 1) / Q;
    const int64_t ncb = D / (D < COLS ? D : COLS);
    const int64_t bsh = static_cast<int64_t>(B) * L * H;
    Sp = 0;
    np = Sp + B * nc * H * D * D;
    mp = np + B * nc * H * D;
    ddp = mp + ((B * nc * H + 3) / 4) * 4;
    dqp = ddp + ((ncb * bsh + 3) / 4) * 4;
    dkp = dqp + ncb * bsh * D;
    dbp = dkp + ncb * bsh * D;
    digp = dbp + ncb * bsh;
    total = digp + ncb * bsh;
  }
};

template <typename T>
cudaError_t launch(const Params& p, void* dq, void* dk, void* dig, void* df,
                   cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(mlstm_bwd_states<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ST_MAX_BYTES));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mlstm_bwd_main<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(MAX_BYTES));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int VB = Layout(p.Q, p.D).VB;
  const dim3 grid(p.D / VB, p.H, p.B);
  mlstm_bwd_states<T><<<grid, NTHREADS, sizeof(float) * StLayout(p.Q, p.D).total, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_main<T><<<grid, NTHREADS, sizeof(float) * Layout(p.Q, p.D).total, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(p.B) * p.L * p.H * p.D;
  const int64_t blocks = (2 * n + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 2147483647) return cudaErrorInvalidValue;
  mlstm_bwd_reduce_qk<T><<<static_cast<unsigned>(blocks), RED_THREADS, 0, stream>>>(
      p.dqp, p.dkp, static_cast<T*>(dq), static_cast<T*>(dk), n, p.D / VB, 1.f / p.sqrt_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t g = static_cast<int64_t>(p.B) * p.H * p.nc;
  mlstm_bwd_reduce_gates<T><<<static_cast<unsigned>((g + RED_THREADS - 1) / RED_THREADS),
                              RED_THREADS, 0, stream>>>(
      p.dbp, p.digp, p.fg, static_cast<T*>(dig), static_cast<T*>(df), p.B, p.L, p.H, p.Q, p.nc,
      p.D / VB, p.fsb, p.fss, p.fsh);
  return cudaGetLastError();
}

bool head_dim_ok(int D) {
  return D >= 4 && D % 4 == 0 && (D <= COLS || (D % COLS == 0 && D <= MAX_D));
}

}  // namespace

// Bytes of dynamic shared memory a block of the main kernel takes.
extern "C" int mlstm_scan_bwd_smem_bytes(int Q, int D) {
  return static_cast<int>(sizeof(float) * Layout(Q, D).total);
}

// Bytes of fp32 device scratch a call takes.
extern "C" int64_t mlstm_scan_bwd_scratch_bytes(int B, int L, int H, int D, int Q) {
  return static_cast<int64_t>(sizeof(float)) * Scratch(B, L, H, D, Q).total;
}

// dtype (of q, k, v, the gates, dh and every output): 0 = float32,
// 1 = bfloat16.  dq, dk, dv (B, L, H, D) and dig, df (B, L, H) are
// contiguous; scratch holds mlstm_scan_bwd_scratch_bytes bytes.  strides:
// 18 int64 (q, k, v, i_gate, f_gate, dh: batch, length, head each).
// Returns a cudaError_t (0 on success).
extern "C" int mlstm_scan_bwd(const void* q, const void* k, const void* v, const void* ig,
                              const void* fg, const void* dh, void* dq, void* dk, void* dv,
                              void* dig, void* df, void* scratch, int dtype, int B, int L, int H,
                              int D, int Q, const int64_t* strides, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 || !head_dim_ok(D) || Q < 4 ||
      Q > MAX_Q || Q % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc(B, L, H, D, Q);
  float* base = static_cast<float*>(scratch);
  const int64_t* s = strides;
  const Params p{q, k, v, ig, fg, dh, dv,
                 base + sc.Sp, base + sc.np, base + sc.mp, base + sc.ddp, base + sc.dqp,
                 base + sc.dkp, base + sc.dbp, base + sc.digp,
                 B, L, H, D, Q, (L + Q - 1) / Q, sqrtf(static_cast<float>(D)),
                 s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                 s[12], s[13], s[14], s[15], s[16], s[17]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(p, dq, dk, dig, df, st); break;
    case 1: err = launch<__nv_bfloat16>(p, dq, dk, dig, df, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
