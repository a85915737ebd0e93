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
// Two paths, chosen by dtype alone in mlstm_scan_bwd, every launch on the
// caller's stream, sharing one fp32 scratch that the wrapper allocates (its
// size query takes no dtype: it gives the larger path's need):
//   fp32: mlstm_bwd_states, mlstm_bwd_main, mlstm_bwd_reduce_qk,
//         mlstm_bwd_reduce_gates, scalar fp32 FMAs (they hold the fp32
//         gates, elementwise against the fp64 gradient at C2's shapes);
//   bf16: mlstm_bwd_states_bf16, mlstm_bwd_chunk_bf16,
//         mlstm_bwd_dstates_bf16, mlstm_bwd_out_bf16, mlstm_bwd_gates_bf16,
//         every product an mma.sync m16n8k16 on bf16 operands with fp32
//         accumulators (mma_bf16.cuh).
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
//
// The scalar design (fp32; it ran bf16 too until the tensor-core kernels).
//   1. mlstm_bwd_states: the forward's scalar kernel (csrc/mlstm.cu) run
//      again, writing instead of h the states before each chunk, S_p
//      (B, nc, H, D, D), n_p (B, nc, H, D) and m_prev (B, nc, H) (75.5 MB at
//      the train shape; recomputed rather than saved by the forward, whose
//      kernel and C interface stay as they are), and each column block's
//      share of dh_i . h_i (ncb, B, S, H).
//   2. mlstm_bwd_main: dS (576 KB in fp32 at D 384; a block may have 227 KB)
//      split over blocks of VB = 32 value columns, as in the forward: block
//      (vb, h, b) owns dS[:, v0:v0+VB] and walks the chunks backward.
//      Everything that needs a full value row (dP, hence G, dqq, dk) it
//      computes over its own columns only, as an fp32 partial; the terms in
//      dden and dn, which need no value column, only block 0 adds.  dv it
//      writes whole.  It recomputes q k^T, streaming q and k 32 columns at
//      a time.
//   3. mlstm_bwd_reduce_qk: dq and dk, the partials summed over the column
//      blocks in a fixed order.
//   4. mlstm_bwd_reduce_gates: dig, and db reverse-summed within each chunk
//      into dlogf, then df; one thread a (b, h, chunk).
// The main kernel: 256 threads a (column block, h, b), a loop over the
// chunks inside (the TPU's sequential axis; Hopper blocks run in no
// order).  Shared memory holds dS[:, cols], one Q x Q matrix M [Q][Q+4] (in
// turn P, G and A dP, on the 4 x 4 tiles on or below the diagonal), v and
// dnum of its columns [Q][VB], q and k tiles [Q][36], dn and n_p and the
// per-row vectors: 206,352 bytes at Q 128, D 384, one block an SM.  A
// thread owns 4 x 4 register tiles; every inner dimension is walked 4 wide
// with float4 loads.  The short sums that cancel (row and column sums of
// Q x Q matrices, the partials across column blocks, the reverse cumsum of
// db) run in fp64, in a fixed order.  The gate math (b, the stabilisers)
// runs in fp64 (gate_math) and every exponent b_i - b_j + ig_j - m_i (and
// those of s_i, c_j and the state's decay) is formed in fp64 and rounded
// once before expf: an fp32 b, down to ~-50 over a chunk of 128, carried an
// absolute error of ~1e-5 into them, which put single entries of dk 1.15x
// past err / (1e-4 + 1e-4 |exact|) <= 1 against the fp64 gradient at D 384,
// chunk 128, where the sequential plain version stays under 0.12 (ROADMAP
// C2).  m' is rounded to fp32 before the exponents that use it, as the
// states scratch keeps it, so the state stays exactly stabilised by the
// value the next chunk reads.  At the train shape in bf16 these four took
// 12.7 ms, 380x the bound, by launch 3.50 / 8.87 / 0.21 / 0.20 ms
// (scripts/mlstm_bwd_split.py --old on this file's earlier version, H100
// 80GB HBM3 at 700 W).
//
// The bf16 design, against the five things that held the scalar kernels
// back at bf16:
//   (a) every product a scalar fp32 FMA: every product here is an mma;
//   (b) the states launch was the forward's scalar kernel run again: launch
//       1 carries S and n alone on the tensor cores (the update is one
//       product a chunk, (cw (.) k)^T v), and h moves to launch 2;
//   (c) q k^T recomputed by every value-column block, twice: launch 2 forms
//       P = q k^T (.) A once per (b, h, chunk), over all D;
//   (d) dP, G and everything after them were partials over 32 value
//       columns, dq and dk 12 fp32 partials of 25.2 MB each: launch 2 forms
//       dP = dh v^T / g + dden over all D once, and launch 4 tiles dq, dk
//       and dv over their output columns, each block owning its columns
//       whole, so none of them has partials;
//   (e) one block of 8 warps an SM walking 4 chunks in order: launches 2
//       and 4 are chunk-parallel (128 and 768 blocks of 16 warps at the
//       train shape); only the two sweeps walk the chunks, 384 blocks of 8
//       warps, two an SM.
// Launches (grids at the train shape):
//   1. mlstm_bwd_states_bf16 (D / 32, H, B): the states before each chunk,
//      S_p, n_p and m_prev, to the scratch (state_sweep below).
//   2. mlstm_bwd_chunk_bf16 (chunks, H, B): per chunk, P, q . n_p, den and
//      g; per group of 64 value columns, h = (s q S_p / sqrt(D) + P v) / g
//      in fp32 accumulators, dh . h and dh . (q S_p); dh v^T over all D;
//      then dden, dP, G's row and column sums and the inter-chunk term of
//      db into the chunk's record, and A (.) dP / sqrt(D) and P / g as bf16.
//   3. mlstm_bwd_dstates_bf16 (D / 32, H, B): dS and dn after each chunk,
//      carried backward, dS <- so dS + (s / g (.) qq)^T dh, to the scratch
//      (75.5 MB, as S_p), and <dS, S_p> over its columns.
//   4. mlstm_bwd_out_bf16 (chunks x D / 64, H, B): dq, dk, dv of a (chunk,
//      64-column tile), whole, and k_j . (dS v_j + dn) over the tile.
//   5. mlstm_bwd_gates_bf16: dw, dtot, the reverse cumsum of db, d i_gate
//      and d f_gate, one warp a chunk, all in fp64.
// Rounding.  q, k, v and dh are bf16 already; of the computed operands, S_p
// (in q S_p and dh S_p^T), P (in P v), s / g (.) qq (in the dS update) and
// dS (in v dS^T and k dS) are split into hi + lo (two mma into one
// accumulator, ~2^-16 of the value); cw (.) k, A (.) dP / sqrt(D) and P / g
// are rounded once.  dh . h takes h in fp32; the gate math and the sums
// that cancel are the scalar path's, in fp64.  A CPU emulation of exactly
// this arithmetic (tests/test_torch_mlstm.py::emulate_bwd) holds every
// gradient within a relative rms of 2e-2 of the fp32 plain version, and
// puts one past it wherever any of the four splits is rounded once instead
// (at gates of +-20: 0.52-4.6).  S_p and dS stay fp32 in the scratch; the
// kernels that read them split them as they stage them.
// Staging.  bf16 tiles come by 16-byte cp.async where rows are whole
// 16-byte units (else element by element), fp32 ones four float4 loads a
// thread before any is stored, so their latencies overlap; every tile row
// is padded by 8 elements, so ldmatrix's 8 row addresses fall in distinct
// banks.  Shared memory at Q 128, D 384: launches 1 and 3 87,088 bytes,
// launch 2 227,344, launch 4 214,528 (mlstm_scan_bwd_tc_smem_bytes).
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

#include <initializer_list>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16: five tensor-core launches (mma.sync m16n8k16, bf16 operands, fp32
// accumulators; helpers in mma_bf16.cuh).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 16;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int SW_WARPS = 8;         // the sweeps: two blocks an SM
constexpr int SW_THREADS = SW_WARPS * 32;
constexpr int KC = 128;             // key columns staged at once (8 m16 tiles of the state)
constexpr int MAX_KC = MAX_D / KC;  // key chunks of the state a warp carries
constexpr int MAX_TRI16 = 3;        // 16 x 16 tiles of the lower triangle a warp owns: ceil(36 / 16)
constexpr int GATE_WARPS = 4;       // mlstm_bwd_gates_bf16: one warp a (b, h, chunk)
constexpr int SMEM_LIMIT = 232448;  // 227 KB, a block's most

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
// Width of the column tiles (a block's value columns in the sweeps, an
// output tile, a value group): 16 where D <= 16, else 32.
__host__ __device__ constexpr int tile_w(int D) { return D <= 16 ? 16 : 32; }
__host__ __device__ constexpr int n_tiles(int D) { return (D + tile_w(D) - 1) / tile_w(D); }
// Width of launch 4's output tiles: 64 where D is a multiple of 64.
__host__ __device__ constexpr int out_w(int D) { return D % 64 == 0 ? 64 : tile_w(D); }
// A chunk's record in the scratch, in floats: s_i, c_j, 1/g_i, dden_i, the
// chunk's share of db_i and of d i_gate_i (QP each), then the old state's scale.
__host__ __device__ constexpr int rec_floats(int QP) { return 6 * QP + 4; }

struct TcParams {
  const bf16 *q, *k, *v, *ig, *fg, *dh;
  bf16 *dq, *dk, *dv, *dig, *df;
  float *Sp, *np, *mp, *dS, *dn, *rec, *tdp, *dwp;
  bf16* mats;       // per (b, h, chunk): A (.) dP / sqrt(D), then P / g, [QP][QP] bf16 each
  int B, L, H, D, Q, nc, QP, W, nt, W4, nt4, nst;
  float inv_sqrt_d;
  int vec16;        // q, k, v, dh rows in whole 16-byte units, 16-byte aligned
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int64_t isb, iss, ish, fsb, fss, fsh, dsb, dss, dsh;
};

// The bf16 path's scratch, offsets in floats (every one a multiple of 4).
struct TcScratch {
  int64_t Sp, np, mp, dS, dn, rec, tdp, dwp, mats, total;
  TcScratch(int B, int L, int H, int D, int Q) {
    const int64_t nc = (L + Q - 1) / Q;
    const int64_t n = static_cast<int64_t>(B) * nc * H;
    const int64_t QP = round16(Q);
    const int64_t nt = n_tiles(D);
    Sp = 0;                            // (B, nc, H, D, D) state before each chunk
    np = Sp + n * D * D;               // (B, nc, H, D)
    mp = np + n * D;                   // (B, nc, H) stabiliser before each chunk
    dS = mp + (n + 3) / 4 * 4;         // (B, nc, H, D, D) cotangent of the state after it
    dn = dS + n * D * D;               // (B, nc, H, D)
    rec = dn + n * D;                  // (B, nc, H) records
    tdp = rec + n * rec_floats(QP);    // (nt, B, nc, H): <dS, S_p> over a block's columns
    dwp = tdp + (nt * n + 3) / 4 * 4;  // (nt, B, nc, H, QP): k_j . (dS v_j + dn) over a tile
    mats = dwp + nt * n * QP;          // (B, nc, H, 2, QP, QP) bf16
    total = mats + n * QP * QP;
  }
};

// Fragment loads.  lda: the A fragment (16 x 16 at rows m0, columns k0)
// of a row-major matrix; lda_t: of A = X^T with X row-major [k][m]; ldb:
// the B fragments of two n8 tiles (n0, n0 + 8; b[0..1] the first) of
// B = Y^T with Y row-major [n][k]; ldb_t: of B row-major [k][n].  ld in
// elements, a multiple of 8 and, as width + 8, conflict-free for ldmatrix.
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0,
                                    int lane) {
  mma::ldmatrix_x4(a, s + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0,
                                      int lane) {
  mma::ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                                (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void ldb(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0,
                                    int lane) {
  mma::ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                          (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0,
                                      int lane) {
  mma::ldmatrix_x4_trans(b, s + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}
// acc (two n8 tiles) += a b.
__device__ __forceinline__ void mma2(float (&acc)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma::mma_bf16(acc[0], a, b[0], b[1]);
  mma::mma_bf16(acc[1], a, b[2], b[3]);
}

// Row r, column c of accumulator element e of n8 tile nt in a warp's
// 16 x 16 tile.
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + ((e >> 1) << 3); }
__device__ __forceinline__ int frag_col(int lane, int nt, int e) {
  return nt * 8 + ((lane & 3) << 1) + (e & 1);
}

// Tile k of the lower triangle of 16 x 16 tiles, row-major: (row r, column j <= r).
__device__ __forceinline__ void tri16(int k, int& r, int& j) {
  int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  while (ti * (ti + 1) / 2 > k) --ti;
  r = ti;
  j = k - ti * (ti + 1) / 2;
}

// Rows [0, nrows) and columns [c0, c0 + W) of a bf16 matrix (row stride rs)
// into dst [nrows][W + 8]; rows >= qv and columns >= D are zeros.  By
// 16-byte cp.async where ``vec`` says the rows allow it (the caller waits
// with staged() before its barrier), else by plain loads.
__device__ __forceinline__ void stage_bf16(bf16* dst, int W, const bf16* src, int64_t rs, int qv,
                                           int nrows, int c0, int D, bool vec) {
  const int units = W / 8;
  for (int idx = threadIdx.x; idx < nrows * units; idx += blockDim.x) {
    const int r = idx / units;
    const int c = c0 + (idx - r * units) * 8;
    if (vec) {  // D % 8 == 0: a unit lies wholly inside D or wholly past it
      const bool ok = r < qv && c < D;
      mma::cp_async16(dst + r * (W + 8) + (c - c0), ok ? src + r * rs + c : src, ok);
      continue;
    }
    uint32_t w4[4] = {0u, 0u, 0u, 0u};
    if (r < qv) {
      const bf16* s = src + r * rs + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = c + 2 * e < D ? __bfloat16_as_ushort(s[2 * e]) : 0u;
        const uint32_t hi = c + 2 * e + 1 < D ? __bfloat16_as_ushort(s[2 * e + 1]) : 0u;
        w4[e] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + (c - c0)) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

// This thread's cp.async copies landed (then a barrier makes them the block's).
__device__ __forceinline__ void staged() {
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
}

// Rows [r0, r0 + nrows) and columns [c0, c0 + W) of an fp32 (D, D)
// row-major matrix (zeros past D) into bf16 hi and lo [nrows][W + 8].
// Loads go out STAGE_BATCH at a time before any store, so their latencies
// overlap.
constexpr int STAGE_BATCH = 4;
__device__ __forceinline__ void stage_split(bf16* hi, bf16* lo, int W, const float* src, int D,
                                            int r0, int nrows, int c0) {
  const int units = W / 4, total = nrows * units;
  for (int base = threadIdx.x; base < total; base += STAGE_BATCH * blockDim.x) {
    float4 x[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int idx = base + u * blockDim.x;
      const int r = idx / units;
      const int c = (idx - r * units) * 4;
      x[u] = idx < total && r0 + r < D && c0 + c < D
                 ? __ldcg(reinterpret_cast<const float4*>(
                       src + static_cast<int64_t>(r0 + r) * D + c0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= total) break;
      const int r = idx / units;
      const int c = (idx - r * units) * 4;
      uint32_t h0, l0, h1, l1;
      mma::split_bf16(x[u].x, x[u].y, h0, l0);
      mma::split_bf16(x[u].z, x[u].w, h1, l1);
      *reinterpret_cast<uint2*>(hi + r * (W + 8) + c) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(lo + r * (W + 8) + c) = make_uint2(l0, l1);
    }
  }
}

__device__ __forceinline__ float bf(const bf16* s) { return __bfloat162float(*s); }

// Shared memory of the two sweeps, in bytes.
struct SwLayout {
  int bq, mi, xh, xl, ys, wv, w2, igs, isc, cw, nv, red, npart, bytes;
  __host__ __device__ constexpr SwLayout(int QP, int W, int D)
      : bq(0), mi(8 * QP), xh(16 * QP),
        xl(16 * QP + 2 * QP * (KC + 8)),
        ys(16 * QP + 4 * QP * (KC + 8)),
        wv(16 * QP + 4 * QP * (KC + 8) + 2 * QP * (W + 8)),
        w2(wv + 4 * QP), igs(wv + 8 * QP), isc(wv + 12 * QP), cw(wv + 16 * QP),
        nv(wv + 20 * QP), red(wv + 20 * QP + 4 * round16(D)),
        npart(wv + 20 * QP + 4 * round16(D) + 4 * (SW_WARPS + 4)),
        bytes(wv + 20 * QP + 4 * round16(D) + 4 * (SW_WARPS + 4) + 4 * SW_WARPS * 32) {}
};

// Launches 1 and 3: a state (D x D) carried over the chunks in fp32
// accumulators, split by value columns: block (vblk, h, b) owns columns
// [v0, v0 + W), its 8 warps each a 16-row tile of every 128 key rows, all
// W columns (two blocks an SM, so one's loads overlap the other's
// products).  Per chunk it writes the state to the scratch, then
// adds X^T Y, X = w (.) R (the chunk's rows of k or q weighted per row,
// staged 128 key columns at a time as bf16, hi + lo where BACK), Y the
// chunk's rows of v or dh (own columns); it carries key rows [v0, v0 + W)
// of the vector alike, in fp32 from unrounded values:
//   forward (BACK false):  S  <- so S  + (cw (.) k)^T v,             n  <- so n  + sum_j cw_j k_j
//   backward (BACK true):  dS <- so dS + (s / g (.) qq)^T dh,         dn <- so dn + sum_i s_i dden_i qq_i
// Forward, it writes the state before each chunk (S_p, n_p, m_prev), with
// the gate math of the scalar kernel; backward, the cotangent of the state
// after each chunk (dS, dn), the weights from launch 2's records, and
// <dS, S_p> over its columns.
template <bool BACK, int NP>
__device__ __forceinline__ void state_sweep(const TcParams& p) {
  extern __shared__ __align__(16) unsigned char smem_sw[];
  const int QP = p.QP, W = p.W, D = p.D, DP = round16(D);
  const SwLayout L(QP, W, D);
  double* bq = reinterpret_cast<double*>(smem_sw + L.bq);
  double* mi = reinterpret_cast<double*>(smem_sw + L.mi);
  bf16* Xh = reinterpret_cast<bf16*>(smem_sw + L.xh);
  bf16* Xl = reinterpret_cast<bf16*>(smem_sw + L.xl);
  bf16* Ys = reinterpret_cast<bf16*>(smem_sw + L.ys);
  float* wv = reinterpret_cast<float*>(smem_sw + L.wv);
  float* w2 = reinterpret_cast<float*>(smem_sw + L.w2);
  float* igs = reinterpret_cast<float*>(smem_sw + L.igs);
  float* isc = reinterpret_cast<float*>(smem_sw + L.isc);
  float* cw = reinterpret_cast<float*>(smem_sw + L.cw);
  float* nv = reinterpret_cast<float*>(smem_sw + L.nv);
  float* red = reinterpret_cast<float*>(smem_sw + L.red);
  float* scal = red + SW_WARPS;
  float* npart = reinterpret_cast<float*>(smem_sw + L.npart);  // [SW_WARPS][32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int v0 = vblk * W;
  const int mr = warp;  // and all W columns: NP pairs of n8 tiles
  const int nkc = (DP + KC - 1) / KC;
  const bf16* R = BACK ? p.q + b * p.qsb + h * p.qsh : p.k + b * p.ksb + h * p.ksh;
  const int64_t rs = BACK ? p.qss : p.kss;
  const bf16* Yg = BACK ? p.dh + b * p.dsb + h * p.dsh : p.v + b * p.vsb + h * p.vsh;
  const int64_t ys = BACK ? p.dss : p.vss;
  const bf16* ig_g = p.ig + b * p.isb + h * p.ish;
  const bf16* fg_g = p.fg + b * p.fsb + h * p.fsh;
  float* out = BACK ? p.dS : p.Sp;
  float* nout = BACK ? p.dn : p.np;

  float acc[MAX_KC][NP][2][4];
#pragma unroll
  for (int pk = 0; pk < MAX_KC; ++pk)
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pk][pr][nt][e] = 0.f;
  for (int i = tid; i < DP; i += SW_THREADS) nv[i] = 0.f;
  float m_prev = -INFINITY;  // forward: warp 0 keeps it

  for (int step = 0; step < p.nc; ++step) {
    const int ch = BACK ? p.nc - 1 - step : step;
    const int t0 = ch * p.Q;
    const int qv = min(p.Q, p.L - t0);
    const int64_t st = (static_cast<int64_t>(b) * p.nc + ch) * p.H + h;
    __syncthreads();  // the last chunk is done with the weights and Y
    if (BACK) {
      const float* rec = p.rec + st * rec_floats(QP);
      for (int i = tid; i < QP; i += SW_THREADS) {
        const float s = rec[i] * p.inv_sqrt_d;
        wv[i] = s * rec[2 * QP + i];
        w2[i] = s * rec[3 * QP + i];
      }
      if (tid == 0) scal[0] = rec[6 * QP];
    } else if (warp == 0) {
      const float m = gate_math<bf16>(ig_g, fg_g, p.iss, p.fss, t0, qv, p.Q, m_prev, bq, igs, mi,
                                      isc, cw, scal, lane);
      if (vblk == 0 && lane == 0) p.mp[st] = m_prev;
      m_prev = m;
    }
    stage_bf16(Ys, W, Yg + t0 * ys, ys, qv, QP, v0, D, p.vec16);
    staged();
    __syncthreads();
    if (!BACK) {
      for (int i = tid; i < QP; i += SW_THREADS) wv[i] = w2[i] = i < p.Q ? cw[i] : 0.f;
      __syncthreads();
    }
    const float so = scal[0];
    {  // the vector's key rows [v0, v0 + W): each warp sums the chunk's rows
       // j = warp mod 16, then one thread a key row the warps' sums in order
      const int dl = lane, d = v0 + lane;
      float s = 0.f;
      if (dl < W && d < D) {
#pragma unroll 4
        for (int j = warp; j < qv; j += SW_WARPS)
          s = fmaf(w2[j], __bfloat162float(R[(t0 + j) * rs + d]), s);
      }
      npart[warp * 32 + dl] = s;
      __syncthreads();
      if (tid < W && v0 + tid < D) {
        nout[st * D + v0 + tid] = nv[tid];
        float t = nv[tid] * so;
        for (int w = 0; w < SW_WARPS; ++w) t += npart[w * 32 + tid];
        nv[tid] = t;
      }
    }
    float* og = out + st * D * D;
    const float* spg = p.Sp + st * D * D;
    float tsum = 0.f;  // backward: this thread's share of <dS, S_p>
#pragma unroll
    for (int pk = 0; pk < MAX_KC; ++pk) {
      if (pk >= nkc) break;
      const int d0 = pk * KC;
      // X = w (.) R[:, d0:d0+KC] as bf16 (hi + lo backward), a 16-byte unit a
      // thread, STAGE_BATCH units loaded before any is stored.
      const int units = QP * (KC / 8);
      for (int base = tid; base < units; base += STAGE_BATCH * SW_THREADS) {
        uint32_t raw[STAGE_BATCH][4];
#pragma unroll
        for (int u = 0; u < STAGE_BATCH; ++u) {
          const int idx = base + u * SW_THREADS;
          const int r = idx >> 4;
          const int c = d0 + ((idx & 15) << 3);
          raw[u][0] = raw[u][1] = raw[u][2] = raw[u][3] = 0u;
          if (idx < units && r < qv && c < D) {
            const bf16* s = R + (t0 + r) * rs + c;
            if (p.vec16) {
              const uint4 v4 = __ldg(reinterpret_cast<const uint4*>(s));
              raw[u][0] = v4.x;
              raw[u][1] = v4.y;
              raw[u][2] = v4.z;
              raw[u][3] = v4.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const uint32_t lo = c + 2 * e < D ? __bfloat16_as_ushort(s[2 * e]) : 0u;
                const uint32_t hi = c + 2 * e + 1 < D ? __bfloat16_as_ushort(s[2 * e + 1]) : 0u;
                raw[u][e] = lo | (hi << 16);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < STAGE_BATCH; ++u) {
          const int idx = base + u * SW_THREADS;
          if (idx >= units) break;
          const int r = idx >> 4;
          const float w = wv[r];
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = mma::unpack_bf16(raw[u][e]);
            mma::split_bf16(w * f.x, w * f.y, hi[e], lo[e]);
          }
          const int o = r * (KC + 8) + ((idx & 15) << 3);
          *reinterpret_cast<uint4*>(Xh + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          if (BACK) *reinterpret_cast<uint4*>(Xl + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      __syncthreads();
      const int row0 = d0 + 16 * mr;
      if (row0 < DP) {
        float2 sp[NP][2][2];  // backward: S_p at this thread's entries, all loads first
#pragma unroll
        for (int pr = 0; pr < NP; ++pr)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = row0 + (lane >> 2) + 8 * hf;
              const int col = v0 + 16 * pr + frag_col(lane, nt, 0);
              sp[pr][nt][hf] = BACK && row < D && col < D
                                   ? __ldcg(reinterpret_cast<const float2*>(
                                         spg + static_cast<int64_t>(row) * D + col))
                                   : make_float2(0.f, 0.f);
            }
#pragma unroll
        for (int pr = 0; pr < NP; ++pr)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = row0 + (lane >> 2) + 8 * hf;
              const int col = v0 + 16 * pr + frag_col(lane, nt, 0);
              float* a = acc[pk][pr][nt];
              if (row < D && col < D) {
                const int64_t o = static_cast<int64_t>(row) * D + col;
                *reinterpret_cast<float2*>(og + o) = make_float2(a[2 * hf], a[2 * hf + 1]);
                tsum = fmaf(a[2 * hf], sp[pr][nt][hf].x, fmaf(a[2 * hf + 1], sp[pr][nt][hf].y, tsum));
              }
              a[2 * hf] *= so;
              a[2 * hf + 1] *= so;
            }
        for (int jt = 0; jt * 16 < qv; ++jt) {
          uint32_t a[4], al[4];
          lda_t(a, Xh, KC + 8, 16 * mr, 16 * jt, lane);
          if (BACK) lda_t(al, Xl, KC + 8, 16 * mr, 16 * jt, lane);
#pragma unroll
          for (int pr = 0; pr < NP; ++pr) {
            uint32_t bb[4];
            ldb_t(bb, Ys, W + 8, 16 * jt, 16 * pr, lane);
            mma2(acc[pk][pr], a, bb);
            if (BACK) mma2(acc[pk][pr], al, bb);
          }
        }
      }
      __syncthreads();
    }
    if (BACK) {  // <dS, S_p> over this block's columns, in a fixed order
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
      if (lane == 0) red[warp] = tsum;
      __syncthreads();
      if (tid == 0) {
        double s = 0.0;
        for (int w = 0; w < SW_WARPS; ++w) s += red[w];
        p.tdp[vblk * static_cast<int64_t>(p.nst) + st] = static_cast<float>(s);
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(SW_THREADS, 2) mlstm_bwd_states_bf16(const TcParams p) {
  state_sweep<false, NP>(p);
}

template <int NP>
__global__ void __launch_bounds__(SW_THREADS, 2) mlstm_bwd_dstates_bf16(const TcParams p) {
  state_sweep<true, NP>(p);
}

// Shared memory of launch 2, in bytes.
struct ChLayout {
  int bq, mi, qs, ks, dhs, vs, sph, spl, ph, pl, igs, isc, cw, qn, den, flo, ginv, dden, npv,
      rowt, colt, xh, ddh, scal, bytes;
  __host__ __device__ constexpr ChLayout(int QP, int W, int D)
      : bq(0), mi(8 * QP), qs(16 * QP),
        ks(16 * QP + 2 * QP * (KC + 8)),
        dhs(16 * QP + 4 * QP * (KC + 8)),
        vs(dhs + 2 * QP * (W + 8)),
        sph(dhs + 4 * QP * (W + 8)),
        spl(sph + 2 * KC * (W + 8)),
        ph(sph + 4 * KC * (W + 8)),
        pl(ph + 2 * QP * (QP + 8)),
        igs(ph + 4 * QP * (QP + 8)),
        isc(igs + 4 * QP), cw(igs + 8 * QP), qn(igs + 12 * QP), den(igs + 16 * QP),
        flo(igs + 20 * QP), ginv(igs + 24 * QP), dden(igs + 28 * QP), npv(igs + 32 * QP),
        rowt(npv + 4 * round16(D)),
        colt(rowt + 4 * 16 * (QP / 16) * (QP / 16 + 1) / 2),
        xh(colt + 4 * 16 * (QP / 16) * (QP / 16 + 1) / 2),
        ddh(xh + 8 * QP), scal(xh + 16 * QP), bytes(xh + 16 * QP + 16) {}
};

// Launch 2, grid (chunks, H, B), 16 warps: one (b, h, chunk), all of it
// chunk-parallel.  P = q k^T / sqrt(D) (.) A once over all D (each warp up
// to 3 16 x 16 tiles of the lower triangle), its row sums, and P to shared
// memory as bf16 hi + lo; q . n_p, den and g; then, per group of W = out_w(D)
// value columns (a warp: 16 rows, 16 NP columns), h in fp32 accumulators
// (q S_p over 128 key columns at a time with S_p split hi + lo, scaled by
// s_i / sqrt(D), plus P v), dh . h and dh . (q S_p) as row partials, and
// dh v^T added into the triangle's registers; then dden, dP = dh v^T / g +
// dden and G = P (.) dP (P read back as hi + lo), whose row and column sums
// (and the inter-chunk term of db) go to the chunk's record, and A (.) dP /
// sqrt(D) and P / g to the scratch as bf16 for launch 4.
template <int NP>
__global__ void __launch_bounds__(TC_THREADS, 1) mlstm_bwd_chunk_bf16(const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_ch[];
  const int QP = p.QP, W = p.W4, D = p.D, DP = round16(D), QT = QP / 16;
  const ChLayout L(QP, W, D);
  double* bq = reinterpret_cast<double*>(smem_ch + L.bq);
  double* mi = reinterpret_cast<double*>(smem_ch + L.mi);
  bf16* Qs = reinterpret_cast<bf16*>(smem_ch + L.qs);
  bf16* Ks = reinterpret_cast<bf16*>(smem_ch + L.ks);
  bf16* dHs = reinterpret_cast<bf16*>(smem_ch + L.dhs);
  bf16* Vs = reinterpret_cast<bf16*>(smem_ch + L.vs);
  bf16* Sph = reinterpret_cast<bf16*>(smem_ch + L.sph);
  bf16* Spl = reinterpret_cast<bf16*>(smem_ch + L.spl);
  bf16* Ph = reinterpret_cast<bf16*>(smem_ch + L.ph);
  bf16* Pl = reinterpret_cast<bf16*>(smem_ch + L.pl);
  float* igs = reinterpret_cast<float*>(smem_ch + L.igs);
  float* isc = reinterpret_cast<float*>(smem_ch + L.isc);
  float* cw = reinterpret_cast<float*>(smem_ch + L.cw);
  float* qn = reinterpret_cast<float*>(smem_ch + L.qn);
  float* den = reinterpret_cast<float*>(smem_ch + L.den);
  float* flo = reinterpret_cast<float*>(smem_ch + L.flo);
  float* ginv = reinterpret_cast<float*>(smem_ch + L.ginv);
  float* dden = reinterpret_cast<float*>(smem_ch + L.dden);
  float* npv = reinterpret_cast<float*>(smem_ch + L.npv);
  float* rowt = reinterpret_cast<float*>(smem_ch + L.rowt);
  float* colt = reinterpret_cast<float*>(smem_ch + L.colt);
  float* xh = reinterpret_cast<float*>(smem_ch + L.xh);
  float* ddh = reinterpret_cast<float*>(smem_ch + L.ddh);
  float* scal = reinterpret_cast<float*>(smem_ch + L.scal);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = ch * p.Q;
  const int qv = min(p.Q, p.L - t0);
  const int64_t st = (static_cast<int64_t>(b) * p.nc + ch) * p.H + h;
  const float isd = p.inv_sqrt_d;
  const bf16* qg = p.q + b * p.qsb + h * p.qsh + t0 * p.qss;
  const bf16* kg = p.k + b * p.ksb + h * p.ksh + t0 * p.kss;
  const bf16* vg = p.v + b * p.vsb + h * p.vsh + t0 * p.vss;
  const bf16* dhg = p.dh + b * p.dsb + h * p.dsh + t0 * p.dss;
  const float* spg = p.Sp + st * D * D;
  float* rec = p.rec + st * rec_floats(QP);
  const int ntri = QT * (QT + 1) / 2;
  const int nkc = (DP + KC - 1) / KC;

  if (warp == 0)
    gate_math<bf16>(p.ig + b * p.isb + h * p.ish, p.fg + b * p.fsb + h * p.fsh, p.iss, p.fss, t0,
                    qv, p.Q, p.mp[st], bq, igs, mi, isc, cw, scal, lane);
  for (int i = tid; i < DP; i += TC_THREADS) npv[i] = i < D ? p.np[st * D + i] : 0.f;
  for (int i = tid; i < 2 * QP; i += TC_THREADS) xh[i] = ddh[i] = 0.f;
  __syncthreads();
  for (int i = p.Q + tid; i < QP; i += TC_THREADS) isc[i] = cw[i] = 0.f;

  int tr[MAX_TRI16], tj[MAX_TRI16];
#pragma unroll
  for (int u = 0; u < MAX_TRI16; ++u) tri16(warp + TC_WARPS * u, tr[u], tj[u]);
  float P[MAX_TRI16][2][4], DV[MAX_TRI16][2][4];  // q k^T then P (steps 1-2); dh v^T
#pragma unroll
  for (int u = 0; u < MAX_TRI16; ++u)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) P[u][nt][e] = DV[u][nt][e] = 0.f;

  // 1. q k^T on the triangle, and q . n_p (4 threads a row), 128 columns at a time.
  float qnp = 0.f;
  for (int kc = 0; kc < nkc; ++kc) {
    stage_bf16(Qs, KC, qg, p.qss, qv, QP, kc * KC, D, p.vec16);
    stage_bf16(Ks, KC, kg, p.kss, qv, QP, kc * KC, D, p.vec16);
    staged();
    __syncthreads();
    const int kw = min(KC, DP - kc * KC);
#pragma unroll
    for (int u = 0; u < MAX_TRI16; ++u) {
      if (warp + TC_WARPS * u >= ntri) break;
      for (int k0 = 0; k0 < kw; k0 += 16) {
        uint32_t a[4], bb[4];
        lda(a, Qs, KC + 8, 16 * tr[u], k0, lane);
        ldb(bb, Ks, KC + 8, 16 * tj[u], k0, lane);
        mma2(P[u], a, bb);
      }
    }
    {
      const int i = tid >> 2, part = tid & 3;
      if (i < QP)
        for (int c = part * (KC / 4); c < (part + 1) * (KC / 4); ++c)
          if (kc * KC + c < DP) qnp = fmaf(bf(Qs + i * (KC + 8) + c), npv[kc * KC + c], qnp);
    }
    __syncthreads();
  }
  qnp += __shfl_xor_sync(0xffffffffu, qnp, 1);
  qnp += __shfl_xor_sync(0xffffffffu, qnp, 2);
  if ((tid & 3) == 0 && (tid >> 2) < QP) qn[tid >> 2] = qnp * isd;

  // 2. P, its row sums by tile, and P as bf16 hi + lo.
#pragma unroll
  for (int u = 0; u < MAX_TRI16; ++u) {
    const int idx = warp + TC_WARPS * u;
    if (idx >= ntri) break;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * tr[u] + frag_row(lane, e);
        const int j = 16 * tj[u] + frag_col(lane, nt, e);
        P[u][nt][e] = j <= i && i < qv
                          ? P[u][nt][e] * isd * exp_of(bq[i] - bq[j] + igs[j] - mi[i])
                          : 0.f;
        rs[e >> 1] += P[u][nt][e];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, lo;
        mma::split_bf16(P[u][nt][2 * hf], P[u][nt][2 * hf + 1], hi, lo);
        const int o = (16 * tr[u] + (lane >> 2) + 8 * hf) * (QP + 8) + 16 * tj[u] +
                      frag_col(lane, nt, 0);
        *reinterpret_cast<uint32_t*>(Ph + o) = hi;
        *reinterpret_cast<uint32_t*>(Pl + o) = lo;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
    }
    if ((lane & 3) == 0) {
      rowt[idx * 16 + (lane >> 2)] = rs[0];
      rowt[idx * 16 + (lane >> 2) + 8] = rs[1];
    }
  }
  __syncthreads();
  for (int i = tid; i < QP; i += TC_THREADS) {
    const int r = i >> 4;
    double s = 0.0;
    for (int j = 0; j <= r; ++j) s += rowt[(r * (r + 1) / 2 + j) * 16 + (i & 15)];
    const float d = fmaf(isc[i], qn[i], static_cast<float>(s));
    const float fl = i < qv ? exp_of(-mi[i]) : 1.f;
    den[i] = d;
    flo[i] = fl;
    ginv[i] = i < qv ? 1.f / fmaxf(fabsf(d), fl) : 0.f;
  }
  __syncthreads();

  // 3. Per group of W value columns: h, dh . h, dh . (q S_p), dh v^T.
  const int mr = warp & 7, nh = warp >> 3;
  const int cb = 16 * NP * nh;  // this warp's first column in the group
  const bool act = mr < QT && cb < W;
  float xr[2] = {0.f, 0.f}, ddr[2] = {0.f, 0.f};
  for (int grp = 0; grp < p.nt4; ++grp) {
    const int c0 = grp * W;
    float acc[NP][2][4];
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        acc[pr][nt][0] = acc[pr][nt][1] = acc[pr][nt][2] = acc[pr][nt][3] = 0.f;
    for (int kc = 0; kc < nkc; ++kc) {
      stage_bf16(Qs, KC, qg, p.qss, qv, QP, kc * KC, D, p.vec16);
      stage_split(Sph, Spl, W, spg, D, kc * KC, KC, c0);
      staged();
      __syncthreads();
      if (act) {
        const int kw = min(KC, DP - kc * KC);
        for (int k0 = 0; k0 < kw; k0 += 16) {
          uint32_t a[4], bh[4], bl[4];
          lda(a, Qs, KC + 8, 16 * mr, k0, lane);
#pragma unroll
          for (int pr = 0; pr < NP; ++pr) {
            ldb_t(bh, Sph, W + 8, k0, cb + 16 * pr, lane);
            ldb_t(bl, Spl, W + 8, k0, cb + 16 * pr, lane);
            mma2(acc[pr], a, bh);
            mma2(acc[pr], a, bl);
          }
        }
      }
      __syncthreads();
    }
    stage_bf16(dHs, W, dhg, p.dss, qv, QP, c0, D, p.vec16);
    stage_bf16(Vs, W, vg, p.vss, qv, QP, c0, D, p.vec16);
    staged();
    __syncthreads();
    if (act) {
      float sc[2], gi[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mr + (lane >> 2) + 8 * hf;
        sc[hf] = isc[i] * isd;
        gi[hf] = ginv[i];
      }
#pragma unroll
      for (int pr = 0; pr < NP; ++pr)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dhx = bf(dHs + (16 * mr + frag_row(lane, e)) * (W + 8) + cb + 16 * pr +
                                 frag_col(lane, nt, e));
            xr[e >> 1] = fmaf(dhx, acc[pr][nt][e], xr[e >> 1]);
            acc[pr][nt][e] *= sc[e >> 1];
          }
      for (int jt = 0; jt <= mr; ++jt) {
        uint32_t ah[4], al[4], bb[4];
        lda(ah, Ph, QP + 8, 16 * mr, 16 * jt, lane);
        lda(al, Pl, QP + 8, 16 * mr, 16 * jt, lane);
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          ldb_t(bb, Vs, W + 8, 16 * jt, cb + 16 * pr, lane);
          mma2(acc[pr], ah, bb);
          mma2(acc[pr], al, bb);
        }
      }
#pragma unroll
      for (int pr = 0; pr < NP; ++pr)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dhx = bf(dHs + (16 * mr + frag_row(lane, e)) * (W + 8) + cb + 16 * pr +
                                 frag_col(lane, nt, e));
            ddr[e >> 1] = fmaf(dhx, acc[pr][nt][e] * gi[e >> 1], ddr[e >> 1]);
          }
    }
#pragma unroll
    for (int u = 0; u < MAX_TRI16; ++u) {
      if (warp + TC_WARPS * u >= ntri) break;
      for (int k0 = 0; k0 < W; k0 += 16) {
        uint32_t a[4], bb[4];
        lda(a, dHs, W + 8, 16 * tr[u], k0, lane);
        ldb(bb, Vs, W + 8, 16 * tj[u], k0, lane);
        mma2(DV[u], a, bb);
      }
    }
    __syncthreads();
  }

  // 4. dh . h and dh . (q S_p) summed over the two column halves; dden, db's inter term.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    xr[hf] += __shfl_xor_sync(0xffffffffu, xr[hf], 1);
    xr[hf] += __shfl_xor_sync(0xffffffffu, xr[hf], 2);
    ddr[hf] += __shfl_xor_sync(0xffffffffu, ddr[hf], 1);
    ddr[hf] += __shfl_xor_sync(0xffffffffu, ddr[hf], 2);
  }
  if (act && (lane & 3) == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * mr + (lane >> 2) + 8 * hf;
      xh[nh * QP + i] = xr[hf];
      ddh[nh * QP + i] = ddr[hf];
    }
  __syncthreads();
  for (int i = tid; i < QP; i += TC_THREADS) {
    const float dd = ddh[i] + ddh[QP + i];
    const float x = xh[i] + xh[QP + i];
    const float dn_i =
        i < qv && fabsf(den[i]) > flo[i] ? -copysignf(1.f, den[i]) * dd * ginv[i] : 0.f;
    dden[i] = dn_i;
    xh[i] = isc[i] * fmaf(ginv[i] * isd, x, qn[i] * dn_i);  // db's inter-chunk term
    rec[i] = isc[i];
    rec[QP + i] = cw[i];
    rec[2 * QP + i] = ginv[i];
    rec[3 * QP + i] = dn_i;
  }
  if (tid == 0) rec[6 * QP] = scal[0];
  __syncthreads();

  // 5. dP, G's row and column sums by tile; A (.) dP / sqrt(D) and P / g as bf16.
  bf16* Ad = p.mats + st * 2 * QP * QP;
  bf16* Pg = Ad + QP * QP;
  for (int e = tid; e < QP * QP / 2; e += TC_THREADS) {  // the tiles above the diagonal: zeros
    const int r = e / (QP / 2);
    const int c = 2 * (e - r * (QP / 2));
    if ((c >> 4) > (r >> 4)) {
      *reinterpret_cast<uint32_t*>(Ad + r * QP + c) = 0u;
      *reinterpret_cast<uint32_t*>(Pg + r * QP + c) = 0u;
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_TRI16; ++u) {
    const int idx = warp + TC_WARPS * u;
    if (idx >= ntri) break;
    float rs[2] = {0.f, 0.f};
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float ad[4], pg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * tr[u] + frag_row(lane, e);
        const int j = 16 * tj[u] + frag_col(lane, nt, e);
        const bool in = j <= i && i < qv;
        const int o = i * (QP + 8) + j;
        const float pv = __bfloat162float(Ph[o]) + __bfloat162float(Pl[o]);  // P, hi + lo
        const float dp = in ? fmaf(DV[u][nt][e], ginv[i], dden[i]) : 0.f;
        const float gv = pv * dp;
        rs[e >> 1] += gv;
        cs[nt][e & 1] += gv;
        ad[e] = in ? exp_of(bq[i] - bq[j] + igs[j] - mi[i]) * dp * isd : 0.f;
        pg[e] = pv * ginv[i];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (16 * tr[u] + (lane >> 2) + 8 * hf) * QP + 16 * tj[u] + frag_col(lane, nt, 0);
        *reinterpret_cast<uint32_t*>(Ad + o) = mma::pack_bf16(ad[2 * hf], ad[2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(Pg + o) = mma::pack_bf16(pg[2 * hf], pg[2 * hf + 1]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cs[nt][e] += __shfl_xor_sync(0xffffffffu, cs[nt][e], o);
    if ((lane & 3) == 0) {
      rowt[idx * 16 + (lane >> 2)] = rs[0];
      rowt[idx * 16 + (lane >> 2) + 8] = rs[1];
    }
    if (lane < 4)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        colt[idx * 16 + frag_col(lane, nt, 0)] = cs[nt][0];
        colt[idx * 16 + frag_col(lane, nt, 1)] = cs[nt][1];
      }
  }
  __syncthreads();
  for (int i = tid; i < QP; i += TC_THREADS) {
    const int r = i >> 4;
    double rg = 0.0, cg = 0.0;
    for (int j = 0; j <= r; ++j) rg += rowt[(r * (r + 1) / 2 + j) * 16 + (i & 15)];
    for (int k = r; k < QT; ++k) cg += colt[(k * (k + 1) / 2 + r) * 16 + (i & 15)];
    rec[4 * QP + i] = static_cast<float>(rg - cg + xh[i]);
    rec[5 * QP + i] = static_cast<float>(cg);
  }
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of launch 4, in bytes: the streamed tiles (dh, v, k
// [QP][KC + 8]; S_p and dS rows [W][KC + 8] hi + lo; dS columns [KC][W + 8]
// hi + lo), which A (.) dP / sqrt(D) and P / g [QP][QP + 8] and the output
// tile's k, q, dh [QP][W + 8] replace afterwards; then the vectors.
struct OutLayout {
  int dhs, vs, ks, sph, spl, dah, dal, dbh, dbl, ad, pg, kt, qt, dht, s, c, ginv, dden, npt,
      dnt, dwh, bytes;
  __host__ __device__ constexpr OutLayout(int QP, int W)
      : dhs(0), vs(2 * QP * (KC + 8)), ks(4 * QP * (KC + 8)),
        sph(6 * QP * (KC + 8)), spl(sph + 2 * W * (KC + 8)), dah(sph + 4 * W * (KC + 8)),
        dal(sph + 6 * W * (KC + 8)), dbh(sph + 8 * W * (KC + 8)),
        dbl(sph + 8 * W * (KC + 8) + 2 * KC * (W + 8)),
        ad(0), pg(2 * QP * (QP + 8)), kt(4 * QP * (QP + 8)),
        qt(4 * QP * (QP + 8) + 2 * QP * (W + 8)), dht(4 * QP * (QP + 8) + 4 * QP * (W + 8)),
        s(imax(sph + 8 * W * (KC + 8) + 4 * KC * (W + 8), 4 * QP * (QP + 8) + 6 * QP * (W + 8))),
        c(s + 4 * QP), ginv(s + 8 * QP), dden(s + 12 * QP), npt(s + 16 * QP),
        dnt(s + 16 * QP + 4 * W), dwh(s + 16 * QP + 8 * W), bytes(s + 24 * QP + 8 * W) {}
};

// Launch 4, grid (chunks x column tiles, H, B), 16 warps: the Q x W tile of
// dq, dk and dv at columns [c0, c0 + W) of one (b, h, chunk), whole (W =
// out_w(D): 64 where D allows, so dh, v and k are read by D / 64 blocks of
// a chunk; a warp: 16 rows, 16 NP columns of each).  The inter-chunk
// products first, over all D 128 at a time, S_p and dS split hi + lo:
//   dq  = s / g / sqrt(D) (.) dh S_p^T + s dden / sqrt(D) n_p
//   dk' = v dS^T + dn  (k . dk' over the tile to the scratch: dw's share)
//   dk  = c (.) dk',   dv = c (.) k dS
// then the chunk's own: dq += (A (.) dP / sqrt(D)) k, dk += (A (.) dP /
// sqrt(D))^T q, dv += (P / g)^T dh, on the tiles on or below the diagonal.
template <int NP>
__global__ void __launch_bounds__(TC_THREADS, 1) mlstm_bwd_out_bf16(const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_out[];
  const int QP = p.QP, W = p.W4, D = p.D, DP = round16(D), QT = QP / 16;
  const OutLayout L(QP, W);
  auto at = [&](int off) { return reinterpret_cast<bf16*>(smem_out + off); };
  auto atf = [&](int off) { return reinterpret_cast<float*>(smem_out + off); };
  float* sv = atf(L.s);
  float* cv = atf(L.c);
  float* gv = atf(L.ginv);
  float* ddv = atf(L.dden);
  float* npt = atf(L.npt);
  float* dnt = atf(L.dnt);
  float* dwh = atf(L.dwh);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = blockIdx.x / p.nt4, tile = blockIdx.x - ch * p.nt4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = ch * p.Q;
  const int qv = min(p.Q, p.L - t0);
  const int c0 = tile * W;
  const int64_t st = (static_cast<int64_t>(b) * p.nc + ch) * p.H + h;
  const float isd = p.inv_sqrt_d;
  const bf16* qg = p.q + b * p.qsb + h * p.qsh + t0 * p.qss;
  const bf16* kg = p.k + b * p.ksb + h * p.ksh + t0 * p.kss;
  const bf16* vg = p.v + b * p.vsb + h * p.vsh + t0 * p.vss;
  const bf16* dhg = p.dh + b * p.dsb + h * p.dsh + t0 * p.dss;
  const float* spg = p.Sp + st * D * D;
  const float* dsg = p.dS + st * D * D;
  const float* rec = p.rec + st * rec_floats(QP);
  const int mr = warp & 7, nh = warp >> 3;
  const int cb = 16 * NP * nh;  // this warp's first column in the tile
  const bool act = mr < QT && cb < W;
  const int nkc = (DP + KC - 1) / KC;

  for (int i = tid; i < QP; i += TC_THREADS) {
    sv[i] = rec[i];
    cv[i] = rec[QP + i];
    gv[i] = rec[2 * QP + i];
    ddv[i] = rec[3 * QP + i];
    dwh[i] = dwh[QP + i] = 0.f;
  }
  for (int c = tid; c < W; c += TC_THREADS) {
    npt[c] = c0 + c < D ? p.np[st * D + c0 + c] : 0.f;
    dnt[c] = c0 + c < D ? p.dn[st * D + c0 + c] : 0.f;
  }

  float aq[NP][2][4], ak[NP][2][4], av[NP][2][4];
#pragma unroll
  for (int pr = 0; pr < NP; ++pr)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[pr][nt][e] = ak[pr][nt][e] = av[pr][nt][e] = 0.f;

  for (int kc = 0; kc < nkc; ++kc) {
    const int d0 = kc * KC;
    stage_bf16(at(L.dhs), KC, dhg, p.dss, qv, QP, d0, D, p.vec16);
    stage_bf16(at(L.vs), KC, vg, p.vss, qv, QP, d0, D, p.vec16);
    stage_bf16(at(L.ks), KC, kg, p.kss, qv, QP, d0, D, p.vec16);
    stage_split(at(L.sph), at(L.spl), KC, spg, D, c0, W, d0);
    stage_split(at(L.dah), at(L.dal), KC, dsg, D, c0, W, d0);
    stage_split(at(L.dbh), at(L.dbl), W, dsg, D, d0, KC, c0);
    staged();
    __syncthreads();
    if (act) {
      const int kw = min(KC, DP - d0);
      for (int k0 = 0; k0 < kw; k0 += 16) {
        uint32_t a[4], bh[4], bl[4];
        lda(a, at(L.dhs), KC + 8, 16 * mr, k0, lane);
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          ldb(bh, at(L.sph), KC + 8, cb + 16 * pr, k0, lane);
          ldb(bl, at(L.spl), KC + 8, cb + 16 * pr, k0, lane);
          mma2(aq[pr], a, bh);
          mma2(aq[pr], a, bl);
        }
        lda(a, at(L.vs), KC + 8, 16 * mr, k0, lane);
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          ldb(bh, at(L.dah), KC + 8, cb + 16 * pr, k0, lane);
          ldb(bl, at(L.dal), KC + 8, cb + 16 * pr, k0, lane);
          mma2(ak[pr], a, bh);
          mma2(ak[pr], a, bl);
        }
        lda(a, at(L.ks), KC + 8, 16 * mr, k0, lane);
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          ldb_t(bh, at(L.dbh), W + 8, k0, cb + 16 * pr, lane);
          ldb_t(bl, at(L.dbl), W + 8, k0, cb + 16 * pr, lane);
          mma2(av[pr], a, bh);
          mma2(av[pr], a, bl);
        }
      }
    }
    __syncthreads();
  }

  // The chunk's matrices (rows of 16-byte units) and the tile's k, q, dh.
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.mats + st * 2 * QP * QP);
    const int units = QP / 8;
    for (int idx = tid; idx < 2 * QP * units; idx += TC_THREADS) {
      const int r = idx / units;  // rows of A (.) dP, then of P / g
      const int u = idx - r * units;
      bf16* dst = r < QP ? at(L.ad) + r * (QP + 8) : at(L.pg) + (r - QP) * (QP + 8);
      mma::cp_async16(dst + 8 * u, src + idx);
    }
  }
  stage_bf16(at(L.kt), W, kg, p.kss, qv, QP, c0, D, p.vec16);
  stage_bf16(at(L.qt), W, qg, p.qss, qv, QP, c0, D, p.vec16);
  stage_bf16(at(L.dht), W, dhg, p.dss, qv, QP, c0, D, p.vec16);
  staged();
  __syncthreads();
  if (act) {
    float dwr[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mr + frag_row(lane, e);
          const int cl = cb + 16 * pr + frag_col(lane, nt, e);
          const float si = sv[i];
          aq[pr][nt][e] = fmaf(aq[pr][nt][e], si * gv[i] * isd, si * ddv[i] * isd * npt[cl]);
          const float kin = ak[pr][nt][e] + dnt[cl];
          dwr[e >> 1] = fmaf(bf(at(L.kt) + i * (W + 8) + cl), kin, dwr[e >> 1]);
          ak[pr][nt][e] = cv[i] * kin;
          av[pr][nt][e] *= cv[i];
        }
    for (int jt = 0; jt <= mr; ++jt) {
      uint32_t a[4], bb[4];
      lda(a, at(L.ad), QP + 8, 16 * mr, 16 * jt, lane);
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        ldb_t(bb, at(L.kt), W + 8, 16 * jt, cb + 16 * pr, lane);
        mma2(aq[pr], a, bb);
      }
    }
    for (int it = mr; it < QT; ++it) {
      uint32_t a[4], bb[4];
      lda_t(a, at(L.ad), QP + 8, 16 * mr, 16 * it, lane);
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        ldb_t(bb, at(L.qt), W + 8, 16 * it, cb + 16 * pr, lane);
        mma2(ak[pr], a, bb);
      }
      lda_t(a, at(L.pg), QP + 8, 16 * mr, 16 * it, lane);
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        ldb_t(bb, at(L.dht), W + 8, 16 * it, cb + 16 * pr, lane);
        mma2(av[pr], a, bb);
      }
    }
    const int64_t base = (static_cast<int64_t>(b) * p.L + t0) * p.H + h;
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mr + (lane >> 2) + 8 * hf;
          const int col = c0 + cb + 16 * pr + frag_col(lane, nt, 0);
          if (i < qv && col < D) {
            const int64_t o = (base + static_cast<int64_t>(i) * p.H) * D + col;
            *reinterpret_cast<uint32_t*>(p.dq + o) =
                mma::pack_bf16(aq[pr][nt][2 * hf], aq[pr][nt][2 * hf + 1]);
            *reinterpret_cast<uint32_t*>(p.dk + o) =
                mma::pack_bf16(ak[pr][nt][2 * hf], ak[pr][nt][2 * hf + 1]);
            *reinterpret_cast<uint32_t*>(p.dv + o) =
                mma::pack_bf16(av[pr][nt][2 * hf], av[pr][nt][2 * hf + 1]);
          }
        }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dwr[hf] += __shfl_xor_sync(0xffffffffu, dwr[hf], 1);
      dwr[hf] += __shfl_xor_sync(0xffffffffu, dwr[hf], 2);
    }
    if ((lane & 3) == 0) {
      dwh[nh * QP + 16 * mr + (lane >> 2)] = dwr[0];
      dwh[nh * QP + 16 * mr + (lane >> 2) + 8] = dwr[1];
    }
  }
  __syncthreads();
  float* dwg = p.dwp + (tile * static_cast<int64_t>(p.nst) + st) * QP;
  for (int i = tid; i < QP; i += TC_THREADS) dwg[i] = dwh[i] + dwh[QP + i];
}

// Launch 5, one warp a (b, h, chunk), E = QP / 32 rows a lane (at least
// one): dw_j = c_j sum over the tiles of launch 4's shares; dtot = sum_j dw_j
// + so (<dS, S_p> + <dn, n_p>); db_i = the record's share - dw_i, plus dtot
// on the chunk's last valid row; d i_gate = the record's share + dw; the
// reverse cumsum of db within the chunk is d log f, and df = d log f
// sigmoid(-f).  All sums in fp64, in a fixed order.
__global__ void __launch_bounds__(GATE_WARPS * 32) mlstm_bwd_gates_bf16(const TcParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t st = static_cast<int64_t>(blockIdx.x) * GATE_WARPS + warp;
  if (st >= p.nst) return;
  const int h = static_cast<int>(st % p.H);
  const int ch = static_cast<int>((st / p.H) % p.nc);
  const int b = static_cast<int>(st / (static_cast<int64_t>(p.H) * p.nc));
  const int QP = p.QP, D = p.D;
  const int t0 = ch * p.Q;
  const int qv = min(p.Q, p.L - t0);
  const float* rec = p.rec + st * rec_floats(QP);
  const int E = (QP + 31) / 32;

  double td = 0.0;
  for (int d = lane; d < D; d += 32)
    td += static_cast<double>(p.dn[st * D + d]) * p.np[st * D + d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) td += __shfl_xor_sync(0xffffffffu, td, o);
  for (int vb = 0; vb < p.nt; ++vb) td += p.tdp[vb * static_cast<int64_t>(p.nst) + st];
  const int nt4 = p.nt4;

  double db[4], dw[4];
  double dws = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    db[e] = dw[e] = 0.0;
    if (e < E && i < qv) {
      double s = 0.0;
      for (int t = 0; t < nt4; ++t) s += p.dwp[(t * static_cast<int64_t>(p.nst) + st) * QP + i];
      dw[e] = static_cast<double>(rec[QP + i]) * s;
      dws += dw[e];
      db[e] = static_cast<double>(rec[4 * QP + i]) - dw[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dws += __shfl_xor_sync(0xffffffffu, dws, o);
  const double dtot = dws + static_cast<double>(rec[6 * QP]) * td;
  double run = 0.0;  // this lane's rows, last first
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    const int i = lane * E + e;
    if (e < E && i == qv - 1) db[e] += dtot;
    run += db[e];
    db[e] = run;  // suffix sum within the lane
  }
  double incl = run;  // suffix sums over the lanes above
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double x = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += x;
  }
  double above = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) above = 0.0;
  const bf16* fgp = p.fg + b * p.fsb + h * p.fsh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    if (e < E && i < qv) {
      const int64_t o = (static_cast<int64_t>(b) * p.L + t0 + i) * p.H + h;
      const float f = __bfloat162float(fgp[(t0 + i) * p.fss]);
      p.dig[o] = __float2bfloat16(static_cast<float>(static_cast<double>(rec[5 * QP + i]) + dw[e]));
      p.df[o] = __float2bfloat16(static_cast<float>(db[e] + above) / (1.f + expf(f)));
    }
  }
}

cudaError_t launch_bf16(const Params& sp, void* dq, void* dk, void* dig, void* df, void* scratch,
                        cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaSuccess;
    for (const void* f : {reinterpret_cast<const void*>(mlstm_bwd_states_bf16<1>),
                          reinterpret_cast<const void*>(mlstm_bwd_states_bf16<2>),
                          reinterpret_cast<const void*>(mlstm_bwd_dstates_bf16<1>),
                          reinterpret_cast<const void*>(mlstm_bwd_dstates_bf16<2>),
                          reinterpret_cast<const void*>(mlstm_bwd_chunk_bf16<1>),
                          reinterpret_cast<const void*>(mlstm_bwd_chunk_bf16<2>),
                          reinterpret_cast<const void*>(mlstm_bwd_out_bf16<1>),
                          reinterpret_cast<const void*>(mlstm_bwd_out_bf16<2>)})
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  TcParams p{};
  p.q = static_cast<const bf16*>(sp.q);
  p.k = static_cast<const bf16*>(sp.k);
  p.v = static_cast<const bf16*>(sp.v);
  p.ig = static_cast<const bf16*>(sp.ig);
  p.fg = static_cast<const bf16*>(sp.fg);
  p.dh = static_cast<const bf16*>(sp.dh);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(sp.dv);
  p.dig = static_cast<bf16*>(dig);
  p.df = static_cast<bf16*>(df);
  const TcScratch sc(sp.B, sp.L, sp.H, sp.D, sp.Q);
  float* base = static_cast<float*>(scratch);
  p.Sp = base + sc.Sp;
  p.np = base + sc.np;
  p.mp = base + sc.mp;
  p.dS = base + sc.dS;
  p.dn = base + sc.dn;
  p.rec = base + sc.rec;
  p.tdp = base + sc.tdp;
  p.dwp = base + sc.dwp;
  p.mats = reinterpret_cast<bf16*>(base + sc.mats);
  p.B = sp.B;
  p.L = sp.L;
  p.H = sp.H;
  p.D = sp.D;
  p.Q = sp.Q;
  p.nc = sp.nc;
  p.QP = round16(sp.Q);
  p.W = tile_w(sp.D);
  p.nt = n_tiles(sp.D);
  p.W4 = out_w(sp.D);
  p.nt4 = (sp.D + p.W4 - 1) / p.W4;
  p.nst = sp.B * sp.nc * sp.H;
  p.inv_sqrt_d = 1.f / sp.sqrt_d;
  p.qsb = sp.qsb; p.qss = sp.qss; p.qsh = sp.qsh;
  p.ksb = sp.ksb; p.kss = sp.kss; p.ksh = sp.ksh;
  p.vsb = sp.vsb; p.vss = sp.vss; p.vsh = sp.vsh;
  p.isb = sp.isb; p.iss = sp.iss; p.ish = sp.ish;
  p.fsb = sp.fsb; p.fss = sp.fss; p.fsh = sp.fsh;
  p.dsb = sp.dsb; p.dss = sp.dss; p.dsh = sp.dsh;
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.vec16 = al16(sp.q) && al16(sp.k) && al16(sp.v) && al16(sp.dh) && sp.D % 8 == 0 &&
            sp.qsb % 8 == 0 && sp.qss % 8 == 0 && sp.qsh % 8 == 0 && sp.ksb % 8 == 0 &&
            sp.kss % 8 == 0 && sp.ksh % 8 == 0 && sp.vsb % 8 == 0 && sp.vss % 8 == 0 &&
            sp.vsh % 8 == 0 && sp.dsb % 8 == 0 && sp.dss % 8 == 0 && sp.dsh % 8 == 0;
  const dim3 sweep(p.nt, p.H, p.B);
  const int sw_bytes = SwLayout(p.QP, p.W, p.D).bytes;
  if (p.W == 32)
    mlstm_bwd_states_bf16<2><<<sweep, SW_THREADS, sw_bytes, stream>>>(p);
  else
    mlstm_bwd_states_bf16<1><<<sweep, SW_THREADS, sw_bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ch_bytes = ChLayout(p.QP, p.W4, p.D).bytes;
  if (p.W4 == 64)
    mlstm_bwd_chunk_bf16<2><<<dim3(p.nc, p.H, p.B), TC_THREADS, ch_bytes, stream>>>(p);
  else
    mlstm_bwd_chunk_bf16<1><<<dim3(p.nc, p.H, p.B), TC_THREADS, ch_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.W == 32)
    mlstm_bwd_dstates_bf16<2><<<sweep, SW_THREADS, sw_bytes, stream>>>(p);
  else
    mlstm_bwd_dstates_bf16<1><<<sweep, SW_THREADS, sw_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 out_grid(p.nc * p.nt4, p.H, p.B);
  if (p.W4 == 64)
    mlstm_bwd_out_bf16<2><<<out_grid, TC_THREADS, OutLayout(p.QP, p.W4).bytes, stream>>>(p);
  else
    mlstm_bwd_out_bf16<1><<<out_grid, TC_THREADS, OutLayout(p.QP, p.W4).bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_gates_bf16<<<static_cast<unsigned>((p.nst + GATE_WARPS - 1) / GATE_WARPS),
                         GATE_WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

static_assert(SwLayout(128, 32, MAX_D).bytes <= SMEM_LIMIT, "sweep plan exceeds 227 KB");
static_assert(ChLayout(128, 64, MAX_D).bytes <= SMEM_LIMIT, "chunk plan exceeds 227 KB");
static_assert(OutLayout(128, 64).bytes <= SMEM_LIMIT, "output plan exceeds 227 KB");

bool head_dim_ok(int D) {
  return D >= 4 && D % 4 == 0 && (D <= COLS || (D % COLS == 0 && D <= MAX_D));
}

}  // namespace

// Bytes of dynamic shared memory a block of the main kernel takes.
extern "C" int mlstm_scan_bwd_smem_bytes(int Q, int D) {
  return static_cast<int>(sizeof(float) * Layout(Q, D).total);
}

// Bytes of fp32 device scratch a call takes: the larger of the two paths' needs.
extern "C" int64_t mlstm_scan_bwd_scratch_bytes(int B, int L, int H, int D, int Q) {
  const int64_t scalar = Scratch(B, L, H, D, Q).total, tc = TcScratch(B, L, H, D, Q).total;
  return static_cast<int64_t>(sizeof(float)) * (scalar > tc ? scalar : tc);
}

// Bytes of dynamic shared memory a block of each bf16 kernel takes: 0
// mlstm_bwd_states_bf16 and mlstm_bwd_dstates_bf16, 1 mlstm_bwd_chunk_bf16,
// 2 mlstm_bwd_out_bf16 (mlstm_bwd_gates_bf16 takes none).
extern "C" int mlstm_scan_bwd_tc_smem_bytes(int Q, int D, int kernel) {
  const int QP = round16(Q), W = tile_w(D);
  switch (kernel) {
    case 0: return SwLayout(QP, W, D).bytes;
    case 1: return ChLayout(QP, out_w(D), D).bytes;
    case 2: return OutLayout(QP, out_w(D)).bytes;
    default: return -1;
  }
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
    case 1: err = launch_bf16(p, dq, dk, dig, df, scratch, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
