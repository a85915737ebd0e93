// Chunked stabilised mLSTM for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/mlstm.py::_mlstm_kernel, launched by
// mlstm_scan_pallas.  It computes the function of
// repro_torch.kernels.ref.mlstm_chunked (h and the final state) with fp32
// accumulation.  Per (b, h) and chunk of Q steps, with the matrix memory
// S (D, D), the normaliser n (D) and the stabiliser m carried from chunk
// to chunk (m starts at -inf, S and n at 0), q scaled by 1/sqrt(D):
//   b_i  = sum_{j<=i} log_sigmoid(f_j),  total = b_{Q-1}
//   m_i  = max(m + b_i, max_{j<=i} (b_i - b_j + ig_j))
//   W_ij = (q_i . k_j) exp(b_i - b_j + ig_j - m_i)      for j <= i, else 0
//   h_i  = (e_i q_i S + sum_j W_ij v_j) / max(|e_i q_i . n + sum_j W_ij|, exp(-m_i))
//          with e_i = exp(m + b_i - m_i)  (0 while m is -inf)
//   then, with w_j = total - b_j + ig_j and m' = max(m + total, max_j w_j):
//   S <- exp(m + total - m') S + sum_j exp(w_j - m') k_j v_j^T   (n alike), m <- m'
// h reads the state before its chunk; the update comes after.  q, k, v and
// both gates are fp32 or bf16 (one type); h is in their type, the final
// S (B,H,D,D), n (B,H,D), m (B,H) fp32.  Unlike the Pallas kernel, which
// drops its state, this one writes it out: the serve path's one-pass
// prefill hands it to decode.
//
// Kernels, chosen by dtype alone in mlstm_scan_fwd: fp32 -> mlstm_fwd,
// scalar fp32 FMAs (unchanged since it was first written; it holds the
// 2e-4 fp32 tolerance); bf16 -> mlstm_w_bf16 then mlstm_fwd_bf16, two
// launches of tensor-core products (mma.sync m16n8k16, bf16 operands,
// fp32 accumulators; helpers in mma_bf16.cuh) with a scratch tensor
// between them that the caller allocates.
//
// What bounds it.  At the serve path's shape (B 8, S 512, H 4, D 384,
// Q 128, bf16) the call must read q, k, v (3 x 12.6 MB) and the gates, and
// write h (12.6 MB) and the fp32 final state (18.9 MB): ~69 MB, 21 us at
// 3.35 TB/s.  It does 4 Q D (Q + D) = 100.7 MFLOP per (b, h, chunk) (the
// products q k^T, q S, W v and k^T v), x 128 = 12.9 GFLOP: 13 us at the
// dense bf16 tensor-core peak.  So the bound is bytes, 21 us.
//
// The scalar design (fp32).  The state does not fit in a block: S is
// D x D x 4 = 576 KB of fp32 per (b, h) at D 384, and a block may have
// 227 KB.  So S is split over blocks of value columns: a block owns
// S[:, v0:v0+32] and loops over the chunks itself (the TPU's sequential
// chunk axis; Hopper blocks run in no order, so nothing carries between
// them), with its own copy of n and m, the gate math redone per block.
// q and k stream through shared memory 32 key columns at a time; a thread
// owns 4 x 4 register tiles of q k^T (lower triangle only), of q S and of
// the state update, all scalar fp32 FMAs, and every block recomputes q k^T.
// It ran bf16 too, until the kernels below: 3.39 ms at the serve shape
// (chip_smoke.py, H100 80GB HBM3 at 700 W), 164x the bound.
//
// The bf16 design, point by point against what held the scalar kernel back:
// 1. Every product is an mma on bf16 operands with fp32 accumulators: q k^T,
//    q S, W v and (cw (.) k)^T v.  1/sqrt(D) multiplies the fp32 products;
//    den, the row sums of W and n come from fp32 values.  S stays fp32 in
//    shared memory for good; only what feeds a product is rounded: W, the
//    copy of S that feeds q S, and cw (.) k, each split into hi = bf16(x)
//    and lo = bf16(x - hi) entering its product twice (~2^-16 of x).  An
//    emulation of these roundings (tests/test_torch_mlstm.py) holds h at
//    0.26 of the 2e-2 tolerance at D 384, chunk 128, and puts it 1.55x past
//    with W rounded once; on the card, a build that rounded the S copy once
//    put h past it at the serve shape too.
// 2. W = q k^T (.) exp(b_i - b_j + ig_j - m_i) is formed once per (b, h,
//    chunk) by launch 1 (mlstm_w_bf16), not once per value-column block:
//    one block of 4 warps per row-tile pair, 512 blocks at the serve shape.
//    It writes W as mma A fragments (bf16 hi + lo), its fp32 row sums and
//    the chunk's vectors (m_i, e_i, cw_j, the old state's scale) to the
//    scratch: 38,928 bytes a (b, h, chunk), 5.0 MB at the serve shape, read
//    back from L2.  Launch 2 (mlstm_fwd_bf16) keeps the value-column split
//    and the chunk loop, and reads W instead of building it.
// 3. q and k tiles (32 key columns) are loaded by TMA (one thread's
//    cp.async.bulk.tensor, completing an mbarrier) into the second of two
//    buffers while the first is used; 16-byte cp.async, issued by every
//    thread, had stalled all warps at each tile on the memory system.  The
//    tiles' 16-byte units are XOR-swizzled as TMA's 64-byte (32-byte at
//    D <= 16) swizzle places them, so ldmatrix's 8 row addresses hit
//    distinct banks; S's fp32 rows are padded by 4 floats, so the B
//    fragments of q S (rows 2t, columns g) do too.  Where a row is not
//    whole 16-byte units (D % 8 != 0) the tiles are loaded element by
//    element instead.
// 4. Row tiles of the lower triangle go in pairs (r, QT - 1 - r): one block
//    a pair in launch 1 (its n8 tiles dealt round-robin to 4 warps), 16 / 4
//    warps a pair in launch 2's q S and W v, so every warp gets the same
//    share of the triangle (9 of the 36 16 x 16 tiles a pair at Q 128).
// 5. The state update is a product too: per 32-row tile of S, 16 warps
//    split its 24 (m16, n8) tiles, each a sum over the chunk's rows in mma
//    steps of 16 (two with hi + lo).  cw (.) k is split into hi + lo once a
//    tile in shared memory; n's update is summed from the same fp32 values.
// 6. Value columns a block: the widest of 96, 64, 32 that divides D and
//    fits (value_cols).  At D 384, 96: 4 x 4 x 8 = 128 blocks of 16 warps,
//    one wave on 132 SMs, and q and k are read from L2 by 4 blocks of a
//    (b, h), not 12.  Shared memory at Q 128, D 384, VB 96: 227,360 bytes
//    (S 153,600, v 26,624, q/k tiles and the lo of cw (.) k 40,960,
//    vectors and barriers 6,176), one block an SM; launch 1 takes 43,072.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.2298 ms a call at the
// serve shape, 0.2218 ms in a CUDA graph of calls, against the scalar
// kernel's 3.39 ms and the 21 us bound: 96 TFLOP/s of mma issued, a tenth
// of the tensor cores' peak.  Each 32-row tile of S is one small update
// (24 m16 x n8 tiles for 16 warps), so 8 warps load the same k^T
// fragments, and every fragment passes through shared memory: mma.sync
// takes its operands from registers (wgmma, which reads them from shared
// memory once, is later work).  ptxas: mlstm_fwd_bf16 127 registers,
// mlstm_w_bf16 96, no spills.
//
// The stabiliser's start: m is -inf before the first chunk, as in the
// oracle; e_i and the old state's scale are set to 0 there instead of
// evaluating exp(-inf - m), so -inf - (-inf) is never formed.  The build
// does not use --use_fast_math: inf stays IEEE.  A ragged last chunk is
// zero-filled where it is loaded, with log-forget 0 and input gate -inf
// (which neither decays nor feeds the state), and masked where h is
// stored; in the bf16 kernels a chunk or a D that does not fill 16-wide
// tiles is zero-padded to them in shared memory (but for launch 1's q rows
// past the chunk, which reach only rows of W that no h reads).
//
// Sizes are runtime values: D a multiple of 4 up to 32, or a multiple of
// 32 up to 512; Q a multiple of 4 in [4, 128]; any length S >= 1 (the
// Python wrapper checks; so does the C entry).  q, k, v and the gates may
// be strided views (element strides of their leading axes, last axis of
// q, k, v contiguous); h is written through its strides.  The bf16
// kernels load q and k tiles by TMA and v by 16-byte cp.async where every
// row starts 16-byte aligned in whole units, and element by element
// otherwise.
// Launch errors are returned, never swallowed.

#include <cuda.h>
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
constexpr int COLS = 32;     // value columns a block owns (VB) and key columns a tile holds (KT)
constexpr int MAX_TRI = 3;   // lower-triangle 4x4 tiles of q k^T a thread: ceil(32*33/2 / 256)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* ig;
  const void* fg;
  void* h;
  float* S;
  float* n;
  float* m;
  int B, L, H, D, Q;
  float sqrt_d;
  int64_t qsb, qss, qsh;
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t isb, iss, ish;
  int64_t fsb, fss, fsh;
  int64_t hsb, hss, hsh;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Shared-memory plan, in floats.  Every offset is a multiple of 4 floats
// (Q, D and the widths are), so float4 accesses stay aligned.
struct Layout {
  int VB, KT, LQ, ss, wt, vs, qt, kt, nv, ig, bq, mi, isc, cw, scal, total;
  __host__ __device__ constexpr Layout(int Q, int D)
      : VB(D < COLS ? D : COLS),
        KT(D < COLS ? D : COLS),
        LQ(Q + 4),
        ss(0),                                   // [D][VB]  S[:, v0:v0+VB]
        wt(D * VB),                              // [Q][LQ]  Wt[j][i] = W_ij
        vs(wt + Q * LQ),                         // [Q][VB]  v of the chunk, own columns
        qt(vs + Q * VB),                         // [KT][LQ] q^T tile (scaled)
        kt(qt + KT * LQ),                        // [KT][LQ] k^T tile
        nv(kt + KT * LQ),                        // [D]      n
        ig(nv + D),                              // [Q]      input gate (-inf past the end)
        bq(ig + Q),                              // [Q]      b_i
        mi(bq + Q),                              // [Q]      m_i
        isc(mi + Q),                             // [Q]      e_i
        cw(isc + Q),                             // [Q]      exp(w_j - m')
        scal(cw + Q),                            // [4]      old state's scale
        total(scal + 4) {}
};

constexpr size_t MAX_BYTES = sizeof(float) * Layout(MAX_Q, MAX_D).total;
static_assert(MAX_BYTES <= 232448, "shared memory plan exceeds 227 KB");

__device__ __forceinline__ void unpack(const float4 v, float (&r)[4]) {
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) mlstm_fwd(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = p.Q, D = p.D;
  const Layout L(Q, D);
  const int LQ = L.LQ, VB = L.VB, KT = L.KT;
  float* Ss = sm + L.ss;
  float* Wt = sm + L.wt;
  float* Vs = sm + L.vs;
  float* Qt = sm + L.qt;
  float* Kt = sm + L.kt;
  float* nv = sm + L.nv;
  float* igs = sm + L.ig;
  float* bq = sm + L.bq;
  float* mi = sm + L.mi;
  float* isc = sm + L.isc;
  float* cw = sm + L.cw;
  float* scal = sm + L.scal;

  const int tid = threadIdx.x;
  const int vblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = vblk * VB;  // this block's first value column
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh + c0;
  const T* ig_g = static_cast<const T*>(p.ig) + b * p.isb + h * p.ish;
  const T* fg_g = static_cast<const T*>(p.fg) + b * p.fsb + h * p.fsh;
  T* hg = static_cast<T*>(p.h) + b * p.hsb + h * p.hsh + c0;
  const float sqrt_d = p.sqrt_d;

  // This thread's lower-triangle tiles of q k^T: (ti, tj) with tj <= ti.
  const int T4 = Q / 4;
  const int ntri = T4 * (T4 + 1) / 2;
  int tri_i[MAX_TRI], tri_j[MAX_TRI];
#pragma unroll
  for (int r = 0; r < MAX_TRI; ++r) {
    const int k = tid + r * NTHREADS;
    int ti = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    while (ti * (ti + 1) / 2 > k) --ti;
    tri_i[r] = ti * 4;
    tri_j[r] = (k - ti * (ti + 1) / 2) * 4;
  }
  // This thread's (row, value column) 4x4 tile of q S and of h.
  const int V4 = VB / 4;
  const bool own = tid < T4 * V4;
  const int oi = (tid / V4) * 4;
  const int ov = (tid % V4) * 4;

  for (int i = tid; i < D * VB; i += NTHREADS) Ss[i] = 0.f;
  for (int i = tid; i < D; i += NTHREADS) nv[i] = 0.f;
  float m_prev = -INFINITY;  // the stabiliser; warp 0 keeps it

  const int nchunks = (p.L + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.L - t0);  // valid rows of this chunk

    // 1. Stage this block's value columns of the chunk; rows past the end are zeros.
    for (int e = tid; e < Q * VB; e += NTHREADS) {
      const int j = e / VB;
      const int c = e - j * VB;
      Vs[e] = j < qv ? to_f(__ldg(vg + (t0 + j) * p.vss + c)) : 0.f;
    }
    // 2. Gate math in warp 0, up to 4 rows a lane: b, m_i, e_i, the update's weights.
    if (tid < 32) {
      const int E = (Q + 31) / 32;
      const int j0 = tid * E;
      float lf[4], igv[4], bl[4], am[4];
      float run = 0.f, amax = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        igv[e] = -INFINITY;
        lf[e] = 0.f;
        if (e < E && j < qv) {
          igv[e] = to_f(__ldg(ig_g + (t0 + j) * p.iss));
          lf[e] = log_sigmoid(to_f(__ldg(fg_g + (t0 + j) * p.fss)));
        }
        run += lf[e];
        bl[e] = run;
      }
      // b: inclusive scan of log-forget over the chunk.
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bl[e] += excl;
        amax = fmaxf(amax, igv[e] - bl[e]);  // -inf - b = -inf past the end
        am[e] = amax;
        const int j = j0 + e;
        if (e < E && j < Q) {
          bq[j] = bl[e];
          igs[j] = igv[e];
        }
      }
      // max_{j<=i} (ig_j - b_j): inclusive max-scan.
      float mincl = amax;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, mincl, off);
        if (tid >= off) mincl = fmaxf(mincl, o);
      }
      float mexcl = __shfl_up_sync(0xffffffffu, mincl, 1);
      if (tid == 0) mexcl = -INFINITY;
      __syncwarp();
      const float total = bq[Q - 1];
      float wmax = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < Q) {
          const float m_intra = bl[e] + fmaxf(mexcl, am[e]);
          const float m_i = fmaxf(m_prev + bl[e], m_intra);
          mi[j] = m_i;
          isc[j] = m_prev == -INFINITY ? 0.f : expf(m_prev + bl[e] - m_i);
          wmax = fmaxf(wmax, total - bl[e] + igv[e]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
      const float m_new = fmaxf(m_prev + total, wmax);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (e < E && j < Q) cw[j] = expf(total - bl[e] + igv[e] - m_new);
      }
      if (tid == 0) scal[0] = m_prev == -INFINITY ? 0.f : expf(m_prev + total - m_new);
      m_prev = m_new;
    }
    __syncthreads();
    const float scale_old = scal[0];

    // 3. Stream q and k through shared memory KT key columns at a time.
    float acc[MAX_TRI][4][4] = {};  // q k^T on this thread's triangle tiles
    float aqs[4][4] = {};           // q S on this thread's (row, value) tile
    float aqn[4] = {};              // q . n on its rows
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
            unpack(*reinterpret_cast<const float4*>(Qt + c * LQ + i0), qr);
            unpack(*reinterpret_cast<const float4*>(Kt + c * LQ + j0), kr);
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
          unpack(*reinterpret_cast<const float4*>(Qt + c * LQ + oi), qr);
          unpack(*reinterpret_cast<const float4*>(Ss + (k0 + c) * VB + ov), sr);
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

      // These rows of S and n are read no more in this chunk: update them.
      for (int e = tid; e < KT * V4; e += NTHREADS) {
        const int c = e / V4;
        const int v0 = (e - c * V4) * 4;
        float* srow = Ss + (k0 + c) * VB + v0;
        float s[4];
        unpack(*reinterpret_cast<const float4*>(srow), s);
#pragma unroll
        for (int w = 0; w < 4; ++w) s[w] *= scale_old;
        float nn = nv[k0 + c] * scale_old;
        for (int j = 0; j < qv; ++j) {
          const float kc = Kt[c * LQ + j] * cw[j];
          float vr[4];
          unpack(*reinterpret_cast<const float4*>(Vs + j * VB + v0), vr);
#pragma unroll
          for (int w = 0; w < 4; ++w) s[w] = fmaf(kc, vr[w], s[w]);
          nn += kc;
        }
        *reinterpret_cast<float4*>(srow) = make_float4(s[0], s[1], s[2], s[3]);
        if (v0 == 0) nv[k0 + c] = nn;
      }
      __syncthreads();
    }

    // 4. W = q k^T (.) exp(b_i - b_j + ig_j - m_i) on the tiles on or below
    //    the diagonal, stored transposed; exp only where j <= i.
#pragma unroll
    for (int r = 0; r < MAX_TRI; ++r) {
      if (tid + r * NTHREADS < ntri) {
        const int i0 = tri_i[r], j0 = tri_j[r];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + w;
          const float bj = bq[j], igj = igs[j];
          float out[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u;
            out[u] = j <= i ? acc[r][u][w] * expf(bq[i] - bj + igj - mi[i]) : 0.f;
          }
          *reinterpret_cast<float4*>(Wt + j * LQ + i0) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    __syncthreads();

    // 5. h = (e_i q S + W v) / max(|e_i q . n + rowsum W|, exp(-m_i)).
    if (own && oi < qv) {
      float awv[4][4] = {};
      float rs[4] = {};
      const int jend = min(oi + 4, qv);
      for (int j = 0; j < jend; ++j) {
        float wr[4], vr[4];
        unpack(*reinterpret_cast<const float4*>(Wt + j * LQ + oi), wr);
        unpack(*reinterpret_cast<const float4*>(Vs + j * VB + ov), vr);
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
        if (i >= qv) break;
        const float e_i = isc[i];
        const float den = fmaxf(fabsf(aqn[u] * e_i + rs[u]), expf(-mi[i]));
        T* hrow = hg + (t0 + i) * p.hss + ov;
#pragma unroll
        for (int w = 0; w < 4; ++w) hrow[w] = from_f<T>((aqs[u][w] * e_i + awv[u][w]) / den);
      }
    }
    __syncthreads();
  }

  float* sg = p.S + (static_cast<int64_t>(b) * p.H + h) * D * D + c0;
  for (int e = tid; e < D * VB; e += NTHREADS) {
    const int row = e / VB;
    sg[static_cast<int64_t>(row) * D + (e - row * VB)] = Ss[e];
  }
  if (vblk == 0) {
    float* ng = p.n + (static_cast<int64_t>(b) * p.H + h) * D;
    for (int i = tid; i < D; i += NTHREADS) ng[i] = nv[i];
    if (tid == 0) p.m[static_cast<int64_t>(b) * p.H + h] = m_prev;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = mlstm_fwd<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_BYTES));
  if (attr != cudaSuccess) return attr;
  const size_t bytes = sizeof(float) * Layout(p.Q, p.D).total;
  const dim3 grid(p.D / Layout(p.Q, p.D).VB, p.H, p.B);
  kern<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: two tensor-core kernels (mma.sync m16n8k16, fp32 accumulators),
// mlstm_w_bf16 then mlstm_fwd_bf16, with a scratch tensor between them.

using bf16 = __nv_bfloat16;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, a block's most
constexpr int W_WARPS = 4;          // mlstm_w_bf16: one row-tile pair a block
constexpr int W_STAGES = 4;         // q/k tiles in flight in mlstm_w_bf16
constexpr int W_MAX = 5;            // n8 tiles of W a warp forms: ceil(18 / 4) at QT 8
constexpr int F_WARPS = 16;         // mlstm_fwd_bf16
constexpr int F_MAX_C = 3;          // n8 value tiles a warp owns in q S and W v: 12 / 4
constexpr int F_MAX_U = 2;          // (m16, n8) tiles of S a warp updates per tile: ceil(24 / 16)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// A q or k tile: rows of KT bf16 (KT = 32, or D rounded up to 16 where
// D <= 16), U = KT / 8 16-byte units a row, the units XOR-swizzled so the
// 8 rows of an ldmatrix fall in distinct banks.  off: element offset of
// unit u of row r.
struct KTile {
  int KT, U, sh;
  __host__ __device__ constexpr KTile(int D)
      : KT(D <= 16 ? 16 : 32), U(D <= 16 ? 2 : 4), sh(D <= 16 ? 2 : 1) {}
  __device__ int off(int r, int u) const { return (r * U + (u ^ ((r >> sh) & (U - 1)))) * 8; }
};

// The scratch of one (b, h, chunk), in floats: the chunk's vectors m_i,
// e_i, cw_j, the row sums of W (QP each), the old state's scale and the
// stabiliser after the chunk (4); then W on the 16 x 16 tiles on or below
// the diagonal as mma A fragments, bf16 hi and lo: tile (it, jt) at
// it (it + 1) / 2 + jt, 256 words; its columns 0-7 (parity 0) then 8-15,
// a uint4 (hi rows g, hi rows g + 8, lo rows g, lo rows g + 8) per lane.
struct Scratch {
  int vec, per;
  __host__ __device__ constexpr Scratch(int Q)
      : vec(4 * round16(Q) + 4),
        per(4 * round16(Q) + 4 + (round16(Q) / 16) * (round16(Q) / 16 + 1) / 2 * 256) {}
};

// mlstm_w_bf16's shared memory, in bytes: W_STAGES stages of (q rows of
// the pair's two row tiles, k rows 0..QP), each a whole number of the
// swizzle's 512-byte (256-byte at KT 16) periods, as TMA needs; then
// b, the input gate, m_i (QP each), the warps' row-sum partials (32 rows
// each) and stabiliser maps (2 floats each), and the stages' mbarriers.
struct WLayout {
  int qt, stage, vec, bar, bytes;
  __host__ __device__ constexpr WLayout(int Q, int D)
      : qt(32 * KTile(D).KT),
        stage(2 * (32 + round16(Q)) * KTile(D).KT),
        vec(W_STAGES * 2 * (32 + round16(Q)) * KTile(D).KT),
        bar(W_STAGES * 2 * (32 + round16(Q)) * KTile(D).KT + 4 * 3 * round16(Q) +
            4 * W_WARPS * 34),
        bytes(W_STAGES * 2 * (32 + round16(Q)) * KTile(D).KT + 4 * 3 * round16(Q) +
              4 * W_WARPS * 34 + 8 * W_STAGES) {}
};

// mlstm_fwd_bf16's shared memory, in bytes, for VB value columns a block:
// q and k tiles in two buffers (first, so TMA's swizzle, which follows the
// address bits, matches KTile's) and the lo of this tile's cw (.) k (the k
// buffer holds hi); S[:, v0:v0+VB] in fp32 (row stride VP + 4 floats, so
// the B fragments of q S, rows 2t.. and columns g.., hit distinct banks);
// the chunk's vectors (m_i, e_i, cw, row sums of W, q . n), n, the n
// update's partials, the scales, the two buffers' mbarriers; the chunk's
// own value columns of v (rows padded by one 16-byte unit).
struct TcLayout {
  int VP, SS, VS, tiles, klo, s, vec, nv, npart, scal, bar, v, bytes;
  __host__ __device__ constexpr TcLayout(int Q, int D, int VB)
      : VP(round16(VB)), SS(round16(VB) + 4), VS(round16(VB) + 8),
        tiles(0),
        klo(8 * round16(Q) * KTile(D).KT),
        s(10 * round16(Q) * KTile(D).KT),
        vec(s + 4 * round16(D) * (round16(VB) + 4)),
        nv(vec + 4 * 5 * round16(Q)),
        npart(nv + 4 * round16(D)),
        scal(npart + 4 * F_WARPS * 32),
        bar(scal + 16),
        v(bar + 16),
        bytes(v + 2 * round16(Q) * (round16(VB) + 8)) {}
};

static_assert(TcLayout(MAX_Q, MAX_D, COLS).bytes <= SMEM_LIMIT,
              "shared memory plan exceeds 227 KB at VB 32");
static_assert(WLayout(MAX_Q, MAX_D).bytes <= SMEM_LIMIT, "W plan exceeds 227 KB");

// The widest VB of 96, 64 and 32 that divides D and whose plan fits a
// block (D itself where D <= 32).  Fewer, wider blocks read q and k from
// L2 fewer times; at Q 128, D 384 it is 96: 4 x 4 x 8 = 128 blocks, one
// wave on 132 SMs.
int value_cols(int Q, int D) {
  if (D <= COLS) return D;
  for (int vb : {96, 64}) {
    if (D % vb == 0 && TcLayout(Q, D, vb).bytes <= SMEM_LIMIT) return vb;
  }
  return COLS;
}

struct TcParams {
  CUtensorMap qmap, kmap;      // q and k as (D, H, L, B) bf16, boxes of KT x 1 x Q x 1
  CUtensorMap q16map;          // q with boxes of KT x 1 x 16 x 1
  Params p;
  float* scratch;
  int vb;     // value columns a block of mlstm_fwd_bf16 owns
  int vec16;  // q, k, v rows 16-byte aligned in whole units: v by cp.async
  int tma;    // vec16 and the three maps encoded: q and k tiles by TMA
};

// Rows [0, n) and columns [0, width) of a bf16 matrix (row stride rs, in
// elements) into a tile, by threads first, first + step, ...; rows >= qv
// and columns >= cvalid are zeros.  off(r, u): the element offset of unit
// u (8 elements) of tile row r.  16-byte cp.async where the rows allow it
// (the caller commits), else plain loads.
template <typename Off>
__device__ __forceinline__ void stage_rows(bf16* dst, Off off, const bf16* src, int64_t rs,
                                           int qv, int n, int width, int cvalid, bool vec16,
                                           int first, int step) {
  const int units = width / 8;
  if (vec16) {
    for (int idx = first; idx < n * units; idx += step) {
      const int j = idx / units;
      const int u = idx - j * units;
      const bool ok = j < qv && u * 8 < cvalid;
      mma::cp_async16(dst + off(j, u), ok ? src + j * rs + u * 8 : src, ok);
    }
  } else {
    for (int idx = first; idx < n * width; idx += step) {
      const int j = idx / width;
      const int c = idx - j * width;
      dst[off(j, c >> 3) + (c & 7)] =
          j < qv && c < cvalid ? src[j * rs + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// One chunk's gate math in one warp, QP / 32 rows a lane (up to 4), rows
// >= qv with log-forget 0 and input gate -inf.  Returns (total, max_j w_j),
// which take the stabiliser m before the chunk to max(m + total, max_j w_j)
// after it.  With OUT it also writes b, the input gate and m_i to shared
// memory and, with vec, m_i, e_i, cw_j, the old state's scale and the new
// stabiliser to the chunk's scratch vectors.
template <bool OUT>
__device__ float2 gate_chunk(const bf16* ig_g, const bf16* fg_g, int64_t iss, int64_t fss,
                            int t0, int qv, int QP, float m_prev, float* bq, float* igs,
                            float* mis, float* vec) {
  const int lane = threadIdx.x & 31;
  const int E = (QP + 31) / 32;
  const int j0 = lane * E;
  float lf[4], igv[4], bl[4], am[4];
  float run = 0.f, amax = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    igv[e] = -INFINITY;
    lf[e] = 0.f;
    if (e < E && j < qv) {
      igv[e] = to_f(__ldg(ig_g + (t0 + j) * iss));
      lf[e] = log_sigmoid(to_f(__ldg(fg_g + (t0 + j) * fss)));
    }
    run += lf[e];
    bl[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  float wmax = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bl[e] += excl;
    amax = fmaxf(amax, igv[e] - bl[e]);
    am[e] = amax;
    wmax = fmaxf(wmax, total - bl[e] + igv[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
  const float m_new = fmaxf(m_prev + total, wmax);
  if (OUT) {
    float mincl = amax;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, mincl, off);
      if (lane >= off) mincl = fmaxf(mincl, o);
    }
    float mexcl = __shfl_up_sync(0xffffffffu, mincl, 1);
    if (lane == 0) mexcl = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      if (e < E && j < QP) {
        const float m_i = fmaxf(m_prev + bl[e], bl[e] + fmaxf(mexcl, am[e]));
        bq[j] = bl[e];
        igs[j] = igv[e];
        mis[j] = m_i;
        if (vec) {
          vec[j] = m_i;
          vec[QP + j] = m_prev == -INFINITY ? 0.f : expf(m_prev + bl[e] - m_i);
          vec[2 * QP + j] = expf(total - bl[e] + igv[e] - m_new);
        }
      }
    }
    if (vec && lane == 0) {
      vec[4 * QP] = m_prev == -INFINITY ? 0.f : expf(m_prev + total - m_new);
      vec[4 * QP + 1] = m_new;
    }
  }
  return make_float2(total, wmax);
}

// Launch 1, grid (chunks x row-tile pairs, H, B), 4 warps: W of one (b, h,
// chunk) once, one block for each pair of 16-row tiles (r0, r1) = (pair,
// QT - 1 - pair), so every block (and, with the pair's n8 tiles dealt
// round-robin, every warp) gets the same share of the lower triangle.
// q k^T on the tiles on or below the diagonal, with q and k tiles
// streaming through a ring of W_STAGES stages; then W_ij = (q_i . k_j) /
// sqrt(D) * exp(b_i - b_j + ig_j - m_i) where j <= i, 0 elsewhere (the
// masked exponential is never evaluated), its fp32 row sums, and W as
// bf16 hi + lo fragments.  The stabiliser before the chunk comes from the
// earlier chunks' gates, redone here (O(S)): chunk c maps m to
// max(m + total_c, max_j w_j), maps compose, so the 4 warps compose a
// quarter of the chunks each and warp 0 applies the four in order.  The
// pair-0 block writes the chunk's vectors, and the last chunk's the final m.
__global__ void __launch_bounds__(W_WARPS * 32)
    mlstm_w_bf16(const __grid_constant__ TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char smem_w[];
  char* smc = reinterpret_cast<char*>(smem_w);
  const KTile kt_(p.D);
  const WLayout L(p.Q, p.D);
  const int QP = round16(p.Q), QT = QP / 16, KT = kt_.KT;
  const int NKT = (p.D + KT - 1) / KT;
  bf16* ring = reinterpret_cast<bf16*>(smc);  // per stage: q (32 rows), k (QP rows)
  float* bq = reinterpret_cast<float*>(smc + L.vec);
  float* igs = bq + QP;
  float* mis = igs + QP;
  float* rsp = mis + QP;                  // [W_WARPS][32]
  float* maps = rsp + W_WARPS * 32;       // [W_WARPS][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smc + L.bar);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int npair = (QT + 1) / 2;
  const int ch = blockIdx.x / npair;
  const int pair = blockIdx.x - ch * npair;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nch = gridDim.x / npair;
  const int t0 = ch * p.Q;
  const int qv = min(p.Q, p.L - t0);
  const int r0 = pair, r1 = QT - 1 - pair;
  const int nkr = (r1 + 1) * 16;  // k rows the pair reads
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + t0 * p.qss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh + t0 * p.kss;
  const bf16* ig_g = static_cast<const bf16*>(p.ig) + b * p.isb + h * p.ish;
  const bf16* fg_g = static_cast<const bf16*>(p.fg) + b * p.fsb + h * p.fsh;
  float* vec = tp.scratch + (static_cast<int64_t>(b * p.H + h) * nch + ch) * Scratch(p.Q).per;
  uint4* wfrag = reinterpret_cast<uint4*>(vec + Scratch(p.Q).vec);
  const auto off = [&](int r, int u) { return kt_.off(r, u); };
  const auto off_r1 = [&](int r, int u) { return kt_.off(r + 16, u); };

  // Tile kt into stage kt % W_STAGES: by TMA (thread 0; q as the pair's two
  // 16-row boxes, k as one box of the chunk's Q rows; the bytes complete the
  // stage's mbarrier), else by every thread's plain loads of the rows the
  // pair reads.  Where Q is not a multiple of 16, q rows past the chunk are
  // the next chunk's (or zeros past the sequence); they only reach rows of
  // W that no h reads.
  auto stage = [&](int kt) {
    if (kt >= NKT) return;
    bf16* qs = ring + (kt % W_STAGES) * (L.stage / 2);
    bf16* ks = qs + L.qt;
    if (tp.tma) {
      if (tid == 0) {
        uint64_t* bar = &bars[kt % W_STAGES];
        mma::mbar_expect_tx(bar, ((r1 != r0 ? 32 : 16) + p.Q) * KT * 2);
        mma::tma_load_4d(qs, &tp.q16map, bar, kt * KT, h, t0 + r0 * 16, b);
        if (r1 != r0)
          mma::tma_load_4d(qs + 16 * KT, &tp.q16map, bar, kt * KT, h, t0 + r1 * 16, b);
        mma::tma_load_4d(ks, &tp.kmap, bar, kt * KT, h, t0, b);
      }
      return;
    }
    const int c0 = kt * KT;
    stage_rows(qs, off, qg + r0 * 16 * p.qss + c0, p.qss, qv - r0 * 16, 16, KT, p.D - c0, false,
               tid, W_WARPS * 32);
    if (r1 != r0)
      stage_rows(qs, off_r1, qg + r1 * 16 * p.qss + c0, p.qss, qv - r1 * 16, 16, KT, p.D - c0,
                 false, tid, W_WARPS * 32);
    stage_rows(ks, off, kg + c0, p.kss, qv, nkr, KT, p.D - c0, false, tid, W_WARPS * 32);
  };
  if (tp.tma) {
    // k rows Q..QP-1 of every stage, which TMA does not fill, stay zero.
    for (int i = tid; i < W_STAGES * (QP - p.Q) * KT; i += W_WARPS * 32) {
      const int st = i / ((QP - p.Q) * KT);
      ring[st * (L.stage / 2) + L.qt + p.Q * KT + i - st * (QP - p.Q) * KT] =
          __float2bfloat16_rn(0.f);
    }
    if (tid == 0) {
      for (int st = 0; st < W_STAGES; ++st) mma::mbar_init(&bars[st], 1);
      mma::fence_mbar_init();
    }
    __syncthreads();
  }
#pragma unroll
  for (int st = 0; st < W_STAGES - 1; ++st) stage(st);

  // The stabiliser before the chunk: warp w composes the maps of chunks
  // [w ch / 4, (w + 1) ch / 4); warp 0 applies the four, then does this
  // chunk's gate math.
  {
    float T = 0.f, Wm = -INFINITY;
    for (int c = warp * ch / W_WARPS; c < (warp + 1) * ch / W_WARPS; ++c) {
      const float2 tw = gate_chunk<false>(ig_g, fg_g, p.iss, p.fss, c * p.Q,
                                          min(p.Q, p.L - c * p.Q), QP, 0.f, nullptr, nullptr,
                                          nullptr, nullptr);
      T += tw.x;
      Wm = fmaxf(Wm + tw.x, tw.y);
    }
    if (lane == 0) {
      maps[2 * warp] = T;
      maps[2 * warp + 1] = Wm;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < W_WARPS; ++w) m = fmaxf(m + maps[2 * w], maps[2 * w + 1]);
    const float2 tw = gate_chunk<true>(ig_g, fg_g, p.iss, p.fss, t0, qv, QP, m, bq, igs, mis,
                                       pair == 0 ? vec : nullptr);
    m = fmaxf(m + tw.x, tw.y);
    if (pair == 0 && ch == nch - 1 && lane == 0) p.m[static_cast<int64_t>(b) * p.H + h] = m;
  }

  const int n0cnt = 2 * r0 + 2;  // n8 tiles of row tile r0 on or below the diagonal
  const int ntot = n0cnt + (r1 != r0 ? 2 * r1 + 2 : 0);
  float acc[W_MAX][4];
#pragma unroll
  for (int w = 0; w < W_MAX; ++w) acc[w][0] = acc[w][1] = acc[w][2] = acc[w][3] = 0.f;

  for (int kt = 0; kt < NKT; ++kt) {
    if (tp.tma) mma::mbar_wait(&bars[kt % W_STAGES], (kt / W_STAGES) & 1);
    __syncthreads();
    stage(kt + W_STAGES - 1);
    const bf16* Qs = ring + (kt % W_STAGES) * (L.stage / 2);
    const bf16* Ks = Qs + L.qt;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk * 16 >= KT) break;
      uint32_t a0[4], a1[4];
      mma::ldmatrix_x4(a0, Qs + kt_.off(lane & 15, 2 * kk + (lane >> 4)));
      mma::ldmatrix_x4(a1, Qs + kt_.off(16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int w = 0; w < W_MAX; ++w) {
        const int idx = warp + w * W_WARPS;
        if (idx >= ntot) break;
        const bool second = idx >= n0cnt;
        const int n = second ? idx - n0cnt : idx;
        uint32_t a[4], bb[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = second ? a1[e] : a0[e];
        mma::ldmatrix_x2(bb, Ks + kt_.off(n * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
        mma::mma_bf16(acc[w], a, bb[0], bb[1]);
      }
    }
  }
  __syncthreads();  // b, the input gate and m_i from warp 0

  const float inv_sqrt_d = 1.f / p.sqrt_d;
  float rs0[2] = {0.f, 0.f}, rs1[2] = {0.f, 0.f};  // rows g, g + 8 of r0 and of r1
#pragma unroll
  for (int w = 0; w < W_MAX; ++w) {
    const int idx = warp + w * W_WARPS;
    if (idx >= ntot) break;
    const bool second = idx >= n0cnt;
    const int n = second ? idx - n0cnt : idx;
    const int r = second ? r1 : r0;
    float wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r * 16 + mma::acc_row(lane, e);
      const int j = n * 8 + mma::acc_col(lane, e);
      wv[e] = j <= i ? acc[w][e] * inv_sqrt_d * expf(bq[i] - bq[j] + igs[j] - mis[i]) : 0.f;
    }
    if (second) {
      rs1[0] += wv[0] + wv[1];
      rs1[1] += wv[2] + wv[3];
    } else {
      rs0[0] += wv[0] + wv[1];
      rs0[1] += wv[2] + wv[3];
    }
    uint32_t hA, lA, hB, lB;
    mma::split_bf16(wv[0], wv[1], hA, lA);
    mma::split_bf16(wv[2], wv[3], hB, lB);
    wfrag[(r * (r + 1) / 2 + (n >> 1)) * 64 + (n & 1) * 32 + lane] = make_uint4(hA, hB, lA, lB);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0[u] += __shfl_xor_sync(0xffffffffu, rs0[u], o);
      rs1[u] += __shfl_xor_sync(0xffffffffu, rs1[u], o);
    }
  }
  if (t == 0) {
    rsp[warp * 32 + g] = rs0[0];
    rsp[warp * 32 + g + 8] = rs0[1];
    rsp[warp * 32 + 16 + g] = rs1[0];
    rsp[warp * 32 + 16 + g + 8] = rs1[1];
  }
  __syncthreads();
  if (tid < (r1 != r0 ? 32 : 16)) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W_WARPS; ++w) s += rsp[w * 32 + tid];
    vec[3 * QP + (tid < 16 ? r0 * 16 + tid : r1 * 16 + tid - 16)] = s;
  }
}

// Launch 2, grid (D / VB, H, B), 16 warps: a block owns S[:, v0:v0+VB] in
// fp32 shared memory and loops over the chunks.  Per chunk, q and k stream
// through KT-column tiles, the next one landing (by TMA, one thread's
// request; else by plain loads) while this one is used.  Per tile: cw (.) k
// is split into bf16 hi + lo in shared memory and n's update summed from
// it in fp32;
// q S gains this tile's rows of S (row-tile pairs; S's rows split into
// hi + lo B fragments) and q . n its columns (fp32); then, since those rows
// of S are read no more in this chunk, they are updated: S = scale S +
// (cw (.) k)^T v.  Then h = (e_i q S / sqrt(D) + W v) / max(|e_i q . n /
// sqrt(D) + rowsum W|, exp(-m_i)), with W read as fragments from the
// scratch, the next tile's fragments in flight while one is multiplied.
__global__ void __launch_bounds__(F_WARPS * 32, 1)
    mlstm_fwd_bf16(const __grid_constant__ TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  char* smc = reinterpret_cast<char*>(smem_tc);
  const int Q = p.Q, D = p.D, VB = tp.vb;
  const KTile kt_(D);
  const TcLayout L(Q, D, VB);
  const int QP = round16(Q), QT = QP / 16, KT = kt_.KT, U = kt_.U;
  const int NKT = (D + KT - 1) / KT;
  const int SS = L.SS, VS = L.VS, VT8 = L.VP / 8;
  const int tile = QP * KT;
  float* Ss = reinterpret_cast<float*>(smc + L.s);
  float* mis = reinterpret_cast<float*>(smc + L.vec);
  float* isc = mis + QP;
  float* cw = isc + QP;
  float* rs = cw + QP;
  float* qns = rs + QP;
  float* nv = reinterpret_cast<float*>(smc + L.nv);
  float* npart = reinterpret_cast<float*>(smc + L.npart);  // [F_WARPS][32]
  float* scal = reinterpret_cast<float*>(smc + L.scal);
  bf16* tiles = reinterpret_cast<bf16*>(smc + L.tiles);  // q0, k0, q1, k1
  bf16* Klo = reinterpret_cast<bf16*>(smc + L.klo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smc + L.bar);
  bf16* Vs = reinterpret_cast<bf16*>(smc + L.v);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int vblk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int v0 = vblk * VB;
  const int nch = (p.L + Q - 1) / Q;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh + v0;
  bf16* hg = static_cast<bf16*>(p.h) + b * p.hsb + h * p.hsh + v0;
  const int per = Scratch(Q).per;
  const float* scb = tp.scratch + static_cast<int64_t>(b * p.H + h) * nch * per;
  const float inv_sqrt_d = 1.f / p.sqrt_d;
  const auto off = [&](int r, int u) { return kt_.off(r, u); };
  const auto voff = [&](int r, int u) { return r * VS + u * 8; };
  constexpr int ISSUER = (F_WARPS - 1) * 32;  // the thread that issues TMA copies

  // q and k tile kt of chunk ch into buffer buf: by TMA, Q rows (rows past
  // the sequence and columns past D come as zeros), whose bytes complete
  // the buffer's mbarrier; else (rows not in whole 16-byte units, or no
  // tensor map) by every thread's plain loads.
  auto stage = [&](int ch, int kt, int buf) {
    if (tp.tma) {
      if (tid == ISSUER) {
        mma::fence_proxy_async();  // after the block's writes to this buffer
        mma::mbar_expect_tx(&bars[buf], 4 * Q * KT);
        mma::tma_load_4d(tiles + 2 * buf * tile, &tp.qmap, &bars[buf], kt * KT, h, ch * Q, b);
        mma::tma_load_4d(tiles + (2 * buf + 1) * tile, &tp.kmap, &bars[buf], kt * KT, h, ch * Q,
                         b);
      }
      return;
    }
    const int t0 = ch * Q;
    const int qv = min(Q, p.L - t0);
    const int c0 = kt * KT;
    stage_rows(tiles + 2 * buf * tile, off, qg + t0 * p.qss + c0, p.qss, qv, QP, KT, D - c0,
               false, tid, F_WARPS * 32);
    stage_rows(tiles + (2 * buf + 1) * tile, off, kg + t0 * p.kss + c0, p.kss, qv, QP, KT,
               D - c0, false, tid, F_WARPS * 32);
  };

  // q S and W v: row-tile pairs (r0, r1) = (pair, QT - 1 - pair), NS warps
  // a pair, the n8 value tiles dealt round-robin to them.
  const int npair = (QT + 1) / 2;
  const int NS = F_WARPS / npair;
  const int pair = warp / NS;
  const int sub = warp - pair * NS;
  const bool active = pair < npair;
  const int r0 = pair, r1 = QT - 1 - pair;
  // The update: the (m16, n8) tiles of the KT x VP block of S, MT row tiles.
  const int MT = KT / 16;
  const int u_m = warp % MT;
  const int u_c0 = warp / MT;
  const int u_step = F_WARPS / MT;

  {
    float4* s4 = reinterpret_cast<float4*>(Ss);
    for (int i = tid; i < round16(D) * SS / 4; i += F_WARPS * 32) s4[i] = make_float4(0, 0, 0, 0);
  }
  for (int i = tid; i < round16(D); i += blockDim.x) nv[i] = 0.f;
  if (tp.tma) {
    // TMA fills Q rows of a tile; rows Q..QP-1 stay zero.  Warp 15 issues
    // the copies (like warp 14, it has one update tile where 0-7 have two).
    for (int i = tid; i < 4 * (QP - Q) * KT; i += blockDim.x) {
      const int tl = i / ((QP - Q) * KT);
      const int e = i - tl * (QP - Q) * KT;
      tiles[tl * tile + Q * KT + e] = __float2bfloat16_rn(0.f);
    }
    if (tid == ISSUER) {
      mma::mbar_init(&bars[0], 1);
      mma::mbar_init(&bars[1], 1);
      mma::fence_mbar_init();
    }
    __syncthreads();
  }
  stage(0, 0, 0);
  int T = 0;  // q/k tiles consumed so far (buffer T & 1)

  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * Q;
    const int qv = min(Q, p.L - t0);
    const float* vec = scb + static_cast<int64_t>(ch) * per;
    const uint4* wfrag = reinterpret_cast<const uint4*>(vec + Scratch(Q).vec);
    __syncthreads();  // the last chunk's h is done with v and the vectors
    for (int i = tid; i < 4 * QP; i += F_WARPS * 32) mis[i] = vec[i];  // m_i, e_i, cw, rowsum W
    if (tid == 0) scal[0] = vec[4 * QP];
    stage_rows(Vs, voff, vg + t0 * p.vss, p.vss, qv, QP, L.VP, VB, tp.vec16, tid, F_WARPS * 32);
    mma::cp_async_commit();

    float acc[2][F_MAX_C][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < F_MAX_C; ++c)
        acc[s][c][0] = acc[s][c][1] = acc[s][c][2] = acc[s][c][3] = 0.f;
    float qn = 0.f;

    for (int kt = 0; kt < NKT; ++kt, ++T) {
      const int buf = T & 1;
      const int k0 = kt * KT;
      if (tp.tma) mma::mbar_wait(&bars[buf], (T >> 1) & 1);
      mma::cp_async_wait<0>();
      __syncthreads();
      const float scale_old = scal[0];
      const bf16* Qs = tiles + 2 * buf * tile;
      bf16* Ks = tiles + (2 * buf + 1) * tile;
      if (kt + 1 < NKT) stage(ch, kt + 1, buf ^ 1);
      else if (ch + 1 < nch) stage(ch + 1, 0, buf ^ 1);
      {
        // cw (.) k into hi (in place of k) and lo, a 16-byte unit a thread,
        // and n's partial sums over each warp's rows.
        {
          const int j = tid / U;
          const int u = tid - j * U;
          float x[8];
          if (j < QP) {
            const int o = kt_.off(j, u);
            const uint4 raw = *reinterpret_cast<const uint4*>(Ks + o);
            const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
            const float c = cw[j];
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 kk = mma::unpack_bf16(w4[e]);
              x[2 * e] = c * kk.x;
              x[2 * e + 1] = c * kk.y;
              mma::split_bf16(x[2 * e], x[2 * e + 1], hi[e], lo[e]);
            }
            *reinterpret_cast<uint4*>(Ks + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(Klo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = 0.f;
          }
          // Sum over the warp's rows (the lanes of one unit) by reduce-scatter:
          // after the xor-16, -8 and -4 steps a lane holds the sum of column
          // 4 bit4 + 2 bit3 + bit2 of its unit (lane % U).
          float y[4], z[2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool up = lane & 16;
            y[e] = (up ? x[e + 4] : x[e]) + __shfl_xor_sync(0xffffffffu, up ? x[e] : x[e + 4], 16);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool up = lane & 8;
            z[e] = (up ? y[e + 2] : y[e]) + __shfl_xor_sync(0xffffffffu, up ? y[e] : y[e + 2], 8);
          }
          const bool up = lane & 4;
          float w = (up ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, up ? z[0] : z[1], 4);
          if (U == 2) w += __shfl_xor_sync(0xffffffffu, w, 2);
          const int col = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
          if (U == 4 || (lane & 2) == 0) npart[warp * 32 + (lane % U) * 8 + col] = w;
        }
        // q . n in fp32, U threads a row, a 16-byte unit each.
        {
          const int i = tid / U;
          const int u = tid - i * U;
          if (i < QP) {
            const uint4 x = *reinterpret_cast<const uint4*>(Qs + kt_.off(i, u));
            const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
            const float* nrow = nv + k0 + u * 8;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 qq = mma::unpack_bf16(w4[e]);
              qn = fmaf(qq.x, nrow[2 * e], fmaf(qq.y, nrow[2 * e + 1], qn));
            }
          }
        }
        // q S over this tile's rows of S.
        if (active) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (kk * 16 >= KT) break;
            uint32_t a0[4], a1[4];
            mma::ldmatrix_x4(a0, Qs + kt_.off(r0 * 16 + (lane & 15), 2 * kk + (lane >> 4)));
            mma::ldmatrix_x4(a1, Qs + kt_.off(r1 * 16 + (lane & 15), 2 * kk + (lane >> 4)));
            const float* srow = Ss + (k0 + kk * 16 + 2 * t) * SS + g;
#pragma unroll
            for (int c = 0; c < F_MAX_C; ++c) {
              const int n = sub + c * NS;
              if (n >= VT8) break;
              const float* sp = srow + n * 8;
              uint32_t bh0, bl0, bh1, bl1;
              mma::split_bf16(sp[0], sp[SS], bh0, bl0);
              mma::split_bf16(sp[8 * SS], sp[9 * SS], bh1, bl1);
              mma::mma_bf16(acc[0][c], a0, bh0, bh1);
              mma::mma_bf16(acc[0][c], a0, bl0, bl1);
              if (r1 != r0) {
                mma::mma_bf16(acc[1][c], a1, bh0, bh1);
                mma::mma_bf16(acc[1][c], a1, bl0, bl1);
              }
            }
          }
        }
      }
      __syncthreads();

      // n of this tile's rows (read by q . n above): the scale and the
      // warps' partial sums, by warp 14 (it has one update tile, not two).
      if (warp == F_WARPS - 2 && lane < KT) {
        float s = nv[k0 + lane] * scale_old;
#pragma unroll
        for (int w = 0; w < F_WARPS; ++w) s += npart[w * 32 + lane];
        nv[k0 + lane] = s;
      }
      // S = scale S + (cw (.) k)^T v on this tile's rows.
      if (u_c0 < VT8) {
        float up[F_MAX_U][4];
#pragma unroll
        for (int u = 0; u < F_MAX_U; ++u) {
          const int c = u_c0 + u * u_step;
          if (c >= VT8) break;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 s = *reinterpret_cast<const float2*>(
                Ss + (k0 + u_m * 16 + g + 8 * r) * SS + c * 8 + 2 * t);
            up[u][2 * r] = s.x * scale_old;
            up[u][2 * r + 1] = s.y * scale_old;
          }
        }
#pragma unroll 2
        for (int jt = 0; jt < QT; ++jt) {
          if (jt * 16 >= qv) break;
          const int ka = kt_.off(jt * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * u_m + ((lane >> 3) & 1));
          uint32_t kh[4], kl[4];
          mma::ldmatrix_x4_trans(kh, Ks + ka);
          mma::ldmatrix_x4_trans(kl, Klo + ka);
          const int vrow = jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int u = 0; u < F_MAX_U; ++u) {
            const int c = u_c0 + u * u_step;
            if (c >= VT8) break;
            uint32_t vb[2];
            mma::ldmatrix_x2_trans(vb, Vs + vrow * VS + c * 8);
            mma::mma_bf16(up[u], kh, vb[0], vb[1]);
            mma::mma_bf16(up[u], kl, vb[0], vb[1]);
          }
        }
#pragma unroll
        for (int u = 0; u < F_MAX_U; ++u) {
          const int c = u_c0 + u * u_step;
          if (c >= VT8) break;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(Ss + (k0 + u_m * 16 + g + 8 * r) * SS + c * 8 + 2 * t) =
                make_float2(up[u][2 * r], up[u][2 * r + 1]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      if (o < U) qn += __shfl_xor_sync(0xffffffffu, qn, o);
    if (tid % U == 0 && tid / U < QP) qns[tid / U] = qn * inv_sqrt_d;
    __syncthreads();

    // h = (e_i q S / sqrt(D) + W v) / max(|e_i q . n / sqrt(D) + rowsum W|, exp(-m_i)).
    if (active) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = s == 0 ? r0 : r1;
        if ((s == 1 && r1 == r0) || r * 16 >= qv) continue;
        const int i0 = r * 16;
        const float e0 = isc[i0 + g] * inv_sqrt_d;
        const float e1 = isc[i0 + g + 8] * inv_sqrt_d;
#pragma unroll
        for (int c = 0; c < F_MAX_C; ++c) {
          acc[s][c][0] *= e0;
          acc[s][c][1] *= e0;
          acc[s][c][2] *= e1;
          acc[s][c][3] *= e1;
        }
        const int nj = min(r + 1, (qv + 15) / 16);
        const uint4* wf = wfrag + r * (r + 1) / 2 * 64 + lane;
        uint4 w0 = wf[0], w1 = wf[32];
        for (int jt = 0; jt < nj; ++jt) {
          const uint32_t wh[4] = {w0.x, w0.y, w1.x, w1.y};
          const uint32_t wl[4] = {w0.z, w0.w, w1.z, w1.w};
          if (jt + 1 < nj) {  // the next tile's fragments, in flight during these products
            w0 = wf[(jt + 1) * 64];
            w1 = wf[(jt + 1) * 64 + 32];
          }
          const int vrow = jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int c = 0; c < F_MAX_C; ++c) {
            const int n = sub + c * NS;
            if (n >= VT8) break;
            uint32_t vb[2];
            mma::ldmatrix_x2_trans(vb, Vs + vrow * VS + n * 8);
            mma::mma_bf16(acc[s][c], wh, vb[0], vb[1]);
            mma::mma_bf16(acc[s][c], wl, vb[0], vb[1]);
          }
        }
        float inv_den[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + g + 8 * rr;
          inv_den[rr] = 1.f / fmaxf(fabsf(isc[i] * qns[i] + rs[i]), expf(-mis[i]));
        }
#pragma unroll
        for (int c = 0; c < F_MAX_C; ++c) {
          const int n = sub + c * NS;
          const int col = n * 8 + 2 * t;
          if (n >= VT8 || col >= VB) break;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = i0 + g + 8 * rr;
            if (i < qv)
              *reinterpret_cast<__nv_bfloat162*>(hg + (t0 + i) * p.hss + col) =
                  __floats2bfloat162_rn(acc[s][c][2 * rr] * inv_den[rr],
                                        acc[s][c][2 * rr + 1] * inv_den[rr]);
          }
        }
      }
    }
  }
  __syncthreads();

  float* sg = p.S + (static_cast<int64_t>(b) * p.H + h) * D * D + v0;
  const int VB4 = VB / 4;
  for (int e = tid; e < D * VB4; e += blockDim.x) {
    const int row = e / VB4;
    const int col = (e - row * VB4) * 4;
    *reinterpret_cast<float4*>(sg + static_cast<int64_t>(row) * D + col) =
        *reinterpret_cast<const float4*>(Ss + row * SS + col);
  }
  if (vblk == 0) {
    float* ng = p.n + (static_cast<int64_t>(b) * p.H + h) * D;
    for (int i = tid; i < D; i += blockDim.x) ng[i] = nv[i];
  }
}

// A (B, L, H, D) bf16 tensor with element strides sb, ss, sh (last axis
// contiguous) as a 4-D tensor map (D, H, L, B), box KT x 1 x rows x 1,
// rows of KT swizzled as KTile lays them out (64-byte or 32-byte swizzle).
bool encode(CUtensorMap* map, const void* base, int64_t sb, int64_t ss, int64_t sh, const Params& p,
            int KT, int rows) {
  const mma::EncodeTiled fn = mma::tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.L), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(KT), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            KT == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

TcParams tc_params(const Params& p, void* scratch) {
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec16 = al16(p.q) && al16(p.k) && al16(p.v) && p.D % 8 == 0 && p.qsb % 8 == 0 &&
                     p.qss % 8 == 0 && p.qsh % 8 == 0 && p.ksb % 8 == 0 && p.kss % 8 == 0 &&
                     p.ksh % 8 == 0 && p.vsb % 8 == 0 && p.vss % 8 == 0 && p.vsh % 8 == 0;
  TcParams tp{};
  tp.p = p;
  tp.scratch = static_cast<float*>(scratch);
  tp.vb = value_cols(p.Q, p.D);
  tp.vec16 = vec16 ? 1 : 0;
  const int KT = KTile(p.D).KT;
  tp.tma = vec16 && encode(&tp.qmap, p.q, p.qsb, p.qss, p.qsh, p, KT, p.Q) &&
           encode(&tp.kmap, p.k, p.ksb, p.kss, p.ksh, p, KT, p.Q) &&
           encode(&tp.q16map, p.q, p.qsb, p.qss, p.qsh, p, KT, 16);
  return tp;
}

cudaError_t launch_bf16(const Params& p, void* scratch, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(mlstm_fwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mlstm_w_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WLayout(MAX_Q, MAX_D).bytes);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const TcParams tp = tc_params(p, scratch);
  const int nch = (p.L + p.Q - 1) / p.Q;
  const int npair = (round16(p.Q) / 16 + 1) / 2;
  mlstm_w_bf16<<<dim3(nch * npair, p.H, p.B), W_WARPS * 32, WLayout(p.Q, p.D).bytes, stream>>>(
      tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_fwd_bf16<<<dim3(p.D / tp.vb, p.H, p.B), F_WARPS * 32, TcLayout(p.Q, p.D, tp.vb).bytes,
                   stream>>>(tp);
  return cudaGetLastError();
}

bool d_supported(int D) {
  return D >= 4 && D % 4 == 0 && (D <= COLS || (D % COLS == 0 && D <= MAX_D));
}

bool q_supported(int Q) { return Q >= 4 && Q <= MAX_Q && Q % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block takes at these sizes.  dtype:
// 0 = float32 (the scalar kernel), 1 = bfloat16 (mlstm_fwd_bf16, the
// larger of the two bf16 kernels; mlstm_scan_w_smem_bytes gives the other).
extern "C" int mlstm_scan_smem_bytes(int Q, int D, int dtype) {
  if (dtype == 1) return TcLayout(Q, D, value_cols(Q, D)).bytes;
  return static_cast<int>(sizeof(float) * Layout(Q, D).total);
}

// Bytes of dynamic shared memory a block of mlstm_w_bf16 takes.
extern "C" int mlstm_scan_w_smem_bytes(int Q, int D) { return WLayout(Q, D).bytes; }

// Value columns of S a block owns (the grid's first axis is D / this).
extern "C" int mlstm_scan_value_cols(int Q, int D, int dtype) {
  if (dtype == 1) return value_cols(Q, D);
  return Layout(Q, D).VB;
}

// Bytes of scratch (float32, device memory) a call needs: 0 for float32;
// for bfloat16 W and the chunk vectors of every (b, h, chunk).
extern "C" int64_t mlstm_scan_scratch_bytes(int B, int L, int H, int Q, int dtype) {
  if (dtype != 1 || B <= 0 || L <= 0 || H <= 0 || !q_supported(Q)) return 0;
  return static_cast<int64_t>(sizeof(float)) * B * H * ((L + Q - 1) / Q) * Scratch(Q).per;
}

// dtype (of q, k, v, both gates and h): 0 = float32, 1 = bfloat16.  S
// (B, H, D, D), n (B, H, D) and m (B, H) float32 contiguous; scratch: the
// float32 buffer of mlstm_scan_scratch_bytes (unused for float32).
// Returns a cudaError_t (0 on success).
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v, const void* ig,
                              const void* fg, void* h, void* S, void* n, void* m, void* scratch,
                              int dtype, int B, int L, int H, int D, int Q,
                              int64_t qsb, int64_t qss, int64_t qsh,
                              int64_t ksb, int64_t kss, int64_t ksh,
                              int64_t vsb, int64_t vss, int64_t vsh,
                              int64_t isb, int64_t iss, int64_t ish,
                              int64_t fsb, int64_t fss, int64_t fsh,
                              int64_t hsb, int64_t hss, int64_t hsh, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 || !d_supported(D) ||
      !q_supported(Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, ig, fg, h,
                 static_cast<float*>(S), static_cast<float*>(n), static_cast<float*>(m),
                 B, L, H, D, Q, sqrtf(static_cast<float>(D)),
                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                 isb, iss, ish, fsb, fss, fsh, hsb, hss, hsh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(p, s); break;
    case 1: err = scratch ? launch_bf16(p, scratch, s) : cudaErrorInvalidValue; break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
