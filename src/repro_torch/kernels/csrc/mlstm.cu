// Chunked stabilised mLSTM for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces: src/repro/kernels/mlstm.py::_mlstm_kernel, launched by
// mlstm_scan_pallas.  It computes the function of
// repro_torch.kernels.ref.mlstm_chunked (h and the final state) in fp32
// arithmetic.  Per (b, h) and chunk of Q steps, with the matrix memory
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
// What bounds it.  At the serve path's shape (B 8, S 512, H 4, D 384,
// Q 128, bf16) the call must read q, k, v (3 x 12.6 MB) and the gates, and
// write h (12.6 MB) and the fp32 final state (18.9 MB): ~69 MB, 21 us at
// 3.35 TB/s.  It does 4 Q D (Q + D) = 100.7 MFLOP per (b, h, chunk) (the
// products q k^T, q S, W v and k^T v), x 128 = 12.9 GFLOP: 13 us at the
// dense bf16 tensor-core peak.  So the bound is bytes, 21 us.  This first
// version does its products as scalar fp32 FMAs (67 TFLOP/s).
//
// What the design does about it.  The state does not fit in a block: S is
// D x D x 4 = 576 KB of fp32 per (b, h) at D 384, and a block may have
// 227 KB.  So S is split over blocks of value columns: a block owns
// S[:, v0:v0+VB] (VB = 32, 48 KB) and loops over the chunks itself (the
// TPU's sequential chunk axis; Hopper blocks run in no order, so nothing
// carries between them).  Grid (D/VB, H, B) = 12 x 4 x 8 = 384 blocks at the
// serve shape, ~3 waves on 132 SMs.  Everything else a block needs is
// small or recomputed: the gate math (b, m_i, e_i, exp weights: O(Q)) and
// n (D floats) come from the gates and k alone, so every block keeps its
// own copy of n and m, and block 0 writes them out.  q and k stream through
// shared memory in tiles of KT = 32 key columns; per tile a block adds to
// q k^T (lower-triangle 4 x 4 register tiles only, so exp(b_i - b_j + ...)
// above the diagonal is never formed) and to q S and q . n (a 4 x 4 tile of
// (row, value column) a thread), and then, since those rows of S are no
// longer read, applies this chunk's update to them.  After the last tile
// W = q k^T (.) exp(...) goes to shared memory, and h = (e q S + W v) / den.
// Every block recomputes q k^T: D/VB = 12 times the work of that product at
// D 384, 3.24 of the 6.66 M FMAs a block does per chunk (chip_smoke.py
// prints the count).
// One launch with no scratch in device memory was chosen over a second
// launch that builds W once per (b, h, chunk): simpler, and the redundant
// product is FMA time, not bytes.  Shared memory at Q 128, D 384: 171 KB
// (S tile 48 KB, W 66 KB, v tile 16 KB, q and k tiles 33 KB), dynamic,
// set with cudaFuncSetAttribute, one block per SM.  mma/wgmma products,
// sharing q k^T between the blocks of a (b, h) and overlapping the next
// tile's loads are later work.
//
// The stabiliser's start: m is -inf before the first chunk, as in the
// oracle; e_i and the old state's scale are set to 0 there instead of
// evaluating exp(-inf - m), so -inf - (-inf) is never formed.  The build
// does not use --use_fast_math: inf stays IEEE.  A ragged last chunk is
// zero-filled where it is loaded, with log-forget 0 and input gate -inf
// (which neither decays nor feeds the state), and masked where h is
// stored.
//
// Sizes are runtime values: D a multiple of 4 up to 32, or a multiple of
// 32 up to 512; Q a multiple of 4 in [4, 128]; any length S >= 1 (the
// Python wrapper checks; so does the C entry).  q, k, v and the gates may
// be strided views (element strides of their leading axes, last axis of
// q, k, v contiguous); h is written through its strides.  Launch errors
// are returned, never swallowed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

bool d_supported(int D) {
  return D >= 4 && D % 4 == 0 && (D <= COLS || (D % COLS == 0 && D <= MAX_D));
}

bool q_supported(int Q) { return Q >= 4 && Q <= MAX_Q && Q % 4 == 0; }

}  // namespace

// Bytes of dynamic shared memory a block takes at these sizes.
extern "C" int mlstm_scan_smem_bytes(int Q, int D) {
  return static_cast<int>(sizeof(float) * Layout(Q, D).total);
}

// dtype (of q, k, v, both gates and h): 0 = float32, 1 = bfloat16.  S
// (B, H, D, D), n (B, H, D) and m (B, H) float32 contiguous.  Returns a
// cudaError_t (0 on success).
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v, const void* ig,
                              const void* fg, void* h, void* S, void* n, void* m, int dtype,
                              int B, int L, int H, int D, int Q,
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
    case 1: err = launch<__nv_bfloat16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
