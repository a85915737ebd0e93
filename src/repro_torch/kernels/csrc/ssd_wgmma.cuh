// Pieces shared by the bf16 SSD kernels for NVIDIA Hopper (sm_90a):
// ssd.cu's ssd_fwd_wgmma and ssd_bwd.cu's ssd_bwd_wgmma.  Header-only; the
// build hashes it into every library's name.
//
// Both kernels split a (b, head) scan over the chunk axis into the blocks
// of one thread-block cluster (at most 8, each taking k = ceil(nc / 8)
// consecutive chunks), and hand the state from block to block through
// distributed shared memory; a block holds a group of G heads of one
// (b, chunk range).  What is here: the plan of chunks and clusters, the
// group-size rule, the byte offset of an element of a 128-byte-swizzled
// 64-column bf16 slab (the layout a TMA box with SWIZZLE_128B writes and
// the wgmma descriptors of mma_bf16.cuh read), the cluster's barrier,
// address map and the bulk copy of a state into another block's inbox,
// wider stores of an accumulator, a chunk's operand tiles by TMA or, for
// a view TMA cannot describe, by plain loads, and the chunk's cumulative
// log-decay per head with the row vectors of decays formed from it.

#pragma once

#include <climits>

#include "mma_bf16.cuh"

namespace ssdw {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 128;                   // a chunk's rows in shared memory (Q <= 128)
constexpr int TILE_BYTES = ROWS * 128;      // 128 rows x 64 bf16 columns, swizzled
constexpr int SLAB_BYTES = 64 * 128;        // 64 x 64 bf16, swizzled (a state's hi or lo)
constexpr int STATE_BYTES = 64 * 64 * 4;    // a state in fp32, as a hand-off sends it
constexpr int THREADS = 256;                // two warpgroups
constexpr int MAX_CLUSTER = 8;              // the portable cluster size
constexpr int CB_LD = 72;                   // floats a row of a 64 x 64 block of C B^T
constexpr int CB_BLOCK = 64 * CB_LD * 4;    // bytes of one block
constexpr int CB_BYTES = 3 * CB_BLOCK;      // blocks (0,0), (1,0), (1,1) of the 128 x 128
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of element (row, col) of a 128-byte-swizzled slab of 64 bf16
// columns whose base is 1024-byte aligned: 16-byte unit u of row r at
// unit u ^ (r % 8).
__host__ __device__ constexpr int sw(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

// Chunks a block takes (k) and blocks a cluster (cs) for nc chunks: at
// most MAX_CLUSTER blocks, each k consecutive chunks, the last fewer.
__host__ __device__ inline void chunk_plan(int nc, int& k, int& cs) {
  k = (nc + MAX_CLUSTER - 1) / MAX_CLUSTER;
  cs = (nc + k - 1) / k;
}

// The group size: of G in [1, gmax], the one that minimises the time of a
// call, ceil(B cs ceil(H / G) / slots) (F + ceil(G / 2)): the waves of the
// grid (slots: the blocks that run at once, whole clusters; on an H100 the
// occupancy query places 120 in clusters of 4, not 132) times a block's
// time, a fixed part F (its tiles' load, the hand-off, C B^T) and one unit
// a pair of heads (the two warpgroups walk a pair at once).  F = 11 / 25
// of a pair: on an H100 a forward block of one pair took 0.59 of a block
// of two.  Ties go to the larger G (C B^T shared by more heads, fewer
// partials).  At zamba2's (B 8, nc 4, H 64) the forward takes G 4 (512
// blocks, 5 waves); at a (2, 2) mesh rank's (4, 4, 32) G 2 (256 blocks,
// 3 waves of one pair, 1.15x faster than G 4's 2 waves of two), and so in
// the long serve mode (clusters of 8; 1.22x); the backward (gmax 2, a
// head a warpgroup) G 2.  src/repro_torch/kernels/ssd.py mirrors it.
inline int group_size(int B, int cs, int H, int gmax, int slots) {
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int g = 1; g <= gmax; ++g) {
    const long long blocks = static_cast<long long>(B) * cs * ((H + g - 1) / g);
    const long long cost = (blocks + slots - 1) / slots * (11 + 25 * ((g + 1) / 2));
    if (cost <= best_cost) {
      best_cost = cost;
      best = g;
    }
  }
  return best;
}

// The blocks of `kernel` (THREADS threads, `smem` bytes of shared memory,
// its attribute set) that run at once on the current device in clusters
// of cs: whole clusters, as the occupancy query places them, times cs.
// Cached per device and cs.
template <typename K>
cudaError_t cluster_slots(K kernel, int cs, int smem, int& slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || cs < 1 || cs > MAX_CLUSTER) return cudaErrorInvalidValue;
  static int cache[64][MAX_CLUSTER + 1] = {};
  if (cache[dev][cs] <= 0) {
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(cs * 64);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;  // not even one cluster fits
    cache[dev][cs] = n * cs;
  }
  slots = cache[dev][cs];
  return cudaSuccess;
}

// Whether TMA can describe a (B, heads, seq, width) bf16 view: a 16-byte
// aligned base and row, head and batch strides of whole 16 bytes.
inline bool describable(const void* base, const int64_t* s) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 &&
         s[2] % 8 == 0 && s[0] > 0 && s[1] > 0 && s[2] > 0;
}

// The cluster barrier in two halves (every thread arrives, then waits);
// the arrival is relaxed: it orders the mbarrier initialisation, which
// fence_mbar_init has released to the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// `p` of this CTA's shared memory at the same place in CTA `rank`'s.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(mma::smem_addr(p)), "r"(rank));
  return a;
}
// A warpgroup's 64 x 64 fp32 accumulator (32 a thread) in fragment order:
// element e of thread wt (0..127) at float (e / 4) * 512 + 4 wt + e % 4, so
// a warp's 16-byte stores and loads are whole 512-byte runs.  put_frag
// writes it into a 16 KB buffer of this CTA's shared memory, which
// bulk_to_cluster copies into another CTA's inbox; recv_frag reads it.
__device__ __forceinline__ void put_frag(const float (&s)[32], char* buf, int wt) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    *reinterpret_cast<float4*>(buf + 4 * (q * 512 + 4 * wt)) =
        make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
}
// One thread: `bytes` of this CTA's shared memory from src into another
// CTA's at dst (cluster_addr), completing on its mbarrier bar (cluster_addr)
// as transaction bytes; returns once src has been read.
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, const void* src, uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(mma::smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
  mma::bulk_commit();
  mma::bulk_wait_read<0>();
}
__device__ __forceinline__ void recv_frag(float (&s)[32], const char* inbox, int wt) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(inbox + 4 * (q * 512 + 4 * wt));
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
}
// Wider stores of a warpgroup's 64 x 64 accumulator, whose thread t of a
// quad holds columns 8 jn + 2 t and + 1 of its rows: for the column
// groups jn = 2 m (a) and 2 m + 1 (b), threads t and t ^ 1 swap one half,
// so that each holds the 4 adjacent columns 16 m + quad_col(t) .. + 3.
__device__ __forceinline__ int quad_col(int t) { return t & 1 ? 8 + 2 * (t - 1) : 2 * t; }
// bf16 pairs as 32-bit words.
__device__ __forceinline__ uint2 quad_pair(uint32_t a, uint32_t b, int t) {
  const bool odd = t & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
  return odd ? make_uint2(got, b) : make_uint2(a, got);
}
// fp32 pairs.
__device__ __forceinline__ float4 quad_pair(float2 a, float2 b, int t) {
  const bool odd = t & 1;
  const float2 s = odd ? a : b;
  const float gx = __shfl_xor_sync(0xffffffffu, s.x, 1);
  const float gy = __shfl_xor_sync(0xffffffffu, s.y, 1);
  return odd ? make_float4(gx, gy, b.x, b.y) : make_float4(a.x, a.y, gx, gy);
}
// The 128 threads of warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
// The state's 64 x 64 accumulator as bf16 hi and lo slabs (rows 16 warp +
// g + 8 hf, columns 8 jn + 2 t: the 128-byte-swizzled layout of a K-major
// or MN-major operand); lo may be null.
__device__ __forceinline__ void put_slabs(const float (&s)[32], char* hi, char* lo) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int off = sw(16 * warp + g + 8 * hf, 8 * jn + 2 * t);
      uint32_t vh, vl;
      mma::split_bf16(s[4 * jn + 2 * hf], s[4 * jn + 2 * hf + 1], vh, vl);
      *reinterpret_cast<uint32_t*>(hi + off) = vh;
      if (lo) *reinterpret_cast<uint32_t*>(lo + off) = vl;
    }
}
// mma::mbar_wait, acquiring at cluster scope what other CTAs released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Rows row0 .. row0 + 127 of a tensor map from mma::encode_map (head h,
// batch b) into a 128-row tile, two 64-row boxes; rows past the sequence
// and columns past the width read as zeros.
__device__ __forceinline__ void tma_rows(char* tile, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b) {
  mma::tma_load_4d(tile, map, bar, 0, h, row0, b);
  mma::tma_load_4d(tile + 8192, map, bar, 0, h, row0 + 64, b);
}

// The same tile by plain loads (a view TMA cannot describe), the block's
// threads together: rows past `rows` and columns past `width` are zeros.
__device__ __forceinline__ void plain_rows(char* tile, const bf16* src, int64_t rstride,
                                           int width, int rows) {
  for (int e = threadIdx.x; e < ROWS * 64; e += THREADS) {
    const int row = e >> 6, col = e & 63;
    const bf16 v = row < rows && col < width ? src[row * rstride + col] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<bf16*>(tile + sw(row, col)) = v;
  }
}

// A head's row vectors of the loaded chunk, ROWS floats each, in this
// order: dt, cum, coef_j = 2^(tot - cum_j) dt_j, and in the forward kend_j
// = 2^(cum_e - cum_j) dt_j (e the last row of j's 16-row band), in the
// backward ecum_i = 2^cum_i (0 past the chunk's valid rows).
enum Vec { V_DT, V_CUM, V_COEF, V_KEND, V_ECUM = V_KEND, NV };

// The forward's decays by 16-row band: for j in an earlier band than i,
// 2^(cum_i - cum_j) = 2^(cum_i - cum_e) kend_j / dt_j, both exponents <= 0,
// so a tile's decay off its diagonal bands is a factor a row times a factor
// a column, and only the diagonal bands need exp2 an element.
//
// dt of rows 0..127 of a chunk (0 past its `qv` valid rows) and cum =
// cumsum(dt A) log2 e over them, by one warp (4 rows a lane), into the
// head's row vectors v (Vec; FWD: the forward's).  A tile holds 128 rows
// from the chunk's first: rows past qv are zeros past S, or the next
// chunk's when Q < 128; dt is 0 there, so every vector but cum is too.
template <bool FWD>
__device__ __forceinline__ void chunk_cum(const float* dg, int64_t dss, int qv, float a2,
                                          float* v) {
  const int lane = threadIdx.x & 31;
  float d[4], c[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    d[e] = j < qv ? __ldg(dg + j * dss) : 0.f;
    run += d[e] * a2;
    c[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += excl;
  const float tot = __shfl_sync(0xffffffffu, c[3], 31);
  const float cend = __shfl_sync(0xffffffffu, c[3], lane | 3);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    v[V_DT * ROWS + j] = d[e];
    v[V_CUM * ROWS + j] = c[e];
    v[V_COEF * ROWS + j] = mma::exp2_approx(tot - c[e]) * d[e];
    v[V_KEND * ROWS + j] = FWD ? mma::exp2_approx(cend - c[e]) * d[e]
                               : j < qv ? mma::exp2_approx(c[e]) : 0.f;
  }
}

// The A fragment (m16n8k16 layout, this warp's 16 rows) of k step ks of
// (f x)^T, a 64 x 128 operand whose row p, column j is f_j x[j][p]: x a
// 128-row swizzled tile (rows j, columns p), f a row vector of ROWS
// floats, rows 16 warp .. 16 warp + 15 of p; as bf16 hi and lo halves
// (hi = bf16(v), lo = bf16(v - hi)).
__device__ __forceinline__ void xt_frag(const char* x, int ks, int warp, const float* f,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int mtx = lane >> 3;
  const int j = 16 * ks + ((mtx >> 1) << 3) + (lane & 7);
  const int unit = 2 * warp + (mtx & 1);
  uint32_t xa[4];
  mma::ldmatrix_x4_trans(xa, x + j * 128 + ((unit ^ (j & 7)) << 4));
  const int ja = 16 * ks + 2 * t;
  const float2 fa = *reinterpret_cast<const float2*>(f + ja);
  const float2 fb = *reinterpret_cast<const float2*>(f + ja + 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = mma::unpack_bf16(xa[q]);
    const float2 fq = q < 2 ? fa : fb;
    mma::split_bf16(v.x * fq.x, v.y * fq.y, hi[q], lo[q]);
  }
}

}  // namespace ssdw
