// bf16 tensor-core helpers for NVIDIA Hopper (sm_90a), shared by the bf16
// paths of the kernel sources beside it.  Header-only;
// a kernel source includes it, and the build hashes it into every
// library's name, so an edit rebuilds them all.
//
// What is here: the m16n8k16 bf16 `mma.sync` with fp32 accumulators (the
// warp-synchronous product), `ldmatrix` (x4, x2, x4.trans and x2.trans),
// 16-byte `cp.async` copies (with zero fill) and their commit / wait
// groups, mbarriers and 4-D TMA tile loads, exp2 on the special-function
// unit, bf16 packing and the hi + lo split of an fp32 value, and the
// fragment index maps; for the warpgroup kernels (namespace wgmma):
// shared-memory matrix descriptors of 128-byte-swizzled tiles, the
// asynchronous warpgroup products `wgmma.mma_async` m64nNk16 with A and B
// in shared memory (N 64, 128; at N 64 also with B MN-major) or A in
// registers (N 64, 80, 128, 256),
// their fence / commit / wait, `setmaxnreg`, and named barriers; and on
// the host the tensor-map encoder and the 4-D map of a (b, head, seq, D)
// bf16 tensor that the attention kernels' TMA loads and stores read
// (encode_map: 64-column boxes, zeros past D).
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane = 4 g + t (g = lane >> 2 in 0..7, t = lane & 3):
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k x n), 2 registers:
//     b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   C/D (16 x 8, fp32), 4 registers:
//     c[0], c[1] = C[g][2t, 2t+1]    c[2], c[3] = C[g+8][2t, 2t+1]
// The lower k (or column) index of a pair sits in the low 16 bits.  An
// accumulator pair of two n8 tiles is therefore already an A fragment of
// the next product (k = the two tiles' 16 columns), which is how P of
// attention and w of SSD go from one product to the next in registers.
//
// A product's inner index may be permuted freely as long as both operands
// use the same permutation; flash_attention.cu's decode mode uses that to
// load its operands straight from global memory with wide loads.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// Row and column of accumulator element e (0..3) of an m16n8 tile.
__device__ __forceinline__ int acc_row(int lane, int e) { return (lane >> 2) + ((e >> 1) << 3); }
__device__ __forceinline__ int acc_col(int lane, int e) { return ((lane & 3) << 1) + (e & 1); }

// d += a * b, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared; with `valid` false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and the Tensor Memory Accelerator (TMA).  A tile load by TMA
// is one thread's cp.async.bulk.tensor; it signals its bytes to an
// mbarrier in shared memory, which the readers wait on by phase parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// After mbar_init: the initialisation made visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Orders this thread's (and, after a barrier, the block's) earlier
// shared-memory accesses before its later async-proxy (TMA) ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Arrive on the barrier and expect `bytes` more from TMA in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// One box of a 4-D tensor map (a CUtensorMap in parameter or global
// memory) at coordinates c0..c3 (innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error
// ~2^-22, -inf gives +0, subnormal results flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 1 / x on the special-function unit (rcp.approx.ftz: 1 ulp; +inf gives
// +0).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// x ~ hi + lo with both bf16: hi = bf16(x), lo = bf16(x - hi).  Two products
// with hi and lo carry x to ~2^-16 of itself instead of bf16's 2^-8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// The low (sel 0x5410) or high (0x7632) bf16 halves of x and y, x's low.
__device__ __forceinline__ uint32_t pair_lo(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x5410);
}
__device__ __forceinline__ uint32_t pair_hi(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's
// entry-point query (so nothing links libcuda); null where it is missing.
// Host code: the kernels' launchers encode their TMA tensor maps with it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                                  &res);
#endif
    return e == cudaSuccess && res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                  : nullptr;
  }();
  return fn;
}

// A plain arrival on an mbarrier (a consumer releasing a buffer).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// A (B, heads, seq, D) bf16 tensor at `base` with element strides s[0..2]
// (batch, head, seq; D contiguous) as a 4-D tensor map (D, heads, seq, B)
// whose box is 64 columns x 1 head x `rows` rows x 1 (64 unless given),
// 128-byte swizzled: the slabs of the warpgroup kernels below (a box of
// fewer rows lands as those rows of a 64-row slab would, when its shared
// address is 1024-aligned).  Rows past `seq` and columns past D (a box is
// 64 columns wide at D 16, 32 and 80 too) read as zeros and are not
// written.  False where the map cannot be encoded.
inline bool encode_map(CUtensorMap* map, const void* base, const int64_t* s, int D, int heads,
                       int seq, int B, unsigned rows = 64) {
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn || seq <= 0) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[2]) * 2,
                                 static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One box of shared memory (as a tensor map's box lays it out) stored by
// TMA at coordinates c0..c3, in this thread's bulk group; elements past
// the tensor's bounds are not written.  The shared memory's writes must be
// made visible to the async proxy first (fence_proxy_async), and stay
// until bulk_wait_read<0>() returns.
__device__ __forceinline__ void tma_store_4d(const void* map, const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma

// Warpgroup (4 warps, 128 threads) products of sm_90a.  Operand tiles in
// shared memory are bf16 "slabs" as a 128-byte-swizzled TMA load writes
// them: rows of 64 elements (128 bytes), the 16-byte unit u of row r
// stored at unit u ^ (r % 8), each slab 1024-byte aligned.  A tile of D
// columns is D / 64 such slabs side by side.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): bits 0-13 the start
// address / 16, 16-29 the leading byte offset / 16, 32-45 the stride byte
// offset / 16, 62-63 the layout (1 = 128-byte swizzle).
//   K-major (the operand's K index along a slab row: A of Q K^T, B as K
//   or Q rows): 8-row groups 1024 bytes apart (stride offset); the
//   leading offset is unused; a k16 step inside a slab moves the start
//   by 32 bytes, the next slab by its size.
//   MN-major (B's N index along a slab row, its K index down the rows:
//   V, dO, Q or K read as (keys or queries) x D): 64-column atoms one
//   slab apart (leading offset), 8-row K groups 1024 bytes apart (stride
//   offset); a k16 step moves the start by 16 rows, 2048 bytes.
//
// Accumulator layout of m64nN (fp32): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15, and in it d[4 j + e] is element e of n8 tile j in the
// mma.m16n8 layout above (rows g, g + 8; columns 8 j + 2 t, + 1).  An A
// operand in registers takes the m16n8k16 A layout per warp, so, as with
// mma.sync, accumulator tiles 2 kk and 2 kk + 1 are the A fragment of k
// step kk of the next product.
namespace wgmma {

__device__ __forceinline__ uint64_t desc(const void* tile, uint32_t lead_bytes,
                                         uint32_t stride_bytes) {
  const uint32_t a = mma::smem_addr(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows of the tile starting at `tile` (a slab row),
// k step ks of a D-wide tile whose slabs are `slab_bytes` apart.
__device__ __forceinline__ uint64_t desc_k(const void* tile, int ks, uint32_t slab_bytes) {
  return desc(static_cast<const char*>(tile) + (ks >> 2) * slab_bytes + (ks & 3) * 32, 16, 1024);
}
// MN-major operand: K rows 16 kk .. 16 kk + 15 of a tile whose 64-column
// slabs are `slab_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk, uint32_t slab_bytes) {
  return desc(static_cast<const char*>(tile) + kk * 2048, slab_bytes, 1024);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The warpgroup's registers a thread: down (a producer) or up (a consumer).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// The dynamic shared memory, rounded up to 1024 bytes (the swizzle's
// period); a kernel's byte count holds 1024 more for it.
__device__ __forceinline__ char* aligned_smem() {
  extern __shared__ __align__(1024) char wg_dynamic_smem[];
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(wg_dynamic_smem) + 1023) &
                                 ~uintptr_t(1023));
}

// The D / 64 x ROWS / 64 boxes of one tile of a tensor map from
// mma::encode_map: rows row0 .. row0 + ROWS - 1 of head h, batch b into
// `tile`, whose 64-column slabs of ROWS rows lie `slab_bytes` apart (each
// slab's 64-row boxes 8 KB apart, as one slab of ROWS rows lays them out),
// on barrier `bar`.  Columns past the map's width read as zeros.
template <int D, int ROWS = 64>
__device__ __forceinline__ void tma_tile(void* tile, uint32_t slab_bytes, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / 64; ++r)
      mma::tma_load_4d(static_cast<char*>(tile) + c * slab_bytes + r * 8192, map, bar, 64 * c, h,
                       row0 + 64 * r, b);
}

// Pins registers at this point of the program for the compiler: an
// asynchronous product's accumulators or A operand are neither read before
// the wait that completes it nor written before the fence that issues it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// Named barriers (id 1..15) over `n` threads: sync waits, arrive does not.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The asynchronous products.  Each m64nN form writes its asm operand list
// once: the accumulators (N / 2 fp32 a thread) as "+f" operands
// (WGMMA_D8: eight of them), their names in the instruction (WGMMA_R*).
// ss: d (64 x N, fp32) += A B^T, A (64 x 16) and B (N x 16) K-major in
// shared memory; rs: d (64 x N) += A B, A (64 x 16) in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B (16 x N) MN-major in
// shared memory.  The overloads take N from the accumulators' count.
#define WGMMA_D8(i)                                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]),      \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WGMMA_D32(i) WGMMA_D8(i), WGMMA_D8((i) + 8), WGMMA_D8((i) + 16), WGMMA_D8((i) + 24)
#define WGMMA_R32                                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R40 WGMMA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WGMMA_R64                                                                           \
  WGMMA_R40 ", %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "   \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_R128                                                                          \
  WGMMA_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "  \
            "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "    \
            "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
            "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, " \
            "%121, %122, %123, %124, %125, %126, %127"
// N columns, REGS the accumulators' names, then the names of the operands
// after them: A's descriptor (ss) or four registers (rs), B's descriptor,
// and the scale-d flag.
#define WGMMA_SS(N, REGS, A, B, P, ...)                                                     \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " P ", 0;\n"                              \
               " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " A    \
               ", " B ", p, 1, 1, 0, 0;\n}\n"                                                \
               : __VA_ARGS__                                                                 \
               : "l"(a), "l"(b), "r"(1))
// ss_mn: as ss, but B (16 x N) MN-major in shared memory (its N index
// along a slab row), read by a desc_mn descriptor.
#define WGMMA_SS_MN(N, REGS, A, B, P, ...)                                                  \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " P ", 0;\n"                              \
               " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " A    \
               ", " B ", p, 1, 1, 0, 1;\n}\n"                                                \
               : __VA_ARGS__                                                                 \
               : "l"(a), "l"(b), "r"(1))
#define WGMMA_RS(N, REGS, A, B, P, ...)                                                     \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " P ", 0;\n"                              \
               " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, {" A   \
               "}, " B ", p, 1, 1, 1;\n}\n"                                                  \
               : __VA_ARGS__                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

__device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
  WGMMA_SS(64, WGMMA_R32, "%32", "%33", "%34", WGMMA_D32(0));
}
__device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
  WGMMA_SS(128, WGMMA_R64, "%64", "%65", "%66", WGMMA_D32(0), WGMMA_D32(32));
}
__device__ __forceinline__ void ss_mn(float (&d)[32], uint64_t a, uint64_t b) {
  WGMMA_SS_MN(64, WGMMA_R32, "%32", "%33", "%34", WGMMA_D32(0));
}
__device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  WGMMA_RS(64, WGMMA_R32, "%32, %33, %34, %35", "%36", "%37", WGMMA_D32(0));
}
__device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  WGMMA_RS(80, WGMMA_R40, "%40, %41, %42, %43", "%44", "%45", WGMMA_D32(0), WGMMA_D8(32));
}
__device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  WGMMA_RS(128, WGMMA_R64, "%64, %65, %66, %67", "%68", "%69", WGMMA_D32(0), WGMMA_D32(32));
}
__device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  WGMMA_RS(256, WGMMA_R128, "%128, %129, %130, %131", "%132", "%133", WGMMA_D32(0),
           WGMMA_D32(32), WGMMA_D32(64), WGMMA_D32(96));
}
// The two forms the backward's kernels name (older sources of the forward,
// which scripts/attention_fwd_ab.py builds against this header, name them too).
__device__ __forceinline__ void m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b) { ss(d, a, b); }
__device__ __forceinline__ void m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  rs(d, a, b);
}

#undef WGMMA_RS
#undef WGMMA_SS_MN
#undef WGMMA_SS
#undef WGMMA_R128
#undef WGMMA_R64
#undef WGMMA_R40
#undef WGMMA_R32
#undef WGMMA_D32
#undef WGMMA_D8

}  // namespace wgmma
