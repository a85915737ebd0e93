// Warp-level bf16 tensor-core helpers for NVIDIA Hopper (sm_90a), shared by
// the bf16 paths of flash_attention.cu, ssd.cu and mlstm.cu.  Header-only;
// a kernel source includes it, and the build hashes it into every
// library's name, so an edit rebuilds them all.
//
// What is here: the m16n8k16 bf16 `mma.sync` with fp32 accumulators (the
// warp-synchronous product; `wgmma` is a later step), `ldmatrix` (x4, x2,
// x4.trans and x2.trans), 16-byte `cp.async` copies (with zero fill)
// and their commit / wait groups, mbarriers and 4-D TMA tile loads, exp2
// on the special-function unit, bf16 packing and the hi + lo split of an
// fp32 value, and the fragment index maps.
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

#include <cuda_bf16.h>
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

}  // namespace mma
