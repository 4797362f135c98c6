// Pieces shared by the kernels that run fp32 products on the tensor cores
// as 3xTF32 through mma.sync (the flash-attention kernels through
// flash_mma.cuh, and conv_bwd.cu): asynchronous copies into shared memory,
// ldmatrix, the TF32 split with its inf/NaN check, and the m16n8k8 TF32
// product.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mma_common {

// -- asynchronous copies ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// -- ldmatrix -------------------------------------------------------------------
//
// Four 8 x 8 matrices of 16-bit values; matrix i takes its row addresses
// from lanes 8i..8i+7, and lane l receives row l / 4, values 2(l % 4) and
// 2(l % 4) + 1 of each. Read as 32-bit values, an 8-row x 4-value fp32
// block: lane l receives (row l / 4, value l % 4), which is how the
// m16n8k8 TF32 fragments are laid out, so rows of 4 fp32 values (16 bytes)
// load TF32 fragments as well.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same at a shared-memory address (smem_addr), which keeps address
// arithmetic in 32 bits
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// one 32-bit word at a shared-memory address
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// -- the 3xTF32 split -----------------------------------------------------------

// cvt.rna.tf32.f32 of a finite x, written out: round to nearest with
// ties away from zero at the 13th bit (the magnitude bits carry into the
// exponent), then clear the 13 bits. Bit for bit the instruction's result
// on finite values only: a NaN's carry leaves the NaN range (0x7FFFFFFF
// becomes -0), so split() never gives it one.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (x - hi is exact in fp32). Unchecked, x must
// be finite. Checked, a non-finite x is hi = 0, lo = x: only the lo(x)
// hi(y) term of a product sees it, so NaN stays NaN and inf * y keeps
// fp32's +-inf (hi = inf would make lo = inf - inf = NaN). Only inf * inf
// (its lo * lo term is the one dropped, the others are inf * 0) and
// inf * a subnormal give NaN where fp32 gives +-inf. The check costs a
// compare and two selects, on top of the five instructions of a split.
template <bool kChecked>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kChecked) {
    const bool finite = fabsf(x) < __int_as_float(0x7F800000);
    hi = finite ? to_tf32(x) : 0u;
    const float r = x - __uint_as_float(hi);  // a NaN comes out 0x7FFFFFFF
    lo = finite ? to_tf32(r) : __float_as_uint(r);
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
}

// -- the product ----------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 from split operands: c += a.lo b.hi + a.hi b.lo + a.hi b.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

}  // namespace mma_common
