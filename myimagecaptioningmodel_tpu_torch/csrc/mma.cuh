// Hopper building blocks of the redesigned kernels F (matmul_bn.cu) and C
// (topk_head.cu): asynchronous global -> shared copies (cp.async, 16 bytes,
// zero-filled past the source's end), shared -> register fragment loads
// (ldmatrix) and the bf16 tensor-core product m16n8k16 with float32
// accumulators (mma.sync). Fragment layouts, for lane l, g = l / 4,
// c = l % 4:
//   A (16 x 16, row-major): a0 (row g, k 2c, 2c+1), a1 (row g+8, the same k),
//     a2 (row g, k 2c+8, 2c+9), a3 (row g+8, k 2c+8, 2c+9);
//   B (16 x 8, k x n):      b0 (k 2c, 2c+1, column g), b1 (k 2c+8, 2c+9);
//   C (16 x 8, float):      c0, c1 (row g, columns 2c, 2c+1), c2, c3 (row g+8).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace capk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global src to shared dst, of which the first src_bytes are
// read and the rest zero-filled (src_bytes 0: nothing is read, dst is zero).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
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

// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i (16 bytes each).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The same, each matrix transposed: from a [k][n] tile, B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16) . b (16 x 8), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 (round to nearest even) in one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

}  // namespace capk
