// Helpers of the mma.sync kernel (K2) and of bf16 packing and row
// reductions shared with the others: the bf16 tensor-core product
// (mma.sync m16n8k16, f32 accumulators), bf16 packing, fragment
// loads with ldmatrix, cp.async copies into shared memory, and the
// reductions over the four threads that hold one row of an mma accumulator.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                           a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same k)
//   B (16 x 8, col-major):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g)
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...)
// So the accumulators of two neighbouring 8-column tiles, packed pairwise,
// are the A fragment of the next product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats to one register of two bf16: `lo` in the low half, as the mma
// fragments expect for the lower column index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment over columns 16j..16j+15 from the accumulators of the two
// 8-column tiles 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte aligned), and r[i] is
// the lane's part of matrix i: row g, columns 2t and 2t+1. With .trans, the
// lane gets rows 2t and 2t+1 of column g instead, so a row-major [k][n] tile
// gives the col-major B fragments of the mma directly.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// An asynchronous 16-byte copy from device to shared memory (cp.async),
// zero-filled when `valid` is false (then nothing is read from `src`).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `N` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash
