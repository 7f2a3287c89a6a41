// bf16 packing and the reductions over the four threads that hold one row
// of a matrix-product accumulator, shared by the flash-attention kernels.
//
// Accumulator layout (one warp's 16 rows of a wgmma m64 tile, f32), with
// g = lane / 4 and t = lane % 4: each 8-column chunk holds (row g, cols 2t,
// 2t+1) and (row g+8, the same cols). A row's values are thus spread over
// the four threads of a group (lanes 4g..4g+3), which group_max and
// group_sum reduce.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

// Two floats to one register of two bf16: `lo` in the low half, as the
// fragments of a matrix product expect for the lower column index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
