// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers with phase parity, TMA tile loads (cp.async.bulk.tensor), the
// wgmma shared-memory descriptor and the bf16 wgmma products with f32
// accumulators, their fences, setmaxnreg, and on the host the encoding of
// TMA tensor maps through the driver entry point (no -lcuda needed).
//
// Shared-memory tiles are row-major [rows][W] bf16 tiles written by TMA
// with a swizzle as wide as one row (W = 64: 128-byte rows, 128-byte
// swizzle; W = 32: 64-byte rows, 64-byte swizzle), each tile aligned to
// 1024 bytes. In the wgmma canonical layouts such a tile is a column of
// 8-row swizzle atoms, so one descriptor form serves both operand majors:
// - K-major (the product's reduction runs along the row, e.g. Q and K in
//   Q.K^T): the 8-row stride (SBO) is 8 rows; a k16 step adds 32 bytes to
//   the start address, inside the atom, where the hardware swizzles the
//   address as TMA did.
// - MN-major (the reduction runs down the rows, e.g. V in P.V, with the
//   transpose bit): the next 8 rows of the reduction are again 8 rows on;
//   a k16 step adds 16 rows. The operand's N extent (W) is one atom wide,
//   so the stride between atoms along N is never used.
// Both offsets are therefore set to 8 rows, which makes the descriptor
// right whichever of the two fields the hardware reads for that stride.
//
// wgmma accumulator layout (m64nN, f32): warp w of the warpgroup owns rows
// 16w..16w+15; with g = lane / 4 and t = lane % 4, registers 4j..4j+3 hold
// (row g, cols 8j+2t, 8j+2t+1) and (row g+8, the same cols). Two
// neighbouring 8-column chunks, packed to bf16 pairwise, are the register A
// fragment of a k16 step (the mma.m16n8k16 A layout), so a score tile
// feeds the next product straight from registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace hopper {

using flash::pack_bf16x2;

// ---------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; follow it with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The producer's arrival, announcing the bytes its TMA copies will deliver.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity` (the
// k-th completion has parity k & 1). A wait that has not completed after
// about two seconds is a bug in the pipeline: it traps, so that the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > 4000000000LL) {
      __trap();
    }
  }
}

// One TMA copy of a box of a 3-D tensor map into shared memory, completing
// on `bar`. Coordinates are innermost first; rows outside the tensor arrive
// as zeros and still count their bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// One TMA copy of a shared-memory tile to a box of a 3-D tensor map (rows
// outside the tensor are not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's TMA stores have read their shared memory
// (kReadOnly) or have completed.
template <bool kReadOnly>
__device__ __forceinline__ void tma_store_wait() {
  if (kReadOnly)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of element (r, c) in a row-major bf16 tile of `row_bytes`
// wide rows, swizzled as TMA writes and reads it (see the note above).
__device__ __forceinline__ uint32_t swizzled(int r, int c, uint32_t row_bytes) {
  const uint32_t b = r * row_bytes + c * 2;
  return b ^ (((b >> 7) & (row_bytes == 128 ? 7u : 3u)) << 4);
}

// A warpgroup's 64 x N f32 accumulator tile, rounded to bf16, into rows
// [0, 64) of a swizzled tile (N = 2 * the register count; N = the row width).
template <int R>
__device__ __forceinline__ void store_acc_tile(unsigned char* tile, const float (&d)[R],
                                               int warp_in_group, int lane) {
  constexpr uint32_t ROW = R * 2 * 2;  // N = 2R columns of 2 bytes
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + swizzled(16 * warp_in_group + g + 8 * h,
                                                   8 * j + 2 * t, ROW)) =
          pack_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

// The first 1024-byte aligned address at or after `raw` in shared memory:
// swizzled tiles must start on one. Allocate 1024 bytes more than the tiles.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// The work item of round r of a persistent block: items are dealt to the
// blocks in rounds, forward in even rounds and backward in odd ones, so
// that items ordered longest first even out across the blocks.
__device__ __forceinline__ int snake_item(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// The wgmma descriptor of a 1024-byte aligned row-major tile of `row_bytes`
// (64 or 128) wide rows, swizzled as wide as a row (see the note above).
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t row_bytes) {
  const uint64_t eight_rows = (8 * row_bytes) >> 4;
  const uint64_t layout = row_bytes == 128 ? 1 : 2;  // 128-byte or 64-byte swizzle
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (eight_rows << 16) |
         (eight_rows << 32) | (layout << 62);
}

// A descriptor moved by `bytes` (a multiple of 16) in shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// 2^x by the special-function unit (one instruction; denormal results
// flush to 0, 2^-inf = 0, 2^0 = 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to this point of the instruction stream, so that the
// compiler neither reads an accumulator before the wgmma that writes it has
// been waited for, nor reuses a register that an issued wgmma still reads.
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

template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), A and B both K-major
// in shared memory. kAccumulate 0 overwrites d (the first k step).
template <int kAccumulate>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(kAccumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 register fragments) . B (16 x N),
// B in shared memory MN-major (its rows run along the reduction), read
// through the transpose bit. N = 64 or 32 (d has N / 2 registers).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The A fragment of k step j from the accumulators of 8-column chunks 2j
// and 2j + 1, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[4], const float (&d)[N], int j) {
  const float* lo = d + 8 * j;
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(lo[4], lo[5]);
  a[3] = pack_bf16x2(lo[6], lo[7]);
}

// ------------------------------------------------------------------ host --

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: it is looked up once
// through the runtime, so that the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                : nullptr;
  }();
  return fn;
}

// Error codes of the host side: a failed encoding returns kTensorMapError
// plus the driver's CUresult, a missing entry point kTensorMapError.
constexpr int kTensorMapError = 10000;

// A 3-D map over a contiguous [bh][rows][d] bf16 tensor (d = 32 or 64),
// innermost first, whose box is `box_rows` rows of one (bh) slice, swizzled
// as wide as a row. Rows past `rows` read as zeros, never the next slice.
inline int encode_rows_bf16(CUtensorMap* map, const void* base, int bh, int rows, int d,
                            int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)d, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// A 1-D map over `n` contiguous f32 values, boxes of `box` values; values
// past `n` read as zeros.
inline int encode_vec_f32(CUtensorMap* map, const void* base, long long n, int box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // rank 1: not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
                        strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// The current device's number of SMs, the grid of a persistent kernel
// (looked up once per device).
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = n;
  return n;
}

// Lets a kernel take `bytes` of dynamic shared memory (above 48 KB only
// after this call).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace hopper
