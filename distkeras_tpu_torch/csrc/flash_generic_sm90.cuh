// Building blocks of the generic flash route for Hopper (sm_90a), shared by
// K1g (flash_attention_generic.cu) and K2g/K3g (flash_attention_generic_bwd.cu):
// float32, float16 and bfloat16 tiles of 64 rows at any head dim D >= 1 and
// any row alignment.
//
// - cp.async staging (stage16, stage32): 16-byte copies where the tensors'
//   bases and D's rows allow it, 4-byte ones where they are 4-byte aligned,
//   2-byte loads otherwise; columns past D and rows past S are zeros. No
//   TMA, whose maps need 16-byte strides.
// - float16 and bfloat16 (Ops16): wgmma m64n64k16 with f32 accumulators on
//   128-byte-swizzled panels of 64 rows x 64 columns (one swizzle atom wide,
//   8 KB, 1024-byte aligned; the layout of hopper_sm90.cuh). `scores` is
//   A B^T with both operands K-major; `product` is X B with X the f32
//   accumulators rounded to 16 bits in registers and B MN-major through the
//   transpose bit. Every chain runs all of a chunk's k16 steps (columns past
//   D are zeros): a wgmma under a run-time condition made ptxas serialize
//   them all.
// - float32 (OpsF32): 3xTF32 on mma.sync m16n8k8 (four warps of 16 rows make
//   the same 64-row tile and accumulator layout as wgmma's). Each operand is
//   split as hi = tf32(x), lo = x - hi and each product taken as lo.hi +
//   hi.lo + hi.hi; each k8 step's three products go into a fresh sum joined
//   to the accumulator by one float32 add. Row-major tiles at a stride of 68
//   floats. `product` takes A from the accumulators with the reduction index
//   permuted inside each k8 step (logical t -> column 2t, t + 4 -> 2t + 1),
//   and B's rows in the same order.
// - Outputs through shared memory (tile_to_smem, smem_to_rows): whole rows,
//   16-byte stores where aligned.
// - On the host: the widest copy the tensors allow (granule) and the launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper_sm90.cuh"

namespace flash_generic {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // rows of a tile: wgmma's m64, 4 warps x 16
constexpr int kPanel = 64;                // columns of a 16-bit panel: one 128-byte atom
constexpr int kPanelBytes = kRows * 128;  // 8 KB
constexpr int kLdf = 68;                  // row stride of a float32 tile, in floats
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// x * log2(e), never fused into a neighbouring add: the mask fill and the
// lse of a fully masked row (both -1e30) convert to the same value, so their
// difference is exactly 0 and that row's P exactly 1.
__device__ __forceinline__ float to_log2(float x) { return __fmul_rn(x, kLog2e); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// ------------------------------------------------------------- cp.async --

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- 16 bits: wgmma panels --

// Rows [row0, row0 + 64) and columns [col0, col0 + 64 NP) of a contiguous
// [S][D] slice of 16-bit values into NP swizzled panels at dst, zeros past
// S rows and D columns, in 16-byte units spread over `nthreads` threads.
// gran: 16 (bases and rows 16-byte aligned), 4 or 2 (the copy's width).
template <int NP>
__device__ __forceinline__ void stage16(unsigned char* dst, const void* src_raw, int row0, int S,
                                        int D, int col0, int gran, int tid, int nthreads) {
  const unsigned short* src = static_cast<const unsigned short*>(src_raw);
  for (int u = tid; u < kRows * NP * 8; u += nthreads) {
    const int r = u / (NP * 8), cu = u % (NP * 8);
    const int p = cu >> 3, c = (cu & 7) * 8;
    unsigned char* d = dst + p * kPanelBytes + swizzled(r, c, 128);
    const int row = row0 + r, col = col0 + p * kPanel + c;
    const int n = row < S ? min(8, D - col) : 0;  // values of this unit inside the slice
    if (n <= 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const unsigned short* s = src + (size_t)row * D + col;
    if (gran == 16) {  // D % 8 == 0: the unit is whole
      cp_async16(d, s);
    } else if (gran == 4) {  // D even: pairs are whole
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        if (e < n)
          cp_async4(d + 2 * e, s + e);
        else
          *reinterpret_cast<uint32_t*>(d + 2 * e) = 0u;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        reinterpret_cast<unsigned short*>(d)[e] = e < n ? s[e] : (unsigned short)0;
    }
  }
}

#define ACC32_ASM                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define ACC32_OPS(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// wgmma m64n64k16 with f32 accumulators for one 16-bit input type: ss, A
// and B K-major in shared memory (accumulate 0 overwrites d); rs, A from
// registers and B MN-major through the transpose bit; and the packing of
// two f32 values into an A register.
template <typename T>
struct Wgmma;

#define DEFINE_WGMMA(TYPE, PTX, PACK)                                                          \
  template <>                                                                                  \
  struct Wgmma<TYPE> {                                                                         \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,          \
                                              int accumulate) {                                \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                              \
                   " wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " " ACC32_ASM    \
                   ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
                   : ACC32_OPS(d)                                                              \
                   : "l"(a), "l"(b), "r"(accumulate));                                         \
    }                                                                                          \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],          \
                                              uint64_t b) {                                    \
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                              \
                   " wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " " ACC32_ASM    \
                   ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
                   : ACC32_OPS(d)                                                              \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));              \
    }                                                                                          \
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {                      \
      const auto v = PACK(lo, hi);                                                             \
      return *reinterpret_cast<const uint32_t*>(&v);                                           \
    }                                                                                          \
  };

DEFINE_WGMMA(bf16, "bf16", __floats2bfloat162_rn)
DEFINE_WGMMA(__half, "f16", __floats2half2_rn)

// The products of the 16-bit kernels on tiles of NP panels.
template <typename T, int NP>
struct Ops16 {
  static constexpr int kTileBytes = kPanelBytes * NP;
  static constexpr int kWidth = kPanel * NP;  // columns of a chunk

  static __device__ __forceinline__ void stage(unsigned char* dst, const void* src, int row0,
                                               int S, int D, int col0, int gran, int tid,
                                               int nthreads) {
    stage16<NP>(dst, src, row0, S, D, col0, gran, tid, nthreads);
  }

  // Issues s (+)= A B^T over the 4 NP k16 steps of 64-row tiles, both
  // operands K-major (accumulate 0 overwrites), as one wgmma group. Columns
  // past D are staged as zeros, so a chunk narrower than the tiles needs no
  // shorter chain: no wgmma is conditional, which would serialize them all.
  static __device__ __forceinline__ void issue_dots(float (&s)[32], const unsigned char* a,
                                                    const unsigned char* b, int accumulate) {
    const uint64_t da = make_desc(a, 128), db = make_desc(b, 128);
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
      Wgmma<T>::ss(s, desc_add(da, off), desc_add(db, off), accumulate | kk);
    }
    wgmma_commit();
  }

  static __device__ __forceinline__ void scores(float (&s)[32], const unsigned char* a,
                                                const unsigned char* b, int, int accumulate,
                                                int, int) {
    wgmma_fence();
    issue_dots(s, a, b, accumulate);
    wgmma_wait<0>();
    fence_regs(s);
  }

  // s (+)= A1 B1^T and dp (+)= A2 B2^T, the two chains in flight together.
  static __device__ __forceinline__ void scores2(float (&s)[32], const unsigned char* a1,
                                                 const unsigned char* b1, float (&dp)[32],
                                                 const unsigned char* a2,
                                                 const unsigned char* b2, int, int accumulate,
                                                 int, int) {
    wgmma_fence();
    issue_dots(s, a1, b1, accumulate);
    issue_dots(dp, a2, b2, accumulate);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  }

  // out[p] += X . B[:, panel p] for each of the NP panels: X the 64 x 64
  // f32 accumulator tile `x` rounded to T (the A fragments of four k16
  // steps), B a 64-row tile read MN-major (its rows run along the
  // reduction). A panel past D adds zeros.
  static __device__ __forceinline__ void product(float (&out)[NP][32], const float (&x)[32],
                                                 const unsigned char* b, int, int) {
    uint32_t f[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[kk][i] = Wgmma<T>::pack(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint64_t db = make_desc(b + p * kPanelBytes, 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<T>::rs(out[p], f[kk], desc_add(db, kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(out[p]);
    fence_regs(f);
  }
};

// ------------------------------------------------ float32: 3xTF32 mma.sync --

// Rows [row0, row0 + 64) and columns [col0, col0 + 64) of a contiguous
// [S][D] float32 slice into a [64][kLdf] tile, zeros outside the slice.
// gran: 16 (bases and rows 16-byte aligned) or 4.
__device__ __forceinline__ void stage32(unsigned char* dst_raw, const void* src_raw, int row0,
                                        int S, int D, int col0, int gran, int tid,
                                        int nthreads) {
  float* dst = reinterpret_cast<float*>(dst_raw);
  const float* src = static_cast<const float*>(src_raw);
  for (int u = tid; u < kRows * 16; u += nthreads) {
    const int r = u >> 4, c = (u & 15) * 4;
    float* d = dst + r * kLdf + c;
    const int row = row0 + r, col = col0 + c;
    const int n = row < S ? min(4, D - col) : 0;
    if (n <= 0) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* s = src + (size_t)row * D + col;
    if (gran == 16) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < n)
          cp_async4(d + e, s + e);
        else
          d[e] = 0.f;
      }
    }
  }
}

// x as hi + lo: hi = x rounded to TF32 (to nearest), lo = x - hi, exact in
// float32 and at most 2^-11 of x. lo goes to the tensor cores as it is,
// which read its leading TF32 bits (a truncation, within 2^-21 of x):
// rounding it too costs one more conversion a value, in the hottest loop.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A . B (a fresh sum, 16 x 8) for one k8 step.
__device__ __forceinline__ void mma_tf32_new(float* d, const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c (16 x 8) += A . B (one k8 step) in 3xTF32, the small terms first. The
// tensor cores add with truncation (round toward zero), a bias that grows
// with the number of additions into one sum: the step's three products go
// into a fresh sum, which joins c through one float32 add (round to nearest).
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float step[4];
  mma_tf32_new(step, alo, bh0, bh1);
  mma_tf32(step, ahi, bl0, bl1);
  mma_tf32(step, ahi, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += step[i];
}

// acc (64 x 64, this warp's 16 rows) += A B^T over the first `ks` k8
// steps: A and B [64][kLdf] tiles, each row a row of the product's operand.
__device__ __forceinline__ void dots_f32(float (&acc)[32], const float* A, const float* B,
                                         int ks, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* arow = A + (16 * warp + g) * kLdf + t;
  const float* brow = B + g * kLdf + t;
#pragma unroll 1
  for (int kk = 0; kk < ks; ++kk) {
    const float* a = arow + 8 * kk;
    uint32_t ahi[4], alo[4];
    split_tf32(a[0], ahi[0], alo[0]);             // (g, t)
    split_tf32(a[8 * kLdf], ahi[1], alo[1]);      // (g + 8, t)
    split_tf32(a[4], ahi[2], alo[2]);             // (g, t + 4)
    split_tf32(a[8 * kLdf + 4], ahi[3], alo[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b = brow + 8 * j * kLdf + 8 * kk;  // row 8j + g, columns t and t + 4
      mma_3xtf32(acc + 4 * j, ahi, alo, b[0], b[4]);
    }
  }
}

struct OpsF32 {
  static constexpr int kTileBytes = kRows * kLdf * 4;  // 17 KB
  static constexpr int kWidth = 64;

  static __device__ __forceinline__ void stage(unsigned char* dst, const void* src, int row0,
                                               int S, int D, int col0, int gran, int tid,
                                               int nthreads) {
    stage32(dst, src, row0, S, D, col0, gran, tid, nthreads);
  }

  // s (+)= A B^T over the chunk's first `width` columns (k8 steps).
  static __device__ __forceinline__ void scores(float (&s)[32], const unsigned char* a,
                                                const unsigned char* b, int width,
                                                int accumulate, int warp, int lane) {
    if (!accumulate) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    dots_f32(s, reinterpret_cast<const float*>(a), reinterpret_cast<const float*>(b),
             (width + 7) >> 3, warp, lane);
  }

  static __device__ __forceinline__ void scores2(float (&s)[32], const unsigned char* a1,
                                                 const unsigned char* b1, float (&dp)[32],
                                                 const unsigned char* a2,
                                                 const unsigned char* b2, int width,
                                                 int accumulate, int warp, int lane) {
    scores(s, a1, b1, width, accumulate, warp, lane);
    scores(dp, a2, b2, width, accumulate, warp, lane);
  }

  // out[0] += X . B: X the 64 x 64 accumulator tile x, B a [64][kLdf] tile
  // whose rows run along the reduction. The reduction index is permuted in
  // each k8 step c: A's column t is x's column 8c + 2t (this thread's first
  // value of chunk c), t + 4 is 8c + 2t + 1, and B's rows follow.
  static __device__ __forceinline__ void product(float (&out)[1][32], const float (&x)[32],
                                                 const unsigned char* b_raw, int warp,
                                                 int lane) {
    const float* B = reinterpret_cast<const float*>(b_raw);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint32_t ahi[4], alo[4];
      split_tf32(x[4 * c], ahi[0], alo[0]);      // (g, 8c + 2t)
      split_tf32(x[4 * c + 2], ahi[1], alo[1]);  // (g + 8, 8c + 2t)
      split_tf32(x[4 * c + 1], ahi[2], alo[2]);  // (g, 8c + 2t + 1)
      split_tf32(x[4 * c + 3], ahi[3], alo[3]);  // (g + 8, 8c + 2t + 1)
      const float* b = B + (8 * c + 2 * t) * kLdf + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_3xtf32(out[0] + 4 * j, ahi, alo, b[8 * j], b[kLdf + 8 * j]);
    }
  }
};

template <typename T, int NP>
using OpsOf = typename std::conditional<std::is_same<T, float>::value, OpsF32, Ops16<T, NP>>::type;

// The number of keys a causal query tile [q0, q0 + 64) needs: keys up to
// its last row's diagonal, or every key if a row of it sees none.
__device__ __forceinline__ int causal_keys(int q0, int Skv, int causal, int shift) {
  if (!causal || q0 < shift) return Skv;
  return min(Skv, q0 + kRows - shift);
}

// The output tile of a warpgroup: its 64 x (64 NP) f32 accumulators,
// rounded to T, go to shared memory at buf (rows of 64 NP + 16 / sizeof(T)
// values: the pad spreads a warp's pairs over all banks) ...
template <typename T, int NP>
__device__ __forceinline__ void tile_to_smem(unsigned char* buf, const float (&acc)[NP][32],
                                             int warp, int lane) {
  constexpr int LD = kPanel * NP + 16 / sizeof(T);
  const int g = lane >> 2, t = lane & 3;
  T* dst = reinterpret_cast<T*>(buf);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* at = dst + (16 * warp + g + 8 * h) * LD + p * kPanel + 8 * j + 2 * t;
        at[0] = from_f<T>(acc[p][4 * j + 2 * h]);
        at[1] = from_f<T>(acc[p][4 * j + 2 * h + 1]);
      }
}

// ... and from there, once the warpgroup has written it, to rows [row0,
// row0 + 64) and columns [col0, col0 + 64 NP) of a contiguous [S][D] slice,
// inside S and D: 16-byte stores along the rows where `gran` is 16, else
// one value at a time. tid counts the nthreads threads that copy.
template <typename T, int NP>
__device__ __forceinline__ void smem_to_rows(T* __restrict__ out, const unsigned char* buf,
                                             int row0, int S, int D, int col0, int gran,
                                             int tid, int nthreads) {
  constexpr int LD = kPanel * NP + 16 / sizeof(T), V = 16 / sizeof(T);  // values a unit
  constexpr int UNITS = kPanel * NP / V;                                // units a row
  const T* src = reinterpret_cast<const T*>(buf);
  for (int u = tid; u < kRows * UNITS; u += nthreads) {
    const int r = u / UNITS, c = (u % UNITS) * V, row = row0 + r, col = col0 + c;
    if (row >= S || col >= D) continue;
    const T* from = src + r * LD + c;
    T* to = out + (size_t)row * D + col;
    if (gran == 16) {  // D % V == 0: the unit is whole
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      const int n = min(V, D - col);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) to[e] = from[e];
    }
  }
}

// ------------------------------------------------------------------ host --

// The widest copy (16, 4 or 2 bytes) that every base and every row start of
// [*, d] tensors of `elem`-byte values allows.
inline int granule(int d, int elem, const void* const* ptrs, int n) {
  for (int g : {16, 4}) {
    bool ok = (d * elem) % g == 0;
    for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % g == 0;
    if (ok) return g;
  }
  return 2;
}

template <typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, long long blocks, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash_generic
