// Flash attention backward of the generic route for Hopper (sm_90a): K2g
// (dQ) and K3g (dK, dV) for float32, float16 and bfloat16 at any head dim D
// >= 1, any row alignment, S_q != S_kv, causal shift 0 and 1 (bf16 at D 32
// and 64 on 16-byte aligned tensors takes flash_attention_bwd.cu instead).
//
// Replaces, outside the Hopper kernels' domain, the Pallas kernels of
// distkeras_tpu/ops/pallas/flash_attention.py, per (bh) slice with q and dO
// [Sq, D], k and v [Skv, D], and the forward's lse and delta = rowsum(dO o O)
// [Sq] in float32:
// - K2g, `_dq_kernel` launched by `dq_call` (:214): dQ = dS K, where
//     P = exp(Q K^T * scale [masked] - lse) and dS = P o (dO V^T - delta) * scale;
// - K3g, `_dkv_kernel` launched by `dkv_call` (:238): dK = dS^T Q, dV = P^T dO.
// The causal mask `row >= col + causal_shift` fills scores with -1e30 before
// the exp, as the reference does, so a query row that sees no key (row 0
// under shift 1) has lse exactly -1e30 and P = 1 for every key. P is rounded
// to the input type before P^T dO, dS before dS K and dS^T Q, where the
// plain versions (ops/flash_attention.py) round them. The scale is D^-1/2.
//
// What bounds them on the H100: per (bh) slice K2g does 6 Sq Skv D flops on
// 4 tensors of S x D in and 1 out, K3g 8 Sq Skv D on 4 in and 2 out: about
// S / 3 flops a byte in float32, 2 S / 3 in 16 bits, under the tensor
// cores' balance point (about 150 flops a byte for TF32, 295 for bf16) at
// every length the main path runs, so both are bound by the bytes they move,
// as long as their products run on the tensor cores. They do:
// - float16 and bfloat16: wgmma m64n64k16, f32 accumulators. Operands are
//   staged into 128-byte-swizzled panels of 64 rows x 64 columns (one
//   swizzle atom wide, 8 KB, 1024-byte aligned), the layout of
//   hopper_sm90.cuh: the score products (Q K^T, dO V^T; in K3g K Q^T and
//   V dO^T) read both operands K-major, a k16 step 32 bytes on inside a
//   panel and the next panel after four; the output products (dS K; P^T dO,
//   dS^T Q) take A from the score accumulators rounded to 16 bits in
//   registers and B MN-major through the transpose bit, one wgmma n64 a
//   panel of output columns. Every chain runs all of a chunk's k16 steps
//   (columns past D are zeros): a wgmma under a run-time condition made
//   ptxas serialize them all.
// - float32: 3xTF32 on mma.sync m16n8k8 (four warps of 16 rows make the same
//   64-row tile and the same accumulator layout as wgmma's). Each operand is
//   split in registers as hi = tf32(x), lo = x - hi and each product taken
//   as lo.hi + hi.lo + hi.hi: within about 2^-20 of each product. The tensor
//   cores add with truncation, so each k8 step's three products go into a
//   fresh sum joined to the accumulator by one float32 add: float32's
//   accuracy at D = 512 too. Tiles are row-major float32 at a stride of 68
//   floats (4 mod 32 banks: each fragment load hits 32 banks). mma.sync, not
//   wgmma: TF32 wgmma reads shared operands K-major only, which would need
//   transposed and pre-split copies of K, Q and dO; mma.sync loads its
//   fragments from any layout. The output products take A from the
//   accumulators with the reduction index permuted inside each k8 step
//   (logical t -> column 2t, t + 4 -> 2t + 1), and B's rows in the same order.
// Staging is cp.async by every thread of the block: 16-byte copies where
// the tensors' bases and D's rows allow it, 4-byte ones where they are
// 4-byte aligned, 2-byte loads otherwise (D = 36 in bf16 has 72-byte rows);
// no TMA, whose maps need 16-byte strides. Columns past D and rows past S
// are zeros. The streamed tile (K2g: K and V of the next key tile; K3g: Q,
// dO, lse and delta of the next query tile) is double-buffered, its copy in
// flight during the current tile's products. Outputs leave through shared
// memory as whole rows (16-byte stores where aligned): storing each
// thread's accumulator pairs straight to device memory was the 16-bit
// kernels' largest cost.
//
// Any D through column chunks: a block owns the output columns of one chunk
// of W = 64 NP columns (NP panels; W = 64 in float32, 64 or 128 in 16 bits),
// a grid axis. The score products reduce over the whole D, chunk by chunk,
// the block's own chunk last, so that the tiles of the output product are
// the ones staged last; at D > W each chunk's block recomputes the scores,
// and stages every tile for every step (the kChunks instances).
//
// - K2g: a block of one warpgroup (128 threads) a tile of 64 query rows and
//   one chunk, looping over key tiles of 64; Q and dO stay in shared memory
//   when D fits one chunk. It holds S, dP (64 x 64) and dQ (64 x W) in
//   registers: 32 + 32 + W / 2 a thread.
// - K3g: a block of two warpgroups a tile of 64 keys and one chunk, looping
//   over query tiles of 64 in the key-row frame; K and V stay in shared
//   memory when D fits one chunk. Warpgroup 0 computes S^T = K Q^T and P^T,
//   hands P^T to warpgroup 1 through shared memory, and adds P^T dO to dV;
//   warpgroup 1 computes dP^T = V dO^T, then dS^T and adds dS^T Q to dK.
//   Each holds one 64 x W output and one score tile: no score is computed
//   twice, and the two halves run at once.
// Causal blocks skip key tiles (K2g) or query tiles (K3g) wholly above the
// diagonal, except the tiles holding a row that sees no key (row < shift).
// K2g deals its query tiles longest first. Each block owns its output
// columns: no atomics, and the result does not depend on the launch order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper_sm90.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // rows of a tile: wgmma's m64, 4 warps x 16
constexpr int kPanel = 64;                // columns of a 16-bit panel: one 128-byte atom
constexpr int kPanelBytes = kRows * 128;  // 8 KB
constexpr int kLdf = 68;                  // row stride of a float32 tile, in floats
constexpr int kStatBytes = 2 * kRows * 4;  // lse and delta of a query tile
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

// Lse and delta of query rows [q0, q0 + 64) into dst[0..63] and dst[64..127],
// zeros past Sq.
__device__ __forceinline__ void stage_stats(float* dst, const float* __restrict__ lse,
                                            const float* __restrict__ delta, int q0, int Sq,
                                            int tid, int nthreads) {
  for (int i = tid; i < 2 * kRows; i += nthreads) {
    const int row = q0 + (i & (kRows - 1));
    if (row < Sq)
      cp_async4(dst + i, (i < kRows ? lse : delta) + row);
    else
      dst[i] = 0.f;
  }
}

// The number of keys a causal query tile [q0, q0 + 64) needs: keys up to
// its last row's diagonal, or every key if a row of it sees none.
__device__ __forceinline__ int causal_keys(int q0, int Skv, int causal, int shift) {
  if (!causal || q0 < shift) return Skv;
  return min(Skv, q0 + kRows - shift);
}

// Arrives at barrier `id` of `count` threads without waiting: the
// producer's half of a hand-over whose consumers wait with named_barrier.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

// K2g. Block w of a grid of q_tiles * nc * BH: query tiles outermost,
// longest first under the causal mask, then the chunk, then the (bh) slice.
// nc, the number of W-column chunks of D, is 1 unless the kChunks instance
// runs (D > W).
template <typename T, int NP, bool kChunks>
__global__ void __maxnreg__(224)  // see K3g
    flash_dq_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dq, int bh_count, int Sq, int Skv, int D,
                            int chunks, int causal, int shift, float scale, int gran) {
  using Ops = OpsOf<T, NP>;
  const int nc = kChunks ? chunks : 1;
  constexpr int TB = Ops::kTileBytes, W = Ops::kWidth;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sdO = sQ + TB;
  unsigned char* sKV = sdO + TB;  // stage s: K at sKV + 2 s TB, V right after

  const int n_qb = (Sq + kRows - 1) / kRows;
  const int qi = blockIdx.x / (nc * bh_count), rest = blockIdx.x % (nc * bh_count);
  const int oc = rest / bh_count, bh = rest % bh_count;
  int qb = qi;
  if (causal) qb = shift ? (qi == 0 ? 0 : n_qb - qi) : n_qb - 1 - qi;
  const int q0 = qb * kRows;
  const size_t q_base = (size_t)bh * Sq * D, kv_base = (size_t)bh * Skv * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float row_lse[2], row_delta[2];  // lse * log2(e), and delta; 0 past Sq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < Sq;
    row_lse[h] = in ? to_log2(lse[(size_t)bh * Sq + rows[h]]) : 0.f;
    row_delta[h] = in ? delta[(size_t)bh * Sq + rows[h]] : 0.f;
  }
  float acc[NP][32];  // dQ, this chunk's columns
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  // Step n: key tile n / nc, chunk (oc + 1 + n % nc) % nc (the block's own
  // last). With one chunk Q and dO are staged once and K/V double-buffered;
  // with several, every step stages all four, one step at a time.
  const int steps = (causal_keys(q0, Skv, causal, shift) + kRows - 1) / kRows * nc;
  constexpr bool pipelined = !kChunks;
  auto issue = [&](int n, int buf) {
    const int col0 = (oc + 1 + n % nc) % nc * W, k0 = n / nc * kRows;
    if (!pipelined || n == 0) {
      Ops::stage(sQ, q + q_base, q0, Sq, D, col0, gran, tid, 128);
      Ops::stage(sdO, dout + q_base, q0, Sq, D, col0, gran, tid, 128);
    }
    unsigned char* sK = sKV + 2 * buf * TB;
    Ops::stage(sK, k + kv_base, k0, Skv, D, col0, gran, tid, 128);
    Ops::stage(sK + TB, v + kv_base, k0, Skv, D, col0, gran, tid, 128);
    cp_async_commit();
  };

  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  float sc[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 x 64, summed over the chunks
  issue(0, 0);
  for (int n = 0; n < steps; ++n) {
    const int buf = pipelined ? n & 1 : 0;
    if (pipelined && n + 1 < steps) {
      issue(n + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();  // this thread's copies and zeros, to wgmma's proxy
    __syncthreads();
    const int i = n % nc, ch = (oc + 1 + i) % nc, k0 = n / nc * kRows;
    const unsigned char* sK = sKV + 2 * buf * TB;
    Ops::scores2(sc, sQ, sK, dp, sdO, sK + TB, min(W, D - ch * W), i > 0, warp, lane);
    if (i == nc - 1) {  // the scores are whole; K's staged chunk is the block's
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), h = e >> 1;
          float x = sc[4 * j + e] * scale_log2;
          if (col >= Skv)
            x = -INFINITY;  // past the sequence: no key at all
          else if (causal && rows[h] < col + shift)
            x = fill_log2;
          const float p = exp2_approx(x - row_lse[h]);
          sc[4 * j + e] = p * (dp[4 * j + e] - row_delta[h]) * scale;  // dS
        }
      }
      Ops::product(acc, sc, sK, warp, lane);
    }
    __syncthreads();  // the buffers of this step are read
    if (!pipelined && n + 1 < steps) issue(n + 1, 0);
  }

  // dQ through the (free) K/V stages: coalesced rows.
  tile_to_smem<T, NP>(sKV, acc, warp, lane);
  __syncthreads();
  smem_to_rows<T, NP>(dq + q_base, sKV, q0, Sq, D, oc * W, gran, tid, 128);
}

// K3g. Block w of a grid of k_tiles * nc * BH: key tiles outermost (under
// the causal mask the first see the most queries), then the chunk, then the
// (bh) slice. Two warpgroups on the same 64 keys: warpgroup 0 computes S^T,
// P^T (which it hands over through shared memory) and dV += P^T dO;
// warpgroup 1 computes dP^T, then dS^T from P^T and dK += dS^T Q. Each owns
// one output: no score is computed twice, and the two halves run at once.
// __maxnreg__, not __launch_bounds__: under __launch_bounds__(256, 1) (K2g:
// (128, 2)) ptxas gave the float32 instances 255 registers and a spill;
// capped at 224 (256 threads x 224 fit an SM's 65,536) none spills.
template <typename T, int NP, bool kChunks>
__global__ void __maxnreg__(224)
    flash_dkv_generic_kernel(const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ q, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int bh_count, int Sq,
                             int Skv, int D, int chunks, int causal, int shift, float scale,
                             int gran) {
  using Ops = OpsOf<T, NP>;
  constexpr int TB = Ops::kTileBytes, W = Ops::kWidth;
  const int nc = kChunks ? chunks : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + TB;
  unsigned char* sQD = sV + TB;  // stage s: Q at sQD + 2 s TB, dO right after
  float* sStats = reinterpret_cast<float*>(sQD + 4 * TB);  // stage s: lse, delta at 2 s 64
  float* sP = sStats + 4 * kRows;  // P^T, [32][128]: value i of thread j at i * 128 + j

  const int kt = blockIdx.x / (nc * bh_count), rest = blockIdx.x % (nc * bh_count);
  const int oc = rest / bh_count, bh = rest % bh_count;
  const int k0 = kt * kRows;
  const size_t q_base = (size_t)bh * Sq * D, kv_base = (size_t)bh * Skv * D;
  const float* lse_bh = lse + (size_t)bh * Sq;
  const float* delta_bh = delta + (size_t)bh * Sq;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};

  // The query tiles this key tile visits: under the causal mask the tiles
  // from its diagonal on (first = kt), and tile 0 before them when it holds
  // a row that sees no key (shift 1), whose P is 1 for every key.
  const int n_qb = (Sq + kRows - 1) / kRows;
  const int first = causal ? min(kt, n_qb) : 0;
  const int extra = causal && shift && first > 0;
  const int steps = (n_qb - first + extra) * nc;
  constexpr bool pipelined = !kChunks;
  auto q_tile = [&](int n) {
    const int vis = n / nc;
    return (extra ? (vis == 0 ? 0 : first + vis - 1) : first + vis) * kRows;
  };
  auto issue = [&](int n, int buf) {
    const int col0 = (oc + 1 + n % nc) % nc * W, q0 = q_tile(n);
    if (!pipelined || n == 0) {
      Ops::stage(sK, k + kv_base, k0, Skv, D, col0, gran, tid, 256);
      Ops::stage(sV, v + kv_base, k0, Skv, D, col0, gran, tid, 256);
    }
    unsigned char* sQ = sQD + 2 * buf * TB;
    Ops::stage(sQ, q + q_base, q0, Sq, D, col0, gran, tid, 256);
    Ops::stage(sQ + TB, dout + q_base, q0, Sq, D, col0, gran, tid, 256);
    stage_stats(sStats + buf * 2 * kRows, lse_bh, delta_bh, q0, Sq, tid, 256);
    cp_async_commit();
  };

  float acc[NP][32];  // warpgroup 0: dV, 1: dK (this chunk's columns)
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  // Warpgroup 0: S^T = K Q^T, 1: dP^T = V dO^T; 64 keys x 64 queries, summed
  // over the chunks.
  float s[32];
  if (steps > 0) issue(0, 0);
  for (int n = 0; n < steps; ++n) {
    const int buf = pipelined ? n & 1 : 0;
    if (pipelined && n + 1 < steps) {
      issue(n + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int i = n % nc, ch = (oc + 1 + i) % nc, q0 = q_tile(n);
    const unsigned char* sQ = sQD + 2 * buf * TB;
    const float* sL = sStats + buf * 2 * kRows;
    const int width = min(W, D - ch * W);  // of this step's chunk
    if (wg == 0) {
      Ops::scores(s, sK, sQ, width, i > 0, warp, lane);
      if (i == nc - 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1), key = keys[e >> 1];
            float x = s[4 * j + e] * scale_log2;
            if (causal && q0 + c < key + shift) x = fill_log2;
            s[4 * j + e] =
                q0 + c < Sq && key < Skv ? exp2_approx(x - to_log2(sL[c])) : 0.f;  // P^T
            sP[(4 * j + e) * 128 + wt] = s[4 * j + e];
          }
        }
        named_barrier_arrive(1, 256);  // P^T is in sP
        Ops::product(acc, s, sQ + TB, warp, lane);  // dV += P^T dO
      }
    } else {
      Ops::scores(s, sV, sQ + TB, width, i > 0, warp, lane);
      if (i == nc - 1) {
        named_barrier(1, 256);  // wait for P^T
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            s[4 * j + e] = sP[(4 * j + e) * 128 + wt] * (s[4 * j + e] - sL[kRows + c]) * scale;
          }
        Ops::product(acc, s, sQ, warp, lane);  // dK += dS^T Q
      }
    }
    __syncthreads();  // the buffers of this step and sP are read
    if (!pipelined && n + 1 < steps) issue(n + 1, 0);
  }

  // dV and dK through the (free) query stages, a pair of them each:
  // coalesced rows.
  unsigned char* buf = sQD + 2 * wg * TB;
  tile_to_smem<T, NP>(buf, acc, warp, lane);
  __syncthreads();
  smem_to_rows<T, NP>((wg == 0 ? dv : dk) + kv_base, buf, k0, Skv, D, oc * W, gran, wt, 128);
}


// ------------------------------------------------------------------ host --

// The widest copy (16, 4 or 2 bytes) that every base and every row start of
// [*, d] tensors of `elem`-byte values allows.
int granule(int d, int elem, const void* const* ptrs, int n) {
  for (int g : {16, 4}) {
    bool ok = (d * elem) % g == 0;
    for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % g == 0;
    if (ok) return g;
  }
  return 2;
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, long long blocks, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dq_out, int bh, int sq, int skv, int d, int causal, int shift,
       float scale, cudaStream_t stream) {
  using Ops = OpsOf<T, NP>;
  const void* ptrs[5] = {q, k, v, dout, dq_out};
  const int gran = granule(d, sizeof(T), ptrs, 5);
  const int nc = (d + Ops::kWidth - 1) / Ops::kWidth;
  // Q, dO and two stages of K and V, and 1024 bytes to align the first.
  const size_t smem = 6 * (size_t)Ops::kTileBytes + 1024;
  return launch_kernel(nc > 1 ? flash_dq_generic_kernel<T, NP, true>
                              : flash_dq_generic_kernel<T, NP, false>,
                       (long long)((sq + kRows - 1) / kRows) * nc * bh, 128, smem, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dq_out), bh, sq, skv, d, nc, causal, shift, scale, gran);
}

template <typename T, int NP>
int dkv(const void* k, const void* v, const void* q, const void* dout, const void* lse,
        const void* delta, void* dk, void* dv, int bh, int sq, int skv, int d, int causal,
        int shift, float scale, cudaStream_t stream) {
  using Ops = OpsOf<T, NP>;
  const void* ptrs[6] = {k, v, q, dout, dk, dv};
  const int gran = granule(d, sizeof(T), ptrs, 6);
  const int nc = (d + Ops::kWidth - 1) / Ops::kWidth;
  // K, V, two stages of Q and dO, two of lse and delta, P^T (64 x 64 f32),
  // and 1024 to align.
  const size_t smem = 6 * (size_t)Ops::kTileBytes + 2 * kStatBytes + kRows * kRows * 4 + 1024;
  return launch_kernel(nc > 1 ? flash_dkv_generic_kernel<T, NP, true>
                              : flash_dkv_generic_kernel<T, NP, false>,
                       (long long)((skv + kRows - 1) / kRows) * nc * bh, 256, smem, stream,
                       static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const T*>(q), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, skv, d, nc, causal,
                       shift, scale, gran);
}

// 16 bits: one panel a chunk up to D = 64, two above (D = 128 in one chunk).
template <typename T, typename... Args>
int dq16(int d, Args... args) {
  return d <= kPanel ? dq<T, 1>(args...) : dq<T, 2>(args...);
}

template <typename T, typename... Args>
int dkv16(int d, Args... args) {
  return d <= kPanel ? dkv<T, 1>(args...) : dkv<T, 2>(args...);
}

}  // namespace

// K2g. q, dout, dq: [bh, sq, d]; k, v: [bh, skv, d]; contiguous, of one
// dtype (0 float32, 1 bfloat16, 2 float16), d >= 1, no alignment asked.
// lse, delta: [bh, sq] f32. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_dq_generic(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq_out, int bh, int sq, int skv, int d,
                                          int causal, int causal_shift, int dtype, float scale,
                                          void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dq<float, 1>(q, k, v, dout, lse, delta, dq_out, bh, sq, skv, d, causal,
                          causal_shift, scale, st);
    case 1:
      return dq16<bf16>(d, q, k, v, dout, lse, delta, dq_out, bh, sq, skv, d, causal,
                        causal_shift, scale, st);
    case 2:
      return dq16<__half>(d, q, k, v, dout, lse, delta, dq_out, bh, sq, skv, d, causal,
                          causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3g. k, v, dk, dv: [bh, skv, d]; q, dout: [bh, sq, d]; the rest as above.
extern "C" int flash_attention_dkv_generic(const void* k, const void* v, const void* q,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int sq, int skv, int d, int causal,
                                           int causal_shift, int dtype, float scale,
                                           void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dkv<float, 1>(k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, d, causal,
                              causal_shift, scale, st);
    case 1:
      return dkv16<bf16>(d, k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, d, causal,
                         causal_shift, scale, st);
    case 2:
      return dkv16<__half>(d, k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, d, causal,
                           causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
