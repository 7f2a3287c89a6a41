// Flash attention forward for every float dtype and head dim the reference
// takes: float32, float16 and bfloat16 at any D >= 1 (K1g, the forward of
// the "generic route"; bf16 at D 32 and 64 takes the Hopper kernel of
// flash_attention_fwd.cu, and the generic backward K2g/K3g lives in
// flash_attention_generic_bwd.cu).
//
// Replaces the Pallas kernel of distkeras_tpu/ops/pallas/flash_attention.py
// outside the Hopper kernel's domain: K1g, `_fwd_kernel` launched by
// `_flash_forward` (:189): O = softmax(Q K^T * scale [masked]) V, lse = m +
// log(l) per query row. The causal mask `row >= col + causal_shift` fills
// scores with -1e30 (not -inf), so a query row that sees no key (shift 1,
// row 0) weighs every key equally and gets lse exactly -1e30, as in the
// reference. All arithmetic is float32 (full float32 FMAs, no TF32); P is
// rounded to the input type before P.V, where the plain version
// (ops/flash_attention.py) rounds it; for float32 that rounding is the
// identity. The scale is the caller's D^-1/2.
//
// What bounds it on the H100: per (bh) slice it does 4*S*S*D flops on 4
// tensors of S*D elements: S flops a float32 byte, 128 at bert_base's S =
// 128, against the card's float32 ratio of 67 TFLOP/s (FMA units, not
// tensor cores) over 3.35 TB/s, 20 flops a byte: compute bound in float32 at
// every S past ~20, and in bf16/f16 too, since it does its products on the
// FMA units.
//
// Design, simple first (a tensor-core design is later work): one block of
// 256 threads per tile of 64 query rows of one (bh) slice; tiles are copied
// from device memory into float32 tiles in shared memory, element by
// element, columns past D as zeros, rows past S as zeros: no alignment is
// asked of rows (D = 12 in f16 is 24 bytes a row). Each thread owns a 4 x
// (BK/16) piece of the 64 x BK score tile (rows g*4..g*4+3, columns l +
// 16*j, for g = tid/16 and l = tid%16), so a row's max and sum are shuffles
// within a half warp, and a 4 x (Dp/16) piece of the output (columns l +
// 16*j) whose rows match its score rows: the rescale needs no exchange. The
// padded width Dp (16, 32, 64, 128 or 256, the least that holds D) is a
// template argument, D a run-time one: the products loop to D, not to Dp.
// Tiles of D elements a row are stored at a stride of Dp + 1 floats, so
// that 16 lanes reading one column of 16 rows hit 16 banks. BK is 64 keys,
// 32 at Dp = 256, which keeps shared memory under 227 KB and the
// accumulators at 64 registers a thread.
// D above 256 goes through column chunks of Dp = 256: a grid axis gives
// each block one chunk of O's columns, and the scores reduce over the whole
// D, one chunk of Q and K staged at a time, the block's own chunk last (its
// V chunk staged with it); each chunk's block recomputes the scores.
// Causal tiles skip key tiles wholly above the diagonal, except the tile
// holding a row that sees no key (row < shift), which weighs every key.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 groups of 16 lanes
constexpr int kRows = 64;      // query rows of a tile
constexpr float kMasked = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened again: where the plain versions round P and dS.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Reductions over the 16 lanes (a half warp) that share a row group.
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dst[r][d] (stride Dp + 1) = src[row0 + r][col0 + d] as float32 for r <
// R, d < Dp; zero past S rows or `width` columns. src is one (bh) slice,
// [S, D] contiguous.
template <typename T, int Dp, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S, int D, int col0, int width) {
  constexpr int LD = Dp + 1;
  for (int idx = threadIdx.x; idx < R * Dp; idx += kThreads) {
    const int r = idx / Dp, d = idx % Dp, row = row0 + r;
    dst[r * LD + d] =
        (row < S && d < width) ? to_f<T>(src[(size_t)row * D + col0 + d]) : 0.f;
  }
}

// The scores of this thread's 4 x NJ piece of a 64 x BK tile over the first
// D columns: a[i][j] (+)= sum_d A[g*4+i][d] B[l+16j][d] (kAdd: added to a).
template <int Dp, int NJ, bool kAdd = false>
__device__ __forceinline__ void tile_dots(float (&a)[4][NJ], const float* A, const float* B,
                                          int D, int g, int l) {
  constexpr int LD = Dp + 1;
  if (!kAdd) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(g * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = B[(l + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
  }
}

// The masked, scaled score of query `row` against key `col`.
__device__ __forceinline__ float score(float dot, float scale, int row, int col, int causal,
                                       int shift) {
  const float x = dot * scale;
  return (causal && row < col + shift) ? kMasked : x;
}

// acc[i][jd] += sum_c W[g*4+i][c] X[c][l+16jd] over c < n: W a 64 x BK tile
// (stride BK + 1), X a BK x Dp tile (stride Dp + 1).
template <int Dp, int BK>
__device__ __forceinline__ void tile_product(float (&acc)[4][Dp / 16], const float* W,
                                             const float* X, int n, int g, int l) {
  constexpr int LD = Dp + 1, PLD = BK + 1;
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(g * 4 + i) * PLD + c];
#pragma unroll
    for (int jd = 0; jd < Dp / 16; ++jd) {
      const float x = X[c * LD + l + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(w[i], x, acc[i][jd]);
    }
  }
}

// The number of keys a causal query tile [q0, q0 + 64) needs: keys up to
// its last row's diagonal, or every key if a row of it sees none.
__device__ __forceinline__ int causal_keys(int q0, int Skv, int causal, int shift) {
  if (!causal || q0 < shift) return Skv;
  return min(Skv, q0 + kRows - shift);
}

// K1g. Block (tile, chunk, bh) of a grid of q_tiles * nc * BH blocks; nc,
// the number of Dp-column chunks of D, is 1 unless D > 256, which takes the
// kChunks instance (the others compile without the chunk loop).
template <typename T, int Dp, int BK, bool kChunks>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                             int S, int D, int q_tiles, int chunks, int causal, int shift,
                             float scale) {
  const int nc = kChunks ? chunks : 1;
  constexpr int LD = Dp + 1, PLD = BK + 1, NJ = BK / 16, ND = Dp / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [64][LD]
  float* Ks = Qs + kRows * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Ps = Vs + BK * LD;     // [64][PLD]
  const int q0 = (blockIdx.x % q_tiles) * kRows, oc = blockIdx.x / q_tiles % nc;
  const size_t bh = blockIdx.x / q_tiles / nc, base = bh * S * (size_t)D;
  const int c0 = oc * Dp, width = min(Dp, D - c0);  // this block's columns of O
  const int g = threadIdx.x >> 4, l = threadIdx.x & 15;

  if (nc == 1) load_tile<T, Dp, kRows>(Qs, q + base, q0, S, D, 0, D);
  float m[4], sum[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    sum[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }
  const int kv_end = causal_keys(q0, S, causal, shift);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[4][NJ];
    if (!kChunks) {
      __syncthreads();  // the last tile's K, V and P are read
      load_tile<T, Dp, BK>(Ks, k + base, k0, S, D, 0, D);
      load_tile<T, Dp, BK>(Vs, v + base, k0, S, D, 0, D);
      __syncthreads();
      tile_dots<Dp, NJ>(s, Qs, Ks, D, g, l);
    } else {
      // Chunk (oc + 1 + c) % nc of Q and K at step c, the block's own
      // last, with its V.
      tile_dots<Dp, NJ>(s, Qs, Ks, 0, g, l);  // zeros
      for (int c = 0; c < nc; ++c) {
        const int cc = (oc + 1 + c) % nc * Dp, w = min(Dp, D - cc);
        __syncthreads();  // the last chunk's (tile's) Q, K, V and P are read
        load_tile<T, Dp, kRows>(Qs, q + base, q0, S, D, cc, w);
        load_tile<T, Dp, BK>(Ks, k + base, k0, S, D, cc, w);
        if (c == nc - 1) load_tile<T, Dp, BK>(Vs, v + base, k0, S, D, cc, w);
        __syncthreads();
        tile_dots<Dp, NJ, true>(s, Qs, Ks, w, g, l);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g * 4 + i;
      float tile_max = kMasked;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + l + 16 * j;
        s[i][j] = score(s[i][j], scale, row, col, causal, shift);
        if (col < S) tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(tile_max));
      const float corr = expf(m[i] - m_new);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + l + 16 * j;
        const float p = col < S ? expf(s[i][j] - m_new) : 0.f;
        part += p;
        Ps[(g * 4 + i) * PLD + l + 16 * j] = round_to<T>(p);
      }
      sum[i] = sum[i] * corr + group16_sum(part);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();
    tile_product<Dp, BK>(acc, Ps, Vs, min(BK, S - k0), g, l);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + g * 4 + i;
    if (row >= S) continue;
    const float l_safe = fmaxf(sum[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int d = l + 16 * jd;
      if (d < width) o[base + (size_t)row * D + c0 + d] = from_f<T>(acc[i][jd] / l_safe);
    }
    if (l == 0 && oc == 0) lse[bh * S + row] = m[i] + logf(l_safe);
  }
}

// The key tile of a padded width: 64, or 32 at Dp = 256 (shared memory).
template <int Dp>
constexpr int key_tile() {
  return Dp >= 256 ? 32 : 64;
}

template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, long long blocks, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int Dp, bool kChunks = false>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s, int d,
        int causal, int shift, float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<Dp>();
  const size_t smem = sizeof(float) * (kRows * (Dp + 1) + 2 * BK * (Dp + 1) + kRows * (BK + 1));
  const int tiles = (s + kRows - 1) / kRows, nc = (d + Dp - 1) / Dp;
  return launch_kernel(flash_fwd_generic_kernel<T, Dp, BK, kChunks>, (long long)tiles * nc * bh,
                       smem, stream, static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                       s, d, tiles, nc, causal, shift, scale);
}

// fwd<T, Dp> at the least padded width Dp that holds d, or Dp = 256 in
// chunks above it.
template <typename T, typename... Args>
int by_dim(int d, Args... args) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (d <= 16) return fwd<T, 16>(args...);
  if (d <= 32) return fwd<T, 32>(args...);
  if (d <= 64) return fwd<T, 64>(args...);
  if (d <= 128) return fwd<T, 128>(args...);
  if (d <= 256) return fwd<T, 256>(args...);
  return fwd<T, 256, true>(args...);
}

}  // namespace

// K1g. q, k, v, o: [bh, s, d] contiguous, of one dtype (0 float32, 1
// bfloat16, 2 float16), d >= 1, no alignment asked; lse: [bh, s] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_generic(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int bh, int s, int d, int causal,
                                           int causal_shift, int dtype, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_dim<float>(d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale, st);
    case 1:
      return by_dim<__nv_bfloat16>(d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale,
                                   st);
    case 2:
      return by_dim<__half>(d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
