// Flash attention forward and backward for every float dtype and head dim
// the reference takes: float32, float16 and bfloat16 at any 1 <= D <= 256
// (the "generic route"; bf16 at D 32 and 64 takes the Hopper kernels of
// flash_attention_fwd.cu and flash_attention_bwd.cu).
//
// Replaces the Pallas kernels of distkeras_tpu/ops/pallas/flash_attention.py
// outside the Hopper kernels' domain:
// - K1g, `_fwd_kernel` launched by `_flash_forward` (:189):
//     O = softmax(Q K^T * scale [masked]) V, lse = m + log(l) per query row;
// - K2g, `_dq_kernel` launched by `dq_call` (:214): dQ = dS K, where
//     P = exp(S * scale - lse) and dS = P o (dO V^T - delta) * scale;
// - K3g, `_dkv_kernel` launched by `dkv_call` (:238): dK = dS^T Q, dV = P^T dO.
// The causal mask `row >= col + causal_shift` fills scores with -1e30 (not
// -inf), so a query row that sees no key (shift 1, row 0) weighs every key
// equally and gets lse exactly -1e30, as in the reference. All arithmetic is
// float32 (full float32 FMAs, no TF32); P is rounded to the input type before
// P.V and P^T.dO, and dS before dS.K and dS^T.Q, where the plain versions
// (ops/flash_attention.py) round them; for float32 those roundings are the
// identity. The scale is the caller's D^-1/2.
//
// What bounds them on the H100: per (bh) slice the forward does 4*S*S*D
// flops (the backward 6 and 8) on 4 (5, 6) tensors of S*D elements: S
// flops a float32 byte, 128 at bert_base's S = 128, against the card's
// float32 ratio of 67 TFLOP/s (FMA units, not tensor cores) over 3.35 TB/s,
// 20 flops a byte: compute bound in float32 at every S past ~20, and in
// bf16/f16 too, since this route does its products on the FMA units.
//
// Design, simple first (a tensor-core design is later work): one block of
// 256 threads per tile of 64 query rows (K1g, K2g) or of BK keys (K3g) of
// one (bh) slice; tiles are copied from device memory into float32 tiles in
// shared memory, element by element, columns past D as zeros, rows past S
// as zeros: no alignment is asked of rows (D = 12 in f16 is 24 bytes a row)
// and S_q may differ from S_kv. Each thread owns a 4 x (BK/16) piece of the
// 64 x BK score tile (rows g*4..g*4+3, columns l + 16*j, for g = tid/16 and
// l = tid%16), so a row's max and sum are shuffles within a half warp, and
// a 4 x (Dp/16) piece of the output (columns l + 16*j) whose rows match its
// score rows: the forward's rescale needs no exchange. The padded width Dp
// (16, 32, 64, 128 or 256, the least that holds D) is a template argument,
// D a run-time one: the products loop to D, not to Dp. Tiles of D elements
// a row are stored at a stride of Dp + 1 floats, so that 16 lanes reading
// one column of 16 rows hit 16 banks. BK is 64 keys, 32 at Dp = 256, which
// keeps each kernel's shared memory under 227 KB and its accumulators at 64
// registers a thread.
// Causal tiles skip key tiles (K1g, K2g) or query tiles (K3g) wholly above
// the diagonal, except the tiles holding a row that sees no key (row <
// shift), which weighs every key.

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

// dst[r][d] (stride Dp + 1) = src[row0 + r][d] as float32 for r < R, d < Dp;
// zero past S rows or D columns. src is one (bh) slice, [S, D] contiguous.
template <typename T, int Dp, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S, int D) {
  constexpr int LD = Dp + 1;
  for (int idx = threadIdx.x; idx < R * Dp; idx += kThreads) {
    const int r = idx / Dp, d = idx % Dp, row = row0 + r;
    dst[r * LD + d] = (row < S && d < D) ? to_f<T>(src[(size_t)row * D + d]) : 0.f;
  }
}

// The scores of this thread's 4 x NJ piece of a 64 x BK tile, and of a
// second product over the same rows and keys (dO V^T in the backward):
// a[i][j] = sum_d A[g*4+i][d] B[l+16j][d].
template <int Dp, int NJ>
__device__ __forceinline__ void tile_dots(float (&a)[4][NJ], const float* A, const float* B,
                                          int D, int g, int l) {
  constexpr int LD = Dp + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) a[i][j] = 0.f;
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

// K1g. Block (tile, bh) of a grid of q_tiles * BH blocks.
template <typename T, int Dp, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                             int S, int D, int q_tiles, int causal, int shift, float scale) {
  constexpr int LD = Dp + 1, PLD = BK + 1, NJ = BK / 16, ND = Dp / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [64][LD]
  float* Ks = Qs + kRows * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Ps = Vs + BK * LD;     // [64][PLD]
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const size_t bh = blockIdx.x / q_tiles, base = bh * S * (size_t)D;
  const int g = threadIdx.x >> 4, l = threadIdx.x & 15;

  load_tile<T, Dp, kRows>(Qs, q + base, q0, S, D);
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
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<T, Dp, BK>(Ks, k + base, k0, S, D);
    load_tile<T, Dp, BK>(Vs, v + base, k0, S, D);
    __syncthreads();
    float s[4][NJ];
    tile_dots<Dp, NJ>(s, Qs, Ks, D, g, l);
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
      if (d < D) o[base + (size_t)row * D + d] = from_f<T>(acc[i][jd] / l_safe);
    }
    if (l == 0) lse[bh * S + row] = m[i] + logf(l_safe);
  }
}

// P and dS of this thread's 4 x NJ piece of the (q0, k0) tile from the
// scores s and dO V^T dp (both overwritten: s by P, dp by dS), each zero
// outside [0, Sq) x [0, Skv).
template <int NJ>
__device__ __forceinline__ void probs_and_dscores(float (&s)[4][NJ], float (&dp)[4][NJ],
                                                  const float (&row_lse)[4],
                                                  const float (&row_delta)[4], int q0, int k0,
                                                  int Sq, int Skv, int g, int l, int causal,
                                                  int shift, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + g * 4 + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = k0 + l + 16 * j;
      float p = 0.f, ds = 0.f;
      if (row < Sq && col < Skv) {
        p = expf(score(s[i][j], scale, row, col, causal, shift) - row_lse[i]);
        ds = p * (dp[i][j] - row_delta[i]) * scale;
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

// K2g. Block (tile, bh) of a grid of q_tiles * BH blocks.
template <typename T, int Dp, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dq_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Skv, int D, int q_tiles, int causal,
                            int shift, float scale) {
  constexpr int LD = Dp + 1, PLD = BK + 1, NJ = BK / 16, ND = Dp / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][LD]
  float* dOs = Qs + kRows * LD;  // [64][LD]
  float* Ks = dOs + kRows * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* dSs = Vs + BK * LD;     // [64][PLD]
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const size_t bh = blockIdx.x / q_tiles;
  const size_t q_base = bh * Sq * (size_t)D, kv_base = bh * Skv * (size_t)D;
  const int g = threadIdx.x >> 4, l = threadIdx.x & 15;

  load_tile<T, Dp, kRows>(Qs, q + q_base, q0, Sq, D);
  load_tile<T, Dp, kRows>(dOs, dout + q_base, q0, Sq, D);
  float row_lse[4], row_delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + g * 4 + i;
    row_lse[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    row_delta[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }
  const int kv_end = causal_keys(q0, Skv, causal, shift);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's K and dS are read
    load_tile<T, Dp, BK>(Ks, k + kv_base, k0, Skv, D);
    load_tile<T, Dp, BK>(Vs, v + kv_base, k0, Skv, D);
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    tile_dots<Dp, NJ>(s, Qs, Ks, D, g, l);
    tile_dots<Dp, NJ>(dp, dOs, Vs, D, g, l);
    probs_and_dscores<NJ>(s, dp, row_lse, row_delta, q0, k0, Sq, Skv, g, l, causal, shift,
                          scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dSs[(g * 4 + i) * PLD + l + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();
    tile_product<Dp, BK>(acc, dSs, Ks, min(BK, Skv - k0), g, l);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + g * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int d = l + 16 * jd;
      if (d < D) dq[q_base + (size_t)row * D + d] = from_f<T>(acc[i][jd]);
    }
  }
}

// K3g. Block (tile, bh) of a grid of k_tiles * BH blocks, BK keys a tile.
// This thread's output rows are keys g*RK .. g*RK + RK - 1 of the tile.
template <typename T, int Dp, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_generic_kernel(const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ q, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int D,
                             int k_tiles, int causal, int shift, float scale) {
  constexpr int LD = Dp + 1, PLD = BK + 1, NJ = BK / 16, ND = Dp / 16, RK = BK / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][LD]
  float* Qs = Vs + BK * LD;      // [64][LD]
  float* dOs = Qs + kRows * LD;  // [64][LD]
  float* Ps = dOs + kRows * LD;  // [64][PLD]
  float* dSs = Ps + kRows * PLD;  // [64][PLD]
  const int k0 = (blockIdx.x % k_tiles) * BK;
  const size_t bh = blockIdx.x / k_tiles;
  const size_t q_base = bh * Sq * (size_t)D, kv_base = bh * Skv * (size_t)D;
  const int g = threadIdx.x >> 4, l = threadIdx.x & 15;

  load_tile<T, Dp, BK>(Ks, k + kv_base, k0, Skv, D);
  load_tile<T, Dp, BK>(Vs, v + kv_base, k0, Skv, D);
  float dk_acc[RK][ND], dv_acc[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;
  for (int q0 = 0; q0 < Sq; q0 += kRows) {
    // Under the mask a query tile whose last row sees no key of this tile
    // adds nothing, unless it holds a row that sees no key at all.
    if (causal && q0 >= shift && q0 + kRows - 1 < k0 + shift) continue;
    __syncthreads();  // the last query tile's Q, dO, P and dS are read
    load_tile<T, Dp, kRows>(Qs, q + q_base, q0, Sq, D);
    load_tile<T, Dp, kRows>(dOs, dout + q_base, q0, Sq, D);
    float row_lse[4], row_delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g * 4 + i;
      row_lse[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
      row_delta[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][NJ], dp[4][NJ];
    tile_dots<Dp, NJ>(s, Qs, Ks, D, g, l);
    tile_dots<Dp, NJ>(dp, dOs, Vs, D, g, l);
    probs_and_dscores<NJ>(s, dp, row_lse, row_delta, q0, k0, Sq, Skv, g, l, causal, shift,
                          scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Ps[(g * 4 + i) * PLD + l + 16 * j] = round_to<T>(s[i][j]);
        dSs[(g * 4 + i) * PLD + l + 16 * j] = round_to<T>(dp[i][j]);
      }
    __syncthreads();
    // dV[c] += sum_r P[r][c] dO[r], dK[c] += sum_r dS[r][c] Q[r], c this thread's keys.
    const int rows = min(kRows, Sq - q0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float p[RK], ds[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        p[i] = Ps[r * PLD + g * RK + i];
        ds[i] = dSs[r * PLD + g * RK + i];
      }
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        const float x = dOs[r * LD + l + 16 * jd], y = Qs[r * LD + l + 16 * jd];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          dv_acc[i][jd] = fmaf(p[i], x, dv_acc[i][jd]);
          dk_acc[i][jd] = fmaf(ds[i], y, dk_acc[i][jd]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + g * RK + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int d = l + 16 * jd;
      if (d < D) {
        dk[kv_base + (size_t)key * D + d] = from_f<T>(dk_acc[i][jd]);
        dv[kv_base + (size_t)key * D + d] = from_f<T>(dv_acc[i][jd]);
      }
    }
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

template <typename T, int Dp>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s, int d,
        int causal, int shift, float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<Dp>();
  const size_t smem = sizeof(float) * (kRows * (Dp + 1) + 2 * BK * (Dp + 1) + kRows * (BK + 1));
  const int tiles = (s + kRows - 1) / kRows;
  return launch_kernel(flash_fwd_generic_kernel<T, Dp, BK>, (long long)tiles * bh, smem, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                       s, d, tiles, causal, shift, scale);
}

template <typename T, int Dp>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dq_out, int bh, int sq, int skv, int d, int causal, int shift,
       float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<Dp>();
  const size_t smem =
      sizeof(float) * (2 * kRows * (Dp + 1) + 2 * BK * (Dp + 1) + kRows * (BK + 1));
  const int tiles = (sq + kRows - 1) / kRows;
  return launch_kernel(flash_dq_generic_kernel<T, Dp, BK>, (long long)tiles * bh, smem, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dq_out), sq, skv, d, tiles, causal, shift, scale);
}

template <typename T, int Dp>
int dkv(const void* k, const void* v, const void* q, const void* dout, const void* lse,
        const void* delta, void* dk, void* dv, int bh, int sq, int skv, int d, int causal,
        int shift, float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<Dp>();
  const size_t smem =
      sizeof(float) * (2 * BK * (Dp + 1) + 2 * kRows * (Dp + 1) + 2 * kRows * (BK + 1));
  const int tiles = (skv + BK - 1) / BK;
  return launch_kernel(flash_dkv_generic_kernel<T, Dp, BK>, (long long)tiles * bh, smem, stream,
                       static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const T*>(q), static_cast<const T*>(dout),
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, d, tiles, causal,
                       shift, scale);
}

// F<T, Dp>::run(args...) at the least padded width Dp that holds d.
template <template <typename, int> class F, typename T, typename... Args>
int by_dim(int d, Args... args) {
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 16) return F<T, 16>::run(args...);
  if (d <= 32) return F<T, 32>::run(args...);
  if (d <= 64) return F<T, 64>::run(args...);
  if (d <= 128) return F<T, 128>::run(args...);
  return F<T, 256>::run(args...);
}

// ... for the element type of `dtype`: 0 float32, 1 bfloat16, 2 float16.
template <template <typename, int> class F, typename... Args>
int dispatch(int dtype, int d, Args... args) {
  switch (dtype) {
    case 0:
      return by_dim<F, float>(d, args...);
    case 1:
      return by_dim<F, __nv_bfloat16>(d, args...);
    case 2:
      return by_dim<F, __half>(d, args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int Dp>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) {
    return fwd<T, Dp>(args...);
  }
};

template <typename T, int Dp>
struct Dq {
  template <typename... Args>
  static int run(Args... args) {
    return dq<T, Dp>(args...);
  }
};

template <typename T, int Dp>
struct Dkv {
  template <typename... Args>
  static int run(Args... args) {
    return dkv<T, Dp>(args...);
  }
};

}  // namespace

// K1g. q, k, v, o: [bh, s, d] contiguous, of one dtype (0 float32, 1
// bfloat16, 2 float16), 1 <= d <= 256, no alignment asked; lse: [bh, s] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_generic(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int bh, int s, int d, int causal,
                                           int causal_shift, int dtype, float scale,
                                           void* stream) {
  return dispatch<Fwd>(dtype, d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale,
                       static_cast<cudaStream_t>(stream));
}

// K2g. q, dout, dq: [bh, sq, d]; k, v: [bh, skv, d]; contiguous, of one
// dtype as above. lse, delta: [bh, sq] f32.
extern "C" int flash_attention_dq_generic(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq_out, int bh, int sq, int skv, int d,
                                          int causal, int causal_shift, int dtype, float scale,
                                          void* stream) {
  return dispatch<Dq>(dtype, d, q, k, v, dout, lse, delta, dq_out, bh, sq, skv, d, causal,
                      causal_shift, scale, static_cast<cudaStream_t>(stream));
}

// K3g. k, v, dk, dv: [bh, skv, d]; q, dout: [bh, sq, d]; the rest as above.
extern "C" int flash_attention_dkv_generic(const void* k, const void* v, const void* q,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int sq, int skv, int d, int causal,
                                           int causal_shift, int dtype, float scale,
                                           void* stream) {
  return dispatch<Dkv>(dtype, d, k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, d, causal,
                       causal_shift, scale, static_cast<cudaStream_t>(stream));
}
