// Flash attention backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// bf16 in, bf16 out, f32 statistics.
//
// Replaces: distkeras_tpu/ops/pallas/flash_attention.py `dq_call` (kernel
// `_dq_kernel`) and `dkv_call` (kernel `_dkv_kernel`), the Pallas TPU
// kernels. Same functions, per (bh) slice, with q and dO [Sq, D], k and v
// [Skv, D], and the forward's lse and delta = rowsum(dO * O) [Sq] in f32:
//   P  = exp(Q K^T * scale [masked] - lse)      dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dQ = dS K          dK = dS^T Q          dV = P^T dO
// Sq may differ from Skv (the ring-attention hops call them that way). The
// causal mask keeps `row >= col + causal_shift` and fills the rest with
// -1e30 before the exp, as the reference does, so a query row that sees no
// key at all (row 0 under shift 1) has lse = -1e30 and P = exp(0) = 1 for
// EVERY key, exactly as in the reference. Keys past the end of a ragged
// tile get -inf, so their P is 0.
//
// What bounds it on the H100: per (bh) slice K2 does 6*Sq*Skv*D flops (three
// products) on 4 tensors of S*D bf16 in and 1 out; K3 8*Sq*Skv*D on 4 in and
// 2 out. At S = 128 (bert_base_mlm) that is 77 and 85 flops per byte, at
// S = 512 causal (gpt_small, half of it masked) about 150: all below the
// card's ~295 flops/byte balance point, so both are memory bound. The design
// therefore reads every input once per tile that needs it and never writes
// the S x S probability or score matrices: they live in registers.
//
// Design: one thread block of 4 warps per 64-row tile, each warp owning 16
// rows, with mma.sync m16n8k16 (bf16 inputs, f32 accumulators).
// - K2, one block per (64-query tile, bh). The warp's Q and dO fragments,
//   and lse and delta of its rows, stay in registers for the whole key loop.
//   K and V tiles of 64 keys are staged row-major in shared memory. The dS
//   accumulators, rounded to bf16, are the A fragments of dS.K directly; the
//   B fragments of that product come from the same row-major K tile through
//   ldmatrix.trans, so no transposed copy is made. Causal tiles stop at the
//   diagonal, except a tile that holds a fully masked row.
// - K3, one block per (64-key tile, bh), in the key-row frame:
//   S^T = K Q^T, P^T = exp(S^T * scale - lse[col]), dP^T = V dO^T,
//   dS^T = P^T * (dP^T - delta[col]) * scale, then dV += P^T dO and
//   dK += dS^T Q with the P^T and dS^T accumulators as A fragments and the
//   row-major Q and dO tiles read through ldmatrix.trans. lse and delta of
//   the tile's 64 queries sit in shared memory. Causal blocks skip query
//   tiles wholly above the diagonal, but always visit the tile that holds a
//   fully masked row.
// - Both stage their tiles with cp.async into two buffers: the copy of the
//   next tile runs while the warps compute on this one.
// - The exps run in base 2 on pre-scaled scores (one ex2 each, where expf
//   costs about ten instructions and each thread takes 64 per tile).
// - Under the causal mask tiles differ in length; the grid puts the tile in
//   blockIdx.y, so that the longest tiles are dispatched first.
// P^T is rounded to bf16 for the P^T.dO product (the reference keeps it in
// f32 there); dS is rounded to bf16 on both sides. Each block owns its output
// tile: no atomics, and the result does not depend on the launch order.
// No TMA and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;  // rows per block (4 warps x 16) and per staged tile
constexpr int kThreads = 128;
// Three blocks per SM cap the kernels at 168 registers (K3 would take 255).
// K3 then spills a few hundred bytes, and is faster all the same: the extra
// warps hide the latency of the tile copies (measured on the H100 at both
// bert_base_mlm and gpt_small shapes).
constexpr int kMinBlocksPerSM = 3;
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// x * log2(e), never fused into a neighbouring add: the mask fill and the
// lse of a fully masked row (both -1e30) must convert to the same value, so
// that their difference is exactly 0 and that row's P exactly 1.
__device__ __forceinline__ float to_log2(float x) { return __fmul_rn(x, kLog2e); }

// Rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a [64][D + 8] tile, by
// cp.async; rows past `rows` are zero-filled. The +8 pad puts the 8 rows of
// one ldmatrix phase on disjoint banks.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int r0, int rows,
                                           int tid) {
  constexpr int ST = D + 8, CHUNKS = D / 8;
  for (int c = tid; c < kBlock * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool in = r0 + r < rows;
    cp_async_16(dst + r * ST + col, src + (in ? (size_t)(r0 + r) * D + col : 0), in);
  }
}

// The warp's A fragments (its 16 rows from `wr`, all D columns) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4], const bf16* tile, int wr,
                                       int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], tile + (wr + (lane & 15)) * ST + kk * 16 + (lane >> 4) * 8);
}

// out (16 x 64) = A (16 x D, fragments) . tile^T: the 64 rows of a staged
// [64][D + 8] tile are the columns of the result, 8 n-tiles of 8. One
// ldmatrix gives the B fragments of an n-tile over 32 columns of D.
template <int D>
__device__ __forceinline__ void product_nt(float out[kBlock / 8][4],
                                           const uint32_t a[D / 16][4],
                                           const bf16* tile, int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int n = 0; n < kBlock / 8; ++n) {
    out[n][0] = out[n][1] = out[n][2] = out[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (n * 8 + (lane & 7)) * ST + kk * 16 + (lane >> 3) * 8);
      mma_bf16_16816(out[n], a[kk], b);
      mma_bf16_16816(out[n], a[kk + 1], b + 2);
    }
  }
}

// out (16 x D) += X (16 x 64, accumulators rounded to bf16) . M (64 x D),
// M the row-major [64][D + 8] tile: ldmatrix.trans gives the B fragments of
// two 8-column n-tiles at once.
template <int D>
__device__ __forceinline__ void product_acc(float out[D / 8][4],
                                            const float x[kBlock / 8][4],
                                            const bf16* tile, int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int j = 0; j < kBlock / 16; ++j) {
    uint32_t a[4];
    acc_to_a(a, x[2 * j], x[2 * j + 1]);
    const bf16* rows = tile + (j * 16 + (lane & 15)) * ST + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rows + dn * 8);
      mma_bf16_16816(out[dn], a, b);
      mma_bf16_16816(out[dn + 1], a, b + 2);
    }
  }
}

// The warp's rows `row0 + g` and `row0 + g + 8` of a [rows, D] bf16 output.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[D / 8][4],
                                           int row0, int rows, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= rows) continue;
    bf16* out = dst + (size_t)row * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + 2 * t) =
          pack_bf16x2(acc[dn][2 * i], acc[dn][2 * i + 1]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Two stages of K and V tiles [64][D + 8] (Q and dO before the key loop).
  return sizeof(bf16) * (size_t)(4 * kBlock * (D + 8));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Two stages of Q and dO tiles [64][D + 8] (K and V before the query
  // loop), and of lse and delta of the tile's 64 queries.
  return sizeof(bf16) * (size_t)(4 * kBlock * (D + 8)) + sizeof(float) * 4 * kBlock;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Skv, float scale,
                    int causal, int shift) {
  constexpr int TILE = kBlock * (D + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Stage s: K tile at sKV + 2 s TILE, V tile right after it.
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);

  // Under the causal mask the last query tiles have the most keys: they are
  // dispatched first, so that the short ones fill the tail.
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlock;
  const size_t bh = blockIdx.x;
  const size_t qoff = bh * Sq * D, koff = bh * Skv * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  // The exps run in base 2: P = 2^(S * scale * log2(e) - lse * log2(e)).
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);

  const int n_kb = (Skv + kBlock - 1) / kBlock;
  int kb_end = n_kb;
  if (causal && q0 >= shift) {  // no fully masked row here: stop at the diagonal
    const int last_key = min(q0 + kBlock, Sq) - 1 - shift;
    kb_end = min(n_kb, last_key / kBlock + 1);
  }

  // Q and dO into stage 1, the first K and V tiles into stage 0.
  stage_tile<D>(sKV + 2 * TILE, q + qoff, q0, Sq, tid);
  stage_tile<D>(sKV + 3 * TILE, dout + qoff, q0, Sq, tid);
  cp_async_commit();
  stage_tile<D>(sKV, k + koff, 0, Skv, tid);
  stage_tile<D>(sKV + TILE, v + koff, 0, Skv, tid);
  cp_async_commit();

  int rows[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = q0 + wr + g + 8 * i;
    const bool in = rows[i] < Sq;
    row_lse[i] = in ? to_log2(lse[bh * Sq + rows[i]]) : 0.f;
    row_delta[i] = in ? delta[bh * Sq + rows[i]] : 0.f;
  }

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, sKV + 2 * TILE, wr, lane);
  load_a<D>(df, sKV + 3 * TILE, wr, lane);
  __syncthreads();  // stage 1 is free for the next K and V tiles

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    if (kb + 1 < kb_end) {
      bf16* next = sKV + 2 * ((kb + 1) & 1) * TILE;
      stage_tile<D>(next, k + koff, k0 + kBlock, Skv, tid);
      stage_tile<D>(next + TILE, v + koff, k0 + kBlock, Skv, tid);
    }
    cp_async_commit();  // possibly empty, so that the wait below is uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + 2 * (kb & 1) * TILE;
    const bf16* sV = sK + TILE;

    float s[kBlock / 8][4], dp[kBlock / 8][4];
    product_nt<D>(s, qf, sK, lane);
    product_nt<D>(dp, df, sV, lane);
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2;
        if (col >= Skv)
          x = -INFINITY;  // past the sequence: no key at all
        else if (causal && rows[i] < col + shift)
          x = fill_log2;
        const float p = exp2f(x - row_lse[i]);
        s[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // dS
      }
    }
    product_acc<D>(acc, s, sK, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<D>(dq + qoff, acc, q0 + wr, Sq, g, t);
}

// The first query tile at or after `qb` that a K3 block of keys from `k0`
// must visit: under the causal mask a tile wholly above the diagonal adds
// nothing, unless it holds a row that sees no key (q < shift), whose P is 1
// for every key. The same for every thread of the block.
__device__ __forceinline__ int next_query_tile(int qb, int n_qb, int k0, int causal,
                                               int shift) {
  for (; qb < n_qb; ++qb) {
    const int q0 = qb * kBlock;
    if (!(causal && q0 + kBlock - 1 < k0 + shift && q0 >= shift)) break;
  }
  return qb;
}

template <int D>
__device__ __forceinline__ void stage_query_tile(bf16* sQD, float* sLD, const bf16* q,
                                                 const bf16* dout, const float* lse,
                                                 const float* delta, int q0, int Sq,
                                                 int tid) {
  constexpr int TILE = kBlock * (D + 8);
  stage_tile<D>(sQD, q, q0, Sq, tid);
  stage_tile<D>(sQD + TILE, dout, q0, Sq, tid);
  if (tid < kBlock) {
    const bool in = q0 + tid < Sq;
    const int r = in ? q0 + tid : 0;
    cp_async_4(sLD + tid, lse + r, in);
    cp_async_4(sLD + kBlock + tid, delta + r, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    flash_dkv_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ q, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                     float scale, int causal, int shift) {
  constexpr int TILE = kBlock * (D + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Stage s: Q tile at sQD + 2 s TILE, dO right after it; lse of its 64
  // queries at sLD + 2 s 64, delta right after.
  bf16* sQD = reinterpret_cast<bf16*>(smem_raw);
  float* sLD = reinterpret_cast<float*>(sQD + 4 * TILE);

  // Under the causal mask the first key tiles see the most queries: with the
  // key tile in blockIdx.y they are dispatched first.
  const int k0 = blockIdx.y * kBlock;
  const size_t bh = blockIdx.x;
  const size_t qoff = bh * Sq * D, koff = bh * Skv * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  const bf16* qs = q + qoff;
  const bf16* dos = dout + qoff;
  const float* lses = lse + bh * Sq;
  const float* deltas = delta + bh * Sq;

  const int n_qb = (Sq + kBlock - 1) / kBlock;
  int qb = next_query_tile(0, n_qb, k0, causal, shift);

  // K and V into stage 1, the first query tile into stage 0.
  stage_tile<D>(sQD + 2 * TILE, k + koff, k0, Skv, tid);
  stage_tile<D>(sQD + 3 * TILE, v + koff, k0, Skv, tid);
  cp_async_commit();
  if (qb < n_qb)
    stage_query_tile<D>(sQD, sLD, qs, dos, lses, deltas, qb * kBlock, Sq, tid);
  cp_async_commit();

  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, sQD + 2 * TILE, wr, lane);
  load_a<D>(vf, sQD + 3 * TILE, wr, lane);
  __syncthreads();  // stage 1 is free for the next query tile
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int stage = 0; qb < n_qb; stage ^= 1) {
    const int q0 = qb * kBlock;
    const int next = next_query_tile(qb + 1, n_qb, k0, causal, shift);
    if (next < n_qb)
      stage_query_tile<D>(sQD + 2 * (stage ^ 1) * TILE, sLD + 2 * (stage ^ 1) * kBlock, qs,
                          dos, lses, deltas, next * kBlock, Sq, tid);
    cp_async_commit();  // possibly empty, so that the wait below is uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sQ = sQD + 2 * stage * TILE;
    const bf16* sD = sQ + TILE;
    const float* sL = sLD + 2 * stage * kBlock;
    const float* sDl = sL + kBlock;

    float pt[kBlock / 8][4], dst[kBlock / 8][4];
    product_nt<D>(pt, kf, sQ, lane);   // S^T
    product_nt<D>(dst, vf, sD, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (q0 + c < Sq) {
          float x = pt[n][e] * scale_log2;
          if (causal && q0 + c < keys[e >> 1] + shift) x = fill_log2;
          p = exp2f(x - to_log2(sL[c]));
          ds = p * (dst[n][e] - sDl[c]) * scale;
        }
        pt[n][e] = p;
        dst[n][e] = ds;
      }
    }
    product_acc<D>(dv_acc, pt, sD, lane);
    product_acc<D>(dk_acc, dst, sQ, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
    qb = next;
  }
  store_rows<D>(dk + koff, dk_acc, k0 + wr, Skv, g, t);
  store_rows<D>(dv + koff, dv_acc, k0 + wr, Skv, g, t);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq, int skv,
              int causal, int shift, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  const dim3 grid(bh, (sq + kBlock - 1) / kBlock);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sq, skv, scale, causal, shift);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* k, const void* v, const void* q, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int skv, int causal, int shift, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  const dim3 grid(bh, (skv + kBlock - 1) / kBlock);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv, scale, causal, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: [bh, sq, d]; k, v: [bh, skv, d]; contiguous bf16, 16-byte
// aligned. lse, delta: [bh, sq] f32. Returns the cudaError_t of the launch.
extern "C" int flash_attention_dq_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, int bh, int sq,
                                       int skv, int d, int causal, int causal_shift,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, sq, skv, causal,
                           causal_shift, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, sq, skv, causal,
                           causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// k, v, dk, dv: [bh, skv, d]; q, dout: [bh, sq, d]; the rest as above.
extern "C" int flash_attention_dkv_bf16(const void* k, const void* v, const void* q,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, int bh,
                                        int sq, int skv, int d, int causal,
                                        int causal_shift, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_dkv<32>(k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, causal,
                            causal_shift, scale, st);
    case 64:
      return launch_dkv<64>(k, v, q, dout, lse, delta, dk, dv, bh, sq, skv, causal,
                            causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
