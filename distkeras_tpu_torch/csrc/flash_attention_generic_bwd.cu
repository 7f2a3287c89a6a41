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
// The staging, the two products and the output copy are the building
// blocks of flash_generic_sm90.cuh, which K1g shares.
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

#include "flash_generic_sm90.cuh"

namespace {

using namespace flash_generic;

constexpr int kStatBytes = 2 * kRows * 4;  // lse and delta of a query tile

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

// Arrives at barrier `id` of `count` threads without waiting: the
// producer's half of a hand-over whose consumers wait with named_barrier.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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
