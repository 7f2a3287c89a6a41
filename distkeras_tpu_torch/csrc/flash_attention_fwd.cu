// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 lse:
// TMA tile loads into a ring of stages, wgmma for both products.
//
// Replaces: distkeras_tpu/ops/pallas/flash_attention.py `_flash_forward`
// (kernel `_fwd_kernel`), the Pallas TPU kernel. Same function:
//   O   = softmax(Q K^T * D^-1/2 [masked]) V        per (bh) slice, [S, D]
//   lse = m + log(l)                                 f32, one per query row
// with the causal mask `row >= col + causal_shift` filled with -1e30 (not
// -inf), so a query row that sees no key at all averages every V row and
// gets lse = -1e30, exactly as the reference's online softmax does. Keys
// past a ragged S get -inf. P is rounded to bf16 before P.V.
//
// What bounds it on the H100: per (bh) slice the work is 4*S*S*D flops
// against 4 tensors of S*D bf16 (8*S*D bytes), so S/2 flops per byte: 64 at
// S = 128 (bert_base_mlm), 256 at S = 512 (gpt_small, half of it masked),
// both below the card's ~295 flops/byte balance point: memory bound. Both
// main-path shapes move 25 MB a call (q, k, v, o and lse): 7.6 us at
// 3.35 TB/s. So Q, K and V are read once per query tile, the S x S scores
// never leave registers, and the copies must overlap the products.
//
// Design: persistent blocks of one consumer warpgroup (4 warps, 64 query
// rows, the m64 of wgmma) and one producer warp; three blocks an SM walk
// the work items (query tile, bh), query tiles outermost, dealt to the
// blocks in snake order (snake_item) so that long causal items even out.
// - The producer's lane 0 loads each item's Q into one of two slots (the
//   next item's while this one runs) and K and V tiles of 64 keys into a
//   ring of three stages with TMA (3-D maps over [BH, S, D], so rows past S
//   arrive as zeros and never from the next slice; 128-byte swizzle for
//   D = 64, 64-byte for D = 32). A stage's `full` mbarrier completes with
//   the copy's bytes; its `empty` mbarrier completes when the consumers are
//   done with it, and only then is it refilled. The next tiles' copies thus
//   run under this tile's products, and the next item's under this one's
//   output store. O goes out through the item's Q slot (once its last
//   product has completed) with one TMA store: coalesced, and off the
//   consumers' path (per-thread 4-byte stores and a division per element
//   cost about 1.8 us an item on the H100).
// - S = Q K^T is one wgmma chain (A = Q, B = K, both K-major in shared
//   memory). The scores are masked and exponentiated in registers, in base
//   2 on pre-scaled scores, one ex2.approx each (exp2f's full-range path
//   cost more than the products). O += P V takes A = P from the score
//   registers rounded to bf16, and B = V as it lies, row-major [key][d],
//   through the transpose bit: V is never transposed by threads.
// - The mask fill converts to base 2 through one unfused multiply, so that
//   a fully masked row's max and scores are equal and its P is exactly 1;
//   such a row's lse is written as -1e30 + log(l), as the reference's.
// - Causal items skip key tiles wholly above the diagonal, except for the
//   item holding a fully masked row (q < shift), which sees every key. The
//   longest items (the last query tiles) are walked first.
// Tile and grid: at bert_base shape (BH = 384, S = 128) 64-row tiles give
// 768 items of two key tiles; at <= 136 registers and 65 KB of shared
// memory three 160-thread blocks fit an SM, 396 on 132 SMs, about two
// items each. 128-row tiles (two consumer warpgroups, 288 threads) would
// fit two an SM: 384 items on 264 blocks, half of them taking two.
// gpt_small (BH = 96, S = 512) also has 768 items of 64 rows.
//
// `hopper_selftest_bf16` checks the building blocks alone: one TMA load of
// each tile with the swizzle of its D, one wgmma chain with both operands
// K-major in shared memory, one with A in registers and B MN-major.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
using flash::group_max;
using flash::group_sum;

constexpr int kBlockM = 64;   // query rows per block: one consumer warpgroup
constexpr int kBlockN = 64;   // keys per staged tile
constexpr int kStages = 3;    // K/V ring
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMinBlocksPerSM = 3;
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// x * log2(e), never fused into a neighbouring add (see the note above).
__device__ __forceinline__ float to_log2(float x) { return __fmul_rn(x, kLog2e); }

template <int D>
constexpr size_t smem_bytes() {
  // Two Q slots, then kStages x (K, V): tiles of 64 rows x D bf16.
  return sizeof(bf16) * (size_t)(2 + 2 * kStages) * kBlockN * D + 1024;
}

// Work item w: the (bh) slice and the first row of its query tile, query
// tiles outermost and, under the causal mask, the last (longest) first;
// and the number of key tiles it visits: under the causal mask it stops at
// the diagonal, unless the tile holds a row that sees no key (q < shift).
struct FwdItem {
  int bh, q0, kb_end;
};

__device__ __forceinline__ FwdItem fwd_item(int w, int bh_count, int S, int causal,
                                            int shift) {
  const int n_qb = (S + kBlockM - 1) / kBlockM;
  const int qi = w / bh_count;
  FwdItem item;
  item.bh = w % bh_count;
  item.q0 = (causal ? n_qb - 1 - qi : qi) * kBlockM;
  item.kb_end = (S + kBlockN - 1) / kBlockN;
  if (causal && item.q0 >= shift)
    item.kb_end = (min(item.q0 + kBlockM, S) - 1 - shift) / kBlockN + 1;
  return item;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                     int bh_count, int S, float scale, int causal,
                     int shift) {
  constexpr int TILE = kBlockN * D;  // elements of one tile
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  constexpr uint32_t ROW = D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 4];
  bf16* sQ = reinterpret_cast<bf16*>(align_1024(smem_raw));  // two slots
  bf16* sKV = sQ + 2 * TILE;  // stage s: K at sKV + 2 s TILE, V right after
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* q_full = bars + 2 * kStages;  // two Q slots
  uint64_t* q_empty = q_full + 2;
  const int n_items = bh_count * ((S + kBlockM - 1) / kBlockM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(&q_full[j], 1);
      mbar_init(&q_empty[j], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block walks work items snake_item(0), (1), ...; counters `it`
  // (items, two Q slots) and `n` (key tiles, the K/V ring) run on across
  // items in the producer and the consumers alike.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int n = 0, it = 0;
      for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
        const FwdItem item = fwd_item(w, bh_count, S, causal, shift);
        const int j = it & 1;
        if (it >= 2) mbar_wait(&q_empty[j], ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[j], TILE_BYTES);
        tma_load_3d(sQ + j * TILE, &q_map, &q_full[j], 0, item.q0, item.bh);
        for (int kb = 0; kb < item.kb_end; ++kb, ++n) {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
          bf16* sK = sKV + 2 * s * TILE;
          mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
          tma_load_3d(sK, &k_map, &full[s], 0, kb * kBlockN, item.bh);
          tma_load_3d(sK + TILE, &v_map, &full[s], 0, kb * kBlockN, item.bh);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's rows are g and g + 8 of its
  // warp's 16, its columns 2t, 2t + 1 of each 8-column chunk.
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  int n = 0, it = 0;
  for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
    const FwdItem item = fwd_item(w, bh_count, S, causal, shift);
    const int rows[2] = {item.q0 + warp * 16 + g, item.q0 + warp * 16 + g + 8};
    float m_run[2] = {fill_log2, fill_log2};
    float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const int j = it & 1;
    bf16* tQ = sQ + j * TILE;
    mbar_wait(&q_full[j], (it >> 1) & 1);
    const uint64_t desc_q = make_desc(tQ, ROW);

    for (int kb = 0; kb < item.kb_end; ++kb, ++n) {
      const int s = n % kStages;
      const int k0 = kb * kBlockN;
      mbar_wait(&full[s], (n / kStages) & 1);
      const bf16* sK = sKV + 2 * s * TILE;
      const uint64_t desc_k = make_desc(sK, ROW);
      const uint64_t desc_v = make_desc(sK + TILE, ROW);

      float sc[32];  // S = Q K^T, 64 x 64
      wgmma_fence();
      wgmma_ss_n64<0>(sc, desc_q, desc_k);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<1>(sc, desc_add(desc_q, 32 * kk), desc_add(desc_k, 32 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int c8 = 0; c8 < kBlockN / 8; ++c8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * c8 + 2 * t + (e & 1);
          float x = sc[4 * c8 + e] * scale_log2;
          if (col >= S)
            x = -INFINITY;  // past the sequence: no key at all
          else if (causal && rows[e >> 1] < col + shift)
            x = fill_log2;
          sc[4 * c8 + e] = x;
          m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_new[i] = group_max(m_new[i]);
        corr[i] = exp2_approx(m_run[i] - m_new[i]);
        m_run[i] = m_new[i];
        l_run[i] *= corr[i];
      }
#pragma unroll
      for (int c8 = 0; c8 < kBlockN / 8; ++c8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(sc[4 * c8 + e] - m_new[e >> 1]);
          sc[4 * c8 + e] = p;
          l_run[e >> 1] += p;
        }
      }
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8) {
        acc[4 * c8] *= corr[0];
        acc[4 * c8 + 1] *= corr[0];
        acc[4 * c8 + 2] *= corr[1];
        acc[4 * c8 + 3] *= corr[1];
      }

      uint32_t pf[kBlockN / 16][4];  // P in bf16, the A fragments of P V
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) acc_to_frag(pf[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs(acc, pf[kk], desc_add(desc_v, 16 * ROW * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      mbar_arrive(&empty[s]);
    }

    // O = acc / l, through the Q slot (its last product has completed) and
    // one TMA store; lse directly.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = fmaxf(group_sum(l_run[i]), 1e-30f);
      const float inv = 1.f / l;
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8) {
        acc[4 * c8 + 2 * i] *= inv;
        acc[4 * c8 + 2 * i + 1] *= inv;
      }
      if (t == 0 && rows[i] < S)  // a row that saw no key has the reference's lse
        lse[(size_t)item.bh * S + rows[i]] =
            m_run[i] == fill_log2 ? kMaskFill + logf(l) : m_run[i] * kLn2 + logf(l);
    }
    store_acc_tile(reinterpret_cast<unsigned char*>(tQ), acc, warp, lane);
    fence_async_smem();
    named_barrier(1, kConsumers);
    if (threadIdx.x == 0) {
      tma_store_3d(&o_map, tQ, 0, item.q0, item.bh);
      tma_store_wait<true>();  // the slot may be refilled once the store has read it
    }
    mbar_arrive(&q_empty[j]);
  }
  if (threadIdx.x == 0) tma_store_wait<false>();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
           int causal, int shift, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (const int err = encode_rows_bf16(&maps[i], src[i], bh, s, D, kBlockN)) return err;
  constexpr size_t smem = smem_bytes<D>();
  if (const int err = allow_smem(flash_fwd_kernel<D>, smem)) return err;
  const int items = bh * ((s + kBlockM - 1) / kBlockM);
  const int resident = kMinBlocksPerSM * sm_count();  // persistent blocks
  flash_fwd_kernel<D><<<items < resident ? items : resident, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), bh, s, scale, causal,
      shift);
  return (int)cudaGetLastError();
}

// The building blocks alone, on one (64 x D) tile each of q, k and v and a
// 64 x 64 bf16 matrix p: s = q k^T (wgmma, both operands K-major in shared
// memory, k16 steps inside the swizzle atom) and o = p v (A from registers,
// B = v MN-major through the transpose bit, k16 steps of 16 rows), f32.
template <int D>
__global__ void __launch_bounds__(kConsumers)
    hopper_selftest_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const bf16* __restrict__ p, float* __restrict__ s_out,
                           float* __restrict__ o_out) {
  constexpr int TILE = kBlockN * D;
  constexpr uint32_t ROW = D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  bf16* sQ = reinterpret_cast<bf16*>(align_1024(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 3 * TILE * sizeof(bf16));
    tma_load_3d(sQ, &q_map, &bar, 0, 0, 0);
    tma_load_3d(sQ + TILE, &k_map, &bar, 0, 0, 0);
    tma_load_3d(sQ + 2 * TILE, &v_map, &bar, 0, 0, 0);
  }
  mbar_wait(&bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const uint64_t desc_q = make_desc(sQ, ROW), desc_k = make_desc(sQ + TILE, ROW);
  const uint64_t desc_v = make_desc(sQ + 2 * TILE, ROW);

  float sc[32];
  wgmma_fence();
  wgmma_ss_n64<0>(sc, desc_q, desc_k);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64<1>(sc, desc_add(desc_q, 32 * kk), desc_add(desc_k, 32 * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1)] = sc[4 * j + e];

  uint32_t pf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p0 = p + r0 * 64 + 16 * kk + 2 * t;
    pf[kk][0] = flash::ld_u32(p0);
    pf[kk][1] = flash::ld_u32(p0 + 8 * 64);
    pf[kk][2] = flash::ld_u32(p0 + 8);
    pf[kk][3] = flash::ld_u32(p0 + 8 * 64 + 8);
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pf[kk], desc_add(desc_v, 16 * ROW * kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pf);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(r0 + 8 * (e >> 1)) * D + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e];
}

template <int D>
int launch_selftest(const void* q, const void* k, const void* v, const void* p, void* s_out,
                    void* o_out, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (const int err = encode_rows_bf16(&maps[i], src[i], 1, kBlockN, D, kBlockN)) return err;
  constexpr size_t smem = sizeof(bf16) * 3 * kBlockN * D + 1024;
  hopper_selftest_kernel<D><<<1, kConsumers, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(p), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous bf16, 16-byte aligned; lse: [bh, s] f32.
// Returns the cudaError_t of the launch (0 on success), or
// hopper::kTensorMapError (+ the CUresult) if a tensor map cannot be made.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bh, int s, int d, int causal,
                                        int causal_shift, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, bh, s, causal, causal_shift, scale, st);
    case 64:
      return launch<64>(q, k, v, o, lse, bh, s, causal, causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Test entry: q, k, v [64, d] and p [64, 64] contiguous bf16 on the card,
// s_out [64, 64] and o_out [64, d] f32 (see hopper_selftest_kernel). The
// float argument is unused; it keeps the calling convention of the kernels.
extern "C" int hopper_selftest_bf16(const void* q, const void* k, const void* v, const void* p,
                                    void* s_out, void* o_out, int d, float unused,
                                    void* stream) {
  (void)unused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_selftest<32>(q, k, v, p, s_out, o_out, st);
    case 64:
      return launch_selftest<64>(q, k, v, p, s_out, o_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
