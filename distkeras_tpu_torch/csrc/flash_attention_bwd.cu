// Flash attention backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// bf16 in, bf16 out, f32 statistics. Both are persistent TMA + mbarrier +
// wgmma kernels built on hopper_sm90.cuh.
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
// card's ~295 flops/byte balance point, so both are memory bound (K2 moves
// 31.9 MB a call at both main-path shapes: 9.5 us at 3.35 TB/s). The design
// therefore reads every input once per tile that needs it and never writes
// the S x S probability or score matrices: they live in registers; and it
// keeps the copies and the output stores off the consumers' path.
//
// - K2 (dQ): persistent blocks of one consumer warpgroup (4 warps, 64
//   query rows, the m64 of wgmma) and one producer warp; three blocks an SM
//   walk the work items (64-query tile, bh), query tiles outermost, ordered
//   by the number of key tiles they visit (longest first) and dealt in
//   snake order (snake_item). The producer's lane 0 loads an item's Q and
//   dO into one of two slots (the next item's while this one runs) and K
//   and V tiles of 64 keys into a ring of two stages, with TMA (3-D maps
//   over [BH, S, D]: q, dO and dq over Sq, k and v over Skv, so rows past
//   the end arrive as zeros and never from the next slice; 128-byte swizzle
//   for D = 64, 64-byte for D = 32) and `full`/`empty` mbarriers. Each
//   consumer thread reads the lse and delta of its two rows once per item,
//   straight into registers. S = Q K^T and dP = dO V^T are two wgmma chains
//   with both operands K-major in shared memory; P is formed while dP runs.
//   dQ += dS K takes A = dS from the accumulator registers rounded to bf16,
//   and B = the same K tile MN-major through the transpose bit: K serves
//   two descriptors and is never transposed by threads. dQ goes out through
//   the item's Q slot with one TMA store once its last product has
//   completed. Causal items stop at the diagonal, except the one holding a
//   fully masked row (q < shift), which visits every key tile; only the
//   diagonal and ragged tiles pay for per-element masks. A consumer thread
//   holds three 64 x 64 f32 tiles (S, dP, dQ) and dS's fragments in 128
//   registers, under the 136 that three blocks an SM allow: nothing spills.
//   Why three blocks of one warpgroup: each tile is a chain (S, the exps,
//   dS, dQ) that leaves the tensor cores idle between its products, and
//   the other warpgroups fill the gaps. Two warpgroups of a 128-row item
//   sharing each K/V tile (half the K/V reads from L2, one block an SM), and
//   two blocks an SM, both ran slower (NVIDIA H100 80GB HBM3, 700 W): the
//   reads are not what holds it.
// - K3 (dK, dV), TMA and wgmma: a persistent block on each SM walks work
//   items (128-key tile, bh), key tiles outermost, with two consumer
//   warpgroups of 64 keys each (the m64 of wgmma) and one producer
//   warpgroup, in the key-row frame:
//     S^T = K Q^T, P^T = exp(S^T * scale - lse[col]), dP^T = V dO^T,
//     dS^T = P^T * (dP^T - delta[col]) * scale, dV += P^T dO, dK += dS^T Q.
//   One producer thread loads an item's K and V into one of two slots (the
//   next item's while this one computes and stores), then Q, dO, lse and
//   delta of each 64-query tile into a ring of four stages with TMA
//   (3-D maps as in K2; 1-D maps over lse and delta), with `full` and
//   `empty` mbarriers per stage. Both warpgroups read the same staged query
//   tile, so Q and dO are read once per 128 keys. S^T and dP^T are wgmma
//   chains with both operands K-major in shared memory (A = K or V, B = Q or
//   dO); dV and dK take A = P^T and dS^T from the accumulator registers
//   rounded to bf16, and B = dO and Q row-major through the transpose bit.
//   K and V never enter registers. dV's product runs while dS^T is formed.
//   dK and dV go out through the item's K/V slot with one TMA store each. A
//   consumer thread holds four 64 x 64 f32 tiles (dK, dV, S^T, dP^T: 4 x 32
//   registers); setmaxnreg gives the consumers 240 registers and the
//   producer 24 (the block's 384 x 168 at launch), so nothing spills.
//   Causal items skip query tiles wholly above the diagonal, but always
//   visit the tile that holds a fully masked row; items are dealt in snake
//   order (snake_item), the longest first. Why persistent: at bert_base
//   shape (BH = 384, S = 128) there are 384 items of two query tiles each,
//   and a 384-thread block at 168 registers fits once on an SM; one block
//   per item (2.9 waves on 132 SMs) left each block's K/V load and output
//   store exposed and ran slower than the mma.sync design it replaces (37
//   against 35 us, NVIDIA H100 80GB HBM3, 700 W). The two K/V slots
//   overlap them with the previous item's work.
// - The exps run in base 2 on pre-scaled scores, one ex2.approx each
//   (exp2f's full-range path took K3 to 53 us at gpt_small's shape,
//   ex2.approx to 32).
// P^T is rounded to bf16 for the P^T.dO product (the reference keeps it in
// f32 there); dS is rounded to bf16 on both sides. Each K2 and K3 item owns
// its output tile: no atomics, and the result does not depend on the launch
// order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;  // rows of a staged query (K2: and key) tile
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// x * log2(e), never fused into a neighbouring add: the mask fill and the
// lse of a fully masked row (both -1e30) must convert to the same value, so
// that their difference is exactly 0 and that row's P exactly 1.
__device__ __forceinline__ float to_log2(float x) { return __fmul_rn(x, kLog2e); }

// K2: one consumer warpgroup and one producer warp a block, three blocks an
// SM (the `(160, 3)` bound caps a thread at 136 registers), and a ring of
// two K/V stages.
constexpr int kDqStages = 2;
constexpr int kDqConsumers = 128;
constexpr int kDqThreads = kDqConsumers + 32;
constexpr int kDqBlocksPerSM = 3;

// K2's work item w: the (bh) slice, the first row of its query tile and the
// number of 64-key tiles it visits. Query tiles are outermost, ordered by
// that number, longest first: under the causal mask the last tiles see the
// most keys and stop at the diagonal, except that under shift 1 the first
// tile, whose row 0 sees no key and so weighs every key, visits them all.
struct DqItem {
  int bh, q0, kb_end;
};

__device__ __forceinline__ DqItem dq_item(int w, int bh_count, int Sq, int Skv, int causal,
                                          int shift) {
  const int n_qb = (Sq + kBlock - 1) / kBlock;
  const int n_kb = (Skv + kBlock - 1) / kBlock;
  const int qi = w / bh_count;
  int qb = qi;
  if (causal) qb = shift ? (qi == 0 ? 0 : n_qb - qi) : n_qb - 1 - qi;
  DqItem item;
  item.bh = w % bh_count;
  item.q0 = qb * kBlock;
  item.kb_end = n_kb;
  if (causal && item.q0 >= shift)
    item.kb_end = min(n_kb, (min(item.q0 + kBlock, Sq) - 1 - shift) / kBlock + 1);
  return item;
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, kDqBlocksPerSM)
    flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    int bh_count, int Sq, int Skv, float scale, int causal, int shift) {
  constexpr int TILE = kBlock * D;  // elements of one tile
  constexpr uint32_t TILE_BYTES = TILE * sizeof(bf16);
  constexpr uint32_t ROW = D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kDqStages + 4];
  bf16* sQD = reinterpret_cast<bf16*>(align_1024(smem_raw));  // slot j: Q, then dO
  bf16* sKV = sQD + 4 * TILE;  // stage s: K at sKV + 2 s TILE, V right after
  uint64_t* full = bars;
  uint64_t* empty = bars + kDqStages;
  uint64_t* q_full = bars + 2 * kDqStages;  // two (Q, dO) slots
  uint64_t* q_empty = q_full + 2;
  const int n_items = bh_count * ((Sq + kBlock - 1) / kBlock);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDqConsumers);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(&q_full[j], 1);
      mbar_init(&q_empty[j], kDqConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block walks work items snake_item(0), (1), ...; counters `it`
  // (items, two slots) and `n` (key tiles, the K/V ring) run on across
  // items in the producer and the consumers alike.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kDqConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int n = 0, it = 0;
      for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
        const DqItem item = dq_item(w, bh_count, Sq, Skv, causal, shift);
        const int j = it & 1;
        if (it >= 2) mbar_wait(&q_empty[j], ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[j], 2 * TILE_BYTES);
        tma_load_3d(sQD + 2 * j * TILE, &q_map, &q_full[j], 0, item.q0, item.bh);
        tma_load_3d(sQD + (2 * j + 1) * TILE, &do_map, &q_full[j], 0, item.q0, item.bh);
        for (int kb = 0; kb < item.kb_end; ++kb, ++n) {
          const int s = n % kDqStages;
          if (n >= kDqStages) mbar_wait(&empty[s], (n / kDqStages - 1) & 1);
          bf16* sK = sKV + 2 * s * TILE;
          mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
          tma_load_3d(sK, &k_map, &full[s], 0, kb * kBlock, item.bh);
          tma_load_3d(sK + TILE, &v_map, &full[s], 0, kb * kBlock, item.bh);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: this thread's rows are g and g + 8 of its
  // warp's 16, its columns 2t, 2t + 1 of each 8-column chunk. The exps run
  // in base 2: P = 2^(S * scale * log2(e) - lse * log2(e)).
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  int n = 0, it = 0;
  for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
    const DqItem item = dq_item(w, bh_count, Sq, Skv, causal, shift);
    const int rows[2] = {item.q0 + warp * 16 + g, item.q0 + warp * 16 + g + 8};
    float row_lse[2], row_delta[2];  // lse * log2(e), and delta; 0 past Sq
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = rows[i] < Sq;
      const size_t at = (size_t)item.bh * Sq + rows[i];
      row_lse[i] = in ? to_log2(lse[at]) : 0.f;
      row_delta[i] = in ? delta[at] : 0.f;
    }
    float acc[D / 2];  // dQ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const int j = it & 1;
    bf16* tQ = sQD + 2 * j * TILE;
    mbar_wait(&q_full[j], (it >> 1) & 1);
    const uint64_t desc_q = make_desc(tQ, ROW);
    const uint64_t desc_do = make_desc(tQ + TILE, ROW);

    for (int kb = 0; kb < item.kb_end; ++kb, ++n) {
      const int s = n % kDqStages;
      const int k0 = kb * kBlock;
      mbar_wait(&full[s], (n / kDqStages) & 1);
      const bf16* sK = sKV + 2 * s * TILE;
      const uint64_t desc_k = make_desc(sK, ROW);
      const uint64_t desc_v = make_desc(sK + TILE, ROW);

      float sc[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 x 64
      wgmma_fence();
      wgmma_ss_n64<0>(sc, desc_q, desc_k);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<1>(sc, desc_add(desc_q, 32 * kk), desc_add(desc_k, 32 * kk));
      wgmma_commit();
      wgmma_ss_n64<0>(dp, desc_do, desc_v);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<1>(dp, desc_add(desc_do, 32 * kk), desc_add(desc_v, 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();  // S is ready; dP may still run
      fence_regs(sc);
      // P. Only a tile that holds keys past Skv, or (causal) keys past some
      // row's diagonal, is masked element by element.
      if (k0 + kBlock > Skv || (causal && item.q0 < k0 + kBlock - 1 + shift)) {
#pragma unroll
        for (int c8 = 0; c8 < kBlock / 8; ++c8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * c8 + 2 * t + (e & 1);
            float x = sc[4 * c8 + e] * scale_log2;
            if (col >= Skv)
              x = -INFINITY;  // past the sequence: no key at all
            else if (causal && rows[e >> 1] < col + shift)
              x = fill_log2;
            sc[4 * c8 + e] = exp2_approx(x - row_lse[e >> 1]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 32; ++r)
          sc[r] = exp2_approx(sc[r] * scale_log2 - row_lse[(r >> 1) & 1]);
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int r = 0; r < 32; ++r)  // dS
        sc[r] = sc[r] * (dp[r] - row_delta[(r >> 1) & 1]) * scale;
      uint32_t df[kBlock / 16][4];  // dS in bf16: the A fragments of dS K
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) acc_to_frag(df[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        wgmma_rs(acc, df[kk], desc_add(desc_k, 16 * ROW * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(df);
      mbar_arrive(&empty[s]);
    }

    // dQ through the Q slot (its last product has completed) and one TMA
    // store: coalesced, and off the consumers' path.
    store_acc_tile(reinterpret_cast<unsigned char*>(tQ), acc, warp, lane);
    fence_async_smem();
    named_barrier(1, kDqConsumers);
    if (threadIdx.x == 0) {
      tma_store_3d(&dq_map, tQ, 0, item.q0, item.bh);
      tma_store_wait<true>();  // the slot may be refilled once the store has read it
    }
    mbar_arrive(&q_empty[j]);
  }
  if (threadIdx.x == 0) tma_store_wait<false>();
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

// K3: the block's keys and query tiles, and its shared memory.
constexpr int kDkvKeys = 128;  // keys per work item: two consumer warpgroups of 64
constexpr int kDkvStages = 4;  // ring of query tiles (Q, dO, lse, delta)
constexpr int kDkvConsumers = 256;
constexpr int kDkvThreads = kDkvConsumers + 128;  // and one producer warpgroup
// setmaxnreg moves registers between the warpgroups of a block, within what
// the block was launched with: 384 threads at 168 registers (ptxas's count
// at entry) = 64,512 = 128 x 24 (producer) + 256 x 240 (consumers).
constexpr uint32_t kProducerRegs = 24;
constexpr uint32_t kConsumerRegs = 240;
// lse and delta of a query tile: a TMA box of 68 f32 from a 16-byte aligned
// start (up to 3 values before the tile, 64 of it, the rest after), each in
// a 128-byte aligned slot of 96.
constexpr int kStatBox = kBlock + 4;
constexpr int kStatSlot = 96;

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Two slots of K and V [128][D], kDkvStages x (Q, dO [64][D]), then
  // kDkvStages x (lse, delta slots), and 1024 bytes to align the first tile.
  return sizeof(bf16) * (size_t)(4 * kDkvKeys + 2 * kDkvStages * kBlock) * D +
         sizeof(float) * 2 * kDkvStages * kStatSlot + 1024;
}

// The key tile and (bh) slice of work item w: key tiles outermost, so that
// under the causal mask the longest items (the first key tiles, which see
// the most queries) come first.
__device__ __forceinline__ void dkv_item(int w, int bh_count, int& k0, int& bh) {
  k0 = (w / bh_count) * kDkvKeys;
  bh = w % bh_count;
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap lse_map,
                     const __grid_constant__ CUtensorMap delta_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map, int bh_count, int Sq, int Skv,
                     float scale, int causal, int shift) {
  constexpr int QT = kBlock * D;     // elements of a query tile
  constexpr int KT = kDkvKeys * D;   // elements of a K (or V) tile
  constexpr uint32_t ROW = D * sizeof(bf16);
  constexpr uint32_t STAGE_BYTES = 2 * QT * sizeof(bf16) + 2 * kStatBox * sizeof(float);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kDkvStages + 4];
  bf16* sKV = reinterpret_cast<bf16*>(align_1024(smem_raw));  // slot j: K, then V
  bf16* sQD = sKV + 4 * KT;  // stage s: Q at sQD + 2 s QT, dO right after
  float* sLD = reinterpret_cast<float*>(sQD + 2 * kDkvStages * QT);  // lse, delta slots
  uint64_t* full = bars;
  uint64_t* empty = bars + kDkvStages;
  uint64_t* kv_full = bars + 2 * kDkvStages;   // two K/V slots
  uint64_t* kv_empty = kv_full + 2;

  const int n_qb = (Sq + kBlock - 1) / kBlock;
  const int n_items = bh_count * ((Skv + kDkvKeys - 1) / kDkvKeys);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDkvConsumers);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(&kv_full[j], 1);
      mbar_init(&kv_empty[j], kDkvConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The block walks work items snake_item(0), (1), ...; counters `it`
  // (items, two K/V slots) and `i` (query tiles, the stage ring) run on
  // across items in the producer and the consumers alike.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kDkvConsumers / 32) {  // the producer warpgroup: one thread issues
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kDkvConsumers / 32 && lane == 0) {
      int i = 0, it = 0;
      for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
        int k0, bh;
        dkv_item(w, bh_count, k0, bh);
        const int j = it & 1;
        if (it >= 2) mbar_wait(&kv_empty[j], ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[j], 2 * KT * sizeof(bf16));
        tma_load_3d(sKV + 2 * j * KT, &k_map, &kv_full[j], 0, k0, bh);
        tma_load_3d(sKV + (2 * j + 1) * KT, &v_map, &kv_full[j], 0, k0, bh);
        for (int qb = next_query_tile(0, n_qb, k0, causal, shift); qb < n_qb;
             qb = next_query_tile(qb + 1, n_qb, k0, causal, shift), ++i) {
          const int s = i % kDkvStages;
          if (i >= kDkvStages) mbar_wait(&empty[s], (i / kDkvStages - 1) & 1);
          bf16* sQ = sQD + 2 * s * QT;
          float* sL = sLD + 2 * s * kStatSlot;
          const int first = bh * Sq + qb * kBlock;  // of the tile's lse and delta
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          tma_load_3d(sQ, &q_map, &full[s], 0, qb * kBlock, bh);
          tma_load_3d(sQ + QT, &do_map, &full[s], 0, qb * kBlock, bh);
          // lse and delta are [BH * Sq] vectors. Boxes starting off a
          // 16-byte boundary faulted on the H100 (at Sq = 1), so the box of
          // 68 values starts at `first` rounded down to a multiple of 4; the
          // consumers skip the `first % 4` before it.
          // Its values may run into the next slice (or past the end, as
          // zeros): those columns are masked as queries past Sq.
          tma_load_1d(sL, &lse_map, &full[s], first & ~3);
          tma_load_1d(sL + kStatSlot, &delta_map, &full[s], first & ~3);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // Consumer warpgroup wg owns keys k0 + 64 wg .. + 63 of each item, in the
  // key-row frame: S^T = K Q^T, P^T = exp(S^T * scale - lse[col]),
  // dP^T = V dO^T, dS^T = P^T * (dP^T - delta[col]) * scale, dV += P^T dO,
  // dK += dS^T Q.
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  int i = 0, it = 0;
  for (int w = snake_item(0); w < n_items; w = snake_item(++it)) {
    int k0, bh;
    dkv_item(w, bh_count, k0, bh);
    const int key0 = k0 + 64 * wg + 16 * (warp % 4) + g;
    const int keys[2] = {key0, key0 + 8};
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;

    const int j = it & 1;
    mbar_wait(&kv_full[j], (it >> 1) & 1);
    const uint64_t desc_k = make_desc(sKV + 2 * j * KT + 64 * wg * D, ROW);
    const uint64_t desc_v = make_desc(sKV + (2 * j + 1) * KT + 64 * wg * D, ROW);

    for (int qb = next_query_tile(0, n_qb, k0, causal, shift); qb < n_qb;
         qb = next_query_tile(qb + 1, n_qb, k0, causal, shift), ++i) {
      const int s = i % kDkvStages;
      const int q0 = qb * kBlock;
      mbar_wait(&full[s], (i / kDkvStages) & 1);
      const bf16* sQ = sQD + 2 * s * QT;
      const int skip = (bh * Sq + q0) & 3;  // see the producer
      const float* sL = sLD + 2 * s * kStatSlot + skip;
      const float* sDl = sL + kStatSlot;
      const uint64_t desc_q = make_desc(sQ, ROW);
      const uint64_t desc_do = make_desc(sQ + QT, ROW);

      float pt[32], dst[32];  // S^T and dP^T, 64 keys x 64 queries
      wgmma_fence();
      wgmma_ss_n64<0>(pt, desc_k, desc_q);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<1>(pt, desc_add(desc_k, 32 * kk), desc_add(desc_q, 32 * kk));
      wgmma_commit();
      wgmma_ss_n64<0>(dst, desc_v, desc_do);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss_n64<1>(dst, desc_add(desc_v, 32 * kk), desc_add(desc_do, 32 * kk));
      wgmma_commit();

      // This thread's 16 query columns: 8 jj + 2 t + h.
      float col_stat[16];  // lse * log2(e), then delta
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) col_stat[2 * jj + h] = to_log2(sL[8 * jj + 2 * t + h]);
      wgmma_wait<1>();  // S^T is ready; dP^T may still run
      fence_regs(pt);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jj + 2 * t + (e & 1);
          float x = pt[4 * jj + e] * scale_log2;
          if (causal && q0 + c < keys[e >> 1] + shift) x = fill_log2;
          pt[4 * jj + e] =
              q0 + c < Sq ? exp2_approx(x - col_stat[2 * jj + (e & 1)]) : 0.f;
        }
      }
      uint32_t pf[4][4];  // P^T in bf16: the A fragments of P^T dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_frag(pf[kk], pt, kk);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) col_stat[2 * jj + h] = sDl[8 * jj + 2 * t + h];
      wgmma_wait<0>();
      fence_regs(dst);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv_acc, pf[kk], desc_add(desc_do, 16 * ROW * kk));
      wgmma_commit();  // dV runs while dS^T is formed

#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[4 * jj + e] =
              pt[4 * jj + e] * (dst[4 * jj + e] - col_stat[2 * jj + (e & 1)]) * scale;
      uint32_t df[4][4];  // dS^T in bf16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_frag(df[kk], dst, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk_acc, df[kk], desc_add(desc_q, 16 * ROW * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pf);
      fence_regs(df);
      mbar_arrive(&empty[s]);
    }
    // dK and dV through this warpgroup's half of the K/V slot (its products
    // have completed) and one TMA store each: coalesced, off the path.
    unsigned char* tK = reinterpret_cast<unsigned char*>(sKV + 2 * j * KT + 64 * wg * D);
    store_acc_tile(tK, dk_acc, warp % 4, lane);
    store_acc_tile(tK + KT * sizeof(bf16), dv_acc, warp % 4, lane);
    fence_async_smem();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_3d(&dk_map, tK, 0, k0 + 64 * wg, bh);
      tma_store_3d(&dv_map, tK + KT * sizeof(bf16), 0, k0 + 64 * wg, bh);
      tma_store_wait<true>();  // the slot may be refilled once the stores have read it
    }
    mbar_arrive(&kv_empty[j]);
  }
  if (threadIdx.x % 128 == 0) tma_store_wait<false>();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq, int skv,
              int causal, int shift, float scale, cudaStream_t stream) {
  CUtensorMap maps[5];
  const void* src[5] = {q, dout, k, v, dq};
  const int rows[5] = {sq, sq, skv, skv, sq};
  for (int i = 0; i < 5; ++i)
    if (const int err = encode_rows_bf16(&maps[i], src[i], bh, rows[i], D, kBlock)) return err;
  // Two (Q, dO) slots and kDqStages (K, V) stages of 64 x D bf16 tiles, and
  // 1024 bytes to align the first.
  constexpr size_t smem = sizeof(bf16) * (size_t)(4 + 2 * kDqStages) * kBlock * D + 1024;
  if (const int err = allow_smem(flash_dq_kernel<D>, smem)) return err;
  const int items = bh * ((sq + kBlock - 1) / kBlock);
  const int resident = kDqBlocksPerSM * sm_count();  // persistent blocks
  flash_dq_kernel<D><<<items < resident ? items : resident, kDqThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<const float*>(delta), bh, sq, skv, scale, causal, shift);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* k, const void* v, const void* q, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int skv, int causal, int shift, float scale,
               cudaStream_t stream) {
  CUtensorMap maps[8];
  int err = encode_rows_bf16(&maps[0], k, bh, skv, D, kDkvKeys);
  if (!err) err = encode_rows_bf16(&maps[1], v, bh, skv, D, kDkvKeys);
  if (!err) err = encode_rows_bf16(&maps[2], q, bh, sq, D, kBlock);
  if (!err) err = encode_rows_bf16(&maps[3], dout, bh, sq, D, kBlock);
  if (!err) err = encode_vec_f32(&maps[4], lse, (long long)bh * sq, kStatBox);
  if (!err) err = encode_vec_f32(&maps[5], delta, (long long)bh * sq, kStatBox);
  if (!err) err = encode_rows_bf16(&maps[6], dk, bh, skv, D, 64);
  if (!err) err = encode_rows_bf16(&maps[7], dv, bh, skv, D, 64);
  if (err) return err;
  constexpr size_t smem = dkv_smem_bytes<D>();
  if (const int e = allow_smem(flash_dkv_kernel<D>, smem)) return e;
  const int items = bh * ((skv + kDkvKeys - 1) / kDkvKeys);
  const int grid = items < sm_count() ? items : sm_count();  // persistent: one block an SM
  flash_dkv_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], bh, sq, skv,
      scale, causal, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: [bh, sq, d]; k, v: [bh, skv, d]; contiguous bf16, 16-byte
// aligned. lse, delta: [bh, sq] f32. Returns the cudaError_t of the launch
// (0 on success), or hopper::kTensorMapError (+ the CUresult) if a tensor
// map cannot be made.
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
