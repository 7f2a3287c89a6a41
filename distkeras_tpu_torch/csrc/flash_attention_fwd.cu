// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 lse.
//
// Replaces: distkeras_tpu/ops/pallas/flash_attention.py `_flash_forward`
// (kernel `_fwd_kernel`), the Pallas TPU kernel. Same function:
//   O   = softmax(Q K^T * D^-1/2 [masked]) V        per (bh) slice, [S, D]
//   lse = m + log(l)                                 f32, one per query row
// with the causal mask `row >= col + causal_shift` filled with -1e30 (not
// -inf), so a query row that sees no key at all averages every V row and
// gets lse = -1e30, exactly as the reference's online softmax does.
//
// What bounds it on the H100: per (bh) slice the work is 4*S*S*D flops
// against 4 tensors of S*D bf16 (8*S*D bytes), so S/2 flops per byte: 64 at
// S = 128 (bert_base_mlm), 256 at S = 512 (gpt_small, half of it masked),
// both below the card's ~295 flops/byte balance point: memory bound. So the
// design reads Q, K and V once from device memory per query tile and never
// writes the S x S score matrix: scores, the running max m, the denominator
// l and the O accumulator all live in registers.
//
// Design: one thread block of 4 warps per (query tile of 64 rows, bh). Each
// warp owns 16 query rows; its Q fragments stay in registers for the whole
// key loop. K and V tiles of 64 keys are staged in shared memory (V stored
// transposed so that its mma B-fragments are 32-bit loads), and both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 inputs, f32
// accumulators). P is rounded to bf16 before the P.V product, as the Pallas
// kernel does. Causal tiles skip key tiles that lie wholly above the
// diagonal, except for a tile that holds a fully masked row (q < shift),
// which must see every key to match the reference. No TMA, no wgmma, no
// cp.async pipelining yet: this version is the simple correct one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;   // query rows per block (4 warps x 16)
constexpr int kBlockK = 64;   // keys per staged tile
constexpr int kThreads = 128;
constexpr float kMaskFill = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles [64][D + 8], V^T tile [D][64 + 8]; the +8 pad spreads the
  // fragment loads of one warp over all 32 banks.
  return sizeof(__nv_bfloat16) *
         (size_t)(kBlockQ * (D + 8) + kBlockK * (D + 8) + D * (kBlockK + 8));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, float scale, int causal, int shift) {
  constexpr int ST = D + 8;        // row stride of sQ and sK
  constexpr int VST = kBlockK + 8;  // row stride of sVt
  constexpr int CHUNKS = D / 8;     // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockQ * ST;
  __nv_bfloat16* sVt = sK + kBlockK * ST;

  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group row, thread in group
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < kBlockQ * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 val = zero;
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + col);
    *reinterpret_cast<uint4*>(sQ + r * ST + col) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = sQ + (wr + g) * ST + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * ST;
    qf[kk][0] = ld_u32(p0);
    qf[kk][1] = ld_u32(p1);
    qf[kk][2] = ld_u32(p0 + 8);
    qf[kk][3] = ld_u32(p1 + 8);
  }

  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m_run[2] = {kMaskFill, kMaskFill};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int kb_end = (S + kBlockK - 1) / kBlockK;
  if (causal && q0 >= shift) {
    const int last_key = min(q0 + kBlockQ, S) - 1 - shift;
    kb_end = last_key / kBlockK + 1;
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < kBlockK * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        const size_t off = base + (size_t)(k0 + r) * D + col;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * ST + col) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * VST + r] = ve[i];
    }
    __syncthreads();

    // Scores for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* pk = sK + (n * 8 + g) * ST + kk * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(pk), ld_u32(pk + 8)};
        mma_bf16_16816(s[n], qf[kk], b);
      }
    }

    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (col >= S)
          x = -INFINITY;  // past the sequence: no key at all
        else if (causal && rows[e >> 1] < col + shift)
          x = kMaskFill;
        s[n][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = group_max(m_new[i]);
      corr[i] = expf(m_run[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] = l_run[i] * corr[i] + group_sum(rsum[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: the score accumulators are the A fragments of P.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* pv = sVt + (dn * 8 + g) * VST + j * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(pv), ld_u32(pv + 8)};
        mma_bf16_16816(acc[dn], a, b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= S) continue;
    const float l_safe = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const uint32_t packed =
          pack_bf16x2(acc[dn][2 * i] / l_safe, acc[dn][2 * i + 1] / l_safe);
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) = packed;
    }
    if (t == 0) lse[(size_t)blockIdx.y * S + row] = m_run[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, int causal, int shift, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s, scale, causal, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous bf16, 16-byte aligned; lse: [bh, s] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int s, int d, int causal,
                                        int causal_shift, float scale,
                                        void* stream) {
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
