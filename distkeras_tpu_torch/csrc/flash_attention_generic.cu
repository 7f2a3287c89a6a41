// Flash attention forward of the generic route for Hopper (sm_90a): K1g, for
// float32, float16 and bfloat16 at any head dim D >= 1, any row and base
// alignment, causal shift 0 and 1 (bf16 at D 32 and 64 on 16-byte aligned
// tensors takes flash_attention_fwd.cu instead; the generic backward K2g/K3g
// lives in flash_attention_generic_bwd.cu, on the same building blocks of
// flash_generic_sm90.cuh).
//
// Replaces the Pallas kernel of distkeras_tpu/ops/pallas/flash_attention.py
// outside the Hopper kernel's domain: K1g, `_fwd_kernel` launched by
// `_flash_forward` (:189): O = softmax(Q K^T * scale [masked]) V, lse = m +
// log(l) per query row, float32. The causal mask `row >= col + causal_shift`
// fills scores with -1e30 (not -inf), so a query row that sees no key (shift
// 1, row 0) weighs every key equally and gets lse exactly -1e30, as in the
// reference. P is rounded to the input type before P V, where the plain
// version (ops/flash_attention.py) rounds it (the identity in float32); l
// sums the unrounded P. The scale is the caller's D^-1/2.
//
// What bounds it on the H100: per (bh) slice it does 4 S^2 D flops (about
// half that under the causal mask) on 3 tensors of S x D in and 1 out: S / 4
// flops a byte in float32, S / 2 in 16 bits. Against the tensor cores'
// balance points (3xTF32: 495 / 3 TFLOP/s over 3.35 TB/s, 49 flops a byte;
// bf16/f16 295) it is bound by its bytes at bert's S = 128 in every dtype,
// and by its operations in float32 at gpt's S = 512, as long as its
// products run on the tensor cores. They do:
// - float16 and bfloat16: wgmma m64n64k16, f32 accumulators, on 128-byte-
//   swizzled panels. S = Q K^T reads both operands K-major (Ops16::scores);
//   O += P V takes P from the score accumulators rounded to 16 bits in
//   registers and V MN-major through the transpose bit (Ops16::product).
// - float32: 3xTF32 on mma.sync m16n8k8 (OpsF32), within about 2^-20 of each
//   product, each k8 step's three products summed apart and joined to the
//   accumulator by one float32 add: float32's accuracy at D = 512 too. P
//   feeds the second product from the accumulators through the permuted
//   reduction index.
//
// Design: a block of one warpgroup (128 threads) a tile of 64 query rows and
// one chunk of W = 64 NP of O's columns (NP panels; W = 64 in float32, 64 or
// 128 in 16 bits), looping over key tiles of 64. Q, K and V are staged by
// cp.async of any alignment (columns past D and rows past S as zeros). When D
// fits one chunk Q stays in shared memory and K and V are double-buffered,
// the next tile's copy in flight during the current tile's products. The
// online softmax runs in registers on the accumulator layout: a row's values
// lie on the 4 lanes of a group, so its max is two shuffles (xor 1, 2); O's
// accumulators hold the same rows, so the rescale needs no exchange, and the
// row sum is reduced once, at the end. Scores are in log2 units (exp2 on the
// special-function unit); a row whose max is the mask fill gets lse -1e30
// exactly. O leaves through shared memory as whole rows (16-byte stores
// where aligned); lse is written once a row, by chunk 0.
// Any D through column chunks on a grid axis (the kChunks instances): the
// scores reduce over the whole D, one chunk of Q and K staged at a time, the
// block's own chunk last with its V chunk; each chunk's block recomputes the
// scores. Causal blocks skip key tiles wholly above the diagonal, except the
// tile holding a row that sees no key (row < shift), which weighs every key,
// and deal their query tiles longest first, as K2g does.

#include "flash_generic_sm90.cuh"

namespace {

using namespace flash_generic;

constexpr float kLn2 = 0.6931471805599453f;

// The register cap of an instance: ptxas spilled the float32 instances at
// some caps and not at others (unchunked: 200, 224 and 232 spilled, 208,
// 216 and 240-255 not; chunked: every cap from 208 to 255 spilled, 200
// not); the 16-bit instances take at most 168 registers under either.
template <bool kChunks>
constexpr int kMaxRegs = kChunks ? 200 : 255;

// K1g. Block w of a grid of q_tiles * nc * BH: query tiles outermost,
// longest first under the causal mask, then the chunk, then the (bh) slice.
// nc, the number of W-column chunks of D, is 1 unless the kChunks instance
// runs (D > W).
template <typename T, int NP, bool kChunks>
__global__ void __maxnreg__(kMaxRegs<kChunks>)
    flash_fwd_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                             int bh_count, int S, int D, int chunks, int causal, int shift,
                             float scale, int gran) {
  using Ops = OpsOf<T, NP>;
  const int nc = kChunks ? chunks : 1;
  constexpr int TB = Ops::kTileBytes, W = Ops::kWidth;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sKV = sQ + TB;  // stage s: K at sKV + 2 s TB, V right after

  const int n_qb = (S + kRows - 1) / kRows;
  const int qi = blockIdx.x / (nc * bh_count), rest = blockIdx.x % (nc * bh_count);
  const int oc = rest / bh_count, bh = rest % bh_count;
  int qb = qi;
  if (causal) qb = shift ? (qi == 0 ? 0 : n_qb - qi) : n_qb - 1 - qi;
  const int q0 = qb * kRows;
  const size_t base = (size_t)bh * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[NP][32];  // O, this chunk's columns, unnormalised
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  const float scale_log2 = scale * kLog2e, fill_log2 = to_log2(kMaskFill);
  // Each row's running max (log2 units) and this thread's part of its sum.
  float m[2] = {fill_log2, fill_log2}, l[2] = {0.f, 0.f};

  // Step n = kt * nc + i: key tile kt, chunk (oc + 1 + i) % nc (the
  // block's own last, with V). With one chunk Q is staged once and K/V
  // double-buffered; with several, every step stages its chunk, one step at
  // a time.
  const int k_tiles = (causal_keys(q0, S, causal, shift) + kRows - 1) / kRows;
  const int steps = k_tiles * nc;
  constexpr bool pipelined = !kChunks;
  auto issue = [&](int n, int buf) {
    const int i = n % nc, col0 = (oc + 1 + i) % nc * W, k0 = n / nc * kRows;
    if (!pipelined || n == 0) Ops::stage(sQ, q + base, q0, S, D, col0, gran, tid, 128);
    unsigned char* sK = sKV + 2 * buf * TB;
    Ops::stage(sK, k + base, k0, S, D, col0, gran, tid, 128);
    if (i == nc - 1) Ops::stage(sK + TB, v + base, k0, S, D, col0, gran, tid, 128);
    cp_async_commit();
  };

  float sc[32];  // S = Q K^T, 64 x 64, summed over the chunks; then P
  issue(0, 0);
  for (int kt = 0, n = 0; kt < k_tiles; ++kt) {
    const unsigned char* sK = sKV;
    for (int i = 0; i < nc; ++i, ++n) {
      const int buf = pipelined ? n & 1 : 0;
      if (pipelined && n + 1 < steps) {
        issue(n + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_async_smem();  // this thread's copies and zeros, to wgmma's proxy
      __syncthreads();
      sK = sKV + 2 * buf * TB;
      Ops::scores(sc, sQ, sK, min(W, D - (oc + 1 + i) % nc * W), i > 0, warp, lane);
      if (i + 1 < nc) {  // kChunks: the next chunk's Q and K, once these are read
        __syncthreads();
        issue(n + 1, 0);
      }
    }
    // The scores are whole. This thread's columns are k0 + 2t + c for c =
    // 8j + (e & 1): scores before seen[h], masked from there to `inside`,
    // outside the sequence past it (no key at all).
    const int k0 = kt * kRows, inside = S - k0 - 2 * t;
    int seen[2];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      seen[h] = causal ? min(inside, q0 + 16 * warp + g + 8 * h - shift + 1 - k0 - 2 * t) : inside;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1), h = e >> 1;
        float x = sc[4 * j + e] * scale_log2;
        if (c >= seen[h]) x = c < inside ? fill_log2 : -INFINITY;
        sc[4 * j + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2_approx(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(sc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[4 * j + e] = p;
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[p][r] *= corr[(r >> 1) & 1];
    Ops::product(acc, sc, sK + TB, warp, lane);  // O += P V
    __syncthreads();  // the buffers of this step are read
    if (!pipelined && n < steps) issue(n, 0);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    const int row = q0 + 16 * warp + g + 8 * h;
    if (oc == 0 && t == 0 && row < S)
      lse[(size_t)bh * S + row] = (m[h] == fill_log2 ? kMaskFill : m[h] * kLn2) + logf(l[h]);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[p][r] *= inv[(r >> 1) & 1];
  // O through the (free) K/V stages: coalesced rows.
  tile_to_smem<T, NP>(sKV, acc, warp, lane);
  __syncthreads();
  smem_to_rows<T, NP>(o + base, sKV, q0, S, D, oc * W, gran, tid, 128);
}

template <typename T, int NP>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s, int d,
        int causal, int shift, float scale, cudaStream_t stream) {
  using Ops = OpsOf<T, NP>;
  const void* ptrs[4] = {q, k, v, o};
  const int gran = granule(d, sizeof(T), ptrs, 4);
  const int nc = (d + Ops::kWidth - 1) / Ops::kWidth;
  // Q and two stages of K and V (one stage in chunks), and 1024 bytes to
  // align the first.
  const size_t smem = (nc > 1 ? 3 : 5) * (size_t)Ops::kTileBytes + 1024;
  return launch_kernel(nc > 1 ? flash_fwd_generic_kernel<T, NP, true>
                              : flash_fwd_generic_kernel<T, NP, false>,
                       (long long)((s + kRows - 1) / kRows) * nc * bh, 128, smem, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
                       bh, s, d, nc, causal, shift, scale, gran);
}

// 16 bits: one panel a chunk up to D = 64, two above (D = 128 in one chunk).
template <typename T, typename... Args>
int fwd16(int d, Args... args) {
  return d <= kPanel ? fwd<T, 1>(args...) : fwd<T, 2>(args...);
}

}  // namespace

// K1g. q, k, v, o: [bh, s, d] contiguous, of one dtype (0 float32, 1
// bfloat16, 2 float16), d >= 1, no alignment asked; lse: [bh, s] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_generic(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int bh, int s, int d, int causal,
                                           int causal_shift, int dtype, float scale,
                                           void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return fwd<float, 1>(q, k, v, o, lse, bh, s, d, causal, causal_shift, scale, st);
    case 1:
      return fwd16<bf16>(d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale, st);
    case 2:
      return fwd16<__half>(d, q, k, v, o, lse, bh, s, d, causal, causal_shift, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
