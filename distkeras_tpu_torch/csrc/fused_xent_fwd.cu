// The fused softmax cross-entropy's forward (K4) and row statistics (K5)
// for Hopper (sm_90a): one sweep over each row of [T, V] logits.
//
// Replaces the Pallas kernels of distkeras_tpu/ops/pallas/fused_xent.py:
// - K4, `_fwd_kernel` launched by `_call_fwd` (:107):
//   loss = log s + m - x[label], a label outside [0, V) picking 0;
// - K5, `_stats_kernel` launched first by `_call_bwd` (:127): m and s;
// where m is the row's maximum (the running max starts at -1e30, as in the
// reference) and s = sum(exp(x - m)), all in float32 whatever the logits'
// type (float32, bfloat16 or float16). Labels are int32 or int64, read as
// they are.
//
// What bounds them: each reads every logit once and does a handful of
// float32 operations on it, about 1 operation a byte, far below the card's
// ratio of compute to memory rate, so the bytes bound them: at T = 4096,
// V = 30522 in float32, 500 MB take 149 us at 3.35 TB/s. To reach that rate
// each SM must keep about 32 KB of logits in flight (Little's law: 3.35 TB/s
// over 132 SMs, times about a microsecond of latency), and the arithmetic
// must stay off the issue slots' critical path: each logit costs one
// conversion to float32, one max, one subtraction, one product, one ex2
// and one add.
//
// One kernel, two widths of a row's team, chosen on the host by the row's
// width (ops/fused_xent.py `_xent_plan`): a warp a row, 8 rows a block, for
// rows of at most 16 KB (MoE's V = 1024: [2048, 1024] float32 is 256
// blocks, one wave), and a block of 256 threads a row for wider ones (the
// vocabularies 30522 and 50257), on a persistent grid of 4 blocks an SM that
// walks the rows. Each thread issues all four of its 16-byte loads of a
// chunk (2 KB a warp, 16 KB a block) before any arithmetic, then folds them
// into its running max and sum in registers; a row ends in shuffles across
// the warp and, for a block, one pass through shared memory. 4 blocks an SM
// keep 64 KB an SM in flight, twice what Little's law asks.
//
// A ring of shared-memory stages filled by plain bulk copies (cp.async.bulk,
// completing on an mbarrier) was this kernel's first design. It ran slower
// than these direct loads at every wide shape on the same card, with more
// or larger stages, more blocks or threads, or a producer warp of its own
// alike, and was dropped (PERF.md).
//
// Alignment: a row's byte stride need not be a multiple of 16 (30522 x 4 =
// 122088, 50257 x 2 = 100514), and a row-strided view may start anywhere,
// so no TMA tensor map can describe the logits, and no 16-byte load can
// start at a row's first element. The kernel reads the 16-byte aligned span
// that covers the row and masks the elements outside it (at most 15 bytes
// on either side, only in the span's first and last vectors). Those bytes
// share an aligned 16-byte unit with bytes of the row, so they never leave
// the row's pages, and PyTorch's allocator hands out blocks in 512-byte
// units, so they stay inside its allocation. Offsets are computed in 64
// bits.
//
// Exponentials: exp(x - m) = 2^((x - m) log2 e), a subtraction, a product
// and one ex2.approx: within about 2e-6 relative of expf, against the 1e-4
// to which s is held (and 1e-5 for the loss). The subtraction comes first
// so that a row whose values all lie at -1e30 (the running max's start, or
// the reference's padding value) gives exp(0) = 1, not the rounding error
// of -1e30 log2 e, which exceeds 2^70.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaxInit = -1e30f;  // the reference's initial running max
constexpr int kNoPick = -(1 << 30);  // no column: a label outside [0, V)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;  // 16-byte loads a thread issues at once

// A 16-byte vector of logits as float32 values.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&x)[N]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&x)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elem<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&x)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __half2 h;
      memcpy(&h, &w[i], 4);
      const float2 f = __half22float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// The running (m, s) after the values summarised by (m2, s2) joined them.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * hopper::exp2_approx((m - mn) * kLog2e) + s2 * hopper::exp2_approx((m2 - mn) * kLog2e);
  m = mn;
}

// Folds G vectors into the running (m, s): `first[g]` is the row index of
// vector g's element 0 (negative in the span's first vector when the row
// starts inside it); elements outside [0, V) count as -inf. If column `pick`
// lies in a vector, its value goes to `picked`.
template <typename T, bool kPick, int G>
__device__ __forceinline__ void sweep(const uint4 (&raw)[G], const int (&first)[G], int V,
                                      int pick, float& m, float& s, float& picked) {
  constexpr int N = Elem<T>::N;
  float x[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Elem<T>::unpack(raw[g], x[g]);
    if (first[g] < 0 || first[g] > V - N) {  // the row's edge, or past its end
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (first[g] + k < 0 || first[g] + k >= V) x[g][k] = neg_inf();
    }
    if (kPick && pick >= first[g] && pick < first[g] + N) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (first[g] + k == pick) picked = x[g][k];
    }
  }
  float mn = m;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < N; ++k) mn = fmaxf(mn, x[g][k]);
  float acc = s * hopper::exp2_approx((m - mn) * kLog2e);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < N; ++k) acc += hopper::exp2_approx((x[g][k] - mn) * kLog2e);
  m = mn;
  s = acc;
}

__device__ __forceinline__ void warp_reduce(float& m, float& s, float& picked) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    picked += __shfl_xor_sync(0xffffffffu, picked, o);  // one lane holds it, the others 0
    merge(m, s, m2, s2);
  }
}

// A row's 16-byte aligned span: its first vector, the elements of that
// vector before the row's first, and the span's length in vectors.
template <typename T>
struct Span {
  const uint4* vecs;
  int head;
  int nvec;
  __device__ Span(const T* logits, long long row, long long stride, int V) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(logits + row * stride);
    vecs = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
    head = static_cast<int>(a & 15) / static_cast<int>(sizeof(T));
    nvec = (head + V + Elem<T>::N - 1) / Elem<T>::N;
  }
};

template <typename L>
__device__ __forceinline__ int pick_of(const L* labels, long long row, int V) {
  const long long label = static_cast<long long>(labels[row]);
  return label >= 0 && label < V ? static_cast<int>(label) : kNoPick;
}

template <bool kStats>
__device__ __forceinline__ void emit(float* out0, float* out1, long long row, float m, float s,
                                     float picked) {
  if (kStats) {
    out0[row] = m;
    out1[row] = s;
  } else {
    out0[row] = logf(s) + m - picked;
  }
}

// kTeam threads sweep each row: 32 (a warp) or kThreads (the block).
template <typename T, bool kStats, typename L, int kTeam>
__global__ void __launch_bounds__(kThreads)
    xent_rows_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                     float* __restrict__ out0, float* __restrict__ out1, int rows, int V,
                     long long stride) {
  constexpr int N = Elem<T>::N;
  constexpr int kRows = kThreads / kTeam;  // rows a block takes at once
  __shared__ float red[3 * kWarps];        // a block team's warps' (m, s, picked)
  const int t = threadIdx.x % kTeam, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long row0 = (long long)blockIdx.x * kRows; row0 < rows;
       row0 += (long long)gridDim.x * kRows) {
    const long long row = row0 + threadIdx.x / kTeam;
    if (kTeam == 32 && row >= rows) break;  // a warp team past the end (no block barrier)
    const Span<T> span(logits, row, stride, V);
    const int pick = kStats ? kNoPick : pick_of(labels, row, V);
    float m = kMaxInit, s = 0.f, picked = 0.f;
    for (int c = 0; c < span.nvec; c += kTeam * kVecs) {
      uint4 raw[kVecs];
      int first[kVecs];
#pragma unroll
      for (int g = 0; g < kVecs; ++g) {  // every load before any arithmetic
        const int j = c + g * kTeam + t;
        first[g] = j * N - span.head;  // past the span: >= V, so all masked
        raw[g] = j < span.nvec ? __ldg(span.vecs + j) : make_uint4(0, 0, 0, 0);
      }
      sweep<T, !kStats, kVecs>(raw, first, V, pick, m, s, picked);
    }
    warp_reduce(m, s, picked);
    if (kTeam > 32) {
      if (lane == 0) {
        red[warp] = m;
        red[kWarps + warp] = s;
        red[2 * kWarps + warp] = picked;
      }
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          merge(m, s, red[w], red[kWarps + w]);
          picked += red[2 * kWarps + w];
        }
      }
      __syncthreads();  // red is read before the next row writes it
    }
    if (t == 0) emit<kStats>(out0, out1, row, m, s, picked);
  }
}

template <typename T, bool kStats, typename L>
int launch(const void* logits, const void* labels, void* out0, void* out1, int rows, int V,
           long long stride, int narrow, int grid, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  const L* y = static_cast<const L*>(labels);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  if (narrow)
    xent_rows_kernel<T, kStats, L, 32><<<grid, kThreads, 0, stream>>>(x, y, o0, o1, rows, V,
                                                                    stride);
  else
    xent_rows_kernel<T, kStats, L, kThreads><<<grid, kThreads, 0, stream>>>(x, y, o0, o1, rows,
                                                                          V, stride);
  return (int)cudaGetLastError();
}

template <bool kStats, typename L>
int by_dtype(int dtype, const void* logits, const void* labels, void* out0, void* out1, int rows,
             int V, long long stride, int narrow, int grid, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float, kStats, L>(logits, labels, out0, out1, rows, V, stride, narrow, grid,
                                      stream);
    case 1:
      return launch<__nv_bfloat16, kStats, L>(logits, labels, out0, out1, rows, V, stride,
                                              narrow, grid, stream);
    case 2:
      return launch<__half, kStats, L>(logits, labels, out0, out1, rows, V, stride, narrow, grid,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: loss[T] (float32) of logits [T, V] (row stride `stride` elements;
// dtype 0 float32, 1 bfloat16, 2 float16) and labels [T] of `label_bytes`
// 4 (int32) or 8 (int64), on the schedule and grid the host chose.
extern "C" int fused_xent_fwd(const void* logits, const void* labels, void* loss, int rows, int v,
                              long long stride, int dtype, int label_bytes, int narrow, int grid,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (label_bytes == 4)
    return by_dtype<false, int32_t>(dtype, logits, labels, loss, nullptr, rows, v, stride, narrow,
                                    grid, st);
  if (label_bytes == 8)
    return by_dtype<false, int64_t>(dtype, logits, labels, loss, nullptr, rows, v, stride, narrow,
                                    grid, st);
  return (int)cudaErrorInvalidValue;
}

// K5: the row max m[T] and s[T] = sum(exp(x - m)), float32, of the same
// logits.
extern "C" int fused_xent_stats(const void* logits, void* m, void* s, int rows, int v,
                                long long stride, int dtype, int narrow, int grid, void* stream) {
  return by_dtype<true, int32_t>(dtype, logits, nullptr, m, s, rows, v, stride, narrow, grid,
                                 static_cast<cudaStream_t>(stream));
}
