// Fused per-token cross-entropy for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_ce` in
// src/repro/kernels/fused_ce/fused_ce.py:67 (body `_ce_kernel`, :31). It
// computes the same function, not the same schedule:
//   logits (T, V) float32, labels (T,) int32 ->
//     lse[t] = log(sum_v exp(logits[t, v]))                      (float32)
//     nll[t] = lse[t] - logits[t, labels[t]]
//   A label outside [0, V) picks nothing, so its nll is lse[t]. The Pallas
//   kernel does the same for a negative label or one past its last vocab
//   tile, which no tile owns (a label inside that tile's padding picks the
//   padding's -1e30 there).
//   lse is written for the backward pass, which runs in PyTorch.
//
// Bound. Each logit is read once and two floats a row are written, against
// a handful of operations per logit (a max, an exp, an add): the bound is
// the bytes over the memory rate, T * V * 4 / 3.35 TB/s (2.68 GB, 0.80 ms
// for gemma3-1b's 2560 x 262,144 logits of one local step).
//
// Design against that bound:
//   * The TPU grid walked (row block, vocab block) in order and carried a
//     running (max, sumexp) in VMEM scratch from one vocab block to the
//     next. Here one CUDA block owns one row and strides over V with
//     16-byte loads (4 logits a thread, VEC = 1 when V is not a multiple of
//     4 or the rows are not 16-byte aligned). Each thread keeps its own
//     running (max, sumexp), rescaled once per 4 logits (one extra exp per
//     chunk only when the chunk raises the max), so probabilities never
//     reach memory.
//   * The thread whose chunk holds the label column picks its logit; the
//     others hold 0, so a sum gives the label logit.
//   * The per-thread states merge by warp shuffles, then across the
//     block's warps in shared memory.
//   * Row offsets are 64-bit: T * V passes 2^31 at T >= 8192 with a 262k
//     vocabulary.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;        // the TPU kernel's finite -inf

template <int VEC> __device__ __forceinline__ void load(const float* p, float* v);
template <> __device__ __forceinline__ void load<1>(const float* p, float* v) {
  v[0] = __ldg(p);
}
template <> __device__ __forceinline__ void load<4>(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// (m, s) <- the merge of two running (max, sumexp) states.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_reduce(float& m, float& s, float& lab) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lab += __shfl_xor_sync(0xffffffffu, lab, off);
    merge(m, s, m2, s2);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
fused_ce_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                float* __restrict__ nll, float* __restrict__ lse, long long v) {
  const long long row = blockIdx.x;
  const float* xr = logits + row * v;
  const long long label = __ldg(labels + row);
  const long long nvec = v / VEC;

  float m = kNegInf, s = 0.f, lab = 0.f;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    float t[VEC];
    load<VEC>(xr + i * VEC, t);
    float cm = t[0];
#pragma unroll
    for (int k = 1; k < VEC; ++k) cm = fmaxf(cm, t[k]);
    if (cm > m) {
      s *= expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += expf(t[k] - m);
    const long long c0 = i * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (c0 + k == label) lab = t[k];
  }

  warp_reduce(m, s, lab);
  __shared__ float sh_m[kWarps], sh_s[kWarps], sh_l[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_m[warp] = m;
    sh_s[warp] = s;
    sh_l[warp] = lab;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sh_m[lane] : kNegInf;
    s = lane < kWarps ? sh_s[lane] : 0.f;
    lab = lane < kWarps ? sh_l[lane] : 0.f;
    warp_reduce(m, s, lab);
    if (lane == 0) {
      const float l = m + logf(fmaxf(s, 1e-30f));
      lse[row] = l;
      nll[row] = l - lab;
    }
  }
}

template <int VEC>
int launch(const float* logits, const int* labels, float* nll, float* lse,
           long long t, long long v, cudaStream_t stream) {
  fused_ce_kernel<VEC><<<static_cast<unsigned>(t), kThreads, 0, stream>>>(
      logits, labels, nll, lse, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (t, v) float32, labels (t,) int32, nll and lse (t,) float32. vec is
// 4 when v is a multiple of 4 and logits is 16-byte aligned, else 1.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// configuration.
extern "C" int fused_ce_launch(const void* logits, const void* labels,
                               void* nll, void* lse, long long t, long long v,
                               int vec, void* stream) {
  if (t < 1 || v < 1 || t > 0x7fffffffLL) return -1;
  const float* x = static_cast<const float*>(logits);
  const int* y = static_cast<const int*>(labels);
  float* n = static_cast<float*>(nll);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && v % 4 == 0) return launch<4>(x, y, n, l, t, v, st);
  if (vec == 1) return launch<1>(x, y, n, l, t, v, st);
  return -1;
}
