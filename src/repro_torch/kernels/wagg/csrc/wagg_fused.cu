// Fused WASGD weighted aggregation (the paper's Eq. 10) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wagg_fused` in
// src/repro/kernels/wagg/wagg.py:88 (body `_wagg_kernel`, :67; `wagg` :139
// delegates to it). It computes the same function, not the same schedule:
//   x (p, N) in float32 or bfloat16, theta (p,) float32 (the codec's
//   per-leaf scale already folded in), payload (p, N) in float32, bfloat16
//   or int8 (or x itself when there is no separate payload), active (p,)
//   float32 0/1 or none ->
//     m[n]      = sum_{j=0..p-1} theta[j] * float(payload[j, n])
//     out[i, n] = (1 - beta) * x[i, n] + beta * m[n]        (active row)
//     out[i, n] = m[n]                                      (inactive row)
//   in x's type. Accumulation is float32, in the order j = 0, 1, ..., p-1.
//
// Bound. Each element of x (and of a separate payload) is read once and
// each output element written once, against 2p + 3 FLOP per column: well
// under one FLOP per byte, so the bound is the bytes over the memory rate,
// p * N * (2 * sizeof(x) + sizeof(payload)) / 3.35 TB/s.
//
// Design against that bound:
//   * The TPU kernel tiled N in VMEM blocks sized by `auto_block_n` (a VMEM
//     budget guard with no counterpart here). On Hopper a simple streaming
//     pass is enough: each thread owns VEC consecutive columns (a grid-
//     stride loop over column groups), loops over the p rows to form m in
//     registers, then writes the p outputs. The second pass re-reads the
//     thread's own x columns, which it loaded a moment earlier, from L1/L2;
//     with a separate payload x is read in the second pass only.
//   * VEC = 4 when N is a multiple of 4 and every row pointer is aligned:
//     16-byte loads of float32, 8-byte loads of bfloat16, 4-byte loads of
//     int8. Any other N takes VEC = 1, so a ragged N needs no padding copy.
//   * Inactive rows (the Alg. 4 late-join) write m without reading x.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // 16 resident blocks per SM

__device__ __forceinline__ float bf16_bits_to_f32(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned f32_to_bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Loads of VEC consecutive elements, widened to float32.
template <int VEC> __device__ __forceinline__ void load(const float* p, float* v);
template <> __device__ __forceinline__ void load<1>(const float* p, float* v) {
  v[0] = __ldg(p);
}
template <> __device__ __forceinline__ void load<4>(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <int VEC> __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v);
template <> __device__ __forceinline__ void load<1>(const __nv_bfloat16* p, float* v) {
  v[0] = bf16_bits_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
template <> __device__ __forceinline__ void load<4>(const __nv_bfloat16* p, float* v) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

template <int VEC> __device__ __forceinline__ void load(const int8_t* p, float* v);
template <> __device__ __forceinline__ void load<1>(const int8_t* p, float* v) {
  v[0] = static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p)));
}
template <> __device__ __forceinline__ void load<4>(const int8_t* p, float* v) {
  const char4 t = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = static_cast<float>(t.x); v[1] = static_cast<float>(t.y);
  v[2] = static_cast<float>(t.z); v[3] = static_cast<float>(t.w);
}

// Stores of VEC consecutive float32 values, narrowed to the output type
// (bfloat16: round to nearest even, as torch's and XLA's casts do).
template <int VEC> __device__ __forceinline__ void store(float* p, const float* v);
template <> __device__ __forceinline__ void store<1>(float* p, const float* v) {
  p[0] = v[0];
}
template <> __device__ __forceinline__ void store<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int VEC> __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v);
template <> __device__ __forceinline__ void store<1>(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(f32_to_bf16_bits(v[0]));
}
template <> __device__ __forceinline__ void store<4>(__nv_bfloat16* p, const float* v) {
  uint2 t;
  t.x = f32_to_bf16_bits(v[0]) | (f32_to_bf16_bits(v[1]) << 16);
  t.y = f32_to_bf16_bits(v[2]) | (f32_to_bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename X, typename Q, int VEC, bool MASKED>
__global__ void __launch_bounds__(kThreads)
wagg_fused_kernel(const X* __restrict__ x, const Q* __restrict__ q,
                  const float* __restrict__ theta,
                  const float* __restrict__ active, X* __restrict__ out,
                  int p, long long n, float keep, float beta) {
  const long long groups = n / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    float m[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) m[k] = 0.f;
    for (int j = 0; j < p; ++j) {
      float v[VEC];
      load<VEC>(q + j * n + col, v);
      const float t = __ldg(theta + j);
#pragma unroll
      for (int k = 0; k < VEC; ++k) m[k] = fmaf(t, v[k], m[k]);
    }
    for (int i = 0; i < p; ++i) {
      float o[VEC];
      if (MASKED && __ldg(active + i) == 0.f) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = m[k];
      } else {
        float xv[VEC];
        load<VEC>(x + i * n + col, xv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = keep * xv[k] + beta * m[k];
      }
      store<VEC>(out + i * n + col, o);
    }
  }
}

struct Args {
  const void* x;
  const void* q;
  const float* theta;
  const float* active;
  void* out;
  int p;
  long long n;
  float keep;
  float beta;
  cudaStream_t stream;
};

template <typename X, typename Q, int VEC, bool MASKED>
int launch(const Args& a) {
  const long long groups = a.n / VEC;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  wagg_fused_kernel<X, Q, VEC, MASKED><<<static_cast<int>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const X*>(a.x), static_cast<const Q*>(a.q), a.theta, a.active,
      static_cast<X*>(a.out), a.p, a.n, a.keep, a.beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename Q>
int dispatch(const Args& a, int vec) {
  const bool masked = a.active != nullptr;
  if (vec == 4) return masked ? launch<X, Q, 4, true>(a) : launch<X, Q, 4, false>(a);
  if (vec == 1) return masked ? launch<X, Q, 1, true>(a) : launch<X, Q, 1, false>(a);
  return -1;
}

template <typename X>
int dispatch_q(const Args& a, int q_dtype, int vec) {
  switch (q_dtype) {
    case 0: return dispatch<X, float>(a, vec);
    case 1: return dispatch<X, __nv_bfloat16>(a, vec);
    case 2: return dispatch<X, int8_t>(a, vec);
    default: return -1;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. x_dtype in {0, 1};
// q_dtype in {0, 1, 2} (pass q = x and q_dtype = x_dtype when there is no
// separate payload). active may be null (no mask). vec is 4 (N % 4 == 0 and
// x, q, out 16-byte aligned) or 1. keep = 1 - beta and beta are computed by
// the caller in double and rounded once to float32. Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported configuration.
extern "C" int wagg_fused_launch(const void* x, const void* q,
                                 const void* theta, const void* active,
                                 void* out, int x_dtype, int q_dtype, int p,
                                 long long n, int vec, float keep, float beta,
                                 void* stream) {
  if (p < 1 || n < 1) return -1;
  if (vec == 4 && n % 4 != 0) return -1;
  const Args a{x, q, static_cast<const float*>(theta),
               static_cast<const float*>(active), out, p, n, keep, beta,
               static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0) return dispatch_q<float>(a, q_dtype, vec);
  if (x_dtype == 1) return dispatch_q<__nv_bfloat16>(a, q_dtype, vec);
  return -1;
}
