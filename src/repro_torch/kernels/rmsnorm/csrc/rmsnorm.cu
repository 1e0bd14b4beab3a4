// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` in
// src/repro/kernels/rmsnorm/rmsnorm.py:29 (body `_rmsnorm_kernel`, :21).
// It computes the same function, not the same schedule:
//   x (rows, d) in float32 or bfloat16, scale (G, d) float32 with
//   rows_per_group = rows / G (G = 1: one scale for every row) ->
//     rstd[r]   = rsqrt(sum_c x[r, c]^2 / d + eps)               (float32)
//     out[r, c] = (x[r, c] * rstd[r]) * scale[r / rows_per_group, c]
//   in x's type (bfloat16: round to nearest even). The reduction is float32.
//   rstd is written for the backward pass, which runs in PyTorch.
//
// Bound. Each element of x is read once and each output written once, and
// the scale and rstd are small, against 4 operations per element: well
// under one operation per byte, so the bound is the bytes over the memory
// rate, rows * d * 2 * sizeof(x) / 3.35 TB/s.
//
// Design against that bound:
//   * Rows are independent, so the TPU kernel's (block_rows, d) VMEM tiles
//     become one warp per row, kWarps rows per block. No shared memory and
//     no __syncthreads: the sum of squares is reduced with warp shuffles.
//   * VEC = 16 bytes of x per lane per load (4 float32, 8 bfloat16) when d
//     is a multiple of VEC and x, out and scale are 16-byte aligned; any
//     other d or pointer takes VEC = 1, so no padding copy is needed.
//   * The second pass (scale multiply and store) re-reads the warp's own
//     row, which it loaded a moment earlier, from L1/L2, so device memory
//     still sees x once.
//   * The scale row of the row's group is read through the read-only
//     cache; with the worker-stacked scales of the training round, each
//     worker's rows take that worker's scale in the same launch.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int kThreads = 32 * kWarps;

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
template <> __device__ __forceinline__ void load<8>(const float* p, float* v) {
  load<4>(p, v);
  load<4>(p + 4, v + 4);
}

template <int VEC> __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v);
template <> __device__ __forceinline__ void load<1>(const __nv_bfloat16* p, float* v) {
  v[0] = __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}
template <> __device__ __forceinline__ void load<8>(const __nv_bfloat16* p, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Stores of VEC consecutive float32 values, narrowed to the output type.
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
template <> __device__ __forceinline__ void store<8>(__nv_bfloat16* p, const float* v) {
  uint4 t;
  t.x = f32_to_bf16_bits(v[0]) | (f32_to_bf16_bits(v[1]) << 16);
  t.y = f32_to_bf16_bits(v[2]) | (f32_to_bf16_bits(v[3]) << 16);
  t.z = f32_to_bf16_bits(v[4]) | (f32_to_bf16_bits(v[5]) << 16);
  t.w = f32_to_bf16_bits(v[6]) | (f32_to_bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename X, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const X* __restrict__ x, const float* __restrict__ scale,
               X* __restrict__ out, float* __restrict__ rstd, long long rows,
               int d, long long rows_per_group, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                // warp-uniform: shuffles stay safe
  const X* xr = x + row * d;
  X* outr = out + row * d;
  const float* sr = scale + (row / rows_per_group) * d;
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    float t[VEC];
    load<VEC>(xr + i * VEC, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ss = fmaf(t[k], t[k], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (lane == 0) rstd[row] = r;

  for (int i = lane; i < nvec; i += 32) {
    float t[VEC], s[VEC], o[VEC];
    load<VEC>(xr + i * VEC, t);
    load<VEC>(sr + i * VEC, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = (t[k] * r) * s[k];
    store<VEC>(outr + i * VEC, o);
  }
}

template <typename X, int VEC>
int launch(const void* x, const float* scale, void* out, float* rstd,
           long long rows, int d, long long rows_per_group, float eps,
           cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<X, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const X*>(x), scale, static_cast<X*>(out), rstd, rows, d,
      rows_per_group, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. scale is float32 (G, d) with
// G = rows / rows_per_group. vec is the elements per 16 bytes of x (4 for
// float32, 8 for bfloat16) when d is a multiple of it and x, out and scale
// are 16-byte aligned, else 1. Returns 0, a cudaError_t from the launch, or
// -1 for an unsupported configuration.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              void* rstd, int x_dtype, long long rows, int d,
                              long long rows_per_group, float eps, int vec,
                              void* stream) {
  if (rows < 1 || d < 1 || rows_per_group < 1 || rows % rows_per_group != 0)
    return -1;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return -1;
  if (vec != 1 && d % vec != 0) return -1;
  const float* s = static_cast<const float*>(scale);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (vec == 4) return launch<float, 4>(x, s, out, rs, rows, d, rows_per_group, eps, st);
    if (vec == 1) return launch<float, 1>(x, s, out, rs, rows, d, rows_per_group, eps, st);
  } else if (x_dtype == 1) {
    if (vec == 8) return launch<__nv_bfloat16, 8>(x, s, out, rs, rows, d, rows_per_group, eps, st);
    if (vec == 1) return launch<__nv_bfloat16, 1>(x, s, out, rs, rows, d, rows_per_group, eps, st);
  }
  return -1;
}
