// RMSNorm for Hopper (sm_90a), optionally with the residual add fused in.
//
// Replaces the Pallas TPU kernel `rmsnorm` in
// src/repro/kernels/rmsnorm/rmsnorm.py:29 (body `_rmsnorm_kernel`, :21),
// and the residual add `x = x + y` that precedes 2L of a model's 2L + 1
// norms (src/repro/models/transformer.py:112/:140, :290/:316, :565/:587).
// It computes the same function, not the same schedule:
//   x (rows, d) in float32 or bfloat16, optional delta (rows, d) in x's
//   type, scale (G, d) float32 with rows_per_group = rows / G (G = 1: one
//   scale for every row) ->
//     s[r, c]   = x[r, c] + delta[r, c], rounded once to x's type, as
//                 torch's `x + delta` (float32 sum, round to nearest even);
//                 without delta, s = x and nothing is written for it
//     rstd[r]   = rsqrt(sum_c s[r, c]^2 / d + eps)                (float32)
//     out[r, c] = (s[r, c] * rstd[r]) * scale[r / rows_per_group, c]
//   in x's type. The reduction is float32. rstd is written for the
//   backward pass, which runs in PyTorch.
//
// Bound. Each element of x (and delta) is read once and each output (s and
// out) written once, the scale and rstd are small, against 4-5 operations
// per element: well under one operation per byte, so the bound is the
// bytes over the memory rate. Fused at the LM shape (4 x 640 x 1152
// bf16): 4 x 5.9 MB / 3.35 TB/s = 0.00704 ms; at a decode step (4 x 1152)
// the launch itself is the floor, and fusing saves the add's launch.
//
// Design against that bound:
//   * Rows are independent, so the TPU kernel's (block_rows, d) VMEM tiles
//     become one warp per row, kWarps rows per block. No shared memory and
//     no __syncthreads: the sum of squares is reduced with warp shuffles.
//   * The warp keeps its row in registers across the reduction: NV
//     16-byte vectors a lane, NV fitted to d (gemma3-1b's d = 1152 bf16 is
//     5 vectors of 8 a lane, the last one masked on half the lanes), up to
//     2048 elements a row. s is read from device memory once and never
//     re-read. Every lane loads all its vectors before it uses any (a lane
//     past the row reloads the row's first vector and drops it), so they are in
//     flight together. Longer rows, and rows without 16-byte vectors, take
//     a second pass over the warp's own x (and delta), from L1/L2.
//   * Four rows a block: at the LM shape's 2,560 rows and some 100
//     registers a thread the whole grid is resident in one wave.
//   * VEC = 16 bytes per lane per load (4 float32, 8 bfloat16) when d is a
//     multiple of VEC and every row pointer is 16-byte aligned; any other
//     d or pointer takes VEC = 1, so no padding copy is needed.
//   * The scale row of the row's group is read through the read-only
//     cache; with the worker-stacked scales of the training round, each
//     worker's rows take that worker's scale in the same launch.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // rows per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ unsigned f32_to_bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// A float32 value rounded to X and widened back: what storing it in X keeps.
template <typename X> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __uint_as_float(f32_to_bf16_bits(v) << 16);
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

// Loads vector i of the row: x, or x + delta rounded to X (and then
// written to s).
template <typename X, int VEC, bool ADD>
__device__ __forceinline__ void load_sum(const X* xr, const X* dr, X* sr, int i,
                                         float* v) {
  load<VEC>(xr + i * VEC, v);
  if (ADD) {
    float t[VEC];
    load<VEC>(dr + i * VEC, t);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = round_to<X>(v[k] + t[k]);
    store<VEC>(sr + i * VEC, v);
  }
}

// NV > 0: the row (at most 32 * NV vectors) stays in registers; NV == 0:
// any d, the second pass re-reads x (and delta) and forms s again.
template <typename X, int VEC, int NV, bool ADD>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const X* __restrict__ x, const X* __restrict__ delta,
               const float* __restrict__ scale, X* __restrict__ s_out,
               X* __restrict__ out, float* __restrict__ rstd, long long rows,
               int d, long long rows_per_group, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                // warp-uniform: shuffles stay safe
  const X* xr = x + row * d;
  const X* dr = ADD ? delta + row * d : nullptr;
  X* sr = ADD ? s_out + row * d : nullptr;
  X* outr = out + row * d;
  const float* scr = scale + (row / rows_per_group) * d;
  const int nvec = d / VEC;

  float ss = 0.f;
  if constexpr (NV > 0) {
    float v[NV][VEC];
    float dl[ADD ? NV : 1][VEC];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      const int ii = i < nvec ? i : 0;      // in range; dropped below
      load<VEC>(xr + ii * VEC, v[k]);
      if constexpr (ADD) load<VEC>(dr + ii * VEC, dl[k]);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        if constexpr (ADD) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = round_to<X>(v[k][e] + dl[k][e]);
          store<VEC>(sr + i * VEC, v[k]);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss = fmaf(v[k][e], v[k][e], ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (lane == 0) rstd[row] = r;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        float s[VEC], o[VEC];
        load<VEC>(scr + i * VEC, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = (v[k][e] * r) * s[e];
        store<VEC>(outr + i * VEC, o);
      }
    }
  } else {
    for (int i = lane; i < nvec; i += 32) {
      float t[VEC];
      load_sum<X, VEC, ADD>(xr, dr, sr, i, t);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(t[e], t[e], ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (lane == 0) rstd[row] = r;
    for (int i = lane; i < nvec; i += 32) {
      // s again from x and delta (read-only here), rounded as before
      float t[VEC], s[VEC], o[VEC];
      load<VEC>(xr + i * VEC, t);
      if (ADD) {
        float u[VEC];
        load<VEC>(dr + i * VEC, u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) t[e] = round_to<X>(t[e] + u[e]);
      }
      load<VEC>(scr + i * VEC, s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = (t[e] * r) * s[e];
      store<VEC>(outr + i * VEC, o);
    }
  }
}

template <typename X, int VEC, int NV, bool ADD>
int launch(const void* x, const void* delta, const float* scale, void* s_out,
           void* out, float* rstd, long long rows, int d,
           long long rows_per_group, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<X, VEC, NV, ADD><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(delta), scale,
      static_cast<X*>(s_out), static_cast<X*>(out), rstd, rows, d,
      rows_per_group, eps);
  return static_cast<int>(cudaGetLastError());
}

// The register path for 16-byte vectors with NV fitted to d: bf16 (VEC 8)
// NV 2, 5, 8 (d up to 512, 1280, 2048); float32 (VEC 4) NV 4, 9, 16 (d
// up to 512, 1152, 2048). Anything else takes the two-pass path.
template <typename X, int VEC, bool ADD>
int dispatch_rows(const void* x, const void* delta, const float* scale,
                  void* s_out, void* out, float* rstd, long long rows, int d,
                  long long rows_per_group, float eps, cudaStream_t stream) {
  if constexpr (VEC > 1) {
    constexpr int kSmall = VEC == 8 ? 2 : 4, kMid = VEC == 8 ? 5 : 9,
                  kLarge = VEC == 8 ? 8 : 16;
    const int per_lane = (d / VEC + 31) / 32;
    if (per_lane <= kSmall)
      return launch<X, VEC, kSmall, ADD>(x, delta, scale, s_out, out, rstd, rows, d,
                                         rows_per_group, eps, stream);
    if (per_lane <= kMid)
      return launch<X, VEC, kMid, ADD>(x, delta, scale, s_out, out, rstd, rows, d,
                                       rows_per_group, eps, stream);
    if (per_lane <= kLarge)
      return launch<X, VEC, kLarge, ADD>(x, delta, scale, s_out, out, rstd, rows, d,
                                         rows_per_group, eps, stream);
  }
  return launch<X, VEC, 0, ADD>(x, delta, scale, s_out, out, rstd, rows, d,
                                rows_per_group, eps, stream);
}

template <typename X, int VEC>
int dispatch_add(const void* x, const void* delta, const float* scale,
                 void* s_out, void* out, float* rstd, long long rows, int d,
                 long long rows_per_group, float eps, cudaStream_t stream) {
  if (delta != nullptr)
    return dispatch_rows<X, VEC, true>(x, delta, scale, s_out, out, rstd, rows,
                                       d, rows_per_group, eps, stream);
  return dispatch_rows<X, VEC, false>(x, delta, scale, s_out, out, rstd, rows,
                                      d, rows_per_group, eps, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. delta (in x's type) may be null:
// the plain norm, and s_out is not written. scale is float32 (G, d) with
// G = rows / rows_per_group. vec is the elements per 16 bytes of x (4 for
// float32, 8 for bfloat16) when d is a multiple of it and every pointer
// is 16-byte aligned, else 1. Returns 0, a cudaError_t from the launch, or
// -1 for an unsupported configuration.
extern "C" int rmsnorm_launch(const void* x, const void* delta,
                              const void* scale, void* s_out, void* out,
                              void* rstd, int x_dtype, long long rows, int d,
                              long long rows_per_group, float eps, int vec,
                              void* stream) {
  if (rows < 1 || d < 1 || rows_per_group < 1 || rows % rows_per_group != 0)
    return -1;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return -1;
  if (vec != 1 && d % vec != 0) return -1;
  if (delta != nullptr && s_out == nullptr) return -1;
  const float* s = static_cast<const float*>(scale);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (vec == 4) return dispatch_add<float, 4>(x, delta, s, s_out, out, rs, rows, d, rows_per_group, eps, st);
    if (vec == 1) return dispatch_add<float, 1>(x, delta, s, s_out, out, rs, rows, d, rows_per_group, eps, st);
  } else if (x_dtype == 1) {
    if (vec == 8) return dispatch_add<__nv_bfloat16, 8>(x, delta, s, s_out, out, rs, rows, d, rows_per_group, eps, st);
    if (vec == 1) return dispatch_add<__nv_bfloat16, 1>(x, delta, s, s_out, out, rs, rows, d, rows_per_group, eps, st);
  }
  return -1;
}
