// Mamba2 SSD within-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk` in
// src/repro/kernels/ssd_chunk/ssd_chunk.py:61 (body `_ssd_chunk_kernel`,
// :32). Same function, per (batch, chunk, head), all in float32:
//   cum   = cumsum(dt * a)                                      (L,)
//   y     = [tril(exp(cum_i - cum_j)) * (C B^T) * dt_j] @ x     (L, hd)
//   state = (exp(cum_L - cum) * dt * B)^T @ x                   (ds, hd)
//   total = cum_L
// Inputs: xs (b, nc, L, nh, hd), B and C (b, nc, L, ds) in float32 or
// bfloat16 (widened to float32 on load, as the Pallas kernel does); dt
// (b, nc, L, nh) and a (nh,) in float32. Outputs float32: y (b, nc, L, nh,
// hd), states (b, nc, nh, ds, hd), totals (b, nc, nh).
//
// Bound. At mamba2-370m's shapes (L 64, nh 32, hd 64, ds 128, bf16 x, B
// and C) one chunk reads 256 KiB of x, 32 KiB of B and C and 8 KiB of dt,
// and writes 512 KiB of f32 y and 1 MiB of f32 states: 1.88 MB. The
// function needs C B^T on and below the diagonal once per chunk (L(L+1)/2
// x ds multiply-adds) and, per head, the masked product with x (L(L+1)/2
// x hd) and the state product (L x ds x hd): 42.6 MFLOP per chunk, 23 FLOP
// a byte against the ridge of 20 of the card's float32 rate outside the
// tensor cores (67 TFLOP/s over 3.35 TB/s). Bytes and operations are
// close; the operations bound it, just (a 512-token prefill: 5.1 us
// against 4.5 us for the bytes).
//
// Design:
//   * One CUDA block per (batch, chunk, head), as the TPU grid: a prefill
//     of 512 tokens gives 8 x 32 = 256 blocks, two a streaming
//     multiprocessor. One block per (batch, chunk) looping over the heads
//     would form C B^T once instead of nh times, but gives 8 blocks for
//     132 SMs. Recomputing it costs each head two fifths more operations
//     (its lower triangle only: blocks skip the rows above the diagonal);
//     filling the card is worth more.
//   * B, C (L x ds) and x (L x hd) are staged in shared memory as float32,
//     about 100 KB at the full shapes: above the 48 KB default, so the
//     launch raises the block's dynamic shared memory limit first.
//   * cum is a warp scan over L: each lane scans a segment of consecutive
//     steps, and the segment sums are scanned with shuffles.
//   * The three products are f32 FMA loops in which a thread owns one
//     output column and a run of rows in registers; the reduced dimension
//     goes in steps of four, read as float4 rows of B, C, the (L x L)
//     matrix and the (ds x L) matrix w_j B_js, so a thread makes about one
//     shared-memory load per four FMAs for the row operand. Rows of B and
//     C are padded by four floats, so lanes that read different rows hit
//     different banks. Tensor cores (mma/wgmma) are later work.
//   * exp(cum_i - cum_j) is taken only for i >= j: a < 0 and dt >= 0 make
//     the exponent positive above the diagonal, where it may overflow, and
//     inf * 0 would give NaN. A padded step (dt = 0) has decay 1 and
//     contributes 0, as in the plain version.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStateRows = 16;  // state rows a thread holds in one pass

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Shared memory of one block, in floats, for a given (L, ds, hd).
struct Smem {
  int dsp, lp, region, b, c, x, s, cum, dt, w, total;
  __host__ __device__ Smem(int L, int ds, int hd) {
    dsp = ds + 4;                          // padded row of B and C
    lp = L + 4;                            // padded row of S and w B^T
    region = L * dsp > ds * lp ? L * dsp : ds * lp;  // C, later w B^T
    c = 0;
    b = c + region;
    x = b + L * dsp;
    s = x + L * hd;
    cum = s + L * lp;
    dt = cum + round4(L);
    w = dt + round4(L);
    total = w + round4(L);
  }
};

template <typename T, int L, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ xs, const float* __restrict__ dt_g,
                 const float* __restrict__ a_g, const T* __restrict__ B_g,
                 const T* __restrict__ C_g, float* __restrict__ y_g,
                 float* __restrict__ state_g, float* __restrict__ total_g,
                 int nc, int nh, int ds) {
  extern __shared__ __align__(16) float smem[];
  const Smem lay(L, ds, HD);
  float* sC = smem + lay.c;
  float* sWBt = smem + lay.c;  // reuses C's region once C B^T is formed
  float* sB = smem + lay.b;
  float* sX = smem + lay.x;
  float* sS = smem + lay.s;
  float* sCum = smem + lay.cum;
  float* sDt = smem + lay.dt;
  float* sW = smem + lay.w;
  const int dsp = lay.dsp, lp = lay.lp;

  const int h = blockIdx.x;
  const size_t bc = blockIdx.y;  // batch * nc + chunk
  const int t = threadIdx.x;

  // -- stage B, C, x and dt of this (batch, chunk, head) --------------------
  const T* Bc = B_g + bc * L * ds;
  const T* Cc = C_g + bc * L * ds;
  for (int e = t; e < L * ds; e += kThreads) {
    const int j = e / ds, k = e - j * ds;
    sB[j * dsp + k] = to_f32<T>(Bc[e]);
    sC[j * dsp + k] = to_f32<T>(Cc[e]);
  }
  for (int e = t; e < L * HD; e += kThreads) {
    const int j = e / HD, d = e - j * HD;
    sX[e] = to_f32<T>(xs[((bc * L + j) * nh + h) * HD + d]);
  }
  if (t < L) sDt[t] = dt_g[(bc * L + t) * nh + h];
  __syncthreads();

  // -- cum: a warp scan over the L steps ------------------------------------
  if (t < 32) {
    constexpr int kPer = (L + 31) / 32;
    const float a = a_g[h];
    float seg[kPer];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t * kPer + i;
      run += j < L ? sDt[j] * a : 0.f;
      seg[i] = run;
    }
    float incl = run;  // inclusive scan of the segment sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (t >= off) incl += o;
    }
    const float before = incl - run;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t * kPer + i;
      if (j < L) sCum[j] = before + seg[i];
    }
  }
  __syncthreads();
  const float total = sCum[L - 1];
  if (t < L) sW[t] = expf(total - sCum[t]) * sDt[t];

  // -- S = tril(exp(cum_i - cum_j)) * (C B^T) * dt_j --------------------------
  // thread: column j, rows i = g + G r
  {
    constexpr int G = kThreads / L;
    constexpr int R = L / G;
    const int j = t % L, g = t / L;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < ds; k += 4) {
      const float4 bj = *reinterpret_cast<const float4*>(sB + j * dsp + k);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + G * r;
        if (i < j) continue;
        const float4 ci = *reinterpret_cast<const float4*>(sC + i * dsp + k);
        acc[r] = dot4(ci, bj, acc[r]);
      }
    }
    const float cj = sCum[j], dtj = sDt[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + G * r;
      sS[i * lp + j] = i >= j ? expf(sCum[i] - cj) * acc[r] * dtj : 0.f;
    }
  }
  __syncthreads();  // S is complete; C is no longer read

  // -- w B^T into C's region: (ds x L), w_j = exp(total - cum_j) dt_j --------
  for (int e = t; e < ds * L; e += kThreads) {
    const int s = e / L, j = e - s * L;
    sWBt[s * lp + j] = sW[j] * sB[j * dsp + s];
  }

  // -- y = S @ x: thread column d, rows i = g + G r ---------------------------
  {
    constexpr int G = kThreads / HD;
    constexpr int R = L / G;
    const int d = t % HD, g = t / HD;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int j = 0; j < L; j += 4) {
      const float4 xj = make_float4(sX[j * HD + d], sX[(j + 1) * HD + d],
                                    sX[(j + 2) * HD + d], sX[(j + 3) * HD + d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 si =
            *reinterpret_cast<const float4*>(sS + (g + G * r) * lp + j);
        acc[r] = dot4(si, xj, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + G * r;
      y_g[((bc * L + i) * nh + h) * HD + d] = acc[r];
    }
  }
  __syncthreads();  // w B^T is complete

  // -- state = (w B)^T @ x: thread column d, rows s = s0 + g + G r -----------
  {
    constexpr int G = kThreads / HD;
    const int d = t % HD, g = t / HD;
    float* st = state_g + (bc * nh + h) * (size_t)ds * HD;
    for (int s0 = 0; s0 < ds; s0 += G * kStateRows) {
      float acc[kStateRows];
#pragma unroll
      for (int r = 0; r < kStateRows; ++r) acc[r] = 0.f;
      for (int j = 0; j < L; j += 4) {
        const float4 xj = make_float4(sX[j * HD + d], sX[(j + 1) * HD + d],
                                      sX[(j + 2) * HD + d], sX[(j + 3) * HD + d]);
#pragma unroll
        for (int r = 0; r < kStateRows; ++r) {
          const int s = s0 + g + G * r;
          if (s < ds) {
            const float4 ws = *reinterpret_cast<const float4*>(sWBt + s * lp + j);
            acc[r] = dot4(ws, xj, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kStateRows; ++r) {
        const int s = s0 + g + G * r;
        if (s < ds) st[(size_t)s * HD + d] = acc[r];
      }
    }
  }
  if (t == 0) total_g[bc * nh + h] = total;
}

template <typename T, int L, int HD>
int launch(const void* xs, const float* dt, const float* a, const void* B,
           const void* C, float* y, float* states, float* totals, int b, int nc,
           int nh, int ds, cudaStream_t stream) {
  const Smem lay(L, ds, HD);
  const size_t bytes = (size_t)lay.total * sizeof(float);
  auto kern = ssd_chunk_kernel<T, L, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh, b * nc);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(xs), dt, a, static_cast<const T*>(B),
      static_cast<const T*>(C), y, states, totals, nc, nh, ds);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int dispatch_hd(int hd, const void* xs, const float* dt, const float* a,
                const void* B, const void* C, float* y, float* states,
                float* totals, int b, int nc, int nh, int ds, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, L, 32>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    case 64: return launch<T, L, 64>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    case 128: return launch<T, L, 128>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    default: return -1;
  }
}

template <typename T>
int dispatch_l(int L, int hd, const void* xs, const float* dt, const float* a,
               const void* B, const void* C, float* y, float* states,
               float* totals, int b, int nc, int nh, int ds, cudaStream_t s) {
  switch (L) {
    case 16: return dispatch_hd<T, 16>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    case 32: return dispatch_hd<T, 32>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    case 64: return dispatch_hd<T, 64>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, s);
    default: return -1;
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch needs (the wrapper checks them
// against the card's limit before launching).
extern "C" long long ssd_chunk_smem_bytes(int L, int ds, int hd) {
  return (long long)Smem(L, ds, hd).total * (long long)sizeof(float);
}

// dtype code of xs, B and C: 0 = float32, 1 = bfloat16; dt and a are
// float32. L in {16, 32, 64}; hd in {32, 64, 128}; ds a multiple of 4.
// Every tensor is contiguous. Returns 0, a cudaError_t
// from the launch, or -1 for an unsupported configuration.
extern "C" int ssd_chunk_launch(const void* xs, const void* dt, const void* a,
                                const void* B, const void* C, void* y, void* states,
                                void* totals, int x_dtype, int b, int nc, int L,
                                int nh, int hd, int ds, void* stream) {
  if (ds <= 0 || ds % 4 != 0 || b <= 0 || nc <= 0 || nh <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* tf = static_cast<float*>(totals);
  if (x_dtype == 0)
    return dispatch_l<float>(L, hd, xs, dtf, af, B, C, yf, sf, tf, b, nc, nh, ds, s);
  if (x_dtype == 1)
    return dispatch_l<__nv_bfloat16>(L, hd, xs, dtf, af, B, C, yf, sf, tf, b, nc, nh, ds, s);
  return -1;
}
