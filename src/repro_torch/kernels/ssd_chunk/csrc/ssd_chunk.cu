// Mamba2 SSD within-chunk block for Hopper (sm_90a), its three products on
// the tensor cores.
//
// Replaces the Pallas TPU kernel `ssd_chunk` in
// src/repro/kernels/ssd_chunk/ssd_chunk.py:61 (body `_ssd_chunk_kernel`,
// :32). Same function, per (batch, chunk, head), all in float32:
//   cum   = cumsum(dt * a)                                      (L,)
//   y     = [tril(exp(cum_i - cum_j)) * (C B^T) * dt_j] @ x     (L, hd)
//   state = (exp(cum_L - cum) * dt * B)^T @ x                   (ds, hd)
//   total = cum_L
// Inputs: xs (b, nc, L, nh, hd), B and C (b, nc, L, ds) in float32 or
// bfloat16; dt (b, nc, L, nh) and a in float32, either (nh,), shared by
// every batch row, or (b, nh), one row of decay rates a batch row (the
// training round folds its workers into the batch, and each worker has
// its own A_log). Outputs float32: y (b, nc, L, nh, hd), states
// (b, nc, nh, ds, hd), totals (b, nc, nh).
//
// Bound. At mamba2-370m's shapes (L 64, nh 32, hd 64, ds 128, bf16 x, B
// and C) one chunk reads 256 KiB of x, 32 KiB of B and C and 8 KiB of dt,
// and writes 512 KiB of f32 y and 1 MiB of f32 states: 1.88 MB, 0.56 us
// at the memory rate. The function needs 42.6 MFLOP a chunk (C B^T on and
// below the diagonal once, and per head the masked product with x and the
// state product): 0.64 us at the float32 rate outside the tensor cores,
// 0.13 us at the bf16 tensor-core rate even with the three-part products
// of the split operands below. On tensor cores the bytes bound it.
//
// Design:
//   * The products on tensor cores, by mma.sync.m16n8k16 (bf16 operands,
//     float32 accumulators). A warp owns a 16-row tile of the chunk: C B^T
//     for its rows (n-tiles on and below the diagonal only) stays in its
//     accumulator registers, the decay mask and dt are applied there (exp
//     taken only for i >= j), and the accumulator of two neighbouring
//     n-tiles is the A fragment of the next product as it stands, so S
//     never goes to shared memory. mma.sync over wgmma: the tiles are
//     small (64 x 64 x 128 at most), the triangle is skipped n-tile by
//     n-tile, and S is reused from registers; wgmma's 64-row warpgroup
//     tiles and asynchronous fences buy nothing once the bytes bind.
//   * Precision. bf16 B, C and x go into the MMA as they are: products of
//     bf16 values are exact in float32. A float32 operand (S, w B, and on
//     the float32 input path x, B and C) is split into three bf16 parts,
//     hi + mid + lo (24 bits of mantissa, as float32 has), and the
//     products of the parts whose orders sum to less than three are
//     accumulated smallest first: three MMAs for an f32 x bf16 product,
//     six for f32 x f32.
//   * Staging in the input dtype: B, C and the x rows of the block's heads
//     go into shared memory as they lie in device memory, by cp.async of
//     16 bytes (8, 4 or 2 where the pointers or the rows are not aligned
//     to 16), rows padded so the fragment loads hit distinct banks, ds
//     padded with zeros to the MMA depth of 16. At mamba2-370m's shapes
//     that is 46 KB a block in bf16, against 103 KB staged as float32.
//   * C B^T once for a group of heads. A block takes HG heads of one
//     (batch, chunk): it stages B and C once and forms C B^T once into its
//     registers, then runs each head's decay, y and state from them. HG is
//     the largest divisor of nh up to 8 that still gives 132 blocks (a
//     512-token prefill at b 1: 256 (batch, chunk, head) triples, HG 1; at
//     b 4, HG 4).
//   * cum is a warp scan over L (one warp a head): each lane scans a
//     segment of consecutive steps, and the segment sums are scanned with
//     shuffles. A padded step (dt = 0) has decay 1 and contributes 0, as
//     in the plain version.
//   * y and states (1.5 MiB of the 1.9 MB a chunk moves) leave through a
//     per-warp shared-memory slab as coalesced 16-byte stores.
//   * The kernel launches on the caller's stream and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;        // heads a block may take
constexpr int kTargetBlocks = 132;  // one for each SM
constexpr int kMaxSmem = 232448;    // dynamic shared memory a Hopper block may use

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one block, in bytes, for (L, hd, ds, heads, element size).
struct Layout {
  int dsp;      // ds padded to the MMA depth
  int bc_ld;    // row of B and C, elements: +16 bytes (bf16) or +32 (f32)
  int x_ld;     // row of x (hg heads), elements: +16 bytes
  int slab_ld;  // row of a warp's output slab, floats
  int c, b, x, cum, dt, w, total;
  __host__ __device__ Layout(int L, int hd, int ds, int hg, int elem) {
    dsp = round_up(ds, 16);
    bc_ld = dsp + 8;
    x_ld = hg * hd + 16 / elem;
    slab_ld = hd + 8;
    const int c_bytes = L * bc_ld * elem;
    const int slab_bytes = kWarps * 16 * slab_ld * 4;
    c = 0;                                  // C, then the warps' output slabs
    b = round_up(c_bytes > slab_bytes ? c_bytes : slab_bytes, 16);
    x = b + round_up(L * bc_ld * elem, 16);
    cum = x + round_up(L * x_ld * elem, 16);
    dt = cum + hg * L * 4;
    w = dt + hg * L * 4;
    total = w + hg * L * 4;
  }
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two neighbouring elements (4- or 8-byte aligned) as floats
__device__ __forceinline__ void pair(const __nv_bfloat16* p, float& x, float& y) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x = f.x;
  y = f.y;
}
__device__ __forceinline__ void pair(const float* p, float& x, float& y) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  x = f.x;
  y = f.y;
}

// Fragments of mma.m16n8k16 (g = lane / 4, c = lane % 4), as floats in
// register order. A (16 x 16): (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..),
// (g+8, 2c+8..). B (16 x 8): (2c..2c+1, g), (2c+8..2c+9, g).
// A from an [m][k] array.
template <typename T>
__device__ __forceinline__ void frag_a_mk(const T* p, int ld, int lane, float (&v)[8]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  pair(p + g * ld + c, v[0], v[1]);
  pair(p + (g + 8) * ld + c, v[2], v[3]);
  pair(p + g * ld + c + 8, v[4], v[5]);
  pair(p + (g + 8) * ld + c + 8, v[6], v[7]);
}
// A from a [k][m] array.
template <typename T>
__device__ __forceinline__ void frag_a_km(const T* p, int ld, int lane, float (&v)[8]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {             // k + 0, k + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {           // m + 0, m + 8
      v[4 * h + 2 * r] = to_f32<T>(p[(c + 8 * h) * ld + g + 8 * r]);
      v[4 * h + 2 * r + 1] = to_f32<T>(p[(c + 8 * h + 1) * ld + g + 8 * r]);
    }
  }
}
// B from an [n][k] array.
template <typename T>
__device__ __forceinline__ void frag_b_nk(const T* p, int ld, int lane, float (&v)[4]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  pair(p + g * ld + c, v[0], v[1]);
  pair(p + g * ld + c + 8, v[2], v[3]);
}
// B from a [k][n] array.
template <typename T>
__device__ __forceinline__ void frag_b_kn(const T* p, int ld, int lane, float (&v)[4]) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  v[0] = to_f32<T>(p[c * ld + g]);
  v[1] = to_f32<T>(p[(c + 1) * ld + g]);
  v[2] = to_f32<T>(p[(c + 8) * ld + g]);
  v[3] = to_f32<T>(p[(c + 9) * ld + g]);
}

// x as NP bf16 parts, largest first (NP 1: x must be a bf16 value)
template <int NP>
__device__ __forceinline__ void parts(float x, __nv_bfloat16 (&out)[NP]) {
  float r = x;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    out[p] = __float2bfloat16_rn(r);
    r -= __bfloat162float(out[p]);
  }
}

// N floats in register order -> NP packed bf16x2 fragments
template <int NP, int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&f)[NP][N / 2]) {
#pragma unroll
  for (int r = 0; r < N / 2; ++r) {
    __nv_bfloat16 lo[NP], hi[NP];
    parts<NP>(v[2 * r], lo);
    parts<NP>(v[2 * r + 1], hi);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      f[p][r] = (uint32_t)__bfloat16_as_ushort(lo[p]) |
                ((uint32_t)__bfloat16_as_ushort(hi[p]) << 16);
  }
}

// Four 8 x 8 bf16 matrices from shared memory (lane l gives row l % 8 of
// matrix l / 8), as mma fragments; TRANS transposes each.
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// The NP parts of an A fragment from an [m][k] array: ldmatrix for bf16,
// split floats for f32.
template <typename T, int NP>
__device__ __forceinline__ void load_a_mk(const T* p, int ld, int lane, uint32_t (&f)[NP][4]) {
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    ldsm4<false>(f[0], p + ((mi & 1) * 8 + r) * ld + (mi >> 1) * 8);
  } else {
    float v[8];
    frag_a_mk(p, ld, lane, v);
    split<NP>(v, f);
  }
}
// The parts of the B fragments of n-tiles n and n + 8 from an [n][k]
// array (KN false) or a [k][n] array (KN true).
template <typename T, int NP, bool KN>
__device__ __forceinline__ void load_b2(const T* p, int ld, int lane, uint32_t (&f0)[NP][2],
                                        uint32_t (&f1)[NP][2]) {
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    uint32_t q[4];
    if (KN)
      ldsm4<true>(q, p + ((mi & 1) * 8 + r) * ld + (mi >> 1) * 8);
    else
      ldsm4<false>(q, p + ((mi >> 1) * 8 + r) * ld + (mi & 1) * 8);
    f0[0][0] = q[0];
    f0[0][1] = q[1];
    f1[0][0] = q[2];
    f1[0][1] = q[3];
  } else {
    float v[4];
    if (KN) frag_b_kn(p, ld, lane, v); else frag_b_nk(p, ld, lane, v);
    split<NP>(v, f0);
    if (KN) frag_b_kn(p + 8, ld, lane, v); else frag_b_nk(p + 8 * ld, ld, lane, v);
    split<NP>(v, f1);
  }
}
// An A fragment from a [k][m] array, as floats in register order.
template <typename T>
__device__ __forceinline__ void load_a_km(const T* p, int ld, int lane, float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    uint32_t q[4];
    ldsm4<true>(q, p + ((mi >> 1) * 8 + r) * ld + (mi & 1) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(q[i] << 16);
      v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
    }
  } else {
    frag_a_km(p, ld, lane, v);
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B over the parts whose orders sum to less than max(NA, NB),
// smallest first
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float (&d)[4], const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
  constexpr int N = NA > NB ? NA : NB;
#pragma unroll
  for (int s = N - 1; s >= 0; --s) {
#pragma unroll
    for (int ia = 0; ia < NA; ++ia) {
      const int ib = s - ia;
      if (ib >= 0 && ib < NB) mma(d, a[ia], b[ib]);
    }
  }
}

// rows x row_bytes from global (rows src_ld bytes apart) into shared memory
// (dst_ld bytes apart), gran bytes a copy; cp.async for 16, 8 and 4
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_ld,
                                           const unsigned char* src, size_t src_ld,
                                           int rows, int row_bytes, int gran) {
  const int per_row = row_bytes / gran;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int off = (i - r * per_row) * gran;
    unsigned char* d = dst + r * dst_ld + off;
    const unsigned char* s = src + r * src_ld + off;
    const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d));
    if (gran == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd), "l"(s));
    else if (gran == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sd), "l"(s));
    else if (gran == 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sd), "l"(s));
    else
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
  }
}

// The warp's 16 x (8 NTW) float tile acc (n-tiles of 8) through its slab
// to rows dst + r * dst_ld (floats) for r < rows, as 16-byte stores.
template <int NTW>
__device__ __forceinline__ void store_tile(const float (&acc)[NTW][4], float* slab,
                                           int slab_ld, float* dst, size_t dst_ld,
                                           int rows, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    *reinterpret_cast<float2*>(slab + g * slab_ld + nt * 8 + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(slab + (g + 8) * slab_ld + nt * 8 + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  constexpr int kQuads = NTW * 2;           // float4s a row
#pragma unroll
  for (int i = lane; i < 16 * kQuads; i += 32) {
    const int r = i / kQuads;
    const int q = i - r * kQuads;
    if (r < rows)
      *reinterpret_cast<float4*>(dst + r * dst_ld + q * 4) =
          *reinterpret_cast<const float4*>(slab + r * slab_ld + q * 4);
  }
  __syncwarp();
}

// One block: HG heads h0 + [0, HG) of one (batch, chunk).
template <typename T, int L, int HD>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ xs, const float* __restrict__ dt_g,
                 const float* __restrict__ a_g, const T* __restrict__ B_g,
                 const T* __restrict__ C_g, float* __restrict__ y_g,
                 float* __restrict__ state_g, float* __restrict__ total_g, int nc,
                 int nh, int ds, int a_ld, int hg, int gran_bc, int gran_x) {
  constexpr int NP = sizeof(T) == 2 ? 1 : 3;   // parts of an input operand
  constexpr int RT = L / 16;                   // 16-row tiles of the chunk
  constexpr int NT = L / 8;                    // 8-column tiles of C B^T
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(L, HD, ds, hg, (int)sizeof(T));
  T* sC = reinterpret_cast<T*>(smem + lay.c);
  float* sSlab = reinterpret_cast<float*>(smem + lay.c);  // once C B^T is formed
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  T* sX = reinterpret_cast<T*>(smem + lay.x);
  float* sCum = reinterpret_cast<float*>(smem + lay.cum);
  float* sDt = reinterpret_cast<float*>(smem + lay.dt);
  float* sW = reinterpret_cast<float*>(smem + lay.w);
  const int dsp = lay.dsp, bc_ld = lay.bc_ld, x_ld = lay.x_ld;

  const int h0 = blockIdx.x * hg;
  const size_t bc = blockIdx.y;  // batch * nc + chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int E = (int)sizeof(T);

  // -- stage B, C and the heads' x in their dtype, dt ------------------------
  stage_rows(reinterpret_cast<unsigned char*>(sB), bc_ld * E,
             reinterpret_cast<const unsigned char*>(B_g + bc * L * ds), (size_t)ds * E, L,
             ds * E, gran_bc);
  stage_rows(reinterpret_cast<unsigned char*>(sC), bc_ld * E,
             reinterpret_cast<const unsigned char*>(C_g + bc * L * ds), (size_t)ds * E, L,
             ds * E, gran_bc);
  stage_rows(reinterpret_cast<unsigned char*>(sX), x_ld * E,
             reinterpret_cast<const unsigned char*>(xs + (bc * L * nh + h0) * HD),
             (size_t)nh * HD * E, L, hg * HD * E, gran_x);
  asm volatile("cp.async.commit_group;\n" ::);
  if (dsp > ds) {                           // the MMA depth's zero padding
    for (int i = threadIdx.x; i < L * (dsp - ds); i += kThreads) {
      const int j = i / (dsp - ds), k = ds + i % (dsp - ds);
      sB[j * bc_ld + k] = T(0.f);
      sC[j * bc_ld + k] = T(0.f);
    }
  }
  for (int i = threadIdx.x; i < hg * L; i += kThreads) {
    const int hh = i / L, j = i - hh * L;
    sDt[i] = dt_g[(bc * L + j) * nh + h0 + hh];
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // -- cum and w = exp(cum_L - cum) dt: a warp scan a head --------------------
  for (int hh = warp; hh < hg; hh += kWarps) {
    constexpr int kPer = (L + 31) / 32;
    const float a = a_g[(bc / nc) * a_ld + h0 + hh];
    const float* dt = sDt + hh * L;
    float* cum = sCum + hh * L;
    float seg[kPer];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = lane * kPer + i;
      run += j < L ? dt[j] * a : 0.f;
      seg[i] = run;
    }
    float incl = run;  // inclusive scan of the segment sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float before = incl - run;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = lane * kPer + i;
      if (j < L) cum[j] = before + seg[i];
    }
    __syncwarp();
    const float total = cum[L - 1];
    for (int j = lane; j < L; j += 32) sW[hh * L + j] = expf(total - cum[j]) * dt[j];
    if (lane == 0) total_g[bc * nh + h0 + hh] = total;
  }

  // -- G = C B^T for the warp's 16 rows, on and below the diagonal block ------
  float gacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[nt][e] = 0.f;
  if (warp < RT) {
    for (int k0 = 0; k0 < dsp; k0 += 16) {
      uint32_t af[NP][4];
      load_a_mk<T, NP>(sC + warp * 16 * bc_ld + k0, bc_ld, lane, af);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        if (nt > 2 * warp) continue;
        uint32_t bf0[NP][2], bf1[NP][2];
        load_b2<T, NP, false>(sB + nt * 8 * bc_ld + k0, bc_ld, lane, bf0, bf1);
        mma_parts<NP, NP>(gacc[nt], af, bf0);
        mma_parts<NP, NP>(gacc[nt + 1], af, bf1);
      }
    }
  }
  __syncthreads();  // sC is read no more: its region holds the slabs, cum is done

  float* slab = sSlab + warp * 16 * lay.slab_ld;
  const int g = lane >> 2, c = (lane & 3) * 2;
  for (int hh = 0; hh < hg; ++hh) {
    const int h = h0 + hh;
    const float* cum = sCum + hh * L;
    const float* dt = sDt + hh * L;
    const float* w = sW + hh * L;
    const T* xh = sX + hh * HD;

    // -- y = S x for the warp's rows; S from G in registers --------------------
    if (warp < RT) {
      const int i0 = warp * 16 + g;
      const float ci0 = cum[i0], ci1 = cum[i0 + 8];
      float yacc[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < RT; ++ks) {
        if (ks > warp) continue;
        // the A fragment of S's columns 16 ks + [0, 16): n-tiles 2 ks and
        // 2 ks + 1 of G, in register order
        float sv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = i0 + ((e >> 1) & 1) * 8;
          const int j = ks * 16 + c + (e & 1) + (e >> 2) * 8;
          const float gv = gacc[2 * ks + (e >> 2)][e & 3];
          sv[e] = i >= j ? expf((i == i0 ? ci0 : ci1) - cum[j]) * gv * dt[j] : 0.f;
        }
        uint32_t af[3][4];
        split<3>(sv, af);
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t bf0[NP][2], bf1[NP][2];
          load_b2<T, NP, true>(xh + ks * 16 * x_ld + nt * 8, x_ld, lane, bf0, bf1);
          mma_parts<3, NP>(yacc[nt], af, bf0);
          mma_parts<3, NP>(yacc[nt + 1], af, bf1);
        }
      }
      store_tile<HD / 8>(yacc, slab, lay.slab_ld,
                         y_g + ((bc * L + warp * 16) * nh + h) * HD, (size_t)nh * HD, 16,
                         lane);
    }

    // -- state = (w B)^T x: 16-row tiles of the ds rows, round robin ----------
    float* st = state_g + (bc * nh + h) * (size_t)ds * HD;
    for (int mt = warp; mt < dsp / 16; mt += kWarps) {
      float sacc[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < RT; ++ks) {
        float av[8];
        load_a_km(sB + ks * 16 * bc_ld + mt * 16, bc_ld, lane, av);
#pragma unroll
        for (int e = 0; e < 8; ++e) av[e] *= w[ks * 16 + c + (e & 1) + (e >> 2) * 8];
        uint32_t af[3][4];
        split<3>(av, af);
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t bf0[NP][2], bf1[NP][2];
          load_b2<T, NP, true>(xh + ks * 16 * x_ld + nt * 8, x_ld, lane, bf0, bf1);
          mma_parts<3, NP>(sacc[nt], af, bf0);
          mma_parts<3, NP>(sacc[nt + 1], af, bf1);
        }
      }
      store_tile<HD / 8>(sacc, slab, lay.slab_ld, st + (size_t)mt * 16 * HD, HD,
                         min(16, ds - mt * 16), lane);
    }
  }
}

// Heads a block takes: the largest divisor of nh up to kMaxGroup that still
// gives kTargetBlocks blocks and fits the shared memory.
int group(int L, int hd, int ds, int elem, int bnc, int nh) {
  int best = 1;
  for (int hg = 2; hg <= kMaxGroup && hg <= nh; ++hg) {
    if (nh % hg != 0 || (long long)bnc * (nh / hg) < kTargetBlocks) continue;
    if (Layout(L, hd, ds, hg, elem).total > kMaxSmem) continue;
    best = hg;
  }
  return best;
}

// the widest copy (16, 8, 4 or 2 bytes) that divides the address and the
// row pitch
int granule(const void* p, long long pitch) {
  const long long a = (long long)reinterpret_cast<uintptr_t>(p) | pitch;
  for (int g = 16; g > 2; g >>= 1)
    if (a % g == 0) return g;
  return 2;
}

template <typename T, int L, int HD>
int launch(const void* xs, const float* dt, const float* a, const void* B, const void* C,
           float* y, float* states, float* totals, int b, int nc, int nh, int ds,
           int a_ld, cudaStream_t stream) {
  constexpr int E = (int)sizeof(T);
  const int hg = group(L, HD, ds, E, b * nc, nh);
  const Layout lay(L, HD, ds, hg, E);
  const int gran_bc = granule(B, (long long)ds * E) < granule(C, (long long)ds * E)
                          ? granule(B, (long long)ds * E)
                          : granule(C, (long long)ds * E);
  const int gran_x = granule(xs, (long long)HD * E);
  auto kern = ssd_chunk_kernel<T, L, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh / hg, b * nc);
  kern<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(xs), dt, a, static_cast<const T*>(B), static_cast<const T*>(C),
      y, states, totals, nc, nh, ds, a_ld, hg, gran_bc, gran_x);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int dispatch_hd(int hd, const void* xs, const float* dt, const float* a,
                const void* B, const void* C, float* y, float* states,
                float* totals, int b, int nc, int nh, int ds, int a_ld,
               cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, L, 32>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    case 64: return launch<T, L, 64>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    case 128: return launch<T, L, 128>(xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    default: return -1;
  }
}

template <typename T>
int dispatch_l(int L, int hd, const void* xs, const float* dt, const float* a,
               const void* B, const void* C, float* y, float* states,
               float* totals, int b, int nc, int nh, int ds, int a_ld,
               cudaStream_t s) {
  switch (L) {
    case 16: return dispatch_hd<T, 16>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    case 32: return dispatch_hd<T, 32>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    case 64: return dispatch_hd<T, 64>(hd, xs, dt, a, B, C, y, states, totals, b, nc, nh, ds, a_ld, s);
    default: return -1;
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch needs at least (one head a
// block; the wrapper checks them against the card's limit before
// launching). x_dtype: 0 = float32, 1 = bfloat16.
extern "C" long long ssd_chunk_smem_bytes(int L, int ds, int hd, int x_dtype) {
  return (long long)Layout(L, hd, ds, 1, x_dtype == 1 ? 2 : 4).total;
}

// dtype code of xs, B and C: 0 = float32, 1 = bfloat16; dt and a are
// float32, a_ld is 0 for a (nh,) and nh for a (b, nh). L in {16, 32, 64};
// hd in {32, 64, 128}; ds a multiple of 4. Every tensor is contiguous; y
// and states 16-byte aligned. Returns 0, a cudaError_t from the launch, or
// -1 for an unsupported configuration.
extern "C" int ssd_chunk_launch(const void* xs, const void* dt, const void* a,
                                const void* B, const void* C, void* y, void* states,
                                void* totals, int x_dtype, int b, int nc, int L,
                                int nh, int hd, int ds, int a_ld, void* stream) {
  if (ds <= 0 || ds % 4 != 0 || b <= 0 || nc <= 0 || nh <= 0) return -1;
  if (a_ld != 0 && a_ld != nh) return -1;
  if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(states) % 16)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* tf = static_cast<float*>(totals);
  if (x_dtype == 0)
    return dispatch_l<float>(L, hd, xs, dtf, af, B, C, yf, sf, tf, b, nc, nh, ds, a_ld,
                              s);
  if (x_dtype == 1)
    return dispatch_l<__nv_bfloat16>(L, hd, xs, dtf, af, B, C, yf, sf, tf, b, nc, nh,
                                      ds, a_ld, s);
  return -1;
}
