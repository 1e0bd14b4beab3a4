// Single-token GQA flash-decode attention over a contiguous KV cache for
// Hopper (sm_90a), in one launch.
//
// Replaces the Pallas TPU kernel `decode_attn` in
// src/repro/kernels/decode_attn/decode_attn.py:78 (body `_decode_kernel`,
// :34). Same function, not the same schedule:
//   q (b, kv, g, hd) and k, v (b, S, kv, hd), each in float32 or bfloat16
//   (any pair), one cache_len for the whole batch -> out (b, kv, g, hd) in
//   q's type; 1 <= g <= 8, hd a multiple of 16 up to 256.
//   q is scaled by hd^-0.5 in float32; scores, softmax and the V sum run in
//   float32. Position t is valid iff t < cache_len and, with a window,
//   cache_len - 1 - t < window. Running max starts at -1e30, the exponent
//   is taken against m_safe = max(m, -0.5e30) and the denominator is
//   floored at 1e-30, as in the Pallas kernel: a row without a valid
//   position (cache_len 0) gives 0.
//
// Bound. A decode step reads q, the K and V rows of the valid positions
// once each and writes the output once. gemma3-1b (kv 1, g 4, hd 256,
// bf16) reads 1 KiB of K+V per valid token for 8 * g * hd = 8 KiFLOP: 8
// FLOP a byte, far below the card's ridge, so the bound is the bytes over
// the memory rate: 1 MiB (0.31 us) per request at a 512-token ring, 2 MiB
// (0.63 us) at a full 1024-token cache. At that size a call costs the
// launch and a chain of latencies, so the design cuts the chain.
//
// Design:
//   * One launch. The positions of a (request, kv head) row are split
//     across CUDA blocks (grid.x = splits, grid.y = b * kv), and the
//     splits of a row form one thread block cluster of at most 16 blocks
//     (H100's non-portable limit). Each block merges its warps; the
//     cluster merges its blocks through distributed shared memory
//     (decode_common.cuh, shared with paged_decode_attn.cu). No scratch in
//     device memory, no second kernel: the launch is capturable in a CUDA
//     graph and safe on any number of streams.
//   * One memory latency per split. A block clips its range to the valid
//     positions first, [max(lo, cache_len - window), min(hi, cache_len,
//     S)), then puts every valid K and V row of it in flight at once with
//     Hopper bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes)
//     that complete on one mbarrier: with kv = 1 a split's rows are one
//     contiguous span, one copy for K and one for V (the mbarrier's
//     transaction count takes up to 2^20 - 1 bytes, more than any stage,
//     so no copy is cut); with kv > 1 the lanes of one warp issue one copy
//     per row of hd * elem bytes. No tensor map and no driver call. q is
//     loaded while the copies fly.
//   * The stage. The split plan (decode_attn.py) gives at most 16 splits
//     and at least 8 positions a split: at the legacy engine's b 4, kv 1
//     that is 16 splits of 32 positions (512-position ring, 32 KiB a block
//     in bf16) or of 64 (1024-position global layer, 64 KiB a block). The
//     stage holds the whole split while its K and V rows fit 128 KiB (bf16
//     hd 256: 128 positions; f32: 64); a longer split (a large batch,
//     whose rows already fill the card, or a long cache) falls back to a
//     ring of two stages of half that (a multiple of 32 positions each),
//     the next stage's copies in flight while this one is computed.
//   * A split wholly outside the valid range loads nothing and the
//     cluster merge selects it away.
//   * Lanes: a warp takes four positions at once (independent dot products
//     and shuffles, one online-softmax update for the four); lane l holds
//     the elements (j * 32 + l) * CE + [0, CE) for j < J. Fast paths fix
//     (G, CE, J) to the configs' shapes (gemma3-1b: g 4, hd 256 = 32 x 8;
//     stablelm-1.6b: g 1, hd 64 = 32 x 2); the generic path (G = 8, CE =
//     2, J = 4) masks lanes past hd and heads past g, for any hd that is a
//     multiple of 16 up to 256 (80) and any g up to 8 (7).
//   * cache_len comes as a kernel argument (the legacy engine knows it on
//     the host: no device-to-host read per step), or from device memory
//     when the caller gives a device scalar.
//   * The kernel launches on the caller's stream and allocates nothing.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kStageBudget = 128 * 1024;  // bytes of K+V rows in flight a block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* len_dev;
  void* out;
  int kv, g, hd, S, per_split, len_host, window;
  int stage_tok, n_stage;   // positions a stage holds, stages (1 or 2)
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes from global to this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One block: one (request, kv head) row and one split of its positions.
// FIXED: g == G and hd == 32 * CE * J, known at compile time (a fast path).
template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const Params p) {
  constexpr int E = CE * J;                 // elements a lane holds
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ MergeSmem<G, E> sm;
  __shared__ __align__(8) uint64_t bar[2];  // one a stage

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.y;  // request * kv + kv head
  const int bi = bk / p.kv;
  const int kh = bk - bi * p.kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = FIXED ? G : p.g;
  const int hd = FIXED ? 32 * E : p.hd;

  // the valid positions [start, end), and this split's part of them
  const int cache_len = p.len_dev != nullptr ? *p.len_dev : p.len_host;
  const int end = min(cache_len, p.S);
  const int start = p.window > 0 ? cache_len - p.window : 0;
  const int lo = max(split * p.per_split, start);
  const int hi = min((split + 1) * p.per_split, end);

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (lo < hi) {
    const int row_bytes = hd * (int)sizeof(TKV);
    const int T = p.stage_tok;
    const int NS = p.n_stage;
    const int n_tile = (hi - lo + T - 1) / T;
    const size_t stage_bytes = (size_t)2 * T * row_bytes;   // K rows, then V rows
    const unsigned char* kb = static_cast<const unsigned char*>(p.k);
    const unsigned char* vb = static_cast<const unsigned char*>(p.v);
    // every row of tile `tile` in flight, by warp 0
    auto issue = [&](int tile) {
      const int t0 = lo + tile * T;
      const int cnt = min(T, hi - t0);
      unsigned char* kdst = smem + (tile % NS) * stage_bytes;
      unsigned char* vdst = kdst + (size_t)T * row_bytes;
      uint64_t* b = &bar[tile % NS];
      if (lane == 0) mbar_expect_tx(b, 2u * cnt * row_bytes);
      __syncwarp();
      const size_t row0 = ((size_t)bi * p.S + t0) * p.kv + kh;
      if (p.kv == 1) {
        if (lane == 0) bulk_copy(kdst, kb + row0 * row_bytes, cnt * row_bytes, b);
        if (lane == 1) bulk_copy(vdst, vb + row0 * row_bytes, cnt * row_bytes, b);
      } else {
        for (int r = lane; r < cnt; r += 32) {
          const size_t off = (row0 + (size_t)r * p.kv) * row_bytes;
          bulk_copy(kdst + (size_t)r * row_bytes, kb + off, row_bytes, b);
          bulk_copy(vdst + (size_t)r * row_bytes, vb + off, row_bytes, b);
        }
      }
    };
    if (warp == 0)
      for (int t = 0; t < NS && t < n_tile; ++t) issue(t);

    float qr[G][E];
    load_q<TQ, G, CE, J>(static_cast<const TQ*>(p.q) + (size_t)bk * g * hd, g, hd,
                         p.scale, lane, qr);
    float m[G], l[G], acc[G][E];
    init_state<G, E>(m, l, acc);

    for (int tile = 0; tile < n_tile; ++tile) {
      const int cnt = min(T, hi - lo - tile * T);
      const unsigned char* kbuf = smem + (tile % NS) * stage_bytes;
      mbar_wait(&bar[tile % NS], (tile / NS) & 1);
      for (int base = warp * kTPW; base < cnt; base += kWarps * kTPW) {
        bool ok[kTPW];
#pragma unroll
        for (int u = 0; u < kTPW; ++u) ok[u] = base + u < cnt;
        attend4<TKV, G, CE, J>(qr, kbuf, kbuf + (size_t)T * row_bytes, row_bytes, base,
                               ok, g, hd, lane, m, l, acc);
      }
      if (tile + NS < n_tile) {
        __syncthreads();                    // every warp is done with the stage
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (warp == 0) issue(tile + NS);
      }
    }
    __syncthreads();  // the stages are free: the warps' merge reuses them
    merge_warps<G, CE, J>(sm, reinterpret_cast<float*>(smem), m, l, acc, g, hd, warp,
                          lane);
  }
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    sm.work[s] = max(s * p.per_split, start) < min((s + 1) * p.per_split, end);
  merge_cluster<TQ, G, E>(sm, static_cast<TQ*>(p.out) + (size_t)bk * g * hd, g, hd,
                          split, n_split, warp, lane);
}

template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
int launch(Params p, int b, int n_split, cudaStream_t stream) {
  const int row_bytes = p.hd * (int)sizeof(TKV);
  if (2LL * p.per_split * row_bytes <= kStageBudget) {
    p.stage_tok = p.per_split;              // the whole split in flight
    p.n_stage = 1;
  } else {
    p.stage_tok = kStageBudget / (4 * row_bytes) / 32 * 32;
    p.n_stage = 2;
  }
  const int stage = p.n_stage * 2 * p.stage_tok * row_bytes;
  const int merge = kWarps * p.g * p.hd * (int)sizeof(float);
  const int smem = stage > merge ? stage : merge;
  auto kernel = decode_attn_kernel<TQ, TKV, G, CE, J, FIXED>;
  static int raised[64] = {};
  const int err = raise_limits(kernel, smem, raised);
  if (err != 0) return err;
  return launch_clusters(kernel, p, n_split, b * p.kv, smem, stream);
}

// fast paths for the configs' shapes, the generic path for the rest
template <typename TQ, typename TKV>
int dispatch(const Params& p, int b, int n_split, cudaStream_t stream) {
  if (p.g == 4 && p.hd == 256) return launch<TQ, TKV, 4, 8, 1, true>(p, b, n_split, stream);
  if (p.g == 1 && p.hd == 64) return launch<TQ, TKV, 1, 2, 1, true>(p, b, n_split, stream);
  return launch<TQ, TKV, 8, 2, 4, false>(p, b, n_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, any (q, cache) pair. 1 <= g <= 8;
// hd a multiple of 16, 16 <= hd <= 256; k and v 16-byte aligned;
// 1 <= n_split <= 16 (the cluster) and n_split * per_split >= S.
// len_dev, when not null, points at an int32 cache_len in device memory
// and len_host is ignored. window <= 0 means no window. Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported configuration.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* len_dev, void* out, int q_dtype,
                                  int kv_dtype, int b, int kv, int g, int hd, int S,
                                  int per_split, int n_split, int len_host, int window,
                                  float scale, void* stream) {
  if (b < 1 || kv < 1 || S < 1 || per_split < 1) return -1;
  if (n_split < 1 || n_split > kMaxSplits || (long long)n_split * per_split < S) return -1;
  if (g < 1 || g > 8 || hd < 16 || hd > 256 || hd % 16 != 0) return -1;
  const Params p{q, k, v, static_cast<const int*>(len_dev), out, kv, g, hd, S,
                 per_split, len_host, window, 0, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 1 && kv_dtype == 0) return dispatch<__nv_bfloat16, float>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 1) return dispatch<float, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(p, b, n_split, st);
  return -1;
}
