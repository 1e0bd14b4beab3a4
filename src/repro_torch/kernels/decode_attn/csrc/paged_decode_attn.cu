// Paged single-token GQA flash-decode attention for Hopper (sm_90a), in
// one launch.
//
// Replaces the Pallas TPU kernel `paged_decode_attn` in
// src/repro/kernels/decode_attn/paged.py:92 (body `_paged_decode_kernel`,
// :43). It computes the same function, not the same schedule:
//   q (b, kv, g, hd) and the K/V pools (n_pool, bs, kv, hd), each in
//   float32 or bfloat16 (any pair), block_table (b, n_blk) int32, index
//   (b,) int32 -> out (b, kv, g, hd) in q's type; 1 <= g <= 8, hd a
//   multiple of 16 up to 256.
//   q is scaled by hd^-0.5 in float32; scores, softmax and the V sum run in
//   float32. Linear layers keep slot <= index; ring layers keep
//   ((index - slot) mod R) < min(window, index + 1) with R = n_blk * bs.
//   Running max starts at -1e30, the exponent is taken against
//   m_safe = max(m, -0.5e30) and the denominator is floored at 1e-30, so a
//   row whose slots are all invalid gives finite output (0).
//
// Bound. A decode step reads q, the K and V rows of the valid slots once
// each, the table and the index, and writes the output once. With kv = 1,
// g = 4, hd = 256 that is 1 KiB of K+V (bf16) per valid token against
// 8 * g * hd = 8 KiFLOP, about 8 FLOP per byte: far below the card's
// ridge, so the bound is the bytes over the memory rate (0.0005 ms for
// the serve run's 4 x 512 tokens). Launch latency and the latency of a
// few dependent memory trips are what a call costs at that size.
//
// Design against that:
//   * One launch. The table is split across CUDA blocks (grid.x = splits
//     of kStage-token tiles, grid.y = b * kv): one block per (request, kv
//     head) would fill a handful of the 132 SMs. The splits of a row form
//     one thread block cluster (up to 16 blocks, H100's non-portable
//     limit). Each block merges its warps and keeps its partial (m, l,
//     acc) in its own shared memory; after a cluster barrier every block
//     reads all the row's (m, l) and merges its own slice of the output
//     from every block's acc through distributed shared memory, and a
//     second barrier keeps each block's memory alive until its peers have
//     read it. No scratch in device memory, no counters, no second
//     kernel: the launch is capturable in a CUDA graph and safe on any
//     number of streams.
//   * Memory-level parallelism. A block reads its slice of the block table
//     into shared memory once, then puts every valid token's K and V rows
//     of a 32-token tile in flight at once with 16-byte cp.async copies
//     into a shared-memory stage (two stages: the next tile's copies fly
//     while this one is computed), instead of one dependent global load
//     per token per warp. The dot products then read shared memory.
//   * Work follows validity. A split with no valid slot (past index on a
//     linear layer, outside the window on a ring) loads nothing and is
//     skipped by the merge; within a split, invalid slots are never copied.
//   * Lanes (decode_common.cuh, shared with decode_attn.cu, as are the
//     two merges): a warp takes four slots of a stage at once (their dot
//     products and shuffles independent, one online-softmax update for
//     the four; exponents by the fast __expf); lane l holds the elements
//     (j * 32 + l) * CE + [0, CE) for j < J of q (g rows) and of the
//     slots' K/V rows. Fast paths fix (G, CE, J) to the configs' shapes
//     (gemma3-1b: g 4, hd 256 = 32 x 8; stablelm-1.6b: g 1, hd 64 =
//     32 x 2); the generic path (G = 8, CE = 2, J = 4) masks lanes past hd
//     and heads past g, for any hd that is a multiple of 16 up to 256 (80)
//     and any g up to 8 (7).
//   * The kernel launches on the caller's stream and allocates nothing.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kStage = 32;        // tokens per shared-memory stage
constexpr int kTableCap = 1024;   // table entries one split may span
static_assert(kStage == kWarps * kTPW, "a stage is one slot for each lane of a warp");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* table;
  const int* index;
  void* out;
  int kv, g, hd, bs, n_blk, per_split, ring, window;
  float scale;
};

__device__ __forceinline__ bool slot_valid(int t, int idx, int ring, int lim) {
  if (ring <= 0) return t <= idx;
  // C++ % truncates toward zero: fold the age into [0, ring)
  const int age = ((idx - t) % ring + ring) % ring;
  return age < lim;
}

// Whether any slot of [lo, hi) is valid: linear, lo <= index; ring, the
// smallest age over the range is below the limit.
__device__ __forceinline__ bool split_has_work(int lo, int hi, int idx, int ring,
                                               int lim) {
  if (lo >= hi) return false;
  if (ring <= 0) return lo <= idx;
  const int im = (idx % ring + ring) % ring;
  const int min_age = im >= hi ? im - (hi - 1) : im >= lo ? 0 : im - (hi - 1) + ring;
  return min_age < lim;
}

// One block: one (request, kv head) row and one split of its table. FIXED:
// g == G and hd == 32 * CE * J, known at compile time (a fast path).
template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Params p) {
  constexpr int E = CE * J;                 // elements a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sm_tab[kTableCap];
  __shared__ long long sm_row[2][kStage];   // a stage's K/V rows, -1: invalid
  __shared__ MergeSmem<G, E> sm;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bk = blockIdx.y;  // request * kv + kv head
  const int bi = bk / p.kv;
  const int kh = bk - bi * p.kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = FIXED ? G : p.g;
  const int hd = FIXED ? 32 * E : p.hd;
  const int bs = p.bs;
  const int S = p.n_blk * bs;
  const int lo = split * p.per_split;
  const int hi = min(lo + p.per_split, S);
  const int row_bytes = hd * (int)sizeof(TKV);
  const int stage_bytes = kStage * 2 * row_bytes;

  // the table slice, the index and q do not depend on each other: their
  // loads go out together
  const int j0 = lo / bs;
  const int n_tab = (hi - 1) / bs - j0 + 1;
  for (int i = threadIdx.x; i < n_tab; i += kThreads)
    sm_tab[i] = p.table[(size_t)bi * p.n_blk + j0 + i];
  const int idx = p.index[bi];
  const int lim = p.ring > 0 ? min(p.window, idx + 1) : 0;

  if (split_has_work(lo, hi, idx, p.ring, lim)) {
    float qr[G][E];
    load_q<TQ, G, CE, J>(static_cast<const TQ*>(p.q) + (size_t)bk * g * hd, g, hd,
                         p.scale, lane, qr);

    __syncthreads();                        // sm_tab

    const unsigned char* kbase = static_cast<const unsigned char*>(p.k_pool);
    const unsigned char* vbase = static_cast<const unsigned char*>(p.v_pool);
    const int cpr = row_bytes / 16;         // 16-byte chunks per row
    // the pool row of each slot of tile st (-1: invalid), by one warp
    auto rows = [&](int st) {
      if (warp == 0) {
        const int t = lo + st * kStage + lane;
        long long row = -1;
        if (t < hi && slot_valid(t, idx, p.ring, lim))
          row = ((long long)sm_tab[t / bs - j0] * bs + (t % bs)) * p.kv + kh;
        sm_row[st & 1][lane] = row;
      }
    };
    // copies every valid slot's K and V rows of tile st into its stage
    auto issue = [&](int st) {
      unsigned char* dst0 = smem + (st & 1) * stage_bytes;
      for (int c = threadIdx.x; c < kStage * 2 * cpr; c += kThreads) {
        const int tok = c / (2 * cpr);
        const int rem = c - tok * 2 * cpr;
        const int which = rem >= cpr;       // 0: K, 1: V
        const int ch = rem - which * cpr;
        const long long row = sm_row[st & 1][tok];
        if (row >= 0) {
          const unsigned char* src = (which ? vbase : kbase) + row * row_bytes + ch * 16;
          cp_async16(dst0 + (tok * 2 + which) * row_bytes + ch * 16, src);
        }
      }
      cp_async_commit();
    };

    float m[G], l[G], acc[G][E];
    init_state<G, E>(m, l, acc);

    static_assert(kStage == 32, "one lane of warp 0 per slot of a tile");
    const int nst = (hi - lo + kStage - 1) / kStage;
    rows(0);
    __syncthreads();
    issue(0);
    for (int st = 0; st < nst; ++st) {
      if (st + 1 < nst) {
        rows(st + 1);
        __syncthreads();
        issue(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const unsigned char* buf = smem + (st & 1) * stage_bytes;
      // the warp's kTPW slots of the tile (an invalid slot's row was never
      // copied: attend4 masks it)
      bool ok[kTPW];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kTPW; ++u) {
        ok[u] = sm_row[st & 1][warp * kTPW + u] >= 0;
        any |= ok[u];
      }
      if (any)                              // warp-uniform
        attend4<TKV, G, CE, J>(qr, buf, buf + row_bytes, 2 * row_bytes, warp * kTPW,
                               ok, g, hd, lane, m, l, acc);
      __syncthreads();  // the stage is free for the next issue
    }

    // merge the warps: the stage area now holds (kWarps, g, hd) floats
    merge_warps<G, CE, J>(sm, reinterpret_cast<float*>(smem), m, l, acc, g, hd, warp,
                          lane);
  }
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    sm.work[s] = split_has_work(s * p.per_split, min((s + 1) * p.per_split, S), idx,
                                p.ring, lim);
  merge_cluster<TQ, G, E>(sm, static_cast<TQ*>(p.out) + (size_t)bk * g * hd, g, hd,
                          split, n_split, warp, lane);
}

template <typename TQ, typename TKV, int G, int CE, int J, bool FIXED>
int launch(const Params& p, int b, int n_split, cudaStream_t stream) {
  const int row_bytes = p.hd * (int)sizeof(TKV);
  const int stage = 2 * kStage * 2 * row_bytes;
  const int merge = kWarps * p.g * p.hd * (int)sizeof(float);
  const int smem = stage > merge ? stage : merge;
  auto kernel = paged_decode_kernel<TQ, TKV, G, CE, J, FIXED>;
  static int raised[64] = {};
  const int err = raise_limits(kernel, smem, raised);
  if (err != 0) return err;
  return launch_clusters(kernel, p, n_split, b * p.kv, smem, stream);
}

template <typename TQ, typename TKV>
int dispatch(const Params& p, int b, int n_split, cudaStream_t stream) {
  if (p.g == 4 && p.hd == 256) return launch<TQ, TKV, 4, 8, 1, true>(p, b, n_split, stream);
  if (p.g == 1 && p.hd == 64) return launch<TQ, TKV, 1, 2, 1, true>(p, b, n_split, stream);
  return launch<TQ, TKV, 8, 2, 4, false>(p, b, n_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, any (q, pool) pair. 1 <= g <= 8;
// hd a multiple of 16, 16 <= hd <= 256; per_split a multiple of 32 whose
// table span fits 1024 entries; 1 <= n_split <= 16 (the cluster) with
// n_split * per_split >= n_blk * bs. ring <= 0 selects the linear layout.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// configuration.
extern "C" int paged_decode_attn_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* index, void* out, int q_dtype, int kv_dtype, int b, int kv,
    int g, int hd, int bs, int n_blk, int per_split, int n_split, int ring,
    int window, float scale, void* stream) {
  if (g < 1 || g > 8 || hd < 16 || hd > 256 || hd % 16 != 0) return -1;
  if (b < 1 || kv < 1 || bs < 1 || n_blk < 1) return -1;
  if (per_split < 1 || per_split % kStage != 0 || n_split < 1 || n_split > kMaxSplits)
    return -1;
  if ((long long)n_split * per_split < (long long)n_blk * bs) return -1;
  if ((per_split + bs - 1) / bs + 1 > kTableCap) return -1;
  const Params p{q, k_pool, v_pool, static_cast<const int*>(table),
                 static_cast<const int*>(index), out, kv, g, hd, bs, n_blk,
                 per_split, ring, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 1 && kv_dtype == 0) return dispatch<__nv_bfloat16, float>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 1) return dispatch<float, __nv_bfloat16>(p, b, n_split, st);
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(p, b, n_split, st);
  return -1;
}
