// rank_flags: the rulebook builders' merge-join rank, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_rank_kernel_seq` (via
// `merge_rank_flags` / `_merge_rank_flags_impl`, EFG_RANK_IMPL=seq, the
// default). The other two Pallas kernels of the same contract have their
// own Hopper kernels: `_rank_kernel_seq4` → rank_flags_seq4.cu and
// `_rank_kernel` (seq=False) → rank_flags_hostwin.cu.
//
// Contract: keys [Vk] int32 ascending (entries >= INVALID_Q are padding),
// queries [n] int32 (each rule row non-decreasing; >= INVALID_Q is padding).
// Keys are clamped to CLAMP_Q and padding queries set to CLAMP_Q, then
//   out[i] = count(keys_c < q_c)·8 + (q_c−1 ∈ keys_c)·4 + (q_c ∈ keys_c)·2
//            + (q_c+1 ∈ keys_c).
// Valid keys are distinct, so the three membership probes sit at pos−1,
// pos and pos + (q ∈ keys), where pos is the lower bound of q_c.
//
// What bounds it on the H100: bytes. Each query is read once and each
// result written once (8 bytes per query), the keys once (4 bytes each, 1.9
// MB at bs=4 Waymo stage 0). The first design ran one independent
// lower_bound per query through L2: ⌈log2 Vk⌉ ≈ 19 dependent probes and
// three more for the flags, per query, although the queries of a rule row
// are monotone and neighbours end within a few keys of one another. Here a
// warp takes 128 consecutive queries (four a lane, lane l holding l,
// l + 32, ..., so that loads and stores coalesce) and shares the search:
// 1. One warp search (rank_walk.cuh `warp_lower_bounds`) brackets the
//    lower bounds of its smallest and largest valid query within 32 keys
//    (3 rounds up to 1.08M keys, one fewer than the exact search), and
//    finds CLAMP_Q's where it holds padding: every lower bound of the warp
//    lies in [the smallest's bracket's start, the largest's end]. The
//    rounds' probes of neighbouring warps coincide, so most are L1 hits.
// 2. Where that span (one key of halo either side) fits 256 keys, as it
//    does on SubM rulebooks (the queries are the keys shifted by a
//    constant), the warp copies it into its slice of shared memory in one
//    coalesced round trip, CLAMP_Q past it, and each lane finds its four
//    lower bounds there by branch-free halving (8 steps of a load and a
//    select, the four interleaved; the lanes' queries are consecutive, so
//    one step's 32 loads hit 32 banks or one broadcast) and reads fm, f0
//    and fp around them.
// 3. A wider span (a rule row ends and the next begins within the 128, a
//    strided conv's queries skip rows of keys) is searched lane by lane in
//    device memory, over the span only.
// 4. Padding queries take count(keys_c < CLAMP_Q) and its flags, without a
//    search of their own.
// No block barrier: many warps an SM keep many searches in flight. What
// the card taught (tools/port_kernel_sweep.py; PERF.md §6): the kernel is
// bound by the instructions that resolve the queries. A thread that walks
// its own consecutive queries one after another, a search per block of
// 2048 queries that idles its other warps, a window held in registers
// (each probe a shuffle of every register) and a branching binary search
// all ran slower than this; 128 queries a warp beat 64 and 256. One launch
// per call. No index outside [0, Vk) is read.

#include <climits>

#include "rank_walk.cuh"

namespace {

using rank_walk::kClampQ;
using rank_walk::kFull;
using rank_walk::kInvalidQ;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 4;               // queries of a lane: l, l + 32, ...
constexpr int kRun = 32 * kPerLane;       // consecutive queries of a warp
constexpr int kWindow = 256;              // keys of a warp's slice of shared memory
constexpr int kSlack = 32;                // keys the span search may leave unknown
static_assert((kWindow & (kWindow - 1)) == 0, "the window search halves a power of two");

__device__ __forceinline__ int clamp_query(int q) { return q >= kInvalidQ ? kClampQ : q; }

__global__ void __launch_bounds__(kThreads)
rank_flags_kernel(const int* __restrict__ keys, int vk, const int* __restrict__ queries,
                  long long n, int* __restrict__ out) {
  __shared__ int s_window[kWarps][kWindow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * kWarps + warp) * kRun;
  if (base >= n) return;  // the whole warp
  int* win = s_window[warp];

  int q[kPerLane];
  bool pad = false;
  int lo_q = INT_MAX, hi_q = INT_MIN;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const long long i = base + lane + 32 * e;
    const int raw = i < n ? __ldg(queries + i) : kInvalidQ;
    pad |= raw >= kInvalidQ && i < n;
    q[e] = clamp_query(raw);
    if (q[e] < kClampQ) lo_q = min(lo_q, q[e]), hi_q = max(hi_q, q[e]);
  }
  // 1. the lower bounds of the warp's smallest and largest valid query and
  // of CLAMP_Q, searched together
  lo_q = __reduce_min_sync(kFull, lo_q);
  hi_q = __reduce_max_sync(kFull, hi_q);
  const bool any_valid = lo_q <= hi_q, any_pad = __any_sync(kFull, pad);
  int tq[3] = {lo_q, hi_q, kClampQ}, lb[3] = {0, 0, 0};
  int ub[3] = {any_valid ? vk : 0, any_valid ? vk : 0, any_pad ? vk : 0};
  rank_walk::warp_lower_bounds<3>(keys, tq, lb, ub, kSlack);
  // every lower bound of the warp lies in [l0, l1]: the bracket of its
  // smallest query's from below, of its largest's from above
  const int l0 = lb[0], l1 = ub[1];
  if (any_pad && ub[2] > lb[2]) {  // CLAMP_Q's, exactly
    int tc[1] = {kClampQ}, lc[1] = {lb[2]}, uc[1] = {ub[2]};
    rank_walk::warp_lower_bounds<1>(keys, tc, lc, uc);
    lb[2] = lc[0];
  }

  int res[kPerLane];
  // 4. padding: the count of keys below CLAMP_Q; q + 1 is past every key
  const int below = lb[2];
  const int pad_fm = any_pad && below > 0 && rank_walk::key_at(keys, below - 1) == kClampQ - 1;
  const int pad_out = below * 8 + pad_fm * 4 + (any_pad && below < vk) * 2;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) res[e] = pad_out;

  const int hi = min(l1, vk);  // the lower bounds lie in [l0, hi]
  if (any_valid && l1 - l0 <= kWindow - 3) {
    // 2. the window: keys [l0 − 1, l1 + 2) at positions [0, l1 − l0 + 3),
    // CLAMP_Q past them and past Vk (position 0 is read only where l0 > 0)
    const int w0 = l0 - 1, need = l1 - l0 + 3;
    for (int j = lane; j < kWindow; j += 32) {
      const int i = w0 + j;
      win[j] = j < need && i >= 0 && i < vk ? rank_walk::key_at(keys, i) : kClampQ;
    }
    __syncwarp();
    // a lower bound's position is 1 + the count of keys < q at positions
    // [1, kWindow): halving steps kWindow/2, ..., 1, each one shared-memory
    // load and a select, the lane's four searches interleaved
    int lo[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) lo[e] = 0;
#pragma unroll
    for (int step = kWindow / 2; step >= 1; step >>= 1) {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) lo[e] = win[lo[e] + step] < q[e] ? lo[e] + step : lo[e];
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      if (q[e] >= kClampQ) continue;
      ++lo[e];
      const int p = w0 + lo[e];  // the lower bound
      const int f0 = p < vk && win[lo[e]] == q[e];
      const int fm = p > 0 && win[lo[e] - 1] == q[e] - 1;
      const int fp = p + f0 < vk && win[lo[e] + f0] == q[e] + 1;
      res[e] = p * 8 + fm * 4 + f0 * 2 + fp;
    }
  } else if (any_valid) {
    // 3. a wide span: each lane's binary search over keys [l0, hi)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      if (q[e] >= kClampQ) continue;
      int lo = l0, len = hi - l0;
      while (len > 0) {
        const int half = len >> 1;
        if (rank_walk::key_at(keys, lo + half) < q[e]) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      const int fm = lo > 0 && rank_walk::key_at(keys, lo - 1) == q[e] - 1;
      const int f0 = lo < vk && rank_walk::key_at(keys, lo) == q[e];
      const int fp = lo + f0 < vk && rank_walk::key_at(keys, lo + f0) == q[e] + 1;
      res[e] = lo * 8 + fm * 4 + f0 * 2 + fp;
    }
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const long long i = base + lane + 32 * e;
    if (i < n) out[i] = res[e];
  }
}

}  // namespace

extern "C" int efg_rank_flags(int device, const void* keys, int vk,
                              const void* queries, long long n, void* out,
                              void* stream) {
  int current = -1;  // a device switch only where it is needed: host time each call
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const long long per_block = (long long)(kThreads / 32) * kRun;
  const long long blocks = (n + per_block - 1) / per_block;
  rank_flags_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, n, (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
