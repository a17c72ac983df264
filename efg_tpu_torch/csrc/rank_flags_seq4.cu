// rank_flags_seq4: the rulebook builders' rank as a merge-join over
// 512-key chunks, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_rank_kernel_seq4` (via
// `merge_rank_flags` with EFG_RANK_IMPL=seq4).
//
// Contract (the same as rank_flags.cu): keys [Vk] int32 ascending (entries
// >= INVALID_Q are padding), queries [P, Vq] int32, each row
// non-decreasing (>= INVALID_Q is padding). Keys are clamped to CLAMP_Q
// and padding queries set to CLAMP_Q, then
//   out[p, i] = count(keys_c < q_c)·8 + (q_c−1 ∈ keys_c)·4
//               + (q_c ∈ keys_c)·2 + (q_c+1 ∈ keys_c).
// Counts are exact at every query; flags are exact at valid queries (and 0
// at padding queries, whose flags the callers mask).
//
// What bounds it on the H100: bytes, 8 per query (read once, written once);
// the keys (1.9 MB at the flagship's bs=4 stage 0) stay in the 50 MB L2.
// The TPU kernel walks 128-query bands in order over 512-key super-chunks
// in VMEM, carrying its scan start from band to band, and takes each row's
// first start (a seed) from a searchsorted outside the pallas_call, since
// scalar prefetch is how a TPU grid learns indices. Hopper's blocks run in
// no order and read memory themselves, so the whole call is one launch:
// - a block takes SEQ4_QUERIES = 256 consecutive queries of one row and
//   finds its own start: one warp searches the keys for the lower bound of
//   the block's first query (rank_walk.cuh `warp_lower_bound`, 4 rounds of
//   32 probes at Vk = 480 000), and the block starts at the chunk
//   (lower_bound − 1) / 512. Every key before it is < q−1 for all the
//   block's queries (valid keys are distinct), so it counts unread;
// - from there the block stages, with 16-byte cp.async, the 512-key chunks
//   that hold its queries' lower bounds, all at once, as a directory of the
//   next 32 chunks' first and last keys names them (rank_walk.cuh `walk`;
//   the first two chunks load beside the directory, and hold every lower
//   bound of most SubM blocks), and each thread binary-searches its chunk
//   in shared memory and reads the three equality probes. The TPU kernel
//   walks every chunk from its start until one ends at max(valid query) + 2
//   or more (its stop rule); this block stages no chunk past the one that
//   holds the lower bound of its largest valid query. A walk over every
//   chunk, double-buffered, took 0.104 ms on the H100 for a strided conv's
//   rulebook (down2, bs=4) where rank_flags.cu took 0.024: consecutive
//   strided outputs skip whole rows and planes of input keys.
//
// Where it is likely to break, and what holds it:
// - the q−1 neighbour of the block's first query when its lower bound is
//   an exact chunk multiple: that key is the last one of the chunk before,
//   hence the −1;
// - padding queries: their count is count(keys_c < CLAMP_Q), which each
//   warp that holds one finds with its own warp search; they stage no
//   chunk, and a block of padding only walks nothing;
// - a probe across a chunk's edge: it reads the directory;
// - Vk not a multiple of 4 or of 512: the vector that reaches Vk is read
//   key by key, and positions at or past Vk read as CLAMP_Q.

#include <cuda_runtime.h>

#include "rank_walk.cuh"

namespace {

using namespace rank_walk;

constexpr int kChunk = kPiece;  // keys per chunk (SEQ4_CHUNK)
constexpr int kThreads = 256;   // queries per block (SEQ4_QUERIES), one per thread

__global__ void __launch_bounds__(kThreads, 4)
rank_seq4_kernel(const int* __restrict__ keys, int vk, const int* __restrict__ queries, int vq,
                 int* __restrict__ out) {
  __shared__ Walk s_walk;
  __shared__ int s_seed;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < vq;
  const size_t at = (size_t)blockIdx.y * vq + i;
  const int q = in ? queries[at] : kClampQ;
  const bool valid = q < kInvalidQ;
  if (warp == 0) {
    // the block's first query (always in range); if it is padding, the
    // block holds padding only (rows are monotone) and walks nothing
    const int q0 = __shfl_sync(kFull, q, 0);
    const int lb = q0 < kInvalidQ ? warp_lower_bound(keys, vk, q0) : 0;
    if (lane == 0) s_seed = max(lb - 1, 0) / kChunk;
  }
  int below = 0;  // count(keys_c < CLAMP_Q): the count of every padding query
  if (__any_sync(kFull, in && !valid)) below = warp_lower_bound(keys, vk, kClampQ);
  Rank r;
  if (__syncthreads_or(valid)) walk(s_walk, keys, vk, (long long)s_seed * kChunk, 2, valid, q, r);
  if (in) out[at] = valid ? r.cnt * 8 + r.fm * 4 + r.f0 * 2 + r.fp : below * 8;
}

}  // namespace

extern "C" int efg_rank_flags_seq4(int device, const void* keys, int vk, const void* queries,
                                   int n_rows, int vq, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0 || vq == 0) return cudaSuccess;
  if (n_rows > 65535) return cudaErrorInvalidValue;
  rank_seq4_kernel<<<dim3((unsigned)((vq + kThreads - 1) / kThreads), (unsigned)n_rows),
                     kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, vq, (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
