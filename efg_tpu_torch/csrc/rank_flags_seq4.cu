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
// What bounds it on the H100: bytes (8 per query, the keys once) at the
// flagship's sizes. The TPU kernel walks 128-query bands in order over
// 512-key super-chunks held in VMEM, carrying the scan start from band to
// band. Hopper's blocks run in no order, so nothing is carried: a block
// takes SEQ4_QUERIES = 256 consecutive queries of one row and starts at
// the chunk its seed names, (lower_bound(first query) − 1) / 512, which
// the wrapper computes with one searchsorted over the blocks' first
// queries (as the JAX wrapper seeds its kernel outside the pallas_call).
// The block stages one 512-key chunk after another into shared memory
// with coalesced loads; each thread adds its query's lower bound within
// the chunk (a binary search in shared memory) and ORs the three equality
// probes. It stops, as the TPU kernel does, after a chunk whose last key
// reaches max(valid query) + 2 (every later key is > q+1 for all its
// queries) or is CLAMP_Q (only padding keys follow), or at the last chunk.
// Every key before the seed's chunk is < q−1 for all the block's queries
// (valid keys are distinct), so it counts without being read.
//
// Where it is likely to break, and what holds it:
// - the q−1 neighbour of the block's first query when its lower bound is
//   an exact chunk multiple: that key is the last one of the chunk before,
//   hence the −1 in the seed;
// - padding queries: their count is count(keys_c < CLAMP_Q), `n_below`,
//   which the wrapper's searchsorted gives; they are left out of the
//   block's max, so a block that holds them stops where its valid queries
//   stop and a block of padding only reads no key at all;
// - Vk not a multiple of 512: positions at or past Vk are staged as
//   CLAMP_Q and never read from the key array.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidQ = 1 << 29;
constexpr int kClampQ = 1 << 30;
constexpr int kChunk = 512;    // keys per chunk (SEQ4_CHUNK)
constexpr int kThreads = 256;  // queries per block (SEQ4_QUERIES), one per thread

__global__ void __launch_bounds__(kThreads)
rank_seq4_kernel(const int* __restrict__ keys, int vk, const int* __restrict__ queries,
                 int vq, const int* __restrict__ seeds, const int* __restrict__ n_below,
                 int* __restrict__ out) {
  __shared__ int s_keys[kChunk];
  __shared__ int s_qmax;
  const int row = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < vq;
  const size_t at = (size_t)row * vq + i;
  const int q = in ? queries[at] : kClampQ;
  const bool valid = q < kInvalidQ;
  if (threadIdx.x == 0) s_qmax = INT_MIN;
  __syncthreads();
  // the block's max valid query: a warp max, then one shared atomic per warp
  const int wmax = __reduce_max_sync(0xffffffffu, valid ? q : INT_MIN);
  if ((threadIdx.x & 31) == 0 && wmax != INT_MIN) atomicMax(&s_qmax, wmax);
  __syncthreads();
  const int qmax = s_qmax;  // INT_MIN: no valid query in the block

  const int seed = seeds[(size_t)row * gridDim.x + blockIdx.x];
  int cnt = seed * kChunk, fm = 0, f0 = 0, fp = 0;
  if (qmax != INT_MIN) {
    const int n_chunks = (vk + kChunk - 1) / kChunk;
    for (int r = seed; r < n_chunks; ++r) {
      const long long base = (long long)r * kChunk;
      for (int j = threadIdx.x; j < kChunk; j += kThreads) {
        s_keys[j] = base + j < vk ? min(__ldg(keys + base + j), kClampQ) : kClampQ;
      }
      __syncthreads();
      if (valid) {
        int lo = 0, hi = kChunk;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_keys[mid] < q) lo = mid + 1; else hi = mid;
        }
        cnt += lo;
        fm |= lo > 0 && s_keys[lo - 1] == q - 1;
        const int e = lo < kChunk && s_keys[lo] == q;
        f0 |= e;
        fp |= lo + e < kChunk && s_keys[lo + e] == q + 1;
      }
      const int last = s_keys[kChunk - 1];
      __syncthreads();  // the chunk is restaged next round
      if (last >= qmax + 2 || last >= kClampQ) break;
    }
  }
  if (in) out[at] = valid ? cnt * 8 + fm * 4 + f0 * 2 + fp : n_below[0] * 8;
}

}  // namespace

extern "C" int efg_rank_flags_seq4(int device, const void* keys, int vk, const void* queries,
                                   int n_rows, int vq, const void* seeds, const void* n_below,
                                   int n_blocks, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0 || vq == 0) return cudaSuccess;
  if (n_blocks != (vq + kThreads - 1) / kThreads || n_rows > 65535) return cudaErrorInvalidValue;
  rank_seq4_kernel<<<dim3((unsigned)n_blocks, (unsigned)n_rows), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, vq, (const int*)seeds,
      (const int*)n_below, (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
