// rank_flags_hostwin: the rulebook builders' rank over per-band key
// windows, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_rank_kernel` (via
// `merge_rank_flags(..., seq=False)`, the "hostwin" path).
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
// the keys stay in the 50 MB L2, and a band reads of its window of them
// (mostly 2-3 rows of 128) the pieces that hold its lower bounds. The TPU
// kernel compares each band of 128 queries with every row of its window as
// [128, 128] broadcast planes in VMEM; it takes the windows from a
// searchsorted outside the pallas_call, since scalar prefetch is how a TPU
// grid learns indices. Here the whole call is one launch, and a block (128
// threads, one query each) finds its own window:
// - two warps search the keys at once (rank_walk.cuh `warp_lower_bound`):
//   the lower bound of the band's first query and of the next band's. The
//   window is efg_tpu's, the key rows from row(lower_bound(start) − 1) to
//   row(lower_bound(next start) + 1), clamped to the last key row; a row's
//   last band reaches the last key row. Every key before the window is
//   < q−1 for all the band's queries, so it counts unread;
// - in the window, cut into pieces of 4 rows (512 keys) from its first
//   row, the block stages with 16-byte cp.async, all at once, the pieces
//   that hold its queries' lower bounds, as a directory of the next 32
//   pieces' first and last keys names them (rank_walk.cuh `walk`; the
//   first piece loads beside the directory, and holds every lower bound of
//   most bands), and each thread binary-searches its piece in shared memory
//   and reads the three equality probes. So a row's last band, whose window
//   reaches the last key row, never stages the array's padding tail past
//   the first CLAMP_Q key.
//
// Where it is likely to break, and what holds it:
// - the q−1 neighbour of a band's first query at an exact row boundary:
//   the window starts one key early (the −1);
// - padding queries (read as CLAMP_Q): their lower bound, the first key
//   that is CLAMP_Q, lies in the window of every band that holds them;
// - a probe across a piece's edge: it reads the directory;
// - Vk not a multiple of 4 or of 128: the vector that reaches Vk is read
//   key by key, and positions at or past Vk, or past the window, read as
//   CLAMP_Q.

#include <cuda_runtime.h>

#include "rank_walk.cuh"

namespace {

using namespace rank_walk;

constexpr int kRow = 128;      // keys per window row, and queries per band (HOSTWIN_ROW)
constexpr int kThreads = kRow;  // one query per thread

__global__ void __launch_bounds__(kThreads, 8)
rank_hostwin_kernel(const int* __restrict__ keys, int vk, const int* __restrict__ queries, int vq,
                    int* __restrict__ out) {
  __shared__ Walk s_walk;
  __shared__ int s_lb[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < vq;
  const size_t at = (size_t)blockIdx.y * vq + i;
  const int q = in ? queries[at] : kClampQ;
  const int qc = q >= kInvalidQ ? kClampQ : q;
  const bool last_band = blockIdx.x + 1 == gridDim.x;
  if (warp == 0) {  // lower_bound of the band's first query (always in range)
    const int lb = warp_lower_bound(keys, vk, __shfl_sync(kFull, qc, 0));
    if (lane == 0) s_lb[0] = lb;
  } else if (warp == 1 && !last_band) {  // ... and of the next band's
    const int qn = queries[(size_t)blockIdx.y * vq + (size_t)(blockIdx.x + 1) * kThreads];
    const int lb = warp_lower_bound(keys, vk, qn >= kInvalidQ ? kClampQ : qn);
    if (lane == 0) s_lb[1] = lb;
  }
  __syncthreads();
  const int kr = (vk + kRow - 1) / kRow;  // key rows
  const int wrow = max(s_lb[0] - 1, 0) / kRow;
  const int last = last_band ? kr - 1 : min((s_lb[1] + 1) / kRow, kr - 1);
  const int nrows = max(last - wrow + 1, 1);
  Rank r;
  walk(s_walk, keys, min((long long)vk, (long long)(wrow + nrows) * kRow), (long long)wrow * kRow,
       1, in, qc, r);
  if (in) out[at] = r.cnt * 8 + (q < kInvalidQ ? r.fm * 4 + r.f0 * 2 + r.fp : 0);
}

}  // namespace

extern "C" int efg_rank_flags_hostwin(int device, const void* keys, int vk, const void* queries,
                                      int n_rows, int vq, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0 || vq == 0) return cudaSuccess;
  if (n_rows > 65535) return cudaErrorInvalidValue;
  rank_hostwin_kernel<<<dim3((unsigned)((vq + kThreads - 1) / kThreads), (unsigned)n_rows),
                        kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, vq, (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
