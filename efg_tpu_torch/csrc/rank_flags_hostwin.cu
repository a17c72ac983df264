// rank_flags_hostwin: the rulebook builders' rank over per-band key
// windows bounded beforehand, for Hopper (sm_90a).
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
// The windows: for each band of 128 queries of a row, key rows (128 keys
// each) [wrow, wrow + nrows), from one searchsorted over the band-start
// queries in the wrapper, as the JAX wrapper computes them outside its
// pallas_call (`hostwin_windows`). Every key before row `wrow` is < q−1
// for all the band's queries, so count = wrow·128 + rank in the window.
//
// What bounds it on the H100: bytes (8 per query, and each band's window
// of keys, mostly 1-3 rows). The TPU kernel compares each band with its
// window row by row as [128, 128] broadcast planes in VMEM. Here a block
// (128 threads, one query each) stages its window into shared memory in
// pieces of up to 16 rows (8 KB) with coalesced loads, and each thread adds
// its query's lower bound within the piece (a binary search in shared
// memory) and ORs the three equality probes.
//
// Where it is likely to break, and what holds it:
// - the q−1 neighbour of a band's first query at an exact row boundary:
//   the window starts one key early (the −1 on wrow);
// - padding queries, and the last band of a row, whose window reaches the
//   last key row: the walk stops after a piece whose last key is CLAMP_Q
//   (only padding keys follow, which no count and no valid flag needs), so
//   no block stages the array's padding tail; a band without padding
//   queries also stops once a piece ends at or past max(query) + 2;
// - a window wider than shared memory: staged piece by piece;
// - Vk not a multiple of 128: positions at or past Vk are staged as
//   CLAMP_Q and never read from the key array.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidQ = 1 << 29;
constexpr int kClampQ = 1 << 30;
constexpr int kRow = 128;      // keys per window row (HOSTWIN_ROW)
constexpr int kThreads = 128;  // queries per band, one per thread
constexpr int kPiece = 16;     // window rows staged at once

__global__ void __launch_bounds__(kThreads)
rank_hostwin_kernel(const int* __restrict__ keys, int vk, const int* __restrict__ queries,
                    int vq, const int* __restrict__ wrow, const int* __restrict__ nrows,
                    int* __restrict__ out) {
  __shared__ int s_keys[kPiece * kRow];
  __shared__ int s_qmax;
  const int row = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < vq;
  const size_t at = (size_t)row * vq + i;
  const int q = in ? queries[at] : kClampQ;
  const int qc = q >= kInvalidQ ? kClampQ : q;
  const bool valid = q < kInvalidQ;
  if (threadIdx.x == 0) s_qmax = INT_MIN;
  __syncthreads();
  // the block's max valid query: a warp max, then one shared atomic per warp
  const int wmax = __reduce_max_sync(0xffffffffu, valid ? q : INT_MIN);
  if ((threadIdx.x & 31) == 0 && wmax != INT_MIN) atomicMax(&s_qmax, wmax);
  const bool has_pad = __syncthreads_or(in && !valid);
  const int qmax = s_qmax;

  const size_t band = (size_t)row * gridDim.x + blockIdx.x;
  const int w0 = wrow[band], nr = nrows[band];
  int cnt = w0 * kRow, fm = 0, f0 = 0, fp = 0;
  if (qmax != INT_MIN || has_pad) {
    for (int r0 = 0; r0 < nr; r0 += kPiece) {
      const int n = min(kPiece, nr - r0) * kRow;
      const long long base = (long long)(w0 + r0) * kRow;
      for (int j = threadIdx.x; j < n; j += kThreads) {
        s_keys[j] = base + j < vk ? min(__ldg(keys + base + j), kClampQ) : kClampQ;
      }
      __syncthreads();
      if (in) {
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_keys[mid] < qc) lo = mid + 1; else hi = mid;
        }
        cnt += lo;
        fm |= lo > 0 && s_keys[lo - 1] == qc - 1;
        const int e = lo < n && s_keys[lo] == qc;
        f0 |= e;
        fp |= lo + e < n && s_keys[lo + e] == qc + 1;
      }
      const int last = s_keys[n - 1];
      __syncthreads();  // the next piece is staged over this one
      if (last >= kClampQ || (!has_pad && last >= qmax + 2)) break;
    }
  }
  if (in) out[at] = cnt * 8 + (valid ? fm * 4 + f0 * 2 + fp : 0);
}

}  // namespace

extern "C" int efg_rank_flags_hostwin(int device, const void* keys, int vk,
                                      const void* queries, int n_rows, int vq,
                                      const void* wrow, const void* nrows, int n_bands,
                                      void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0 || vq == 0) return cudaSuccess;
  if (n_bands != (vq + kThreads - 1) / kThreads || n_rows > 65535) return cudaErrorInvalidValue;
  rank_hostwin_kernel<<<dim3((unsigned)n_bands, (unsigned)n_rows), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, vq, (const int*)wrow, (const int*)nrows,
      (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
