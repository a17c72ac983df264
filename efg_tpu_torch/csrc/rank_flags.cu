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
// result written once (8 bytes per query); the keys (4 bytes each, 1.9 MB
// at bs=4 Waymo stage 0) stay in the 50 MB L2 across the ~log2(Vk) probes
// of every binary search. The TPU kernel merged sorted query bands against
// VMEM-resident key chunks because the TPU has no fast scattered loads;
// here one thread per query does an independent lower_bound through L2,
// which needs no sequential carry between blocks (the TPU grid carried the
// scan start across bands). Queries are monotone per row, so neighbouring
// threads walk the same search path and their loads coalesce. Every probe
// index stays in [0, Vk).

#include <cuda_runtime.h>

namespace {

constexpr int kInvalidQ = 1 << 29;
constexpr int kClampQ = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int key_at(const int* __restrict__ keys, int i) {
  return min(__ldg(keys + i), kClampQ);
}

__global__ void __launch_bounds__(kThreads)
rank_flags_kernel(const int* __restrict__ keys, int vk,
                  const int* __restrict__ queries, long long n,
                  int* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const int q = queries[i];
  const int qc = q >= kInvalidQ ? kClampQ : q;
  int lo = 0, hi = vk;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key_at(keys, mid) < qc) lo = mid + 1; else hi = mid;
  }
  const int fm = lo > 0 && key_at(keys, lo - 1) == qc - 1;
  const int f0 = lo < vk && key_at(keys, lo) == qc;
  const int ip = lo + f0;
  const int fp = ip < vk && key_at(keys, ip) == qc + 1;
  out[i] = lo * 8 + fm * 4 + f0 * 2 + fp;
}

}  // namespace

extern "C" int efg_rank_flags(int device, const void* keys, int vk,
                              const void* queries, long long n, void* out,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  rank_flags_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)keys, vk, (const int*)queries, n, (int*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
