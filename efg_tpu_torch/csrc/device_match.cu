// device_match: exact linear assignment of a batch of cost matrices on the
// card, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports efg_tpu/ops/matcher.py `device_match`
// (:55-152), the Jonker-Volgenant shortest-augmenting-path solver that
// efg_tpu writes in `lax` control flow and runs wherever it does not run on
// the CPU (`hungarian_match`, backend "auto"). Without it the port copied
// every step's cost matrices to the host for scipy and the assignment back:
// a synchronising round trip in every DETR-style training step.
//
// Contract: cost [B, Q, G] f32 (nan → 0, ±inf → ±1e8, as efg_tpu's
// nan_to_num), mask [B, G] bool → out [B, G] int64: the query of each valid
// GT, −1 on padding and on rows left unassigned when there are more valid
// GTs than queries. The result equals efg_tpu's bit for bit, and the plain
// version's (`ops/cuda/match_kernels.py` `device_match_plain`):
// - the same expressions in the same order: r = ((min_val + cst[i]) − u[i])
//   − v, the dual update with spc read at col4row before the augmentation;
//   the arithmetic is additions and subtractions only, written with
//   __fadd_rn / __fsub_rn, so no multiply-add contraction can change a bit;
// - the same loop bounds: a Dijkstra search while no sink is found, a
//   column remains and steps ≤ G; the augmentation walk while steps ≤ G;
// - the same skip rule: a row runs when it is valid and a column is free;
// - jnp.argmin's rule: the first index of the minimum (index 0 when every
//   entry is inf), by a block reduction on (value, index) in which a tie
//   goes to the lower index.
//
// Parallelism: one block per problem; its threads stride over the Q
// columns (and the G rows in the dual update). The solve is serial in its
// Dijkstra steps: each step is one pass over the remaining columns and one
// block argmin (two barriers). What bounds it on the H100 is that chain of
// steps, not bytes: the cost matrix is read once into a transposed copy
// (each step then reads one GT's row of Q costs, coalesced, from L2), and
// the state of a problem lives in shared memory (17·Q + 9·G bytes, up to
// ~13.4k queries at G = 256), or, where it does not fit, in the workspace.
//
// Workspace (the wrapper allocates it, size from efg_device_match_workspace):
// the transposed costs [B, G, Q] f32, then, on the workspace route only,
// one state region of state_stride(Q, G) bytes per problem.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;        // threads of a block (Q ≥ 512)
constexpr int kSmemLimit = 232448;      // the H100's dynamic shared memory a block may opt into
constexpr int kStaticSmem = 1024;       // kept free for the block's static shared memory
constexpr int kBytesPerCol = 4 * 4 + 1; // v, spc, row4col, path (4 bytes), remaining (1)
constexpr int kBytesPerRow = 4 * 2 + 1; // u, col4row (4 bytes), in_tree (1)
constexpr long long kAlign = 256;       // alignment of each workspace region

__host__ __device__ inline long long round_up(long long x, long long a) {
  return (x + a - 1) / a * a;
}

// Bytes of one problem's state: the 4-byte arrays first, then the bytes.
__host__ __device__ inline long long state_bytes(int q, int g) {
  return round_up((long long)kBytesPerCol * q + (long long)kBytesPerRow * g, 16);
}

// One problem's stride in the workspace, on the workspace route.
__host__ __device__ inline long long state_stride(int q, int g) {
  return round_up(state_bytes(q, g), kAlign);
}

inline bool state_in_smem(int q, int g) {
  return state_bytes(q, g) <= kSmemLimit - kStaticSmem;
}

inline int block_threads(int q) {
  const int t = (q + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

inline long long cost_region_bytes(int b, int q, int g) {
  return round_up(4LL * b * q * g, kAlign);
}

__device__ inline bool before(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// The block's argmin of the threads' (best, bidx): each warp's
// shuffle-down tree (an out-of-range lane keeps its own value), then
// thread 0 over the warps in order; the result is thread 0's (best, bidx).
// Ends with the block's barrier before thread 0's pass.
__device__ inline void block_argmin(float& best, int& bidx, float* red_val, int* red_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
    if (before(ov, oi, best, bidx)) {
      best = ov;
      bidx = oi;
    }
  }
  if (lane == 0) {
    red_val[warp] = best;
    red_idx[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (before(red_val[w], red_idx[w], best, bidx)) {
        best = red_val[w];
        bidx = red_idx[w];
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
device_match_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ mask,
                    long long* __restrict__ out, unsigned char* __restrict__ ws, int q, int g,
                    int smem_state, long long state_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_val[kMaxThreads / 32];
  __shared__ int red_idx[kMaxThreads / 32];
  __shared__ float s_min;
  __shared__ int s_sink, s_i, s_nrem, s_steps;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float kInf = __int_as_float(0x7f800000);
  const long long qg = (long long)q * g;
  float* cst = reinterpret_cast<float*>(ws) + b * qg;  // [G, Q]
  unsigned char* st =
      smem_state ? smem : ws + state_offset + b * state_stride(q, g);
  float* v = reinterpret_cast<float*>(st);
  float* spc = v + q;
  int* row4col = reinterpret_cast<int*>(spc + q);
  int* path = row4col + q;
  float* u = reinterpret_cast<float*>(path + q);
  int* col4row = reinterpret_cast<int*>(u + g);
  unsigned char* remaining = reinterpret_cast<unsigned char*>(col4row + g);
  unsigned char* in_tree = remaining + q;
  const unsigned char* valid = mask + (long long)b * g;

  // the costs, transposed, with efg_tpu's nan_to_num
  const float* c = cost + b * qg;
  for (long long k = tid; k < qg; k += nt) {
    float x = c[k];
    if (isnan(x)) x = 0.0f;
    else if (isinf(x)) x = x > 0.0f ? 1e8f : -1e8f;
    const long long col = k / g, row = k - col * g;
    cst[row * q + col] = x;
  }
  for (int j = tid; j < q; j += nt) {
    v[j] = 0.0f;
    row4col[j] = -1;
  }
  for (int k = tid; k < g; k += nt) {
    u[k] = 0.0f;
    col4row[k] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < g; ++cur) {
    int free_col = 0;
    for (int j = tid; j < q; j += nt) free_col |= row4col[j] < 0;
    // the skip rule: valid[cur] & any(row4col < 0)
    if (!__syncthreads_or(free_col) || !valid[cur]) continue;

    for (int j = tid; j < q; j += nt) {
      remaining[j] = 1;
      spc[j] = kInf;
      path[j] = 0;
    }
    for (int k = tid; k < g; k += nt) in_tree[k] = 0;
    if (tid == 0) {
      s_sink = -1;
      s_i = cur;
      s_min = 0.0f;
      s_nrem = q;
      s_steps = 0;
    }
    __syncthreads();

    // Dijkstra: while sink < 0 & any(remaining) & steps ≤ g
    while (true) {
      const int sink = s_sink, i = s_i;
      const float min_val = s_min;
      if (!(sink < 0 && s_nrem > 0 && s_steps <= g)) break;
      if (tid == 0) in_tree[i] = 1;
      const float ui = u[i];
      const float* crow = cst + (long long)i * q;
      float best = kInf;
      int bidx = INT_MAX;
      for (int j = tid; j < q; j += nt) {
        float m = kInf;  // masked = where(remaining, spc, inf)
        if (remaining[j]) {
          const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, crow[j]), ui), v[j]);
          m = spc[j];
          if (r < m) {
            spc[j] = r;
            path[j] = i;
            m = r;
          }
        }
        if (before(m, j, best, bidx)) {
          best = m;
          bidx = j;
        }
      }
      block_argmin(best, bidx, red_val, red_idx);
      if (tid == 0) {
        s_min = best;
        if (remaining[bidx]) {
          remaining[bidx] = 0;
          --s_nrem;
        }
        const int owner = row4col[bidx];
        if (owner < 0) s_sink = bidx;
        else s_i = owner;
        ++s_steps;
      }
      __syncthreads();
    }

    // dual update (spc read at col4row before the augmentation)
    const float min_val = s_min;
    for (int k = tid; k < g; k += nt) {
      if (k == cur) {
        u[k] = __fadd_rn(u[k], min_val);
      } else if (in_tree[k]) {
        const int col = min(max(col4row[k], 0), q - 1);
        u[k] = __fadd_rn(u[k], __fsub_rn(min_val, spc[col]));
      }
    }
    for (int j = tid; j < q; j += nt) {
      if (!remaining[j]) v[j] = __fsub_rn(v[j], __fsub_rn(min_val, spc[j]));
    }
    __syncthreads();
    if (tid == 0) {  // augment: walk the path from the sink back to cur
      int j = s_sink;
      bool done = j < 0;
      for (int steps = 0; !done && steps <= g; ++steps) {
        const int i = path[j];
        row4col[j] = i;
        const int next = col4row[i];
        col4row[i] = j;
        done = i == cur;
        j = next;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < g; k += nt) {
    out[(long long)b * g + k] = valid[k] ? (long long)col4row[k] : -1LL;
  }
}

}  // namespace

// Bytes of the workspace efg_device_match needs for B problems of Q × G.
extern "C" int efg_device_match_workspace(int b, int q, int g, long long* bytes) {
  if (b < 0 || q < 0 || g < 0) return cudaErrorInvalidValue;
  *bytes = cost_region_bytes(b, q, g);
  if (!state_in_smem(q, g)) *bytes += (long long)b * state_stride(q, g);
  return cudaSuccess;
}

extern "C" int efg_device_match(int device, const void* cost, const void* mask, void* out,
                                void* ws, int b, int q, int g, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b < 0 || q < 0 || g < 0) return cudaErrorInvalidValue;
  if (b == 0 || g == 0) return cudaSuccess;
  if (q == 0) return cudaErrorInvalidValue;  // the wrapper writes −1 itself
  const bool in_smem = state_in_smem(q, g);
  const int smem = in_smem ? (int)state_bytes(q, g) : 0;
  static bool opted_in = false;  // once, so that no later call (a graph capture) repeats it
  if (smem > 48 * 1024 && !opted_in) {
    err = cudaFuncSetAttribute(device_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - kStaticSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  device_match_kernel<<<b, block_threads(q), smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const unsigned char*)mask, (long long*)out, (unsigned char*)ws, q, g,
      in_smem ? 1 : 0, cost_region_bytes(b, q, g));
  return cudaGetLastError();
}

// The latency of one Dijkstra step's block argmin, for the solve's serial
// floor: one block of `threads` runs `iters` argmins in a dependent chain,
// each with the step's barriers (the warps' pass, thread 0's update of a
// shared value that the next one reads). out[0] keeps the chain alive.
__global__ void __launch_bounds__(kMaxThreads) argmin_chain_kernel(int iters, float* out) {
  __shared__ float red_val[kMaxThreads / 32];
  __shared__ int red_idx[kMaxThreads / 32];
  __shared__ float s_min;
  if (threadIdx.x == 0) s_min = 0.0f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float best = __fadd_rn(s_min, (float)((threadIdx.x * 7 + it) & 31));
    int bidx = threadIdx.x;
    block_argmin(best, bidx, red_val, red_idx);
    if (threadIdx.x == 0) s_min = __fsub_rn(best, (float)(bidx & 1));
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s_min;
}

extern "C" int efg_argmin_chain(int device, int threads, int iters, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || iters < 0) {
    return cudaErrorInvalidValue;
  }
  argmin_chain_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(iters, (float*)out);
  return cudaGetLastError();
}

extern "C" int efg_device_match_threads(int q, int* threads) {
  *threads = block_threads(q);
  return cudaSuccess;
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
