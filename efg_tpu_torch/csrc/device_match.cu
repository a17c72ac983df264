// device_match: exact linear assignment of a batch of cost matrices on the
// card, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports efg_tpu/ops/matcher.py `device_match`
// (:55-152), the Jonker-Volgenant shortest-augmenting-path solver that
// efg_tpu writes in `lax` control flow and runs wherever it does not run on
// the CPU (`hungarian_match`, backend "auto").
//
// Contract: cost [B, Q, G] f32 (nan → 0, ±inf → ±1e8, as efg_tpu's
// nan_to_num), mask [B, G] bool → out [B, G] int64: the query of each valid
// GT, −1 on padding and on rows left unassigned when there are more valid
// GTs than queries. The result equals efg_tpu's bit for bit, and the plain
// version's (`ops/cuda/match_kernels.py` `device_match_plain`):
// - the same expressions in the same order: r = ((min_val + cst[i]) − u[i])
//   − v, the dual update with spc read at col4row before the augmentation;
//   only additions and subtractions, written with __fadd_rn / __fsub_rn, so
//   no multiply-add contraction can change a bit;
// - the same loop bounds: a Dijkstra search while no sink is found, a
//   column remains and steps ≤ G; the augmentation walk while steps ≤ G;
// - the same skip rule: a row runs when it is valid and a column is free;
// - jnp.argmin's rule: the first index of the minimum (index 0 when every
//   entry is inf).
//
// Design (one block a problem: the Dijkstra chain is serial):
// - Staging: every thread of the block (at least kStageThreads) stages the
//   costs once, transposed to [G, Q] with a row stride of Q | 1 and
//   nan_to_num applied, keeping kTile loads in flight: into shared memory
//   where the staged costs and the state fit the block's 227 KB (each
//   thread walks the [Q, G] input in order, coalesced; the odd stride
//   spreads the transposed writes over the banks), else into the workspace
//   through a 32 × 33 tile a warp (coalesced reads and writes).
// - Solving: only as many warps as the columns need stay (a thread holds
//   kCols columns up to kMaxThreads threads; the rest of the block exits;
//   one solving warp needs no block barrier). A Dijkstra step reads its
//   row of Q costs from shared memory, or from L2; each thread issues the
//   loads of its columns (KB at a time) before it computes any of them.
// - The valid rows are listed once (warp 0's ballots); padding rows cost
//   nothing. The skip rule's any(row4col < 0) is `assigned < Q`, a count
//   that each augmentation raises by the free columns it fills.
// - No reset pass: a row's first step (i = cur, min_val = 0, every column
//   remaining) writes spc, path and remaining for every column, as the
//   reset followed by that step would. Before it, each column removed by
//   the previous row takes that row's dual update of v, v −= min − spc,
//   from its own thread (a column's v, spc, path and remaining are only
//   ever touched by the thread that owns it, j mod threads, during a row).
//   The rows that enter the tree are kept in a list (thread 0), and the
//   dual update of u runs over that list alone, a row a lane of warp 0.
// - One barrier a Dijkstra step (none in one warp): each warp reduces its
//   lanes' (value, index) by two redux.sync minimums (the value's
//   order-preserving key, then the lowest index holding it), lane 0 writes
//   the pair to a slot that alternates between two arrays by the step's
//   parity, and after the barrier every warp reduces the slots the same
//   way. Every thread then holds (min, j), reads owner = row4col[j] and
//   moves on; only j's owner clears remaining[j]. The index carries
//   whether j was still remaining, so every thread counts the remaining
//   columns without reading them.
// - Lane 0 of warp 0 walks the augmenting path, then the row's barrier.
//
// Routes (the wrapper computes the same plan from the constants below):
// "shared": costs and state in shared memory, no workspace; "workspace":
// the costs in the workspace, the state in shared memory where it fits
// (17·Q + 17·G bytes) and in the workspace beyond (Q above ~13.5k).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;        // most threads that solve (a power of two)
constexpr int kCols = 1;                // columns a solving thread holds, at most threads
constexpr int kStageThreads = 512;      // threads that stage the costs (a block has at least these)
constexpr int kSmemLimit = 232448;      // the H100's shared memory a block may opt into
constexpr int kStaticSmem = 1024;       // kept free for the block's static shared memory
constexpr int kBytesPerCol = 4 * 4 + 1; // v, spc, row4col, path (4 bytes), remaining (1)
constexpr int kBytesPerRow = 4 * 4 + 1; // u, col4row, valid list, tree list (4 bytes), in_tree (1)
constexpr int kTile = 32;               // staging: a warp's tile (kTile²), a thread's loads in flight
constexpr int kBatch = 8;               // most columns a solving thread loads at a time
constexpr int kCarveout = 0;            // preferred shared-memory share (%): the rest is L1
constexpr long long kAlign = 256;       // alignment of each workspace region

constexpr int kLaunchMax = kMaxThreads > kStageThreads ? kMaxThreads : kStageThreads;
static_assert((kMaxThreads & (kMaxThreads - 1)) == 0 && kLaunchMax <= 1024, "threads");
static_assert(kStageThreads % 32 == 0 && kCols >= 1, "plan");
static_assert((kBatch & (kBatch - 1)) == 0 && kBatch >= 4, "batch");

constexpr unsigned kNone = 0xffffffffu;  // above every candidate's key and index

__host__ __device__ inline long long round_up(long long x, long long a) {
  return (x + a - 1) / a * a;
}

// The staged costs' row stride: odd, so that consecutive GT rows of one
// query land in different banks.
__host__ __device__ inline int cost_stride(int q) { return q | 1; }

__host__ __device__ inline long long cost_bytes(int q, int g) {
  return round_up(4LL * g * cost_stride(q), 16);
}

// One problem's state: the 4-byte arrays first, then the bytes.
__host__ __device__ inline long long state_bytes(int q, int g) {
  return round_up((long long)kBytesPerCol * q + (long long)kBytesPerRow * g, 16);
}

__host__ __device__ inline long long state_stride(int q, int g) {
  return round_up(state_bytes(q, g), kAlign);
}

inline bool costs_in_smem(int q, int g) {
  return cost_bytes(q, g) + state_bytes(q, g) <= kSmemLimit - kStaticSmem;
}

inline bool state_in_smem(int q, int g) {
  return state_bytes(q, g) <= kSmemLimit - kStaticSmem;
}

// The threads that solve: the smallest power of two ≥ ⌈Q / kCols⌉, at
// least a warp and at most kMaxThreads.
inline int solve_threads(int q) {
  int t = 32;
  while (t * kCols < q && t < kMaxThreads) t *= 2;
  return t;
}

// The block: the solving threads, at least kStageThreads.
inline int launch_threads(int q) {
  return solve_threads(q) > kStageThreads ? solve_threads(q) : kStageThreads;
}

// The columns a solving thread takes at a time in a step's pass: the
// smallest power of two ≥ ⌈Q / threads⌉, at most kBatch.
inline int pass_batch(int q) {
  const int k = (q + solve_threads(q) - 1) / solve_threads(q);
  int kb = 1;
  while (kb < k && kb < kBatch) kb *= 2;
  return kb;
}

inline long long tile_bytes(int threads) {
  return 4LL * (threads / 32) * kTile * (kTile + 1);
}

inline long long smem_bytes(int q, int g) {
  if (costs_in_smem(q, g)) return cost_bytes(q, g) + state_bytes(q, g);
  const long long st = state_in_smem(q, g) ? state_bytes(q, g) : 0;
  const long long tb = tile_bytes(launch_threads(q));
  return st > tb ? st : tb;
}

inline long long workspace_bytes(int b, int q, int g) {
  if (costs_in_smem(q, g)) return 0;
  long long n = round_up((long long)b * cost_bytes(q, g), kAlign);
  if (!state_in_smem(q, g)) n += (long long)b * state_stride(q, g);
  return n;
}

__device__ __forceinline__ float clean(float x) {  // efg_tpu's nan_to_num
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? 1e8f : -1e8f;
  return x;
}

// An order-preserving key of a non-NaN float. −0 becomes +0 first (x + 0
// rounds it so), as jnp.argmin holds the two equal; a zero's sign never
// changes a comparison of the sums and differences computed from it.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The solving warps' barrier (named barrier 1; the block's other warps
// have exited), a warp's own where one warp solves.
__device__ __forceinline__ void solve_sync(int nwarps) {
  if (nwarps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(nwarps * 32) : "memory");
  }
}

// The solving warps' lexicographic minimum of the threads' (key, idx), in
// every thread: a warp's two redux.sync minimums; with several warps, lane
// 0's slot in the array of this step's parity, the barrier, the slots'
// two minimums.
__device__ __forceinline__ void block_argmin(unsigned& key, unsigned& idx, uint2 (*slots)[32],
                                             int parity, int nwarps) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned k = __reduce_min_sync(full, key);
  const unsigned i = __reduce_min_sync(full, key == k ? idx : kNone);
  if (nwarps == 1) {
    key = k;
    idx = i;
    return;
  }
  if (lane == 0) slots[parity][warp] = make_uint2(k, i);
  solve_sync(nwarps);
  const uint2 s = lane < nwarps ? slots[parity][lane] : make_uint2(kNone, kNone);
  key = __reduce_min_sync(full, s.x);
  idx = __reduce_min_sync(full, s.x == key ? s.y : kNone);
}

// KB: the columns a solving thread takes at a time in a step's pass
// (`pass_batch`), loaded before any of them is computed.
template <int KB>
__global__ void __launch_bounds__(kLaunchMax, 1)  // registers for one resident block an SM
device_match_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ mask,
                    long long* __restrict__ out, unsigned char* __restrict__ ws, int q, int g,
                    int nt, int costs_smem, int state_smem, long long state_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint2 slots[2][32];
  __shared__ int s_nvalid, s_assigned;

  const int b = blockIdx.x, tid = threadIdx.x, nl = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int stride = cost_stride(q), qg = q * g;
  const float kInf = __int_as_float(0x7f800000);
  float* cst = costs_smem ? reinterpret_cast<float*>(smem)
                          : reinterpret_cast<float*>(ws + b * cost_bytes(q, g));  // [G, stride]
  unsigned char* st = costs_smem ? smem + cost_bytes(q, g)
                      : state_smem ? smem
                                   : ws + state_offset + b * state_stride(q, g);
  float* v = reinterpret_cast<float*>(st);
  float* spc = v + q;
  int* row4col = reinterpret_cast<int*>(spc + q);
  int* path = row4col + q;
  float* u = reinterpret_cast<float*>(path + q);
  int* col4row = reinterpret_cast<int*>(u + g);
  int* vlist = col4row + g;  // the valid rows, in order
  int* tree = vlist + g;     // the rows that entered this row's tree
  unsigned char* remaining = reinterpret_cast<unsigned char*>(tree + g);
  unsigned char* in_tree = remaining + q;
  const float* c = cost + (long long)b * qg;
  const unsigned char* valid = mask + (long long)b * g;

  // stage the costs, transposed, with nan_to_num, by the whole block
  if (costs_smem) {
    const int dq = nl / g, dg = nl - dq * g;
    int qi = tid / g, gi = tid - qi * g;
    for (int k0 = tid; k0 < qg; k0 += nl * kTile) {
      float x[kTile];  // kTile loads in flight before the stores
#pragma unroll
      for (int t = 0; t < kTile; ++t) x[t] = k0 + t * nl < qg ? c[k0 + t * nl] : 0.0f;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (k0 + t * nl < qg) cst[gi * stride + qi] = clean(x[t]);
        gi += dg;
        qi += dq;
        if (gi >= g) {
          gi -= g;
          ++qi;
        }
      }
    }
  } else {
    float* tile = reinterpret_cast<float*>(smem) + warp * kTile * (kTile + 1);
    const int tq = (q + kTile - 1) / kTile, tg = (g + kTile - 1) / kTile;
    for (int t = warp; t < tq * tg; t += nl >> 5) {
      const int q0 = t / tg * kTile, g0 = (t - t / tg * tg) * kTile;
      const int nq = min(kTile, q - q0), ng = min(kTile, g - g0);
      float x[kTile];  // the tile's kTile rows in flight, then their stores
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        x[r] = r < nq && lane < ng ? c[(q0 + r) * g + g0 + lane] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) tile[r * (kTile + 1) + lane] = clean(x[r]);
      __syncwarp();
      for (int r = 0; r < ng; ++r) {
        if (lane < nq) cst[(g0 + r) * stride + q0 + lane] = tile[lane * (kTile + 1) + r];
      }
      __syncwarp();
    }
    __syncthreads();  // the tiles share their shared memory with the state
  }
  for (int j = tid; j < q; j += nl) {
    v[j] = 0.0f;
    row4col[j] = -1;
    remaining[j] = 1;
  }
  for (int k = tid; k < g; k += nl) {
    u[k] = 0.0f;
    col4row[k] = -1;
    in_tree[k] = 0;
  }
  if (warp == 0) {  // the valid rows, listed in order by ballots
    int n = 0;
    for (int k0 = 0; k0 < g; k0 += 32) {
      const bool ok = k0 + lane < g && valid[k0 + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (ok) vlist[n + __popc(ballot & ((1u << lane) - 1u))] = k0 + lane;
      n += __popc(ballot);
    }
    if (lane == 0) {
      s_nvalid = n;
      s_assigned = 0;
    }
  }
  __syncthreads();
  if (tid >= nt) return;  // the warps that only staged

  const int nvalid = s_nvalid;
  float prev_min = 0.0f;  // the last row's min_val, for its dual update of v
  int parity = 0;
  for (int n = 0; n < nvalid; ++n) {
    if (s_assigned >= q) break;  // no free column: this row and every later one skip
    const int cur = vlist[n];
    int ntree = 0;
    if (tid == 0) {
      in_tree[cur] = 1;
      tree[ntree++] = cur;
    }
    // the first Dijkstra step: i = cur, min_val = 0, every column remaining
    unsigned key, idx;
    {
      const float ui = u[cur];
      const float* crow = cst + cur * stride;
      float best = kInf;
      int bj = -1;
      for (int j0 = tid; j0 < q; j0 += nt * KB) {
        float cv[KB], vv[KB], sv[KB];
        unsigned char rem[KB];
#pragma unroll
        for (int t = 0; t < KB; ++t) {  // every load of the batch first
          const int j = j0 + t * nt;
          const bool in = j < q;
          cv[t] = in ? crow[j] : 0.0f;
          vv[t] = in ? v[j] : 0.0f;
          sv[t] = in ? spc[j] : 0.0f;
          rem[t] = in ? remaining[j] : 1;
        }
#pragma unroll
        for (int t = 0; t < KB; ++t) {
          const int j = j0 + t * nt;
          if (j >= q) break;
          float vj = vv[t];
          if (!rem[t]) {  // removed by the previous row: its dual update
            vj = __fsub_rn(vj, __fsub_rn(prev_min, sv[t]));
            v[j] = vj;
            remaining[j] = 1;
          }
          const float r = __fsub_rn(__fsub_rn(__fadd_rn(0.0f, cv[t]), ui), vj);
          const bool upd = r < kInf;
          const float m = upd ? r : kInf;
          spc[j] = m;
          path[j] = upd ? cur : 0;
          if (m < best) {
            best = m;
            bj = j;
          }
        }
      }
      if (bj < 0 && tid < q) bj = tid;  // every value of the thread inf: its first column
      key = bj < 0 ? kNone : order_key(best);
      idx = bj < 0 ? kNone : (unsigned)bj << 1 | 1u;
    }
    int i = cur, sink = -1, steps = 0, nrem = q;
    float min_val = 0.0f;
    while (true) {
      block_argmin(key, idx, slots, parity, nwarps);
      parity ^= 1;
      const int j = (int)(idx >> 1);
      min_val = key_value(key);
      if (idx & 1u) {
        --nrem;
        if ((j & (nt - 1)) == tid) remaining[j] = 0;
      }
      const int owner = row4col[j];
      if (owner < 0) sink = j;
      else i = owner;
      ++steps;
      if (!(sink < 0 && nrem > 0 && steps <= g)) break;
      if (tid == 0 && !in_tree[i]) {
        in_tree[i] = 1;
        tree[ntree++] = i;
      }
      // the next Dijkstra step, from row i
      const float ui = u[i];
      const float* crow = cst + i * stride;
      float best = kInf;
      int bj = -1;
      unsigned bflag = 0, flag0 = 0;
      for (int j0 = tid; j0 < q; j0 += nt * KB) {
        float cv[KB], vv[KB], sv[KB];
        unsigned char rem[KB];
#pragma unroll
        for (int t = 0; t < KB; ++t) {  // every load of the batch first
          const int jj = j0 + t * nt;
          const bool in = jj < q;
          cv[t] = in ? crow[jj] : 0.0f;
          vv[t] = in ? v[jj] : 0.0f;
          sv[t] = in ? spc[jj] : 0.0f;
          rem[t] = in ? remaining[jj] : 0;
        }
        if (j0 == tid) flag0 = rem[0];
#pragma unroll
        for (int t = 0; t < KB; ++t) {
          const int jj = j0 + t * nt;
          if (jj >= q) break;
          float m = kInf;  // masked = where(remaining, spc, inf)
          if (rem[t]) {
            const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, cv[t]), ui), vv[t]);
            m = sv[t];
            if (r < m) {
              spc[jj] = r;
              path[jj] = i;
              m = r;
            }
          }
          if (m < best) {
            best = m;
            bj = jj;
            bflag = rem[t];
          }
        }
      }
      if (bj < 0 && tid < q) {  // every value of the thread inf: its first column
        bj = tid;
        bflag = flag0;
      }
      key = bj < 0 ? kNone : order_key(best);
      idx = bj < 0 ? kNone : (unsigned)bj << 1 | bflag;
    }
    if (warp == 0) {
      __syncwarp();  // the lanes' spc and path, for one solving warp
      // the dual update of u over the tree, a row a lane (spc read at
      // col4row before the augmentation)
      const int ntr = __shfl_sync(0xffffffffu, ntree, 0);
      for (int t = lane; t < ntr; t += 32) {
        const int k = tree[t];
        in_tree[k] = 0;
        if (k == cur) {
          u[k] = __fadd_rn(u[k], min_val);
        } else {
          const int col = min(max(col4row[k], 0), q - 1);
          u[k] = __fadd_rn(u[k], __fsub_rn(min_val, spc[col]));
        }
      }
      __syncwarp();
      if (lane == 0) {
        // augment: walk the path from the sink back to cur (a column −1
        // indexes the last, as in efg_tpu's jnp indexing)
        int j = sink, filled = 0;
        bool done = j < 0;
        for (int s = 0; !done && s <= g; ++s) {
          const int jc = j < 0 ? j + q : j;
          const int r = path[jc];
          filled += row4col[jc] < 0;
          row4col[jc] = r;
          const int next = col4row[r];
          col4row[r] = j;
          done = r == cur;
          j = next;
        }
        s_assigned += filled;
      }
    }
    prev_min = min_val;
    solve_sync(nwarps);
  }

  for (int k = tid; k < g; k += nt) {
    out[(long long)b * g + k] = valid[k] ? (long long)col4row[k] : -1LL;
  }
}

// The latency of one Dijkstra step's argmin, for the solve's serial floor:
// one block of `threads`, all solving, runs `iters` argmins in a dependent
// chain (each thread's candidate from the last minimum), as a step runs
// them. out[0] keeps the chain alive.
__global__ void __launch_bounds__(kLaunchMax) argmin_chain_kernel(int iters, float* out) {
  __shared__ uint2 slots[2][32];
  const int nwarps = blockDim.x >> 5;
  float min_val = 0.0f;
  for (int it = 0; it < iters; ++it) {
    unsigned key = order_key(__fadd_rn(min_val, (float)((threadIdx.x * 7 + it) & 31)));
    unsigned idx = threadIdx.x << 1 | 1u;
    block_argmin(key, idx, slots, it & 1, nwarps);
    min_val = __fsub_rn(key_value(key), (float)(idx >> 1 & 1));
  }
  if (threadIdx.x == 0) out[0] = min_val;
}

template <int KB>
cudaError_t launch(const void* cost, const void* mask, void* out, void* ws, int b, int q, int g,
                   cudaStream_t stream) {
  static bool opted_in = false;  // once, so that no later call (a graph capture) repeats it
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        device_match_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit - kStaticSmem);
    // the workspace route's rows stay in L1 the more of it shared memory
    // leaves; a launch that needs more shared memory still gets it
    if (err == cudaSuccess && kCarveout >= 0) {
      err = cudaFuncSetAttribute(device_match_kernel<KB>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout, kCarveout);
    }
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  device_match_kernel<KB><<<b, launch_threads(q), (size_t)smem_bytes(q, g), stream>>>(
      (const float*)cost, (const unsigned char*)mask, (long long*)out, (unsigned char*)ws, q, g,
      solve_threads(q), costs_in_smem(q, g) ? 1 : 0, state_in_smem(q, g) ? 1 : 0,
      round_up((long long)b * cost_bytes(q, g), kAlign));
  return cudaGetLastError();
}

}  // namespace

// The plan of B problems of Q × G: the threads that solve and the block's,
// the pass's columns a thread at a time, dynamic shared memory, whether
// the costs (route) and the state sit in shared memory, and the workspace
// bytes the call needs (0 on the shared-memory route).
extern "C" int efg_device_match_plan(int b, int q, int g, int* threads, int* block, int* batch,
                                     long long* smem, int* costs_smem, int* state_smem,
                                     long long* ws_bytes) {
  if (b < 0 || q < 1 || g < 0) return cudaErrorInvalidValue;
  *threads = solve_threads(q);
  *block = launch_threads(q);
  *batch = pass_batch(q);
  *smem = smem_bytes(q, g);
  *costs_smem = costs_in_smem(q, g);
  *state_smem = state_in_smem(q, g);
  *ws_bytes = workspace_bytes(b, q, g);
  return cudaSuccess;
}

extern "C" int efg_device_match(int device, const void* cost, const void* mask, void* out,
                                void* ws, long long ws_bytes, int b, int q, int g,
                                void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b < 0 || q < 0 || g < 0) return cudaErrorInvalidValue;
  if (b == 0 || g == 0) return cudaSuccess;
  // the wrapper writes −1 itself at Q = 0; the kernel's indices are 32-bit
  if (q == 0 || 1LL * q * g >= (1LL << 31) || 1LL * g * cost_stride(q) >= (1LL << 31) ||
      q >= (1 << 30)) {
    return cudaErrorInvalidValue;
  }
  if (ws_bytes < workspace_bytes(b, q, g)) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pass_batch(q)) {
    case 1: return launch<1>(cost, mask, out, ws, b, q, g, s);
    case 2: return launch<2>(cost, mask, out, ws, b, q, g, s);
    case 4: return launch<4>(cost, mask, out, ws, b, q, g, s);
    default: return launch<kBatch>(cost, mask, out, ws, b, q, g, s);
  }
}

extern "C" int efg_argmin_chain(int device, int threads, int iters, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (threads < 32 || threads > kLaunchMax || threads % 32 || iters < 0) {
    return cudaErrorInvalidValue;
  }
  argmin_chain_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(iters, (float*)out);
  return cudaGetLastError();
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
