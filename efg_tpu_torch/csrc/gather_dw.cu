// gather_dw: the weight gradient of the packed-rulebook sparse conv, for
// Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_dw_kernel` (via
// `fused_gather_dw`), the backward's dW where the gathered-tap path does not
// apply (cout not a multiple of 16, or a strided conv without an inverse
// rulebook).
//
// Contract: features [V_in, C] bf16, packed [P, V_out] int32 (the forward's
// rulebook, packed[p, v] = pos·8 + fm·4 + f0·2 + fp), g [V_out, O] bf16 (the
// output gradient, already masked by the output rows' validity), dw
// [P·3·C, O] f32, rows ordered (pair, tap, channel):
//   dw[(p·3 + t)·C + c, o] = Σ_v flag_t(p, v) · f[row_t(p, v), c] · g[v, o],
//   (row_t, flag_t) = (pos−1, fm), (pos, f0), (pos+f0, fp).
// A tap whose flag is off, or whose row falls outside [0, V_in), adds
// nothing and is never read. C and O are each one of 16, 32, 64, 128, 256
// (the wrapper pads other widths with zero channels). The sum over V runs
// in a fixed order, so two calls with the same inputs give the same bits.
//
// What bounds it on the H100: bytes, as the forward gather-GEMM (2·C·O
// operations per tap found against ≥ 2·C + 2·O + 4 bytes per output row and
// pair). Beyond the bound, a block stages whole steps of TM rows and
// multiplies their flag-free rows as zeros, as the forward does.
//
// Design. Grid (pair · channel chunk, row chunk, column block): a block
// owns one pair, KC channels of each of its three taps, ON ≤ 128 columns of
// O and one chunk of `steps` steps of TM output rows. It
// 1. loads the chunk's rulebook words into shared memory and ORs each
//    step's flags; warp 0 lists the steps with a flag (a ballot), so a step
//    none of whose rows has one of the pair's flags issues no copy and no
//    product;
// 2. runs a STAGES-deep cp.async ring over the listed steps, one barrier a
//    step: a step stages its three tap rows as one A tile [TM, 3·KC] and its
//    gradient rows as one G tile [TM, ON] (zero-filled where a tap's flag is
//    off or its row is out of range, and G where the row has no flag of the
//    pair, so nothing is read for it), and the next steps' copies fly while
//    this one multiplies;
// 3. accumulates Aᵀ·G into [3·KC, ON] f32 registers that live across the
//    chunk. The rows are K, so both operands are MN-major. Where C, O ≥ 64
//    (WG): three warpgroups, one per tap, each a wgmma.m64nONk16 chain over
//    the step's rows, A and G in blocks of 64 columns of 128-byte rows
//    (128-byte swizzle) read by MN-major descriptors. Below: eight warps of
//    mma.sync m16n8k16, both operands loaded by ldmatrix .trans, the warps
//    splitting the tile WM × WN and a step's rows WK ways;
// 4. writes the block's partial [3·KC, ON] once into the workspace [chunks,
//    P·3·C, O] (mma.sync: the WK warp partials summed in order through
//    shared memory first). A second kernel sums the workspace over the
//    chunks in chunk order into dw, one float4 a thread: every launch's
//    sums have one order, the reduction is as parallel as dw is large, and
//    there are no counters to reset and no serial tail in a last block. dw
//    is written once.
// The grid's row chunks are chosen (`chunks_for`) so that the blocks fill
// the card WAVES times over, with no block taking more than ROWS rows (its
// rulebook words are staged whole).
//
// 256 channels (no model conv: efg_tpu takes this kernel only where cout %
// 16 ≠ 0) reuse the 128-wide blocks unchanged. C = 256 is four 64-channel
// chunks (CH = 4), as C = 128 is two. O = 256 is two column blocks of 128
// (the grid's z), each the O = 128 block with its columns offset: one
// block of all 256 columns would need ACC = 128 accumulators a thread over
// three warpgroups (384 threads, past 65 536 / 384 = 170 registers with
// the operands' addresses) and a ring of 2 × 112 KB; each column block
// gathers the step's A tile again (the workspace rows it writes differ
// only in columns). The workspace grows to chunks × P·3·C·O f32: at
// C256·O256 with P = 9 and 30 000 output rows, 8 chunks (the card filled
// 4 times: 132 blocks × 4 over 72 blocks a chunk) of 7.1 MB, about 57 MB.
// Shared memory of a block of the most rows (bytes) and registers as
// `ptxas -v` prints them: C256·O16 131 344 and 96, C256·O32 139 536 and
// 120, C256·O64 214 288 and 92, C256·O128 and O256 181 520 and 128,
// C128·O256 and C64·O256 181 520 and 128, C32·O256 139 536 and 120,
// C16·O256 114 960 and 121; no spills.
//
// The plan (below) is the fastest of those tools/port_kernel_sweep.py timed
// on the flagship's 21 conv backwards (PERF.md §6): wgmma at C, O ≥ 64
// (0.87 ms against mma.sync's 1.21 on the four C = O = 64 calls); 4096 rows
// a block but at C = O = 16 (where they ran 3% slower than 2048); two
// waves of blocks at C64·O128 (its one call, down3: 0.099 ms against 0.119).
//
// The cp.async, ldmatrix, mma.sync and wgmma-descriptor helpers are
// gather_gemm_core.cuh's; this kernel lives in namespace `dw`, so its Plan
// is its own.

#include <type_traits>

#include "gather_gemm_core.cuh"

namespace {
namespace dw {

template <int C, int O>
struct Plan {
  static constexpr int TM = 128;                  // output rows a step
  static constexpr int ON = O < 128 ? O : 128;    // columns of O a block
  static constexpr int KC = C < 64 ? C : 64;      // channels of a tap a block
  static constexpr int WG = C >= 64 && ON >= 64;  // wgmma, a warpgroup per tap
  static constexpr int STAGES = WG ? (ON == 64 ? 3 : 2) : (C == 16 && ON <= 64 ? 3 : 2);
  static constexpr int WM = 3 * KC / 48;          // mma.sync: warps along dW's 3·KC rows
  static constexpr int WN = ON < 64 ? 1 : (ON / 32 < 8 / WM ? ON / 32 : 8 / WM);  // along O
  static constexpr int WK = 8 / (WM * WN);        // along a step's rows
  static constexpr int ROWS = C == 16 && O == 16 ? 2048 : 4096;  // most output rows a block
  static constexpr int WAVES = C == 64 && O == 128 ? 2 : 4;  // blocks per resident block, at least
  static constexpr int MIN_BLOCKS = WG || (C >= 64 && ON == 128) ? 1 : 2;  // the launch bound
};

// What follows from a plan (the plan's members are the Layout's too)
template <int C, int O>
struct Layout : Plan<C, O> {
  using P = Plan<C, O>;
  static constexpr int CH = C / P::KC;             // channel chunks
  static constexpr int ON = P::ON;                 // columns of dW a block
  static constexpr int OS = O / ON;                // column blocks
  static constexpr int M = 3 * P::KC;              // rows of a block's dW tile
  static constexpr bool WGMMA = P::WG != 0;
  static constexpr int THREADS = WGMMA ? 3 * 128 : 32 * P::WM * P::WN * P::WK;
  // mma.sync tiles are padded rows; wgmma tiles are blocks of 64 columns
  // (a tap's channels, or 64 of O) of 128-byte rows, swizzled
  static constexpr int LDA = WGMMA ? 64 : M + kPad;
  static constexpr int LDG = WGMMA ? 64 : ON + kPad;
  static constexpr int A_ELEMS = P::TM * (WGMMA ? M : LDA);
  static constexpr int STAGE_ELEMS = A_ELEMS + P::TM * (WGMMA ? ON : LDG);
  static constexpr int RING_BYTES = P::STAGES * STAGE_ELEMS * 2;
  static constexpr int WTM = M / P::WM, WTN = ON / P::WN;  // mma.sync: warp tile of dW
  static constexpr int KW = P::TM / P::WK;         // a warp's rows of a step
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int ACC = WGMMA ? ON / 2 : MT * NT * 4;  // accumulators a thread
  static constexpr int LDO = ON + 4;               // mma.sync: the partials in shared memory
  static constexpr int OUT_BYTES = WGMMA ? 0 : P::WK * M * LDO * 4;
  static constexpr int BODY_BYTES = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;
  static constexpr int MAX_STEPS = P::ROWS / P::TM;
  static_assert(!WGMMA || (P::KC == 64 && ON % 64 == 0), "wgmma: a tap is one 64-channel block");
  static_assert(C % P::KC == 0 && P::KC % 16 == 0, "whole 16-channel pieces per chunk");
  static_assert(O % ON == 0 && ON <= 128, "column blocks of at most one m64n128");
  static_assert(P::WM * P::WN * P::WK == 8 && M % (16 * P::WM) == 0 && ON % (16 * P::WN) == 0,
                "eight warps over whole m16 tiles and pairs of n8 tiles");
  static_assert(KW % 16 == 0 && P::TM % 32 == 0, "whole k16 slices; a warp's words share a step");
  static_assert(MAX_STEPS >= 1, "a block takes at least one step");
};

// Dynamic shared memory of a block of `steps` steps: the ring (or, after it,
// the warps' partials), the rulebook words, each step's flag, the list of
// steps that run and their count (+ 1024 to align a wgmma ring).
template <int C, int O>
size_t smem_bytes(int steps) {
  using L = Layout<C, O>;
  return L::BODY_BYTES + (size_t)steps * (L::TM + 2) * 4 + 16 + (L::WGMMA ? 1024 : 0);
}

// start the copies of chunk step s into ring slot `slot`
template <int C, int O>
__device__ __forceinline__ void load_step(int s, __nv_bfloat16* slot, const int* s_pk,
                                          const __nv_bfloat16* __restrict__ feat,
                                          const __nv_bfloat16* __restrict__ g, int v_in,
                                          int row0, int ch, int col0) {
  using L = Layout<C, O>;
  constexpr int KV = L::KC / 8;  // 16-byte pieces of a tap
  constexpr int AV = 3 * KV;     // of an A row
  constexpr int GV = L::ON / 8;  // of the block's columns of a G row
  const int* pk = s_pk + s * L::TM;
  const uint32_t a0 = smem_addr(slot);
  for (int i = threadIdx.x; i < L::TM * AV; i += L::THREADS) {
    const int r = i / AV, vc = i % AV;
    const int tap = vc / KV, cv = vc % KV;
    const int v = pk[r];
    const int pos = v >> 3, fl = v & 7;
    const int src = tap == 0 ? pos - 1 : (tap == 1 ? pos : pos + ((fl >> 1) & 1));
    const bool on = ((fl >> (2 - tap)) & 1) && src >= 0 && src < v_in;
    const __nv_bfloat16* p = on ? feat + (size_t)src * C + ch * L::KC + cv * 8 : feat;
    // wgmma: tap t's block of TM 128-byte rows, its pieces permuted by the
    // row's index mod 8 (the 128-byte swizzle)
    const int dst = L::WGMMA ? tap * L::TM * 128 + r * 128 + ((cv ^ (r & 7)) << 4)
                          : (r * L::LDA + vc * 8) * 2;
    cp_async16(a0 + dst, p, on ? 16 : 0);
  }
  const uint32_t g0 = a0 + L::A_ELEMS * 2;
  const size_t grow = (size_t)row0 + (size_t)s * L::TM;
  for (int i = threadIdx.x; i < L::TM * GV; i += L::THREADS) {
    const int r = i / GV, vc = i % GV;
    const bool on = (pk[r] & 7) != 0;  // rows past V_out have no flags
    const int dst = L::WGMMA ? (vc / 8) * L::TM * 128 + r * 128 + (((vc % 8) ^ (r & 7)) << 4)
                          : (r * L::LDG + vc * 8) * 2;
    cp_async16(g0 + dst, on ? g + (grow + r) * O + col0 + vc * 8 : g, on ? 16 : 0);
  }
}

// One step's products. wgmma: warpgroup t multiplies tap t's [TM, 64] block
// (A, MN-major: 8-row K groups 1024 bytes apart) by the gradient rows (B,
// MN-major: the same, 64-column blocks TM·128 bytes apart), all TM rows.
// mma.sync: this warp's [WTM, WTN] tile of Aᵀ·G over its KW rows.
template <int C, int O>
__device__ __forceinline__ void step_products(float (&acc)[Layout<C, O>::ACC],
                                              const __nv_bfloat16* sA, int m0, int n0, int k0) {
  using L = Layout<C, O>;
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_addr(sA), g_base = smem_addr(sA + L::A_ELEMS);
  if constexpr (L::WGMMA) {
    const uint32_t a_tap = a_base + (threadIdx.x / 128) * L::TM * 128;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < L::TM; kk += 16) {
      const uint64_t da = wgmma_desc(a_tap + (kk / 8) * 1024, L::TM * 128, 1024);
      const uint64_t db = wgmma_desc(g_base + (kk / 8) * 1024, L::TM * 128, 1024);
      wgmma_k16<L::ON, 1>(acc, da, db);  // A M-major: the transpose flag
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  } else {
    // ldmatrix .trans rows of this lane: A's 8×8 pieces are (m0-7, k0-7),
    // (m8-15, k0-7), (m0-7, k8-15), (m8-15, k8-15); G's (k0-7, n0-7),
    // (k8-15, n0-7), (k0-7, n8-15), (k8-15, n8-15)
    const int a_k = (lane & 7) + ((lane >> 4) << 3), a_m = ((lane >> 3) & 1) * 8;
    const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < L::KW; kk += 16) {
      uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
        ldmatrix_x4_trans(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                          a_base + ((k0 + kk + a_k) * L::LDA + m0 + mt * 16 + a_m) * 2);
      }
#pragma unroll
      for (int nt = 0; nt < L::NT; nt += 2) {
        ldmatrix_x4_trans(b[nt][0], b[nt][1], b[nt + 1][0], b[nt + 1][1],
                          g_base + ((k0 + kk + b_k) * L::LDG + n0 + nt * 8 + b_n) * 2);
      }
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) mma_bf16(acc + (mt * L::NT + nt) * 4, a[mt], b[nt]);
    }
  }
}

template <int C, int O>
__global__ void __launch_bounds__(Layout<C, O>::THREADS, Plan<C, O>::MIN_BLOCKS)
gather_dw_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ packed,
                 const __nv_bfloat16* __restrict__ g, float* __restrict__ ws, int v_in,
                 int v_out, int n_pairs, int steps) {
  using L = Layout<C, O>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled wgmma tiles start on 1024-byte boundaries (their pattern
  // repeats every 8 rows of 128 bytes)
  unsigned char* smem = smem_raw + (L::WGMMA ? (1024 - (smem_addr(smem_raw) & 1023)) & 1023 : 0);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* s_pk = reinterpret_cast<int*>(smem + L::BODY_BYTES);
  int* s_act = s_pk + steps * L::TM;
  int* s_list = s_act + steps;
  int* s_n = s_list + steps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x / L::CH, ch = blockIdx.x % L::CH, col0 = blockIdx.z * L::ON;
  const int tiles = v_out > 0 ? (v_out + L::TM - 1) / L::TM : 1;
  const int s0 = blockIdx.y * steps;
  const int ns = min(steps, tiles - s0);  // this chunk's steps
  const int row0 = s0 * L::TM;

  // 1. the chunk's rulebook words (zero past V_out) and the steps with a flag
  for (int s = tid; s < ns; s += L::THREADS) s_act[s] = 0;
  __syncthreads();
  for (int i = tid; i < ns * L::TM; i += L::THREADS) {  // a warp's 32 words share a step
    const int r = row0 + i;
    const int v = r < v_out ? packed[(size_t)p * v_out + r] : 0;
    s_pk[i] = v;
    const int any = __reduce_or_sync(0xffffffffu, v & 7);
    if (lane == 0 && any) s_act[i / L::TM] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int e0 = 0; e0 < ns; e0 += 32) {
      const int e = e0 + lane;
      const bool act = e < ns && s_act[e];
      const unsigned b = __ballot_sync(0xffffffffu, act);
      if (act) s_list[base + __popc(b & ((1u << lane) - 1u))] = e;
      base += __popc(b);
    }
    if (lane == 0) *s_n = base;
  }
  __syncthreads();
  const int n = *s_n;

  // 2-3. the ring over the listed steps, products into registers
  const int wk = warp / (L::WM * L::WN), wmn = warp % (L::WM * L::WN);
  const int m0 = (wmn / L::WN) * L::WTM, n0 = (wmn % L::WN) * L::WTN, k0 = wk * L::KW;
  float acc[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < n) {
      load_step<C, O>(s_list[s], ring + s * L::STAGE_ELEMS, s_pk, feat, g, v_in, row0, ch, col0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<L::STAGES - 2>();
    if constexpr (L::WGMMA) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step i has landed everywhere; the slot of step i − 1 is free
    const int nx = i + L::STAGES - 1;
    if (nx < n) {
      load_step<C, O>(s_list[nx], ring + (nx % L::STAGES) * L::STAGE_ELEMS, s_pk, feat, g, v_in,
                      row0, ch, col0);
    }
    cp_async_commit();
    step_products<C, O>(acc, ring + (i % L::STAGES) * L::STAGE_ELEMS, m0, n0, k0);
  }
  cp_async_wait<0>();
  float* dst = ws + (size_t)blockIdx.y * n_pairs * 3 * C * O;
  if constexpr (L::WGMMA) {  // 4. each warpgroup's tap to the workspace once
    const int m = (warp % 4) * 16 + (lane >> 2);  // the tap's channel
    float* row =
        dst + ((size_t)(p * 3 + warp / 4) * C + ch * L::KC + m) * O + col0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < L::ON / 8; ++j) {
      *reinterpret_cast<float2*>(row + j * 8) = make_float2(acc[j * 4], acc[j * 4 + 1]);
      *reinterpret_cast<float2*>(row + 8 * O + j * 8) = make_float2(acc[j * 4 + 2], acc[j * 4 + 3]);
    }
  } else {
    __syncthreads();  // the ring is free for the partials

    // 4. the warps' partials, summed over wk in order, to the workspace once
    float* s_out = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
      const int m = m0 + mt * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int c = n0 + nt * 8 + (lane & 3) * 2;
        const float* d = acc + (mt * L::NT + nt) * 4;
        *reinterpret_cast<float2*>(s_out + (wk * L::M + m) * L::LDO + c) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(s_out + (wk * L::M + m + 8) * L::LDO + c) =
            make_float2(d[2], d[3]);
      }
    }
    __syncthreads();
    constexpr int OV = L::ON / 4;
    for (int i = tid; i < L::M * OV; i += L::THREADS) {
      const int m = i / OV, c = (i % OV) * 4;
      float4 sum = *reinterpret_cast<const float4*>(s_out + m * L::LDO + c);
#pragma unroll
      for (int w = 1; w < L::WK; ++w) {
        const float4 t = *reinterpret_cast<const float4*>(s_out + (w * L::M + m) * L::LDO + c);
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      const int row = (p * 3 + m / L::KC) * C + ch * L::KC + m % L::KC;
      *reinterpret_cast<float4*>(dst + (size_t)row * O + col0 + c) = sum;
    }
  }
}

// dw = Σ_k ws[k] over the chunks, in chunk order
__global__ void __launch_bounds__(256)
sum_chunks_kernel(const float4* __restrict__ ws, float4* __restrict__ out, int n4, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 sum = ws[i];
  for (int k = 1; k < chunks; ++k) {
    const float4 t = ws[(size_t)k * n4 + i];
    sum.x += t.x;
    sum.y += t.y;
    sum.z += t.z;
    sum.w += t.w;
  }
  out[i] = sum;
}

// Let the kernel take the shared memory of a block of MAX_STEPS steps (the
// occupancy query counts no more blocks than that attribute allows)
template <int C, int O>
cudaError_t allow_smem() {
  static bool allowed = false;
  if (allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(gather_dw_kernel<C, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<C, O>(Layout<C, O>::MAX_STEPS));
  allowed = err == cudaSuccess;
  return err;
}

// The row chunks of a call: enough blocks to fill the card WAVES times
// (resident blocks at a chunk of ROWS rows), at most ROWS rows a block, no
// more chunks than TM-row tiles, and then as few chunks as hold the steps a
// chunk takes (so that no chunk is empty).
template <int C, int O>
cudaError_t chunks_for(int v_out, int n_pairs, int* chunks) {
  using L = Layout<C, O>;
  using P = Plan<C, O>;
  static int resident = 0;  // blocks of ROWS rows the card holds at once
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = allow_smem<C, O>();
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_dw_kernel<C, O>,
                                                          L::THREADS, smem_bytes<C, O>(L::MAX_STEPS));
    }
    if (err != cudaSuccess) return err;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long tiles = v_out > 0 ? (v_out + L::TM - 1) / L::TM : 1;
  const long long per_chunk = (long long)n_pairs * L::CH * L::OS;  // blocks of one row chunk
  long long n = ((long long)resident * P::WAVES + per_chunk - 1) / per_chunk;
  const long long fewest = (tiles + L::MAX_STEPS - 1) / L::MAX_STEPS;
  n = n < fewest ? fewest : n;
  n = n > tiles ? tiles : n;
  const long long steps = (tiles + n - 1) / n;
  *chunks = (int)((tiles + steps - 1) / steps);
  return cudaSuccess;
}

template <int C, int O>
cudaError_t launch(const void* feat, const void* packed, const void* g, void* ws, void* out,
                   int v_in, int v_out, int n_pairs, int chunks, cudaStream_t stream) {
  using L = Layout<C, O>;
  const int tiles = v_out > 0 ? (v_out + L::TM - 1) / L::TM : 1;
  if (chunks < 1 || chunks > tiles) return cudaErrorInvalidValue;
  const int steps = (tiles + chunks - 1) / chunks;
  if (steps > L::MAX_STEPS || (tiles + steps - 1) / steps != chunks) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<C, O>();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(n_pairs * L::CH), (unsigned)chunks, (unsigned)L::OS);
  gather_dw_kernel<C, O><<<grid, L::THREADS, smem_bytes<C, O>(steps), stream>>>(
      (const __nv_bfloat16*)feat, (const int*)packed, (const __nv_bfloat16*)g, (float*)ws, v_in,
      v_out, n_pairs, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = n_pairs * 3 * C * O / 4;
  sum_chunks_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>((const float4*)ws, (float4*)out, n4,
                                                         chunks);
  return cudaGetLastError();
}

// f(C, O) for the widths the kernel takes; cudaErrorInvalidValue otherwise
template <typename F>
cudaError_t by_width(int c, int o, F&& f) {
  auto on_o = [&](auto cc) -> cudaError_t {
    switch (o) {
      case 16: return f(cc, std::integral_constant<int, 16>{});
      case 32: return f(cc, std::integral_constant<int, 32>{});
      case 64: return f(cc, std::integral_constant<int, 64>{});
      case 128: return f(cc, std::integral_constant<int, 128>{});
      case 256: return f(cc, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (c) {
    case 16: return on_o(std::integral_constant<int, 16>{});
    case 32: return on_o(std::integral_constant<int, 32>{});
    case 64: return on_o(std::integral_constant<int, 64>{});
    case 128: return on_o(std::integral_constant<int, 128>{});
    case 256: return on_o(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dw
}  // namespace

// The row chunks of a call, i.e. the first dimension of its workspace
// [chunks, P·3·C, O] f32.
extern "C" int efg_gather_dw_chunks(int device, int v_out, int n_pairs, int c, int o,
                                    int* chunks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_pairs < 0 || v_out < 0) return cudaErrorInvalidValue;
  *chunks = 1;
  if (n_pairs == 0) return cudaSuccess;  // an empty dw
  return dw::by_width(c, o, [&](auto cc, auto oo) {
    return dw::chunks_for<decltype(cc)::value, decltype(oo)::value>(v_out, n_pairs, chunks);
  });
}

// dw [P·3·C, O] f32, written whole; ws [chunks, P·3·C, O] f32 is scratch,
// chunks as efg_gather_dw_chunks gave it.
extern "C" int efg_gather_dw(int device, const void* feat, const void* packed, const void* g,
                             void* ws, void* out, int v_in, int v_out, int n_pairs, int c, int o,
                             int chunks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_pairs < 0 || v_out < 0) return cudaErrorInvalidValue;
  if (n_pairs == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return dw::by_width(c, o, [&](auto cc, auto oo) {
    return dw::launch<decltype(cc)::value, decltype(oo)::value>(feat, packed, g, ws, out, v_in,
                                                               v_out, n_pairs, chunks, s);
  });
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
