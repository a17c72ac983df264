// gather_gemm: the packed-rulebook sparse-conv contraction, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_fwd_kernel` (via
// `fused_gather_gemm`): the forward of every SubM and strided sparse conv
// (`efg_gather_gemm`), and its `emit_stacked` use in every backward, which
// also writes out the gathered taps (`efg_gather_gemm_stacked`).
//
// Contract: features [V_in, C] bf16, packed [P, V_out] int32 with
// packed[p, v] = pos·8 + fm·4 + f0·2 + fp, weights [P·3·C, O] bf16 with
// rows ordered (pair, tap, channel), out [V_out, O] f32:
//   out[v] = Σ_p Σ_t flag_t · f[row_t] @ W[p, t],
//   (row_t, flag_t) = (pos−1, fm), (pos, f0), (pos+f0, fp).
// A tap whose flag is 0 contributes nothing and its row is never read (pos
// may equal V_in); a set flag whose row falls outside [0, V_in) is treated
// as 0 as well, so no load leaves the feature array.
// C and O are each one of 16, 32, 64, 128.
//
// Stacked variant: besides `out` it writes the flag-masked tap rows it
// gathers, stacked [V_out, P·3·C] bf16 with
//   stacked[v, (p·3 + t)·C + c] = flag_t · f[row_t(v), c]
// (the transpose of the TPU kernel's [P·3·C, vt] buffer, so that each
// output row's taps are one contiguous row), zeros included.
//
// What bounds it on the H100. Bytes, at every flagship width: a conv does
// 2·C·O operations per tap found against ≥ 2·C + 4·O + 4·P bytes of
// compulsory traffic per output row, far below the card's ~295 operations
// per byte; the stacked entry adds 2·P·3·C bytes written per row, which set
// its bound. What held the first design (64 rows, 4 warps, WMMA 16×16×16)
// back was latency, not bytes: each (pair, tap) step gathered, loaded the
// weights, multiplied and waited at two barriers in turn with nothing in
// flight behind it; every block staged all of W (27·C·O·2 bytes, 5× the
// gathered bytes at C = O = 128); and taps that no row of the tile has
// were multiplied all the same (extra_conv: 3.2% of its taps set, as slow
// as res3 at 40%).
//
// Design:
// - A block owns TM = 128 output rows × all O columns, 8 warps.
// - The K loop runs over steps. C ≤ 32: a step is a whole pair, its three
//   taps side by side (K = 3·C = 48 or 96), so that each step's product
//   covers the next gather. C = 64: one tap (K = 64). C = 128: one tap's
//   half (K = 64). A step stages the A tile [TM, K] (each row's tap rows,
//   16-byte cp.async with the zero-fill form, src-size 0, where the flag is
//   off or the row lies outside [0, V_in): no branch and no load) and its
//   [K, O] weight block (contiguous in W) in one slot of a ring in dynamic
//   shared memory; STAGES − 1 steps are in flight behind the one being
//   multiplied, with one barrier per step (the multistage schedule: wait
//   for the oldest group, barrier, refill the slot the last step freed,
//   multiply).
// - Before the loop the block loads its rulebook entries of every pair
//   once ([P, TM] int32 in shared memory) and forms, with a warp OR
//   reduction, each pair's mask of 3 tap bits over its rows. A step whose
//   taps no row of the tile has set is skipped: no gather, no weight load,
//   no product (exact: it adds only zeros). One warp compacts the steps
//   that remain into a list with a ballot, so the ring runs over them
//   alone. The stacked entry writes the skipped steps' zero columns with
//   plain 16-byte stores. extra_conv (a (3,1,1) conv: 3 of its 27 taps
//   exist) runs 6 of its 54 steps.
// - The weights are streamed through the ring step by step and not kept
//   resident: TM = 128 halves the bytes each output row costs in weight
//   traffic against 64, and a skipped step loads none. Whole-W residency
//   would pay off only in blocks that outlive one tile; at the flagship's
//   V_out (100k-480k rows) every block reads its own W once per tile
//   either way.
// - Products, chosen per width by what bounds it:
//   · C, O ≥ 64 (res2, res3, down3, extra_conv and their backward):
//     wgmma.m64nOk16, A and B from shared memory, two warpgroups of 64 rows.
//     With mma.sync these calls are bound by shared-memory bandwidth: each
//     warp reloads its A and B fragments with ldmatrix, 24 KB per K = 16 of
//     a 128 × 128 tile, where the ring's own writes are 8 KB. wgmma reads
//     each operand once per warpgroup, 12 KB. The tiles are 128-byte rows
//     (K = 64 of A; 64 columns of W, in blocks of KS rows) under the
//     128-byte swizzle, written so by the cp.async copies (16-byte piece
//     v of row r at r·128 + (v ^ r%8)·16); the ring starts on a 1024-byte
//     boundary. W is N-major (the descriptor's transpose flag); its
//     descriptor strides are 1024 bytes per 8 K-rows and KS·128 per 64
//     columns. (Unswizzled 8×8 core-matrix tiles, 1024 bytes apart along
//     M, put the core matrices wgmma reads together in one bank group: on
//     the card they ran slower than mma.sync.)
//   · Otherwise: mma.sync.m16n8k16 in a WM × WN warp grid (O = 16: 8 × 1,
//     else 4 × 2), operands loaded with ldmatrix (B with .trans from the
//     row-major [K, O] tile); rows padded by 16 bytes, an odd number of
//     16-byte units, so the eight rows an ldmatrix phase reads fall in
//     eight different bank groups. These calls are latency-bound (a few µs
//     of dependent round trips per block against KBs of data), so the
//     ring is as deep as leaves the most blocks an SM, as timed on the
//     card: 2 slots at C = 32 (a third slot of K = 96 costs C32·O64 its
//     second block an SM), 3 elsewhere.
// - Stacked writes: once a step's A tile has landed, every thread copies
//   its 16-byte pieces from shared memory to `stacked` with streaming
//   stores (each row's piece of a step is 96-256 contiguous bytes, whole
//   32-byte sectors), made before that step's products, so they drain
//   while the tensor cores run and the next steps' gathers are in flight.
// - The output is written once from the accumulators (float2 per thread,
//   whole 32-byte sectors; the wgmma fragment repeats the mma.sync one per
//   warp), the ragged last tile masked by row.
//
// Shared memory per block (bytes): the ring, STAGES·(TM·LDA + K·LDW)·2, +
// P·(TM + 1 + steps per pair)·4 + 16 for the rulebook, masks and step
// list (+ 1024 to align a wgmma ring). At P = 9 (P = 18 adds 4 680-4 860):
// C16·O16 54 616, C16·O32 59 224, C32·O16 67 160, C32·O32 73 304, C32·O64
// 85 592, C64·O32 75 424, C64·O64 79 520, C64·O128 104 096, C128·O64
// 79 628, C128·O128 104 204. Registers (≤ 128 by the launch bound of two
// blocks an SM), forward / stacked, as `ptxas -v` prints them in
// chip_smoke.py's `device` line: C16·O16 56 / 80, C16·O32 72 / 112,
// C32·O16 58 / 82, C32·O32 76 / 94, C32·O64 100 / 108, C64·O32 80 / 96,
// C64·O64 83 / 114, C64·O128 124 / 128, C128·O64 83 / 96, C128·O128
// 123 / 125; no spills, but for the forward at C16·O128 and C32·O128 (8
// bytes), which no flagship conv runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 128;   // output rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;    // row padding (16 bytes) of the staged bf16 tiles (mma.sync)

template <int C, int O>
struct Plan {
  static constexpr int TAPS = C <= 32 ? 3 : 1;   // taps per step
  static constexpr int KC = C < 64 ? C : 64;     // channels of a tap per step
  static constexpr int CHUNKS = C / KC;          // steps per tap
  static constexpr int SPP = 3 / TAPS * CHUNKS;  // steps per pair
  static constexpr int KS = TAPS * KC;           // K of one step
  static constexpr int STAGES = C == 32 ? 2 : 3;  // ring slots (see the note)
  // wgmma (two warpgroups, 64 rows each, all O columns) where C, O ≥ 64
  static constexpr bool WG = C >= 64 && O >= 64;
  // mma.sync tiles are padded rows; wgmma tiles are 128-byte rows, swizzled
  static constexpr int LDA = WG ? KS : KS + kPad;
  static constexpr int LDW = WG ? O : O + kPad;
  static constexpr int A_ELEMS = kTM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + KS * LDW;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int WN = WG || O == 16 ? 1 : 2;  // warp grid (wgmma: a warp's 16 rows)
  static constexpr int WM = kWarps / WN;
  static constexpr int WTM = kTM / WM;           // warp tile
  static constexpr int WTN = O / WN;
  static constexpr int MT = WTM / 16;            // m16 tiles per warp
  static constexpr int NT = WTN / 8;             // n8 tiles per warp
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(KS % 16 == 0, "a step's K is a multiple of 16");
  static_assert(!WG || KS == 64, "a wgmma tile row is one 128-byte swizzle span");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start, leading
// and stride byte offsets
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D[64, N] += A[64, 16] (K-major) · B[16, N] (N-major, hence the transpose flag)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_m64n64k16(d, a, b);
  } else {
    wgmma_m64n128k16(d, a, b);
  }
}

// keep the compiler from moving accumulator reads or writes across a wgmma fence
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// step e = p·SPP + j covers taps [t0, t0 + TAPS) of pair p, channels
// [ch·KC, ch·KC + KC) of each
template <int C, int O>
struct Step {
  int p, t0, ch;
  __device__ __forceinline__ explicit Step(int e) {
    using L = Plan<C, O>;
    p = e / L::SPP;
    const int j = e % L::SPP;
    t0 = L::TAPS == 3 ? 0 : j / L::CHUNKS;
    ch = L::TAPS == 3 ? 0 : j % L::CHUNKS;
  }
  // first column of this step in a stacked row, and first row of W
  __device__ __forceinline__ int col() const {
    using L = Plan<C, O>;
    return (p * 3 + t0) * C + ch * L::KC;
  }
  // whether any row of the tile has a flag among this step's taps
  __device__ __forceinline__ bool active(const int* s_mask) const {
    const int m = s_mask[p];
    return Plan<C, O>::TAPS == 3 ? m != 0 : ((m >> (2 - t0)) & 1) != 0;
  }
};

// byte offset in a staged A tile of row r's 16-byte piece vc; a wgmma tile
// row is 128 bytes (K = 64) whose pieces are permuted by the row's index
// mod 8 (the 128-byte swizzle), so eight rows read at one K fall in eight
// different bank groups
template <int C, int O>
__device__ __forceinline__ int a_offset(int r, int vc) {
  using L = Plan<C, O>;
  if constexpr (L::WG) {
    return r * 128 + ((vc ^ (r & 7)) << 4);
  } else {
    return (r * L::LDA + vc * 8) * 2;
  }
}

// start the cp.async copies of step e into ring slot `slot`
template <int C, int O>
__device__ __forceinline__ void load_step(int e, __nv_bfloat16* slot, const int* s_pk,
                                          const __nv_bfloat16* __restrict__ feat,
                                          const __nv_bfloat16* __restrict__ w, int v_in) {
  using L = Plan<C, O>;
  const Step<C, O> st(e);
  const int* pk = s_pk + st.p * kTM;
  constexpr int KV = L::KC / 8;    // 16-byte pieces of one tap
  constexpr int AV = L::KS / 8;    // 16-byte pieces of one A row
  const uint32_t a0 = smem_addr(slot);
  for (int i = threadIdx.x; i < kTM * AV; i += kThreads) {
    const int r = i / AV, vc = i % AV;
    const int tap = st.t0 + vc / KV, cv = vc % KV;
    const int v = pk[r];
    const int pos = v >> 3, fl = v & 7;
    const int src = tap == 0 ? pos - 1 : (tap == 1 ? pos : pos + ((fl >> 1) & 1));
    const bool on = ((fl >> (2 - tap)) & 1) && src >= 0 && src < v_in;
    const __nv_bfloat16* g = on ? feat + (size_t)src * C + st.ch * L::KC + cv * 8 : feat;
    cp_async16(a0 + a_offset<C, O>(r, vc), g, on ? 16 : 0);
  }
  constexpr int WV = O / 8;
  const __nv_bfloat16* wsrc = w + (size_t)st.col() * O;
  const uint32_t w0 = a0 + L::A_ELEMS * 2;
  for (int i = threadIdx.x; i < L::KS * WV; i += kThreads) {
    const int k = i / WV, vc = i % WV;
    // wgmma: 64-column blocks of [K, 64] with 128-byte rows, swizzled
    const int dst = L::WG ? (vc / 8) * L::KS * 128 + k * 128 + (((vc % 8) ^ (k & 7)) << 4)
                          : (k * L::LDW + vc * 8) * 2;
    cp_async16(w0 + dst, wsrc + (size_t)k * O + vc * 8, 16);
  }
}

template <int C, int O, bool EMIT>
__global__ void __launch_bounds__(kThreads, 2)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                   __nv_bfloat16* __restrict__ stacked, int v_in, int v_out, int n_pairs) {
  using L = Plan<C, O>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled wgmma tiles start on 1024-byte boundaries (their pattern
  // repeats every 8 rows of 128 bytes)
  unsigned char* smem = smem_raw + (L::WG ? (1024 - (smem_addr(smem_raw) & 1023)) & 1023 : 0);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* s_pk = reinterpret_cast<int*>(smem + L::RING_BYTES);  // [P, TM] rulebook entries
  int* s_mask = s_pk + n_pairs * kTM;                          // [P] OR of the tap flags
  int* s_steps = s_mask + n_pairs;                             // the steps that run
  int* s_n = s_steps + n_pairs * L::SPP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTM;
  const int rows = min(kTM, v_out - row0);
  const int n_all = n_pairs * L::SPP;
  const size_t lds = (size_t)n_pairs * 3 * C;  // stacked row length

  for (int p = tid; p < n_pairs; p += kThreads) s_mask[p] = 0;
  __syncthreads();
  // the block's rulebook entries, once; rows past V_out read as no flags.
  // kThreads is a multiple of kTM, so a warp's 32 entries share one pair.
  for (int i = tid; i < n_pairs * kTM; i += kThreads) {
    const int p = i / kTM, r = i % kTM;
    const int v = r < rows ? packed[(size_t)p * v_out + row0 + r] : 0;
    s_pk[i] = v;
    const int any = __reduce_or_sync(0xffffffffu, v & 7);
    if (lane == 0 && any) atomicOr(&s_mask[p], any);
  }
  __syncthreads();
  if (warp == 0) {  // compact the steps that run, in order
    int base = 0;
    for (int e0 = 0; e0 < n_all; e0 += 32) {
      const int e = e0 + lane;
      const bool act = e < n_all && Step<C, O>(e).active(s_mask);
      const unsigned b = __ballot_sync(0xffffffffu, act);
      if (act) s_steps[base + __popc(b & ((1u << lane) - 1u))] = e;
      base += __popc(b);
    }
    if (lane == 0) *s_n = base;
  }
  __syncthreads();
  const int n = *s_n;

  constexpr int AV = L::KS / 8;
  if (EMIT && n < n_all) {  // the skipped steps' columns of stacked are zero
    for (int e = 0; e < n_all; ++e) {
      const Step<C, O> st(e);
      if (st.active(s_mask)) continue;
      for (int i = tid; i < rows * AV; i += kThreads) {
        const int r = i / AV, vc = i % AV;
        __stcs(reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds + st.col() + vc * 8),
               make_uint4(0u, 0u, 0u, 0u));
      }
    }
  }

  float acc[L::MT * L::NT * 4];
#pragma unroll
  for (int k = 0; k < L::MT * L::NT * 4; ++k) acc[k] = 0.0f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < n) load_step<C, O>(s_steps[s], ring + s * L::STAGE_ELEMS, s_pk, feat, w, v_in);
    cp_async_commit();
  }

  // this warp's first output row and column
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int warp_row = L::WG ? (warp / 4) * 64 + (warp % 4) * 16 : wm * L::WTM;
  const int warp_col = wn * L::WTN;
  // this lane's ldmatrix rows: A (row within the m16 tile, k half), B (k row, n half)
  const int a_row = warp_row + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = warp_col + (lane >> 4) * 8;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<L::STAGES - 2>();
    if constexpr (L::WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step i has landed everywhere; the slot of step i − 1 is free
    {
      const int nx = i + L::STAGES - 1;
      if (nx < n) {
        load_step<C, O>(s_steps[nx], ring + (nx % L::STAGES) * L::STAGE_ELEMS, s_pk, feat, w,
                        v_in);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* sA = ring + (i % L::STAGES) * L::STAGE_ELEMS;
    const __nv_bfloat16* sW = sA + L::A_ELEMS;
    if (EMIT) {
      const int col = Step<C, O>(s_steps[i]).col();
      for (int j = tid; j < rows * AV; j += kThreads) {
        const int r = j / AV, vc = j % AV;
        __stcs(reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds + col + vc * 8),
               *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(sA) +
                                               a_offset<C, O>(r, vc)));
      }
    }
    const uint32_t a_base = smem_addr(sA), w_base = smem_addr(sW);
    if constexpr (L::WG) {
      // warpgroup g multiplies rows [64g, 64g + 64). A (K-major): 8-row
      // groups 1024 bytes apart, a k16 step 32 bytes along the swizzled row.
      // W (N-major): 8-row K groups 1024 bytes apart (a k16 step is two),
      // 64-column blocks KS·128 bytes apart
      const uint32_t a_wg = a_base + (warp / 4) * 64 * 128;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < L::KS; kk += 16) {
        const uint64_t da = wgmma_desc(a_wg + kk * 2, 16, 1024);
        const uint64_t db = wgmma_desc(w_base + (kk / 8) * 1024, L::KS * 128, 1024);
        wgmma_k16<O>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    } else {
#pragma unroll
      for (int kk = 0; kk < L::KS; kk += 16) {
        uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
          ldmatrix_x4(a[mt], a_base + ((a_row + mt * 16) * L::LDA + kk + a_col) * 2);
        }
#pragma unroll
        for (int nt = 0; nt < L::NT; nt += 2) {
          ldmatrix_x4_trans(b[nt][0], b[nt][1], b[nt + 1][0], b[nt + 1][1],
                            w_base + ((kk + b_row) * L::LDW + b_col + nt * 8) * 2);
        }
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt) mma_bf16(acc + (mt * L::NT + nt) * 4, a[mt], b[nt]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulators (row lane/4 [+8], columns 2·(lane%4) + {0, 1} of each n8
  // tile; the wgmma fragment repeats the mma.sync one) straight to out
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    const int r = warp_row + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      const int c = warp_col + nt * 8 + (lane & 3) * 2;
      const float* d = acc + (mt * L::NT + nt) * 4;
      if (r < rows) {
        *reinterpret_cast<float2*>(out + (size_t)(row0 + r) * O + c) = make_float2(d[0], d[1]);
      }
      if (r + 8 < rows) {
        *reinterpret_cast<float2*>(out + (size_t)(row0 + r + 8) * O + c) =
            make_float2(d[2], d[3]);
      }
    }
  }
}

struct Args {
  const void* feat;
  const void* packed;
  const void* w;
  void* out;
  void* stacked;
  int v_in, v_out, n_pairs;
};

template <int C, int O, bool EMIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Plan<C, O>;
  const size_t smem = L::RING_BYTES + (size_t)a.n_pairs * (kTM + 1 + L::SPP) * 4 + 16 +
                      (L::WG ? 1024 : 0);  // room to align the ring
  auto kernel = gather_gemm_kernel<C, O, EMIT>;
  static size_t allowed = 48 * 1024;  // dynamic shared memory this instantiation may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const unsigned blocks = (unsigned)((a.v_out + kTM - 1) / kTM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)a.feat, (const int*)a.packed, (const __nv_bfloat16*)a.w,
      (float*)a.out, (__nv_bfloat16*)a.stacked, a.v_in, a.v_out, a.n_pairs);
  return cudaGetLastError();
}

template <int C, bool EMIT>
cudaError_t launch_o(int o, const Args& a, cudaStream_t s) {
  switch (o) {
    case 16: return launch<C, 16, EMIT>(a, s);
    case 32: return launch<C, 32, EMIT>(a, s);
    case 64: return launch<C, 64, EMIT>(a, s);
    case 128: return launch<C, 128, EMIT>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool EMIT>
int dispatch(int device, int c, int o, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.v_out == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 16: return launch_o<16, EMIT>(o, a, s);
    case 32: return launch_o<32, EMIT>(o, a, s);
    case 64: return launch_o<64, EMIT>(o, a, s);
    case 128: return launch_o<128, EMIT>(o, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int efg_gather_gemm(int device, const void* feat, const void* packed,
                               const void* w, void* out, int v_in, int v_out,
                               int n_pairs, int c, int o, void* stream) {
  return dispatch<false>(device, c, o, Args{feat, packed, w, out, nullptr, v_in, v_out, n_pairs},
                         stream);
}

extern "C" int efg_gather_gemm_stacked(int device, const void* feat, const void* packed,
                                       const void* w, void* out, void* stacked, int v_in,
                                       int v_out, int n_pairs, int c, int o, void* stream) {
  return dispatch<true>(device, c, o, Args{feat, packed, w, out, stacked, v_in, v_out, n_pairs},
                        stream);
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
