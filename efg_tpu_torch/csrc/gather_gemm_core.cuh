// gather_gemm_core.cuh: the packed-rulebook gather-GEMM block that
// gather_gemm.cu and gather_gemm_g3.cu share, for Hopper (sm_90a). Each of
// the two sources defines its step plan, `Plan<C, O, EMIT>`, includes this header
// and instantiates `launch<C, O, EMIT>` for the widths it takes; this header
// holds everything else: cp.async with zero fill, ldmatrix and mma.sync,
// the wgmma descriptors and instructions, the 128-byte swizzle offsets, the
// per-pair OR masks, the ballot that lists the steps that run, the ring of
// steps, the stacked writes and the epilogue.
//
// Contract of both sources: features [V_in, C] bf16, packed [P, V_out]
// int32 with packed[p, v] = pos·8 + fm·4 + f0·2 + fp, weights [P·3·C, O]
// bf16 with rows ordered (pair, tap, channel), out [V_out, O] f32:
//   out[v] = Σ_p Σ_t flag_t · f[row_t] @ W[p, t],
//   (row_t, flag_t) = (pos−1, fm), (pos, f0), (pos+f0, fp).
// A tap whose flag is 0 contributes nothing and its row is never read; a set
// flag whose row falls outside [0, V_in) is treated as 0 as well, so no load
// leaves the feature array. The stacked entry also writes stacked
// [V_out, P·3·C] bf16 with stacked[v, (p·3 + t)·C + c] = flag_t · f[row_t(v), c].
//
// The block (see gather_gemm.cu for why each part is there): TM output rows
// × all O columns, 8 warps. The K loop runs over steps; a step is PAIRS
// consecutive pairs × TAPS taps of each × KC channels of a tap, side by side
// in K = PAIRS·TAPS·KC, in the order of a stacked row, so a step's columns
// of `stacked` and its rows of W are each one contiguous range. A plan
// picks PAIRS = 1 (a pair, a tap or a tap's half a step) or PAIRS = 3 (one
// δz-group of three pairs a step, all taps); a group past the last pair
// reads its missing pairs as flag-free rows and zero weights. Each step's A
// tile [TM, K] and [K, O] weight block go into one slot of a STAGES-deep
// ring with one barrier per step; the block's rulebook is loaded once and
// each pair's flags ORed over the tile; a step none of whose pairs has a
// flag among its taps is skipped (its stacked columns written as zeros).
// Products: wgmma.m64nOk16 from 128-byte-swizzled tiles where C, O ≥ 64
// (a step's K is 64 there, one swizzle span), mma.sync + ldmatrix
// otherwise. A plan's LAG = 1 leaves each step's wgmma group in flight
// through the next step's barrier and copies (its ring slot is refilled
// one step later).
//
// Everything here lives in an anonymous namespace: each source is its own
// translation unit and shared library, and its Plan is its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // row padding (16 bytes) of the staged bf16 tiles (mma.sync)

// The step plan of the including source: TM (output rows per block), PAIRS
// (pairs per step), TAPS (taps of each pair per step, 3 or 1), KC (channels
// of a tap per step), STAGES (ring slots), MIN_BLOCKS (the launch bound),
// PERSIST (persistent blocks that prefetch the next tile's rulebook), LAG
// (wgmma groups left in flight across a step, 0 or 1).
template <int C, int O, bool EMIT>
struct Plan;

// What follows from a plan: the tile shapes, strides and warp grid.
template <int C, int O, bool EMIT>
struct Layout {
  using P = Plan<C, O, EMIT>;
  static constexpr int TM = P::TM;
  static constexpr int PAIRS = P::PAIRS;
  static constexpr int TAPS = P::TAPS;
  static constexpr int KC = P::KC;
  static constexpr int CHUNKS = C / KC;           // steps per tap
  static constexpr int SPP = 3 / TAPS * CHUNKS;   // steps per group of PAIRS pairs
  static constexpr int KS = PAIRS * TAPS * KC;    // K of one step
  static constexpr int STAGES = P::STAGES;
  // wgmma (two warpgroups, 64 rows each, all O columns) where C, O ≥ 64
  static constexpr bool WG = C >= 64 && O >= 64;
  static constexpr int LAG = WG ? P::LAG : 0;     // wgmma groups in flight
  static constexpr int AHEAD = STAGES - 1 - LAG;  // steps whose copies fly ahead
  // mma.sync tiles are padded rows; wgmma tiles are 128-byte rows (K = 64),
  // swizzled
  static constexpr int LDA = WG ? KS : KS + kPad;
  static constexpr int LDW = WG ? O : O + kPad;
  static constexpr int A_ELEMS = TM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + KS * LDW;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int WN = WG || O == 16 ? 1 : 2;  // warp grid (wgmma: a warp's 16 rows)
  static constexpr int WM = kWarps / WN;
  static constexpr int WTM = TM / WM;             // warp tile
  static constexpr int WTN = O / WN;
  static constexpr int MT = WTM / 16;             // m16 tiles per warp
  static constexpr int NT = WTN / 8;              // n8 tiles per warp
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(MT >= 1 && WTM % 16 == 0, "a warp's rows are whole m16 tiles");
  static_assert(KS % 16 == 0, "a step's K is a multiple of 16");
  static_assert(TM % 32 == 0 && kThreads % TM == 0, "a warp's rulebook entries share one pair");
  static_assert(PAIRS == 1 || (TAPS == 3 && KC == C), "a group step takes whole pairs");
  static_assert(!WG || (KS == 64 && TM == 128),
                "wgmma: K of one 128-byte swizzle span, two warpgroups of 64 rows");
  static_assert(O <= 256, "a block's columns are at most one m64n256");
  static_assert(LAG <= 1 && AHEAD >= 1, "a slot is refilled only after its wgmma group is done");
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

// D[64, N] += A[64, 16] · B[16, N], B N-major (hence its transpose flag), A
// K-major, or M-major with TRANS_A = 1
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
}

template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
}

template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
}

template <int N, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_m64n64k16<TRANS_A>(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16<TRANS_A>(d, a, b);
  } else {
    wgmma_m64n256k16<TRANS_A>(d, a, b);
  }
}

// keep the compiler from moving accumulator reads or writes across a wgmma fence
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// step e = g·SPP + j covers pairs [g·PAIRS, g·PAIRS + PAIRS), taps
// [t0, t0 + TAPS) of each, channels [ch·KC, ch·KC + KC) of each tap
template <int C, int O, bool EMIT>
struct Step {
  int p0, t0, ch;
  __device__ __forceinline__ explicit Step(int e) {
    using L = Layout<C, O, EMIT>;
    p0 = e / L::SPP * L::PAIRS;
    const int j = e % L::SPP;
    t0 = L::TAPS == 3 ? 0 : j / L::CHUNKS;
    ch = L::TAPS == 3 ? 0 : j % L::CHUNKS;
  }
  // first column of this step in a stacked row, and first row of W
  __device__ __forceinline__ int col() const {
    return (p0 * 3 + t0) * C + ch * Layout<C, O, EMIT>::KC;
  }
  // whether any row of the tile has a flag among this step's taps
  __device__ __forceinline__ bool active(const int* s_mask) const {
    using L = Layout<C, O, EMIT>;
    int m = 0;
#pragma unroll
    for (int j = 0; j < L::PAIRS; ++j) m |= s_mask[p0 + j];
    return L::TAPS == 3 ? m != 0 : ((m >> (2 - t0)) & 1) != 0;
  }
};

// byte offset in a staged A tile of row r's 16-byte piece vc; a wgmma tile
// is TM 128-byte rows (K = 64) whose pieces are permuted by the row's index
// mod 8 (the 128-byte swizzle), so eight rows read at one K
// fall in eight different bank groups
template <int C, int O, bool EMIT>
__device__ __forceinline__ int a_offset(int r, int vc) {
  using L = Layout<C, O, EMIT>;
  if constexpr (L::WG) {
    return r * 128 + ((vc ^ (r & 7)) << 4);
  } else {
    return (r * L::LDA + vc * 8) * 2;
  }
}

// start the cp.async copies of step e into ring slot `slot`; W rows at and
// past w_rows (a group's missing pairs) are zero-filled
template <int C, int O, bool EMIT>
__device__ __forceinline__ void load_step(int e, __nv_bfloat16* slot, const int* s_pk,
                                          const __nv_bfloat16* __restrict__ feat,
                                          const __nv_bfloat16* __restrict__ w, int v_in,
                                          int w_rows) {
  using L = Layout<C, O, EMIT>;
  const Step<C, O, EMIT> st(e);
  constexpr int KV = L::KC / 8;         // 16-byte pieces of one tap
  constexpr int PV = L::TAPS * KV;      // of one pair
  constexpr int AV = L::KS / 8;         // of one A row
  const uint32_t a0 = smem_addr(slot);
  for (int i = threadIdx.x; i < L::TM * AV; i += kThreads) {
    const int r = i / AV, vc = i % AV;
    const int pj = L::PAIRS == 1 ? 0 : vc / PV;  // pair of the step
    const int tap = st.t0 + (L::PAIRS == 1 ? vc : vc % PV) / KV, cv = vc % KV;
    const int v = s_pk[(st.p0 + pj) * L::TM + r];
    const int pos = v >> 3, fl = v & 7;
    const int src = tap == 0 ? pos - 1 : (tap == 1 ? pos : pos + ((fl >> 1) & 1));
    const bool on = ((fl >> (2 - tap)) & 1) && src >= 0 && src < v_in;
    const __nv_bfloat16* g = on ? feat + (size_t)src * C + st.ch * L::KC + cv * 8 : feat;
    cp_async16(a0 + a_offset<C, O, EMIT>(r, vc), g, on ? 16 : 0);
  }
  constexpr int WV = O / 8;
  const int row0 = st.col();
  const __nv_bfloat16* wsrc = w + (size_t)row0 * O;
  const uint32_t w0 = a0 + L::A_ELEMS * 2;
  for (int i = threadIdx.x; i < L::KS * WV; i += kThreads) {
    const int k = i / WV, vc = i % WV;
    // wgmma: 64-column blocks of [K, 64] with 128-byte rows, swizzled
    const int dst = L::WG ? (vc / 8) * L::KS * 128 + k * 128 + (((vc % 8) ^ (k & 7)) << 4)
                          : (k * L::LDW + vc * 8) * 2;
    const bool on = L::PAIRS == 1 || row0 + k < w_rows;
    cp_async16(w0 + dst, on ? wsrc + (size_t)k * O + vc * 8 : w, on ? 16 : 0);
  }
}

// The shared memory of a block past its ring: a tile's rulebook entries
// [n_pp, TM], each pair's OR of tap flags [n_pp], the steps that run and
// their count.
struct TileSmem {
  int* pk;
  int* mask;
  int* steps;
  int* n;
};

template <int C, int O, bool EMIT>
__device__ __forceinline__ TileSmem tile_smem(unsigned char* smem, int n_pp) {
  using L = Layout<C, O, EMIT>;
  TileSmem t;
  t.pk = reinterpret_cast<int*>(smem + L::RING_BYTES);
  t.mask = t.pk + n_pp * L::TM;
  t.steps = t.mask + n_pp;
  t.n = t.steps + n_pp * L::SPP;
  return t;
}

// Warp 0 compacts the steps that run, in order (call between barriers).
template <int C, int O, bool EMIT>
__device__ __forceinline__ void list_steps(const TileSmem& t, int n_all) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int base = 0;
    for (int e0 = 0; e0 < n_all; e0 += 32) {
      const int e = e0 + lane;
      const bool act = e < n_all && Step<C, O, EMIT>(e).active(t.mask);
      const unsigned b = __ballot_sync(0xffffffffu, act);
      if (act) t.steps[base + __popc(b & ((1u << lane) - 1u))] = e;
      base += __popc(b);
    }
    if (lane == 0) *t.n = base;
  }
}

// One step's products on the staged A tile and weight block of sA,
// accumulated in acc (this warp's tile at warp_row, warp_col).
template <int C, int O, bool EMIT>
__device__ __forceinline__ void step_products(float (&acc)[Layout<C, O, EMIT>::MT *
                                                          Layout<C, O, EMIT>::NT * 4],
                                              const __nv_bfloat16* sA, int warp_row,
                                              int warp_col) {
  using L = Layout<C, O, EMIT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* sW = sA + L::A_ELEMS;
  const uint32_t a_base = smem_addr(sA), w_base = smem_addr(sW);
  // this lane's ldmatrix rows: A (row within the m16 tile, k half), B (k row, n half)
  const int a_row = warp_row + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = warp_col + (lane >> 4) * 8;
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
    // with LAG, this step's group runs on while the next step waits, meets
    // the barrier and issues its copies
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(L::LAG) : "memory");
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

// The accumulators to out: row lane/4 [+8], columns 2·(lane%4) + {0, 1}
// of each n8 tile (the wgmma fragment repeats the mma.sync one), whole
// 32-byte sectors, the ragged last tile masked by row.
template <int C, int O, bool EMIT>
__device__ __forceinline__ void store_out(const float (&acc)[Layout<C, O, EMIT>::MT *
                                                             Layout<C, O, EMIT>::NT * 4],
                                          float* __restrict__ out, int row0, int rows,
                                          int warp_row, int warp_col) {
  using L = Layout<C, O, EMIT>;
  const int lane = threadIdx.x & 31;
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

// The tile's products (its accumulators zeroed here) over the ring of its
// steps that run, and with EMIT its stacked taps, zeros included; then its
// rows of out. Every copy the tile issued has landed when it returns.
template <int C, int O, bool EMIT>
__device__ __forceinline__ void run_tile(const TileSmem& t, __nv_bfloat16* ring,
                                         const __nv_bfloat16* __restrict__ feat,
                                         const __nv_bfloat16* __restrict__ w,
                                         float* __restrict__ out,
                                         __nv_bfloat16* __restrict__ stacked, int v_in,
                                         int n_pairs, int n_all, int row0, int rows) {
  using L = Layout<C, O, EMIT>;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t lds = (size_t)n_pairs * 3 * C;  // stacked row length
  const int w_rows = n_pairs * 3 * C;
  const int n = *t.n;

  constexpr int AV = L::KS / 8;
  if (EMIT && n < n_all) {  // the skipped steps' columns of stacked are zero
    for (int e = 0; e < n_all; ++e) {
      const Step<C, O, EMIT> st(e);
      if (st.active(t.mask)) continue;
      for (int i = tid; i < rows * AV; i += kThreads) {
        const int r = i / AV, vc = i % AV;
        if (L::PAIRS > 1 && st.col() + vc * 8 >= (int)lds) continue;  // a missing pair
        __stcs(reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds + st.col() + vc * 8),
               make_uint4(0u, 0u, 0u, 0u));
      }
    }
  }

  float acc[L::MT * L::NT * 4];
#pragma unroll
  for (int k = 0; k < L::MT * L::NT * 4; ++k) acc[k] = 0.0f;

#pragma unroll
  for (int s = 0; s < L::AHEAD; ++s) {
    if (s < n) {
      load_step<C, O, EMIT>(t.steps[s], ring + s * L::STAGE_ELEMS, t.pk, feat, w, v_in, w_rows);
    }
    cp_async_commit();
  }

  // this warp's first output row and column
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int warp_row = L::WG ? (warp / 4) * 64 + (warp % 4) * 16 : wm * L::WTM;
  const int warp_col = wn * L::WTN;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<L::AHEAD - 1>();
    if constexpr (L::WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // step i has landed everywhere; the slot of step i − 1 − LAG is free (its
    // products are done: each warpgroup waited for them before this barrier)
    __syncthreads();
    {
      const int nx = i + L::AHEAD;
      if (nx < n) {
        load_step<C, O, EMIT>(t.steps[nx], ring + (nx % L::STAGES) * L::STAGE_ELEMS, t.pk, feat, w,
                              v_in, w_rows);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* sA = ring + (i % L::STAGES) * L::STAGE_ELEMS;
    if (EMIT) {
      const int col = Step<C, O, EMIT>(t.steps[i]).col();
      for (int j = tid; j < rows * AV; j += kThreads) {
        const int r = j / AV, vc = j % AV;
        if (L::PAIRS > 1 && col + vc * 8 >= (int)lds) continue;  // a missing pair
        __stcs(reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds + col + vc * 8),
               *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(sA) +
                                               a_offset<C, O, EMIT>(r, vc)));
      }
    }
    step_products<C, O, EMIT>(acc, sA, warp_row, warp_col);
  }
  cp_async_wait<0>();
  if constexpr (L::LAG > 0) {  // the last step's products
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  store_out<C, O, EMIT>(acc, out, row0, rows, warp_row, warp_col);
}

// One block per tile of TM output rows: the tile's rulebook entries loaded
// and its pair masks ORed in one pass, then list_steps and run_tile.
template <int C, int O, bool EMIT>
__global__ void __launch_bounds__(kThreads, Plan<C, O, EMIT>::MIN_BLOCKS)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feat, const int* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                   __nv_bfloat16* __restrict__ stacked, int v_in, int v_out, int n_pairs) {
  using L = Layout<C, O, EMIT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled wgmma tiles start on 1024-byte boundaries (their pattern
  // repeats every 8 rows of 128 bytes); written out here: computed in a
  // helper function, it cost the stacked kernels up to 10 registers
  unsigned char* smem = smem_raw + (L::WG ? (1024 - (smem_addr(smem_raw) & 1023)) & 1023 : 0);
  // pairs rounded up to whole steps' groups; the pairs past n_pairs have no flags
  const int n_pp = (n_pairs + L::PAIRS - 1) / L::PAIRS * L::PAIRS;
  const TileSmem t = tile_smem<C, O, EMIT>(smem, n_pp);
  const int row0 = blockIdx.x * L::TM;
  const int rows = min(L::TM, v_out - row0);

  for (int p = threadIdx.x; p < n_pp; p += kThreads) t.mask[p] = 0;
  __syncthreads();
  // the block's rulebook entries, once; rows past V_out read as no flags.
  // kThreads is a multiple of TM, so a warp's 32 entries share one pair.
  for (int i = threadIdx.x; i < n_pp * L::TM; i += kThreads) {
    const int p = i / L::TM, r = i % L::TM;
    const bool real = r < rows && (L::PAIRS == 1 || p < n_pairs);
    const int v = real ? packed[(size_t)p * v_out + row0 + r] : 0;
    t.pk[i] = v;
    const int any = __reduce_or_sync(0xffffffffu, v & 7);
    if ((threadIdx.x & 31) == 0 && any) atomicOr(&t.mask[p], any);
  }
  __syncthreads();
  const int n_all = n_pp / L::PAIRS * L::SPP;
  list_steps<C, O, EMIT>(t, n_all);
  __syncthreads();
  run_tile<C, O, EMIT>(t, reinterpret_cast<__nv_bfloat16*>(smem), feat, w, out, stacked, v_in,
                       n_pairs, n_all, row0, rows);
}

// 4-byte async copy; src_bytes 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Persistent blocks: block b takes tiles b, b + gridDim.x, ... . The
// rulebook entries are double-buffered: the next tile's are copied with
// cp.async while the current tile's steps run (in the ring's first copy
// group), so a tile's first round trip is its first gather, not its
// rulebook.
template <int C, int O, bool EMIT>
__global__ void __launch_bounds__(kThreads, Plan<C, O, EMIT>::MIN_BLOCKS)
gather_gemm_persistent_kernel(const __nv_bfloat16* __restrict__ feat,
                              const int* __restrict__ packed, const __nv_bfloat16* __restrict__ w,
                              float* __restrict__ out, __nv_bfloat16* __restrict__ stacked,
                              int v_in, int v_out, int n_pairs) {
  using L = Layout<C, O, EMIT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled wgmma tiles start on 1024-byte boundaries (their pattern
  // repeats every 8 rows of 128 bytes); written out here: computed in a
  // helper function, it cost the stacked kernels up to 10 registers
  unsigned char* smem = smem_raw + (L::WG ? (1024 - (smem_addr(smem_raw) & 1023)) & 1023 : 0);
  const int n_pp = (n_pairs + L::PAIRS - 1) / L::PAIRS * L::PAIRS;
  TileSmem t = tile_smem<C, O, EMIT>(smem, n_pp);
  int* const pk0 = t.pk;
  int* const pk1 = t.n + 4;  // the second buffer, after the step count
  const int n_tiles = (v_out + L::TM - 1) / L::TM;
  const int n_all = n_pp / L::PAIRS * L::SPP;
  const int n_entries = n_pp * L::TM;

  auto prefetch = [&](int* dst, int tile) {  // a tile's entries, zeros past the call
    const int row0 = tile * L::TM, rows = min(L::TM, v_out - row0);
    for (int i = threadIdx.x; i < n_entries; i += kThreads) {
      const int p = i / L::TM, r = i % L::TM;
      const bool real = tile < n_tiles && r < rows && p < n_pairs;
      cp_async4(smem_addr(dst + i), real ? packed + (size_t)p * v_out + row0 + r : packed,
                real ? 4 : 0);
    }
  };
  prefetch(pk0, blockIdx.x);
  cp_async_commit();
  for (int tile = blockIdx.x, k = 0; tile < n_tiles; tile += gridDim.x, k ^= 1) {
    const int row0 = tile * L::TM;
    const int rows = min(L::TM, v_out - row0);
    t.pk = k ? pk1 : pk0;
    __syncthreads();  // the last tile's readers of its rulebook, masks and steps are done
    for (int p = threadIdx.x; p < n_pp; p += kThreads) t.mask[p] = 0;
    cp_async_wait<0>();  // this tile's entries (the copies of this thread)
    __syncthreads();
    for (int i = threadIdx.x; i < n_entries; i += kThreads) {
      const int any = __reduce_or_sync(0xffffffffu, t.pk[i] & 7);
      if ((threadIdx.x & 31) == 0 && any) atomicOr(&t.mask[i / L::TM], any);
    }
    prefetch(k ? pk0 : pk1, tile + gridDim.x);  // lands with the ring's first group
    __syncthreads();
    list_steps<C, O, EMIT>(t, n_all);
    __syncthreads();
    run_tile<C, O, EMIT>(t, reinterpret_cast<__nv_bfloat16*>(smem), feat, w, out, stacked, v_in,
                         n_pairs, n_all, row0, rows);
  }
  cp_async_wait<0>();
}

struct Args {
  const void* feat;
  const void* packed;
  const void* w;
  void* out;
  void* stacked;
  int v_in, v_out, n_pairs;
};

// Dynamic shared memory of one block: the ring, then the rulebook entries,
// masks and step list of the pairs rounded up to whole groups (persistent
// blocks: and a second buffer of entries; + 1024 to align a wgmma ring).
template <int C, int O, bool EMIT>
size_t smem_bytes(int n_pairs) {
  using L = Layout<C, O, EMIT>;
  const int n_pp = (n_pairs + L::PAIRS - 1) / L::PAIRS * L::PAIRS;
  const size_t second = Plan<C, O, EMIT>::PERSIST ? (size_t)n_pp * L::TM * 4 + 16 : 0;
  return L::RING_BYTES + (size_t)n_pp * (L::TM + 1 + L::SPP) * 4 + 16 + second +
         (L::WG ? 1024 : 0);
}

// A block per tile, or (Plan::PERSIST) as many persistent blocks as the
// card holds at once, each taking every gridDim.x-th tile.
template <int C, int O, bool EMIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<C, O, EMIT>;
  const size_t smem = smem_bytes<C, O, EMIT>(a.n_pairs);
  constexpr bool kPersist = Plan<C, O, EMIT>::PERSIST;
  auto kernel = [] {  // only the kernel the plan runs is instantiated
    if constexpr (kPersist) {
      return gather_gemm_persistent_kernel<C, O, EMIT>;
    } else {
      return gather_gemm_kernel<C, O, EMIT>;
    }
  }();
  static size_t allowed = 48 * 1024;  // dynamic shared memory this instantiation may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const long long tiles = (a.v_out + L::TM - 1) / L::TM;
  long long blocks = tiles;
  if (kPersist) {
    static size_t resident_smem = 0;  // the shared memory `resident` was found for
    static int resident = 0;          // blocks the card holds at once
    if (smem != resident_smem) {
      int device = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      if (err != cudaSuccess) return err;
      resident = sms * per_sm > 0 ? sms * per_sm : 1;
      resident_smem = smem;
    }
    blocks = tiles < resident ? tiles : resident;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)a.feat, (const int*)a.packed, (const __nv_bfloat16*)a.w,
      (float*)a.out, (__nv_bfloat16*)a.stacked, a.v_in, a.v_out, a.n_pairs);
  return cudaGetLastError();
}

// O of 16-128, and of 256 where the source's plans take it (WIDE)
template <int C, bool EMIT, bool WIDE = false>
cudaError_t launch_o(int o, const Args& a, cudaStream_t s) {
  switch (o) {
    case 16: return launch<C, 16, EMIT>(a, s);
    case 32: return launch<C, 32, EMIT>(a, s);
    case 64: return launch<C, 64, EMIT>(a, s);
    case 128: return launch<C, 128, EMIT>(a, s);
    case 256:
      if constexpr (WIDE) return launch<C, 256, EMIT>(a, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
