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
// C and O are each one of 16, 32, 64, 128, 256, in both entries.
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
//   half (K = 64); C = 256, a tap's quarter (K = 64: twelve steps a pair).
//   A step stages the A tile [TM, K] (each row's tap rows,
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
// - O = 256 (ConQueR's res4: the strided conv into it at C = 128, its
//   SubM convs and (3,1,1) out conv at C = 256, and their backward's
//   d_features gathers in the stacked entry; `WIDE`) runs one block a tile
//   over all 256 columns, so each tile's taps are gathered once. A step
//   stages A [128, 64] (16 KB) and W's [64, 256] block (32 KB, four
//   64-column blocks); each warpgroup multiplies its 64 rows with
//   wgmma.m64n256k16 into 128 f32 accumulators a thread, one block an SM
//   (≤ 255 registers), a 4-slot ring (192 KB). The steps' copies run two
//   ahead and each step's wgmma group stays in flight through the next
//   step's barrier and copies (LAG = 1: on the H100 the 5 res4 forward
//   calls ran 24% slower waiting for each step's products,
//   tools/port_kernel_sweep.py `lag0`), so the tensor cores work while the
//   gathers are issued. All eight warps issue the copies, as in every
//   plan: A's rows are gathered (no TMA), W's block would need a tensor
//   map per call (the 128-byte swizzle) for one bulk copy, and a producer
//   warpgroup with setmaxnreg would leave the consumers the same
//   255-register cap they have here. At C ≤ 32 (no model conv) the block
//   is mma.sync over 4 × 2 warps of 32 × 128. The earlier plan, two blocks
//   of the O = 128 plan a tile side by side over O, gathered each tile's
//   taps twice: on res4's calls on the H100 the one block takes 12.5% less
//   device time in the forward and 12.8% less in the stacked entry
//   (PERF.md §6). At C = 256 and P = 18 a stacked row is 13 824 elements;
//   offsets into `stacked` are size_t.
//
// The block itself (rulebook, masks, step list, ring, products, stacked
// writes, epilogue) is gather_gemm_core.cuh, shared with gather_gemm_g3.cu;
// this file holds the step plan below and the instantiations.
//
// Shared memory per block (bytes): the ring, STAGES·(TM·LDA + K·LDW)·2, +
// P·(TM + 1 + steps per pair)·4 + 16 for the rulebook, masks and step
// list (+ 1024 to align a wgmma ring). At P = 9 (P = 18 adds 4 680-4 860):
// C16·O16 54 616, C16·O32 59 224, C32·O16 67 160, C32·O32 73 304, C32·O64
// 85 592, C64·O32 75 424, C64·O64 79 520, C64·O128 104 096, C128·O64
// 79 628, C128·O128 104 204; C256·O16-O128 are the C128 plans with 12
// steps a pair (+ 216 bytes). At O = 256 (4 slots of 48 KB, 2 of 75.5 KB
// at C = 32), in either entry: C16 163 416, C32 159 320, C64 202 400, C128
// 202 508, C256 202 724.
// Registers (≤ 128 by the launch bound of two blocks an SM; ≤ 255 at
// O = 256, one block an SM), forward / stacked, as `ptxas -v` prints them
// in chip_smoke.py's `device` line:
// C16·O16 56 / 80, C16·O32 72 / 112, C16·O64 103 / 114, C16·O128 128 / 128,
// C32·O16 58 / 90, C32·O32 77 / 96, C32·O64 101 / 114, C32·O128 128 / 128,
// C64·O16 60 / 106, C64·O32 80 / 96, C64·O64 83 / 114, C64·O128 124 / 128,
// C128 and C256·O16-O64 55-83 / 94-96, C128 and C256·O128 123 / 125; at
// O = 256, C64-C256 185 / 206 (wgmma), C32 238 / 255 and C16 238 / 239
// (mma.sync). No spills on a model's path; 8 bytes spill in the forward
// C16·O128 and 4 in the stacked C32·O256, which no model conv runs.

#include "gather_gemm_core.cuh"

namespace {

constexpr int kTM = 128;   // output rows per block

template <int C, int O, bool EMIT>
struct Plan {
  static constexpr int TM = kTM;
  static constexpr int PAIRS = 1;                 // a step holds taps of one pair
  static constexpr int TAPS = C <= 32 ? 3 : 1;   // taps per step
  static constexpr int KC = C < 64 ? C : 64;     // channels of a tap per step
  static constexpr int CHUNKS = C / KC;          // steps per tap
  static constexpr int SPP = 3 / TAPS * CHUNKS;  // steps per pair
  static constexpr int KS = TAPS * KC;           // K of one step
  static constexpr bool WIDE = O > 128;          // all 256 columns in one block a tile
  static constexpr int STAGES = C == 32 ? 2 : (WIDE ? 4 : 3);  // ring slots (see the note)
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;  // launch bound: ≤ 255 or ≤ 128 registers
  static constexpr int LAG = WIDE ? 1 : 0;       // wgmma groups left in flight across a step
  static constexpr bool PERSIST = false;         // a block per tile
  static_assert(C < 64 || KS == 64, "a wgmma step is one 128-byte swizzle span");
};

template <bool EMIT>
int dispatch(int device, int c, int o, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.v_out == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 16: return launch_o<16, EMIT, true>(o, a, s);
    case 32: return launch_o<32, EMIT, true>(o, a, s);
    case 64: return launch_o<64, EMIT, true>(o, a, s);
    case 128: return launch_o<128, EMIT, true>(o, a, s);
    case 256: return launch_o<256, EMIT, true>(o, a, s);
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
