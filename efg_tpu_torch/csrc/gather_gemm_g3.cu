// gather_gemm_g3: the packed-rulebook sparse-conv contraction with a step
// plan of its own per entry and width, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_fwd_kernel_g3` (the
// group-merged grid that `fused_gather_gemm` runs under EFG_SPARSE_G3 for
// cin <= 64 and at least two δz-groups): the forward (`efg_gather_gemm_g3`)
// and its `emit_stacked` use in the backward (`efg_gather_gemm_g3_stacked`).
//
// Contract: that of gather_gemm.cu (gather_gemm_core.cuh states it), for C
// of 16, 32 or 64 and O of 16, 32, 64 or 128, and P ≥ 1.
//
// What the TPU kernel is for: its (tile, δz-group) grid paid a fixed cost
// per grid step, so it merged all δz-groups of a tile into one step. The
// block here is gather_gemm.cu's (gather_gemm_core.cuh: 128-row tiles, a
// cp.async ring with one barrier a step, the rulebook loaded once per tile,
// the steps that no row of the tile needs skipped by a ballot, wgmma at C,
// O ≥ 64 and mma.sync below, streaming stores of the stacked taps); the
// plan below is g3's own, per entry and width, each choice the fastest of
// those tools/port_kernel_sweep.py timed on the flagship's calls (PERF.md
// §6):
// - δz-group steps (three pairs with all their taps, K = 9·C) for the
//   stacked entry at C = 16. That entry is bound by the taps it writes,
//   and a group step writes 288 contiguous bytes of a stacked row where a
//   pair step writes 96. Elsewhere group steps ran slower: a group's A tile
//   is three times a pair's, so the ring leaves half the blocks an SM, and
//   the latency-bound forward calls want more rows in flight, not fewer
//   and larger steps. So did a whole pair a step at C = 64 (K = 192, a
//   form the core no longer takes: a wgmma step there is one 64-wide span).
//   Elsewhere the steps are gather_gemm.cu's: a pair (K = 3·C) at C ≤ 32,
//   a tap (K = 64) at C = 64; 3 ring slots, 2 at C = 32 and for groups.
// - Persistent blocks (as many as the card holds at once, each taking
//   every gridDim.x-th tile, the next tile's rulebook copied with cp.async
//   while the current tile's steps run, so a tile's first round trip is
//   its first gather, not its rulebook) for the stacked entry at C = 16 and
//   at C = O = 32, and the forward at C16·O32 (with a launch bound of 4
//   blocks an SM), C32·O64 and C64·O64. Elsewhere they cost more in
//   registers (and so blocks an SM) than they saved.
//
// What bounds it on the H100: bytes, as gather_gemm.cu (2·C·O operations
// per tap found against ≥ 2·C + 4·O + 4·P bytes per output row; the stacked
// entry adds 2·P·3·C bytes written per row and is bound by them).
//
// Shared memory per block (bytes) at P = 9 (P = 18 adds 4 680 at C ≤ 32,
// 4 752 at C = 64, and a persistent block as much again). Forward: C16·O16
// 54 616, C16·O32 63 848, C16·O64 68 440, C16·O128 86 872, C32·O16 67 160,
// C32·O32 73 304, C32·O64 90 216, C32·O128 110 168, C64·O16 69 280, C64·O32
// 75 424, C64·O64 84 144, C64·O128 104 096. Stacked: C16·O16 100 968,
// C16·O32 110 184, C16·O64 128 616, C16·O128 165 480, C32·O16 67 160,
// C32·O32 77 928, C32·O64 85 592, C32·O128 110 168, C64·O16 69 280, C64·O32
// 75 424, C64·O64 79 520, C64·O128 104 096. Registers (≤ 128 by the launch
// bound, 64 for the forward at C16·O32), forward / stacked, "p" a
// persistent kernel, as chip_smoke.py's `device` line prints them: C16·O16
// 56 / 121 p, C16·O32 64 p / 121 p, C16·O64 103 / 128 p, C16·O128 128 /
// 128 p, C32·O16 58 / 90, C32·O32 77 / 127 p, C32·O64 113 p / 114,
// C32·O128 128 / 128, C64·O16 60 / 106, C64·O32 80 / 96, C64·O64 88 p /
// 114, C64·O128 124 / 128; no spills, but 8 bytes at C16·O128 (both),
// which no flagship conv runs.

#include "gather_gemm_core.cuh"

namespace {

template <int C, int O, bool EMIT>
struct Plan {
  static constexpr bool GROUP = EMIT && C == 16;  // δz-group steps
  static constexpr int TM = 128;
  static constexpr int PAIRS = GROUP ? 3 : 1;
  static constexpr int TAPS = C == 64 ? 1 : 3;
  static constexpr int KC = C;
  static constexpr int STAGES = GROUP || C == 32 ? 2 : 3;
  static constexpr int MIN_BLOCKS = !EMIT && C == 16 && O == 32 ? 4 : 2;
  static constexpr bool PERSIST = EMIT ? C == 16 || (C == 32 && O == 32)
                                      : (C == 16 && O == 32) || (C == 32 && O == 64) ||
                                            (C == 64 && O == 64);
  static constexpr int LAG = 0;  // each step's wgmma group done before the next
};

template <bool EMIT>
int dispatch(int device, int c, int o, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.v_out == 0) return cudaSuccess;
  if (a.n_pairs <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 16: return launch_o<16, EMIT>(o, a, s);
    case 32: return launch_o<32, EMIT>(o, a, s);
    case 64: return launch_o<64, EMIT>(o, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int efg_gather_gemm_g3(int device, const void* feat, const void* packed,
                                  const void* w, void* out, int v_in, int v_out,
                                  int n_pairs, int c, int o, void* stream) {
  return dispatch<false>(device, c, o, Args{feat, packed, w, out, nullptr, v_in, v_out, n_pairs},
                         stream);
}

extern "C" int efg_gather_gemm_g3_stacked(int device, const void* feat, const void* packed,
                                          const void* w, void* out, void* stacked, int v_in,
                                          int v_out, int n_pairs, int c, int o, void* stream) {
  return dispatch<true>(device, c, o, Args{feat, packed, w, out, stacked, v_in, v_out, n_pairs},
                        stream);
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
