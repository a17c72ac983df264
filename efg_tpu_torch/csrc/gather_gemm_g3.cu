// gather_gemm_g3: the packed-rulebook sparse-conv contraction with each
// pair's three tap rows gathered as one span and contracted in one
// K = 3·C product, for Hopper (sm_90a).
//
// Replaces: efg_tpu/ops/pallas/sparse_kernels.py `_fwd_kernel_g3` (the
// group-merged grid that `fused_gather_gemm` runs under EFG_SPARSE_G3 for
// cin <= 64 and at least two δz-groups): the forward (`efg_gather_gemm_g3`)
// and its `emit_stacked` use in the backward (`efg_gather_gemm_g3_stacked`).
//
// Contract (the same as gather_gemm.cu): features [V_in, C] bf16, packed
// [P, V_out] int32 with packed[p, v] = pos·8 + fm·4 + f0·2 + fp, weights
// [P·3·C, O] bf16 with rows ordered (pair, tap, channel), out [V_out, O]
// f32:
//   out[v] = Σ_p Σ_t flag_t · f[row_t] @ W[p, t],
//   (row_t, flag_t) = (pos−1, fm), (pos, f0), (pos+f0, fp);
// a tap whose flag is 0, or whose row falls outside [0, V_in), adds 0.
// The stacked entry also writes stacked [V_out, P·3·C] bf16 with
//   stacked[v, (p·3 + t)·C + c] = flag_t · f[row_t(v), c].
// C is 16, 32 or 64 and O is 16, 32, 64 or 128.
//
// What the TPU kernel does, and the Hopper counterpart of each idea:
// - It gathers from `feat3`, where row v holds (f[v−1], f[v], f[v+1]), so
//   one gather fetches a pair's three δx taps. In a row-major [V_in, C]
//   array those three rows already are one contiguous span of 3·C bf16
//   (96, 192 or 384 bytes) from row pos−1. A block loads the span of each
//   of its (row, pair) with 16-byte `cp.async` copies into one 3·C-wide row
//   of the A tile, and folds `_taps_band`'s fix-up into the copies' zero
//   fill: the −1 third is zero where fm = 0, the middle third where f0 = 0,
//   and the +1 third copies row pos + f0 (the middle row where f0 = 0) and
//   is zero where fp = 0. A row outside [0, V_in) is zero-filled, never
//   read. Then ONE WMMA chain with K = 3·C runs per pair, where
//   gather_gemm.cu runs three chains with K = C, each between two
//   barriers.
// - It keeps the windows of all δz-groups in flight and prefetches the next
//   tile's window DMAs. Here the next pair's span copies and its [3·C, O]
//   weight block are in flight (cp.async, double-buffered) while the
//   current pair's product runs.
// What bounds it on the H100: bytes, as for gather_gemm.cu (~27·C·O·2
// operations per output row against ≥ 2·C + 4·O + 4·P bytes; the stacked
// entry adds 27·C·2 bytes written per row). A block owns TM = 64 output
// rows × all O columns, four warps each a 16-row strip, f32 accumulators
// in registers; the output is written once through shared memory. Shared
// memory is dynamic, up to 152 KB at C = 64, O = 128 (two stages of the
// 64 × 3·C A tile and the 3·C × O weight block). Not yet done (later
// work): wgmma, TMA, more rows per block at the wide shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTM = 64;       // output rows per block
constexpr int kWarps = 4;     // one 16-row strip per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPadBf16 = 8;   // row padding (16 bytes) of the staged bf16 tiles
constexpr int kPadF32 = 4;    // row padding of the f32 output staging tile

template <int C, int O>
struct Smem {
  static constexpr int K = 3 * C;  // one pair's three taps side by side
  static constexpr int LDA = K + kPadBf16;
  static constexpr int LDW = O + kPadBf16;
  static constexpr int LDO = O + kPadF32;
  static constexpr int A_BYTES = kTM * LDA * 2;  // multiples of 128 at every C, O
  static constexpr int W_BYTES = K * LDW * 2;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int O_BYTES = kTM * LDO * 4;
  static constexpr int BYTES = 2 * STAGE > O_BYTES ? 2 * STAGE : O_BYTES;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = on ? 16 : 0;  // 0: zero-fill the 16 bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage s (0 or 1) of the double buffer: its A tile at s·STAGE, its weight
// block right after.
template <int C, int O>
__device__ __forceinline__ __nv_bfloat16* stage(unsigned char* smem, bool weights, int s) {
  using S = Smem<C, O>;
  return reinterpret_cast<__nv_bfloat16*>(smem + s * S::STAGE + (weights ? S::A_BYTES : 0));
}

// Issue the copies of pair p into stage s: the A tile [kTM, 3·C] (each row
// one span, fixed up through the zero fill) and the weight block [3·C, O].
template <int C, int O>
__device__ __forceinline__ void load_pair(unsigned char* smem, int s,
                                          const __nv_bfloat16* __restrict__ feat,
                                          const int* __restrict__ packed,
                                          const __nv_bfloat16* __restrict__ w, int p,
                                          int row0, int v_in, int v_out) {
  using S = Smem<C, O>;
  __nv_bfloat16* sA = stage<C, O>(smem, false, s);
  __nv_bfloat16* sW = stage<C, O>(smem, true, s);
  constexpr int VT = C / 8;   // 16-byte vectors per tap
  constexpr int VR = 3 * VT;  // per span
  for (int i = threadIdx.x; i < kTM * VR; i += kThreads) {
    const int r = i / VR, vc = i % VR, t = vc / VT;
    const int gr = row0 + r;
    const int v = gr < v_out ? __ldg(packed + (size_t)p * v_out + gr) : 0;
    const int pos = v >> 3;
    const int src = t == 0 ? pos - 1 : (t == 1 ? pos : pos + ((v >> 1) & 1));
    const bool on = ((v >> (2 - t)) & 1) && src >= 0 && src < v_in;
    const __nv_bfloat16* g = on ? feat + (size_t)src * C + (vc - t * VT) * 8 : feat;
    cp_async16(sA + r * S::LDA + vc * 8, g, on);
  }
  constexpr int WV = O / 8;
  const __nv_bfloat16* wsrc = w + (size_t)p * S::K * O;
  for (int i = threadIdx.x; i < S::K * WV; i += kThreads) {
    const int k = i / WV, vc = i % WV;
    cp_async16(sW + k * S::LDW + vc * 8, wsrc + (size_t)k * O + vc * 8, true);
  }
}

template <int C, int O, bool EMIT>
__global__ void __launch_bounds__(kThreads)
gather_gemm_g3_kernel(const __nv_bfloat16* __restrict__ feat,
                      const int* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ out, __nv_bfloat16* __restrict__ stacked,
                      int v_in, int v_out, int n_pairs) {
  using S = Smem<C, O>;
  constexpr int NF = O / 16;  // accumulator fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * kTM;
  const size_t lds = (size_t)n_pairs * S::K;  // stacked row length

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  load_pair<C, O>(smem, 0, feat, packed, w, 0, row0, v_in, v_out);
  cp_async_commit();
  for (int p = 0; p < n_pairs; ++p) {
    if (p + 1 < n_pairs) {  // the next pair's copies run behind this pair's product
      load_pair<C, O>(smem, (p + 1) & 1, feat, packed, w, p + 1, row0, v_in, v_out);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sA = stage<C, O>(smem, false, p & 1);
    const __nv_bfloat16* sW = stage<C, O>(smem, true, p & 1);
    if (EMIT) {  // the fixed-up A tile is this pair's slice of the stacked taps
      constexpr int VR = S::K / 8;
      for (int i = threadIdx.x; i < kTM * VR; i += kThreads) {
        const int r = i / VR, vc = i % VR;
        if (row0 + r < v_out) {
          *reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds + (size_t)p * S::K +
                                    vc * 8) =
              *reinterpret_cast<const uint4*>(sA + r * S::LDA + vc * 8);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < S::K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + warp * 16 * S::LDA + k, S::LDA);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sW + k * S::LDW + j * 16, S::LDW);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // this stage is refilled next round (with pair p + 2)
  }

  float* sO = reinterpret_cast<float*>(smem);  // every copy has landed: reuse the stages
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(sO + warp * 16 * S::LDO + j * 16, acc[j], S::LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int OV = O / 4;  // float4 per output row
  for (int i = threadIdx.x; i < kTM * OV; i += kThreads) {
    const int r = i / OV, vc = i % OV;
    if (row0 + r < v_out) {
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * O + vc * 4) =
          *reinterpret_cast<const float4*>(sO + r * S::LDO + vc * 4);
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
  auto kernel = gather_gemm_g3_kernel<C, O, EMIT>;
  constexpr int bytes = Smem<C, O>::BYTES;
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const unsigned blocks = (unsigned)((a.v_out + kTM - 1) / kTM);
  kernel<<<blocks, kThreads, bytes, stream>>>(
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
