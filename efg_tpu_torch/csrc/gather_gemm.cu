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
// output row's taps are one contiguous row). It is the A tile the kernel
// already stages in shared memory, stored to global memory as it is loaded.
//
// What bounds it on the H100: bytes. At the flagship widths a conv does
// ~27·C·O·2 operations per output row against ≥ 2·C + 4·O + 4·P bytes of
// compulsory traffic, far below the card's ~295 operations per byte.
// Design: a block owns TM = 64 output rows × all O columns, four warps
// each own a 16-row strip. For every (pair, tap) it gathers the 64 tap rows
// into shared memory as bf16 (16-byte vector loads, zero where the flag is
// off), stages the matching [C, O] weight block, and accumulates with WMMA
// bf16 16×16×16 products into f32 register fragments; the output is written
// once, through shared memory, with the ragged last tile masked. Channels
// are staged in chunks of at most 64 so every case fits 48 KB of static
// shared memory. The TPU kernel's one-hot MXU gathers, HBM window DMAs and
// band bookkeeping have no counterpart: Hopper loads arbitrary rows
// directly. Not yet done (later work): cp.async/TMA pipelining of the next
// tap's gather behind the current product, and wgmma.

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
struct Tiles {
  static constexpr int KC = C < 64 ? C : 64;  // channels staged per step
  static constexpr int LDA = KC + kPadBf16;
  static constexpr int LDW = O + kPadBf16;
  static constexpr int LDO = O + kPadF32;
  static constexpr int A_BYTES = kTM * LDA * 2;
  static constexpr int W_BYTES = KC * LDW * 2;
  static constexpr int O_BYTES = kTM * LDO * 4;
  static constexpr int BYTES =
      A_BYTES + W_BYTES > O_BYTES ? A_BYTES + W_BYTES : O_BYTES;
};

template <int C, int O, bool EMIT>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ feat,
                   const int* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ out, __nv_bfloat16* __restrict__ stacked,
                   int v_in, int v_out, int n_pairs) {
  using T = Tiles<C, O>;
  constexpr int KC = T::KC, LDA = T::LDA, LDW = T::LDW, LDO = T::LDO;
  constexpr int NF = O / 16;  // accumulator fragments per warp

  // the output staging tile reuses the A/W tiles once the products are done
  __shared__ __align__(128) unsigned char smem[T::BYTES];
  __shared__ int s_pos[kTM];
  __shared__ int s_flags[kTM];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
  float* sO = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kTM;
  const size_t lds = (size_t)n_pairs * 3 * C;  // stacked row length

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int p = 0; p < n_pairs; ++p) {
    if (tid < kTM) {
      const int r = row0 + tid;
      const int v = r < v_out ? packed[(size_t)p * v_out + r] : 0;
      s_pos[tid] = v >> 3;
      s_flags[tid] = v & 7;
    }
    __syncthreads();
    for (int t = 0; t < 3; ++t) {
      for (int kc = 0; kc < C; kc += KC) {
        // A: [kTM, KC] tap rows of this (pair, tap), zero where the flag is off
        constexpr int AV = KC / 8;  // 16-byte vectors per row
        for (int i = tid; i < kTM * AV; i += kThreads) {
          const int r = i / AV, vc = i % AV;
          const int pos = s_pos[r], fl = s_flags[r];
          const int src = t == 0 ? pos - 1 : (t == 1 ? pos : pos + ((fl >> 1) & 1));
          const bool on = ((fl >> (2 - t)) & 1) && src >= 0 && src < v_in;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (on) {
            val = __ldg(reinterpret_cast<const uint4*>(feat + (size_t)src * C + kc + vc * 8));
          }
          *reinterpret_cast<uint4*>(sA + r * LDA + vc * 8) = val;
          if (EMIT && row0 + r < v_out) {
            *reinterpret_cast<uint4*>(stacked + (size_t)(row0 + r) * lds +
                                      (p * 3 + t) * C + kc + vc * 8) = val;
          }
        }
        // W: rows (p, t, kc .. kc+KC) of the [P·3·C, O] weight matrix
        constexpr int WV = O / 8;
        const __nv_bfloat16* wsrc = w + ((size_t)(p * 3 + t) * C + kc) * O;
        for (int i = tid; i < KC * WV; i += kThreads) {
          const int k = i / WV, vc = i % WV;
          *reinterpret_cast<uint4*>(sW + k * LDW + vc * 8) =
              __ldg(reinterpret_cast<const uint4*>(wsrc + (size_t)k * O + vc * 8));
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KC; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sA + warp * 16 * LDA + k, LDA);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, sW + k * LDW + j * 16, LDW);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
        __syncthreads();  // tiles (and s_pos/s_flags) free for the next step
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(sO + warp * 16 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int OV = O / 4;  // float4 per output row
  for (int i = tid; i < kTM * OV; i += kThreads) {
    const int r = i / OV, vc = i % OV;
    if (row0 + r < v_out) {
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * O + vc * 4) =
          *reinterpret_cast<const float4*>(sO + r * LDO + vc * 4);
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
  const unsigned blocks = (unsigned)((a.v_out + kTM - 1) / kTM);
  gather_gemm_kernel<C, O, EMIT><<<blocks, kThreads, 0, stream>>>(
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
