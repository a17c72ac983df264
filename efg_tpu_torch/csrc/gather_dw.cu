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
// [P·3·C, O] f32 zeroed by the caller, rows ordered (pair, tap, channel):
//   dw[(p·3 + t)·C + c, o] = Σ_v flag_t(p, v) · f[row_t(p, v), c] · g[v, o],
//   (row_t, flag_t) = (pos−1, fm), (pos, f0), (pos+f0, fp).
// A tap whose flag is off, or whose row falls outside [0, V_in), adds
// nothing and is never read. C and O are each one of 16, 32, 64, 128 (the
// wrapper pads other widths with zero channels).
//
// What bounds it on the H100: bytes, as the forward. Each (pair, tap)
// re-gathers its V_out feature rows and re-reads g: ~2·P·3·(C + O) bytes per
// output row against 2·C·O operations per found tap.
// Design: grid (row chunk, pair·3 + tap, channel chunk of ≤ 64). A block
// walks its chunk of kRowsPerBlock output rows 64 at a time: it gathers the
// 64 tap rows [64, KC] and the 64 gradient rows [64, O] into shared memory
// (16-byte loads, zero where the flag is off or past V_out) and accumulates
// tapsᵀ·g with WMMA bf16 16×16×16 products into f32 fragments; the [KC, O]
// result tiles are spread over the four warps. At the end each block adds
// its partial [KC, O] into dw with f32 atomicAdd: the reduction over V runs
// across blocks in no fixed order, so sums differ from run to run in the
// last bits (the wrapper's tolerance says so). Not yet done (later work):
// pipelining the next gather behind the current product, wgmma, and a
// deterministic second-pass reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTM = 64;               // output rows staged per step
constexpr int kRowsPerBlock = 1024;   // output rows reduced by one block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPadBf16 = 8;
constexpr int kPadF32 = 4;

template <int C, int O>
struct Tiles {
  static constexpr int KC = C < 64 ? C : 64;  // channels per block
  static constexpr int LDA = KC + kPadBf16;
  static constexpr int LDG = O + kPadBf16;
  static constexpr int LDO = O + kPadF32;
  static constexpr int A_BYTES = kTM * LDA * 2;
  static constexpr int G_BYTES = kTM * LDG * 2;
  static constexpr int O_BYTES = KC * LDO * 4;
  static constexpr int BYTES =
      A_BYTES + G_BYTES > O_BYTES ? A_BYTES + G_BYTES : O_BYTES;
  static constexpr int N_TILES = (KC / 16) * (O / 16);  // 16×16 result tiles
  static constexpr int TILES_PER_WARP = (N_TILES + kWarps - 1) / kWarps;
};

template <int C, int O>
__global__ void __launch_bounds__(kThreads)
gather_dw_kernel(const __nv_bfloat16* __restrict__ feat,
                 const int* __restrict__ packed,
                 const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ dw, int v_in, int v_out) {
  using T = Tiles<C, O>;
  constexpr int KC = T::KC, LDA = T::LDA, LDG = T::LDG, LDO = T::LDO;
  constexpr int NT = T::N_TILES, TPW = T::TILES_PER_WARP;
  constexpr int NJ = O / 16;  // result tiles per 16-channel strip

  __shared__ __align__(128) unsigned char smem[T::BYTES];
  __shared__ int s_pos[kTM];
  __shared__ int s_flags[kTM];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + T::A_BYTES);
  float* sO = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int pt = blockIdx.y;  // pair·3 + tap
  const int p = pt / 3, t = pt % 3;
  const int kc = blockIdx.z * KC;
  const int first = blockIdx.x * kRowsPerBlock;
  const int last = min(first + kRowsPerBlock, v_out);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int row0 = first; row0 < last; row0 += kTM) {
    if (tid < kTM) {
      const int r = row0 + tid;
      const int v = r < last ? packed[(size_t)p * v_out + r] : 0;  // 0: no flags
      s_pos[tid] = v >> 3;
      s_flags[tid] = v & 7;
    }
    __syncthreads();
    // A: [kTM, KC] tap rows, zero where the flag is off or past the chunk
    constexpr int AV = KC / 8;
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
    }
    // G: [kTM, O] gradient rows, zero past the chunk (no garbage × 0)
    constexpr int GV = O / 8;
    for (int i = tid; i < kTM * GV; i += kThreads) {
      const int r = i / GV, vc = i % GV;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < last) {
        val = __ldg(reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * O + vc * 8));
      }
      *reinterpret_cast<uint4*>(sG + r * LDG + vc * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < NT) {
        const int ci = tile / NJ, oj = tile % NJ;
#pragma unroll
        for (int k = 0; k < kTM; k += 16) {
          // Aᵀ strip: element (c, v) at sA[v·LDA + c], i.e. column-major
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
          wmma::load_matrix_sync(a, sA + k * LDA + ci * 16, LDA);
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sG + k * LDG + oj * 16, LDG);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
    __syncthreads();  // tiles and s_pos/s_flags free for the next step
  }

#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < NT) {
      const int ci = tile / NJ, oj = tile % NJ;
      wmma::store_matrix_sync(sO + ci * 16 * LDO + oj * 16, acc[i], LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  float* dst = dw + ((size_t)pt * C + kc) * O;
  for (int i = tid; i < KC * O; i += kThreads) {
    const int c = i / O, o = i % O;
    atomicAdd(dst + (size_t)c * O + o, sO[c * LDO + o]);
  }
}

template <int C, int O>
cudaError_t launch(const void* feat, const void* packed, const void* g, void* dw,
                   int v_in, int v_out, int n_pairs, cudaStream_t stream) {
  const dim3 grid((unsigned)((v_out + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)(n_pairs * 3), (unsigned)(C / Tiles<C, O>::KC));
  gather_dw_kernel<C, O><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)feat, (const int*)packed, (const __nv_bfloat16*)g,
      (float*)dw, v_in, v_out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_o(int o, const void* feat, const void* packed, const void* g,
                     void* dw, int v_in, int v_out, int n_pairs, cudaStream_t s) {
  switch (o) {
    case 16: return launch<C, 16>(feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 32: return launch<C, 32>(feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 64: return launch<C, 64>(feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 128: return launch<C, 128>(feat, packed, g, dw, v_in, v_out, n_pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int efg_gather_dw(int device, const void* feat, const void* packed,
                             const void* g, void* dw, int v_in, int v_out,
                             int n_pairs, int c, int o, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (v_out == 0 || n_pairs == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 16: return launch_o<16>(o, feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 32: return launch_o<32>(o, feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 64: return launch_o<64>(o, feat, packed, g, dw, v_in, v_out, n_pairs, s);
    case 128: return launch_o<128>(o, feat, packed, g, dw, v_in, v_out, n_pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* efg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
