// rank_walk.cuh: what the rank kernels share, for Hopper (sm_90a): the warp
// search that finds a block's place in the keys (all three kernels), and
// the walk of seq4 and hostwin that stages, from there on, the 512-key
// pieces that hold its queries' lower bounds and searches them in shared
// memory.
//
// All compute the rank contract of rank_flags.cu: keys [Vk] int32
// ascending (entries >= INVALID_Q are padding), read as min(key, CLAMP_Q);
// per query q (padding queries read as CLAMP_Q) the count of keys < q and
// whether q−1, q, q+1 are keys.

#pragma once

#include <cuda_runtime.h>

namespace rank_walk {

constexpr int kInvalidQ = 1 << 29;
constexpr int kClampQ = 1 << 30;
constexpr int kPiece = 512;  // keys per staged piece: 128 threads, 16 bytes each
constexpr int kVecs = kPiece / 4;
constexpr int kDir = 32;     // pieces a directory spans: one warp, one piece a lane
constexpr int kSlots = 4;    // pieces staged at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int key_at(const int* __restrict__ keys, int i) {
  return min(__ldg(keys + i), kClampQ);
}

// The key at position p, clamped; CLAMP_Q at and past `lim` (<= Vk).
__device__ __forceinline__ int key_or_clamp(const int* __restrict__ keys, long long lim,
                                            long long p) {
  return p < lim ? key_at(keys, (int)p) : kClampQ;
}

// lower_bound(q[i]) over min(keys, CLAMP_Q) for N targets at once, found by
// one whole warp (every lane calls it with the same arguments). Target i's
// lower bound is known to lie in [lo[i], hi[i]] (hi[i] <= Vk; keys before
// lo[i] are < q[i], the key at hi[i], if any, is >= q[i]); lo[i] == hi[i]
// asks nothing. Each round the 32 lanes probe, for every open target, the
// last key of each of 32 equal segments of its unknown keys [lo, hi)
// (spacing ⌈(hi − lo)/32⌉); the ballot of "key < q" is a prefix of the
// lanes, and its length c leaves the segment after the c-th, less its
// probed key: at most ⌈(hi − lo)/32⌉ − 1 keys. So 4 rounds resolve up to
// 1 082 400 keys (Vk = 480 000 at the flagship's bs=4 stage 0). The N
// targets' probes of a round are issued together, so N searches take the
// round trips of one. The search stops once at most `slack` keys of every
// target are unknown: its lower bound then lies in [lo[i], hi[i]] (slack
// 0: lo == hi, the lower bound). Every probe lies in [lo, hi): nothing at
// or past Vk is read.
template <int N>
__device__ __forceinline__ void warp_lower_bounds(const int* __restrict__ keys, const int (&q)[N],
                                                  int (&lo)[N], int (&hi)[N], int slack = 0) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    bool lt[N], open = false;
    int step[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      step[i] = (hi[i] - lo[i] + 31) >> 5;
      const int idx = lo[i] + (lane + 1) * step[i] - 1;
      const bool ask = hi[i] - lo[i] > slack;
      lt[i] = ask && idx < hi[i] && key_at(keys, idx) < q[i];
      open |= ask;
    }
    if (!open) return;  // lo and hi are the same in every lane
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (hi[i] - lo[i] > slack) {
        lo[i] += __popc(__ballot_sync(kFull, lt[i])) * step[i];
        hi[i] = min(lo[i] + step[i] - 1, hi[i]);
      }
    }
  }
}

// lower_bound(q) over min(keys[0, vk), CLAMP_Q), by one whole warp.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int vk, int q) {
  int qs[1] = {q}, lo[1] = {0}, hi[1] = {vk};
  warp_lower_bounds<1>(keys, qs, lo, hi);
  return lo[0];
}

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The n-th (from 0) set bit of mask.
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
  for (; n > 0; --n) mask &= mask - 1;
  return __ffs(mask) - 1;
}

struct Rank {
  int cnt = 0, fm = 0, f0 = 0, fp = 0;
};

// A block's walk in shared memory.
struct Walk {
  alignas(16) int keys[kSlots][kPiece];  // the staged pieces
  int first[kDir + 1];  // first key of each directory piece, and of the piece after
  int last[kDir];       // last key of each directory piece
  unsigned need;        // directory pieces that hold some searching thread's lower bound
};

// Stage keys [p, p + 4) into dst: one 16-byte cp.async where all four lie
// below lim, else key by key, CLAMP_Q at and past lim.
__device__ __forceinline__ void stage_vec(int* dst, const int* __restrict__ keys, long long lim,
                                          long long p) {
  if (p + 4 <= lim) {
    cp_async16(dst, keys + p);
  } else {
    for (int e = 0; e < 4; ++e) dst[e] = key_or_clamp(keys, lim, p + e);
  }
}

// Rank q in the staged piece s, the piece c of the directory at `base`:
// its position, and the probes, those across the piece's edges from the
// directory (before_dir: the key ahead of the directory).
__device__ __forceinline__ void rank_piece(const Walk& w, const int* s, long long base, int c,
                                           int before_dir, int q, Rank& r) {
  int lo = 0, hi = kPiece;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (min(s[mid], kClampQ) < q) lo = mid + 1; else hi = mid;
  }
  // lo < kPiece: the piece's last key is >= q
  r.cnt = (int)(base + (long long)c * kPiece) + lo;
  const int prev = lo > 0 ? min(s[lo - 1], kClampQ) : c > 0 ? w.last[c - 1] : before_dir;
  r.fm = prev == q - 1;
  r.f0 = min(s[lo], kClampQ) == q;
  const int next = lo + r.f0 < kPiece ? min(s[lo + r.f0], kClampQ) : w.first[c + 1];
  r.fp = next == q + 1;
}

// Rank q against the keys [begin, lim) (lim <= Vk; positions at and past
// `lim` read as CLAMP_Q), given that q's lower bound lies past `begin`
// unless it is 0 (the kernels' −1 on their starts holds this, so the key
// before `begin` is never a probe). Every thread of the block calls it (it
// holds barriers); the threads with `search` rank q.
//
// The keys from `begin` on are cut into 512-key pieces. One warp loads a
// directory of 32 pieces, their first and last keys (one L2 round trip),
// and each searching thread finds the piece that holds its lower bound:
// the first whose last key is >= q. The first `spec` pieces (at most
// kSlots) are staged while the directory loads, with 16-byte cp.async (the
// vector that reaches `lim` key by key); where they hold every lower bound
// that is all. Otherwise the pieces that hold one are staged, up to four at
// a time, all issued together, so their loads overlap one another. Each
// thread then binary-searches its piece in shared memory; the probes that
// cross a piece's edge read the directory. A query past the directory (a
// block that spans more than 16 384 keys) takes the next directory.
__device__ __forceinline__ void walk(Walk& w, const int* __restrict__ keys, long long lim,
                                     long long begin, int spec, bool search, int q, Rank& r) {
  const int lane = threadIdx.x & 31;
  bool open = search;      // q's piece not found yet
  int before_dir = q;      // the key ahead of this directory (q: none that is a probe)
  for (long long base = begin;; base += (long long)kDir * kPiece) {
    if (threadIdx.x < 32) {
      const long long a = base + (long long)lane * kPiece;
      w.first[lane] = key_or_clamp(keys, lim, a);
      w.last[lane] = key_or_clamp(keys, lim, a + kPiece - 1);
      if (lane == 0) {
        w.first[kDir] = key_or_clamp(keys, lim, base + (long long)kDir * kPiece);
        w.need = 0;
      }
    }
    const bool first_dir = base == begin;
    if (first_dir) {  // landed before the barrier, so no later stage races them
      for (int v = threadIdx.x; v < spec * kVecs; v += blockDim.x) {
        stage_vec(&w.keys[v / kVecs][4 * (v % kVecs)], keys, lim,
                  base + (long long)(v / kVecs) * kPiece + 4 * (v % kVecs));
      }
      cp_async_commit_wait_all();
    }
    __syncthreads();
    int c = -1;  // q's piece in this directory
    if (open && q <= w.last[kDir - 1]) {
      int lo = 0, hi = kDir - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (w.last[mid] < q) lo = mid + 1; else hi = mid;
      }
      c = lo;
      atomicOr(&w.need, 1u << c);
    }
    __syncthreads();
    const unsigned need = w.need;
    if (first_dir && (need >> spec) == 0) {  // the staged pieces hold every lower bound
      if (c >= 0) rank_piece(w, w.keys[c], base, c, before_dir, q, r);
    } else {
      const int n_need = __popc(need);
      const int slot = c >= 0 ? __popc(need & ((1u << c) - 1)) : -1;
      for (int g = 0; g < n_need; g += kSlots) {
        const int n_vecs = min(kSlots, n_need - g) * kVecs;
        for (int v = threadIdx.x; v < n_vecs; v += blockDim.x) {
          stage_vec(&w.keys[v / kVecs][4 * (v % kVecs)], keys, lim,
                    base + (long long)nth_bit(need, g + v / kVecs) * kPiece + 4 * (v % kVecs));
        }
        cp_async_commit_wait_all();
        __syncthreads();
        if (slot >= g && slot < g + kSlots) {
          rank_piece(w, w.keys[slot - g], base, c, before_dir, q, r);
        }
        __syncthreads();  // the slots take the next group's pieces
      }
    }
    open = open && c < 0;
    before_dir = w.last[kDir - 1];
    if (!__syncthreads_or(open)) break;  // else the next directory overwrites this one
  }
}

}  // namespace rank_walk
