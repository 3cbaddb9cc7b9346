// Cluster routines shared by the run kernels (csrc/run_extend.cu,
// csrc/run_extend_dual.cu) and the pop arena (csrc/arena.cu): the layout
// of a partial, the fold of several partials by one warp, and the push of
// a CTA's partial into every CTA's gather rows over distributed shared
// memory.
//
// A partial is `Layout::kHead` header words — `kSum` wrapping int32 sums,
// then `kMax` maxima (of values >= 0), then one word of OR'd flags — then,
// for each of `kRows` vote rows, has[A] and counts[A] (float32 bits).  The
// single run kernel has one vote row, the dual one a row per side.  Folds
// are in the order of the partials given: float32 adds with __fadd_rn,
// sums as wrapping unsigned int32, so every CTA that folds the same rows
// in the same order takes the same values.

#pragma once

#include <cooperative_groups.h>

#include <cstdint>

namespace clu {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;

template <int kSum_, int kMax_, int kRows_>
struct Layout {
  static constexpr int kSum = kSum_;
  static constexpr int kMax = kMax_;
  static constexpr int kRows = kRows_;
  static constexpr int kFlags = kSum + kMax;        // the flags word
  static constexpr int kHead = (kFlags + 4) & ~3;   // 16-byte aligned
  // words of one partial (a multiple of 4: partials are copied as int4)
  __host__ __device__ static constexpr int words(int A) {
    return (kHead + 2 * kRows * A + 3) & ~3;
  }
  __host__ __device__ static constexpr int has_at(int A, int v) {
    return kHead + 2 * v * A;
  }
  __host__ __device__ static constexpr int counts_at(int A, int v) {
    return kHead + 2 * v * A + A;
  }
};

// One warp folds partials src[0], ..., src[n - 1] (stride P words, n <=
// 32) in that order.  The header lands in `head` (the same in every
// lane); each vote row's fold is handed to out(v, k, has, count) by the
// lane that owns (row v, symbol k).
template <class L, class Out>
__device__ __forceinline__ void fold(const int* src, int n, int P, int A,
                                     unsigned (&head)[L::kFlags + 1],
                                     Out out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w <= L::kFlags; ++w) {
    const unsigned v = lane < n ? (unsigned)src[lane * P + w] : 0u;
    if (w < L::kSum) {
      head[w] = __reduce_add_sync(kFull, v);
    } else if (w < L::kFlags) {
      head[w] = (unsigned)__reduce_max_sync(kFull, (int)v);
    } else {
      head[w] = __reduce_or_sync(kFull, v);
    }
  }
  // a lane per (row, symbol)
  for (int i = lane; i < L::kRows * A; i += 32) {
    const int v = L::kRows == 1 ? 0 : i / A;
    const int k = i - v * A;
    float c = 0.f;
    int hv = 0;
#pragma unroll 4
    for (int q = 0; q < n; ++q) {
      const int* p = src + q * P;
      c = __fadd_rn(c, __int_as_float(p[L::counts_at(A, v) + k]));
      hv |= p[L::has_at(A, v) + k];
    }
    out(v, k, hv, c);
  }
}

// One warp: store the CTA's partial `part` (P words, 16-byte aligned)
// at `slot` of every CTA of the cluster (the same offset in each CTA's
// shared memory) over distributed shared memory.
__device__ __forceinline__ void push(cg::cluster_group& cl, const int* part,
                                     int P, int* slot, int csize) {
  const int lane = threadIdx.x & 31;
  const int n4 = P / 4;
  const int4* src = reinterpret_cast<const int4*>(part);
  for (int i = lane; i < csize * n4; i += 32) {
    int4* q = reinterpret_cast<int4*>(cl.map_shared_rank(slot, i / n4));
    q[i % n4] = src[i % n4];
  }
}

// One warp: fold the warps' partials wpart[0..nw) in warp order into the
// CTA's partial `part`, then store it into slot `rank` of every CTA's
// gather rows `gath` (kMaxCluster slots of P words) over distributed
// shared memory.
template <class L>
__device__ __forceinline__ void cta_fold(cg::cluster_group& cl,
                                         const int* wpart, int nw, int P,
                                         int A, int* part, int* gath,
                                         int rank, int csize) {
  const int lane = threadIdx.x & 31;
  unsigned head[L::kFlags + 1];
  fold<L>(wpart, nw, P, A, head, [&](int v, int k, int hv, float c) {
    part[L::has_at(A, v) + k] = hv;
    part[L::counts_at(A, v) + k] = __float_as_int(c);
  });
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w <= L::kFlags; ++w) part[w] = (int)head[w];
  }
  __syncwarp();
  push(cl, part, P, gath + (size_t)rank * P, csize);
}

}  // namespace clu
