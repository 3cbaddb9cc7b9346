// Cluster routines shared by the run kernels (csrc/run_extend.cu,
// csrc/run_extend_dual.cu) and the pop arena (csrc/arena.cu): the layout
// of a partial, the fold of several partials by one warp, and the push of
// a CTA's partial into every CTA's gather rows over distributed shared
// memory.
//
// The member-scoped exchange of the gang kernel (csrc/run_ragged.cu) is
// here too: `mbarrier`s in shared memory, and `st.async` stores into a
// peer CTA's shared memory that complete bytes on the peer's `mbarrier`.
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

// ---------------------------------------------------------------------
// Scoped exchange: a CTA stores its partial straight into each peer's
// gather row with `st.async`, each store completing its bytes on the
// peer's own `mbarrier`; a CTA then waits for its own barrier's phase.
// No CTA waits on a CTA outside its peers (csrc/run_ragged.cu).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// One arrival a phase (the CTA's own, with the bytes it expects).
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Makes the barriers' initialisation visible to the cluster's other CTAs
// (before the cluster barrier that precedes any store into them).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The CTA's arrival on its barrier for this phase, expecting `bytes` from
// its peers' stores (which may land before it: the count goes negative).
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of `parity` has completed; the peers'
// stores of that phase are then visible to the calling thread.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into a peer's shared memory (`remote`, from peer_addr), their
// completion counted on the peer's barrier `remote_bar`.
__device__ __forceinline__ void st_async(uint32_t remote, int4 v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

// 4 bytes, as above.
__device__ __forceinline__ void st_async(uint32_t remote, int v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, "
      "[%2];" ::"r"(remote),
      "r"(v), "r"(remote_bar)
      : "memory");
}

// One warp: the partial `mine` (P words, 16-byte aligned, at the same
// offset `mine - row0` in every CTA) stored into each peer of ranks
// [base, base + n) except `self` (all cluster ranks), each store counted
// on the peer's barrier `bar` (the same offset in every CTA).
__device__ __forceinline__ void push_scoped(const int* mine, int P, int base,
                                            int n, int self, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const int n4 = P / 4;
  const uint32_t src = smem_addr(mine), b = smem_addr(bar);
  const int4* v = reinterpret_cast<const int4*>(mine);
  for (int i = lane; i < n * n4; i += 32) {
    const int q = base + i / n4;
    if (q == self) continue;
    st_async(peer_addr(src + 16u * (i % n4), q), v[i % n4], peer_addr(b, q));
  }
}

}  // namespace clu
