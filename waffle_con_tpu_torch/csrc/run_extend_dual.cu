// Fused dual run loop of the dual-consensus search, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_j_run_dual_pallas` (body `_mkkernel_dual`) of
// waffle_con_tpu/ops/pallas_run.py, and the per-lane gather mode of the
// XLA loop `_j_run_dual` (waffle_con_tpu/ops/jax_scorer.py) that stands in
// for it when a side's reads sit at different offsets.  One launch is one
// `run_extend_dual` call on one dual node (two branch slots): both sides
// advance one consensus symbol per step, each with its own nomination,
// with divergence pruning, side locks, the imbalance stop and record
// absorption, and a final stats snapshot of both sides.  Decision for
// decision it computes what waffle_con_tpu_torch/ops/run_dual_kernel.py's
// `run_extend_dual_plain` computes (stop codes 1-6, the float32 vote fold
// under the VOTE_EPS contract, wrapping int32 cost folds).
//
// What bounds it.  Not bytes or operations: a step's work is small (two
// sides x R x W band cells, ~20 int32 operations each), and each step
// needs the decision of the step before, so the loop is bound by the
// latency of one step; and the dual search's launches commit about two
// steps each, so the fixed cost of a launch (state in, snapshot and state
// out) weighs as much as the steps.
//
// Design: the cluster design of csrc/run_extend.cu, with the unit of work
// a (side, read) row.  One thread-block cluster per launch (1-16 CTAs of
// at most 16 warps, the geometry chosen by `plan_run_dual` in
// ops/run_dual_kernel.py and passed in).  Reads are split over the CTAs
// in contiguous blocks, and both sides of a read always sit in one CTA:
// the sides are coupled per read every step (the node cost takes each
// read's better side, the vote weights read both sides' distances,
// pruning compares the two new ones), so that coupling never crosses
// distributed shared memory.
//  * Rows over warps: a warp pair per read, one side each (paired by a
//    64-thread named barrier), while a cluster's CTAs hold 16 rows each;
//    otherwise each warp takes both sides of several reads.  At the dual
//    north star (R = 64, W = 258): 8 CTAs of 16 warps, one row a warp.
//  * The band lives on chip: each CTA loads its reads' rows of both slots
//    into shared memory once (only rows of active reads; a locked side's
//    rows into one buffer, for its snapshot), steps each unlocked side
//    into its second buffer (a column that overflows the band, code 5, is
//    never swapped in), and writes back only the final buffer of rows
//    that were stepped.  A read pruned at a commit gets its new row copied
//    into the other buffer by its warp.  Shapes whose buffers do not fit
//    in 16 CTAs keep the rows in device memory (the slot and a scratch
//    buffer per side) through the template parameter kOnChip.
//  * Each row keeps a ring of its read's symbols in shared memory
//    (band_ops.cuh `RingWindow`), fed one symbol a step, loaded a step
//    ahead, so no device-memory load lies on the step.
//  * One cluster barrier per step.  The column pass of step j
//    (`column_step_runs`, which also takes the new column's tip
//    histogram) is followed, per read, by the pruning of step j and the
//    read's folds of the post-step state: the commit inputs of step j
//    (band overflow, active counts after pruning) and the decision inputs
//    of step j + 1 (cost and record folds, reached flags, each unlocked
//    side's weighted votes under the post-pruning masks).  Warp partials
//    fold per CTA and are pushed into every CTA's gather rows over
//    distributed shared memory (csrc/cluster_ops.cuh, shared with the
//    single kernel); after the barrier warp 0 of every CTA folds them in
//    rank order and takes the same decision: code 5 drops step j and the
//    speculative votes, code 6 commits step j and ends the loop, else
//    step j commits and the decision of step j + 1 stands.
//  * The kernel writes the whole packed output itself (rank 0 the
//    scalars; every CTA a share of the unused symbol slots, zeroed), so a
//    launch needs no memset.
//  * The shard instance (`run_extend_dual_shards_launch`) runs the same
//    kernel on a read-sharded store whose shards share the card, one
//    launch for all of them: each (side, read) row is read and updated in
//    its own shard (csrc/store_shards.cuh), the CTAs' reads, the fold and
//    the outputs stay over the store's global reads, so the launch is the
//    one-store launch of the gathered store bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "band_ops.cuh"
#include "cluster_ops.cuh"
#include "store_shards.cuh"

namespace cg = cooperative_groups;

namespace {

using band::kInf;
using band::ring_len;
using clu::kMaxCluster;
constexpr int kBig = 1 << 28;       // cost of an untracked side
constexpr int kRecCap = 256;        // record buffer rows (REC_CAP)
constexpr int kMaxThreads = 512;    // 16 warps: up to 128 registers a thread
constexpr float kVoteEps = 0.01f;   // VOTE_EPS, float32(1e-2)

// A partial (of a warp, or of a CTA, csrc/cluster_ops.cuh): six sums, two
// maxima, the flags, then a vote row per side (has[A], counts[A]).
using Part = clu::Layout<6, 2, 2>;
constexpr int kTot = 0, kFinTot = 1, kCount0 = 2, kNAny = 3;
constexpr int kCnt2 = 4;            // 4, 5: active reads of each side after
                                    // pruning
constexpr int kMaxEds = 6, kFinMax = 7, kFlags = Part::kFlags;
// flags: a finalized distance out of band; the reached stop (et: a read
// not reached, else: a read reached); band overflow of the step; per side
// k, (kFin0 << k) the side's finish (et: a read not reached, else: a read
// reached) and (kNonexact0 << k) a voting read with a non-dyadic split
constexpr int kFo = 1, kStop = 2, kOvf = 4, kFin0 = 8, kNonexact0 = 32;

// Dynamic shared memory of one CTA (mirrored by run_dual_kernel._smem_bytes).
__host__ __device__ inline size_t smem_bytes(int rpc, int nw, int W, int A,
                                             bool on_chip) {
  const size_t P = Part::words(A);
  const size_t words = (1 + 2 * kMaxCluster) * P + 23 * (size_t)rpc +
                       (size_t)nw * (2 * (size_t)A + P) + 4 * (size_t)A + 8;
  size_t bytes = 4 * words;
  if (on_chip) bytes += 16 * (size_t)rpc * W + 4 * (size_t)rpc * ring_len(W);
  return bytes;
}

struct Args {
  int32_t* D;          // [B, R, W] band store; slots h[0], h[1] updated
  int32_t* e;          // [B, R]
  int32_t* rmin;       // [B, R]
  int32_t* er;         // [B, R]
  const int32_t* off;  // [B, R]
  uint8_t* act;        // [B, R] (torch.bool); pruning writes it back
  int32_t* cons;       // [B, C]
  int32_t* clen;       // [B]
  const int16_t* reads;  // [R, L] dense symbol ids, -1 padded
  const int32_t* rlen;   // [R]
  const int32_t* mc_tab;   // [MCN] vote threshold by vote total
  const int32_t* imb_tab;  // [IMBN] imbalance floor by node length
  int32_t* scratch;    // [2, R, W] second band buffer of each side
                       // (device-memory band only)
  int32_t* out;        // packed outputs (run_dual_kernel.dual_out_layout)
  int32_t* rec_steps;  // [REC_CAP]
  int32_t* rec_planes; // [4, REC_CAP, R]: fin1, fin2, act1, act2
  int h[2], lock[2];
  int R, W, C, L, A, E, MCN, IMBN;
  int me_budget, other_cost, other_len, delta, l2, weighted, max_steps;
  int allow_records, rec_min, mc_dyn, wc, et;
  int csize, nw, rpc, rpw;  // the launch plan (rpw: rows per warp)
  // offsets of the packed output fields, per side
  int o_eds[2], o_split[2], o_reached[2], o_act[2], o_occ[2], o_syms[2];
  // a read-sharded store (csrc/store_shards.cuh): `nsh` shard records in
  // device memory, `Rs` reads each, slots h[] on every shard; the store
  // pointers above (D .. rlen) are then unused.  Null: one store.
  const StoreShard* sh;
  int nsh, Rs;
};

// The words of (side sd, read r): slot h[sd] of the one store, or of read
// r's shard.
__device__ __forceinline__ shards::Cell cell(const Args& a, int sd, int r) {
  const StoreShard own{a.D,    a.e,   a.rmin,
                       a.er,   const_cast<int32_t*>(a.off),
                       a.act,  a.cons, a.clen,
                       a.reads, a.rlen};
  return shards::cell(a.sh, a.Rs, own, a.R, a.W, a.L, a.h[sd], r);
}

// Read r's symbols [L].
__device__ __forceinline__ const int16_t* read_row(const Args& a, int r) {
  if (a.sh) {
    const int k = r / a.Rs;
    return a.sh[k].reads + (size_t)(r - k * a.Rs) * a.L;
  }
  return a.reads + (size_t)r * a.L;
}

// Slot h[sd]'s consensus row and length word in copy k of the store
// (every shard holds one; the one store is copy 0).
__device__ __forceinline__ int copies(const Args& a) {
  return a.sh ? a.nsh : 1;
}
__device__ __forceinline__ int32_t* cons_row(const Args& a, int k, int sd) {
  return (a.sh ? a.sh[k].cons : a.cons) + (size_t)a.h[sd] * a.C;
}
__device__ __forceinline__ int32_t* clen_at(const Args& a, int k, int sd) {
  return (a.sh ? a.sh[k].clen : a.clen) + a.h[sd];
}

// The per-read words of a CTA: field k of side sd at rd[(2k + sd) * rpc].
enum Field {
  kE, kRmin, kEr,       // committed folds
  kE2, kRmin2, kEr2,    // folds after the column (a locked side's stay
                        // equal)
  kFin, kFin2,          // finalized distances, committed and after the step
  kOff, kAct, kAct2,    // act2: activity after pruning
  kFields
};

struct Smem {
  int32_t* band;  // [2 sides, 2 buffers, rpc, W] (on-chip band only)
  int* part;      // [P] the CTA's partial
  int* gath;      // [2, kMaxCluster, P] every CTA's partial, by parity
  int* rd;        // [kFields, 2, rpc] per-read words
  int rpc;
  int* rlen;      // [rpc]
  int* hist;      // [nw, 2, A] tip histograms
  int* wpart;     // [nw, P] per-warp partials
  float* gcount; int* ghas;  // [2, A] the cluster's votes
  int* dec;       // [8] warp 0's decision
  int16_t* ring;  // [2, rpc, ring_len(W)] (on-chip band only)
  __device__ __forceinline__ int* f(Field k, int sd) const {
    return rd + (2 * k + sd) * rpc;
  }
};

template <bool kOnChip>
__device__ inline Smem carve(char* base, const Args& a) {
  Smem s;
  const int P = Part::words(a.A);
  if (kOnChip) {
    s.band = reinterpret_cast<int32_t*>(base);
    base += 16 * (size_t)a.rpc * a.W;
  } else {
    s.band = nullptr;
  }
  int* p = reinterpret_cast<int*>(base);
  s.part = p; p += P;  // 16-byte aligned: copied over DSMEM as int4
  s.gath = p; p += 2 * kMaxCluster * P;
  s.rd = p; p += 2 * kFields * a.rpc;
  s.rpc = a.rpc;
  s.rlen = p; p += a.rpc;
  s.hist = p; p += a.nw * 2 * a.A;
  s.wpart = p; p += a.nw * P;
  s.gcount = reinterpret_cast<float*>(p); p += 2 * a.A;
  s.ghas = p; p += 2 * a.A;
  s.dec = p; p += 8;
  s.ring = kOnChip ? reinterpret_cast<int16_t*>(p) : nullptr;
  return s;
}

// The cluster barrier in two halves (every thread of the cluster arrives
// once, then waits), so the work between them hides its latency.  The
// arrival orders nothing; the wait acquires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Per-thread view of the launch: who this warp is and which rows it owns.
struct Ctx {
  int rank, warp, lane, P;
  int r0, nloc;   // first read of the CTA, reads the CTA owns
  int lo, hi;     // local reads [lo, hi) of this warp
  int s0, ns;     // its sides: s0 only (ns = 1, a warp pair per read) or
                  // both (ns = 2)
  int ring_mask;
  // this warp owns side sd of its reads
  __device__ __forceinline__ bool mine(int sd) const {
    return ns == 2 || sd == s0;
  }
};

// The warps of a read meet: the two warps of a pair at a 64-thread named
// barrier (id 1 + pair), a warp that owns both sides at a warp barrier.
__device__ __forceinline__ void pair_sync(const Ctx& x) {
  if (x.ns == 1) {
    asm volatile("bar.sync %0, 64;" ::"r"(1 + (x.warp >> 1)) : "memory");
  } else {
    __syncwarp();
  }
}

// Band row of side sd, local read lr (global r), in buffer buf.
template <bool kOnChip>
__device__ __forceinline__ int32_t* row(const Args& a, const Smem& s, int sd,
                                        int buf, int lr, int r) {
  if (kOnChip) return s.band + ((size_t)(2 * sd + buf) * a.rpc + lr) * a.W;
  if (buf == 0) return cell(a, sd, r).D;
  return a.scratch + ((size_t)sd * a.R + r) * a.W;
}

__device__ __forceinline__ int16_t* ring_of(const Smem& s, const Ctx& x,
                                            const Args& a, int sd, int lr) {
  return s.ring + ((size_t)sd * a.rpc + lr) * (x.ring_mask + 1);
}

// Symbol of read r at position i (-1 outside [0, L)), from device memory.
__device__ __forceinline__ int read_sym(const Args& a, int r, int i) {
  return i >= 0 && i < a.L ? read_row(a, r)[i] : -1;
}

__device__ __forceinline__ unsigned cost_of(int x, int l2) {
  const unsigned u = (unsigned)x;
  return l2 ? u * u : u;  // wrapping int32, as on the TPU
}

// Vote weight of side sd of a read with activity (n0, n1) and distances
// (e0, e1) (reference get_ed_weights under `weighted`; otherwise full
// weight for a tracked read).
__device__ __forceinline__ float weight(const Args& a, int sd, int n0, int n1,
                                        int e0, int e1) {
  const int mine = sd ? n1 : n0;
  if (!a.weighted || !(n0 && n1)) return mine ? 1.f : 0.f;
  const float c1 = fmaxf((float)e0, 0.5f);
  const float c2 = fmaxf((float)e1, 0.5f);
  return __fdiv_rn(sd ? c1 : c2, __fadd_rn(c1, c2));
}

// Tip histogram of side sd of local read lr over buffer buf at consensus
// length j into `hist`; returns the split.
template <bool kOnChip>
__device__ __forceinline__ int tips(const Args& a, const Smem& s,
                                    const Ctx& x, int sd, int buf, int lr,
                                    int j, int* hist) {
  const int r = x.r0 + lr;
  const int32_t* Dv = row<kOnChip>(a, s, sd, buf, lr, r);
  const int i0 = j - s.f(kOff, sd)[lr] - a.E;
  const int e = s.f(kE, sd)[lr], rl = s.rlen[lr];
  if (kOnChip) {
    const band::RingWindow win{ring_of(s, x, a, sd, lr), x.ring_mask};
    return band::tip_histogram_win(Dv, win, a.W, rl, i0, e, hist);
  }
  const band::GlobalWindow win{read_row(a, r), a.L};
  return band::tip_histogram_win(Dv, win, a.W, rl, i0, e, hist);
}

// One warp's pass over its rows.  `step`: first advance each active row of
// each unlocked side from buffer cur (length clen) into cur ^ 1 by
// consuming sym, prune on the new distances, then fold the post-step
// state; otherwise fold the committed state (its tip histograms taken
// here).  The folds and votes go into the warp's partial; the post-step
// activity and finalized distances into act2 / fin2.
template <bool kOnChip>
__device__ void warp_pass(const Args& a, const Smem& s, const Ctx& x,
                          bool step, int cur, int clen0, int clen1,
                          int sym0, int sym1) {
  const int lane = x.lane;
  int* wp = s.wpart + x.warp * x.P;
  for (int i = lane; i < 4 * a.A; i += 32) wp[Part::kHead + i] = 0;
  __syncwarp();
  unsigned tot = 0, ftot = 0;
  int count0 = 0, n_any = 0, cnt0 = 0, cnt1 = 0, mx_eds = 0, mx_fin = 0;
  int flags = 0;
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
    const int rl = s.rlen[lr];
    int split[2] = {0, 0};
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      if (!x.mine(sd) || a.lock[sd] || !s.f(kAct, sd)[lr]) continue;
      int* hist = s.hist + (x.warp * 2 + sd) * a.A;
      const int clen = sd ? clen1 : clen0;
      if (!step) {
        split[sd] = tips<kOnChip>(a, s, x, sd, cur, lr, clen, hist);
        continue;
      }
      const int32_t* Dv = row<kOnChip>(a, s, sd, cur, lr, r);
      int32_t* Dn = row<kOnChip>(a, s, sd, cur ^ 1, lr, r);
      const int i0 = clen + 1 - s.f(kOff, sd)[lr] - a.E;
      const int sym = sd ? sym1 : sym0;
      const band::Folds3 f0{s.f(kE, sd)[lr], s.f(kRmin, sd)[lr],
                            s.f(kEr, sd)[lr]};
      band::Folds3 f;
      if (kOnChip) {
        const band::RingWindow win{ring_of(s, x, a, sd, lr), x.ring_mask};
        f = band::column_step_runs(Dv, Dn, win, a.W, rl, i0, sym, a.wc, a.et,
                                   f0, hist, &split[sd]);
      } else {
        const band::GlobalWindow win{read_row(a, r), a.L};
        f = band::column_step_runs(Dv, Dn, win, a.W, rl, i0, sym, a.wc, a.et,
                                   f0, hist, &split[sd]);
      }
      if (lane == 0) {
        s.f(kE2, sd)[lr] = f.e;
        s.f(kRmin2, sd)[lr] = f.rmin;
        s.f(kEr2, sd)[lr] = f.er;
      }
    }
    pair_sync(x);
    // divergence pruning on the new distances (a locked side's e2 is its
    // frozen e, which counts in the overflow test too)
    const int a0 = s.f(kAct, 0)[lr], a1 = s.f(kAct, 1)[lr];
    const int e0 = s.f(kE2, 0)[lr], e1 = s.f(kE2, 1)[lr];
    int n0 = a0, n1 = a1;
    if (step) {
      const int both = a0 && a1;
      n0 = a0 && !(both && e1 + a.delta < e0);
      n1 = a1 && !(both && e0 + a.delta < e1);
      if ((x.mine(0) && a0 && e0 >= a.E) || (x.mine(1) && a1 && e1 >= a.E))
        flags |= kOvf;
    }
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      if (!x.mine(sd)) continue;
      const int nsd = sd ? n1 : n0;
      if (sd) cnt1 += nsd; else cnt0 += nsd;
      if (lane == 0) s.f(kAct2, sd)[lr] = nsd;
      if (a.lock[sd]) continue;
      // the side's votes of the next step, under the post-pruning masks
      int* hist = s.hist + (x.warp * 2 + sd) * a.A;
      const int sp = split[sd];
      const float w = weight(a, sd, n0, n1, e0, e1);
      const bool voting = w > 0.f && sp > 0;
      const float split_f = (float)max(sp, 1);
      int* whas = wp + Part::has_at(a.A, sd);
      float* wcount = reinterpret_cast<float*>(wp + Part::counts_at(a.A, sd));
      for (int k = lane; k < a.A; k += 32) {
        const int c = hist[k];
        if (voting && c > 0) {
          wcount[k] = __fadd_rn(wcount[k],
                                __fmul_rn(__fdiv_rn((float)c, split_f), w));
          whas[k] = 1;
        }
        hist[k] = 0;
      }
      if (voting && (sp & (sp - 1)) != 0) flags |= kNonexact0 << sd;
    }
    if (x.s0 == 0) {
      // the read's cost and record folds (by the side-0 warp of a pair)
      const int eda = n0 ? e0 : 0, edb = n1 ? e1 : 0;
      const unsigned ca = cost_of(eda, a.l2), cb = cost_of(edb, a.l2);
      const int best = min(n0 ? (int)ca : kBig, n1 ? (int)cb : kBig);
      const int any = n0 || n1;
      tot += any ? (unsigned)best : 0u;
      int fin0 = 0, fin1 = 0;
      if (n0) {
        const int fu = max(e0, s.f(kRmin2, 0)[lr]);
        fin0 = min(fu, kInf);
        if (fu >= a.E) flags |= kFo;
      }
      if (n1) {
        const int fu = max(e1, s.f(kRmin2, 1)[lr]);
        fin1 = min(fu, kInf);
        if (fu >= a.E) flags |= kFo;
      }
      const unsigned fc0 = cost_of(fin0, a.l2), fc1 = cost_of(fin1, a.l2);
      const int side0 = n0 && (!n1 || (int)fc0 <= (int)fc1);
      ftot += any ? (side0 ? fc0 : fc1) : 0u;
      count0 += side0 && any;
      n_any += any;
      mx_eds = max(mx_eds, max(eda, edb));
      mx_fin = max(mx_fin, max(fin0, fin1));
      const int er0 = s.f(kEr2, 0)[lr], er1 = s.f(kEr2, 1)[lr];
      const int re0 = n0 && er0 < kInf && e0 == er0;
      const int re1 = n1 && er1 < kInf && e1 == er1;
      const int f0 = a.et ? (n0 && !re0) : re0;
      const int f1 = a.et ? (n1 && !re1) : re1;
      const int st = a.et ? (any && !(re0 || re1)) : (re0 || re1);
      if (f0) flags |= kFin0;
      if (f1) flags |= kFin0 << 1;
      if (st) flags |= kStop;
      if (lane == 0) {
        s.f(kFin2, 0)[lr] = fin0;
        s.f(kFin2, 1)[lr] = fin1;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    wp[kTot] = (int)tot;
    wp[kFinTot] = (int)ftot;
    wp[kCount0] = count0;
    wp[kNAny] = n_any;
    wp[kCnt2] = cnt0;
    wp[kCnt2 + 1] = cnt1;
    wp[kMaxEds] = mx_eds;
    wp[kFinMax] = mx_fin;
    wp[kFlags] = flags;
  }
}

// One side's nomination (the JAX package's `_dual_votes` +
// `_nominate_side`): wildcard drop, candidates recounted after it, the
// mc_tab threshold at the rounded vote total, EPS near-tie guard,
// first-max tie-break.  Run by one lane.
__device__ __forceinline__ void nominate(const Args& a, const float* counts,
                                         const int* has, bool nonexact,
                                         bool* dirty, int* sym_out) {
  int n_raw = 0;
#pragma unroll 4
  for (int k = 0; k < a.A; ++k) n_raw += has[k] != 0;
  const int dropped = a.wc >= 0 && n_raw > 1 ? a.wc : -1;
  int n_cands = 0;
  float n_vote_f = 0.f;
#pragma unroll 4
  for (int k = 0; k < a.A; ++k) {
    n_cands += has[k] != 0 && k != dropped;
    n_vote_f = __fadd_rn(n_vote_f, k != dropped ? counts[k] : 0.f);
  }
  bool exactable = !nonexact && !a.weighted;
  const float n_vote_r = rintf(n_vote_f);  // half to even, as jnp.round
  const bool int_ok = fabsf(__fsub_rn(n_vote_f, n_vote_r)) < kVoteEps;
  const bool tab_bad = a.mc_dyn && !int_ok;
  exactable = exactable && !tab_bad;
  const int idx = min(max((int)n_vote_r, 0), a.MCN - 1);
  const float mc_f = (float)a.mc_tab[idx];
  float maxc = -1.f;
#pragma unroll 4
  for (int k = 0; k < a.A; ++k)
    maxc = fmaxf(maxc, has[k] && k != dropped ? counts[k] : -1.f);
  const float thr = fminf(mc_f, maxc);
  int npass = 0, sym = 0;
  bool near_any = false;
  float best = -1.f;
#pragma unroll 4
  for (int k = 0; k < a.A; ++k) {
    const bool hv = has[k] != 0 && k != dropped;
    const float c = k != dropped ? counts[k] : 0.f;
    const bool passing = hv && c >= thr;
    npass += passing;
    near_any = near_any || (hv && fabsf(__fsub_rn(c, thr)) < kVoteEps);
    const float ca = passing ? c : -1.f;
    if (ca > best) {
      sym = k;
      best = ca;
    }
  }
  const bool near_tie = fabsf(__fsub_rn(maxc, mc_f)) < kVoteEps || near_any;
  *dirty = (!exactable && near_tie) || npass != 1 || n_cands == 0 || tab_bad;
  *sym_out = sym;
}

// The decision a publish broadcasts: the commit of the step just taken
// (ovf: code 5; code6) and the decision of the next step.
struct Dec {
  int ovf, code6, code, sym0, sym1, reached, rec_imb, fin_total;
};

// Warp 0: fold the CTAs' partials of parity p (gathered in this CTA's
// shared memory) in rank order and decide, with the counters the next
// step will have (n_steps, n_budget, n_rec, lengths nc0 / nc1); `stepped`:
// the partials carry a step's commit inputs, taken at length len_pre.
// Stop codes 3, 2, 1, 4 in that order; lane 0 stores the decision.
__device__ void decide(const Args& a, const Smem& s, const Ctx& x, int p,
                       bool stepped, int n_steps, int n_budget, int n_rec,
                       int nc0, int nc1, int len_pre) {
  // the imbalance floor's load is issued before the fold
  const int imb_v =
      stepped ? a.imb_tab[min(max(len_pre + 1, 0), a.IMBN - 1)] : 0;
  const int* gath = s.gath + (size_t)p * kMaxCluster * x.P;
  unsigned h[kFlags + 1];
  clu::fold<Part>(gath, a.csize, x.P, a.A, h,
                  [&](int v, int k, int hv, float c) {
                    s.gcount[v * a.A + k] = c;
                    s.ghas[v * a.A + k] = hv;
                  });
  __syncwarp();
  const int flags = (int)h[kFlags];
  const int ovf = stepped && (flags & kOvf) != 0;
  const int code6 =
      stepped && ((int)h[kCnt2] < imb_v || (int)h[kCnt2 + 1] < imb_v);
  // lane parity k nominates side k (both sides at once); a locked side
  // never arbitrates
  const int k = x.lane & 1;
  bool my_dirty = false;
  int my_sym = 0;
  if (!a.lock[k])
    nominate(a, s.gcount + k * a.A, s.ghas + k * a.A,
             (flags & (kNonexact0 << k)) != 0, &my_dirty, &my_sym);
  const unsigned dirty_at = __ballot_sync(clu::kFull, my_dirty);
  const bool dirty[2] = {(dirty_at & 1u) != 0, (dirty_at & 2u) != 0};
  const int sym[2] = {__shfl_sync(clu::kFull, my_sym, 0),
                      __shfl_sync(clu::kFull, my_sym, 1)};
  const int total = (int)h[kTot];
  const bool cost_overflow = a.l2 && (int)h[kMaxEds] > 2048;
  const bool fin_a = a.et ? !(flags & kFin0) : (flags & kFin0) != 0;
  const bool fin_b =
      a.et ? !(flags & (kFin0 << 1)) : (flags & (kFin0 << 1)) != 0;
  const bool reached_stop = a.et ? !(flags & kStop) : (flags & kStop) != 0;
  const int cur_len = max(nc0, nc1);
  const bool wins_pop = total < a.other_cost ||
                        (total == a.other_cost && cur_len > a.other_len);
  const int count0 = (int)h[kCount0];
  const int count1 = (int)h[kNAny] - count0;
  const bool fin_cost_ovf = a.l2 && (int)h[kFinMax] > 2048;
  const bool rec_blocked = !a.allow_records || (flags & kFo) ||
                           fin_cost_ovf || n_rec >= kRecCap;
  int code = 0;
  if (total > n_budget || !wins_pop) code = 3;
  else if (reached_stop && rec_blocked) code = 2;
  else if (dirty[0] || dirty[1] || (fin_a && !a.lock[0]) ||
           (fin_b && !a.lock[1]) || cost_overflow) code = 1;
  else if (n_steps >= a.max_steps) code = 4;
  if (x.lane == 0) {
    s.dec[0] = ovf;
    s.dec[1] = code6;
    s.dec[2] = code;
    s.dec[3] = sym[0];
    s.dec[4] = sym[1];
    s.dec[5] = reached_stop;
    s.dec[6] = count0 < a.rec_min || count1 < a.rec_min;
    s.dec[7] = (int)h[kFinTot];
  }
}

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads, 1)
    run_extend_dual_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const Smem s = carve<kOnChip>(smem_raw, a);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  Ctx x;
  x.rank = (int)cl.block_rank();
  x.warp = tid >> 5;
  x.lane = tid & 31;
  x.P = Part::words(a.A);
  x.r0 = x.rank * a.rpc;
  x.nloc = max(0, min(a.rpc, a.R - x.r0));
  if (a.rpw == 1) {  // a warp pair per read, one side each
    x.lo = min(x.warp >> 1, x.nloc);
    x.hi = min(x.lo + 1, x.nloc);
    x.s0 = x.warp & 1;
    x.ns = 1;
  } else {           // both sides of rpw / 2 reads per warp
    const int k = a.rpw / 2;
    x.lo = min(x.warp * k, x.nloc);
    x.hi = min(x.lo + k, x.nloc);
    x.s0 = 0;
    x.ns = 2;
  }
  x.ring_mask = ring_len(a.W) - 1;
  const bool lead = x.rank == 0 && tid == 0;
  int clen0 = *clen_at(a, 0, 0), clen1 = *clen_at(a, 0, 1);
  // every CTA of the cluster is running before any partial is pushed: the
  // barrier's wait comes after the state is loaded
  cluster_arrive_relaxed();

  for (int lr = tid; lr < x.nloc; lr += nthreads) {
    for (int k = 0; k < 2; ++k) {
      const shards::Cell c = cell(a, k, x.r0 + lr);
      s.f(kE, k)[lr] = s.f(kE2, k)[lr] = *c.e;
      s.f(kRmin, k)[lr] = s.f(kRmin2, k)[lr] = *c.rmin;
      s.f(kEr, k)[lr] = s.f(kEr2, k)[lr] = *c.er;
      s.f(kOff, k)[lr] = *c.off;
      s.f(kAct, k)[lr] = s.f(kAct2, k)[lr] = *c.act != 0;
      s.f(kFin, k)[lr] = s.f(kFin2, k)[lr] = 0;
      if (k == 0) s.rlen[lr] = *c.rlen;
    }
  }
  for (int i = tid; i < a.nw * 2 * a.A; i += nthreads) s.hist[i] = 0;
  if (tid < 8) s.dec[tid] = 0;
  if (kOnChip) {
    // each warp loads the rows of its active reads and their symbol rings
    for (int lr = x.lo; lr < x.hi; ++lr) {
      const int r = x.r0 + lr;
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        const shards::Cell c = cell(a, sd, r);
        if (!x.mine(sd) || !*c.act) continue;
        const int32_t* src = c.D;
        int32_t* dst = row<kOnChip>(a, s, sd, 0, lr, r);
        for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
        int16_t* rg = ring_of(s, x, a, sd, lr);
        const int base = (sd ? clen1 : clen0) - *c.off - a.E;
        for (int k = x.lane; k <= a.W; k += 32) {
          const int i = base + k;
          rg[i & x.ring_mask] = (int16_t)read_sym(a, r, i);
        }
      }
    }
  }
  __syncthreads();
  cluster_wait();

  // The read window's feed, one step ahead: lane l of a warp feeds its
  // row l (read lo + l / ns, side s0 + l % ns) of an unlocked side: `pend`
  // is the symbol the next column adds to the row's ring, at `feed_pos`;
  // it is loaded a whole step before it is stored.
  const int feed_lr = x.lo + x.lane / x.ns;
  const int feed_sd = x.s0 + x.lane % x.ns;
  const bool feeds = kOnChip && feed_lr < x.hi && !a.lock[feed_sd] &&
                     s.f(kAct, feed_sd)[feed_lr];
  const int feed_r = x.r0 + feed_lr;
  int16_t* feed_ring = feeds ? ring_of(s, x, a, feed_sd, feed_lr) : nullptr;
  int feed_pos = feeds ? (feed_sd ? clen1 : clen0) + 1 + a.W -
                             s.f(kOff, feed_sd)[feed_lr] - a.E
                       : 0;
  int pend = feeds ? read_sym(a, feed_r, feed_pos) : 0;

  int steps = 0, cur = 0, p = 0, rec_count = 0, code = 0;
  int budget = a.me_budget;

  // After a pass: the warps' partials -> the CTA's partial, stored into
  // every CTA's gather rows of parity p -> the one cluster barrier of the
  // step -> warp 0 folds the gathered rows and decides -> broadcast in
  // the CTA.
  auto publish = [&](bool stepped, int n_steps, int n_budget, int n_rec,
                     int nc0, int nc1, int len_pre) {
    __syncthreads();
    if (x.warp == 0) {
      clu::cta_fold<Part>(cl, s.wpart, a.nw, x.P, a.A, s.part,
                          s.gath + (size_t)p * kMaxCluster * x.P, x.rank,
                          a.csize);
    }
    cl.sync();
    if (x.warp == 0) {
      decide(a, s, x, p, stepped, n_steps, n_budget, n_rec, nc0, nc1,
             len_pre);
    }
    p ^= 1;
    __syncthreads();
    return Dec{s.dec[0], s.dec[1], s.dec[2], s.dec[3],
               s.dec[4], s.dec[5], s.dec[6], s.dec[7]};
  };

  // the vote and folds of the committed state decide the first step
  warp_pass<kOnChip>(a, s, x, false, cur, clen0, clen1, 0, 0);
  Dec dec = publish(false, 0, budget, 0, clen0, clen1, 0);
  code = dec.code;
  for (int i = x.lane; i < (x.hi - x.lo) * x.ns; i += 32) {
    const int lr = x.lo + i / x.ns, sd = x.s0 + i % x.ns;
    s.f(kFin, sd)[lr] = s.f(kFin2, sd)[lr];
  }
  __syncwarp();

  while (code == 0) {
    if (feeds) {
      feed_ring[feed_pos & x.ring_mask] = (int16_t)pend;
      ++feed_pos;
      pend = read_sym(a, feed_r, feed_pos);
    }
    __syncwarp();
    warp_pass<kOnChip>(a, s, x, true, cur, clen0, clen1, dec.sym0, dec.sym1);
    // the counters after this step's commit
    int rec_next = rec_count, budget_next = budget;
    if (dec.reached) {
      rec_next += 1;
      if (!dec.rec_imb && dec.fin_total < budget) budget_next = dec.fin_total;
    }
    const int nc0 = clen0 + !a.lock[0], nc1 = clen1 + !a.lock[1];
    const Dec nd = publish(true, steps + 1, budget_next, rec_next, nc0, nc1,
                           max(clen0, clen1));
    if (nd.ovf) {
      code = 5;  // the step stays uncommitted
      break;
    }
    // ---- commit of the step
    if (dec.reached) {
      // record of the pre-step state
      const int ri = min(rec_count, kRecCap - 1);
      const size_t plane = (size_t)kRecCap * a.R;
      for (int i = x.lane; i < (x.hi - x.lo) * x.ns; i += 32) {
        const int lr = x.lo + i / x.ns, sd = x.s0 + i % x.ns;
        const size_t at = (size_t)ri * a.R + x.r0 + lr;
        a.rec_planes[sd * plane + at] = s.f(kFin, sd)[lr];
        a.rec_planes[(2 + sd) * plane + at] = s.f(kAct, sd)[lr];
      }
      if (lead) a.rec_steps[ri] = steps;
    }
    if (lead) {
      for (int k = 0; k < copies(a); ++k) {
        if (!a.lock[0]) cons_row(a, k, 0)[clen0] = dec.sym0;
        if (!a.lock[1]) cons_row(a, k, 1)[clen1] = dec.sym1;
      }
      if (!a.lock[0]) a.out[a.o_syms[0] + steps] = dec.sym0;
      if (!a.lock[1]) a.out[a.o_syms[1] + steps] = dec.sym1;
    }
    // a read pruned now is no longer stepped: its new row goes into the
    // side's other buffer too
    for (int lr = x.lo; lr < x.hi; ++lr) {
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        if (!x.mine(sd) || a.lock[sd] || !s.f(kAct, sd)[lr] ||
            s.f(kAct2, sd)[lr])
          continue;
        const int r = x.r0 + lr;
        const int32_t* src = row<kOnChip>(a, s, sd, cur ^ 1, lr, r);
        int32_t* dst = row<kOnChip>(a, s, sd, cur, lr, r);
        for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
      }
    }
    __syncwarp();
    for (int i = x.lane; i < (x.hi - x.lo) * x.ns; i += 32) {
      const int lr = x.lo + i / x.ns, sd = x.s0 + i % x.ns;
      if (!a.lock[sd] && s.f(kAct, sd)[lr]) {
        s.f(kE, sd)[lr] = s.f(kE2, sd)[lr];
        s.f(kRmin, sd)[lr] = s.f(kRmin2, sd)[lr];
        s.f(kEr, sd)[lr] = s.f(kEr2, sd)[lr];
      }
      s.f(kFin, sd)[lr] = s.f(kFin2, sd)[lr];
      s.f(kAct, sd)[lr] = s.f(kAct2, sd)[lr];
    }
    __syncwarp();
    rec_count = rec_next;
    budget = budget_next;
    steps += 1;
    clen0 = nc0;
    clen1 = nc1;
    cur ^= 1;
    if (nd.code6) {
      code = 6;  // committed all the same
      break;
    }
    dec = nd;
    code = nd.code;
  }

  // no CTA leaves while a peer may still touch its shared memory (the
  // pushes all came before the last publish's barrier); the barrier's
  // wait comes after the snapshot and the write-back
  cluster_arrive_relaxed();

  // ---- final snapshot of both sides
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      if (!x.mine(sd)) continue;
      int* hist = s.hist + (x.warp * 2 + sd) * a.A;
      const int act = s.f(kAct, sd)[lr];
      const int split =
          act ? tips<kOnChip>(a, s, x, sd, a.lock[sd] ? 0 : cur, lr,
                              sd ? clen1 : clen0, hist)
              : 0;
      for (int k = x.lane; k < a.A; k += 32) {
        a.out[a.o_occ[sd] + r * a.A + k] = hist[k];
        hist[k] = 0;
      }
      __syncwarp();
      if (x.lane == 0) {
        const int e = s.f(kE, sd)[lr], er = s.f(kEr, sd)[lr];
        a.out[a.o_eds[sd] + r] = act ? e : 0;
        a.out[a.o_split[sd] + r] = split;
        a.out[a.o_reached[sd] + r] = act && er < kInf && e == er;
        a.out[a.o_act[sd] + r] = act;
      }
    }
  }
  // ---- write-back: the final buffer of each stepped row (the rows of
  // reads active at the start; the slot's mask is still the original
  // here), then the per-read state of both slots
  if (steps > 0 && (kOnChip || cur == 1)) {
    for (int lr = x.lo; lr < x.hi; ++lr) {
      const int r = x.r0 + lr;
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        const shards::Cell c = cell(a, sd, r);
        if (!x.mine(sd) || a.lock[sd] || !*c.act) continue;
        const int32_t* src = row<kOnChip>(a, s, sd, cur, lr, r);
        int32_t* dst = c.D;
        for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
      }
    }
  }
  __syncwarp();
  for (int i = x.lane; i < (x.hi - x.lo) * x.ns; i += 32) {
    const int lr = x.lo + i / x.ns, sd = x.s0 + i % x.ns;
    const shards::Cell c = cell(a, sd, x.r0 + lr);
    *c.e = s.f(kE, sd)[lr];
    *c.rmin = s.f(kRmin, sd)[lr];
    *c.er = s.f(kEr, sd)[lr];
    *c.act = (uint8_t)(s.f(kAct, sd)[lr] != 0);
  }
  // symbol slots past each side's commits (all of a locked side's) are 0
  {
    const int c0 = a.lock[0] ? 0 : steps, c1 = a.lock[1] ? 0 : steps;
    const int stride = a.csize * nthreads;
    for (int i = x.rank * nthreads + tid; i < a.max_steps; i += stride) {
      if (i >= c0) a.out[a.o_syms[0] + i] = 0;
      if (i >= c1) a.out[a.o_syms[1] + i] = 0;
    }
  }
  if (lead) {
    a.out[0] = steps;
    a.out[1] = code;
    a.out[2] = rec_count;
    a.out[3] = clen0;
    a.out[4] = clen1;
    a.out[5] = a.out[6] = a.out[7] = 0;
    for (int k = 0; k < copies(a); ++k) {
      *clen_at(a, k, 0) = clen0;
      *clen_at(a, k, 1) = clen1;
    }
  }
  cluster_wait();
}

// Launch shapes already checked on this device (attributes set, at least
// one cluster of the shape fits).
struct Checked {
  const void* fn;
  int csize, threads;
  size_t smem;
};
std::mutex g_checked_mu;
Checked g_checked[16];
int g_nchecked = 0;

template <bool kOnChip>
int launch(const Args& a, int threads, size_t smem, cudaStream_t stream) {
  auto* fn = run_extend_dual_kernel<kOnChip>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(a.csize, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(g_checked_mu);
    bool known = false;
    for (int i = 0; i < g_nchecked; ++i) {
      const Checked& c = g_checked[i];
      known |= c.fn == (const void*)fn && c.csize == a.csize &&
               c.threads == threads && c.smem == smem;
    }
    if (!known) {
      // the attribute only ever grows, so shapes checked earlier still fit
      static size_t smem_attr = 0;
      if (smem > smem_attr) {
        cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_attr = smem;
      }
      cudaError_t err = cudaSuccess;
      if (a.csize > 8) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
      }
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters <= 0) return -2;
      g_checked[g_nchecked % 16] =
          Checked{(const void*)fn, a.csize, threads, smem};
      g_nchecked = g_nchecked < 16 ? g_nchecked + 1 : 16;
    }
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// The scalars of a dual run and the plan into `a` (its store, slots,
// tables and outputs set by the caller), then the launch.
int launch_dual(Args& a, int R, int W, int C, int L, int A, int MCN,
                int IMBN, int me_budget, int other_cost, int other_len,
                int delta, int l2, int weighted, int max_steps, int lock1,
                int lock2, int allow_records, int rec_min, int mc_dyn, int wc,
                int et, int csize, int threads, int rpc, int rpw,
                int on_chip, long long smem, void* stream) {
  a.lock[0] = lock1; a.lock[1] = lock2;
  a.R = R; a.W = W; a.C = C; a.L = L; a.A = A; a.MCN = MCN; a.IMBN = IMBN;
  a.E = (W - 2) / 2;
  a.me_budget = me_budget; a.other_cost = other_cost;
  a.other_len = other_len; a.delta = delta; a.l2 = l2;
  a.weighted = weighted; a.max_steps = max_steps;
  a.allow_records = allow_records; a.rec_min = rec_min; a.mc_dyn = mc_dyn;
  a.wc = wc; a.et = et;
  a.csize = csize; a.nw = threads / 32; a.rpc = rpc; a.rpw = rpw;
  // packed output layout (mirrors run_dual_kernel.dual_out_layout)
  int at = 8;
  for (int k = 0; k < 2; ++k) {
    a.o_eds[k] = at; at += R;
    a.o_split[k] = at; at += R;
    a.o_reached[k] = at; at += R;
    a.o_act[k] = at; at += R;
    a.o_occ[k] = at; at += R * A;
  }
  a.o_syms[0] = at; at += max_steps;
  a.o_syms[1] = at;
  // rows over warps: a warp pair per read (an even warp count, two warps
  // for each of the CTA's reads), or both sides of rpw / 2 reads a warp;
  // on chip a warp feeds the rings of at most 32 rows
  const int nw = a.nw;
  const bool rows_ok =
      rpw == 1 ? nw % 2 == 0 && nw >= 2 * rpc
               : rpw % 2 == 0 && (long long)nw * (rpw / 2) >= rpc &&
                     (!on_chip || rpw <= 32);
  const bool plan_ok =
      csize >= 1 && csize <= kMaxCluster && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && rpc >= 1 && rpw >= 1 &&
      rows_ok && (long long)csize * rpc >= R && A >= 1 && W >= 4 &&
      MCN >= 1 && IMBN >= 1 && (on_chip || a.scratch != nullptr) &&
      (size_t)smem == smem_bytes(rpc, nw, W, A, on_chip != 0) &&
      shards::cover(a.sh, a.nsh, a.Rs, R);
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_chip ? launch<true>(a, threads, (size_t)smem, st)
                 : launch<false>(a, threads, (size_t)smem, st);
}

// The launch's tables and outputs into `a`.
void set_io(Args& a, void* mc_tab, void* imb_tab, void* scratch, void* out,
            void* rec_steps, void* rec_planes, int h1, int h2) {
  a.mc_tab = static_cast<const int32_t*>(mc_tab);
  a.imb_tab = static_cast<const int32_t*>(imb_tab);
  a.scratch = static_cast<int32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.rec_steps = static_cast<int32_t*>(rec_steps);
  a.rec_planes = static_cast<int32_t*>(rec_planes);
  a.h[0] = h1; a.h[1] = h2;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one cluster of
// `csize` CTAs of `threads` threads on `stream`, with the geometry of the
// plan (`plan_run_dual` in ops/run_dual_kernel.py): `rpc` reads per CTA,
// `rpw` rows per warp (1: a warp pair per read; an even number: both
// sides of rpw / 2 reads per warp), the band on chip (`on_chip`) or in
// device memory (`scratch` then holds each side's second buffer), `smem`
// bytes of dynamic shared memory.  Returns 0 on success, -1 when the plan
// does not cover the shape or its shared memory disagrees with the
// kernel's layout, -2 when no cluster of that shape fits on the device,
// else the CUDA error; the launch does not synchronise.
extern "C" int run_extend_dual_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* mc_tab, void* imb_tab,
    void* scratch, void* out, void* rec_steps, void* rec_planes, int h1,
    int h2, int R, int W, int C, int L, int A, int MCN, int IMBN,
    int me_budget, int other_cost, int other_len, int delta, int l2,
    int weighted, int max_steps, int lock1, int lock2, int allow_records,
    int rec_min, int mc_dyn, int wc, int et, int csize, int threads, int rpc,
    int rpw, int on_chip, long long smem, void* stream) {
  Args a;
  a.D = static_cast<int32_t*>(D);
  a.e = static_cast<int32_t*>(e);
  a.rmin = static_cast<int32_t*>(rmin);
  a.er = static_cast<int32_t*>(er);
  a.off = static_cast<const int32_t*>(off);
  a.act = static_cast<uint8_t*>(act);
  a.cons = static_cast<int32_t*>(cons);
  a.clen = static_cast<int32_t*>(clen);
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.sh = nullptr;
  a.nsh = 1; a.Rs = R;
  set_io(a, mc_tab, imb_tab, scratch, out, rec_steps, rec_planes, h1, h2);
  return launch_dual(a, R, W, C, L, A, MCN, IMBN, me_budget, other_cost,
                     other_len, delta, l2, weighted, max_steps, lock1, lock2,
                     allow_records, rec_min, mc_dyn, wc, et, csize, threads,
                     rpc, rpw, on_chip, smem, stream);
}

// The shard instance: the same dual run on slots h1, h2 of a read-sharded
// store whose `nsh` shards (`Rs` reads each, R = nsh Rs) share this card,
// one launch for all of them.  `shards` is the device copy of the shards'
// records (csrc/store_shards.cuh `StoreShard`); each row is read and
// updated in its own shard, each symbol and length written to every
// shard.  Tables, outputs and plan are the one-store launch's at the
// store's R.  Returns as `run_extend_dual_launch`, and -1 too when the
// shards do not cover R.
extern "C" int run_extend_dual_shards_launch(
    const void* shards, int nsh, int Rs, void* mc_tab, void* imb_tab,
    void* scratch, void* out, void* rec_steps, void* rec_planes, int h1,
    int h2, int R, int W, int C, int L, int A, int MCN, int IMBN,
    int me_budget, int other_cost, int other_len, int delta, int l2,
    int weighted, int max_steps, int lock1, int lock2, int allow_records,
    int rec_min, int mc_dyn, int wc, int et, int csize, int threads, int rpc,
    int rpw, int on_chip, long long smem, void* stream) {
  if (shards == nullptr) return -1;
  Args a;
  a.D = a.e = a.rmin = a.er = nullptr;
  a.off = nullptr;
  a.act = nullptr;
  a.cons = a.clen = nullptr;
  a.reads = nullptr;
  a.rlen = nullptr;
  a.sh = static_cast<const StoreShard*>(shards);
  a.nsh = nsh; a.Rs = Rs;
  set_io(a, mc_tab, imb_tab, scratch, out, rec_steps, rec_planes, h1, h2);
  return launch_dual(a, R, W, C, L, A, MCN, IMBN, me_budget, other_cost,
                     other_len, delta, l2, weighted, max_steps, lock1, lock2,
                     allow_records, rec_min, mc_dyn, wc, et, csize, threads,
                     rpc, rpw, on_chip, smem, stream);
}
