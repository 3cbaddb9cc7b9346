// Fused single-branch run loop of the consensus search, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_j_run_pallas` (body `_mkkernel`) of
// waffle_con_tpu/ops/pallas_run.py, and the per-lane gather mode of the
// XLA loop `_j_run` (waffle_con_tpu/ops/jax_scorer.py) that stands in for
// it when a branch's reads sit at different offsets.  One launch is one
// `run_extend` call on one branch slot: a forced first push, then a loop
// that appends one consensus symbol per step while the reads' tip votes
// name a unique passing candidate, and a final stats snapshot.  Decision
// for decision it computes what waffle_con_tpu_torch/ops/run_kernel.py's
// `run_extend_plain` computes (stop codes 1-5, record absorption, the
// float32 vote fold under the VOTE_EPS contract).
//
// What bounds it.  Not bytes or operations: a step's work is small (R x W
// band cells, ~20 int32 operations each: 0.16 us of the card's int32
// rate at R = 256, W = 514), and each step needs the decision of the step
// before, so the loop is bound by the latency of one step.  A step is one
// DP column per read, the tip votes of the new column, and the reduction
// of every read's votes and folds into one decision; one SM, as on the
// TPU's one core, spends ~100 us on it at the north star.
//
// Design.  One thread-block cluster per launch (1-16 CTAs of at most 16
// warps, the geometry chosen by `plan_run` in ops/run_kernel.py and
// passed in).  Reads are split over the CTAs in contiguous blocks and,
// within a CTA, over its warps: at the north star (R = 256, W = 514) 16
// CTAs of 16 warps, one read per warp, so a step costs one read's column
// on each of 16 SMs.
//  * The band lives on chip: each CTA loads its reads' rows of slot h into
//    shared memory once, with a second buffer for the next column (a step
//    swaps an index; a column that overflows the band, code 5, is simply
//    never swapped in) and writes them back once at the end.  Shapes whose
//    two buffers do not fit in 16 CTAs keep the rows in device memory (slot
//    h and a scratch buffer) through the template parameter kOnChip; the
//    planner decides this from the shape alone.
//  * The column step (band_ops.cuh `column_step_runs`) gives each lane a
//    contiguous run of cells: the insertion chain is a sequential min along
//    the run plus one warp scan per column, and the new column's tip votes
//    come from a third walk by the few lanes whose least cell is within
//    the new e, so the vote needs no pass of its own.
//  * The read window: each read keeps a ring of its symbols in shared
//    memory (a power of two >= W + 2 slots) holding the current window; the
//    one symbol a step adds is loaded from device memory a whole step ahead
//    and stored at the top of the step, so no device-memory latency lies on
//    the step.  (Prefetching the whole window instead would move W + 1
//    symbols a step for the same effect.)
//  * One cluster barrier per step: the vote of step j + 1 is taken in the
//    column pass of step j, over the column just written.  Each warp folds
//    its reads into a partial (in read order), warp 0 folds the warps'
//    partials (in warp order) into the CTA's partial and stores it over
//    distributed shared memory into slot `rank` of every CTA's
//    parity-double-buffered gather rows, then one barrier.cluster
//    arrive/wait.  Warp 0 of every CTA then folds the gathered rows in
//    rank order (float32 adds with __fadd_rn, wrapping unsigned int32
//    totals; csrc/cluster_ops.cuh, shared with the dual kernel) and takes
//    the decision; every CTA computes the same one, so no second cluster
//    barrier is needed, only a CTA barrier to broadcast it.
//  * Record rows and the snapshot's per-read outputs are written by the
//    CTA that owns each read; the symbols, record steps, scalars and the
//    consensus by rank 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "band_ops.cuh"
#include "cluster_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using band::kFull;
using band::kInf;
using band::ring_len;
using clu::kMaxCluster;
constexpr int kRecCap = 256;        // record buffer rows (REC_CAP)
constexpr int kMaxThreads = 512;   // 16 warps: up to 128 registers a thread
constexpr float kVoteEps = 0.01f;   // VOTE_EPS, float32(1e-2)

// A partial (of a warp, or of a CTA, csrc/cluster_ops.cuh): two sums, two
// maxima, the flags, then one vote row (has[A], counts[A]).
using Part = clu::Layout<2, 2, 1>;
constexpr int kTot = 0, kFinTot = 1, kMaxEds = 2, kMaxFin = 3;
constexpr int kFlags = Part::kFlags, kHead = Part::kHead;
constexpr int kNonexact = 1, kNotReached = 2, kAnyReached = 4, kFinOvf = 8,
              kOvf = 16;

__host__ __device__ inline int part_words(int A) { return Part::words(A); }

// Dynamic shared memory of one CTA (mirrored by run_kernel._smem_bytes).
__host__ __device__ inline size_t smem_bytes(int rpc, int nw, int W, int A,
                                             bool on_chip) {
  const size_t P = part_words(A);
  const size_t words = (1 + 2 * kMaxCluster) * P + 11 * (size_t)rpc +
                       (size_t)nw * ((size_t)A + P) + 2 * (size_t)A + 8;
  size_t bytes = 4 * words;
  if (on_chip) bytes += 8 * (size_t)rpc * W + 2 * (size_t)rpc * ring_len(W);
  return bytes;
}

struct Args {
  int32_t* D;          // [B, R, W] band store; slot h updated in place
  int32_t* e;          // [B, R]
  int32_t* rmin;       // [B, R]
  int32_t* er;         // [B, R]
  const int32_t* off;  // [B, R]
  const uint8_t* act;  // [B, R] (torch.bool)
  int32_t* cons;       // [B, C]
  int32_t* clen;       // [B]
  const int16_t* reads;  // [R, L] dense symbol ids, -1 padded
  const int32_t* rlen;   // [R]
  int32_t* scratch;    // [R, W] second band buffer (device-memory band only)
  int32_t* out;        // packed outputs (run_kernel.out_layout)
  int32_t* rec_steps;  // [REC_CAP]
  int32_t* rec_fins;   // [REC_CAP, R]
  int h, R, W, C, L, A, E;
  int me_budget, other_cost, other_len, min_count, l2, max_steps;
  int first_sym, allow_records, wc, et;
  int csize, nw, rpc, rpw;  // the launch plan
  // offsets of the packed output fields
  int o_eds, o_split, o_reached, o_fin, o_occ, o_syms;
};

struct Smem {
  int32_t* band;  // [2, rpc, W] (on-chip band only)
  int* e; int* rmin; int* er;        // [rpc] folds of the committed column
  int* e2; int* rmin2; int* er2;     // [rpc] folds of the speculative column
  int* fin; int* fin2;               // [rpc] finalized distances of both
  int* off; int* act; int* rlen;     // [rpc]
  int* hist;                         // [nw, A] tip histogram of one read
  int* wpart;                        // [nw, P] per-warp partials
  float* gcount; int* ghas;          // [A] each: the cluster's votes
  int* part;                         // [P] the CTA's partial
  int* gath;                         // [2, kMaxCluster, P] every CTA's
                                     // partial, by parity
  int* dec;                          // [8] warp 0's decision, broadcast
  int16_t* ring;                     // [rpc, ring_len(W)] (on-chip only)
};

template <bool kOnChip>
__device__ inline Smem carve(char* base, const Args& a) {
  Smem s;
  const int P = part_words(a.A);
  if (kOnChip) {
    s.band = reinterpret_cast<int32_t*>(base);
    base += 8 * (size_t)a.rpc * a.W;
  } else {
    s.band = nullptr;
  }
  int* p = reinterpret_cast<int*>(base);
  s.part = p; p += P;  // 16-byte aligned: copied over DSMEM as int4
  s.gath = p; p += 2 * kMaxCluster * P;
  s.e = p; p += a.rpc; s.rmin = p; p += a.rpc; s.er = p; p += a.rpc;
  s.e2 = p; p += a.rpc; s.rmin2 = p; p += a.rpc; s.er2 = p; p += a.rpc;
  s.fin = p; p += a.rpc; s.fin2 = p; p += a.rpc;
  s.off = p; p += a.rpc; s.act = p; p += a.rpc; s.rlen = p; p += a.rpc;
  s.hist = p; p += a.nw * a.A;
  s.wpart = p; p += a.nw * P;
  s.gcount = reinterpret_cast<float*>(p); p += a.A;
  s.ghas = p; p += a.A;
  s.dec = p; p += 8;
  s.ring = kOnChip ? reinterpret_cast<int16_t*>(p) : nullptr;
  return s;
}

// Per-thread view of the launch: who this warp is and which reads it owns.
struct Ctx {
  int rank, warp, lane, P;
  int r0, nloc;   // first read of the CTA, reads the CTA owns
  int lo, hi;     // local reads [lo, hi) of this warp
  int ring_mask;
};

// Band row of local read lr (global r) in buffer buf.
template <bool kOnChip>
__device__ __forceinline__ int32_t* row(const Args& a, const Smem& s,
                                        int buf, int lr, int r) {
  if (kOnChip) return s.band + ((size_t)buf * a.rpc + lr) * a.W;
  int32_t* base = buf == 0 ? a.D + (size_t)a.h * a.R * a.W : a.scratch;
  return base + (size_t)r * a.W;
}

// Symbol of read r at position i (-1 outside [0, L)), from device memory.
__device__ __forceinline__ int read_sym(const Args& a, int r, int i) {
  return i >= 0 && i < a.L ? a.reads[(size_t)r * a.L + i] : -1;
}

struct Fold {
  unsigned tot, fin_tot;
  int max_eds, max_fin, flags;
};

// One warp's pass over its reads at consensus length j.  `step`: first
// advance each active read's column from buffer cur (length j - 1) into
// cur ^ 1 by consuming `sym`, then vote over the new column with the new
// folds (kept in e2/rmin2/er2/fin2).  Otherwise vote over buffer cur with
// the committed folds (fin into fin2).  Votes and folds go into the warp's
// partial, or, with `snap`, into the packed per-read outputs.  Returns the
// warp's flags.
template <bool kOnChip>
__device__ int warp_pass(const Args& a, const Smem& s, const Ctx& x,
                         bool step, bool snap, int cur, int j, int sym) {
  const int lane = x.lane;
  int* hist = s.hist + x.warp * a.A;
  int* wp = s.wpart + x.warp * x.P;
  int* whas = wp + kHead;
  float* wcount = reinterpret_cast<float*>(wp + kHead + a.A);
  if (!snap) {
    for (int k = lane; k < a.A; k += 32) {
      whas[k] = 0;
      wcount[k] = 0.f;
    }
  }
  unsigned tot = 0, ftot = 0;
  int mx_eds = 0, mx_fin = 0, flags = 0;
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
    if (!s.act[lr]) {
      if (snap) {
        for (int k = lane; k < a.A; k += 32) a.out[a.o_occ + r * a.A + k] = 0;
        if (lane == 0) {
          a.out[a.o_eds + r] = 0;
          a.out[a.o_split + r] = 0;
          a.out[a.o_reached + r] = 0;
          a.out[a.o_fin + r] = 0;
        }
      }
      continue;
    }
    const int rl = s.rlen[lr];
    const int i0 = j - s.off[lr] - a.E;  // read position of cell 0
    int e = s.e[lr], rmin = s.rmin[lr], er = s.er[lr];
    const int32_t* Dv = row<kOnChip>(a, s, cur, lr, r);
    const int16_t* ring = kOnChip ? s.ring + (size_t)lr * (x.ring_mask + 1)
                                  : nullptr;
    const band::RingWindow rwin{ring, x.ring_mask};
    const band::GlobalWindow gwin{a.reads + (size_t)r * a.L, a.L};
    int split = 0;
    if (step) {
      int32_t* Dn = row<kOnChip>(a, s, cur ^ 1, lr, r);
      const band::Folds3 f0{e, rmin, er};
      // the new column's tip votes come out of the column step
      const band::Folds3 f =
          kOnChip ? band::column_step_runs(Dv, Dn, rwin, a.W, rl, i0, sym,
                                           a.wc, a.et, f0, hist, &split)
                  : band::column_step_runs(Dv, Dn, gwin, a.W, rl, i0, sym,
                                           a.wc, a.et, f0, hist, &split);
      e = f.e;
      rmin = f.rmin;
      er = f.er;
      if (e >= a.E) flags |= kOvf;
      if (lane == 0) {
        s.e2[lr] = e;
        s.rmin2[lr] = rmin;
        s.er2[lr] = er;
      }
      Dv = Dn;
      __syncwarp();
    }
    if (!step) {
      split = kOnChip
                  ? band::tip_histogram_win(Dv, rwin, a.W, rl, i0, e, hist)
                  : band::tip_histogram_win(Dv, gwin, a.W, rl, i0, e, hist);
    }
    const float split_f = (float)max(split, 1);
    for (int k = lane; k < a.A; k += 32) {
      const int c = hist[k];
      if (snap) {
        a.out[a.o_occ + r * a.A + k] = c;
      } else {
        if (split > 0) {
          wcount[k] = __fadd_rn(wcount[k], __fdiv_rn((float)c, split_f));
        }
        if (c > 0) whas[k] = 1;
      }
      hist[k] = 0;
    }
    __syncwarp();
    const int fin_u = max(e, rmin);
    const int fin = min(fin_u, kInf);
    const int reached = er < kInf && e == er;
    const unsigned ue = (unsigned)e, uf = (unsigned)fin;
    tot += a.l2 ? ue * ue : ue;       // wrapping int32, as on the TPU
    ftot += a.l2 ? uf * uf : uf;
    mx_eds = max(mx_eds, e);
    mx_fin = max(mx_fin, fin);
    if (split > 0 && (split & (split - 1)) != 0) flags |= kNonexact;
    flags |= reached ? kAnyReached : kNotReached;
    if (fin_u >= a.E) flags |= kFinOvf;
    if (lane == 0) {
      if (snap) {
        a.out[a.o_eds + r] = e;
        a.out[a.o_split + r] = split;
        a.out[a.o_reached + r] = reached;
        a.out[a.o_fin + r] = fin;
      } else {
        s.fin2[lr] = fin;
      }
    }
  }
  if (lane == 0 && !snap) {
    wp[kTot] = (int)tot;
    wp[kFinTot] = (int)ftot;
    wp[kMaxEds] = mx_eds;
    wp[kMaxFin] = mx_fin;
    wp[kFlags] = flags;
  }
  return flags;
}

// Warp 0: fold the CTAs' partials of parity p (gathered in this CTA's
// shared memory), in rank order.  The votes land in gcount/ghas; the
// scalars are returned, the same in every lane.
__device__ Fold cluster_fold(const Args& a, const Smem& s, const Ctx& x,
                             int p) {
  const int* gath = s.gath + (size_t)p * kMaxCluster * x.P;
  unsigned head[kFlags + 1];
  clu::fold<Part>(gath, a.csize, x.P, a.A, head,
                  [&](int, int k, int hv, float c) {
                    s.gcount[k] = c;
                    s.ghas[k] = hv;
                  });
  __syncwarp();
  Fold f;
  f.tot = head[kTot];
  f.fin_tot = head[kFinTot];
  f.max_eds = (int)head[kMaxEds];
  f.max_fin = (int)head[kMaxFin];
  f.flags = (int)head[kFlags];
  return f;
}

struct Dec {
  int code, sym, reached_here, fin_total;
};

// Warp 0: the step decision from the cluster fold (every lane computes
// the same): nomination (fractional votes, wildcard drop, EPS near-tie
// guard, first-max tie-break) and stop codes 3, 2, 1, 4 in that order.
__device__ Dec decide(const Args& a, const Smem& s, const Fold& f,
                      int steps, int budget, int rec_count, int clen) {
  const float* counts = s.gcount;
  const int* has = s.ghas;
  const int itotal = (int)f.tot;
  const bool cost_overflow = a.l2 && f.max_eds > 2048;
  const bool fin_ovf_j = f.max_fin >= a.E;
  const bool fin_cost_ovf = a.l2 && f.max_fin > 2048;
  const bool all_exact = !(f.flags & kNonexact);
  const bool reached_here =
      a.et ? !(f.flags & kNotReached) : (f.flags & kAnyReached) != 0;
  const float mcf = (float)a.min_count;
  int n_cands = 0, npass = 0, sym_best = 0;
  float maxc = -1.f, thr;
  bool near_any = false;
  if (a.A <= 32) {
    // lane k holds symbol k: counts by ballot, maxima by butterfly
    const int lane = threadIdx.x & 31;
    const bool in = lane < a.A;
    const bool has_raw = in && has[lane] != 0;
    n_cands = __popc(__ballot_sync(kFull, has_raw));
    const int dropped = a.wc >= 0 && n_cands > 1 ? a.wc : -1;
    const bool hv = has_raw && lane != dropped;
    const float c = in && lane != dropped ? counts[lane] : 0.f;
    maxc = hv ? c : -1.f;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      maxc = fmaxf(maxc, __shfl_xor_sync(kFull, maxc, k));
    thr = fminf(mcf, maxc);
    const bool passing = hv && c >= thr;
    npass = __popc(__ballot_sync(kFull, passing));
    near_any = __ballot_sync(kFull, hv && fabsf(c - thr) < kVoteEps) != 0;
    float best = passing ? c : -1.f;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, k));
    // the first symbol at the passing maximum (0 when none passes)
    const unsigned at = __ballot_sync(kFull, passing && c == best);
    sym_best = at ? __ffs(at) - 1 : 0;
  } else {
    for (int k = 0; k < a.A; ++k) n_cands += has[k] != 0;
    const int dropped = a.wc >= 0 && n_cands > 1 ? a.wc : -1;
    for (int k = 0; k < a.A; ++k)
      maxc = fmaxf(maxc, has[k] && k != dropped ? counts[k] : -1.f);
    thr = fminf(mcf, maxc);
    float best = -1.f;
    for (int k = 0; k < a.A; ++k) {
      const bool hv = has[k] != 0 && k != dropped;
      const float c = k != dropped ? counts[k] : 0.f;
      const bool passing = hv && c >= thr;
      npass += passing;
      near_any = near_any || (hv && fabsf(c - thr) < kVoteEps);
      const float ca = passing ? c : -1.f;
      if (ca > best) {
        sym_best = k;
        best = ca;
      }
    }
  }
  const bool near_tie = fabsf(maxc - mcf) < kVoteEps || near_any;
  const bool dirty = (!all_exact && near_tie) || npass != 1 ||
                     n_cands == 0 || cost_overflow;
  const bool rec_blocked = !a.allow_records || fin_ovf_j || fin_cost_ovf ||
                           rec_count >= kRecCap;
  const bool wins_pop = itotal < a.other_cost ||
                        (itotal == a.other_cost && clen > a.other_len);
  int code = 0;
  if (itotal > budget || !wins_pop) code = 3;
  else if (reached_here && rec_blocked) code = 2;
  else if (dirty) code = 1;
  else if (steps >= a.max_steps) code = 4;
  return Dec{code, sym_best, reached_here, (int)f.fin_tot};
}

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads, 1) run_extend_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const Smem s = carve<kOnChip>(smem_raw, a);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  Ctx x;
  x.rank = (int)cl.block_rank();
  x.warp = tid >> 5;
  x.lane = tid & 31;
  x.P = part_words(a.A);
  x.r0 = x.rank * a.rpc;
  x.nloc = max(0, min(a.rpc, a.R - x.r0));
  x.lo = min(x.warp * a.rpw, x.nloc);
  x.hi = min(x.lo + a.rpw, x.nloc);
  x.ring_mask = ring_len(a.W) - 1;
  const bool lead = x.rank == 0 && tid == 0;
  const size_t hR = (size_t)a.h * a.R;
  const int clen0 = a.clen[a.h];

  for (int lr = tid; lr < x.nloc; lr += nthreads) {
    const size_t hr = hR + x.r0 + lr;
    s.e[lr] = a.e[hr];
    s.rmin[lr] = a.rmin[hr];
    s.er[lr] = a.er[hr];
    s.off[lr] = a.off[hr];
    s.act[lr] = a.act[hr] != 0;
    s.rlen[lr] = a.rlen[x.r0 + lr];
    s.fin[lr] = 0;
  }
  for (int i = tid; i < a.nw * a.A; i += nthreads) s.hist[i] = 0;
  if (tid < 8) s.dec[tid] = 0;
  if (kOnChip) {
    // each warp loads its own reads' rows and symbol rings
    const int RS = x.ring_mask + 1;
    for (int lr = x.lo; lr < x.hi; ++lr) {
      const int r = x.r0 + lr;
      if (!a.act[hR + r]) continue;
      const int32_t* src = a.D + (hR + r) * a.W;
      int32_t* dst = row<kOnChip>(a, s, 0, lr, r);
      for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
      const int base = clen0 - a.off[hR + r] - a.E;
      for (int k = x.lane; k <= a.W; k += 32) {
        const int i = base + k;
        s.ring[(size_t)lr * RS + (i & x.ring_mask)] =
            (int16_t)read_sym(a, r, i);
      }
    }
  }
  __syncthreads();

  // The read window's feed, one step ahead: lane l of a warp holds in
  // `pend` the symbol that the column at length j + 1 adds to the ring of
  // the warp's read lo + l; it is loaded a whole step before the column at
  // length j stores it (that slot is outside the window of the column at
  // j), so the device-memory latency stays off the step.
  const int feed_lr = x.lo + x.lane;
  const bool feeds = kOnChip && feed_lr < x.hi && s.act[feed_lr];
  const int feed_base =
      feeds ? a.W - s.off[feed_lr] - a.E : 0;  // ring position - j
  int16_t* feed_ring =
      feeds ? s.ring + (size_t)feed_lr * (x.ring_mask + 1) : nullptr;
  int pend = feeds ? read_sym(a, x.r0 + feed_lr, clen0 + 1 + feed_base) : 0;

  int steps = 0, clen = clen0, cur = 0, p = 0, rec_count = 0;
  int budget = a.me_budget;
  Dec dec{0, a.first_sym, 0, 0};

  // After a pass: the warps' partials -> the CTA's partial, stored into
  // every CTA's gather rows of parity p -> the one cluster barrier of the
  // step -> warp 0 folds the gathered rows and decides the next step with
  // the counters it will have then (n_steps, n_budget, n_rec, n_clen) ->
  // broadcast in the CTA.  Returns whether the pass's column overflowed.
  auto publish = [&](int n_steps, int n_budget, int n_rec, int n_clen) {
    __syncthreads();
    if (x.warp == 0) {
      clu::cta_fold<Part>(cl, s.wpart, a.nw, x.P, a.A, s.part,
                          s.gath + (size_t)p * kMaxCluster * x.P, x.rank,
                          a.csize);
    }
    cl.sync();
    if (x.warp == 0) {
      const Fold f = cluster_fold(a, s, x, p);
      const Dec d = decide(a, s, f, n_steps, n_budget, n_rec, n_clen);
      if (x.lane == 0) {
        s.dec[0] = d.code;
        s.dec[1] = d.sym;
        s.dec[2] = d.reached_here;
        s.dec[3] = d.fin_total;
        s.dec[4] = (f.flags & kOvf) != 0;
      }
    }
    p ^= 1;
    __syncthreads();
    const Dec d{s.dec[0], s.dec[1], s.dec[2], s.dec[3]};
    const bool ovf = s.dec[4] != 0;
    dec = d;
    return ovf;
  };

  if (a.first_sym < 0) {
    // the vote of the committed column
    warp_pass<kOnChip>(a, s, x, false, false, cur, clen, 0);
    publish(steps, budget, rec_count, clen);
    for (int lr = x.lo + x.lane; lr < x.hi; lr += 32)
      if (s.act[lr]) s.fin[lr] = s.fin2[lr];
    __syncwarp();
  }
  // one consensus symbol per iteration (the first one forced when
  // first_sym >= 0) until a stop code
  while (dec.code == 0) {
    const Dec cur_dec = dec;
    if (feeds) {
      feed_ring[(clen + 1 + feed_base) & x.ring_mask] = (int16_t)pend;
      pend = read_sym(a, x.r0 + feed_lr, clen + 2 + feed_base);
    }
    __syncwarp();
    warp_pass<kOnChip>(a, s, x, true, false, cur, clen + 1, cur_dec.sym);
    // the counters after this step's commit
    int rec_next = rec_count, budget_next = budget;
    if (cur_dec.reached_here) {
      rec_next += 1;
      budget_next = min(budget, cur_dec.fin_total);
    }
    if (publish(steps + 1, budget_next, rec_next, clen + 1)) {
      dec.code = 5;  // the column stays uncommitted
      break;
    }
    if (cur_dec.reached_here) {
      // record of the popped (pre-push) state
      const int ri = min(rec_count, kRecCap - 1);
      for (int lr = x.lo + x.lane; lr < x.hi; lr += 32)
        a.rec_fins[(size_t)ri * a.R + x.r0 + lr] = s.fin[lr];
      if (lead) a.rec_steps[ri] = steps;
    }
    if (lead) {
      a.cons[(size_t)a.h * a.C + clen] = cur_dec.sym;
      a.out[a.o_syms + steps] = cur_dec.sym;
    }
    for (int lr = x.lo + x.lane; lr < x.hi; lr += 32) {
      if (!s.act[lr]) continue;
      s.e[lr] = s.e2[lr];
      s.rmin[lr] = s.rmin2[lr];
      s.er[lr] = s.er2[lr];
      s.fin[lr] = s.fin2[lr];
    }
    __syncwarp();
    rec_count = rec_next;
    budget = budget_next;
    steps += 1;
    clen += 1;
    cur ^= 1;
  }

  // ---- final snapshot over the committed column, write-back of slot h
  const int flags = warp_pass<kOnChip>(a, s, x, false, true, cur, clen, 0);
  if (x.lane == 0 && (flags & kFinOvf)) atomicOr(&s.dec[7], 1);
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
    if (!s.act[lr] || (!kOnChip && cur == 0)) continue;
    const int32_t* src = row<kOnChip>(a, s, cur, lr, r);
    int32_t* dst = a.D + (hR + r) * a.W;
    for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
  }
  for (int lr = x.lo + x.lane; lr < x.hi; lr += 32) {
    const size_t hr = hR + x.r0 + lr;
    a.e[hr] = s.e[lr];
    a.rmin[hr] = s.rmin[lr];
    a.er[hr] = s.er[lr];
  }
  cl.sync();
  if (lead) {
    int fin_ovf = 0;
    for (int q = 0; q < a.csize; ++q)
      fin_ovf |= *cl.map_shared_rank(&s.dec[7], q);
    a.out[0] = steps;
    a.out[1] = dec.code;
    a.out[2] = rec_count;
    a.out[3] = fin_ovf;
    a.out[4] = clen;
    a.out[5] = a.out[6] = a.out[7] = 0;
    a.clen[a.h] = clen;
  }
  // no CTA leaves while rank 0 may still read its shared memory
  cl.sync();
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
  auto* fn = run_extend_kernel<kOnChip>;
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
      g_checked[g_nchecked % 16] = Checked{(const void*)fn, a.csize, threads, smem};
      g_nchecked = g_nchecked < 16 ? g_nchecked + 1 : 16;
    }
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one cluster of
// `csize` CTAs of `threads` threads on `stream`, with the geometry of the
// plan (`plan_run` in ops/run_kernel.py): `rpc` reads per CTA, `rpw` per
// warp, the band on chip (`on_chip`) or in device memory (`scratch` then
// holds the second buffer), `smem` bytes of dynamic shared memory.
// Returns 0 on success, -1 when the plan does not cover the shape or its
// shared memory disagrees with the kernel's layout, -2 when no cluster of
// that shape fits on the device, else the CUDA error; the launch does not
// synchronise.
extern "C" int run_extend_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* scratch, void* out,
    void* rec_steps, void* rec_fins, int h, int R, int W, int C, int L,
    int A, int me_budget, int other_cost, int other_len, int min_count,
    int l2, int max_steps, int first_sym, int allow_records, int wc, int et,
    int csize, int threads, int rpc, int rpw, int on_chip, long long smem,
    void* stream) {
  Args a;
  a.D = static_cast<int32_t*>(D);
  a.e = static_cast<int32_t*>(e);
  a.rmin = static_cast<int32_t*>(rmin);
  a.er = static_cast<int32_t*>(er);
  a.off = static_cast<const int32_t*>(off);
  a.act = static_cast<const uint8_t*>(act);
  a.cons = static_cast<int32_t*>(cons);
  a.clen = static_cast<int32_t*>(clen);
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.scratch = static_cast<int32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.rec_steps = static_cast<int32_t*>(rec_steps);
  a.rec_fins = static_cast<int32_t*>(rec_fins);
  a.h = h; a.R = R; a.W = W; a.C = C; a.L = L; a.A = A;
  a.E = (W - 2) / 2;
  a.me_budget = me_budget; a.other_cost = other_cost;
  a.other_len = other_len; a.min_count = min_count; a.l2 = l2;
  a.max_steps = max_steps; a.first_sym = first_sym;
  a.allow_records = allow_records; a.wc = wc; a.et = et;
  a.csize = csize; a.nw = threads / 32; a.rpc = rpc; a.rpw = rpw;
  // packed output layout (mirrors run_kernel.out_layout)
  a.o_eds = 8;
  a.o_split = a.o_eds + R;
  a.o_reached = a.o_split + R;
  a.o_fin = a.o_reached + R;
  a.o_occ = a.o_fin + R;
  a.o_syms = a.o_occ + R * A;
  const bool plan_ok =
      csize >= 1 && csize <= kMaxCluster && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && rpc >= 1 && rpw >= 1 &&
      (long long)csize * rpc >= R && (long long)a.nw * rpw >= rpc &&
      A >= 1 && W >= 4 && (on_chip || scratch != nullptr) &&
      (size_t)smem == smem_bytes(rpc, a.nw, W, A, on_chip != 0);
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_chip ? launch<true>(a, threads, (size_t)smem, st)
                 : launch<false>(a, threads, (size_t)smem, st);
}
