// The single-branch run loop of the consensus search, shared by the run
// kernel (csrc/run_extend.cu: one branch a launch, its slot updated in
// place) and the frontier-gang kernel (csrc/run_ragged.cu: up to 8
// branches a launch, one thread-block cluster each, every result written
// to deposit buffers and no slot touched).  `run_branch` is the whole
// body of one cluster: a forced first push, then one consensus symbol per
// step while the reads' tip votes name a unique passing candidate, and a
// final stats snapshot.  Decision for decision it computes what
// waffle_con_tpu_torch/ops/run_kernel.py's `run_extend_plain` computes
// (stop codes 1-5, record absorption, the float32 vote fold under the
// VOTE_EPS contract); both kernels run this one body, so a gang member's
// result is the solo launch's bit for bit.
//
// What bounds it.  Not bytes or operations: a step's work is small (R x W
// band cells, ~20 int32 operations each: 0.16 us of the card's int32
// rate at R = 256, W = 514), and each step needs the decision of the step
// before, so the loop is bound by the latency of one step.  A step is one
// DP column per read, the tip votes of the new column, and the reduction
// of every read's votes and folds into one decision.
//
// Design.  One thread-block cluster per branch (1-16 CTAs of at most 16
// warps, the geometry chosen by `plan_run` in ops/run_kernel.py and
// passed in).  Reads are split over the CTAs in contiguous blocks and,
// within a CTA, over its warps: at the north star (R = 256, W = 514) 16
// CTAs of 16 warps, one read per warp, so a step costs one read's column
// on each of 16 SMs.
//  * The band lives on chip: each CTA loads its reads' rows once, with a
//    second buffer for the next column (a step swaps an index; a column
//    that overflows the band, code 5, is simply never swapped in) and
//    writes them back once at the end.  Shapes whose two buffers do not
//    fit in 16 CTAs keep the rows in device memory (the home rows and a
//    scratch buffer) through the template parameter kOnChip; the planner
//    decides this from the shape alone.
//  * The column step (band_ops.cuh `column_step_runs`) gives each lane a
//    contiguous run of cells: the insertion chain is a sequential min along
//    the run plus one warp scan per column, and the new column's tip votes
//    come from a third walk by the few lanes whose least cell is within
//    the new e, so the vote needs no pass of its own.
//  * The read window: each read keeps a ring of its symbols in shared
//    memory (a power of two >= W + 2 slots) holding the current window; the
//    one symbol a step adds is loaded from device memory a whole step ahead
//    and stored at the top of the step, so no device-memory latency lies on
//    the step.
//  * One cluster barrier per step: the vote of step j + 1 is taken in the
//    column pass of step j, over the column just written.  Each warp folds
//    its reads into a partial (in read order), warp 0 folds the warps'
//    partials (in warp order) into the CTA's partial and stores it over
//    distributed shared memory into slot `rank` of every CTA's
//    parity-double-buffered gather rows, then one barrier.cluster
//    arrive/wait.  Warp 0 of every CTA then folds the gathered rows in
//    rank order (float32 adds with __fadd_rn, wrapping unsigned int32
//    totals; csrc/cluster_ops.cuh) and takes the decision; every CTA
//    computes the same one, so no second cluster barrier is needed, only a
//    CTA barrier to broadcast it.
//  * Record rows and the snapshot's per-read outputs are written by the
//    CTA that owns each read; the symbols, record steps, scalars and the
//    consensus by rank 0.
//  * The gang kernel's instantiation (kScoped, csrc/run_ragged.cu) runs a
//    branch on the ranks [base, base + csize) of a larger cluster, beside
//    other branches, and replaces every cluster barrier by an exchange
//    among those ranks only: warp 0 folds the CTA's partial straight into
//    its own gather row of parity p, stores it into the same row of each
//    peer with st.async, each store completing its bytes on the peer's
//    mbarrier of parity p, and waits for its own barrier's phase (one
//    arrival, its own, expecting the peers' bytes).  The fold over the
//    gathered rows is then the one above, in the branch's own rank order,
//    so the result is bitwise the solo launch's.  Why the two parities
//    are enough without a full barrier: a CTA stores its step-j+2 partial
//    into a peer's parity row only after it has received every step-j+1
//    partial, and each peer stored its step-j+1 partial only after it had
//    folded (and so read) its step-j rows; so no store lands on a row
//    before its owner is done with it, and the barrier of that parity is
//    then in the phase the store counts toward.  At the end, instead of
//    the two cluster barriers, one last exchange (the snapshot's band
//    overflow flag, 4 bytes a peer): a CTA exits only after every peer's
//    store into it has landed, so no store reaches a CTA that has left.
//    The barriers live in the partial's words (`part`), which the
//    instantiation does not otherwise use, and are made visible by one
//    cluster barrier at the start, before any CTA may leave.
//  * The shard instance (csrc/store_shards.cuh; `run_extend_shards_launch`
//    in csrc/run_extend.cu) runs one branch of a read-sharded store whose
//    shards share the card: `Args.sh` lists the shards, and each read's
//    rows, folds and symbols are taken from its own shard, in place.  The
//    CTAs' blocks of reads, the fold and the outputs stay over the store's
//    global reads, so the run is the one-store run of the gathered store
//    bit for bit; rank 0 writes each symbol and the final length into
//    every shard's consensus row.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "band_ops.cuh"
#include "cluster_ops.cuh"
#include "store_shards.cuh"

namespace {

namespace cg = cooperative_groups;

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

// One branch's run.  The branch's state is read from the `*_in` rows and
// left in the home rows (`Dh`, `*_out`); the run kernel points both at the
// branch's slot, the gang kernel reads the slot and leaves the result in a
// deposit.
struct Args {
  const int32_t* Ds;       // [R, W] band rows at the start
  int32_t* Dh;             // [R, W] band rows at the end (the device-memory
                           // band's buffer 0)
  const int32_t* e_in;     // [R]
  const int32_t* rmin_in;  // [R]
  const int32_t* er_in;    // [R]
  int32_t* e_out;          // [R]
  int32_t* rmin_out;       // [R]
  int32_t* er_out;         // [R]
  const int32_t* off;      // [R]
  const uint8_t* act;      // [R] (torch.bool)
  const int32_t* cons_in;  // [C] consensus row at the start
  int32_t* cons_out;       // [C] consensus row at the end
  const int32_t* clen_in;  // [1]
  int32_t* clen_out;       // [1]
  const int16_t* reads;    // [R, L] dense symbol ids, -1 padded
  const int32_t* rlen;     // [R]
  int32_t* scratch;        // [R, W] second band buffer (device-memory band)
  int32_t* out;            // packed outputs (run_kernel.out_layout)
  int32_t* rec_steps;      // [REC_CAP]
  int32_t* rec_fins;       // [REC_CAP, R]
  int R, W, C, L, A, E;
  int me_budget, other_cost, other_len, min_count, l2, max_steps;
  int first_sym, allow_records, wc, et;
  // consensus length the caller expects at the start (-1: not checked); a
  // branch that disagrees runs nothing and reports code -1
  int len0;
  // a read-sharded store (csrc/store_shards.cuh): `nsh` shard records in
  // device memory, `Rs` reads each, the branch at slot `slot` of every
  // shard; the store rows above (Ds .. clen_out, reads, rlen) are then
  // unused.  Null: one store.
  const StoreShard* sh;
  int nsh, Rs, slot;
  int csize, nw, rpc, rpw;  // the launch plan
  // offsets of the packed output fields
  int o_eds, o_split, o_reached, o_fin, o_occ, o_syms;
};

// The per-branch fields of Args that depend only on the shape and plan.
inline void set_shape(Args& a, int R, int W, int C, int L, int A, int csize,
                      int threads, int rpc, int rpw) {
  a.R = R; a.W = W; a.C = C; a.L = L; a.A = A;
  a.E = (W - 2) / 2;
  a.sh = nullptr;  // one store unless the caller lists shards after this
  a.nsh = 1; a.Rs = R; a.slot = 0;
  a.csize = csize; a.nw = threads / 32; a.rpc = rpc; a.rpw = rpw;
  // packed output layout (mirrors run_kernel.out_layout)
  a.o_eds = 8;
  a.o_split = a.o_eds + R;
  a.o_reached = a.o_split + R;
  a.o_fin = a.o_reached + R;
  a.o_occ = a.o_fin + R;
  a.o_syms = a.o_occ + R * A;
}

// Whether a plan covers the shape (with the band on chip a warp feeds at
// most 32 symbol rings, one a lane) and its shared memory matches the
// kernel's layout.
inline bool plan_ok(const Args& a, int threads, int on_chip, size_t smem) {
  return a.csize >= 1 && a.csize <= kMaxCluster && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 && a.rpc >= 1 &&
         a.rpw >= 1 && (long long)a.csize * a.rpc >= a.R &&
         (long long)a.nw * a.rpw >= a.rpc && (!on_chip || a.rpw <= 32) &&
         a.A >= 1 && a.W >= 4 &&
         smem == smem_bytes(a.rpc, a.nw, a.W, a.A, on_chip != 0);
}

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

// Read r's words of the branch on a sharded store: row r % Rs of slot
// `slot` in shard r / Rs.
__device__ __forceinline__ shards::Cell shard_cell(const Args& a, int r) {
  const int k = r / a.Rs;
  return shards::cell_of(a.sh[k], a.Rs, a.W, a.L, a.slot, r - k * a.Rs);
}

// Band row of read r at the start and at the end (the same row on a
// sharded store).
__device__ __forceinline__ const int32_t* start_row(const Args& a, int r) {
  return a.sh ? shard_cell(a, r).D : a.Ds + (size_t)r * a.W;
}
__device__ __forceinline__ int32_t* home_row(const Args& a, int r) {
  return a.sh ? shard_cell(a, r).D : a.Dh + (size_t)r * a.W;
}

// Read r's symbols [L].
__device__ __forceinline__ const int16_t* read_row(const Args& a, int r) {
  return a.sh ? shard_cell(a, r).rd : a.reads + (size_t)r * a.L;
}

// Band row of local read lr (global r) in buffer buf.
template <bool kOnChip>
__device__ __forceinline__ int32_t* row(const Args& a, const Smem& s,
                                        int buf, int lr, int r) {
  if (kOnChip) return s.band + ((size_t)buf * a.rpc + lr) * a.W;
  return buf == 0 ? home_row(a, r) : a.scratch + (size_t)r * a.W;
}

// Symbol of read r at position i (-1 outside [0, L)), from device memory.
__device__ __forceinline__ int read_sym(const Args& a, int r, int i) {
  return i >= 0 && i < a.L ? read_row(a, r)[i] : -1;
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
    const band::GlobalWindow gwin{read_row(a, r), a.L};
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

// The whole run of one branch on the calling thread-block cluster (with
// kScoped, on its ranks [base, base + a.csize)).
template <bool kOnChip, bool kScoped = false>
__device__ __forceinline__ void run_branch(const Args& a, char* smem_raw,
                                           int base = 0) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const Smem s = carve<kOnChip>(smem_raw, a);
  // the scoped exchange's barriers, one a parity, in the partial's words
  uint64_t* bars = reinterpret_cast<uint64_t*>(s.part);
  if constexpr (kScoped) {
    if (tid == 0) {
      clu::bar_init(&bars[0]);
      clu::bar_init(&bars[1]);
      clu::bar_init_fence();
    }
    cl.sync();  // the cluster's one barrier: every CTA's barriers ready
  }
  const int clen0 = a.sh ? a.sh[0].clen[a.slot] : *a.clen_in;
  if (a.len0 >= 0 && clen0 != a.len0) {
    // the caller's consensus and the branch disagree: every CTA of the
    // branch sees the same length and leaves before any exchange
    if ((int)cl.block_rank() == base && tid == 0) {
      a.out[0] = 0;
      a.out[1] = -1;
      a.out[2] = a.out[3] = 0;
      a.out[4] = clen0;
      a.out[5] = a.out[6] = a.out[7] = 0;
    }
    return;
  }
  Ctx x;
  x.rank = (int)cl.block_rank() - base;
  x.warp = tid >> 5;
  x.lane = tid & 31;
  x.P = part_words(a.A);
  x.r0 = x.rank * a.rpc;
  x.nloc = max(0, min(a.rpc, a.R - x.r0));
  x.lo = min(x.warp * a.rpw, x.nloc);
  x.hi = min(x.lo + a.rpw, x.nloc);
  x.ring_mask = ring_len(a.W) - 1;
  const bool lead = x.rank == 0 && tid == 0;
  const bool moves = a.Ds != a.Dh;  // the result goes to other rows

  for (int lr = tid; lr < x.nloc; lr += nthreads) {
    const int r = x.r0 + lr;
    if (a.sh) {
      const shards::Cell c = shard_cell(a, r);
      s.e[lr] = *c.e;
      s.rmin[lr] = *c.rmin;
      s.er[lr] = *c.er;
      s.off[lr] = *c.off;
      s.act[lr] = *c.act != 0;
      s.rlen[lr] = *c.rlen;
    } else {
      s.e[lr] = a.e_in[r];
      s.rmin[lr] = a.rmin_in[r];
      s.er[lr] = a.er_in[r];
      s.off[lr] = a.off[r];
      s.act[lr] = a.act[r] != 0;
      s.rlen[lr] = a.rlen[r];
    }
    s.fin[lr] = 0;
  }
  if (x.rank == 0 && a.cons_in != a.cons_out) {
    for (int i = tid; i < clen0; i += nthreads) a.cons_out[i] = a.cons_in[i];
  }
  for (int i = tid; i < a.nw * a.A; i += nthreads) s.hist[i] = 0;
  if (tid < 8) s.dec[tid] = 0;
  // each warp sets up its own reads' rows: on chip, the active rows and
  // their symbol rings; the rows that do not step go to the home rows
  // as they are (all of them with the band in device memory, whose
  // buffer 0 is the home rows)
  const int RS = x.ring_mask + 1;
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
    const bool active = (a.sh ? *shard_cell(a, r).act : a.act[r]) != 0;
    const int32_t* src = start_row(a, r);
    if (moves && (!kOnChip || !active)) {
      int32_t* dst = home_row(a, r);
      for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
    }
    if (!kOnChip || !active) continue;
    int32_t* dst = row<kOnChip>(a, s, 0, lr, r);
    for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
    const int base = clen0 - (a.sh ? *shard_cell(a, r).off : a.off[r]) - a.E;
    for (int k = x.lane; k <= a.W; k += 32) {
      const int i = base + k;
      s.ring[(size_t)lr * RS + (i & x.ring_mask)] =
          (int16_t)read_sym(a, r, i);
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
  int phase[2] = {0, 0};  // each scoped barrier's phase parity

  // kScoped: warp 0 stores `words` words of the CTA's gather row of parity
  // p (already written) into each peer's, then waits until the peers'
  // rows of that parity have landed in this CTA.
  auto exchange = [&](int words) {
    int* mine = s.gath + ((size_t)p * kMaxCluster + x.rank) * x.P;
    if (x.lane == 0) {
      clu::bar_expect(&bars[p], 4u * words * (a.csize - 1));
    }
    if (words == 1) {
      const uint32_t src = clu::smem_addr(mine + kFlags);
      const uint32_t b = clu::smem_addr(&bars[p]);
      for (int q = x.lane; q < a.csize; q += 32) {
        if (q != x.rank) {
          clu::st_async(clu::peer_addr(src, base + q), mine[kFlags],
                        clu::peer_addr(b, base + q));
        }
      }
    } else {
      clu::push_scoped(mine, words, base, a.csize, base + x.rank, &bars[p]);
    }
    clu::bar_wait(&bars[p], phase[p]);
    phase[p] ^= 1;
  };

  // After a pass: the warps' partials -> the CTA's partial, stored into
  // every CTA's gather rows of parity p -> the one cluster barrier of the
  // step -> warp 0 folds the gathered rows and decides the next step with
  // the counters it will have then (n_steps, n_budget, n_rec, n_clen) ->
  // broadcast in the CTA.  Returns whether the pass's column overflowed.
  auto publish = [&](int n_steps, int n_budget, int n_rec, int n_clen) {
    __syncthreads();
    if constexpr (kScoped) {
      if (x.warp == 0) {
        // the CTA's partial folded straight into its own gather row
        int* mine = s.gath + ((size_t)p * kMaxCluster + x.rank) * x.P;
        unsigned head[kFlags + 1];
        clu::fold<Part>(s.wpart, a.nw, x.P, a.A, head,
                        [&](int, int k, int hv, float c) {
                          mine[Part::has_at(a.A, 0) + k] = hv;
                          mine[Part::counts_at(a.A, 0) + k] =
                              __float_as_int(c);
                        });
        if (x.lane == 0) {
#pragma unroll
          for (int w = 0; w <= kFlags; ++w) mine[w] = (int)head[w];
        }
        __syncwarp();
        exchange(x.P);
      }
    } else {
      if (x.warp == 0) {
        clu::cta_fold<Part>(cl, s.wpart, a.nw, x.P, a.A, s.part,
                            s.gath + (size_t)p * kMaxCluster * x.P, x.rank,
                            a.csize);
      }
      cl.sync();
    }
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
      if (a.sh) {
        for (int k = 0; k < a.nsh; ++k)
          a.sh[k].cons[(size_t)a.slot * a.C + clen] = cur_dec.sym;
      } else {
        a.cons_out[clen] = cur_dec.sym;
      }
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

  // ---- final snapshot over the committed column, write-back of the rows
  const int flags = warp_pass<kOnChip>(a, s, x, false, true, cur, clen, 0);
  if (x.lane == 0 && (flags & kFinOvf)) atomicOr(&s.dec[7], 1);
  for (int lr = x.lo; lr < x.hi; ++lr) {
    const int r = x.r0 + lr;
    if (!s.act[lr] || (!kOnChip && cur == 0)) continue;
    const int32_t* src = row<kOnChip>(a, s, cur, lr, r);
    int32_t* dst = home_row(a, r);
    for (int t = x.lane; t < a.W; t += 32) dst[t] = src[t];
  }
  for (int lr = x.lo + x.lane; lr < x.hi; lr += 32) {
    const int r = x.r0 + lr;
    if (a.sh) {
      const shards::Cell c = shard_cell(a, r);
      *c.e = s.e[lr];
      *c.rmin = s.rmin[lr];
      *c.er = s.er[lr];
    } else {
      a.e_out[r] = s.e[lr];
      a.rmin_out[r] = s.rmin[lr];
      a.er_out[r] = s.er[lr];
    }
  }
  int fin_ovf = 0;
  if constexpr (kScoped) {
    // the last exchange: each CTA's flag into its peers' rows; after it
    // no store is on its way to this CTA
    __syncthreads();
    if (x.warp == 0) {
      int* row = s.gath + (size_t)p * kMaxCluster * x.P;
      if (x.lane == 0) row[x.rank * x.P + kFlags] = s.dec[7];
      __syncwarp();
      exchange(1);
      for (int q = 0; q < a.csize; ++q) fin_ovf |= row[q * x.P + kFlags];
    }
  } else {
    cl.sync();
    if (lead) {
      for (int q = 0; q < a.csize; ++q)
        fin_ovf |= *cl.map_shared_rank(&s.dec[7], q);
    }
  }
  if (lead) {
    a.out[0] = steps;
    a.out[1] = dec.code;
    a.out[2] = rec_count;
    a.out[3] = fin_ovf;
    a.out[4] = clen;
    a.out[5] = a.out[6] = a.out[7] = 0;
    if (a.sh) {
      for (int k = 0; k < a.nsh; ++k) a.sh[k].clen[a.slot] = clen;
    } else {
      *a.clen_out = clen;
    }
  }
  // no CTA leaves while rank 0 may still read its shared memory
  if constexpr (!kScoped) cl.sync();
}

// Launch shapes already checked on this device (attributes set, at least
// one cluster of the shape fits), for the kernels of one source file.
struct Checked {
  const void* fn;
  int csize, threads;
  size_t smem;
};
std::mutex g_checked_mu;
Checked g_checked[16];
int g_nchecked = 0;

// The launch configuration of `nclusters` clusters of `csize` CTAs.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         int csize, int nclusters,
                                         int threads, size_t smem,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(csize * nclusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The dynamic shared memory each kernel of the file is allowed so far.
struct SmemAttr {
  const void* fn;
  size_t smem;
};
SmemAttr g_smem_attr[4];

// Sets the kernel's attributes for the shape and returns how many of its
// clusters fit on the device at once in `*clusters` (CUDA error, or 0).
// The caller holds g_checked_mu.
template <class Fn>
int cluster_capacity(Fn* fn, int csize, int threads, size_t smem,
                     int* clusters) {
  // the attribute only ever grows, so shapes checked earlier still fit
  SmemAttr* at = nullptr;
  for (SmemAttr& s : g_smem_attr) {
    if (s.fn == (const void*)fn || (!at && !s.fn)) at = &s;
    if (s.fn == (const void*)fn) break;
  }
  if (!at) return -1;
  if (at->fn != (const void*)fn || smem > at->smem) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *at = SmemAttr{(const void*)fn, smem};
  }
  if (csize > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(attr, csize, 1, threads, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// Launch `nclusters` clusters of `fn` with argument `arg`.  Returns 0, -2
// when no cluster of the shape fits on the device, else the CUDA error;
// the launch does not synchronise.
template <class Fn, class Arg>
int launch_clusters(Fn* fn, const Arg& arg, int csize, int nclusters,
                    int threads, size_t smem, cudaStream_t stream) {
  {
    std::lock_guard<std::mutex> lock(g_checked_mu);
    bool known = false;
    for (int i = 0; i < g_nchecked; ++i) {
      const Checked& c = g_checked[i];
      known |= c.fn == (const void*)fn && c.csize == csize &&
               c.threads == threads && c.smem == smem;
    }
    if (!known) {
      int clusters = 0;
      const int err = cluster_capacity(fn, csize, threads, smem, &clusters);
      if (err != 0) return err;
      if (clusters <= 0) return -2;
      g_checked[g_nchecked % 16] = Checked{(const void*)fn, csize, threads, smem};
      g_nchecked = g_nchecked < 16 ? g_nchecked + 1 : 16;
    }
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(attr, csize, nclusters, threads, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, arg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
