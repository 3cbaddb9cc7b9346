// The K-node pop arena of the branch store, for Hopper (sm_90a).
//
// Replaces `_j_arena` of waffle_con_tpu/ops/jax_scorer.py.  The engine's
// in-hand node and up to K - 1 queue competitors run the host's exact pop
// loop on the device: the winner by (cost, length desc, FIFO rank), both
// node kinds' tracker constriction, the me-budget / threshold / capacity
// / imbalance discards, child creation at clean vote splits (in the
// host's `_build_specs` order, atomic: an overflow in any child commits
// none), one column step of the winner's side or sides with divergence
// pruning, and the stop codes 1-5.  Event for event it computes what
// waffle_con_tpu_torch/ops/arena_kernel.py's `arena_plain` computes.
//
// What bounds it.  An event is a chain: the next winner depends on the
// last commit.  Its work is one node's column step (2 sides x R rows of W
// cells, ~20 int32 operations a cell), a fold of that node's votes and a
// 64-way tournament; at R = 64, W = 258 that is ~0.66 M operations, well
// under a microsecond of the card's int32 rate.  The rows stepped are few
// per event, so an event is latency-bound: the row step's dependent
// passes, barriers and scalar decisions set its time, not bandwidth.
//
// Design: the cluster design of the run kernels (csrc/run_extend_dual.cu)
// with the event as the step.  One thread-block cluster per call (1-16
// CTAs of at most 16 warps, `plan_arena` in ops/arena_kernel.py).
//  * Rows over the cluster.  Reads are split over the CTAs in contiguous
//    blocks of `rpc`; a (side, read) row q = side * rpc + local read
//    belongs to warp q % nw for the whole call, so at the dual north star
//    (R = 64, W = 258: 8 CTAs of 16 warps) each warp owns one row.  Both
//    sides of a read sit in one CTA, so divergence pruning stays in the
//    CTA, and no CTA touches another's rows in the store.
//  * Decisions replicated.  Every CTA keeps an identical copy of the node
//    table (each node's scalars and its decision record with both sides'
//    vote rows) and of the trackers lc / pc, and runs the tournament, the
//    decisions, the child registration and the event's bookkeeping on
//    that copy, so no decision is broadcast.  Only rank 0 writes the
//    call's results (history, per-node fields, cons / clen, creation
//    records); each CTA writes its own reads' rows and stats.
//  * One cluster barrier per commit.  Each warp stages its row and a ring
//    of its read's symbols in shared memory and steps it there, keeping
//    the new column until the commit is known, and keeps the row staged
//    after it: when the same node wins again the step loads nothing (the
//    ring fed with the one symbol prefetched at the write-back).  Warp 0
//    runs the tournament and the decisions (the creation gates' vote
//    tests a symbol per lane); per node, one warp folds the CTA's reads
//    into a partial of the record (wrapping cost sum, largest distance,
//    active reads of each side, the reach / finish / overflow flags with
//    an "all" as the OR of its negation, both sides' vote rows) and
//    stores it into every CTA's gather rows over distributed shared
//    memory (csrc/cluster_ops.cuh; rows double-buffered by parity).  After
//    the one cluster barrier every CTA folds the partials in rank order
//    and gets the same record bit for bit; then each warp writes its new
//    column back into the store, or drops it when a read overflowed the
//    band (code 5 commits nothing).  A split steps its children straight
//    into their pool slots and folds their records `fold_nodes` at a time,
//    one barrier each; the initial records go the same way.  A discard or
//    a stop crosses no barrier.
//  * Placements (the plan): a warp's rows staged in shared memory, or
//    stepped in device memory through a scratch row (`band`, W beyond
//    the staging limit); the records' vote rows and the trackers in
//    shared memory, or in a per-CTA copy in device memory.
//  * The shard instance (`arena_shards_launch`) runs the same kernel on a
//    read-sharded store whose shards share the card, one launch for all of
//    them: the node slots and the creation pool are the same slot indices
//    on every shard, each (side, read) row is read and written in its own
//    shard (csrc/store_shards.cuh), consensus rows and lengths in every
//    shard; the CTAs' reads, the fold and the outputs stay over the
//    store's global reads, so the call is the one-store call of the
//    gathered store bit for bit.
// The vote fold sums in another order than the plain twin (a CTA's reads
// in order, then the ranks); every vote decision the arena takes is exact
// (dyadic tip splits) or has a VOTE_EPS margin, the contract of the run
// kernels.  The profiled variant (`kProf`, the same source) adds rank 0's
// clock64 totals of each part of an event.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

#include "band_ops.cuh"
#include "cluster_ops.cuh"
#include "store_shards.cuh"

namespace cg = cooperative_groups;

namespace {

using band::kFull;
using band::kInf;
using clu::kMaxCluster;

constexpr int kCrePerEvent = 8;
constexpr int kCreCap = 64;
constexpr int kBigTot = INT_MAX;
constexpr int kBig = 1 << 28;
constexpr float kEps = 1e-2f;
constexpr int kMaxK = 64;
constexpr int kMaxA = 128;
constexpr int kParams = 24;
constexpr int kDecWords = 136;
constexpr int kMaxThreads = 512;  // 16 warps
constexpr int kMaxFold = 8;       // node records folded per cluster barrier
constexpr int kMcCache = 256;     // min-count table entries kept on chip

// the packed parameters (ops/arena_kernel.py `_params`)
enum Param {
  P_ME = 0, P_MINC, P_DELTA, P_L2, P_WEIGHTED, P_REST_COST, P_REST_LEN,
  P_NLIVE, P_MAXQ, P_CAP, P_STEPLIM, P_MAXNWC, P_CMODE, P_NPOOL, P_RELAX,
  P_MCDYN, P_WC, P_ET, P_AREAL, P_MAXSTEPS
};

// a node record's flags
enum Flag {
  F_REACH = 1, F_DIRTY = 2, F_IMB = 4, F_FIN1 = 8, F_FIN2 = 16,
  F_COVF = 32, F_EX1 = 64, F_EX2 = 128, F_NT1 = 256, F_NT2 = 512
};

// the decision words in shared memory
enum Dec {
  D_WIN = 0, D_CODE, D_DISC, D_SPLIT, D_NCH, D_FIRST, D_K, D_THR, D_TOTQ,
  D_FAR, D_LCON, D_WLEN, D_NSTEPS, D_SEQCTR, D_POOL, D_CRE, D_OVF, D_DIAG,
  D_CSYM1, D_CSYM2, D_NCS, D_NSIDES, D_STOP,
  D_TR = 24,          // tr[2][4]: threshold, total, farthest, last constr.
  D_SPEC_KIND = 32,   // child t: kind
  D_SPEC_A = 40,      //          side-1 symbol
  D_SPEC_B = 48,      //          side-2 symbol
  D_CS_DST = 56,      // child side i: destination side
  D_CS_SRC = 72,      //               source side
  D_CS_SYM = 88,      //               pushed symbol
  D_RNODE = 104,      // node j of a fold round: node index
  D_RKIND = 112,      //                         1 dual, 0 single
  D_RLEN = 120,       //                         length after the event
  D_RIMB = 128,       //                         its imbalance floor
};

// Words of a commit row's staging state: the store slot its staging
// area holds (-1: none), which of the two columns is current, the row's
// offset and read length, the last step's first read position.
enum CacheWord { C_SLOT = 0, C_CUR, C_OFF, C_RLEN, C_I0, C_N = 8 };

// A node's partial (csrc/cluster_ops.cuh): three wrapping sums (cost,
// active reads of each side), one maximum (the largest active distance),
// the flags; then has[A] and counts[A] of each side.
using Part = clu::Layout<3, 1, 2>;
constexpr int kTot = 0, kN1 = 1, kN2 = 2, kMx = 3, kPF = Part::kFlags;
// partial flags; an "all" test travels as the OR of its negation
enum PFlag {
  PF_NOT_ALL_RR = 1, PF_ANY_RR = 2, PF_NOT_ALL_F1 = 4, PF_ANY_F1 = 8,
  PF_NOT_ALL_F2 = 16, PF_ANY_F2 = 32, PF_ANY_R1 = 64, PF_OVF = 128,
  PF_NONDY1 = 256, PF_NONDY2 = 512
};

// Words of a round's row q = (j * 2 + side) * rpc + local read: the new
// folds, the tip count, the activity before and after pruning; in the
// side-0 row of a read, the read's terms of its node's partial (cost,
// largest active distance, flags).
enum RowWord {
  RW_E = 0, RW_RMIN, RW_ER, RW_SPLIT, RW_ACT, RW_ACTF, RW_HTOT, RW_HMX,
  RW_HFL, RW_N
};

// Words of a staged row: two [W] columns and a ring of the read's
// symbols (band_ops.cuh `ring_len(W)` int16 slots), rounded up to 4 words.
__host__ __device__ inline int stage_words(int W) {
  return (2 * W + band::ring_len(W) / 2 + 3) & ~3;
}

// Dynamic shared memory of one CTA in words (mirrored by
// ops/arena_kernel.py `_smem_bytes`): the CTA's partials and every CTA's
// partials by parity, the node table, the decision words, the winner's
// passing symbols, the row words, tip histograms and vote terms of a
// round, the parameters and slots, the head of the min-count table, each
// commit row's staging state; with the band staged each commit row's staging
// area, then the records' vote rows and the trackers where they live in
// shared memory.
__host__ __device__ inline long long smem_words(int K, int A, int rpc,
                                                int csize, int gn, int W,
                                                int Lw, bool staged,
                                                bool rec_smem,
                                                bool trk_smem) {
  const long long P = Part::words(A);
  long long w = gn * P + 2LL * gn * csize * P + 16LL * K + kDecWords +
                3LL * A + 2LL * gn * rpc * (RW_N + 2LL * A) + kParams +
                2LL * K + kMcCache + 2LL * rpc * C_N;
  if (staged) w += 2LL * rpc * stage_words(W);
  if (rec_smem) w += 4LL * K * A;
  if (trk_smem) w += 4LL * Lw;
  return w;
}

struct Args {
  int32_t* D;
  int32_t* e;
  int32_t* rmin;
  int32_t* er;
  int32_t* off;
  uint8_t* act;
  int32_t* cons;
  int32_t* clen;
  const int16_t* reads;
  const int32_t* rlen;
  const int32_t* in;
  int32_t* out;
  int32_t* scratch;
  int B, R, W, C, L, A, K, Lw, MCN, IMBN, max_steps, E;
  // the plan: cluster, warps, reads per CTA, nodes folded per barrier;
  // placements (1: shared memory)
  int csize, nw, rpc, gn, staged, rec_smem, trk_smem;
  // 1: a warp keeps its commit row staged between events (one row per
  // warp, band staged)
  int keep;
  // packed output (ops/arena_kernel.py `arena_out_layout`)
  int o_hist, o_evsym, o_steps, o_alive, o_kinds, o_clen, o_act, o_eds,
      o_split, o_reached, o_occ, o_cre, o_end;
  // packed input (`arena_in_layout`)
  int i_slots, i_kinds, i_tr, i_lc, i_pc, i_mc, i_imb;
  // device-memory scratch: the commit's new columns [2][R][W] (band in
  // device memory), per CTA the records' vote rows [4][K][A] and the
  // trackers [4][Lw] (where they live in device memory)
  long long s_rec, s_trk;
  // profiled variant: per-part clock64 totals (ops/arena_kernel.py
  // `PROF_FIELDS`)
  long long* prof;
  // a read-sharded store (csrc/store_shards.cuh): `nsh` shard records in
  // device memory, `Rs` reads each; the store pointers above (D .. rlen)
  // are then unused.  Null: one store.
  const StoreShard* sh;
  int nsh, Rs;
};

// Shared memory of one CTA (and the device-memory copies it owns).
struct Smem {
  int* part;    // [gn][P] the CTA's partial of each node of a round
  int* gath;    // [2][gn][csize][P] every CTA's partials, by parity
  int* total;   // [K] record: cost
  int* flags;   // [K] record: Flag bits
  int* sym1;    // [K] record: nominated symbols
  int* sym2;
  int* mc1;     // [K] record: min-count table entries
  int* mc2;
  int* kind;    // [K] 0 single, 1 dual, -1 none
  int* alive;   // [K]
  int* seqv;    // [K] FIFO rank
  int* fresh;   // [K] original queue entry never re-pushed
  int* steps;   // [K]
  int* clen;    // [2K] per-side consensus length
  int* dec;     // [kDecWords]
  int* pass;    // [3A]: passing symbols of the winner's sides, order
  int* rw;      // [2 gn rpc][RW_N] row words of a round
  int* rh;      // [2 gn rpc][A] tip histograms of a round's rows
  float* vt;    // [2 gn rpc][A] their weighted vote terms
  int* pin;     // [kParams + 2K] the parameters and slots of `in`
  int* mcc;     // [kMcCache] the head of the min-count table
  int* cache;   // [2 rpc][C_N] each commit row's staging state
  int32_t* stage;  // [2 rpc][stage_words(W)] (band staged) or null
  float* rcnt;  // [K][2][A] records' vote rows: counts
  int* rhv;     //                               has-vote flags
  int* lc;      // [2][Lw] trackers: length counts
  int* pc;      //                   processed counts
};

__device__ __forceinline__ Smem carve(int* base, const Args& a, int rank) {
  const int K = a.K, A = a.A;
  const int P = Part::words(A);
  Smem s;
  int* p = base;
  s.part = p; p += a.gn * P;  // 16-byte aligned: copied over DSMEM as int4
  s.gath = p; p += 2 * a.gn * a.csize * P;
  s.total = p; p += K;
  s.flags = p; p += K;
  s.sym1 = p; p += K;
  s.sym2 = p; p += K;
  s.mc1 = p; p += K;
  s.mc2 = p; p += K;
  s.kind = p; p += K;
  s.alive = p; p += K;
  s.seqv = p; p += K;
  s.fresh = p; p += K;
  s.steps = p; p += K;
  s.clen = p; p += 5 * K;       // 2K words, 16K for the table
  s.dec = p; p += kDecWords;
  s.pass = p; p += 3 * A;
  s.rw = p; p += 2 * a.gn * a.rpc * RW_N;
  s.rh = p; p += 2 * a.gn * a.rpc * A;
  s.vt = reinterpret_cast<float*>(p); p += 2 * a.gn * a.rpc * A;
  s.pin = p; p += kParams + 2 * K;
  s.mcc = p; p += kMcCache;
  s.cache = p; p += 2 * a.rpc * C_N;
  s.stage = nullptr;
  if (a.staged) {
    s.stage = p;
    p += 2 * a.rpc * stage_words(a.W);
  }
  int* rec = a.rec_smem ? p : a.scratch + a.s_rec + (size_t)rank * 4 * K * A;
  if (a.rec_smem) p += 4 * K * A;
  s.rcnt = reinterpret_cast<float*>(rec);
  s.rhv = rec + 2 * K * A;
  int* trk = a.trk_smem ? p : a.scratch + a.s_trk + (size_t)rank * 4 * a.Lw;
  s.lc = trk;
  s.pc = trk + 2 * a.Lw;
  return s;
}

// Per-thread view of the launch.
struct Ctx {
  int rank, warp, lane, nw;
  int r0, nloc;  // first read of the CTA, reads it owns
};

__device__ __forceinline__ int node_len(const Smem& s, int n) {
  return s.kind[n] == 1 ? max(s.clen[2 * n], s.clen[2 * n + 1])
                        : s.clen[2 * n];
}

// The words of read r of store slot `slot`: the one store's, or read r's
// shard's.
__device__ __forceinline__ shards::Cell slot_cell(const Args& a, int slot,
                                                  int r) {
  const StoreShard own{a.D,   a.e,    a.rmin, a.er,    a.off,
                       a.act, a.cons, a.clen, a.reads, a.rlen};
  return shards::cell(a.sh, a.Rs, own, a.R, a.W, a.L, slot, r);
}

// The words of side f's row of read r.
__device__ __forceinline__ shards::Cell store_row(const Args& a,
                                                  const Smem& s, int f,
                                                  int r) {
  return slot_cell(a, s.pin[kParams + f], r);
}

// The store's consensus rows and lengths in copy k (every shard holds
// one; the one store is copy 0).
__device__ __forceinline__ int copies(const Args& a) {
  return a.sh ? a.nsh : 1;
}
__device__ __forceinline__ int32_t* cons_of(const Args& a, int k) {
  return a.sh ? a.sh[k].cons : a.cons;
}
__device__ __forceinline__ int32_t* clen_of(const Args& a, int k) {
  return a.sh ? a.sh[k].clen : a.clen;
}

// A 4-byte copy from device memory into shared memory that bypasses the
// registers; the copies a thread issued complete at cp_async_wait.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Symbol of read r at position i (-1 outside [0, L)), from device memory.
__device__ __forceinline__ int read_sym(const Args& a, int r, int i) {
  return i >= 0 && i < a.L ? slot_cell(a, 0, r).rd[i] : -1;
}

// Warp 0: the pop winner by (cost asc, length desc, FIFO rank asc); dead
// and unused nodes cost kBigTot.  Every lane returns the winner.
__device__ __forceinline__ int tournament(const Smem& s, int K) {
  const int lane = threadIdx.x & 31;
  int bt = kBigTot, bl = INT_MIN, bq = INT_MAX, bn = -1;
  for (int n = lane; n < K; n += 32) {
    const int t = s.alive[n] && s.kind[n] >= 0 ? s.total[n] : kBigTot;
    const int l = node_len(s, n);
    const int q = s.seqv[n];
    if (bn < 0 || t < bt || (t == bt && (l > bl || (l == bl && q < bq)))) {
      bt = t; bl = l; bq = q; bn = n;
    }
  }
#pragma unroll
  for (int k = 16; k; k >>= 1) {
    const int t = __shfl_xor_sync(kFull, bt, k);
    const int l = __shfl_xor_sync(kFull, bl, k);
    const int q = __shfl_xor_sync(kFull, bq, k);
    const int n = __shfl_xor_sync(kFull, bn, k);
    if (n >= 0 && (bn < 0 || t < bt ||
                   (t == bt && (l > bl || (l == bl && q < bq))))) {
      bt = t; bl = l; bq = q; bn = n;
    }
  }
  return bn;
}

// Warp 0: everything the event decides before any row moves — the
// rest-of-queue and discard tests, both kinds' tracker constriction, the
// creation gates and child specs, and the stop code.  Every lane takes
// the scalar steps on the same shared words; the creation gates' vote
// tests go a symbol per lane; lane 0 writes the decision.
__device__ __forceinline__ void decide(const Args& a, const Smem& s, int win) {
  const int lane = threadIdx.x & 31;
  const int* P = s.pin;
  int* d = s.dec;
  const int K = a.K, A = a.A, Lw = a.Lw;
  const int* lc = s.lc;
  const int* pc = s.pc;
  const int nsteps = d[D_NSTEPS];
  const int step_limit = P[P_STEPLIM];
  const bool first = nsteps == 0;
  if (first) win = 0;
  const int wtot = s.alive[win] && s.kind[win] >= 0 ? s.total[win] : kBigTot;
  const int wlen = node_len(s, win);
  // a commit's record: its imbalance floor at the length after the step
  const int imb_next =
      lane == 0 ? a.in[a.i_imb + min(max(wlen + 1, 0), a.IMBN - 1)] : 0;
  const bool arena_empty = wtot == kBigTot;
  const int rc = P[P_REST_COST], rl = P[P_REST_LEN];
  const bool rest_wins =
      !first && (wtot > rc || (wtot == rc && wlen < rl) ||
                 (wtot == rc && wlen == rl && !s.fresh[win]));
  int* tr = d + D_TR;
  int trv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) trv[i] = tr[i];
  if (!first) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int thr = trv[4 * k], tot = trv[4 * k + 1], lcon = trv[4 * k + 3];
      const int far = trv[4 * k + 2];
      while ((tot > P[P_MAXQ] || lcon >= P[P_MAXNWC]) && thr < far) {
        tot -= lc[k * Lw + min(max(thr, 0), Lw - 1)];
        ++thr;
        lcon = 0;
      }
      trv[4 * k] = thr;
      trv[4 * k + 1] = tot;
      trv[4 * k + 3] = lcon;
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) tr[i] = trv[i];
  }
  const int k = min(max(s.kind[win], 0), 1);
  const int thr = k ? trv[4] : trv[0];
  const int li = min(max(wlen, 0), Lw - 1);
  const int fl = s.flags[win];
  const bool discarded = wtot > P[P_ME] || wlen < thr ||
                         pc[k * Lw + li] >= P[P_CAP] || (fl & F_IMB);
  const bool discard_now = !first && !rest_wins && !arena_empty &&
                           discarded && nsteps < step_limit;

  // ---- creation gates (`_j_arena` :2065-2153), a symbol per lane
  const bool single = s.kind[win] == 0;
  const float* cA = s.rcnt + (win * 2) * A;
  const float* cB = s.rcnt + (win * 2 + 1) * A;
  const int* hvA = s.rhv + (win * 2) * A;
  const int* hvB = s.rhv + (win * 2 + 1) * A;
  const float mcA = (float)s.mc1[win], mcB = (float)s.mc2[win];
  float maxA = -1.f, maxB = -1.f;
  for (int x = lane; x < A; x += 32) {
    if (hvA[x]) maxA = fmaxf(maxA, cA[x]);
    if (hvB[x]) maxB = fmaxf(maxB, cB[x]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    maxA = fmaxf(maxA, __shfl_xor_sync(kFull, maxA, o));
    maxB = fmaxf(maxB, __shfl_xor_sync(kFull, maxB, o));
  }
  const float thA = fminf(mcA, maxA), thB = fminf(mcB, maxB);
  int* passA = s.pass;
  int* passB = s.pass + A;
  int* order = s.pass + 2 * A;
  const int wc = P[P_WC];
  int nA = 0, nB = 0, ncand = 0, npass_mc = 0;
  bool margA = true, margB = true, pair_ok = true;
  for (int x = lane; x < A; x += 32) {
    const int pa = hvA[x] && cA[x] >= thA, pb = hvB[x] && cB[x] >= thB;
    passA[x] = pa;
    passB[x] = pb;
    nA += pa;
    nB += pb;
    const bool cand = hvA[x] && !(wc >= 0 && x == wc);
    ncand += cand;
    npass_mc += cand && cA[x] >= mcA;
    if (hvA[x]) margA &= fabsf(cA[x] - mcA) > kEps;
    if (hvB[x]) margB &= fabsf(cB[x] - mcB) > kEps;
    if (cand) {
      for (int y = 0; y < A; ++y) {
        const bool cy = hvA[y] && !(wc >= 0 && y == wc);
        if (cy && x != y) pair_ok &= fabsf(cA[x] - cA[y]) > kEps;
      }
    }
  }
  nA = __reduce_add_sync(kFull, nA);
  nB = __reduce_add_sync(kFull, nB);
  ncand = __reduce_add_sync(kFull, ncand);
  npass_mc = __reduce_add_sync(kFull, npass_mc);
  margA = __all_sync(kFull, margA);
  margB = __all_sync(kFull, margB);
  pair_ok = __all_sync(kFull, pair_ok);
  const int cmode = P[P_CMODE];
  const int n_pairs =
      cmode >= 2 && npass_mc > 1 ? ncand * (ncand - 1) / 2 : 0;
  const int n_children = single ? nA + n_pairs : nA * nB;
  const bool relax = P[P_RELAX];
  const bool relaxA = relax && !(fl & F_NT1) && margA;
  const bool relaxB = relax && !(fl & F_NT2) && margB;
  const bool ord_ok = pair_ok || cmode < 2;
  const bool exA = fl & F_EX1, exB = fl & F_EX2;
  const bool exact_ok = single ? (exA || (relaxA && ord_ok))
                               : ((exA || relaxA) && (exB || relaxB));
  const bool kind_ok =
      single || (cmode >= 2 && !(fl & F_FIN1) && !(fl & F_FIN2));
  const int pool_next = d[D_POOL], cre_count = d[D_CRE];
  const int n_lim = P[P_NLIVE] + P[P_NPOOL];
  const bool g2 = n_children <= kCrePerEvent;
  const bool g3 = pool_next + n_children <= n_lim;
  const bool g4 = cre_count + n_children <= kCreCap;
  const bool g5 = nsteps + 1 + n_children <= step_limit;
  const bool splitable = cmode >= 1 && exact_ok && kind_ok && g2 && g3 &&
                         g4 && g5 && !(fl & F_COVF) && n_children >= 2;
  const bool dirty = fl & F_DIRTY, reach = fl & F_REACH;
  const bool want_split = dirty && splitable && !reach && !discarded &&
                          !rest_wins && !arena_empty;
  int code = 0;
  if (rest_wins || arena_empty) code = 3;
  else if (discarded) code = first || nsteps >= step_limit ? 4 : 0;
  else if (reach) code = 2;
  else if (dirty && !want_split) code = 1;
  else if (nsteps >= step_limit) code = 4;
  __syncwarp();
  if (lane != 0) return;
  d[D_DIAG] = n_children * 64 + exact_ok + kind_ok * 2 + g2 * 4 + g3 * 8 +
              g4 * 16 + g5 * 32;

  if (want_split) {
    // (count desc, symbol asc) order of the non-wildcard candidates
    int m = 0;
    for (int x = 0; x < A; ++x) order[m++] = x;
    for (int i = 1; i < A; ++i) {
      const int x = order[i];
      const bool cx = hvA[x] && !(wc >= 0 && x == wc);
      const float kx = cx ? -cA[x] : 3e38f;
      int j = i - 1;
      while (j >= 0) {
        const int y = order[j];
        const bool cy = hvA[y] && !(wc >= 0 && y == wc);
        const float ky = cy ? -cA[y] : 3e38f;
        if (ky > kx || (ky == kx && y > x)) {
          order[j + 1] = y;
          --j;
        } else {
          break;
        }
      }
      order[j + 1] = x;
    }
    int ncs = 0;
    for (int t = 0; t < n_children; ++t) {
      int kind_t, sa, sb = 0;
      if (!single) {
        const int q = max(nB, 1);
        int ia = t / q, ib = t % q;
        sa = 0; sb = 0;
        for (int x = 0, c = 0; x < A; ++x)
          if (passA[x] && c++ == ia) { sa = x; break; }
        for (int x = 0, c = 0; x < A; ++x)
          if (passB[x] && c++ == ib) { sb = x; break; }
        kind_t = 1;
      } else if (t < nA) {
        sa = 0;
        for (int x = 0, c = 0; x < A; ++x)
          if (passA[x] && c++ == t) { sa = x; break; }
        kind_t = 0;
      } else {
        int pp = t - nA, r = 0;
        while (pp >= ncand - 1 - r) {
          pp -= ncand - 1 - r;
          ++r;
        }
        sa = order[r];
        sb = order[r + 1 + pp];
        kind_t = 1;
      }
      d[D_SPEC_KIND + t] = kind_t;
      d[D_SPEC_A + t] = sa;
      d[D_SPEC_B + t] = sb;
      const int c = pool_next + t;
      d[D_CS_DST + ncs] = 2 * c;
      d[D_CS_SRC + ncs] = 2 * win;
      d[D_CS_SYM + ncs] = sa;
      ++ncs;
      if (kind_t == 1) {
        d[D_CS_DST + ncs] = 2 * c + 1;
        d[D_CS_SRC + ncs] = single ? 2 * win : 2 * win + 1;
        d[D_CS_SYM + ncs] = sb;
        ++ncs;
      }
    }
    d[D_NCS] = ncs;
  }
  d[D_WIN] = win;
  d[D_CODE] = code;
  d[D_DISC] = discard_now;
  d[D_SPLIT] = want_split;
  d[D_NCH] = n_children;
  d[D_FIRST] = first;
  d[D_K] = k;
  d[D_THR] = thr;
  d[D_TOTQ] = trv[4 * k + 1];
  d[D_FAR] = trv[4 * k + 2];
  d[D_LCON] = trv[4 * k + 3];
  d[D_WLEN] = wlen;
  d[D_OVF] = 0;
  d[D_CSYM1] = s.sym1[win];
  d[D_CSYM2] = s.kind[win] == 1 ? s.sym2[win] : 0;
  d[D_NSIDES] = s.kind[win] == 1 ? 2 : 1;
  // a commit's fold round: the winner at its length after the step
  d[D_RNODE] = win;
  d[D_RKIND] = s.kind[win] == 1;
  d[D_RLEN] = wlen + 1;
  d[D_RIMB] = imb_next;
}

__device__ __forceinline__ void zero_stats(const Args& a, int oi) {
  a.out[a.o_act + oi] = 0;
  a.out[a.o_eds + oi] = 0;
  a.out[a.o_split + oi] = 0;
  a.out[a.o_reached + oi] = 0;
}

// One warp: the stats of side f at read r from its store row
// (`stats_core`) into row words w and histogram hist.
__device__ void stats_row(const Args& a, const Smem& s, int f, int r, int* w,
                          int* hist) {
  const int lane = threadIdx.x & 31;
  const shards::Cell c = store_row(a, s, f, r);
  const bool act = *c.act;
  for (int x = lane; x < a.A; x += 32) hist[x] = 0;
  __syncwarp();
  int split = 0;
  if (act) {
    split = band::tip_histogram_win(c.D, band::GlobalWindow{c.rd, a.L}, a.W,
                                    *c.rlen, s.clen[f] - *c.off - a.E, *c.e,
                                    hist);
  }
  if (lane == 0) {
    w[RW_E] = act ? *c.e : 0;
    w[RW_RMIN] = 0;
    w[RW_ER] = act ? *c.er : kInf;
    w[RW_SPLIT] = split;
    w[RW_ACT] = act;
  }
  __syncwarp();
}

// One warp: the source row (its words `c`, read r) into column 0 of a
// staging area (two [W] columns and a symbol ring) and the folds, offset,
// activity and read length beside it: the column copied asynchronously
// while the row's words load, then the read window from position i0 - 1
// into the ring (active rows).  Returns the activity.
__device__ __forceinline__ int stage_row(const Args& a, const Smem& s,
                                         const shards::Cell& c, int r,
                                         int fs, int32_t* stage,
                                         band::Folds3& f, int& off, int& rl,
                                         int& i0) {
  const int lane = threadIdx.x & 31;
  const int W = a.W;
  for (int t = lane; t < W; t += 32) cp_async4(stage + t, c.D + t);
  const int act = *c.act;
  f = band::Folds3{*c.e, *c.rmin, *c.er};
  off = *c.off;
  rl = *c.rlen;
  i0 = s.clen[fs] + 1 - off - a.E;
  if (act) {
    int16_t* ring = reinterpret_cast<int16_t*>(stage + 2 * W);
    const int mask = band::ring_len(W) - 1;
    for (int t = lane; t <= W; t += 32) {
      const int i = i0 - 1 + t;
      ring[i & mask] = (int16_t)read_sym(a, r, i);
    }
  }
  cp_async_wait();
  __syncwarp();
  return act;
}

// One warp: read r of side fs (active) pushed by `sym` into row `Dn` (a
// child's pool row); returns the new folds, `hist` the new column's tip
// histogram, *split its size.  With a staging area the row steps in
// shared memory and the new column is stored coalesced; without one the
// step runs on device memory.
__device__ band::Folds3 push_row(const Args& a, const Smem& s, int fs,
                                 int r, int sym, int32_t* Dn, int* hist,
                                 int* split, int32_t* stage) {
  const int lane = threadIdx.x & 31;
  const int W = a.W;
  const shards::Cell c = store_row(a, s, fs, r);
  const int wc = s.pin[P_WC], et = s.pin[P_ET];
  for (int x = lane; x < a.A; x += 32) hist[x] = 0;
  if (stage == nullptr) {
    const band::Folds3 f{*c.e, *c.rmin, *c.er};
    const int i0 = s.clen[fs] + 1 - *c.off - a.E;
    __syncwarp();
    return band::column_step_runs<band::GlobalWindow, true>(
        c.D, Dn, band::GlobalWindow{c.rd, a.L}, W, *c.rlen, i0, sym, wc, et,
        f, hist, split);
  }
  band::Folds3 f;
  int off, rl, i0;
  stage_row(a, s, c, r, fs, stage, f, off, rl, i0);
  const band::RingWindow win{reinterpret_cast<int16_t*>(stage + 2 * W),
                             band::ring_len(W) - 1};
  const band::Folds3 nf = band::column_step_runs<band::RingWindow, true>(
      stage, stage + W, win, W, rl, i0, sym, wc, et, f, hist, split);
  for (int t = lane; t < W; t += 32) Dn[t] = stage[W + t];
  __syncwarp();
  return nf;
}

__device__ __forceinline__ void put_row(int* w, const band::Folds3& nf,
                                        int split, int act) {
  w[RW_E] = nf.e;
  w[RW_RMIN] = nf.rmin;
  w[RW_ER] = nf.er;
  w[RW_SPLIT] = split;
  w[RW_ACT] = act;
}

// Row q of a round: node j, side sd, local read lr.
struct RowIdx {
  int j, sd, lr;
};
__device__ __forceinline__ RowIdx row_of(int q, int rpc) {
  const int js = q / rpc;
  return RowIdx{js >> 1, js & 1, q - js * rpc};
}

// A commit, step 1 (each warp its rows of the winner's sides): the rows
// pushed by the winner's nominated symbols, the folds, tip counts and
// histograms into the row words.  With the band staged the new column
// stays in the staging area until the write-back; a row whose staging
// area still holds its slot from the last commit (`keep`) steps on it
// with no load at all: its folds and activity are the row words', its
// window the ring fed with the symbol `pend` the write-back prefetched.
// In device memory the new columns go to the scratch rows.
__device__ __forceinline__ void step_commit(const Args& a, const Ctx& x,
                                            const Smem& s, int pend) {
  const int* d = s.dec;
  const int W = a.W, win = d[D_WIN], nsides = d[D_NSIDES];
  const int wc = s.pin[P_WC], et = s.pin[P_ET];
  for (int q = x.warp; q < 2 * a.rpc; q += x.nw) {
    const RowIdx ri = row_of(q, a.rpc);
    if (ri.sd >= nsides || ri.lr >= x.nloc) continue;
    const int r = x.r0 + ri.lr, fs = 2 * win + ri.sd;
    const int sym = d[D_CSYM1 + ri.sd];
    int* w = s.rw + q * RW_N;
    int* hist = s.rh + q * a.A;
    int split;
    band::Folds3 nf;
    if (!a.staged) {
      if (!*store_row(a, s, fs, r).act) {
        if (x.lane == 0) w[RW_ACT] = 0;
        continue;
      }
      nf = push_row(a, s, fs, r, sym,
                    a.scratch + ((size_t)ri.sd * a.R + r) * W, hist, &split,
                    nullptr);
    } else {
      int* c = s.cache + q * C_N;
      int32_t* stage = s.stage + q * stage_words(W);
      const int slot = s.pin[kParams + fs];
      const int mask = band::ring_len(W) - 1;
      band::Folds3 f;
      int act, rl, i0, cur;
      if (c[C_SLOT] == slot) {
        act = w[RW_ACTF];
        f = band::Folds3{w[RW_E], w[RW_RMIN], w[RW_ER]};
        rl = c[C_RLEN];
        i0 = s.clen[fs] + 1 - c[C_OFF] - a.E;
        cur = c[C_CUR];
        if (act && x.lane == 0) {
          reinterpret_cast<int16_t*>(stage + 2 * W)[(i0 - 1 + W) & mask] =
              (int16_t)pend;
        }
      } else {
        int off;
        act = stage_row(a, s, slot_cell(a, slot, r), r, fs, stage, f, off,
                        rl, i0);
        cur = 0;
        if (x.lane == 0) {
          c[C_SLOT] = a.keep ? slot : -1;
          c[C_CUR] = 0;
          c[C_OFF] = off;
          c[C_RLEN] = rl;
        }
      }
      if (!act) {
        if (x.lane == 0) w[RW_ACT] = 0;
        __syncwarp();
        continue;
      }
      for (int k = x.lane; k < a.A; k += 32) hist[k] = 0;
      if (x.lane == 0) c[C_I0] = i0;
      __syncwarp();
      const band::RingWindow rwin{reinterpret_cast<int16_t*>(stage + 2 * W),
                                  mask};
      nf = band::column_step_runs<band::RingWindow, true>(
          stage + cur * W, stage + (cur ^ 1) * W, rwin, W, rl, i0, sym, wc,
          et, f, hist, &split);
    }
    if (x.lane == 0) put_row(w, nf, split, 1);
    __syncwarp();
  }
}

// Children of a split, step 1, for children t0 .. t0 + nr - 1 (each warp
// rows of the round in turn): each child row is its source row pushed by
// the child's symbol, written straight into the child's pool slot
// (inactive reads copy the source).  The pool rows are scratch until the
// children are registered.
__device__ void step_children(const Args& a, const Ctx& x, const Smem& s,
                              int t0, int nr) {
  const int* d = s.dec;
  const int W = a.W;
  const int win = d[D_WIN], pool = d[D_POOL];
  const bool single = s.kind[win] == 0;
  int32_t* stage = a.staged ? s.stage + x.warp * stage_words(W) : nullptr;
  for (int q = x.warp; q < 2 * nr * a.rpc; q += x.nw) {
    const RowIdx ri = row_of(q, a.rpc);
    const int t = t0 + ri.j;
    if ((ri.sd == 1 && d[D_SPEC_KIND + t] != 1) || ri.lr >= x.nloc) continue;
    const int r = x.r0 + ri.lr;
    const int fs = ri.sd == 0 || single ? 2 * win : 2 * win + 1;
    const int fd = 2 * (pool + t) + ri.sd;
    const shards::Cell cs = store_row(a, s, fs, r);
    const shards::Cell cd = store_row(a, s, fd, r);
    int* w = s.rw + q * RW_N;
    if (*cs.act) {
      int split;
      const band::Folds3 nf = push_row(
          a, s, fs, r, d[(ri.sd ? D_SPEC_B : D_SPEC_A) + t], cd.D,
          s.rh + q * a.A, &split, stage);
      if (x.lane == 0) {
        *cd.e = nf.e;
        *cd.rmin = nf.rmin;
        *cd.er = nf.er;
        put_row(w, nf, split, 1);
      }
    } else {
      for (int i = x.lane; i < W; i += 32) cd.D[i] = cs.D[i];
      if (x.lane == 0) {
        *cd.e = *cs.e;
        *cd.rmin = *cs.rmin;
        *cd.er = *cs.er;
        w[RW_ACT] = 0;
      }
    }
    if (x.lane == 0) *cd.off = *cs.off;
    __syncwarp();
  }
}

// The initial records, step 1, for live nodes n0 .. n0 + nr - 1: each
// live side's stats from its store row.
__device__ void stats_nodes(const Args& a, const Ctx& x, const Smem& s,
                            int n0, int nr) {
  for (int q = x.warp; q < 2 * nr * a.rpc; q += x.nw) {
    const RowIdx ri = row_of(q, a.rpc);
    if ((ri.sd == 1 && s.dec[D_RKIND + ri.j] != 1) || ri.lr >= x.nloc)
      continue;
    stats_row(a, s, 2 * (n0 + ri.j) + ri.sd, x.r0 + ri.lr,
              s.rw + q * RW_N, s.rh + q * a.A);
  }
}

// One warp: read lr of node j of a round — divergence pruning of a dual
// node's pair first (`prune`), then the read's terms of the node's
// partial (`_node_eval`'s quantities): its cost term, largest active
// distance and flags into the side-0 row's words, each side's weighted
// vote terms (o / split * w in float32, 0 where the side does not vote)
// into `vt`; the band overflow flag from the stepped rows (`stepped`).
// Leaves each row's activity after pruning in RW_ACTF.
__device__ __forceinline__ void read_terms(const Args& a, const Ctx& x,
                                           const Smem& s, int j, int lr,
                                           bool prune, bool stepped) {
  const int lane = x.lane, A = a.A;
  const int* P = s.pin;
  const bool dual = s.dec[D_RKIND + j];
  const bool l2 = P[P_L2], use_w = P[P_WEIGHTED] && dual;
  const int q1 = 2 * j * a.rpc + lr, q2 = q1 + a.rpc;
  int* w1 = s.rw + q1 * RW_N;
  int* w2 = s.rw + q2 * RW_N;
  bool a1 = w1[RW_ACT];
  bool a2 = dual && w2[RW_ACT];
  const int e1 = a1 ? w1[RW_E] : 0, e2 = a2 ? w2[RW_E] : 0;
  unsigned fl = 0;
  if (stepped && ((a1 && e1 >= a.E) || (a2 && e2 >= a.E))) fl |= PF_OVF;
  if (prune && a1 && a2) {
    const int delta = P[P_DELTA];
    const bool p1 = e2 + delta < e1, p2 = e1 + delta < e2;
    a1 = !p1;
    a2 = !p2;
  }
  const bool r1 = a1 && w1[RW_ER] < kInf && e1 == w1[RW_ER];
  const bool r2 = a2 && w2[RW_ER] < kInf && e2 == w2[RW_ER];
  const int c1 = l2 ? (int)((unsigned)e1 * (unsigned)e1) : e1;
  const int c2 = l2 ? (int)((unsigned)e2 * (unsigned)e2) : e2;
  unsigned tot;
  if (dual) {
    const int best = min(a1 ? c1 : kBig, a2 ? c2 : kBig);
    tot = (a1 || a2) ? (unsigned)best : 0u;
  } else {
    tot = a1 ? (unsigned)c1 : 0u;
  }
  const bool rr = (a1 && r1) || (a2 && r2);
  if (!(rr || (!a1 && !a2))) fl |= PF_NOT_ALL_RR;
  if (rr) fl |= PF_ANY_RR;
  if (a1 && !r1) fl |= PF_NOT_ALL_F1;
  if (a1 && r1) fl |= PF_ANY_F1;
  if (a2 && !r2) fl |= PF_NOT_ALL_F2;
  if (a2 && r2) fl |= PF_ANY_F2;
  if (r1) fl |= PF_ANY_R1;
  const int sp1 = w1[RW_SPLIT], sp2 = dual ? w2[RW_SPLIT] : 0;
  if (a1 && sp1 > 0 && (sp1 & (sp1 - 1))) fl |= PF_NONDY1;
  if (a2 && sp2 > 0 && (sp2 & (sp2 - 1))) fl |= PF_NONDY2;
  // weighted dual votes split a read by the other side's relative
  // distance, else 1 on an active read
  float wt1 = 1.f, wt2 = 1.f;
  if (use_w && a1 && a2) {
    const float c1f = fmaxf((float)e1, 0.5f), c2f = fmaxf((float)e2, 0.5f);
    wt1 = __fdiv_rn(c2f, __fadd_rn(c1f, c2f));
    wt2 = __fdiv_rn(c1f, __fadd_rn(c1f, c2f));
  }
  __syncwarp();
  if (lane == 0) {
    w1[RW_ACTF] = a1;
    if (dual) w2[RW_ACTF] = a2;
    w1[RW_HTOT] = (int)tot;
    w1[RW_HMX] = max(a1 ? e1 : 0, a2 ? e2 : 0);
    w1[RW_HFL] = (int)fl;
  }
  for (int i = lane; i < (dual ? 2 : 1) * A; i += 32) {
    const int sd = i / A, k = i - sd * A;
    const int q = sd ? q2 : q1, sp = sd ? sp2 : sp1;
    const int o = s.rh[q * A + k];
    float t = 0.f;
    if ((sd ? a2 : a1) && sp > 0 && o > 0)
      t = __fmul_rn(__fdiv_rn((float)o, (float)sp), sd ? wt2 : wt1);
    s.vt[q * A + k] = t;
  }
}

// One warp: node j of a round, its CTA partial from its reads' terms in
// read order (votes summed in float32), with the record's imbalance
// floor (loaded here unless the decision already did).
__device__ __forceinline__ void node_partial(const Args& a, const Ctx& x,
                                             const Smem& s, int j,
                                             bool imb_known) {
  const int lane = x.lane, A = a.A, rpc = a.rpc;
  const bool dual = s.dec[D_RKIND + j];
  // the record's imbalance floor, loaded while the partial is folded
  const int imb_v =
      lane == 0 && !imb_known
          ? a.in[a.i_imb + min(max(s.dec[D_RLEN + j], 0), a.IMBN - 1)]
          : 0;
  int* part = s.part + j * Part::words(A);
  const int* w1b = s.rw + (2 * j) * rpc * RW_N;
  const int* w2b = s.rw + (2 * j + 1) * rpc * RW_N;
  unsigned tot = 0, fl = 0;
  int mx = 0, n1 = 0, n2 = 0;
  for (int lr = lane; lr < x.nloc; lr += 32) {
    const int* w1 = w1b + lr * RW_N;
    tot += (unsigned)w1[RW_HTOT];
    mx = max(mx, w1[RW_HMX]);
    fl |= (unsigned)w1[RW_HFL];
    n1 += w1[RW_ACTF];
    n2 += dual && w2b[lr * RW_N + RW_ACTF];
  }
  tot = __reduce_add_sync(kFull, tot);
  mx = __reduce_max_sync(kFull, mx);
  n1 = __reduce_add_sync(kFull, n1);
  n2 = __reduce_add_sync(kFull, n2);
  fl = __reduce_or_sync(kFull, fl);
  if (lane < Part::kHead) {
    const int hv[5] = {(int)tot, n1, n2, mx, (int)fl};
    part[lane] = lane <= kPF ? hv[lane] : 0;
  }
  // votes: a lane per (side, symbol), the CTA's reads in order
  for (int i = lane; i < 2 * A; i += 32) {
    const int sd = i / A, k = i - sd * A;
    float c = 0.f;
    int h = 0;
    if (sd == 0 || dual) {
      const float* t = s.vt + (size_t)(2 * j + sd) * rpc * A + k;
      for (int lr = 0; lr < x.nloc; ++lr) {
        c = __fadd_rn(c, t[lr * A]);
        h |= t[lr * A] > 0.f;
      }
    }
    part[Part::has_at(A, sd) + k] = h;
    part[Part::counts_at(A, sd) + k] = __float_as_int(c);
  }
  if (lane == 0 && !imb_known) s.dec[D_RIMB + j] = imb_v;
  __syncwarp();
}

// One warp: node j of a round, the cluster's partials folded in rank
// order into the node's record (`_node_eval` of the plain twin).
__device__ __forceinline__ void record_fold(const Args& a, const Ctx& x,
                                            const Smem& s, int p, int j) {
  const int lane = x.lane, A = a.A;
  const int* P = s.pin;
  const int Pw = Part::words(A);
  int* d = s.dec;
  const int n = d[D_RNODE + j];
  const bool dual = d[D_RKIND + j];
  const bool l2 = P[P_L2], weighted = P[P_WEIGHTED], et = P[P_ET];
  float* rec_cnt = s.rcnt + n * 2 * A;
  int* rec_hv = s.rhv + n * 2 * A;
  unsigned head[Part::kFlags + 1];
  clu::fold<Part>(s.gath + (size_t)((p * a.gn + j) * a.csize) * Pw, a.csize,
                  Pw, A, head, [&](int v, int k, int hv, float c) {
                    rec_cnt[v * A + k] = c;
                    rec_hv[v * A + k] = hv;
                  });
  __syncwarp();
  // the nomination of side `lane` (lanes 0 and 1 side by side), then
  // lane 0 the record
  if (lane >= 2) return;
  const unsigned fl = head[kPF];
  const bool fin1 = et ? !(fl & PF_NOT_ALL_F1) : (fl & PF_ANY_F1);
  const bool fin2 = et ? !(fl & PF_NOT_ALL_F2) : (fl & PF_ANY_F2);
  const bool reach = dual ? (et ? !(fl & PF_NOT_ALL_RR) : (fl & PF_ANY_RR))
                          : (et ? !(fl & PF_NOT_ALL_F1) : (fl & PF_ANY_R1));
  const bool covf = l2 && (int)head[kMx] > 2048;
  const int side = lane;
  int sym = 0, mc = 0;
  bool exact = false, near = false, sdirty = false;
  if (side == 0 || dual) {
    float* cnt = rec_cnt + side * A;
    int* hv = rec_hv + side * A;
    const bool nondy = fl & (side ? PF_NONDY2 : PF_NONDY1);
    const int wc = P[P_WC];
    int nc = 0;
    for (int k = 0; k < A; ++k) nc += hv[k];
    if (wc >= 0 && wc < A && nc > 1) {
      hv[wc] = 0;
      cnt[wc] = 0.f;
    }
    nc = 0;
    float nvf = 0.f;
    for (int k = 0; k < A; ++k) {
      nc += hv[k];
      nvf = __fadd_rn(nvf, cnt[k]);
    }
    const float nvr = rintf(nvf);
    const bool int_ok = fabsf(nvf - nvr) < kEps;
    const bool tab_bad = P[P_MCDYN] && !int_ok;
    exact = !nondy && !weighted && !tab_bad;
    const int mi = min(max((int)nvr, 0), a.MCN - 1);
    mc = mi < kMcCache ? s.mcc[mi] : a.in[a.i_mc + mi];
    const float mcf = (float)mc;
    float maxc = -1.f;
    for (int k = 0; k < A; ++k)
      if (hv[k]) maxc = fmaxf(maxc, cnt[k]);
    const float thr = fminf(mcf, maxc);
    int npass = 0;
    float best = -3.f;
    near = fabsf(maxc - mcf) < kEps;
    for (int k = 0; k < A; ++k) {
      const bool ps = hv[k] && cnt[k] >= thr;
      npass += ps;
      near |= hv[k] && fabsf(cnt[k] - thr) < kEps;
      const float v = ps ? cnt[k] : -1.f;
      if (v > best) {
        best = v;
        sym = k;
      }
    }
    sdirty = (!exact && near) || npass != 1 || nc == 0 || tab_bad;
  }
  constexpr unsigned kTwo = 0x3u;
  const int sym2 = __shfl_sync(kTwo, sym, 1);
  const int mc2 = __shfl_sync(kTwo, mc, 1);
  const int side2 = __shfl_sync(kTwo, (int)exact | (int)near << 1 |
                                          (int)sdirty << 2, 1);
  if (lane != 0) return;
  if (fl & PF_OVF) atomicOr(&d[D_OVF], 1);
  const bool ex2 = dual && (side2 & 1), nt2 = dual && (side2 & 2);
  const bool dirty = covf || sdirty ||
                     (dual && ((side2 & 4) || fin1 || fin2));
  const int flags = (reach ? F_REACH : 0) | (fin1 ? F_FIN1 : 0) |
                    (fin2 ? F_FIN2 : 0) | (covf ? F_COVF : 0) |
                    (exact ? F_EX1 : 0) | (near ? F_NT1 : 0) |
                    (ex2 ? F_EX2 : 0) | (nt2 ? F_NT2 : 0);
  const int syms[2] = {sym, dual ? sym2 : 0};
  const int mcs[2] = {mc, dual ? mc2 : 0};
  const int imb_v = d[D_RIMB + j];
  const int n1 = (int)head[kN1], n2 = (int)head[kN2];
  const bool imb = dual && (n1 < imb_v || n2 < imb_v);
  s.total[n] = (int)head[kTot];
  s.flags[n] = flags | (dirty ? F_DIRTY : 0) | (imb ? F_IMB : 0);
  s.sym1[n] = syms[0];
  s.sym2[n] = syms[1];
  s.mc1[n] = mcs[0];
  s.mc2[n] = mcs[1];
}

// A fold round of nr nodes (every thread of every CTA): each read's terms
// (a warp a read), each node's CTA partial, pushed into every CTA's
// gather rows of parity p, the one cluster barrier, then each node's
// record folded in rank order.
// Returns whether a stepped row overflowed the band, to every warp from
// the gathered flags (the warp folding node j also sets D_OVF); the
// records are complete at the next block barrier.
__device__ __forceinline__ bool fold_round(const Args& a, const Ctx& x,
                                           const Smem& s,
                                           cg::cluster_group& cl, int p,
                                           int nr, bool prune, bool stepped,
                                           bool imb_known = false) {
  const int Pw = Part::words(a.A);
  for (int i = x.warp; i < nr * x.nloc; i += x.nw)
    read_terms(a, x, s, i / x.nloc, i % x.nloc, prune, stepped);
  __syncthreads();
  for (int j = x.warp; j < nr; j += x.nw) {
    node_partial(a, x, s, j, imb_known);
    clu::push(cl, s.part + j * Pw, Pw,
              s.gath + (size_t)((p * a.gn + j) * a.csize + x.rank) * Pw,
              a.csize);
  }
  cl.sync();
  bool ovf = false;
  for (int i = x.lane; i < nr * a.csize; i += 32)
    ovf |= s.gath[(size_t)(p * a.gn * a.csize + i) * Pw + kPF] & PF_OVF;
  ovf = __any_sync(kFull, ovf);
  for (int j = x.warp; j < nr; j += x.nw) record_fold(a, x, s, p, j);
  return ovf;
}

// One warp: a round row's stats into the packed output (its activity
// after pruning), and for a child row its activity into the store.
__device__ __forceinline__ void emit_row(const Args& a, const Smem& s, int f,
                                         int r, int q, bool child) {
  const int lane = threadIdx.x & 31;
  const int* w = s.rw + q * RW_N;
  const bool keep = w[RW_ACTF];
  const int oi = f * a.R + r;
  int* occ = a.out + a.o_occ + (size_t)oi * a.A;
  for (int k = lane; k < a.A; k += 32) occ[k] = keep ? s.rh[q * a.A + k] : 0;
  if (lane == 0) {
    const int e = w[RW_E], er = w[RW_ER];
    a.out[a.o_act + oi] = keep;
    a.out[a.o_eds + oi] = keep ? e : 0;
    a.out[a.o_split + oi] = keep ? w[RW_SPLIT] : 0;
    a.out[a.o_reached + oi] = keep && er < kInf && e == er;
    if (child) *store_row(a, s, f, r).act = keep;
  }
}

// The rows of a fold round of nodes n0 .. n0 + nr - 1 (live nodes, or
// children) into the packed output.
__device__ void emit_round(const Args& a, const Ctx& x, const Smem& s,
                           int n0, int nr, bool child) {
  for (int q = x.warp; q < 2 * nr * a.rpc; q += x.nw) {
    const RowIdx ri = row_of(q, a.rpc);
    if ((ri.sd == 1 && s.dec[D_RKIND + ri.j] != 1) || ri.lr >= x.nloc)
      continue;
    emit_row(a, s, 2 * (n0 + ri.j) + ri.sd, x.r0 + ri.lr, q, child);
  }
}

// A commit, step 3 (each warp its rows; the band did not overflow): the
// new columns into the store, with the folds, activity after pruning and
// stats of each stepped row.  A kept staging area makes its new column
// current, and lane 0 prefetches into `pend` the symbol the row's next
// step adds to its ring.
__device__ __forceinline__ void write_commit(const Args& a, const Ctx& x,
                                             const Smem& s, int& pend) {
  const int* d = s.dec;
  const int W = a.W, win = d[D_WIN], nsides = d[D_NSIDES];
  for (int q = x.warp; q < 2 * a.rpc; q += x.nw) {
    const RowIdx ri = row_of(q, a.rpc);
    if (ri.sd >= nsides || ri.lr >= x.nloc) continue;
    const int* w = s.rw + q * RW_N;
    if (!w[RW_ACT]) continue;
    const int r = x.r0 + ri.lr, f = 2 * win + ri.sd;
    const shards::Cell cr = store_row(a, s, f, r);
    int* c = s.cache + q * C_N;
    const int32_t* src =
        a.staged ? s.stage + q * stage_words(W) + (c[C_CUR] ^ 1) * W
                 : a.scratch + ((size_t)ri.sd * a.R + r) * W;
    for (int t = x.lane; t < W; t += 32) cr.D[t] = src[t];
    if (x.lane == 0) {
      *cr.e = w[RW_E];
      *cr.rmin = w[RW_RMIN];
      *cr.er = w[RW_ER];
      *cr.act = w[RW_ACTF];
      if (a.keep) {
        c[C_CUR] ^= 1;
        pend = read_sym(a, r, c[C_I0] + W);
      }
    }
    emit_row(a, s, f, r, q, false);
  }
}

// Thread 0 of every CTA: a committed winner's sides grow by their
// symbols; rank 0 appends them to the store.
__device__ __forceinline__ void append_symbols(const Args& a, const Smem& s,
                                               bool lead) {
  const int* d = s.dec;
  for (int sd = 0; sd < d[D_NSIDES]; ++sd) {
    const int f = 2 * d[D_WIN] + sd;
    const int slot = s.pin[kParams + f];
    const int at = min(max(s.clen[f], 0), a.C - 1);
    s.clen[f] += 1;
    for (int k = 0; lead && k < copies(a); ++k) {
      cons_of(a, k)[(size_t)slot * a.C + at] = d[D_CSYM1 + sd];
      clen_of(a, k)[slot] = s.clen[f];
    }
  }
}

// Every thread of rank 0: each new child side's consensus row (the
// source's, with the pushed symbol at its length).
__device__ void child_cons(const Args& a, const Smem& s) {
  const int* d = s.dec;
  const int C = a.C;
  for (long long i = threadIdx.x; i < (long long)d[D_NCS] * C;
       i += blockDim.x) {
    const int ci = (int)(i / C), k = (int)(i % C);
    const int fs = d[D_CS_SRC + ci];
    const size_t ss = (size_t)s.pin[kParams + fs] * C;
    const size_t sd = (size_t)s.pin[kParams + d[D_CS_DST + ci]] * C;
    const int at = min(max(s.clen[fs], 0), C - 1);
    for (int m = 0; m < copies(a); ++m) {
      int32_t* cons = cons_of(a, m);
      cons[sd + k] = k == at ? d[D_CS_SYM + ci] : cons[ss + k];
    }
  }
}

// Thread 0 of every CTA: a split event's creation bookkeeping
// (`_j_arena`'s `write_body`): the children join the table, each one's
// tracker insert; rank 0 writes their lengths, history entries and
// creation records.
__device__ void register_children(const Args& a, const Smem& s, bool lead) {
  int* d = s.dec;
  const int K = a.K, Lw = a.Lw;
  const int win = d[D_WIN], pool = d[D_POOL], cre = d[D_CRE];
  const int nl = d[D_WLEN] + 1;
  const bool single = s.kind[win] == 0;
  int* lc = s.lc;
  int* tr = d + D_TR;
  int* cr = a.out + a.o_cre;
  for (int t = 0; t < d[D_NCH]; ++t) {
    const int c = pool + t, kt = d[D_SPEC_KIND + t];
    s.kind[c] = kt;
    s.alive[c] = 1;
    s.seqv[c] = d[D_SEQCTR] + t;
    s.fresh[c] = 0;
    s.clen[2 * c] = s.clen[2 * win] + 1;
    if (kt == 1) s.clen[2 * c + 1] = s.clen[single ? 2 * win : 2 * win + 1] + 1;
    lc[kt * Lw + min(max(nl, 0), Lw - 1)] += 1;
    tr[4 * kt + 1] += nl >= tr[4 * kt];
    if (!lead) continue;
    for (int m = 0; m < copies(a); ++m) {
      clen_of(a, m)[s.pin[kParams + 2 * c]] = s.clen[2 * c];
      if (kt == 1)
        clen_of(a, m)[s.pin[kParams + 2 * c + 1]] = s.clen[2 * c + 1];
    }
    a.out[a.o_hist + min(max(d[D_NSTEPS] + 1 + t, 0), a.max_steps - 1)] =
        3 * K + cre + t;
    const int j = min(cre + t, kCreCap - 1);
    cr[j] = win;
    cr[kCreCap + j] = kt;
    cr[2 * kCreCap + j] = d[D_SPEC_A + t];
    cr[3 * kCreCap + j] = d[D_SPEC_B + t];
    cr[4 * kCreCap + j] = nl;
  }
}

// Thread 0 of every CTA: the event's tracker arithmetic and table updates
// (`_j_arena` :2468-2520) and its final stop code; rank 0 writes the
// history entry.
__device__ __forceinline__ void finish_event(const Args& a, const Smem& s,
                                             bool lead) {
  int* d = s.dec;
  const int K = a.K, Lw = a.Lw;
  int* lc = s.lc;
  int* pc = s.pc;
  int* tr = d + D_TR;
  const int win = d[D_WIN], k = d[D_K], thr = d[D_THR], wlen = d[D_WLEN];
  const int far = d[D_FAR], lcon = d[D_LCON];
  const bool first = d[D_FIRST], disc = d[D_DISC], ovf = d[D_OVF];
  int code = d[D_CODE];
  const bool split_commit = d[D_SPLIT] && !ovf;
  bool commit = false;
  if (d[D_SPLIT] && ovf) code = 5;
  if (code == 0 && !disc && !split_commit) {
    if (ovf) code = 5;
    else commit = true;
  }
  const int li = min(max(wlen, 0), Lw - 1);
  const int nsteps = d[D_NSTEPS];
  const int hp = min(max(nsteps, 0), a.max_steps - 1);
  int* hist = a.out + a.o_hist;
  if (commit) {
    int totq = d[D_TOTQ];
    if (!first) {
      lc[k * Lw + li] -= 1;
      totq -= wlen >= thr;
    }
    pc[k * Lw + li] += 1;
    lc[k * Lw + min(max(wlen + 1, 0), Lw - 1)] += 1;
    totq += wlen + 1 >= thr;
    tr[4 * k] = thr;
    tr[4 * k + 1] = totq;
    tr[4 * k + 2] = max(far, wlen);
    tr[4 * k + 3] = lcon + 1;
    if (lead) {
      hist[hp] = win;
      a.out[a.o_evsym + 2 * hp] = d[D_CSYM1];
      a.out[a.o_evsym + 2 * hp + 1] = d[D_CSYM2];
    }
    s.steps[win] += 1;
    s.seqv[win] = d[D_SEQCTR];
    s.fresh[win] = 0;
    d[D_SEQCTR] += 1;
    d[D_NSTEPS] = nsteps + 1;
  } else if (disc) {
    lc[k * Lw + li] -= 1;
    tr[4 * k + 1] = d[D_TOTQ] - (wlen >= thr);
    if (lead) hist[hp] = K + win;
    s.alive[win] = 0;
    d[D_NSTEPS] = nsteps + 1;
  } else if (split_commit) {
    if (!first) {
      lc[k * Lw + li] -= 1;
      tr[4 * k + 1] -= wlen >= thr;
    }
    tr[4 * k + 2] = max(far, wlen);
    tr[4 * k + 3] = lcon + 1;
    pc[k * Lw + li] += 1;
    if (lead) hist[hp] = 2 * K + win;
    s.alive[win] = 0;
    const int nch = d[D_NCH];
    d[D_NSTEPS] = nsteps + 1 + nch;
    d[D_SEQCTR] += nch;
    d[D_POOL] += nch;
    d[D_CRE] += nch;
  }
  d[D_STOP] = win;
  d[D_CODE] = code;
}

// Parts of an event timed by the profiled variant (rank 0's thread 0:
// its clock64 at the barriers between them).
enum ProfPart { PP_DECIDE = 0, PP_STEP, PP_WRITE, PP_FOLD, PP_FINISH, PP_N };

template <bool kProf>
__global__ void __launch_bounds__(kMaxThreads, 1) arena_kernel(Args a) {
  extern __shared__ __align__(16) int smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  Ctx x;
  x.rank = (int)cl.block_rank();
  x.warp = threadIdx.x >> 5;
  x.lane = threadIdx.x & 31;
  x.nw = a.nw;
  x.r0 = x.rank * a.rpc;
  x.nloc = max(0, min(a.rpc, a.R - x.r0));
  const Smem s = carve(smem_raw, a, x.rank);
  const int K = a.K, A = a.A;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const bool lead = x.rank == 0 && tid == 0;
  const int* P = a.in;
  int* d = s.dec;
  const int n_live = P[P_NLIVE];

  long long pt[PP_N] = {0, 0, 0, 0, 0};
  long long t_begin = 0, tk = 0, iters = 0;
  if (kProf) t_begin = clock64();
  // the part just ended: its clocks since the last tick
  auto tick = [&](int part) {
    if (kProf && lead) {
      const long long t = clock64();
      pt[part] += t - tk;
      tk = t;
    }
  };

  // ---- every CTA: its copy of the node table, records and trackers;
  // rank 0 clears the output fields it alone writes
  if (x.rank == 0) {
    for (int i = tid; i < a.o_act; i += nthreads) a.out[i] = 0;
    for (int i = a.o_cre + tid; i < a.o_end; i += nthreads) a.out[i] = 0;
  }
  for (int i = tid; i < 2 * K * A; i += nthreads) {
    s.rcnt[i] = 0.f;
    s.rhv[i] = 0;
  }
  for (int i = tid; i < 2 * a.Lw; i += nthreads) {
    s.lc[i] = P[a.i_lc + i];
    s.pc[i] = P[a.i_pc + i];
  }
  for (int n = tid; n < K; n += nthreads) {
    s.total[n] = s.flags[n] = s.sym1[n] = s.sym2[n] = 0;
    s.mc1[n] = s.mc2[n] = s.steps[n] = 0;
    s.kind[n] = P[a.i_kinds + n];
    s.alive[n] = n < n_live;
    s.seqv[n] = n;
    s.fresh[n] = n != 0;
  }
  for (int f = tid; f < 2 * K; f += nthreads)
    s.clen[f] = clen_of(a, 0)[P[a.i_slots + f]];
  for (int i = tid; i < kParams + 2 * K; i += nthreads) s.pin[i] = P[i];
  for (int i = tid; i < kMcCache; i += nthreads)
    s.mcc[i] = P[a.i_mc + min(i, a.MCN - 1)];
  for (int i = tid; i < 2 * a.rpc; i += nthreads) s.cache[i * C_N] = -1;
  // lane 0 of a warp that keeps its row staged: the symbol its next step
  // adds to the ring
  int pend = -1;
  if (tid == 0) {
    for (int i = 0; i < 8; ++i) d[D_TR + i] = P[a.i_tr + i];
    d[D_NSTEPS] = 0;
    d[D_SEQCTR] = K + 1;
    d[D_POOL] = n_live;
    d[D_CRE] = 0;
    d[D_CODE] = 0;
    d[D_DIAG] = 0;
  }
  // every CTA is running (and set up) before any partial is pushed
  cl.sync();

  // ---- the live nodes' records, gn at a time
  int p = 0;
  for (int n0 = 0; n0 < n_live; n0 += a.gn) {
    const int nr = min(a.gn, n_live - n0);
    if (tid < nr) {
      d[D_RNODE + tid] = n0 + tid;
      d[D_RKIND + tid] = s.kind[n0 + tid] == 1;
      d[D_RLEN + tid] = node_len(s, n0 + tid);
    }
    __syncthreads();
    stats_nodes(a, x, s, n0, nr);
    __syncthreads();
    fold_round(a, x, s, cl, p, nr, false, false);
    emit_round(a, x, s, n0, nr, false);
    p ^= 1;
    __syncthreads();
  }

  if (kProf) tk = clock64();
  for (;;) {
    if (x.warp == 0) decide(a, s, tournament(s, K));
    __syncthreads();
    tick(PP_DECIDE);
    if (d[D_SPLIT]) {
      const int win = d[D_WIN], nch = d[D_NCH];
      const bool single = s.kind[win] == 0;
      const int len1 = s.clen[2 * win] + 1;
      const int len2 = s.clen[single ? 2 * win : 2 * win + 1] + 1;
      // the children's steps reuse the staging areas
      for (int i = tid; i < 2 * a.rpc; i += nthreads) s.cache[i * C_N] = -1;
      for (int t0 = 0; t0 < nch; t0 += a.gn) {
        const int nr = min(a.gn, nch - t0);
        if (tid < nr) {
          const int kt = d[D_SPEC_KIND + t0 + tid];
          d[D_RNODE + tid] = d[D_POOL] + t0 + tid;
          d[D_RKIND + tid] = kt;
          d[D_RLEN + tid] = kt == 1 ? max(len1, len2) : len1;
        }
        __syncthreads();
        step_children(a, x, s, t0, nr);
        __syncthreads();
        tick(PP_STEP);
        fold_round(a, x, s, cl, p, nr, true, true);
        tick(PP_FOLD);
        emit_round(a, x, s, d[D_POOL] + t0, nr, true);
        p ^= 1;
        __syncthreads();
      }
      if (!d[D_OVF]) {
        if (x.rank == 0) child_cons(a, s);
        if (tid == 0) register_children(a, s, lead);
      }
      tick(PP_WRITE);
    } else if (d[D_CODE] == 0 && !d[D_DISC]) {
      step_commit(a, x, s, pend);
      __syncthreads();
      tick(PP_STEP);
      const bool ovf = fold_round(a, x, s, cl, p, 1, d[D_NSIDES] == 2,
                                  true, true);
      tick(PP_FOLD);
      if (!ovf) {
        write_commit(a, x, s, pend);
        if (tid == 0) append_symbols(a, s, lead);
      }
      p ^= 1;
      tick(PP_WRITE);
    }
    if (tid == 0) finish_event(a, s, lead);
    __syncthreads();
    tick(PP_FINISH);
    ++iters;
    if (d[D_CODE] != 0) break;
  }

  // ---- results: rank 0 the scalars and per-node fields; each CTA zeroes
  // its reads' stats of the sides no node owns (creation pool sides never
  // created, side 2 of single nodes)
  const int n_nodes = n_live + d[D_CRE];
  if (lead) {
    a.out[0] = d[D_NSTEPS];
    a.out[1] = d[D_CODE];
    a.out[2] = d[D_STOP];
    a.out[3] = d[D_CRE];
    a.out[4] = d[D_DIAG];
  }
  if (x.rank == 0) {
    for (int n = tid; n < K; n += nthreads) {
      a.out[a.o_steps + n] = s.steps[n];
      a.out[a.o_alive + n] = s.alive[n];
      a.out[a.o_kinds + n] = s.kind[n];
    }
    for (int f = tid; f < 2 * K; f += nthreads)
      a.out[a.o_clen + f] = s.clen[f];
  }
  for (int i = tid; i < 2 * K * x.nloc; i += nthreads) {
    const int f = i / x.nloc, n = f >> 1;
    if (n < n_nodes && (!(f & 1) || s.kind[n] == 1)) continue;
    const int oi = f * a.R + x.r0 + i % x.nloc;
    zero_stats(a, oi);
    for (int k = 0; k < A; ++k) a.out[a.o_occ + (size_t)oi * A + k] = 0;
  }
  if (kProf && lead) {
    for (int i = 0; i < PP_N; ++i) a.prof[i] = pt[i];
    a.prof[PP_N] = clock64() - t_begin;
    a.prof[PP_N + 1] = iters;
  }
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

template <bool kProf>
int launch(const Args& a, int threads, size_t smem, cudaStream_t stream) {
  auto* fn = arena_kernel<kProf>;
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

// The plan, shape and layouts into `a` (its store set by the caller),
// then the launch.
int launch_arena(Args& a, void* in, void* out, void* scratch, int B, int R,
                 int W, int C, int L, int A, int K, int Lw, int MCN,
                 int IMBN, int max_steps, int csize, int threads, int rpc,
                 int gn, int staged, int rec_smem, int trk_smem,
                 long long smem, void* prof, void* stream) {
  const int nw = threads / 32;
  const bool plan_ok =
      csize >= 1 && csize <= kMaxCluster && threads % 32 == 0 &&
      nw == min(16, 2 * rpc) && rpc >= 1 && (long long)csize * rpc >= R &&
      gn >= 1 && gn <= kMaxFold &&
      smem == 4 * smem_words(K, A, rpc, csize, gn, W, Lw, staged != 0,
                             rec_smem != 0, trk_smem != 0);
  if (!plan_ok || K < 1 || K > kMaxK || A < 1 || A > kMaxA || R < 1 ||
      W < 4 || W % 2 || Lw < 1 || C < 2 || MCN < 1 || IMBN < 1 ||
      max_steps < 1 || B < 2 * K || !shards::cover(a.sh, a.nsh, a.Rs, R))
    return -1;
  a.in = static_cast<const int32_t*>(in);
  a.out = static_cast<int32_t*>(out);
  a.scratch = static_cast<int32_t*>(scratch);
  a.prof = static_cast<long long*>(prof);
  a.B = B; a.R = R; a.W = W; a.C = C; a.L = L; a.A = A; a.K = K;
  a.Lw = Lw; a.MCN = MCN; a.IMBN = IMBN; a.max_steps = max_steps;
  a.E = (W - 2) / 2;
  a.csize = csize; a.nw = nw; a.rpc = rpc; a.gn = gn;
  a.staged = staged != 0;
  a.rec_smem = rec_smem != 0;
  a.trk_smem = trk_smem != 0;
  a.keep = a.staged && nw == 2 * rpc;
  const int S = 2 * K;
  int at = 8;
  a.o_hist = at; at += max_steps;
  a.o_evsym = at; at += 2 * max_steps;
  a.o_steps = at; at += K;
  a.o_alive = at; at += K;
  a.o_kinds = at; at += K;
  a.o_clen = at; at += S;
  a.o_act = at; at += S * R;
  a.o_eds = at; at += S * R;
  a.o_split = at; at += S * R;
  a.o_reached = at; at += S * R;
  a.o_occ = at; at += S * R * A;
  a.o_cre = at; at += 5 * kCreCap;
  a.o_end = at;
  at = kParams;
  a.i_slots = at; at += S;
  a.i_kinds = at; at += K;
  a.i_tr = at; at += 8;
  a.i_lc = at; at += 2 * Lw;
  a.i_pc = at; at += 2 * Lw;
  a.i_mc = at; at += MCN;
  a.i_imb = at;
  // scratch (ops/arena_kernel.py `scratch_words`)
  long long sat = a.staged ? 0 : 2LL * R * W;
  a.s_rec = sat;
  if (!a.rec_smem) sat += 4LL * csize * K * A;
  a.s_trk = sat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return prof ? launch<true>(a, threads, (size_t)smem, st)
              : launch<false>(a, threads, (size_t)smem, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  The store (D, e, rmin, er,
// off, act, cons, clen) is stepped in place at the slots of the packed
// input `in` (ops/arena_kernel.py `arena_in_layout`; not modified), the
// results go to the packed `out` (`arena_out_layout`).  One cluster of
// `csize` CTAs of `threads` threads with the plan's geometry
// (`plan_arena`): `rpc` reads per CTA, `gn` node records folded per
// cluster barrier, the band staged in shared memory (`staged`) or stepped
// through `scratch`, the records' vote rows (`rec_smem`) and the trackers
// (`trk_smem`) in shared memory or in per-CTA copies in `scratch`, `smem`
// bytes of dynamic shared memory.  `prof` non-null launches the profiled
// variant, which fills it.  Returns 0 on success, -1 when the plan does
// not match the kernel, -2 when no cluster of that shape fits on the
// device, else the CUDA error; the launch does not synchronise.
extern "C" int arena_launch(void* D, void* e, void* rmin, void* er,
                            void* off, void* act, void* cons, void* clen,
                            void* reads, void* rlen, void* in, void* out,
                            void* scratch, int B, int R, int W, int C, int L,
                            int A, int K, int Lw, int MCN, int IMBN,
                            int max_steps, int csize, int threads, int rpc,
                            int gn, int staged, int rec_smem, int trk_smem,
                            long long smem, void* prof, void* stream) {
  Args a;
  a.D = static_cast<int32_t*>(D);
  a.e = static_cast<int32_t*>(e);
  a.rmin = static_cast<int32_t*>(rmin);
  a.er = static_cast<int32_t*>(er);
  a.off = static_cast<int32_t*>(off);
  a.act = static_cast<uint8_t*>(act);
  a.cons = static_cast<int32_t*>(cons);
  a.clen = static_cast<int32_t*>(clen);
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.sh = nullptr;
  a.nsh = 1; a.Rs = R;
  return launch_arena(a, in, out, scratch, B, R, W, C, L, A, K, Lw, MCN,
                      IMBN, max_steps, csize, threads, rpc, gn, staged,
                      rec_smem, trk_smem, smem, prof, stream);
}

// The shard instance: the same call on a read-sharded store whose `nsh`
// shards (`Rs` reads each, R = nsh Rs; B slots each, allocated in
// lockstep) share this card, one launch for all of them.  `shards` is the
// device copy of the shards' records (csrc/store_shards.cuh
// `StoreShard`); every row is stepped in place in its own shard, every
// consensus row and length written to every shard.  Inputs, outputs,
// scratch and plan are the one-store call's at the store's R.  Returns as
// `arena_launch`, and -1 too when the shards do not cover R.
extern "C" int arena_shards_launch(const void* shards, int nsh, int Rs,
                                   void* in, void* out, void* scratch, int B,
                                   int R, int W, int C, int L, int A, int K,
                                   int Lw, int MCN, int IMBN, int max_steps,
                                   int csize, int threads, int rpc, int gn,
                                   int staged, int rec_smem, int trk_smem,
                                   long long smem, void* prof,
                                   void* stream) {
  if (shards == nullptr) return -1;
  Args a;
  a.D = a.e = a.rmin = a.er = a.off = nullptr;
  a.act = nullptr;
  a.cons = a.clen = nullptr;
  a.reads = nullptr;
  a.rlen = nullptr;
  a.sh = static_cast<const StoreShard*>(shards);
  a.nsh = nsh; a.Rs = Rs;
  return launch_arena(a, in, out, scratch, B, R, W, C, L, A, K, Lw, MCN,
                      IMBN, max_steps, csize, threads, rpc, gn, staged,
                      rec_smem, trk_smem, smem, prof, stream);
}
