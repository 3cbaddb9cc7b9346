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
// per event, so an event is latency-bound: synchronisations of the CTA
// and dependent device-memory accesses set its time, not bandwidth.
//
// Design.  One CTA of min(32, 2R) warps runs the whole loop
// (`plan_arena` in ops/arena_kernel.py).  The rows stay in the branch
// store in device memory (L2-resident) and are stepped in place: a
// commit steps the winner's rows into a scratch pair first (a band
// overflow commits nothing), children are stepped straight into their
// pool slots.  A side's stats are a pure function of its row, so every
// node keeps its decision record (cost, length, flags, nominated
// symbols, votes) and only the rows an event changed are re-folded: the
// column step (band_ops.cuh's `column_step_runs`) returns the new
// column's tip histogram, one warp folds a node's votes, one warp runs
// the tournament, and thread 0 does the scalar decisions and the
// tracker arithmetic (lc/pc in device memory).  The vote fold sums in
// another order than the plain twin; every vote decision the arena takes
// is exact (dyadic tip splits) or has a VOTE_EPS margin, the contract of
// the run kernels.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "band_ops.cuh"

namespace {

using band::kFull;
using band::kInf;

constexpr int kCrePerEvent = 8;
constexpr int kCreCap = 64;
constexpr int kBigTot = INT_MAX;
constexpr int kBig = 1 << 28;
constexpr float kEps = 1e-2f;
constexpr int kMaxK = 64;
constexpr int kMaxA = 128;
constexpr int kParams = 24;
constexpr int kDecWords = 128;

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
};

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
  int32_t* in;
  int32_t* out;
  int32_t* scratch;
  int B, R, W, C, L, A, K, Lw, MCN, IMBN, max_steps, E;
  // 1: each warp's column step staged in shared memory
  int staged;
  // packed output (ops/arena_kernel.py `arena_out_layout`)
  int o_hist, o_evsym, o_steps, o_alive, o_kinds, o_clen, o_act, o_eds,
      o_split, o_reached, o_occ, o_cre, o_end;
  // packed input (`arena_in_layout`)
  int i_slots, i_kinds, i_tr, i_lc, i_pc, i_mc, i_imb;
  // scratch: commit rows [2][R][W], folds [2][4][R] (e, rmin, er, act),
  // tip histograms [2][R][A], splits [2][R]; the records' vote rows
  int s_folds, s_occ, s_split, s_cnt, s_hv;
};

// Shared memory of the CTA.
struct Smem {
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
  int* warp;    // per warp: hist[A], counts[2A] (float), has[2A]
  int* pass;    // [3A]: passing symbols of the winner's sides, order
  int* dec;     // [kDecWords]
};

__device__ Smem carve(int* base, int K, int A, int warps) {
  Smem s;
  s.total = base;
  s.flags = s.total + K;
  s.sym1 = s.flags + K;
  s.sym2 = s.sym1 + K;
  s.mc1 = s.sym2 + K;
  s.mc2 = s.mc1 + K;
  s.kind = s.mc2 + K;
  s.alive = s.kind + K;
  s.seqv = s.alive + K;
  s.fresh = s.seqv + K;
  s.steps = s.fresh + K;
  s.clen = s.steps + K;         // 2K words: 13K so far
  s.warp = base + 16 * K;
  s.pass = s.warp + warps * 5 * A;
  s.dec = s.pass + 3 * A;
  return s;
}

// Words of a warp's staging area: two [W] columns and a [W + 1] int16
// window, rounded up to 4 words.
__host__ __device__ inline int stage_words(int W) {
  return (2 * W + (W + 2) / 2 + 3) & ~3;
}

__device__ __forceinline__ float warp_sum_f(float v) {
  // butterfly: every lane ends with the same sum (each level adds the
  // same two values in either order)
#pragma unroll
  for (int k = 16; k; k >>= 1) v += __shfl_xor_sync(kFull, v, k);
  return v;
}

__device__ __forceinline__ int node_len(const Smem& s, int n) {
  return s.kind[n] == 1 ? max(s.clen[2 * n], s.clen[2 * n + 1])
                        : s.clen[2 * n];
}

// One warp: node n's decision record (`_node_eval` of the plain twin)
// from its sides' stats in the packed output and their lengths.
__device__ void node_eval(const Args& a, const Smem& s, int n) {
  const int lane = threadIdx.x & 31;
  const int* P = a.in;
  const int R = a.R, A = a.A;
  const bool dual = s.kind[n] == 1;
  const int f1 = 2 * n, f2 = 2 * n + 1;
  const int* act_o = a.out + a.o_act;
  const int* eds_o = a.out + a.o_eds;
  const int* split_o = a.out + a.o_split;
  const int* reached_o = a.out + a.o_reached;
  const int* occ_o = a.out + a.o_occ;
  const bool l2 = P[P_L2], weighted = P[P_WEIGHTED], et = P[P_ET];
  const bool use_w = weighted && dual;
  unsigned tot = 0;
  int mx = 0, n1 = 0, n2 = 0;
  bool all_rr = true, any_rr = false, all_f1 = true, any_f1 = false;
  bool all_f2 = true, any_f2 = false, any_r1 = false;
  for (int r = lane; r < R; r += 32) {
    const bool a1 = act_o[f1 * R + r];
    const bool a2 = dual && act_o[f2 * R + r];
    const int e1 = eds_o[f1 * R + r];
    const int e2 = dual ? eds_o[f2 * R + r] : 0;
    const bool r1 = reached_o[f1 * R + r];
    const bool r2 = dual && reached_o[f2 * R + r];
    const int c1 = l2 ? (int)((unsigned)e1 * (unsigned)e1) : e1;
    const int c2 = l2 ? (int)((unsigned)e2 * (unsigned)e2) : e2;
    if (dual) {
      const int best = min(a1 ? c1 : kBig, a2 ? c2 : kBig);
      tot += (a1 || a2) ? (unsigned)best : 0u;
    } else {
      tot += a1 ? (unsigned)c1 : 0u;
    }
    mx = max(mx, max(a1 ? e1 : 0, a2 ? e2 : 0));
    const bool rr = (a1 && r1) || (a2 && r2);
    all_rr &= rr || (!a1 && !a2);
    any_rr |= rr;
    all_f1 &= r1 || !a1;
    any_f1 |= a1 && r1;
    all_f2 &= r2 || !a2;
    any_f2 |= a2 && r2;
    any_r1 |= r1;
    n1 += a1;
    n2 += a2;
  }
  tot = __reduce_add_sync(kFull, tot);
  mx = __reduce_max_sync(kFull, mx);
  n1 = __reduce_add_sync(kFull, n1);
  n2 = __reduce_add_sync(kFull, n2);
  all_rr = __all_sync(kFull, all_rr);
  any_rr = __any_sync(kFull, any_rr);
  all_f1 = __all_sync(kFull, all_f1);
  any_f1 = __any_sync(kFull, any_f1);
  all_f2 = __all_sync(kFull, all_f2);
  any_f2 = __any_sync(kFull, any_f2);
  any_r1 = __any_sync(kFull, any_r1);
  const bool fin1 = et ? all_f1 : any_f1;
  const bool fin2 = et ? all_f2 : any_f2;
  const bool reach = dual ? (et ? all_rr : any_rr) : (et ? all_f1 : any_r1);
  const bool covf = l2 && mx > 2048;

  const int warp = threadIdx.x >> 5;
  int* hist = s.warp + warp * 5 * A;
  float* wcnt = reinterpret_cast<float*>(hist + A);
  int* whv = hist + 3 * A;
  float* rec_cnt = reinterpret_cast<float*>(a.scratch + a.s_cnt);
  int* rec_hv = a.scratch + a.s_hv;
  int flags = (reach ? F_REACH : 0) | (fin1 ? F_FIN1 : 0) |
              (fin2 ? F_FIN2 : 0) | (covf ? F_COVF : 0);
  bool dirty = covf;
  int syms[2] = {0, 0}, mcs[2] = {0, 0};
  for (int side = 0; side < 2; ++side) {
    float* cnt = wcnt + side * A;
    int* hv = whv + side * A;
    if (side == 1 && !dual) {
      for (int x = lane; x < A; x += 32) {
        rec_cnt[(n * 2 + 1) * A + x] = 0.f;
        rec_hv[(n * 2 + 1) * A + x] = 0;
      }
      break;
    }
    const int fs = 2 * n + side;
    // per-read weights: weighted dual votes split a read by the other
    // side's relative distance, else 1 on an active read
    bool nondy = false;
    for (int r = lane; r < R; r += 32) {
      const bool aa = act_o[(2 * n) * R + r];
      const bool ab = dual && act_o[(2 * n + 1) * R + r];
      const bool self = side ? ab : aa;
      float w = self ? 1.f : 0.f;
      if (use_w && aa && ab) {
        const float c1f = fmaxf((float)eds_o[(2 * n) * R + r], 0.5f);
        const float c2f = fmaxf((float)eds_o[(2 * n + 1) * R + r], 0.5f);
        w = (side ? c1f : c2f) / (c1f + c2f);
      }
      const int sp = split_o[fs * R + r];
      nondy |= w > 0.f && sp > 0 && (sp & (sp - 1)) != 0;
    }
    nondy = __any_sync(kFull, nondy);
    for (int x = 0; x < A; ++x) {
      float v = 0.f;
      bool h = false;
      for (int r = lane; r < R; r += 32) {
        const bool aa = act_o[(2 * n) * R + r];
        const bool ab = dual && act_o[(2 * n + 1) * R + r];
        const bool self = side ? ab : aa;
        float w = self ? 1.f : 0.f;
        if (use_w && aa && ab) {
          const float c1f = fmaxf((float)eds_o[(2 * n) * R + r], 0.5f);
          const float c2f = fmaxf((float)eds_o[(2 * n + 1) * R + r], 0.5f);
          w = (side ? c1f : c2f) / (c1f + c2f);
        }
        const int sp = split_o[fs * R + r];
        const int o = occ_o[(fs * R + r) * A + x];
        if (w > 0.f && sp > 0 && o > 0) {
          v += (float)o / (float)sp * w;
          h = true;
        }
      }
      v = warp_sum_f(v);
      h = __any_sync(kFull, h);
      if (lane == 0) {
        cnt[x] = v;
        hv[x] = h;
      }
    }
    __syncwarp();
    if (lane == 0) {
      const int wc = P[P_WC];
      int nc = 0;
      for (int x = 0; x < A; ++x) nc += hv[x];
      if (wc >= 0 && wc < A && nc > 1) {
        hv[wc] = 0;
        cnt[wc] = 0.f;
      }
      nc = 0;
      float nvf = 0.f;
      for (int x = 0; x < A; ++x) {
        nc += hv[x];
        nvf += cnt[x];
      }
      const float nvr = rintf(nvf);
      const bool int_ok = fabsf(nvf - nvr) < kEps;
      const bool tab_bad = P[P_MCDYN] && !int_ok;
      const bool exact = !nondy && !weighted && !tab_bad;
      const int mc = a.in[a.i_mc + min(max((int)nvr, 0), a.MCN - 1)];
      const float mcf = (float)mc;
      float maxc = -1.f;
      for (int x = 0; x < A; ++x)
        if (hv[x]) maxc = fmaxf(maxc, cnt[x]);
      const float thr = fminf(mcf, maxc);
      int npass = 0, sym = 0;
      float best = -3.f;
      bool near = fabsf(maxc - mcf) < kEps;
      for (int x = 0; x < A; ++x) {
        const bool ps = hv[x] && cnt[x] >= thr;
        npass += ps;
        near |= hv[x] && fabsf(cnt[x] - thr) < kEps;
        const float v = ps ? cnt[x] : -1.f;
        if (v > best) {
          best = v;
          sym = x;
        }
        rec_cnt[(n * 2 + side) * A + x] = cnt[x];
        rec_hv[(n * 2 + side) * A + x] = hv[x];
      }
      dirty |= (!exact && near) || npass != 1 || nc == 0 || tab_bad;
      if (side == 1) dirty |= fin1 || fin2;
      syms[side] = sym;
      mcs[side] = mc;
      flags |= (exact ? (side ? F_EX2 : F_EX1) : 0) |
               (near ? (side ? F_NT2 : F_NT1) : 0);
    }
    __syncwarp();
  }
  if (lane == 0) {
    const int nlen = node_len(s, n);
    const int imb_v = a.in[a.i_imb + min(max(nlen, 0), a.IMBN - 1)];
    const bool imb = dual && (n1 < imb_v || n2 < imb_v);
    s.total[n] = (int)tot;
    s.flags[n] = flags | (dirty ? F_DIRTY : 0) | (imb ? F_IMB : 0);
    s.sym1[n] = syms[0];
    s.sym2[n] = syms[1];
    s.mc1[n] = mcs[0];
    s.mc2[n] = mcs[1];
  }
  __syncwarp();
}

// Warp 0: the pop winner by (cost asc, length desc, FIFO rank asc); dead
// and unused nodes cost kBigTot.  Every lane returns the winner.
__device__ int tournament(const Smem& s, int K) {
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

// Thread 0: everything the event decides before any row moves — the
// rest-of-queue and discard tests, both kinds' tracker constriction, the
// creation gates and child specs, and the stop code.
__device__ void decide(const Args& a, const Smem& s, int win) {
  const int* P = a.in;
  int* d = s.dec;
  const int K = a.K, A = a.A, Lw = a.Lw;
  int* lc = a.in + a.i_lc;
  const int* pc = a.in + a.i_pc;
  const int nsteps = d[D_NSTEPS];
  const int step_limit = P[P_STEPLIM];
  const bool first = nsteps == 0;
  if (first) win = 0;
  const int wtot = s.alive[win] && s.kind[win] >= 0 ? s.total[win] : kBigTot;
  const int wlen = node_len(s, win);
  const bool arena_empty = wtot == kBigTot;
  const int rc = P[P_REST_COST], rl = P[P_REST_LEN];
  const bool rest_wins =
      !first && (wtot > rc || (wtot == rc && wlen < rl) ||
                 (wtot == rc && wlen == rl && !s.fresh[win]));
  int* tr = d + D_TR;
  if (!first) {
    for (int k = 0; k < 2; ++k) {
      int thr = tr[4 * k], tot = tr[4 * k + 1], lcon = tr[4 * k + 3];
      const int far = tr[4 * k + 2];
      while ((tot > P[P_MAXQ] || lcon >= P[P_MAXNWC]) && thr < far) {
        tot -= lc[k * Lw + min(max(thr, 0), Lw - 1)];
        ++thr;
        lcon = 0;
      }
      tr[4 * k] = thr;
      tr[4 * k + 1] = tot;
      tr[4 * k + 3] = lcon;
    }
  }
  const int k = min(max(s.kind[win], 0), 1);
  const int thr = tr[4 * k];
  const int li = min(max(wlen, 0), Lw - 1);
  const int fl = s.flags[win];
  const bool discarded = wtot > P[P_ME] || wlen < thr ||
                         pc[k * Lw + li] >= P[P_CAP] || (fl & F_IMB);
  const bool discard_now = !first && !rest_wins && !arena_empty &&
                           discarded && nsteps < step_limit;

  // ---- creation gates (`_j_arena` :2065-2153)
  const bool single = s.kind[win] == 0;
  const float* rc_cnt = reinterpret_cast<const float*>(a.scratch + a.s_cnt);
  const int* rc_hv = a.scratch + a.s_hv;
  const float* cA = rc_cnt + (win * 2) * A;
  const float* cB = rc_cnt + (win * 2 + 1) * A;
  const int* hvA = rc_hv + (win * 2) * A;
  const int* hvB = rc_hv + (win * 2 + 1) * A;
  const float mcA = (float)s.mc1[win], mcB = (float)s.mc2[win];
  float maxA = -1.f, maxB = -1.f;
  for (int x = 0; x < A; ++x) {
    if (hvA[x]) maxA = fmaxf(maxA, cA[x]);
    if (hvB[x]) maxB = fmaxf(maxB, cB[x]);
  }
  const float thA = fminf(mcA, maxA), thB = fminf(mcB, maxB);
  int* passA = s.pass;
  int* passB = s.pass + A;
  int* order = s.pass + 2 * A;
  const int wc = P[P_WC];
  int nA = 0, nB = 0, ncand = 0, npass_mc = 0;
  bool margA = true, margB = true, pair_ok = true;
  for (int x = 0; x < A; ++x) {
    passA[x] = hvA[x] && cA[x] >= thA;
    passB[x] = hvB[x] && cB[x] >= thB;
    nA += passA[x];
    nB += passB[x];
    const bool cand = hvA[x] && !(wc >= 0 && x == wc);
    ncand += cand;
    npass_mc += cand && cA[x] >= mcA;
    if (hvA[x]) margA &= fabsf(cA[x] - mcA) > kEps;
    if (hvB[x]) margB &= fabsf(cB[x] - mcB) > kEps;
    for (int y = 0; y < A; ++y) {
      const bool cy = hvA[y] && !(wc >= 0 && y == wc);
      if (cand && cy && x != y) pair_ok &= fabsf(cA[x] - cA[y]) > kEps;
    }
  }
  const int cmode = P[P_CMODE];
  const int n_pairs =
      cmode >= 2 && npass_mc > 1 ? ncand * (ncand - 1) / 2 : 0;
  const int n_children = single ? nA + n_pairs : nA * nB;
  const bool relax = P[P_RELAX];
  const bool relaxA = relax && !(fl & F_NT1) && margA;
  const bool relaxB = relax && !(fl & F_NT2) && margB;
  const bool ord_ok = pair_ok || cmode < 2;
  const bool exA = fl & F_EX1, exB = fl & F_EX2;
  const bool exact_ok =
      single ? (exA || (relaxA && ord_ok)) : ((exA || relaxA) && (exB || relaxB));
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
  d[D_DIAG] = n_children * 64 + exact_ok + kind_ok * 2 + g2 * 4 + g3 * 8 +
              g4 * 16 + g5 * 32;
  int code = 0;
  if (rest_wins || arena_empty) code = 3;
  else if (discarded) code = first || nsteps >= step_limit ? 4 : 0;
  else if (reach) code = 2;
  else if (dirty && !want_split) code = 1;
  else if (nsteps >= step_limit) code = 4;

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
  d[D_TOTQ] = tr[4 * k + 1];
  d[D_FAR] = tr[4 * k + 2];
  d[D_LCON] = tr[4 * k + 3];
  d[D_WLEN] = wlen;
  d[D_OVF] = 0;
  d[D_CSYM1] = s.sym1[win];
  d[D_CSYM2] = s.kind[win] == 1 ? s.sym2[win] : 0;
  d[D_NSIDES] = s.kind[win] == 1 ? 2 : 1;
}

__device__ __forceinline__ void zero_stats(const Args& a, int oi) {
  a.out[a.o_act + oi] = 0;
  a.out[a.o_eds + oi] = 0;
  a.out[a.o_split + oi] = 0;
  a.out[a.o_reached + oi] = 0;
}

// One warp: side f's stats at read r from its store row (`stats_core`).
__device__ void stats_row(const Args& a, const Smem& s, int f, int r,
                          int* hist) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)a.in[a.i_slots + f] * a.R + r;
  const int oi = f * a.R + r;
  int* occ = a.out + a.o_occ + (size_t)oi * a.A;
  if (!a.act[row]) {
    for (int x = lane; x < a.A; x += 32) occ[x] = 0;
    if (lane == 0) zero_stats(a, oi);
    return;
  }
  for (int x = lane; x < a.A; x += 32) hist[x] = 0;
  __syncwarp();
  const int e = a.e[row];
  const int split = band::tip_histogram_win(
      a.D + row * a.W, band::GlobalWindow{a.reads + (size_t)r * a.L, a.L},
      a.W, a.rlen[r], s.clen[f] - a.off[row] - a.E, e, hist);
  for (int x = lane; x < a.A; x += 32) occ[x] = hist[x];
  if (lane == 0) {
    const int er = a.er[row];
    a.out[a.o_act + oi] = 1;
    a.out[a.o_eds + oi] = e;
    a.out[a.o_split + oi] = split;
    a.out[a.o_reached + oi] = er < kInf && e == er;
  }
  __syncwarp();
}

// Symbols of one read from a window staged in shared memory: positions
// base .. base + W (the ones a column step and its vote read).
struct StagedWindow {
  const int16_t* w;
  int base;
  __device__ __forceinline__ int operator()(int i) const { return w[i - base]; }
};

// One warp: read r of side fs pushed by `sym` into row `Dn` (a child's
// store row, or the commit scratch); returns the new folds.  `hist` gets
// the new column's tip histogram, *split its size.  With the band staged
// (`stage` non-null: two [W] columns and a [W + 1] window of the warp in
// shared memory) the source row and its read window are loaded
// coalesced, the step runs in shared memory and the new column is
// stored coalesced; otherwise it runs on device memory.
__device__ band::Folds3 push_row(const Args& a, const Smem& s, int fs,
                                 int r, int sym, int32_t* Dn, int* hist,
                                 int* split, int32_t* stage) {
  const int lane = threadIdx.x & 31;
  const int W = a.W;
  const size_t row = (size_t)a.in[a.i_slots + fs] * a.R + r;
  for (int x = lane; x < a.A; x += 32) hist[x] = 0;
  const band::Folds3 f{a.e[row], a.rmin[row], a.er[row]};
  const int i0 = s.clen[fs] + 1 - a.off[row] - a.E;
  const int16_t* rd = a.reads + (size_t)r * a.L;
  if (stage == nullptr) {
    __syncwarp();
    return band::column_step_runs<band::GlobalWindow, true>(
        a.D + row * W, Dn, band::GlobalWindow{rd, a.L}, W, a.rlen[r], i0,
        sym, a.in[P_WC], a.in[P_ET], f, hist, split);
  }
  int32_t* sDo = stage;
  int32_t* sDn = stage + W;
  int16_t* sw = reinterpret_cast<int16_t*>(stage + 2 * W);
  for (int t = lane; t < W; t += 32) sDo[t] = a.D[row * W + t];
  for (int t = lane; t <= W; t += 32) {
    const int i = i0 - 1 + t;
    sw[t] = i >= 0 && i < a.L ? rd[i] : (int16_t)-1;
  }
  __syncwarp();
  const band::Folds3 nf = band::column_step_runs<StagedWindow, true>(
      sDo, sDn, StagedWindow{sw, i0 - 1}, W, a.rlen[r], i0, sym,
      a.in[P_WC], a.in[P_ET], f, hist, split);
  for (int t = lane; t < W; t += 32) Dn[t] = sDn[t];
  __syncwarp();
  return nf;
}

// Children of a split event, step 1 (one warp per child side and read):
// each child row is its source row pushed by the child's symbol, written
// straight into the child's pool slot (inactive reads copy the source);
// any active read reaching the band's edge flags an overflow, and then
// no child is created (the pool rows are scratch).
__device__ void step_children(const Args& a, const Smem& s, int* hist,
                              int32_t* stage) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int R = a.R, W = a.W, A = a.A;
  int* d = s.dec;
  for (int i = warp; i < d[D_NCS] * R; i += warps) {
    const int ci = i / R, r = i % R;
    const int fd = d[D_CS_DST + ci], fs = d[D_CS_SRC + ci];
    const size_t rs = (size_t)a.in[a.i_slots + fs] * R + r;
    const size_t rd = (size_t)a.in[a.i_slots + fd] * R + r;
    const int oi = fd * R + r;
    int* occ = a.out + a.o_occ + (size_t)oi * A;
    const int ac = a.act[rs];
    if (ac) {
      int split;
      const band::Folds3 nf = push_row(a, s, fs, r, d[D_CS_SYM + ci],
                                       a.D + rd * W, hist, &split, stage);
      for (int x = lane; x < A; x += 32) occ[x] = hist[x];
      if (lane == 0) {
        a.e[rd] = nf.e;
        a.rmin[rd] = nf.rmin;
        a.er[rd] = nf.er;
        a.out[a.o_act + oi] = 1;
        a.out[a.o_eds + oi] = nf.e;
        a.out[a.o_split + oi] = split;
        a.out[a.o_reached + oi] = nf.er < kInf && nf.e == nf.er;
        if (nf.e >= a.E) atomicOr(&d[D_OVF], 1);
      }
    } else {
      for (int t = lane; t < W; t += 32) a.D[rd * W + t] = a.D[rs * W + t];
      for (int x = lane; x < A; x += 32) occ[x] = 0;
      if (lane == 0) {
        a.e[rd] = a.e[rs];
        a.rmin[rd] = a.rmin[rs];
        a.er[rd] = a.er[rs];
        zero_stats(a, oi);
      }
    }
    if (lane == 0) {
      a.act[rd] = ac;
      a.off[rd] = a.off[rs];
    }
    __syncwarp();
  }
}

// Children, step 2 (every thread): divergence pruning of each dual
// child's pair, and each child side's consensus row (the source's, with
// the pushed symbol at its length).
__device__ void finish_children(const Args& a, const Smem& s) {
  const int R = a.R, A = a.A, C = a.C;
  const int* d = s.dec;
  const int pool = d[D_POOL], nch = d[D_NCH];
  const int delta = a.in[P_DELTA];
  for (int i = threadIdx.x; i < nch * R; i += blockDim.x) {
    const int t = i / R, r = i % R;
    if (d[D_SPEC_KIND + t] != 1) continue;
    const int c = pool + t;
    const size_t r1 = (size_t)a.in[a.i_slots + 2 * c] * R + r;
    const size_t r2 = (size_t)a.in[a.i_slots + 2 * c + 1] * R + r;
    if (!(a.act[r1] && a.act[r2])) continue;
    const int e1 = a.e[r1], e2 = a.e[r2];
    const bool p1 = e2 + delta < e1, p2 = e1 + delta < e2;
    for (int side = 0; side < 2; ++side) {
      if (!(side ? p2 : p1)) continue;
      const int oi = (2 * c + side) * R + r;
      a.act[side ? r2 : r1] = 0;
      zero_stats(a, oi);
      for (int x = 0; x < A; ++x) a.out[a.o_occ + (size_t)oi * A + x] = 0;
    }
  }
  for (long long i = threadIdx.x; i < (long long)d[D_NCS] * C;
       i += blockDim.x) {
    const int ci = (int)(i / C), x = (int)(i % C);
    const int fs = d[D_CS_SRC + ci];
    const size_t ss = (size_t)a.in[a.i_slots + fs] * C;
    const size_t sd = (size_t)a.in[a.i_slots + d[D_CS_DST + ci]] * C;
    const int at = min(max(s.clen[fs], 0), C - 1);
    a.cons[sd + x] = x == at ? d[D_CS_SYM + ci] : a.cons[ss + x];
  }
}

// Thread 0: a split event's creation bookkeeping (`_j_arena`'s
// `write_body`): the children join the table, each one's tracker insert,
// history entry and creation record.
__device__ void register_children(const Args& a, const Smem& s) {
  int* d = s.dec;
  const int K = a.K, Lw = a.Lw;
  const int win = d[D_WIN], pool = d[D_POOL], cre = d[D_CRE];
  const int nl = d[D_WLEN] + 1;
  const bool single = s.kind[win] == 0;
  int* lc = a.in + a.i_lc;
  int* tr = d + D_TR;
  int* cr = a.out + a.o_cre;
  for (int t = 0; t < d[D_NCH]; ++t) {
    const int c = pool + t, kt = d[D_SPEC_KIND + t];
    s.kind[c] = kt;
    s.alive[c] = 1;
    s.seqv[c] = d[D_SEQCTR] + t;
    s.fresh[c] = 0;
    s.clen[2 * c] = s.clen[2 * win] + 1;
    a.clen[a.in[a.i_slots + 2 * c]] = s.clen[2 * c];
    if (kt == 1) {
      s.clen[2 * c + 1] = s.clen[single ? 2 * win : 2 * win + 1] + 1;
      a.clen[a.in[a.i_slots + 2 * c + 1]] = s.clen[2 * c + 1];
    }
    lc[kt * Lw + min(max(nl, 0), Lw - 1)] += 1;
    tr[4 * kt + 1] += nl >= tr[4 * kt];
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

// A commit, step 1 (one warp per side and read): the winner's rows
// pushed into the scratch pair, their folds, activity and votes beside.
__device__ void step_commit(const Args& a, const Smem& s, int* hist,
                            int32_t* stage) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int R = a.R, W = a.W, A = a.A;
  int* d = s.dec;
  int* F = a.scratch + a.s_folds;
  for (int i = warp; i < d[D_NSIDES] * R; i += warps) {
    const int sd = i / R, r = i % R;
    const int fs = 2 * d[D_WIN] + sd;
    const size_t row = (size_t)a.in[a.i_slots + fs] * R + r;
    const int ac = a.act[row];
    if (ac) {
      int split;
      const band::Folds3 nf =
          push_row(a, s, fs, r, d[D_CSYM1 + sd],
                   a.scratch + ((size_t)sd * R + r) * W, hist, &split,
                   stage);
      int* occ = a.scratch + a.s_occ + ((size_t)sd * R + r) * A;
      for (int x = lane; x < A; x += 32) occ[x] = hist[x];
      if (lane == 0) {
        F[(sd * 4 + 0) * R + r] = nf.e;
        F[(sd * 4 + 1) * R + r] = nf.rmin;
        F[(sd * 4 + 2) * R + r] = nf.er;
        a.scratch[a.s_split + sd * R + r] = split;
        if (nf.e >= a.E) atomicOr(&d[D_OVF], 1);
      }
    }
    if (lane == 0) F[(sd * 4 + 3) * R + r] = ac;
    __syncwarp();
  }
}

// A commit, step 2 (one warp per side and read): the scratch rows into
// the store, with divergence pruning of a dual pair and the new stats;
// thread 0 appends the symbols.
__device__ void write_commit(const Args& a, const Smem& s) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int R = a.R, W = a.W, A = a.A, C = a.C;
  const int* d = s.dec;
  const int* F = a.scratch + a.s_folds;
  const int nsides = d[D_NSIDES];
  for (int i = warp; i < nsides * R; i += warps) {
    const int sd = i / R, r = i % R;
    if (!F[(sd * 4 + 3) * R + r]) continue;
    const int f = 2 * d[D_WIN] + sd;
    const size_t row = (size_t)a.in[a.i_slots + f] * R + r;
    const int32_t* src = a.scratch + ((size_t)sd * R + r) * W;
    for (int t = lane; t < W; t += 32) a.D[row * W + t] = src[t];
    const int es = F[(sd * 4) * R + r], er = F[(sd * 4 + 2) * R + r];
    bool keep = true;
    if (nsides == 2 && F[((1 - sd) * 4 + 3) * R + r]) {
      keep = !(F[((1 - sd) * 4) * R + r] + a.in[P_DELTA] < es);
    }
    const int oi = f * R + r;
    const int* socc = a.scratch + a.s_occ + ((size_t)sd * R + r) * A;
    for (int x = lane; x < A; x += 32)
      a.out[a.o_occ + (size_t)oi * A + x] = keep ? socc[x] : 0;
    if (lane == 0) {
      a.e[row] = es;
      a.rmin[row] = F[(sd * 4 + 1) * R + r];
      a.er[row] = er;
      a.act[row] = keep;
      a.out[a.o_act + oi] = keep;
      a.out[a.o_eds + oi] = keep ? es : 0;
      a.out[a.o_split + oi] = keep ? a.scratch[a.s_split + sd * R + r] : 0;
      a.out[a.o_reached + oi] = keep && er < kInf && es == er;
    }
  }
  if (threadIdx.x == 0) {
    for (int sd = 0; sd < nsides; ++sd) {
      const int f = 2 * d[D_WIN] + sd;
      const int slot = a.in[a.i_slots + f];
      a.cons[(size_t)slot * C + min(max(s.clen[f], 0), C - 1)] =
          d[D_CSYM1 + sd];
      s.clen[f] += 1;
      a.clen[slot] = s.clen[f];
    }
  }
}

// Thread 0: the event's tracker arithmetic, history entry and table
// updates (`_j_arena` :2468-2520), and its final stop code.
__device__ void finish_event(const Args& a, const Smem& s) {
  int* d = s.dec;
  const int K = a.K, Lw = a.Lw;
  int* lc = a.in + a.i_lc;
  int* pc = a.in + a.i_pc;
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
    hist[hp] = win;
    a.out[a.o_evsym + 2 * hp] = d[D_CSYM1];
    a.out[a.o_evsym + 2 * hp + 1] = d[D_CSYM2];
    s.steps[win] += 1;
    s.seqv[win] = d[D_SEQCTR];
    s.fresh[win] = 0;
    d[D_SEQCTR] += 1;
    d[D_NSTEPS] = nsteps + 1;
  } else if (disc) {
    lc[k * Lw + li] -= 1;
    tr[4 * k + 1] = d[D_TOTQ] - (wlen >= thr);
    hist[hp] = K + win;
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
    hist[hp] = 2 * K + win;
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

__global__ void __launch_bounds__(1024) arena_kernel(Args a) {
  extern __shared__ int smem_raw[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int K = a.K, R = a.R, A = a.A;
  const int* P = a.in;
  const Smem s = carve(smem_raw, K, A, warps);
  int* d = s.dec;
  int* hist = s.warp + warp * 5 * A;
  // the warp's staging area for a column step, when the plan stages
  int32_t* stage = a.staged ? s.dec + kDecWords + warp * stage_words(a.W)
                            : nullptr;
  const int n_live = P[P_NLIVE];

  for (int i = threadIdx.x; i < a.o_end; i += blockDim.x) a.out[i] = 0;
  for (int i = threadIdx.x; i < 4 * K * A; i += blockDim.x)
    a.scratch[a.s_cnt + i] = 0;
  for (int n = threadIdx.x; n < K; n += blockDim.x) {
    s.total[n] = s.flags[n] = s.sym1[n] = s.sym2[n] = 0;
    s.mc1[n] = s.mc2[n] = s.steps[n] = 0;
    s.kind[n] = a.in[a.i_kinds + n];
    s.alive[n] = n < n_live;
    s.seqv[n] = n;
    s.fresh[n] = n != 0;
  }
  for (int f = threadIdx.x; f < 2 * K; f += blockDim.x)
    s.clen[f] = a.clen[a.in[a.i_slots + f]];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) d[D_TR + i] = a.in[a.i_tr + i];
    d[D_NSTEPS] = 0;
    d[D_SEQCTR] = K + 1;
    d[D_POOL] = n_live;
    d[D_CRE] = 0;
    d[D_CODE] = 0;
  }
  __syncthreads();
  for (int i = warp; i < 2 * n_live * R; i += warps) {
    const int f = i / R;
    if ((f & 1) && s.kind[f >> 1] != 1) continue;
    stats_row(a, s, f, i % R, hist);
  }
  __syncthreads();
  for (int n = warp; n < n_live; n += warps) node_eval(a, s, n);
  __syncthreads();

  for (;;) {
    if (warp == 0) {
      const int win = tournament(s, K);
      if (lane == 0) decide(a, s, win);
    }
    __syncthreads();
    if (d[D_SPLIT]) {
      step_children(a, s, hist, stage);
      __syncthreads();
      if (!d[D_OVF]) {
        finish_children(a, s);
        __syncthreads();
        if (threadIdx.x == 0) register_children(a, s);
        __syncthreads();
        for (int t = warp; t < d[D_NCH]; t += warps)
          node_eval(a, s, d[D_POOL] + t);
        __syncthreads();
      }
    } else if (d[D_CODE] == 0 && !d[D_DISC]) {
      step_commit(a, s, hist, stage);
      __syncthreads();
      if (!d[D_OVF]) {
        write_commit(a, s);
        __syncthreads();
        if (warp == 0) node_eval(a, s, d[D_WIN]);
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) finish_event(a, s);
    __syncthreads();
    if (d[D_CODE] != 0) break;
  }

  // results: scalars and per-node fields; stats of sides no node owns
  // (creation pool sides never created, side 2 of single nodes) zeroed
  const int n_nodes = n_live + d[D_CRE];
  if (threadIdx.x == 0) {
    a.out[0] = d[D_NSTEPS];
    a.out[1] = d[D_CODE];
    a.out[2] = d[D_STOP];
    a.out[3] = d[D_CRE];
    a.out[4] = d[D_DIAG];
  }
  for (int n = threadIdx.x; n < K; n += blockDim.x) {
    a.out[a.o_steps + n] = s.steps[n];
    a.out[a.o_alive + n] = s.alive[n];
    a.out[a.o_kinds + n] = s.kind[n];
  }
  for (int f = threadIdx.x; f < 2 * K; f += blockDim.x)
    a.out[a.o_clen + f] = s.clen[f];
  for (long long i = threadIdx.x; i < 2LL * K * R; i += blockDim.x) {
    const int f = (int)(i / R), n = f >> 1;
    if (n < n_nodes && (!(f & 1) || s.kind[n] == 1)) continue;
    zero_stats(a, (int)i);
    for (int x = 0; x < A; ++x) a.out[a.o_occ + i * A + x] = 0;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  The store (D, e, rmin, er,
// off, act, cons, clen) is stepped in place at the slots of the packed
// input `in` (ops/arena_kernel.py `arena_in_layout`; its trackers are
// updated in place), the results go to the packed `out`
// (`arena_out_layout`), `scratch` holds the commit rows and the records'
// vote rows.  `threads` and `smem` are `plan_arena`'s.  Returns 0 on
// success, -1 when the plan does not match the kernel, else the CUDA
// error; the launch does not synchronise.
extern "C" int arena_launch(void* D, void* e, void* rmin, void* er,
                            void* off, void* act, void* cons, void* clen,
                            void* reads, void* rlen, void* in, void* out,
                            void* scratch, int B, int R, int W, int C, int L,
                            int A, int K, int Lw, int MCN, int IMBN,
                            int max_steps, int threads, int smem,
                            int staged, void* stream) {
  const int warps = min(32, max(1, 2 * R));
  const int want_smem = 4 * (16 * K + warps * 5 * A + 3 * A + kDecWords +
                             (staged ? warps * stage_words(W) : 0));
  if (K < 1 || K > kMaxK || A < 1 || A > kMaxA || R < 1 || W < 4 ||
      W % 2 || Lw < 1 || C < 2 || MCN < 1 || IMBN < 1 || max_steps < 1 ||
      threads != 32 * warps || smem != want_smem || B < 2 * K)
    return -1;
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
  a.in = static_cast<int32_t*>(in);
  a.out = static_cast<int32_t*>(out);
  a.scratch = static_cast<int32_t*>(scratch);
  a.B = B; a.R = R; a.W = W; a.C = C; a.L = L; a.A = A; a.K = K;
  a.Lw = Lw; a.MCN = MCN; a.IMBN = IMBN; a.max_steps = max_steps;
  a.E = (W - 2) / 2;
  a.staged = staged != 0;
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
  at = 2 * R * W;
  a.s_folds = at; at += 8 * R;
  a.s_occ = at; at += 2 * R * A;
  a.s_split = at; at += 2 * R;
  a.s_cnt = at; at += 2 * K * A;
  a.s_hv = at;
  static int smem_attr = 0;
  if (smem > 48 * 1024 && smem > smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        arena_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_attr = smem;
  }
  arena_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
