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
// Design.  One CTA of 1024 threads per launch; the two sides are coupled
// per read every step (the node cost takes each read's better side, the
// vote weights compare the two sides' distances, pruning compares the
// new ones), so both live in the one CTA.  The band keeps the branch
// store's [R, W] layout; a warp owns one (side, read) row at a time and
// runs the tip histogram and the column step of csrc/band_ops.cuh on it
// (32-cell tiles, warp-scan insertion chain), shared with
// csrc/run_extend.cu.  Reads are fetched from the [R, L] int16 array at
// per-read offsets, and the alphabet size is a runtime bound, so uniform
// and mixed offsets take the same kernel.  A step is: the per-read cost
// and record folds (a thread per read) together with the vote pass of
// each unlocked side (tip histograms, per-warp float32 partial sums in
// read order); one thread's decision; the column pass of each unlocked
// side into the other of its two band buffers (its slot of the store and
// a scratch [R, W] buffer), so a step that overflows the band is never
// swapped in; the pruning fold on the new distances; and the commit.  A
// read pruned at a commit gets its new row copied into the side's other
// buffer, since the column pass only writes active reads.
//
// What bounds it.  Each step streams the two sides' R x W int32 bands
// through ONE SM (read twice, written once per unlocked side: about
// 0.4 MB at the dual north star's R = 64, W = 258), and holds about nine
// block-wide barriers on the way through the decision.  A later design
// spreads the (side, read) rows over a thread-block cluster with the
// folds reduced in distributed shared memory, keeps the bands on chip in
// int16, and cuts the barrier chain by letting each warp fold its own
// partial decision.

#include <cuda_runtime.h>
#include <cstdint>

#include "band_ops.cuh"

namespace {

using band::kFull;
using band::kInf;
constexpr int kBig = 1 << 28;       // cost of an untracked side
constexpr int kRecCap = 256;        // record buffer rows (REC_CAP)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kVoteEps = 0.01f;   // VOTE_EPS, float32(1e-2)

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
  int32_t* out;        // packed outputs (run_dual_kernel.dual_out_layout)
  int32_t* rec_steps;  // [REC_CAP]
  int32_t* rec_planes; // [4, REC_CAP, R]: fin1, fin2, act1, act2
  int h[2], lock[2];
  int R, W, C, L, A, E, MCN, IMBN;
  int me_budget, other_cost, other_len, delta, l2, weighted, max_steps;
  int allow_records, rec_min, mc_dyn, wc, et;
  // offsets of the packed output fields, per side
  int o_eds[2], o_split[2], o_reached[2], o_act[2], o_occ[2], o_syms[2];
};

// Shared-memory working set (dynamic, carved in order by carve()).
struct Smem {
  int* e[2]; int* rmin[2]; int* er[2];     // [R] folds of the current state
  int* e2[2]; int* rmin2[2]; int* er2[2];  // [R] folds after the column pass
  int* fin[2];                             // [R] finalized distances
  int* off[2]; int* act[2];                // [R]
  int* act2[2];                            // [R] activity after pruning
  int* prn[2];                             // [R] pruned at this step
  int* rlen;                               // [R]
  int* hist;                               // [kWarps, A] tip histogram
  float* pcount;                           // [2, kWarps, A] per-warp votes
  int* phas;                               // [2, kWarps, A] "has votes"
  float* counts;                           // [2, A]
  int* has;                                // [2, A]
};

__host__ __device__ inline size_t smem_bytes(int R, int A) {
  return sizeof(int) * (23 * (size_t)R + 5 * (size_t)kWarps * A + 4 * (size_t)A);
}

__device__ inline Smem carve(char* base, int R, int A) {
  Smem s;
  int* p = reinterpret_cast<int*>(base);
  for (int k = 0; k < 2; ++k) {
    s.e[k] = p; p += R; s.rmin[k] = p; p += R; s.er[k] = p; p += R;
    s.e2[k] = p; p += R; s.rmin2[k] = p; p += R; s.er2[k] = p; p += R;
    s.fin[k] = p; p += R; s.off[k] = p; p += R; s.act[k] = p; p += R;
    s.act2[k] = p; p += R; s.prn[k] = p; p += R;
  }
  s.rlen = p; p += R;
  s.hist = p; p += kWarps * A;
  s.pcount = reinterpret_cast<float*>(p); p += 2 * kWarps * A;
  s.phas = p; p += 2 * kWarps * A;
  s.counts = reinterpret_cast<float*>(p); p += 2 * A;
  s.has = p; p += 2 * A;
  return s;
}

// Block-wide accumulators of one step (integer folds: order-free).
struct Folds {
  unsigned total, fin_total;     // wrapping int32 sums
  int max_eds, fin_max;          // max over tracked (read, side)
  int count0, n_any;             // record assignment counts
  int fo;                        // a finalized distance out of band
  int fin_flag[2];               // et: a side not finished; else: finished
  int stop_flag;                 // et: a read not reached; else: any reached
  int nonexact[2];               // a voting read with a non-dyadic split
  int cnt2[2];                   // active reads after pruning
  int ovf;                       // band overflow of the step
  int pruned;                    // a read was pruned at the step
};

__device__ inline unsigned cost_of(int x, int l2) {
  const unsigned u = (unsigned)x;
  return l2 ? u * u : u;  // wrapping int32, as on the TPU
}

// Per-read vote weight of side `side` (reference get_ed_weights under
// `weighted`; otherwise full weight for a tracked read).
__device__ inline float weight(const Args& a, const Smem& s, int side, int r) {
  const int aa = s.act[0][r], ab = s.act[1][r];
  const int mine = side ? ab : aa;
  if (!a.weighted || !(aa && ab)) return mine ? 1.f : 0.f;
  const float c1 = fmaxf((float)s.e[0][r], 0.5f);
  const float c2 = fmaxf((float)s.e[1][r], 0.5f);
  return __fdiv_rn(side ? c1 : c2, __fadd_rn(c1, c2));
}

// Tip histogram of read r of one side at consensus length `clen` into the
// warp's `hist`; returns the number of tips (split), warp-uniform.
__device__ inline int tips(const Args& a, const Smem& s, int side,
                           const int32_t* Dcur, int clen, int r, int* hist) {
  return band::tip_histogram(Dcur + (size_t)r * a.W,
                             a.reads + (size_t)r * a.L, a.W, s.rlen[r],
                             clen - s.off[side][r] - a.E, s.e[side][r], hist);
}

// Vote pass of one unlocked side: per read, the tip histogram folded into
// the warp's float32 partial sums (read order within the warp).
__device__ void vote_pass(const Args& a, const Smem& s, Folds* F, int side,
                          const int32_t* Dcur, int clen) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hist = s.hist + warp * a.A;
  float* pc = s.pcount + (side * kWarps + warp) * a.A;
  int* ph = s.phas + (side * kWarps + warp) * a.A;
  int nonexact = 0;
  for (int r = warp; r < a.R; r += kWarps) {
    if (!s.act[side][r]) continue;
    const int split = tips(a, s, side, Dcur, clen, r, hist);
    const float w = weight(a, s, side, r);
    const bool voting = w > 0.f && split > 0;
    const float split_f = (float)max(split, 1);
    for (int sym = lane; sym < a.A; sym += 32) {
      const int c = hist[sym];
      if (voting && c > 0) {
        pc[sym] += __fmul_rn(__fdiv_rn((float)c, split_f), w);
        ph[sym] = 1;
      }
      hist[sym] = 0;
    }
    __syncwarp();
    nonexact |= voting && (split & (split - 1)) != 0;
  }
  if (lane == 0 && nonexact) atomicOr(&F->nonexact[side], 1);
}

// Final snapshot of one side into the packed output.
__device__ void snapshot(const Args& a, const Smem& s, int side,
                         const int32_t* Dcur, int clen) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hist = s.hist + warp * a.A;
  for (int r = warp; r < a.R; r += kWarps) {
    const int act = s.act[side][r];
    const int split = act ? tips(a, s, side, Dcur, clen, r, hist) : 0;
    for (int sym = lane; sym < a.A; sym += 32) {
      a.out[a.o_occ[side] + r * a.A + sym] = hist[sym];
      hist[sym] = 0;
    }
    __syncwarp();
    if (lane == 0) {
      const int e = s.e[side][r], er = s.er[side][r];
      a.out[a.o_eds[side] + r] = act ? e : 0;
      a.out[a.o_split[side] + r] = split;
      a.out[a.o_reached[side] + r] = act && er < kInf && e == er;
      a.out[a.o_act[side] + r] = act;
    }
  }
}

// Column pass of one unlocked side: advance every active read's band
// column from consensus length jnew - 1 to jnew by consuming `sym`, into
// Dnext; per-read folds into e2/rmin2/er2; band overflow into F->ovf.
__device__ void column_pass(const Args& a, const Smem& s, Folds* F, int side,
                            const int32_t* Dcur, int32_t* Dnext, int jnew,
                            int sym) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < a.R; r += kWarps) {
    if (!s.act[side][r]) continue;
    const band::Folds3 f = band::column_step(
        Dcur + (size_t)r * a.W, Dnext + (size_t)r * a.W,
        a.reads + (size_t)r * a.L, a.W, a.L, s.rlen[r],
        jnew - s.off[side][r] - a.E, sym, a.wc, a.et,
        band::Folds3{s.e[side][r], s.rmin[side][r], s.er[side][r]});
    if (lane == 0) {
      s.e2[side][r] = f.e;
      s.rmin2[side][r] = f.rmin;
      s.er2[side][r] = f.er;
      if (f.e >= a.E) atomicOr(&F->ovf, 1);
    }
  }
}

// One side's nomination (the JAX package's `_dual_votes` +
// `_nominate_side`): wildcard drop, candidates recounted after it, the
// mc_tab threshold at the rounded vote total, EPS near-tie guard,
// first-max tie-break.  Run by one thread.
__device__ void nominate(const Args& a, float* counts, int* has,
                         bool nonexact, bool* dirty, int* sym_out) {
  int n_cands = 0;
  for (int k = 0; k < a.A; ++k) n_cands += has[k] != 0;
  if (a.wc >= 0 && n_cands > 1) {
    has[a.wc] = 0;
    counts[a.wc] = 0.f;
  }
  n_cands = 0;
  for (int k = 0; k < a.A; ++k) n_cands += has[k] != 0;
  bool exactable = !nonexact && !a.weighted;
  float n_vote_f = 0.f;
  for (int k = 0; k < a.A; ++k) n_vote_f = __fadd_rn(n_vote_f, counts[k]);
  const float n_vote_r = rintf(n_vote_f);  // half to even, as jnp.round
  const bool int_ok = fabsf(__fsub_rn(n_vote_f, n_vote_r)) < kVoteEps;
  const bool tab_bad = a.mc_dyn && !int_ok;
  exactable = exactable && !tab_bad;
  const int idx = min(max((int)n_vote_r, 0), a.MCN - 1);
  const float mc_f = (float)a.mc_tab[idx];
  float maxc = -1.f;
  for (int k = 0; k < a.A; ++k) maxc = fmaxf(maxc, has[k] ? counts[k] : -1.f);
  const float thr = fminf(mc_f, maxc);
  int npass = 0, sym = 0;
  bool near_any = false;
  float best = -1.f;
  for (int k = 0; k < a.A; ++k) {
    const bool hv = has[k] != 0;
    const bool passing = hv && counts[k] >= thr;
    npass += passing;
    near_any = near_any || (hv && fabsf(__fsub_rn(counts[k], thr)) < kVoteEps);
    const float ca = passing ? counts[k] : -1.f;
    if (ca > best) {
      sym = k;
      best = ca;
    }
  }
  const bool near_tie = fabsf(__fsub_rn(maxc, mc_f)) < kVoteEps || near_any;
  *dirty = (!exactable && near_tie) || npass != 1 || n_cands == 0 || tab_bad;
  *sym_out = sym;
}

__global__ void __launch_bounds__(kThreads, 1) run_extend_dual_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, a.R, a.A);
  __shared__ Folds F;
  __shared__ int32_t* buf[2][2];
  __shared__ int s_cur[2], s_clen[2], s_sym[2];
  __shared__ int s_steps, s_code, s_rec_count, s_budget, s_commit, s_do_rec;
  __shared__ int s_ri, s_reached_stop, s_rec_imb, s_fin_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t RW = (size_t)a.R * a.W;

  for (int r = tid; r < a.R; r += kThreads) {
    for (int k = 0; k < 2; ++k) {
      const size_t hr = (size_t)a.h[k] * a.R + r;
      s.e[k][r] = a.e[hr];
      s.rmin[k][r] = a.rmin[hr];
      s.er[k][r] = a.er[hr];
      s.off[k][r] = a.off[hr];
      s.act[k][r] = a.act[hr] != 0;
    }
    s.rlen[r] = a.rlen[r];
  }
  for (int i = tid; i < kWarps * a.A; i += kThreads) s.hist[i] = 0;
  for (int i = tid; i < 2 * kWarps * a.A; i += kThreads) {
    s.pcount[i] = 0.f;
    s.phas[i] = 0;
  }
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      buf[k][0] = a.D + (size_t)a.h[k] * RW;
      buf[k][1] = a.scratch + (size_t)k * RW;
      s_cur[k] = 0;
      s_clen[k] = a.clen[a.h[k]];
    }
    s_steps = 0;
    s_code = 0;
    s_rec_count = 0;
    s_budget = a.me_budget;
    F = Folds{};
  }
  __syncthreads();
  // inactive reads are never stepped: each unlocked side's scratch buffer
  // carries their rows too (reads pruned later are copied at the commit)
  for (int k = 0; k < 2; ++k) {
    if (a.lock[k]) continue;
    for (int r = warp; r < a.R; r += kWarps) {
      if (s.act[k][r]) continue;
      for (int t = lane; t < a.W; t += 32)
        buf[k][1][(size_t)r * a.W + t] = buf[k][0][(size_t)r * a.W + t];
    }
  }

  while (true) {
    __syncthreads();
    if (s_code != 0) break;
    const int clen0 = s_clen[0], clen1 = s_clen[1];

    // ---- per-read folds (a thread per read; whole warps per round)
    for (int base = 0; base < a.R; base += kThreads) {
      const int r = base + tid;
      const bool ok = r < a.R;
      const int aa = ok && s.act[0][r], ab = ok && s.act[1][r];
      const int eda = aa ? s.e[0][r] : 0, edb = ab ? s.e[1][r] : 0;
      const unsigned ca = cost_of(eda, a.l2), cb = cost_of(edb, a.l2);
      const int best = min(aa ? (int)ca : kBig, ab ? (int)cb : kBig);
      const unsigned tot = (aa || ab) ? (unsigned)best : 0u;
      int fin1 = 0, fin2 = 0, fo = 0;
      if (aa) {
        const int fu = max(s.e[0][r], s.rmin[0][r]);
        fin1 = min(fu, kInf);
        fo |= fu >= a.E;
      }
      if (ab) {
        const int fu = max(s.e[1][r], s.rmin[1][r]);
        fin2 = min(fu, kInf);
        fo |= fu >= a.E;
      }
      if (ok) {
        s.fin[0][r] = fin1;
        s.fin[1][r] = fin2;
      }
      const unsigned fc1 = cost_of(fin1, a.l2), fc2 = cost_of(fin2, a.l2);
      const int side0 = aa && (!ab || (int)fc1 <= (int)fc2);
      const int any_act = aa || ab;
      const unsigned ftot = any_act ? (side0 ? fc1 : fc2) : 0u;
      const int rea = aa && s.er[0][r] < kInf && s.e[0][r] == s.er[0][r];
      const int reb = ab && s.er[1][r] < kInf && s.e[1][r] == s.er[1][r];
      const int rr = rea || reb;
      const int fa = a.et ? (aa && !rea) : rea;
      const int fb = a.et ? (ab && !reb) : reb;
      const int st = a.et ? (any_act && !rr) : rr;
      const unsigned w_tot = __reduce_add_sync(kFull, tot);
      const unsigned w_ftot = __reduce_add_sync(kFull, ftot);
      const int w_max_eds = __reduce_max_sync(kFull, max(eda, edb));
      const int w_fin_max = __reduce_max_sync(kFull, max(fin1, fin2));
      const int w_count0 = __reduce_add_sync(kFull, side0 && any_act);
      const int w_any = __reduce_add_sync(kFull, any_act);
      const int w_fo = __reduce_or_sync(kFull, fo);
      const int w_fa = __reduce_or_sync(kFull, fa);
      const int w_fb = __reduce_or_sync(kFull, fb);
      const int w_st = __reduce_or_sync(kFull, st);
      if (lane == 0) {
        atomicAdd(&F.total, w_tot);
        atomicAdd(&F.fin_total, w_ftot);
        atomicMax(&F.max_eds, w_max_eds);
        atomicMax(&F.fin_max, w_fin_max);
        atomicAdd(&F.count0, w_count0);
        atomicAdd(&F.n_any, w_any);
        if (w_fo) atomicOr(&F.fo, 1);
        if (w_fa) atomicOr(&F.fin_flag[0], 1);
        if (w_fb) atomicOr(&F.fin_flag[1], 1);
        if (w_st) atomicOr(&F.stop_flag, 1);
      }
    }
    // ---- vote pass of each unlocked side
    for (int k = 0; k < 2; ++k) {
      if (!a.lock[k])
        vote_pass(a, s, &F, k, buf[k][s_cur[k]], k ? clen1 : clen0);
    }
    __syncthreads();
    for (int i = tid; i < 2 * a.A; i += kThreads) {
      const int k = i / a.A, sym = i - k * a.A;
      float c = 0.f;
      int hv = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int j = (k * kWarps + w) * a.A + sym;
        c = __fadd_rn(c, s.pcount[j]);
        hv |= s.phas[j];
        s.pcount[j] = 0.f;
        s.phas[j] = 0;
      }
      s.counts[i] = c;
      s.has[i] = hv;
    }
    __syncthreads();
    if (tid == 0) {
      bool dirty[2] = {false, false};
      int sym[2] = {0, 0};
      for (int k = 0; k < 2; ++k) {
        if (!a.lock[k])  // a locked side never arbitrates
          nominate(a, s.counts + k * a.A, s.has + k * a.A,
                   F.nonexact[k] != 0, &dirty[k], &sym[k]);
      }
      const int total = (int)F.total;
      const bool cost_overflow = a.l2 && F.max_eds > 2048;
      const bool fin_a = a.et ? !F.fin_flag[0] : F.fin_flag[0] != 0;
      const bool fin_b = a.et ? !F.fin_flag[1] : F.fin_flag[1] != 0;
      const bool reached_stop = a.et ? !F.stop_flag : F.stop_flag != 0;
      const int cur_len = max(clen0, clen1);
      const bool wins_pop = total < a.other_cost ||
                            (total == a.other_cost && cur_len > a.other_len);
      const int count1 = F.n_any - F.count0;
      const bool fin_cost_ovf = a.l2 && F.fin_max > 2048;
      const bool rec_blocked = !a.allow_records || F.fo || fin_cost_ovf ||
                               s_rec_count >= kRecCap;
      int code = 0;
      if (total > s_budget || !wins_pop) code = 3;
      else if (reached_stop && rec_blocked) code = 2;
      else if (dirty[0] || dirty[1] || (fin_a && !a.lock[0]) ||
               (fin_b && !a.lock[1]) || cost_overflow) code = 1;
      else if (s_steps >= a.max_steps) code = 4;
      s_code = code;
      s_sym[0] = sym[0];
      s_sym[1] = sym[1];
      s_reached_stop = reached_stop;
      s_rec_imb = F.count0 < a.rec_min || count1 < a.rec_min;
      s_fin_total = (int)F.fin_total;
      F.cnt2[0] = F.cnt2[1] = 0;
      F.ovf = 0;
      F.pruned = 0;
    }
    __syncthreads();
    if (s_code != 0) break;

    // ---- one column on each unlocked side
    for (int k = 0; k < 2; ++k) {
      if (!a.lock[k])
        column_pass(a, s, &F, k, buf[k][s_cur[k]], buf[k][s_cur[k] ^ 1],
                    (k ? clen1 : clen0) + 1, s_sym[k]);
    }
    __syncthreads();

    // ---- divergence pruning on the new distances (a thread per read)
    for (int base = 0; base < a.R; base += kThreads) {
      const int r = base + tid;
      const bool ok = r < a.R;
      const int aa = ok && s.act[0][r], ab = ok && s.act[1][r];
      int ea2 = 0, eb2 = 0;
      if (ok) {
        ea2 = a.lock[0] ? s.e[0][r] : s.e2[0][r];
        eb2 = a.lock[1] ? s.e[1][r] : s.e2[1][r];
      }
      // a locked side's frozen distances count in the overflow test too
      const int ovf = (aa && a.lock[0] && ea2 >= a.E) ||
                      (ab && a.lock[1] && eb2 >= a.E);
      const int both = aa && ab;
      const int na = aa && !(both && eb2 + a.delta < ea2);
      const int nb = ab && !(both && ea2 + a.delta < eb2);
      if (ok) {
        s.act2[0][r] = na;
        s.act2[1][r] = nb;
        s.prn[0][r] = aa && !na;
        s.prn[1][r] = ab && !nb;
      }
      const int w_na = __reduce_add_sync(kFull, na);
      const int w_nb = __reduce_add_sync(kFull, nb);
      const int w_ovf = __reduce_or_sync(kFull, ovf);
      const int w_prn = __reduce_or_sync(kFull, (aa && !na) || (ab && !nb));
      if (lane == 0) {
        atomicAdd(&F.cnt2[0], w_na);
        atomicAdd(&F.cnt2[1], w_nb);
        if (w_ovf) atomicOr(&F.ovf, 1);
        if (w_prn) atomicOr(&F.pruned, 1);
      }
    }
    __syncthreads();
    if (tid == 0) {
      s_commit = !F.ovf;
      s_do_rec = 0;
      if (F.ovf) {
        s_code = 5;
      } else {
        const int cur_len = max(clen0, clen1);
        const int imb_v =
            a.imb_tab[min(max(cur_len + 1, 0), a.IMBN - 1)];
        if (F.cnt2[0] < imb_v || F.cnt2[1] < imb_v) s_code = 6;  // committed
        for (int k = 0; k < 2; ++k) {
          if (a.lock[k]) continue;
          a.cons[(size_t)a.h[k] * a.C + s_clen[k]] = s_sym[k];
          a.out[a.o_syms[k] + s_steps] = s_sym[k];
          s_clen[k] += 1;
          s_cur[k] ^= 1;
        }
        if (s_reached_stop) {
          // record of the pre-step state
          s_do_rec = 1;
          s_ri = min(s_rec_count, kRecCap - 1);
          a.rec_steps[s_ri] = s_steps;
          s_rec_count += 1;
          if (!s_rec_imb && s_fin_total < s_budget) s_budget = s_fin_total;
        }
        s_steps += 1;
      }
      // next step's per-read folds start from zero
      F.total = F.fin_total = 0u;
      F.max_eds = F.fin_max = F.count0 = F.n_any = F.fo = 0;
      F.fin_flag[0] = F.fin_flag[1] = F.stop_flag = 0;
      F.nonexact[0] = F.nonexact[1] = 0;
    }
    __syncthreads();
    if (s_commit) {
      // a pruned read is no longer stepped: give the side's other buffer
      // its new row
      if (F.pruned) {
        for (int k = 0; k < 2; ++k) {
          if (a.lock[k]) continue;
          const int32_t* src = buf[k][s_cur[k]];
          int32_t* dst = buf[k][s_cur[k] ^ 1];
          for (int r = warp; r < a.R; r += kWarps) {
            if (!s.prn[k][r]) continue;
            for (int t = lane; t < a.W; t += 32)
              dst[(size_t)r * a.W + t] = src[(size_t)r * a.W + t];
          }
        }
      }
      for (int r = tid; r < a.R; r += kThreads) {
        if (s_do_rec) {
          const size_t row = (size_t)s_ri * a.R + r;
          const size_t plane = (size_t)kRecCap * a.R;
          a.rec_planes[row] = s.fin[0][r];
          a.rec_planes[plane + row] = s.fin[1][r];
          a.rec_planes[2 * plane + row] = s.act[0][r];
          a.rec_planes[3 * plane + row] = s.act[1][r];
        }
        for (int k = 0; k < 2; ++k) {
          if (!a.lock[k] && s.act[k][r]) {
            s.e[k][r] = s.e2[k][r];
            s.rmin[k][r] = s.rmin2[k][r];
            s.er[k][r] = s.er2[k][r];
          }
          s.act[k][r] = s.act2[k][r];
        }
      }
    }
  }

  // ---- final snapshot and write-back of both slots
  for (int k = 0; k < 2; ++k) snapshot(a, s, k, buf[k][s_cur[k]], s_clen[k]);
  if (tid == 0) {
    a.out[0] = s_steps;
    a.out[1] = s_code;
    a.out[2] = s_rec_count;
    a.out[3] = s_clen[0];
    a.out[4] = s_clen[1];
    a.out[5] = a.out[6] = a.out[7] = 0;
    a.clen[a.h[0]] = s_clen[0];
    a.clen[a.h[1]] = s_clen[1];
  }
  for (int k = 0; k < 2; ++k) {
    if (s_cur[k] == 1) {
      for (size_t i = tid; i < RW; i += kThreads) buf[k][0][i] = buf[k][1][i];
    }
  }
  for (int r = tid; r < a.R; r += kThreads) {
    for (int k = 0; k < 2; ++k) {
      const size_t hr = (size_t)a.h[k] * a.R + r;
      a.e[hr] = s.e[k][r];
      a.rmin[hr] = s.rmin[k][r];
      a.er[hr] = s.er[k][r];
      a.act[hr] = (uint8_t)(s.act[k][r] != 0);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one CTA on `stream`
// and returns cudaGetLastError() (0 on success); the launch does not
// synchronise.
extern "C" int run_extend_dual_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* mc_tab, void* imb_tab,
    void* scratch, void* out, void* rec_steps, void* rec_planes, int h1,
    int h2, int R, int W, int C, int L, int A, int MCN, int IMBN,
    int me_budget, int other_cost, int other_len, int delta, int l2,
    int weighted, int max_steps, int lock1, int lock2, int allow_records,
    int rec_min, int mc_dyn, int wc, int et, void* stream) {
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
  a.mc_tab = static_cast<const int32_t*>(mc_tab);
  a.imb_tab = static_cast<const int32_t*>(imb_tab);
  a.scratch = static_cast<int32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.rec_steps = static_cast<int32_t*>(rec_steps);
  a.rec_planes = static_cast<int32_t*>(rec_planes);
  a.h[0] = h1; a.h[1] = h2;
  a.lock[0] = lock1; a.lock[1] = lock2;
  a.R = R; a.W = W; a.C = C; a.L = L; a.A = A; a.MCN = MCN; a.IMBN = IMBN;
  a.E = (W - 2) / 2;
  a.me_budget = me_budget; a.other_cost = other_cost;
  a.other_len = other_len; a.delta = delta; a.l2 = l2;
  a.weighted = weighted; a.max_steps = max_steps;
  a.allow_records = allow_records; a.rec_min = rec_min; a.mc_dyn = mc_dyn;
  a.wc = wc; a.et = et;
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
  const size_t smem = smem_bytes(R, A);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        run_extend_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  run_extend_dual_kernel<<<1, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
