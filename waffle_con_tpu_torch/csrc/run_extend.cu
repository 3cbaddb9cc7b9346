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
// Design.  One CTA of 1024 threads per launch; the whole step loop runs
// inside it, so a run costs one launch and one host round trip, as on the
// TPU.  The band keeps the branch store's [R, W] layout: each read's
// column is contiguous, and a warp owns one read at a time (reads strided
// over the 32 warps); the per-read tip histogram and column step are the
// warp routines of csrc/band_ops.cuh, shared with the dual kernel.  A step is
// two passes over the band: the vote pass (tip histogram per read in
// shared memory, per-warp float32 partial sums in read order) and, once
// one thread has taken the decision, the column pass, which writes the
// new column into the other of two band buffers (slot h of the store and
// a scratch [R, W] buffer) so a step that overflows the band is simply
// never swapped in.
//
// What bounds it.  Each step reads the R x W int32 band twice and writes
// it once: about 1.5 MB at R = 256, W = 514, streamed by ONE SM from L2
// (the two buffers fit in L2), plus the per-step __syncthreads barriers
// of the decision.  A later design spreads the reads over a thread-block
// cluster or a cooperative grid (votes and folds reduced through
// distributed shared memory) and keeps the band on chip in int16.

#include <cuda_runtime.h>
#include <cstdint>

#include "band_ops.cuh"

namespace {

using band::kInf;
constexpr int kRecCap = 256;        // record buffer rows (REC_CAP)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kVoteEps = 0.01f;   // VOTE_EPS, float32(1e-2)

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
  int32_t* scratch;    // [R, W] second band buffer
  int32_t* out;        // packed outputs (run_kernel.out_layout)
  int32_t* rec_steps;  // [REC_CAP]
  int32_t* rec_fins;   // [REC_CAP, R]
  int h, R, W, C, L, A, E;
  int me_budget, other_cost, other_len, min_count, l2, max_steps;
  int first_sym, allow_records, wc, et;
  // offsets of the packed output fields
  int o_eds, o_split, o_reached, o_fin, o_occ, o_syms;
};

// Shared-memory working set (dynamic, carved in order by carve()).
struct Smem {
  int* e; int* rmin; int* er;        // [R] per-read folds of the current state
  int* e2; int* rmin2; int* er2;     // [R] folds after the column pass
  int* fin;                          // [R] finalized distances (vote pass)
  int* off; int* act; int* rlen;     // [R]
  int* hist;                         // [kWarps, A] tip histogram of a read
  float* pcount;                     // [kWarps, A] per-warp vote sums
  int* phas;                         // [kWarps, A] per-warp "has votes"
  float* counts;                     // [A]
  int* has;                          // [A]
  // per-warp folds of the vote pass
  unsigned* w_total; unsigned* w_fin_total;
  int* w_max_eds; int* w_max_fin; int* w_nonexact; int* w_notreached;
  int* w_reached; int* w_fin_ovf;
};

__host__ __device__ inline size_t smem_bytes(int R, int A) {
  return sizeof(int) * (10 * (size_t)R + 3 * (size_t)kWarps * A + 2 * (size_t)A +
                        8 * (size_t)kWarps);
}

__device__ inline Smem carve(char* base, int R, int A) {
  Smem s;
  int* p = reinterpret_cast<int*>(base);
  s.e = p; p += R; s.rmin = p; p += R; s.er = p; p += R;
  s.e2 = p; p += R; s.rmin2 = p; p += R; s.er2 = p; p += R;
  s.fin = p; p += R; s.off = p; p += R; s.act = p; p += R; s.rlen = p; p += R;
  s.hist = p; p += kWarps * A;
  s.pcount = reinterpret_cast<float*>(p); p += kWarps * A;
  s.phas = p; p += kWarps * A;
  s.counts = reinterpret_cast<float*>(p); p += A;
  s.has = p; p += A;
  s.w_total = reinterpret_cast<unsigned*>(p); p += kWarps;
  s.w_fin_total = reinterpret_cast<unsigned*>(p); p += kWarps;
  s.w_max_eds = p; p += kWarps; s.w_max_fin = p; p += kWarps;
  s.w_nonexact = p; p += kWarps; s.w_notreached = p; p += kWarps;
  s.w_reached = p; p += kWarps; s.w_fin_ovf = p; p += kWarps;
  return s;
}

// Vote pass at consensus length `clen`: per read, the tip histogram over
// the dense symbols (band cells with D <= e facing a real read base) and
// the per-read folds, reduced per warp.  `snap` also writes the final
// stats snapshot into the packed output.
__device__ void vote_pass(const Args& a, const Smem& s, const int32_t* Dcur,
                          int clen, bool snap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hist = s.hist + warp * a.A;
  float* pcount = s.pcount + warp * a.A;
  int* phas = s.phas + warp * a.A;
  unsigned tot = 0, ftot = 0;
  int mx_eds = 0, mx_fin = 0, nonexact = 0, notreached = 0, anyreached = 0;
  int fin_ovf = 0;
  for (int r = warp; r < a.R; r += kWarps) {
    const int act = s.act[r];
    const int e = s.e[r];
    const int split =
        act ? band::tip_histogram(Dcur + (size_t)r * a.W,
                                  a.reads + (size_t)r * a.L, a.W, s.rlen[r],
                                  clen - s.off[r] - a.E, e, hist)
            : 0;
    const float split_f = (float)max(split, 1);
    for (int sym = lane; sym < a.A; sym += 32) {
      const int c = hist[sym];
      if (split > 0) pcount[sym] += (float)c / split_f;
      if (c > 0) phas[sym] = 1;
      if (snap) a.out[a.o_occ + r * a.A + sym] = c;
      hist[sym] = 0;
    }
    __syncwarp();
    if (lane == 0) {
      const int rmin = s.rmin[r], er = s.er[r];
      const int eds = act ? e : 0;
      const int fin_u = max(e, rmin);
      const int fin = act ? min(fin_u, kInf) : 0;
      const int reached = act && er < kInf && e == er;
      s.fin[r] = fin;
      const unsigned ue = (unsigned)eds, uf = (unsigned)fin;
      tot += a.l2 ? ue * ue : ue;       // wrapping int32, as on the TPU
      ftot += a.l2 ? uf * uf : uf;
      mx_eds = max(mx_eds, eds);
      mx_fin = max(mx_fin, fin);
      nonexact |= split > 0 && (split & (split - 1)) != 0;
      notreached |= act && !reached;
      anyreached |= reached;
      fin_ovf |= act && fin_u >= a.E;
      if (snap) {
        a.out[a.o_eds + r] = eds;
        a.out[a.o_split + r] = split;
        a.out[a.o_reached + r] = reached;
        a.out[a.o_fin + r] = fin;
      }
    }
  }
  if (lane == 0) {
    s.w_total[warp] = tot;
    s.w_fin_total[warp] = ftot;
    s.w_max_eds[warp] = mx_eds;
    s.w_max_fin[warp] = mx_fin;
    s.w_nonexact[warp] = nonexact;
    s.w_notreached[warp] = notreached;
    s.w_reached[warp] = anyreached;
    s.w_fin_ovf[warp] = fin_ovf;
  }
}

// Column pass: advance every active read's band column from consensus
// length jnew - 1 to jnew by consuming `sym`, into Dnext; per-read folds
// into e2/rmin2/er2.  Returns (through *ovf) whether any active read's
// edit distance reached the band edge.
__device__ void column_pass(const Args& a, const Smem& s,
                            const int32_t* Dcur, int32_t* Dnext, int jnew,
                            int sym, int* ovf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < a.R; r += kWarps) {
    if (!s.act[r]) continue;
    const band::Folds3 f = band::column_step(
        Dcur + (size_t)r * a.W, Dnext + (size_t)r * a.W,
        a.reads + (size_t)r * a.L, a.W, a.L, s.rlen[r],
        jnew - s.off[r] - a.E, sym, a.wc, a.et,
        band::Folds3{s.e[r], s.rmin[r], s.er[r]});
    if (lane == 0) {
      s.e2[r] = f.e;
      s.rmin2[r] = f.rmin;
      s.er2[r] = f.er;
      if (f.e >= a.E) *ovf = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) run_extend_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, a.R, a.A);
  __shared__ int32_t* buf[2];
  __shared__ int s_cur, s_clen, s_steps, s_code, s_sym, s_rec_count;
  __shared__ int s_budget, s_fin_total, s_reached_here, s_ovf, s_commit;
  __shared__ int s_do_rec, s_ri;
  const int tid = threadIdx.x;
  const size_t RW = (size_t)a.R * a.W;
  int32_t* Dstate = a.D + (size_t)a.h * RW;

  for (int r = tid; r < a.R; r += kThreads) {
    const size_t hr = (size_t)a.h * a.R + r;
    s.e[r] = a.e[hr];
    s.rmin[r] = a.rmin[hr];
    s.er[r] = a.er[hr];
    s.off[r] = a.off[hr];
    s.act[r] = a.act[hr] != 0;
    s.rlen[r] = a.rlen[r];
  }
  for (int i = tid; i < kWarps * a.A; i += kThreads) {
    s.hist[i] = 0;
    s.pcount[i] = 0.f;
    s.phas[i] = 0;
  }
  if (tid == 0) {
    buf[0] = Dstate;
    buf[1] = a.scratch;
    s_cur = 0;
    s_clen = a.clen[a.h];
    s_steps = 0;
    s_code = 0;
    s_rec_count = 0;
    s_budget = a.me_budget;
    s_ovf = 0;
  }
  __syncthreads();
  // inactive reads never change: the scratch buffer carries their rows too
  for (int r = 0; r < a.R; ++r) {
    if (s.act[r]) continue;
    for (int t = tid; t < a.W; t += kThreads)
      a.scratch[(size_t)r * a.W + t] = Dstate[(size_t)r * a.W + t];
  }

  // ---- forced first push (host-nominated child): only band overflow
  // refuses it
  if (a.first_sym >= 0) {
    column_pass(a, s, buf[0], buf[1], s_clen + 1, a.first_sym, &s_ovf);
    __syncthreads();
    if (tid == 0) {
      s_commit = !s_ovf;
      if (s_ovf) {
        s_code = 5;
      } else {
        a.cons[(size_t)a.h * a.C + s_clen] = a.first_sym;
        a.out[a.o_syms] = a.first_sym;
        s_steps = 1;
        s_clen += 1;
        s_cur = 1;
      }
    }
    __syncthreads();
    if (s_commit) {
      for (int r = tid; r < a.R; r += kThreads) {
        if (!s.act[r]) continue;
        s.e[r] = s.e2[r];
        s.rmin[r] = s.rmin2[r];
        s.er[r] = s.er2[r];
      }
    }
  }

  // ---- one consensus symbol per iteration until a stop code
  while (true) {
    __syncthreads();
    if (s_code != 0) break;
    const int cur = s_cur;
    const int clen = s_clen;
    vote_pass(a, s, buf[cur], clen, false);
    __syncthreads();
    for (int sym = tid; sym < a.A; sym += kThreads) {
      float c = 0.f;
      int hv = 0;
      for (int w = 0; w < kWarps; ++w) {
        c += s.pcount[w * a.A + sym];
        hv |= s.phas[w * a.A + sym];
        s.pcount[w * a.A + sym] = 0.f;
        s.phas[w * a.A + sym] = 0;
      }
      s.counts[sym] = c;
      s.has[sym] = hv;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned total = 0, fin_total = 0;
      int mx_eds = 0, mx_fin = 0, nonexact = 0, notreached = 0, anyreached = 0;
      for (int w = 0; w < kWarps; ++w) {
        total += s.w_total[w];
        fin_total += s.w_fin_total[w];
        mx_eds = max(mx_eds, s.w_max_eds[w]);
        mx_fin = max(mx_fin, s.w_max_fin[w]);
        nonexact |= s.w_nonexact[w];
        notreached |= s.w_notreached[w];
        anyreached |= s.w_reached[w];
      }
      const int itotal = (int)total;
      const bool cost_overflow = a.l2 && mx_eds > 2048;
      const bool fin_ovf_j = mx_fin >= a.E;
      const bool fin_cost_ovf = a.l2 && mx_fin > 2048;
      const bool all_exact = !nonexact;
      const bool reached_here = a.et ? !notreached : anyreached != 0;

      // nomination: fractional votes, wildcard drop, EPS near-tie guard,
      // first-max tie-break
      int n_cands = 0;
      for (int sym = 0; sym < a.A; ++sym) n_cands += s.has[sym] != 0;
      if (a.wc >= 0 && n_cands > 1) {
        s.has[a.wc] = 0;
        s.counts[a.wc] = 0.f;
      }
      float maxc = -1.f;
      for (int sym = 0; sym < a.A; ++sym)
        maxc = fmaxf(maxc, s.has[sym] ? s.counts[sym] : -1.f);
      const float mcf = (float)a.min_count;
      const float thr = fminf(mcf, maxc);
      int npass = 0, sym_best = 0;
      bool near_any = false;
      float best = -1.f;
      for (int sym = 0; sym < a.A; ++sym) {
        const bool hv = s.has[sym] != 0;
        const bool passing = hv && s.counts[sym] >= thr;
        npass += passing;
        near_any = near_any || (hv && fabsf(s.counts[sym] - thr) < kVoteEps);
        const float ca = passing ? s.counts[sym] : -1.f;
        if (ca > best) {
          sym_best = sym;
          best = ca;
        }
      }
      const bool near_tie = fabsf(maxc - mcf) < kVoteEps || near_any;
      const bool dirty = (!all_exact && near_tie) || npass != 1 ||
                         n_cands == 0 || cost_overflow;
      const bool rec_blocked = !a.allow_records || fin_ovf_j ||
                               fin_cost_ovf || s_rec_count >= kRecCap;
      const bool wins_pop =
          itotal < a.other_cost ||
          (itotal == a.other_cost && clen > a.other_len);
      int code = 0;
      if (itotal > s_budget || !wins_pop) code = 3;
      else if (reached_here && rec_blocked) code = 2;
      else if (dirty) code = 1;
      else if (s_steps >= a.max_steps) code = 4;
      s_code = code;
      s_sym = sym_best;
      s_reached_here = reached_here;
      s_fin_total = (int)fin_total;
      s_ovf = 0;
    }
    __syncthreads();
    if (s_code != 0) break;
    column_pass(a, s, buf[cur], buf[cur ^ 1], clen + 1, s_sym, &s_ovf);
    __syncthreads();
    if (tid == 0) {
      s_commit = !s_ovf;
      s_do_rec = 0;
      if (s_ovf) {
        s_code = 5;
      } else {
        a.cons[(size_t)a.h * a.C + clen] = s_sym;
        a.out[a.o_syms + s_steps] = s_sym;
        if (s_reached_here) {
          // record of the popped (pre-push) state
          s_do_rec = 1;
          s_ri = min(s_rec_count, kRecCap - 1);
          a.rec_steps[s_ri] = s_steps;
          s_rec_count += 1;
          if (s_fin_total < s_budget) s_budget = s_fin_total;
        }
        s_steps += 1;
        s_clen = clen + 1;
        s_cur = cur ^ 1;
      }
    }
    __syncthreads();
    if (s_commit) {
      for (int r = tid; r < a.R; r += kThreads) {
        if (s_do_rec) a.rec_fins[(size_t)s_ri * a.R + r] = s.fin[r];
        if (!s.act[r]) continue;
        s.e[r] = s.e2[r];
        s.rmin[r] = s.rmin2[r];
        s.er[r] = s.er2[r];
      }
    }
  }

  // ---- final snapshot and write-back of slot h
  const int cur = s_cur;
  vote_pass(a, s, buf[cur], s_clen, true);
  __syncthreads();
  if (tid == 0) {
    int fin_ovf = 0;
    for (int w = 0; w < kWarps; ++w) fin_ovf |= s.w_fin_ovf[w];
    a.out[0] = s_steps;
    a.out[1] = s_code;
    a.out[2] = s_rec_count;
    a.out[3] = fin_ovf;
    a.out[4] = s_clen;
    a.out[5] = a.out[6] = a.out[7] = 0;
    a.clen[a.h] = s_clen;
  }
  if (cur == 1) {
    for (size_t i = tid; i < RW; i += kThreads) Dstate[i] = a.scratch[i];
  }
  for (int r = tid; r < a.R; r += kThreads) {
    const size_t hr = (size_t)a.h * a.R + r;
    a.e[hr] = s.e[r];
    a.rmin[hr] = s.rmin[r];
    a.er[hr] = s.er[r];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one CTA on `stream`
// and returns cudaGetLastError() (0 on success); the launch does not
// synchronise.
extern "C" int run_extend_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* scratch, void* out,
    void* rec_steps, void* rec_fins, int h, int R, int W, int C, int L,
    int A, int me_budget, int other_cost, int other_len, int min_count,
    int l2, int max_steps, int first_sym, int allow_records, int wc, int et,
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
  // packed output layout (mirrors run_kernel.out_layout)
  a.o_eds = 8;
  a.o_split = a.o_eds + R;
  a.o_reached = a.o_split + R;
  a.o_fin = a.o_reached + R;
  a.o_occ = a.o_fin + R;
  a.o_syms = a.o_occ + R * A;
  const size_t smem = smem_bytes(R, A);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        run_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  run_extend_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
