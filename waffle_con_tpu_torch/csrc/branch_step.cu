// Branch life-cycle calls of the branch store, for Hopper (sm_90a).
//
// Replaces the XLA functions of waffle_con_tpu/ops/jax_scorer.py that
// root, copy, advance, deactivate and read branch slots: `_j_root`
// (:506), `_j_clone_batch` (:537), `_j_deactivate_batch` (:557),
// `_j_push_batch` (:629), `_j_clone_push_batch` (:683), `_j_stats` (:754)
// and `_j_finalize` (:821).  Call for call it computes what the plain
// twins of waffle_con_tpu_torch/ops/branch_kernel.py compute from
// torch_scorer.py's column primitives.
//
// What bounds it.  A call is a batch of n rows (src, dst, sym), each one
// DP column step of R reads x W band cells (~20 int32 operations a cell),
// the tip histogram and a few folds a read.  Its bound is the band read
// and written once, a microsecond or less at the tracked shapes, so a
// call's time is its launches, the bytes it moves more than once and the
// host's work around it.  The design makes one launch a batch where the
// batch fits, reads each band once and writes only what changes.
//
// Contracts.  Every src row is read before any dst row is written (a row
// may write the slot another row copies from: an expansion pushes its
// source in place beside the clones).  Nothing commits when a pushed
// active read reaches the band edge (e >= E): the batch's overflow word.
// Stats come back in one packed output that the host fetches in one copy.
// The output's flags hold the epoch of the call that set them (a number
// above every other output value, new each call), so no launch clears
// them.  Two options serve the sharded column step (parallel/mesh.py's
// `sharded_col_step`, the counterpart of JAX's parallel/mesh.py:284):
// `force` commits a batch even when it overflows (the step's outputs are
// wanted whatever the overflow says), and `part` (three device words,
// zeroed before the launch) gathers the call's partials as the stats are
// written: the sum of the active reads' edit distances, whether any read
// reached its end and whether any pushed read overflowed; integer atomics,
// so the words are the same in any order of the warps (the sum is exact).
//
// Read shards (ops/sharded_scorer.py's fused route).  A call may cover up
// to kMaxShards read shards of one sharded store that sit on this card:
// each shard its own store (`Shard`: its addresses, its reads and rlen),
// all of one geometry (B, R/S, W, C, L).  The warps of every (row, shard,
// read) are one grid, read-major inside a row, so warp w of the call is
// output column w of a store of S x R/S reads: the packed output is the
// one the shards' outputs merged in read order would give, written once.
// The shards share the call's overflow word, so the barrier then the
// commit test makes the step all or nothing across the shards inside the
// kernel, and they share `part`.  One store is the case S = 1.
//
// Two plans (`plan_branch` in ops/branch_kernel.py, picked before the
// launch from the shape and the card's occupancy):
//  * one_launch (W <= 544, every warp of the batch resident at once):
//    branch_one_kernel, one warp a (row, read), 16 warps a CTA.  The warp
//    loads its src band row once into registers, a run of `C` cells a
//    lane (col_replay.cu's layout, C in 1, 2, 3, 5, 9, 17), and steps it
//    there: the diagonal and deletion terms from the lane's own cells and
//    lane + 1's first, the insertion chain by one warp scan of the run
//    minima.  The row is read and written coalesced, through the warp's
//    row of shared memory (32 C words).  The tip histogram of the new
//    column (or of the current one, for stats and copies with stats) goes
//    to the warp's histogram row in shared memory (A words) and is
//    written to the output's occ row once.  A pushed read that overflows
//    writes the epoch into the overflow word, then the batch meets one
//    barrier: a cooperative launch's grid barrier (at the tracked shapes
//    as fast as one thread-block cluster's, which would take only batches
//    of up to 16 CTAs).  After it, unless the word holds this call's
//    epoch, each warp writes its registers straight into its dst slot:
//    a pushed active read its new band and folds, a copy (src != dst) the
//    band and fields it read; an inactive read or a row in place without
//    a push writes nothing of the band, and an in-place push writes one
//    consensus symbol and the length.  A copy's consensus row is staged in
//    a scratch row by the threads that write it back, so it too is read
//    before the barrier.  Stats and finalize take the same kernel with no
//    barrier and no write.
//  * slab (wider bands, or a batch whose warps cannot all be resident):
//    branch_rows_kernel, one warp a (row, read) with both columns in
//    device memory (band_ops.cuh's `column_step_runs`, so any W and any
//    alphabet take the same code), a pushed read's new band and a copy's
//    band into a scratch slab, then branch_commit_kernel, gated on the
//    overflow word, copies into each dst (row, read) only what changed.
// The work is a column recurrence on int32 and each warp reads one
// contiguous band row (2 KB at W = 514) once, coalesced: there is no
// matrix product for wgmma and no tile worth a TMA descriptor, so neither
// is used.
//  * root: one warp a read writes the fresh column; deactivate: one
//    thread a (slot, read) pair.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "band_ops.cuh"

// One call as the host describes it (ops/branch_kernel.py's `_Call`,
// field for field), the argument of the C entry `branch_rows_launch` (so
// outside the unnamed namespace: the entry must keep external linkage).
struct BranchCall {
  void* D;
  void* e;
  void* rmin;
  void* er;
  void* off;
  void* act;
  void* cons;
  void* clen;
  void* reads;
  void* rlen;
  void* rows;       // device rows [3, n]
  void* rows_host;  // pinned host rows [3, n]
  void* out;        // device packed output (null: no stats)
  void* out_host;   // pinned host output: one_launch writes it, the slab
                    // plan's output is copied into it
  void* flag;       // device word: the batch's overflow epoch
  void* slab;
  void* event;      // the store's event (branch_event)
  void* stream;
  void* part;       // device partials [3] (null: none; needs `out`)
  void* shard_ptrs; // host array of `shards` BranchShard (null: one store,
                    // the addresses above)
  int B, R, W, C, L;
  int n, A, wc, et, mode, votes, epoch;
  int plan, cells, warps, blocks, smem, commit_blocks, commit_rows;
  int out_words;    // words fetched into out_host
  int force;        // commit even when the batch overflows
  int shards;       // read shards of the call (R each); 1: one store
  int defer;        // with out_host: return once the output is queued, the
                    // caller waits on the event (branch_event_sync)
};

// One read shard's store and reads, as the host lists them for a call on
// several shards (ops/branch_kernel.py's `_Shard`, field for field).
struct BranchShard {
  void* D;
  void* e;
  void* rmin;
  void* er;
  void* off;
  void* act;
  void* cons;
  void* clen;
  void* reads;
  void* rlen;
};

namespace {

namespace cg = cooperative_groups;
using band::Folds3;
using band::kFull;
using band::kInf;

constexpr int kSlabWarps = 8;   // warps of a CTA of branch_rows / root
constexpr int kOneWarps = 16;   // warps of a CTA of branch_one
constexpr int kMaxShards = 16;  // branch_kernel.MAX_SHARDS

enum PlanId { kPlanSlab = 0, kPlanOne = 1 };

// Symbols of one read as the plain twin gathers them (torch_scorer.py's
// `gather_window`, JAX's `take_along_axis` over clipped positions):
// positions clamped into [0, L).  It differs from band::GlobalWindow
// (-1 outside) only where a finite cell faces position -1: a read whose
// anchor lies past its branch's length, stepped before it (no engine
// makes such a call; tests/test_torch_window_edge.py).
struct ClampedWindow {
  const int16_t* rd;
  int L;
  __device__ __forceinline__ int operator()(int i) const {
    return rd[min(max(i, 0), L - 1)];
  }
};

// The branch store: D [B, R, W], e/rmin/er/off/act [B, R], cons [B, C],
// clen [B].
struct Store {
  int32_t* D;
  int32_t* e;
  int32_t* rmin;
  int32_t* er;
  int32_t* off;
  uint8_t* act;
  int32_t* cons;
  int32_t* clen;
  int B, R, W, C, E;
};

// One read shard of a launch: its store (R = the shard's reads) and its
// reads.
struct Shard {
  Store s;
  const int16_t* reads;  // [R, L], -1 past a read's end
  const int32_t* rlen;   // [R]
};

// A launch's arguments, passed as a __grid_constant__ parameter (1.8 KB
// with kMaxShards shards, under the 4 KB limit).  Warp w of a call is
// (row k, read rg) of the output's [n, Ro] layout, read rg = shard
// rg / Rs, read rg % Rs of it.
struct RowsArgs {
  Shard sh[kMaxShards];
  const int32_t* rows;   // [3, n]: src slot, dst slot, symbol (-1: copy)
  int32_t* out;          // packed output (null: no stats)
  int32_t* flag;         // device copy of the batch's overflow word
  int32_t* slab;         // slab plan: the advance's scratch; one_launch:
                         // the copies' staged consensus rows [S, n, C]
  int32_t* part;         // partials: edit-distance sum, reached, overflow
  int shards, Rs, Ro;    // shards S, reads a shard, reads of the call
  int n, L, A, wc, et, votes, mode, epoch, force;
};

// Where warp (row k, output read rg) of a call lives: its shard, the read
// in that shard.
struct Where {
  int k, si, r;
  __device__ __forceinline__ Where(const RowsArgs& a, long long w) {
    k = (int)(w / a.Ro);
    const int rg = (int)(w % a.Ro);
    si = rg / a.Rs;
    r = rg - si * a.Rs;
  }
};

// One store's warp (a call on one shard): shard 0, known at compile time.
struct WhereOne {
  int k, si, r;
  __device__ __forceinline__ WhereOne(const RowsArgs& a, long long w) {
    k = (int)(w / a.Rs);
    si = 0;
    r = (int)(w % a.Rs);
  }
};

// Packed output (branch_kernel.unpack): eds, split, reached and fin
// [n, R] each, fin_ovf [n], the batch's overflow word, then occ [n, R, A].
// A flag is set when it holds the call's epoch.
__host__ __device__ inline size_t flags_at(int n, int R) {
  return 4 * (size_t)n * R;
}
__host__ __device__ inline size_t occ_at(int n, int R) {
  return flags_at(n, R) + n + 1;
}

// Scratch of the slab plan's advance (branch_kernel.slab_words): D [n, Ro,
// W], then e, rmin, er, off, act [n, Ro] each, cons [S, n, C] and clen [S,
// n].
struct Slab {
  int32_t* D;
  int32_t* folds;
  int32_t* cons;
  int32_t* clen;
  __device__ Slab(int32_t* base, const RowsArgs& a) {
    const Store& s = a.sh[0].s;
    const size_t nR = (size_t)a.n * a.Ro;
    D = base;
    folds = base + nR * s.W;
    cons = folds + 5 * nR;
    clen = cons + (size_t)a.shards * a.n * s.C;
  }
};

// Lane 0's stats of (row k, read r) = warp w of the batch (of R = the
// call's reads), at the row's new length; a finalized distance outside the
// band and a pushed read's overflow set their flags to the call's epoch.
// With `part`, the read's share of the call's partials.
__device__ __forceinline__ void write_stats(const RowsArgs& a, int R,
                                            long long w, int k, int act,
                                            Folds3 f, int split,
                                            bool stepped) {
  const int n = a.n, E = a.sh[0].s.E;
  const size_t nR = (size_t)n * R;
  int32_t* o = a.out;
  o[w] = act ? f.e : 0;
  o[nR + w] = split;
  o[2 * nR + w] = act && f.er < kInf && f.e == f.er;
  const int fin = max(f.e, f.rmin);
  o[3 * nR + w] = act ? min(fin, kInf) : 0;
  if (act && fin >= E) o[flags_at(n, R) + k] = a.epoch;
  if (stepped && f.e >= E) {
    o[flags_at(n, R) + n] = a.epoch;
    *a.flag = a.epoch;
  }
  if (a.part != nullptr) {
    if (act) atomicAdd(&a.part[0], f.e);
    if (act && f.er < kInf && f.e == f.er) atomicOr(&a.part[1], 1);
    if (stepped && f.e >= E) atomicOr(&a.part[2], 1);
  }
}

// ---------------------------------------------------------------------
// one_launch: the band row in registers

// One DP column of one read with the lane's cells [ta, ta + C) in
// registers `u` (cells past W hold kInf and take no part), ta = lane * C:
// what band_ops.cuh's `column_step_runs` computes, cell for cell.  `rd`
// is the read's symbol row, the window starts at read position i0 for
// cell 0.  With `hist` (the warp's shared row) the tip histogram of the
// new column goes there and its size to *split.  Returns the new folds.
template <int C>
__device__ __forceinline__ Folds3 step_regs(int (&u)[C], const int16_t* rd,
                                            int L, int W, int rl, int i0,
                                            int sym, int wc, int et,
                                            Folds3 f, int* hist,
                                            int* split) {
  const int lane = threadIdx.x & 31;
  const int ta = lane * C;
  // symbols at read positions i0 - 1 + ta + q, clamped as the twin's
  // gather: cell q compares ch[q] and votes for ch[q + 1]
  int ch[C + 1];
#pragma unroll
  for (int q = 0; q <= C; ++q) {
    ch[q] = rd[min(max(i0 - 1 + ta + q, 0), L - 1)];
  }
  // the old column's cell above the lane's run: lane + 1's first cell
  int above = __shfl_down_sync(kFull, u[0], 1);
  if (lane == 31) above = kInf;
  int run = INT_MAX;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int t = ta + q;
    const int d_next = q + 1 < C ? u[q + 1] : above;
    const int i_new = i0 + t;
    const int sub = ch[q] != sym && ch[q] != wc;
    int base = min(u[q] + sub, d_next + 1);
    if ((unsigned)i_new > (unsigned)rl) base = kInf;  // i_new < 0 or > rl
    if (t < W) {
      u[q] = base;
      run = min(run, base - t);
    }
  }
  // the chain entering this lane: the minimum over the lanes below (a
  // shuffle from below lane 0 returns the lane's own value)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    run = min(run, __shfl_up_sync(kFull, run, o));
  }
  int x = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) x = INT_MAX;
  int colmin = kInf, rend = kInf;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int t = ta + q;
    if (t < W) {
      const int base = u[q];
      x = min(x, base - t);
      const int dn = min(min(base, x + t), kInf);
      u[q] = dn;
      colmin = min(colmin, dn);
      if (i0 + t == rl) rend = min(rend, dn);
    }
  }
  colmin = __reduce_min_sync(kFull, colmin);
  rend = __reduce_min_sync(kFull, rend);
  const int rmin_n = min(f.rmin, rend);
  const int e_unc = max(f.e, colmin);
  const int e_cap =
      f.er < kInf ? f.e : max(f.e, min(colmin, max(f.e, rmin_n)));
  const int e_n = et ? e_cap : e_unc;
  const int er_n =
      f.er < kInf ? f.er : (rmin_n <= e_n ? max(f.e, rmin_n) : kInf);
  if (hist != nullptr) {
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = i0 + ta + q;
      if (ta + q < W && (unsigned)i < (unsigned)rl && u[q] <= e_n) {
        atomicAdd(&hist[ch[q + 1]], 1);
        ++cnt;
      }
    }
    *split = __reduce_add_sync(kFull, cnt);
  }
  return Folds3{e_n, rmin_n, er_n};
}

// Tip histogram of the column in registers (cells with D <= e facing a
// real read base, the window starting at read position i0): band_ops.cuh's
// `tip_histogram_win`.  Returns the number of tips in every lane.
template <int C>
__device__ __forceinline__ int tips_regs(const int (&u)[C], const int16_t* rd,
                                         int W, int rl, int i0, int e,
                                         int* hist) {
  const int ta = (threadIdx.x & 31) * C;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int i = i0 + ta + q;
    if (ta + q < W && (unsigned)i < (unsigned)rl && u[q] <= e) {
      atomicAdd(&hist[rd[i]], 1);
      ++cnt;
    }
  }
  return __reduce_add_sync(kFull, cnt);
}

// One launch a batch: warp w = (row k, read r).  Without kCommit it
// reads stats (mode 1) and writes nothing else; with it (a cooperative
// launch) it advances or copies (mode 0) and commits after the grid
// barrier.  kShards: the call covers several shards, each warp's store
// picked at run time; without it the one store is shard 0 at compile
// time, so a call on one store keeps the registers, and so the CTAs an
// SM holds, of the kernel before shards.
template <int C, bool kCommit, bool kShards>
__global__ void __launch_bounds__(kOneWarps * 32)
    branch_one_kernel(const __grid_constant__ RowsArgs a) {
  // [warps][32 C] band rows, then [warps][A] histograms: a row a warp
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const int n = a.n, R = a.Rs, W = a.sh[0].s.W, E = a.sh[0].s.E;
  const int Ro = kShards ? a.Ro : R;  // the call's reads
  const bool valid = w < (long long)n * Ro;  // the whole warp
  const int ta = lane * C;
  int k = 0, r = 0, si = 0, src = 0, dst = 0, sym = -1, act = 0, off = 0;
  int cl = 0;
  bool push = false, moved = false;
  Folds3 f{0, 0, 0};
  int u[C];
  if (valid) {
    using At = std::conditional_t<kShards, Where, WhereOne>;
    const At at(a, w);
    k = at.k;
    si = at.si;
    r = at.r;
    const Shard& S = a.sh[kShards ? si : 0];
    const Store& s = S.s;
    const int32_t* rows = a.rows;
    src = rows[k];
    dst = rows[n + k];
    sym = rows[2 * n + k];
    push = a.mode == 0 && sym >= 0;
    moved = a.mode == 0 && src != dst;
    const size_t sr = (size_t)src * R + r;
    act = s.act[sr];
    off = s.off[sr];
    cl = s.clen[src];
    f = Folds3{s.e[sr], s.rmin[sr], s.er[sr]};
    const int rl = S.rlen[r];
    const bool votes = a.out != nullptr && a.votes;
    const bool step = push && act;
    const bool tips = votes && act && !step;
    // the band row, read once: for a step, the tips or a copy
    const int32_t* Do = s.D + sr * W;
    const bool need = step || tips || moved;
    // read coalesced, through the warp's row of shared memory
    int* band_s = smem + warp * 32 * C;
    if (need) {
      for (int t = lane; t < W; t += 32) band_s[t] = Do[t];
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      u[q] = need && ta + q < W ? band_s[ta + q] : kInf;
    }
    int* hist = smem + (blockDim.x >> 5) * 32 * C + warp * a.A;
    if (votes) {
      for (int q = lane; q < a.A; q += 32) hist[q] = 0;
      __syncwarp();
    }
    const int16_t* rd = S.reads + (size_t)r * a.L;
    int split = 0;
    if (step) {
      f = step_regs<C>(u, rd, a.L, W, rl, cl + 1 - off - E, sym, a.wc, a.et,
                       f, votes ? hist : nullptr, &split);
    } else if (tips) {
      split = tips_regs<C>(u, rd, W, rl, cl - off - E, f.e, hist);
    }
    if (a.out != nullptr) {
      if (votes) {
        __syncwarp();
        int32_t* occ = a.out + occ_at(n, Ro) + (size_t)w * a.A;
        for (int q = lane; q < a.A; q += 32) occ[q] = hist[q];
      }
      if (lane == 0) write_stats(a, Ro, w, k, act, f, split, step);
    }
    // a copy's consensus row, staged by the threads that write it back
    if (kCommit && moved) {
      const int32_t* cons = s.cons + (size_t)src * s.C;
      int32_t* stage = a.slab + ((size_t)si * n + k) * s.C;
      for (long long c = (long long)r * 32 + lane; c < s.C;
           c += (long long)R * 32) {
        stage[c] = cons[c];
      }
    }
  }
  if constexpr (!kCommit) {
    return;
  } else {
    // every src row of the batch (of every shard) is read, and every
    // overflow flagged
    cg::this_grid().sync();
    if (!valid) return;
    if (a.out != nullptr && !a.force && __ldcg(a.flag) == a.epoch) {
      return;  // a pushed read reached the band: nothing commits
    }
    const Store& s = a.sh[kShards ? si : 0].s;
    const size_t dr = (size_t)dst * R + r;
    if ((push && act) || moved) {
      // written coalesced, through the warp's row of shared memory
      int* band_s = smem + warp * 32 * C;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (ta + q < W) band_s[ta + q] = u[q];
      }
      __syncwarp();
      int32_t* Dd = s.D + dr * W;
      for (int t = lane; t < W; t += 32) Dd[t] = band_s[t];
      if (lane == 0) {
        s.e[dr] = f.e;
        s.rmin[dr] = f.rmin;
        s.er[dr] = f.er;
        if (moved) {
          s.off[dr] = off;
          s.act[dr] = (uint8_t)act;
        }
      }
    }
    const int cpos = min(max(cl, 0), s.C - 1);
    int32_t* cons = s.cons + (size_t)dst * s.C;
    if (moved) {
      const int32_t* stage = a.slab + ((size_t)si * n + k) * s.C;
      for (long long c = (long long)r * 32 + lane; c < s.C;
           c += (long long)R * 32) {
        cons[c] = push && c == cpos ? sym : stage[c];
      }
    } else if (push && r == 0 && lane == 0) {
      cons[cpos] = sym;
    }
    if (r == 0 && lane == 0 && (push || moved)) {
      s.clen[dst] = push ? cl + 1 : cl;
    }
  }
}

// ---------------------------------------------------------------------
// slab: the band in device memory, a commit launch

__global__ void __launch_bounds__(kSlabWarps * 32)
    branch_rows_kernel(const __grid_constant__ RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int n = a.n, R = a.Rs;
  if (w >= (long long)n * a.Ro) return;  // the whole warp
  const Where at(a, w);
  const int k = at.k, si = at.si, r = at.r;
  const Shard& S = a.sh[si];
  const Store& s = S.s;
  const int W = s.W, E = s.E;
  const int32_t* rows = a.rows;
  const int src = rows[k], dst = rows[n + k], sym = rows[2 * n + k];
  const bool push = a.mode == 0 && sym >= 0;
  const bool moved = a.mode == 0 && src != dst;
  const size_t sr = (size_t)src * R + r;
  const int rl = S.rlen[r], off = s.off[sr], act = s.act[sr];
  const int cl = s.clen[src];
  const bool step = push && act;
  const int32_t* Do = s.D + sr * W;
  const ClampedWindow win{S.reads + (size_t)r * a.L, a.L};
  Folds3 f{s.e[sr], s.rmin[sr], s.er[sr]};
  int* hist = nullptr;
  if (a.out != nullptr && a.votes) {
    hist = a.out + occ_at(n, a.Ro) + (size_t)w * a.A;
    for (int q = lane; q < a.A; q += 32) hist[q] = 0;
    __syncwarp();
  }
  const bool votes = hist != nullptr && act;
  int split = 0;
  if (a.mode == 0) {
    const Slab sl(a.slab, a);
    int32_t* Dn = sl.D + (size_t)w * W;
    if (step) {
      const int i0 = cl + 1 - off - E;
      if (votes) {
        f = band::column_step_runs<ClampedWindow, true>(
            Do, Dn, win, W, rl, i0, sym, a.wc, a.et, f, hist, &split);
      } else {
        f = band::column_step_runs<ClampedWindow, false>(
            Do, Dn, win, W, rl, i0, sym, a.wc, a.et, f, nullptr, nullptr);
      }
    } else {
      // a copy carries its band through the slab; a row in place keeps
      // its own
      if (moved) {
        for (int t = lane; t < W; t += 32) Dn[t] = Do[t];
      }
      if (votes) {
        split = band::tip_histogram_win(Do, win, W, rl, cl - off - E, f.e,
                                        hist);
      }
    }
    const size_t nR = (size_t)n * a.Ro;
    if (lane == 0) {
      sl.folds[w] = f.e;
      sl.folds[nR + w] = f.rmin;
      sl.folds[2 * nR + w] = f.er;
      sl.folds[3 * nR + w] = off;
      sl.folds[4 * nR + w] = act;
    }
    // a copy's consensus row, spread over its shard's R warps
    const size_t row = (size_t)si * n + k;
    if (moved) {
      const int32_t* cons = s.cons + (size_t)src * s.C;
      int32_t* cons_n = sl.cons + row * s.C;
      for (long long c = (long long)r * 32 + lane; c < s.C;
           c += (long long)R * 32) {
        cons_n[c] = cons[c];
      }
    }
    if (r == 0 && lane == 0) sl.clen[row] = cl;
  } else if (votes) {
    split = band::tip_histogram_win(Do, win, W, rl, cl - off - E, f.e, hist);
  }
  if (a.out == nullptr || lane != 0) return;
  write_stats(a, a.Ro, w, k, act, f, split, step);
}

// The slab into the dst slots, unless the batch's overflow word holds the
// call's epoch (and the call does not `force`): (row, read) pairs over
// gridDim.y, a pair's words over the CTAs of gridDim.x.  A pair writes its
// band and folds only when its read was pushed active or its row copies
// (src != dst); an in-place push writes one consensus symbol.
__global__ void __launch_bounds__(256)
    branch_commit_kernel(const __grid_constant__ RowsArgs a) {
  const int n = a.n, R = a.Rs, W = a.sh[0].s.W;
  if (a.out != nullptr && !a.force && *a.flag == a.epoch) return;
  const Slab sl(a.slab, a);
  const size_t nR = (size_t)n * a.Ro;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t p = blockIdx.y; p < nR; p += gridDim.y) {
    const Where at(a, (long long)p);
    const int k = at.k, r = at.r;
    const Store& s = a.sh[at.si].s;
    const int32_t* rows = a.rows;
    const int src = rows[k], dst = rows[n + k], sym = rows[2 * n + k];
    const bool push = sym >= 0, moved = src != dst;
    const int act = sl.folds[4 * nR + p];
    const size_t d = (size_t)dst * R + r;
    if ((push && act) || moved) {
      int32_t* D = s.D + d * W;
      const int32_t* Ds = sl.D + p * W;
      for (size_t i = tid; i < (size_t)W; i += stride) D[i] = Ds[i];
      if (tid == 0) {
        s.e[d] = sl.folds[p];
        s.rmin[d] = sl.folds[nR + p];
        s.er[d] = sl.folds[2 * nR + p];
        if (moved) {
          s.off[d] = sl.folds[3 * nR + p];
          s.act[d] = (uint8_t)act;
        }
      }
    }
    if (r != 0) continue;
    const size_t row = (size_t)at.si * n + k;
    const int cl = sl.clen[row];
    const size_t cpos = (size_t)min(max(cl, 0), s.C - 1);
    int32_t* cons = s.cons + (size_t)dst * s.C;
    if (moved) {
      const int32_t* cs = sl.cons + row * s.C;
      for (size_t c = tid; c < (size_t)s.C; c += stride) {
        cons[c] = push && c == cpos ? sym : cs[c];
      }
    } else if (push && tid == 0) {
      cons[cpos] = sym;
    }
    if (tid == 0 && (push || moved)) s.clen[dst] = push ? cl + 1 : cl;
  }
}

// A root launch's arguments: the shards' stores and rlen (Shard.reads is
// not read), the mask act_in [S x R] of the call's reads, the slot.
struct RootArgs {
  Shard sh[kMaxShards];
  const uint8_t* act_in;
  int shards, slot;
};

// The fresh column of every read of `slot` (torch_scorer.init_col at
// off = 0) in every shard, one warp a read.
__global__ void __launch_bounds__(kSlabWarps * 32)
    branch_root_kernel(const __grid_constant__ RootArgs a) {
  const int lane = threadIdx.x & 31;
  const long long rg =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int R = a.sh[0].s.R;
  if (rg >= (long long)a.shards * R) return;
  const int si = (int)(rg / R), r = (int)(rg % R);
  const Store& s = a.sh[si].s;
  const size_t sr = (size_t)a.slot * R + r;
  const int act = a.act_in[rg], rl = a.sh[si].rlen[r], E = s.E;
  int32_t* D = s.D + sr * s.W;
  for (int t = lane; t < s.W; t += 32) {
    const int i0 = t - E;
    D[t] = act && i0 >= 0 && i0 <= rl ? i0 : kInf;
  }
  if (lane != 0) return;
  const int rmin = act && rl <= E + 1 ? rl : kInf;
  s.e[sr] = 0;
  s.rmin[sr] = rmin;
  s.er[sr] = rmin <= 0 ? 0 : kInf;
  s.off[sr] = 0;
  s.act[sr] = (uint8_t)act;
  if (r == 0) s.clen[a.slot] = 0;
}

__global__ void __launch_bounds__(256)
    branch_deactivate_kernel(uint8_t* act, const int32_t* pairs, int m,
                             int R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) act[(size_t)pairs[i] * R + pairs[m + i]] = 0;
}

Store make_store(void* D, void* e, void* rmin, void* er, void* off,
                 void* act, void* cons, void* clen, int B, int R, int W,
                 int C) {
  Store s;
  s.D = static_cast<int32_t*>(D);
  s.e = static_cast<int32_t*>(e);
  s.rmin = static_cast<int32_t*>(rmin);
  s.er = static_cast<int32_t*>(er);
  s.off = static_cast<int32_t*>(off);
  s.act = static_cast<uint8_t*>(act);
  s.cons = static_cast<int32_t*>(cons);
  s.clen = static_cast<int32_t*>(clen);
  s.B = B;
  s.R = R;
  s.W = W;
  s.C = C;
  s.E = (W - 2) / 2;
  return s;
}

// Most dynamic shared memory a CTA of sm_90 may take (with the opt-in).
constexpr int kMaxSmem = 232448;

// Lets `fn` take up to kMaxSmem bytes of dynamic shared memory (the
// default is 48 KB); once a kernel.
int allow_smem(const void* fn) {
  static const void* done[32] = {};
  for (const void*& slot : done) {
    if (slot == fn) return 0;
    if (slot == nullptr) {
      cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err == cudaSuccess) slot = fn;
      return (int)err;
    }
  }
  return 0;
}

template <int C, bool kCommit, bool kShards>
int launch_one_as(const RowsArgs& a, const BranchCall& c, cudaStream_t st) {
  auto* fn = branch_one_kernel<C, kCommit, kShards>;
  const dim3 grid(c.blocks), block(c.warps * 32);
  const size_t smem = (size_t)c.smem;
  if (smem > 48 * 1024) {
    const int rc = allow_smem(reinterpret_cast<const void*>(fn));
    if (rc != 0) return rc;
  }
  if constexpr (kCommit) {
    void* args[] = {const_cast<RowsArgs*>(&a)};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fn), grid, block, args, smem, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    fn<<<grid, block, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kCommit, bool kShards>
int launch_one_on(const RowsArgs& a, const BranchCall& c, cudaStream_t st) {
  switch (c.cells) {
    case 1: return launch_one_as<1, kCommit, kShards>(a, c, st);
    case 2: return launch_one_as<2, kCommit, kShards>(a, c, st);
    case 3: return launch_one_as<3, kCommit, kShards>(a, c, st);
    case 5: return launch_one_as<5, kCommit, kShards>(a, c, st);
    case 9: return launch_one_as<9, kCommit, kShards>(a, c, st);
    case 17: return launch_one_as<17, kCommit, kShards>(a, c, st);
    default: return -1;
  }
}

template <bool kCommit>
int launch_one(const RowsArgs& a, const BranchCall& c, cudaStream_t st) {
  return a.shards > 1 ? launch_one_on<kCommit, true>(a, c, st)
                      : launch_one_on<kCommit, false>(a, c, st);
}

template <bool kShards>
const void* commit_kernel_on(int cells) {
  switch (cells) {
    case 1:
      return reinterpret_cast<const void*>(branch_one_kernel<1, true, kShards>);
    case 2:
      return reinterpret_cast<const void*>(branch_one_kernel<2, true, kShards>);
    case 3:
      return reinterpret_cast<const void*>(branch_one_kernel<3, true, kShards>);
    case 5:
      return reinterpret_cast<const void*>(branch_one_kernel<5, true, kShards>);
    case 9:
      return reinterpret_cast<const void*>(branch_one_kernel<9, true, kShards>);
    case 17:
      return reinterpret_cast<const void*>(
          branch_one_kernel<17, true, kShards>);
    default: return nullptr;
  }
}

// The committing instance on `cells` cells a lane for a call on `shards`
// shards (null: none), whose CTAs must all be resident.
const void* commit_kernel(int cells, int shards) {
  return shards > 1 ? commit_kernel_on<true>(cells)
                    : commit_kernel_on<false>(cells);
}

// The call's shards: the BranchShard array, or the call's own addresses
// as one shard.  Returns false when a shard lacks an address or the count
// is outside [1, kMaxShards].
bool fill_shards(const BranchShard* ps, int shards, const BranchShard& own,
                 int B, int R, int W, int C, Shard* out) {
  if (shards < 1 || shards > kMaxShards || (shards > 1 && ps == nullptr)) {
    return false;
  }
  for (int i = 0; i < shards; ++i) {
    const BranchShard& p = shards > 1 ? ps[i] : own;
    if (!p.D || !p.e || !p.rmin || !p.er || !p.off || !p.act || !p.clen ||
        !p.rlen) {
      return false;
    }
    out[i].s = make_store(p.D, p.e, p.rmin, p.er, p.off, p.act, p.cons,
                          p.clen, B, R, W, C);
    out[i].reads = static_cast<const int16_t*>(p.reads);
    out[i].rlen = static_cast<const int32_t*>(p.rlen);
  }
  return true;
}

BranchShard own_shard(const BranchCall& c) {
  return BranchShard{c.D,  c.e,    c.rmin,  c.er,    c.off,
                     c.act, c.cons, c.clen, c.reads, c.rlen};
}

// Whether the call's plan covers it and agrees with the kernels' layout;
// `sh` (every shard's store and reads) is filled.
bool plan_covers(const BranchCall& c, Shard* sh) {
  const int shards = c.shards < 1 ? 1 : c.shards;
  const long long nR = (long long)c.n * c.R * shards;
  const bool base =
      (c.mode == 0 || c.mode == 1) && c.n >= 1 && c.B >= 1 && c.R >= 1 &&
      c.C >= 1 && c.L >= 1 && c.W >= 4 && c.W % 2 == 0 && c.blocks >= 1 &&
      c.rows &&
      fill_shards(static_cast<const BranchShard*>(c.shard_ptrs), shards,
                  own_shard(c), c.B, c.R, c.W, c.C, sh) &&
      (c.mode == 0 || c.out != nullptr) &&
      (c.out == nullptr || (c.epoch > kInf && (!c.votes || c.A >= 1))) &&
      (c.part == nullptr || c.out != nullptr);
  if (!base) return false;
  for (int i = 0; i < shards; ++i) {
    if (!sh[i].s.cons || !sh[i].reads) return false;
  }
  if (c.plan == kPlanOne) {
    return (c.mode == 1 || c.slab != nullptr) &&
           commit_kernel(c.cells, shards) != nullptr &&
           32LL * c.cells >= c.W &&
           c.warps >= 1 && c.warps <= kOneWarps &&
           (long long)c.warps * c.blocks >= nR && c.smem <= kMaxSmem &&
           (long long)c.smem >=
               4LL * c.warps * (32LL * c.cells + (c.votes ? c.A : 0));
  }
  return c.plan == kPlanSlab && c.warps >= 1 && c.warps <= kSlabWarps &&
         (long long)c.warps * c.blocks >= nR &&
         (c.mode == 0 ? c.slab != nullptr && c.commit_blocks >= 1 &&
                            c.commit_rows >= 1 && c.commit_rows <= 65535
                      : c.slab == nullptr);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns 0 on success,
// -1 when the plan (`plan_branch` in ops/branch_kernel.py) does not cover
// the call, else the CUDA error.  The host checks the slots and reads of
// `rows` and `pairs` against B and R.  A host buffer is pinned: an upload
// from it is one async copy, and every call that returns without waiting
// records the store's event, on which the host waits (branch_event_sync)
// before it writes the pinned rows again.

namespace {

// One async copy of `bytes` from the pinned host to the device, unless
// there is nothing to copy.
int upload(void* dev, const void* host, size_t bytes, cudaStream_t st) {
  if (bytes == 0) return 0;
  return (int)cudaMemcpyAsync(dev, host, bytes, cudaMemcpyHostToDevice, st);
}

// After a launch: with `out_host`, the output copied into it (when the
// kernel wrote it on the device: `out` set) and one wait on the event
// (none with `defer`: the caller waits); else the event marks the upload
// for the next call.
int finish(void* event, void* out_host, const void* out, size_t bytes,
           cudaStream_t st, bool defer = false) {
  cudaEvent_t ev = static_cast<cudaEvent_t>(event);
  if (out_host != nullptr) {
    cudaError_t err = cudaSuccess;
    if (out != nullptr) {
      err = cudaMemcpyAsync(out_host, out, bytes, cudaMemcpyDeviceToHost,
                            st);
    }
    if (err == cudaSuccess) err = cudaEventRecord(ev, st);
    if (err == cudaSuccess && !defer) err = cudaEventSynchronize(ev);
    return (int)err;
  }
  return (int)cudaEventRecord(ev, st);
}

}  // namespace

// A new event for a store's calls (no timing), into *event.
extern "C" int branch_event(void** event) {
  if (event == nullptr) return -1;
  cudaEvent_t ev;
  cudaError_t err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
  *event = err == cudaSuccess ? static_cast<void*>(ev) : nullptr;
  return (int)err;
}

extern "C" int branch_event_free(void* event) {
  return (int)cudaEventDestroy(static_cast<cudaEvent_t>(event));
}

extern "C" int branch_event_sync(void* event) {
  return (int)cudaEventSynchronize(static_cast<cudaEvent_t>(event));
}

// One call (`BranchCall`).  `mode` 0 advances rows [3, n] (src, dst, sym;
// sym -1 copies) of the store and commits them unless the batch
// overflows; `out` (packed stats, null: none) gets every row's stats at
// its new length.  `mode` 1 reads the stats of rows (slot, slot, -1) into
// `out` and writes nothing else.  `votes` 0 skips the histogram (occ and
// split are left unwritten).  `plan` 1 (one_launch) is branch_one on
// `cells` cells a lane, `warps` x `blocks`, `smem` bytes of band and
// histogram rows, for mode 0 a cooperative launch behind the grid barrier;
// `slab` then holds the copies' consensus rows [S, n, C].  `plan` 0
// (slab) is branch_rows on `warps` x `blocks`, then for mode 0
// branch_commit on `commit_blocks` x `commit_rows` CTAs, through the
// scratch `slab` (branch_kernel.slab_words).  The rows are one async copy
// from the pinned `rows_host` to `rows`.
// With `out_host` (pinned, so the card reaches it) the call returns when
// the output is there (with `defer`, when it is queued): the one-launch
// kernel writes it straight into `out_host`, the slab plan into `out`,
// whose first `out_words` words are then copied; `flag` is the device
// word the commit tests for an overflow.  Without `out_host` the call
// returns at once.  `force` commits an overflowing batch too; `part`
// (device, with `out`) is zeroed, then gathers the call's partials.
// `shards` > 1 makes the call cover the `shard_ptrs` stores (R reads
// each, one geometry): one launch (two on the slab plan) for all of
// them, the output over their S x R reads in shard order.
extern "C" int branch_rows_launch(const BranchCall* call) {
  RowsArgs a;
  if (call == nullptr || !plan_covers(*call, a.sh) ||
      call->event == nullptr || call->rows_host == nullptr ||
      (call->out_host != nullptr &&
       (call->out == nullptr || call->flag == nullptr ||
        call->out_words < 1))) {
    return -1;
  }
  const BranchCall& c = *call;
  cudaStream_t st = static_cast<cudaStream_t>(c.stream);
  a.shards = c.shards < 1 ? 1 : c.shards;
  a.Rs = c.R;
  a.Ro = a.shards * c.R;
  a.rows = static_cast<const int32_t*>(c.rows);
  const bool direct = c.plan == kPlanOne && c.out_host != nullptr;
  a.out = static_cast<int32_t*>(direct ? c.out_host : c.out);
  a.flag = static_cast<int32_t*>(c.flag);
  a.slab = static_cast<int32_t*>(c.slab);
  a.n = c.n;
  a.L = c.L;
  a.A = c.A;
  a.wc = c.wc;
  a.et = c.et;
  a.votes = c.votes;
  a.mode = c.mode;
  a.epoch = c.epoch;
  a.part = static_cast<int32_t*>(c.part);
  a.force = c.force;
  int rc = upload(c.rows, c.rows_host, 3 * sizeof(int32_t) * (size_t)c.n,
                  st);
  if (rc != 0) return rc;
  if (c.part != nullptr) {
    rc = (int)cudaMemsetAsync(c.part, 0, 3 * sizeof(int32_t), st);
    if (rc != 0) return rc;
  }
  if (c.plan == kPlanOne) {
    rc = c.mode == 0 ? launch_one<true>(a, c, st)
                     : launch_one<false>(a, c, st);
  } else {
    branch_rows_kernel<<<c.blocks, c.warps * 32, 0, st>>>(a);
    rc = (int)cudaGetLastError();
    if (rc == 0 && c.mode == 0) {
      branch_commit_kernel<<<dim3(c.commit_blocks, c.commit_rows), 256, 0,
                             st>>>(a);
      rc = (int)cudaGetLastError();
    }
  }
  if (rc != 0) return rc;
  return finish(c.event, c.out_host, direct ? nullptr : c.out,
                sizeof(int32_t) * (size_t)c.out_words, st, c.defer != 0);
}

// CTAs of the committing branch_one on `cells` cells a lane, for a call on
// `shards` shards, that one SM holds at once with `warps` warps and `smem`
// bytes of shared memory, into *per_sm (`plan_branch`'s residency test).
extern "C" int branch_occupancy(int cells, int warps, int smem, int shards,
                                int* per_sm) {
  const void* fn = commit_kernel(cells, shards);
  if (fn == nullptr || per_sm == nullptr || warps < 1 ||
      warps > kOneWarps || smem < 0 || smem > kMaxSmem) {
    return -1;
  }
  if (smem > 48 * 1024) {
    const int rc = allow_smem(fn);
    if (rc != 0) return rc;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, warps * 32, (size_t)smem);
}

namespace {

// Roots slot `slot` of each of `nshards` stores (`shards`, R reads each):
// the launch behind both root entries.
int root_launch(const BranchShard* shards, int nshards,
                const BranchShard& own, void* act_in, void* act_host,
                void* event, int slot, int B, int R, int W, int warps,
                int blocks, void* stream) {
  RootArgs a;
  const bool plan_ok =
      slot >= 0 && slot < B && R >= 1 && W >= 4 && W % 2 == 0 &&
      warps >= 1 && warps <= kSlabWarps &&
      (long long)warps * blocks >= (long long)nshards * R &&
      act_in != nullptr && act_host != nullptr && event != nullptr &&
      fill_shards(shards, nshards, own, B, R, W, 1, a.sh);
  if (!plan_ok) return -1;
  a.act_in = static_cast<const uint8_t*>(act_in);
  a.shards = nshards;
  a.slot = slot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = upload(act_in, act_host, (size_t)nshards * R, st);
  if (rc != 0) return rc;
  branch_root_kernel<<<blocks, warps * 32, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  return rc != 0 ? rc : finish(event, nullptr, nullptr, 0, st);
}

}  // namespace

// Roots slot `slot`: the fresh column of every read, active where
// act_in [R] (uint8, copied from the pinned `act_host` first) says,
// consensus length 0.
extern "C" int branch_root_launch(void* D, void* e, void* rmin, void* er,
                                  void* off, void* act, void* clen,
                                  void* rlen, void* act_in, void* act_host,
                                  void* event, int slot, int B, int R,
                                  int W, int warps, int blocks,
                                  void* stream) {
  const BranchShard own{D, e, rmin, er, off, act, nullptr, clen, nullptr,
                        rlen};
  return root_launch(nullptr, 1, own, act_in, act_host, event, slot, B, R,
                     W, warps, blocks, stream);
}

// Roots slot `slot` of every one of `nshards` read shards (`shards`, R
// reads each, one geometry) in one launch: act_in [S x R] in shard order.
extern "C" int branch_root_shards_launch(const BranchShard* shards,
                                         int nshards, void* act_in,
                                         void* act_host, void* event,
                                         int slot, int B, int R, int W,
                                         int warps, int blocks,
                                         void* stream) {
  if (shards == nullptr || nshards < 1) return -1;
  return root_launch(shards, nshards, shards[0], act_in, act_host, event,
                     slot, B, R, W, warps, blocks, stream);
}

// Clears act[pairs[0][i], pairs[1][i]] for each of the `m` pairs [2, m]
// (copied from the pinned `pairs_host` first).
extern "C" int branch_deactivate_launch(void* act, void* pairs,
                                        void* pairs_host, void* event,
                                        int m, int B, int R, int blocks,
                                        void* stream) {
  if (m < 1 || B < 1 || R < 1 || (long long)blocks * 256 < m ||
      pairs == nullptr || pairs_host == nullptr || event == nullptr) {
    return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = upload(pairs, pairs_host, 2 * sizeof(int32_t) * m, st);
  if (rc != 0) return rc;
  branch_deactivate_kernel<<<blocks, 256, 0, st>>>(
      static_cast<uint8_t*>(act), static_cast<const int32_t*>(pairs), m, R);
  rc = (int)cudaGetLastError();
  return rc != 0 ? rc : finish(event, nullptr, nullptr, 0, st);
}
