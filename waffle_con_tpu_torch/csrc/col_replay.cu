// Column replay of the branch store, for Hopper (sm_90a).
//
// Replaces the XLA loops `_j_replay` and `_j_activate` of
// waffle_con_tpu/ops/jax_scorer.py.  A band row (one read of one branch
// slot) is rebuilt from its anchor: the fresh column at consensus
// position off (read prefix i costs i), then one DP column step per
// symbol cons[slot, j] for off <= j < clen[slot].  Two modes:
//  * mode 0, band growth: every (slot, read) row of the store into fresh
//    [B, R, W] tensors at the new width (inactive rows get the fresh
//    column's values, as the plain twin gives them);
//  * mode 1, activation: row (slot, read) restarted at `offset` and
//    caught up over the slot's consensus; the row (band, folds, off, act)
//    is written back in place only when its edit distance stays inside
//    the band (e < E), and one word tells the host whether it did not.
// Column for column it computes what waffle_con_tpu_torch/ops/
// torch_scorer.py's `replay_rows` computes.
//
// What bounds it.  A row's columns form a chain (each needs the one
// before), and rows are independent.  A growth replay's work is ~20 int32
// operations per band cell per replayed column; an activation is one
// row's chain of 50-5,000 columns.  Both are latency-bound: the time of a
// launch is the longest row's chain times the latency of one column, so
// the design shortens that latency and keeps every cell on the SM.
//
// Design.  Each lane keeps a contiguous run of `C` cells of its row in
// registers (one kernel instance per C), each cell t as u = D - t, the
// padding slots below cell 0, and the step is done on them in place:
//  * the old column's cell above the run comes from lane + 1 with one
//    shuffle; pass 1 computes each cell's base - t (diagonal, deletion,
//    validity) and keeps the lane's prefix minima of it, one scan of the
//    lanes' run minima carries the insertion chain, and pass 2 is one
//    minimum a cell with the chain entering the lane;
//  * the read's symbols slide down one cell a column: each lane takes
//    the symbol of lane + 1's first cell with a shuffle, and the top lane
//    takes it from a chunk of the next 32 symbols that the warp loads
//    one chunk ahead, in one coalesced load; the consensus symbol
//    comes from such a chunk too, broadcast with a shuffle;
//  * the column's folds are reduced off the chain and folded one column
//    late: the column minimum, and the cell facing the read's end, which
//    the row's top cell gives (the cells past the read's end carry its
//    chain).
// Placement by width (`plan_replay` in ops/replay_kernel.py):
//  * a row on one warp (W <= 544), no barrier at all;
//  * a row on up to 16 warps of one CTA (W <= 8,704): the insertion chain
//    crosses warps through one record a warp in shared memory (its run
//    minimum, its first old cell, its last column's folds) and one CTA
//    barrier a column.  The cell above a warp's top cell is the next
//    warp's first old cell, known only after that barrier, so the top
//    cell's deletion term enters the chain as a separate term that every
//    warp above adds from the records;
//  * a row on a thread-block cluster of up to 16 CTAs (W <= 139,264): the
//    same records, pushed to every CTA over distributed shared memory,
//    and one cluster barrier a column.  The columns never leave the SMs.
// Wider rows (none a search reaches) take the device-memory last resort:
// one warp a row with both columns in device memory and band_ops.cuh's
// `column_step_runs`.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "band_ops.cuh"

namespace {

namespace cg = cooperative_groups;
using band::Folds3;
using band::kFull;
using band::kInf;

constexpr int kMaxRowWarps = 16;  // warps of one row in a CTA
// an infinite u = D - t: u + t >= kInf for every cell, padding included
constexpr int kBig = 2 * kInf;
constexpr int kMaxCluster = 16;

struct ReplayArgs {
  // mode 1: the store's band and folds, written in place
  int32_t* D;
  int32_t* e;
  int32_t* rmin;
  int32_t* er;
  int32_t* off;
  uint8_t* act;
  const int32_t* cons;
  const int32_t* clen;
  const int16_t* reads;
  const int32_t* rlen;
  // mode 0: the rebuilt band and folds
  int32_t* D_out;
  int32_t* e_out;
  int32_t* rmin_out;
  int32_t* er_out;
  // mode 1: 1 when the row overflowed the band (nothing written)
  int32_t* flag;
  // device-memory last resort: the rows' second columns (mode 0, [rows,
  // W]) or the row's two columns (mode 1, [2, W])
  int32_t* scratch;
  int B, R, W, C, L, E;
  int slot, read, offset, wc, et;
  // register plan: warps of a row in a CTA, CTAs of a row (a cluster
  // when > 1)
  int row_warps, ctas;
};

// The folds of one column: the column minimum and the cell facing the
// read's end give the row's new (e, rmin, er), as band_ops.cuh's
// `column_step_runs` folds them.
__device__ __forceinline__ Folds3 fold_column(Folds3 f, int colmin, int rend,
                                              int et) {
  const int rmin_n = min(f.rmin, rend);
  const int e_unc = max(f.e, colmin);
  const int e_cap =
      f.er < kInf ? f.e : max(f.e, min(colmin, max(f.e, rmin_n)));
  const int e_n = et ? e_cap : e_unc;
  const int er_n =
      f.er < kInf ? f.er : (rmin_n <= e_n ? max(f.e, rmin_n) : kInf);
  return Folds3{e_n, rmin_n, er_n};
}

__device__ __forceinline__ int read_sym(const int16_t* rd, int L, int i) {
  return i >= 0 && i < L ? rd[i] : -1;
}

// A warp's record of one column, for the warps above it: the minimum of
// base - t over its cells (the top cell's base without its deletion
// term), its first cell of the old column, and the previous column's
// minimum and read-end cell over its cells.
struct alignas(16) Rec {
  int run, first, colmin, rend;
};

// Writes a finished row: growth writes it (band and folds) to the
// outputs, activation commits it (band, folds, off, act) unless it
// overflows and writes the flag.  `u` holds cell ta + s as D - t;
// `lead` is the row's first lane.
template <bool kActivate, int C>
__device__ __forceinline__ void write_row(const ReplayArgs& a,
                                          const int (&u)[C], Folds3 f,
                                          size_t row, int ta, int off,
                                          bool lead) {
  const bool ovf = kActivate && f.e >= a.E;
  if (!ovf) {
    int32_t* dst = (kActivate ? a.D : a.D_out) + row * a.W;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      if (ta + s >= 0) dst[ta + s] = min(u[s] + ta + s, kInf);
    }
    if (lead) {
      (kActivate ? a.e : a.e_out)[row] = f.e;
      (kActivate ? a.rmin : a.rmin_out)[row] = f.rmin;
      (kActivate ? a.er : a.er_out)[row] = f.er;
      if (kActivate) {
        a.off[row] = off;
        a.act[row] = 1;
      }
    }
  }
  if (kActivate && lead) a.flag[0] = ovf ? 1 : 0;
}

template <bool kActivate, int C>
__global__ void __launch_bounds__(512) col_replay_kernel(ReplayArgs a) {
  extern __shared__ Rec recs[];  // [2][row_warps * ctas], multi-warp rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool multi = a.row_warps > 1 || a.ctas > 1;
  const int nwr = a.row_warps * a.ctas;  // warps of the row
  long long k;                            // the row, b * R + r
  int gw = 0, rank = 0;
  if (!multi) {
    k = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (k >= (kActivate ? 1 : (long long)a.B * a.R)) return;
  } else {
    if (a.ctas > 1) {
      rank = (int)cg::this_cluster().block_rank();
      // every CTA runs before any record reaches its shared memory
      cg::this_cluster().sync();
    }
    k = blockIdx.x / a.ctas;
    gw = rank * a.row_warps + warp;
  }
  int b, r, off, act;
  if (kActivate) {
    b = a.slot;
    r = a.read;
    off = a.offset;
    act = 1;
  } else {
    b = (int)(k / a.R);
    r = (int)(k % a.R);
    off = a.off[k];
    act = a.act[k];
  }
  const int W = a.W, E = a.E, wc = a.wc, et = a.et;
  const int rl = a.rlen[r];
  // the row's cells sit in the top W of its slots (lane by lane, warp by
  // warp), the padding below cell 0; cell t is kept as u = D - t
  const int pad = 32 * nwr * C - W;
  const int ta = (gw * 32 + lane) * C - pad;  // this lane's first cell
  const int tb = (gw + 1) * 32 * C - pad;     // the cell above the warp's
  const bool top = lane == 31;                // the top lane of the warp
  const bool top_warp = gw == nwr - 1;
  int u[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    const int t = ta + s;
    u[s] = act && t >= E && t - E <= rl ? -E : kBig;
  }
  Folds3 f;
  f.e = 0;
  f.rmin = act && rl <= E + 1 ? rl : kInf;
  f.er = f.rmin <= 0 ? 0 : kInf;
  const int nsteps = act ? max(0, a.clen[b] - off) : 0;
  const size_t row = kActivate ? (size_t)b * a.R + r : (size_t)k;
  const bool lead = gw == 0 && lane == 0;
  if (nsteps > 0) {
    const int16_t* rd = a.reads + (size_t)r * a.L;
    const int32_t* cons = a.cons + (size_t)b * a.C;
    const int Lr = a.L, Cc = a.C;
    auto cons_at = [&](int j) { return j < Cc ? cons[j] : 0; };
    // step q computes column off + q + 1; cell t faces read position
    // q + 1 - E + t and compares its symbol at q - E + t
    int ch[C];
#pragma unroll
    for (int s = 0; s < C; ++s) ch[s] = read_sym(rd, Lr, ta + s - E);
    // chunks of the next 32 symbols: the top lane's feed and the
    // consensus, each loaded a chunk ahead
    int rcur = read_sym(rd, Lr, tb - E + lane);
    int rnxt = read_sym(rd, Lr, tb - E + 32 + lane);
    int ccur = cons_at(off + lane);
    int cnxt = cons_at(off + 32 + lane);
    int pend_cm = kInf, pend_re = kInf;  // the last column's folds
    for (int q = 0; q < nsteps; ++q) {
      const int qi = q & 31;
      if (q > 0 && qi == 0) {
        rcur = rnxt;
        ccur = cnxt;
        rnxt = read_sym(rd, Lr, q + 32 + tb - E + lane);
        cnxt = cons_at(off + q + 32 + lane);
      }
      const int sym = __shfl_sync(kFull, ccur, qi);
      const int i0 = q + 1 - E;
      // cells 0 .. hi keep their base: the padding below cell 0 and the
      // cells facing read positions past rl get kBig.  Cells facing
      // positions below 0 need no test: every cell they come from is
      // kBig, so their base is too and the chain keeps them there
      const int hi = min(rl - i0, W - 1);
      const unsigned nv = (unsigned)max(hi + 1, 0);
      // pass 1: each cell's base - t (diagonal, and deletion from the
      // cell above: D + 1 - t = u + 2), kept as the lane's prefix
      // minimum, so that pass 2 needs only the chain entering the lane.
      // The top lane's cell above is beyond the row (or, in a multi-warp
      // row, the next warp's, added after the barrier)
      const int old0 = u[0];
      int above = __shfl_down_sync(kFull, u[0], 1);
      if (top) above = kBig;
      int run = INT_MAX;
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const int un = s + 1 < C ? u[s + 1] : above;
        const int sub = ch[s] != sym && ch[s] != wc;
        int base = min(u[s] + sub, un + 2);
        if ((unsigned)(ta + s) >= nv) base = kBig;
        run = min(run, base);
        u[s] = run;
      }
      // the symbols slide down one cell for the next column
      {
        const int feed = __shfl_sync(kFull, rcur, qi);
        int nb = __shfl_down_sync(kFull, ch[0], 1);
        if (top) nb = feed;
#pragma unroll
        for (int s = 0; s + 1 < C; ++s) ch[s] = ch[s + 1];
        ch[C - 1] = nb;
      }
      // the previous column's folds, their reductions done by now
      if (!multi && q > 0) {
        f = fold_column(f, pend_cm, pend_re, et);
      }
      // the chain entering this lane from the lanes below it (a lane
      // with no lane `o` below it gets its own value back)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        run = min(run, __shfl_up_sync(kFull, run, o));
      }
      int x = __shfl_up_sync(kFull, run, 1);
      if (lane == 0) x = INT_MAX;
      if (multi) {
        // publish this warp's record, then take the chain from the warps
        // below and fold the previous column over every warp
        const int par = q & 1;
        const int wrun = __shfl_sync(kFull, run, 31);
        const int first = __shfl_sync(kFull, old0, 0);
        const Rec rec{wrun, first, pend_cm, pend_re};
        Rec* slot = recs + par * nwr;
        if (a.ctas > 1) {
          cg::cluster_group cl = cg::this_cluster();
          if (lane < a.ctas) *cl.map_shared_rank(slot + gw, lane) = rec;
          cl.sync();
        } else {
          if (lane == 0) slot[gw] = rec;
          __syncthreads();
        }
        int xin = INT_MAX, cm = kInf, re = kInf;
        for (int v = lane; v < nwr; v += 32) {
          const Rec rv = slot[v];
          cm = min(cm, rv.colmin);
          re = min(re, rv.rend);
          if (v < gw) {
            // warp v's top cell with its deletion term
            const int tt = (v + 1) * 32 * C - 1 - pad;
            int tot = rv.run;
            if ((unsigned)tt < nv) tot = min(tot, slot[v + 1].first + 2);
            xin = min(xin, tot);
          }
        }
        xin = __reduce_min_sync(kFull, xin);
        if (q > 0) {
          f = fold_column(f, __reduce_min_sync(kFull, cm),
                          __reduce_min_sync(kFull, re), et);
        }
        x = min(x, xin);
        if (lane == 31 && gw + 1 < nwr && (unsigned)(ta + C - 1) < nv) {
          u[C - 1] = min(u[C - 1], slot[gw + 1].first + 2);
        }
      }
      // pass 2: one minimum with the chain from below per cell; the
      // column minimum of D = u + t over the lane's cells
      int cm = INT_MAX;
#pragma unroll
      for (int s = 0; s < C; ++s) {
        u[s] = min(x, u[s]);
        cm = min(cm, u[s] + s);
      }
      pend_cm = __reduce_min_sync(kFull, min(cm + ta, kInf));
      // the cells past the read's end carry the chain of the cell facing
      // it, so the row's top cell gives that cell's value
      const int t_end = rl - i0;
      const int utop = __shfl_sync(kFull, u[C - 1], 31);
      pend_re = top_warp && t_end >= 0 && t_end < W
                    ? min(utop + t_end, kInf)
                    : kInf;
    }
    if (!multi) {
      f = fold_column(f, pend_cm, pend_re, et);
    } else {
      // the last column's folds
      const int par = nsteps & 1;
      const Rec rec{0, 0, pend_cm, pend_re};
      Rec* slot = recs + par * nwr;
      if (a.ctas > 1) {
        cg::cluster_group cl = cg::this_cluster();
        if (lane < a.ctas) *cl.map_shared_rank(slot + gw, lane) = rec;
        cl.sync();
      } else {
        if (lane == 0) slot[gw] = rec;
        __syncthreads();
      }
      int cm = kInf, re = kInf;
      for (int v = lane; v < nwr; v += 32) {
        cm = min(cm, slot[v].colmin);
        re = min(re, slot[v].rend);
      }
      f = fold_column(f, __reduce_min_sync(kFull, cm),
                      __reduce_min_sync(kFull, re), et);
    }
  }
  // every warp of a multi-warp row holds the same folds
  write_row<kActivate, C>(a, u, f, row, ta, off, lead);
}

// The device-memory last resort: one warp a row, both columns in device
// memory (in growth mode the output row and a [rows, W] scratch row, in
// activation mode a [2, W] scratch), the column step of band_ops.cuh.
template <bool kActivate>
__global__ void __launch_bounds__(256) col_replay_global_kernel(
    ReplayArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  int b, r, off, act;
  if (kActivate) {
    if (k != 0) return;
    b = a.slot;
    r = a.read;
    off = a.offset;
    act = 1;
  } else {
    if (k >= (long long)a.B * a.R) return;
    b = (int)(k / a.R);
    r = (int)(k % a.R);
    off = a.off[k];
    act = a.act[k];
  }
  const int W = a.W, E = a.E;
  const int rl = a.rlen[r];
  const size_t row = kActivate ? (size_t)b * a.R + r : (size_t)k;
  int32_t* dst = (kActivate ? a.D : a.D_out) + row * W;
  int32_t* cur = kActivate ? a.scratch : dst;
  int32_t* nxt = kActivate ? a.scratch + W : a.scratch + row * W;
  for (int t = lane; t < W; t += 32) {
    const int i0 = t - E;
    cur[t] = act && i0 >= 0 && i0 <= rl ? i0 : kInf;
  }
  Folds3 f;
  f.e = 0;
  f.rmin = act && rl <= E + 1 ? rl : kInf;
  f.er = f.rmin <= 0 ? 0 : kInf;
  __syncwarp();
  if (act) {
    const int cl = a.clen[b];
    const int32_t* cons = a.cons + (size_t)b * a.C;
    const band::GlobalWindow win{a.reads + (size_t)r * a.L, a.L};
    for (int j = off; j < cl; ++j) {
      f = band::column_step_runs<band::GlobalWindow, false>(
          cur, nxt, win, W, rl, j + 1 - off - E, cons[j], a.wc, a.et, f,
          nullptr, nullptr);
      int32_t* t = cur;
      cur = nxt;
      nxt = t;
      __syncwarp();
    }
  }
  const bool ovf = kActivate && f.e >= E;
  if (!ovf) {
    if (cur != dst) {
      for (int t = lane; t < W; t += 32) dst[t] = cur[t];
    }
    if (lane == 0) {
      (kActivate ? a.e : a.e_out)[row] = f.e;
      (kActivate ? a.rmin : a.rmin_out)[row] = f.rmin;
      (kActivate ? a.er : a.er_out)[row] = f.er;
      if (kActivate) {
        a.off[row] = off;
        a.act[row] = 1;
      }
    }
  }
  if (kActivate && lane == 0) a.flag[0] = ovf ? 1 : 0;
}

template <bool kActivate, int C>
int launch_regs(const ReplayArgs& a, int warps, int blocks, size_t smem,
                cudaStream_t stream) {
  auto* fn = col_replay_kernel<kActivate, C>;
  if (a.ctas > 8) {
    static bool nonportable = false;
    if (!nonportable) {
      cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      nonportable = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(warps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kActivate>
int launch(const ReplayArgs& a, int cells, int warps, int blocks,
           size_t smem, cudaStream_t stream) {
  switch (cells) {
    case 0:
      col_replay_global_kernel<kActivate><<<blocks, warps * 32, 0, stream>>>(
          a);
      return (int)cudaGetLastError();
    case 1: return launch_regs<kActivate, 1>(a, warps, blocks, smem, stream);
    case 2: return launch_regs<kActivate, 2>(a, warps, blocks, smem, stream);
    case 3: return launch_regs<kActivate, 3>(a, warps, blocks, smem, stream);
    case 5: return launch_regs<kActivate, 5>(a, warps, blocks, smem, stream);
    case 9: return launch_regs<kActivate, 9>(a, warps, blocks, smem, stream);
    case 17:
      return launch_regs<kActivate, 17>(a, warps, blocks, smem, stream);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  `mode` 0 replays every row of
// the store (off, act, cons, clen) into D_out, e_out, rmin_out, er_out;
// `mode` 1 catches row (slot, read) up from `offset` over cons[slot] and
// commits it into D, e, rmin, er, off, act unless it overflows, writing
// the overflow flag to `flag`.  The plan is `plan_replay`'s (ops/
// replay_kernel.py): `cells` cells a lane in registers, a row on one
// warp or on `row_warps` warps of a CTA over `ctas` CTAs (a cluster),
// `warps` warps a CTA, `blocks` CTAs and `smem` bytes of
// records (two per warp of a multi-warp row); `cells` 0 is the
// device-memory last resort, its columns in `scratch` ([B * R, W] int32
// in mode 0, [2, W] in mode 1).  Returns 0 on success, -1 when the plan
// does not cover the rows or disagrees with the kernel's layout, else the
// CUDA error; the launch does not synchronise.
extern "C" int col_replay_launch(
    int mode, void* D, void* e, void* rmin, void* er, void* off, void* act,
    void* cons, void* clen, void* reads, void* rlen, void* D_out,
    void* e_out, void* rmin_out, void* er_out, void* flag, void* scratch,
    int B, int R, int W, int C, int L, int slot, int read, int offset,
    int wc, int et, int cells, int row_warps, int ctas,
    int warps, int blocks, long long smem, void* stream) {
  ReplayArgs a;
  a.D = static_cast<int32_t*>(D);
  a.e = static_cast<int32_t*>(e);
  a.rmin = static_cast<int32_t*>(rmin);
  a.er = static_cast<int32_t*>(er);
  a.off = static_cast<int32_t*>(off);
  a.act = static_cast<uint8_t*>(act);
  a.cons = static_cast<const int32_t*>(cons);
  a.clen = static_cast<const int32_t*>(clen);
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.D_out = static_cast<int32_t*>(D_out);
  a.e_out = static_cast<int32_t*>(e_out);
  a.rmin_out = static_cast<int32_t*>(rmin_out);
  a.er_out = static_cast<int32_t*>(er_out);
  a.flag = static_cast<int32_t*>(flag);
  a.scratch = static_cast<int32_t*>(scratch);
  a.B = B; a.R = R; a.W = W; a.C = C; a.L = L;
  a.E = (W - 2) / 2;
  a.slot = slot; a.read = read; a.offset = offset; a.wc = wc; a.et = et;
  a.row_warps = row_warps; a.ctas = ctas;
  const long long rows = mode == 1 ? 1 : (long long)B * R;
  const bool multi = row_warps > 1 || ctas > 1;
  bool geom;
  if (cells == 0) {
    geom = scratch != nullptr && smem == 0 && warps >= 1 && warps <= 8 &&
           (long long)warps * blocks >= rows;
  } else if (!multi) {
    geom = 32LL * cells >= W && ctas == 1 && smem == 0 && warps >= 1 &&
           warps <= 8 && (long long)warps * blocks >= rows;
  } else {
    geom = row_warps >= 1 && row_warps <= kMaxRowWarps &&
           ctas >= 1 && ctas <= kMaxCluster && warps == row_warps &&
           32LL * cells * row_warps * ctas >= W &&
           (long long)blocks == rows * ctas &&
           smem == 2LL * (long long)sizeof(Rec) * row_warps * ctas;
  }
  const bool plan_ok =
      (mode == 0 || mode == 1) && geom && blocks >= 1 && W >= 4 &&
      W % 2 == 0 &&
      (mode == 0 ? D_out && e_out && rmin_out && er_out
                 : D && e && rmin && er && flag && slot >= 0 && slot < B &&
                       read >= 0 && read < R && offset >= 0);
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  return mode == 1 ? launch<true>(a, cells, warps, blocks, sm, st)
                   : launch<false>(a, cells, warps, blocks, sm, st);
}
