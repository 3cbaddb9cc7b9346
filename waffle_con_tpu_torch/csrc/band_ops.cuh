// Band operations shared by the run kernels (csrc/run_extend.cu,
// csrc/run_extend_dual.cu): one read's tip histogram and one read's DP
// column step, each done by one warp over the read's [W] band row.
//
// The band is the branch store's [R, W] int32 layout: cell t of read r at
// consensus length j faces read position i = j - off[r] - E + t.  Reads
// are fetched from the [R, L] int16 array of dense symbol ids with a
// bounds check, at the read's own offset, so any offsets and any alphabet
// size take the same code.

#pragma once

#include <climits>
#include <cstdint>

namespace band {

constexpr int kInf = 1 << 20;       // band "infinity" (torch_scorer.INF)
constexpr unsigned kFull = 0xffffffffu;

// Tip histogram of one read: every band cell with D <= e that faces a
// real read base votes for that base in `hist` (the warp's [A] row).
// Returns the number of tips (split), the same in every lane; `hist` is
// complete once the call returns.
__device__ __forceinline__ int tip_histogram(const int32_t* Dr,
                                             const int16_t* rd, int W,
                                             int rl, int i0, int e,
                                             int* hist) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int t = lane; t < W; t += 32) {
    const int i = i0 + t;
    if (i >= 0 && i < rl && Dr[t] <= e) {
      atomicAdd(&hist[rd[i]], 1);
      ++n;
    }
  }
  const int split = __reduce_add_sync(kFull, n);
  __syncwarp();
  return split;
}

struct Folds3 {
  int e, rmin, er;
};

// One DP column of one read: consume `sym` at the new consensus length,
// from the row Do into the row Dn.  `i0` is the read position of cell 0
// at the new length, `rl` the read's length.  Lanes walk the row in
// 32-cell tiles with coalesced loads; the insertion chain (a prefix min
// of base - t along the row) is a warp scan per tile with the carry
// handed from tile to tile.  Returns the read's new (e, rmin, er) folds,
// the same in every lane (`et`: early termination caps e at the read's
// end).
__device__ __forceinline__ Folds3 column_step(const int32_t* Do, int32_t* Dn,
                                              const int16_t* rd, int W,
                                              int L, int rl, int i0, int sym,
                                              int wc, int et, Folds3 f) {
  const int lane = threadIdx.x & 31;
  int carry = INT_MAX, colmin = kInf, rend = kInf;
  for (int t0 = 0; t0 < W; t0 += 32) {
    const int t = t0 + lane;
    const bool in_band = t < W;
    const int i_new = i0 + t;
    int base = kInf;
    if (in_band) {
      const int d_diag = Do[t];
      const int d_del = t + 1 < W ? Do[t + 1] : kInf;
      const int bi = i_new - 1;
      const int ch = bi >= 0 && bi < L ? rd[bi] : -1;
      const int sub = ch != sym && ch != wc;
      base = min(d_diag + sub, d_del + 1);
      if (i_new < 0 || i_new > rl) base = kInf;
    }
    int x = in_band ? base - t : INT_MAX;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(kFull, x, k);
      if (lane >= k) x = min(x, y);
    }
    x = min(x, carry);
    carry = __shfl_sync(kFull, x, 31);
    if (in_band) {
      const int dn = min(min(base, x + t), kInf);
      Dn[t] = dn;
      colmin = min(colmin, dn);
      if (i_new == rl) rend = min(rend, dn);
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
  return Folds3{e_n, rmin_n, er_n};
}

// ---- Routines of the cluster run kernel (csrc/run_extend.cu): the same
// tip histogram and column step, with the read's symbols taken through a
// window accessor `win(i)` (symbol id at read position i, -1 outside
// [0, L)), so the kernel can serve them from a ring in shared memory or
// from the read array in device memory with one body.

// Symbols of one read straight from the [R, L] read array.
struct GlobalWindow {
  const int16_t* rd;
  int L;
  __device__ __forceinline__ int operator()(int i) const {
    return i >= 0 && i < L ? rd[i] : -1;
  }
};

// Symbols of one read from a power-of-two ring in shared memory that holds
// the positions of the current window (position i at slot i & mask).
struct RingWindow {
  const int16_t* ring;
  int mask;
  __device__ __forceinline__ int operator()(int i) const {
    return ring[i & mask];
  }
};

// tip_histogram over a window accessor.
template <class Win>
__device__ __forceinline__ int tip_histogram_win(const int32_t* Dr,
                                                 const Win& win, int W,
                                                 int rl, int i0, int e,
                                                 int* hist) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int t = lane; t < W; t += 32) {
    const int i = i0 + t;
    if (i >= 0 && i < rl && Dr[t] <= e) {
      atomicAdd(&hist[win(i)], 1);
      ++n;
    }
  }
  const int split = __reduce_add_sync(kFull, n);
  __syncwarp();
  return split;
}

// One DP column of one read, with the read's cells in contiguous runs:
// lane k owns cells [k * c, k * c + c), c = ceil(W / 32), so the
// insertion chain (a prefix min of base - t along the column) is a
// sequential min along each lane's run, one warp scan of the 32 run
// minima, and a second pass over the run, instead of a scan per 32-cell
// tile.  Pass 1 writes each cell's base (diagonal, deletion, validity)
// into Dn; pass 2 turns it into the new cell.
//
// It also takes the tip histogram of the new column (cells with
// D <= e_new facing a real read base) into `hist`, its size into *split:
// pass 2 keeps each lane's least cell facing a read base, and only the
// lanes whose least cell is within e_new (a few, around the alignment's
// tip) walk their run a third time.  Returns the read's new (e, rmin,
// er) folds, the same in every lane.
template <class Win>
__device__ __forceinline__ Folds3 column_step_runs(
    const int32_t* __restrict__ Do, int32_t* __restrict__ Dn,
    const Win& win, int W, int rl, int i0, int sym, int wc, int et,
    Folds3 f, int* hist, int* split) {
  const int lane = threadIdx.x & 31;
  const int c = (W + 31) >> 5;
  const int ta = min(lane * c, W), tb = min(ta + c, W);
  int run = INT_MAX;
  int d_next = ta < tb ? Do[ta] : kInf;
#pragma unroll 4
  for (int t = ta; t < tb; ++t) {
    const int d_diag = d_next;
    d_next = t + 1 < W ? Do[t + 1] : kInf;
    const int i_new = i0 + t;
    const int ch = win(i_new - 1);
    const int sub = ch != sym && ch != wc;
    int base = min(d_diag + sub, d_next + 1);
    if ((unsigned)i_new > (unsigned)rl) base = kInf;  // i_new < 0 or > rl
    Dn[t] = base;
    run = min(run, base - t);
  }
  // the chain entering this lane's run: the minimum over the lanes below
  // (a shuffle from below lane 0 returns the lane's own value)
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) run = min(run, __shfl_up_sync(kFull, run, k));
  const int below = __shfl_up_sync(kFull, run, 1);
  int x = lane == 0 ? INT_MAX : below;
  int colmin = kInf, rend = kInf, vmin = INT_MAX;
#pragma unroll 4
  for (int t = ta; t < tb; ++t) {
    const int base = Dn[t];
    x = min(x, base - t);
    const int dn = min(min(base, x + t), kInf);
    Dn[t] = dn;
    colmin = min(colmin, dn);
    const int i_new = i0 + t;
    rend = i_new == rl ? min(rend, dn) : rend;
    vmin = (unsigned)i_new < (unsigned)rl ? min(vmin, dn) : vmin;
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
  int n = 0;
  if (vmin <= e_n) {
    for (int t = ta; t < tb; ++t) {
      const int i = i0 + t;
      if ((unsigned)i < (unsigned)rl && Dn[t] <= e_n) {
        atomicAdd(&hist[win(i)], 1);
        ++n;
      }
    }
  }
  *split = __reduce_add_sync(kFull, n);
  __syncwarp();
  return Folds3{e_n, rmin_n, er_n};
}

}  // namespace band
