// Band operations of the run kernels (csrc/run_extend.cu,
// csrc/run_extend_dual.cu) and the column replay (csrc/col_replay.cu):
// one read's tip histogram and one read's DP column step, each done by
// one warp over the read's [W] band row.
//
// The band is the branch store's [R, W] int32 layout: cell t of read r at
// consensus length j faces read position i = j - off[r] - E + t.  A
// read's dense symbol ids are taken at its own offset, so any offsets and
// any alphabet size take the same code.

#pragma once

#include <climits>
#include <cstdint>

namespace band {

constexpr int kInf = 1 << 20;       // band "infinity" (torch_scorer.INF)
constexpr unsigned kFull = 0xffffffffu;

struct Folds3 {
  int e, rmin, er;
};

// The read's symbols are taken through a window accessor `win(i)` (symbol
// id at read position i, -1 outside [0, L)), so a kernel can serve them
// from a ring in shared memory or from the read array in device memory
// with one body.

// Symbols of one read straight from the [R, L] read array.
struct GlobalWindow {
  const int16_t* rd;
  int L;
  __device__ __forceinline__ int operator()(int i) const {
    return i >= 0 && i < L ? rd[i] : -1;
  }
};

// Slots of a read's symbol ring: a power of two >= W + 2, so the symbol a
// step adds never lands on a slot of the window it is still reading.
__host__ __device__ inline int ring_len(int W) {
  int n = 1;
  while (n < W + 2) n <<= 1;
  return n;
}

// Symbols of one read from a power-of-two ring in shared memory that holds
// the positions of the current window (position i at slot i & mask).
struct RingWindow {
  const int16_t* ring;
  int mask;
  __device__ __forceinline__ int operator()(int i) const {
    return ring[i & mask];
  }
};

// Tip histogram of one read: every band cell with D <= e that faces a
// real read base votes for that base in `hist` (the warp's [A] row).
// Returns the number of tips (split), the same in every lane; `hist` is
// complete once the call returns.
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
// With kVotes it also takes the tip histogram of the new column (cells
// with D <= e_new facing a real read base) into `hist`, its size into
// *split: pass 2 keeps each lane's least cell facing a read base, and
// only the lanes whose least cell is within e_new (a few, around the
// alignment's tip) walk their run a third time.  Without it (a replay,
// which needs no vote) `hist` and `split` are not touched and the caller
// orders the warp's accesses to Dn (__syncwarp) before the next column.
// Returns the read's new (e, rmin, er) folds, the same in every lane.
template <class Win, bool kVotes = true>
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
  if constexpr (!kVotes) return Folds3{e_n, rmin_n, er_n};
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
