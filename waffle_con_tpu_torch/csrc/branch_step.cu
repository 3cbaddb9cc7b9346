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
// call's time is its launches and the host's copy of the result.  The
// design keeps the launches to two a batch and makes one packed output
// that the host fetches in one copy.
//
// Design.
//  * branch_rows: one warp a (row, read).  The warp steps its read's band
//    with band_ops.cuh's `column_step_runs`, both columns in device
//    memory, so any W takes the same code (each lane walks a contiguous
//    run of cells; the insertion chain crosses lanes by one warp scan),
//    or copies it for a copy-only row or an inactive read, into a scratch
//    slab with the row's folds, consensus and length.  Then the tip
//    histogram of the new column goes straight into the packed output's
//    occ row of that (row, read), in device memory, so any alphabet takes
//    the same code, and lane 0 writes the read's fields.  A finalized
//    distance outside the band and a band overflow are ORed into words of
//    the output (zeroed before the launch).
//  * branch_commit: a second launch on the same stream copies the slab
//    into the dst slots unless the overflow word is set.  So a batch
//    commits nothing when any of its rows overflows, as JAX's does, and
//    every src row is read (launch 1) before any dst row is written
//    (launch 2): a row may write the slot another row copies from.
//  * stats and finalize: branch_rows on (slot, slot, -1) rows with no
//    slab and no commit (finalize without the histogram).
//  * root: one warp a read writes the fresh column; deactivate: one
//    thread a (slot, read) pair.

#include <cuda_runtime.h>

#include <cstdint>

#include "band_ops.cuh"

namespace {

using band::Folds3;
using band::kInf;

constexpr int kMaxWarps = 8;  // warps of a CTA of branch_rows / root

// Symbols of one read as the plain twin gathers them (torch_scorer.py's
// `gather_window`, JAX's `take_along_axis` over clipped positions):
// positions clamped into [0, L).  It differs from band::GlobalWindow
// (-1 outside) only where a finite cell faces position -1: a read whose
// anchor lies past its branch's length, stepped before it.
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

struct RowsArgs {
  Store s;
  const int16_t* reads;  // [R, L], -1 past a read's end
  const int32_t* rlen;   // [R]
  const int32_t* rows;   // [3, n]: src slot, dst slot, symbol (-1: copy)
  int32_t* out;          // packed output (null: no stats)
  int32_t* slab;         // scratch of an advance (null: stats only)
  int n, L, A, wc, et, votes;
};

// Packed output (branch_kernel.out_layout): eds, split, reached and fin
// [n, R] each, fin_ovf [n], the batch's overflow word, then occ [n, R, A].
__host__ __device__ inline size_t flags_at(int n, int R) {
  return 4 * (size_t)n * R;
}
__host__ __device__ inline size_t occ_at(int n, int R) {
  return flags_at(n, R) + n + 1;
}

// Scratch of an advance (branch_kernel.slab_words): D [n, R, W], then
// e, rmin, er, off, act [n, R] each, cons [n, C] and clen [n].
struct Slab {
  int32_t* D;
  int32_t* folds;
  int32_t* cons;
  int32_t* clen;
  __device__ Slab(int32_t* base, int n, const Store& s) {
    const size_t nR = (size_t)n * s.R;
    D = base;
    folds = base + nR * s.W;
    cons = folds + 5 * nR;
    clen = cons + (size_t)n * s.C;
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32)
    branch_rows_kernel(const RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const Store& s = a.s;
  const int n = a.n, R = s.R, W = s.W, E = s.E;
  if (w >= (long long)n * R) return;  // the whole warp
  const int k = (int)(w / R), r = (int)(w % R);
  const int src = a.rows[k], sym = a.rows[2 * n + k];
  const bool push = sym >= 0 && a.slab != nullptr;
  const size_t sr = (size_t)src * R + r;
  const int rl = a.rlen[r], off = s.off[sr], act = s.act[sr];
  const int cl = s.clen[src];
  const int32_t* Do = s.D + sr * W;
  const ClampedWindow win{a.reads + (size_t)r * a.L, a.L};
  Folds3 f{s.e[sr], s.rmin[sr], s.er[sr]};
  int* hist = nullptr;
  if (a.out != nullptr && a.votes) {
    hist = a.out + occ_at(n, R) + (size_t)w * a.A;
    for (int q = lane; q < a.A; q += 32) hist[q] = 0;
    __syncwarp();
  }
  const bool votes = hist != nullptr && act;
  int split = 0;
  if (a.slab != nullptr) {
    const Slab sl(a.slab, n, s);
    int32_t* Dn = sl.D + (size_t)w * W;
    if (push && act) {
      const int i0 = cl + 1 - off - E;
      if (votes) {
        f = band::column_step_runs<ClampedWindow, true>(
            Do, Dn, win, W, rl, i0, sym, a.wc, a.et, f, hist, &split);
      } else {
        f = band::column_step_runs<ClampedWindow, false>(
            Do, Dn, win, W, rl, i0, sym, a.wc, a.et, f, nullptr, nullptr);
      }
    } else {
      for (int t = lane; t < W; t += 32) Dn[t] = Do[t];
      if (votes) {
        split = band::tip_histogram_win(Do, win, W, rl, cl - off - E, f.e,
                                        hist);
      }
    }
    const size_t nR = (size_t)n * R;
    if (lane == 0) {
      sl.folds[w] = f.e;
      sl.folds[nR + w] = f.rmin;
      sl.folds[2 * nR + w] = f.er;
      sl.folds[3 * nR + w] = off;
      sl.folds[4 * nR + w] = act;
    }
    // the row's consensus, spread over its R warps
    const int32_t* cons = s.cons + (size_t)src * s.C;
    int32_t* cons_n = sl.cons + (size_t)k * s.C;
    const int cpos = min(max(cl, 0), s.C - 1);
    for (long long c = (long long)r * 32 + lane; c < s.C;
         c += (long long)R * 32) {
      cons_n[c] = push && c == cpos ? sym : cons[c];
    }
    if (r == 0 && lane == 0) sl.clen[k] = push ? cl + 1 : cl;
  } else if (votes) {
    split = band::tip_histogram_win(Do, win, W, rl, cl - off - E, f.e, hist);
  }
  if (a.out == nullptr || lane != 0) return;
  const size_t nR = (size_t)n * R;
  int32_t* o = a.out;
  o[w] = act ? f.e : 0;
  o[nR + w] = split;
  o[2 * nR + w] = act && f.er < kInf && f.e == f.er;
  const int fin = max(f.e, f.rmin);
  o[3 * nR + w] = act ? min(fin, kInf) : 0;
  if (act && fin >= E) atomicOr(&o[flags_at(n, R) + k], 1);
  if (push && act && f.e >= E) atomicOr(&o[flags_at(n, R) + n], 1);
}

// Row k of the batch's slab into slot rows[1][k], unless the batch's
// overflow word is set (rows over gridDim.y, a row's words over the
// CTAs of gridDim.x).
__global__ void __launch_bounds__(256) branch_commit_kernel(const RowsArgs a) {
  const Store& s = a.s;
  const int n = a.n, R = s.R;
  if (a.out != nullptr && a.out[flags_at(n, R) + n] != 0) return;
  const Slab sl(a.slab, n, s);
  const size_t nR = (size_t)n * R, RW = (size_t)R * s.W;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = blockIdx.y; k < n; k += gridDim.y) {
    const size_t dst = (size_t)a.rows[n + k];
    int32_t* D = s.D + dst * RW;
    const int32_t* Ds = sl.D + (size_t)k * RW;
    for (size_t i = tid; i < RW; i += step) D[i] = Ds[i];
    for (size_t r = tid; r < (size_t)R; r += step) {
      const size_t q = (size_t)k * R + r, d = dst * R + r;
      s.e[d] = sl.folds[q];
      s.rmin[d] = sl.folds[nR + q];
      s.er[d] = sl.folds[2 * nR + q];
      s.off[d] = sl.folds[3 * nR + q];
      s.act[d] = (uint8_t)sl.folds[4 * nR + q];
    }
    for (size_t c = tid; c < (size_t)s.C; c += step) {
      s.cons[dst * s.C + c] = sl.cons[(size_t)k * s.C + c];
    }
    if (tid == 0) s.clen[dst] = sl.clen[k];
  }
}

// The fresh column of every read of `slot` (torch_scorer.init_col at
// off = 0), one warp a read.
__global__ void __launch_bounds__(kMaxWarps * 32)
    branch_root_kernel(const Store s, const int32_t* rlen,
                       const uint8_t* act_in, int slot) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= s.R) return;
  const size_t sr = (size_t)slot * s.R + r;
  const int act = act_in[r], rl = rlen[r], E = s.E;
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
  if (r == 0) s.clen[slot] = 0;
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

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns 0 on success,
// -1 when the plan (`plan_branch` in ops/branch_kernel.py) does not cover
// the call, else the CUDA error; none synchronises.  The host checks the
// slots and reads of `rows` and `pairs` against B and R.

// `mode` 0 advances rows [3, n] (src, dst, sym; sym -1 copies) of the
// store through the slab `slab` and commits them unless the batch
// overflows; `out` (packed stats, null: none) gets every row's stats at
// its new length.  `mode` 1 reads the stats of rows (slot, slot, -1) into
// `out` and writes nothing else.  `votes` 0 skips the histogram (occ and
// split are left unwritten).  `warps` warps a CTA, `blocks` CTAs of the
// rows launch, `commit_blocks` x `commit_rows` CTAs of the commit.
extern "C" int branch_rows_launch(
    int mode, int votes, void* D, void* e, void* rmin, void* er, void* off,
    void* act, void* cons, void* clen, void* reads, void* rlen, void* rows,
    void* out, void* slab, int B, int R, int W, int C, int L, int n, int A,
    int wc, int et, int warps, int blocks, int commit_blocks,
    int commit_rows, void* stream) {
  const bool plan_ok =
      (mode == 0 || mode == 1) && n >= 1 && B >= 1 && R >= 1 && C >= 1 &&
      L >= 1 && W >= 4 && W % 2 == 0 && warps >= 1 && warps <= kMaxWarps &&
      blocks >= 1 && (long long)warps * blocks >= (long long)n * R &&
      (mode == 0 ? slab != nullptr && commit_blocks >= 1 &&
                       commit_rows >= 1 && commit_rows <= 65535
                 : slab == nullptr && out != nullptr) &&
      (out == nullptr || !votes || A >= 1);
  if (!plan_ok) return -1;
  RowsArgs a;
  a.s = make_store(D, e, rmin, er, off, act, cons, clen, B, R, W, C);
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.rows = static_cast<const int32_t*>(rows);
  a.out = static_cast<int32_t*>(out);
  a.slab = static_cast<int32_t*>(slab);
  a.n = n;
  a.L = L;
  a.A = A;
  a.wc = wc;
  a.et = et;
  a.votes = votes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.out != nullptr) {
    cudaError_t err = cudaMemsetAsync(a.out + flags_at(n, R), 0,
                                      (size_t)(n + 1) * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
  }
  branch_rows_kernel<<<blocks, warps * 32, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || mode == 1) return (int)err;
  branch_commit_kernel<<<dim3(commit_blocks, commit_rows), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Roots slot `slot`: the fresh column of every read, active where
// act_in [R] (uint8) says, consensus length 0.
extern "C" int branch_root_launch(void* D, void* e, void* rmin, void* er,
                                  void* off, void* act, void* clen,
                                  void* rlen, void* act_in, int slot, int B,
                                  int R, int W, int warps, int blocks,
                                  void* stream) {
  const bool plan_ok = slot >= 0 && slot < B && R >= 1 && W >= 4 &&
                       W % 2 == 0 && warps >= 1 && warps <= kMaxWarps &&
                       (long long)warps * blocks >= R && act_in != nullptr;
  if (!plan_ok) return -1;
  const Store s =
      make_store(D, e, rmin, er, off, act, nullptr, clen, B, R, W, 1);
  branch_root_kernel<<<blocks, warps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int32_t*>(rlen),
      static_cast<const uint8_t*>(act_in), slot);
  return (int)cudaGetLastError();
}

// Clears act[pairs[0][i], pairs[1][i]] for each of the `m` pairs [2, m].
extern "C" int branch_deactivate_launch(void* act, void* pairs, int m, int B,
                                        int R, int blocks, void* stream) {
  if (m < 1 || B < 1 || R < 1 || (long long)blocks * 256 < m) return -1;
  branch_deactivate_kernel<<<blocks, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(act), static_cast<const int32_t*>(pairs), m, R);
  return (int)cudaGetLastError();
}
