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
// operations per band cell per replayed column over every active row; at
// 4,096 rows of W = 258 over ~10,000 columns that is ~0.2 G operations,
// ~12 ms of the card's int32 rate, so a full store is operations-bound
// once enough rows run at once.  An activation is one row's chain of
// 50-5,000 columns: latency-bound on one warp.
//
// Design.  One warp per row and no synchronisation across rows: CTAs of
// up to 8 warps (`plan_replay` in ops/replay_kernel.py), each warp with
// its row's two columns double-buffered in shared memory.  A row whose
// two columns do not fit a CTA's shared memory (W > 29,056) keeps them in
// device memory instead (kShared false): in growth mode the output row
// and a [rows, W] scratch row, in activation mode a [2, W] scratch.  The
// column step is band_ops.cuh's `column_step_runs` (each lane a
// contiguous run of cells, the insertion chain as a run minimum plus one
// warp scan), without its tip histogram; the read's symbols come straight
// from the [R, L] read array (`GlobalWindow`), which the L1 cache serves.

#include <cuda_runtime.h>

#include <cstdint>

#include "band_ops.cuh"

namespace {

using band::kInf;

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
  // kShared false: the rows' second columns (mode 0, [rows, W]) or the
  // row's two columns (mode 1, [2, W])
  int32_t* scratch;
  int B, R, W, C, L, E;
  int slot, read, offset, wc, et;
};

template <bool kActivate, bool kShared>
__global__ void __launch_bounds__(256) col_replay_kernel(ReplayArgs a) {
  extern __shared__ int32_t smem[];
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
  // where the row ends up (mode 1: only when it does not overflow)
  const size_t row = kActivate ? (size_t)b * a.R + r : (size_t)k;
  int32_t* dst = (kActivate ? a.D : a.D_out) + row * W;
  int32_t* cur;
  int32_t* nxt;
  if (kShared) {
    cur = smem + (size_t)warp * 2 * W;
    nxt = cur + W;
  } else if (kActivate) {
    cur = a.scratch;
    nxt = a.scratch + W;
  } else {
    cur = dst;
    nxt = a.scratch + row * W;
  }
  // the fresh column at j == off
  for (int t = lane; t < W; t += 32) {
    const int i0 = t - E;
    cur[t] = act && i0 >= 0 && i0 <= rl ? i0 : kInf;
  }
  band::Folds3 f;
  f.e = 0;
  f.rmin = act && rl <= E + 1 ? rl : kInf;
  f.er = f.rmin <= 0 ? 0 : kInf;
  __syncwarp();
  if (act) {
    const int cl = a.clen[b];
    const int32_t* cons = a.cons + (size_t)b * a.C;
    const band::GlobalWindow win{a.reads + (size_t)r * a.L, a.L};
    for (int j = off; j < cl; ++j) {
      // column j -> j + 1; cell t of the new column faces read position
      // j + 1 - off - E + t
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
      int32_t* e = kActivate ? a.e : a.e_out;
      int32_t* rmin = kActivate ? a.rmin : a.rmin_out;
      int32_t* er = kActivate ? a.er : a.er_out;
      e[row] = f.e;
      rmin[row] = f.rmin;
      er[row] = f.er;
      if (kActivate) {
        a.off[row] = off;
        a.act[row] = 1;
      }
    }
  }
  if (kActivate && lane == 0) a.flag[0] = ovf ? 1 : 0;
}

template <bool kActivate, bool kShared>
int launch(const ReplayArgs& a, int warps, int blocks, size_t smem,
           cudaStream_t stream) {
  auto fn = col_replay_kernel<kActivate, kShared>;
  static size_t smem_attr = 0;
  if (smem > 48 * 1024 && smem > smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_attr = smem;
  }
  fn<<<blocks, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  `mode` 0 replays every row of
// the store (off, act, cons, clen) into D_out, e_out, rmin_out, er_out;
// `mode` 1 catches row (slot, read) up from `offset` over cons[slot] and
// commits it into D, e, rmin, er, off, act unless it overflows, writing
// the overflow flag to `flag`.  `warps`, `blocks` and `smem` are the plan
// of `plan_replay` (ops/replay_kernel.py); `smem` 0 keeps the columns in
// `scratch` ([B * R, W] int32 in mode 0, [2, W] in mode 1).  Returns 0 on success, -1 when
// the plan does not cover the rows or disagrees with the kernel's shared
// memory layout, else the CUDA error; the launch does not synchronise.
extern "C" int col_replay_launch(
    int mode, void* D, void* e, void* rmin, void* er, void* off, void* act,
    void* cons, void* clen, void* reads, void* rlen, void* D_out,
    void* e_out, void* rmin_out, void* er_out, void* flag, void* scratch,
    int B, int R,
    int W, int C, int L, int slot, int read, int offset, int wc, int et,
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
  const long long rows = mode == 1 ? 1 : (long long)B * R;
  const bool plan_ok =
      (mode == 0 || mode == 1) && warps >= 1 && warps <= 8 && blocks >= 1 &&
      (long long)warps * blocks >= rows && W >= 4 && W % 2 == 0 &&
      (smem == 0 ? scratch != nullptr : smem == 8LL * W * warps) &&
      (mode == 0 ? D_out && e_out && rmin_out && er_out
                 : D && e && rmin && er && flag && slot >= 0 && slot < B &&
                       read >= 0 && read < R && offset >= 0);
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (mode == 1) {
    return sm ? launch<true, true>(a, warps, blocks, sm, st)
              : launch<true, false>(a, warps, blocks, 0, st);
  }
  return sm ? launch<false, true>(a, warps, blocks, sm, st)
            : launch<false, false>(a, warps, blocks, 0, st);
}
