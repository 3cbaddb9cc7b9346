// Activation-offset scan of the consensus search, for Hopper (sm_90a).
//
// Replaces the XLA loop `_j_offset_scan` of waffle_con_tpu/ops/
// jax_scorer.py.  For a late read's head (its first m symbols) and every
// window position p < P of the consensus tail, it computes
//   ed[b, p] = min_j Lev(head[b][:m], cons_win[p : p + j]),  j = 0 .. 2M,
// the prefix mode of the host's `wfa_ed_config(require_both_end=False)`,
// as one dense DP column per position: col[i] is the cost of head[:i]
// against cons_win[p : p + j].  Column j comes from column j - 1 by a
// substitution step (col[i - 1] + mismatch), a deletion step (col[i] +
// 1), new[0] = j, and the insertion chain new[i] = min_{k <= i} new[k] +
// (i - k); new[m] is folded into the best.  The window's and the head's
// padding sentinels never match; the wildcard (wc >= 0) matches on either
// side.  Position for position it gives what waffle_con_tpu_torch/ops/
// torch_scorer.py's `offset_scan` gives.
//
// Only the work that can reach the output is done.  The three steps only
// carry a cell upward, so new[m] needs cells 0 .. m alone, not M + 1.
// And a column j > 2m cannot lower the best: Lev(head[:m], s) >= |s| - m
// > m, while the best starts at min(3M + 5, m) <= m.  So each position
// steps J = min(2M, 2m) columns of m + 1 cells, where the plain twin (as
// the JAX loop) steps 2M columns of M + 1.
//
// What bounds it.  J columns of m + 1 cells at ~10 int32 operations a
// cell per position: at the default window (P = 64, m = 50, M = 64)
// 3.3 M operations, well under a microsecond of the card's int32 rate,
// and a few kilobytes of input.  A scan is one launch of J dependent
// columns: latency-bound.
//
// Design.  One warp per (head, window position), CTAs of up to 8
// positions of one head (`plan_offset_scan` in ops/replay_kernel.py).
// Each lane owns a contiguous run of the column's m + 1 cells and
// touches no other lane's cells: the substitution step takes the cell
// below a run from the lane below with one __shfl_up_sync, and the
// insertion chain is a run minimum, one warp scan of the 32 run minima
// and a second pass over the run, as in band_ops.cuh's
// `column_step_runs`.  One kernel body, by where the runs live:
//  * kC > 0: kC cells a lane in registers (one instance per kC, m + 1 <=
//    1,056), the fastest place for a column that is stepped J times;
//  * kC == 0: longer heads keep the column in shared memory, one
//    m + 1-cell column a warp.
// In both the CTA's window segment and its head sit in shared memory
// too (kStaged).  Where that does not fit a CTA (M >= 32,768, or a long
// head's columns), the warps read the window and the head from device
// memory and keep the column in a device-memory scratch ([B * P,
// m + 1]; kC == 0, kStaged false).  Which memory each pointer names is
// known at compile time, so the loads are shared or global ones, not
// generic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct ScanArgs {
  const int32_t* win;    // [P + 2M] dense ids, sentinel -2
  const int32_t* heads;  // [B, M] dense ids, sentinel -3
  int32_t* out;          // [B, P]
  int32_t* scratch;      // kStaged false: [B * P, m + 1] columns
  int P, M, m, wc;
};

template <int kC, bool kStaged>
__global__ void __launch_bounds__(256) offset_scan_kernel(ScanArgs a) {
  extern __shared__ int32_t smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_head = (a.P + nw - 1) / nw;
  const int b = blockIdx.x / per_head;
  const int p0 = (blockIdx.x % per_head) * nw;
  const int p = p0 + warp;
  const int M = a.M, m = a.m, wc = a.wc;
  const int n = m + 1;
  const int32_t* win;   // win[j - 1]: the window symbol column j adds
  const int32_t* head;  // head[i - 1]: the head symbol of cell i
  int32_t* col = nullptr;  // kC == 0: the warp's column
  if constexpr (kStaged) {
    // smem: the window segment cons_win[p0 .. p0 + seg), the head, then
    // (kC == 0) one m + 1-cell column a warp
    const int seg = nw - 1 + 2 * M;
    const int wn = a.P + 2 * M;
    int32_t* s_win = smem;
    int32_t* s_head = smem + seg;
    for (int x = threadIdx.x; x < seg; x += blockDim.x) {
      s_win[x] = a.win[min(p0 + x, wn - 1)];
    }
    for (int x = threadIdx.x; x < M; x += blockDim.x) {
      s_head[x] = a.heads[(size_t)b * M + x];
    }
    __syncthreads();
    win = s_win + warp;
    head = s_head;
    if (kC == 0) col = s_head + M + (size_t)warp * n;
  } else {
    static_assert(kC == 0, "a register column is always staged");
    win = a.win + p;
    head = a.heads + (size_t)b * M;
    col = a.scratch + ((size_t)b * a.P + p) * n;
  }
  if (p >= a.P) return;

  // this lane's run: cells ta .. ta + len - 1.  The loops over it run
  // kC times, unrolled, with the cells past len skipped, for a register
  // run, and len times, unrolled by 4, for a run in memory.
  const int cnt = kC > 0 ? kC : (n + 31) >> 5;
  const int ta = lane * cnt;
  const int len = max(0, min(cnt, n - ta));
  const int trips = kC > 0 ? kC : len;
  int reg[kC > 0 ? kC : 1];
  int32_t* run_mem = kC > 0 ? nullptr : col + ta;
  int top = 0;  // the run's last cell (none when the lane has no cell)
#pragma unroll (kC > 0 ? kC : 4)
  for (int s = 0; s < trips; ++s) {
    if (kC == 0 || s < len) {
      (kC > 0 ? reg[s] : run_mem[s]) = ta + s;
      top = ta + s;
    }
  }
  int best = min(3 * M + 5, m);
  const int J = min(2 * M, 2 * m);
  for (int j = 1; j <= J; ++j) {
    const int cj = win[j - 1];
    const bool cwild = wc >= 0 && cj == wc;
    // cell ta - 1 of the old column, from the lane below
    int prev = __shfl_up_sync(kFull, top, 1);
    int run = INT_MAX;
#pragma unroll (kC > 0 ? kC : 4)
    for (int s = 0; s < trips; ++s) {
      const int t = ta + s;
      if (kC == 0 || s < len) {
        int& c = kC > 0 ? reg[s] : run_mem[s];
        const int old = c;
        int v = j;
        if (t > 0) {
          const int h = head[t - 1];
          const int mis = !(h == cj || cwild || (wc >= 0 && h == wc));
          v = min(prev + mis, old + 1);
        }
        prev = old;
        c = v;
        run = min(run, v - t);
      }
    }
    // the chain entering this lane's run: the minimum over the lanes
    // below (a shuffle from below lane 0 returns the lane's own value)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      run = min(run, __shfl_up_sync(kFull, run, d));
    }
    const int below = __shfl_up_sync(kFull, run, 1);
    int x = lane == 0 ? INT_MAX : below;
#pragma unroll (kC > 0 ? kC : 4)
    for (int s = 0; s < trips; ++s) {
      const int t = ta + s;
      if (kC == 0 || s < len) {
        int& c = kC > 0 ? reg[s] : run_mem[s];
        x = min(x, c - t);
        c = x + t;
        top = c;
        if (t == m) best = min(best, c);
      }
    }
  }
  best = __shfl_sync(kFull, best, m / cnt);
  if (lane == 0) a.out[(size_t)b * a.P + p] = best;
}

template <int kC, bool kStaged = true>
int launch(const ScanArgs& a, int warps, int blocks, size_t smem,
           cudaStream_t stream) {
  auto fn = offset_scan_kernel<kC, kStaged>;
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

// Plain C entry point (bound with ctypes).  Scores the B heads against
// the P window positions into `out`, with the plan of `plan_offset_scan`
// (ops/replay_kernel.py): `warps` positions a CTA, `blocks` CTAs,
// `cells` cells a lane in registers (0: the column in memory) and `smem`
// bytes of dynamic shared memory (the window segment, the head and, for
// `cells` 0, the warps' columns), or `cells` 0 and `smem` 0 for all of
// them in device memory (the columns in `scratch`, [B * P, m + 1]
// int32).
// Returns 0 on success, -1 when the plan does not cover the shape or
// disagrees with the kernel's layout, else the CUDA error; the launch
// does not synchronise.
extern "C" int offset_scan_launch(void* win, void* heads, void* out,
                                  void* scratch, int B, int P, int M, int m,
                                  int wc, int warps, int blocks, int cells,
                                  long long smem, void* stream) {
  ScanArgs a;
  a.win = static_cast<const int32_t*>(win);
  a.heads = static_cast<const int32_t*>(heads);
  a.out = static_cast<int32_t*>(out);
  a.scratch = static_cast<int32_t*>(scratch);
  a.P = P; a.M = M; a.m = m; a.wc = wc;
  const long long cols = cells ? 0 : (long long)warps * (m + 1);
  const bool plan_ok =
      B >= 1 && P >= 1 && M >= 1 && m >= 0 && m <= M && warps >= 1 &&
      warps <= 8 && P % warps == 0 && blocks == B * (P / warps) &&
      (cells == 0 || 32LL * cells >= m + 1) &&
      (smem == 0 ? cells == 0 && scratch != nullptr
                 : smem == 4 * (warps - 1 + 3LL * M + cols));
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (smem == 0) return launch<0, false>(a, warps, blocks, 0, st);
  switch (cells) {
    case 0: return launch<0>(a, warps, blocks, sm, st);
    case 1: return launch<1>(a, warps, blocks, sm, st);
    case 2: return launch<2>(a, warps, blocks, sm, st);
    case 3: return launch<3>(a, warps, blocks, sm, st);
    case 5: return launch<5>(a, warps, blocks, sm, st);
    case 9: return launch<9>(a, warps, blocks, sm, st);
    case 17: return launch<17>(a, warps, blocks, sm, st);
    case 33: return launch<33>(a, warps, blocks, sm, st);
    default: return -1;
  }
}
