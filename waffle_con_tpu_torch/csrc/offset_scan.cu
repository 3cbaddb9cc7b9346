// Activation-offset scan of the consensus search, for Hopper (sm_90a).
//
// Replaces the XLA loop `_j_offset_scan` of waffle_con_tpu/ops/
// jax_scorer.py.  For a late read's head (its first m symbols) and every
// window position p < P of the consensus tail, it computes
//   ed[b, p] = min_j Lev(head[b][:m], cons_win[p : p + j]),  j = 0 .. 2M,
// the prefix mode of the host's `wfa_ed_config(require_both_end=False)`:
// a Levenshtein DP with D[i][0] = i and D[0][j] = j whose row m is folded
// into the best after every column.  The window's and the head's padding
// sentinels never match; the wildcard (wc >= 0) matches on either side.
// Position for position it gives what waffle_con_tpu_torch/ops/
// torch_scorer.py's `offset_scan` gives.
//
// Only the work that can reach the output is done.  A column j > 2m
// cannot lower the best: Lev(head[:m], s) >= |s| - m > m, while the best
// starts at min(3M + 5, m) <= m.  So each position steps J = min(2M, 2m)
// columns, where the plain twin (as the JAX loop) steps 2M.
//
// What bounds it.  J dependent column steps per position; a launch's
// inputs are a few kilobytes.  Latency-bound: the time of a launch is one
// position's chain of J columns times the latency of a column step.
//
// Design: Myers' bit-vector algorithm in Hyyro's form for a global top
// row.  A column is held as its vertical deltas D[i][j] - D[i-1][j], one
// bit per head row in two words (Pv: +1, Mv: -1), and stepped with a
// dozen bitwise operations and one add per 64 rows; the top row's
// horizontal delta is +1 (D[0][j] = j), so a 1 is shifted into Ph.  The
// score of row m starts at m and moves by row m's horizontal delta; the
// best is its running minimum.  Peq[s] (bit i set where head row i + 1
// matches window symbol s) is built once per head in shared memory: for
// the ids 0-255 and one row for every other symbol, the wildcard's bits
// folded into every row and the wildcard's own row all ones.
//  * m <= 2,048: a group of G = 1, 2, ..., 32 lanes per position (G the
//    least power of two with 64 G >= m), one 64-bit word of the column a
//    lane, in registers.  G = 1 (m <= 64, the default compare length of
//    50) is one thread per position with no cross-lane traffic; wider
//    groups resolve the add's carries across lanes with two ballots
//    (carry lookahead on the lanes' generate and propagate bits) and the
//    shifts' carries with one shuffle.
//  * longer heads: one warp per position, its ceil(m / 64) words in
//    shared memory, stepped 32 words (one a lane) at a time with the same
//    lookahead and the carries of each 32-word chunk handed to the next.
//    Peq lives in shared memory where it fits beside the columns, else
//    in a device-memory table of the CTA's own.
// The window symbols are read from device memory two columns ahead of
// their use; neither they nor Peq depend on the column, so their loads
// stay off the chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSyms = 256;  // Peq rows for ids 0-255, then one for others
using u64 = unsigned long long;

struct ScanArgs {
  const int32_t* win;    // [P + 2M] dense ids, sentinel -2
  const int32_t* heads;  // [B, M] dense ids, sentinel -3
  int32_t* out;          // [B, P]
  u64* table;            // kRegs false, Peq off chip: [blocks, 257, nwp]
  int P, M, m, wc;
  int group;  // kRegs: lanes per position
  int nwp;    // words of one Peq row (kRegs: group; else 32 per chunk)
};

// Peq of head b into `tab` ([257][nwp]), by every thread of the CTA.
__device__ __forceinline__ void build_peq(u64* tab, const int32_t* head,
                                          int m, int nwp, int wc) {
  const int n = (kSyms + 1) * nwp;
  for (int x = threadIdx.x; x < n; x += blockDim.x) tab[x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int s = head[i];
    if ((unsigned)s < (unsigned)kSyms) {
      atomicOr(&tab[s * nwp + (i >> 6)], 1ull << (i & 63));
    }
  }
  __syncthreads();
  if ((unsigned)wc < (unsigned)kSyms) {
    // the wildcard's bits match every window symbol; the wildcard in the
    // window matches every head row
    u64* other = tab + kSyms * nwp;
    for (int w = threadIdx.x; w < nwp; w += blockDim.x) {
      other[w] = tab[wc * nwp + w];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < kSyms * nwp; x += blockDim.x) {
      const int s = x / nwp;
      tab[x] = s == wc ? ~0ull : tab[x] | other[x - s * nwp];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int peq_row(int s) {
  return (unsigned)s < (unsigned)kSyms ? s : kSyms;
}

// Carries into the lanes of a group from the lanes' generate and
// propagate bits (bit l: lane l of the group) and the group's carry in:
// bit l of the result is the carry into lane l, bit `n` the carry out.
__device__ __forceinline__ u64 lookahead(unsigned g, unsigned p, unsigned cin) {
  const u64 s = (u64)g + (u64)(g | p) + cin;
  return s ^ g ^ (g | p);
}

template <bool kRegs>
__global__ void __launch_bounds__(256) offset_scan_kernel(ScanArgs a) {
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31;
  const int G = kRegs ? a.group : 32;
  const int npc = blockDim.x / G;  // positions of a CTA
  const int per_head = (a.P + npc - 1) / npc;
  const int b = blockIdx.x / per_head;
  // positions past P (a CTA wider than the window) step a copy of the
  // last one and write nothing, so that every warp operation names the
  // whole warp: groups of one warp each passing their own lanes' mask
  // would be run one after the other
  const int pp = (blockIdx.x % per_head) * npc + threadIdx.x / G;
  const int p = min(pp, a.P - 1);
  const int li = lane & (G - 1);
  const int M = a.M, m = a.m, nwp = a.nwp;
  const int32_t* head = a.heads + (size_t)b * M;
  u64* tab = kRegs || a.table == nullptr
                 ? smem
                 : a.table + (size_t)blockIdx.x * (kSyms + 1) * nwp;
  build_peq(tab, head, m, nwp, a.wc);
  const unsigned gbase = lane & ~(G - 1);
  const unsigned gbits = G == 32 ? kFull : (1u << G) - 1;
  int best = min(3 * M + 5, m);
  if (m > 0) {
    const int J = min(2 * M, 2 * m);
    const int wn = a.P + 2 * M;
    const int32_t* win = a.win + p;
    const int last = wn - 1 - p;  // win[last] is the window's end
    // row m: word wm (chunk wm / 32, lane wm % 32), bit bm
    const int wm = (m - 1) >> 6, bm = (m - 1) & 63;
    int score = m;
    // the symbols of columns j and j + 1, loaded ahead
    int s1 = win[min(0, last)], s2 = win[min(1, last)];
    if (kRegs) {
      // one word a lane: rows 64 li + 1 .. 64 li + 64
      const bool own = li == wm;
      u64 Pv = ~0ull, Mv = 0;
      u64 eq = tab[peq_row(s1) * nwp + li];
      for (int j = 1; j <= J; ++j) {
        const u64 Eq = eq;
        eq = tab[peq_row(s2) * nwp + li];
        s2 = win[min(j + 1, last)];
        const u64 Xv = Eq | Mv;
        const u64 t = Eq & Pv;
        u64 sum = t + Pv;
        if (G > 1) {
          const unsigned gen =
              (__ballot_sync(kFull, sum < t) >> gbase) & gbits;
          const unsigned pro =
              (__ballot_sync(kFull, sum == ~0ull) >> gbase) & gbits;
          sum += (lookahead(gen, pro, 0) >> li) & 1;
        }
        const u64 Xh = (sum ^ Pv) | Eq;
        u64 Ph = Mv | ~(Xh | Pv);
        u64 Mh = Pv & Xh;
        if (own) score += (int)((Ph >> bm) & 1) - (int)((Mh >> bm) & 1);
        unsigned lo = (unsigned)(Ph >> 63) | ((unsigned)(Mh >> 63) << 1);
        if (G > 1) lo = __shfl_up_sync(kFull, lo, 1, G);
        if (li == 0) lo = 1;  // the top row: Ph in 1, Mh in 0
        Ph = (Ph << 1) | (lo & 1);
        Mh = (Mh << 1) | (lo >> 1);
        Pv = Mh | ~(Xv | Ph);
        Mv = Ph & Xv;
        best = min(best, score);
      }
      best = __shfl_sync(kFull, best, wm, G);
    } else {
      // one warp a position, its words in shared memory after the Peq
      // table (when that is on chip), 32 words (a chunk) at a time
      const int nc = nwp >> 5;
      u64* col = (a.table == nullptr ? smem + (kSyms + 1) * nwp : smem) +
                 (size_t)(threadIdx.x >> 5) * 2 * nwp;
      for (int w = lane; w < nwp; w += 32) {
        col[2 * w] = ~0ull;
        col[2 * w + 1] = 0;
      }
      __syncwarp();
      const int cm = wm >> 5, lm = wm & 31;
      for (int j = 1; j <= J; ++j) {
        const u64* eqrow = tab + (size_t)peq_row(s1) * nwp;
        s1 = s2;
        s2 = win[min(j + 1, last)];
        unsigned cin = 0, lo_in = 1;  // the add's and the shifts' carries
        for (int c = 0; c < nc; ++c) {
          const int w = c * 32 + lane;
          const u64 Eq = eqrow[w];
          const u64 Pv = col[2 * w], Mv = col[2 * w + 1];
          const u64 Xv = Eq | Mv;
          const u64 t = Eq & Pv;
          u64 sum = t + Pv;
          const unsigned gen = __ballot_sync(kFull, sum < t);
          const unsigned pro = __ballot_sync(kFull, sum == ~0ull);
          const u64 cv = lookahead(gen, pro, cin);
          sum += (cv >> lane) & 1;
          cin = (unsigned)(cv >> 32) & 1;
          const u64 Xh = (sum ^ Pv) | Eq;
          u64 Ph = Mv | ~(Xh | Pv);
          u64 Mh = Pv & Xh;
          if (c == cm && lane == lm) {
            score += (int)((Ph >> bm) & 1) - (int)((Mh >> bm) & 1);
          }
          const unsigned hi =
              (unsigned)(Ph >> 63) | ((unsigned)(Mh >> 63) << 1);
          unsigned lo = __shfl_up_sync(kFull, hi, 1);
          if (lane == 0) lo = lo_in;
          lo_in = __shfl_sync(kFull, hi, 31);
          Ph = (Ph << 1) | (lo & 1);
          Mh = (Mh << 1) | (lo >> 1);
          col[2 * w] = Mh | ~(Xv | Ph);
          col[2 * w + 1] = Ph & Xv;
        }
        best = min(best, score);
      }
      best = __shfl_sync(kFull, best, lm);
    }
  }
  if (li == 0 && pp < a.P) a.out[(size_t)b * a.P + p] = best;
}

template <bool kRegs>
int launch(const ScanArgs& a, int threads, int blocks, size_t smem,
           cudaStream_t stream) {
  auto fn = offset_scan_kernel<kRegs>;
  static size_t smem_attr = 0;
  if (smem > 48 * 1024 && smem > smem_attr) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_attr = smem;
  }
  fn<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Scores the B heads against
// the P window positions into `out`, with the plan of `plan_offset_scan`
// (ops/replay_kernel.py): `group` lanes per position with the column in
// registers, or `group` 0 for one warp per position with the column in
// shared memory; `threads` a CTA, `blocks` CTAs and `smem` bytes of
// dynamic shared memory (the Peq table of 257 rows of `nwp` words, then
// for `group` 0 two words a row a position), or, for `group` 0 with
// `table` given, the Peq table in `table` ([blocks, 257, nwp] 64-bit
// words) and only the columns in shared memory.  The ids of the head,
// the window and `wc` are an alphabet of `num_symbols` dense ids: Peq has
// a row for each id below 256 and one shared by all others, so a larger
// alphabet is refused.  Returns 0 on success, -1 when the plan does not
// cover the shape or disagrees with the kernel's layout, else the CUDA
// error; the launch does not synchronise.
extern "C" int offset_scan_launch(void* win, void* heads, void* out,
                                  void* table, int B, int P, int M, int m,
                                  int wc, int num_symbols, int group, int nwp,
                                  int threads, int blocks, long long smem,
                                  void* stream) {
  ScanArgs a;
  a.win = static_cast<const int32_t*>(win);
  a.heads = static_cast<const int32_t*>(heads);
  a.out = static_cast<int32_t*>(out);
  a.table = static_cast<u64*>(table);
  a.P = P; a.M = M; a.m = m; a.wc = wc;
  a.group = group; a.nwp = nwp;
  const bool regs = group > 0;
  const int g = regs ? group : 32;
  const long long words = (m + 63) / 64;
  const long long tab = 8LL * (kSyms + 1) * nwp;
  const long long npc = threads / g;
  const bool pow2 = g >= 1 && g <= 32 && (g & (g - 1)) == 0;
  bool geom = pow2 && threads >= 32 && threads <= 256 && threads % g == 0 &&
              (threads & 31) == 0 && npc >= 1 &&
              blocks == B * ((P + npc - 1) / npc);
  if (regs) {
    geom = geom && nwp == g && 64LL * g >= m && table == nullptr &&
           smem == tab;
  } else {
    const long long cols = 16LL * nwp * (threads / 32);
    geom = geom && nwp % 32 == 0 && 64LL * nwp >= m &&
           smem == (table ? cols : tab + cols);
  }
  const bool plan_ok = B >= 1 && P >= 1 && M >= 1 && m >= 0 && m <= M &&
                       wc < kSyms && num_symbols >= 0 &&
                       num_symbols <= kSyms && words <= nwp && geom;
  if (!plan_ok) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return regs ? launch<true>(a, threads, blocks, (size_t)smem, st)
              : launch<false>(a, threads, blocks, (size_t)smem, st);
}
