// Frontier-gang run kernel of the consensus search, for Hopper (sm_90a).
//
// Replaces the XLA loop `_j_run_ragged` (built by `BandArena._build_kernel`
// in waffle_con_tpu/ops/ragged.py) as the frontier gang uses it: the K=1
// run body over up to G = 8 branches of one search at once, each branch's
// result kept as a deposit that its own later pop may consume.  Per
// branch: a forced first push when first_sym >= 0 (only band overflow,
// code 5, refuses it), then one symbol a step until a stop code in the
// order 3 (over budget or loses the pop) > 2 (reached; records are never
// absorbed) > 1 (dirty vote) > 4 (max_steps), then 5 (overflow after the
// column step), and the stats of the stopped state.
//
// What bounds it.  As the run kernel: each branch's steps are a chain of
// dependent column steps, so a branch is bound by the latency of one step
// (R x W cells, ~20 int32 operations each, then one decision over every
// read).  The gang adds no work to a branch; it runs the branches side
// by side instead of one launch after another.
//
// Design.  The members of a self-gang are branches of one search, so they
// share R, W and the alphabet: each is an independent run of the run
// kernel's geometry.  One launch holds one thread-block cluster per member
// (`plan_run`'s cluster and warp layout, `plan_ragged` in
// ops/ragged_kernel.py), and each cluster runs csrc/run_body.cuh's
// `run_branch`, the run kernel's own body: XLA's segment reduces over a
// pool of member rows become each cluster's own rank-order fold, and the
// float32 vote fold is the run kernel's bit for bit, so a deposit equals a
// solo launch from the same state.  A cluster reads its member's rows
// straight from the branch store by slot (the host passes each slot's
// addresses), never writes the store, and leaves the post-run state in
// the deposit buffers: D [G, R, W], e/rmin/er [G, R], cons [G, C], clen
// [G] and the packed outputs [G, ...] (run_kernel.out_layout).  A member
// whose slot does not hold the consensus length the host expects runs
// nothing and reports code -1.  With 16-CTA clusters, 8 members may not
// all fit on the card at once; they then run in waves
// (`run_ragged_max_clusters` gives how many fit).

#include "run_body.cuh"

namespace {

constexpr int kMaxGang = 8;  // FrontierGang.G

struct GangArgs {
  Args m[kMaxGang];
};

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads, 1)
    run_ragged_kernel(const __grid_constant__ GangArgs g) {
  extern __shared__ __align__(16) char smem_raw[];
  const int member = blockIdx.x / g.m[0].csize;
  run_branch<kOnChip>(g.m[member], smem_raw);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches `G` clusters of
// `csize` CTAs of `threads` threads on `stream`, cluster g running member
// g from slot slots[g] of the branch store (D [B, R, W], e/rmin/er/off/act
// [B, R], cons [B, C], clen [B]) into row g of the deposit buffers (dD [G,
// R, W], de/drmin/der [G, R], dcons [G, C], dclen [G], out [G, stride]).
// `params` is [G, 7] int32 per member: slot, len0, me_budget, other_cost,
// other_len, max_steps, first_sym.  Records are never absorbed.  The plan
// fields are `plan_run`'s (`scratch` [G, R, W] holds the second buffer of
// a device-memory band).  Returns 0 on success, -1 when the plan does not
// cover the shape or G is out of range, -2 when no cluster of that shape
// fits on the device, else the CUDA error; the launch does not
// synchronise.
extern "C" int run_ragged_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* dD, void* de, void* drmin,
    void* der, void* dcons, void* dclen, void* scratch, void* out,
    const int* params, int G, int stride, int R, int W, int C, int L, int A,
    int min_count, int l2, int wc, int et, int csize, int threads, int rpc,
    int rpw, int on_chip, long long smem, void* stream) {
  if (G < 1 || G > kMaxGang || (!on_chip && scratch == nullptr)) return -1;
  GangArgs g;
  const size_t RW = (size_t)R * W;
  for (int k = 0; k < G; ++k) {
    const int* p = params + 7 * k;
    const size_t slot = (size_t)p[0];
    Args& a = g.m[k];
    a.Ds = static_cast<const int32_t*>(D) + slot * RW;
    a.Dh = static_cast<int32_t*>(dD) + k * RW;
    a.e_in = static_cast<const int32_t*>(e) + slot * R;
    a.rmin_in = static_cast<const int32_t*>(rmin) + slot * R;
    a.er_in = static_cast<const int32_t*>(er) + slot * R;
    a.e_out = static_cast<int32_t*>(de) + (size_t)k * R;
    a.rmin_out = static_cast<int32_t*>(drmin) + (size_t)k * R;
    a.er_out = static_cast<int32_t*>(der) + (size_t)k * R;
    a.off = static_cast<const int32_t*>(off) + slot * R;
    a.act = static_cast<const uint8_t*>(act) + slot * R;
    a.cons_in = static_cast<const int32_t*>(cons) + slot * C;
    a.cons_out = static_cast<int32_t*>(dcons) + (size_t)k * C;
    a.clen_in = static_cast<const int32_t*>(clen) + slot;
    a.clen_out = static_cast<int32_t*>(dclen) + k;
    a.reads = static_cast<const int16_t*>(reads);
    a.rlen = static_cast<const int32_t*>(rlen);
    a.scratch = on_chip ? nullptr : static_cast<int32_t*>(scratch) + k * RW;
    a.out = static_cast<int32_t*>(out) + (size_t)k * stride;
    a.rec_steps = nullptr;  // allow_records = 0: never written
    a.rec_fins = nullptr;
    a.len0 = p[1];
    a.me_budget = p[2];
    a.other_cost = p[3];
    a.other_len = p[4];
    a.max_steps = p[5];
    a.first_sym = p[6];
    a.min_count = min_count; a.l2 = l2; a.wc = wc; a.et = et;
    a.allow_records = 0;
    set_shape(a, R, W, C, L, A, csize, threads, rpc, rpw);
    if (!plan_ok(a, threads, on_chip, (size_t)smem) ||
        a.o_syms + a.max_steps + 1 > stride || a.len0 < 0 ||
        a.len0 + a.max_steps + 1 >= C)
      return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_chip ? launch_clusters(run_ragged_kernel<true>, g, csize, G,
                                   threads, (size_t)smem, st)
                 : launch_clusters(run_ragged_kernel<false>, g, csize, G,
                                   threads, (size_t)smem, st);
}

// How many clusters of the gang kernel's shape fit on the device at once
// (the co-resident members of one launch), or a negative CUDA error.
extern "C" int run_ragged_max_clusters(int csize, int threads, int on_chip,
                                       long long smem) {
  int clusters = 0;
  std::lock_guard<std::mutex> lock(g_checked_mu);
  const int err =
      on_chip ? cluster_capacity(run_ragged_kernel<true>, csize, threads,
                                 (size_t)smem, &clusters)
              : cluster_capacity(run_ragged_kernel<false>, csize, threads,
                                 (size_t)smem, &clusters);
  return err > 0 ? -err : (err < 0 ? err : clusters);
}
