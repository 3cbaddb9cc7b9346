// Gang run kernel of the consensus search, for Hopper (sm_90a).
//
// Replaces the XLA loop `_j_run_ragged` (built by `BandArena._build_kernel`
// in waffle_con_tpu/ops/ragged.py): the K=1 run body over up to 8
// members at once.  A member is one branch's run_extend: the frontier
// gang's members are branches of one search (one store, one shape); the
// serving pool's are branches of different jobs (each its own store, and
// its own R, W, C, L, A and search constants).  Per member: a forced first
// push when first_sym >= 0 (only band overflow, code 5, refuses it), then
// one symbol a step until a stop code in the order 3 (over budget or
// loses the pop) > 2 (reached; records are never absorbed) > 1 (dirty
// vote) > 4 (max_steps), then 5 (overflow after the column step), and the
// stats of the stopped state.
//
// What bounds it.  As the run kernel: each member's steps are a chain of
// dependent column steps, so a member is bound by the latency of one step
// (R x W cells, ~20 int32 operations each, then one decision over every
// read).  The gang adds no work to a member; it runs the members side by
// side instead of one launch after another.
//
// Design.  Each member runs csrc/run_body.cuh's `run_branch`, the run
// kernel's own body, on a contiguous range of CTAs of a thread-block
// cluster: ranks [base, base + c), where c is the cluster of the member's
// own `plan_run`.  XLA's segment reduces over a pool of member rows become
// each member's own rank-order fold, and the float32 vote fold is the run
// kernel's bit for bit, so a member's result equals its solo launch from
// the same state.
//  * Member-scoped exchange.  The run body's instantiation for the gang
//    (kScoped) replaces the whole-cluster barrier of each step by an
//    exchange among the member's own CTAs: each CTA stores its partial
//    into its peers' parity-double-buffered gather rows with st.async,
//    completing bytes on each peer's own mbarrier, and waits on its own
//    (run_body.cuh says why two parities suffice, and how a CTA leaves).
//    No CTA waits on another member, so members share a cluster.
//  * Packing.  `plan_members` in ops/ragged_kernel.py packs the members
//    by their own c, first fit decreasing, into clusters of the largest
//    member's c, and gives each its (cluster, base).  A group of one
//    R 256 / W 514 member (16 CTAs) and seven R 32 / W 130 members (2 CTAs
//    each) takes 2 clusters, not 8, so it runs in one wave (7 clusters of
//    16 fit on an H100 at once).  CTAs a packed cluster does not use only
//    meet the start barrier and leave.  The solo run kernel keeps the
//    cluster barrier (run_body.cuh's other instantiation).
//  * Per-member geometry.  Each member carries its own descriptor
//    (`RaggedMember`, built by the host): its store's addresses at its
//    slot, R, W (the row stride JAX calls wrow), C, L, A, its reads, its
//    search constants, its own `plan_run` split of reads over CTAs and
//    warps (rpc, rpw, c) and its place (cluster, base).  The CTA's threads
//    and the dynamic shared memory are one per launch, so the launch takes
//    the largest member's; the warps past a member's plan hold no read and
//    add identity partials, so its fold is its solo launch's fold, in the
//    same warp order.
//  * The band's placement is per member: the kernel holds both of
//    `run_branch`'s instantiations (band in shared memory, band in device
//    memory with a scratch buffer), and each member takes its own.
//  * Members write either in place (the serving pool: the slot is
//    advanced, as `run_extend` does) or to deposit rows (the frontier
//    gang: no slot is touched), as the host's descriptor points.
//  * A member whose slot does not hold the consensus length the host
//    expects runs nothing and reports code -1.
//  * A launch holds at most 8 descriptors (`GangArgs`, passed by value as
//    a __grid_constant__, under the 4 KB launch-parameter limit); a larger
//    group runs as consecutive launches of 8, which gives the same results
//    because members are independent.  More clusters than fit on the card
//    at once run in waves (`run_ragged_max_clusters` gives how many fit).

#include "run_body.cuh"

// One member of a launch, built by the host (mirrors ragged_kernel._Member
// field for field; outside the file's unnamed namespace, since the C
// entry point takes it): the addresses are already at the member's slot (or
// deposit row).
struct RaggedMember {
  const int32_t* Ds;
  int32_t* Dh;
  const int32_t* e_in;
  const int32_t* rmin_in;
  const int32_t* er_in;
  int32_t* e_out;
  int32_t* rmin_out;
  int32_t* er_out;
  const int32_t* off;
  const uint8_t* act;
  const int32_t* cons_in;
  int32_t* cons_out;
  const int32_t* clen_in;
  int32_t* clen_out;
  const int16_t* reads;
  const int32_t* rlen;
  int32_t* scratch;  // [R, W] second band buffer (band in device memory)
  int32_t* out;      // packed outputs (run_kernel.out_layout)
  int R, W, C, L, A;
  int len0, me_budget, other_cost, other_len, max_steps, first_sym;
  int min_count, l2, wc, et;
  int rpc, rpw, on_chip, stride;
  int cluster, base, ctas;  // its place: CTAs [base, base + ctas) of
                            // cluster `cluster` (ctas: its plan's cluster)
};

namespace {

constexpr int kMaxGang = 8;  // ragged_kernel.MAX_GANG

struct GangArgs {
  Args m[kMaxGang];
  int on_chip[kMaxGang];
  int cluster[kMaxGang];
  int base[kMaxGang];
  int G;
  int csize;  // CTAs of a cluster of the launch
};

__global__ void __launch_bounds__(kMaxThreads, 1)
    run_ragged_kernel(const __grid_constant__ GangArgs g) {
  extern __shared__ __align__(16) char smem_raw[];
  const int cluster = blockIdx.x / g.csize;
  const int rank = blockIdx.x % g.csize;  // the CTA's rank in its cluster
  int member = -1;
  for (int k = 0; k < g.G; ++k) {
    if (g.cluster[k] == cluster && rank >= g.base[k] &&
        rank < g.base[k] + g.m[k].csize) {
      member = k;
    }
  }
  if (member < 0) {
    // a CTA no member uses: the start barrier every CTA meets, then leave
    cg::this_cluster().sync();
    return;
  }
  if (g.on_chip[member])
    run_branch<true, true>(g.m[member], smem_raw, g.base[member]);
  else
    run_branch<false, true>(g.m[member], smem_raw, g.base[member]);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches `nclusters` clusters
// of `csize` CTAs of `threads` threads with `smem` bytes of dynamic shared
// memory on `stream`; member k of `members` (G of them, 1-8) runs on CTAs
// [base, base + ctas) of its cluster.  Records are never absorbed.
// Returns 0 on success, -1 when a member's descriptor does not fit the
// launch (its split, its place, its shared memory, its output row, its
// consensus capacity), two members overlap or G is out of range, -2 when
// no cluster of that shape fits on the device, else the CUDA error; the
// launch does not synchronise.
extern "C" int run_ragged_launch(const RaggedMember* members, int G,
                                 int nclusters, int csize, int threads,
                                 long long smem, void* stream) {
  if (G < 1 || G > kMaxGang || nclusters < 1 || nclusters > G ||
      csize < 1 || csize > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return -1;
  GangArgs g;
  g.G = G;
  g.csize = csize;
  for (int k = 0; k < G; ++k) {
    const RaggedMember& p = members[k];
    Args& a = g.m[k];
    a.Ds = p.Ds;
    a.Dh = p.Dh;
    a.e_in = p.e_in;
    a.rmin_in = p.rmin_in;
    a.er_in = p.er_in;
    a.e_out = p.e_out;
    a.rmin_out = p.rmin_out;
    a.er_out = p.er_out;
    a.off = p.off;
    a.act = p.act;
    a.cons_in = p.cons_in;
    a.cons_out = p.cons_out;
    a.clen_in = p.clen_in;
    a.clen_out = p.clen_out;
    a.reads = p.reads;
    a.rlen = p.rlen;
    a.scratch = p.on_chip ? nullptr : p.scratch;
    a.out = p.out;
    a.rec_steps = nullptr;  // allow_records = 0: never written
    a.rec_fins = nullptr;
    a.len0 = p.len0;
    a.me_budget = p.me_budget;
    a.other_cost = p.other_cost;
    a.other_len = p.other_len;
    a.max_steps = p.max_steps;
    a.first_sym = p.first_sym;
    a.min_count = p.min_count;
    a.l2 = p.l2;
    a.wc = p.wc;
    a.et = p.et;
    a.allow_records = 0;
    // the member's own cluster (its fold's CTAs) and split, the launch's
    // warps
    set_shape(a, p.R, p.W, p.C, p.L, p.A, p.ctas, threads, p.rpc, p.rpw);
    g.on_chip[k] = p.on_chip != 0;
    g.cluster[k] = p.cluster;
    g.base[k] = p.base;
    const bool fits =
        p.ctas >= 1 && p.cluster >= 0 && p.cluster < nclusters &&
        p.base >= 0 && p.base + p.ctas <= csize && p.rpc >= 1 &&
        p.rpw >= 1 && (long long)p.ctas * p.rpc >= p.R &&
        (long long)a.nw * p.rpw >= p.rpc && (!p.on_chip || p.rpw <= 32) &&
        p.A >= 1 && p.W >= 4 && (p.on_chip || p.scratch != nullptr) &&
        smem_bytes(p.rpc, a.nw, p.W, p.A, p.on_chip != 0) <= (size_t)smem &&
        a.o_syms + p.max_steps + 1 <= p.stride && p.len0 >= 0 &&
        p.len0 + p.max_steps + 1 < p.C;
    if (!fits) return -1;
    for (int q = 0; q < k; ++q) {
      const RaggedMember& o = members[q];
      if (o.cluster == p.cluster && o.base < p.base + p.ctas &&
          p.base < o.base + o.ctas)
        return -1;  // two members on one CTA
    }
  }
  return launch_clusters(run_ragged_kernel, g, csize, nclusters, threads,
                         (size_t)smem, static_cast<cudaStream_t>(stream));
}

// How many clusters of the gang kernel's launch shape fit on the device at
// once (the co-resident members of one launch), or a negative CUDA error.
extern "C" int run_ragged_max_clusters(int csize, int threads,
                                       long long smem) {
  int clusters = 0;
  std::lock_guard<std::mutex> lock(g_checked_mu);
  const int err = cluster_capacity(run_ragged_kernel, csize, threads,
                                   (size_t)smem, &clusters);
  return err > 0 ? -err : (err < 0 ? err : clusters);
}
