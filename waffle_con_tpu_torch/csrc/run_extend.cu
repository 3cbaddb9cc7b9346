// Fused single-branch run loop of the consensus search, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_j_run_pallas` (body `_mkkernel`) of
// waffle_con_tpu/ops/pallas_run.py, and the per-lane gather mode of the
// XLA loop `_j_run` (waffle_con_tpu/ops/jax_scorer.py) that stands in for
// it when a branch's reads sit at different offsets.  One launch is one
// `run_extend` call on one branch slot: a forced first push, then a loop
// that appends one consensus symbol per step while the reads' tip votes
// name a unique passing candidate, and a final stats snapshot.  Decision
// for decision it computes what waffle_con_tpu_torch/ops/run_kernel.py's
// `run_extend_plain` computes (stop codes 1-5, record absorption, the
// float32 vote fold under the VOTE_EPS contract).
//
// The loop itself, what bounds it and its design (one thread-block
// cluster per branch, the band in shared memory, one cluster barrier a
// step, partials folded in rank order) are in csrc/run_body.cuh, which the
// frontier-gang kernel (csrc/run_ragged.cu) shares.  One SM, as on the
// TPU's one core, spends ~100 us on a step at the north star; one cluster
// of 16 CTAs about 6 us (NVIDIA H100 80GB HBM3, 700 W).  The shard
// instance (`run_extend_shards_launch`) runs the same kernel on a
// read-sharded store whose shards share the card, one launch for all of
// them (csrc/store_shards.cuh).

#include "run_body.cuh"

namespace {

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads, 1) run_extend_kernel(Args a) {
  extern __shared__ __align__(16) char smem_raw[];
  run_branch<kOnChip>(a, smem_raw);
}

}  // namespace

namespace {

// The scalars of a run and the plan into `a` (its store set by the
// caller), then the launch.
int launch_run(Args& a, int R, int W, int C, int L, int A, int me_budget,
               int other_cost, int other_len, int min_count, int l2,
               int max_steps, int first_sym, int allow_records, int wc,
               int et, int csize, int threads, int rpc, int rpw, int on_chip,
               long long smem, void* scratch, void* stream) {
  a.scratch = static_cast<int32_t*>(scratch);
  a.me_budget = me_budget; a.other_cost = other_cost;
  a.other_len = other_len; a.min_count = min_count; a.l2 = l2;
  a.max_steps = max_steps; a.first_sym = first_sym;
  a.allow_records = allow_records; a.wc = wc; a.et = et;
  a.len0 = -1;
  const StoreShard* sh = a.sh;
  const int nsh = a.nsh, Rs = a.Rs, slot = a.slot;
  set_shape(a, R, W, C, L, A, csize, threads, rpc, rpw);
  a.sh = sh; a.nsh = nsh; a.Rs = Rs; a.slot = slot;
  if (!plan_ok(a, threads, on_chip, (size_t)smem) ||
      (!on_chip && scratch == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_chip ? launch_clusters(run_extend_kernel<true>, a, csize, 1,
                                   threads, (size_t)smem, st)
                 : launch_clusters(run_extend_kernel<false>, a, csize, 1,
                                   threads, (size_t)smem, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches one cluster of
// `csize` CTAs of `threads` threads on `stream`, with the geometry of the
// plan (`plan_run` in ops/run_kernel.py): `rpc` reads per CTA, `rpw` per
// warp, the band on chip (`on_chip`) or in device memory (`scratch` then
// holds the second buffer), `smem` bytes of dynamic shared memory.  Slot
// `h` of the branch store is read and updated in place.
// Returns 0 on success, -1 when the plan does not cover the shape or its
// shared memory disagrees with the kernel's layout, -2 when no cluster of
// that shape fits on the device, else the CUDA error; the launch does not
// synchronise.
extern "C" int run_extend_launch(
    void* D, void* e, void* rmin, void* er, void* off, void* act, void* cons,
    void* clen, void* reads, void* rlen, void* scratch, void* out,
    void* rec_steps, void* rec_fins, int h, int R, int W, int C, int L,
    int A, int me_budget, int other_cost, int other_len, int min_count,
    int l2, int max_steps, int first_sym, int allow_records, int wc, int et,
    int csize, int threads, int rpc, int rpw, int on_chip, long long smem,
    void* stream) {
  const size_t hR = (size_t)h * R;
  Args a;
  a.Ds = static_cast<int32_t*>(D) + hR * W;
  a.Dh = static_cast<int32_t*>(D) + hR * W;
  a.e_in = a.e_out = static_cast<int32_t*>(e) + hR;
  a.rmin_in = a.rmin_out = static_cast<int32_t*>(rmin) + hR;
  a.er_in = a.er_out = static_cast<int32_t*>(er) + hR;
  a.off = static_cast<const int32_t*>(off) + hR;
  a.act = static_cast<const uint8_t*>(act) + hR;
  a.cons_in = a.cons_out = static_cast<int32_t*>(cons) + (size_t)h * C;
  a.clen_in = a.clen_out = static_cast<int32_t*>(clen) + h;
  a.reads = static_cast<const int16_t*>(reads);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.out = static_cast<int32_t*>(out);
  a.rec_steps = static_cast<int32_t*>(rec_steps);
  a.rec_fins = static_cast<int32_t*>(rec_fins);
  a.sh = nullptr;
  a.nsh = 1; a.Rs = R; a.slot = 0;
  return launch_run(a, R, W, C, L, A, me_budget, other_cost, other_len,
                    min_count, l2, max_steps, first_sym, allow_records, wc,
                    et, csize, threads, rpc, rpw, on_chip, smem, scratch,
                    stream);
}

// The shard instance: the same run on slot `h` of a read-sharded store
// whose `nsh` shards (`Rs` reads each, R = nsh Rs) share this card, one
// launch for all of them.  `shards` is the device copy of the shards'
// records (csrc/store_shards.cuh `StoreShard`, ops/branch_kernel.py
// `_Shard`); each read's rows are read and updated in place in its own
// shard, and each symbol and the final length go to every shard.  The
// plan, `scratch`, `out` and the record buffers are the one-store launch's
// at the store's R.  Returns as `run_extend_launch`, and -1 too when the
// shards do not cover R.
extern "C" int run_extend_shards_launch(
    const void* shards, int nsh, int Rs, void* scratch, void* out,
    void* rec_steps, void* rec_fins, int h, int R, int W, int C, int L,
    int A, int me_budget, int other_cost, int other_len, int min_count,
    int l2, int max_steps, int first_sym, int allow_records, int wc, int et,
    int csize, int threads, int rpc, int rpw, int on_chip, long long smem,
    void* stream) {
  if (shards == nullptr || !shards::cover(shards, nsh, Rs, R) || h < 0)
    return -1;
  Args a;
  a.Ds = a.Dh = nullptr;
  a.e_in = a.rmin_in = a.er_in = nullptr;
  a.e_out = a.rmin_out = a.er_out = nullptr;
  a.off = nullptr;
  a.act = nullptr;
  a.cons_in = a.cons_out = nullptr;
  a.clen_in = a.clen_out = nullptr;
  a.reads = nullptr;
  a.rlen = nullptr;
  a.out = static_cast<int32_t*>(out);
  a.rec_steps = static_cast<int32_t*>(rec_steps);
  a.rec_fins = static_cast<int32_t*>(rec_fins);
  a.sh = static_cast<const StoreShard*>(shards);
  a.nsh = nsh; a.Rs = Rs; a.slot = h;
  return launch_run(a, R, W, C, L, A, me_budget, other_cost, other_len,
                    min_count, l2, max_steps, first_sym, allow_records, wc,
                    et, csize, threads, rpc, rpw, on_chip, smem, scratch,
                    stream);
}
