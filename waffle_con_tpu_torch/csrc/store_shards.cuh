// The read shards of one branch store on one card, as the shard instances
// of the run, dual-run and arena kernels address them (csrc/run_body.cuh,
// csrc/run_extend_dual.cu, csrc/arena.cu).
//
// A read-sharded store (waffle_con_tpu_torch/ops/sharded_scorer.py) keeps
// one branch store a shard, each with Rs of the store's R = n Rs reads:
// shard k holds reads k Rs .. (k + 1) Rs - 1, its slots are the store's
// (allocated on every shard in lockstep), and every shard holds the same
// consensus rows.  A shard instance takes one record a shard (the host
// copies the records into device memory once a call; the kernel parameter
// holds only their address) and addresses read r of slot h as row r % Rs
// of slot h in shard r / Rs.  Everything else of the launch stays over the
// store's global reads: the CTAs' blocks of reads, each warp's reads, the
// rank-order fold, the outputs and the scratch rows.  So a shard instance
// folds the same reads in the same order as the one-store launch at the
// same R, and computes what that launch computes on the gathered store,
// bit for bit; a CTA whose block straddles two shards reads each read
// through its own shard.  A consensus symbol or length is written to every
// shard.

#pragma once

#include <cstdint>

namespace {

// One read shard's store and reads (ops/branch_kernel.py's `_Shard` and
// csrc/branch_step.cu's `BranchShard`, field for field).
struct StoreShard {
  int32_t* D;            // [B, Rs, W]
  int32_t* e;            // [B, Rs]
  int32_t* rmin;         // [B, Rs]
  int32_t* er;           // [B, Rs]
  int32_t* off;          // [B, Rs]
  uint8_t* act;          // [B, Rs] (torch.bool)
  int32_t* cons;         // [B, C]
  int32_t* clen;         // [B]
  const int16_t* reads;  // [Rs, L] dense symbol ids, -1 padded
  const int32_t* rlen;   // [Rs]
};

namespace shards {

constexpr int kMax = 16;  // branch_kernel.MAX_SHARDS

// The words of one (slot, read) of a store: its band row, its folds,
// offset and activity, and its read's symbols and length.
struct Cell {
  int32_t* D;  // [W]
  int32_t* e;
  int32_t* rmin;
  int32_t* er;
  int32_t* off;
  uint8_t* act;
  const int16_t* rd;  // [L]
  const int32_t* rlen;
};

// Read l of slot `slot` in a store of `rows` reads a slot.
__device__ __forceinline__ Cell cell_of(const StoreShard& s, int rows, int W,
                                        int L, int slot, int l) {
  const size_t i = (size_t)slot * rows + l;
  return Cell{s.D + i * W, s.e + i,   s.rmin + i,
              s.er + i,    s.off + i, s.act + i,
              s.reads + (size_t)l * L, s.rlen + l};
}

// Read r (of the store's R) of slot `slot`: on the shards `sh` (Rs reads
// each), row r % Rs of shard r / Rs; with no shards (`sh` null), row r of
// the one store `own`.
__device__ __forceinline__ Cell cell(const StoreShard* sh, int Rs,
                                     const StoreShard& own, int R, int W,
                                     int L, int slot, int r) {
  if (sh == nullptr) return cell_of(own, R, W, L, slot, r);
  const int k = r / Rs;
  return cell_of(sh[k], Rs, W, L, slot, r - k * Rs);
}

// Whether a launch's shard records cover its R reads (a null `sh`: one
// store, always).
inline bool cover(const void* sh, int nsh, int Rs, int R) {
  return sh == nullptr ||
         (nsh >= 1 && nsh <= kMax && Rs >= 1 && (long long)nsh * Rs == R);
}

}  // namespace shards

}  // namespace
