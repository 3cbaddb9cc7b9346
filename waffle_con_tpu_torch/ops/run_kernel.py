"""The single-branch run loop behind ``TorchScorer.run_extend``.

Four pieces, one contract:

* :func:`run_extend_plain` — the loop in plain PyTorch over the column
  primitives of :mod:`waffle_con_tpu_torch.ops.torch_scorer`, one
  consensus symbol per iteration (its vote nomination is
  :func:`nominate`).  It is what runs for tensors on the CPU, and the
  yardstick the CUDA kernel is held to on the card.
* :func:`plan_run` — the launch geometry of the kernel (one
  thread-block cluster per run) from the shape alone.
* :func:`run_extend_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/run_extend.cu`` (built with ``nvcc`` at first use by
  :mod:`~waffle_con_tpu_torch.ops.cuda_build` and bound with
  ``ctypes``); it counts its launches in
  ``run_extend_cuda.launches``.
* :func:`run_extend` — the dispatch rule: a state on the CPU runs the
  plain loop, a state on a CUDA device launches the kernel (or raises).
* :func:`run_extend_shards` — the same run on a read-sharded store
  (``ops/sharded_scorer.py``) whose shards share one device: on a card
  one launch of the kernel's shard instance for every shard
  (:func:`run_extend_shards_cuda`, ``run_extend_shards_launch``), on the
  CPU :func:`run_extend_shards_plain` (the shards' slot gathered into one
  store, the plain loop, the result split back).

The contract is the one of ``waffle_con_tpu``'s ``_j_run_pallas``
(``ops/pallas_run.py``) and ``_j_run`` (``ops/jax_scorer.py``): a forced
first push (only band overflow, code 5, refuses it), then one symbol per
step while the tip votes name a unique passing candidate — stop codes 3
(the branch loses the next pop or goes over budget), 2 (reached end and
the record cannot be absorbed), 1 (dirty vote), 4 (step cap), 5 (band
overflow, step not committed) — with reached-end records absorbed into
``REC_CAP`` buffers, and a final stats snapshot.  Slot ``h`` of the
branch store is updated in place.

Results come back as one packed ``int32`` tensor (see :func:`out_layout`)
so the host pays a single device-to-host copy per call, plus the record
buffers when records were absorbed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.ops import branch_kernel, cuda_build, state_io
from waffle_con_tpu_torch.ops.cuda_build import BUILD_DIR, build, build_info  # noqa: F401
from waffle_con_tpu_torch.ops.torch_scorer import (
    REC_CAP,
    VOTE_EPS,
    col_step,
    finalized,
    gather_window,
    stats_core,
)
from waffle_con_tpu_torch.runtime import faults


class RunArgs(NamedTuple):
    """Per-call scalars of one run (host integers, passed by value)."""

    me_budget: int
    other_cost: int
    other_len: int
    min_count: int
    l2: bool
    max_steps: int
    first_sym: int
    allow_records: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size (rows of ``occ``)
    a_real: int


def out_layout(R: int, A: int, max_steps: int) -> Dict[str, Tuple[int, int]]:
    """``name -> (start, stop)`` of each field in the packed ``int32``
    output: 8 scalars (steps, code, rec_count, fin_ovf, clen), then the
    final stats snapshot (eds, split, reached, fin: ``[R]`` each; occ:
    ``[R, A]`` row-major), then the committed symbols (``max_steps + 1``
    slots: a forced first push may commit one step even at
    ``max_steps == 0``)."""
    fields = [
        ("scalars", 8), ("eds", R), ("split", R), ("reached", R),
        ("fin", R), ("occ", R * A), ("syms", max_steps + 1),
    ]
    out = {}
    at = 0
    for name, n in fields:
        out[name] = (at, at + n)
        at += n
    return out


def _wrap32(x: int) -> int:
    """Two's-complement int32 wrap of a Python integer (the device folds
    sum and square in wrapping int32 arithmetic)."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


# ---------------------------------------------------------------------
# launch planner of the CUDA kernel

#: shared memory a CTA may use on an H100 (227 KB, the opt-in maximum)
SMEM_LIMIT = 232448
#: largest thread-block cluster (16 needs the non-portable cluster size)
MAX_CLUSTER = 16
#: warps of a CTA (512 threads, so a thread may hold 128 registers)
MAX_WARPS = 16


class RunPlan(NamedTuple):
    """Launch geometry of one ``run_extend`` kernel call."""

    #: CTAs of the one thread-block cluster
    cluster: int
    #: threads of each CTA (32 per warp)
    threads: int
    #: reads of each CTA (contiguous blocks; the last CTA may own fewer)
    reads_per_cta: int
    #: reads of each warp (contiguous within the CTA)
    reads_per_warp: int
    #: ``"smem"``: both band buffers of a CTA's reads in its shared
    #: memory; ``"global"``: slot ``h`` and a scratch buffer in device
    #: memory
    band: str
    #: dynamic shared memory of each CTA, bytes
    smem_bytes: int


def _part_words(A: int) -> int:
    return (8 + 2 * A + 3) & ~3


def _ring_len(W: int) -> int:
    n = 1
    while n < W + 2:
        n <<= 1
    return n


def _smem_bytes(rpc: int, nw: int, W: int, A: int, on_chip: bool) -> int:
    """Dynamic shared memory of one CTA (the layout of ``carve`` in
    ``csrc/run_extend.cu``): the CTA's partial and every CTA's partial
    by parity, 11 words per read, a histogram and a partial row per
    warp, the cluster's votes and the broadcast decision; on chip also
    two band buffers and a symbol ring per read."""
    P = _part_words(A)
    words = (1 + 2 * MAX_CLUSTER) * P + 11 * rpc + nw * (A + P) + 2 * A + 8
    nbytes = 4 * words
    if on_chip:
        nbytes += 8 * rpc * W + 2 * rpc * _ring_len(W)
    return nbytes


def plan_run(R: int, W: int, A: int) -> RunPlan:
    """The launch geometry of the run kernel for ``R`` reads, band width
    ``W`` and ``A`` dense symbols.  The rule:

    * the smallest cluster (1, 2, 4, 8 or 16 CTAs) whose CTAs own at most
      16 reads each, one read per warp, with the band on chip;
    * else 16 CTAs of up to 16 warps, several reads per warp, with the
      band on chip when the CTA's share fits in shared memory (and a warp
      feeds at most 32 symbol rings, one a lane), and in device memory
      when it does not;
    * where even that overflows a CTA's shared memory (the per-warp
      histograms and partials grow with ``A``), half the warps, then half
      again, each warp taking more reads.

    Raises ``ValueError`` on a shape no plan takes (an empty read set, a
    band narrower than 4 cells or odd, no symbol, or per-read state
    that exceeds a CTA's shared memory even on one warp with the band off
    chip)."""
    if R < 1 or A < 1 or W < 4 or W % 2:
        raise ValueError(f"no run plan for R={R}, W={W}, A={A}")

    def make(c, rpc, nw, band):
        return RunPlan(c, 32 * nw, rpc, -(-rpc // nw), band,
                       _smem_bytes(rpc, nw, W, A, band == "smem"))

    c = 1
    while c <= MAX_CLUSTER:
        rpc = -(-R // c)
        if rpc <= MAX_WARPS and _smem_bytes(rpc, rpc, W, A, True) <= SMEM_LIMIT:
            return make(c, rpc, rpc, "smem")
        c *= 2
    rpc = -(-R // MAX_CLUSTER)
    nw = min(MAX_WARPS, rpc)
    while nw >= 1:
        for band in ("smem", "global"):
            plan = make(MAX_CLUSTER, rpc, nw, band)
            if plan.smem_bytes <= SMEM_LIMIT and (
                    band == "global" or plan.reads_per_warp <= 32):
                return plan
        nw //= 2
    raise ValueError(
        f"no run plan for R={R}, W={W}, A={A}: {rpc} reads per CTA need "
        f"{plan.smem_bytes} bytes of shared memory (limit {SMEM_LIMIT})"
    )


# ---------------------------------------------------------------------
# plain PyTorch version


def vote_counts(occ, split):
    """Fractional tip votes of a snapshot: each read splits one unit
    across its tips, summed over the reads in float32 (the device folds
    in another order; the VOTE_EPS contract of :func:`nominate` covers
    the difference).  Returns ``(counts [A] float32, has_votes [A])``."""
    frac = torch.where(
        split[:, None] > 0,
        occ.float() / split.clamp(min=1)[:, None].float(),
        torch.zeros((), dtype=torch.float32, device=occ.device),
    )
    return frac.sum(0), (occ > 0).any(0)


def nominate(counts, has_votes, min_count: int, wc: int, all_exact: bool,
             cost_overflow: bool) -> Tuple[int, int, bool]:
    """The run loop's nomination from the summed votes: wildcard drop,
    passing threshold ``min(min_count, max vote)``, the EPS near-tie
    guard, first-max tie-break.  Returns ``(npass, sym, dirty)``: the run
    may commit ``sym`` only when ``dirty`` is false.  ``counts`` and
    ``has_votes`` are not modified."""
    counts = counts.to(torch.float32).clone()
    has_votes = has_votes.clone()
    eps = float(VOTE_EPS)
    mcf = torch.tensor(float(min_count), dtype=torch.float32,
                       device=counts.device)
    n_cands = int(has_votes.sum())
    if wc >= 0 and n_cands > 1:
        has_votes[wc] = False
        counts[wc] = 0.0
    neg1 = torch.full_like(counts, -1.0)
    maxc = torch.where(has_votes, counts, neg1).max()
    thr = torch.minimum(mcf, maxc)
    passing = has_votes & (counts >= thr)
    npass = int(passing.sum())
    near_tie = bool((maxc - mcf).abs() < eps) or bool(
        (has_votes & ((counts - thr).abs() < eps)).any()
    )
    dirty = (
        (not all_exact and near_tie)
        or npass != 1
        or n_cands == 0
        or cost_overflow
    )
    sym = int(torch.argmax(torch.where(passing, counts, neg1)))
    return npass, sym, dirty


def run_extend_plain(state, h: int, reads, rlen, args: RunArgs):
    """The run loop in plain PyTorch (same contract and outputs as the
    CUDA kernel).  Returns ``(out, rec_steps, rec_fins)``."""
    run_extend_plain.calls += 1
    dev = state["D"].device
    W = state["D"].shape[2]
    R = state["D"].shape[1]
    E = (W - 2) // 2
    A = args.a_real
    off = state["off"][h]
    act = state["act"][h]
    D = state["D"][h].clone()
    e = state["e"][h].clone()
    rmin = state["rmin"][h].clone()
    er = state["er"][h].clone()
    clen = int(state["clen"][h])

    lay = out_layout(R, A, args.max_steps)
    syms = []
    rec_steps = torch.zeros(REC_CAP, dtype=torch.int32, device=dev)
    rec_fins = torch.zeros((REC_CAP, R), dtype=torch.int32, device=dev)

    def window(j):
        return gather_window(reads, j, off, E, W)

    def step(D, e, rmin, er, j, sym):
        return col_step(D, e, rmin, er, off, act, rlen, window(j), j + 1,
                        sym, args.wc, args.et, E)

    def overflows(e_new):
        return bool((act & (e_new >= E)).any())

    steps = 0
    code = 0
    if args.first_sym >= 0:
        Df, ef, rminf, erf = step(D, e, rmin, er, clen, args.first_sym)
        if overflows(ef):
            code = 5
        else:
            D, e, rmin, er = Df, ef, rminf, erf
            syms.append(args.first_sym)
            clen += 1
            steps = 1

    budget = args.me_budget
    rec_count = 0
    while code == 0:
        eds, occ, split, reached = stats_core(
            D, e, rmin, er, off, act, rlen, window(clen), clen, A, E
        )
        fin_j, _ = finalized(e, rmin, act, E)
        eds64 = eds.long()
        fin64 = fin_j.long()
        total = _wrap32((eds64 * eds64 if args.l2 else eds64).sum())
        fin_total = _wrap32((fin64 * fin64 if args.l2 else fin64).sum())
        max_eds = int(eds.max())
        fin_max = int(fin_j.max())
        cost_overflow = args.l2 and max_eds > 2048
        fin_ovf_j = fin_max >= E
        fin_cost_ovf = args.l2 and fin_max > 2048
        all_exact = not bool(((split > 0) & ((split & (split - 1)) != 0)).any())
        if args.et:
            reached_here = not bool((act & ~reached).any())
        else:
            reached_here = bool(reached.any())

        counts, has_votes = vote_counts(occ, split)
        _npass, sym, dirty = nominate(
            counts, has_votes, args.min_count, args.wc, all_exact,
            cost_overflow,
        )
        rec_blocked = (
            not args.allow_records
            or fin_ovf_j
            or fin_cost_ovf
            or rec_count >= REC_CAP
        )
        wins_pop = total < args.other_cost or (
            total == args.other_cost and clen > args.other_len
        )
        if total > budget or not wins_pop:
            code = 3
        elif reached_here and rec_blocked:
            code = 2
        elif dirty:
            code = 1
        elif steps >= args.max_steps:
            code = 4
        if code != 0:
            break
        D2, e2, rmin2, er2 = step(D, e, rmin, er, clen, sym)
        if overflows(e2):
            code = 5
            break
        if reached_here:
            ri = min(rec_count, REC_CAP - 1)
            rec_steps[ri] = steps
            rec_fins[ri] = fin_j
            rec_count += 1
            if fin_total < budget:
                budget = fin_total
        D, e, rmin, er = D2, e2, rmin2, er2
        syms.append(sym)
        clen += 1
        steps += 1

    eds, occ, split, reached = stats_core(
        D, e, rmin, er, off, act, rlen, window(clen), clen, A, E
    )
    fin, fin_ovf = finalized(e, rmin, act, E)
    clen0 = clen - steps
    state["D"][h] = D
    state["e"][h] = e
    state["rmin"][h] = rmin
    state["er"][h] = er
    if steps:
        state["cons"][h, clen0:clen] = torch.tensor(
            syms, dtype=torch.int32, device=dev
        )
    state["clen"][h] = clen

    out = torch.zeros(lay["syms"][1], dtype=torch.int32, device=dev)

    def put(name, value):
        a, b = lay[name]
        out[a:b] = value.reshape(-1).to(torch.int32)

    put("scalars", torch.tensor(
        [steps, code, rec_count, int(fin_ovf), clen, 0, 0, 0],
        dtype=torch.int32, device=dev,
    ))
    put("eds", eds)
    put("split", split)
    put("reached", reached)
    put("fin", fin)
    put("occ", occ)
    if steps:
        a = lay["syms"][0]
        out[a:a + steps] = torch.tensor(syms, dtype=torch.int32, device=dev)
    return out, rec_steps, rec_fins


run_extend_plain.calls = 0


# ---------------------------------------------------------------------
# CUDA kernel: bind, launch (the build lives in ops/cuda_build.py; its
# names stay importable from here)


def _launcher():
    fn = cuda_build.library().run_extend_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 20 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
    return fn


_LAUNCH_ERRORS = {
    -1: "the plan does not match the kernel's layout",
    -2: "no cluster of this shape fits on the device",
}


def _shards_launcher():
    fn = cuda_build.library().run_extend_shards_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 21
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return fn


def _scalars(args: RunArgs):
    """The run's scalars in the C entries' order."""
    return (args.me_budget, args.other_cost, args.other_len, args.min_count,
            int(args.l2), args.max_steps, args.first_sym,
            int(args.allow_records), args.wc, int(args.et))


def _buffers(R: int, W: int, args: RunArgs, plan: RunPlan, dev):
    """A launch's packed output, record buffers and (band in device
    memory) scratch rows."""
    out = torch.empty(out_layout(R, args.a_real, args.max_steps)["syms"][1],
                      dtype=torch.int32, device=dev)
    rec_steps = torch.empty(REC_CAP, dtype=torch.int32, device=dev)
    rec_fins = torch.empty((REC_CAP, R), dtype=torch.int32, device=dev)
    scratch = (None if plan.band == "smem"
               else torch.empty((R, W), dtype=torch.int32, device=dev))
    return out, rec_steps, rec_fins, scratch


def _plan_args(plan: RunPlan):
    return (plan.cluster, plan.threads, plan.reads_per_cta,
            plan.reads_per_warp, int(plan.band == "smem"), plan.smem_bytes)


def _counted(plan: RunPlan) -> None:
    run_extend_cuda.launches += 1
    run_extend_cuda.placements[plan.band] += 1
    run_extend_cuda.last_plan = plan


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def run_extend_cuda(state, h: int, reads, rlen, args: RunArgs):
    """Launch the CUDA run kernel on slot ``h``: one thread-block cluster
    of the geometry :func:`plan_run` gives, the whole run loop inside.
    Same contract and outputs as :func:`run_extend_plain`.  Raises on
    anything the kernel does not take, and when the launch is refused;
    never falls back.  The caller guarantees ``cons`` capacity
    ``C > clen[h] + max_steps + 1``, as ``TorchScorer.run_extend`` does.
    Each launch adds one to ``run_extend_cuda.launches`` and to its band
    placement's count in ``run_extend_cuda.placements``;
    ``run_extend_cuda.last_plan`` is the last launch's plan."""
    D = state["D"]
    dev = D.device
    if dev.type != "cuda":
        raise ValueError("run_extend_cuda needs tensors on a CUDA device")
    B, R, W = D.shape
    C = state["cons"].shape[1]
    want = {
        "D": torch.int32, "e": torch.int32, "rmin": torch.int32,
        "er": torch.int32, "off": torch.int32, "act": torch.bool,
        "cons": torch.int32, "clen": torch.int32,
    }
    for name, dt in want.items():
        t = state[name]
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"state[{name!r}]: need contiguous {dt} on {dev}")
    if reads.dtype != torch.int16 or reads.device != dev or reads.shape[0] != R:
        raise ValueError("reads: need contiguous int16 [R, L] on the state device")
    if rlen.dtype != torch.int32 or rlen.device != dev or rlen.shape != (R,):
        raise ValueError("rlen: need int32 [R] on the state device")
    if not (reads.is_contiguous() and rlen.is_contiguous()):
        raise ValueError("reads/rlen must be contiguous")
    if not 0 <= h < B:
        raise ValueError(f"slot {h} out of range")
    plan = plan_run(R, W, args.a_real)
    launch = _launcher()
    out, rec_steps, rec_fins, scratch = _buffers(R, W, args, plan, dev)
    ptr = _ptr
    rc = launch(
        ptr(D), ptr(state["e"]), ptr(state["rmin"]), ptr(state["er"]),
        ptr(state["off"]), ptr(state["act"]), ptr(state["cons"]),
        ptr(state["clen"]), ptr(reads), ptr(rlen), ptr(scratch), ptr(out),
        ptr(rec_steps), ptr(rec_fins),
        h, R, W, C, reads.shape[1], args.a_real, *_scalars(args),
        *_plan_args(plan), cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, R, W, args, plan)
    _counted(plan)
    return out, rec_steps, rec_fins


def _raise_on(rc: int, R: int, W: int, args: RunArgs, plan: RunPlan,
              shards: int = 0) -> None:
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        on = f", {shards} shards" if shards else ""
        raise RuntimeError(
            f"run_extend kernel launch failed: {why} (R={R}, W={W}, "
            f"A={args.a_real}{on}, {plan})"
        )


run_extend_cuda.launches = 0
run_extend_cuda.placements = {"smem": 0, "global": 0}
run_extend_cuda.last_plan = None


def run_extend_shards_cuda(states, h: int, reads, rlens, args: RunArgs):
    """The run kernel's shard instance: the run of slot ``h`` of a
    read-sharded store whose shards (``states``, one store of ``Rs``
    reads each, with their ``reads`` and ``rlens``) share one card, in
    one launch for all of them, each read's rows updated in place in its
    own shard and each symbol written to every shard.  The plan, the
    output and the records are those of :func:`run_extend_cuda` at the
    store's ``R = n Rs``, so the result is the unsharded kernel's on the
    gathered store, bit for bit.  Raises like :func:`run_extend_cuda`;
    never falls back.  Each launch adds one to
    ``run_extend_cuda.launches`` (the kernel's count) and to
    ``run_extend_shards_cuda.launches``."""
    table = branch_kernel.shard_records(states, reads, rlens)
    B, Rs, W = states[0]["D"].shape
    n = len(states)
    R = n * Rs
    C = states[0]["cons"].shape[1]
    if not 0 <= h < B:
        raise ValueError(f"slot {h} out of range")
    dev = states[0]["D"].device
    plan = plan_run(R, W, args.a_real)
    out, rec_steps, rec_fins, scratch = _buffers(R, W, args, plan, dev)
    rc = _shards_launcher()(
        _ptr(table), n, Rs, _ptr(scratch), _ptr(out), _ptr(rec_steps),
        _ptr(rec_fins), h, R, W, C, reads[0].shape[1], args.a_real,
        *_scalars(args), *_plan_args(plan), cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, R, W, args, plan, n)
    _counted(plan)
    run_extend_shards_cuda.launches += 1
    return out, rec_steps, rec_fins


run_extend_shards_cuda.launches = 0


def run_extend_shards_plain(states, h: int, reads, rlens, args: RunArgs):
    """The shard instance's plain version: slot ``h`` of the shards
    gathered into one store (``state_io.gather_slots``), the plain loop
    on it, the result split back into the shards in place
    (``state_io.scatter_slots``).  Same outputs as
    :func:`run_extend_shards_cuda`."""
    run_extend_shards_plain.calls += 1
    state, rd, rl = state_io.gather_slots(states, [h], reads, rlens)
    out = run_extend_plain(state, 0, rd, rl, args)
    state_io.scatter_slots(states, [h], state)
    return out


run_extend_shards_plain.calls = 0


def run_extend_shards(states, h: int, reads, rlens, args: RunArgs):
    """Dispatch rule of a sharded store's run: shards on one CUDA device
    launch :func:`run_extend_shards_cuda`, shards on the CPU take
    :func:`run_extend_shards_plain`; anything else (the shards on several
    devices) raises, and so does an armed ``pallas_compile`` fault."""
    faults.check_kernel("run")
    kind = shard_placement(states)
    if kind == "fused":
        return run_extend_shards_cuda(states, h, reads, rlens, args)
    if kind == "plain":
        return run_extend_shards_plain(states, h, reads, rlens, args)
    raise ValueError("no run kernel for shards on several devices")


def shard_placement(states) -> str:
    """Where the shards' stores are, as ``sharded_scorer.placement``
    names it: ``"fused"`` (one CUDA device), ``"plain"`` (the CPU) or
    ``"cross_card"``."""
    from waffle_con_tpu_torch.ops.sharded_scorer import placement

    return placement([st["D"].device for st in states])


def run_extend(state, h: int, reads, rlen, args: RunArgs):
    """Dispatch rule: CPU tensors run :func:`run_extend_plain`, CUDA
    tensors launch the kernel; any other device raises, and so does an
    armed ``pallas_compile`` fault (never a quiet switch to the twin)."""
    faults.check_kernel("run")
    kind = state["D"].device.type
    if kind == "cuda":
        return run_extend_cuda(state, h, reads, rlen, args)
    if kind == "cpu":
        return run_extend_plain(state, h, reads, rlen, args)
    raise ValueError(f"no run kernel for device type {kind!r}")


class RunResult(NamedTuple):
    """Host view of one run's packed output."""

    steps: int
    code: int
    rec_count: int
    fin_ovf: bool
    clen: int
    eds: np.ndarray
    split: np.ndarray
    reached: np.ndarray
    fin: np.ndarray
    occ: np.ndarray
    syms: np.ndarray


def unpack(out_np: np.ndarray, R: int, A: int,
           max_steps: int) -> RunResult:
    """Split a fetched packed output (see :func:`out_layout`)."""
    lay = out_layout(R, A, max_steps)
    get = lambda name: out_np[lay[name][0]:lay[name][1]]  # noqa: E731
    sc = get("scalars")
    steps = int(sc[0])
    return RunResult(
        steps, int(sc[1]), int(sc[2]), bool(sc[3]), int(sc[4]),
        get("eds"), get("split"), get("reached").astype(bool), get("fin"),
        get("occ").reshape(R, A), get("syms")[:steps],
    )


def fetch(out, rec_steps, rec_fins, R: int, A: int, max_steps: int
          ) -> Tuple[RunResult, Optional[np.ndarray], Optional[np.ndarray]]:
    """One device-to-host copy of the packed output, plus the record
    rows when any were absorbed."""
    res = unpack(out.cpu().numpy(), R, A, max_steps)
    if not res.rec_count:
        return res, None, None
    n = res.rec_count
    return res, rec_steps[:n].cpu().numpy(), rec_fins[:n].cpu().numpy()
