"""The gang launch: up to 8 ``run_extend`` runs in one call.

Three pieces, one contract (the JAX package's ``_j_run_ragged``,
``waffle_con_tpu/ops/ragged.py``):

* :func:`plan_ragged` / :func:`plan_members` — the launch geometry from
  the shapes alone: each member keeps :func:`plan_run`'s split of its
  reads over its own ``c`` CTAs, the members are packed first fit
  decreasing by ``c`` into clusters of the largest member's ``c`` (a
  member on ranks ``[base, base + c)`` of its cluster), and the launch
  takes the largest member's threads and shared memory.
* :func:`run_members_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/run_ragged.cu`` (built by
  :mod:`~waffle_con_tpu_torch.ops.cuda_build` and bound with ``ctypes``);
  it counts its launches in ``run_ragged_cuda.launches``.
* :func:`run_members` — the dispatch rule: members on the CPU run
  :func:`run_members_plain` (their rows laid out as a pool for
  :func:`~waffle_con_tpu_torch.ops.ragged.ragged_plain`), members on a
  CUDA device launch the kernel (or raise).

A member (:class:`Member`) is one branch's run: its store, slot, reads
and search constants, so members may come from different stores at
different ``R``, ``W``, ``C``, ``L`` and ``A`` (the serving pool's
cross-job gang) or all from one (the frontier gang, :func:`run_ragged`).
Results go either into each member's slot (``in_place``: the serving
pool, as ``run_extend`` would) or into deposit buffers (the frontier
gang: ``D [G, R, W]``, ``e``/``rmin``/``er [G, R]``, ``cons [G, C]``,
``clen [G]``; no slot is touched).  Each member's packed output is a
solo run's (:func:`~waffle_con_tpu_torch.ops.run_kernel.out_layout` at
its own ``R``, ``A`` and ``max_steps``) with ``rec_count`` 0: records are
never absorbed.  A member whose slot does not hold the consensus length
it names runs nothing and reports code -1.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops.ragged import JP_COLS, ragged_plain
from waffle_con_tpu_torch.ops.run_kernel import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    RunPlan,
    _smem_bytes,
    out_layout,
    plan_run,
)
from waffle_con_tpu_torch.runtime import faults

#: members of one launch at most (``FrontierGang.G``, the kernel's
#: ``kMaxGang``); a larger group runs as consecutive launches
MAX_GANG = 8

class GangCall(NamedTuple):
    """The search constants of one frontier-gang launch."""

    min_count: int
    l2: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size (rows of ``occ``)
    a_real: int


class Member(NamedTuple):
    """One run of a gang launch: branch ``slot`` of the store ``state``
    (``D [B, R, W]``, ``e``/``rmin``/``er``/``off``/``act [B, R]``,
    ``cons [B, C]``, ``clen [B]``) over ``reads [R, L]`` int16 and ``rlen
    [R]``, with its own call arguments and search constants."""

    state: dict
    slot: int
    reads: torch.Tensor
    rlen: torch.Tensor
    len0: int
    me_budget: int
    other_cost: int
    other_len: int
    max_steps: int
    first_sym: int
    min_count: int
    l2: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size (rows of ``occ``)
    a_real: int

    def shape(self):
        """``(R, W, A, C)`` of the member's store."""
        _B, R, W = self.state["D"].shape
        return (R, W, self.a_real, self.state["cons"].shape[1])


class RaggedPlan(NamedTuple):
    """Launch geometry of one gang of ``members``.  ``run`` is the
    launch's geometry (its cluster size, threads and shared memory; for a
    gang of one shape exactly :func:`plan_run`'s), ``plans`` each
    member's own :func:`plan_run` split of its reads (``rpc``, ``rpw``,
    band, and its ``c`` CTAs), ``slots`` each member's ``(cluster,
    base)`` and ``spans`` its CTAs: CTAs ``[base, base + span)`` of
    cluster ``cluster`` (the span is ``c``, or the whole cluster on the
    unpacked plan, whose CTAs past a member's reads fold identity
    partials).  ``clusters`` are launched, ``ctas`` of their CTAs hold a
    member; ``waves`` is ``ceil(clusters / co-resident clusters)`` once a
    card was asked (0 before)."""

    members: int
    run: RunPlan
    plans: tuple = ()
    slots: tuple = ()
    spans: tuple = ()
    clusters: int = 0
    ctas: int = 0
    waves: int = 0


def pack_members(sizes: Sequence[int], csize: int, packed: bool = True):
    """Each member's ``(cluster, base)`` for members of ``sizes`` CTAs in
    clusters of ``csize``: first fit decreasing (the largest members
    first, ties in member order), each member into the first cluster with
    room; ``packed`` False gives every member a cluster of its own (the
    layout of one cluster a member).  Returns ``(slots, clusters)``."""
    if not packed:
        return tuple((g, 0) for g in range(len(sizes))), len(sizes)
    used: List[int] = []
    slots = [None] * len(sizes)
    for g in sorted(range(len(sizes)), key=lambda g: -sizes[g]):
        c = sizes[g]
        if not 1 <= c <= csize:
            raise ValueError(f"a member of {c} CTAs in clusters of {csize}")
        at = next((i for i, u in enumerate(used) if u + c <= csize), None)
        if at is None:
            at = len(used)
            used.append(0)
        slots[g] = (at, used[at])
        used[at] += c
    return tuple(slots), len(used)


def plan_members(shapes: Sequence[tuple], packed: bool = True) -> RaggedPlan:
    """The gang kernel's geometry for members of shapes ``(R, W, A, C)``:
    each member's :func:`plan_run` (its split and its ``c`` CTAs), the
    members packed by ``c`` into clusters of the largest ``c``
    (:func:`pack_members`; ``packed`` False: the layout of one cluster a
    member, each member on every CTA of its cluster), and a
    launch of the largest CTA among them, with the largest shared memory
    a member needs on the launch's warps.  Raises ``ValueError`` on what
    the kernel does not take: no member or more than :data:`MAX_GANG`, a
    consensus capacity below 2, a shape :func:`plan_run` refuses, or a
    member whose per-warp state on the launch's warps overflows a CTA's
    shared memory."""
    G = len(shapes)
    if not 1 <= G <= MAX_GANG:
        raise ValueError(f"no gang plan for G={G}")
    plans = []
    for R, W, A, C in shapes:
        if C < 2:
            raise ValueError(f"no gang plan for C={C}")
        plans.append(plan_run(R, W, A))
    sizes = [p.cluster for p in plans]
    slots, clusters = pack_members(sizes, max(sizes), packed)
    spans = tuple(sizes) if packed else (max(sizes),) * G
    placed = dict(slots=slots, spans=spans, clusters=clusters,
                  ctas=sum(spans))
    if len(set(shapes)) == 1:
        return RaggedPlan(G, plans[0], tuple(plans), **placed)
    cluster = max(p.cluster for p in plans)
    threads = max(p.threads for p in plans)
    nw = threads // 32
    smem = 0
    for (R, W, A, C), p in zip(shapes, plans):
        need = _smem_bytes(p.reads_per_cta, nw, W, A, p.band == "smem")
        if need > SMEM_LIMIT:
            raise ValueError(
                f"no gang plan: member R={R}, W={W}, A={A} needs {need} "
                f"bytes of shared memory on {nw} warps (limit {SMEM_LIMIT})")
        smem = max(smem, need)
    bands = {p.band for p in plans}
    run = RunPlan(cluster, threads, max(p.reads_per_cta for p in plans),
                  max(p.reads_per_warp for p in plans),
                  bands.pop() if len(bands) == 1 else "mixed", smem)
    assert cluster <= MAX_CLUSTER
    return RaggedPlan(G, run, tuple(plans), **placed)


def plan_ragged(G: int, R: int, W: int, A: int, C: int) -> RaggedPlan:
    """The gang kernel's geometry for ``G`` members of one shape: ``R``
    reads, band width ``W``, ``A`` dense symbols and consensus capacity
    ``C`` (the frontier gang's case): one cluster of :func:`plan_run`'s
    geometry per member.  Raises ``ValueError`` as
    :func:`plan_members`."""
    if not 1 <= G <= MAX_GANG:
        raise ValueError(f"no gang plan for G={G}, C={C}")
    return plan_members([(R, W, A, C)] * G)


def _layouts(members: Sequence[Member]):
    """Each member's packed-output layout and its offset in one flat
    output buffer."""
    lays, offs, at = [], [], 0
    for m in members:
        R, _W, A, _C = m.shape()
        lay = out_layout(R, A, int(m.max_steps))
        lays.append(lay)
        offs.append(at)
        at += lay["syms"][1]
    return lays, offs, at


def _deposits(members: Sequence[Member], stride: int):
    """Deposit buffers of a one-store gang (the frontier gang's)."""
    st = members[0].state
    _B, R, W = st["D"].shape
    C = st["cons"].shape[1]
    G, dev, i32 = len(members), st["D"].device, torch.int32
    return {
        "D": torch.zeros((G, R, W), dtype=i32, device=dev),
        "e": torch.zeros((G, R), dtype=i32, device=dev),
        "rmin": torch.zeros((G, R), dtype=i32, device=dev),
        "er": torch.zeros((G, R), dtype=i32, device=dev),
        "cons": torch.zeros((G, C), dtype=i32, device=dev),
        "clen": torch.zeros(G, dtype=i32, device=dev),
        "out": torch.zeros((G, stride), dtype=i32, device=dev),
    }


def _check_one_store(members: Sequence[Member]) -> None:
    st = members[0].state
    if any(m.state is not st for m in members):
        raise ValueError("deposits need every member on one store")
    if len({m.slot for m in members}) != len(members):
        raise ValueError("the members' slots must be distinct")


def run_members_plain(members: Sequence[Member], in_place: bool):
    """The gang in plain PyTorch: the in-step members' slot rows laid out
    as a pool (member ``g``'s ``R_g`` rows one after another, at the pool
    width ``max W``, each row with its own stride ``wrow``) for
    :func:`ragged_plain`, its outputs put back into each slot
    (``in_place``) or into deposit buffers.  Same contract and outputs as
    :func:`run_members_cuda`: returns ``(outs, dep)``, ``outs`` each
    member's packed output (int32, on the members' device) and ``dep``
    the deposit buffers (``None`` in place)."""
    run_ragged_plain.calls += 1
    G = len(members)
    dev = members[0].state["D"].device
    i32 = torch.int32
    lays, offs, total = _layouts(members)
    flat = torch.zeros(total, dtype=i32, device=dev)
    outs = [flat[offs[g]:offs[g] + lays[g]["syms"][1]] for g in range(G)]
    dep = None
    if not in_place:
        _check_one_store(members)
        dep = _deposits(members, max(lay["syms"][1] for lay in lays))
        outs = [dep["out"][g] for g in range(G)]
    run = []
    for g, m in enumerate(members):
        clen = int(m.state["clen"][m.slot])
        if clen == m.len0:
            run.append(g)
        else:
            outs[g][1] = -1
            outs[g][4] = clen
    if not run:
        return outs, dep
    shapes = [members[g].shape() for g in run]
    P = sum(s[0] for s in shapes)
    Wp = max(s[1] for s in shapes)
    A = max(s[2] for s in shapes)
    Cp = max(s[3] for s in shapes)
    Lp = max(members[g].reads.shape[1] for g in run)
    n = len(run)
    INF = 1 << 20
    reads = torch.full((P, Lp), -1, dtype=torch.int16, device=dev)
    rlen = torch.zeros(P, dtype=i32, device=dev)
    D = torch.full((P, Wp), INF, dtype=i32, device=dev)
    fields = {k: torch.zeros(P, dtype=i32, device=dev)
              for k in ("e", "rmin", "er", "off")}
    act = torch.zeros(P, dtype=torch.bool, device=dev)
    seg = torch.zeros(P, dtype=i32, device=dev)
    wrow = torch.zeros(P, dtype=i32, device=dev)
    cons0 = torch.zeros((n + 1, Cp), dtype=i32, device=dev)
    clen0 = torch.zeros(n + 1, dtype=i32, device=dev)
    jp = np.zeros((n + 1, JP_COLS), dtype=np.int64)
    at = 0
    spans = []
    for k, g in enumerate(run):
        m = members[g]
        R, W, _A, C = m.shape()
        rs = slice(at, at + R)
        spans.append((rs, R, W, C))
        st, s = m.state, m.slot
        reads[rs, : m.reads.shape[1]] = m.reads
        rlen[rs] = m.rlen
        D[rs, :W] = st["D"][s]
        for name in ("e", "rmin", "er", "off"):
            fields[name][rs] = st[name][s]
        act[rs] = st["act"][s]
        seg[rs] = k
        wrow[rs] = W
        cons0[k, :C] = st["cons"][s]
        clen0[k] = st["clen"][s]
        jp[k] = (1, m.me_budget, m.other_cost, m.other_len, m.min_count,
                 int(m.l2), m.max_steps, m.first_sym, m.wc, int(m.et))
        at += R
    out = ragged_plain(
        reads, rlen, D, fields["e"], fields["rmin"], fields["er"],
        fields["off"], act, seg, wrow, cons0, clen0,
        torch.as_tensor(jp, dtype=i32, device=dev), A,
    )
    (oD, oe, ormin, oer, ocons, oclen, steps, code, _iters, eds, occ, split,
     reached, fin, fin_ovf) = out
    for k, g in enumerate(run):
        m = members[g]
        rs, R, W, C = spans[k]
        A_m = m.a_real
        if in_place:
            st, s = m.state, m.slot
            st["D"][s] = oD[rs, :W]
            st["e"][s], st["rmin"][s], st["er"][s] = oe[rs], ormin[rs], oer[rs]
            st["cons"][s] = ocons[k, :C]
            st["clen"][s] = oclen[k]
        else:
            dep["D"][g] = oD[rs, :W]
            dep["e"][g], dep["rmin"][g], dep["er"][g] = (
                oe[rs], ormin[rs], oer[rs])
            dep["cons"][g] = ocons[k, :C]
            dep["clen"][g] = oclen[k]
        o, lay = outs[g], lays[g]
        o[0], o[1], o[3], o[4] = (steps[k], code[k], fin_ovf[k].to(i32),
                                  oclen[k])
        for name, val in (("eds", eds[rs]), ("split", split[rs]),
                          ("reached", reached[rs]), ("fin", fin[rs]),
                          ("occ", occ[rs, :A_m])):
            a, b = lay[name]
            o[a:b] = val.reshape(-1).to(i32)
        a = lay["syms"][0]
        ns = int(steps[k])
        o[a:a + ns] = ocons[k, m.len0:m.len0 + ns]
    return outs, dep


# ---------------------------------------------------------------------
# CUDA kernel: bind, launch


class _Member(ctypes.Structure):
    """``struct RaggedMember`` of ``csrc/run_ragged.cu``, field for
    field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "Ds", "Dh", "e_in", "rmin_in", "er_in", "e_out", "rmin_out",
        "er_out", "off", "act", "cons_in", "cons_out", "clen_in",
        "clen_out", "reads", "rlen", "scratch", "out")] + [
        (name, ctypes.c_int) for name in (
            "R", "W", "C", "L", "A", "len0", "me_budget", "other_cost",
            "other_len", "max_steps", "first_sym", "min_count", "l2", "wc",
            "et", "rpc", "rpw", "on_chip", "stride", "cluster", "base",
            "ctas")]


def _lib_fn(name, argtypes):
    fn = getattr(cuda_build.library(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _launcher():
    return _lib_fn("run_ragged_launch", [
        ctypes.POINTER(_Member), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


#: (device index, cluster, threads, shared bytes) -> co-resident clusters
_CORESIDENT: Dict[tuple, int] = {}


def max_clusters(plan: RaggedPlan) -> int:
    """How many of the plan's clusters fit on the card at once (clusters
    of one launch beyond it run in later waves); asked once a shape."""
    rp = plan.run
    key = (torch.cuda.current_device(), rp.cluster, rp.threads,
           rp.smem_bytes)
    if key not in _CORESIDENT:
        n = _lib_fn("run_ragged_max_clusters", [ctypes.c_int] * 2 + [
            ctypes.c_longlong])(rp.cluster, rp.threads, rp.smem_bytes)
        if n < 0:
            raise RuntimeError(
                f"cluster occupancy query failed: CUDA error {-n}")
        _CORESIDENT[key] = n
    return _CORESIDENT[key]


def waves(plan: RaggedPlan) -> int:
    """``ceil(clusters / co-resident clusters)`` of the plan on the
    current card."""
    return -(-plan.clusters // max(max_clusters(plan), 1))


_LAUNCH_ERRORS = {
    -1: "the plan or a member's parameters do not match the kernel",
    -2: "no cluster of this shape fits on the device",
}

_STORE_TYPES = {
    "D": torch.int32, "e": torch.int32, "rmin": torch.int32,
    "er": torch.int32, "off": torch.int32, "act": torch.bool,
    "cons": torch.int32, "clen": torch.int32,
}


def _check_member(m: Member, dev) -> None:
    st = m.state
    for name, dt in _STORE_TYPES.items():
        t = st[name]
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"state[{name!r}]: need contiguous {dt} on {dev}")
    B, R, _W = st["D"].shape
    if not 0 <= m.slot < B:
        raise ValueError(f"slot {m.slot} outside the store's {B} slots")
    rd, rl = m.reads, m.rlen
    if (rd.dtype != torch.int16 or rd.device != dev or rd.shape[0] != R
            or not rd.is_contiguous()):
        raise ValueError(
            "reads: need contiguous int16 [R, L] on the state device")
    if (rl.dtype != torch.int32 or rl.device != dev or rl.shape != (R,)
            or not rl.is_contiguous()):
        raise ValueError("rlen: need int32 [R] on the state device")


def run_members_cuda(members: Sequence[Member], in_place: bool,
                     plan: RaggedPlan = None):
    """Launch the CUDA gang kernel over ``members`` (at most
    :data:`MAX_GANG`), packed as :func:`plan_members` packs them (or on
    ``plan``, one of :func:`plan_members`' for these shapes), each member
    reading its slot and writing its slot (``in_place``) or its deposit
    row.  Returns ``(outs, dep)`` as :func:`run_members_plain`.  Raises
    on anything the kernel does not take and when the launch is refused;
    never falls back.  The caller guarantees ``len0 + max_steps + 2 < C``
    for every member.  Each launch adds one to
    ``run_ragged_cuda.launches``; ``run_ragged_cuda.last_plan`` is the
    last launch's plan, its ``waves`` filled in."""
    dev = members[0].state["D"].device
    if dev.type != "cuda":
        raise ValueError("the gang kernel needs tensors on a CUDA device")
    for m in members:
        _check_member(m, dev)
    if not in_place:
        _check_one_store(members)
    shapes = [m.shape() for m in members]
    if plan is None:
        plan = plan_members(shapes)
    elif plan.plans != tuple(plan_run(R, W, A) for R, W, A, _C in shapes):
        raise ValueError("the plan is not one of these members' shapes")
    rp = plan.run
    lays, offs, total = _layouts(members)
    i32 = torch.int32
    flat = torch.empty(total, dtype=i32, device=dev)
    outs = [flat[offs[g]:offs[g] + lays[g]["syms"][1]]
            for g in range(len(members))]
    dep = None
    if not in_place:
        stride = max(lay["syms"][1] for lay in lays)
        dep = _deposits(members, stride)
        outs = [dep["out"][g] for g in range(len(members))]
    arr = (_Member * len(members))()
    keep = []  # scratch buffers live until the launch is queued
    for g, (m, p) in enumerate(zip(members, plan.plans)):
        st, s = m.state, m.slot
        R, W, A, C = m.shape()
        RW = R * W

        def addr(t, n):
            return t.data_ptr() + t.element_size() * s * n

        d = arr[g]
        d.Ds = addr(st["D"], RW)
        d.e_in, d.rmin_in, d.er_in = (addr(st["e"], R), addr(st["rmin"], R),
                                      addr(st["er"], R))
        d.off, d.act = addr(st["off"], R), addr(st["act"], R)
        d.cons_in, d.clen_in = addr(st["cons"], C), addr(st["clen"], 1)
        if in_place:
            d.Dh, d.e_out, d.rmin_out, d.er_out = (d.Ds, d.e_in, d.rmin_in,
                                                   d.er_in)
            d.cons_out, d.clen_out = d.cons_in, d.clen_in
        else:
            d.Dh = dep["D"][g].data_ptr()
            d.e_out, d.rmin_out, d.er_out = (dep["e"][g].data_ptr(),
                                             dep["rmin"][g].data_ptr(),
                                             dep["er"][g].data_ptr())
            d.cons_out, d.clen_out = (dep["cons"][g].data_ptr(),
                                      dep["clen"][g].data_ptr())
        d.reads, d.rlen = m.reads.data_ptr(), m.rlen.data_ptr()
        on_chip = p.band == "smem"
        if not on_chip:
            scratch = torch.empty((R, W), dtype=i32, device=dev)
            keep.append(scratch)
            d.scratch = scratch.data_ptr()
        d.out = outs[g].data_ptr()
        d.R, d.W, d.C, d.L, d.A = R, W, C, m.reads.shape[1], A
        d.len0, d.max_steps, d.first_sym = m.len0, m.max_steps, m.first_sym
        d.me_budget = min(int(m.me_budget), 2**31 - 1)
        d.other_cost = min(int(m.other_cost), 2**31 - 1)
        d.other_len = int(m.other_len)
        d.min_count, d.l2, d.wc, d.et = (int(m.min_count), int(m.l2),
                                         int(m.wc), int(m.et))
        d.rpc, d.rpw, d.on_chip = p.reads_per_cta, p.reads_per_warp, on_chip
        d.stride = lays[g]["syms"][1]
        d.cluster, d.base = plan.slots[g]
        d.ctas = plan.spans[g]
    with torch.cuda.device(dev):
        rc = _launcher()(arr, len(members), plan.clusters, rp.cluster,
                         rp.threads, rp.smem_bytes,
                         cuda_build.stream_ptr(dev))
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(
            f"run_ragged kernel launch failed: {why} (G={len(members)}, "
            f"shapes={[m.shape() for m in members]}, {rp})"
        )
    run_ragged_cuda.launches += 1
    with torch.cuda.device(dev):
        run_ragged_cuda.last_plan = plan._replace(waves=waves(plan))
    return outs, dep


def run_members(members: Sequence[Member], in_place: bool):
    """Dispatch rule: members on the CPU run :func:`run_members_plain`, on
    a CUDA device the kernel, in consecutive launches of at most
    :data:`MAX_GANG` (members are independent, so the results are those
    of one launch); any other device raises, and so does an armed
    ``pallas_compile`` fault.  Returns ``(outs, dep)``."""
    faults.check_kernel("ragged")
    if not members:
        raise ValueError("a gang needs at least one member")
    if len({(id(m.state), m.slot) for m in members}) != len(members):
        raise ValueError("two members on one slot of one store")
    kind = members[0].state["D"].device.type
    if kind == "cuda":
        fn = run_members_cuda
    elif kind == "cpu":
        fn = run_members_plain
    else:
        raise ValueError(f"no gang kernel for device type {kind!r}")
    if not in_place or len(members) <= MAX_GANG:
        return fn(members, in_place)
    outs: List[torch.Tensor] = []
    for i in range(0, len(members), MAX_GANG):
        outs.extend(fn(members[i:i + MAX_GANG], in_place)[0])
    return outs, None


def _one_store_members(state, params, reads, rlen, call: GangCall):
    return [
        Member(state, int(p[0]), reads, rlen, int(p[1]), int(p[2]),
               int(p[3]), int(p[4]), int(p[5]), int(p[6]), call.min_count,
               call.l2, call.wc, call.et, call.a_real)
        for p in np.asarray(params, dtype=np.int64)
    ]


def run_ragged_cuda(state, params, reads, rlen, call: GangCall):
    """The frontier gang's launch on the card: every member from one
    store (``params`` rows: slot, len0, me_budget, other_cost, other_len,
    max_steps, first_sym), each writing its deposit row.  Returns the
    deposit buffers (``out [G, stride]`` at the largest ``max_steps``)."""
    members = _one_store_members(state, params, reads, rlen, call)
    if len(members) > MAX_GANG:
        raise ValueError(f"a frontier gang holds at most {MAX_GANG} members")
    return run_members_cuda(members, in_place=False)[1]


run_ragged_cuda.launches = 0
run_ragged_cuda.last_plan = None


def run_ragged_plain(state, params, reads, rlen, call: GangCall):
    """The frontier gang in plain PyTorch: same contract and outputs as
    :func:`run_ragged_cuda`."""
    members = _one_store_members(state, params, reads, rlen, call)
    return run_members_plain(members, in_place=False)[1]


#: calls of the plain gang (both entries), counted as twin calls
run_ragged_plain.calls = 0


def run_ragged(state, params, reads, rlen, call: GangCall):
    """The frontier gang's dispatch rule: CPU tensors run
    :func:`run_ragged_plain`, CUDA tensors launch the kernel; any other
    device raises, and so does an armed ``pallas_compile`` fault."""
    members = _one_store_members(state, params, reads, rlen, call)
    if len(members) > MAX_GANG:
        raise ValueError(f"a frontier gang holds at most {MAX_GANG} members")
    return run_members(members, in_place=False)[1]


def fetch_outs(outs: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Every member's packed output on the host, in one device-to-host
    copy."""
    host = torch.cat(list(outs)).cpu().numpy()
    res, at = [], 0
    for o in outs:
        res.append(host[at:at + o.numel()])
        at += o.numel()
    return res
