"""The frontier gang's launch: up to 8 branches of one search in one call.

Three pieces, one contract (the JAX package's ``_j_run_ragged`` as its
frontier gang uses it, ``waffle_con_tpu/ops/ragged.py``):

* :func:`plan_ragged` — the launch geometry from the shape alone: one
  thread-block cluster per member, each of :func:`plan_run`'s geometry.
* :func:`run_ragged_cuda` — the wrapper of the hand-written Hopper kernel
  ``csrc/run_ragged.cu`` (built by :mod:`~waffle_con_tpu_torch.ops.cuda_build`
  and bound with ``ctypes``); it counts its launches in
  ``run_ragged_cuda.launches``.
* :func:`run_ragged` — the dispatch rule: a branch store on the CPU runs
  :func:`run_ragged_plain` (the members' rows laid out as a pool for
  :func:`~waffle_con_tpu_torch.ops.ragged.ragged_plain`), one on a CUDA
  device launches the kernel (or raises).

Both read each member's rows from its slot of the branch store and never
write the store.  They return the deposit buffers: ``D [G, R, W]``,
``e``/``rmin``/``er [G, R]``, ``cons [G, C]``, ``clen [G]`` (each
member's state at its stop) and ``out [G, stride]``, each row the packed
output of a solo run (:func:`~waffle_con_tpu_torch.ops.run_kernel.out_layout`
at the launch's largest ``max_steps``) with ``rec_count`` 0: records are
never absorbed.  A member whose slot does not hold the consensus length
its parameters name runs nothing and reports code -1.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops.ragged import JP_COLS, ragged_plain
from waffle_con_tpu_torch.ops.run_kernel import RunPlan, out_layout, plan_run
from waffle_con_tpu_torch.runtime import faults

#: members of one launch at most (``FrontierGang.G``, the kernel's
#: ``kMaxGang``)
MAX_GANG = 8

#: columns of the per-member parameter rows: slot, len0, me_budget,
#: other_cost, other_len, max_steps, first_sym
PARAM_COLS = 7


class GangCall(NamedTuple):
    """The search constants of one gang launch."""

    min_count: int
    l2: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size (rows of ``occ``)
    a_real: int


class RaggedPlan(NamedTuple):
    """Launch geometry of one gang: ``members`` clusters of ``run``'s
    geometry."""

    members: int
    run: RunPlan


def plan_ragged(G: int, R: int, W: int, A: int, C: int) -> RaggedPlan:
    """The gang kernel's geometry for ``G`` members of ``R`` reads, band
    width ``W``, ``A`` dense symbols and consensus capacity ``C``: one
    cluster of :func:`plan_run`'s geometry per member.  Raises
    ``ValueError`` on what the kernel does not take: no member or more
    than :data:`MAX_GANG`, a consensus capacity below 2, or a shape
    :func:`plan_run` refuses."""
    if not 1 <= G <= MAX_GANG or C < 2:
        raise ValueError(f"no gang plan for G={G}, C={C}")
    return RaggedPlan(G, plan_run(R, W, A))


def _stride(R: int, A: int, params) -> int:
    return out_layout(R, A, int(params[:, 5].max()))["syms"][1]


def run_ragged_plain(state, params, reads, rlen, call: GangCall):
    """The gang in plain PyTorch: the in-sync members' slot rows laid out
    as a pool (member ``g`` on rows ``g * R .. g * R + R - 1``) for
    :func:`ragged_plain`, its outputs put into the deposit layout.  Same
    contract and outputs as :func:`run_ragged_cuda`."""
    run_ragged_plain.calls += 1
    dev = state["D"].device
    i32 = torch.int32
    params = np.asarray(params, dtype=np.int64)
    G = len(params)
    _B, R, W = state["D"].shape
    C = state["cons"].shape[1]
    A = call.a_real
    lay = out_layout(R, A, int(params[:, 5].max()))
    dep = {
        "D": torch.zeros((G, R, W), dtype=i32, device=dev),
        "e": torch.zeros((G, R), dtype=i32, device=dev),
        "rmin": torch.zeros((G, R), dtype=i32, device=dev),
        "er": torch.zeros((G, R), dtype=i32, device=dev),
        "cons": torch.zeros((G, C), dtype=i32, device=dev),
        "clen": torch.zeros(G, dtype=i32, device=dev),
        "out": torch.zeros((G, lay["syms"][1]), dtype=i32, device=dev),
    }
    clens = state["clen"][torch.as_tensor(params[:, 0], device=dev)].cpu()
    run = [g for g in range(G) if int(clens[g]) == params[g, 1]]
    for g in range(G):
        if g not in run:
            dep["out"][g, 1] = -1
            dep["out"][g, 4] = int(clens[g])
    if not run:
        return dep
    n = len(run)
    slots = torch.as_tensor(params[run, 0], device=dev)
    rows = lambda name: state[name][slots].reshape(n * R, *state[name].shape[2:])  # noqa: E731
    jp = np.zeros((n + 1, JP_COLS), dtype=np.int64)
    for k, g in enumerate(run):
        _slot, _len0, me, oc, ol, ms, fs = params[g]
        jp[k] = (1, me, oc, ol, call.min_count, int(call.l2), ms, fs,
                 call.wc, int(call.et))
    cons0 = torch.zeros((n + 1, C), dtype=i32, device=dev)
    cons0[:n] = state["cons"][slots]
    clen0 = torch.zeros(n + 1, dtype=i32, device=dev)
    clen0[:n] = state["clen"][slots]
    out = ragged_plain(
        reads.repeat(n, 1), rlen.repeat(n), rows("D"), rows("e"),
        rows("rmin"), rows("er"), rows("off"), rows("act"),
        torch.arange(n, dtype=i32, device=dev).repeat_interleave(R),
        torch.full((n * R,), W, dtype=i32, device=dev),
        cons0, clen0, torch.as_tensor(jp, dtype=i32, device=dev), A,
    )
    (D, e, rmin, er, cons, clen, steps, code, _iters, eds, occ, split,
     reached, fin, fin_ovf) = out
    for k, g in enumerate(run):
        rs = slice(k * R, (k + 1) * R)
        dep["D"][g] = D[rs]
        dep["e"][g], dep["rmin"][g], dep["er"][g] = e[rs], rmin[rs], er[rs]
        dep["cons"][g] = cons[k]
        dep["clen"][g] = clen[k]
        o = dep["out"][g]
        o[0], o[1], o[3], o[4] = steps[k], code[k], fin_ovf[k].to(i32), clen[k]
        for name, val in (("eds", eds[rs]), ("split", split[rs]),
                          ("reached", reached[rs]), ("fin", fin[rs]),
                          ("occ", occ[rs])):
            a, b = lay[name]
            o[a:b] = val.reshape(-1).to(i32)
        a = lay["syms"][0]
        len0, ns = int(params[g, 1]), int(steps[k])
        o[a:a + ns] = cons[k, len0:len0 + ns]
    return dep


run_ragged_plain.calls = 0


# ---------------------------------------------------------------------
# CUDA kernel: bind, launch


def _lib_fn(name, argtypes):
    fn = getattr(cuda_build.library(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _launcher():
    return _lib_fn("run_ragged_launch", [ctypes.c_void_p] * 18 + [
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 16 + [
        ctypes.c_longlong, ctypes.c_void_p])


def max_clusters(plan: RaggedPlan) -> int:
    """How many of the plan's clusters fit on the card at once (members
    of one launch beyond it run in later waves)."""
    rp = plan.run
    n = _lib_fn("run_ragged_max_clusters", [ctypes.c_int] * 3 + [
        ctypes.c_longlong])(rp.cluster, rp.threads, int(rp.band == "smem"),
                            rp.smem_bytes)
    if n < 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error {-n}")
    return n


_LAUNCH_ERRORS = {
    -1: "the plan or a member's parameters do not match the kernel",
    -2: "no cluster of this shape fits on the device",
}


def run_ragged_cuda(state, params, reads, rlen, call: GangCall):
    """Launch the CUDA gang kernel: one thread-block cluster per member
    (``params`` rows: slot, len0, me_budget, other_cost, other_len,
    max_steps, first_sym), each reading its slot of the branch store and
    writing its deposit row.  Raises on anything the kernel does not take
    and when the launch is refused; never falls back.  The caller
    guarantees ``len0 + max_steps + 2 < C`` for every member, as
    ``FrontierGang.run`` does.  Each launch adds one to
    ``run_ragged_cuda.launches``; ``run_ragged_cuda.last_plan`` is the last
    launch's plan."""
    D = state["D"]
    dev = D.device
    if dev.type != "cuda":
        raise ValueError("run_ragged_cuda needs tensors on a CUDA device")
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
    if (reads.dtype != torch.int16 or reads.device != dev
            or reads.shape[0] != R or not reads.is_contiguous()):
        raise ValueError("reads: need contiguous int16 [R, L] on the state device")
    if (rlen.dtype != torch.int32 or rlen.device != dev
            or rlen.shape != (R,) or not rlen.is_contiguous()):
        raise ValueError("rlen: need int32 [R] on the state device")
    params = np.ascontiguousarray(params, dtype=np.int32)
    G = len(params)
    if params.shape != (G, PARAM_COLS) or not (
            (params[:, 0] >= 0).all() and (params[:, 0] < B).all()):
        raise ValueError(f"params: need [G, {PARAM_COLS}] rows of slots < {B}")
    if len(set(params[:, 0].tolist())) != G:
        raise ValueError("params: the members' slots must be distinct")
    A = call.a_real
    plan = plan_ragged(G, R, W, A, C)
    rp = plan.run
    stride = _stride(R, A, params)
    i32 = torch.int32
    dep = {
        "D": torch.empty((G, R, W), dtype=i32, device=dev),
        "e": torch.empty((G, R), dtype=i32, device=dev),
        "rmin": torch.empty((G, R), dtype=i32, device=dev),
        "er": torch.empty((G, R), dtype=i32, device=dev),
        "cons": torch.empty((G, C), dtype=i32, device=dev),
        "clen": torch.empty(G, dtype=i32, device=dev),
        "out": torch.empty((G, stride), dtype=i32, device=dev),
    }
    on_chip = rp.band == "smem"
    scratch = None if on_chip else torch.empty((G, R, W), dtype=i32,
                                               device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    rc = _launcher()(
        ptr(D), ptr(state["e"]), ptr(state["rmin"]), ptr(state["er"]),
        ptr(state["off"]), ptr(state["act"]), ptr(state["cons"]),
        ptr(state["clen"]), ptr(reads), ptr(rlen), ptr(dep["D"]),
        ptr(dep["e"]), ptr(dep["rmin"]), ptr(dep["er"]), ptr(dep["cons"]),
        ptr(dep["clen"]), ptr(scratch), ptr(dep["out"]),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        G, stride, R, W, C, reads.shape[1], A, call.min_count,
        int(call.l2), call.wc, int(call.et), rp.cluster, rp.threads,
        rp.reads_per_cta, rp.reads_per_warp, int(on_chip), rp.smem_bytes,
        cuda_build.stream_ptr(dev),
    )
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(
            f"run_ragged kernel launch failed: {why} (G={G}, R={R}, W={W}, "
            f"A={A}, {rp})"
        )
    run_ragged_cuda.launches += 1
    run_ragged_cuda.last_plan = plan
    return dep


run_ragged_cuda.launches = 0
run_ragged_cuda.last_plan = None


def run_ragged(state, params, reads, rlen, call: GangCall):
    """Dispatch rule: CPU tensors run :func:`run_ragged_plain`, CUDA
    tensors launch the kernel; any other device raises, and so does an
    armed ``pallas_compile`` fault."""
    faults.check_kernel("ragged")
    kind = state["D"].device.type
    if kind == "cuda":
        return run_ragged_cuda(state, params, reads, rlen, call)
    if kind == "cpu":
        return run_ragged_plain(state, params, reads, rlen, call)
    raise ValueError(f"no gang kernel for device type {kind!r}")
