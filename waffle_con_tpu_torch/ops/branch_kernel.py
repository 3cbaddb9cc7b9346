"""The branch store's life-cycle calls behind ``TorchScorer``: root, copy,
advance, stats, finalize and deactivate.

``waffle_con_tpu``'s ``JaxScorer`` runs them as seven jitted XLA
functions (``ops/jax_scorer.py``): ``_j_root``, ``_j_clone_batch``,
``_j_deactivate_batch``, ``_j_push_batch``, ``_j_clone_push_batch``,
``_j_stats`` and ``_j_finalize``.  Here they are one hand-written CUDA
source, ``csrc/branch_step.cu``, in the style of
:mod:`~waffle_con_tpu_torch.ops.replay_kernel`:

* plain twins built from ``torch_scorer``'s column primitives
  (:func:`root_plain`, :func:`advance_plain`, :func:`stats_plain`,
  :func:`finalize_plain`, :func:`deactivate_plain`), each counted in its
  ``.calls``;
* :func:`plan_branch`, the kernels' launch geometry, which takes every
  shape the store can hold: the band and the tip histogram live in device
  memory, so neither the width nor the alphabet bounds a launch;
* the CUDA wrappers (``*_cuda``), every launch through
  :func:`branch_cuda`, counted in ``branch_cuda.launches`` (and by entry
  in ``branch_cuda.entries``);
* the dispatch (:func:`root`, :func:`advance`, :func:`stats`,
  :func:`finalize`, :func:`deactivate`): tensors on the CPU take the twin,
  tensors on a CUDA device launch the kernel or raise.

An advance takes rows ``(src, dst, sym)``: ``sym == -1`` copies slot
``src`` into ``dst`` (``_j_clone_batch``), ``src == dst`` pushes in place
(``_j_push_batch``), anything else clones and pushes
(``_j_clone_push_batch``).  Every src row is read before any dst row is
written, and the batch commits nothing when any pushed read's edit
distance reaches the band (``e >= E``): the caller grows the band and
retries.  Results come back to the host as :class:`BranchOut` numpy
arrays; the kernel's packed output is fetched in one copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops import replay_kernel as rpk
from waffle_con_tpu_torch.ops import torch_scorer as ts

#: warps of a CTA of the rows and root launches, one (row, read) a warp
ROW_WARPS = 8
#: threads of a CTA of the commit and deactivate launches
COPY_THREADS = 256
#: most CTAs of the commit on one row (each thread copies several words)
COMMIT_CTAS = 264
#: most rows of the commit's grid (its y dimension); rows past it loop
COMMIT_ROWS = 65535


class BranchOut(NamedTuple):
    """Stats of a batch of ``n`` rows over ``R`` reads and ``A`` symbols,
    each at its row's length after the call (the twin of ``_j_push_batch``'s
    ``stats`` and ``overflow``)."""

    #: ``[n, R]`` int32 edit distance (0 on inactive reads)
    eds: np.ndarray
    #: ``[n, R, A]`` int32 tip votes (``None`` without the histogram)
    occ: Optional[np.ndarray]
    #: ``[n, R]`` int32 tips a read (``None`` without the histogram)
    split: Optional[np.ndarray]
    #: ``[n, R]`` bool: the read's wavefront touched its end
    reached: np.ndarray
    #: ``[n, R]`` int32 finalized distances (``max(e, rmin)``, capped)
    fin: np.ndarray
    #: ``[n]`` bool: every active read's finalized distance is in the band
    fin_ok: np.ndarray
    #: whether any pushed read overflowed the band (nothing committed)
    overflow: bool


class BranchPlan(NamedTuple):
    """Launch geometry of one call of ``csrc/branch_step.cu``."""

    #: warps of a CTA of the rows launch, one (row, read) each
    warps: int
    #: CTAs of the rows launch
    blocks: int
    #: CTAs of the commit on one row, and rows of its grid
    commit_blocks: int
    commit_rows: int
    #: words of the packed output without and with the ``occ`` plane
    head_words: int
    out_words: int


def plan_branch(n: int, R: int, W: int, A: int) -> BranchPlan:
    """The launch geometry of a call on ``n`` rows of ``R`` reads, ``W``
    band cells and ``A`` symbols.  Every shape the store can hold is
    taken: one warp a (row, read), 8 a CTA, the band and the histogram
    in device memory; the commit copies a row's ``R x W`` words with up
    to ``COMMIT_CTAS`` CTAs.  Raises ``ValueError`` only on an empty
    batch or a band that is not ``2E + 2`` cells."""
    if n < 1 or R < 1 or A < 1 or W < 4 or W % 2:
        raise ValueError(f"no branch plan for n={n}, R={R}, W={W}, A={A}")
    blocks = -(-n * R // ROW_WARPS)
    commit = max(1, min(COMMIT_CTAS, -(-R * W // (4 * COPY_THREADS))))
    head = 4 * n * R + n + 1
    return BranchPlan(ROW_WARPS, blocks, commit, min(n, COMMIT_ROWS), head,
                      head + n * R * A)


def slab_words(n: int, R: int, W: int, C: int) -> int:
    """int32 words of an advance's scratch slab: the new band, the five
    per-read fields (``e``, ``rmin``, ``er``, ``off``, ``act``), the
    consensus and the length of every row."""
    return n * R * W + 5 * n * R + n * C + n


def unpack(host: np.ndarray, n: int, R: int, A: int, votes: bool) -> BranchOut:
    """A packed output (``csrc/branch_step.cu``'s layout: ``eds``,
    ``split``, ``reached``, ``fin`` ``[n, R]`` each, the rows' ``fin``
    overflow flags ``[n]``, the batch's overflow word, then ``occ [n, R,
    A]``) as a :class:`BranchOut`."""
    nR = n * R
    field = lambda i: host[i * nR:(i + 1) * nR].reshape(n, R)  # noqa: E731
    flags = host[4 * nR:4 * nR + n + 1]
    occ = host[4 * nR + n + 1:4 * nR + n + 1 + nR * A]
    return BranchOut(
        eds=field(0), occ=occ.reshape(n, R, A) if votes else None,
        split=field(1) if votes else None, reached=field(2).astype(bool),
        fin=field(3), fin_ok=flags[:n] == 0, overflow=bool(flags[n]),
    )


def _rows_np(rows) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[0] != 3 or rows.shape[1] < 1:
        raise ValueError(f"rows: need [3, n] (src, dst, sym), not "
                         f"{rows.shape}")
    return rows


def _check_rows(state, rows: np.ndarray, pushes: bool) -> None:
    """Slots inside the store, distinct destinations, and (``pushes``
    False) copy-only rows."""
    B = state["D"].shape[0]
    if rows[:2].min() < 0 or rows[:2].max() >= B:
        raise ValueError(f"rows: slots outside [0, {B})")
    if len(set(rows[1].tolist())) != rows.shape[1]:
        raise ValueError("rows: duplicate destination slots")
    if not pushes and (rows[2] >= 0).any():
        raise ValueError("rows: a copy without stats cannot push")


# ---------------------------------------------------------------------
# plain twins (tensors on the CPU)


def _geometry(state):
    W = state["D"].shape[2]
    return W, (W - 2) // 2


def _host_out(stats, fin, fin_ovf, overflow: bool) -> BranchOut:
    eds, occ, split, reached = (x.cpu().numpy() for x in stats)
    return BranchOut(eds, occ, split, reached, fin.cpu().numpy(),
                     ~fin_ovf.cpu().numpy(), overflow)


def root_plain(state, slot: int, act, rlen) -> None:
    """Root slot ``slot``: ``init_col`` at offset 0 for the reads active
    in ``act`` (``[R]`` bool), consensus length 0 (``_j_root``'s state;
    its stats are :func:`stats_plain`'s)."""
    root_plain.calls += 1
    W, E = _geometry(state)
    off = torch.zeros_like(state["off"][slot])
    D, e, rmin, er = ts.init_col(off, act, rlen, E, W)
    for name, val in (("D", D), ("e", e), ("rmin", rmin), ("er", er),
                      ("off", off), ("act", act)):
        state[name][slot] = val
    state["clen"][slot] = 0


root_plain.calls = 0


def advance_plain(state, rows, reads, rlen, wc: int, et: bool,
                  num_symbols: int, with_stats: bool = True):
    """Rows ``(src, dst, sym)`` (``[3, n]``): slot ``src`` advanced by
    ``sym`` (``-1``: copied as it is) into slot ``dst``, every src read
    before any dst written, nothing committed when a pushed read reaches
    the band.  Returns the :class:`BranchOut` of the rows at their new
    lengths (``_j_clone_push_batch``'s stats and overflow), or ``None``
    without ``with_stats`` (a batch of copies, ``_j_clone_batch``)."""
    advance_plain.calls += 1
    rows = _rows_np(rows)
    _check_rows(state, rows, with_stats)
    st = state
    dev = st["D"].device
    W, E = _geometry(st)
    C = st["cons"].shape[1]
    r = torch.from_numpy(rows).to(dev)
    si, di, sym = r[0].long(), r[1].long(), r[2]
    push = sym >= 0
    D, e, rmin, er = st["D"][si], st["e"][si], st["rmin"][si], st["er"][si]
    off, act, cons, clen = (st["off"][si], st["act"][si], st["cons"][si],
                            st["clen"][si])
    Dn, en, rminn, ern = ts.col_step(
        D, e, rmin, er, off, act, rlen,
        ts.gather_window(reads, clen, off, E, W), clen + 1,
        sym.clamp(min=0), wc, et, E,
    )
    sel = lambda new, old: torch.where(  # noqa: E731
        push.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    Dn, en, rminn, ern = sel(Dn, D), sel(en, e), sel(rminn, rmin), sel(ern, er)
    overflow = bool((push & (act & (en >= E)).any(-1)).any())
    clenn = torch.where(push, clen + 1, clen)
    out = None
    if with_stats:
        stats = ts.stats_core(
            Dn, en, rminn, ern, off, act, rlen,
            ts.gather_window(reads, clenn, off, E, W), clenn, num_symbols, E,
        )
        fin, fin_ovf = ts.finalized(en, rminn, act, E)
        out = _host_out(stats, fin, fin_ovf, overflow)
    if not overflow:
        at = torch.arange(rows.shape[1], device=dev)
        cpos = clen.clamp(0, C - 1).long()
        cons_n = cons.clone()
        cons_n[at, cpos] = torch.where(push, sym, cons[at, cpos])
        for name, val in (("D", Dn), ("e", en), ("rmin", rminn), ("er", ern),
                          ("off", off), ("act", act), ("cons", cons_n),
                          ("clen", clenn)):
            st[name][di] = val
    return out


advance_plain.calls = 0


def stats_plain(state, slots, reads, rlen, num_symbols: int) -> BranchOut:
    """The :class:`BranchOut` of each slot in ``slots`` as it stands
    (``_j_stats``, with the finalized distances bundled); writes
    nothing."""
    stats_plain.calls += 1
    W, E = _geometry(state)
    si = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                         device=state["D"].device)
    D, e, rmin, er, off, act, clen = (
        state[k][si] for k in ("D", "e", "rmin", "er", "off", "act", "clen"))
    stats = ts.stats_core(D, e, rmin, er, off, act, rlen,
                          ts.gather_window(reads, clen, off, E, W), clen,
                          num_symbols, E)
    fin, fin_ovf = ts.finalized(e, rmin, act, E)
    return _host_out(stats, fin, fin_ovf, False)


stats_plain.calls = 0


def finalize_plain(state, slots):
    """``(fin [n, R], ovf [n])`` of each slot in ``slots``: the finalized
    distances and whether any active read's is outside the band
    (``_j_finalize``)."""
    finalize_plain.calls += 1
    _W, E = _geometry(state)
    si = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                         device=state["D"].device)
    fin, ovf = ts.finalized(state["e"][si], state["rmin"][si],
                            state["act"][si], E)
    return fin.cpu().numpy(), ovf.cpu().numpy()


finalize_plain.calls = 0


def deactivate_plain(state, pairs) -> None:
    """Clear ``act`` at every ``(slot, read)`` of ``pairs`` (``[2, m]``,
    ``_j_deactivate_batch``)."""
    deactivate_plain.calls += 1
    p = torch.as_tensor(np.asarray(pairs, dtype=np.int64),
                        device=state["act"].device)
    state["act"][p[0], p[1]] = False


deactivate_plain.calls = 0


def plain_calls() -> int:
    """Calls of every twin of this module since their counts were last
    zeroed."""
    return sum(fn.calls for fn in TWINS)


# ---------------------------------------------------------------------
# CUDA kernels: bind, launch (the build lives in ops/cuda_build.py)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rows": [_INT] * 2 + [_PTR] * 13 + [_INT] * 13 + [_PTR],
    "root": [_PTR] * 9 + [_INT] * 6 + [_PTR],
    "deactivate": [_PTR] * 2 + [_INT] * 4 + [_PTR],
}


def branch_cuda(entry: str, launcher: str, *args) -> None:
    """Call the C entry ``branch_<launcher>_launch`` of
    ``csrc/branch_step.cu`` with ``args``; raises when it refuses the plan
    or the launch fails, never falls back.  Each call adds one to
    ``branch_cuda.launches`` and to ``branch_cuda.entries[entry]``."""
    name = f"branch_{launcher}_launch"
    rc = rpk._bind(name, _ARGTYPES[launcher])(*args)
    rpk._raise_on(rc, f"branch_step {entry}", name)
    branch_cuda.launches += 1
    branch_cuda.entries[entry] += 1


branch_cuda.launches = 0
branch_cuda.entries = dict.fromkeys(
    ("root", "copy", "advance", "stats", "finalize", "deactivate"), 0)
branch_cuda.last_plan = None


def _check_store(state, reads, rlen):
    dev = state["D"].device
    if dev.type != "cuda":
        raise ValueError("branch_step needs tensors on a CUDA device")
    B, R, W = state["D"].shape
    rpk._need(state["D"], torch.int32, dev, "D")
    for name in ("e", "rmin", "er", "off"):
        rpk._need(state[name], torch.int32, dev, name, (B, R))
    rpk._need(state["act"], torch.bool, dev, "act", (B, R))
    rpk._need(state["cons"], torch.int32, dev, "cons")
    rpk._need(state["clen"], torch.int32, dev, "clen", (B,))
    if state["cons"].shape[0] != B:
        raise ValueError("cons: need [B, C]")
    rpk._need(rlen, torch.int32, dev, "rlen", (R,))
    if reads is not None:
        rpk._need(reads, torch.int16, dev, "reads")
        if reads.shape[0] != R:
            raise ValueError("reads: need [R, L]")
    return dev, B, R, W


def _upload(host: np.ndarray, dev):
    """One host-to-device copy of a small int32 array, from pinned
    memory."""
    return torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)


def _store_ptrs(st):
    return [rpk._ptr(st[k])
            for k in ("D", "e", "rmin", "er", "off", "act", "cons", "clen")]


def _rows_cuda(entry, mode, votes, state, rows, reads, rlen, wc, et,
               num_symbols, with_out):
    dev, B, R, W = _check_store(state, reads, rlen)
    n = rows.shape[1]
    C = state["cons"].shape[1]
    A = max(int(num_symbols), 1)
    plan = plan_branch(n, R, W, A)
    words = plan.out_words if votes else plan.head_words
    out = (torch.empty(words, dtype=torch.int32, device=dev) if with_out
           else None)
    slab = (torch.empty(slab_words(n, R, W, C), dtype=torch.int32,
                        device=dev) if mode == 0 else None)
    rows_dev = _upload(rows, dev)
    branch_cuda(
        entry, "rows", mode, int(votes), *_store_ptrs(state),
        *map(rpk._ptr, (reads, rlen, rows_dev, out, slab)), B, R, W, C,
        reads.shape[1], n, A, wc, int(et), plan.warps, plan.blocks,
        plan.commit_blocks, plan.commit_rows, cuda_build.stream_ptr(dev),
    )
    branch_cuda.last_plan = plan
    if out is None:
        return None
    host = torch.empty(words, dtype=torch.int32, pin_memory=True)
    host.copy_(out)
    return unpack(host.numpy(), n, R, A, votes)


def root_cuda(state, slot: int, act, rlen) -> None:
    """Launch ``branch_root``: :func:`root_plain` on the card."""
    dev, B, R, W = _check_store(state, None, rlen)
    rpk._need(act, torch.bool, dev, "act", (R,))
    if not 0 <= slot < B:
        raise ValueError(f"slot {slot} outside [0, {B})")
    branch_cuda(
        "root", "root", *_store_ptrs(state)[:6],
        *map(rpk._ptr, (state["clen"], rlen, act)), slot, B, R, W,
        ROW_WARPS, -(-R // ROW_WARPS), cuda_build.stream_ptr(dev),
    )


def advance_cuda(state, rows, reads, rlen, wc: int, et: bool,
                 num_symbols: int, with_stats: bool = True):
    """Launch ``branch_rows`` and ``branch_commit`` (one overflow word
    between them, on the device): :func:`advance_plain` on the card, its
    stats fetched in one copy; a batch of copies (``with_stats`` False)
    does not synchronise."""
    rows = _rows_np(rows)
    _check_rows(state, rows, with_stats)
    return _rows_cuda("advance" if with_stats else "copy", 0, with_stats,
                      state, rows, reads, rlen, wc, et, num_symbols,
                      with_stats)


def _slot_rows(state, slots) -> np.ndarray:
    s = np.asarray(slots, dtype=np.int32).reshape(-1)
    rows = np.stack([s, s, np.full_like(s, -1)])
    B = state["D"].shape[0]
    if len(s) < 1 or s.min() < 0 or s.max() >= B:
        raise ValueError(f"slots outside [0, {B})")
    return rows


def stats_cuda(state, slots, reads, rlen, num_symbols: int) -> BranchOut:
    """Launch ``branch_rows`` in read mode: :func:`stats_plain` on the
    card."""
    return _rows_cuda("stats", 1, True, state, _slot_rows(state, slots),
                      reads, rlen, -2, False, num_symbols, True)


def finalize_cuda(state, slots, reads, rlen):
    """Launch ``branch_rows`` in read mode without the histogram:
    :func:`finalize_plain` on the card."""
    out = _rows_cuda("finalize", 1, False, state, _slot_rows(state, slots),
                     reads, rlen, -2, False, 1, True)
    return out.fin, ~out.fin_ok


def deactivate_cuda(state, pairs) -> None:
    """Launch ``branch_deactivate``: :func:`deactivate_plain` on the
    card."""
    act = state["act"]
    dev = act.device
    if dev.type != "cuda":
        raise ValueError("branch_step needs tensors on a CUDA device")
    rpk._need(act, torch.bool, dev, "act")
    B, R = act.shape
    p = np.ascontiguousarray(pairs, dtype=np.int32)
    m = p.shape[1] if p.ndim == 2 and p.shape[0] == 2 else 0
    if (m < 1 or p[0].min() < 0 or p[0].max() >= B or p[1].min() < 0
            or p[1].max() >= R):
        raise ValueError(f"pairs: need [2, m] inside [{B}, {R}]")
    pairs_dev = _upload(p, dev)
    branch_cuda("deactivate", "deactivate", rpk._ptr(act),
                rpk._ptr(pairs_dev), m, B, R, -(-m // COPY_THREADS),
                cuda_build.stream_ptr(dev))


# ---------------------------------------------------------------------
# dispatch


def _on_cuda(t) -> bool:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no branch kernel for device type {kind!r}")
    return kind == "cuda"


def root(state, slot: int, act, rlen) -> None:
    """Dispatch rule: CPU tensors take :func:`root_plain`, CUDA tensors
    launch :func:`root_cuda`."""
    fn = root_cuda if _on_cuda(state["D"]) else root_plain
    fn(state, slot, act, rlen)


def advance(state, rows, reads, rlen, wc: int, et: bool, num_symbols: int,
            with_stats: bool = True):
    """Dispatch rule: CPU tensors take :func:`advance_plain`, CUDA tensors
    launch :func:`advance_cuda`."""
    fn = advance_cuda if _on_cuda(state["D"]) else advance_plain
    return fn(state, rows, reads, rlen, wc, et, num_symbols, with_stats)


def stats(state, slots, reads, rlen, num_symbols: int) -> BranchOut:
    """Dispatch rule: CPU tensors take :func:`stats_plain`, CUDA tensors
    launch :func:`stats_cuda`."""
    fn = stats_cuda if _on_cuda(state["D"]) else stats_plain
    return fn(state, slots, reads, rlen, num_symbols)


def finalize(state, slots, reads, rlen):
    """Dispatch rule: CPU tensors take :func:`finalize_plain`, CUDA
    tensors launch :func:`finalize_cuda`."""
    if _on_cuda(state["D"]):
        return finalize_cuda(state, slots, reads, rlen)
    return finalize_plain(state, slots)


def deactivate(state, pairs) -> None:
    """Dispatch rule: CPU tensors take :func:`deactivate_plain`, CUDA
    tensors launch :func:`deactivate_cuda`."""
    fn = deactivate_cuda if _on_cuda(state["act"]) else deactivate_plain
    fn(state, pairs)


#: the plain twins, whose calls :func:`plain_calls` sums
TWINS = (root_plain, advance_plain, stats_plain, finalize_plain,
         deactivate_plain)
