"""The ``WavefrontScorer`` seam between the host search engine and the
alignment kernels.

The engines (``models/consensus.py``, ``models/dual_consensus.py``;
``models/priority_consensus.py`` drives the dual one) own
the least-cost-first search — priority queue, thresholds, candidate
nomination, activation — and talk to per-*branch* wavefront state only through this interface.  A branch is
one consensus hypothesis; its state is one incremental DWFA per tracked
read.

Implementations:

* :class:`PythonScorer` (here) — one :class:`~waffle_con_tpu_torch.ops.dwfa.DWFALite`
  object per (branch, read); the executable-specification oracle.
* ``TorchScorer`` (:mod:`waffle_con_tpu_torch.ops.torch_scorer`) — all
  branches and reads batched in torch tensors on one device, with the
  run loop as a hand-written CUDA kernel.
* ``ShardedScorer`` (:mod:`waffle_con_tpu_torch.ops.sharded_scorer`) —
  the device branch store with its reads split over the devices of a
  mesh (``config.mesh_shards``), one ``TorchScorer`` a shard.
* ``NativeScorer`` (:mod:`waffle_con_tpu_torch.native`) — the C++ branch
  store, one incremental DWFA per (branch, read) on the host.
* :class:`SubsetScorer` (here) — a view of any of them, restricted to the
  reads of one priority-engine worklist group, so that one scorer per
  chain level serves every group at that level.

All implementations agree exactly: integer edit distances and integer
tip-vote counts (the engine does the fractional-vote arithmetic host-side
in read order, so float summation order is the same on every backend).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.ops.alignment import wfa_ed_config
from waffle_con_tpu_torch.ops.dwfa import DWFALite


class BranchStats:
    """Per-branch observation snapshot returned by scorer calls.

    Attributes (``R`` reads, ``A`` dense symbols):

    * ``eds`` — ``[R] int64`` current edit distance per read (0 if
      untracked).
    * ``occ`` — ``[R, A] int64`` tip votes: how many wavefront tips of
      read ``r`` nominate dense symbol ``a`` as the next consensus base.
    * ``split`` — ``[R] int64`` total tips per read (vote normalizer).
    * ``reached`` — ``[R] bool`` whether the read's wavefront has touched
      the end of its baseline (False if untracked).
    * ``fin`` — optional ``[R] int64`` finalized distances at this
      position, bundled by scorers whose snapshot computes them for free
      (``None`` when unknown or out of band).
    """

    __slots__ = ("eds", "occ", "split", "reached", "fin")

    def __init__(self, eds, occ, split, reached, fin=None):
        self.eds = eds
        self.occ = occ
        self.split = split
        self.reached = reached
        self.fin = fin


class DeferredStats(BranchStats):
    """A :class:`BranchStats` whose arrays are fetched on first access:
    the async seam of the JAX package's ``ops/scorer.py``, where a device
    run returns its control scalars at once and its bulk observation
    arrays later.  ``fetch`` is a zero-argument callable returning the
    real :class:`BranchStats`; every field read resolves it once, and a
    field write (the ``garbage`` fault's payload) resolves, then writes
    through.

    The supervisor resolves every result inside its policy boundary
    (:func:`resolve_stats`), so a timeout, a garbage result or a demotion
    is blamed on the call that produced it.  ``TorchScorer`` returns none:
    its run kernels write the control scalars and the stats into one
    packed buffer that crosses to the host in one copy, so deferring the
    stats would add a second copy and save nothing.
    """

    __slots__ = ("_fetch", "_value")

    def __init__(self, fetch) -> None:
        self._fetch = fetch
        self._value: Optional[BranchStats] = None

    def resolve(self) -> BranchStats:
        """Fetch the arrays; idempotent."""
        if self._value is None:
            self._value = self._fetch()
            self._fetch = None
        return self._value

    def _get(name):  # noqa: N805 - descriptor factory, not a method
        def getter(self):
            return getattr(self.resolve(), name)

        def setter(self, value):
            setattr(self.resolve(), name, value)

        return property(getter, setter)

    eds = _get("eds")
    occ = _get("occ")
    split = _get("split")
    reached = _get("reached")
    fin = _get("fin")
    del _get


def resolve_stats(obj):
    """Resolve every :class:`DeferredStats` reachable in a call's result
    (lists and tuples walked); returns ``obj``."""
    if isinstance(obj, DeferredStats):
        obj.resolve()
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            resolve_stats(x)
    return obj


def build_symbol_table(reads: Sequence[bytes], wildcard: Optional[int]) -> np.ndarray:
    """Dense symbol table: sorted distinct bytes over all reads (plus the
    wildcard if configured).  Index in this array == dense id."""
    symbols = set()
    for read in reads:
        symbols.update(read)
    if wildcard is not None:
        symbols.add(wildcard)
    return np.array(sorted(symbols), dtype=np.int64)


def find_activation_offset(
    consensus: bytes,
    sequence: bytes,
    offset_window: int,
    offset_compare_length: int,
    wildcard: Optional[int],
) -> int:
    """Search the tail window of ``consensus`` for the best starting offset
    of a late-activating read: prefix-mode WFA of the read's head against
    every window position, first-best wins with the window midpoint as
    the incumbent."""
    cmp_len = min(offset_compare_length, len(sequence))
    con_len = len(consensus)
    start_position = max(0, con_len - (offset_window + cmp_len))
    end_position = max(0, con_len - cmp_len)

    best_offset = max(0, con_len - (cmp_len + offset_window // 2))
    head = sequence[:cmp_len]
    min_ed = wfa_ed_config(consensus[best_offset:], head, False, wildcard)
    for p in range(start_position, end_position):
        ed = wfa_ed_config(consensus[p:], head, False, wildcard)
        if ed < min_ed:
            min_ed = ed
            best_offset = p
    return best_offset


class WavefrontScorer:
    """Abstract branch-store interface. Handles are opaque integers."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig) -> None:
        self.reads = [bytes(r) for r in reads]
        self.config = config
        self.symtab = build_symbol_table(self.reads, config.wildcard)
        self.sym_id: Dict[int, int] = {
            int(s): i for i, s in enumerate(self.symtab)
        }
        #: dispatch accounting, extended by device backends
        self.counters: Dict[str, int] = {}

    @property
    def num_reads(self) -> int:
        return len(self.reads)

    @property
    def num_symbols(self) -> int:
        return len(self.symtab)

    def best_activation_offset(
        self,
        consensus: bytes,
        seq_index: int,
        offset_window: int,
        offset_compare_length: int,
        wildcard: Optional[int],
    ) -> int:
        """Best starting offset for a late-activating read (see
        :func:`find_activation_offset`)."""
        return find_activation_offset(
            consensus, self.reads[seq_index], offset_window,
            offset_compare_length, wildcard,
        )

    # -- branch lifecycle ------------------------------------------------
    def root(self, active: np.ndarray) -> int:
        raise NotImplementedError

    def clone(self, h: int) -> int:
        raise NotImplementedError

    def clone_many(self, hs: List[int]) -> List[int]:
        """Batched :meth:`clone`; backends override to fuse into one
        device call."""
        return [self.clone(h) for h in hs]

    def free(self, h: int) -> None:
        raise NotImplementedError

    # -- state evolution -------------------------------------------------
    def push(self, h: int, consensus: bytes) -> BranchStats:
        """``consensus`` must be the branch's previous consensus plus
        exactly one appended symbol; advances every tracked read."""
        raise NotImplementedError

    def push_many(
        self, specs: List[Tuple[int, bytes]]
    ) -> List[BranchStats]:
        """Batched :meth:`push` over ``(handle, consensus)`` pairs; backends
        override to fuse into one device call."""
        return [self.push(h, consensus) for h, consensus in specs]

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        """Recompute the snapshot without mutating state."""
        raise NotImplementedError

    def activate(self, h: int, read_index: int, offset: int, consensus: bytes) -> None:
        """Begin tracking ``read_index`` with the given consensus offset and
        catch its wavefront up to the current consensus."""
        raise NotImplementedError

    def deactivate(self, h: int, read_index: int) -> None:
        """Stop tracking a read."""
        raise NotImplementedError

    def deactivate_many(self, pairs: List[Tuple[int, int]]) -> None:
        """Batched :meth:`deactivate` over ``(handle, read_index)`` pairs."""
        for h, read_index in pairs:
            self.deactivate(h, read_index)

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        """Edit distances after forcing every tracked read's wavefront to
        the end of its baseline — computed on a scratch copy, the branch
        itself is not mutated.  Untracked reads report 0."""
        raise NotImplementedError


class PythonScorer(WavefrontScorer):
    """Reference oracle: per-(branch, read) ``DWFALite`` objects."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig) -> None:
        super().__init__(reads, config)
        self._branches: Dict[int, List[Optional[DWFALite]]] = {}
        self._next = 0

    def _new_handle(self, dwfas: List[Optional[DWFALite]]) -> int:
        h = self._next
        self._next += 1
        self._branches[h] = dwfas
        return h

    def root(self, active: np.ndarray) -> int:
        cfg = self.config
        dwfas: List[Optional[DWFALite]] = [
            DWFALite(cfg.wildcard, cfg.allow_early_termination) if a else None
            for a in active
        ]
        return self._new_handle(dwfas)

    def clone(self, h: int) -> int:
        self._count("clone_calls")
        return self._new_handle(
            [dw.clone() if dw is not None else None for dw in self._branches[h]]
        )

    def free(self, h: int) -> None:
        self._branches.pop(h, None)

    def _count(self, key: str) -> None:
        self.counters[key] = self.counters.get(key, 0) + 1

    def push(self, h: int, consensus: bytes) -> BranchStats:
        self._count("push_calls")
        dwfas = self._branches[h]
        for read, dw in zip(self.reads, dwfas):
            if dw is not None:
                dw.update(read, consensus)
        return self._snapshot(dwfas, consensus)

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        self._count("stats_calls")
        return self._snapshot(self._branches[h], consensus)

    def activate(self, h: int, read_index: int, offset: int, consensus: bytes) -> None:
        self._count("activate_calls")
        dwfas = self._branches[h]
        assert dwfas[read_index] is None
        cfg = self.config
        dw = DWFALite(cfg.wildcard, cfg.allow_early_termination)
        dw.set_offset(offset)
        dw.update(self.reads[read_index], consensus)
        dwfas[read_index] = dw

    def deactivate(self, h: int, read_index: int) -> None:
        self._branches[h][read_index] = None

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        self._count("finalize_calls")
        eds = np.zeros(self.num_reads, dtype=np.int64)
        for r, dw in enumerate(self._branches[h]):
            if dw is not None:
                scratch = dw.clone()
                scratch.finalize(self.reads[r], consensus)
                eds[r] = scratch.edit_distance
        return eds

    # -----------------------------------------------------------------
    def _snapshot(
        self, dwfas: List[Optional[DWFALite]], consensus: bytes
    ) -> BranchStats:
        n = self.num_reads
        a = self.num_symbols
        eds = np.zeros(n, dtype=np.int64)
        occ = np.zeros((n, a), dtype=np.int64)
        split = np.zeros(n, dtype=np.int64)
        reached = np.zeros(n, dtype=bool)
        for r, dw in enumerate(dwfas):
            if dw is None:
                continue
            read = self.reads[r]
            eds[r] = dw.edit_distance
            reached[r] = dw.reached_baseline_end(read)
            votes = dw.get_extension_candidates(read, consensus)
            total = 0
            for sym, count in votes.items():
                occ[r, self.sym_id[sym]] = count
                total += count
            split[r] = total
        return BranchStats(eds, occ, split, reached)


def _slice_stats(stats: BranchStats, idx: np.ndarray) -> BranchStats:
    """``stats`` restricted to the reads at ``idx``."""
    return BranchStats(
        stats.eds[idx],
        stats.occ[idx],
        stats.split[idx],
        stats.reached[idx],
        stats.fin[idx] if stats.fin is not None else None,
    )


def _sliced_clone_push_many(inner, idx, specs):
    return [
        (h, _slice_stats(s, idx) if s is not None else None)
        for h, s in inner(specs)
    ]


def _sliced_run_extend(inner, idx, h, consensus, *args, **kwargs):
    steps, code, appended, stats, records = inner(h, consensus, *args, **kwargs)
    return (
        steps, code, appended, _slice_stats(stats, idx),
        [(j, fin[idx]) for j, fin in records],
    )


def _sliced_run_extend_dual(inner, idx, *args, **kwargs):
    (steps, code, app1, app2, stats1, stats2, act1, act2, records) = inner(
        *args, **kwargs
    )
    return (
        steps, code, app1, app2,
        _slice_stats(stats1, idx), _slice_stats(stats2, idx),
        act1[idx], act2[idx],
        [
            (j, f1[idx], f2[idx], a1[idx], a2[idx])
            for j, f1, f2, a1, a2 in records
        ],
    )


def _sliced_run_arena(inner, idx, *args, **kwargs):
    (events, nsteps, code, stop_node, node_steps, appended, sides_stats,
     sides_act, alive, creations) = inner(*args, **kwargs)
    return (
        events, nsteps, code, stop_node, node_steps, appended,
        [None if s is None else _slice_stats(s, idx) for s in sides_stats],
        [None if a is None else a[idx] for a in sides_act],
        alive, creations,
    )


class SubsetScorer(WavefrontScorer):
    """View of a shared base scorer restricted to a subset of its reads.

    The priority engine solves one dual search per worklist group over a
    subset of one chain level's sequences.  A scorer built per group
    would upload the reads again and plan the kernels for each group's
    geometry; this view maps a group onto one scorer built over the whole
    level instead.  Group membership is the root activation mask: reads
    outside the group are inactive lanes, exactly as pruned reads are, so
    results equal those of a scorer over the group alone.  Per-read
    outputs are gathered back to the group's local index space, and
    local read indices are mapped to the base's on the way in.

    Handles are the base's handles.  ``indices`` must be sorted.  The
    fast paths (``clone_push_many``, ``run_extend``, ``run_extend_dual``,
    ``run_arena``) are ``None`` when the base lacks them, and otherwise hold the base and
    the index map but not the view, so the engine's cached
    :func:`fast_paths` snapshot makes no reference cycle: once the last
    view and the caller's reference go, the base and its device tensors
    are freed at once.
    """

    def __init__(self, base: WavefrontScorer, indices: Sequence[int]) -> None:
        self.base = base
        self.indices = np.asarray(list(indices), dtype=np.int64)
        self.reads = [base.reads[i] for i in self.indices]
        self.config = base.config
        self.symtab = base.symtab
        self.sym_id = base.sym_id

    @property
    def counters(self) -> Dict[str, int]:
        return self.base.counters

    @property
    def fastpath_gen(self) -> int:
        # forwarded so a supervised base's demotion or re-promotion
        # invalidates a fast_paths() snapshot taken over this view
        return getattr(self.base, "fastpath_gen", 0)

    def _slice(self, stats: BranchStats) -> BranchStats:
        return _slice_stats(stats, self.indices)

    # -- branch lifecycle ----------------------------------------------
    def root(self, active: np.ndarray) -> int:
        full = np.zeros(self.base.num_reads, dtype=bool)
        full[self.indices] = np.asarray(active, dtype=bool)
        return self.base.root(full)

    def clone(self, h: int) -> int:
        return self.base.clone(h)

    def clone_many(self, hs: List[int]) -> List[int]:
        return self.base.clone_many(hs)

    def free(self, h: int) -> None:
        self.base.free(h)

    # -- state evolution -----------------------------------------------
    def push(self, h: int, consensus: bytes) -> BranchStats:
        return self._slice(self.base.push(h, consensus))

    def push_many(
        self, specs: List[Tuple[int, bytes]]
    ) -> List[BranchStats]:
        return [self._slice(s) for s in self.base.push_many(specs)]

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        return self._slice(self.base.stats(h, consensus))

    def activate(
        self, h: int, read_index: int, offset: int, consensus: bytes
    ) -> None:
        self.base.activate(
            h, int(self.indices[read_index]), offset, consensus
        )

    def deactivate(self, h: int, read_index: int) -> None:
        self.base.deactivate(h, int(self.indices[read_index]))

    def deactivate_many(self, pairs: List[Tuple[int, int]]) -> None:
        self.base.deactivate_many(
            [(h, int(self.indices[r])) for h, r in pairs]
        )

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        return self.base.finalized_eds(h, consensus)[self.indices]

    def best_activation_offset(
        self, consensus, seq_index, offset_window, offset_compare_length,
        wildcard,
    ) -> int:
        return self.base.best_activation_offset(
            consensus, int(self.indices[seq_index]), offset_window,
            offset_compare_length, wildcard,
        )

    # -- device fast paths (None when the base lacks them) -------------
    def _forward(self, name: str, sliced):
        inner = getattr(self.base, name, None)
        if inner is None:
            return None
        return functools.partial(sliced, inner, self.indices)

    @property
    def clone_push_many(self):
        return self._forward("clone_push_many", _sliced_clone_push_many)

    @property
    def run_extend(self):
        return self._forward("run_extend", _sliced_run_extend)

    @property
    def run_extend_dual(self):
        return self._forward("run_extend_dual", _sliced_run_extend_dual)

    @property
    def run_arena(self):
        return self._forward("run_arena", _sliced_run_arena)

    # the launch planners' answers and the gang probe are the base's: the
    # view launches the base's kernels at the base's shape, with its
    # handles
    @property
    def run_takes(self):
        return getattr(self.base, "run_takes", None)

    @property
    def run_dual_takes(self):
        return getattr(self.base, "run_dual_takes", None)

    @property
    def arena_takes(self):
        return getattr(self.base, "arena_takes", None)

    def ragged_run_probe(self, h: int):
        inner = getattr(self.base, "ragged_run_probe", None)
        return inner(h) if inner is not None else None

    # the arena's sizes are the base's (the view adds no node)
    @property
    def ARENA_CAP(self):
        return self.base.ARENA_CAP

    @property
    def ARENA_K(self):
        return self.base.ARENA_K

    @property
    def ARENA_CRE_PER_EVENT(self):
        return getattr(self.base, "ARENA_CRE_PER_EVENT", 0)

    @property
    def ARENA_TAKE_MAX(self):
        return getattr(self.base, "ARENA_TAKE_MAX", self.base.ARENA_K - 1)


def _takes_any(*_shape) -> bool:
    return True


class FastPaths:
    """The resolved optional-capability surface of a scorer, snapshotted
    once so the engine's per-pop feature tests do not re-probe it.  A
    scorer without an attribute (the Python oracle) makes the engine take
    its per-pop expand path instead.  ``run_takes``, ``run_dual_takes``
    and ``arena_takes`` ask the kernels' launch planners, at the store's
    shape of the moment, whether a launch would be taken; a refusal means
    the engine takes its host path for that pop (scorers without planners
    take every shape)."""

    __slots__ = (
        "run_extend", "run_extend_dual", "run_arena", "clone_push_many",
        "arena_cap", "arena_k", "arena_cre_per_event", "arena_take_max",
        "run_takes", "run_dual_takes", "arena_takes", "gen",
    )

    def __init__(self, scorer, gen: int = 0) -> None:
        self.gen = gen
        self.run_extend = getattr(scorer, "run_extend", None)
        self.run_extend_dual = getattr(scorer, "run_extend_dual", None)
        self.run_arena = getattr(scorer, "run_arena", None)
        self.run_takes = getattr(scorer, "run_takes", None) or _takes_any
        self.run_dual_takes = (
            getattr(scorer, "run_dual_takes", None) or _takes_any)
        self.arena_takes = getattr(scorer, "arena_takes", None) or _takes_any
        self.clone_push_many = getattr(scorer, "clone_push_many", None)
        self.arena_cap = getattr(scorer, "ARENA_CAP", 0)
        self.arena_k = getattr(scorer, "ARENA_K", 1)
        self.arena_cre_per_event = getattr(scorer, "ARENA_CRE_PER_EVENT", 0)
        self.arena_take_max = getattr(
            scorer, "ARENA_TAKE_MAX", self.arena_k - 1
        )


def fast_paths(scorer) -> FastPaths:
    """Cached :class:`FastPaths` for ``scorer``, resolved on first use and
    again whenever the scorer's ``fastpath_gen`` moves (a supervisor
    bumps it at each demotion or re-promotion; 0 for every other
    scorer)."""
    gen = getattr(scorer, "fastpath_gen", 0)
    fp = scorer.__dict__.get("_fastpath_cache")
    if fp is None or fp.gen != gen:
        fp = FastPaths(scorer, gen)
        scorer.__dict__["_fastpath_cache"] = fp
    return fp


def construct_backend(
    reads: Sequence[bytes], config: CdwfaConfig, backend: str
) -> WavefrontScorer:
    """Instantiate one concrete backend scorer.  The one place every
    scorer is born, so it is also where the observability proxies are
    installed: a ``TimedScorer`` when metrics or tracing is on, an
    ``AuditScorerTap`` when an audit capture is (both transparent to
    :class:`FastPaths`: a wrapped scorer launches the same kernels)."""
    if backend == "python":
        scorer = PythonScorer(reads, config)
    elif backend == "torch":
        from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
        from waffle_con_tpu_torch.parallel.mesh import shard_for_config

        # the read-sharded store when config.mesh_shards asks for one
        scorer = shard_for_config(reads, config) or TorchScorer(reads, config)
    elif backend == "native":
        from waffle_con_tpu_torch.native import NativeScorer

        scorer = NativeScorer(reads, config)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    from waffle_con_tpu_torch.obs.audit import maybe_tap
    from waffle_con_tpu_torch.obs.instrument import maybe_instrument

    return maybe_tap(maybe_instrument(scorer, backend), backend)


#: thread-local scorer decoration (see :func:`set_scorer_decorator`)
_SCORER_HOOK = threading.local()


def set_scorer_decorator(decorator):
    """Install a *thread-local* decorator applied to every scorer that
    :func:`make_scorer` builds on this thread; returns the previous one
    so callers can restore it (``None``: none installed).

    This is the serve layer's injection point: a worker thread installs
    ``lambda s: CoalescingScorer(s, dispatcher, job)`` around an engine's
    ``consensus()`` call, and every scorer the engine builds — the
    priority engine's per-level shared scorers included — routes its
    calls through the cross-job batching dispatcher.  Thread-locality
    keeps concurrent jobs from seeing each other's wrappers.  The
    decorator applies only in :func:`make_scorer`, never in
    :func:`construct_backend`: fallback scorers the supervisor builds
    mid-search live inside an already routed call and must not be
    routed again.
    """
    previous = getattr(_SCORER_HOOK, "decorator", None)
    _SCORER_HOOK.decorator = decorator
    return previous


def make_scorer(reads: Sequence[bytes], config: CdwfaConfig) -> WavefrontScorer:
    """Instantiate the scorer selected by ``config.backend``, wrapped in
    the fault-tolerant
    :class:`~waffle_con_tpu_torch.runtime.supervisor.BackendSupervisor`
    when ``config.supervised`` or ``config.backend_chain`` is set, then
    in the calling thread's scorer decorator when one is installed (see
    :func:`set_scorer_decorator`)."""
    if config.supervised or config.backend_chain is not None:
        from waffle_con_tpu_torch.runtime.supervisor import BackendSupervisor

        scorer: WavefrontScorer = BackendSupervisor(reads, config)
    else:
        scorer = construct_backend(reads, config, config.backend)
    decorator = getattr(_SCORER_HOOK, "decorator", None)
    if decorator is not None:
        scorer = decorator(scorer)
    return scorer
