"""Configuration for the consensus engine of the PyTorch/CUDA port.

Same knobs and defaults as ``waffle_con_tpu.config`` for every field the
single- and dual-consensus searches read, plus the port's own scorer selection:
``backend`` is ``"torch"`` (the device branch store), ``"native"`` (the
C++ branch store on the host, :mod:`waffle_con_tpu_torch.native`) or
``"python"`` (the :class:`~waffle_con_tpu_torch.ops.dwfa.DWFALite`
oracle), and ``device`` names the torch device the ``"torch"`` scorer
lives on; the two host engines ignore it.

Typical usage::

    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusCost

    config = (
        CdwfaConfigBuilder()
        .consensus_cost(ConsensusCost.L2_DISTANCE)
        .wildcard(ord("N"))
        .build()
    )
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ConsensusCost(enum.Enum):
    """Scoring model for a consensus."""

    #: Minimize the total edit distance across all sequences.
    L1_DISTANCE = "l1"
    #: Minimize the sum of squared edit distances across all sequences.
    L2_DISTANCE = "l2"

    def apply(self, edit_distance: int) -> int:
        """Map a raw integer edit distance into this cost space."""
        if self is ConsensusCost.L1_DISTANCE:
            return edit_distance
        return edit_distance * edit_distance


@dataclasses.dataclass(frozen=True)
class CdwfaConfig:
    """Configuration of the single- and dual-consensus engines."""

    #: The consensus scoring cost.
    consensus_cost: ConsensusCost = ConsensusCost.L1_DISTANCE
    #: Maximum queue size: how many active branches are allowed during
    #: exploration (counted at or above the rising length threshold).
    max_queue_size: int = 20
    #: Maximum number of nodes *processed* at each consensus length.
    max_capacity_per_size: int = 20
    #: Maximum number of equally-good results tracked.
    max_return_size: int = 10
    #: Maximum explored nodes without constraining the queue threshold;
    #: prevents hyper-branching in truly ambiguous regions.
    max_nodes_wo_constraint: int = 1000
    #: Minimum occurrences of a candidate extension to be used (the
    #: largest-observed candidate is always eligible regardless).
    min_count: int = 3
    #: Minimum fraction of sequences voting for a candidate extension.
    min_af: float = 0.0
    #: For dual consensus: weight nominated extensions by relative edit
    #: distance, accelerating convergence.
    weighted_by_ed: bool = False
    #: Optional wildcard symbol (byte value) that matches anything.
    wildcard: Optional[int] = None
    #: Dual-mode pruning threshold: when a read's two tracked wavefronts
    #: diverge in edit distance by more than this, drop the worse one.
    dual_max_ed_delta: int = 20
    #: If true, input sequences shorter than the final consensus are not
    #: penalized for the unmatched consensus tail.
    allow_early_termination: bool = False
    #: If true, shift all provided offsets down when none start at zero.
    auto_shift_offsets: bool = True
    #: Number of bases before the last offset searched for the optimal
    #: start point of a late-activating sequence.
    offset_window: int = 50
    #: Number of bases compared when scoring candidate start points.
    offset_compare_length: int = 50
    #: Scorer backend: "torch" (device branch store), "native" (the C++
    #: branch store on the host) or "python" (the pure-Python oracle).
    backend: str = "torch"
    #: Torch device of the "torch" backend ("native" and "python" run on
    #: the host whatever it says).  "cuda" never drops to the CPU: the
    #: scorer raises when no CUDA device is present.
    device: str = "cuda"
    #: Seed the band half-width from the caller's error model instead of
    #: growing it from a small default (rounded up to a power of two).
    initial_band: Optional[int] = None
    #: Expand up to this many queue nodes per scorer dispatch: the
    #: children of the popped node and of the next best queued nodes are
    #: cloned and pushed in one call and consumed when those nodes pop.
    prefetch_width: int = 16
    #: Frontier-gang width M: alongside each engaged run, advance the
    #: next-best M - 1 queued branches through one gang launch, their
    #: results kept as deposits their own pops may consume (byte-identical
    #: to M = 1 by construction).  ``None`` is the adaptive width; 1 turns
    #: the gang off.
    frontier_width: Optional[int] = None
    #: Route every scorer call through the fault-tolerant
    #: :class:`~waffle_con_tpu_torch.runtime.supervisor.BackendSupervisor`
    #: (timeout, retry with backoff, mid-search demotion down the backend
    #: chain).  Implied by setting ``backend_chain``.
    supervised: bool = False
    #: Explicit fallback chain for the supervisor, e.g. ``("torch",
    #: "python")``.  ``None`` derives the suffix of torch -> native ->
    #: python that starts at ``backend``.
    backend_chain: Optional[tuple] = None
    #: Wall-clock budget of one scorer call before the supervisor declares
    #: it hung (seconds; ``None`` runs no timer — injected timeouts still
    #: work).
    dispatch_timeout_s: Optional[float] = None
    #: Retries of a failed call on the current backend before demotion.
    dispatch_retries: int = 2
    #: Base delay of the exponential retry backoff (seconds).
    retry_backoff_s: float = 0.05
    #: Uniform-random jitter fraction added to each backoff delay.
    retry_jitter: float = 0.25
    #: Circuit breaker: consecutive failed calls (across ops) before the
    #: supervisor demotes the live search.
    breaker_threshold: int = 3
    #: After this many clean calls on a demoted backend, probe the
    #: next-better backend for re-promotion (doubling after each failed
    #: probe).  ``None`` disables re-promotion.
    repromote_after: Optional[int] = None
    #: Watchdog: pinned budget of blocking scorer calls for one
    #: ``consensus()`` (summed over ``DISPATCH_COUNTER_KEYS``); ``None``
    #: disables the check.
    dispatch_budget: Optional[int] = None
    #: Watchdog strict mode: raise ``WatchdogError`` instead of warning
    #: when the dispatch budget is exceeded.
    watchdog_strict: bool = False
    #: Read-axis sharding of the "torch" branch store: the reads are
    #: split over this many devices of the mesh
    #: (:mod:`waffle_con_tpu_torch.parallel`), the devices of the thread's
    #: pinned ``DeviceSet`` when one is pinned (one device may be listed
    #: more than once), else the local devices of ``device``'s type.
    #: 0 keeps one unsharded store.
    mesh_shards: int = 0
    #: Log each search's one-line summary (the ``SearchReport``
    #: ``summary_line``) at INFO instead of DEBUG.
    log_search_summary: bool = False

    def __post_init__(self) -> None:
        if self.wildcard is not None and not 0 <= self.wildcard <= 255:
            raise ValueError("wildcard must be a byte value (0..=255)")
        if self.backend not in ("python", "native", "torch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.prefetch_width < 1:
            raise ValueError("prefetch_width must be >= 1")
        if self.frontier_width is not None and self.frontier_width < 1:
            raise ValueError("frontier_width must be >= 1")
        if self.initial_band is not None and self.initial_band < 1:
            raise ValueError("initial_band must be >= 1")
        if self.backend_chain is not None:
            chain = tuple(self.backend_chain)
            if not chain:
                raise ValueError("backend_chain must not be empty")
            for b in chain:
                if b not in ("python", "native", "torch"):
                    raise ValueError(f"unknown backend {b!r} in chain")
            if len(set(chain)) != len(chain):
                raise ValueError("backend_chain entries must be unique")
            object.__setattr__(self, "backend_chain", chain)
        if self.dispatch_timeout_s is not None and self.dispatch_timeout_s <= 0:
            raise ValueError("dispatch_timeout_s must be positive")
        if self.dispatch_retries < 0:
            raise ValueError("dispatch_retries must be >= 0")
        if self.retry_backoff_s < 0 or self.retry_jitter < 0:
            raise ValueError("retry backoff and jitter must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.repromote_after is not None and self.repromote_after < 1:
            raise ValueError("repromote_after must be >= 1")
        if self.dispatch_budget is not None and self.dispatch_budget < 1:
            raise ValueError("dispatch_budget must be >= 1")
        if self.mesh_shards < 0:
            raise ValueError("mesh_shards must be >= 0")
        if self.mesh_shards and self.backend != "torch":
            raise ValueError("mesh_shards requires the torch backend")


class CdwfaConfigBuilder:
    """Fluent builder for :class:`CdwfaConfig`."""

    def __init__(self) -> None:
        self._values: dict = {}

    def build(self) -> CdwfaConfig:
        return CdwfaConfig(**self._values)

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in CdwfaConfig.__dataclass_fields__:
            raise AttributeError(name)

        def setter(value):
            self._values[name] = value
            return self

        return setter
