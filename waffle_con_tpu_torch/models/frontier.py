"""Frontier-parallel speculation policy (the adaptive gang width).

The engines' pop loops are serial by contract (byte parity with the
Python oracle is the bar), but on tie-heavy geometries the queue holds
many near-tied branches that will each be popped and advanced in turn.
:class:`FrontierSpeculator` turns that queue depth into device work:
alongside the in-hand node's ``run_extend`` it gangs the next-best M-1
queued branches (``SetPriorityQueue.peek_top``) through one gang launch
(:class:`~waffle_con_tpu_torch.ops.ragged.FrontierGang`).

Nothing here affects results: peers' post-run states are kept as
consume-once deposits (no slot is touched at gang time) and consumed only
after validation against the real pop's arguments, so every M, adaptive
included, is byte-identical to M=1 by construction.  This module only
decides how wide to speculate:

* explicit: the ``frontier_width`` config field, a fixed M clamped to
  the gang capacity (1 switches the gang off);
* adaptive (default): 1 on thin frontiers (a shallow queue, or a
  positive best-vs-next cost gap: the next pop is not a tie, so a peer's
  predicted arguments would rarely validate), wider with queue depth on
  flat ones, and 1 for a cooldown window when the rolling rate of used
  deposits says predictions are not landing.

The JAX package's ``waffle_con_tpu/models/frontier.py``, line for line,
except that the width comes from the config alone: the port reads no
environment knob (the JAX package's ``WAFFLE_FRONTIER_M`` and
``WAFFLE_RAGGED`` decide nothing the config field does not).
"""

from __future__ import annotations

from typing import List, Optional

from waffle_con_tpu_torch.ops import ragged as _ragged
from waffle_con_tpu_torch.ops.ragged import GangMember

__all__ = ["FrontierSpeculator", "GangMember"]


class FrontierSpeculator:
    """Per-search frontier-gang launcher and adaptive width policy.

    One instance per engine search (it caches the resolved device
    scorer and a commit-rate window, both search-local).  The engine asks
    :meth:`width` every pop with the queue depth and the best-vs-next
    cost gap and, when it decides to gang, hands :meth:`gang` the in-hand
    member plus peer predictions.  ``run_extend`` then consumes the
    in-hand deposit immediately; peers' deposits wait for their own pops.
    """

    #: hard cap = FrontierGang.G (fixed member-group capacity)
    MAX_M = _ragged.FrontierGang.G
    #: adaptive: don't gang queues shallower than this
    MIN_DEPTH = 4
    #: commit-rate window: resolutions needed before judging, the rate
    #: below which speculation pauses, and the pause length (in pops)
    RATE_WINDOW = 32
    RATE_FLOOR = 0.25
    COOLDOWN_POPS = 512

    def __init__(self, scorer, config=None) -> None:
        self.scorer = scorer
        self._explicit: Optional[int] = (
            getattr(config, "frontier_width", None) if config else None)
        self._ts = None              # resolved TorchScorer endpoint
        self._probe_failed = False   # scorer has no gangable endpoint
        self._snap = (0, 0)          # (injected, mispredict) window base
        self._cooldown = 0
        self.last_width = 1
        self.last_commit_rate: Optional[float] = None

    # -- endpoint ------------------------------------------------------

    def _endpoint(self, h: int):
        """Resolve (once) the ``TorchScorer`` that owns the slots, through
        ``ragged_run_probe`` (a ``SubsetScorer`` view hops to its base);
        engines on the python/native backends resolve to None and never
        gang."""
        if self._ts is not None:
            return self._ts if h in self._ts._slot_of else None
        if self._probe_failed:
            return None
        probe = getattr(self.scorer, "ragged_run_probe", None)
        ep = probe(h) if probe is not None else None
        if ep is None:
            self._probe_failed = True
            return None
        self._ts = ep[0]
        return self._ts

    # -- adaptive width -------------------------------------------------

    def _window_rate(self) -> Optional[float]:
        ts = self._ts
        if ts is None:
            return None
        inj = ts.counters.get("run_gang_injected", 0)
        mis = ts.counters.get("run_gang_mispredict", 0)
        di = inj - self._snap[0]
        dm = mis - self._snap[1]
        if di + dm <= 0:
            return None
        return di / (di + dm)

    def width(self, queue_depth: int, gap: Optional[int]) -> int:
        """Gang width for this pop (1 = run solo).  ``gap`` is
        ``next_cost - top_cost`` (None when the queue holds one node).
        Pure policy: any return value is byte-safe."""
        if _ragged.serving_active():
            w = 1
        elif self._explicit is not None:
            w = max(1, min(int(self._explicit), self.MAX_M))
        elif self._cooldown > 0:
            self._cooldown -= 1
            if self._cooldown == 0:
                # window over: forget the bad stretch and re-try
                self._reset_window()
            w = 1
        elif queue_depth < self.MIN_DEPTH or (gap is not None and gap > 0):
            # thin frontier: the next pops are not ties, peer argument
            # predictions would rarely validate — don't spend a launch
            w = 1
        else:
            w = min(self.MAX_M, 1 << max(0, queue_depth.bit_length() - 2))
            rate = self._window_rate()
            self.last_commit_rate = rate
            if rate is not None:
                resolved = (
                    self._ts.counters.get("run_gang_injected", 0)
                    - self._snap[0]
                    + self._ts.counters.get("run_gang_mispredict", 0)
                    - self._snap[1]
                )
                if resolved >= self.RATE_WINDOW and rate < self.RATE_FLOOR:
                    self._cooldown = self.COOLDOWN_POPS
                    w = 1
        self.last_width = w
        return w

    def _reset_window(self) -> None:
        ts = self._ts
        if ts is not None:
            self._snap = (
                ts.counters.get("run_gang_injected", 0),
                ts.counters.get("run_gang_mispredict", 0),
            )

    # -- gang launch ----------------------------------------------------

    def gang(self, members: List[GangMember], min_count: int,
             l2: bool) -> int:
        """Launch one frontier gang (in-hand member first).  Returns the
        deposit count (0 = nothing ganged; every member simply runs
        solo)."""
        if len(members) < 2:
            return 0
        ts = self._endpoint(members[0].h)
        if ts is None:
            return 0
        return _ragged.frontier_gang_for(ts).run(members, min_count, l2)

    def pending(self, h: int) -> bool:
        """True when a consume-once deposit is waiting for ``h`` (engines
        keep such nodes out of the arena and of prefetch expansion: their
        next run is already paid for)."""
        ts = self._ts
        if ts is None:
            return False
        gang = ts._frontier_gang
        return gang is not None and gang.pending(h)

    def commit_rate(self) -> Optional[float]:
        """Cumulative rate of used deposits for this search's scorer."""
        ts = self._ts
        if ts is None:
            return None
        inj = ts.counters.get("run_gang_injected", 0)
        mis = ts.counters.get("run_gang_mispredict", 0)
        if inj + mis == 0:
            return None
        return inj / (inj + mis)
