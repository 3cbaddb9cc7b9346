"""Search-queue infrastructure for the consensus engines.

Two pieces:

* :class:`PQueueTracker` — beam/threshold accounting sidecar (capability
  parity with upstream ``waffle_con/src/pqueue_tracker.rs:10-144``): histogram
  of queued consensus lengths above a rising threshold, plus per-length
  processed-node capacities.
* :class:`SetPriorityQueue` — a max-priority queue with *set semantics*
  (one entry per key), replacing the reference's ``priority-queue`` crate:
  the engines rely on pushes of an already-present node being detectable
  (upstream ``waffle_con/src/dual_consensus.rs:648,678,731`` asserts they never
  happen).  Ties on priority pop in FIFO order, which is deterministic.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np


class CapacityFullError(Exception):
    """Raised by :meth:`PQueueTracker.process` when a length is at capacity."""


class PQueueTracker:
    """Tracks how many queued items of each consensus length remain above a
    monotonically rising length threshold, and how many items of each
    length have been processed (with a per-length capacity)."""

    def __init__(self, initial_size: int, capacity_per_size: int) -> None:
        self._length_counts: List[int] = [0] * initial_size
        self._total_count = 0
        self._threshold = 0
        self._processed_counts: List[int] = [0] * initial_size
        self._capacity_per_size = capacity_per_size

    def insert(self, value: int) -> None:
        if value >= len(self._length_counts):
            self._length_counts.extend([0] * (value + 1 - len(self._length_counts)))
        self._length_counts[value] += 1
        if value >= self._threshold:
            self._total_count += 1

    def remove(self, value: int) -> None:
        assert self._length_counts[value] > 0
        self._length_counts[value] -= 1
        if value >= self._threshold:
            assert self._total_count > 0
            self._total_count -= 1

    def increment_threshold(self) -> None:
        self.increase_threshold(self._threshold + 1)

    def increase_threshold(self, new_threshold: int) -> None:
        assert new_threshold >= self._threshold
        for t in range(self._threshold, new_threshold):
            if t < len(self._length_counts):
                self._total_count -= self._length_counts[t]
        self._threshold = new_threshold

    def process(self, value: int) -> None:
        """Mark one item of this length processed; error when full."""
        if value >= len(self._processed_counts):
            self._processed_counts.extend(
                [0] * (value + 1 - len(self._processed_counts))
            )
        if self._processed_counts[value] >= self._capacity_per_size:
            raise CapacityFullError("Capacity is full")
        self._processed_counts[value] += 1

    def processed(self, value: int) -> int:
        if value >= len(self._processed_counts):
            return 0
        return self._processed_counts[value]

    def bulk_run_advance(
        self, start_len: int, steps: int, fresh_pop: bool = True
    ) -> bool:
        """Apply the net tracker effect of a constriction-free frontier
        run segment: ``steps`` consecutive (pop at ``L``, process ``L``,
        insert ``L+1``) cycles starting at ``start_len``, where every
        intermediate insert is immediately consumed by the next pop.
        ``fresh_pop`` False means the segment continues an earlier one,
        so its first cycle pops (removes) the entry the previous
        segment's final insert queued.  Returns False (and applies
        nothing) if any touched length is at processing capacity — the
        caller falls back to the exact scalar loop.  All lengths must be
        at or above the threshold (true for any run: pops below the
        threshold are discarded, not run)."""
        if steps <= 0:
            return True
        end = start_len + steps  # exclusive of the final inserted length
        if end >= len(self._processed_counts):
            self._processed_counts.extend(
                [0] * (end + 1 - len(self._processed_counts))
            )
        window = np.asarray(self._processed_counts[start_len:end])
        if window.max(initial=0) >= self._capacity_per_size:
            return False
        self._processed_counts[start_len:end] = (window + 1).tolist()
        if not fresh_pop:
            self.remove(start_len)
        # intermediate inserts at start_len+1 .. end-1 are each consumed
        # by the following pop, so length_counts only nets the final one
        self.insert(end)
        return True

    def at_capacity(self, value: int) -> bool:
        return self.processed(value) >= self._capacity_per_size

    def __len__(self) -> int:
        return self._total_count

    def unfiltered_len(self) -> int:
        """Entries tracked at every length, below the threshold too."""
        return sum(self._length_counts)

    def is_empty(self) -> bool:
        return self._total_count == 0

    def threshold(self) -> int:
        return self._threshold

    #: horizon for the scalar fallback simulation: a run that commits this
    #: many steps stops with the step-limit code and simply re-engages at
    #: its next pop, so capping the preview costs one extra dispatch at
    #: worst — while an uncapped scalar loop was measured at 82% of the
    #: dual engine's wall time
    SIM_HORIZON = 256

    def simulate_run_bound(
        self,
        start_len: int,
        farthest: int,
        last_constraint: int,
        max_queue_size: int,
        max_nodes_wo_constraint: int,
        max_steps: int,
    ) -> int:
        """Exact preview of how many consecutive frontier pops a
        just-popped node of length ``start_len`` could survive before the
        threshold or per-length capacity bookkeeping would prune it,
        assuming no other queue activity — which is exactly the state of
        affairs during a device-resident extension run.  Lets the run
        engage on nodes *behind* the farthest frontier without risking a
        replayed step the real search would have pruned.

        Fast path: for a node at the frontier (``start_len >= farthest``)
        the threshold can never overtake the run — constriction raises it
        at most to ``farthest``, which trails the run's own lengths — so
        the only possible cut is a capacity-saturated length, found with
        one vectorized scan of the processed-counts window."""
        if start_len >= farthest:
            pc = self._processed_counts
            cap = self._capacity_per_size
            lo = start_len + 1
            hi = min(start_len + max_steps, len(pc))
            if lo < hi:
                window = np.asarray(pc[lo:hi]) >= cap
                j = int(np.argmax(window))
                if window[j]:
                    return j + 1  # first saturated length is step j+1
            return max_steps
        max_steps = min(max_steps, self.SIM_HORIZON)
        lc = list(self._length_counts)
        pc = list(self._processed_counts)
        total = self._total_count
        thr = self._threshold
        cap = self._capacity_per_size
        for j in range(max_steps):
            length = start_len + j
            if j > 0:
                while (
                    total > max_queue_size
                    or last_constraint >= max_nodes_wo_constraint
                ) and thr < farthest:
                    if thr < len(lc):
                        total -= lc[thr]
                    thr += 1
                    last_constraint = 0
                if length < thr:
                    return j
                if length < len(pc) and pc[length] >= cap:
                    return j
                # remove(length): the node leaves the queue for this pop
                if length < len(lc) and lc[length] > 0:
                    lc[length] -= 1
                    if length >= thr:
                        total -= 1
            farthest = max(farthest, length)
            last_constraint += 1
            while length >= len(pc):
                pc.append(0)
            pc[length] += 1
            # insert(length + 1): the extended node re-enters the queue
            while length + 1 >= len(lc):
                lc.append(0)
            lc[length + 1] += 1
            if length + 1 >= thr:
                total += 1
        return max_steps

    def export_windows(self, length: int):
        """Length-count and processed-count arrays padded or truncated to
        ``length`` (the pop arena's tracker input; see
        ``ops/arena_kernel.py``)."""
        lc = np.zeros(length, dtype=np.int32)
        pc = np.zeros(length, dtype=np.int32)
        n = min(length, len(self._length_counts))
        lc[:n] = self._length_counts[:n]
        m = min(length, len(self._processed_counts))
        pc[:m] = self._processed_counts[:m]
        return lc, pc

    # -- checkpoint seam (models/checkpoint.py) ------------------------

    def export_state(self) -> dict:
        """JSON-serializable full state for a search checkpoint."""
        return {
            "length_counts": list(self._length_counts),
            "total_count": self._total_count,
            "threshold": self._threshold,
            "processed_counts": list(self._processed_counts),
            "capacity_per_size": self._capacity_per_size,
        }

    def restore_state(self, state: dict) -> None:
        """Overwrite this tracker with an :meth:`export_state` snapshot.

        The capacity must match the one this tracker was constructed
        with (it comes from the same config), so a checkpoint can never
        bring in different beam semantics."""
        if int(state["capacity_per_size"]) != self._capacity_per_size:
            raise ValueError(
                "tracker capacity mismatch: checkpoint "
                f"{state['capacity_per_size']} vs config "
                f"{self._capacity_per_size}"
            )
        self._length_counts = [int(v) for v in state["length_counts"]]
        self._total_count = int(state["total_count"])
        self._threshold = int(state["threshold"])
        self._processed_counts = [
            int(v) for v in state["processed_counts"]
        ]


class SetPriorityQueue:
    """Max-priority queue keyed by hashable identity.

    ``push`` returns ``False`` (and leaves the queue unchanged apart from
    updating the stored payload/priority) when the key is already present —
    the engines assert this never fires, mirroring the reference's
    duplicate-node invariant.  Pop order: highest priority first; equal
    priorities pop in insertion order.
    """

    def __init__(self) -> None:
        # heap entries: (neg_priority_tuple, seq, key)
        self._heap: List[Tuple[Any, int, Hashable]] = []
        self._live: Dict[Hashable, Tuple[Any, Any]] = {}  # key -> (priority, item)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._live)

    def is_empty(self) -> bool:
        return not self._live

    def push(self, key: Hashable, item: Any, priority: Tuple) -> bool:
        """Insert ``item`` with ``priority`` (a tuple where larger wins).

        Returns True if the key was new.  When the key is already present
        the queue is left untouched and False is returned, so the caller
        still owns (and must dispose of) the rejected item.
        """
        if key in self._live:
            return False
        self._live[key] = (priority, item)
        heapq.heappush(self._heap, (self._negate(priority), self._seq, key))
        self._seq += 1
        return True

    def peek_priority(self) -> Optional[Tuple]:
        """Priority of the current best entry, or None when empty."""
        while self._heap:
            _neg, _seq, key = self._heap[0]
            if key in self._live:
                return self._live[key][0]
            heapq.heappop(self._heap)
        return None

    def peek_top(self, k: int) -> List[Tuple[Any, Tuple]]:
        """Up to ``k`` best ``(item, priority)`` pairs in pop order,
        without removing them (used for speculative expansion and
        frontier ganging).

        Partial selection: the backing array is a binary heap, so the
        next-best candidates are reachable by walking it as a tree with
        an auxiliary frontier heap — O(k log k) comparisons per call
        instead of the O(n log k) full scan ``heapq.nsmallest`` costs,
        which scaled every pop with queue depth on deep tie-heavy
        queues.  Stale entries (already popped keys) are skipped but
        their subtrees are still expanded, since a stale parent still
        heap-dominates its children."""
        out: List[Tuple[Any, Tuple]] = []
        if k <= 0 or not self._live:
            return out
        heap = self._heap
        # drain stale entries off the root so repeated peeks stay cheap
        while heap and heap[0][2] not in self._live:
            heapq.heappop(heap)
        if not heap:  # pragma: no cover - _live nonempty implies a root
            return out
        n = len(heap)
        # (entry, index) pairs: entries order by (neg_priority, seq) and
        # seq is unique, so comparison never reaches index or key —
        # emission order is exactly pop order
        frontier: List[Tuple[Tuple[Any, int, Hashable], int]] = [(heap[0], 0)]
        while frontier and len(out) < k:
            entry, i = heapq.heappop(frontier)
            live = self._live.get(entry[2])
            if live is not None:
                out.append((live[1], live[0]))
            left = 2 * i + 1
            if left < n:
                heapq.heappush(frontier, (heap[left], left))
            if left + 1 < n:
                heapq.heappush(frontier, (heap[left + 1], left + 1))
        return out

    def pop(self) -> Tuple[Any, Any]:
        """Remove and return ``(item, priority)`` of the best entry."""
        return self.pop_with_seq()[:2]

    def pop_with_seq(self) -> Tuple[Any, Any, int]:
        """Like :meth:`pop` but also returns the entry's insertion
        sequence number, so a speculative pop can be undone with
        :meth:`push_restored` without disturbing FIFO tie order."""
        while self._heap:
            _neg, seq, key = heapq.heappop(self._heap)
            entry = self._live.get(key)
            if entry is None:
                continue  # stale (already popped)
            priority, item = entry
            del self._live[key]
            return item, priority, seq
        raise IndexError("pop from empty SetPriorityQueue")

    def push_restored(
        self, key: Hashable, item: Any, priority: Tuple, seq: int
    ) -> bool:
        """Re-insert a speculatively popped entry with its ORIGINAL
        sequence number: ties against entries inserted after the original
        push still pop this entry first, exactly as if the speculative
        pop never happened.  Returns False (queue unchanged) when the key
        is already present."""
        if key in self._live:
            return False
        self._live[key] = (priority, item)
        heapq.heappush(self._heap, (self._negate(priority), seq, key))
        return True

    # -- checkpoint seam (models/checkpoint.py) ------------------------

    def export_entries(self) -> List[Tuple[Hashable, Any, Tuple, int]]:
        """Every live entry as ``(key, item, priority, seq)`` in exact
        pop order (priority first, insertion sequence breaking ties).

        Re-inserting each entry into a fresh queue with
        :meth:`push_restored` (then :meth:`restore_seq`) reproduces this
        queue's pop order, FIFO tie order included."""
        out: List[Tuple[Hashable, Any, Tuple, int]] = []
        seen = set()
        for _neg, seq, key in sorted(self._heap):
            if key in seen or key not in self._live:
                continue  # stale entry from a speculative pop/re-push
            seen.add(key)
            priority, item = self._live[key]
            out.append((key, item, priority, seq))
        return out

    def export_seq(self) -> int:
        """The insertion-sequence counter (monotonic push count)."""
        return self._seq

    def restore_seq(self, seq: int) -> None:
        """Advance the insertion-sequence counter to at least ``seq`` so
        future pushes tie-break after every restored entry."""
        self._seq = max(self._seq, int(seq))

    @staticmethod
    def _negate(priority: Tuple) -> Tuple:
        return tuple(-p for p in priority)
