"""Content-addressed consensus cache with checkpoint overlap reuse.

The port of ``waffle_con_tpu``'s ``serve/cache`` package.  The cache
sits between admission and dispatch in
:class:`~waffle_con_tpu_torch.serve.service.ConsensusService` and
answers in three tiers (cheapest first):

1. **exact hit** — the request's canonical key (order-insensitive read
   multiset + scoring config fingerprint, :mod:`.keys`) matches a
   stored result: serve it straight from the wire-codec JSON, zero
   worker involvement and zero kernel launches.  Byte-parity holds by
   construction because the key collapses exactly the degrees of
   freedom the engines ignore (read order; placement-only config
   fields) and nothing else — per-read score vectors are remapped to
   the request's read order.
2. **proposal certify** — a cached result for a read *subset* is
   re-scored against the full request by one exact pass and served only
   at the cached optimal cost (:mod:`.proposal`); anything short
   degrades to a full search.
3. **checkpoint superset** — a finished job's last *bound-free*
   mid-search checkpoint whose read multiset is a subset of the
   request's resumes through ``resume(checkpoint, extra_reads=)``; the
   worker still runs, but from a paid-for frontier instead of scratch.
   Only snapshots taken before the subset search found any complete
   candidate qualify (:func:`resumable_wire`): such a snapshot carries
   no incumbent bound (``maximum_error`` unset, no pending results), so
   no branch has been pruned against subset-only costs and the resumed
   superset search explores the same tree a from-scratch one would.  A
   bound-tightened snapshot would prune the superset's optimum with
   the subset's incumbent — those are never deposited.

Everything here is fail-closed: any gate miss, decode error, or store
corruption (quarantined, never served) falls through to the normal
full-search path, so the cache can cost a lookup but never an answer.
The port reads no environment variable: the service builds its cache
from its :class:`~waffle_con_tpu_torch.serve.service.ServeConfig`
(:meth:`ConsensusCache.from_config`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.serve.cache import keys, proposal
from waffle_con_tpu_torch.serve.cache.store import (
    CheckpointStore,
    FileStore,
    ResultStore,
)
from waffle_con_tpu_torch.serve.procs import wire

#: Per-read score vector fields in the wire result JSON, by job kind —
#: the parts that are functions of read *position* and must be remapped
#: when serving a permuted duplicate.
_SCORE_FIELDS = {
    "single": ("scores",),
    "dual": ("scores1", "scores2", "is_consensus1"),
}


def _remap_sides(item: Dict, stored_sides: List, perm: List[int]) -> None:
    """A dual result's per-side score vectors in the request's read
    order.  ``consensus1.scores`` lists the scores of the reads on side 1
    (``is_consensus1``) in read order, ``consensus2.scores`` those of the
    others: a permuted duplicate reorders them too, not only the full
    ``scores1`` / ``scores2`` / ``is_consensus1`` vectors (the JAX
    package's cache remaps only those three)."""
    for name, side in (("consensus1", True), ("consensus2", False)):
        cons = item.get(name)
        if cons is None:
            continue
        members = [j for j, s in enumerate(stored_sides) if bool(s) == side]
        by_read = dict(zip(members, cons["scores"], strict=True))
        item[name] = dict(cons, scores=[
            by_read[j] for j in perm if bool(stored_sides[j]) == side
        ])


def resumable_wire(wire_ckpt) -> bool:
    """True when a wire-form checkpoint is safe to resume with extra
    reads: its search had found no complete candidate yet, so it
    carries no incumbent bound (``maximum_error`` unset, no pending
    ``results``) and has a live frontier.  Resuming a bound-tightened
    snapshot over a read *superset* would prune with subset-only costs
    and can miss the superset's optimum — never deposit those."""
    try:
        state = wire_ckpt["body"]["state"]
        return bool(
            state["entries"]
            and state.get("maximum_error") is None
            and not state.get("results")
        )
    except (KeyError, TypeError):
        return False


@dataclasses.dataclass(frozen=True)
class CacheHit:
    """A result served without a full search.  ``tier`` is ``"exact"``
    or ``"certified"``; ``result`` is a fresh decoded engine result."""

    tier: str
    result: object


@dataclasses.dataclass(frozen=True)
class CheckpointHit:
    """A cached checkpoint whose reads are a sub-multiset of the
    request's: attach ``checkpoint`` (wire dict) to the job and let the
    engine resume with the extra reads."""

    checkpoint: Dict
    extras: int


class ConsensusCache:
    """Bounded three-tier consensus cache (thread-safe facade)."""

    def __init__(
        self,
        name: str,
        max_results: int = 256,
        max_checkpoints: int = 64,
        proposals: bool = True,
        cache_dir: Optional[str] = None,
    ) -> None:
        self.name = name
        self.proposals = proposals
        self._lock = lockcheck.make_lock(f"serve.cache.ConsensusCache.{name}")
        self._results = ResultStore(max_results)
        self._checkpoints = CheckpointStore(max_checkpoints)
        self._files = FileStore(cache_dir) if cache_dir else None
        self._counts = {
            "exact": 0, "certified": 0, "checkpoint": 0, "misses": 0,
            "deposits": 0, "ckpt_deposits": 0, "certify_failed": 0,
        }

    @classmethod
    def from_config(cls, name: str, serve_config) -> Optional["ConsensusCache"]:
        """The cache a :class:`~waffle_con_tpu_torch.serve.service.
        ServeConfig` asks for, or ``None`` when caching is off (the
        default)."""
        if not serve_config.cache:
            return None
        return cls(
            name,
            max_results=serve_config.cache_max_results,
            max_checkpoints=serve_config.cache_max_checkpoints,
            proposals=serve_config.cache_proposals,
            cache_dir=serve_config.cache_dir,
        )

    # -- lookup --------------------------------------------------------

    def lookup(self, request, trace_id: Optional[str] = None):
        """``CacheHit`` / ``CheckpointHit`` / ``None`` (miss)."""
        key = keys.request_key(request)
        with self._lock:
            entry = self._results.get(key)
            if entry is None and self._files is not None:
                entry = self._files.get(key)
                if entry is not None and self._valid_file_entry(request, entry):
                    self._results.put(key, entry)
                else:
                    entry = None
            if entry is not None:
                result = self._serve(request, entry)
                if result is not None:
                    self._counts["exact"] += 1
                    self._observe("exact", request, trace_id)
                    return CacheHit("exact", result)
            if self.proposals:
                hit = self._certify_locked(request)
                if hit is not None:
                    self._counts["certified"] += 1
                    self._observe("certified", request, trace_id)
                    return hit
            hit = self._checkpoint_locked(request)
            if hit is not None:
                self._counts["checkpoint"] += 1
                self._observe("checkpoint", request, trace_id)
                return hit
            self._counts["misses"] += 1
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_cache_misses_total", service=self.name
            ).inc()
        return None

    @staticmethod
    def _valid_file_entry(request, entry: Dict) -> bool:
        """Shape gate for entries read back off disk: the seal proves
        the bytes, this proves they are a result entry for this kind."""
        return (
            isinstance(entry, dict)
            and entry.get("kind") == request.kind
            and isinstance(entry.get("result"), list)
            and isinstance(entry.get("elements"), list)
        )

    def _serve(self, request, entry: Dict):
        """Decode a stored entry into fresh result objects, remapping
        per-read score vectors into the request's read order."""
        elements = keys.read_elements(request)
        stored = entry.get("elements")
        try:
            if request.kind == "priority":
                # chain order is positional seeding: serve only the exact
                # ordered form, a permuted chain list is a different job
                if elements != stored:
                    return None
                return wire.decode_result(request.kind, entry["result"])
            perm = keys.match_permutation(elements, stored or [])
            if perm is None:
                return None
            obj = entry["result"]
            if perm != list(range(len(perm))):
                fields = _SCORE_FIELDS.get(request.kind, ())
                remapped = []
                for item in obj:
                    stored_sides = item.get("is_consensus1")
                    item = dict(item)
                    for field in fields:
                        old = item.get(field)
                        if old is not None:
                            item[field] = [old[j] for j in perm]
                    if request.kind == "dual":
                        _remap_sides(item, stored_sides, perm)
                    remapped.append(item)
                obj = remapped
            return wire.decode_result(request.kind, obj)
        except (wire.WireError, KeyError, IndexError, ValueError, TypeError):
            return None  # a malformed entry is a miss, never an answer

    def _certify_locked(self, request):
        if request.kind != "single" or request.offsets is not None:
            return None
        for _key, entry in reversed(self._results.items()):
            if not proposal.eligible(request, entry):
                continue
            stored = [bytes.fromhex(h) for h in entry.get("reads", ())]
            if keys.multiset_extras(request.reads, stored) is None:
                continue
            # one certification attempt against the freshest eligible
            # subset entry; a failed certify degrades to a full search
            # rather than scanning further (bounded lookup cost)
            try:
                served = proposal.certify(request, entry)
                error = None
            except Exception as exc:  # noqa: BLE001 - fail closed: search
                served, error = None, repr(exc)
            if served is None:
                self._counts["certify_failed"] += 1
                events.record(
                    "cache_certify_failed", service=self.name,
                    job_kind=request.kind, error=error,
                )
                return None
            obj = wire.encode_result("single", served)
            return CacheHit(
                "certified", wire.decode_result("single", obj)
            )
        return None

    def _checkpoint_locked(self, request):
        if request.kind != "single" or request.offsets is not None:
            return None
        fp = keys.config_fingerprint(request.config)
        for digest, entry in reversed(self._checkpoints.items()):
            if entry.get("config_fp") != fp:
                continue
            stored = [bytes.fromhex(h) for h in entry.get("reads", ())]
            extras = keys.multiset_extras(request.reads, stored)
            if extras is None:
                continue
            self._checkpoints.touch(digest)
            return CheckpointHit(entry["checkpoint"], len(extras))
        return None

    # -- deposits ------------------------------------------------------

    def deposit_result(self, request, wire_result: List[Dict]) -> None:
        """Store a finished job's wire-encoded result under its
        canonical key (and in the file store when configured)."""
        key = keys.request_key(request)
        entry = {
            "kind": request.kind,
            "result": wire_result,
            "elements": keys.read_elements(request),
        }
        if request.kind != "priority":
            entry["reads"] = [bytes(r).hex() for r in request.reads]
            entry["offsets"] = (
                list(request.offsets) if request.offsets is not None else None
            )
        if request.kind == "single":
            config = request.config or CdwfaConfig()
            entry["config_fp"] = keys.config_fingerprint(request.config)
            entry["truncated"] = len(wire_result) >= config.max_return_size
        with self._lock:
            self._results.put(key, entry)
            self._counts["deposits"] += 1
            if self._files is not None:
                self._files.put(key, entry)
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_cache_deposits_total", service=self.name
            ).inc()

    def deposit_checkpoint(self, request, wire_ckpt: Dict) -> None:
        """Store a finished job's last bound-free mid-search checkpoint
        keyed by its read-multiset digest, for superset resume.  Only
        unseeded ``single`` jobs with a live, incumbent-free frontier
        qualify (see :func:`resumable_wire`)."""
        if request.kind != "single" or request.offsets is not None:
            return
        if not resumable_wire(wire_ckpt):
            return
        digest = keys.reads_digest(request.reads)
        entry = {
            "checkpoint": wire_ckpt,
            "reads": [bytes(r).hex() for r in request.reads],
            "config_fp": keys.config_fingerprint(request.config),
        }
        with self._lock:
            self._checkpoints.put(digest, entry)
            self._counts["ckpt_deposits"] += 1

    # -- accounting ----------------------------------------------------

    def _observe(self, tier: str, request, trace_id: Optional[str]) -> None:
        events.record(
            "cache_hit", service=self.name, tier=tier, job_kind=request.kind,
        )
        obs_flight.record(
            "cache_hit", trace_id=trace_id, tier=tier,
            job_kind=request.kind, service=self.name,
        )
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_cache_hits_total", service=self.name, tier=tier,
            ).inc()

    def stats(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
            counts["results"] = len(self._results)
            counts["checkpoints"] = len(self._checkpoints)
            counts["quarantined"] = (
                self._files.quarantined if self._files is not None else 0
            )
        return counts
