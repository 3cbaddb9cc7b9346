"""Canonical request hashing for the consensus cache.

The port of ``waffle_con_tpu``'s ``serve/cache/keys.py``; for the same
request its keys are the JAX package's, digit for digit.  Two requests
map to the same key exactly when a consensus engine would return the
same answer for both (modulo per-read score order):

* the **read multiset** — reads are order-insensitive for the engines'
  tie-set semantics, but multiplicity matters (duplicate reads double
  votes), so the key digests the sorted multiset of ``(read, offset)``
  pairs.  Priority chains keep their within-chain order (seeding is
  positional) while the chain multiset itself is order-insensitive.
* the **scoring config fingerprint** — every :class:`CdwfaConfig`
  field that shapes the search result (cost model, queue/nomination
  bounds, wildcard, offset policy, …).  Placement and performance
  fields (``backend``, ``device``, ``mesh_shards``, supervisor/retry
  knobs, band seeds, speculation widths) are deliberately EXCLUDED: they
  decide where and how fast a job runs, never what it returns, and
  admission rewrites some of them (mesh placement) after the client
  built the request.

The digests are hex sha256 over canonical JSON (sorted keys, no
whitespace) — stable across processes and safe as file names for the
optional on-disk store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.serve.procs.wire import encode_config

#: CdwfaConfig fields that never change a search's *result* — only its
#: placement, speed, or supervision.  Everything not listed here is
#: scoring-relevant and participates in the key (fail-closed: a new
#: config field changes keys until someone proves it placement-only).
#: The JAX package's set plus the port's ``device``.
PLACEMENT_ONLY_FIELDS = frozenset({
    "backend", "device", "mesh_shards", "initial_band", "prefetch_width",
    "frontier_width", "supervised", "backend_chain",
    "dispatch_timeout_s", "dispatch_retries", "retry_backoff_s",
    "retry_jitter", "breaker_threshold", "repromote_after",
    "dispatch_budget", "watchdog_strict", "log_search_summary",
})


def scoring_config_fields(config) -> Dict:
    """The scoring-relevant slice of a config as plain JSON types
    (``None`` config means engine defaults, fingerprinted as such)."""
    if config is None:
        config = CdwfaConfig()
    encoded = encode_config(config)
    return {k: v for k, v in encoded.items()
            if k not in PLACEMENT_ONLY_FIELDS}


def config_fingerprint(config) -> str:
    """Hex digest of the scoring-relevant config slice."""
    return _digest({"config": scoring_config_fields(config)})


def read_elements(request) -> List:
    """The request's read multiset as sortable JSON elements.

    ``single``/``dual``: ``[read_hex, offset]`` pairs (offset ``None``
    when unseeded).  ``priority``: each chain is a list of read hexes
    in chain order (within-chain order is positional seeding and must
    NOT be canonicalized away)."""
    if request.kind == "priority":
        return [[bytes(s).hex() for s in chain] for chain in request.reads]
    offsets = request.offsets or (None,) * len(request.reads)
    return [[bytes(r).hex(), o] for r, o in zip(request.reads, offsets)]


def request_key(request) -> str:
    """The canonical content-addressed key for one job request:
    order-insensitive read multiset + kind + scoring config."""
    return _digest({
        "kind": request.kind,
        "reads": sorted(read_elements(request), key=_sort_token),
        "config": scoring_config_fields(request.config),
    })


def reads_digest(reads: Sequence[bytes],
                 offsets: Optional[Sequence[Optional[int]]] = None) -> str:
    """Order-insensitive digest of a plain read multiset (the
    checkpoint store's subset-overlap key; ``single`` kind only)."""
    offs = offsets or (None,) * len(reads)
    elements = [[bytes(r).hex(), o] for r, o in zip(reads, offs)]
    return _digest({"reads": sorted(elements, key=_sort_token)})


def read_multiset(reads: Sequence[bytes]) -> Counter:
    """Multiset of raw read bytes (offset-free; used for the
    subset/superset overlap tests, which are gated to unseeded jobs)."""
    return Counter(bytes(r) for r in reads)


def multiset_extras(superset_reads: Sequence[bytes],
                    subset_reads: Sequence[bytes],
                    ) -> Optional[Tuple[bytes, ...]]:
    """The reads in ``superset_reads`` left after removing one copy of
    each read in ``subset_reads`` (kept in superset order), or ``None``
    when ``subset_reads`` is not a sub-multiset."""
    need = read_multiset(subset_reads)
    extras: List[bytes] = []
    for read in superset_reads:
        read = bytes(read)
        if need.get(read, 0) > 0:
            need[read] -= 1
        else:
            extras.append(read)
    if any(v > 0 for v in need.values()):
        return None
    return tuple(extras)


def match_permutation(request_elements: List,
                      stored_elements: List) -> Optional[List[int]]:
    """``perm[i] = j`` assigning each request read position ``i`` a
    distinct stored position ``j`` with an equal ``(read, offset)``
    value, or ``None`` when the multisets differ.  Equal-valued reads
    have equal per-read scores (the scorer is a deterministic function
    of ``(read, consensus, offset)``), so any consistent assignment
    remaps a cached result's score vectors correctly."""
    slots: Dict[str, List[int]] = {}
    for j, element in enumerate(stored_elements):
        slots.setdefault(_sort_token(element), []).append(j)
    perm: List[int] = []
    for element in request_elements:
        bucket = slots.get(_sort_token(element))
        if not bucket:
            return None
        perm.append(bucket.pop())
    if any(bucket for bucket in slots.values()):
        return None
    return perm


def _sort_token(element) -> str:
    return json.dumps(element, sort_keys=True, separators=(",", ":"))


def _digest(obj: Dict) -> str:
    blob = json.dumps(
        obj, sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


# sanity: the placement-only list must stay a subset of the real config
# fields, so a renamed field cannot silently start leaking into keys
def _check_fields() -> None:
    names = {f.name for f in dataclasses.fields(CdwfaConfig)}
    unknown = PLACEMENT_ONLY_FIELDS - names
    if unknown:
        raise RuntimeError(
            f"PLACEMENT_ONLY_FIELDS names unknown config fields: "
            f"{sorted(unknown)}"
        )


_check_fields()
