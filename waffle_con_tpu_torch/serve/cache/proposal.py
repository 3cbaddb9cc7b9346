"""Propose-then-verify: certify a cached near-miss consensus.

The port of ``waffle_con_tpu``'s ``serve/cache/proposal.py``.  A cached
entry for read multiset ``R0`` holds the *complete* tied set of optimal
consensuses at cost ``c0``.  For a new request over a superset
``R = R0 + extras``, every candidate ``s`` satisfies

    total_R(s) = total_R0(s) + total_extras(s) >= total_R0(s) >= c0

so the optimal cost for ``R`` is at least ``c0``.  If any cached
consensus ``t`` achieves ``total_R(t) == c0`` under one exact scoring
pass (every extra read at edit distance 0 against ``t``), then ``c0``
IS the optimum for ``R``, and any optimal ``s`` for ``R`` must have
``total_R0(s) == c0`` — i.e. ``s`` belongs to the cached tied set.
The served answer ``{t in cached : total_R(t) == c0}`` is therefore
the complete tied set for ``R``.  Anything short of equality degrades
to a full search (mirroring the ``checkpoint_rejected`` path), so a
wrong proposal can cost time but never parity.

The completeness premise leans on the cached set being untruncated
(``len(results) < max_return_size``) and on search reachability under
the nomination gates (``min_count``/``min_af``) — the latter is not
proven here, which is why certification is narrowly gated, defaults to
refusing anything unusual, and can be switched off outright with
``ServeConfig.cache_proposals=False``.

**The exact scorer.**  The JAX package scores with its ``PythonScorer``.
The port scores through its own scorer seam
(:func:`~waffle_con_tpu_torch.ops.scorer.construct_backend`) with the
request's ``backend`` and ``device`` and every other placement-only
field at its default (so a placed job is not certified on a sharded
store): on ``"python"`` this is exactly the JAX package's pass, on
``"torch"`` one root, one branch step a symbol and one finalize on the
device.  Every backend's per-read edit distances equal the oracle's, so
the served set is the same.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.models.consensus import Consensus
from waffle_con_tpu_torch.ops.scorer import construct_backend
from waffle_con_tpu_torch.serve.cache import keys

#: placement-only fields the certify pass takes from the request
_KEPT = frozenset({"backend", "device"})


def eligible(request, entry: Dict) -> bool:
    """Cheap gates before the (expensive) scoring pass: unseeded
    ``single`` jobs, identical scoring config, no early termination,
    and an untruncated cached tied set."""
    if request.kind != "single" or entry.get("kind") != "single":
        return False
    if request.offsets is not None or entry.get("offsets") is not None:
        return False
    if entry.get("truncated"):
        return False
    config = request.config
    if config is not None and config.allow_early_termination:
        return False
    if entry.get("config_fp") != keys.config_fingerprint(config):
        return False
    if not entry.get("result"):
        return False
    return True


def certify_config(config: Optional[CdwfaConfig]) -> CdwfaConfig:
    """The config of the certify pass's scorer: the request's, with
    every placement-only field but ``backend`` and ``device`` at its
    default (no shards, no supervisor, the default band seed)."""
    config = config if config is not None else CdwfaConfig()
    defaults = CdwfaConfig()
    return dataclasses.replace(config, **{
        name: getattr(defaults, name)
        for name in keys.PLACEMENT_ONLY_FIELDS - _KEPT
    })


def certify(request, entry: Dict) -> Optional[List]:
    """Score every cached candidate against the request's full read
    set in one exact pass; return the complete tied set if one candidate
    holds the cached optimal cost, else ``None``.

    Caller must have checked :func:`eligible`."""
    stored_reads = [bytes.fromhex(h) for h in entry.get("reads", ())]
    extras = keys.multiset_extras(request.reads, stored_reads)
    if extras is None:
        return None

    config = certify_config(request.config)
    cost = config.consensus_cost

    cached = entry["result"]
    totals0 = {sum(item["scores"]) for item in cached}
    if len(totals0) != 1:  # a tied set with unequal totals is corrupt
        return None
    c0 = totals0.pop()

    candidates = sorted(
        base64.b64decode(item["sequence"]) for item in cached
    )
    reads = [bytes(r) for r in request.reads]
    scorer = construct_backend(reads, config, config.backend)
    active = np.ones(len(reads), dtype=bool)
    served: List = []
    for seq in candidates:
        handle = scorer.root(active)
        for i in range(len(seq)):
            scorer.push(handle, seq[: i + 1])
        eds = scorer.finalized_eds(handle, seq)
        scorer.free(handle)
        scores = [cost.apply(int(e)) for e in eds]
        if sum(scores) == c0:
            served.append(Consensus(seq, cost, scores))
    if not served:
        return None
    return served
