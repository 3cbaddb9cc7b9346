"""The port's consensus cache (``waffle_con_tpu_torch/serve/cache``)
against the JAX package's.

* The cases of ``tests/test_consensus_cache.py``: the canonical key's
  properties (read-order invariance, multiplicity, scoring and
  placement-only fields, kind, offsets, priority chains), the stores
  (LRU bound, hash-sealed files and quarantine), the bound-free
  checkpoint gate, and the service: exact hits served ``CACHED`` without
  a worker, near-miss proposals certified ``CERTIFIED`` or degraded to a
  search, checkpoint supersets resumed, the file store across service
  restarts, the cache off by default.  The JAX package's knobs are
  ``ServeConfig`` fields here, and the checkpoint tier's snapshot is
  pinned (a ``CheckpointController(snapshot_at_pops=...)`` run,
  deposited through ``deposit_checkpoint``), so no case depends on
  timing.
* Across the packages: ``request_key``, ``config_fingerprint`` and
  ``reads_digest`` equal JAX's for every kind, seeded and unseeded;
  ``certify`` on one entry serves JAX's set on the port's ``"python"``
  and ``"torch"`` (CPU); a cache directory written by either package is
  served by the other; every served result equals JAX's serial
  ``"python"`` result and the port's own serial result.
* The service's cache tests once more with the lock checker on: no
  lock-order inversion, and nothing the cache's lock leads to leads back
  to it.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from waffle_con_tpu import CdwfaConfigBuilder as JBuilder
from waffle_con_tpu.config import CdwfaConfig as JConfig
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu.serve.cache import ConsensusCache as JConsensusCache
from waffle_con_tpu.serve.cache import keys as jkeys
from waffle_con_tpu.serve.cache import proposal as jproposal
from waffle_con_tpu.serve.procs import wire as jwire
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.serve import (
    ConsensusService,
    JobRequest,
    JobStatus,
    ServeConfig,
)
from waffle_con_tpu_torch.serve.cache import (
    ConsensusCache,
    keys,
    proposal,
    resumable_wire,
)
from waffle_con_tpu_torch.serve.cache.store import FileStore, ResultStore
from waffle_con_tpu_torch.serve.procs import wire
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

pytestmark = pytest.mark.serve

WAIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_arena():
    ragged.reset_arena()
    yield
    ragged.reset_arena()


def _cfg(backend="torch", **kw):
    b = CdwfaConfigBuilder().backend(backend)
    if backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _jcfg(backend="python", **kw):
    b = JBuilder().backend(backend)
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _reads(n=6, seq_len=120, error=0.02, seed=11):
    return tuple(generate_test(4, seq_len, n, error, seed=seed)[1])


def _req(reads, config=None, kind="single", **kw):
    return JobRequest(kind=kind, reads=reads, config=config, **kw)


def _serial(request):
    return _build_engine(request).consensus()


def _jax_serial(reads, kind="single", **cfg):
    """JAX's serial ``"python"`` result of the same job, in the port's
    wire form (the two packages' result types differ)."""
    jreq = JJobRequest(kind=kind, reads=reads, config=_jcfg(**cfg))
    return jwire.encode_result(kind, jservice._build_engine(jreq).consensus())


def _wire(kind, result):
    return wire.encode_result(kind, result)


def _svc(**kw):
    return ConsensusService(ServeConfig(workers=2, cache=True, **kw))


# ------------------------------------------------- canonical hash


def test_key_invariant_under_read_permutation():
    reads = _reads()
    cfg = _cfg(min_count=2)
    permuted = reads[::-1]
    assert permuted != reads
    assert keys.request_key(_req(reads, cfg)) == \
        keys.request_key(_req(permuted, cfg))


def test_key_sensitive_to_duplicate_multiplicity():
    reads = _reads()
    cfg = _cfg(min_count=2)
    doubled = reads + (reads[0],)
    assert keys.request_key(_req(reads, cfg)) != \
        keys.request_key(_req(doubled, cfg))


def test_key_sensitive_to_scoring_fields():
    reads = _reads()
    base = keys.request_key(_req(reads, _cfg(min_count=2)))
    assert base != keys.request_key(_req(reads, _cfg(min_count=3)))
    assert base != keys.request_key(
        _req(reads, _cfg(min_count=2, wildcard=ord("*")))
    )


def test_key_insensitive_to_placement_fields():
    reads = _reads()
    base = keys.request_key(_req(reads, _cfg(min_count=2)))
    placed = _cfg(min_count=2, mesh_shards=2, initial_band=9)
    assert keys.request_key(_req(reads, placed)) == base
    # the port's own placement field: the card or the CPU, one key
    on_card = dataclasses.replace(_cfg(min_count=2), device="cuda")
    assert keys.request_key(_req(reads, on_card)) == base
    assert keys.request_key(_req(reads, _cfg("python", min_count=2))) == base


def test_key_sensitive_to_kind_and_offsets():
    reads = _reads()
    cfg = _cfg(min_count=2)
    base = keys.request_key(_req(reads, cfg))
    assert base != keys.request_key(_req(reads, cfg, kind="dual"))
    seeded = _req(reads, cfg, offsets=(None,) * (len(reads) - 1) + (3,))
    assert base != keys.request_key(seeded)


def test_priority_chains_keep_within_chain_order():
    cfg = _cfg(min_count=2)
    c1, c2 = (b"\x00\x01", b"\x02\x03"), (b"\x01\x02", b"\x03\x00")
    key = keys.request_key(_req((c1, c2), cfg, kind="priority"))
    # chain multiset is order-insensitive ...
    assert key == keys.request_key(_req((c2, c1), cfg, kind="priority"))
    # ... but within-chain order is positional seeding: never collapsed
    flipped = (tuple(reversed(c1)), c2)
    assert key != keys.request_key(_req(flipped, cfg, kind="priority"))


def test_multiset_extras_and_match_permutation():
    reads = _reads()
    extra = b"\x00\x01\x02\x03"
    extras = keys.multiset_extras(reads + (extra,), reads)
    assert extras == (extra,)
    assert keys.multiset_extras(reads[:-1], reads) is None
    # duplicate copies count: one copy is not a superset of two
    assert keys.multiset_extras(reads, reads + (reads[0],)) is None

    stored = keys.read_elements(_req(reads, None))
    wanted = keys.read_elements(_req(reads[::-1], None))
    perm = keys.match_permutation(wanted, stored)
    assert perm is not None
    assert [stored[j] for j in perm] == wanted
    assert keys.match_permutation(
        keys.read_elements(_req(reads + (extra,), None)), stored
    ) is None


# ------------------------------------------------- keys across packages


def _key_cases():
    reads = _reads(n=7, seq_len=130, seed=5)
    chains = tuple((r[:40], r) for r in reads[:4])
    offsets = (None, 3, None, 0, 12, None, 7)
    return {
        "single": ("single", reads, None),
        "single_seeded": ("single", reads, offsets),
        "dual": ("dual", reads, None),
        "dual_seeded": ("dual", reads, offsets),
        "priority": ("priority", chains, None),
    }


_CONFIGS = {
    "defaults": None,
    "min_count": dict(min_count=2),
    "scoring": dict(min_count=3, wildcard=ord("*"), max_queue_size=40,
                    weighted_by_ed=True, offset_window=30,
                    dual_max_ed_delta=5, allow_early_termination=True),
    "placement": dict(min_count=2, initial_band=20, prefetch_width=3,
                      frontier_width=2, dispatch_retries=5),
}


def _both_configs(name):
    kw = _CONFIGS[name]
    if kw is None:
        return None, None
    return _cfg(**kw), _jcfg(**kw)


@pytest.mark.parametrize("config", sorted(_CONFIGS))
@pytest.mark.parametrize("case", sorted(_key_cases()))
def test_keys_equal_the_jax_packages(case, config):
    kind, reads, offsets = _key_cases()[case]
    pcfg, jcfg = _both_configs(config)
    preq = JobRequest(kind=kind, reads=reads, config=pcfg, offsets=offsets)
    jreq = JJobRequest(kind=kind, reads=reads, config=jcfg, offsets=offsets)
    assert keys.read_elements(preq) == jkeys.read_elements(jreq)
    assert keys.request_key(preq) == jkeys.request_key(jreq)
    assert keys.config_fingerprint(pcfg) == jkeys.config_fingerprint(jcfg)
    assert keys.scoring_config_fields(pcfg) == \
        jkeys.scoring_config_fields(jcfg)
    if kind != "priority":
        assert keys.reads_digest(reads) == jkeys.reads_digest(reads)
        assert keys.reads_digest(reads, offsets) == \
            jkeys.reads_digest(reads, offsets)


def test_placement_only_fields_are_the_jax_set_plus_device():
    assert keys.PLACEMENT_ONLY_FIELDS == \
        jkeys.PLACEMENT_ONLY_FIELDS | {"device"}
    # the default scoring slices are equal field for field
    assert keys.scoring_config_fields(CdwfaConfig()) == \
        jkeys.scoring_config_fields(JConfig())


# ------------------------------------------------- stores


def test_result_store_is_bounded_lru():
    store = ResultStore(2)
    store.put("a", 1)
    store.put("b", 2)
    assert store.get("a") == 1  # refreshes "a"
    store.put("c", 3)  # evicts "b", the least recently used
    assert store.get("b") is None
    assert store.get("a") == 1 and store.get("c") == 3
    assert len(store) == 2


def test_file_store_round_trip_and_quarantine(tmp_path):
    store = FileStore(str(tmp_path))
    store.put("k1", {"kind": "single", "result": [1, 2]})
    assert store.get("k1") == {"kind": "single", "result": [1, 2]}
    # reopening reads the manifest back
    assert FileStore(str(tmp_path)).get("k1") is not None

    # corrupt the sealed bytes: the digest mismatch quarantines the
    # entry — it is never served again, from this or a fresh store
    victim = next(
        p for p in tmp_path.iterdir()
        if p.is_file() and p.name != "MANIFEST.json"
    )
    victim.write_bytes(victim.read_bytes() + b" ")
    assert store.get("k1") is None
    assert store.quarantined == 1
    assert (tmp_path / "_quarantine").exists()
    assert FileStore(str(tmp_path)).get("k1") is None


# ------------------------------------------------- checkpoint gate


def _fake_wire_ckpt(entries=1, maximum_error=None, results=()):
    return {
        "version": 1, "kind": "single",
        "body": {"state": {
            "entries": [{"n": i} for i in range(entries)],
            "maximum_error": maximum_error,
            "results": list(results),
        }},
    }


def test_resumable_wire_accepts_only_bound_free_frontiers():
    assert resumable_wire(_fake_wire_ckpt())
    # an incumbent bound would prune the superset's optimum with
    # subset-only costs: never resumable
    assert not resumable_wire(_fake_wire_ckpt(maximum_error=7))
    assert not resumable_wire(_fake_wire_ckpt(results=[{"c": 1}]))
    assert not resumable_wire(_fake_wire_ckpt(entries=0))
    assert not resumable_wire({"body": {}})
    assert not resumable_wire(None)


def test_deposit_checkpoint_rejects_bounded_snapshots():
    cache = ConsensusCache("t")
    req = _req(_reads(), _cfg(min_count=2))
    cache.deposit_checkpoint(req, _fake_wire_ckpt(maximum_error=3))
    assert cache.stats()["ckpt_deposits"] == 0
    cache.deposit_checkpoint(req, _fake_wire_ckpt())
    assert cache.stats()["ckpt_deposits"] == 1


# ------------------------------------------------- service integration


def _pinned_snapshot(request, at=5):
    """A bound-free snapshot of ``request``'s serial search taken at poll
    ``at`` (the search runs on to its end), as a wire dict."""
    snaps = []
    ctrl = ckpt_mod.CheckpointController(snapshot_at_pops={at},
                                         on_snapshot=snaps.append)
    with ckpt_mod.installed(ctrl):
        _serial(request)
    assert len(snaps) == 1
    wire_ckpt = snaps[0].to_wire()
    assert resumable_wire(wire_ckpt)
    return wire_ckpt


def _ckpt_reads():
    """Eight reads of one truth and an extra read of it at 5 %."""
    truth, reads = generate_test(4, 160, 8, 0.03, seed=21)
    return tuple(reads), corrupt(truth, 0.05, np.random.default_rng(22))


def test_exact_duplicate_served_cached_and_dispatch_free():
    reads = _reads()
    cfg = _cfg(min_count=2)
    dup = _req(reads[::-1], cfg)
    want = _serial(dup)
    with _svc() as svc:
        first = svc.submit(_req(reads, cfg))
        first.result(timeout=WAIT_S)
        second = svc.submit(dup)
        got = second.result(timeout=WAIT_S)
        stats = svc.stats()
    assert second.status is JobStatus.CACHED
    assert second.started_at is None  # never dispatched
    assert got == want  # scores remapped to the submitted read order
    assert _wire("single", got) == _jax_serial(reads[::-1], min_count=2)
    assert stats["cache"]["exact"] == 1
    assert stats["jobs"]["cached"] == 1
    assert svc.outstanding() == 0


def test_superset_with_cached_consensus_certifies():
    reads = _reads()
    cfg = _cfg(min_count=2)
    with _svc() as svc:
        first = svc.submit(_req(reads, cfg))
        base = first.result(timeout=WAIT_S)
        superset = _req(reads + (base[0].sequence,), cfg)
        want = _serial(superset)
        handle = svc.submit(superset)
        got = handle.result(timeout=WAIT_S)
        stats = svc.stats()
    assert handle.status is JobStatus.CERTIFIED
    assert handle.started_at is None
    assert got == want
    assert _wire("single", got) == _jax_serial(superset.reads, min_count=2)
    assert stats["cache"]["certified"] == 1
    assert stats["jobs"]["certified"] == 1


def test_certify_failure_degrades_to_full_search():
    reads = _reads()
    cfg = _cfg(min_count=2)
    noisy = generate_test(4, 120, 1, 0.3, seed=99)[1][0]
    events.clear_events()
    with _svc() as svc:
        svc.submit(_req(reads, cfg)).result(timeout=WAIT_S)
        superset = _req(reads + (noisy,), cfg)
        want = _serial(superset)
        handle = svc.submit(superset)
        got = handle.result(timeout=WAIT_S)
        stats = svc.stats()
    # the noisy extra raises the optimal cost past the cached bound:
    # the proposal fails certification and the job runs a real search
    assert handle.status is JobStatus.DONE
    assert got == want
    assert _wire("single", got) == _jax_serial(superset.reads, min_count=2)
    assert stats["cache"]["certify_failed"] >= 1
    assert events.get_events("cache_certify_failed")


def test_checkpoint_superset_resumes_with_parity():
    reads, extra = _ckpt_reads()
    cfg = _cfg(min_count=2)
    subset = _req(reads, cfg)
    snapshot = _pinned_snapshot(subset)
    events.clear_events()
    with _svc(cache_proposals=False) as svc:  # isolate the tier
        svc.submit(subset).result(timeout=WAIT_S)
        svc._cache.deposit_checkpoint(subset, snapshot)
        assert svc.stats()["cache"]["ckpt_deposits"] == 1
        superset = _req(reads + (extra,), cfg)
        want = _serial(superset)
        handle = svc.submit(superset)
        got = handle.result(timeout=WAIT_S)
        stats = svc.stats()
    assert handle.status is JobStatus.DONE
    assert got == want  # bound-free resume is byte-identical
    assert _wire("single", got) == _jax_serial(superset.reads, min_count=2)
    assert stats["cache"]["checkpoint"] == 1
    assert stats["checkpoints"]["resumed"] == 1
    resumed = events.get_events("job_resumed")
    assert [e["extra_reads"] for e in resumed] == [1]


def test_resumed_jobs_never_deposit():
    reads, extra = _ckpt_reads()
    cfg = _cfg(min_count=2)
    subset = _req(reads, cfg)
    snapshot = _pinned_snapshot(subset)
    # snapshots every poll: the resumed job has bound-free candidates of
    # its own, and must still deposit none of them
    with _svc(cache_proposals=False, checkpoint_interval_s=0.0001) as svc:
        svc.submit(subset).result(timeout=WAIT_S)
        svc._cache.deposit_checkpoint(subset, snapshot)
        before = svc.stats()["cache"]
        handle = svc.submit(_req(reads + (extra,), cfg))
        handle.result(timeout=WAIT_S)
        stats = svc.stats()
    # a resumed search did not cover the space from scratch: its
    # result and checkpoints stay out of the cache (fail-closed)
    assert stats["cache"]["checkpoint"] == 1
    assert stats["checkpoints"]["resumed"] == 1
    assert stats["checkpoints"]["snapshots"] > 0
    assert stats["cache"]["deposits"] == before["deposits"] == 1
    assert stats["cache"]["ckpt_deposits"] == before["ckpt_deposits"]
    assert stats["cache"]["results"] == 1


def test_file_store_serves_across_service_restarts(tmp_path):
    reads = _reads()
    cfg = _cfg(min_count=2)
    with _svc(cache_dir=str(tmp_path)) as svc:
        want = svc.submit(_req(reads, cfg)).result(timeout=WAIT_S)
    with _svc(cache_dir=str(tmp_path)) as svc:
        handle = svc.submit(_req(reads[::-1], cfg))
        got = handle.result(timeout=WAIT_S)
        assert handle.status is JobStatus.CACHED
        assert svc.stats()["cache"]["exact"] == 1
    assert [c.sequence for c in got] == [c.sequence for c in want]
    assert got == _serial(_req(reads[::-1], cfg))


def test_cache_off_by_default():
    reads = _reads()
    with ConsensusService(ServeConfig(workers=1)) as svc:
        h = svc.submit(_req(reads, _cfg(min_count=2)))
        h.result(timeout=WAIT_S)
        h2 = svc.submit(_req(reads, _cfg(min_count=2)))
        h2.result(timeout=WAIT_S)
        stats = svc.stats()
    assert "cache" not in stats
    assert h2.status is JobStatus.DONE


# ------------------------------------------------- beyond the JAX cases


def test_quarantined_entry_is_searched_and_fires_an_incident(tmp_path):
    reads = _reads()
    cfg = _cfg(min_count=2)
    with _svc(cache_dir=str(tmp_path)) as svc:
        want = svc.submit(_req(reads, cfg)).result(timeout=WAIT_S)
    victim = next(p for p in tmp_path.iterdir()
                  if p.suffix == ".json" and p.name != "MANIFEST.json")
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    victim.write_bytes(bytes(blob))
    obs_flight.reset()
    with _svc(cache_dir=str(tmp_path)) as svc:
        handle = svc.submit(_req(reads[::-1], cfg))
        got = handle.result(timeout=WAIT_S)
        stats = svc.stats()
    assert handle.status is JobStatus.DONE
    assert got == _serial(_req(reads[::-1], cfg))
    assert [c.sequence for c in got] == [c.sequence for c in want]
    assert stats["cache"]["quarantined"] == 1
    assert (tmp_path / "_quarantine" / victim.name).exists()
    assert "cache_quarantine" in [i["reason"] for i in obs_flight.incidents()]


def test_priority_served_only_in_chain_order():
    cfg = _cfg(min_count=2)
    reads = _reads(n=6, seq_len=100, seed=3)
    chains = tuple((r[:50], r) for r in reads)
    with _svc() as svc:
        want = svc.submit(_req(chains, cfg, kind="priority")).result(
            timeout=WAIT_S)
        same = svc.submit(_req(chains, cfg, kind="priority"))
        got = same.result(timeout=WAIT_S)
        permuted = svc.submit(_req(chains[::-1], cfg, kind="priority"))
        permuted.result(timeout=WAIT_S)
    assert same.status is JobStatus.CACHED and got == want
    # the same chain multiset in another order has the same key but is a
    # different seeding: a miss, searched
    assert permuted.status is JobStatus.DONE


def test_dual_duplicate_scores_remapped():
    reads = (b"ACGTACGT", b"ACTTACGT", b"ACGTACGT", b"ACTTACGT", b"ACGTACGA")
    cfg = _cfg(min_count=1)
    permuted = (reads[3], reads[0], reads[4], reads[1], reads[2])
    with _svc() as svc:
        svc.submit(_req(reads, cfg, kind="dual")).result(timeout=WAIT_S)
        handle = svc.submit(_req(permuted, cfg, kind="dual"))
        got = handle.result(timeout=WAIT_S)
    assert handle.status is JobStatus.CACHED
    assert got == _serial(_req(permuted, cfg, kind="dual"))
    assert _wire("dual", got) == _jax_serial(permuted, kind="dual",
                                             min_count=1)


def _jax_entry(reads, **cfg):
    """The JAX cache's stored entry for a finished subset job."""
    jreq = JJobRequest(kind="single", reads=reads, config=_jcfg(**cfg))
    jcache = JConsensusCache("jax")
    jcache.deposit_result(jreq, jwire.encode_result(
        "single", jservice._build_engine(jreq).consensus()))
    return jcache._results.items()[-1][1]


@pytest.mark.parametrize("backend", ["python", "torch"])
@pytest.mark.parametrize("case", ["certified", "failed"])
def test_certify_serves_the_jax_packages_set(backend, case):
    reads = _reads(n=7, seq_len=140, seed=13)
    entry = _jax_entry(reads, min_count=2)
    if case == "certified":
        extra = wire.decode_result("single", entry["result"])[0].sequence
    else:
        extra = generate_test(4, 140, 1, 0.3, seed=98)[1][0]
    sup = reads + (extra,)
    preq = _req(sup, _cfg(backend, min_count=2))
    jreq = JJobRequest(kind="single", reads=sup,
                       config=_jcfg(min_count=2))
    assert proposal.eligible(preq, entry) == jproposal.eligible(jreq, entry)
    assert proposal.eligible(preq, entry)
    got = proposal.certify(preq, entry)
    want = jproposal.certify(jreq, entry)
    if case == "failed":
        assert got is None and want is None
        return
    assert _wire("single", got) == jwire.encode_result("single", want)
    assert _wire("single", got) == _wire("single", _serial(preq))


def test_certify_pass_scores_on_the_request_backend_unsharded():
    cfg = _cfg(min_count=2, mesh_shards=2, initial_band=30,
               supervised=True, frontier_width=3)
    got = proposal.certify_config(cfg)
    assert (got.backend, got.device) == ("torch", "cpu")
    defaults = CdwfaConfig()
    for name in keys.PLACEMENT_ONLY_FIELDS - {"backend", "device"}:
        assert getattr(got, name) == getattr(defaults, name), name
    assert keys.config_fingerprint(got) == keys.config_fingerprint(cfg)
    assert proposal.certify_config(None) == CdwfaConfig()


def test_jax_written_cache_dir_served_by_the_port(tmp_path):
    reads = _reads(n=7, seq_len=130, seed=17)
    jreq = JJobRequest(kind="single", reads=reads,
                       config=_jcfg(min_count=2))
    jres = jservice._build_engine(jreq).consensus()
    JConsensusCache("jax", cache_dir=str(tmp_path)).deposit_result(
        jreq, jwire.encode_result("single", jres))
    dup = _req(reads[::-1], _cfg(min_count=2))
    with _svc(cache_dir=str(tmp_path)) as svc:
        handle = svc.submit(dup)
        got = handle.result(timeout=WAIT_S)
    assert handle.status is JobStatus.CACHED
    assert got == _serial(dup)
    assert _wire("single", got) == _jax_serial(reads[::-1], min_count=2)


def test_port_written_cache_dir_served_by_jax(tmp_path):
    reads = _reads(n=7, seq_len=130, seed=19)
    with _svc(cache_dir=str(tmp_path)) as svc:
        svc.submit(_req(reads, _cfg(min_count=2))).result(timeout=WAIT_S)
    jreq = JJobRequest(kind="single", reads=reads[::-1],
                       config=_jcfg(min_count=2))
    hit = JConsensusCache("jax", cache_dir=str(tmp_path)).lookup(jreq)
    assert hit is not None and hit.tier == "exact"
    assert jwire.encode_result("single", hit.result) == \
        jwire.encode_result("single", jservice._build_engine(jreq).consensus())


def test_cache_fields_validated_and_carried_by_replicas():
    for bad in (dict(cache_max_results=0), dict(cache_max_checkpoints=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    from waffle_con_tpu_torch.serve import ReplicatedConfig, ReplicatedService

    cfg = ReplicatedConfig(replicas=2, devices=("cpu", "cpu"),
                           base=ServeConfig(workers=1, cache=True,
                                            cache_max_results=3))
    with ReplicatedService(cfg) as door:
        caches = [rep.service._cache for rep in door._replicas]
    assert all(c is not None for c in caches)
    assert caches[0] is not caches[1]  # one cache a replica
    assert [c._results.max_entries for c in caches] == [3, 3]


def test_cache_metrics_and_stats_file(tmp_path):
    from waffle_con_tpu_torch.obs import metrics as obs_metrics

    reads = _reads()
    cfg = _cfg(min_count=2)
    path = tmp_path / "stats.json"
    obs_metrics.enable_metrics(True)
    try:
        obs_metrics.registry().reset()
        with _svc(stats_file=str(path)) as svc:
            svc.submit(_req(reads, cfg)).result(timeout=WAIT_S)
            time.sleep(0.3)  # past the stats file's 0.25 s throttle
            svc.submit(_req(reads[::-1], cfg)).result(timeout=WAIT_S)
        text = obs_metrics.registry().render_prometheus()
    finally:
        obs_metrics.enable_metrics(False)
    for name in ("waffle_cache_hits_total", "waffle_cache_misses_total",
                 "waffle_cache_deposits_total"):
        assert name in text
    payload = json.loads(path.read_text())
    assert payload["stats"]["cache"]["exact"] == 1
    assert payload["stats"]["jobs"]["cached"] == 1


def test_cache_paths_under_the_lock_checker():
    """Exact, certified, failed-certify and checkpoint tiers in one
    service whose locks are all order-checked: no inversion is raised,
    and no lock acquired under the cache's lock reaches it again."""
    lockcheck.reset()
    lockcheck.enable_lockcheck(True)
    try:
        reads, extra = _ckpt_reads()
        cfg = _cfg(min_count=2)
        subset = _req(reads, cfg)
        snapshot = _pinned_snapshot(subset)
        noisy = corrupt(extra, 0.3, np.random.default_rng(97))
        with _svc() as svc:
            base = svc.submit(subset).result(timeout=WAIT_S)
            svc._cache.deposit_checkpoint(subset, snapshot)
            statuses = []
            for req in (_req(reads[::-1], cfg),
                        _req(reads + (base[0].sequence,), cfg),
                        _req(reads + (noisy,), cfg)):
                h = svc.submit(req)
                assert h.result(timeout=WAIT_S) == _serial(req)
                statuses.append(h.status)
            stats = svc.stats()
        edges = lockcheck.edges()
    finally:
        lockcheck.reset_enabled()
        lockcheck.reset()
    assert statuses == [JobStatus.CACHED, JobStatus.CERTIFIED,
                        JobStatus.DONE]
    assert stats["cache"]["certify_failed"] == 1
    cache_locks = {a for a, _b in edges if a.startswith("serve.cache.")}
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)

    def reaches(src, dst):
        seen, todo = set(), [src]
        while todo:
            node = todo.pop()
            if node == dst:
                return True
            if node not in seen:
                seen.add(node)
                todo.extend(graph.get(node, ()))
        return False

    for lock in cache_locks:
        assert not any(reaches(b, lock) for b in graph.get(lock, ()))
