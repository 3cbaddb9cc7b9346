"""The port's placement and perf database (``serve/placement.py``,
``obs/perfdb.py``) against the JAX package's.

* The policy: ``tests/test_placement.py``'s cases on the port's
  :class:`PlacementPolicy`, and its ``classify``, ``effective_shards`` and
  ``place`` decisions held to JAX's policy on the same requests and device
  counts (JAX places ``"jax"`` jobs, the port ``"torch"`` jobs).
* The served mesh job: a large job through a port service pinned to two
  CPU shards equals JAX ``"python"`` and the port's unsharded run, and is
  counted; the serving pool refuses a sharded store.
* Learned placement: ``tests/test_mixed_width.py``'s six cases with
  ``learned=True`` and a perf database in a temporary directory, the port's
  decisions held to JAX's on the same file (the JAX side's knobs set with
  ``monkeypatch.setenv``).
* The perf database and evidence lines: ``tests/test_evidence_schema.py``'s
  cases on the port's module, and files written by each package read by
  the other.

No JAX ``"jax"`` search runs here: the JAX references are ``"python"``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from waffle_con_tpu import CdwfaConfigBuilder as JBuilder
from waffle_con_tpu.obs import perfdb as jperfdb
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import placement as jplacement
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.obs import perfdb
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops.sharded_scorer import ShardedScorer
from waffle_con_tpu_torch.parallel import DeviceSet
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.serve import (
    ConsensusService,
    JobRequest,
    PlacementPolicy,
    ServeConfig,
)
from waffle_con_tpu_torch.serve import placement
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils.example_gen import generate_test

pytestmark = pytest.mark.serve

WAIT_S = 120
CPU2 = DeviceSet("t", ("cpu", "cpu"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    ragged.reset_arena()
    placement.reset_profile_cache()
    jplacement.reset_profile_cache()
    yield
    ragged.reset_arena()
    placement.reset_profile_cache()
    jplacement.reset_profile_cache()


def _cfg(backend="torch", **kw):
    b = CdwfaConfigBuilder().backend(backend)
    if backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _jcfg(backend="jax", **kw):
    b = JBuilder().backend(backend)
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _reads(n_reads, seq_len=100):
    _, reads = generate_test(4, seq_len, n_reads, 0.01, seed=n_reads)
    return tuple(reads)


def _request(n_reads, config, seq_len=100):
    return JobRequest(kind="single", reads=_reads(n_reads, seq_len),
                      config=config)


def _key(res):
    return [(c.sequence, list(c.scores)) for c in res]


# ----------------------------------------------------------- classifier


def test_classify_threshold_boundary():
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=2)
    cfg = _cfg(min_count=2)
    assert policy.classify(_request(15, cfg)) == "arena"
    assert policy.classify(_request(16, cfg)) == "mesh"


def test_policy_validation():
    with pytest.raises(ValueError, match="large_read_threshold"):
        PlacementPolicy(large_read_threshold=0)
    with pytest.raises(ValueError, match="mesh_shards"):
        PlacementPolicy(mesh_shards=1)
    # learning needs a database file: the port has no default one
    with pytest.raises(ValueError, match="perfdb_path"):
        PlacementPolicy(learned=True)


def test_effective_shards_clamps_and_pow2_floors():
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=8)
    assert policy.effective_shards(100, 8) == 8
    assert policy.effective_shards(100, 6) == 4
    assert policy.effective_shards(100, 3) == 2
    assert policy.effective_shards(3, 8) == 2
    assert policy.effective_shards(100, 1) == 1
    assert policy.effective_shards(0, 8) == 0


# -------------------------------------------------------- place() paths


def test_place_declines_small_python_and_explicit():
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=2)
    tcfg = _cfg(min_count=2)
    assert policy.place(_request(8, tcfg), 8) is None
    # mesh_shards is a feature of the torch store: other backends stay
    for backend in ("python", "native"):
        other = _cfg(backend, min_count=2)
        assert policy.place(_request(24, other), 8) is None
    assert policy.place(_request(24, None), 8) is None
    pinned = dataclasses.replace(tcfg, mesh_shards=4)
    assert policy.place(_request(24, pinned), 8) is None
    assert policy.place(_request(24, tcfg), 1) is None


def test_place_promotes_without_mutating_original():
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=4)
    cfg = _cfg(min_count=2)
    request = _request(24, cfg)
    placed = policy.place(request, 8)
    assert placed is not None
    assert placed.config.mesh_shards == 4
    assert placed.reads == request.reads
    assert request.config.mesh_shards == 0
    assert cfg.mesh_shards == 0


def test_place_clamps_to_device_pool():
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=8)
    placed = policy.place(_request(24, _cfg(min_count=2)), 2)
    assert placed is not None
    assert placed.config.mesh_shards == 2


#: (threshold, shards asked, reads, devices): both sides of the threshold,
#: pools under, at and over the ask, non-powers of two, a job smaller
#: than the ask
DECISIONS = [
    (16, 2, 15, 8), (16, 2, 16, 8), (16, 8, 100, 6), (16, 8, 100, 3),
    (16, 8, 3, 8), (4, 8, 3, 8), (16, 4, 24, 1), (16, 4, 24, 0),
    (64, 2, 256, 4), (256, 2, 256, 2), (256, 2, 64, 2), (1, 16, 32, 32),
]


@pytest.mark.parametrize("threshold,asked,n_reads,devices", DECISIONS)
def test_decisions_equal_jax(threshold, asked, n_reads, devices):
    reads = _reads(n_reads)
    port = PlacementPolicy(large_read_threshold=threshold, mesh_shards=asked)
    jax = jplacement.PlacementPolicy(large_read_threshold=threshold,
                                     mesh_shards=asked)
    preq = JobRequest(kind="single", reads=reads, config=_cfg(min_count=2))
    jreq = JJobRequest(kind="single", reads=reads,
                       config=_jcfg(min_count=2))
    assert port.classify(preq) == jax.classify(jreq)
    assert (port.effective_shards(n_reads, devices)
            == jax.effective_shards(n_reads, devices))
    p, j = port.place(preq, devices), jax.place(jreq, devices)
    assert (p is None) == (j is None)
    if p is not None:
        assert p.config.mesh_shards == j.config.mesh_shards
        assert p.reads == j.reads


# --------------------------------------------------- service integration


@pytest.fixture(scope="module")
def mesh_jobs():
    """The large and the small job of ``tests/test_placement.py``'s served
    case, on the port (``"torch"`` on the CPU) and as JAX ``"python"``
    references."""
    large, small = _reads(16), _reads(6, seq_len=80)
    pcfg = _cfg(min_count=2, initial_band=12)
    jcfg = _jcfg("python", min_count=2, initial_band=12)
    want = [_key(jservice._build_engine(JJobRequest(
        kind="single", reads=r, config=jcfg)).consensus())
        for r in (large, small)]
    return [JobRequest(kind="single", reads=r, config=pcfg)
            for r in (large, small)], want


def test_served_mesh_job_equals_jax_python_and_unsharded(mesh_jobs):
    requests, want = mesh_jobs
    unsharded = [_key(_build_engine(r).consensus()) for r in requests]
    events.clear_events()
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=2)
    with ConsensusService(
        ServeConfig(workers=2, batch_window_s=0.002, placement=policy),
        device_set=CPU2,
    ) as svc:
        handles = svc.submit_all(requests)
        got = [_key(h.result(timeout=WAIT_S)) for h in handles]
        stats = svc.stats()
    assert unsharded == want
    assert got == want
    jobs = stats["jobs"]
    assert jobs["mesh_placed"] == 1 and jobs["done"] == 2
    assert jobs["placement_errors"] == 0 and jobs["failed"] == 0
    placed = events.get_events("job_placed_mesh")
    assert [(e["reads"], e["shards"]) for e in placed] == [(16, 2)]
    sharded = events.get_events("scorer_sharded")
    assert sharded and sharded[-1]["devices"] == ["cpu", "cpu"]
    assert stats["ragged"]["pages_used"] == 0


def test_placement_errors_are_counted_not_silent(mesh_jobs, monkeypatch):
    requests, want = mesh_jobs
    policy = PlacementPolicy(large_read_threshold=16, mesh_shards=2)

    def broken(self, request, available):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(PlacementPolicy, "place", broken)
    events.clear_events()
    with ConsensusService(
        ServeConfig(workers=1, batch_window_s=0.0, placement=policy),
        device_set=CPU2,
    ) as svc:
        got = _key(svc.submit(requests[1]).result(timeout=WAIT_S))
        jobs = svc.stats()["jobs"]
    assert got == want[1]
    assert jobs["placement_errors"] == 1 and jobs["mesh_placed"] == 0
    (ev,) = events.get_events("placement_failed")
    assert "probe failed" in ev["error"]


def test_pool_refuses_a_sharded_store():
    reads = _reads(16)
    store = ShardedScorer(reads, _cfg(min_count=2), ("cpu", "cpu"))
    arena = ragged.BandArena(ragged.ArenaConfig())
    vals = {"consensus": b"", "max_steps": 8}
    assert arena.why_not(store, vals) == "sharded"
    assert arena.why_not(store.shards[0], vals) is None


def test_supervisor_builds_backends_under_the_jobs_device_set():
    """A placed job's supervisor builds every later backend under the
    device set pinned where it was built, whichever thread asks (a routed
    call's demotion or re-promotion runs on the dispatcher thread, which
    has no pin of its own)."""
    import threading

    from waffle_con_tpu_torch.parallel import use_device_set
    from waffle_con_tpu_torch.runtime.supervisor import BackendSupervisor

    cfg = dataclasses.replace(_cfg(min_count=2, supervised=True),
                              mesh_shards=2)
    with use_device_set(CPU2):
        sup = BackendSupervisor(list(_reads(16)), cfg)
    assert isinstance(sup._scorer, ShardedScorer)
    built = []
    thread = threading.Thread(
        target=lambda: built.append(sup._new_backend("torch")))
    thread.start()
    thread.join(WAIT_S)
    (store,) = built
    assert isinstance(store, ShardedScorer)
    assert [str(d) for d in store.devices] == ["cpu", "cpu"]


# -------------------------------------------------- learned placement


@pytest.fixture
def learned(monkeypatch, tmp_path):
    """The database file in a temporary directory: the port's learned
    policy names it, the JAX side gets it through its own knobs."""
    path = str(tmp_path / "perfdb.jsonl")
    monkeypatch.setenv("WAFFLE_PERFDB", path)
    monkeypatch.setenv("WAFFLE_PLACEMENT_LEARNED", "1")
    return path


def _both(path, threshold=64):
    return (PlacementPolicy(large_read_threshold=threshold, learned=True,
                            perfdb_path=path),
            jplacement.PlacementPolicy(large_read_threshold=threshold))


def _classify(port, jax, n_reads):
    """The port's decision on ``n_reads`` reads, held to JAX's."""
    reads = tuple(b"ACGTACGT" for _ in range(n_reads))
    got = port.classify(JobRequest(kind="single", reads=reads,
                                   config=_cfg()))
    assert got == jax.classify(JJobRequest(kind="single", reads=reads,
                                           config=_jcfg()))
    return got


def test_learned_placement_cold_falls_back_to_threshold(learned):
    port, jax = _both(learned)
    assert _classify(port, jax, 100) == "mesh"
    assert _classify(port, jax, 10) == "arena"


def test_learned_placement_warm_overrides_threshold(learned):
    port, jax = _both(learned)
    for _ in range(placement.MIN_PROFILE_SAMPLES):
        placement.record_outcome("mesh", 100, 2.0, path=learned)
        placement.record_outcome("arena", 100, 0.5, path=learned)
    assert _classify(port, jax, 100) == "arena"
    assert _classify(port, jax, 10) == "arena"
    # the JAX package's writes count the same: the stamp change re-reads
    for _ in range(2 * placement.MIN_PROFILE_SAMPLES):
        jplacement.record_outcome("mesh", 100, 0.1)
    assert _classify(port, jax, 100) == "mesh"


def test_learned_placement_one_sided_history_is_cold(learned):
    port, jax = _both(learned)
    for _ in range(5 * placement.MIN_PROFILE_SAMPLES):
        placement.record_outcome("arena", 100, 0.1, path=learned)
    assert _classify(port, jax, 100) == "mesh"


def test_learned_placement_disabled_ignores_history(learned, monkeypatch):
    for _ in range(placement.MIN_PROFILE_SAMPLES):
        placement.record_outcome("mesh", 100, 2.0, path=learned)
        placement.record_outcome("arena", 100, 0.5, path=learned)
    monkeypatch.setenv("WAFFLE_PLACEMENT_LEARNED", "0")
    port = PlacementPolicy(large_read_threshold=64, perfdb_path=learned)
    jax = jplacement.PlacementPolicy(large_read_threshold=64)
    assert _classify(port, jax, 100) == "mesh"


def test_learned_placement_prefers_phase_profile_seconds(learned):
    port, jax = _both(learned)
    for _ in range(placement.MIN_PROFILE_SAMPLES):
        placement.record_outcome(
            "mesh", 100, 9.0,
            phases={"host_prep": 0.05, "device_compute": 0.1,
                    "transfer": 0.05},
            path=learned,
        )
        placement.record_outcome("arena", 100, 0.5, path=learned)
    assert _classify(port, jax, 100) == "mesh"


def test_service_records_placement_profiles(learned):
    """With a learned policy every done job appends one placement_profile
    record with its substrate and reads bucket; the JAX package reads
    them as its own."""
    requests = [_request(n, _cfg(min_count=2), seq_len=80) for n in (4, 6, 9)]
    policy = PlacementPolicy(large_read_threshold=64, learned=True,
                             perfdb_path=learned)
    with ConsensusService(ServeConfig(workers=2, batch_window_s=0.02,
                                      placement=policy)) as svc:
        for h in svc.submit_all(requests):
            h.result(timeout=WAIT_S)
    records = perfdb.load_records(learned, kind=perfdb.PLACEMENT_KIND)
    assert records == jperfdb.load_records(learned,
                                           kind=jperfdb.PLACEMENT_KIND)
    assert len(records) == len(requests)
    for rec, req in zip(sorted(records, key=lambda r: r["n_reads"]),
                        requests):
        assert rec["substrate"] == "arena"
        assert rec["n_reads"] == len(req.reads)
        assert rec["reads_bucket"] == perfdb.reads_bucket(len(req.reads))
        assert rec["value"] > 0


# --------------------------------------------------- evidence validation


def _microbench_line(**overrides):
    line = {
        "metric": "hotloop_steps_per_s",
        "value": 1048.1,
        "unit": "steps/s",
        "mode": "microbench",
        "parity": True,
        "steps": 9983,
        "stop_code": 2,
        "breakdown": {"run_cols": 4},
        "schema": perfdb.EVIDENCE_SCHEMA,
    }
    line.update(overrides)
    return line


def test_evidence_tables_equal_jax():
    assert perfdb.SCHEMA == jperfdb.SCHEMA
    assert perfdb.EVIDENCE_SCHEMA == jperfdb.EVIDENCE_SCHEMA
    assert perfdb.PLACEMENT_KIND == jperfdb.PLACEMENT_KIND
    assert perfdb.EVIDENCE_REQUIRED == jperfdb.EVIDENCE_REQUIRED
    assert perfdb.EVIDENCE_MODE_FIELDS == jperfdb.EVIDENCE_MODE_FIELDS


def test_load_evidence_accepts_current_schema():
    out = perfdb.load_evidence(json.dumps(_microbench_line()))
    assert out["value"] == 1048.1


def test_load_evidence_missing_required_field():
    bad = _microbench_line()
    del bad["unit"]
    with pytest.raises(ValueError, match="unit"):
        perfdb.load_evidence(bad)


def test_load_evidence_missing_mode_field():
    bad = _microbench_line()
    del bad["stop_code"]
    with pytest.raises(ValueError, match="stop_code"):
        perfdb.load_evidence(bad)


def test_load_evidence_rejects_newer_major():
    with pytest.raises(ValueError, match="newer"):
        perfdb.load_evidence(_microbench_line(schema=99))


def test_load_evidence_rejects_nonsense_major():
    with pytest.raises(ValueError, match="nonsense"):
        perfdb.load_evidence(_microbench_line(schema=0))


def test_load_evidence_missing_schema_is_legacy_major_one():
    legacy = {"metric": "x", "value": 1}
    assert perfdb.load_evidence(json.dumps(legacy))["metric"] == "x"


def test_load_evidence_rejects_non_object():
    with pytest.raises(ValueError):
        perfdb.load_evidence("[1, 2]")


def test_stamp_evidence_sets_schema():
    out = perfdb.stamp_evidence({"metric": "m"})
    assert out["schema"] == perfdb.EVIDENCE_SCHEMA
    assert jperfdb.load_evidence(json.dumps(_microbench_line())) == \
        perfdb.load_evidence(json.dumps(_microbench_line()))


def test_every_mode_contract_includes_required_fields_disjointly():
    for mode, fields in perfdb.EVIDENCE_MODE_FIELDS.items():
        overlap = set(fields) & set(perfdb.EVIDENCE_REQUIRED)
        assert not overlap, (mode, overlap)


# --------------------------------------------------------- perfdb jsonl


def test_perfdb_round_trip(tmp_path):
    db = tmp_path / "perf.jsonl"
    rec = perfdb.make_record(
        "microbench", "hotloop_steps_per_s", 1048.1, "steps/s",
        platform="cpu", run_cols=4,
    )
    assert rec["schema"] == perfdb.SCHEMA
    assert rec["unix_time"] > 0 and rec["host"]
    path = perfdb.append_record(rec, str(db))
    assert path == str(db)
    loaded = perfdb.load_records(str(db))
    assert len(loaded) == 1
    assert loaded[0]["value"] == 1048.1
    assert loaded[0]["run_cols"] == 4


def test_perfdb_append_refuses_wrong_schema(tmp_path):
    with pytest.raises(ValueError, match="refusing"):
        perfdb.append_record({"schema": 99, "value": 1},
                             str(tmp_path / "x.jsonl"))


def test_perfdb_load_skips_torn_and_future_lines(tmp_path):
    db = tmp_path / "perf.jsonl"
    good = perfdb.make_record("microbench", "m", 10.0, "steps/s")
    with open(db, "w") as fh:
        fh.write(json.dumps(good) + "\n")
        fh.write('{"schema": 1, "kind": "microbench", "val')  # torn
        fh.write("\n")
        fh.write(json.dumps({**good, "schema": perfdb.SCHEMA + 1,
                             "value": 999.0}) + "\n")
        fh.write("[1,2,3]\n")  # not an object
        fh.write(json.dumps({**good, "value": 20.0}) + "\n")
    loaded = perfdb.load_records(str(db))
    assert [r["value"] for r in loaded] == [10.0, 20.0]
    assert loaded == jperfdb.load_records(str(db))


def test_perfdb_load_missing_file_is_empty(tmp_path):
    assert perfdb.load_records(str(tmp_path / "nope.jsonl")) == []


def test_perfdb_kind_filter(tmp_path):
    db = str(tmp_path / "perf.jsonl")
    perfdb.append_record(
        perfdb.make_record("microbench", "m", 1.0, "u"), db)
    perfdb.append_record(
        perfdb.make_record("serve", "s", 2.0, "u"), db)
    assert [r["kind"] for r in perfdb.load_records(db, kind="serve")] \
        == ["serve"]


def test_perfdb_has_no_default_path(tmp_path):
    """The JAX package's default file under ``evidence/`` has no port
    counterpart: a write or read without a path raises."""
    rec = perfdb.make_record("microbench", "m", 1.0, "u")
    for path in (None, ""):
        with pytest.raises(ValueError, match="path"):
            perfdb.append_record(rec, path)
        with pytest.raises(ValueError, match="path"):
            perfdb.load_records(path)
        with pytest.raises(ValueError, match="path"):
            placement.record_outcome("mesh", 100, 1.0, path=path)
    assert not hasattr(perfdb, "default_path")


def test_rolling_baseline_median_math():
    recs = [{"value": v, "metric": "m"} for v in (10, 30, 20)]
    assert perfdb.rolling_baseline(recs) == 20
    recs.append({"value": 40, "metric": "m"})
    assert perfdb.rolling_baseline(recs) == 25
    assert perfdb.rolling_baseline(recs, window=2) == 30
    recs.append({"value": "bogus", "metric": "m"})
    recs.append({"value": 1000, "metric": "other"})
    assert perfdb.rolling_baseline(recs, metric="m") == 25
    assert perfdb.rolling_baseline([], metric="m") is None


def test_files_written_by_each_package_read_by_the_other(tmp_path):
    """A port file read by the JAX package and a JAX file read by the
    port: the same records, buckets, decision seconds and medians."""
    port_db, jax_db = str(tmp_path / "port.jsonl"), str(tmp_path / "j.jsonl")
    rng = np.random.default_rng(0)
    for i in range(12):
        n = int(rng.integers(1, 600))
        wall = float(rng.uniform(0.01, 5.0))
        phases = ({"host_prep": 0.01 * i, "device_compute": 0.02,
                   "transfer": 0.005} if i % 3 == 0 else None)
        sub = ("mesh", "arena")[i % 2]
        placement.record_outcome(sub, n, wall, phases=phases, path=port_db)
        jplacement.record_outcome(sub, n, wall, phases=phases, path=jax_db)
    for a, b in ((port_db, jax_db), (jax_db, port_db)):
        mine = perfdb.load_records(a, kind=perfdb.PLACEMENT_KIND)
        theirs = jperfdb.load_records(a, kind=jperfdb.PLACEMENT_KIND)
        assert mine == theirs and len(mine) == 12
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k != "unix_time"}
        assert ([strip(r) for r in mine]
                == [strip(r) for r in perfdb.load_records(b)])
        for rec in mine:
            assert (perfdb.decision_seconds(rec)
                    == jperfdb.decision_seconds(rec))
        for bucket in sorted({r["reads_bucket"] for r in mine}):
            assert (perfdb.substrate_medians(mine, bucket)
                    == jperfdb.substrate_medians(mine, bucket))
    for n in (0, 1, 2, 3, 64, 65, 255, 256, 257, 4096):
        assert perfdb.reads_bucket(n) == jperfdb.reads_bucket(n)
    assert os.path.getsize(port_db) > 0
