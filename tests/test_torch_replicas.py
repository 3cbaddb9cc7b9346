"""The port's replicated front door (``serve/replicas.py``) against the
JAX package's.

``tests/test_replicas.py``'s cases on the port: two in-process replicas
behind :class:`ReplicatedService` on the ``"python"`` backend with
``devices=("cpu", "cpu")`` return what serial runs return (and what JAX
``"python"`` returns) while the door spreads jobs by least outstanding
work; ``backend_demoted`` / ``slow_search`` triggers drain or shed exactly
the replica their trace id names; a drained replica re-admits at zero
outstanding work; the door writes ``base.stats_file`` with a per-replica
table.  Then one ``"torch"`` case on the CPU where a replica places a
large job on its two CPU shards, and the default ``devices`` on a host
without CUDA.
"""

import json

import pytest
import torch

from waffle_con_tpu import CdwfaConfigBuilder as JBuilder
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu.utils.example_gen import generate_test as jgenerate_test
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.parallel import mesh as tmesh
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.serve import (
    JobRequest,
    PlacementPolicy,
    ReplicatedConfig,
    ReplicatedService,
    ServeConfig,
)
from waffle_con_tpu_torch.serve import replicas as serve_replicas
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils.example_gen import generate_test

pytestmark = pytest.mark.serve

WAIT_S = 120
CPU2 = ("cpu", "cpu")


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


def _cfg(backend="python", **kw):
    b = CdwfaConfigBuilder().backend(backend)
    if backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _requests(n, seq_len=160, reads=6):
    cfg = _cfg(min_count=2)
    out = []
    for seed in range(n):
        _, r = generate_test(4, seq_len, reads, 0.02, seed=seed)
        out.append(JobRequest(kind="single", reads=tuple(r), config=cfg))
    return out


def _key(res):
    return [(c.sequence, list(c.scores)) for c in res]


def _door(replicas=2, devices=CPU2, base=None, **cfg_kw):
    return ReplicatedService(ReplicatedConfig(
        replicas=replicas, devices=devices,
        base=base or ServeConfig(workers=2, batch_window_s=0.002),
        **cfg_kw,
    ))


@pytest.fixture(scope="module")
def jax_six():
    """``_requests(6)``'s reads served by JAX ``"python"`` serially."""
    jcfg = JBuilder().backend("python").min_count(2).build()
    out = []
    for seed in range(6):
        _, r = jgenerate_test(4, 160, 6, 0.02, seed=seed)
        out.append(_key(jservice._build_engine(JJobRequest(
            kind="single", reads=tuple(r), config=jcfg)).consensus()))
    return out


# ------------------------------------------------------ parity + routing


def test_replicated_results_byte_identical_to_serial(jax_six):
    requests = _requests(6)
    expected = [_key(_build_engine(r).consensus()) for r in requests]
    with _door(replicas=2) as door:
        handles = door.submit_all(requests)
        results = [_key(h.result(timeout=WAIT_S)) for h in handles]
        stats = door.stats()
    assert expected == jax_six
    assert results == expected
    assert stats["jobs"]["done"] == 6
    assert stats["jobs"].get("failed", 0) == 0


def test_least_outstanding_routing_uses_both_replicas():
    requests = _requests(6)
    with _door(replicas=2) as door:
        handles = door.submit_all(requests)
        for h in handles:
            h.result(timeout=WAIT_S)
        reps = door.replica_stats()
    routed = {r["replica"]: r["routed"] for r in reps}
    assert sum(routed.values()) == 6
    assert all(v >= 1 for v in routed.values()), routed
    assert [r["devices"] for r in reps] == [["cpu"], ["cpu"]]


def test_replica_names_and_trace_prefix():
    with _door(replicas=2) as door:
        handle = door.submit(_requests(1)[0])
        handle.result(timeout=WAIT_S)
        names = [r["replica"] for r in door.replica_stats()]
    assert names == ["consensus:r0", "consensus:r1"]
    assert any(
        handle.trace.trace_id.startswith(name + "/") for name in names
    ), handle.trace.trace_id


# ---------------------------------------------------- health transitions


def test_backend_demotion_drains_attributed_replica(monkeypatch):
    events.clear_events()
    with _door(replicas=2) as door:
        r0 = door._replicas[0]
        # pin outstanding work so the drain cannot re-admit mid-test
        monkeypatch.setattr(r0.service, "outstanding", lambda: 1)
        obs_flight.trigger(
            "backend_demoted", trace_id=f"{r0.name}/job-999",
            from_backend="torch",
        )
        reps = {r["replica"]: r for r in door.replica_stats()}
        assert reps[r0.name]["state"] == serve_replicas.DRAINING
        assert reps[r0.name]["demotions"] == 1
        assert reps["consensus:r1"]["state"] == serve_replicas.UP

        handles = door.submit_all(_requests(3))
        for h in handles:
            h.result(timeout=WAIT_S)
        reps = {r["replica"]: r for r in door.replica_stats()}
        assert reps[r0.name]["routed"] == 0
        assert reps["consensus:r1"]["routed"] == 3
    (ev,) = events.get_events("replica_draining")
    assert ev["replica"] == r0.name


def test_drained_replica_readmits_at_zero_outstanding():
    events.clear_events()
    with _door(replicas=2) as door:
        r0 = door._replicas[0]
        obs_flight.trigger(
            "backend_demoted", trace_id=f"{r0.name}/job-998",
            from_backend="torch",
        )
        assert door.replica_stats()[0]["state"] == serve_replicas.DRAINING
        # outstanding work is already 0: the next routing decision
        # re-admits before placing the job
        door.submit(_requests(1)[0]).result(timeout=WAIT_S)
        rep = door.replica_stats()[0]
        assert rep["state"] == serve_replicas.UP
        assert rep["readmits"] == 1
    assert [e["replica"] for e in events.get_events("replica_readmitted")] \
        == [r0.name]


def test_slow_search_sheds_until_cooldown(monkeypatch):
    with _door(replicas=2, shed_cooldown_s=120.0) as door:
        r0 = door._replicas[0]
        obs_flight.trigger(
            "slow_search", trace_id=f"{r0.name}/job-997", p95_s=9.9,
        )
        assert door.replica_stats()[0]["state"] == serve_replicas.SHEDDING
        # shedding deprioritizes: the job lands on the healthy replica
        # though r0 has equal outstanding work and a lower index
        door.submit(_requests(1)[0]).result(timeout=WAIT_S)
        reps = {r["replica"]: r for r in door.replica_stats()}
        assert reps[r0.name]["routed"] == 0
        assert reps[r0.name]["sheds"] == 1
        assert reps["consensus:r1"]["routed"] == 1
        # an expired cooldown restores the replica at the next decision
        monkeypatch.setattr(r0, "shed_until", 0.0)
        door.submit(_requests(1)[0]).result(timeout=WAIT_S)
        assert door.replica_stats()[0]["state"] == serve_replicas.UP


def test_all_unhealthy_falls_back_to_least_outstanding(monkeypatch):
    with _door(replicas=2) as door:
        for i, rep in enumerate(door._replicas):
            monkeypatch.setattr(rep.service, "outstanding", lambda: 0)
            obs_flight.trigger(
                "backend_demoted", trace_id=f"{rep.name}/job-{990 + i}",
                from_backend="torch",
            )
            rep.state = serve_replicas.DRAINING
            monkeypatch.setattr(rep.service, "outstanding", lambda: 1)
        # every replica unhealthy: degraded routing still serves
        handle = door.submit(_requests(1)[0])
        assert handle.result(timeout=WAIT_S) is not None


def test_foreign_triggers_are_ignored():
    with _door(replicas=2) as door:
        obs_flight.trigger(
            "backend_demoted", trace_id="someone-else/job-1",
            from_backend="torch",
        )
        obs_flight.trigger("pool_exhausted",
                           trace_id="consensus:r0/job-996")
        obs_flight.trigger("backend_demoted", trace_id=None)
        states = [r["state"] for r in door.replica_stats()]
    assert states == [serve_replicas.UP, serve_replicas.UP]


def test_close_detaches_listener():
    door = _door(replicas=2)
    r0_name = door._replicas[0].name
    door.close()
    # triggers after close must not touch the closed door's state
    obs_flight.trigger(
        "backend_demoted", trace_id=f"{r0_name}/job-995",
        from_backend="torch",
    )
    assert door._replicas[0].state == serve_replicas.UP


# ------------------------------------------------- flight trigger stream


def test_trigger_listeners_receive_and_survive_errors():
    calls = []

    def listener(reason, trace_id, detail):
        calls.append((reason, trace_id, dict(detail)))

    def broken(reason, trace_id, detail):
        raise RuntimeError("listener bug")

    obs_flight.add_trigger_listener(broken)
    obs_flight.add_trigger_listener(listener)
    obs_flight.add_trigger_listener(listener)  # once per callable
    try:
        obs_flight.trigger("unit_test_reason", trace_id="t/1", k=1)
        # the recorder dedupes a repeated (reason, trace) but the
        # listeners see every firing
        obs_flight.trigger("unit_test_reason", trace_id="t/1", k=2)
    finally:
        obs_flight.remove_trigger_listener(listener)
        obs_flight.remove_trigger_listener(broken)
    assert calls == [
        ("unit_test_reason", "t/1", {"k": 1}),
        ("unit_test_reason", "t/1", {"k": 2}),
    ]
    obs_flight.trigger("unit_test_reason", trace_id="t/2")
    assert len(calls) == 2  # removed listeners stay silent


# ---------------------------------------------------------- stats payload


def test_front_door_publishes_replica_table(tmp_path):
    stats_file = tmp_path / "stats.json"
    base = ServeConfig(workers=2, batch_window_s=0.002,
                       stats_file=str(stats_file))
    with _door(replicas=2, base=base) as door:
        for h in door.submit_all(_requests(2)):
            h.result(timeout=WAIT_S)
        members = [r.service.config.stats_file for r in door._replicas]
    assert members == [None, None]  # the door writes the file alone
    payload = json.loads(stats_file.read_text())
    assert payload["service"] == "consensus"
    table = payload["replicas"]
    assert [r["replica"] for r in table] == [
        "consensus:r0", "consensus:r1",
    ]
    for rep in table:
        assert rep["state"] == serve_replicas.UP
        assert "outstanding" in rep and "routed" in rep


# ------------------------------------------ placement inside a replica


def test_torch_replica_places_a_job_on_two_cpu_shards():
    """Two replicas over four CPU devices (two each): a 16-read job is
    placed on its replica's two shards, a 6-read job stays on a pool, and
    both equal JAX ``"python"``."""
    shapes = ((16, 100), (6, 80))
    jcfg = JBuilder().backend("python").min_count(2).initial_band(12).build()
    want, requests = [], []
    for n, length in shapes:
        _, r = generate_test(4, length, n, 0.01, seed=n)
        want.append(_key(jservice._build_engine(JJobRequest(
            kind="single", reads=tuple(r), config=jcfg)).consensus()))
        requests.append(JobRequest(kind="single", reads=tuple(r),
                                   config=_cfg("torch", min_count=2,
                                               initial_band=12)))
    events.clear_events()
    base = ServeConfig(workers=2, batch_window_s=0.002,
                       placement=PlacementPolicy(16, 2))
    with _door(replicas=2, devices=("cpu",) * 4, base=base) as door:
        handles = door.submit_all(requests)
        got = [_key(h.result(timeout=WAIT_S)) for h in handles]
        stats = door.stats()
        pools = [r.arena.stats() for r in door._replicas]
    assert got == want
    assert stats["jobs"]["mesh_placed"] == 1
    assert stats["jobs"]["placement_errors"] == 0
    assert [r["routed"] for r in stats["replicas"]] == [1, 1]
    assert [r["devices"] for r in stats["replicas"]] == [["cpu", "cpu"]] * 2
    (placed,) = events.get_events("job_placed_mesh")
    assert placed["service"] == "consensus:r0" and placed["shards"] == 2
    for pool in pools:
        assert pool["admits"] == pool["releases"]
        assert pool["pages_used"] == 0


def test_default_devices_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmesh.reset_probe_cache()
    try:
        with pytest.raises(ValueError, match="no CUDA device"):
            ReplicatedService(ReplicatedConfig(), autostart=False)
    finally:
        tmesh.reset_probe_cache()
    with pytest.raises(ValueError, match="empty"):
        ReplicatedConfig(devices=())
