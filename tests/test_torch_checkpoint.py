"""Search checkpoints of the port (``waffle_con_tpu_torch/models/
checkpoint.py``) against the JAX package's.

The port's ``"torch"`` backend on the CPU (its plain twins) and the JAX
package's ``"jax"`` backend, snapshotted at the same pinned poll, give
checkpoints whose ``state`` and read fields are equal as canonical JSON
(``config`` left out: the packages' configs differ; the priority state's
``merged_counters`` left out: they are each backend's own scorer-call
counters).  A resumed port search equals the uninterrupted one and JAX
``"python"``; a JAX-written checkpoint, its ``config`` re-encoded by the
port's codec, resumes in the port to the same result.  Draws:
``tests/test_checkpoint.py``'s (single, dual, priority) and its
mid-gang draws (``frontier_width(8)``), an extra read joining on resume,
and the rejection cases (version skew, CRC, truncation, wrong kind, a
corrupted read caught by the priority check)."""

import json

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.models import checkpoint as jck
from waffle_con_tpu_torch.models import checkpoint as tck
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ workloads
# tests/test_checkpoint.py's draws


def _single_reads():
    _, reads = generate_test(4, 100, 8, 0.03, seed=52300)
    return list(reads)


def _dual_reads():
    rng = np.random.default_rng(61250)
    truth, reads1 = generate_test(4, 60, 3, 0.04, seed=61251)
    h2 = bytearray(truth)
    for pos in rng.choice(60, size=2, replace=False):
        h2[pos] = (h2[pos] + 1 + int(rng.integers(3))) % 4
    return list(reads1) + [
        corrupt(bytes(h2), 0.04, np.random.default_rng(61252 + i))
        for i in range(3)
    ]


def _chains():
    n = 6
    _, level0 = generate_test(4, 50, n, 0.02, seed=71000)
    t1a, _ = generate_test(4, 80, 1, 0.0, seed=71001)
    t1b = bytearray(t1a)
    t1b[40] = (t1b[40] + 1) % 4
    t1b = bytes(t1b)
    return [
        [level0[i],
         corrupt(t1a if i < n // 2 else t1b, 0.02,
                 np.random.default_rng(71002 + i))]
        for i in range(n)
    ]


def _engine(pkg, kind, backend, **kw):
    b = pkg.CdwfaConfigBuilder().backend(backend).min_count(2)
    if pkg is T:
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    cfg = b.build()
    if kind == "single":
        eng = pkg.ConsensusDWFA(cfg)
        for r in _single_reads():
            eng.add_sequence(r)
    elif kind == "dual":
        eng = pkg.DualConsensusDWFA(cfg)
        for r in _dual_reads():
            eng.add_sequence(r)
    else:
        eng = pkg.PriorityConsensusDWFA(cfg)
        for chain in _chains():
            eng.add_sequence_chain(chain)
    return eng


def _key(res):
    """A result as plain data (sequences, scores, read assignment)."""
    if hasattr(res, "consensuses"):
        return ([[(c.sequence, list(c.scores)) for c in chain]
                 for chain in res.consensuses], list(res.sequence_indices))
    if res and hasattr(res[0], "consensus1"):
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        return [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [(c.sequence, list(c.scores)) for c in res]


def _polls(pkg_ck, make):
    """The uninterrupted search's result and its poll count."""
    ctrl = pkg_ck.CheckpointController()
    with pkg_ck.installed(ctrl):
        res = make().consensus()
    return _key(res), ctrl._polls


def _preempt(pkg_ck, make, at):
    """The checkpoint a search gives when preempted at poll ``at``."""
    ctrl = pkg_ck.CheckpointController(snapshot_at_pops={at}, preempt=True)
    with pytest.raises(pkg_ck.SearchPreempted) as stop:
        with pkg_ck.installed(ctrl):
            make().consensus()
    return stop.value.checkpoint


def _resume(checkpoint, extra_reads=()):
    """The port's full loop: wire dict -> JSON text -> validated
    checkpoint -> primed engine."""
    text = json.dumps(checkpoint.to_wire())
    return tck.resume_engine(tck.SearchCheckpoint.from_json(text),
                             extra_reads=extra_reads)


def _canon(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _comparable(kind, body):
    """The body fields the two packages must agree on."""
    state = dict(body["state"])
    state.pop("merged_counters", None)
    out = {"state": state, "offsets": body["offsets"]}
    if kind == "priority":
        out.update(chains=body["chains"], seed_groups=body["seed_groups"])
    else:
        out["reads"] = body["reads"]
    return out


_CACHE = {}


def _oracle(kind):
    """JAX ``"python"``'s result of a draw (cached per module)."""
    if kind not in _CACHE:
        _CACHE[kind] = _key(_engine(J, kind, "python").consensus())
    return _CACHE[kind]


# ------------------------------------------------- parity with JAX


@pytest.mark.parametrize("kind", ["single", "dual", "priority"])
def test_checkpoint_state_matches_jax_and_resumes(kind):
    """At the same pinned poll the port's checkpoint and JAX ``"jax"``'s
    agree field for field; the port's resumes to the uninterrupted
    result, JAX ``"python"``'s, and so does the JAX-written one."""
    want = _oracle(kind)
    got, polls = _polls(tck, lambda: _engine(T, kind, "torch"))
    assert got == want
    assert polls >= 2
    at = polls // 2
    port = _preempt(tck, lambda: _engine(T, kind, "torch"), at)
    jaxc = _preempt(jck, lambda: _engine(J, kind, "jax"), at)
    assert port.kind == jaxc.kind == kind
    assert _canon(_comparable(kind, port.body)) == _canon(
        _comparable(kind, jaxc.body))
    assert _key(_resume(port).consensus()) == want
    # the JAX-written checkpoint, its config re-encoded by the port's
    # codec and the body re-signed, resumes in the port
    body = json.loads(json.dumps(jaxc.to_wire()["body"]))
    body["config"] = tck.encode_config_dict(
        T.CdwfaConfigBuilder().backend("torch").device("cpu").min_count(2)
        .build())
    moved = tck.SearchCheckpoint(kind, body)
    assert _key(_resume(moved).consensus()) == want


@pytest.mark.parametrize("kind", ["single", "dual", "priority"])
def test_every_snapshot_resumes_to_the_same_result(kind):
    """Snapshots at every poll (``interval_s`` ~0): the first, middle and
    last resume byte-identically; the port's ``"python"`` oracle's too."""
    want = _oracle(kind)
    for backend in ("torch", "python"):
        snaps = []
        ctrl = tck.CheckpointController(interval_s=1e-9,
                                        on_snapshot=snaps.append)
        with tck.installed(ctrl):
            assert _key(_engine(T, kind, backend).consensus()) == want
        assert snaps and ctrl.snapshots == len(snaps)
        for idx in sorted({0, len(snaps) // 2, len(snaps) - 1}):
            assert _key(_resume(snaps[idx]).consensus()) == want, (
                backend, idx, len(snaps))


@pytest.mark.parametrize("kind", ["single", "dual", "priority"])
def test_snapshot_mid_gang_resumes(kind):
    """``frontier_width(8)`` (``tests/test_checkpoint.py``'s mid-gang
    draws): a snapshot taken while gang deposits wait resumes
    byte-identically (deposits are consume-once speculation, never in a
    checkpoint), and its state matches JAX ``"jax"``'s at M=8."""
    want = _oracle(kind)
    make = lambda: _engine(T, kind, "torch", frontier_width=8)  # noqa: E731
    got, polls = _polls(tck, make)
    assert got == want
    port = _preempt(tck, make, polls // 2)
    jaxc = _preempt(jck, lambda: _engine(J, kind, "jax", frontier_width=8),
                    polls // 2)
    assert _canon(_comparable(kind, port.body)) == _canon(
        _comparable(kind, jaxc.body))
    assert _key(_resume(port).consensus()) == want


def test_python_checkpoint_resumes_on_torch():
    """A checkpoint of the port's ``"python"`` oracle, its config moved to
    ``"torch"``, resumes on the branch store to the same result."""
    want = _oracle("dual")
    _got, polls = _polls(tck, lambda: _engine(T, "dual", "python"))
    ck = _preempt(tck, lambda: _engine(T, "dual", "python"), polls // 2)
    body = json.loads(json.dumps(ck.body))
    body["config"]["backend"] = "torch"
    body["config"]["device"] = "cpu"
    eng = _resume(tck.SearchCheckpoint("dual", body))
    assert eng.config.backend == "torch"
    assert _key(eng.consensus()) == want


# ------------------------------------------------- incremental reads


def test_single_extra_read_joins_on_resume():
    """An extra read joins every live branch at offset 0; the resumed
    search scores it (JAX ``"python"`` resumed the same way agrees)."""
    truth, _ = generate_test(4, 100, 8, 0.03, seed=52300)
    late = corrupt(truth, 0.03, np.random.default_rng(999))
    _got, polls = _polls(tck, lambda: _engine(T, "single", "torch"))
    port = _preempt(tck, lambda: _engine(T, "single", "torch"), polls // 2)
    eng = _resume(port, extra_reads=[late])
    assert len(eng.sequences) == 9
    got = _key(eng.consensus())
    assert got and all(len(scores) == 9 for _seq, scores in got)
    body = json.loads(json.dumps(port.body))
    body["config"] = jck.encode_config_dict(
        J.CdwfaConfigBuilder().backend("python").min_count(2).build())
    jeng = jck.resume_engine(jck.SearchCheckpoint("single", body),
                             extra_reads=[late])
    assert _key(jeng.consensus()) == got


def test_dual_extra_reads_pop0_only():
    _got, polls = _polls(tck, lambda: _engine(T, "dual", "torch"))
    late_ck = _preempt(tck, lambda: _engine(T, "dual", "torch"), polls - 1)
    assert int(late_ck.body["state"]["pops"]) > 0
    with pytest.raises(tck.CheckpointRejected, match="pop-0"):
        _resume(late_ck, extra_reads=[b"\x00\x01"])
    pop0 = _preempt(tck, lambda: _engine(T, "dual", "torch"), 0)
    eng = _resume(pop0, extra_reads=[_dual_reads()[0]])
    assert len(eng.sequences) == len(_dual_reads()) + 1
    assert eng.consensus()


def test_priority_rejects_extra_reads():
    ck = _preempt(tck, lambda: _engine(T, "priority", "torch"), 0)
    with pytest.raises(tck.CheckpointRejected, match="extra_reads"):
        _resume(ck, extra_reads=[b"\x00\x01"])


# ------------------------------------------------- rejection paths


def _one_wire_snapshot():
    """A deep copy of a mid-search single checkpoint's wire form."""
    if "wire" not in _CACHE:
        _got, polls = _polls(tck, lambda: _engine(T, "single", "python"))
        ck = _preempt(tck, lambda: _engine(T, "single", "python"),
                      polls // 2)
        _CACHE["wire"] = json.dumps(ck.to_wire())
    return json.loads(_CACHE["wire"])


def test_version_skew_rejected():
    wire = _one_wire_snapshot()
    wire["version"] = tck.CKPT_VERSION + 1
    with pytest.raises(tck.CheckpointRejected, match="version"):
        tck.SearchCheckpoint.from_wire(wire)


def test_tampered_body_fails_crc():
    wire = _one_wire_snapshot()
    wire["body"]["state"]["pops"] = int(wire["body"]["state"]["pops"]) + 1
    with pytest.raises(tck.CheckpointRejected, match="CRC"):
        tck.SearchCheckpoint.from_wire(wire)
    text = json.dumps(_one_wire_snapshot())
    with pytest.raises(tck.CheckpointRejected):
        tck.SearchCheckpoint.from_json(text[: len(text) // 2])


def test_truncated_body_rejected():
    wire = _one_wire_snapshot()
    body = dict(wire["body"])
    del body["state"]
    truncated = tck.SearchCheckpoint("single", body).to_wire()
    with pytest.raises(tck.CheckpointRejected, match="malformed"):
        tck.resume_engine(tck.SearchCheckpoint.from_wire(truncated))


def test_wrong_engine_kind_rejected():
    wire = _one_wire_snapshot()
    with pytest.raises(tck.CheckpointRejected, match="cannot resume"):
        T.DualConsensusDWFA.resume(wire)


def test_corrupted_read_rejected_by_priority_check():
    """A read corrupted behind a valid CRC (re-signed) cannot poison the
    search: the rebuilt nodes' priorities disagree with the stored ones,
    on the python oracle and on the branch store alike."""
    wire = _one_wire_snapshot()
    body = json.loads(json.dumps(wire["body"]))
    read0 = bytes(tck.unb64(body["reads"][0]))
    body["reads"][0] = tck.b64(bytes((b + 1) % 4 for b in read0))
    for backend in ("python", "torch"):
        body["config"]["backend"] = backend
        body["config"]["device"] = "cpu"
        resigned = tck.SearchCheckpoint("single", body).to_wire()
        engine = tck.resume_engine(tck.SearchCheckpoint.from_wire(resigned))
        with pytest.raises(tck.CheckpointRejected, match="priority"):
            engine.consensus()


def test_non_dict_payload_rejected():
    for garbage in (None, 17, "{}", [1, 2], {"version": 1}):
        with pytest.raises(tck.CheckpointRejected):
            tck.SearchCheckpoint.from_wire(garbage)


def test_oversize_snapshot_dropped_and_config_codec_roundtrip():
    snaps = []
    ctrl = tck.CheckpointController(interval_s=1e-9, max_bytes=64,
                                    on_snapshot=snaps.append)
    with tck.installed(ctrl):
        _engine(T, "single", "python").consensus()
    assert not snaps and ctrl.oversize_dropped > 0
    cfg = (T.CdwfaConfigBuilder().consensus_cost(T.ConsensusCost.L2_DISTANCE)
           .wildcard(ord("N")).frontier_width(4).initial_band(16).build())
    enc = json.loads(json.dumps(tck.encode_config_dict(cfg)))
    assert tck.decode_config_dict(enc) == cfg
    enc["not_a_field"] = 1
    assert tck.decode_config_dict(enc) == cfg
    with pytest.raises(tck.CheckpointRejected):
        tck.decode_config_dict({"backend": "tpu"})
