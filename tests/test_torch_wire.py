"""The port's wire codec (``waffle_con_tpu_torch/serve/procs/wire.py``)
against the JAX package's.

* The frame and codec cases of ``tests/test_procs.py``: every frame type
  round trips, torn and concatenated frames, the typed errors (checksum,
  version, frame type, size, garbage payload, a header fuzz), and the
  config, request and result codecs.  The JAX package's
  ``WAFFLE_PROC_FRAME_MAX`` knob is the port's ``max_payload=`` argument.
* Across the packages: the same frames are the same bytes and decode on
  either side; a JAX-encoded config and request decode in the port; the
  port's config codec is the checkpoints'; and ``encode_result`` of the
  port's serial ``"torch"`` results (CPU) is byte-equal to JAX's serial
  ``"python"`` results, for single, dual and priority jobs.
"""

import json
import random
import zlib

import pytest
import torch

from waffle_con_tpu import CdwfaConfigBuilder as JBuilder
from waffle_con_tpu.config import CdwfaConfig as JConfig
from waffle_con_tpu.config import ConsensusCost as JCost
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu.serve.procs import wire as jwire
from waffle_con_tpu.utils import fixtures as jfixtures
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.models.consensus import Consensus
from waffle_con_tpu_torch.models.dual_consensus import DualConsensus
from waffle_con_tpu_torch.models.priority_consensus import PriorityConsensus
from waffle_con_tpu_torch.serve import JobRequest
from waffle_con_tpu_torch.serve.procs import wire
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils import fixtures
from waffle_con_tpu_torch.utils.example_gen import generate_test

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# frames (tests/test_procs.py)
# ---------------------------------------------------------------------

def test_frame_roundtrip_every_type():
    decoder = wire.FrameDecoder()
    payloads = {ftype: {"n": int(ftype), "name": ftype.name}
                for ftype in wire.FrameType}
    blob = b"".join(
        wire.encode_frame(ftype, obj) for ftype, obj in payloads.items()
    )
    frames = decoder.feed(blob)
    assert [(f, o) for f, o in frames] == list(payloads.items())
    assert decoder.pending() == 0


def test_torn_frames_buffer_without_hanging():
    # one byte at a time: nothing decodes until the frame completes,
    # and the decoder never blocks or raises on partial input
    frame = wire.encode_frame(wire.FrameType.PING, {"x": 1})
    decoder = wire.FrameDecoder()
    for byte in frame[:-1]:
        assert decoder.feed(bytes([byte])) == []
    assert decoder.feed(frame[-1:]) == [(wire.FrameType.PING, {"x": 1})]


def test_two_frames_in_one_chunk_plus_tail():
    a = wire.encode_frame(wire.FrameType.PING, {})
    b = wire.encode_frame(wire.FrameType.PONG, {"outstanding": 2})
    c = wire.encode_frame(wire.FrameType.DRAIN, {})
    decoder = wire.FrameDecoder()
    got = decoder.feed(a + b + c[:4])
    assert [f for f, _ in got] == [wire.FrameType.PING, wire.FrameType.PONG]
    assert decoder.feed(c[4:]) == [(wire.FrameType.DRAIN, {})]


def test_bad_checksum_is_typed():
    frame = bytearray(wire.encode_frame(wire.FrameType.RESULT, {"job": 1}))
    frame[-1] ^= 0xFF  # flip a payload byte; header CRC now mismatches
    with pytest.raises(wire.BadChecksum):
        wire.FrameDecoder().feed(bytes(frame))


def test_future_version_is_typed():
    frame = bytearray(wire.encode_frame(wire.FrameType.PING, {}))
    frame[0] = wire.FRAME_VERSION + 1
    with pytest.raises(wire.UnsupportedVersion):
        wire.FrameDecoder().feed(bytes(frame))


def test_unknown_frame_type_is_typed():
    payload = b"{}"
    frame = wire.HEADER.pack(
        wire.FRAME_VERSION, 200, len(payload), zlib.crc32(payload)
    ) + payload
    with pytest.raises(wire.UnknownFrameType):
        wire.FrameDecoder().feed(frame)


def test_oversized_declared_length_is_typed():
    header = wire.HEADER.pack(wire.FRAME_VERSION, 1, 1 << 20, 0)
    with pytest.raises(wire.FrameTooLarge):
        wire.FrameDecoder(max_payload=4096).feed(header)
    with pytest.raises(wire.FrameTooLarge):
        wire.encode_frame(wire.FrameType.SUBMIT, {"x": "a" * 8192},
                          max_payload=4096)
    # the default bound is 32 MiB, and no bound goes below 4 KiB
    assert wire.FrameDecoder().max_payload == 32 * 1024 * 1024
    assert wire.FrameDecoder(max_payload=16).max_payload == 4096
    wire.FrameDecoder().feed(header)  # 1 MiB declared: within the default


def test_garbage_payload_is_typed_never_a_hang():
    # correct header + CRC over non-JSON bytes: typed WireError
    payload = b"\xff\xfe not json"
    frame = wire.HEADER.pack(
        wire.FRAME_VERSION, int(wire.FrameType.PING), len(payload),
        zlib.crc32(payload),
    ) + payload
    with pytest.raises(wire.WireError):
        wire.FrameDecoder().feed(frame)


def test_header_fuzz_never_untyped():
    # every mutation of a valid frame must raise a WireError subclass
    # or decode cleanly — nothing untyped, nothing hangs
    base = wire.encode_frame(wire.FrameType.HEALTH, {"reason": "x"})
    rng = random.Random(20260806)
    for _ in range(300):
        blob = bytearray(base)
        for _ in range(rng.randint(1, 4)):
            blob[rng.randrange(len(blob))] = rng.randrange(256)
        decoder = wire.FrameDecoder(max_payload=65536)
        try:
            decoder.feed(bytes(blob))
        except wire.WireError:
            pass


def test_config_codec_roundtrip():
    cfg = CdwfaConfig(
        consensus_cost=ConsensusCost.L2_DISTANCE, max_queue_size=7,
        min_af=0.25, wildcard=ord("N"), backend="torch", device="cpu",
        mesh_shards=2, initial_band=32, backend_chain=("torch", "python"),
        supervised=True, dual_max_ed_delta=9,
    )
    assert wire.decode_config(wire.encode_config(cfg)) == cfg
    assert wire.decode_config(None) is None
    # unknown fields from a newer peer are dropped, not fatal
    obj = wire.encode_config(cfg)
    obj["knob_from_the_future"] = 42
    assert wire.decode_config(obj) == cfg
    with pytest.raises(wire.WireError):
        wire.decode_config(["not", "an", "object"])
    with pytest.raises(wire.WireError):
        wire.decode_config({"consensus_cost": "l7"})


def test_request_codec_roundtrip_all_kinds():
    single = JobRequest(kind="single", reads=(b"ACGT", b"ACG"),
                        offsets=(None, 1), priority=2, deadline_s=9.0,
                        tag="t", config=CdwfaConfig())
    rt = wire.decode_request(wire.encode_request(single))
    assert (rt.kind, rt.reads, rt.offsets, rt.priority, rt.tag) == \
        (single.kind, single.reads, single.offsets, single.priority,
         single.tag)
    assert rt.config == single.config
    chain = JobRequest(kind="priority",
                       reads=((b"AC", b"ACGT"), (b"AG", b"ACGA")))
    assert wire.decode_request(wire.encode_request(chain)).reads == \
        chain.reads
    # the door rewrites the deadline to the REMAINING budget
    sent = wire.encode_request(single, deadline_left_s=1.5)
    assert sent["deadline_s"] == 1.5
    with pytest.raises(wire.WireError):
        wire.decode_request({"kind": "single", "reads": ["!!"]})


def test_result_codec_roundtrip_all_kinds():
    c1 = Consensus(b"ACGT", ConsensusCost.L1_DISTANCE, [0, 1])
    c2 = Consensus(b"ACGA", ConsensusCost.L1_DISTANCE, [2, 0])
    single = [c1, c2]
    assert wire.decode_result(
        "single", wire.encode_result("single", single)
    ) == single
    dual = [DualConsensus(c1, c2, [True, False], [0, None], [None, 0]),
            DualConsensus(c1, None, [True, True], [0, 1], [None, None])]
    assert wire.decode_result(
        "dual", wire.encode_result("dual", dual)
    ) == dual
    prio = PriorityConsensus([[c1], [c1, c2]], [0, 1])
    assert wire.decode_result(
        "priority", wire.encode_result("priority", prio)
    ) == prio
    with pytest.raises(wire.WireError):
        wire.encode_result("nope", [])
    with pytest.raises(wire.WireError):
        wire.decode_result("single", [{"bad": 1}])


def test_trace_context_codec():
    ctx = {"trace_id": "svc/job-3", "chrome_pid": 7, "label": "job-3",
           "parent_span_id": 11, "span_base": 4096, "flow_id": None}
    assert wire.decode_trace(ctx) == jwire.decode_trace(ctx)
    assert wire.decode_trace(None) is None
    for bad in ([1], {"chrome_pid": 1}, dict(ctx, chrome_pid=-1)):
        with pytest.raises(wire.WireError):
            wire.decode_trace(bad)


# ---------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------

def test_frames_are_the_jax_packages_bytes():
    rng = random.Random(5)
    for ftype in wire.FrameType:
        obj = {"job": rng.randrange(1000), "name": ftype.name,
               "data": [rng.random() for _ in range(3)]}
        ours = wire.encode_frame(ftype, obj)
        theirs = jwire.encode_frame(jwire.FrameType(int(ftype)), obj)
        assert ours == theirs
        assert [(int(f), o) for f, o in jwire.FrameDecoder().feed(ours)] \
            == [(int(ftype), obj)]
        assert wire.FrameDecoder().feed(theirs) == [(ftype, obj)]


def test_jax_encoded_config_and_request_decode_in_the_port():
    jcfg = JConfig(consensus_cost=JCost.L2_DISTANCE, min_count=3,
                   wildcard=ord("*"), offset_window=40, backend="python")
    got = wire.decode_config(jwire.encode_config(jcfg))
    # the JAX config's fields, the port's own default for ``device``
    assert got == CdwfaConfig(consensus_cost=ConsensusCost.L2_DISTANCE,
                              min_count=3, wildcard=ord("*"),
                              offset_window=40, backend="python")
    jreq = JJobRequest(kind="single", reads=(b"ACGT", b"AGT"),
                       offsets=(None, 2), config=jcfg, priority=1, tag="x")
    req = wire.decode_request(jwire.encode_request(jreq))
    assert (req.kind, req.reads, req.offsets, req.priority, req.tag) == \
        (jreq.kind, jreq.reads, jreq.offsets, jreq.priority, jreq.tag)
    assert req.config == got


def test_config_codec_is_the_checkpoints():
    cfg = CdwfaConfigBuilder().backend("torch").device("cpu").min_count(
        3).wildcard(ord("N")).build()
    assert wire.encode_config(cfg) == ckpt_mod.encode_config_dict(cfg)
    obj = ckpt_mod.encode_config_dict(cfg)
    assert wire.decode_config(obj) == ckpt_mod.decode_config_dict(obj)


def _results_requests():
    """Single, dual and priority jobs of small size, built for either
    package: (kind, reads, config kwargs)."""
    out = []
    for seed in (3, 4):
        _, reads = generate_test(4, 140, 7, 0.02, seed=seed)
        out.append(("single", tuple(reads), dict(min_count=2)))
    out.append(("dual", (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT",
                         b"ACTTACGT"), dict(min_count=1)))
    return out


@pytest.mark.parametrize("which", ["single0", "single1", "dual",
                                   "dual_fixture", "priority"])
def test_encode_result_byte_equal_to_jax(which):
    if which.startswith("single") or which == "dual":
        idx = {"single0": 0, "single1": 1, "dual": 2}[which]
        kind, reads, kw = _results_requests()[idx]
        jb, pb = JBuilder().backend("python"), CdwfaConfigBuilder().backend(
            "torch").device("cpu")
        for k, v in kw.items():
            jb, pb = getattr(jb, k)(v), getattr(pb, k)(v)
        jreq = JJobRequest(kind=kind, reads=reads, config=jb.build())
        preq = JobRequest(kind=kind, reads=reads, config=pb.build())
    else:
        jcfg = JBuilder().backend("python").wildcard(ord("*")).build()
        pcfg = CdwfaConfigBuilder().backend("torch").device("cpu").wildcard(
            ord("*")).build()
        if which == "dual_fixture":
            kind = "dual"
            seqs, _ = jfixtures.load_dual_fixture("dual_001", True,
                                                  jcfg.consensus_cost)
            pseqs, _ = fixtures.load_dual_fixture("dual_001", True,
                                                  pcfg.consensus_cost)
            jreq = JJobRequest(kind=kind, reads=tuple(seqs), config=jcfg)
            preq = JobRequest(kind=kind, reads=tuple(pseqs), config=pcfg)
        else:
            kind = "priority"
            chains, _ = jfixtures.load_priority_fixture(
                "priority_001", True, jcfg.consensus_cost)
            pchains, _ = fixtures.load_priority_fixture(
                "priority_001", True, pcfg.consensus_cost)
            jreq = JJobRequest(kind=kind, config=jcfg,
                               reads=tuple(tuple(c) for c in chains))
            preq = JobRequest(kind=kind, config=pcfg,
                              reads=tuple(tuple(c) for c in pchains))
    assert preq.reads == jreq.reads
    want = jwire.encode_result(
        kind, jservice._build_engine(jreq).consensus())
    got = wire.encode_result(kind, _build_engine(preq).consensus())
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    # and each side decodes the other's bytes
    assert wire.encode_result(kind, wire.decode_result(kind, want)) == want
    assert jwire.encode_result(kind, jwire.decode_result(kind, got)) == got
