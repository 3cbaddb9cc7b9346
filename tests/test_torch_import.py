"""The port stands alone: it imports without JAX and without the JAX
package, runs a single, a dual and a priority search on the CPU (the
fixtures read by its own loader), imports its C++ engines (``native``,
built from its own copy of the source) and runs a search on
``"native"``, and refuses to fall back to the CPU
when a CUDA device is asked for and absent."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None          # any import of jax now fails
    import waffle_con_tpu_torch as T
    from waffle_con_tpu_torch.ops import run_kernel, state_io, torch_scorer
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, 80, 6, 0.02, seed=5)
    eng = T.ConsensusDWFA(
        T.CdwfaConfigBuilder().backend("torch").device("cpu").build()
    )
    for r in reads:
        eng.add_sequence(r)
    assert eng.consensus()[0].sequence == truth

    from waffle_con_tpu_torch import DualConsensusDWFA
    from waffle_con_tpu_torch.ops import arena_kernel, cuda_build, run_dual_kernel

    t2 = bytearray(truth)
    t2[30] = (t2[30] + 1) % 4
    dual = DualConsensusDWFA(
        T.CdwfaConfigBuilder().backend("torch").device("cpu").min_count(2)
        .build()
    )
    for r in [truth] * 3 + [bytes(t2)] * 3:
        dual.add_sequence(r)
    res = dual.consensus()
    assert res[0].is_dual()
    assert {res[0].consensus1.sequence, res[0].consensus2.sequence} == {
        truth, bytes(t2)
    }
    c = dual.last_search_stats["scorer_counters"]
    assert c["run_dual_calls"] + c["arena_calls"] >= 1

    from waffle_con_tpu_torch import MultiConsensus, PriorityConsensusDWFA
    from waffle_con_tpu_torch.models import multi_consensus, priority_consensus
    from waffle_con_tpu_torch.utils import fixtures

    chains, expected = fixtures.load_priority_fixture(
        "priority_003", True, T.ConsensusCost.L1_DISTANCE
    )
    prio = PriorityConsensusDWFA(
        T.CdwfaConfigBuilder().backend("torch").device("cpu")
        .wildcard(ord("*")).build()
    )
    for chain in chains:
        prio.add_sequence_chain(chain)
    got = prio.consensus()
    assert got.sequence_indices == expected.sequence_indices
    assert prio.last_search_stats["scorer_constructions"] == 2
    assert MultiConsensus([], []).consensuses == []

    from waffle_con_tpu_torch import native

    assert native.native_consensus(reads)[0][0] == truth
    eng = T.ConsensusDWFA(T.CdwfaConfigBuilder().backend("native").build())
    for r in reads:
        eng.add_sequence(r)
    assert eng.consensus()[0].sequence == truth
    loaded = sorted(m for m in sys.modules
                    if m == "waffle_con_tpu" or m.startswith("waffle_con_tpu."))
    assert not loaded, loaded
    assert sys.modules["jax"] is None
    print("OK")
    """
)


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a host without one")
    import waffle_con_tpu_torch as T

    cfg = T.CdwfaConfigBuilder().backend("torch").build()
    assert cfg.device == "cuda"
    eng = T.ConsensusDWFA(cfg)
    eng.add_sequence(b"ACGT")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.consensus()
    prio = T.PriorityConsensusDWFA()
    prio.add_sequence_chain([b"ACGT", b"ACGTT"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prio.consensus()
