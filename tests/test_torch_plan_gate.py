"""The kernels' launch planners as the engines' gate: a shape a planner
refuses means "not engaged", never an exception in the middle of a
search.

* The gate answers ``TorchScorer.run_takes`` / ``run_dual_takes`` /
  ``arena_takes`` (and the gang's ``plan_ragged``) say "no" exactly where
  ``plan_run``, ``plan_run_dual`` and ``plan_arena`` raise, at the shapes
  the planners refuse (A = 129; R = 1,152 at A = 128 for the arena; R =
  16,384 at A = 256 for the dual run; R = 65,536 at A = 256 for the run)
  and at neighbours they take (R = 256 at A = 256 for the dual run, on
  fewer warps); each refusal counts ``plan_refused_<kernel>``.
  On the CPU the plain twins take every shape.
* The engines on CPU tensors with the gate refusing (every planner, or
  the CUDA planners' own answers) return the bytes of the port's and the
  JAX package's ``"python"`` oracles, on a draw over 129 symbols (two
  haplotypes, so the arena has competitors) and on a small dual draw, and
  the refusal counters move.
* The planners still raise when called directly.
"""

import types

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu_torch.ops import ragged_kernel, torch_scorer
from waffle_con_tpu_torch.ops.arena_kernel import plan_arena
from waffle_con_tpu_torch.ops.run_dual_kernel import plan_run_dual
from waffle_con_tpu_torch.ops.run_kernel import plan_run
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer, planner_refuses
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raises(planner, *shape):
    try:
        planner(*shape)
    except ValueError:
        return True
    return False


def _store_view(R, W, A, C=512):
    """The fields of a CUDA branch store the gate reads, at any shape."""
    view = types.SimpleNamespace(device=CUDA, _R=R, _W=W, num_symbols=A,
                                 _C=C, ARENA_K=TorchScorer.ARENA_K,
                                 counters={})
    view._takes = types.MethodType(TorchScorer._takes, view)
    return view


GATES = [
    # (gate, planner, (R, W, A), extra gate args)
    ("arena", plan_arena, (16, 258, 129), (8192,)),
    ("arena", plan_arena, (16, 258, 128), (8192,)),
    ("arena", plan_arena, (1152, 258, 128), (8192,)),
    ("arena", plan_arena, (1024, 258, 128), (8192,)),
    ("arena", plan_arena, (17856, 258, 4), (8192,)),
    ("run_dual", plan_run_dual, (16384, 258, 256), ()),
    ("run_dual", plan_run_dual, (256, 258, 256), ()),
    ("run_dual", plan_run_dual, (128, 258, 256), ()),
    ("run", plan_run, (65536, 258, 256), ()),
    ("run", plan_run, (65536, 258, 4), ()),
    ("run", plan_run, (256, 514, 4), ()),
]


@pytest.mark.parametrize("gate,planner,shape,extra", GATES)
def test_gate_refuses_exactly_where_the_planner_raises(gate, planner, shape,
                                                       extra):
    R, W, A = shape
    view = _store_view(R, W, A)
    takes = getattr(TorchScorer, f"{gate}_takes")(view, *extra)
    if planner is plan_arena:
        refused = _raises(plan_arena, TorchScorer.ARENA_K, R, W, A, *extra,
                          512)
    else:
        refused = _raises(planner, R, W, A)
    assert takes == (not refused)
    assert view.counters.get(f"plan_refused_{gate}", 0) == int(refused)
    # the plain twins take every shape
    cpu = _store_view(R, W, A)
    cpu.device = torch.device("cpu")
    assert getattr(TorchScorer, f"{gate}_takes")(cpu, *extra)


def test_refused_shapes_are_refused():
    """The shapes this gate exists for do raise in their planners."""
    assert _raises(plan_arena, 64, 16, 258, 129, 8192, 512)
    assert _raises(plan_arena, 64, 1152, 258, 128, 8192, 512)
    assert _raises(plan_run_dual, 16384, 258, 256)
    assert not _raises(plan_run_dual, 256, 258, 256)
    assert _raises(plan_run, 65536, 258, 256)
    assert _raises(ragged_kernel.plan_ragged, 2, 65536, 258, 256, 512)
    assert not _raises(plan_run, 256, 514, 4)


def test_ragged_gate_counts():
    view = _store_view(65536, 258, 256)
    assert not view._takes("ragged", ragged_kernel.plan_ragged, 2, 65536,
                           258, 256, 512)
    assert not planner_refuses(torch.device("cpu"), plan_run, 65536, 258, 256)
    assert view.counters == {"plan_refused_ragged": 1}


# ---------------------------------------------------------------------
# engines behind a refusing gate


def _alphabet_draw(A, n, length, err, seed, snps):
    """``n`` reads over ``A`` symbols, every symbol in the truth, the
    second half from a haplotype ``snps`` away."""
    rng = np.random.default_rng(seed)
    truth = np.concatenate([
        rng.permutation(A), rng.integers(0, A, size=length - A),
    ]).astype(np.uint8).tobytes()
    h2 = bytearray(truth)
    for pos, shift in snps:
        h2[pos] = (h2[pos] + shift) % A
    return [corrupt(bytes(h2) if i >= n // 2 else truth, err, rng, A)
            for i in range(n)]


def _small_dual():
    t1, reads1 = generate_test(4, 140, 6, 0.02, seed=71)
    t2 = bytearray(t1)
    t2[40] = (t2[40] + 1) % 4
    t2[90] = (t2[90] + 2) % 4
    rng = np.random.default_rng(72)
    return list(reads1) + [corrupt(bytes(t2), 0.02, rng) for _ in range(6)]


DRAWS = {
    "single_A129": (lambda: _alphabet_draw(129, 8, 400, 0.01, 3,
                                           ((150, 1), (300, 5))), False, 3),
    "dual_small": (_small_dual, True, 2),
}


def _run(pkg, backend, reads, dual, mc):
    b = pkg.CdwfaConfigBuilder().backend(backend).min_count(mc)
    if pkg is T:
        b = b.device("cpu")
    eng = (pkg.DualConsensusDWFA if dual else pkg.ConsensusDWFA)(b.build())
    for r in reads:
        eng.add_sequence(r)
    res = eng.consensus()
    if dual:
        key = [(repr(d.consensus1), repr(d.consensus2),
                list(d.is_consensus1)) for d in res]
    else:
        key = [(c.sequence, list(c.scores)) for c in res]
    return key, dict(eng.last_search_stats.get("scorer_counters", {}))


@pytest.mark.parametrize("mode", ["all", "cuda_planners"])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_engines_take_the_host_path_when_refused(name, mode, monkeypatch):
    make, dual, mc = DRAWS[name]
    reads = make()
    if mode == "all":
        monkeypatch.setattr(torch_scorer, "planner_refuses",
                            lambda device, planner, *shape: True)
    else:
        # the CUDA kernels' answers, for the plain twins on the CPU
        real = torch_scorer.planner_refuses
        monkeypatch.setattr(torch_scorer, "planner_refuses",
                            lambda device, planner, *shape:
                            real(CUDA, planner, *shape))
    got, c = _run(T, "torch", reads, dual, mc)
    assert got == _run(T, "python", reads, dual, mc)[0]
    assert got == _run(J, "python", reads, dual, mc)[0]
    if mode == "all":
        # no kernel launched; every refusal counted
        assert c["run_calls"] == c["run_dual_calls"] == 0
        assert c.get("arena_calls", 0) == 0
        assert c.get("plan_refused_run", 0) > 0
        if dual:
            assert c.get("plan_refused_arena", 0) > 0
    elif name == "single_A129":
        # only the arena refuses 129 symbols; the run kernel still runs
        assert c.get("plan_refused_arena", 0) > 0 and c["run_calls"] > 0
        assert c.get("arena_calls", 0) == 0
    else:
        assert not any(k.startswith("plan_refused") for k in c)


def test_planner_refusal_is_never_caught_elsewhere():
    """A plan refusal inside a kernel wrapper still raises: the gate is
    the engines' only way around it."""
    with pytest.raises(ValueError):
        plan_arena(64, 16, 258, 129, 8192, 512)
