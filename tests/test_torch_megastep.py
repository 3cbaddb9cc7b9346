"""The JAX package's megastep (``JaxScorer.run_mega``, the XLA loop
``_j_run_mega`` under the ``WAFFLE_MEGA_SYMS`` budget) against the port,
whose run kernel already runs to the first event in one launch: the
port has one run path, ``TorchScorer.run_extend``, and reads no
``WAFFLE_*`` knob.

Engine level, on the exit classes of ``tests/test_megastep.py``: the
port's ``"torch"`` (``device="cpu"``, so the run kernel's plain twin
runs) against JAX ``"jax"`` with ``WAFFLE_MEGASTEP=1`` (frontier
speculator off, ``frontier_width(1)``, the path the port implements):
results byte for byte, the port's ``run_calls`` / ``run_steps`` equal to
JAX's ``run_mega_calls`` / ``run_mega_steps`` (and to its ``run_calls`` /
``run_steps``), and ``run_stop_*``, ``run_dual_calls``, ``arena_calls``
and ``grow_e_events`` equal.  JAX's ``run_dual_mega_calls`` has no
counterpart and is left out.  Scorer level: a budget-capped megastep is
``run_extend`` with ``max_steps`` at the budget.  The test session sets
``WAFFLE_MEGASTEP=0`` (the root ``conftest.py``), so each test sets the
knobs it needs; the draws share few geometries, so ``_j_run_mega``
compiles for a handful of shapes.
"""

import ast
import os

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_torch_priority_jax import _key as _priority_key
from test_torch_run import _dump, _slot_rows, _assert_rows_equal, _configs
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu_torch.ops.state_io import state_to_numpy
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

import jax

#: counters the port keeps under JAX's names
SAME = ("run_calls", "run_steps", "run_dual_calls", "arena_calls",
        "grow_e_events")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_mega(monkeypatch, syms=None):
    monkeypatch.setenv("WAFFLE_MEGASTEP", "1")
    if syms is None:
        monkeypatch.delenv("WAFFLE_MEGA_SYMS", raising=False)
    else:
        monkeypatch.setenv("WAFFLE_MEGA_SYMS", syms)


def _builder(pkg, backend, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    b = b.device("cpu") if pkg is T else b.frontier_width(1)
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    return b


def _key(res):
    if res and hasattr(res[0], "consensus1"):
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        return [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [(c.sequence, list(c.scores)) for c in res]


def _counters(stats):
    c = stats["scorer_counters"]
    keys = set(SAME) | {k for k in c if k.startswith("run_stop_")}
    out = {k: c.get(k, 0) for k in sorted(keys)}
    out["mega"] = (c.get("run_mega_calls"), c.get("run_mega_steps"))
    return out


def _assert_counters_match(port, jax_mega):
    """The port's one run path counted as JAX's megastep counts it."""
    assert port["mega"] == (None, None)
    assert jax_mega["mega"] == (jax_mega["run_calls"], jax_mega["run_steps"])
    strip = lambda c: {k: v for k, v in c.items() if k != "mega"}  # noqa: E731
    assert strip(port) == strip(jax_mega)


def _search(pkg, backend, engine, reads, **cfg):
    eng = getattr(pkg, engine)(_builder(pkg, backend, **cfg).build())
    for r in reads:
        eng.add_sequence(r)
    return _key(eng.consensus()), _counters(eng.last_search_stats)


def _against_jax_mega(monkeypatch, engine, reads, **cfg):
    """The port and JAX ``"jax"`` with its megastep on: results and
    counters equal.  Returns the port's counters."""
    _set_mega(monkeypatch)
    got, c_port = _search(T, "torch", engine, reads, **cfg)
    want, c_jax = _search(J, "jax", engine, reads, **cfg)
    assert got == want
    _assert_counters_match(c_port, c_jax)
    return c_port


def _dual_reads(seq_len=80, n_per=4, er=0.03, seed=4000):
    """``tests/test_megastep.py``'s ``_dual_reads``."""
    rng = np.random.default_rng(seed)
    truth, reads1 = generate_test(4, seq_len, n_per, er, seed=seed + 1)
    h2 = bytearray(truth)
    for pos in rng.choice(seq_len, size=2, replace=False):
        h2[pos] = (h2[pos] + 1 + int(rng.integers(3))) % 4
    return list(reads1) + [
        corrupt(bytes(h2), er, np.random.default_rng(seed + 2 + i))
        for i in range(n_per)
    ]


def _chains(n=6, seed=5000):
    """``tests/test_megastep.py``'s ``_chains``."""
    _, level0 = generate_test(4, 40, n, 0.02, seed=seed)
    t1a, _ = generate_test(4, 70, 1, 0.0, seed=seed + 1)
    t1b = bytearray(t1a)
    t1b[35] = (t1b[35] + 1) % 4
    t1b = bytes(t1b)
    return [
        [level0[i],
         corrupt(t1a if i < n // 2 else t1b, 0.02,
                 np.random.default_rng(seed + 2 + i))]
        for i in range(n)
    ]


# ------------------------------------------------ engine-level parity


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("er,min_count", [(0.02, 2), (0.08, 3)])
def test_single_exit_reason_fuzz(seed, er, min_count, monkeypatch):
    """2 % error barely forks (long runs, the megastep's best case), 8 %
    at min_count 3 forks at nearly every pop; the port commits the same
    trail with the same launches as the JAX megastep."""
    _, reads = generate_test(4, 90, 6, er, seed=seed)
    c = _against_jax_mega(monkeypatch, "ConsensusDWFA", reads,
                          min_count=min_count)
    assert c["run_calls"] > 0
    assert c["run_stop_1"] > 0


def test_band_overflow_mid_megastep(monkeypatch):
    """Stop code 5 (band overflow) inside a run: read 0 lacks 12 bases,
    more than the starting band (E=8) spans, so the run overflows at the
    gap; the band grows and the search lands on the same bytes with the
    same growth path."""
    _, reads = generate_test(4, 80, 6, 0.06, seed=41)
    reads = [reads[0][:40] + reads[0][52:]] + list(reads[1:])
    c = _against_jax_mega(monkeypatch, "ConsensusDWFA", reads,
                          min_count=2, initial_band=2)
    assert c["run_stop_5"] > 0
    assert c["grow_e_events"] > 0


def test_dual_mega_parity(monkeypatch):
    c = _against_jax_mega(monkeypatch, "DualConsensusDWFA", _dual_reads(),
                          min_count=2)
    assert c["run_calls"] + c["run_dual_calls"] > 0


def test_priority_mega_parity(monkeypatch):
    """Priority chains reach the run through each group's
    ``SubsetScorer`` view; results and the merged counters equal JAX's
    megastep."""
    chains = _chains()

    def run(pkg, backend):
        eng = pkg.PriorityConsensusDWFA(
            _builder(pkg, backend, min_count=2).build())
        for chain in chains:
            eng.add_sequence_chain(chain)
        return _priority_key(eng.consensus()), _counters(eng.last_search_stats)

    _set_mega(monkeypatch)
    got, c_port = run(T, "torch")
    want, c_jax = run(J, "jax")
    assert got == want
    _assert_counters_match(c_port, c_jax)
    assert c_port["run_calls"] > 0


@pytest.mark.parametrize("knobs", [
    {"WAFFLE_MEGASTEP": "0"},
    {"WAFFLE_MEGASTEP": "1", "WAFFLE_MEGA_SYMS": "3"},
])
def test_port_reads_no_megastep_knob(knobs, monkeypatch):
    """The JAX package's knobs leave the port's search and launches as
    they are."""
    _, reads = generate_test(4, 60, 6, 0.02, seed=31)
    monkeypatch.delenv("WAFFLE_MEGA_SYMS", raising=False)
    monkeypatch.setenv("WAFFLE_MEGASTEP", "1")
    base = _search(T, "torch", "ConsensusDWFA", reads, min_count=2)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    assert _search(T, "torch", "ConsensusDWFA", reads, min_count=2) == base


# ------------------------------------------------ scorer level


@pytest.mark.parametrize("syms", [1, 3, 7, 40])
def test_budget_capped_megastep_is_run_extend_at_the_budget(syms,
                                                            monkeypatch):
    """``JaxScorer.run_mega`` under ``WAFFLE_MEGA_SYMS=syms`` (a caller's
    ``max_steps`` of 40) against the port's ``run_extend`` at
    ``max_steps=syms``: steps, stop code (4 while the budget binds),
    appended bytes, stats, records and the slot's rows equal."""
    _set_mega(monkeypatch, str(syms))
    _truth, reads = generate_test(4, 120, 10, 0.0, seed=1)
    jcfg, tcfg = _configs(3, False)
    js, ts = JaxScorer(reads, jcfg), TorchScorer(reads, tcfg)
    run = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
               min_count=3, l2=False)
    outs, rows = [], []
    for sc in (js, ts):
        h = sc.root(np.ones(len(reads), dtype=bool))
        if sc is js:
            out = sc.run_mega(h, b"", max_steps=40, **run)
            state = jax.device_get(sc._state)
        else:
            out = sc.run_extend(h, b"", max_steps=min(syms, 40), **run)
            state = state_to_numpy(sc._state)
        outs.append(_dump(out))
        rows.append(_slot_rows(state, sc._slot_of[h]))
    assert js.counters["run_mega_calls"] == 1
    assert outs[0] == outs[1]
    _assert_rows_equal(rows[0], rows[1])
    assert outs[1][:2] == ((syms, 4) if syms < 40 else (40, 4))


# ------------------------------------------------ no knob in the port


def _direct_reads(path):
    """Line numbers and names of ``WAFFLE_*`` environment reads in a
    source file (``os.environ.get``, ``os.environ[...]``, ``os.getenv``)."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    found = []
    for node in ast.walk(tree):
        arg = None
        if isinstance(node, ast.Call) and node.args:
            f = ast.unparse(node.func)
            if f in ("os.environ.get", "os.getenv", "environ.get", "getenv"):
                arg = node.args[0]
        elif isinstance(node, ast.Subscript):
            if ast.unparse(node.value) in ("os.environ", "environ"):
                arg = node.slice
        if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                and arg.value.startswith("WAFFLE_")):
            found.append((node.lineno, arg.value))
    return sorted(found)


def test_no_port_module_reads_a_waffle_knob():
    port = os.path.join(REPO, "waffle_con_tpu_torch")
    paths = [os.path.join(d, f) for d, _s, fs in os.walk(port)
             for f in fs if f.endswith(".py")]
    bad = {os.path.relpath(p, REPO): _direct_reads(p) for p in paths}
    assert len(paths) > 20
    assert not {k: v for k, v in bad.items() if v}


def test_the_scan_finds_direct_reads(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\n"
        "a = os.environ.get('WAFFLE_MEGASTEP')\n"
        "b = os.getenv('WAFFLE_MEGA_SYMS', '1')\n"
        "c = os.environ['WAFFLE_MEGASTEP']\n"
        "d = os.environ.get('HOME')\n"
    )
    assert [line for line, _ in _direct_reads(str(src))] == [2, 3, 4]
