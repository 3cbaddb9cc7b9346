"""Read-axis sharding of the port (``waffle_con_tpu_torch/parallel/`` and
``ops/sharded_scorer.py``) against the JAX package's ``parallel/mesh.py``.

The port's ``sharded_col_step`` on 8 co-resident ``"cpu"`` shards against
JAX's ``sharded_col_step`` on the suite's 8 virtual XLA devices (root
``conftest.py``): ``tests/test_parallel.py``'s ``_problem(16, 18, 24)``, a
state with inactive reads, offsets and early termination, and a step in
which one read of the last shard overflows the band; all nine outputs
equal, tolerance 0.  The sharded store call by call against the
unsharded ``TorchScorer`` through a push where only one shard's reads
overflow (no shard commits, every shard grows).  The three engines with
``mesh_shards(8)`` on ``tests/test_parallel.py``'s and
``__graft_entry__.py``'s draws against JAX ``"jax"`` with
``mesh_shards(8)`` and the ``"python"`` oracle; late reads with band
growth at 2 and 4 shards; the one-shard-overflow draw; a supervised
sharded search demoted by ``device_loss``; a checkpoint resume of a
sharded search.  Then the device topology helpers
(``tests/test_parallel.py``'s cases) and the config's validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.ops.jax_scorer import _col_step, _init_col
from waffle_con_tpu.parallel import make_mesh as jmake_mesh
from waffle_con_tpu.parallel import sharded_col_step as jsharded_col_step
from waffle_con_tpu_torch.models import checkpoint as tck
from waffle_con_tpu_torch.ops import (
    arena_kernel,
    branch_kernel,
    run_kernel,
    sharded_scorer,
)
from waffle_con_tpu_torch.ops.sharded_scorer import ShardedScorer
from waffle_con_tpu_torch.ops.state_io import (
    gather_reads,
    gather_state,
    split_reads,
    split_state,
    state_to_numpy,
)
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.parallel import mesh as tmesh
from waffle_con_tpu_torch.parallel import (
    DeviceSet,
    current_device_set,
    device_slices,
    make_mesh,
    sharded_col_step,
    shard_for_config,
    use_device_set,
)
from waffle_con_tpu_torch.runtime import events, faults, supervisor
from waffle_con_tpu_torch.utils.example_gen import generate_test

CPU8 = DeviceSet("cpu8", ("cpu",) * 8)


def needs_devices(n):
    return pytest.mark.skipif(
        len(jax.devices()) < n, reason=f"needs {n} XLA devices"
    )


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def runtime_clean():
    faults.clear()
    events.clear_events()
    yield
    faults.clear()
    events.clear_events()
    supervisor.shutdown_executors(wait=True)


# ------------------------------------------------- the sharded column step


def _problem(R, W, L, seed=0):
    """``tests/test_parallel.py``'s ``_problem``: numpy fields."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(R, L)).astype(np.int32)
    rlen = np.full((R,), L, dtype=np.int32)
    off = np.zeros((R,), dtype=np.int32)
    act = np.ones((R,), dtype=bool)
    return _fresh(reads, rlen, off, act, W)


def _fresh(reads, rlen, off, act, W, C=64):
    E = jnp.int32((W - 2) // 2)
    D, e, rmin, er = _init_col(jnp.asarray(off), jnp.asarray(act),
                               jnp.asarray(rlen), E, W)
    st = dict(D=D, e=e, rmin=rmin, er=er, off=off, act=act,
              cons=np.zeros((C,), dtype=np.int32), clen=np.int32(0))
    return reads, rlen, {k: np.asarray(v) for k, v in st.items()}


def _jax_ref_step(st, reads, rlen, sym, wc=-2, et=False):
    """One unsharded JAX column step with stats (``tests/
    test_parallel.py``'s ``_reference_step``) and the overflow flag."""
    W = st["D"].shape[1]
    E = jnp.int32((W - 2) // 2)
    cons = jnp.asarray(st["cons"])
    clen = jnp.int32(st["clen"])
    cons2 = cons.at[jnp.clip(clen, 0, cons.shape[0] - 1)].set(sym)
    clen2 = clen + 1
    act = jnp.asarray(st["act"])
    D2, e2, rmin2, er2 = _col_step(
        jnp.asarray(st["D"]), jnp.asarray(st["e"]), jnp.asarray(st["rmin"]),
        jnp.asarray(st["er"]), jnp.asarray(st["off"]), act,
        jnp.asarray(rlen), jnp.asarray(reads), clen2, jnp.int32(sym),
        jnp.int32(wc), jnp.bool_(et), E,
    )
    new = dict(st, D=np.asarray(D2), e=np.asarray(e2), rmin=np.asarray(rmin2),
               er=np.asarray(er2), cons=np.asarray(cons2),
               clen=np.int32(clen2))
    overflow = bool((act & (e2 >= E)).any())
    return new, overflow


def _advanced(reads, rlen, st, syms, et=False):
    for y in syms:
        st, _ = _jax_ref_step(st, reads, rlen, int(y), et=et)
    return st


def _case_plain():
    reads, rlen, st = _problem(16, 18, 24)
    return reads, rlen, st, 2, False


def _case_offsets():
    """Inactive reads, nonzero anchors, five columns in, early
    termination on."""
    rng = np.random.default_rng(3)
    reads = rng.integers(0, 4, size=(16, 24)).astype(np.int32)
    rlen = rng.integers(16, 25, size=16).astype(np.int32)
    off = rng.integers(0, 3, size=16).astype(np.int32)
    act = np.ones(16, dtype=bool)
    act[[2, 9, 13]] = False
    reads, rlen, st = _fresh(reads, rlen, off, act, 18)
    syms = reads[0, :5]
    return reads, rlen, _advanced(reads, rlen, st, syms, et=True), 1, True


def _case_overflow():
    """Reads 0-14 one truth with a substitution each, read 15 random (in
    the last shard): stepped along the truth up to the column at which
    read 15's edit distance reaches the band (E = 8)."""
    rng = np.random.default_rng(9)
    truth = rng.integers(0, 4, size=40).astype(np.int32)
    reads = np.tile(truth, (16, 1))
    for i in range(15):
        reads[i, (7 * i) % 40] = (reads[i, (7 * i) % 40] + 1) % 4
    reads[15] = rng.integers(0, 4, size=40)
    rlen = np.full(16, 40, dtype=np.int32)
    reads, rlen, st = _fresh(reads, rlen, np.zeros(16, np.int32),
                             np.ones(16, bool), 18)
    for j in range(40):
        nxt, overflow = _jax_ref_step(st, reads, rlen, int(truth[j]))
        if overflow:
            assert (nxt["e"][:14] < 8).all()  # only the last shard's
            return reads, rlen, st, int(truth[j]), False
        st = nxt
    raise AssertionError("the draw never overflows")


CASES = {"plain": _case_plain, "offsets": _case_offsets,
         "overflow": _case_overflow}


@needs_devices(8)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_col_step_matches_jax(case):
    reads, rlen, st, sym, et = CASES[case]()
    jstep = jsharded_col_step(jmake_mesh(8, axis_names=("read",)))
    want = jstep(*(jnp.asarray(st[k]) for k in
                   ("D", "e", "rmin", "er", "off", "act", "cons")),
                 jnp.int32(st["clen"]), jnp.asarray(reads),
                 jnp.asarray(rlen), jnp.int32(sym), jnp.int32(-2),
                 jnp.bool_(et))
    mesh = make_mesh(devices=["cpu"] * 8)
    devs = mesh.devices
    step = sharded_col_step(mesh)
    inputs = {k: [t.clone() for t in split_reads(st[k], devs)]
              for k in ("D", "e", "rmin", "er", "off", "act")}
    got = step(*(inputs[k] for k in ("D", "e", "rmin", "er", "off", "act")),
               torch.tensor(st["cons"]), int(st["clen"]),
               split_reads(reads.astype(np.int16), devs),
               split_reads(rlen, devs), sym, -2, et)
    for name, g, w in zip(("D", "e", "rmin", "er", "occ", "split"), got[:6],
                          want[:6]):
        g = gather_reads(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[6]) == int(want[6])
    assert bool(got[7]) == bool(want[7])
    assert bool(got[8]) == bool(want[8]) == (case == "overflow")
    # the inputs are the caller's, untouched
    for k, parts in inputs.items():
        np.testing.assert_array_equal(gather_reads(parts), st[k])


def test_sharded_col_step_one_shard_is_the_branch_step():
    """One shard: the step is one call of the branch step on the whole
    store (the unsharded path), and the partials are its stats."""
    reads, rlen, st, sym, et = _case_offsets()
    one = sharded_col_step(make_mesh(devices=["cpu"]))(
        *([torch.tensor(st[k])] for k in
          ("D", "e", "rmin", "er", "off", "act")),
        torch.tensor(st["cons"]), int(st["clen"]),
        [torch.as_tensor(reads.astype(np.int16))], [torch.as_tensor(rlen)],
        sym, -2, et)
    store = {k: torch.tensor(st[k])[None]
             for k in ("D", "e", "rmin", "er", "off", "act", "cons")}
    store["clen"] = torch.tensor([int(st["clen"])], dtype=torch.int32)
    out = branch_kernel.advance_plain(
        store, [[0], [0], [sym]], torch.as_tensor(reads.astype(np.int16)),
        torch.as_tensor(rlen), -2, et, 32)
    for k, g in zip(("D", "e", "rmin", "er"), one[:4]):
        assert torch.equal(g[0], store[k][0])
    np.testing.assert_array_equal(one[4][0].numpy(), out.occ[0])
    assert int(one[6]) == int(out.eds.sum())
    assert bool(one[7]) == bool(out.reached.any())


def test_state_split_and_gather_round_trip():
    """A JAX-layout store (numpy) split over 4 shards and gathered back;
    each shard holds its quarter of the reads and the whole consensus."""
    rng = np.random.default_rng(4)
    st = dict(D=rng.integers(0, 9, (3, 16, 18)), e=rng.integers(0, 9, (3, 16)),
              rmin=rng.integers(0, 9, (3, 16)), er=rng.integers(0, 9, (3, 16)),
              off=rng.integers(0, 9, (3, 16)), act=rng.random((3, 16)) < 0.5,
              cons=rng.integers(0, 4, (3, 64)), clen=np.array([5, 0, 9]))
    shards = split_state(st, ["cpu"] * 4)
    assert [tuple(sh["D"].shape) for sh in shards] == [(3, 4, 18)] * 4
    assert shards[2]["act"].dtype == torch.bool
    back = gather_state(shards)
    for k, v in st.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="do not split"):
        split_reads(np.zeros((10, 2)), ["cpu"] * 4)


def test_reduce_partials_adds_in_shard_order():
    parts = [torch.tensor([3, 0, 0], dtype=torch.int32),
             torch.tensor([4, 1, 0], dtype=torch.int32),
             torch.tensor([0, 0, 1], dtype=torch.int32)]
    total, reached, overflow = sharded_scorer.reduce_partials(parts, "cpu")
    assert (int(total), bool(reached), bool(overflow)) == (7, True, True)
    assert total.dtype == torch.int32


# --------------------------------------------------- the sharded store


def _overflow_draw(n=16, length=60, seed=21):
    """``n - 1`` reads of one truth at 2 % and a last read of random
    symbols: pushing the truth overflows only the last read's shard."""
    truth, reads = generate_test(4, length, n - 1, 0.02, seed=seed)
    rng = np.random.default_rng(seed)
    rand = bytes(b"ACGT"[int(i)] for i in rng.integers(0, 4, length))
    return truth, list(reads) + [rand]


def _cfg(**kw):
    b = T.CdwfaConfigBuilder().backend("torch").device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _stats_equal(a, b):
    for name in ("eds", "occ", "split", "reached"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.fin is None) == (b.fin is None)
    if a.fin is not None:
        np.testing.assert_array_equal(a.fin, b.fin)


@pytest.mark.parametrize("shards", [2, 4])
def test_store_commits_on_no_shard_when_one_overflows(shards):
    """Pushing the truth: the last shard's random read reaches the band
    at some column while every other shard's reads stay inside it.  The
    shards that committed go back, every shard grows and replays, the
    step is retried: stats and every store field equal the unsharded
    store's after each push."""
    truth, reads = _overflow_draw()
    cfg = _cfg()
    sharded = ShardedScorer(reads, cfg, ["cpu"] * shards)
    plain = TorchScorer(reads, cfg)
    hs, hp = sharded.root(np.ones(16, bool)), plain.root(np.ones(16, bool))
    child_s = sharded.clone_many([hs])[0]
    child_p = plain.clone_many([hp])[0]
    for j in range(1, 40):
        cons = truth[:j]
        [(hs2, s_stats), (cs2, c_stats)] = sharded.clone_push_many(
            [(hs, cons, True), (child_s, None, True)] if j % 2 else
            [(hs, cons, True), (child_s, cons, True)])
        [(hp2, p_stats), (cp2, pc_stats)] = plain.clone_push_many(
            [(hp, cons, True), (child_p, None, True)] if j % 2 else
            [(hp, cons, True), (child_p, cons, True)])
        assert (hs2, cs2) == (hp2, cp2)
        _stats_equal(s_stats, p_stats)
        if c_stats is not None:
            _stats_equal(c_stats, pc_stats)
        if j % 2:
            plain.push_many([(child_p, cons)])
            sharded.push_many([(child_s, cons)])
    assert sharded.counters["shard_overflow_rollbacks"] >= 1
    assert sharded._E == plain._E > 8
    assert (sharded.counters["grow_e_events"]
            == plain.counters["grow_e_events"])
    want = state_to_numpy(plain._state)
    got = gather_state([sh._state for sh in sharded.shards])
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for h in (hs, child_s):
        _stats_equal(sharded.stats(h, truth[:39]), plain.stats(h, truth[:39]))
        np.testing.assert_array_equal(sharded.finalized_eds(h, truth[:39]),
                                      plain.finalized_eds(h, truth[:39]))


def test_store_geometry_is_one_across_shards():
    """Shards built from subsets of the reads share the store's symbol
    table (a shard holding no wildcard still counts its column), ``L``,
    ``C``, ``E`` and exactly ``R / n`` rows; the padding rows are
    inactive; 3 shards pad 16 rows to 18."""
    reads = [b"ACGTN" * 3] + [b"ACGT" * 4] * 4
    cfg = _cfg(wildcard=ord("N"))
    st = ShardedScorer(reads, cfg, ["cpu"] * 3)
    assert st._R == 18 and [sh._R for sh in st.shards] == [6, 6, 6]
    for sh in st.shards:
        assert list(sh.symtab) == list(st.symtab) == list(b"ACGNT")
        assert sh._wc == st.sym_id[ord("N")]
        assert (sh._L, sh._C, sh._E) == (256, 512, 8)
    h = st.root(np.ones(5, bool))
    assert st._act_host[st._slot(h)].tolist() == [True] * 5 + [False] * 13
    assert st.stats(h, b"").occ.shape == (5, 5)


# ------------------------------------------------------------ engines


def _key(res):
    if hasattr(res, "consensuses"):
        return ([[(c.sequence, list(c.scores)) for c in chain]
                 for chain in res.consensuses], list(res.sequence_indices))
    if res and hasattr(res[0], "consensus1"):
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        return [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [(c.sequence, list(c.scores)) for c in res]


def _engine(pkg, kind, backend, data, **kw):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    eng = {"single": pkg.ConsensusDWFA, "dual": pkg.DualConsensusDWFA,
           "priority": pkg.PriorityConsensusDWFA}[kind](b.build())
    for item in data:
        if kind == "priority":
            eng.add_sequence_chain(item)
        elif isinstance(item, tuple):
            eng.add_sequence_offset(*item)
        else:
            eng.add_sequence(item)
    return eng


def _result(pkg, kind, backend, data, **kw):
    eng = _engine(pkg, kind, backend, data, **kw)
    return _key(eng.consensus()), eng


_PRIORITY_CHAINS = [
    [b"ACGTACGT", b"ACGTACGTTT"],
    [b"ACGTACGT", b"ACGTACGTTT"],
    [b"ACGTACGT", b"ACTTACGTAA"],
    [b"ACGTACGT", b"ACTTACGTAA"],
] * 2

#: name -> (engine, draw, min_count): ``tests/test_parallel.py``'s draws
#: and ``__graft_entry__.py``'s dryrun's single draw (its dual and
#: priority draws are ``test_parallel.py``'s)
DRAWS = {
    "parallel_single": ("single",
                        lambda: generate_test(4, 60, 8, 0.02, seed=11)[1], 2),
    "dryrun_single": ("single",
                      lambda: generate_test(4, 50, 8, 0.02, seed=7)[1], 2),
    "dual": ("dual", lambda: [b"ACGTACGT", b"ACGTACGT", b"AGGTACGT",
                              b"AGGTACGT"] * 2, 1),
    "priority": ("priority", lambda: _PRIORITY_CHAINS, 1),
}


@needs_devices(8)
@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_engines_sharded_match_jax_mesh_and_oracle(draw):
    kind, make, mc = DRAWS[draw]
    data = list(make())
    want, _ = _result(J, kind, "python", data, min_count=mc)
    got_j, _ = _result(J, kind, "jax", data, min_count=mc, mesh_shards=8)
    assert got_j == want
    constructions = len(events.get_events("scorer_sharded"))
    with use_device_set(CPU8):
        got, eng = _result(T, kind, "torch", data, min_count=mc,
                           mesh_shards=8)
    assert got == want
    assert len(events.get_events("scorer_sharded")) > constructions
    c = eng.last_search_stats["scorer_counters"]
    # the sharded store takes the run, dual-run and arena paths
    assert c["run_calls"] + c["run_dual_calls"] + c["arena_calls"] > 0
    assert not any(k.startswith("plan_refused") for k in c)
    if kind == "priority":
        assert len(got[0]) == 2


def _late_draw():
    """20 reads x 300 bp at 2 %, every 4th cut at 60-120 and added with
    its offset; no ``initial_band``, so the band grows."""
    _, reads = generate_test(4, 300, 20, 0.02, seed=31)
    rng = np.random.default_rng(31)
    out = []
    for i, r in enumerate(reads):
        if i % 4 == 3:
            s = int(rng.integers(60, 120))
            out.append((r[s:], s))
        else:
            out.append(r)
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_late_reads_and_band_growth_sharded(shards):
    data = _late_draw()
    want, _ = _result(J, "single", "python", data, min_count=3)
    plain, eng_p = _result(T, "single", "torch", data, min_count=3)
    assert plain == want
    with use_device_set(DeviceSet("cpu", ("cpu",) * shards)):
        got, eng = _result(T, "single", "torch", data, min_count=3,
                           mesh_shards=shards)
    assert got == want
    c = eng.last_search_stats["scorer_counters"]
    cp = eng_p.last_search_stats["scorer_counters"]
    assert c["grow_e_events"] >= 1
    assert c["activate_calls"] == cp["activate_calls"] >= 5
    assert c["offset_scan_calls"] == cp["offset_scan_calls"] >= 1


def test_one_shard_overflow_draw_single_engine(monkeypatch):
    """The store's shards placed as on two cards (the run paths refused,
    so every pop expands through the branch step and one shard's
    overflow rolls the others back)."""
    truth, reads = _overflow_draw()
    want, _ = _result(J, "single", "python", reads, min_count=4)
    monkeypatch.setattr(sharded_scorer, "placement",
                        lambda devices: "cross_card")
    with use_device_set(DeviceSet("cpu2", ("cpu", "cpu"))):
        got, eng = _result(T, "single", "torch", reads, min_count=4,
                           mesh_shards=2)
    assert got == want
    assert got[0][0] == truth
    c = eng.last_search_stats["scorer_counters"]
    assert c["shard_overflow_rollbacks"] >= 1
    assert c["plan_refused_cross_card"] >= 1 and c["run_calls"] == 0


def test_supervised_sharded_search_demotes_on_device_loss(monkeypatch):
    """Device loss at the middle store call of the run, dual-run, arena
    and ``clone_push`` kinds and its two retries demote the sharded store
    to native once, mid-search; the result is the unsupervised sharded
    search's, and the search leaves the sharded store's run paths with
    the demotion."""
    _, reads = generate_test(4, 90, 6, 0.08, seed=1)
    data = list(reads)
    with use_device_set(DeviceSet("cpu4", ("cpu",) * 4)):
        want, _ = _result(T, "single", "torch", data, min_count=3,
                          mesh_shards=4)
        seen = []
        orig = supervisor.BackendSupervisor._supervised

        def spy(self, op, involved, call, **kw):
            seen.append((op, self._dispatch_index))
            return orig(self, op, involved, call, **kw)

        kw = dict(min_count=3, mesh_shards=4, supervised=True,
                  retry_backoff_s=0.0)
        with monkeypatch.context() as m:
            m.setattr(supervisor.BackendSupervisor, "_supervised", spy)
            assert _result(T, "single", "torch", data, **kw)[0] == want
        hits = [i for op, i in seen
                if op in ("clone_push", "run", "arena")]
        assert len(hits) >= 2
        at = hits[len(hits) // 2]
        events.clear_events()
        plan = faults.install(faults.FaultPlan())
        for k in range(3):
            plan.add("device_loss", backend="torch", at=at + k, count=None)
        sharded_runs = []  # per sharded run call: demoted already?
        for mod, name in ((run_kernel, "run_extend_shards_plain"),
                          (arena_kernel, "arena_shards_plain")):
            def spy_run(*a, _fn=getattr(mod, name), **k):
                sharded_runs.append(
                    bool(events.get_events("backend_demoted")))
                return _fn(*a, **k)

            monkeypatch.setattr(mod, name, spy_run)
        got, eng = _result(T, "single", "torch", data, **kw)
    assert got == want
    demoted = [(d["from_backend"], d["to_backend"])
               for d in events.get_events("backend_demoted")]
    assert demoted == [("torch", "native")]
    assert eng.last_search_stats["backend"] == "native"
    # sharded runs before the demotion, none after it
    assert sharded_runs and not any(sharded_runs)


def test_checkpoint_resume_of_a_sharded_search():
    # 6 % error: the search stops its runs often enough to be preempted
    # half way (at 3 % it is two pops)
    _, reads = generate_test(4, 120, 8, 0.06, seed=7)
    data = list(reads)
    with use_device_set(DeviceSet("cpu4", ("cpu",) * 4)):
        make = lambda: _engine(T, "single", "torch", data, min_count=2,  # noqa: E731
                               mesh_shards=4)
        ctrl = tck.CheckpointController()
        with tck.installed(ctrl):
            want = _key(make().consensus())
        polls = ctrl._polls
        assert polls > 4
        ctrl = tck.CheckpointController(snapshot_at_pops={polls // 2},
                                        preempt=True)
        with pytest.raises(tck.SearchPreempted) as stop:
            with tck.installed(ctrl):
                make().consensus()
        text = stop.value.checkpoint.to_json()
        resumed = tck.resume_engine(tck.SearchCheckpoint.from_json(text))
        got = _key(resumed.consensus())
    assert got == want
    assert got == _result(J, "single", "python", data, min_count=2)[0]


# ----------------------------------------------------- device topology


def test_probe_device_count_caches_the_probe(monkeypatch):
    tmesh.reset_probe_cache()
    calls = []
    real = torch.cuda.device_count

    def counting():
        calls.append(1)
        return real()

    monkeypatch.setattr(torch.cuda, "device_count", counting)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        n1 = tmesh.probe_device_count("cuda")
        n2 = tmesh.probe_device_count("cuda")
        assert tmesh.probe_device_count("cpu") == 1
    finally:
        tmesh.reset_probe_cache()
    assert n1 == n2 == real()
    assert len(calls) == 1


def test_device_slices_partitions_disjointly():
    devs = [f"dev{i}" for i in range(8)]
    slices = device_slices(3, devices=devs, name_prefix="rep")
    assert [s.name for s in slices] == ["rep0", "rep1", "rep2"]
    assert [len(s) for s in slices] == [3, 3, 2]
    assert [d for s in slices for d in s.devices] == devs


def test_device_slices_round_robin_when_oversubscribed():
    slices = device_slices(4, devices=["dev0", "dev1"])
    assert [s.devices for s in slices] == [
        ("dev0",), ("dev1",), ("dev0",), ("dev1",),
    ]
    with pytest.raises(ValueError, match="n_slices"):
        device_slices(0, devices=["dev0"])


def test_device_set_rejects_empty():
    with pytest.raises(ValueError, match="empty"):
        DeviceSet("none", ())


def test_use_device_set_is_nested_and_thread_scoped():
    import threading

    outer = DeviceSet("outer", ("cpu",))
    inner = DeviceSet("inner", ("cpu", "cpu"))
    assert current_device_set() is None
    with use_device_set(outer):
        assert current_device_set() is outer
        with use_device_set(inner):
            assert current_device_set() is inner
        assert current_device_set() is outer
        seen = []
        t = threading.Thread(target=lambda: seen.append(current_device_set()))
        t.start()
        t.join()
    assert seen == [None]
    assert current_device_set() is None


def test_make_mesh_draws_from_pinned_device_set():
    pinned = DeviceSet("pin", ("cpu",) * 2)
    with use_device_set(pinned):
        assert make_mesh().size == 2
        # an explicit devices argument overrides the thread pin
        assert make_mesh(devices=["cpu"] * 4).size == 4
        with pytest.raises(ValueError, match="only 2 available"):
            make_mesh(3)
    assert make_mesh(device_type="cpu").devices == (torch.device("cpu"),)
    m = make_mesh(devices=["cpu"] * 4, shape=(1, 4),
                  axis_names=("branch", "read"))
    assert m.shape == {"branch": 1, "read": 4}
    with pytest.raises(ValueError, match="no axis 'read'"):
        tmesh.shard_scorer(None, make_mesh(devices=["cpu"] * 2,
                                           axis_names=("data",)))


def test_shard_for_config_fails_fast_without_touching_the_scorer():
    cfg = _cfg(mesh_shards=4)
    with use_device_set(DeviceSet("tiny", ("cpu", "cpu"))):
        # reads=None: the availability check runs before anything is built
        with pytest.raises(ValueError, match="exceeds the 2 available"):
            shard_for_config(None, cfg)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        shard_for_config(None, cfg)  # the CPU counts one device
    assert shard_for_config(None, _cfg()) is None
    with use_device_set(DeviceSet("four", ("cpu",) * 4)):
        store = shard_for_config([b"ACGT"] * 5, cfg)
    assert isinstance(store, ShardedScorer) and len(store.shards) == 4
    ev = events.get_events("scorer_sharded")[-1]
    assert (ev["axis"], ev["shards"], ev["reads"]) == ("read", 4, 16)


def test_config_validation():
    with pytest.raises(ValueError, match="requires the torch backend"):
        T.CdwfaConfigBuilder().backend("native").mesh_shards(2).build()
    with pytest.raises(ValueError, match="requires the torch backend"):
        T.CdwfaConfigBuilder().backend("python").mesh_shards(2).build()
    with pytest.raises(ValueError, match=">= 0"):
        T.CdwfaConfigBuilder().mesh_shards(-1).build()
    assert T.CdwfaConfigBuilder().build().mesh_shards == 0
    assert T.CdwfaConfigBuilder().mesh_shards(4).build().mesh_shards == 4
