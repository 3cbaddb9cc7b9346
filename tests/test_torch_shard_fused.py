"""The fused step of a read-sharded store against the JAX package: the
shards of one device in one call (``ops/branch_kernel.py``'s
``advance_shards`` and kin, ``ops/sharded_scorer.py``'s routes,
``parallel/mesh.py``'s ``sharded_col_step``).

* The fused step's twin (every shard's ``advance_plain`` under the
  all-or-nothing rule, the partials summed) through ``sharded_col_step``
  with the CPU shards grouped as a card's are (``cpu_grouped``) at 1, 2,
  4 and 8 ``"cpu"`` shards against JAX's ``sharded_col_step`` on as many
  virtual XLA devices (root ``conftest.py``): ``tests/test_parallel.py``'s
  problem, a state with inactive reads, offsets and early termination,
  and a step in which one read of the last shard reaches the band; all
  nine outputs equal, tolerance 0, one twin call a step.
* The twin at E = 8 without ``force``: no shard commits when one read of
  one shard overflows; a step that does not overflow commits on every
  shard what the unsharded store commits.
* The sharded store with its CPU shards in one group, call by call,
  against the unsharded ``TorchScorer`` through pushes where only the
  last shard's read overflows: no host rollback, the same growths, the
  same stats and state; and the single and priority engines with
  ``mesh_shards(4)`` so grouped against JAX ``"jax"`` with
  ``mesh_shards(4)``.
* The route: ``shard_groups`` puts the shards of each CUDA device in one
  group (one launch a card), leaves a CPU shard alone, makes every shard
  a group of one under ``"per_shard"``, and refuses a group past
  ``MAX_SHARDS``; the fused call's plan counts every (row, shard, read)
  warp.
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
from waffle_con_tpu_torch.ops import branch_kernel as bk
from waffle_con_tpu_torch.ops import run_kernel as rk
from waffle_con_tpu_torch.ops import sharded_scorer as ss
from waffle_con_tpu_torch.ops.state_io import (
    gather_reads,
    gather_state,
    split_reads,
    state_to_numpy,
)
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.parallel import (
    DeviceSet,
    make_mesh,
    sharded_col_step,
    use_device_set,
)
from waffle_con_tpu_torch.parallel import mesh as tmesh
from waffle_con_tpu_torch.runtime import events, faults
from waffle_con_tpu_torch.utils.example_gen import generate_test

SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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


@pytest.fixture
def cpu_grouped(monkeypatch):
    """The CPU's shards grouped by device, as a card's are, so the host
    side of a group of several shards runs here (on their twin)."""
    monkeypatch.setattr(ss, "_fuses", lambda device: True)


# ------------------------------------------------ the sharded column step


def _fresh(reads, rlen, off, act, W, C=64):
    E = jnp.int32((W - 2) // 2)
    D, e, rmin, er = _init_col(jnp.asarray(off), jnp.asarray(act),
                               jnp.asarray(rlen), E, W)
    st = dict(D=D, e=e, rmin=rmin, er=er, off=off, act=act,
              cons=np.zeros((C,), dtype=np.int32), clen=np.int32(0))
    return reads, rlen, {k: np.asarray(v) for k, v in st.items()}


def _jax_step(st, reads, rlen, sym, et=False):
    """One unsharded JAX column step and its overflow flag."""
    W = st["D"].shape[1]
    E = jnp.int32((W - 2) // 2)
    cons = jnp.asarray(st["cons"])
    clen = jnp.int32(st["clen"])
    act = jnp.asarray(st["act"])
    D2, e2, rmin2, er2 = _col_step(
        jnp.asarray(st["D"]), jnp.asarray(st["e"]), jnp.asarray(st["rmin"]),
        jnp.asarray(st["er"]), jnp.asarray(st["off"]), act,
        jnp.asarray(rlen), jnp.asarray(reads), clen + 1, jnp.int32(sym),
        jnp.int32(-2), jnp.bool_(et), E,
    )
    new = dict(st, D=np.asarray(D2), e=np.asarray(e2), rmin=np.asarray(rmin2),
               er=np.asarray(er2),
               cons=np.asarray(cons.at[jnp.clip(clen, 0, cons.shape[0] - 1)]
                               .set(sym)),
               clen=np.int32(clen + 1))
    return new, bool((act & (e2 >= E)).any())


def _case_plain():
    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, size=(16, 24)).astype(np.int32)
    return _fresh(reads, np.full(16, 24, np.int32), np.zeros(16, np.int32),
                  np.ones(16, bool), 18) + (2, False)


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
    for y in reads[0, :5]:
        st, _ = _jax_step(st, reads, rlen, int(y), et=True)
    return reads, rlen, st, 1, True


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
    reads, rlen, st = _fresh(reads, np.full(16, 40, np.int32),
                             np.zeros(16, np.int32), np.ones(16, bool), 18)
    for j in range(40):
        nxt, overflow = _jax_step(st, reads, rlen, int(truth[j]))
        if overflow:
            assert (nxt["e"][:15] < 8).all()  # only the last shard's read
            return reads, rlen, st, int(truth[j]), False
        st = nxt
    raise AssertionError("the draw never overflows")


CASES = {"plain": _case_plain, "offsets": _case_offsets,
         "overflow": _case_overflow}
FIELDS = ("D", "e", "rmin", "er", "off", "act")


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_col_step_matches_jax(case, shards, cpu_grouped):
    reads, rlen, st, sym, et = CASES[case]()
    jstep = jsharded_col_step(jmake_mesh(shards, axis_names=("read",)))
    want = jstep(*(jnp.asarray(st[k]) for k in FIELDS + ("cons",)),
                 jnp.int32(st["clen"]), jnp.asarray(reads),
                 jnp.asarray(rlen), jnp.int32(sym), jnp.int32(-2),
                 jnp.bool_(et))
    mesh = make_mesh(devices=["cpu"] * shards)
    step = sharded_col_step(mesh)
    devs = mesh.devices
    inputs = {k: [t.clone() for t in split_reads(st[k], devs)]
              for k in FIELDS}
    twin, one = bk.advance_shards_plain.calls, bk.advance_plain.calls
    got = step(*(inputs[k] for k in FIELDS), torch.tensor(st["cons"]),
               int(st["clen"]), split_reads(reads.astype(np.int16), devs),
               split_reads(rlen, devs), sym, -2, et)
    # one call of the fused twin for every shard, none a shard alone
    assert bk.advance_shards_plain.calls == twin + 1
    assert bk.advance_plain.calls == one
    for name, g, w in zip(("D", "e", "rmin", "er", "occ", "split"), got[:6],
                          want[:6]):
        g = gather_reads(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[6]) == int(want[6])
    assert bool(got[7]) == bool(want[7])
    assert bool(got[8]) == bool(want[8]) == (case == "overflow")
    for k, parts in inputs.items():  # the caller's inputs, untouched
        np.testing.assert_array_equal(gather_reads(parts), st[k])


def _one_slot_shards(st, reads, rlen, shards):
    """The JAX-layout one-branch state ``st`` as ``shards`` one-slot
    stores on the CPU, with each shard's reads and rlen."""
    per = {k: split_reads(st[k], ["cpu"] * shards) for k in FIELDS}
    states = []
    for i in range(shards):
        s = {k: per[k][i].clone()[None] for k in FIELDS}
        s["cons"] = torch.tensor(st["cons"])[None].clone()
        s["clen"] = torch.tensor([int(st["clen"])], dtype=torch.int32)
        states.append(s)
    return (states, split_reads(reads.astype(np.int16), ["cpu"] * shards),
            split_reads(rlen, ["cpu"] * shards))


def _whole(st, reads, rlen):
    s = {k: torch.tensor(st[k])[None].clone() for k in FIELDS + ("cons",)}
    s["clen"] = torch.tensor([int(st["clen"])], dtype=torch.int32)
    return (s, torch.as_tensor(reads.astype(np.int16)),
            torch.as_tensor(rlen))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_fused_twin_commits_on_no_shard_at_e8(shards):
    """An E = 8 step where one read of the last shard reaches the band:
    the stats are the unsharded step's, the overflow is set and no shard
    commits; the partials are the shards' summed.  The column before it
    commits on every shard what the unsharded store commits."""
    reads, rlen, st, sym, et = _case_overflow()
    states, rd, rl = _one_slot_shards(st, reads, rlen, shards)
    before = [{k: v.clone() for k, v in s.items()} for s in states]
    whole, wrd, wrl = _whole(st, reads, rlen)
    want = bk.advance_plain(whole, [[0], [0], [sym]], wrd, wrl, -2, et, 32)
    got = bk.advance_shards_plain(states, [[0], [0], [sym]], rd, rl, -2, et,
                                  32)
    assert want.overflow and got.overflow
    for name in ("eds", "occ", "split", "reached", "fin", "fin_ok"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for s, b in zip(states, before):
        for k in s:
            assert torch.equal(s[k], b[k]), k
    # the partials: each shard's step alone (on copies), summed in order
    parts = [ss.partials_plain(bk.advance_shards_plain(
        [{k: v.clone() for k, v in s.items()}], [[0], [0], [sym]], [r], [q],
        -2, et, 32), "cpu") for s, r, q in zip(states, rd, rl)]
    total, reached, overflow = ss.reduce_partials(parts, "cpu")
    assert [int(x) for x in ss.partials_plain(got, "cpu")] == [
        int(total), int(reached), int(overflow)]
    assert bool(overflow) and int(total) == int(want.eds.sum())
    # the column before commits on every shard
    reads, rlen, st0, _s, _e = _case_overflow()
    prev = int(reads[0, int(st0["clen"])])
    states, rd, rl = _one_slot_shards(st0, reads, rlen, shards)
    whole, wrd, wrl = _whole(st0, reads, rlen)
    bk.advance_plain(whole, [[0], [0], [prev]], wrd, wrl, -2, False, 32)
    out = bk.advance_shards_plain(states, [[0], [0], [prev]], rd, rl, -2,
                                  False, 32)
    gathered = gather_state(states)
    for k, v in state_to_numpy(whole).items():
        np.testing.assert_array_equal(gathered[k], v, err_msg=k)
    assert out.eds.shape == (1, 16)


# ------------------------------------------------------ the sharded store


def _overflow_draw(n=16, length=60, seed=21):
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


@pytest.mark.parametrize("shards", [2, 4])
def test_store_fused_route_commits_all_or_nothing(shards, cpu_grouped):
    """The store with one group: every push a fused call of all the
    shards; when the last shard's random read reaches the band nothing
    commits anywhere, so no shard goes back (no host rollback), the band
    grows and the step is retried: stats and every store field equal the
    unsharded store's after each push."""
    truth, reads = _overflow_draw()
    cfg = _cfg()
    sharded = ss.ShardedScorer(reads, cfg, ["cpu"] * shards)
    assert [ks for _d, ks in sharded.groups] == [list(range(shards))]
    plain = TorchScorer(reads, cfg)
    hs, hp = sharded.root(np.ones(16, bool)), plain.root(np.ones(16, bool))
    child_s = sharded.clone_many([hs])[0]
    child_p = plain.clone_many([hp])[0]
    one = bk.advance_plain.calls
    fused = bk.advance_shards_plain.calls
    for j in range(1, 40):
        cons = truth[:j]
        spec = lambda h, c: [(h, cons, True), (c, None if j % 2 else cons,  # noqa: E731
                                               True)]
        got = sharded.clone_push_many(spec(hs, child_s))
        want = plain.clone_push_many(spec(hp, child_p))
        for (h1, s1), (h2, s2) in zip(got, want):
            assert h1 == h2
            assert (s1 is None) == (s2 is None)
            if s1 is not None:
                _stats_equal(s1, s2)
    assert bk.advance_plain.calls - one == plain.counters["grow_e_events"] + 39
    assert bk.advance_shards_plain.calls - fused == (
        sharded.counters["grow_e_events"] + 39)
    assert sharded.counters["shard_overflow_rollbacks"] == 0
    assert sharded.counters["grow_e_events"] == plain.counters[
        "grow_e_events"] >= 1
    want = state_to_numpy(plain._state)
    got = gather_state([sh._state for sh in sharded.shards])
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for h, g in ((hs, hp), (child_s, child_p)):
        _stats_equal(sharded.stats(h, truth[:39]), plain.stats(g, truth[:39]))
        np.testing.assert_array_equal(sharded.finalized_eds(h, truth[:39]),
                                      plain.finalized_eds(g, truth[:39]))


_CHAINS = [
    [b"ACGTACGT", b"ACGTACGTTT"],
    [b"ACGTACGT", b"ACGTACGTTT"],
    [b"ACGTACGT", b"ACTTACGTAA"],
    [b"ACGTACGT", b"ACTTACGTAA"],
] * 2

DRAWS = {
    "single": ("single", lambda: generate_test(4, 60, 8, 0.02, seed=11)[1],
               2),
    "overflow": ("single", lambda: _overflow_draw()[1], 4),
    "priority": ("priority", lambda: _CHAINS, 1),
}


def _key(res):
    if hasattr(res, "consensuses"):
        return ([[(c.sequence, list(c.scores)) for c in chain]
                 for chain in res.consensuses], list(res.sequence_indices))
    return [(c.sequence, list(c.scores)) for c in res]


def _run(pkg, kind, backend, data, **kw):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T:
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    eng = {"single": pkg.ConsensusDWFA,
           "priority": pkg.PriorityConsensusDWFA}[kind](b.build())
    for item in data:
        if kind == "priority":
            eng.add_sequence_chain(item)
        else:
            eng.add_sequence(item)
    return _key(eng.consensus()), eng


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_search_on_fused_route_matches_jax_mesh(draw, monkeypatch,
                                                cpu_grouped):
    """The engines on 4 ``"cpu"`` shards, every store call fused, against
    JAX ``"jax"`` with ``mesh_shards(4)`` and the ``"python"`` oracle."""
    kind, make, mc = DRAWS[draw]
    data = list(make())
    want, _ = _run(J, kind, "python", data, min_count=mc)
    got_j, _ = _run(J, kind, "jax", data, min_count=mc, mesh_shards=4)
    assert got_j == want
    built = []

    def fused_store(reads, config, devices):
        built.append(ss.ShardedScorer(reads, config, devices))
        return built[-1]

    monkeypatch.setattr(tmesh, "ShardedScorer", fused_store)
    one = bk.advance_plain.calls
    # the store's pushes: fused branch steps, or inside its sharded runs
    fused = bk.advance_shards_plain.calls + rk.run_extend_shards_plain.calls
    with use_device_set(DeviceSet("cpu4", ("cpu",) * 4)):
        got, eng = _run(T, kind, "torch", data, min_count=mc, mesh_shards=4)
    assert got == want
    assert built and all(len(st.groups) == 1 for st in built)
    assert bk.advance_plain.calls == one
    assert (bk.advance_shards_plain.calls
            + rk.run_extend_shards_plain.calls) > fused
    c = eng.last_search_stats["scorer_counters"]
    assert not c.get("shard_overflow_rollbacks")
    if draw == "overflow":
        assert c["grow_e_events"] >= 1


# ---------------------------------------------------------------- route


def test_shard_groups_by_device(monkeypatch):
    cards = ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    groups = ss.shard_groups(cards)
    assert [(str(d), ks) for d, ks in groups] == [("cuda:0", [0, 2]),
                                                  ("cuda:1", [1, 3])]
    assert [ks for _d, ks in ss.shard_groups(["cuda:0"] * 4)] == [
        [0, 1, 2, 3]]
    assert [ks for _d, ks in ss.shard_groups(cards, "per_shard")] == [
        [0], [1], [2], [3]]
    # a CPU shard runs its twin alone
    assert [ks for _d, ks in ss.shard_groups(["cpu"] * 3)] == [[0], [1], [2]]
    assert [ks for _d, ks in ss.shard_groups(["cpu", "cuda:0", "cpu"])] == [
        [0], [1], [2]]
    with pytest.raises(ValueError, match="at most"):
        ss.shard_groups(["cuda:0"] * (bk.MAX_SHARDS + 1))
    ss.shard_groups(["cpu"] * (bk.MAX_SHARDS + 1))
    ss.shard_groups(["cuda:0"] * (bk.MAX_SHARDS + 1), "per_shard")
    for route in ("sideways", "fused"):
        with pytest.raises(ValueError, match="route"):
            ss.shard_groups(cards, route)
    # grouped by device wherever the rule groups
    monkeypatch.setattr(ss, "_fuses", lambda device: True)
    assert [ks for _d, ks in ss.shard_groups(["cpu"] * 3)] == [[0, 1, 2]]
    assert [ks for _d, ks in ss.shard_groups(["cpu", "cuda:0", "cpu"])] == [
        [0, 2], [1]]
    with pytest.raises(ValueError, match="at most"):
        ss.shard_groups(["cpu"] * (bk.MAX_SHARDS + 1))


def test_fused_plan_counts_every_shard_warp():
    """A fused call of S shards of R reads plans n x S x R warps, and its
    scratch holds every shard's staged consensus rows."""
    for n, S, R, W in [(1, 4, 64, 514), (3, 8, 32, 130), (1, 1, 256, 514)]:
        plan = bk.plan_branch(n, S * R, W, 4, 132, 2)
        assert plan.name == "one_launch"
        assert plan.blocks == -(-n * S * R // bk.ONE_WARPS)
        assert bk.scratch_words(plan, n, S * R, W, 512, S) == S * n * 512
    slab = bk.plan_branch(2, 4 * 64, 2050, 4, 132, 2)
    assert slab.name == "slab"
    assert bk.scratch_words(slab, 2, 256, 2050, 512, 4) == (
        2 * 256 * 2050 + 5 * 2 * 256 + 4 * (2 * 512 + 2))
    assert bk.slab_words(2, 256, 2050, 512) == bk.slab_words(
        2, 256, 2050, 512, 1)


def test_fused_twin_refuses_mixed_geometry():
    reads, rlen, st, sym, _et = _case_plain()
    states, rd, rl = _one_slot_shards(st, reads, rlen, 2)
    states[1]["D"] = torch.cat([states[1]["D"]] * 2, dim=2)
    with pytest.raises(ValueError, match="geometry"):
        bk.advance_shards_plain(states, [[0], [0], [sym]], rd, rl, -2,
                                False, 32)


def test_jax_devices_for_the_mesh():
    assert len(jax.devices()) >= 8
