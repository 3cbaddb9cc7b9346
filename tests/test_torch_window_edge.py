"""Read position -1: how the port reads it, and that no engine reaches it.

A band cell faces read position ``i = j - off - E + t``.  A column step
compares the pushed symbol with the read's symbol at ``i - 1``, so the
cell facing ``i = 0`` reads position -1.  JAX reads it two ways: clipped
to ``reads[r, 0]`` on the branch path (``_col_step``, ``_stats_core``)
and in runs whose active offsets differ, and as the ``-1`` filler of its
padded reads in runs whose active offsets are all equal
(``_col_step_u``).  The port's plain twins always clip.  The two readings
differ only where that cell is finite, which takes a read anchored past
its branch's length and then stepped.

``test_read_anchored_past_its_branch`` builds that state through the
scorer seam (8 reads, W=18) and compares the port's ``"torch"`` scorer
with JAX's ``"jax"`` call for call: every branch-path call and every run
with mixed offsets is equal; a run or dual run with uniform offsets
differs by one in the distances of the reads anchored past the branch,
and nowhere else.  The ``"python"`` oracle refuses to anchor a read
there.  ``test_engines_never_step_a_read_before_its_anchor`` wraps the
scorer of the engines' late-read draws and a resumed search and checks
after every call that no active read of a live branch is anchored past
its branch's length, so no engine call can reach that state.
"""

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.ops.scorer import make_scorer as jax_make_scorer
from waffle_con_tpu_torch.models import checkpoint as ckpt
from waffle_con_tpu_torch.ops.scorer import make_scorer
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import (
    corrupt,
    generate_priority_test,
    generate_test,
)

#: the branch's length, and the anchor of the reads placed past it
CLEN, ANCHOR = 20, 25
#: the reads anchored past the branch (6 only in the uniform scenario)
LATE = (6, 7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw():
    """8 reads of an 80-symbol truth, two substitutions each; read 7
    starts at truth[22], three symbols past the anchor's 25 - 20."""
    rng = np.random.default_rng(3)
    truth = bytes(rng.choice(list(b"ACGT"), 80).tolist())
    reads = []
    for _ in range(8):
        r = bytearray(truth)
        for p in rng.choice(80, 2, replace=False):
            r[p] = b"ACGT"[(b"ACGT".index(r[p]) + 1) % 4]
        reads.append(bytes(r))
    reads[7] = truth[22:]
    return truth, reads


def _scorer(backend, reads):
    if backend == "jax":
        return jax_make_scorer(
            reads, J.CdwfaConfigBuilder().backend("jax").min_count(2).build())
    b = T.CdwfaConfigBuilder().backend(backend).min_count(2)
    if backend == "torch":
        b = b.device("cpu")
    return make_scorer(reads, b.build())


def _stats(s):
    return None if s is None else dict(
        eds=s.eds.tolist(), occ=s.occ.tolist(), split=s.split.tolist(),
        reached=s.reached.tolist(),
        fin=None if s.fin is None else s.fin.tolist())


def _scenario(sc, truth, uniform):
    """Root (reads 0-5 active, or none for ``uniform``), push the truth to
    CLEN columns, anchor read 7 (and read 6 for ``uniform``) at ANCHOR,
    then stats, a clone, pushes of the symbol read 7 starts with, a run
    forced to push that symbol first, and a dual run.  Returns ``[(call,
    result)]``."""
    log = []
    act = np.zeros(8, dtype=bool)
    act[:6] = not uniform
    h = sc.root(act)
    for k in range(1, CLEN + 1):
        sc.push_many([(h, truth[:k])])
    cons = truth[:CLEN]
    sc.activate(h, 7, ANCHOR, cons)
    if uniform:
        sc.activate(h, 6, ANCHOR, cons)
    log.append(("stats", _stats(sc.stats(h, cons))))
    h2 = sc.clone(h)
    for k in range(1, 6):
        c = cons + truth[22:22 + k]
        log.append((f"push{k}", [_stats(s) for s in sc.push_many([(h, c)])]))
    log.append(("stats_pushed", _stats(sc.stats(h, c))))
    steps, code, app, st, recs = sc.run_extend(
        h2, cons, 10**6, 10**6, 0, 2, False, 30,
        first_sym=sc.sym_id[truth[22]])
    log.append(("run", dict(steps=steps, code=code, app=app, stats=_stats(st),
                            recs=[(a, b.tolist()) for a, b in recs])))
    h3 = sc.clone(h2)
    c2 = cons + app
    d = sc.run_extend_dual(h2, h3, c2, c2, 10**6, 10**6, 0, 2, 1, 1, False,
                           False, 20)
    log.append(("dual", dict(steps=d[0], code=d[1], app=(d[2], d[3]),
                             stats=(_stats(d[4]), _stats(d[5])),
                             act=(d[6].tolist(), d[7].tolist()),
                             recs=len(d[8]))))
    return log


def _late_eds_less_one(got, want):
    """``got``'s stats with the LATE reads' distances raised by one."""
    def bump(s):
        s = dict(s)
        s["eds"] = [e + (r in LATE) for r, e in enumerate(s["eds"])]
        return s
    got = dict(got)
    got["stats"] = (bump(got["stats"]) if isinstance(got["stats"], dict)
                    else tuple(map(bump, got["stats"])))
    return got


@pytest.mark.parametrize("uniform", [False, True],
                         ids=["mixed_offsets", "uniform_offsets"])
def test_read_anchored_past_its_branch(uniform):
    truth, reads = _draw()
    want = _scenario(_scorer("jax", reads), truth, uniform)
    got = _scenario(_scorer("torch", reads), truth, uniform)
    assert [name for name, _ in got] == [name for name, _ in want]
    differs = []
    for (name, g), (_, w) in zip(got, want):
        if g != w:
            differs.append(name)
            # JAX's uniform-offset run reads the -1 filler there, one more
            # than the clipped symbol the port's twin compares
            assert _late_eds_less_one(g, w) == w, name
    assert differs == (["run", "dual"] if uniform else [])
    # the run really stepped the cell facing position -1 (its first
    # symbol is the one read 7 starts with) and left it finite
    run = dict(got)["run"]
    assert run["steps"] >= 1 and run["app"][:1] == truth[22:23]
    # the oracle refuses an anchor past the consensus
    with pytest.raises(AssertionError):
        _scenario(_scorer("python", reads), truth, uniform)


#: the scorer calls a search makes; each is checked after it returns
CALLS = ("root", "clone_many", "push_many", "clone_push_many", "stats",
         "activate", "deactivate_many", "finalized_eds", "run_extend",
         "run_extend_dual", "run_arena")


@pytest.fixture
def anchors(monkeypatch):
    """Wrap ``TorchScorer``'s calls: an activation's offset must lie in
    its consensus, and after every call no active read of a live branch
    may be anchored past its branch's length.  Yields the count of calls
    checked by name."""
    seen = dict.fromkeys(CALLS, 0)

    def check(name, fn):
        def wrapped(self, *args, **kwargs):
            if name == "activate":
                _h, _r, offset, consensus = args
                assert 0 <= offset <= len(consensus), (offset, len(consensus))
            out = fn(self, *args, **kwargs)
            slots = sorted(self._slot_of.values())
            st = self._state
            off, act = st["off"][slots], st["act"][slots]
            clen = st["clen"][slots]
            past = act & (off > clen[:, None])
            assert not bool(past.any()), (name, past.nonzero().tolist())
            seen[name] += 1
            return out
        return wrapped

    for name in CALLS:
        monkeypatch.setattr(TorchScorer, name,
                            check(name, getattr(TorchScorer, name)))
    yield seen


def _late(reads, seed, cut):
    rng = np.random.default_rng(seed)
    return [(r[int(s):], int(s)) if i % 4 == 3 else (r, None)
            for i, (r, s) in enumerate(zip(reads, rng.integers(*cut,
                                                               len(reads))))]


def _engine(kind, **cfg):
    b = T.CdwfaConfigBuilder().backend("torch").device("cpu")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    return getattr(T, kind)(b.build())


def _single():
    _truth, reads = generate_test(4, 300, 16, 0.02, seed=71)
    eng = _engine("ConsensusDWFA", min_count=4)
    for r, off in _late(reads, 7, (80, 160)):
        eng.add_sequence(r) if off is None else eng.add_sequence_offset(r,
                                                                        off)
    return eng


def _dual():
    rng = np.random.default_rng(72)
    t1, reads1 = generate_test(4, 300, 6, 0.01, seed=72)
    t2 = bytearray(t1)
    for pos, shift in ((120, 1), (220, 2)):
        t2[pos] = (t2[pos] + shift) % 4
    reads = list(reads1) + [corrupt(bytes(t2), 0.01, rng) for _ in range(6)]
    eng = _engine("DualConsensusDWFA", min_count=3)
    for r, off in _late(reads, 7, (80, 160)):
        eng.add_sequence(r) if off is None else eng.add_sequence_offset(r,
                                                                        off)
    return eng


def _priority():
    _truth, (t1a, t1b), chains = generate_priority_test(
        4, 120, 0.01, (15, 16, 300))
    offsets = [[None, None] for _ in chains]
    for i, start in ((1, 30), (3, 25)):
        hap = t1a if i < 2 else t1b
        chains[i][1] = corrupt(hap[start:], 0.01,
                               np.random.default_rng(600 + i))
        offsets[i][1] = start
    eng = _engine("PriorityConsensusDWFA", min_count=2, initial_band=20)
    for i, chain in enumerate(chains):
        eng.add_seeded_sequence_chain(chain, offsets[i], i % 2)
    return eng


def _resumed():
    """The single late draw preempted at its first poll and resumed: the
    restore anchors every tracked read at its recorded offset."""
    ctrl = ckpt.CheckpointController(snapshot_at_pops={1}, preempt=True)
    eng = _single()
    with ckpt.installed(ctrl):
        with pytest.raises(ckpt.SearchPreempted) as stop:
            eng.consensus()
    text = stop.value.checkpoint.to_json()
    return ckpt.resume_engine(ckpt.SearchCheckpoint.from_json(text))


@pytest.mark.parametrize("make", [_single, _dual, _priority, _resumed],
                         ids=["single", "dual", "priority", "resumed"])
def test_engines_never_step_a_read_before_its_anchor(anchors, make):
    eng = make()
    eng.consensus()
    assert anchors["activate"] > 0, "the draw activated no read"
    assert anchors["push_many"] + anchors["run_extend"] > 0
