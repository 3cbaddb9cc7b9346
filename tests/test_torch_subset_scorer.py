"""``SubsetScorer`` over a shared ``TorchScorer``, call by call, against a
``TorchScorer`` over the group's reads alone and against the JAX
package's ``SubsetScorer`` over a ``JaxScorer`` (Pallas kernels in
interpret mode).

The shared store holds 21 reads: ten of one haplotype, ten of a second
two SNPs away, all cut short by 0-3 symbols so that runs absorb reached
reads as records, and one read of random symbols that carries a symbol
no group member has (so the view's symbol table is wider than the
group's).  Each group is a sorted, non-contiguous set of indices.  Root,
``clone_push_many``, ``push_many``, ``stats``, ``activate``,
``deactivate``, ``finalized_eds``, ``run_extend`` and ``run_extend_dual``
must give equal outputs; votes are compared per symbol byte, since the
per-group scorer's dense ids differ where its symbol table is narrower.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.ops.scorer import SubsetScorer as JaxSubsetScorer
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops.scorer import SubsetScorer, fast_paths
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

#: the two SNPs of the second haplotype
SNPS = ((40, 1), (90, 2))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: the test
    workers share the host's cores, and torch's default of one thread
    per core makes them wait on each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads():
    t1, reads1 = generate_test(4, 120, 10, 0.02, seed=71)
    t2 = bytearray(t1)
    for pos, shift in SNPS:
        t2[pos] = (t2[pos] + shift) % 4
    t2 = bytes(t2)
    rng = np.random.default_rng(72)
    reads = list(reads1) + [corrupt(t2, 0.02, rng) for _ in range(10)]
    reads = [r[: len(r) - (k % 4)] for k, r in enumerate(reads)]
    reads.append(bytes(rng.integers(0, 5, size=120).astype(np.uint8)))
    return t1, t2, reads


def _scorers(reads, idx):
    tcfg = (CdwfaConfigBuilder().backend("torch").device("cpu").min_count(3)
            .build())
    jcfg = JaxConfigBuilder().backend("jax").min_count(3).build()
    jbase = JaxScorer(reads, jcfg)
    jbase._pallas_mode = "interpret"
    return {
        "view": SubsetScorer(TorchScorer(reads, tcfg), idx),
        "group": TorchScorer([reads[i] for i in idx], tcfg),
        "jax_view": JaxSubsetScorer(jbase, idx),
    }


def _votes(sc, occ):
    """Per read, ``{symbol byte: tips}`` over the nonzero votes."""
    return [{int(sc.symtab[a]): int(row[a]) for a in np.flatnonzero(row)}
            for row in np.asarray(occ)]


def _stats(sc, s):
    return (s.eds.tolist(), _votes(sc, s.occ), s.split.tolist(),
            np.asarray(s.reached, dtype=bool).tolist(),
            None if s.fin is None else s.fin.tolist())


def _mask(a):
    return np.asarray(a, dtype=bool).tolist()


def _drive_branches(sc, t1):
    """Root (local read 2 late), expansion, batched pushes, a late
    activation, a deactivation and the finalized distances."""
    log = []
    n = sc.num_reads
    act = np.ones(n, dtype=bool)
    act[2] = False
    root = sc.root(act)
    log.append(_stats(sc, sc.stats(root, b"")))
    alt = bytes([(t1[0] + 1) % 4])
    out = sc.clone_push_many([(root, None, False), (root, alt, False),
                              (root, t1[:1], True)])
    log.append([None if s is None else _stats(sc, s) for _h, s in out])
    (c0, _), (c1, _), (h, _) = out
    for k in range(1, 30):
        log.append([_stats(sc, s) for s in sc.push_many(
            [(h, t1[: k + 1]), (c1, alt + t1[1: k + 1])])])
    sc.activate(h, 2, 5, t1[:30])
    log.append(_stats(sc, sc.stats(h, t1[:30])))
    sc.deactivate_many([(c1, 1), (c1, n - 1)])
    log.append(_stats(sc, sc.stats(c1, alt + t1[1:30])))
    log.append(sc.finalized_eds(h, t1[:30]).tolist())
    for hh in (c0, c1, h):
        sc.free(hh)
    return log


def _run_extend(sc):
    """One run from a fresh root of the whole group."""
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    steps, code, app, st, recs = sc.run_extend(
        h, b"", 2**31 - 1, 2**31 - 1, 0, 3, False, 400)
    sc.free(h)
    return (steps, code, app, _stats(sc, st),
            [(j, f.tolist()) for j, f in recs])


def _run_extend_dual(sc, t1, t2):
    """Both haplotypes pushed past the first SNP, then dual runs towards
    the reads' ends (pruning on the way), each haplotype's next symbol
    pushed wherever a run stops on an ambiguous column."""
    c1, c2 = t1[: SNPS[0][0] + 3], t2[: SNPS[0][0] + 3]
    n = sc.num_reads
    ha, hb = sc.root(np.ones(n, dtype=bool)), sc.root(np.ones(n, dtype=bool))
    for k in range(len(c1)):
        sc.push_many([(ha, t1[: k + 1]), (hb, t2[: k + 1])])
    runs = []
    for _ in range(4):
        out = sc.run_extend_dual(ha, hb, c1, c2, 2**31 - 1, 2**31 - 1, 0, 3,
                                 1, 2, False, False, 400)
        steps, code, app1, app2, st1, st2, act1, act2, recs = out
        runs.append((steps, code, app1, app2, _stats(sc, st1),
                     _stats(sc, st2), _mask(act1), _mask(act2),
                     [(j, f1.tolist(), f2.tolist(), _mask(a1), _mask(a2))
                      for j, f1, f2, a1, a2 in recs]))
        c1, c2 = c1 + app1, c2 + app2
        if code != 1 or len(c1) >= len(t1):
            break
        c1, c2 = c1 + t1[len(c1):len(c1) + 1], c2 + t2[len(c2):len(c2) + 1]
        sc.push_many([(ha, c1), (hb, c2)])
    sc.free(ha)
    sc.free(hb)
    return runs


@pytest.mark.parametrize("idx", [
    [0, 2, 5, 7, 9],
    [1, 3, 4, 8, 11, 12, 15, 19],
], ids=["one_haplotype", "both_haplotypes"])
def test_view_matches_group_scorer_and_jax_view(idx):
    t1, t2, reads = _reads()
    scorers = _scorers(reads, idx)
    seen = {}
    for name, sc in scorers.items():
        log = _drive_branches(sc, t1)
        log.append(_run_extend(sc))
        if len(idx) > 5:
            log.append(_run_extend_dual(sc, t1, t2))
        seen[name] = log
    assert seen["view"] == seen["group"]
    assert seen["view"] == seen["jax_view"]
    view = scorers["view"]
    run = seen["view"][-1]
    if len(idx) > 5:
        # the dual runs pruned reads to their haplotype
        assert len(run) > 1 and any(False in r[6] + r[7] for r in run)
        assert view.counters["run_dual_calls"] == len(run)
    else:
        assert run[4], "the run absorbed no records"
    assert view.counters["run_calls"] == 1
    assert view.base.live_handles() == 0
    # the wider symbol table of the view: the random read's fifth symbol
    assert view.num_symbols == 5 and scorers["group"].num_symbols == 4


def test_view_forwards_and_maps_indices():
    _t1, _t2, reads = _reads()
    cfg = CdwfaConfigBuilder().backend("torch").device("cpu").build()
    base = TorchScorer(reads, cfg)
    view = SubsetScorer(base, [3, 6, 17])
    assert view.reads == [reads[3], reads[6], reads[17]]
    assert view.symtab is base.symtab and view.sym_id is base.sym_id
    assert view.config is base.config and view.counters is base.counters
    h = view.root(np.array([True, False, True]))
    assert base._act_host[base._slot_of[h]].nonzero()[0].tolist() == [3, 17]
    view.activate(h, 1, 0, b"")
    assert base._act_host[base._slot_of[h]].nonzero()[0].tolist() == [3, 6, 17]
    view.deactivate(h, 0)
    assert base._act_host[base._slot_of[h]].nonzero()[0].tolist() == [6, 17]
    # handles are the base's
    h2 = view.clone(h)
    assert base.live_handles() == 2
    view.free(h)
    view.free(h2)
    assert base.live_handles() == 0
    fp = fast_paths(view)
    assert fp.run_extend is not None and fp.run_extend_dual is not None
    assert fp.clone_push_many is not None


def test_view_of_the_oracle_has_no_fast_paths():
    from waffle_con_tpu_torch.ops.scorer import PythonScorer

    cfg = CdwfaConfigBuilder().backend("python").build()
    view = SubsetScorer(PythonScorer([b"ACGT", b"ACGA", b"AGGT"], cfg), [0, 2])
    fp = fast_paths(view)
    assert (fp.run_extend, fp.run_extend_dual, fp.clone_push_many) == (
        None, None, None)
    h = view.root(np.array([True, True]))
    st = view.push(h, b"A")
    assert st.eds.tolist() == [0, 0]
    assert _votes(view, st.occ) == [{ord("C"): 1}, {ord("G"): 1}]


def test_dual_records_through_the_view():
    """A locked side 1 and a side 2 whose reads end one after another:
    the dual run absorbs records, each plane sliced to the group.  The
    members interleave with reads outside the group."""
    t1, reads1 = generate_test(4, 120, 6, 0.0, seed=73)
    t2 = bytearray(t1)
    t2[60] = (t2[60] + 1) % 4
    t2 = bytes(t2)
    rng = np.random.default_rng(74)
    group = [r[:100] for r in reads1] + [t2[: 104 + k % 3] for k in range(6)]
    others = [bytes(rng.integers(0, 4, size=110).astype(np.uint8))
              for _ in range(6)]
    reads = [r for pair in zip(group, others + others) for r in pair]
    idx = list(range(0, 24, 2))
    seen = {}
    for name, sc in _scorers(reads, idx).items():
        a1 = np.arange(12) < 6
        ha, hb = sc.root(a1), sc.root(~a1)
        for k in range(100):
            sc.push_many([(ha, t1[: k + 1]), (hb, t2[: k + 1])])
        out = sc.run_extend_dual(ha, hb, t1[:100], t2[:100], 2**31 - 1,
                                 2**31 - 1, 0, 3, 20, 2, False, False, 200,
                                 lock1=True)
        steps, code, app1, app2, st1, st2, act1, act2, recs = out
        seen[name] = (steps, code, app1, app2, _stats(sc, st1),
                      _stats(sc, st2), _mask(act1), _mask(act2),
                      [(j, f1.tolist(), f2.tolist(), _mask(a1), _mask(a2))
                       for j, f1, f2, a1, a2 in recs])
    assert seen["view"] == seen["group"] == seen["jax_view"]
    assert seen["view"][8], "the run absorbed no records"
