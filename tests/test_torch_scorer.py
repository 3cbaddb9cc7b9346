"""The port's branch store (``TorchScorer``) against ``JaxScorer``, call by
call: root, clone+push expansion, batched push, stats, late activation,
deactivation and finalized distances, on a small band (E=8) and a wide
one (E=256, W=514, the north-star band).  Stats must be equal exactly and
so must the branch slots' state rows after every call."""

import jax
import numpy as np
import pytest

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.utils.example_gen import generate_test
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops.state_io import state_to_numpy
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer


def _stats(s):
    return (s.eds.tolist(), s.occ.tolist(), s.split.tolist(),
            s.reached.tolist(), None if s.fin is None else s.fin.tolist())


def _rows(sc, handles):
    state = (jax.device_get(sc._state) if isinstance(sc, JaxScorer)
             else state_to_numpy(sc._state))
    out = []
    for h in handles:
        slot = sc._slot_of[h]
        clen = int(state["clen"][slot])
        out.append((
            clen, state["cons"][slot][:clen].tolist(),
            *(np.asarray(state[k][slot]).tolist()
              for k in ("D", "e", "rmin", "er", "off", "act")),
        ))
    return out


@pytest.mark.parametrize("band", [None, 200], ids=["E8", "E256"])
def test_branch_store_calls_match_jax(band):
    truth, reads = generate_test(4, 90, 8, 0.03, seed=31)
    jb = JaxConfigBuilder().backend("jax").min_count(2)
    tb = CdwfaConfigBuilder().backend("torch").device("cpu").min_count(2)
    if band is not None:
        jb, tb = jb.initial_band(band), tb.initial_band(band)
    scorers = [JaxScorer(reads, jb.build()), TorchScorer(reads, tb.build())]
    seen = []
    for sc in scorers:
        log = []
        act = np.ones(len(reads), dtype=bool)
        act[[2, 5]] = False
        root = sc.root(act)
        log.append(_stats(sc.stats(root, b"")))
        # expansion: the root in place plus two clones pushed by
        # different symbols, then a batched push of both clones
        cons = truth[:1]
        alt = bytes([(truth[0] + 1) % 4])
        out = sc.clone_push_many([(root, None, False), (root, alt, False),
                                  (root, cons, True)])
        log.append([None if s is None else _stats(s) for _h, s in out])
        (c0, _), (c1, _), (h, _) = out
        for k in range(1, 20):
            log.append([_stats(s) for s in sc.push_many(
                [(h, truth[: k + 1]), (c1, alt + truth[1: k + 1])])])
        # late reads join at their offsets and catch up to the branch
        sc.activate(h, 2, 3, truth[:20])
        sc.activate(h, 5, 7, truth[:20])
        log.append(_stats(sc.stats(h, truth[:20])))
        sc.deactivate(c1, 1)
        log.append(_stats(sc.stats(c1, alt + truth[1:20])))
        log.append(sc.finalized_eds(h, truth[:20]).tolist())
        log.append(_rows(sc, [c0, c1, h]))
        seen.append(log)
    assert seen[0] == seen[1]
