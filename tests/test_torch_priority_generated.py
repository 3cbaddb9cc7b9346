"""The port's ``PriorityConsensusDWFA`` on ``"torch"`` (``device="cpu"``)
against the JAX package's on ``"jax"`` and the port's ``"python"``
oracle, on generated two-level draws (12 chains x 300 bp, two SNPs at
level 1; ``generate_priority_test``), one of them growing the shared
band.  Same bar as ``tests/test_torch_priority_jax.py``, whose helpers
it uses.
"""

import pytest

from test_torch_priority_jax import _check, one_torch_thread  # noqa: F401
from waffle_con_tpu_torch.utils.example_gen import generate_priority_test


@pytest.mark.parametrize("seeds,err,band", [
    ((11, 12, 300), 0.02, 20),
    # E=16 grows to 32 in the first level-1 group: later groups at that
    # level run on the grown band of the shared scorer
    ((13, 14, 400), 0.03, 16),
], ids=["band20", "band_grows"])
def test_draws_match_jax_backend(seeds, err, band):
    truth, (t1a, t1b), chains = generate_priority_test(12, 300, err, seeds)
    want, eng = _check(chains, min_count=3, initial_band=band)
    assert [[s for s, _ in chain] for chain in want[0]] == [
        [truth, min(t1a, t1b)], [truth, max(t1a, t1b)]]
    first = 0 if t1a < t1b else 1
    assert want[1] == [first] * 6 + [1 - first] * 6
    st = eng.last_search_stats
    assert st["scorer_constructions"] == 2
    assert [(g["level"], g["size"], g["dual"]) for g in st["groups"]] == [
        (0, 12, False), (1, 12, True), (1, 6, False), (1, 6, False)]
    c = st["scorer_counters"]
    assert c["run_calls"] > 0 and c["run_dual_calls"] + c["arena_calls"] > 0
    assert (c["grow_e_events"] > 0) == (band == 16)
