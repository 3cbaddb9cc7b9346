"""Seeded synthetic consensus datasets for tests and benchmarks.

Capability parity with upstream ``waffle_con/src/example_gen.rs:11-64``: a
random consensus over a small alphabet plus ``num_samples`` noisy copies
with per-base error ``error_rate`` split evenly between substitution,
deletion and insertion.  Deterministic for a given seed (numpy PCG64; the
reference's ChaCha12 stream is not reproduced bit-for-bit — datasets are
regenerated, not ported, per SURVEY.md §7 step 1).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def corrupt(
    consensus: bytes,
    error_rate: float,
    rng: np.random.Generator,
    alphabet_size: int = 4,
) -> bytes:
    """One noisy copy of ``consensus``: per-base error split evenly between
    substitution, deletion and insertion (reference error model,
    upstream ``waffle_con/src/example_gen.rs:30-58``)."""
    seq_len = len(consensus)
    seq = bytearray()
    con_index = 0
    while con_index < seq_len:
        c = int(consensus[con_index])
        if rng.random() < error_rate:
            error_type = int(rng.integers(0, 3))
            if error_type == 0:
                # substitution: any *other* symbol
                sub_offset = int(rng.integers(0, alphabet_size - 1))
                seq.append((c + 1 + sub_offset) % alphabet_size)
                con_index += 1
            elif error_type == 1:
                # deletion
                con_index += 1
            else:
                # insertion (consensus position is retried)
                seq.append(int(rng.integers(0, alphabet_size)))
        else:
            seq.append(c)
            con_index += 1
    return bytes(seq)


def generate_test(
    alphabet_size: int,
    seq_len: int,
    num_samples: int,
    error_rate: float,
    seed: int = 0,
) -> Tuple[bytes, List[bytes]]:
    """Return ``(consensus, samples)`` with symbols in ``0..alphabet_size``."""
    assert alphabet_size > 1
    assert 0.0 <= error_rate <= 1.0

    rng = np.random.default_rng(seed)
    consensus = rng.integers(0, alphabet_size, size=seq_len, dtype=np.uint8)
    samples = [
        corrupt(bytes(consensus), error_rate, rng, alphabet_size)
        for _ in range(num_samples)
    ]
    return bytes(consensus), samples


def generate_priority_test(
    num_chains: int,
    seq_len: int,
    error_rate: float,
    seeds: Tuple[int, int, int] = (3, 4, 200),
) -> Tuple[bytes, Tuple[bytes, bytes], List[List[bytes]]]:
    """Two-level sequence chains whose second level splits the reads in
    two: the JAX package's priority benchmark draw (``bench.py``
    ``bench_priority``).  Level 0 is ``generate_test`` at ``seq_len // 2``
    (seed ``seeds[0]``); level 1 is one of two haplotypes of ``seq_len``
    bases, the second with the bases at ``seq_len // 3`` and
    ``2 * seq_len // 3`` shifted by +1 and +2 (mod 4), the first half of
    the chains from the first (read ``i`` corrupted with the generator
    seeded ``seeds[2] + i``).  Returns ``(level0_truth, (t1a, t1b),
    chains)``."""
    truth, level0 = generate_test(4, seq_len // 2, num_chains, error_rate,
                                  seed=seeds[0])
    t1a, _ = generate_test(4, seq_len, 1, 0.0, seed=seeds[1])
    t1b = bytearray(t1a)
    t1b[seq_len // 3] = (t1b[seq_len // 3] + 1) % 4
    t1b[2 * seq_len // 3] = (t1b[2 * seq_len // 3] + 2) % 4
    t1b = bytes(t1b)
    chains = [
        [level0[i], corrupt(t1a if i < num_chains // 2 else t1b, error_rate,
                            np.random.default_rng(seeds[2] + i))]
        for i in range(num_chains)
    ]
    return truth, (t1a, t1b), chains
