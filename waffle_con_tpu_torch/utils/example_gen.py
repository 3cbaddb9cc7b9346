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
