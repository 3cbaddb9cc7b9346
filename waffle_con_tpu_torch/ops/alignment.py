"""One-shot WFA edit distance between two byte strings.

Capability parity with upstream ``waffle_con/src/sequence_alignment.rs:18-87``:
plain edit distance via expanding wavefronts of furthest-reaching
``(i, j)`` pairs, with an optional prefix mode (``require_both_end=False``)
that only requires ``v2`` to be fully consumed — used by the engines'
offset-activation search — and a wildcard that matches on *either* side.

>>> wfa_ed(bytes([0, 1, 2, 4, 5]), bytes([0, 1, 3, 4, 5]))
1
>>> wfa_ed_config(bytes([0, 1, 2, 4, 5]), bytes([0, 1, 2, 4]), False, ord('*'))
0
>>> wfa_ed_config(bytes([0, 1, 2, 4, 5]), bytes([0, 1, 2, 4]), True, ord('*'))
1
"""

from __future__ import annotations

from typing import Optional


def wfa_ed(v1: bytes, v2: bytes) -> int:
    """Full end-to-end edit distance with the default ``*`` wildcard."""
    return wfa_ed_config(v1, v2, True, ord("*"))


def wfa_ed_config(
    v1: bytes,
    v2: bytes,
    require_both_end: bool = True,
    wildcard: Optional[int] = None,
) -> int:
    """Edit distance between ``v1`` and ``v2``.

    When ``require_both_end`` is false, the alignment may stop at any
    position of ``v1`` once ``v2`` is exhausted (prefix semantics).  A
    ``wildcard`` byte matches anything on either side.
    """
    l1 = len(v1)
    l2 = len(v2)

    # furthest-reaching (i, j) per diagonal; wavefront index w at edit
    # distance e spans diagonals j - i = w - e.
    curr = [(0, 0)]
    edits = 0
    while True:
        nxt = [(0, 0)] * (2 * edits + 3)
        for w, (i, j) in enumerate(curr):
            while i < l1 and j < l2 and (
                v1[i] == v2[j] or v1[i] == wildcard or v2[j] == wildcard
            ):
                i += 1
                j += 1
            if j == l2 and (i == l1 or not require_both_end):
                return edits
            if i == l1:
                # only j may advance
                a, b, c = (i, j), (i, j + 1), (i, j + 1)
            elif j == l2:
                # only i may advance
                a, b, c = (i + 1, j), (i + 1, j), (i, j)
            else:
                # deletion / mismatch / insertion (of v2 relative to v1)
                a, b, c = (i + 1, j), (i + 1, j + 1), (i, j + 1)
            if a > nxt[w]:
                nxt[w] = a
            if b > nxt[w + 1]:
                nxt[w + 1] = b
            if c > nxt[w + 2]:
                nxt[w + 2] = c
        edits += 1
        curr = nxt
