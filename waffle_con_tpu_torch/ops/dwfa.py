"""Incremental ("dynamic") edit-distance wavefront alignment.

:class:`DWFALite` maintains the anti-diagonal wavefront of an edit-distance
WFA between a fixed ``baseline`` sequence (a read) and a growing ``other``
sequence (the consensus being built).  Appending one symbol to ``other``
re-extends the wavefront and raises the edit distance only when forced.

This is the capability-parity equivalent of the reference kernel
(upstream ``waffle_con/src/dynamic_wfa.rs:13-265``); it is also the executable
specification for the batched torch scorer in
:mod:`waffle_con_tpu_torch.ops.torch_scorer` and its CUDA run kernel —
they must agree exactly (integer edit distances), which the parity tests
assert.

Mental model: diagonals are indexed by ``k = (other consumed) - (baseline
consumed)``, with ``k`` ranging over ``[-e, +e]`` at edit distance ``e``.
The stored value per diagonal is the number of bases consumed in ``other``
(beyond ``offset``); the baseline position of a diagonal is then simply
``d - k``.  Both sequences live *outside* this object and must be passed
into every call; only appends to ``other`` are legal between calls.
"""

from __future__ import annotations

from typing import Dict, Optional


class DWFAError(Exception):
    """Raised on illegal state transitions (e.g. update after finalize)."""


class DWFALite:
    """Single-pair incremental WFA state.

    Parameters
    ----------
    wildcard:
        Optional byte value that matches anything when it appears in the
        *baseline* sequence.
    allow_early_termination:
        When true, ``update`` stops escalating edit distance once the
        wavefront reaches the end of the baseline, so consensus growth past
        a short read costs nothing.
    """

    __slots__ = (
        "edit_distance",
        "wavefront",
        "is_finalized",
        "wildcard",
        "allow_early_termination",
        "offset",
    )

    def __init__(
        self,
        wildcard: Optional[int] = None,
        allow_early_termination: bool = False,
    ) -> None:
        self.edit_distance: int = 0
        # wavefront[i] is the diagonal k = i - edit_distance; value = bases
        # consumed in `other` (beyond `offset`).  Always length 2e+1.
        self.wavefront = [0]
        self.is_finalized = False
        self.wildcard = wildcard
        self.allow_early_termination = allow_early_termination
        self.offset = 0

    # ------------------------------------------------------------------
    # lifecycle

    def set_offset(self, offset: int) -> None:
        """Ignore the first ``offset`` characters of ``other`` entirely, as
        if the alignment began there (late-starting reads)."""
        self.offset = offset

    def clone(self) -> "DWFALite":
        dup = DWFALite.__new__(DWFALite)
        dup.edit_distance = self.edit_distance
        dup.wavefront = list(self.wavefront)
        dup.is_finalized = self.is_finalized
        dup.wildcard = self.wildcard
        dup.allow_early_termination = self.allow_early_termination
        dup.offset = self.offset
        return dup

    def state_key(self):
        """Hashable full-state identity (used for search-node dedup)."""
        return (
            self.edit_distance,
            tuple(self.wavefront),
            self.is_finalized,
            self.offset,
        )

    def __eq__(self, rhs) -> bool:
        return (
            isinstance(rhs, DWFALite)
            and self.edit_distance == rhs.edit_distance
            and self.wavefront == rhs.wavefront
            and self.is_finalized == rhs.is_finalized
            and self.wildcard == rhs.wildcard
            and self.allow_early_termination == rhs.allow_early_termination
            and self.offset == rhs.offset
        )

    def __hash__(self) -> int:
        return hash(self.state_key())

    # ------------------------------------------------------------------
    # core updates

    def update(self, baseline: bytes, other: bytes) -> int:
        """Account for newly appended ``other`` symbols: greedily extend all
        diagonals, escalating edit distance until some diagonal consumes all
        of ``other`` (or, with early termination, the baseline is exhausted).

        Returns the current edit distance.
        """
        if self.is_finalized:
            raise DWFAError("Cannot push more bases after finalizing a DWFA")

        self._extend(baseline, other)
        target = len(other)
        while self.maximum_other_distance() < target and not (
            self.allow_early_termination and self.reached_baseline_end(baseline)
        ):
            self._increase_edit_distance(baseline, other)

        assert self.maximum_other_distance() == target or (
            self.allow_early_termination
            and self.maximum_baseline_distance() == len(baseline)
        )
        return self.edit_distance

    def _extend(self, baseline: bytes, other: bytes) -> None:
        """Greedy furthest-reaching extension of every diagonal."""
        wf = self.wavefront
        e = self.edit_distance
        off = self.offset
        blen = len(baseline)
        olen = len(other)
        wc = self.wildcard
        for i in range(len(wf)):
            d = wf[i]
            k = i - e  # diagonal: other-consumed minus baseline-consumed
            # baseline position for this diagonal is d - k
            bo = d - k
            oo = d + off
            while bo < blen and oo < olen:
                b = baseline[bo]
                if b != other[oo] and b != wc:
                    break
                d += 1
                bo += 1
                oo += 1
            wf[i] = d

    def _increase_edit_distance(self, baseline: bytes, other: bytes) -> None:
        """Grow the wavefront by one edit: each new diagonal takes the best
        of a baseline-skip (value unchanged, from diagonal ``k+1``), a
        mismatch (value+1, same ``k``) or an other-insertion (value+1, from
        ``k-1``); then re-extend."""
        if self.is_finalized:
            raise DWFAError("Cannot increase edit distance after finalizing a DWFA")
        old = self.wavefront
        n = len(old)
        self.edit_distance += 1
        new = [0] * (n + 2)
        for i, d in enumerate(old):
            # deletion of a baseline base: same other-consumption
            if d > new[i]:
                new[i] = d
            # mismatch: consume one of each
            if d + 1 > new[i + 1]:
                new[i + 1] = d + 1
            # insertion into baseline: consume one more of other
            if d + 1 > new[i + 2]:
                new[i + 2] = d + 1
        self.wavefront = new
        self._extend(baseline, other)

    def finalize(self, baseline: bytes, other: bytes) -> None:
        """Signal that ``other`` is complete: escalate until the wavefront
        reaches the end of the baseline, charging for any unmatched tail."""
        if self.is_finalized:
            raise DWFAError("Cannot finalize a DWFA twice.")
        blen = len(baseline)
        while self.maximum_baseline_distance() < blen:
            self._increase_edit_distance(baseline, other)

    # ------------------------------------------------------------------
    # queries

    def maximum_baseline_distance(self) -> int:
        """Farthest position reached in ``baseline`` over all diagonals."""
        e = self.edit_distance
        return max(d - (i - e) for i, d in enumerate(self.wavefront))

    def maximum_other_distance(self) -> int:
        """Farthest position reached in ``other`` (including the offset)."""
        return self.offset + max(self.wavefront)

    def reached_baseline_end(self, baseline: bytes) -> bool:
        return self.maximum_baseline_distance() == len(baseline)

    def get_extension_candidates(
        self, baseline: bytes, other: bytes
    ) -> Dict[int, int]:
        """Next-symbol votes: for every diagonal whose ``other`` consumption
        is exactly at the end, the baseline character it faces is a
        candidate; returns ``{byte: tip_count}``."""
        votes: Dict[int, int] = {}
        e = self.edit_distance
        off = self.offset
        olen = len(other)
        blen = len(baseline)
        for i, d in enumerate(self.wavefront):
            if d + off == olen:
                bo = d - (i - e)
                if bo < blen:
                    c = baseline[bo]
                    votes[c] = votes.get(c, 0) + 1
        return votes
