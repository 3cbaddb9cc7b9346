"""Carry a branch store across frameworks.

The branch store of ``waffle_con_tpu``'s ``JaxScorer`` is a dict of
arrays — ``D [B, R, W]``, ``e``/``rmin``/``er``/``off`` ``[B, R]`` int32,
``act [B, R]`` bool, ``cons [B, C]`` int32, ``clen [B]`` int32 — and so is
:class:`~waffle_con_tpu_torch.ops.torch_scorer.TorchScorer`'s.  Fetched to
numpy (``jax.device_get``) one side's store becomes the other's with
these two functions, which is how the tests put the same branch state
into both packages.  A read-sharded store
(:mod:`waffle_con_tpu_torch.ops.sharded_scorer`) holds one such dict a
shard, each with ``R / n`` of the reads: :func:`split_state` and
:func:`gather_state` carry one store across, :func:`split_reads` and
:func:`gather_reads` one per-read array (the read axis first), and
:func:`gather_slots` / :func:`scatter_slots` some slots of the shards as
one store and back (the plain versions of the sharded run paths).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

#: field -> dtype of the branch store
FIELDS = {
    "D": np.int32, "e": np.int32, "rmin": np.int32, "er": np.int32,
    "off": np.int32, "act": np.bool_, "cons": np.int32, "clen": np.int32,
}


def state_from_numpy(state: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy branch store -> contiguous torch tensors on ``device``."""
    return {
        name: torch.tensor(np.asarray(state[name], dtype=dt), device=device)
        for name, dt in FIELDS.items()
    }


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """torch branch store -> numpy arrays (one host copy per field)."""
    return {name: state[name].cpu().numpy() for name in FIELDS}


#: the fields with a read axis (axis 1 of ``[B, R, ...]``)
READ_FIELDS = ("D", "e", "rmin", "er", "off", "act")


def split_reads(x, devices: Sequence, axis: int = 0) -> List[torch.Tensor]:
    """A per-read array (numpy or tensor) split evenly along ``axis``
    into one contiguous tensor a device, in order (shard ``k`` holds rows
    ``k R/n .. (k+1) R/n - 1``)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    n = len(devices)
    if t.shape[axis] % n:
        raise ValueError(
            f"{t.shape[axis]} rows do not split over {n} shards")
    return [part.contiguous().to(torch.device(dev))
            for part, dev in zip(torch.chunk(t, n, dim=axis), devices)]


def gather_reads(parts: Sequence, axis: int = 0) -> np.ndarray:
    """The shards' parts of a per-read array, in shard order, as one
    numpy array."""
    return np.concatenate([torch.as_tensor(p).cpu().numpy() for p in parts],
                          axis=axis)


def split_state(state: Dict[str, np.ndarray],
                devices: Sequence) -> List[Dict[str, torch.Tensor]]:
    """A numpy branch store -> one torch store a shard: the per-read
    fields split along the read axis, ``cons`` and ``clen`` copied to
    every shard."""
    full = {name: np.asarray(state[name], dtype=dt)
            for name, dt in FIELDS.items()}
    per = {name: split_reads(full[name], devices, axis=1)
           for name in READ_FIELDS}
    return [
        dict({name: per[name][k] for name in READ_FIELDS},
             cons=torch.tensor(full["cons"], device=torch.device(dev)),
             clen=torch.tensor(full["clen"], device=torch.device(dev)))
        for k, dev in enumerate(devices)
    ]


def gather_state(shards: Sequence[Dict[str, torch.Tensor]]
                 ) -> Dict[str, np.ndarray]:
    """One torch store a shard -> one numpy store: the per-read fields
    joined in shard order, ``cons`` and ``clen`` from the first shard
    (every shard holds the same)."""
    out = {name: gather_reads([sh[name] for sh in shards], axis=1)
           for name in READ_FIELDS}
    out["cons"] = shards[0]["cons"].cpu().numpy()
    out["clen"] = shards[0]["clen"].cpu().numpy()
    return out


def gather_slots(states: Sequence[Dict[str, torch.Tensor]], slots,
                 reads: Sequence[torch.Tensor], rlens: Sequence[torch.Tensor]):
    """Slots ``slots`` of the shards' stores as one store of
    ``len(slots)`` slots over every read (slot ``i`` of it is
    ``slots[i]`` of the shards), with the shards' reads and lengths
    joined, on the shards' device: ``(state, reads, rlen)``."""
    dev = states[0]["D"].device
    idx = torch.as_tensor(list(slots), dtype=torch.long)
    part = [{name: st[name][idx.to(st[name].device)] for name in FIELDS}
            for st in states]
    state = state_from_numpy(gather_state(part), dev)
    return (state, torch.from_numpy(gather_reads(reads)).to(dev),
            torch.from_numpy(gather_reads(rlens)).to(dev))


def scatter_slots(states: Sequence[Dict[str, torch.Tensor]], slots,
                  state: Dict[str, torch.Tensor]) -> None:
    """:func:`gather_slots` undone: the one store's slots written back in
    place into slots ``slots`` of the shards (:func:`split_state`)."""
    idx = torch.as_tensor(list(slots), dtype=torch.long)
    parts = split_state(state_to_numpy(state),
                        [st["D"].device for st in states])
    for st, part in zip(states, parts):
        for name in FIELDS:
            st[name][idx.to(st[name].device)] = part[name]
