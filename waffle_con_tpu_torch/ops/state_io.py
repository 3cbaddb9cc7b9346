"""Carry a branch store across frameworks.

The branch store of ``waffle_con_tpu``'s ``JaxScorer`` is a dict of
arrays — ``D [B, R, W]``, ``e``/``rmin``/``er``/``off`` ``[B, R]`` int32,
``act [B, R]`` bool, ``cons [B, C]`` int32, ``clen [B]`` int32 — and so is
:class:`~waffle_con_tpu_torch.ops.torch_scorer.TorchScorer`'s.  Fetched to
numpy (``jax.device_get``) one side's store becomes the other's with
these two functions, which is how the tests put the same branch state
into both packages.
"""

from __future__ import annotations

from typing import Dict

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
