"""waffle_con_tpu_torch — the PyTorch/CUDA port of ``waffle_con_tpu``.

Backbone-free consensus of noisy long reads: a least-cost-first search
over partial consensus strings whose per-read scoring step is an
incremental edit-distance wavefront.  This package runs that search with
its branch store in torch tensors on an NVIDIA GPU, and the run loop —
the hot path — as a hand-written CUDA kernel for Hopper
(``csrc/run_extend.cu``).  It imports torch, numpy and the standard
library only; ``waffle_con_tpu`` (the JAX package beside it) is its
reference, reached by the tests alone.

* ``ops``    — the DWFA oracle, the scorer seam, the torch branch store
  and the CUDA run kernel with its plain PyTorch twin.
* ``models`` — the single-consensus engine.
* ``utils``  — the priority-queue tracker and synthetic data generation.
"""

from waffle_con_tpu_torch.config import CdwfaConfig, CdwfaConfigBuilder, ConsensusCost
from waffle_con_tpu_torch.models.consensus import Consensus, ConsensusDWFA

__all__ = [
    "CdwfaConfig",
    "CdwfaConfigBuilder",
    "ConsensusCost",
    "Consensus",
    "ConsensusDWFA",
]
