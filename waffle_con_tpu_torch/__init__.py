"""waffle_con_tpu_torch — the PyTorch/CUDA port of ``waffle_con_tpu``.

Backbone-free consensus of noisy long reads: a least-cost-first search
over partial consensus strings whose per-read scoring step is an
incremental edit-distance wavefront.  This package runs that search with
its branch store in torch tensors on an NVIDIA GPU, and the run loops —
the hot path — as hand-written CUDA kernels for Hopper
(``csrc/run_extend.cu`` for one branch, ``csrc/run_extend_dual.cu`` for
the two branches of a dual node).  It imports torch, numpy and the standard
library only; ``waffle_con_tpu`` (the JAX package beside it) is its
reference, reached by the tests alone.

* ``ops``    — the DWFA oracle, the scorer seam, the torch branch store
  and the CUDA kernels with their plain PyTorch twins.
* ``models`` — the single-, dual- and priority-consensus engines, and
  search checkpoints (``models/checkpoint.py``: snapshot, preempt and
  resume a search; a resumed search rebuilds its branches through the
  column-replay kernel and runs on the same kernels).
* ``obs``    — observability, off by default and switched on in code:
  span tracer (Chrome trace, ``torch.profiler`` bridge), metrics
  registry (Prometheus text), per-search reports, the decision audit
  and its lockstep shadow against the python oracle.
* ``runtime`` — supervised dispatch, off by default: retry, demotion
  down torch -> native -> python and re-promotion of a live search,
  deterministic fault injection, dispatch budgets and deadlines, and the
  event log they record into.
* ``native`` — the C++ engine suite (a copy of the JAX package's),
  built with ``g++`` on first use: ``backend="native"`` and the host
  baseline ``native_consensus`` / ``native_dual_consensus`` /
  ``native_priority_consensus``.
* ``utils``  — the priority-queue tracker, synthetic data generation and
  the JSON scenario fixtures' loaders.
"""

from waffle_con_tpu_torch.config import CdwfaConfig, CdwfaConfigBuilder, ConsensusCost
from waffle_con_tpu_torch.models.checkpoint import (
    CheckpointController,
    CheckpointRejected,
    SearchCheckpoint,
    SearchPreempted,
    resume_engine,
)
from waffle_con_tpu_torch.models.consensus import Consensus, ConsensusDWFA
from waffle_con_tpu_torch.models.dual_consensus import DualConsensus, DualConsensusDWFA
from waffle_con_tpu_torch.models.multi_consensus import MultiConsensus
from waffle_con_tpu_torch.models.priority_consensus import (
    PriorityConsensus,
    PriorityConsensusDWFA,
)
from waffle_con_tpu_torch.obs.report import SearchReport

__all__ = [
    "CheckpointController",
    "CheckpointRejected",
    "SearchCheckpoint",
    "SearchPreempted",
    "SearchReport",
    "resume_engine",
    "CdwfaConfig",
    "CdwfaConfigBuilder",
    "ConsensusCost",
    "Consensus",
    "ConsensusDWFA",
    "DualConsensus",
    "DualConsensusDWFA",
    "MultiConsensus",
    "PriorityConsensus",
    "PriorityConsensusDWFA",
]
