"""Runtime lock-order checking for the port.

* :mod:`waffle_con_tpu_torch.analysis.lockcheck` — ``Lock`` / ``RLock``
  / ``Thread`` factories; with :func:`~waffle_con_tpu_torch.analysis.
  lockcheck.enable_lockcheck` on they record each thread's acquisition
  chain and raise on a cyclic lock order (a potential deadlock).
"""
