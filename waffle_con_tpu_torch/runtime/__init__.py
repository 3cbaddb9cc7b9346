"""The port's runtime plane, off by default and switched on in the config
(``supervised`` or ``backend_chain``):

* :mod:`~waffle_con_tpu_torch.runtime.supervisor` —
  ``BackendSupervisor``: every scorer call under timeout, retry with
  backoff, result validation and a circuit breaker that demotes the live
  search down torch -> native -> python (and probes it back up) with
  byte-identical results;
* :mod:`~waffle_con_tpu_torch.runtime.faults` — deterministic fault
  injection, installed in code: ``timeout``, ``device_loss``,
  ``garbage``, ``pallas_compile`` (a kernel that fails raises) and
  ``flip_vote`` (a wrong decision for the audit plane);
* :mod:`~waffle_con_tpu_torch.runtime.watchdog` — dispatch budgets and
  deadlines;
* :mod:`~waffle_con_tpu_torch.runtime.events` — the process-wide event
  log the others record into.
"""
