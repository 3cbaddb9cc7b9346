"""Runtime hooks of the port: deterministic fault injection
(:mod:`waffle_con_tpu_torch.runtime.faults`, the ``flip_vote`` fault the
audit plane is tested against)."""
