"""Read-axis sharding of one search's branch store over several
devices, with the cross-read sums added in shard order."""

from waffle_con_tpu_torch.parallel.mesh import (
    DeviceSet,
    current_device_set,
    device_slices,
    make_mesh,
    probe_device_count,
    reset_probe_cache,
    shard_for_config,
    shard_scorer,
    sharded_col_step,
    use_device_set,
)

__all__ = [
    "DeviceSet", "current_device_set", "device_slices", "make_mesh",
    "probe_device_count", "reset_probe_cache", "shard_for_config",
    "shard_scorer", "sharded_col_step", "use_device_set",
]
