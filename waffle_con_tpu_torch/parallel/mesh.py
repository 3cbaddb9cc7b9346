"""Read-axis sharding: one search's reads split over several devices.

The port of ``waffle_con_tpu``'s ``parallel/mesh.py``, with its names.
The JAX package maps the read axis onto a ``jax.sharding.Mesh``: one
scorer's state is placed with a ``NamedSharding`` and GSPMD partitions
every kernel.  The port keeps that single-controller shape: one process
holds the shards of one branch store
(:class:`~waffle_con_tpu_torch.ops.sharded_scorer.ShardedScorer`) on an
ordered tuple of torch devices, every store call runs on each shard, and
the cross-read sums are added in shard order on the mesh's first device.
No process group is made and no ``torch.distributed`` call runs.

* :class:`Mesh` is the port's mesh: devices in order, on named axes (the
  read axis is ``"read"``).  A mesh may list one device more than once:
  its shards then share the card (or the CPU), which is how one card
  holds 4 shards and how the tests run 8 shards on the CPU.
* :func:`shard_scorer` and :func:`shard_for_config` build the sharded
  store; ``construct_backend`` calls :func:`shard_for_config` for the
  ``"torch"`` backend when ``config.mesh_shards`` is set, so the
  supervisor's fallback construction shards as ``make_scorer`` does.
* :func:`sharded_col_step` is JAX's explicit ``shard_map`` column step:
  the shards on one card are one fused call of the branch step
  (``csrc/branch_step.cu``: one launch, the partials summed in the
  kernel) on one-slot copies of their state, a launch a card, then the
  cards' partials are added on the mesh's first device.
* :class:`DeviceSet`, :func:`device_slices`, :func:`use_device_set` and
  :func:`current_device_set` pin slices of the local devices to threads.

The port reads no environment variable: the device count is
``torch.cuda.device_count()`` for ``"cuda"`` and 1 for ``"cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

import numpy as np

from waffle_con_tpu_torch.ops import branch_kernel
from waffle_con_tpu_torch.ops.sharded_scorer import (
    ShardedScorer,
    reduce_partials,
    shard_groups,
    shard_step,
)

#: (device type -> device count) probe cache
_PROBE_LOCK = threading.Lock()
_PROBE_CACHE: Dict[str, int] = {}


def probe_device_count(device_type: str = "cuda") -> int:
    """Cached local device count of ``device_type``:
    ``torch.cuda.device_count()`` for ``"cuda"``, 1 for ``"cpu"``; asked
    once a process and type."""
    with _PROBE_LOCK:
        cached = _PROBE_CACHE.get(device_type)
    if cached is not None:
        return cached
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    elif device_type == "cpu":
        n = 1
    else:
        raise ValueError(f"no device count for device type {device_type!r}")
    with _PROBE_LOCK:
        _PROBE_CACHE[device_type] = n
    return n


def reset_probe_cache() -> None:
    """Forget cached probe outcomes."""
    with _PROBE_LOCK:
        _PROBE_CACHE.clear()


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The local devices of ``device_type``, in index order."""
    n = probe_device_count(device_type)
    if device_type == "cpu":
        return [torch.device("cpu")]
    return [torch.device(device_type, i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """A named, ordered slice of the local devices (a device may be
    listed more than once: its shards share it)."""

    name: str
    devices: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError(f"device set {self.name!r} is empty")

    def __len__(self) -> int:
        return len(self.devices)

    def mesh(self, n_devices: Optional[int] = None,
             shape: Optional[Sequence[int]] = None,
             axis_names: Sequence[str] = ("read",)) -> "Mesh":
        return make_mesh(n_devices, shape, axis_names, devices=self.devices)


def device_slices(n_slices: int,
                  devices: Optional[Sequence[Any]] = None,
                  name_prefix: str = "slice") -> List[DeviceSet]:
    """Partition the local devices (or ``devices``) into ``n_slices``
    contiguous sets: disjoint (sizes differ by at most one) with at least
    one device a slice, else one device a slice, round-robin."""
    if n_slices < 1:
        raise ValueError(f"need n_slices >= 1, got {n_slices}")
    devs = tuple(devices) if devices is not None else tuple(local_devices())
    if not devs:
        raise ValueError("no devices to slice")
    out: List[DeviceSet] = []
    if len(devs) >= n_slices:
        base, rem = divmod(len(devs), n_slices)
        start = 0
        for i in range(n_slices):
            size = base + (1 if i < rem else 0)
            out.append(DeviceSet(f"{name_prefix}{i}",
                                 devs[start:start + size]))
            start += size
    else:
        for i in range(n_slices):
            out.append(DeviceSet(f"{name_prefix}{i}",
                                 (devs[i % len(devs)],)))
    return out


_TLS = threading.local()


def current_device_set() -> Optional[DeviceSet]:
    """The device set pinned on this thread, or ``None`` (all devices)."""
    return getattr(_TLS, "device_set", None)


@contextlib.contextmanager
def use_device_set(device_set: Optional[DeviceSet]):
    """Pin mesh construction on this thread to ``device_set`` (nested
    scopes restore the outer pin)."""
    prev = current_device_set()
    _TLS.device_set = device_set
    try:
        yield device_set
    finally:
        _TLS.device_set = prev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in row-major order over named axes of ``shape``."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("read",),
    devices: Optional[Sequence[Any]] = None,
    device_type: str = "cuda",
) -> Mesh:
    """A mesh over the first ``n_devices`` (or all) devices.  ``devices``
    is the pool; when omitted the thread's pinned :class:`DeviceSet`
    wins over the local devices of ``device_type``.  ``shape`` reshapes
    the list over ``axis_names`` (row-major)."""
    if devices is not None:
        pool = list(devices)
    else:
        pinned = current_device_set()
        pool = (list(pinned.devices) if pinned is not None
                else local_devices(device_type))
    if n_devices is not None:
        if n_devices > len(pool):
            raise ValueError(
                f"requested {n_devices} mesh devices but only "
                f"{len(pool)} available"
            )
        pool = pool[:n_devices]
    if shape is None:
        shape = (len(pool),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names must have equal rank")
    size = 1
    for s in shape:
        size *= s
    if size != len(pool):
        raise ValueError(f"shape {shape} does not hold {len(pool)} devices")
    return Mesh(tuple(torch.device(d) for d in pool),
                dict(zip(tuple(axis_names), shape)))


def _read_devices(mesh: Mesh, read_axis: str) -> Tuple[torch.device, ...]:
    """The mesh's devices along ``read_axis`` (every other axis of size
    1: the port shards the read axis only)."""
    if read_axis not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {read_axis!r} (axes: {mesh.axis_names})"
        )
    others = {a: s for a, s in mesh.shape.items() if a != read_axis}
    if any(s != 1 for s in others.values()):
        raise ValueError(
            f"the port shards the read axis only; mesh axes {mesh.shape}")
    return mesh.devices


def shard_scorer(scorer, mesh: Mesh, read_axis: str = "read"):
    """The read-sharded store of ``scorer``'s reads and config over the
    mesh's read axis (a new
    :class:`~waffle_con_tpu_torch.ops.sharded_scorer.ShardedScorer`; the
    scorer given is left as it is).  Records ``scorer_sharded``."""
    devices = _read_devices(mesh, read_axis)
    return _sharded(scorer.reads, scorer.config, devices, read_axis)


def _sharded(reads, config, devices, read_axis: str) -> ShardedScorer:
    store = ShardedScorer(reads, config, devices)
    from waffle_con_tpu_torch.runtime import events

    events.record(
        "scorer_sharded", axis=read_axis, shards=len(devices),
        reads=int(store._R),
        devices=[str(d) for d in devices],
    )
    return store


def shard_for_config(reads, config) -> Optional[ShardedScorer]:
    """The sharded store ``config.mesh_shards`` asks for, over ``reads``
    (``None`` when it asks for none).  The availability check runs
    first, against the thread's pinned :class:`DeviceSet` or the cached
    device count of ``config.device``'s type, so a config asking for
    more shards than there are devices fails before anything is built.
    ``construct_backend`` calls it, so the supervisor's fallback
    construction shards as ``make_scorer`` does."""
    shards = getattr(config, "mesh_shards", 0)
    if not shards:
        return None
    pinned = current_device_set()
    dtype = torch.device(config.device).type
    available = (len(pinned) if pinned is not None
                 else probe_device_count(dtype))
    if shards > available:
        raise ValueError(
            f"config.mesh_shards={shards} exceeds the "
            f"{available} available device(s)"
            + (f" in device set {pinned.name!r}" if pinned else "")
        )
    mesh = make_mesh(shards, device_type=dtype)
    return _sharded(reads, config, mesh.devices, "read")


def sharded_col_step(mesh: Mesh, read_axis: str = "read",
                     num_symbols: int = 32, plain: bool = False,
                     route: str = "auto"):
    """The explicit column step of one branch over the mesh's read axis.

    Returns ``step(D, e, rmin, er, off, act, cons, clen, reads, rlen,
    sym, wc, et) -> (D', e', rmin', er', occ, split, total, reached_any,
    overflow)``.  The per-read arguments (``D [R/n, W]``, ``e``, ``rmin``,
    ``er``, ``off``, ``act``, ``reads [R/n, L]``, ``rlen``) are lists of
    one tensor a shard, in mesh order, each on its shard's device
    (``ops/state_io.py``'s :func:`split_reads` makes them); ``cons``
    ``[C]`` and the scalars are the same for every shard.  The per-read
    outputs come back the same way (``occ [R/n, num_symbols]``), as new
    tensors, the inputs untouched; ``total``, ``reached_any`` and
    ``overflow`` are 0-d tensors on the mesh's first device.

    The shards are grouped as the sharded store groups them
    (:func:`~waffle_con_tpu_torch.ops.sharded_scorer.shard_groups`,
    ``route``): each group is one call of ``csrc/branch_step.cu``
    (:func:`shard_step`: a forced commit, the group's partials summed by
    the kernel's atomics) on one-slot copies of its shards' state stacked
    in one tensor a field.  ``plain`` takes the twins instead on every
    device (the plain version the card's kernel is held to).  The groups'
    partials are added on the mesh's first device
    (:func:`reduce_partials`)."""
    devices = _read_devices(mesh, read_axis)
    groups = shard_groups(devices, route)
    bufs = [branch_kernel.BranchBuffers() for _ in groups]
    i32 = torch.int32

    def group(ks, dev, gi, D, e, rmin, er, off, act, cons, clen, reads,
              rlen, rows, wc, et):
        m = len(ks)
        # one copy a field type (the bands, the four per-read words, act)
        # into one-slot stores, a view a shard of each
        band = torch.stack([D[k].to(dev, i32) for k in ks])
        words = torch.stack([x[k].to(dev, i32) for x in (e, rmin, er, off)
                             for k in ks])
        Rs = band.shape[1]
        f = {"D": band.view(m, 1, Rs, -1).unbind(0),
             "act": torch.stack([act[k].to(dev, torch.bool)
                                 for k in ks]).view(m, 1, Rs).unbind(0),
             "cons": torch.as_tensor(cons, dtype=i32).to(dev).reshape(
                 1, 1, -1).repeat(m, 1, 1).unbind(0),
             "clen": torch.full((m, 1), int(clen), dtype=i32,
                                device=dev).unbind(0)}
        per_word = words.view(4, m, 1, Rs)
        for i, name in enumerate(("e", "rmin", "er", "off")):
            f[name] = per_word[i].unbind(0)
        states = [{name: t[i] for name, t in f.items()} for i in range(m)]
        out, part = shard_step(
            states, rows, [reads[k].to(dev, torch.int16).contiguous()
                           for k in ks],
            [rlen[k].to(dev, i32).contiguous() for k in ks], wc, et,
            num_symbols, bufs=bufs[gi], force=True, partials=True,
            plain=plain)
        # occ and split of every shard in one upload
        A = out.occ.shape[2]
        host = np.concatenate([out.occ[0].reshape(-1), out.split[0]])
        up = torch.from_numpy(host.astype(np.int32, copy=False)).to(dev)
        occ = up[:m * Rs * A].view(m, Rs, A).unbind(0)
        split = up[m * Rs * A:].view(m, Rs).unbind(0)
        bands = band.unbind(0)
        w = per_word[:3, :, 0].unbind(1)  # (e, rmin, er) a shard
        return [(bands[i], w[i][0], w[i][1], w[i][2], occ[i], split[i])
                for i in range(m)], part

    def step(D, e, rmin, er, off, act, cons, clen, reads, rlen, sym, wc,
             et):
        rows = np.asarray([[0], [0], [int(sym)]], dtype=np.int32)
        per, parts = [None] * len(devices), []
        for gi, (dev, ks) in enumerate(groups):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                got, part = group(ks, dev, gi, D, e, rmin, er, off, act,
                                  cons, clen, reads, rlen, rows, int(wc),
                                  bool(et))
            for k, o in zip(ks, got):
                per[k] = o
            parts.append(part)
        total, reached_any, overflow = reduce_partials(parts, devices[0])
        return tuple([o[i] for o in per] for i in range(6)) + (
            total, reached_any, overflow)

    return step
