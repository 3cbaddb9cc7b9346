"""The JAX reference side of the port's tests: keeping each test worker's
memory maps under the kernel's limit.

Every compiled XLA:CPU executable keeps its code and data in memory maps
of the process (several hundred for one engine geometry), and JAX holds
every executable it compiled in its in-memory caches for the life of the
process.  A process that has compiled enough reaches the kernel's limit
of maps a process (``/proc/sys/vm/max_map_count``, often 65,530); the
next mapping fails inside XLA (a segmentation fault in
``backend_compile_and_load``, or in ``executable.serialize()`` under
``put_executable_and_time``) and the process dies.  Under the tier-1
run's six xdist workers that fails whichever test the worker was
running: the port's JAX-reference tests, which compile the most, and any
test that runs on a worker after them or after a compile-heavy module
(``tests/test_fuzz_parity.py`` alone, in one process, reaches the limit
at ``test_frontier_gang_fuzz[1]``).

This module is a pytest plugin of every session that collects it
(``pytest_plugins`` names it): after each test, a process holding more
than :data:`HIGH_WATER` maps drops the executables JAX holds in memory
(``jax.clear_caches()``).  No test's body, inputs or checks change; a
later compile of a dropped function is read back from the persistent
compilation cache or compiled again.
"""

import gc
import os

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("test_torch_jax_reference",)


def _map_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


#: maps of a process above which the executables are dropped: 60 % of
#: the limit leaves room for the most a single test has added (~8,000)
HIGH_WATER = int(0.6 * _map_limit())


def process_maps() -> int:
    """Memory maps of this process (0 where ``/proc`` has none)."""
    try:
        with open(f"/proc/{os.getpid()}/maps", "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


def release_jax_executables() -> None:
    """Drop every executable JAX holds in memory, and its maps."""
    jax.clear_caches()
    gc.collect()


def pytest_runtest_teardown(item, nextitem):
    if process_maps() > HIGH_WATER:
        release_jax_executables()


def test_released_executables_give_back_their_maps():
    """Compiled executables hold memory maps until the caches drop them,
    and the high-water mark sits below the kernel's limit."""
    if not process_maps():
        pytest.skip("needs /proc/<pid>/maps (Linux)")
    assert 0 < HIGH_WATER < _map_limit()
    release_jax_executables()
    base = process_maps()
    outs = [int(jax.jit(lambda x, k=k: (x * k + 1).sum())(jnp.arange(n)))
            for k, n in ((3, 7), (5, 9), (7, 11), (11, 13))]
    assert outs == [70, 189, 396, 871]
    grown = process_maps()
    assert grown > base
    release_jax_executables()
    assert process_maps() < grown


def test_the_hook_is_registered(request):
    """Collecting this file registers it as a plugin of the session."""
    import sys

    plugin = request.config.pluginmanager.get_plugin(
        "test_torch_jax_reference")
    assert plugin is sys.modules[__name__]
