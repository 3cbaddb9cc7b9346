"""The port's build cache (``waffle_con_tpu_torch/utils/cache.py``).

Mirrors ``tests/test_fault_injection.py``'s
``test_injected_cache_corruption_quarantined`` on the port's own cache:
the libraries it builds into ``_build/``.  On the C++ engines' library
(``g++`` is here, ``nvcc`` is not), in a build directory of the test's
own: a corrupted ``.so`` is quarantined, rebuilt and loaded, never
loaded as it is; the ``cache_corrupt`` fault flips a library's bytes and
records its event; a library with no manifest entry is sealed; a corrupt
manifest is rebuilt.  The kernel library's loader takes the same check
(its build stubbed by a copy of a built library).
"""

import ctypes
import json
import logging
import os
import shutil

import pytest

from waffle_con_tpu_torch import native as TN
from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.runtime import events, faults
from waffle_con_tpu_torch.utils import cache


@pytest.fixture(autouse=True)
def clean_runtime():
    faults.clear()
    events.clear_events()
    yield
    faults.clear()
    events.clear_events()


@pytest.fixture
def native_dir(tmp_path, monkeypatch):
    """The native library's build directory moved to ``tmp_path``, with
    a copy of the built library in it (unsealed), and the loader's
    cached handle dropped."""
    built = TN.build()
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "_lib", None)
    lib = TN.library_path()
    assert lib.parent == tmp_path
    shutil.copyfile(built, lib)
    return lib


def _flip(path, at=None):
    data = bytearray(path.read_bytes())
    mid = len(data) // 2 if at is None else at
    data[mid:mid + 16] = bytes(b ^ 0xFF for b in data[mid:mid + 16])
    path.write_bytes(bytes(data))


def _manifest(path):
    return json.loads((path / cache.MANIFEST_NAME).read_text())


def test_quarantine_moves_a_mismatch_and_seals_new_entries(tmp_path, caplog):
    a, b = tmp_path / "libwaffle_a.so", tmp_path / "libwaffle_b.so"
    a.write_bytes(b"\x00" * 256)
    b.write_bytes(b"\x01" * 256)
    (tmp_path / "notes.txt").write_text("not an entry")
    assert cache.quarantine_corrupt_entries(tmp_path) == []
    assert sorted(_manifest(tmp_path)) == ["libwaffle_a.so", "libwaffle_b.so"]
    _flip(a)
    with caplog.at_level(logging.WARNING, logger="waffle_con_tpu_torch"):
        assert cache.quarantine_corrupt_entries(tmp_path) == [
            "libwaffle_a.so"]
    assert not a.exists()
    assert (tmp_path / cache.QUARANTINE_DIR / "libwaffle_a.so").exists()
    assert sorted(_manifest(tmp_path)) == ["libwaffle_b.so"]
    assert [e["entry"] for e in events.get_events("cache_quarantine")] == [
        "libwaffle_a.so"]
    assert any("quarantined corrupt" in r.getMessage() for r in caplog.records)


def test_corrupted_native_library_is_quarantined_rebuilt_and_loaded(
        native_dir):
    cache.seal(native_dir)
    sealed = _manifest(native_dir.parent)[native_dir.name]
    _flip(native_dir)
    lib = TN.load_library()
    assert cache.last_checks[native_dir.name] == "quarantined"
    assert (native_dir.parent / cache.QUARANTINE_DIR
            / native_dir.name).exists()
    # rebuilt from the source, sealed, and the rebuild is what loaded
    assert lib._name == str(native_dir)
    assert _manifest(native_dir.parent)[native_dir.name] == sealed
    assert cache._sha256_file(native_dir) == sealed
    assert TN.native_wfa_ed(b"ACGT", b"AGGT") == 1
    assert [e["entry"] for e in events.get_events("cache_quarantine")] == [
        native_dir.name]


def test_library_without_manifest_entry_is_sealed(native_dir):
    lib = TN.load_library()
    assert cache.last_checks[native_dir.name] == "sealed"
    assert lib._name == str(native_dir)
    assert _manifest(native_dir.parent)[native_dir.name] == (
        cache._sha256_file(native_dir))
    assert events.get_events("cache_quarantine") == []
    # a second check finds it in the manifest
    assert cache.check_library(native_dir) == "verified"


def test_cache_corrupt_fault_records_its_events(tmp_path):
    """The armed fault flips the first library of the directory before
    the check; the check quarantines it and the loader builds again."""
    lib = tmp_path / "libwaffle_kernels-test.so"
    builds = []

    def build():
        if not lib.exists():
            builds.append(1)
            lib.write_bytes(bytes(range(256)) * 4)
            cache.seal(lib)
        return lib

    assert cache.load_checked(build, str) == str(lib)
    assert cache.last_checks[lib.name] == "verified"
    faults.install(faults.FaultPlan()).add("cache_corrupt")
    assert cache.load_checked(build, str) == str(lib)
    assert cache.last_checks[lib.name] == "quarantined"
    assert len(builds) == 2
    assert [e["entry"] for e in events.get_events(
        "cache_corruption_injected")] == [lib.name]
    assert [e["entry"] for e in events.get_events("cache_quarantine")] == [
        lib.name]
    # the rule fired once (count 1): the next load verifies
    assert cache.load_checked(build, str) == str(lib)
    assert cache.last_checks[lib.name] == "verified"
    assert "cache_corrupt" in faults.FAULT_KINDS


def test_corrupt_manifest_is_rebuilt(tmp_path, caplog):
    lib = tmp_path / "libwaffle_a.so"
    lib.write_bytes(b"\x02" * 64)
    (tmp_path / cache.MANIFEST_NAME).write_text("{not json")
    with caplog.at_level(logging.WARNING, logger="waffle_con_tpu_torch"):
        assert cache.check_library(lib) == "sealed"
    assert any("corrupt build-cache manifest" in r.getMessage()
               for r in caplog.records)
    assert list(_manifest(tmp_path)) == ["libwaffle_a.so"]


def test_kernel_library_load_is_checked(tmp_path, monkeypatch):
    """``cuda_build.library()`` loads through the same check (the build
    stubbed: a copy of the C++ library stands in for the kernels')."""
    lib = tmp_path / "libwaffle_kernels-stub.so"
    shutil.copyfile(TN.build(), lib)
    monkeypatch.setattr(cuda_build, "build", lambda verbose=False: lib)
    monkeypatch.setattr(cuda_build, "_lib", None)
    loaded = cuda_build.library()
    assert isinstance(loaded, ctypes.CDLL)
    assert cache.last_checks[lib.name] == "sealed"
    assert os.path.exists(tmp_path / cache.MANIFEST_NAME)
