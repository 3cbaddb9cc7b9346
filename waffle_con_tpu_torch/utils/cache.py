"""Integrity checks of the port's build cache.

The port builds two shared libraries into its build directory
(``waffle_con_tpu_torch/_build/``, listed in ``.gitignore``): the CUDA
kernels, ``libwaffle_kernels-<hash>.so`` (``ops/cuda_build.py``), and the
C++ engines, ``libwaffle_native-<hash>.so`` (``native/__init__.py``).
Each name hashes its sources and flags, so an edited source builds a new
library; nothing in the name vouches for the bytes on disk.  A library
cut short by a crashed writer, a disk fault or an injected corruption
loads into the process and fails there, or not at all.

So the build directory keeps a JSON manifest of each library's SHA-256,
written when the library is built (:func:`seal`).  Before every
``ctypes.CDLL`` load, :func:`check_library` verifies the directory
against it (:func:`quarantine_corrupt_entries`): a library whose bytes
no longer match moves into ``_quarantine/`` (a WARNING and a
``cache_quarantine`` event) and the loader builds it again; a library
with no manifest entry (built before the manifest existed) is sealed as
it is.  The counterpart of ``waffle_con_tpu``'s ``utils/cache.py``,
which guards XLA's compilation cache the same way.

The manifest is read and written under an exclusive file lock, and
written to a temporary file that replaces it, so processes building and
loading side by side (test workers) never see half a manifest.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

#: manifest and quarantine live inside the build directory
MANIFEST_NAME = "MANIFEST.json"
QUARANTINE_DIR = "_quarantine"
#: the entries the manifest covers: the libraries the port loads
ENTRY_PREFIX = "libwaffle_"

#: library name -> the outcome of its last check in this process:
#: ``"verified"``, ``"sealed"`` or ``"quarantined"`` (then rebuilt)
last_checks: Dict[str, str] = {}


def _sha256_file(path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def cache_entries(path) -> List[Tuple[str, str]]:
    """``(name, full path)`` of every library in the build directory
    ``path``, in name order (temporary files of a build in progress, the
    manifest and the quarantine are not entries)."""
    try:
        names = sorted(os.listdir(path))
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        full = os.path.join(path, name)
        if (name.startswith(ENTRY_PREFIX) and name.endswith(".so")
                and os.path.isfile(full)):
            out.append((name, full))
    return out


@contextlib.contextmanager
def _locked(path):
    """An exclusive lock of the build directory's manifest."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, MANIFEST_NAME + ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _load_manifest(path) -> dict:
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not a mapping")
        return manifest
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as exc:
        # a corrupt manifest is rebuilt: the libraries it vouched for
        # are sealed again as they are
        logger.warning("rebuilding corrupt build-cache manifest: %r", exc)
        return {}


def _save_manifest(path, manifest: dict) -> None:
    fd, tmp = tempfile.mkstemp(prefix=".manifest-", dir=path)
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))


def seal(lib) -> None:
    """Record the SHA-256 of the library at ``lib`` in its directory's
    manifest (the builders call it right after a library lands)."""
    lib = Path(lib)
    with _locked(lib.parent):
        manifest = _load_manifest(lib.parent)
        manifest[lib.name] = _sha256_file(lib)
        _save_manifest(lib.parent, manifest)


def _scan(path) -> Tuple[List[str], List[str]]:
    """Verify every entry of ``path`` against the manifest: mismatches
    move to the quarantine, new entries are sealed, rows of vanished
    entries dropped.  Returns ``(quarantined, sealed)`` names."""
    quarantined, sealed = [], []
    with _locked(path):
        manifest = _load_manifest(path)
        changed = False
        for name, full in cache_entries(path):
            digest = _sha256_file(full)
            expected = manifest.get(name)
            if expected is None:
                manifest[name] = digest
                sealed.append(name)
                changed = True
            elif digest != expected:
                qdir = os.path.join(path, QUARANTINE_DIR)
                os.makedirs(qdir, exist_ok=True)
                shutil.move(full, os.path.join(qdir, name))
                del manifest[name]
                quarantined.append(name)
                changed = True
        for name in list(manifest):
            if not os.path.isfile(os.path.join(path, name)):
                del manifest[name]
                changed = True
        if changed:
            _save_manifest(path, manifest)
    from waffle_con_tpu_torch.runtime import events

    for name in quarantined:
        logger.warning(
            "quarantined corrupt build-cache entry %s (hash mismatch); "
            "it will be rebuilt", name,
        )
        events.record("cache_quarantine", entry=name)
    return quarantined, sealed


def quarantine_corrupt_entries(path) -> List[str]:
    """Verify every library in the build directory ``path`` against the
    manifest; move mismatches into ``_quarantine/`` (so the library is
    rebuilt instead of loaded) and seal new entries into the manifest.
    Returns the quarantined names."""
    return _scan(path)[0]


def check_library(lib) -> str:
    """The check before a load of the library at ``lib``: the armed
    ``cache_corrupt`` fault first (``runtime/faults.py``), then the
    directory verified (:func:`quarantine_corrupt_entries`).  Returns
    ``"quarantined"`` (the library is gone: build it again),
    ``"sealed"`` (it had no manifest entry) or ``"verified"``."""
    from waffle_con_tpu_torch.runtime import faults

    lib = Path(lib)
    faults.maybe_corrupt_cache(lib.parent)
    quarantined, sealed = _scan(lib.parent)
    if lib.name in quarantined:
        return "quarantined"
    return "sealed" if lib.name in sealed else "verified"


def load_checked(build, load):
    """``load(path)`` of the library ``build()`` returns, checked first
    (:func:`check_library`): a quarantined library is built again before
    the load.  The outcome is kept in :data:`last_checks`."""
    path = Path(build())
    status = check_library(path)
    if status == "quarantined":
        path = Path(build())
    last_checks[path.name] = status
    return load(str(path))
