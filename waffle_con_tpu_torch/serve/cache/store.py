"""Bounded content-addressed stores for the consensus cache.

The port of ``waffle_con_tpu``'s ``serve/cache/store.py``.
:class:`ResultStore` and :class:`CheckpointStore` are in-memory LRU maps
(OrderedDict move-to-end on hit, popitem(last=False) on overflow).
Entries hold only plain JSON types — results travel in the
:mod:`waffle_con_tpu_torch.serve.procs.wire` result codec form and
checkpoints in the :class:`~waffle_con_tpu_torch.models.checkpoint.
SearchCheckpoint` wire-dict form — so every cache hit decodes fresh
objects and a served result can never be aliased/mutated by one client
into another's answer.

:class:`FileStore` is the optional persistence layer for results
(``ServeConfig.cache_dir``), following the build cache's hash-sealing
(:mod:`waffle_con_tpu_torch.utils.cache`): one ``<key>.json`` file per
entry, a ``MANIFEST.json`` of content sha256 digests beside them, and a
``_quarantine/`` subdir.  A read whose bytes no longer match their
sealed digest (crashed writer, disk fault, injected corruption) is moved
into quarantine and reported as a ``cache_quarantine`` flight trigger —
a corrupt entry is *never* served; the job simply searches from scratch.
The on-disk form is the JAX package's, so either package's cache
directory serves the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.runtime import events

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
QUARANTINE_DIR = "_quarantine"


class ResultStore:
    """LRU of finished results keyed by the canonical request key.

    One entry is ``{"kind", "result", "elements", ...}`` — the
    wire-codec result JSON plus the deposit request's ordered read
    elements (so a permuted duplicate's score vectors can be
    remapped)."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[Dict]:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key: str, entry: Dict) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def items(self) -> List[Tuple[str, Dict]]:
        """Snapshot in LRU order (oldest first) — the proposal tier
        scans it for subset near-misses."""
        return list(self._entries.items())


class CheckpointStore:
    """LRU of final mid-search checkpoints keyed by the deposit job's
    read-multiset digest.

    One entry is ``{"checkpoint", "reads", "config_fp"}`` — the wire
    checkpoint dict, the deposit's read list (hex), and the scoring
    config fingerprint (a resumed engine runs the checkpoint's own
    config, so reuse demands fingerprint equality).  Subset lookup is a
    bounded linear scan: the store caps at tens of entries and multiset
    inclusion is cheap next to the search it saves."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, digest: str, entry: Dict) -> None:
        self._entries[digest] = entry
        self._entries.move_to_end(digest)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def items(self) -> List[Tuple[str, Dict]]:
        return list(self._entries.items())

    def touch(self, digest: str) -> None:
        if digest in self._entries:
            self._entries.move_to_end(digest)


class FileStore:
    """Hash-sealed on-disk result entries under one directory."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.quarantined = 0
        self._manifest = self._load_manifest()

    # -- manifest ------------------------------------------------------

    def _load_manifest(self) -> Dict[str, str]:
        manifest_path = os.path.join(self.path, MANIFEST_NAME)
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
            if not isinstance(manifest, dict):
                raise ValueError("manifest is not a mapping")
            return {str(k): str(v) for k, v in manifest.items()}
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as exc:
            logger.warning(
                "rebuilding corrupt consensus-cache manifest: %r", exc
            )
            return {}

    def _save_manifest(self) -> None:
        manifest_path = os.path.join(self.path, MANIFEST_NAME)
        tmp = f"{manifest_path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(self._manifest, fh, indent=0, sort_keys=True)
            os.replace(tmp, manifest_path)
        except OSError:  # a broken cache disk must never fail a job
            pass

    # -- entries -------------------------------------------------------

    def _entry_path(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def get(self, key: str) -> Optional[Dict]:
        """The sealed entry for ``key``, or ``None`` — a digest
        mismatch or undecodable body quarantines the file and reports
        it; it is never served."""
        full = self._entry_path(key)
        try:
            with open(full, "rb") as fh:
                blob = fh.read()
        except OSError:
            return None
        expected = self._manifest.get(key)
        digest = hashlib.sha256(blob).hexdigest()
        if expected is None or digest != expected:
            self._quarantine(key, full, "digest mismatch")
            return None
        try:
            entry = json.loads(blob.decode("utf-8"))
            if not isinstance(entry, dict):
                raise ValueError("entry is not an object")
        except (UnicodeDecodeError, ValueError) as exc:
            # sealed bytes that don't parse mean the seal itself was
            # written over a bad payload: quarantine, don't trust it
            self._quarantine(key, full, f"undecodable entry: {exc}")
            return None
        return entry

    def put(self, key: str, entry: Dict) -> None:
        full = self._entry_path(key)
        blob = json.dumps(
            entry, sort_keys=True, separators=(",", ":"), allow_nan=False
        ).encode("utf-8")
        tmp = f"{full}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, full)
        except OSError:
            return
        self._manifest[key] = hashlib.sha256(blob).hexdigest()
        self._save_manifest()

    def _quarantine(self, key: str, full: str, why: str) -> None:
        qdir = os.path.join(self.path, QUARANTINE_DIR)
        try:
            os.makedirs(qdir, exist_ok=True)
            shutil.move(full, os.path.join(qdir, os.path.basename(full)))
        except OSError:
            try:
                os.unlink(full)
            except OSError:
                pass
        self._manifest.pop(key, None)
        self._save_manifest()
        self.quarantined += 1
        logger.warning(
            "quarantined corrupt consensus-cache entry %s (%s); the job "
            "will search from scratch", key, why,
        )
        events.record("cache_quarantine", entry=key, why=why)
        obs_flight.trigger(
            "cache_quarantine", cache_dir=self.path, entries=[key],
        )
