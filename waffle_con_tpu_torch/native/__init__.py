"""ctypes bindings of the C++ engine suite, the port's host baseline.

``src/waffle_native.cpp`` is a byte-for-byte copy of the JAX package's
C++ engines; the port keeps its own copy and builds it with ``g++`` into
the port's build directory (``waffle_con_tpu_torch/_build/``, listed in
``.gitignore``), under a name carrying the hash of the source and the
flags.  Nothing is built at import: the first call (or an explicit
:func:`build`) compiles to a temporary file and renames it into place,
so a process never loads a half-written library, and the library is
sealed into the build cache's manifest and checked before each load
(:mod:`waffle_con_tpu_torch.utils.cache`).  Provides:

* :class:`NativeScorer` — the C++ branch store behind the scorer seam
  (``backend="native"``);
* :func:`native_consensus`, :func:`native_dual_consensus`,
  :func:`native_priority_consensus` — the complete C++ single, dual and
  priority engines, the yardstick the port's device path is measured
  against;
* :func:`native_wfa_ed` — one-shot edit distance.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models.consensus import Consensus, EngineError
from waffle_con_tpu_torch.models.dual_consensus import DualConsensus
from waffle_con_tpu_torch.models.priority_consensus import PriorityConsensus
from waffle_con_tpu_torch.ops.cuda_build import BUILD_DIR
from waffle_con_tpu_torch.ops.scorer import BranchStats, WavefrontScorer
from waffle_con_tpu_torch.utils import cache

SRC = Path(__file__).resolve().parent / "src" / "waffle_native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall seconds of the last ``g++`` build in this process (0.0 when the
#: library came from the build directory)
build_info = {"seconds": 0.0}

_I64 = ctypes.c_longlong
_I64P = ctypes.POINTER(_I64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwaffle_native-{digest.hexdigest()[:16]}.so"


def build(rebuild: bool = False) -> Path:
    """Compile the C++ engines into :func:`library_path` (reused when it
    exists, unless ``rebuild``) and return the path."""
    lib = library_path()
    if lib.exists() and not rebuild:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                capture_output=True, text=True,
            )
        except FileNotFoundError as exc:
            raise NativeBuildError(f"native build failed: {exc}") from exc
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed:\n{proc.stderr[-4000:]}"
            )
        build_info["seconds"] = time.perf_counter() - t0
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    cache.seal(lib)
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = cache.load_checked(build, ctypes.CDLL)

        lib.wn_scorer_new.restype = ctypes.c_void_p
        lib.wn_scorer_new.argtypes = [
            _U8P, _I64P, _I64, _U8P, _I64, ctypes.c_int, ctypes.c_int,
        ]
        lib.wn_scorer_free.argtypes = [ctypes.c_void_p]
        lib.wn_root.restype = _I64
        lib.wn_root.argtypes = [ctypes.c_void_p, _U8P]
        lib.wn_clone.restype = _I64
        lib.wn_clone.argtypes = [ctypes.c_void_p, _I64]
        lib.wn_free_branch.argtypes = [ctypes.c_void_p, _I64]
        lib.wn_push.argtypes = [
            ctypes.c_void_p, _I64, _U8P, _I64, _I64P, _I64P, _I64P, _U8P,
        ]
        lib.wn_stats.argtypes = lib.wn_push.argtypes
        lib.wn_activate.argtypes = [
            ctypes.c_void_p, _I64, _I64, _I64, _U8P, _I64,
        ]
        lib.wn_deactivate.argtypes = [ctypes.c_void_p, _I64, _I64]
        lib.wn_finalized_eds.argtypes = [
            ctypes.c_void_p, _I64, _U8P, _I64, _I64P,
        ]
        lib.wn_wfa_ed.restype = _I64
        lib.wn_wfa_ed.argtypes = [
            _U8P, _I64, _U8P, _I64, ctypes.c_int, ctypes.c_int,
        ]
        lib.wn_consensus.restype = ctypes.c_int
        lib.wn_consensus.argtypes = [
            _U8P, _I64P, _I64, _I64P, _I64P, ctypes.c_double,
            ctypes.POINTER(_U8P), _I64P,
        ]
        lib.wn_dual_consensus.restype = ctypes.c_int
        lib.wn_dual_consensus.argtypes = [
            _U8P, _I64P, _I64, _I64P, _I64P, ctypes.c_double,
            ctypes.POINTER(_U8P), _I64P,
        ]
        lib.wn_priority_consensus.restype = ctypes.c_int
        lib.wn_priority_consensus.argtypes = [
            _U8P, _I64P, _I64, _I64, _I64P, _I64P, _I64P, ctypes.c_double,
            ctypes.POINTER(_U8P), _I64P,
        ]
        lib.wn_blob_free.argtypes = [_U8P]
        _lib = lib
        return lib


def _bytes_ptr(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)), _U8P)


def _pack_reads(reads: Sequence[bytes]):
    blob = b"".join(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    return (
        _bytes_ptr(blob),
        lens.ctypes.data_as(_I64P),
        lens,  # keep alive
    )


class NativeScorer(WavefrontScorer):
    """C++ branch store behind the scorer seam."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig) -> None:
        super().__init__(reads, config)
        self._lib = load_library()
        data_ptr, lens_ptr, self._keep = _pack_reads(self.reads)
        symtab = np.asarray(self.symtab, dtype=np.uint8)
        self._ptr = self._lib.wn_scorer_new(
            data_ptr,
            lens_ptr,
            len(self.reads),
            symtab.ctypes.data_as(_U8P),
            len(symtab),
            -1 if config.wildcard is None else config.wildcard,
            1 if config.allow_early_termination else 0,
        )

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.wn_scorer_free(ptr)
            self._ptr = None

    def _out_buffers(self):
        n, a = self.num_reads, self.num_symbols
        eds = np.zeros(n, dtype=np.int64)
        occ = np.zeros((n, a), dtype=np.int64)
        split = np.zeros(n, dtype=np.int64)
        reached = np.zeros(n, dtype=np.uint8)
        return eds, occ, split, reached

    def root(self, active: np.ndarray) -> int:
        act = np.ascontiguousarray(active, dtype=np.uint8)
        return self._lib.wn_root(self._ptr, act.ctypes.data_as(_U8P))

    def clone(self, h: int) -> int:
        return self._lib.wn_clone(self._ptr, h)

    def free(self, h: int) -> None:
        self._lib.wn_free_branch(self._ptr, h)

    def _observe(self, fn, h: int, consensus: bytes) -> BranchStats:
        eds, occ, split, reached = self._out_buffers()
        fn(
            self._ptr, h, _bytes_ptr(consensus), len(consensus),
            eds.ctypes.data_as(_I64P), occ.ctypes.data_as(_I64P),
            split.ctypes.data_as(_I64P), reached.ctypes.data_as(_U8P),
        )
        return BranchStats(eds, occ, split, reached.astype(bool))

    def push(self, h: int, consensus: bytes) -> BranchStats:
        return self._observe(self._lib.wn_push, h, consensus)

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        return self._observe(self._lib.wn_stats, h, consensus)

    def activate(self, h: int, read_index: int, offset: int, consensus: bytes) -> None:
        self._lib.wn_activate(
            self._ptr, h, read_index, offset, _bytes_ptr(consensus), len(consensus)
        )

    def deactivate(self, h: int, read_index: int) -> None:
        self._lib.wn_deactivate(self._ptr, h, read_index)

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        eds = np.zeros(self.num_reads, dtype=np.int64)
        self._lib.wn_finalized_eds(
            self._ptr, h, _bytes_ptr(consensus), len(consensus),
            eds.ctypes.data_as(_I64P),
        )
        return eds


def native_wfa_ed(
    v1: bytes, v2: bytes, require_both_end: bool = True,
    wildcard: Optional[int] = None,
) -> int:
    lib = load_library()
    return lib.wn_wfa_ed(
        _bytes_ptr(v1), len(v1), _bytes_ptr(v2), len(v2),
        1 if require_both_end else 0,
        -1 if wildcard is None else wildcard,
    )


_ENGINE_ERRORS = {
    1: "Must have at least one initial offset of None to see the consensus.",
    2: "Encountered coverage gap",  # detail-less fallback; the engine
    # normally attaches [top_len, max_activate] for the full message
    3: "Finalize called on DWFA that was never initialized.",
    4: "internal invariant violated: activating an already-active read",
}


class _BlobReader:
    def __init__(self, raw: bytes) -> None:
        self.raw = raw
        self.pos = 0

    def i64(self) -> int:
        (v,) = struct.unpack_from("<q", self.raw, self.pos)
        self.pos += 8
        return v

    def data(self) -> bytes:
        n = self.i64()
        out = self.raw[self.pos : self.pos + n]
        self.pos += n
        return out

    def vec(self) -> List[int]:
        return [self.i64() for _ in range(self.i64())]


def _int_cfg_base(cfg: CdwfaConfig) -> List[int]:
    return [
        1 if cfg.consensus_cost is ConsensusCost.L2_DISTANCE else 0,
        cfg.max_queue_size,
        cfg.max_capacity_per_size,
        cfg.max_return_size,
        cfg.max_nodes_wo_constraint,
        cfg.min_count,
        -1 if cfg.wildcard is None else cfg.wildcard,
        1 if cfg.allow_early_termination else 0,
        1 if cfg.auto_shift_offsets else 0,
        cfg.offset_window,
        cfg.offset_compare_length,
    ]


def _int_cfg_dual(cfg: CdwfaConfig) -> np.ndarray:
    return np.array(
        _int_cfg_base(cfg)
        + [1 if cfg.weighted_by_ed else 0, cfg.dual_max_ed_delta],
        dtype=np.int64,
    )


def _check_offsets(offsets, n: int, what: str = "offsets"):
    if len(offsets) != n:
        raise EngineError(
            f"{what} must have one entry per sequence "
            f"({len(offsets)} != {n})"
        )


def _call_blob(fn, *args):
    """Invoke a blob-returning engine entry; raises EngineError on rc != 0.

    Error rc 2 (coverage gap) carries a 2x i64 detail blob so the raised
    message matches the reference exactly, lengths included."""
    lib = load_library()
    blob = _U8P()
    size = _I64(0)
    rc = fn(lib, *args, ctypes.byref(blob), ctypes.byref(size))
    if rc != 0:
        detail = b""
        if blob and size.value > 0:
            detail = ctypes.string_at(blob, size.value)
            lib.wn_blob_free(blob)
        if rc == 2 and len(detail) == 16:
            top_len, max_activate = struct.unpack("<qq", detail)
            raise EngineError(
                f"Encountered coverage gap: consensus is length {top_len} "
                f"with no candidates, but sequences activate at {max_activate}"
            )
        raise EngineError(_ENGINE_ERRORS.get(rc, f"native engine error {rc}"))
    try:
        return ctypes.string_at(blob, size.value)
    finally:
        lib.wn_blob_free(blob)


def _read_dual_results(reader: _BlobReader, cost: ConsensusCost):
    """Decode the dual-result blob into DualConsensus objects."""
    results = []
    n_results = reader.i64()
    for _ in range(n_results):
        cons1 = reader.data()
        has2 = reader.i64()
        cons2 = reader.data() if has2 else None
        n = reader.i64()
        is_cons1 = [bool(reader.i64()) for _ in range(n)]
        scores1 = [None if v < 0 else v for v in reader.vec()]
        scores2 = [None if v < 0 else v for v in reader.vec()]
        c1_scores = reader.vec()
        c2_scores = reader.vec()
        c1 = Consensus(cons1, cost, c1_scores)
        c2 = Consensus(cons2, cost, c2_scores) if has2 else None
        results.append(
            DualConsensus(c1, c2, is_cons1, scores1, scores2)
        )
    return results


def native_dual_consensus(
    reads: Sequence[bytes],
    offsets: Optional[Sequence[Optional[int]]] = None,
    config: Optional[CdwfaConfig] = None,
) -> List[DualConsensus]:
    """Run the full C++ dual-consensus engine; returns the same
    ``List[DualConsensus]`` the port's dual engine produces."""
    cfg = config if config is not None else CdwfaConfig()
    if offsets is None:
        offsets = [None] * len(reads)
    _check_offsets(offsets, len(reads))
    data_ptr, lens_ptr, _keep = _pack_reads([bytes(r) for r in reads])
    offs = np.array([-1 if o is None else o for o in offsets], dtype=np.int64)
    int_cfg = _int_cfg_dual(cfg)

    raw = _call_blob(
        lambda lib, *a: lib.wn_dual_consensus(*a),
        data_ptr, lens_ptr, len(reads), offs.ctypes.data_as(_I64P),
        int_cfg.ctypes.data_as(_I64P), cfg.min_af,
    )
    return _read_dual_results(_BlobReader(raw), cfg.consensus_cost)


def native_priority_consensus(
    chains: Sequence[Sequence[bytes]],
    offsets: Optional[Sequence[Sequence[Optional[int]]]] = None,
    seed_groups: Optional[Sequence[Optional[int]]] = None,
    config: Optional[CdwfaConfig] = None,
) -> PriorityConsensus:
    """Run the full C++ priority (chained multi) consensus engine; returns
    the same ``PriorityConsensus`` the port's priority engine produces."""
    cfg = config if config is not None else CdwfaConfig()
    if not chains:
        raise EngineError("Must provide a non-empty sequences Vec")
    n_levels = len(chains[0])
    if n_levels == 0:
        raise EngineError("Must provide a non-empty sequences Vec")
    for chain in chains:
        if len(chain) != n_levels:
            raise EngineError(
                f"Expected sequences Vec of length {n_levels}, "
                f"but got one of length {len(chain)}"
            )
    if offsets is None:
        offsets = [[None] * n_levels for _ in chains]
    if seed_groups is None:
        seed_groups = [None] * len(chains)
    _check_offsets(offsets, len(chains), "offset chains")
    for offset_chain in offsets:
        _check_offsets(offset_chain, n_levels, "offset chain levels")
    _check_offsets(seed_groups, len(chains), "seed_groups")

    flat = b"".join(bytes(s) for chain in chains for s in chain)
    lens = np.array(
        [len(s) for chain in chains for s in chain], dtype=np.int64
    )
    offs = np.array(
        [
            -1 if o is None else o
            for offset_chain in offsets
            for o in offset_chain
        ],
        dtype=np.int64,
    )
    seeds = np.array(
        [-1 if s is None else s for s in seed_groups], dtype=np.int64
    )
    int_cfg = _int_cfg_dual(cfg)

    raw = _call_blob(
        lambda lib, *a: lib.wn_priority_consensus(*a),
        _bytes_ptr(flat), lens.ctypes.data_as(_I64P), len(chains), n_levels,
        offs.ctypes.data_as(_I64P), seeds.ctypes.data_as(_I64P),
        int_cfg.ctypes.data_as(_I64P), cfg.min_af,
    )
    reader = _BlobReader(raw)
    out_chains = []
    for _ in range(reader.i64()):
        chain = []
        for _ in range(reader.i64()):
            seq = reader.data()
            scores = reader.vec()
            chain.append(Consensus(seq, cfg.consensus_cost, scores))
        out_chains.append(chain)
    indices = reader.vec()
    return PriorityConsensus(out_chains, indices)


def native_consensus(
    reads: Sequence[bytes],
    offsets: Optional[Sequence[Optional[int]]] = None,
    config: Optional[CdwfaConfig] = None,
) -> List[Tuple[bytes, List[int]]]:
    """Run the full C++ single-consensus engine; returns
    ``[(sequence, scores), ...]`` sorted lexicographically."""
    cfg = config if config is not None else CdwfaConfig()
    if offsets is None:
        offsets = [None] * len(reads)
    _check_offsets(offsets, len(reads))
    data_ptr, lens_ptr, _keep = _pack_reads([bytes(r) for r in reads])
    offs = np.array(
        [-1 if o is None else o for o in offsets], dtype=np.int64
    )
    int_cfg = np.array(_int_cfg_base(cfg), dtype=np.int64)
    raw = _call_blob(
        lambda lib, *a: lib.wn_consensus(*a),
        data_ptr, lens_ptr, len(reads), offs.ctypes.data_as(_I64P),
        int_cfg.ctypes.data_as(_I64P), cfg.min_af,
    )

    reader = _BlobReader(raw)
    results = []
    for _ in range(reader.i64()):
        sequence = reader.data()
        scores = reader.vec()
        results.append((sequence, scores))
    return results
