"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into one
object each — all compilers started together — and the objects link into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by the hash of every source (``*.cu`` and ``*.cuh``)
and of the code-generation flags, and lives in :data:`BUILD_DIR` (listed
in ``.gitignore``), so an edited source rebuilds and an unchanged one is
reused.  Nothing is built when a module is imported: the first kernel
launch (or an explicit :func:`build`) does it.  A library is sealed into
the build directory's manifest when it lands and checked against it
before it is loaded (:mod:`waffle_con_tpu_torch.utils.cache`): one
whose bytes changed is quarantined and built again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from waffle_con_tpu_torch.utils import cache

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: build directory of the compiled kernels (listed in .gitignore)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()
#: wall seconds of the last ``nvcc`` build of the library in this process
#: (0.0 when it came from the build directory), and the compilers' output
build_info = {"seconds": 0.0, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    """The kernel sources, in name order."""
    return sorted(CSRC.glob("*.cu"))


def _compile(nvcc: str, flags, out_dir: str):
    """Compile every source to an object in ``out_dir``, one compiler per
    source, all started together.  Returns the objects, the compilers'
    output and whether any failed."""
    procs = []
    for src in sources():
        obj = os.path.join(out_dir, src.stem + ".o")
        procs.append((obj, subprocess.Popen(
            [nvcc, *flags, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], False
    for _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        failed |= proc.returncode != 0
    return [obj for obj, _ in procs], "".join(log), failed


def build(verbose: bool = False) -> Path:
    """Compile every kernel source into one shared library in
    :data:`BUILD_DIR` and return its path.  ``verbose`` adds ``-Xptxas
    -v`` (registers, shared memory and spills per kernel) to the recorded
    build log; it does not change the code, so it is not part of the
    library's name, and a cached library is compiled again (objects
    only, into a temporary directory) to produce that report."""
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libwaffle_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, log, failed = _compile(nvcc, flags, tmp)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        build_info["log"] = log
        if lib.exists():
            return lib
        out_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", out_so, *objs],
            capture_output=True, text=True,
        )
        build_info["log"] += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_info['log']}")
        build_info["seconds"] = time.perf_counter() - t0
        os.replace(out_so, lib)
    cache.seal(lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, checked against the
    build cache's manifest before it is loaded)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = cache.load_checked(build, ctypes.CDLL)
    return _lib


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a launch argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
