"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` at first CUDA use into ``bevy_ggrs_tpu_torch/_build/`` and loaded
with ``ctypes``; the library's file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source builds
anew. Nothing here runs at import time, so the package imports on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

KERNELS = ("checksum", "pairwise", "pairwise_mxu", "pairwise_tri", "cell_gather")

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_functions: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in [_SRC / f"{name}.cu", *sorted(_SRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return _OUT / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for one already built); the compiler's output, with
    ptxas's register and shared-memory report, goes to ``<lib>.log``."""
    _OUT.mkdir(exist_ok=True)
    started = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        log = open(lib.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
        started[name] = (proc, log, tmp, lib, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, lib, t0) in started.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}, see {lib.with_suffix('.log')})")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return seconds


def function(name: str, symbol: str, argtypes) -> object:
    """The C function ``symbol`` of library ``name``, built if needed,
    with its ``argtypes`` set and an ``int`` (``cudaError_t``) result."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
