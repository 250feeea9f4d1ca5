"""Build the port's native host libraries with ``g++`` (no pybind11).

Each ``.cpp`` of this directory compiles to
``bevy_ggrs_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source builds anew and no library is
ever written beside its source. A build runs at first use, never at import.
The compiler writes to a temporary named by the process id, which
``os.replace`` then moves into place: several processes (test workers, the
peers of one machine) may build the same library at once.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_OUT = _DIR.parent / "_build"

CORE = "session_core"
UDP = "udp_poller"

_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update((_DIR / f"{name}.cpp").read_bytes())
    return _OUT / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The library of ``native/<name>.cpp``, compiled if it is not built
    yet. Raises ``RuntimeError`` with the compiler's message on failure."""
    from bevy_ggrs_tpu_torch.utils import build_cache

    lib = library_path(name)
    if lib.exists():
        build_cache.record_cache_hit()
        return lib
    _OUT.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = ["g++", *_FLAGS, str(_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        with build_cache.timed("gxx", lib.name):
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed (rc {done.returncode}):\n"
                                   f"{done.stderr.strip()}")
            os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


if __name__ == "__main__":
    print(build(CORE))
    print(build(UDP))
