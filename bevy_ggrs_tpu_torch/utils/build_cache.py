"""Build and preparation accounting: the port's compile counters.

Counterpart of ``bevy_ggrs_tpu/utils/xla_cache.py``. The JAX package
counts XLA backend compiles through jax's monitoring events, and the
serving tier asserts that match churn (admission, retirement, faults,
readmission) compiles nothing after warmup. PyTorch runs eagerly and
compiles no program per shape, so the port counts the events that do
cost a first call its time:

- ``nvcc`` builds of a kernel library and ``g++`` builds of a native
  library (``ops/_build.py``, ``native/build.py``);
- misses of the checksum kernel's layout cache (``ops/checksum.py``: a
  world structure seen for the first time);
- the batched serving tick's first run at a tick structure
  (``serve/batch.py``: world leaves, device and branch tensor), the
  counterpart of JAX compiling the vmapped tick for a new shape.

Each is a "backend compile" here; a library found already built on disk
is a cache hit, and every lookup that could have built is a cache task.
The function names are the JAX module's, so the serving code and
``obs/prom.py``'s compile section read the same counters. Counting is
always on: :func:`install_compile_listeners` has nothing to install and
returns True.

The cost observatory (:func:`record_executable_cost`) runs a callable
once and records the card's peak allocated bytes
(``torch.cuda.max_memory_allocated``) as ``hbm_peak_bytes``; on the CPU
the record is empty, as JAX's is on a backend without memory analysis.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

_lock = threading.Lock()
_COUNTERS = {
    "backend_compiles": 0,
    "cache_tasks": 0,
    "cache_hits": 0,
}
# The port's split of backend_compiles by kind.
_KINDS = {"nvcc": 0, "gxx": 0, "layout": 0, "shape": 0}
_COMPILE_EVENTS: List[dict] = []


def install_compile_listeners() -> bool:
    """Nothing to install: the build and layout paths always report.
    Returns True, as the JAX function does once its listeners are live."""
    return True


def record_compile(kind: str, ms: float, fingerprint: str = "") -> None:
    """One build or preparation of ``kind`` (``nvcc``, ``gxx``,
    ``layout`` or ``shape``) that took ``ms`` milliseconds."""
    with _lock:
        _COUNTERS["backend_compiles"] += 1
        _COUNTERS["cache_tasks"] += 1
        _KINDS[kind] = _KINDS.get(kind, 0) + 1
        _COMPILE_EVENTS.append({"ms": float(ms), "fingerprint": str(fingerprint)})


def record_cache_hit() -> None:
    """A build looked for its library and found it built."""
    with _lock:
        _COUNTERS["cache_tasks"] += 1
        _COUNTERS["cache_hits"] += 1


def compile_counters() -> dict:
    """Snapshot of the process-wide counters (a copy): the JAX keys
    (``backend_compiles``, ``cache_tasks``, ``cache_hits``) and the
    port's split of ``backend_compiles`` (``nvcc_builds``,
    ``gxx_builds``, ``layout_misses``, ``shape_preparations``). Compare
    snapshots around a phase: a churn phase must leave them all as they
    were."""
    with _lock:
        out = dict(_COUNTERS)
        out.update(nvcc_builds=_KINDS["nvcc"], gxx_builds=_KINDS["gxx"],
                   layout_misses=_KINDS["layout"], shape_preparations=_KINDS["shape"])
    return out


def compile_events() -> List[dict]:
    """Per-build wall-time records (copies), in occurrence order."""
    with _lock:
        return [dict(e) for e in _COMPILE_EVENTS]


def compile_summary() -> dict:
    """Aggregate of the per-build wall times, in the JAX module's shape:
    the ``{ns}_xla_compile_ms`` summary ``obs/prom.py`` exports."""
    times = sorted(e["ms"] for e in compile_events())
    if not times:
        return {
            "count": 0,
            "total_ms": 0.0,
            "mean_ms": 0.0,
            "p50_ms": 0.0,
            "max_ms": 0.0,
            "fingerprints": [],
        }
    total = float(sum(times))
    return {
        "count": len(times),
        "total_ms": round(total, 3),
        "mean_ms": round(total / len(times), 3),
        "p50_ms": round(times[len(times) // 2], 3),
        "max_ms": round(times[-1], 3),
        "fingerprints": sorted(
            {e["fingerprint"] for e in compile_events() if e["fingerprint"]}
        ),
    }


class timed:
    """``with timed(kind, fingerprint):`` records one build of ``kind``
    with its wall time when the block completes."""

    def __init__(self, kind: str, fingerprint: str = ""):
        self.kind, self.fingerprint = kind, fingerprint

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            record_compile(self.kind, (time.perf_counter() - self.t0) * 1000.0,
                           self.fingerprint)
        return False


_EXEC_COSTS: Dict[str, dict] = {}


def priced_call(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its peak device bytes recorded under
    ``name`` (``hbm_peak_bytes``, from ``torch.cuda.max_memory_allocated``
    after a reset of the peak) the first time the name is seen. Without a
    GPU the record is ``{}``. Returns what ``fn`` returns."""
    import torch

    if name in _EXEC_COSTS or not torch.cuda.is_available():
        _EXEC_COSTS.setdefault(name, {})
        return fn(*args, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    _EXEC_COSTS[name] = {"hbm_peak_bytes": float(torch.cuda.max_memory_allocated())}
    return result


def record_executable_cost(name: str, fn: Callable, *args, **kwargs) -> dict:
    """Price ``fn`` for these arguments once under ``name`` (one call,
    through :func:`priced_call`); later calls with the same name return the
    cached record without running ``fn``."""
    if name not in _EXEC_COSTS:
        priced_call(name, fn, *args, **kwargs)
    return dict(_EXEC_COSTS[name])


def executable_costs() -> Dict[str, dict]:
    """Snapshot of every priced callable: name -> cost record."""
    return {k: dict(v) for k, v in _EXEC_COSTS.items()}
