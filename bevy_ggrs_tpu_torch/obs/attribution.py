"""Device-time attribution: where does a dispatch actually spend time?

The serve benches measure wall time per tick window, which conflates
three very different costs: host-side work (branch build, argument
assembly, Python driver), device execution (the tick's kernels), and
builds (which should be zero after warmup — the churn gates hold that).

Counterpart of ``bevy_ggrs_tpu/obs/attribution.py``:

- **host vs device**: CUDA launches are asynchronous — the tick returns
  once its work is *enqueued*. :meth:`AttributionProbe.device_wait`
  records a CUDA event where it opens and one where it closes, then
  ``torch.cuda.synchronize()``: the host clock over the window is the
  residual device wait (the JAX package's ``jax.block_until_ready``),
  and the events' elapsed time (``device_event_ms``) the stream's clock
  over the same window. The stream's clock counts the card's idle gaps
  too: where the host enqueues the work inside the window, the two
  agree, and only a window opened after the work was enqueued reads the
  card's own time. On the CPU the window is a plain host timer.
- **build events**: deltas of ``utils.build_cache``'s counters (kernel
  and native builds, layout preparations) over the window, so a row that
  built something is flagged instead of mis-read as device time.
- **kernel-level detail** (optional): :func:`profile_window` runs a
  window under ``torch.profiler`` when a logdir is given and writes its
  Chrome trace there (the JAX package's ``jax.profiler.trace``).

The lane-serialization verdict compares the batched device wait with
``lanes x`` a serial one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from ..utils.build_cache import compile_counters


def _cuda_live() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def profile_window(logdir: Optional[str]):
    """``torch.profiler`` around a block when ``logdir`` is given, its
    Chrome trace written to ``<logdir>/trace.json`` (CPU and, with a
    GPU, CUDA activity); a no-op otherwise."""
    if not logdir:
        yield
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class AttributionProbe:
    """Accumulates host-enqueue time and device-wait time over a window
    of dispatches.

    Usage (the bench pattern)::

        probe = AttributionProbe()
        with probe.host():
            core.tick(work)              # returns at enqueue
        with probe.device_wait():
            pass                         # closing synchronizes the card
        row.update(probe.result(lanes=S, serial_device_ms=base))
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.host_ms = 0.0
        self.device_ms = 0.0
        self.device_event_ms = 0.0  # CUDA events' elapsed time, summed
        self.event_windows = 0  # device windows timed by CUDA events
        self.dispatches = 0
        self._nested_ms = 0.0
        self._counters0 = dict(compile_counters())
        self._counters_end = None

    @contextlib.contextmanager
    def host(self):
        """Time a host window. ``device_wait`` windows that open INSIDE
        this one are excluded from the host total (and counted as device
        time, as always): on backends where dispatch can block on the
        in-flight computation — XLA:CPU admits one — the executor call
        itself absorbs device execution, and without the exclusion that
        device time masquerades as host work and the verdict lies."""
        t0 = self._clock()
        nested0 = self._nested_ms
        try:
            yield
        finally:
            elapsed = (self._clock() - t0) * 1000.0
            self.host_ms += max(
                0.0, elapsed - (self._nested_ms - nested0)
            )
            self.dispatches += 1

    @contextlib.contextmanager
    def device_wait(self):
        """Time a device window: work enqueued inside it and everything
        still in flight when it closes (it ends with
        ``torch.cuda.synchronize()`` when CUDA is in use)."""
        import torch

        cuda = _cuda_live()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = self._clock()
        try:
            yield
        finally:
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize()
                self.device_event_ms += start.elapsed_time(end)
                self.event_windows += 1
            elapsed = (self._clock() - t0) * 1000.0
            self.device_ms += elapsed
            self._nested_ms += elapsed

    def snapshot_compiles(self) -> None:
        """Freeze the compile-counter window here. Call at the end of
        the measured region when other compiling work (baselines, parity
        oracles) runs between measurement and :meth:`result` — otherwise
        their compiles masquerade as the probe's."""
        self._counters_end = dict(compile_counters())

    def compile_delta(self) -> Dict[str, int]:
        now = (
            self._counters_end
            if self._counters_end is not None
            else compile_counters()
        )
        return {
            k: int(now.get(k, 0)) - int(self._counters0.get(k, 0))
            for k in set(now) | set(self._counters0)
        }

    def result(
        self,
        lanes: int = 1,
        serial_device_ms: Optional[float] = None,
        min_activity_ms: float = 0.01,
        cost: Optional[Dict[str, float]] = None,
    ) -> Dict[str, object]:
        """The breakdown + verdict for one bench row.

        ``lanes`` is the batch width S; ``serial_device_ms`` is the
        measured per-dispatch device wait of the S=1 baseline, which
        makes the lane-serialization test possible: if the batched
        device wait is close to ``lanes ×`` the serial wait, the backend
        ran the lanes serially and the verdict says so (that row's
        ceiling is the backend, not the host).

        ``min_activity_ms`` is the idle floor: when the per-dispatch
        host+device total sits below it, the host/device split is noise
        over noise and the verdict is ``idle`` — not a coin-flip
        ``balanced`` that reads as a real finding.

        ``cost`` joins the cost observatory
        (:func:`bevy_ggrs_tpu_torch.utils.build_cache.record_executable_cost`):
        given ``flops``/``hbm_peak_bytes`` for the dispatched executable,
        the row gains achieved FLOP/s over the measured device window and
        ``hbm_peak_bytes``; ``mfu`` is emitted only when the caller has
        declared the device's peak (``GGRS_PEAK_FLOPS`` env, FLOP/s) —
        an MFU against an assumed peak would be fiction.

        Where CUDA events timed the device windows, the row also carries
        ``attr_device_event_ms``, the stream's elapsed time over them per
        dispatch (a port-only key; on the CPU the row is the JAX
        package's).
        """
        n = max(self.dispatches, 1)
        total = self.host_ms + self.device_ms
        host_frac = self.host_ms / total if total > 0 else 0.0
        delta = self.compile_delta()
        out: Dict[str, object] = {
            "attr_host_ms": self.host_ms / n,
            "attr_device_ms": self.device_ms / n,
            "attr_host_frac": round(host_frac, 4),
            "attr_dispatches": self.dispatches,
            "attr_compiles": int(delta.get("backend_compiles", 0)),
        }
        if self.event_windows:
            # The stream's clock over the device windows, beside the host's.
            out["attr_device_event_ms"] = self.device_event_ms / n
        per_dispatch_total = total / n
        verdict = "host_bound" if host_frac >= 0.6 else (
            "device_bound" if host_frac <= 0.4 else "balanced"
        )
        if per_dispatch_total < min_activity_ms:
            verdict = "idle"
        if serial_device_ms is not None and lanes > 1:
            per_dispatch_device = self.device_ms / n
            ratio = (
                per_dispatch_device / serial_device_ms
                if serial_device_ms > 1e-6 else 0.0
            )
            out["attr_lane_ratio"] = round(ratio, 3)
            # Device wait scaling with lane count (>= half of perfectly
            # serial) means the lanes did NOT run in parallel.
            if verdict == "device_bound" and ratio >= 0.5 * lanes:
                verdict = "lane_serialized"
        out["attr_verdict"] = verdict
        if cost:
            device_s = (self.device_ms / n) / 1000.0
            flops = float(cost.get("flops", 0.0) or 0.0)
            if flops > 0.0 and device_s > 0.0:
                achieved = flops / device_s
                out["achieved_flops_per_s"] = round(achieved, 1)
                peak = _declared_peak_flops()
                if peak:
                    out["mfu"] = round(achieved / peak, 5)
            if cost.get("hbm_peak_bytes"):
                out["hbm_peak_bytes"] = int(cost["hbm_peak_bytes"])
            if cost.get("bytes_accessed"):
                out["attr_bytes_accessed"] = int(cost["bytes_accessed"])
        return out


def _declared_peak_flops() -> Optional[float]:
    """The device's peak FLOP/s, only if the operator declared it
    (``GGRS_PEAK_FLOPS``, plain float FLOP/s).
    No built-in device table: an undeclared peak yields no ``mfu``
    column rather than a number computed against a guess."""
    import os

    raw = os.environ.get("GGRS_PEAK_FLOPS", "")
    try:
        peak = float(raw)
    except ValueError:
        return None
    return peak if peak > 0 else None
