"""Span-aware sampling host profiler: WHICH function is the millisecond.

The admission ladder's verdict (knee at 3 adm/s, host-bound) and the
serve-tier host/device split both end at a *number* per stage —
``branch_build_ms``, ``admission_admit_ms`` — with nothing naming the
Python frame the time lives in. This module closes that gap without a
profiler daemon or a dependency: a background thread samples the target
thread's Python stack (``sys._current_frames``) on a seeded-deterministic
~2 ms cadence and folds every sample into the innermost *open obs span*
on that thread (the cross-thread span-stack registry in
:mod:`bevy_ggrs_tpu_torch.obs.trace` — tracer spans, admission stages, and the
dispatch-loop host phases all push markers there).

Outputs:

- **folded stacks** (:meth:`HostProfiler.folded` /
  :meth:`export_folded`): pprof/FlameGraph text, one line per unique
  ``stage;frame;...;leaf`` path with the accumulated self-time in
  integer microseconds — ``flamegraph.pl`` or speedscope load it as-is;
- **per-stage culprit tables** (:meth:`report`): ranked leaf-frame
  self-time per span, the "branch_build_ms is 62% ``_structured_bits``"
  answer bench rows embed as a compact ``profile`` blob
  (:meth:`profile_blob`) that ``tools/bench_gate.py`` diffs against the
  committed baseline when a latency gate trips;
- **a Perfetto counter track** (:meth:`export_perfetto`): stack depth +
  cumulative profiled ms as ``ph:"C"`` events carrying the same
  ``wall_t0`` anchor as SpanTracer exports, so ``obs/merge.py`` aligns
  it with the span timeline;
- **a flame tree** (:meth:`flame_tree`) the HTML ops report renders as a
  self-contained CSS flame graph (no external JS).

Design holds the telemetry bars:

- **wire-inert**: sampling only *reads* interpreter state; it never
  touches sessions, sockets, or the RNGs that shape the wire.
  ``tests/test_telemetry_determinism.py`` proves ON-vs-OFF bitwise.
- **bounded overhead**: the sampled thread pays nothing except brief GIL
  holds while the sampler walks <= ``max_depth`` frames; the enabled
  cost is test-enforced at <= 5% of the frame budget at S=256.
- **deterministic cadence**: the inter-sample jitter comes from a seeded
  ``random.Random`` so two profiled runs sample on the same schedule
  relative to their start (the wall-clock phase still differs — this is
  about reproducible *density*, not reproducible stacks).
- **self-time accounting**: each sample is weighted by the measured gap
  since the previous sample (capped at ``gap_cap_ms`` so a suspended
  process can't bill hours to one frame), and the weight goes to the
  *leaf* frame — the folded sums are self-time, not inclusive time, so
  per-stage tables rank actual CPU culprits.

Samples whose Python stack is unreadable (target thread gone, depth 0)
are counted in a separate unattributed bucket; :meth:`attributed_frac`
reports the attributed share, optionally restricted to a stage prefix
(the acceptance bar: >= 95% over the five ``admission_*`` stages).
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from .trace import open_span_stack

#: Stage bucket for samples taken while no obs span is open.
NO_SPAN = "(no_span)"
#: Leaf bucket for samples whose Python stack could not be read.
UNATTRIBUTED = "(unattributed)"


def _frame_label(frame) -> str:
    """Stable frame id: ``func (file.py)``. No line numbers — they shift
    between commits and would make baseline profile diffs noisy."""
    code = frame.f_code
    return f"{code.co_name} ({os.path.basename(code.co_filename)})"


class HostProfiler:
    """Sampling profiler for one target thread (the main thread unless
    told otherwise). Use :meth:`start`/:meth:`stop` for the background
    thread, or drive :meth:`sample_once` directly (tests inject stacks
    and spans there for determinism)."""

    enabled = True

    def __init__(
        self,
        interval_ms: float = 2.0,
        seed: int = 0,
        target_thread: Optional[int] = None,
        top_k: int = 8,
        clock=time.perf_counter,
        max_depth: int = 24,
        gap_cap_ms: float = 250.0,
        pid: int = 0,
        process_name: Optional[str] = None,
        wall_t0: Optional[float] = None,
        track_capacity: int = 100_000,
    ):
        self.interval_ms = float(interval_ms)
        self.seed = int(seed)
        self.top_k = int(top_k)
        self.max_depth = int(max_depth)
        self.gap_cap_ms = float(gap_cap_ms)
        self.pid = int(pid)
        self.process_name = process_name
        self.wall_t0 = time.time() if wall_t0 is None else float(wall_t0)
        self._target = (
            int(target_thread)
            if target_thread is not None
            else threading.main_thread().ident
        )
        self._clock = clock
        self._rng = random.Random(self.seed)
        # (stage, frame-path root->leaf) -> accumulated self-time ms
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], float] = {}
        # stage -> leaf frame -> self-time ms (the culprit tables)
        self._self_ms: Dict[str, Dict[str, float]] = {}
        self._stage_ms: Dict[str, float] = {}
        self._unattributed_ms = 0.0
        self._samples = 0
        self._unattributed_samples = 0
        # counter-track samples: (ts_us since start, stack depth, total ms)
        self._track = collections.deque(maxlen=int(track_capacity))
        self._origin = clock()
        self._last_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    # -- sampling --------------------------------------------------------

    def sample_once(
        self,
        now: Optional[float] = None,
        frames: Optional[List[str]] = None,
        span_stack: Optional[Tuple[str, ...]] = None,
    ) -> Optional[str]:
        """Take one sample and fold it. ``frames`` (root-first labels)
        and ``span_stack`` are injectable for deterministic tests; the
        production path reads ``sys._current_frames()`` and the span
        registry. Returns the stage the sample folded into."""
        now = self._clock() if now is None else now
        if self._last_t is None:
            weight = self.interval_ms  # nominal first-sample weight
        else:
            weight = min(
                max((now - self._last_t) * 1000.0, 0.0), self.gap_cap_ms
            )
        self._last_t = now

        if span_stack is None:
            span_stack = open_span_stack(self._target)
        stage = span_stack[-1] if span_stack else NO_SPAN

        if frames is None:
            frames = self._read_target_stack()

        self._samples += 1
        self._stage_ms[stage] = self._stage_ms.get(stage, 0.0) + weight
        if not frames:
            self._unattributed_samples += 1
            self._unattributed_ms += weight
            path: Tuple[str, ...] = (UNATTRIBUTED,)
            leaf = UNATTRIBUTED
        else:
            path = tuple(frames[-self.max_depth:])
            leaf = path[-1]
        key = (stage, path)
        self._stacks[key] = self._stacks.get(key, 0.0) + weight
        per = self._self_ms.setdefault(stage, {})
        per[leaf] = per.get(leaf, 0.0) + weight
        self._track.append(
            (
                int((now - self._origin) * 1e6),
                len(frames) if frames else 0,
                self.total_ms,
            )
        )
        return stage

    def _read_target_stack(self) -> List[str]:
        try:
            frame = sys._current_frames().get(self._target)
        except Exception:  # pragma: no cover - interpreter teardown
            return []
        if frame is None:
            return []
        labels: List[str] = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            labels.append(_frame_label(frame))
            frame = frame.f_back
            depth += 1
        labels.reverse()  # root first, leaf last (folded-stack order)
        return labels

    # -- background thread -----------------------------------------------

    def start(self) -> "HostProfiler":
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        self._thread = threading.Thread(
            target=self._run, name="ggrs-host-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> "HostProfiler":
        thread = self._thread
        if thread is None:
            return self
        self._stop_ev.set()
        thread.join(timeout=5.0)
        self._thread = None
        return self

    def __enter__(self) -> "HostProfiler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def _run(self) -> None:
        while not self._stop_ev.is_set():
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - never kill the host
                pass
            # Seeded jitter in [0.5, 1.5) x interval: deterministic
            # density, and no aliasing with a fixed-period frame loop.
            jitter = 0.5 + self._rng.random()
            self._stop_ev.wait(self.interval_ms * jitter / 1000.0)

    # -- readers ---------------------------------------------------------

    @property
    def samples(self) -> int:
        return self._samples

    @property
    def total_ms(self) -> float:
        return sum(self._stage_ms.values())

    def attributed_frac(self, stage_prefix: Optional[str] = None) -> float:
        """Share of sampled self-time attributed to a named Python frame,
        optionally restricted to stages starting with ``stage_prefix``
        (e.g. ``"admission_"`` for the five-stage acceptance bar)."""
        total = 0.0
        unattr = 0.0
        for (stage, path), ms in self._stacks.items():
            if stage_prefix is not None and not stage.startswith(
                stage_prefix
            ):
                continue
            total += ms
            if path == (UNATTRIBUTED,):
                unattr += ms
        if total <= 0.0:
            return 1.0
        return 1.0 - unattr / total

    def folded(self) -> List[str]:
        """pprof/FlameGraph folded-stack lines, sorted by weight
        descending: ``stage;frame;...;leaf <integer microseconds>``."""
        rows = sorted(
            self._stacks.items(), key=lambda kv: (-kv[1], kv[0])
        )
        return [
            ";".join((stage,) + path) + f" {max(int(ms * 1000.0), 1)}"
            for (stage, path), ms in rows
        ]

    def export_folded(self, path: str) -> int:
        lines = self.folded()
        with open(path, "w") as f:
            for line in lines:
                f.write(line + "\n")
        return len(lines)

    def stage_table(
        self, top_k: Optional[int] = None
    ) -> Dict[str, Dict[str, object]]:
        """Per-stage culprit table: total self-time and the top-K leaf
        frames by self-time."""
        k = self.top_k if top_k is None else int(top_k)
        out: Dict[str, Dict[str, object]] = {}
        for stage, per in self._self_ms.items():
            ranked = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))
            out[stage] = {
                "total_ms": round(self._stage_ms.get(stage, 0.0), 3),
                "top": [
                    [frame, round(ms, 3)] for frame, ms in ranked[:k]
                ],
            }
        return out

    def flame_tree(self) -> Dict[str, object]:
        """Nested {name, ms, children} tree over stage -> frame paths,
        children sorted by weight — the ops report renders this as a
        pure-CSS flame graph."""
        root = {"name": "all", "ms": 0.0, "children": {}}
        for (stage, path), ms in self._stacks.items():
            root["ms"] += ms
            node = root
            for part in (stage,) + path:
                child = node["children"].get(part)
                if child is None:
                    child = {"name": part, "ms": 0.0, "children": {}}
                    node["children"][part] = child
                child["ms"] += ms
                node = child

        def _freeze(node):
            kids = sorted(
                node["children"].values(),
                key=lambda c: (-c["ms"], c["name"]),
            )
            return {
                "name": node["name"],
                "ms": round(node["ms"], 3),
                "children": [_freeze(c) for c in kids],
            }

        return _freeze(root)

    def report(self, top_k: Optional[int] = None) -> Dict[str, object]:
        """Everything the ops report / bench row needs in one dict."""
        return {
            "samples": self._samples,
            "total_ms": round(self.total_ms, 3),
            "interval_ms": self.interval_ms,
            "seed": self.seed,
            "attributed_frac": round(self.attributed_frac(), 4),
            "unattributed_ms": round(self._unattributed_ms, 3),
            "stages": self.stage_table(top_k),
            "tree": self.flame_tree(),
        }

    def profile_blob(self, top_k: Optional[int] = None) -> Dict[str, object]:
        """Compact per-stage top-K self-time blob for bench rows — the
        unit ``tools/bench_gate.py`` diffs for regression attribution.
        Frame self-times are kept as ms; the gate normalizes to shares so
        run length cancels."""
        k = self.top_k if top_k is None else int(top_k)
        stages: Dict[str, Dict[str, object]] = {}
        for stage, per in self._self_ms.items():
            ranked = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))
            stages[stage] = {
                "total_ms": round(self._stage_ms.get(stage, 0.0), 3),
                "self_ms": {
                    frame: round(ms, 3) for frame, ms in ranked[:k]
                },
            }
        return {
            "samples": self._samples,
            "total_ms": round(self.total_ms, 3),
            "attributed_frac": round(self.attributed_frac(), 4),
            "stages": stages,
        }

    def summary(self) -> Dict[str, object]:
        return {
            "samples": self._samples,
            "total_ms": round(self.total_ms, 3),
            "stages": len(self._stage_ms),
            "attributed_frac": round(self.attributed_frac(), 4),
        }

    # -- exports ---------------------------------------------------------

    def export_perfetto(self, path: Optional[str] = None) -> dict:
        """Counter-track trace (``ph:"C"``): per-sample stack depth and
        cumulative profiled ms, same file shape (``otherData.wall_t0``,
        pid, process_name) as SpanTracer exports so ``obs/merge.py``
        merges and wall-aligns it with the span timeline."""
        tid = 8  # outside the 0..3 component range and the wire tid (9)
        events: List[dict] = []
        if self.process_name is not None:
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": self.process_name},
                }
            )
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self.pid,
                "tid": tid,
                "args": {"name": "host_profiler"},
            }
        )
        for ts_us, depth, total_ms in self._track:
            events.append(
                {
                    "name": "host_profile",
                    "cat": "ggrs",
                    "ph": "C",
                    "ts": int(ts_us),
                    "pid": self.pid,
                    "tid": tid,
                    "args": {
                        "stack_depth": int(depth),
                        "profiled_ms": round(float(total_ms), 3),
                    },
                }
            )
        trace = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_t0": self.wall_t0,
                "pid": self.pid,
                "process_name": self.process_name,
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def export_report_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1, sort_keys=True)


class _NullProfiler:
    """Shared no-op profiler (the ``null_tracer`` pattern): every method
    is O(1) and allocation-free; the disabled path costs one attribute
    lookup at wiring time and nothing per frame."""

    __slots__ = ()

    enabled = False
    samples = 0
    total_ms = 0.0

    def start(self) -> "_NullProfiler":
        return self

    def stop(self) -> "_NullProfiler":
        return self

    def __enter__(self) -> "_NullProfiler":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def sample_once(self, *a, **k) -> None:
        return None

    def attributed_frac(self, stage_prefix=None) -> float:
        return 0.0

    def folded(self) -> List[str]:
        return []

    def export_folded(self, path: str) -> int:
        return 0

    def stage_table(self, top_k=None) -> dict:
        return {}

    def flame_tree(self) -> dict:
        return {"name": "all", "ms": 0.0, "children": []}

    def report(self, top_k=None) -> dict:
        return {}

    def profile_blob(self, top_k=None):
        return None

    def summary(self) -> dict:
        return {}

    def export_perfetto(self, path: Optional[str] = None) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_report_json(self, path: str) -> None:
        pass


null_profiler = _NullProfiler()
