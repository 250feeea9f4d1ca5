"""Span tracer: nested wall-clock phase spans over the session stage loop.

Counterpart of ``bevy_ggrs_tpu/obs/trace.py``, a copy whose exports have
the same structure. ``utils.metrics`` keeps counters and flat phase timers;
this tracer adds the *timeline*: ``with trace.span("net_poll")``
style nesting recorded as begin/end events on a microsecond clock,
exported as

- Chrome-trace / Perfetto JSON (:meth:`SpanTracer.export_perfetto` — load
  the file in https://ui.perfetto.dev or ``chrome://tracing``),
- a JSONL event stream (:meth:`SpanTracer.export_jsonl`),
- a per-span-name aggregate (:meth:`SpanTracer.summary`).

Design notes:

- Events are appended in runtime order, so begin/end matching and nesting
  are correct *by construction*; export never has to re-derive a stack
  from timestamps. The export pass only repairs the two edge cases a
  bounded ring introduces (orphan ends whose begin was evicted, and spans
  still open at export time, which are auto-closed at the final
  timestamp).
- The disabled path is the null-object pattern `utils.metrics` uses:
  :data:`null_tracer` hands out one shared no-op span, so an instrumented
  hot loop pays one attribute lookup + context enter/exit per span.
- Host-side only. For kernel-level profiles wrap the run in
  ``torch.profiler.profile``; both timelines compose (the profiler's trace
  carries the device's kernels, this one the session phases).
- One clock with the profiler. By default the tracer stamps events on
  the wall clock ``torch.profiler``'s events carry (``time.time_ns``), in
  whole microseconds from an origin that is also ``wall_t0``: a stamp
  plus ``wall_t0`` is the profiler's clock to the microsecond, so an idle
  gap in a device trace can be put down to the span open at its time
  (``obs/merge.py --align wall`` lays both on one timeline). A
  caller-supplied ``clock`` (a virtual network clock, a stepped test
  clock) keeps its own seconds and a ``wall_t0`` read apart.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

# Event tuples: ("B", name, ts_us, args) / ("E", name, ts_us, None)
#             / ("I", name, ts_us, args)   (instant)


# -- cross-thread span-stack registry -----------------------------------
#
# A sampling profiler runs on its OWN thread and must
# answer "which obs span is open on the *sampled* thread right now?" — a
# plain threading.local can't be read from outside, so the per-thread
# stacks live in a module dict keyed by thread ident. Mutation is only
# ever by the owning thread (append/pop under the GIL); the sampler takes
# a snapshot with tuple(), which cannot interleave with a list mutation
# in CPython. Entries are tokens rather than bare names so a span that
# closes out of LIFO order (the admission path's ``first_frame`` opens at
# enqueue and closes a later frame, overlapping everything between) is
# removed by identity instead of corrupting its neighbours.

_SPAN_STACKS: Dict[int, List["_StackToken"]] = {}
_STACKS_LOCK = threading.Lock()  # guards registry insertion only


class _StackToken:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def _stack_for(ident: Optional[int] = None) -> List["_StackToken"]:
    ident = threading.get_ident() if ident is None else ident
    stack = _SPAN_STACKS.get(ident)
    if stack is None:
        with _STACKS_LOCK:
            stack = _SPAN_STACKS.setdefault(ident, [])
    return stack


def push_span(name: str) -> _StackToken:
    """Mark ``name`` as the innermost open span on the calling thread.
    Returns a token for :func:`pop_span`."""
    tok = _StackToken(name)
    _stack_for().append(tok)
    return tok


def pop_span(token: _StackToken) -> None:
    """Close a span marker. Tolerates non-LIFO closes (removal by token
    identity) and double-pops (a missing token is a no-op)."""
    stack = _SPAN_STACKS.get(threading.get_ident())
    if not stack:
        return
    if stack[-1] is token:
        stack.pop()
        return
    try:
        stack.remove(token)
    except ValueError:
        pass


def open_span_stack(thread_ident: int) -> Tuple[str, ...]:
    """Snapshot of the open-span names on ``thread_ident``, outermost
    first. Safe to call from any thread (this is the profiler's read)."""
    stack = _SPAN_STACKS.get(thread_ident)
    if not stack:
        return ()
    return tuple(tok.name for tok in tuple(stack))


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_t0", "_tok")

    def __init__(self, tracer: "SpanTracer", name: str, args):
        self._tr = tracer
        self._name = name
        self._args = args
        self._t0 = 0
        self._tok = None

    def __enter__(self):
        tr = self._tr
        self._t0 = tr._now_us()
        tr._events.append(("B", self._name, self._t0, self._args))
        tr._depth += 1
        self._tok = push_span(self._name)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        end = tr._now_us()
        tr._events.append(("E", self._name, end, None))
        tr._depth -= 1
        if self._tok is not None:
            pop_span(self._tok)
            self._tok = None
        dur = (end - self._t0) / 1000.0
        agg = tr._agg.get(self._name)
        if agg is None:
            tr._agg[self._name] = [1, dur, dur]
        else:
            agg[0] += 1
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
        return False


# Span-name prefix -> (track offset, track name). Export assigns each
# component a stable tid (`tid * 4 + offset`) so a merged trace shows
# session / spec / server / relay as separate named rows per process
# instead of one flat track. Runtime order is globally LIFO (context
# managers), and restricting a well-nested sequence to one component
# keeps it well-nested, so per-(pid,tid) B/E matching holds without
# restructuring the ring.
_COMPONENT_TRACKS = (
    ("spec", 1, "spec"),
    ("serve", 2, "server"),
    ("srv", 2, "server"),
    ("relay", 3, "relay"),
)
_SESSION_TRACK = (0, "session")


def _component_track(name: str):
    head = name.split("_", 1)[0]
    for prefix, offset, track in _COMPONENT_TRACKS:
        if head == prefix:
            return offset, track
    return _SESSION_TRACK


class SpanTracer:
    """Enabled tracer. ``pid`` distinguishes peers when several tracers'
    exports are merged into one trace (each peer is a Perfetto process).
    With no ``clock`` the stamps are wall-clock microseconds (the
    profiler's clock) since the tracer was made, and ``wall_t0``, unless
    given, is that instant; ``clock`` (seconds) replaces the wall clock."""

    enabled = True

    def __init__(
        self,
        capacity: int = 200_000,
        clock=None,
        pid: int = 0,
        tid: int = 0,
        process_name: Optional[str] = None,
        wall_t0: Optional[float] = None,
    ):
        self._clock = clock
        # Wall microseconds (no clock given) or the clock's seconds at ts=0.
        self._origin = time.time_ns() // 1000 if clock is None else clock()
        self._events = collections.deque(maxlen=int(capacity))
        self._agg: Dict[str, List[float]] = {}  # name -> [count, total, max]
        self._depth = 0
        self.pid = int(pid)
        self.tid = int(tid)
        self.process_name = process_name
        # Wall-clock instant of ts=0, so the merge tool can align traces
        # captured by different processes (virtual-clock tracers share a
        # timeline already; real-clock ones need this anchor). On the
        # default clock it is the origin itself.
        if wall_t0 is None:
            wall_t0 = self._origin / 1e6 if clock is None else time.time()
        self.wall_t0 = float(wall_t0)

    def _now_us(self) -> int:
        if self._clock is None:
            return time.time_ns() // 1000 - self._origin
        return int((self._clock() - self._origin) * 1e6)

    # -- instruments ----------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._events.append(("I", name, self._now_us(), args or None))

    # -- reporting ------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name {count, total_ms, mean_ms, max_ms}."""
        return {
            name: {
                "count": int(c),
                "total_ms": total,
                "mean_ms": total / c if c else 0.0,
                "max_ms": mx,
            }
            for name, (c, total, mx) in self._agg.items()
        }

    def _well_formed_events(self):
        """Runtime events repaired to a provably matched, nested sequence:
        begins always emit; an end emits only when it matches the top of
        the reconstructed stack (an end whose begin was evicted from the
        ring is dropped); spans still open at export time are closed at
        the final timestamp, innermost first. Timestamps are monotonized
        (this guards a wall clock set back and a caller-supplied clock)."""
        out = []
        stack: List[str] = []
        last_ts = 0
        for ph, name, ts, args in self._events:
            if ts < last_ts:
                ts = last_ts
            last_ts = ts
            if ph == "B":
                stack.append(name)
                out.append(("B", name, ts, args))
            elif ph == "E":
                if stack and stack[-1] == name:
                    stack.pop()
                    out.append(("E", name, ts, None))
                # else: orphan end (begin evicted) — drop
            else:
                out.append(("I", name, ts, args))
        for name in reversed(stack):
            out.append(("E", name, last_ts, None))
        return out

    def export_perfetto(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (the format Perfetto's legacy importer
        and ``chrome://tracing`` load). Returns the trace dict; also
        writes it to ``path`` when given."""
        events = []
        if self.process_name is not None:
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": self.tid,
                    "args": {"name": self.process_name},
                }
            )
        named_tracks = set()
        body = []
        for ph, name, ts, args in self._well_formed_events():
            offset, track = _component_track(name)
            tid = self.tid * 4 + offset
            if tid not in named_tracks:
                named_tracks.add(tid)
                events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": self.pid,
                        "tid": tid,
                        "args": {"name": track},
                    }
                )
            ev = {
                "name": name,
                "cat": "ggrs",
                "ph": "i" if ph == "I" else ph,
                "ts": ts,
                "pid": self.pid,
                "tid": tid,
            }
            if ph == "I":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            body.append(ev)
        events.extend(body)
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

    def export_jsonl(self, path: str) -> int:
        """One JSON object per line, runtime order; returns lines written."""
        n = 0
        with open(path, "w") as f:
            for ph, name, ts, args in self._well_formed_events():
                rec = {"ph": ph, "name": name, "ts_us": ts}
                if args:
                    rec["args"] = dict(args)
                f.write(json.dumps(rec) + "\n")
                n += 1
        return n


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullTracer:
    """Shared no-op tracer: every instrument is O(1) and allocation-free
    (mirrors ``utils.metrics.null_metrics``)."""

    __slots__ = ()

    enabled = False
    _span = _NullSpan()

    def span(self, name: str, **args) -> _NullSpan:
        return self._span

    def instant(self, name: str, **args) -> None:
        pass

    def summary(self):
        return {}

    def export_perfetto(self, path: Optional[str] = None) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_jsonl(self, path: str) -> int:
        return 0


null_tracer = _NullTracer()
