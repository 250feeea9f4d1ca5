"""Admission-path tracing: one arrival, five measured stages.

The front door's unit of work is an *arrival* — a match that wants a
slot. Between "the traffic generator emitted it" and "its first served
frame left a group dispatch" the arrival crosses every layer of the
stack, and each crossing is a distinct failure/latency domain:

==============  =====================================================
matchmake       the matchmaker resolved the arrival into a session +
                inputs (player assembly, spectator targets)
place           the balancer scored the fleet and booked a placement
slot_warm       the destination server built the session/supervisor
                and the slot's initial state (the lazy-state build the
                admit queue keeps off the frame-critical path)
admit           the device write into the slot row (``core.admit``)
first_frame     queued-admission wait + time to the first group
                dispatch that actually served the match
==============  =====================================================

:class:`AdmissionTrace` records the stages as wall-clock spans against
the caller's clock (virtual clocks work — the bench drives admission on
the LoopbackNetwork clock), emits per-stage tracer instants, and carries
an FNV-1a **admission key** (the same 64-bit digest family as the
provenance flow keys in obs/provenance.py) so a merged Perfetto timeline
can chain the matchmaker's events to the destination server's — the
key rides in the event args of every stage from either process.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from bevy_ggrs_tpu_torch.obs.provenance import flow_key
from bevy_ggrs_tpu_torch.obs.trace import null_tracer, pop_span, push_span

#: Ordered stage names; ``durations`` holds a subset until ``complete``.
STAGES = ("matchmake", "place", "slot_warm", "admit", "first_frame")


def admission_key(match_id: int) -> int:
    """The arrival's cross-process correlation id: FNV-1a 64 over a
    canonical byte string, same digest family as the datagram flow keys
    (so one merge tool handles both)."""
    return flow_key(b"admission:%d" % int(match_id))


class AdmissionTrace:
    """Per-arrival stage clock. Stages may be recorded with
    :meth:`stage` (a context manager), paired :meth:`begin`/:meth:`end`
    calls (for stages that span frames, like the admit-queue wait), or
    directly via :meth:`record`."""

    __slots__ = (
        "match_id", "key", "tracer", "durations",
        "t_start", "t_done", "server_id", "handle", "_clock", "_open",
    )

    def __init__(
        self,
        match_id: int,
        clock=time.perf_counter,
        tracer=None,
    ):
        self.match_id = int(match_id)
        self.key = admission_key(match_id)
        self.tracer = tracer if tracer is not None else null_tracer
        self._clock = clock
        self.durations: Dict[str, float] = {}
        self._open: Dict[str, tuple] = {}  # stage -> (t0, span token)
        self.t_start = clock()
        self.t_done: Optional[float] = None
        self.server_id: Optional[int] = None
        self.handle = None

    # -- recording -------------------------------------------------------

    def begin(self, stage: str) -> None:
        # Mark the stage on the caller thread's span stack so the
        # sampling profiler folds host samples into it. Tokens tolerate
        # non-LIFO closes — ``first_frame`` opens at enqueue and closes
        # frames later, overlapping every stage in between.
        self._open[stage] = (self._clock(), push_span(f"admission_{stage}"))

    def end(self, stage: str) -> float:
        t0, tok = self._open.pop(stage)
        pop_span(tok)
        ms = (self._clock() - t0) * 1000.0
        self.record(stage, ms)
        return ms

    @contextmanager
    def stage(self, name: str):
        self.begin(name)
        try:
            yield self
        finally:
            self.end(name)

    def is_open(self, stage: str) -> bool:
        return stage in self._open

    def record(self, stage: str, ms: float) -> None:
        """Accumulating (a stage interrupted and resumed across frames
        sums its pieces)."""
        self.durations[stage] = self.durations.get(stage, 0.0) + float(ms)
        self.tracer.instant(
            "admission_stage",
            match=self.match_id,
            stage=stage,
            dur_ms=round(float(ms), 4),
            flow=self.key,
        )

    def finish(self, server_id=None, handle=None) -> "AdmissionTrace":
        """Close the trace (idempotent): stamps total wall time and emits
        the summary instant the merge tool correlates by ``flow``."""
        if self.t_done is not None:
            return self
        self.t_done = self._clock()
        if server_id is not None:
            self.server_id = int(server_id)
        if handle is not None:
            self.handle = handle
        args = {
            f"{k}_ms": round(v, 4) for k, v in self.durations.items()
        }
        self.tracer.instant(
            "admission_complete",
            match=self.match_id,
            total_ms=round(self.total_ms, 4),
            flow=self.key,
            server=-1 if self.server_id is None else self.server_id,
            **args,
        )
        return self

    # -- readers ---------------------------------------------------------

    @property
    def total_ms(self) -> float:
        end = self.t_done if self.t_done is not None else self._clock()
        return (end - self.t_start) * 1000.0

    @property
    def complete(self) -> bool:
        return self.t_done is not None and all(
            s in self.durations for s in STAGES
        )

    def snapshot(self) -> Dict[str, object]:
        return {
            "match_id": self.match_id,
            "key": self.key,
            "server_id": self.server_id,
            "total_ms": self.total_ms if self.t_done is not None else None,
            "stages": dict(self.durations),
            "complete": self.complete,
        }
