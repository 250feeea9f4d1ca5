"""Flight recorder: a bounded ring of per-frame :class:`FrameRecord`s.

Counterpart of ``bevy_ggrs_tpu/obs/recorder.py``: it reads a session, a
runner and a supervisor of the port through the same attribute names, so
its records equal the JAX recorder's for equal sessions.

One :meth:`FlightRecorder.capture` call per drive-loop iteration snapshots
the whole stack — session frame/confirmation frontier, confirmed-vs-
predicted input handles, rollback activity since the previous capture
(deltas of the runner's monotone counters), the newest settled checksum,
per-peer RTT/ack frontier, the supervisor's health FSM (with transition
edges), and any chaos faults the wrapped socket injected in the interval.

Everything is read with ``getattr`` guards, so any subset of
(session, runner, supervisor) works: the recorder never couples layers
that are otherwise independent, and a plain two-peer test session records
fine without a supervisor or chaos socket.

The ring is host-side and bounded (default 4096 records ≈ 68 s at 60 fps),
so it can stay on in soaks; :meth:`FlightRecorder.export_jsonl` dumps it
as the failure artifact and :meth:`FlightRecorder.rollback_histogram`
feeds the Prometheus snapshot.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

NULL_FRAME = -1


@dataclasses.dataclass
class FrameRecord:
    """One drive-loop iteration. Counter-like fields are deltas since the
    previous capture; frontier fields are absolute."""

    seq: int
    t: float
    frame: int
    confirmed_frame: int
    confirmed_players: int
    predicted_players: int
    rollbacks: int
    resim_frames: int
    rollback_depth: int
    checksum_frame: int
    checksum: Optional[int]
    health: Optional[str]
    health_transition: Optional[Tuple[str, str]]
    peers: Dict[str, Dict[str, object]]
    faults: List[Tuple[float, str, str]]
    events: List[str]
    # Batched-serving columns (None outside a MatchServer drive loop —
    # appended with defaults so existing positional constructions and
    # recorded JSONL stay stable).
    slots_active: Optional[int] = None
    slots_free: Optional[int] = None
    stagger_jitter_ms: Optional[float] = None
    # Serve-tier fault-domain gauges (None outside a MatchServer loop).
    slots_quarantined: Optional[int] = None
    slots_recovering: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FlightRecorder:
    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        self.records = collections.deque(maxlen=int(capacity))
        self._clock = clock
        self._seq = 0
        self._last_rollbacks = None
        self._last_resim = None
        self._last_health = None
        self._fault_cursor = 0
        self._ledger_seq = 0  # speculation-ledger drain watermark

    def capture(
        self,
        session=None,
        runner=None,
        supervisor=None,
        events=(),
        now: Optional[float] = None,
        server=None,
    ) -> FrameRecord:
        frame = NULL_FRAME
        confirmed = NULL_FRAME
        confirmed_players = 0
        predicted_players = 0
        checksum_frame = NULL_FRAME
        checksum = None
        peers: Dict[str, Dict[str, object]] = {}
        faults: List[Tuple[float, str, str]] = []

        if session is not None:
            frame = int(session.current_frame)
            confirmed = int(session.confirmed_frame())
            # A handle is "confirmed" when its queue already holds the real
            # input for the last simulated frame; otherwise that frame ran
            # on a repeat-last prediction for it.
            last_sim = frame - 1
            for q in getattr(session, "_queues", ()):
                if q.last_confirmed_frame >= last_sim:
                    confirmed_players += 1
                else:
                    predicted_players += 1
            local_cs = getattr(session, "_local_checksums", None)
            if local_cs:
                checksum_frame = max(local_cs)
                checksum = int(local_cs[checksum_frame])
            for addr, ep in getattr(session, "_endpoints", {}).items():
                acked = ep._last_ack_rx.values()
                sent = ep._max_sent.values()
                peers[str(addr)] = {
                    "state": ep.state.name,
                    "ping_ms": round(float(ep.ping_ms), 3),
                    "remote_frame": int(ep.remote_frame),
                    "ack_frontier": max(acked) if acked else NULL_FRAME,
                    "sent_frontier": max(sent) if sent else NULL_FRAME,
                }
            sock_faults = getattr(session.socket, "faults", None)
            if sock_faults is not None:
                if self._fault_cursor > len(sock_faults):
                    self._fault_cursor = 0  # socket was swapped/restarted
                faults = [
                    (float(t), str(kind), str(dst))
                    for t, kind, dst in sock_faults[self._fault_cursor:]
                ]
                self._fault_cursor = len(sock_faults)

        rollbacks = resim = 0
        rollback_depth = 0
        if runner is not None:
            if frame == NULL_FRAME:
                frame = int(runner.frame)
            total_rb = int(runner.rollbacks_total)
            total_resim = int(runner.rollback_frames_total)
            if self._last_rollbacks is not None:
                rollbacks = total_rb - self._last_rollbacks
                resim = total_resim - self._last_resim
            self._last_rollbacks = total_rb
            self._last_resim = total_resim
            # With per-tick capture at most one rollback lands per record,
            # so the resim delta IS its depth. Across a coarser capture
            # that sum used to be reported *as* a depth — conflating e.g.
            # three 2-deep rollbacks with one 6-deep one. When the runner
            # carries an enabled speculation ledger we report the max
            # per-rollback depth in the window instead (bitwise identical
            # for single-rollback captures); without a ledger the summed
            # fallback remains, which the histogram labels.
            rollback_depth = resim if rollbacks else 0
            led = getattr(runner, "ledger", None)
            if led is not None and getattr(led, "enabled", False):
                entries = led.tail(self._ledger_seq)
                if entries:
                    self._ledger_seq = entries[-1]["seq"] + 1
                if rollbacks:
                    rollback_depth = max(
                        (int(e["depth"]) for e in entries),
                        default=rollback_depth,
                    )

        slots_active = slots_free = None
        stagger_jitter = None
        slots_quarantined = slots_recovering = None
        if server is not None:
            # MatchServer (or anything exposing the same gauges): slot
            # occupancy + how far the stagger-group dispatches drifted off
            # their ideal offsets within the last served frame.
            slots_active = int(getattr(server, "slots_active", 0))
            slots_free = int(getattr(server, "slots_free", 0))
            jitter = getattr(server, "last_stagger_jitter_ms", None)
            stagger_jitter = None if jitter is None else float(jitter)
            q = getattr(server, "slots_quarantined", None)
            slots_quarantined = None if q is None else int(q)
            r = getattr(server, "slots_recovering", None)
            slots_recovering = None if r is None else int(r)

        health = None
        transition = None
        if supervisor is not None:
            health = supervisor.health.name
            if self._last_health is not None and self._last_health != health:
                transition = (self._last_health, health)
            self._last_health = health

        rec = FrameRecord(
            seq=self._seq,
            t=self._clock() if now is None else now,
            frame=frame,
            confirmed_frame=confirmed,
            confirmed_players=confirmed_players,
            predicted_players=predicted_players,
            rollbacks=rollbacks,
            resim_frames=resim,
            rollback_depth=rollback_depth,
            checksum_frame=checksum_frame,
            checksum=checksum,
            health=health,
            health_transition=transition,
            peers=peers,
            faults=faults,
            events=[e.kind.name for e in events],
            slots_active=slots_active,
            slots_free=slots_free,
            stagger_jitter_ms=stagger_jitter,
            slots_quarantined=slots_quarantined,
            slots_recovering=slots_recovering,
        )
        self._seq += 1
        self.records.append(rec)
        return rec

    # -- reporting ------------------------------------------------------

    def rollback_histogram(self) -> Dict[int, int]:
        """{depth: occurrences} over recorded rollbacks."""
        hist: Dict[int, int] = {}
        for r in self.records:
            if r.rollbacks:
                hist[r.rollback_depth] = hist.get(r.rollback_depth, 0) + 1
        return dict(sorted(hist.items()))

    def health_transitions(self) -> List[Tuple[int, str, str]]:
        """(frame, from, to) edges of the supervisor FSM."""
        return [
            (r.frame,) + tuple(r.health_transition)
            for r in self.records
            if r.health_transition
        ]

    def to_dicts(self) -> List[dict]:
        return [r.to_dict() for r in self.records]

    def export_jsonl(self, path: str) -> int:
        n = 0
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")
                n += 1
        return n
