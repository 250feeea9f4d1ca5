"""SessionSupervisor: self-healing on top of detect-and-report.

Counterpart of ``bevy_ggrs_tpu/session/supervisor.py``, speaking the same
state-transfer messages and checkpoint bytes, so a peer of either package
heals from a donor of the other. The session layer (``p2p.py``) detects
faults (desyncs, disconnects, version skew) and stops there, as ggrs does;
this supervisor turns those events into repaired incidents:

- **Desync quarantine -> recovery.** On DESYNC_DETECTED it holds a checksum
  vote over every peer's report for the frame
  (``P2PSession.checksum_votes``). The minority side quarantines itself
  (stops advancing; survivors stall at most ``max_prediction`` frames
  behind), fetches a settled snapshot from the majority's donor over the
  state-transfer protocol (StateRequest/StateChunk), verifies its digest,
  restores through ``runner.restore_state``, replays the gap with freshly
  gathered inputs, and rejoins the match bitwise.
- **Crash reconnect.** On DISCONNECTED it re-arms the dead address with a
  fresh handshaking endpoint (``P2PSession.reconnect_peer``); a restarted
  peer calls :meth:`begin_rejoin`, adopts a full ``dumps_runner``
  checkpoint from a donor, gap-fills its own input queues with its frozen
  last input (what every survivor predicted, so no rollbacks), and feeds
  real inputs again once the survivors' readmit window has passed.
- **Silent corruption.** Every ``attest_interval`` frames it has the runner
  attest its ring and repair a corrupt row in place
  (``runner.attest_and_repair``); what the runner cannot repair escalates
  to the donor transfer.

Every chunk carries a crc32 and the whole transfer a 64-bit digest of the
decoded world (``combine64`` of the world checksum: on a CUDA world one
launch of the checksum kernel, ``csrc/checksum.cu``), so a damaged payload
is refused and requested again. That is integrity, not authentication.

Drive-loop contract::

    session.poll_remote_clients()
    sup.tick(now)
    if session.current_state() == RUNNING and sup.should_advance():
        session.add_local_input(h, sup.input_for(h, real_bits))
        requests = session.advance_frame()   # may raise PredictionThreshold
        runner.handle_requests(requests, session)
"""

from __future__ import annotations

import enum
import zlib
from typing import Dict, List, Optional

import numpy as np

from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch.obs.trace import null_tracer
from bevy_ggrs_tpu_torch.ops.checksum import checksum
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import (
    EventKind,
    InvalidRequest,
    SessionEvent,
    SessionState,
    NULL_FRAME,
)
from bevy_ggrs_tpu_torch.session.endpoint import PeerState
from bevy_ggrs_tpu_torch.session.requests import SaveGameState
from bevy_ggrs_tpu_torch.state import combine64, ring_frame_at, ring_load
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics
from bevy_ggrs_tpu_torch.utils.persistence import (
    dumps_checkpoint,
    dumps_runner,
    loads_checkpoint,
    loads_runner,
    runner_tree,
)

# Per-chunk payload bytes: small enough that chunk+header stays well under
# one MTU alongside the session's normal traffic.
CHUNK_PAYLOAD = 1024
# Served-transfer cache entries kept for retried requests.
_SERVE_CACHE = 4
# Rejoin freeze window multiplier: a rejoiner feeds its frozen (predicted)
# input for 2x max_prediction frames so the frozen->real transition lands
# after every survivor has readmitted it, within everyone's rollback window.
_REJOIN_FREEZE_FACTOR = 2


def transfer_digest(state) -> int:
    """The 64-bit digest a transfer carries of its world: the world
    checksum, folded. On a CUDA world this is one launch of the checksum
    kernel; on a CPU world, its plain version."""
    return combine64(checksum(state))


def _whole(runner, state):
    """``state`` of ``runner`` whole: gathered from every rank's rows when
    the runner is entity-sharded (``RollbackRunner.whole_state``)."""
    gather = getattr(runner, "whole_state", None)
    return state if gather is None else gather(state)


class Health(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"  # network interrupted on >=1 endpoint
    QUARANTINED = "quarantined"  # lost a desync vote; transfer in flight
    RESTORING = "restoring"  # rejoining from a full checkpoint


class SessionSupervisor:
    def __init__(
        self,
        session,
        runner,
        metrics=None,
        clock=None,
        reconnect: bool = True,
        serve_state: bool = True,
        vote_timeout: float = 0.5,
        request_interval: float = 0.3,
        tracer=None,
        attest_interval: Optional[int] = 60,
    ):
        self.session = session
        self.runner = runner
        self.metrics = metrics if metrics is not None else null_metrics
        # Default to the session's tracer so one wiring point (the builder)
        # instruments the whole stack; pass one to split timelines.
        if tracer is None:
            tracer = getattr(session, "tracer", None)
        self.tracer = tracer if tracer is not None else null_tracer
        self._clock = clock if clock is not None else session._clock
        self.reconnect = reconnect
        self.serve_state = serve_state
        self.vote_timeout = float(vote_timeout)
        self.request_interval = float(request_interval)
        # Attestation cadence in frames (None disables): every
        # ``attest_interval`` runner frames the runner re-hashes every
        # occupied ring row and repairs a mismatch by resimulation.
        self.attest_interval = None if attest_interval is None else int(attest_interval)
        self._last_attest_frame = 0

        self.health = Health.HEALTHY
        self._interrupted: set = set()
        self._pending_votes: Dict[int, float] = {}  # frame -> deadline
        self._transfer: Optional[Dict] = None
        # Encoded chunks only: never a view of a ring that later saves
        # overwrite in place.
        self._served: Dict[tuple, List[proto.StateChunk]] = {}
        self._nonce_counter = 0
        self._rejoin_donor = None
        self._freeze_until: Optional[int] = None
        self._frozen: Dict[int, np.ndarray] = {}

    def _set_health(self, health: Health) -> None:
        """Every transition goes through here, so the trace carries every
        edge (the flight recorder also reads ``self.health`` per capture)."""
        if health is not self.health:
            self.tracer.instant("health", prev=self.health.value, to=health.value)
        self.health = health

    # ------------------------------------------------------------------
    # Drive-loop surface

    def should_advance(self) -> bool:
        """False while quarantined or restoring: a peer on a divergent or
        not yet adopted timeline must not extend it."""
        return self.health not in (Health.QUARANTINED, Health.RESTORING)

    def input_for(self, handle: int, bits):
        """Input filter for the post-rejoin freeze window: the frozen last
        input (what every survivor predicts for us) until the session
        reaches the rejoin frame, then the real ``bits``."""
        if self._freeze_until is not None:
            if self.session.current_frame < self._freeze_until:
                frozen = self._frozen.get(handle)
                if frozen is not None:
                    return frozen
            else:
                self._freeze_until = None
                self._frozen.clear()
        return bits

    def frames_behind(self) -> int:
        """How far the furthest-ahead running peer is past us (a rejoiner
        runs extra catch-up ticks while this is positive)."""
        behind = 0
        for ep in self.session._endpoints.values():
            if ep.state == PeerState.RUNNING and ep.remote_frame != NULL_FRAME:
                behind = max(behind, ep.remote_frame - self.session.current_frame)
        return behind

    def retarget(self, runner) -> None:
        """Swap the runner this supervisor drives and serves from, keeping
        pending votes, an in-flight transfer and the frozen-input window."""
        self.runner = runner

    def begin_rejoin(self, donor_addr) -> None:
        """Restarted-process entry point: after building a fresh session and
        runner (same topology) call this once; the supervisor waits for the
        sync handshake to complete, then adopts a full checkpoint from
        ``donor_addr`` and resumes. Handshake first, so the donor already
        collects our input spans when it serializes the checkpoint and the
        adopted frontier has no gap."""
        self._rejoin_donor = donor_addr
        self._set_health(Health.RESTORING)

    # ------------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[SessionEvent]:
        """Pump recovery state; returns the session events drained this tick
        (plus the supervisor's own QUARANTINED/RECOVERED/STATE_FAULT
        events) for the app to consume: call it instead of
        ``session.events()``."""
        with self.tracer.span("sup_tick"):
            return self._tick(now)

    def _tick(self, now: Optional[float] = None) -> List[SessionEvent]:
        now = self._clock() if now is None else now
        events = list(self.session.events())
        for ev in events:
            self._on_event(ev, now)

        for addr, msg in self.session.drain_control():
            if isinstance(msg, proto.StateRequest):
                self._serve(addr, msg, now)
            elif isinstance(msg, proto.StateChunk):
                self._on_chunk(addr, msg)

        if (
            self._rejoin_donor is not None
            and self._transfer is None
            and self.session.current_state() == SessionState.RUNNING
        ):
            self._begin_transfer(self._rejoin_donor, proto.STATE_KIND_FULL, now)
            self._rejoin_donor = None

        self._attest(now, events)
        self._decide_votes(now, events)
        self._drive_transfer(now, events)

        if self.health == Health.HEALTHY and self._interrupted:
            self._set_health(Health.DEGRADED)
        elif self.health == Health.DEGRADED and not self._interrupted:
            self._set_health(Health.HEALTHY)
        return events

    # ------------------------------------------------------------------
    # Event handling

    def _on_event(self, ev: SessionEvent, now: float) -> None:
        if ev.kind == EventKind.NETWORK_INTERRUPTED:
            self._interrupted.add(ev.addr)
            self.metrics.count("network_interruptions")
        elif ev.kind == EventKind.NETWORK_RESUMED:
            self._interrupted.discard(ev.addr)
        elif ev.kind == EventKind.DISCONNECTED:
            self._interrupted.discard(ev.addr)
            self.metrics.count("peer_disconnects")
            if (
                self.reconnect
                and ev.addr in set(self.session._handle_addr.values())
                and self.session.reconnect_peer(ev.addr)
            ):
                self.metrics.count("reconnects_initiated")
        elif ev.kind == EventKind.DESYNC_DETECTED:
            self.metrics.count("desyncs_detected")
            frame = ev.data["frame"]
            if frame not in self._pending_votes:
                self._pending_votes[frame] = now + self.vote_timeout
        elif ev.kind == EventKind.PLAYER_REJOINED:
            self.metrics.count("players_rejoined")

    # ------------------------------------------------------------------
    # Attestation (integrity.py)

    def _attest(self, now: float, events: List[SessionEvent]) -> None:
        """Periodic silent-corruption sweep: every ``attest_interval``
        frames re-hash the ring's rows and repair any mismatch by
        resimulation. A repair that lands bitwise needs no quarantine (the
        timeline provably never diverged); an unrepairable fault escalates
        to the same donor transfer as a lost desync vote."""
        runner = self.runner
        if (
            self.attest_interval is None
            or not hasattr(runner, "attest_and_repair")
            or self.health in (Health.QUARANTINED, Health.RESTORING)
        ):
            self._drain_state_faults(events)
            return
        if runner.frame - self._last_attest_frame >= self.attest_interval:
            self._last_attest_frame = runner.frame
            try:
                with self.tracer.span("attest"):
                    runner.attest_and_repair(self.session)
            except integrity.StateFault:
                self.on_state_fault(now=now)
        self._drain_state_faults(events)

    def _drain_state_faults(self, events: List[SessionEvent]) -> None:
        faults = getattr(self.runner, "state_faults", None)
        if not faults:
            return
        for rec in faults:
            self.metrics.count("sdc_faults")
            events.append(SessionEvent(EventKind.STATE_FAULT, data=dict(rec)))
        faults.clear()

    def on_state_fault(self, fault=None, now: Optional[float] = None) -> bool:
        """Unrepairable local corruption (``integrity.StateFault``: no clean
        snapshot below the corrupt rows, or the input log no longer covers
        the resimulation): the ring can no longer prove its own timeline.
        The remedy is the lost-vote path: quarantine, adopt a
        digest-verified settled snapshot from a donor, replay forward. A
        drive loop that catches StateFault from ``runner.handle_requests``
        calls this directly. Returns True when a donor transfer began."""
        now = self._clock() if now is None else now
        if self.health in (Health.QUARANTINED, Health.RESTORING):
            return False
        donor = next(
            (
                a
                for a in set(self.session._handle_addr.values())
                if self.session._endpoints[a].state == PeerState.RUNNING
            ),
            None,
        )
        self.metrics.count("sdc_escalations")
        if donor is None:
            # No live donor: a checkpoint on disk is the next rung.
            return False
        self._set_health(Health.QUARANTINED)
        self._begin_transfer(donor, proto.STATE_KIND_RING, now)
        return True

    # ------------------------------------------------------------------
    # Desync vote

    def _owner_of(self, handle: int):
        """Vote token owning ``handle``: "local" for our own players."""
        if handle in self.session.local_handles:
            return "local"
        return self.session._handle_addr.get(handle)

    def _decide_votes(self, now: float, events: List[SessionEvent]) -> None:
        for frame in sorted(self._pending_votes):
            deadline = self._pending_votes[frame]
            votes = self.session.checksum_votes(frame)
            local = self.session._local_checksums.get(frame)
            running = {
                a
                for a in set(self.session._handle_addr.values())
                if self.session._endpoints[a].state == PeerState.RUNNING
            }
            if not running <= set(votes) and now < deadline:
                continue  # wait for the stragglers (or the timeout)
            del self._pending_votes[frame]
            self.session.checksum_votes(frame, pop=True)
            if local is None:
                continue  # our checksum already collected: nothing to compare
            groups: Dict[int, set] = {local: {"local"}}
            for a, cs in votes.items():
                groups.setdefault(cs, set()).add(a)
            if len(groups) < 2:
                continue  # healed before the vote closed

            def rank(item):
                _cs, members = item
                # Majority wins; a tie goes to the group owning the lowest
                # player handle, so every peer computes the same winner
                # from the same ballot.
                lowest = next(
                    (
                        h
                        for h in range(self.session.num_players)
                        if self._owner_of(h) in members
                    ),
                    self.session.num_players,
                )
                return (len(members), -lowest)

            _win_cs, winners = max(groups.items(), key=rank)
            if "local" in winners:
                self.metrics.count("desync_votes_won")
                continue
            self._quarantine(frame, winners, now, events)

    def _quarantine(self, frame: int, winners: set, now: float,
                    events: List[SessionEvent]) -> None:
        if self.health in (Health.QUARANTINED, Health.RESTORING):
            return  # recovery already in flight
        donor = next(
            a
            for h in range(self.session.num_players)
            for a in [self._owner_of(h)]
            if a in winners and a != "local"
        )
        self._set_health(Health.QUARANTINED)
        self.metrics.count("quarantines")
        events.append(SessionEvent(EventKind.QUARANTINED, addr=donor, data={"frame": frame}))
        self._begin_transfer(donor, proto.STATE_KIND_RING, now)

    # ------------------------------------------------------------------
    # State transfer: requesting side

    def _begin_transfer(self, donor, kind: int, now: float) -> None:
        self._nonce_counter += 1
        low = min(self.session.local_handles) if self.session.local_handles else 0
        nonce = ((low & 0x7FFF) << 16) | (self._nonce_counter & 0xFFFF)
        self._transfer = {
            "nonce": nonce,
            "kind": kind,
            "donor": donor,
            "chunks": {},
            "total": None,
            "frame": None,
            "checksum": None,
            "last_req": now,
            "started": now,
            "started_frame": self.session.current_frame,
        }
        self.session.send_control(donor, proto.StateRequest(nonce, kind))

    def _on_chunk(self, addr, msg: proto.StateChunk) -> None:
        t = self._transfer
        if t is None or msg.nonce != t["nonce"] or addr != t["donor"]:
            return  # stale or unsolicited
        if zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc & 0xFFFFFFFF:
            self.metrics.count("corrupt_chunks")
            return  # damaged in flight: the retry requests it again
        t["total"] = msg.total
        t["frame"] = msg.frame
        t["checksum"] = msg.checksum
        t["chunks"][msg.seq] = msg.payload

    def _drive_transfer(self, now: float, events: List[SessionEvent]) -> None:
        t = self._transfer
        if t is None:
            return
        if t["total"] is not None and len(t["chunks"]) >= t["total"]:
            self._apply_transfer(now, events)
            return
        if now - t["last_req"] >= self.request_interval:
            resend_from = 0
            if t["total"] is not None:
                resend_from = next(s for s in range(t["total"]) if s not in t["chunks"])
            self.session.send_control(
                t["donor"], proto.StateRequest(t["nonce"], t["kind"], resend_from))
            t["last_req"] = now

    def _fail_transfer(self, now: float) -> None:
        """Unusable payload (digest or template mismatch): start the whole
        transfer again under a fresh nonce; the donor may have moved on."""
        t = self._transfer
        self.metrics.count("transfer_failures")
        self._begin_transfer(t["donor"], t["kind"], now)

    def _apply_transfer(self, now: float, events: List[SessionEvent]) -> None:
        t = self._transfer
        with self.tracer.span("sup_apply_transfer", kind=t["kind"]):
            data = b"".join(t["chunks"][s] for s in range(t["total"]))
            try:
                if t["kind"] == proto.STATE_KIND_RING:
                    self._adopt_ring(data, t, now)
                else:
                    self._adopt_full(data, t, now)
            except (ValueError, KeyError, InvalidRequest):
                # Digest or template mismatch, or the replay needed inputs
                # our queues no longer hold (the donor's frontier too far
                # behind): retry under a fresh nonce. We stay quarantined,
                # so a half-replayed runner is simply restored again by the
                # next good transfer.
                self._fail_transfer(now)
                return
        self._transfer = None
        self._set_health(Health.HEALTHY)
        self.metrics.count("recoveries")
        self.metrics.observe("recovery_latency_ms", (now - t["started"]) * 1000.0)
        events.append(SessionEvent(
            EventKind.RECOVERED, addr=t["donor"],
            data={"frame": t["frame"], "kind": t["kind"]}))

    def _adopt_ring(self, data: bytes, t: Dict, now: float) -> None:
        """Desync recovery: restore the donor's settled snapshot, then replay
        forward to the session's current frame with freshly gathered inputs
        (corrections that arrived during the quarantine fold in through the
        normal gather)."""
        session, runner = self.session, self.runner
        tree, meta = loads_checkpoint(data, {"state": _whole(runner, runner.state)},
                                      "<state-transfer>")
        state = tree["state"]
        frame = int(meta["frame"])
        if transfer_digest(state) != t["checksum"]:
            raise ValueError("transfer digest mismatch")
        if frame > session.current_frame:
            # A future we have no inputs for; the donor's settled frontier
            # waits on our inputs, so only a malformed donor sends one.
            raise ValueError("transfer frame ahead of session")
        if frame < session.current_frame - 2 * session.max_prediction - 1:
            # Older than the input history the session keeps: the replay
            # could not gather those frames. Retry; the donor catches up.
            raise ValueError("transfer frame behind retained input history")
        runner.restore_state(frame, state)
        f = frame
        while f < session.current_frame:
            # Replay in bites of at most max_prediction frames (the burst's
            # capacity), each its own Load-free request list.
            end = min(f + runner.max_prediction, session.current_frame)
            requests: List[object] = []
            for g in range(f, end):
                requests.append(SaveGameState(g))
                requests.append(session._advance_request(g))
            runner.handle_requests(requests, session)
            f = end
        # Mispredictions older than the adopted frame died with the old
        # timeline; the replay re-recorded everything newer.
        session._tracker.clear_first_incorrect()
        self.metrics.observe("recovery_frames", session.current_frame - frame)

    def _adopt_full(self, data: bytes, t: Dict, now: float) -> None:
        """Kill/restart rejoin: adopt the donor's full runner and session
        checkpoint, then gap-fill our own input queues with the frozen last
        input every survivor already predicts for us (bitwise their
        predictions, so adoption rolls nobody back), and hold that input
        until the readmit window has passed (:meth:`input_for`)."""
        session, runner = self.session, self.runner
        # Verify the digest before loads_runner changes anything.
        tree, _meta = loads_checkpoint(data, runner_tree(runner), "<state-transfer>")
        if transfer_digest(tree["state"]) != t["checksum"]:
            raise ValueError("transfer digest mismatch")
        loads_runner(data, runner, session=session)
        self._frozen = {}
        player_addrs = set(session._handle_addr.values())
        for h in session.local_handles:
            session._disconnected.pop(h, None)
            q = session._queues[h]
            frozen = np.asarray(q.last_input).copy()
            self._frozen[h] = frozen
            # The donor's gathers predicted repeat-last for us since our
            # death; feed exactly that so history stays bitwise equal.
            for f in range(q.last_confirmed_frame + 1, session.current_frame):
                q.add_input(f, frozen)
                session._tracker.note_confirmed(h, f, frozen)
                for addr in player_addrs:
                    session._endpoints[addr].queue_input(h, f, frozen)
        self._freeze_until = (
            session.current_frame + _REJOIN_FREEZE_FACTOR * session.max_prediction)
        self.metrics.observe("recovery_frames", session.current_frame - t["started_frame"])

    # ------------------------------------------------------------------
    # State transfer: serving side

    def _serve(self, addr, req: proto.StateRequest, now: float) -> None:
        if not self.serve_state:
            return
        if self.health in (Health.QUARANTINED, Health.RESTORING):
            return  # never serve a timeline we are abandoning ourselves
        key = (addr, req.nonce)
        chunks = self._served.get(key)
        if chunks is None:
            with self.tracer.span("sup_serve_state", kind=req.kind):
                built = self._build_payload(req.kind)
            if built is None:
                return  # nothing settled to serve yet; the requester retries
            data, frame, digest = built
            payloads = [data[i : i + CHUNK_PAYLOAD]
                        for i in range(0, len(data), CHUNK_PAYLOAD)] or [b""]
            total = len(payloads)
            chunks = [
                proto.StateChunk(req.nonce, req.kind, frame, digest, seq, total,
                                 zlib.crc32(p) & 0xFFFFFFFF, p)
                for seq, p in enumerate(payloads)
            ]
            self._served[key] = chunks
            while len(self._served) > _SERVE_CACHE:
                self._served.pop(next(iter(self._served)))
            self.metrics.count("state_transfers_served")
        for c in chunks[max(req.resend_from, 0) :]:
            self.session.send_control(addr, c)

    def _build_payload(self, kind: int):
        session, runner = self.session, self.runner
        if kind == proto.STATE_KIND_FULL:
            if runner.frame != session.current_frame:
                return None  # not at a tick boundary
            digest = transfer_digest(_whole(runner, runner.state))
            data = dumps_runner(runner, session=session)
            return data, int(runner.frame), int(digest)
        # STATE_KIND_RING: the newest frame that is saved in the ring,
        # settled (every input confirmed, no pending rollback reaches it),
        # and not ahead of the runner.
        bound = min(session.confirmed_frame(), runner.frame)
        for frame in range(bound, max(-1, bound - runner.max_prediction - 1), -1):
            if frame < 0:
                break
            if ring_frame_at(runner.ring, frame) != frame:
                continue
            if not session._settled(frame):
                continue
            # A copy of the row, serialized at once: later saves write the
            # ring in place.
            state = _whole(runner, ring_load(runner.ring, frame))
            digest = transfer_digest(state)
            data = dumps_checkpoint({"state": state}, {"frame": int(frame)})
            return data, int(frame), int(digest)
        return None
