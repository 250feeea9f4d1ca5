"""P2PSession: GGPO-style rollback netcode session.

Counterpart of ``bevy_ggrs_tpu/session/p2p.py``, host code the port keeps
its own copy of; it speaks the same wire protocol, so a session of either
package plays against a session of the other. The ggrs ``P2PSession``
semantics that bevy_ggrs consumes (``src/ggrs_stage.rs:213-257``):

- remote inputs that haven't arrived are *predicted* (repeat last confirmed);
- ``advance_frame()`` optimistically emits ``[Save(F), Advance(i_F)]``;
- when a late-arriving confirmed input contradicts a prediction, the next
  ``advance_frame()`` prepends ``Load(F_bad)`` + corrected
  ``(Save, Advance)`` pairs replaying ``F_bad .. F_now`` — up to
  ``max_prediction`` frames of resimulation in one call;
- running more than ``max_prediction`` frames past the last confirmed input
  raises :class:`PredictionThreshold` (the caller skips the frame);
- ``frames_ahead() > 0`` tells the driver to pace ×1.1 slower;
- sessions start SYNCHRONIZING and only run after the sync handshake;
- per-peer events (synchronized / interrupted / resumed / disconnected) and
  ``network_stats(handle)``.

Spectator fan-out: host-side, every spectator address gets a stream of
*confirmed* inputs for all players (the feed a
:class:`~bevy_ggrs_tpu_torch.session.spectator.SpectatorSession` consumes).
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Sequence

import numpy as np

from bevy_ggrs_tpu_torch.schedule import InputSpec
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import (
    EventKind,
    InvalidRequest,
    NetworkStats,
    NotSynchronized,
    PredictionThreshold,
    SessionEvent,
    SessionState,
    NULL_FRAME,
    restore_spans,
    serialize_spans,
)
from bevy_ggrs_tpu_torch.session.input_queue import (
    NEVER_DISCONNECTED,
    make_queue_set,
    make_tracker,
)
from bevy_ggrs_tpu_torch.session.endpoint import PeerEndpoint, PeerState
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame, LoadGameState, SaveGameState
from bevy_ggrs_tpu_torch.obs.trace import null_tracer
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

# Upper bound on the AUTO desync-detection interval (frames between
# checksum reports to peers). The effective default is
# ``min(CHECKSUM_SEND_INTERVAL, max_prediction)`` so the frame a desync is
# detected at is usually still inside the snapshot ring (depth
# ``max_prediction + 1``) and ``runner.diagnose_frame`` can name the
# divergent component; sessions override per-build via
# ``SessionBuilder.with_desync_detection`` (ggrs desync-detection config
# parity, survey §2.2).
CHECKSUM_SEND_INTERVAL = 16
# A spectator more than this many confirmed frames behind the fan-out is
# dropped (bounds host-side history retention; the GGPO policy).
SPECTATOR_MAX_LAG = 600


class P2PSession:
    """Use :class:`~bevy_ggrs_tpu_torch.session.builder.SessionBuilder` to
    construct (``start_p2p_session(socket)``)."""

    def __init__(
        self,
        num_players: int,
        input_spec: InputSpec,
        socket,
        local_players: Dict[int, None],
        remote_players: Dict[int, object],  # handle -> addr
        spectators: Sequence[object],  # addrs
        max_prediction: int = 8,
        input_delay: int = 0,
        disconnect_timeout: float = 2.0,
        disconnect_notify_start: float = 0.5,
        fps: int = 60,
        seed: int = 0,
        clock=None,
        desync_detection="auto",
        metrics=None,
        tracer=None,
        config_digest: int = 0,
    ):
        self.num_players = int(num_players)
        self.input_spec = input_spec
        self.socket = socket
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.max_prediction = int(max_prediction)
        # Desync-detection cadence: "auto" picks the largest interval that
        # still (usually) keeps the divergent frame inside the snapshot
        # ring at detection time; an int is an explicit interval; None or
        # <= 0 disables the exchange entirely (ggrs DesyncDetection::Off).
        if desync_detection == "auto":
            self.desync_interval = min(
                CHECKSUM_SEND_INTERVAL, self.max_prediction
            )
        elif desync_detection is None:
            self.desync_interval = 0
        else:
            self.desync_interval = max(int(desync_detection), 0)
        self.input_delay = int(input_delay)
        self.fps = int(fps)
        self._clock = clock if clock is not None else _time.monotonic

        zero = input_spec.zeros_np(1)[0]
        self._zero = zero
        # Input history + misprediction tracking (the Python data plane;
        # the JAX package's native core has the same semantics).
        self._qset = make_queue_set(
            zero,
            [input_delay if h in local_players else 0 for h in range(num_players)],
        )
        self._queues = self._qset.queues
        self._tracker = make_tracker(num_players, zero)
        self.local_handles = sorted(local_players)
        self._handle_addr: Dict[int, object] = dict(remote_players)
        self._disconnected: Dict[int, int] = {}  # handle -> frame of disconnect

        rng = np.random.RandomState(seed)
        # Kept for reconnect_peer: replacement endpoints share the session
        # RNG stream and the original timeout knobs.
        self._rng = rng
        self._disconnect_timeout = disconnect_timeout
        self._disconnect_notify_start = disconnect_notify_start
        # Session-config digest every endpoint advertises/enforces in the
        # sync handshake (v4): the input-predictor weight content hash, 0
        # when prediction is off (SessionBuilder.with_input_predictor).
        self.config_digest = int(config_digest) & 0xFFFFFFFFFFFFFFFF
        self._endpoints: Dict[object, PeerEndpoint] = {}
        for addr in set(remote_players.values()) | set(spectators):
            self._endpoints[addr] = PeerEndpoint(
                addr,
                rng,
                disconnect_timeout=disconnect_timeout,
                disconnect_notify_start=disconnect_notify_start,
                metrics=self.metrics,
                config_digest=self.config_digest,
            )
        self._spectator_addrs = list(spectators)
        # Confirmed-input fan-out cursor per spectator address.
        self._spec_sent: Dict[object, int] = {a: NULL_FRAME for a in spectators}

        self.current_frame = 0
        self._pending_local: Dict[int, np.ndarray] = {}
        self._events: List[SessionEvent] = []
        self._local_checksums: Dict[int, int] = {}
        self._last_checksum_sent = NULL_FRAME
        self._desynced_frames: set = set()
        # Supervisor surfaces: state-transfer messages parked by endpoints
        # ((addr, msg) pairs, see drain_control) and the per-settled-frame
        # checksum ballot used to pick the desync-vote winner.
        self._control_inbox: List = []
        self._checksum_votes: Dict[int, Dict[object, int]] = {}

    # ------------------------------------------------------------------
    # Introspection (stage-driver surface, survey §2.2)

    def current_state(self) -> SessionState:
        """RUNNING once every remote *player* has completed the sync
        handshake. Spectator endpoints sync opportunistically but never
        gate the players (a dead spectator must not block the match)."""
        player_addrs = set(self._handle_addr.values())
        for addr in player_addrs:
            if self._endpoints[addr].state == PeerState.SYNCHRONIZING:
                # A reconnect endpoint chasing a dead peer (every handle at
                # this addr already in _disconnected) must not re-gate the
                # survivors: the match goes on with frozen inputs until the
                # peer actually answers the re-handshake.
                handles = [
                    h for h, a in self._handle_addr.items() if a == addr
                ]
                if handles and all(h in self._disconnected for h in handles):
                    continue
                return SessionState.SYNCHRONIZING
        return SessionState.RUNNING

    def local_player_handles(self) -> List[int]:
        return list(self.local_handles)

    def remote_player_handles(self) -> List[int]:
        return sorted(self._handle_addr)

    def confirmed_frame(self) -> int:
        """Highest frame for which every connected player's input is
        confirmed (local inputs confirm at add time, after input delay)."""
        return self._qset.min_confirmed(
            [h not in self._disconnected for h in range(self.num_players)]
        )

    def confirmed_input(self, handle: int, frame: int):
        """The confirmed input of ``handle`` for ``frame``, or None while it
        is still a prediction. The speculative runner pins these known
        values across every candidate branch so branch capacity is spent
        exclusively on genuinely unknown inputs."""
        return self._queues[handle].confirmed(frame)

    def confirmed_span(self, handle: int, lo: int, n: int):
        """Bulk :meth:`confirmed_input` for frames ``lo .. lo+n-1``:
        ``(values[n, *shape], mask[n])``. One call (one FFI round trip on
        the native queue) per player per speculation tick instead of
        ``n`` — the O(F x P) getter loop was the measured host-side
        dispatch cost (round-3 verdict weak #5)."""
        return self._queues[handle].confirmed_span(lo, n)

    def frames_ahead(self) -> int:
        """How many frames we should yield to let slower peers catch up
        (>0 ⇒ the driver runs ×1.1 slower, `ggrs_stage.rs:107-109,227`).
        GGPO time sync: half the gap between our frame advantage over the
        peer and the peer's self-reported advantage."""
        worst = 0
        for ep in self._endpoints.values():
            if ep.state != PeerState.RUNNING or ep.remote_frame == NULL_FRAME:
                continue
            local_adv = self.current_frame - ep.remote_frame
            worst = max(worst, (local_adv - ep.remote_advantage) // 2)
        return worst

    def network_stats(self, handle: int) -> NetworkStats:
        addr = self._handle_addr.get(handle)
        if addr is None:
            raise InvalidRequest(f"handle {handle} is not a remote player")
        return self._endpoints[addr].stats(self._clock(), self.current_frame)

    def events(self) -> List[SessionEvent]:
        out, self._events = self._events, []
        return out

    # ------------------------------------------------------------------
    # Network pump (`poll_remote_clients`, ggrs_stage.rs:113-119)

    def poll_remote_clients(self, now: Optional[float] = None) -> None:
        with self.tracer.span("net_poll"):
            self._poll_remote_clients(now)

    def _poll_remote_clients(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        datagrams_in = 0
        with self.tracer.span("net_recv"):
            for addr, data in self.socket.receive_all():
                datagrams_in += 1
                ep = self._endpoints.get(addr)
                if ep is None:
                    continue  # unknown peer: drop (untrusted input)
                msg = proto.decode(data)
                if msg is None:
                    ep.note_undecodable(data)
                    continue
                ep.on_message(
                    msg,
                    now,
                    lambda m, _addr=addr, _now=now: self._on_remote_inputs(
                        _addr, m, _now
                    ),
                )
        if datagrams_in:
            self.metrics.count("datagrams_in", datagrams_in)

        self._check_desync()
        self._maybe_send_checksums(now)

        local_adv = self._local_advantage()
        with self.tracer.span("net_send"):
            for addr, ep in self._endpoints.items():
                before = ep.state
                ep.poll(now, self.current_frame, local_adv)
                if before != PeerState.DISCONNECTED and ep.state == PeerState.DISCONNECTED:
                    self._on_peer_disconnected(addr)
                ack = self._ack_frame_for(addr)
                ep.send_pending_inputs(now, self.current_frame, local_adv, ack)
                if ep.control_inbox:
                    self._control_inbox.extend(
                        (addr, m) for m in ep.control_inbox
                    )
                    ep.control_inbox.clear()
                    if len(self._control_inbox) > 256:
                        del self._control_inbox[:-256]
                self._events.extend(ep.events)
                ep.events.clear()
                for data in ep.outbox:
                    self.socket.send_to(data, addr)
                ep.outbox.clear()

        ahead = self.frames_ahead()
        if ahead > 0:
            self._events.append(
                SessionEvent(EventKind.WAIT_RECOMMENDATION, data={"skip_frames": ahead})
            )

    # ------------------------------------------------------------------
    # Supervisor surface (session/supervisor.py)

    def drain_control(self) -> List:
        """Take every parked state-transfer message as (addr, msg) pairs.
        The supervisor (not the session) owns recovery policy."""
        out, self._control_inbox = self._control_inbox, []
        return out

    def send_control(self, addr: object, msg: proto.Message) -> None:
        """Send a state-transfer message directly (bypasses the endpoint
        outbox: recovery traffic must flow even to SYNCHRONIZING/quarantined
        peers the normal input path won't talk to)."""
        self.metrics.count("datagrams_out")
        self.socket.send_to(proto.encode(msg), addr)

    def checksum_votes(self, frame: int, pop: bool = False) -> Dict[object, int]:
        """Every remote peer's reported checksum for a settled exchange
        frame (addr -> checksum), recorded by ``_check_desync`` for
        agreeing AND mismatching peers alike — the ballot the supervisor
        uses to decide which side of a desync is the minority."""
        votes = self._checksum_votes.get(frame, {})
        if pop:
            self._checksum_votes.pop(frame, None)
        return dict(votes)

    def reconnect_peer(self, addr: object) -> bool:
        """Replace a DISCONNECTED peer's endpoint with a fresh
        SYNCHRONIZING one so a restarted process at the same address can
        re-handshake mid-match. The dead peer's handles stay in
        ``_disconnected`` (frozen inputs) until its confirmed inputs start
        flowing again (see the readmit path in ``_on_remote_inputs``)."""
        ep = self._endpoints.get(addr)
        if ep is None or ep.state != PeerState.DISCONNECTED:
            return False
        fresh = PeerEndpoint(
            addr,
            self._rng,
            disconnect_timeout=self._disconnect_timeout,
            disconnect_notify_start=self._disconnect_notify_start,
            metrics=self.metrics,
            config_digest=self.config_digest,
        )
        fresh.reconnecting = True
        self._endpoints[addr] = fresh
        return True

    def _local_advantage(self) -> int:
        """Our frame advantage over the slowest running peer (sent in input
        msgs / quality reports for the peer's own frames_ahead)."""
        adv = 0
        for ep in self._endpoints.values():
            if ep.state == PeerState.RUNNING and ep.remote_frame != NULL_FRAME:
                adv = max(adv, self.current_frame - ep.remote_frame)
        # The advantage rides an int16 wire field; a remote_frame briefly
        # seeded by a corrupted datagram must skew timesync, not crash the
        # encoder.
        return min(adv, 0x7FFF)

    def _ack_frame_for(self, addr: object) -> int:
        handles = [h for h, a in self._handle_addr.items() if a == addr]
        if not handles:
            return NULL_FRAME
        return min(self._queues[h].last_confirmed_frame for h in handles)

    def _on_remote_inputs(
        self, sender: object, msg: proto.InputMsg, now: float
    ) -> None:
        h = msg.handle
        if not 0 <= h < self.num_players or h not in self._handle_addr:
            return
        owner = self._handle_addr[h]
        relayed = sender != owner
        if relayed:
            # Handle-ownership check: a peer may only speak for its own
            # players — except survivors relaying a quarantined-or-dead
            # player's confirmed inputs (see _relay_disconnected_inputs).
            # `h in _disconnected` also admits the window where the owner's
            # replacement endpoint is back to RUNNING but its own confirmed
            # stream hasn't caught up past the relayed tail yet.
            owner_ep = self._endpoints.get(owner)
            dead = (
                owner_ep is None
                or owner_ep.state == PeerState.DISCONNECTED
                or h in self._disconnected
            )
            if not dead:
                return
            if sender in self._spectator_addrs:
                return  # spectators never contribute inputs
        queue = self._queues[h]
        for frame, bits in proto.unpack_input_span(
            msg, np.dtype(self._zero.dtype), self._zero.shape
        ):
            if frame != queue.last_confirmed_frame + 1:
                if frame <= queue.last_confirmed_frame:
                    self.metrics.count("input_frames_redundant")
                    continue  # redundant resend
                self.metrics.count("input_span_gaps")
                break  # gap (loss beyond span) — wait for next resend
            queue.add_input(frame, bits)
            self._note_confirmed(h, frame, queue.confirmed(frame))
        if (
            not relayed
            and h in self._disconnected
            and self._endpoints[owner].state == PeerState.RUNNING
            and queue.last_confirmed_frame >= self._disconnected[h]
        ):
            # Readmit: the owner re-handshook (reconnect_peer) and its OWN
            # confirmed stream reached the disconnect point, so its inputs
            # are no longer frozen. Deleting the entry flips this handle's
            # status back to live in subsequent gathers only — already
            # simulated frames keep their recorded DISCONNECTED status, and
            # game systems never read status into state (docs/parity.md),
            # so peers readmitting at different frames stay bitwise equal.
            del self._disconnected[h]
            self._events.append(
                SessionEvent(
                    EventKind.PLAYER_REJOINED,
                    addr=owner,
                    data={"handle": h},
                )
            )
        if relayed and queue.last_confirmed_frame >= 0:
            # Relayed handles are outside the piggybacked-ack path: ack
            # explicitly so the relaying survivor can trim its span.
            self._endpoints[sender].send_input_ack(
                h, queue.last_confirmed_frame, now
            )

    def _note_confirmed(self, handle: int, frame: int, bits: np.ndarray) -> None:
        """A confirmed input arrived; if we already simulated ``frame`` with
        different bits (a prediction, or a disconnect-freeze later corrected
        by a surviving peer's relay), schedule a rollback to it."""
        self._tracker.note_confirmed(handle, frame, bits)

    def _on_peer_disconnected(self, addr: object) -> None:
        """All handles at ``addr`` become disconnected: their inputs freeze
        at repeat-last with DISCONNECTED status. Because peers may have
        received different amounts of the dead player's input (loss/latency
        asymmetry), each survivor relays the confirmed tail it holds to the
        others; later-arriving relayed inputs trigger a normal corrective
        rollback via ``_note_confirmed``, so survivors converge on the
        longest available history instead of desyncing."""
        for h, a in self._handle_addr.items():
            if a == addr and h not in self._disconnected:
                self._disconnected[h] = self.current_frame
                self._relay_disconnected_inputs(h)

    def _relay_disconnected_inputs(self, handle: int) -> None:
        queue = self._queues[handle]
        dead_addr = self._handle_addr[handle]
        spectators = set(self._spectator_addrs)
        horizon = max(0, self.current_frame - self.max_prediction - 1)
        for addr, ep in self._endpoints.items():
            if addr == dead_addr or addr in spectators:
                continue
            if ep.state == PeerState.DISCONNECTED:
                continue
            for f in range(horizon, queue.last_confirmed_frame + 1):
                got = queue.confirmed(f)
                if got is not None:
                    ep.queue_input(handle, f, got, relay=True)

    def disconnect_player(self, handle: int) -> None:
        """Voluntarily drop a remote player (ggrs ``disconnect_player``)."""
        addr = self._handle_addr.get(handle)
        if addr is None:
            raise InvalidRequest(f"handle {handle} is not remote")
        ep = self._endpoints[addr]
        if ep.state != PeerState.DISCONNECTED:
            ep.force_disconnect()
            self._events.extend(ep.events)
            ep.events.clear()
        self._on_peer_disconnected(addr)

    # ------------------------------------------------------------------
    # Checkpoint / resume (host crash recovery)

    # How far below current_frame state_dict probes for surviving history
    # (the GC horizon is dynamic; this just bounds the probe loop). Must
    # exceed SPECTATOR_MAX_LAG: the GC floor retains input history back to
    # the laggiest live spectator's cursor, and a checkpoint that truncated
    # it would leave a resumed host unable to continue that fan-out.
    _CKPT_PROBE = SPECTATOR_MAX_LAG + 128

    def state_dict(self) -> Dict:
        """JSON-serializable local session state for crash recovery.

        Captures frame counters, per-player confirmed-input history and
        used-input (prediction) records within the GC window, disconnect
        map, spectator fan-out cursors, and checksum-exchange state.
        Endpoint/network state is deliberately NOT captured: a restored
        host builds fresh endpoints and re-runs the sync handshake (live
        peers answer SyncRequest while RUNNING), and input-span redundancy
        re-delivers anything in flight at crash time. Checkpoint at tick
        boundaries (after ``handle_requests``), like CheckpointManager
        does."""
        lo = max(0, self.current_frame - self._CKPT_PROBE)
        inputs = serialize_spans(self._queues, lo)
        # Confirmed frontier + prediction source survive even when the
        # span itself fell outside the probe window (long-disconnected
        # players): the restored queue must keep predicting the FROZEN
        # last input, not zeros, or survivors desync.
        queue_meta: Dict[str, Dict] = {
            str(h): {
                "last_confirmed": int(q.last_confirmed_frame),
                "last_input": np.asarray(q.last_input).tolist(),
            }
            for h, q in enumerate(self._queues)
        }
        used: Dict[str, list] = {}
        for f in range(lo, self.current_frame):
            got = self._tracker.get_used(f)
            if got is not None:
                bits, status = got
                used[str(f)] = [np.asarray(bits).tolist(),
                                np.asarray(status).tolist()]
        return {
            "current_frame": self.current_frame,
            "inputs": inputs,
            "queue_meta": queue_meta,
            "used": used,
            "disconnected": {str(h): int(f)
                             for h, f in self._disconnected.items()},
            "spec_sent": {str(i): int(self._spec_sent[a])
                          for i, a in enumerate(self._spectator_addrs)},
            "checksums": {str(f): int(c)
                          for f, c in self._local_checksums.items()},
            "last_checksum_sent": int(self._last_checksum_sent),
        }

    def load_state_dict(self, sd: Dict) -> None:
        """Restore :meth:`state_dict` into a freshly constructed session
        (same topology/knobs/socket binding). Used-input records replay
        first, then every confirmed input re-notes against them — so a
        misprediction that was pending at crash time re-derives its
        ``first_incorrect`` and the next ``advance_frame`` emits the same
        rollback the crashed session would have."""
        self.current_frame = int(sd["current_frame"])
        dtype = self._zero.dtype
        shape = self._zero.shape
        for f_str in sorted(sd["used"], key=int):
            bits, status = sd["used"][f_str]
            self._tracker.record_used(
                int(f_str),
                np.asarray(bits, dtype=dtype).reshape((self.num_players,) + shape),
                np.asarray(status, np.int32),
            )
        # Re-derive pending mispredictions vs the used records while
        # replaying each confirmed input.
        restore_spans(
            self._queues, sd["inputs"], self.current_frame, dtype, shape,
            meta=sd.get("queue_meta"),
            on_confirmed=self._tracker.note_confirmed,
        )
        self._disconnected = {
            int(h): int(f) for h, f in sd["disconnected"].items()
        }
        # Dead peers' fresh endpoints must not gate the sync handshake (a
        # SYNCHRONIZING endpoint for a player who disconnected pre-crash
        # would park current_state() forever).
        for h, _f in self._disconnected.items():
            addr = self._handle_addr.get(h)
            ep = self._endpoints.get(addr)
            if ep is not None and ep.state != PeerState.DISCONNECTED:
                ep.force_disconnect()
                ep.events.clear()  # restored fact, not a new event
        for i, a in enumerate(self._spectator_addrs):
            if str(i) in sd.get("spec_sent", {}):
                self._spec_sent[a] = int(sd["spec_sent"][str(i)])
        self._local_checksums = {
            int(f): int(c) for f, c in sd["checksums"].items()
        }
        self._last_checksum_sent = int(sd.get("last_checksum_sent", -1))
        self._pending_local.clear()
        # Local input history must be re-offered to peers: endpoint ack
        # state died with the endpoints, and peers may have missed the
        # in-flight tail. Spans are idempotent receiver-side (stale frames
        # are dropped), so re-queue everything surviving in the local
        # queues.
        for h in self.local_handles:
            q = self._queues[h]
            for f_str in sorted(sd["inputs"].get(str(h), {}), key=int):
                got = q.confirmed(int(f_str))
                if got is not None:
                    for addr in self._handle_addr.values():
                        self._endpoints[addr].queue_input(h, int(f_str), got)

    # ------------------------------------------------------------------
    # Checksums / desync detection

    def wants_checksum(self, frame: int) -> bool:
        """Only exchange-interval frames are worth the device->host sync a
        checksum report costs (see RollbackRunner); desync detection
        compares exactly these. Always False with detection disabled —
        bursts then complete without any host sync."""
        return self.desync_interval > 0 and frame % self.desync_interval == 0

    def report_checksum(self, frame: int, checksum: int) -> None:
        """Driver reports each saved frame's checksum (the
        ``GameStateCell::save`` analog). Resimulated frames overwrite —
        only *confirmed* frames are comparable across peers."""
        self._local_checksums[frame] = int(checksum)
        horizon = self.confirmed_frame() - 4 * max(self.desync_interval, 1)
        for f in [f for f in self._local_checksums if f < horizon]:
            del self._local_checksums[f]

    def _settled(self, frame: int) -> bool:
        """A frame's local checksum is final iff every input ≤ it is
        confirmed AND no pending rollback reaches it (a mispredicted frame's
        checksum is stale until the next ``advance_frame`` resimulates and
        re-reports it)."""
        if frame > self.confirmed_frame():
            return False
        fi = self._tracker.first_incorrect
        return fi == NULL_FRAME or frame < fi

    def _maybe_send_checksums(self, now: float) -> None:
        if self.desync_interval <= 0:
            return  # detection disabled: nothing sent, nothing compared
        target = (
            self.confirmed_frame() // self.desync_interval
        ) * self.desync_interval
        if target <= self._last_checksum_sent or target < 0:
            return
        if not self._settled(target):
            return  # retry next poll, after the rollback corrects it
        cs = self._local_checksums.get(target)
        if cs is None:
            return
        for ep in self._endpoints.values():
            if ep.state == PeerState.RUNNING:
                ep.send_checksum(target, cs, now)
        self._last_checksum_sent = target

    def _check_desync(self) -> None:
        for ep in self._endpoints.values():
            for frame in sorted(ep.remote_checksums):
                if not self._settled(frame):
                    continue  # keep until our own checksum is final
                remote = ep.remote_checksums[frame]
                local = self._local_checksums.get(frame)
                # Ballot for the supervisor's majority vote: record every
                # settled compared report, agreeing peers included — a
                # 2-vs-1 desync is only decidable when the agreeing peer's
                # vote is on file too.
                self._checksum_votes.setdefault(frame, {})[ep.addr] = remote
                self.metrics.count("checksum_ballots")
                if local is not None:
                    self.metrics.count("checksums_compared")
                if (
                    local is not None
                    and local != remote
                    and frame not in self._desynced_frames
                ):
                    self._desynced_frames.add(frame)
                    self.metrics.count("desyncs_flagged")
                    self.tracer.instant(
                        "desync_detected", frame=frame, peer=str(ep.addr)
                    )
                    self._events.append(
                        SessionEvent(
                            EventKind.DESYNC_DETECTED,
                            addr=ep.addr,
                            data={"frame": frame, "local": local, "remote": remote},
                        )
                    )
                del ep.remote_checksums[frame]
        horizon = self.confirmed_frame() - 8 * max(self.desync_interval, 1)
        for f in [f for f in self._checksum_votes if f < horizon]:
            del self._checksum_votes[f]

    # ------------------------------------------------------------------
    # Input + advance (the protocol heart)

    def add_local_input(self, handle: int, bits) -> None:
        """Feed this frame's input for a local player (`ggrs_stage.rs:246`).
        Must be called for every local handle before ``advance_frame``."""
        if handle not in self.local_handles:
            raise InvalidRequest(f"handle {handle} is not local")
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronized("session is still synchronizing")
        self._pending_local[handle] = np.asarray(
            bits, dtype=self._zero.dtype
        ).reshape(self._zero.shape)

    def advance_frame(self) -> List[object]:
        with self.tracer.span("advance_frame"):
            return self._advance_frame()

    def _advance_frame(self) -> List[object]:
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronized("session is still synchronizing")
        missing = [h for h in self.local_handles if h not in self._pending_local]
        if missing:
            raise InvalidRequest(f"missing local input for handles {missing}")

        # Back-pressure (`GGRSError::PredictionThreshold`): refuse to run
        # more than max_prediction frames past the last confirmed input.
        confirmed = self.confirmed_frame()
        if self.current_frame - confirmed > self.max_prediction:
            raise PredictionThreshold(
                f"frame {self.current_frame} is more than {self.max_prediction} "
                f"frames past last confirmed {confirmed}"
            )

        # Commit local inputs (after input delay) and stage them for send.
        frame = self.current_frame
        spectators = set(self._spectator_addrs)
        for h in self.local_handles:
            target = self._queues[h].add_local_input(frame, self._pending_local[h])
            for addr, ep in self._endpoints.items():
                if addr in spectators:
                    continue  # spectators get the confirmed fan-out instead
                if ep.state == PeerState.DISCONNECTED:
                    continue  # never queue to the dead — unbounded growth
                # Reconnect endpoints buffer too (bounded inside
                # queue_input): a rejoiner's state checkpoint is cut the
                # moment WE serve it, so every input we produce while its
                # handshake is still in flight must reach it as a span or
                # the frontier gaps and both sides deadlock at the
                # prediction window.
                for f in range(
                    max(0, target - (self._queues[h].delay or 0)), target + 1
                ):
                    got = self._queues[h].confirmed(f)
                    if got is not None:
                        ep.queue_input(h, f, got)
                refill = ep.refill_range(h)
                if refill is not None:
                    # A corrupted lying-high ack trimmed frames the peer
                    # never received; restore them from our own input
                    # history (bounded by the _gc retention window) so the
                    # peer's frontier can't gap permanently.
                    start = max(
                        refill[0],
                        0,
                        self.current_frame - 2 * self.max_prediction - 1,
                    )
                    for f in range(start, refill[1]):
                        got = self._queues[h].confirmed(f)
                        if got is not None:
                            ep.queue_input(h, f, got)
        self._pending_local.clear()

        requests: List[object] = []

        # Rollback: a confirmed input contradicted a prediction.
        rollback_to = self._tracker.first_incorrect
        if rollback_to != NULL_FRAME:
            floor = frame - self.max_prediction
            if rollback_to < floor:
                # Deeper than the snapshot ring reaches — possible only
                # when late inputs contradict a frame we already settled
                # with a frozen prediction (a readmitted peer that never
                # actually died). Roll back as far as snapshots exist; the
                # residual divergence is exactly what desync detection +
                # the supervisor's state resync repair.
                rollback_to = floor
            self.metrics.count("mispredictions")
            self.metrics.observe("misprediction_depth", frame - rollback_to)
            requests.append(LoadGameState(rollback_to))
            for f in range(rollback_to, frame):
                requests.append(SaveGameState(f))
                requests.append(self._advance_request(f))
            self._tracker.clear_first_incorrect()

        # The new frame.
        requests.append(SaveGameState(frame))
        requests.append(self._advance_request(frame))
        self.current_frame = frame + 1

        self._fanout_spectators()
        self._gc()
        return requests

    def _advance_request(self, frame: int) -> AdvanceFrame:
        disc = [
            self._disconnected.get(h, NEVER_DISCONNECTED)
            for h in range(self.num_players)
        ]
        bits, status = self._qset.gather(frame, disc)
        self._tracker.record_used(frame, bits, status)
        return AdvanceFrame(bits=bits, status=status)

    def _fanout_spectators(self) -> None:
        """Queue newly-confirmed inputs of ALL players to every spectator."""
        if not self._spectator_addrs:
            return
        confirmed = self.confirmed_frame()
        for addr in self._spectator_addrs:
            ep = self._endpoints[addr]
            if confirmed - self._spec_sent[addr] > SPECTATOR_MAX_LAG:
                # Too far behind (never synced, or stalled): drop it so the
                # host stops retaining input history on its behalf.
                ep.force_disconnect()
            if ep.state != PeerState.RUNNING:
                # Not synced yet: keep the cursor frozen instead of
                # accumulating unsendable pending spans; on sync the full
                # history streams from the cursor.
                continue
            start = self._spec_sent[addr] + 1
            for f in range(start, confirmed + 1):
                for h, q in enumerate(self._queues):
                    got = q.confirmed(f)
                    if got is None and h in self._disconnected:
                        got, _ = q.input(f)
                    if got is not None:
                        ep.queue_input(h, f, got)
            self._spec_sent[addr] = max(self._spec_sent[addr], confirmed)

    def _spectator_floor(self) -> int:
        """Oldest frame a live spectator still needs from the fan-out —
        input history must not be GC'd past it."""
        floor = None
        for addr in self._spectator_addrs:
            if self._endpoints[addr].state == PeerState.DISCONNECTED:
                continue
            cursor = self._spec_sent[addr] + 1
            floor = cursor if floor is None else min(floor, cursor)
        return floor if floor is not None else 2**31

    def _gc(self) -> None:
        """Drop history that can no longer participate in a rollback or the
        spectator fan-out."""
        horizon = min(
            self.confirmed_frame(),
            # Two windows, not one: a quarantined peer replays from a donor
            # snapshot cut at the DONOR's confirmed frontier, which can lag
            # ours by most of a prediction window under loss — the replay
            # gathers those older frames from these queues.
            self.current_frame - 2 * self.max_prediction - 1,
            self._spectator_floor(),
        )
        self._qset.discard_before(horizon)
        self._tracker.discard_before(horizon)
