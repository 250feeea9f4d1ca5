"""FleetBalancer: placement, live migration, and server-loss failover.

Counterpart of ``bevy_ggrs_tpu/fleet/balancer.py``: the same wire bytes
(heartbeats, type 18-21 migration frames) and the same decisions, over
the port's MatchServers.

The balancer is a control-plane process: it never simulates a frame and
never touches a session's inputs. Its inputs are the per-server
:class:`~bevy_ggrs_tpu_torch.session.protocol.FleetHeartbeat` beacons (SLO
pages, quarantine counts, occupancy) arriving on its socket; its outputs
are admissions, migrations and failovers performed through the public
MatchServer surface (``add_match`` / ``suspend_match`` /
``resume_match`` / ``adopt_rejoin``).

Design invariants, in order of importance:

1. **No match is ever lost by a migration.** The source's
   :class:`~bevy_ggrs_tpu_torch.serve.faults.SlotTicket` is retained until the
   destination verified the wire blob's integrity digest and readmitted;
   any failure — refused offer, missing chunk, CRC or digest mismatch —
   aborts by readmitting the retained ticket at the source's original
   (group, slot).
2. **Migration is bitwise.** The destination readmits from the
   WIRE-DECODED ticket (not the in-memory one), so a passing soak proves
   the full encode → chunk → reassemble → decode path preserves the
   trajectory exactly.
3. **Silence is not death until the timeout says so.** A
   :class:`~bevy_ggrs_tpu_torch.chaos.plan.BalancerPartition` shorter than
   ``heartbeat_timeout`` must produce zero failovers — the false-positive
   discipline docs/chaos.md specifies.
4. **Churn never compiles.** Placement lands on existing batched slots;
   migration readmits through the traced-index admit path; failover uses
   the same resume/adopt paths crash-restart uses. A fleet soak asserts
   that no kernel is built and no checksum layout prepared after warmup
   (``utils/build_cache.py``), per server end to end.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.serve.faults import (
    SlotTicket,
    load_checkpoint_matches,
    pack_match_record,
    unpack_match_record,
)
from bevy_ggrs_tpu_torch.serve.server import MatchHandle
from bevy_ggrs_tpu_torch.session import protocol as proto

__all__ = ["FleetBalancer", "FleetMember", "Migration", "Placement"]

#: Migration blob fragments mirror the relay keyframe chunking.
CHUNK_PAYLOAD = 1024


def _is_p2p(session) -> bool:
    # Mirrors serve.server._supervisable: ballots + control channel mark
    # a session whose state lives on the network, not in a state_dict.
    return hasattr(session, "checksum_votes") and hasattr(
        session, "drain_control"
    )


class _LiveSlotView:
    """Runner-shaped view of wherever a served match currently lives —
    batched slot or recovery lane — resolved per read, so a
    :class:`~bevy_ggrs_tpu_torch.relay.stream.StatePublisher` re-pointed here
    stays correct through lane drains and readmissions after a
    migration/failover hop."""

    def __init__(self, server, handle: MatchHandle):
        self._server = server
        self._handle = handle

    def _runner(self):
        lane = self._server._lanes.get(self._handle)
        return None if lane is None else lane.runner

    @property
    def state(self):
        r = self._runner()
        if r is not None:
            return r.state
        return self._server.groups[self._handle.group].slot_state(
            self._handle.slot
        )

    @property
    def ring(self):
        r = self._runner()
        if r is not None:
            return r.ring
        return self._server.groups[self._handle.group].slot_ring(
            self._handle.slot
        )

    @property
    def frame(self) -> int:
        r = self._runner()
        if r is not None:
            return int(r.frame)
        return self._server.groups[self._handle.group].slots[
            self._handle.slot
        ].frame

    @property
    def max_prediction(self) -> int:
        return self._server.groups[self._handle.group].max_prediction


@dataclasses.dataclass
class FleetMember:
    """One supervised server: the live object (None once dead), its
    migration-endpoint address + socket, its checkpoint directory (the
    failover source of truth), and the freshest heartbeat."""

    server_id: int
    server: object
    addr: object = None
    sock: object = None
    checkpoint_dir: Optional[str] = None
    alive: bool = True
    draining: bool = False
    last_beat: Optional[float] = None
    info: Optional[proto.FleetHeartbeat] = None
    # Monotonic-staleness liveness: ``last_beat`` only advances on a beat
    # whose ``beat_seq`` is strictly newer than any seen (a REORDERED old
    # beat carries no liveness information); ``missed_beats`` is the
    # receiver-derived count of expected-but-unheard beats since.
    last_beat_seq: int = -1
    missed_beats: int = 0


@dataclasses.dataclass
class Placement:
    """The balancer's book entry for one fleet-managed match — everything
    failover needs to re-establish it without asking anyone."""

    match_id: int
    server_id: int
    handle: MatchHandle
    session: object
    local_inputs: Optional[Callable[[int, int], object]] = None
    donor: object = None  # P2P failover rejoin donor (surviving peer addr)
    publisher: object = None  # StatePublisher to rehost across hops


@dataclasses.dataclass
class Migration:
    """In-flight live migration state. ``ticket`` is the retained source
    ticket — the abort path's guarantee that the match survives any wire
    failure. ``resolved`` goes True exactly once, via readmit-at-dst or
    abort-back-to-src."""

    nonce: int
    match_id: int
    src_id: int
    dst_id: int
    src_handle: MatchHandle
    ticket: SlotTicket
    frame: int
    total: int
    digest: int
    begun_dst_frames: int
    epoch: int = 0
    chunks: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    offer_seen: bool = False
    done_seen: bool = False
    accepted: Optional[bool] = None
    resolved: bool = False
    aborted: bool = False
    dst_handle: Optional[MatchHandle] = None
    stall_frames: Optional[int] = None


class FleetBalancer:
    def __init__(
        self,
        socket=None,
        addr=None,
        heartbeat_timeout: float = 0.5,
        clock: Optional[Callable[[], float]] = None,
        plan=None,
        metrics=None,
        tracer=None,
        page_refusal_threshold: int = 1,
        spec_hit_weight: float = 0.25,
        spec_waste_weight: float = 0.5,
        dead_beats: int = 3,
        reliable_wire: bool = True,
    ):
        import time as _time

        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.socket = socket
        self.addr = addr
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._clock = clock if clock is not None else _time.monotonic
        # Chaos plan consulted for BalancerPartition windows: a partitioned
        # member's heartbeats are dropped at ingest, modelling control-plane
        # silence without touching the data plane.
        self.plan = plan
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        # Placement policy: a member whose last type-22 heartbeat carries
        # >= this many SLO pages is REFUSED as a placement target while
        # any calmer candidate exists (<=0 disables the refusal).
        self.page_refusal_threshold = int(page_refusal_threshold)
        # Speculation economics in the placement score (heartbeat
        # spec_hit/spec_waste permille): sub-occupancy weights, so they
        # only break ties between equally-loaded calm servers.
        self.spec_hit_weight = float(spec_hit_weight)
        self.spec_waste_weight = float(spec_waste_weight)
        self.placements_refused_paging = 0
        self.placements_on_paging = 0
        # Server-loss discipline: dead = ``dead_beats`` consecutive missed
        # beats on a monotonically-stale liveness clock (one beat period is
        # heartbeat_timeout / dead_beats), so neither a single lost beat
        # nor a REORDERED stale one can flip a live server to dead.
        self.dead_beats = max(1, int(dead_beats))
        # Wrap member migration sockets in the reliable sublayer
        # (transport/reliable.py) so type 18-21 frames survive chaos.
        self.reliable_wire = bool(reliable_wire)
        self.members: Dict[int, FleetMember] = {}
        self.placements: Dict[int, Placement] = {}
        self._nonce = 0
        # Fencing tokens: per-match epoch, bumped on every transfer
        # attempt; a landing from a superseded epoch is refused without
        # readmit (the newer attempt owns the match).
        self._epochs: Dict[int, int] = {}
        self.migrations_begun = 0
        self.migrations_completed = 0
        self.migrations_aborted = 0
        self.abort_reasons: Dict[str, int] = {}
        self.epoch_fence_refusals = 0
        self.failovers = 0
        self.matches_recovered = 0
        self.matches_lost = 0

    # -- membership ------------------------------------------------------

    def register(
        self,
        server_id: int,
        server,
        addr=None,
        sock=None,
        checkpoint_dir: Optional[str] = None,
    ) -> FleetMember:
        if sock is not None and self.reliable_wire:
            from bevy_ggrs_tpu_torch.transport.reliable import ReliableSocket

            if not isinstance(sock, ReliableSocket):
                sock = ReliableSocket(
                    sock, clock=self._clock, seed=int(server_id)
                )
        m = FleetMember(
            server_id=int(server_id),
            server=server,
            addr=addr,
            sock=sock,
            checkpoint_dir=checkpoint_dir,
            last_beat=self._clock(),
        )
        self.members[m.server_id] = m
        return m

    def _alive(self) -> List[FleetMember]:
        return [
            m
            for m in self.members.values()
            if m.alive and m.server is not None
        ]

    def set_draining(self, server_id: int, draining: bool = True) -> None:
        """A draining member stops being a placement/migration target (its
        hosted matches keep serving) — the first act of the autopilot's
        drain-pack-retire sequence."""
        self.members[int(server_id)].draining = bool(draining)
        if draining:
            self.metrics.count("fleet_servers_draining")
        self.tracer.instant(
            "fleet_drain", server=int(server_id), draining=bool(draining)
        )

    def retire_member(self, server_id: int) -> FleetMember:
        """Remove a drained member from the fleet. Refuses (ValueError)
        while any placement still points at it — retire is the LAST act
        of drain-pack-retire, never a way to lose matches. The caller
        owns the returned member's server/socket teardown."""
        sid = int(server_id)
        hosted = [
            pl.match_id
            for pl in self.placements.values()
            if pl.server_id == sid
        ]
        if hosted:
            raise ValueError(
                f"server {sid} still hosts matches {hosted}; pack them off "
                "before retiring"
            )
        member = self.members.pop(sid)
        self.metrics.count("fleet_servers_retired")
        self.tracer.instant("fleet_retire", server=sid)
        return member

    def fleet_rows(self) -> List[Dict]:
        """Per-server fleet table rows (occupancy, burn, spec quality)
        for the HTML ops report (:func:`~bevy_ggrs_tpu_torch.obs.report.
        build_report` ``fleet=``)."""
        rows = []
        for sid, m in sorted(self.members.items()):
            hb = m.info
            if hb is None and m.alive and m.server is not None:
                hb = m.server.heartbeat()
            row = {
                "server_id": sid,
                "alive": m.alive,
                "draining": m.draining,
                "missed_beats": m.missed_beats,
                "matches": sum(
                    1 for pl in self.placements.values()
                    if pl.server_id == sid
                ),
            }
            if hb is not None:
                total = max(1, hb.slots_active + hb.slots_free)
                row.update(
                    slots_active=hb.slots_active,
                    slots_free=hb.slots_free,
                    occupancy=hb.slots_active / total,
                    pages=hb.pages,
                    quarantined=hb.quarantined,
                    spec_hit_permille=hb.spec_hit_permille,
                    spec_waste_permille=hb.spec_waste_permille,
                    score=self._score(m),
                )
            rows.append(row)
        return rows

    @property
    def ctrl_retransmits(self) -> int:
        """Reliable-sublayer retransmits across every member wire — the
        chaos soak's 'the control plane actually fought packet loss'
        witness."""
        return sum(
            int(getattr(m.sock, "retransmits", 0) or 0)
            for m in self.members.values()
            if m.sock is not None
        )

    # -- heartbeats + death detection ------------------------------------

    def pump(self, now: Optional[float] = None) -> int:
        """Drain the balancer socket: every decodable
        :class:`FleetHeartbeat` refreshes its member's liveness clock and
        load picture. Heartbeats from a member inside a
        :class:`BalancerPartition` window are dropped — the balancer is
        deliberately deaf to them, which is exactly the condition its
        false-positive discipline is tested under. Returns heartbeats
        applied."""
        if self.socket is None:
            return 0
        now = self._clock() if now is None else float(now)
        applied = 0
        for _addr, data in self.socket.receive_all():
            msg = proto.decode(data)
            if not isinstance(msg, proto.FleetHeartbeat):
                continue
            if self.plan is not None and self.plan.balancer_partitioned(
                msg.server_id, now
            ):
                self.metrics.count("fleet_heartbeats_dropped")
                continue
            member = self.members.get(msg.server_id)
            if member is None:
                continue
            delta = member.last_beat_seq - msg.beat_seq
            if msg.beat_seq > 0 and 0 <= delta <= proto.BEAT_REORDER_WINDOW:
                # Reordered stale beat: a seq we already advanced past
                # must NOT refresh liveness (the false-positive fix's
                # dual: no false NEGATIVES from old beats either).
                # Bounded window, not a bare compare: heartbeats travel
                # unenveloped, so a corrupted beat_seq with a high bit
                # flipped would otherwise poison the floor forever; a
                # far-off seq resets it instead (self-healing).
                self.metrics.count("fleet_heartbeats_stale")
                continue
            member.last_beat_seq = msg.beat_seq
            member.last_beat = now
            member.missed_beats = 0
            member.info = msg
            applied += 1
            self.metrics.count("fleet_heartbeats_rx")
        return applied

    def check(self, now: Optional[float] = None) -> List[int]:
        """Declare members dead after ``dead_beats`` CONSECUTIVE missed
        beats (one beat period = ``heartbeat_timeout / dead_beats``, so
        the total silence budget is unchanged); returns newly-dead server
        ids (the caller triggers :meth:`failover` — detection and
        recovery are separate acts so a harness can interleave them with
        frame serving). Because :meth:`pump` refuses to let a reordered
        stale beat advance ``last_beat``, the missed count is monotone
        under silence — one lucky old datagram cannot reset it."""
        now = self._clock() if now is None else float(now)
        period = self.heartbeat_timeout / self.dead_beats
        dead: List[int] = []
        for m in self.members.values():
            if not m.alive or m.last_beat is None:
                continue
            m.missed_beats = max(0, int((now - m.last_beat) / period))
            if m.missed_beats >= self.dead_beats:
                m.alive = False
                dead.append(m.server_id)
                self.metrics.count("fleet_servers_dead")
                self.tracer.instant(
                    "fleet_server_dead",
                    server=m.server_id,
                    silent_for=now - m.last_beat,
                    missed_beats=m.missed_beats,
                )
        return dead

    # -- placement -------------------------------------------------------

    def _score(self, m: FleetMember) -> float:
        """Lower is better. Heartbeat-derived burn: SLO pages dominate,
        quarantined/recovering slots next, occupancy breaks ties —
        so a healthy-but-full server loses to a healthy-and-empty one
        and any paging server loses to both. The heartbeat's speculation
        economics (hit/waste permille) ride below occupancy's unit
        scale: between equally-loaded calm servers, the one burning more
        device time on wasted branches loses (see
        :func:`~bevy_ggrs_tpu_torch.fleet.autopilot.heartbeat_score`)."""
        from bevy_ggrs_tpu_torch.fleet.autopilot import heartbeat_score

        hb = m.info if m.info is not None else m.server.heartbeat()
        return heartbeat_score(
            hb, self.spec_hit_weight, self.spec_waste_weight
        )

    def _pages(self, m: FleetMember) -> int:
        hb = m.info if m.info is not None else m.server.heartbeat()
        return int(hb.pages)

    def place(self, exclude: Tuple[int, ...] = ()) -> FleetMember:
        """The least-burning live member with a free slot. A member whose
        SLO burn signal is currently paging (type-22 heartbeat ``pages``
        at or above ``page_refusal_threshold``) is refused outright — an
        arrival storm routes around it — unless EVERY candidate is
        paging, in which case the least-burning one still admits (full
        refusal would turn one bad minute into an outage) and the
        concession is counted."""
        candidates = [
            m
            for m in self._alive()
            if m.server_id not in exclude
            and not m.draining
            and m.server.free_slot_handles()
        ]
        if not candidates:
            raise RuntimeError("fleet has no admittable server")
        if self.page_refusal_threshold > 0:
            calm = [
                m for m in candidates
                if self._pages(m) < self.page_refusal_threshold
            ]
            if calm and len(calm) < len(candidates):
                self.placements_refused_paging += 1
                self.metrics.count("fleet_placements_refused_paging")
                candidates = calm
            elif not calm:
                self.placements_on_paging += 1
                self.metrics.count("fleet_placements_on_paging")
        return min(candidates, key=lambda m: (self._score(m), m.server_id))

    def place_match(
        self,
        match_id: int,
        session,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        initial_state=None,
        spec_on: bool = True,
        donor=None,
        publisher=None,
        server_id: Optional[int] = None,
        trace=None,
        queue: bool = False,
    ) -> Tuple[int, MatchHandle]:
        """Fleet-level admission: pick a server (or honor the pin), admit
        at its least-loaded stagger group, book the placement. With
        ``queue=True`` the server-side admission goes through its admit
        queue (:meth:`~bevy_ggrs_tpu_torch.serve.server.MatchServer.
        enqueue_match`) — the slot is booked now, the expensive warm
        drains off the destination's frame-critical path. ``trace`` (an
        :class:`~bevy_ggrs_tpu_torch.serve.admission.AdmissionTrace`) gets the
        place stage recorded here and the server stages downstream."""
        if trace is not None:
            trace.begin("place")
        member = (
            self.members[server_id]
            if server_id is not None
            else self.place()
        )
        admit = member.server.enqueue_match if queue else member.server.add_match
        if trace is not None:
            trace.end("place")
        handle = admit(
            session,
            local_inputs,
            initial_state=initial_state,
            spec_on=spec_on,
            trace=trace,
        )
        self.placements[int(match_id)] = Placement(
            match_id=int(match_id),
            server_id=member.server_id,
            handle=handle,
            session=session,
            local_inputs=local_inputs,
            donor=donor,
            publisher=publisher,
        )
        self.metrics.count("fleet_placements")
        self.tracer.instant(
            "fleet_place",
            match=int(match_id),
            server=member.server_id,
            group=handle.group,
            slot=handle.slot,
        )
        return member.server_id, handle

    # -- live migration --------------------------------------------------

    def begin_migration(
        self, match_id: int, dst_id: Optional[int] = None
    ) -> Migration:
        """Drain ``match_id`` off its server and ship its snapshot to the
        destination over the type 18–21 wire: one MigrateOffer carrying
        the whole-blob digest, CRC-guarded chunks, one MigrateDone. The
        source slot frees immediately (the bounded stall begins); the
        retained ticket keeps the abort path open until
        :meth:`complete_migration` resolves."""
        pl = self.placements[int(match_id)]
        src = self.members[pl.server_id]
        dst = (
            self.members[dst_id]
            if dst_id is not None
            else self.place(exclude=(pl.server_id,))
        )
        if dst.server_id == src.server_id:
            raise ValueError("migration destination is the source")
        self._nonce = (self._nonce + 1) & 0xFFFFFFFF
        nonce = self._nonce
        # Bump the match's fencing token: this attempt supersedes every
        # earlier one, whose frames/landings are now refusable by epoch.
        epoch = self._epochs.get(pl.match_id, 0) + 1
        self._epochs[pl.match_id] = epoch
        with self.tracer.span(
            "fleet_migrate",
            phase="begin",
            match=pl.match_id,
            src=src.server_id,
            dst=dst.server_id,
        ):
            session_state = None
            if not _is_p2p(pl.session):
                sd = getattr(pl.session, "state_dict", None)
                session_state = sd() if sd is not None else None
            ticket = src.server.suspend_match(pl.handle)
            blob = pack_match_record(
                src.server.state_codec(),
                {
                    "handle": pl.handle,
                    "kind": "p2p" if _is_p2p(pl.session) else "synctest",
                    "frame": ticket.frame,
                    "state": ticket.state,
                    "ring": ticket.ring,
                    "input_log": ticket.input_log,
                    "spec_on": ticket.spec_on,
                    "session_state": session_state,
                },
            )
            from bevy_ggrs_tpu_torch.relay.delta import payload_digest

            digest = payload_digest(blob)
            chunks = [
                blob[i : i + CHUNK_PAYLOAD]
                for i in range(0, len(blob), CHUNK_PAYLOAD)
            ] or [b""]
            total = len(chunks)
            src.sock.send_to(
                proto.encode(
                    proto.MigrateOffer(
                        nonce, pl.match_id, ticket.frame, total, digest,
                        epoch,
                    )
                ),
                dst.addr,
            )
            for seq, payload in enumerate(chunks):
                src.sock.send_to(
                    proto.encode(
                        proto.MigrateChunk(
                            nonce,
                            ticket.frame,
                            seq,
                            total,
                            zlib.crc32(payload) & 0xFFFFFFFF,
                            payload,
                            epoch,
                        )
                    ),
                    dst.addr,
                )
                self.metrics.count("fleet_migrate_bytes", len(payload))
            src.sock.send_to(
                proto.encode(proto.MigrateDone(nonce, ticket.frame, 1, epoch)),
                dst.addr,
            )
        self.migrations_begun += 1
        self.metrics.count("fleet_migrations_begun")
        return Migration(
            nonce=nonce,
            match_id=pl.match_id,
            src_id=src.server_id,
            dst_id=dst.server_id,
            src_handle=pl.handle,
            ticket=ticket,
            frame=ticket.frame,
            total=total,
            digest=digest,
            begun_dst_frames=dst.server.frames_served,
            epoch=epoch,
        )

    def _abort_migration(self, mig: Migration, reason: str) -> None:
        pl = self.placements[mig.match_id]
        src = self.members[mig.src_id]
        # The source slot was freed by suspend and is not reserved, so the
        # retained ticket readmits at the exact original (group, slot).
        handle = src.server.resume_match(
            pl.session, pl.local_inputs, mig.ticket, handle=mig.src_handle
        )
        pl.server_id, pl.handle = src.server_id, handle
        mig.resolved, mig.aborted = True, True
        self.migrations_aborted += 1
        self.abort_reasons[reason] = self.abort_reasons.get(reason, 0) + 1
        self.metrics.count("fleet_migrations_aborted")
        self.tracer.instant(
            "fleet_migrate_abort", match=mig.match_id, reason=reason
        )

    def _refuse_landing(self, mig: Migration, reason: str) -> None:
        """Epoch fence: a landing from a superseded transfer attempt is
        refused WITHOUT readmitting the retained ticket — the newer epoch
        owns the match, and resurrecting a stale ticket at the source
        would be exactly the duplicate-match split-brain the fence
        exists to kill. Typed event, no match lost (the live copy is the
        newer attempt's)."""
        mig.resolved, mig.aborted = True, True
        self.epoch_fence_refusals += 1
        self.abort_reasons[reason] = self.abort_reasons.get(reason, 0) + 1
        self.metrics.count("fleet_epoch_fence_refusals")
        self.tracer.instant(
            "fleet_epoch_fence",
            match=mig.match_id,
            reason=reason,
            epoch=mig.epoch,
            current=self._epochs.get(mig.match_id, 0),
        )

    def complete_migration(self, mig: Migration) -> Optional[MatchHandle]:
        """Destination-side progress: drain the destination's migration
        socket, ack the offer, reassemble chunks. Once the blob is whole
        it must pass the offer digest AND the in-blob state digest before
        the WIRE-DECODED ticket readmits at the destination's least-loaded
        group; any failure aborts back to the source. Returns the new
        handle when resolved-forward, None while in flight or after an
        abort (check ``mig.aborted``). Call repeatedly between frames."""
        if mig.resolved:
            return mig.dst_handle
        if mig.epoch < self._epochs.get(mig.match_id, 0):
            # This whole attempt was superseded (a newer begin_migration
            # bumped the fence) — refuse it outright, readmitting nothing.
            self._refuse_landing(mig, "epoch_fence")
            return None
        src = self.members[mig.src_id]
        dst = self.members[mig.dst_id]
        for _addr, data in dst.sock.receive_all():
            msg = proto.decode(data)
            if msg is None or getattr(msg, "nonce", None) != mig.nonce:
                continue
            if isinstance(msg, proto.MigrateOffer):
                mig.offer_seen = True
                accept = bool(dst.server.free_slot_handles())
                dst.sock.send_to(
                    proto.encode(
                        proto.MigrateAccept(
                            mig.nonce, accept, msg.epoch,
                            0 if accept else proto.MIG_REFUSE_CAPACITY,
                        )
                    ),
                    src.addr,
                )
                if not accept:
                    self._abort_migration(mig, "offer_refused")
                    return None
            elif isinstance(msg, proto.MigrateChunk):
                if zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc:
                    self._abort_migration(mig, "chunk_crc")
                    return None
                mig.chunks[msg.seq] = msg.payload
            elif isinstance(msg, proto.MigrateDone):
                mig.done_seen = True
        # Source side only learns the accept verdict; a refusal already
        # aborted above, so this drain is bookkeeping.
        for _addr, data in src.sock.receive_all():
            msg = proto.decode(data)
            if (
                isinstance(msg, proto.MigrateAccept)
                and msg.nonce == mig.nonce
            ):
                mig.accepted = bool(msg.accept)
        if not (mig.done_seen and len(mig.chunks) == mig.total):
            return None
        blob = b"".join(mig.chunks[i] for i in range(mig.total))
        from bevy_ggrs_tpu_torch.relay.delta import payload_digest

        if payload_digest(blob) != mig.digest:
            self._abort_migration(mig, "blob_digest")
            return None
        try:
            rec = unpack_match_record(
                dst.server.state_codec(), blob, dst.server._template
            )
        except ValueError:
            self._abort_migration(mig, "record_digest")
            return None
        if mig.epoch < self._epochs.get(mig.match_id, 0):
            # Fence the LANDING too: the blob arrived whole but a newer
            # attempt owns the match now — landing it would host the
            # match twice.
            self._refuse_landing(mig, "epoch_fence")
            return None
        pl = self.placements[mig.match_id]
        with self.tracer.span(
            "fleet_migrate",
            phase="readmit",
            match=mig.match_id,
            src=mig.src_id,
            dst=mig.dst_id,
            frame=rec["frame"],
        ):
            handle = dst.server.resume_match(
                pl.session, pl.local_inputs, rec["ticket"]
            )
        pl.server_id, pl.handle = dst.server_id, handle
        if pl.publisher is not None:
            pl.publisher.rehost(
                runner=_LiveSlotView(dst.server, handle)
            )
        mig.resolved, mig.dst_handle = True, handle
        mig.stall_frames = dst.server.frames_served - mig.begun_dst_frames
        self.migrations_completed += 1
        self.metrics.count("fleet_migrations_completed")
        self.metrics.observe(
            "fleet_migration_stall_frames", mig.stall_frames
        )
        return handle

    # -- server-loss failover --------------------------------------------

    def failover(self, dead_id: int) -> List[Tuple[int, int, MatchHandle]]:
        """Recover a dead server's matches from its last on-disk
        checkpoint onto surviving members: synctest matches resume
        bitwise at the checkpoint frame (session rewound via its saved
        state_dict), P2P matches adopt-rejoin from their booked donor.
        Matches with no checkpoint record (admitted after the last save)
        or no recovery path are counted lost and unbooked — the soak
        gate requires that count to be zero. Returns
        ``[(match_id, server_id, handle), ...]`` for the recovered."""
        member = self.members[dead_id]
        member.alive = False
        member.server = None
        self.failovers += 1
        self.metrics.count("fleet_failovers")
        by_key = {
            (pl.handle.group, pl.handle.slot): pl
            for pl in self.placements.values()
            if pl.server_id == dead_id
        }
        recovered: List[Tuple[int, int, MatchHandle]] = []
        records: List[Dict] = []
        if member.checkpoint_dir is not None and self._alive():
            from bevy_ggrs_tpu_torch.serve.faults import ServerCheckpointer

            path = ServerCheckpointer(member.checkpoint_dir).latest()
            if path is not None:
                # Tickets decode onto a survivor's template (its device
                # and dtypes).
                host = self._alive()[0].server
                records = load_checkpoint_matches(
                    path, host.state_codec(), host._template
                )
        seen = set()
        for rec in records:
            pl = by_key.get(rec["key"])
            if pl is None:
                continue  # retired since the save
            seen.add(rec["key"])
            survivor = self.place(exclude=(dead_id,))
            with self.tracer.span(
                "fleet_failover",
                match=pl.match_id,
                dead=dead_id,
                to=survivor.server_id,
                kind=rec["kind"],
                frame=rec["frame"],
            ):
                if rec["kind"] == "synctest":
                    if rec["session_state"] is not None:
                        pl.session.load_state_dict(rec["session_state"])
                    handle = survivor.server.resume_match(
                        pl.session, pl.local_inputs, rec["ticket"]
                    )
                else:
                    handle = survivor.server.free_slot_handles()[0]
                    handle = survivor.server.adopt_rejoin(
                        handle, pl.session, pl.local_inputs, pl.donor
                    )
            pl.server_id, pl.handle = survivor.server_id, handle
            if pl.publisher is not None:
                pl.publisher.rehost(
                    runner=_LiveSlotView(survivor.server, handle)
                )
            recovered.append((pl.match_id, survivor.server_id, handle))
            self.matches_recovered += 1
            self.metrics.count("fleet_matches_recovered")
            self.metrics.observe(
                "fleet_failover_restored_frame", rec["frame"]
            )
        for key, pl in by_key.items():
            if key in seen:
                continue
            self.placements.pop(pl.match_id, None)
            self.matches_lost += 1
            self.metrics.count("fleet_matches_lost")
            self.tracer.instant(
                "fleet_match_lost", match=pl.match_id, dead=dead_id
            )
        return recovered
