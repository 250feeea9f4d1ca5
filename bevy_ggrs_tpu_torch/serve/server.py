"""MatchServer: the host loop that turns batch slots into served matches.

Counterpart of ``bevy_ggrs_tpu/serve/server.py``. One server = one model
family (one schedule, one input spec, one batched tick executor) serving
up to ``capacity`` concurrent matches on one device (``cuda`` unless the
caller passes ``device="cpu"``). The
slots are partitioned into ``stagger_groups`` groups that dispatch at
evenly spaced offsets across the 16.7 ms frame: with G groups only S/G
matches' host work (input collection, branch build, argument assembly)
lands on any one instant, flattening the dispatch burst a single
all-slots tick would concentrate at frame start. All groups share ONE
:class:`~bevy_ggrs_tpu_torch.serve.batch.BatchedTickExecutor`.

Session contract (duck-typed, getattr-guarded — SyncTestSession, P2P and
spectator sessions all fit):

- ``local_player_handles()`` + ``add_local_input(handle, bits)`` — fed
  from the match's ``local_inputs(frame, handle)`` callback each frame;
- ``advance_frame() -> [requests]`` — the canonical request list;
- ``confirmed_frame()`` (optional) — the speculation anchor; absent means
  fully confirmed every frame (synctest);
- ``poll_remote_clients()`` (optional) — pumped before input collection;
- ``report_checksum(frame, checksum)`` / ``wants_checksum(frame)``
  (optional) — fed from the core's deferred checksum reports;
- ``checksum_votes`` + ``drain_control`` (optional) — their presence
  marks a supervisable P2P session: the server wraps it in a
  :class:`~bevy_ggrs_tpu_torch.session.supervisor.SessionSupervisor` whose
  runner is a facade over the live batch slot, so desync ballots and
  donor-side state serving work while the match is batched.

Fault domains (docs/serving.md "Failure domains"): each match carries a
:class:`~bevy_ggrs_tpu_torch.serve.faults.SlotHealthFSM`. A session that raises,
blows its per-tick watchdog budget ``strike_limit`` times, or trips the
batched core's canonical-burst contract is fenced at the group boundary —
its slot drains to a singleton :class:`~bevy_ggrs_tpu_torch.serve.faults.
RecoveryLane` (all lanes share ONE warmed rollout executor, so the
build counters of ``utils.build_cache`` stay unchanged through any amount
of fault churn), the
other S−1 lanes dispatch on time, and the match readmits at its reserved
slot index once the lane reports clean — bitwise-continuous with its
pre-fault trajectory. A ``checkpoint_dir`` arms periodic whole-server
checkpoints (:class:`~bevy_ggrs_tpu_torch.serve.faults.ServerCheckpointer`) for
kill -9 crash-restart.

Observability: every group dispatch runs under a ``serve_tick`` span and
per-slot counters carry a ``match_slot`` label; ``slots_active``,
``slots_free``, ``slots_quarantined``, ``slots_recovering`` and
``last_stagger_jitter_ms`` are live gauges the FlightRecorder's
``capture(server=...)`` columns snapshot, and every fault/readmit emits
``slot_fault``/``slot_recover`` tracer instants.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.serve.batch import BatchedSessionCore, BatchedTickExecutor
from bevy_ggrs_tpu_torch.serve.faults import (
    RecoveryLane,
    ServerCheckpointer,
    SlotFault,
    SlotHealth,
    SlotHealthFSM,
    SlotTicket,
    _SlotRunnerFacade,
    adopt_ticket,
)
from bevy_ggrs_tpu_torch.session.common import PredictionThreshold, SessionState
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame


@dataclasses.dataclass(frozen=True)
class MatchHandle:
    group: int
    slot: int


class _Match:
    __slots__ = ("session", "local_inputs", "fsm", "supervisor", "spec_on")

    def __init__(self, session, local_inputs, fsm, supervisor, spec_on):
        self.session = session
        self.local_inputs = local_inputs
        self.fsm = fsm
        self.supervisor = supervisor
        self.spec_on = spec_on


def _supervisable(session) -> bool:
    """P2P-shaped sessions (desync ballots + control channel) get a
    SessionSupervisor; synctest/spectator sessions do not."""
    return hasattr(session, "checksum_votes") and hasattr(
        session, "drain_control"
    )


class MatchServer:
    def __init__(
        self,
        schedule,
        initial_state,
        max_prediction: int,
        num_players: int,
        input_spec,
        capacity: int = 64,
        stagger_groups: int = 4,
        num_branches: int = 8,
        spec_frames: Optional[int] = None,
        branch_values=None,
        frame_ms: float = 1000.0 / 60.0,
        metrics=None,
        tracer=None,
        clock=time.perf_counter,
        report_checksums: bool = True,
        watchdog_budget_ms: Optional[float] = None,
        watchdog_strike_limit: int = 3,
        recovery_deadline_frames: int = 900,
        lane_error_limit: int = 8,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 120,
        checkpoint_keep: int = 3,
        slo_config=None,
        slo_export_interval: int = 32,
        trace_dir: Optional[str] = None,
        server_id: int = 0,
        fleet_socket=None,
        fleet_addr=None,
        heartbeat_interval: int = 8,
        timeseries=None,
        admit_budget: int = 4,
        admission_slo_ms: Optional[float] = None,
        ledger=None,
        attest_interval: Optional[int] = 64,
        profiler=None,
        device=None,
    ):
        from bevy_ggrs_tpu_torch.obs.ledger import null_ledger
        from bevy_ggrs_tpu_torch.obs.profiler import null_profiler
        from bevy_ggrs_tpu_torch.obs.slo import SlotSLO, WindowSLO
        from bevy_ggrs_tpu_torch.obs.timeseries import null_timeseries
        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics
        from bevy_ggrs_tpu_torch.state import resolve_device
        from bevy_ggrs_tpu_torch.utils.build_cache import install_compile_listeners

        install_compile_listeners()
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        # Sampling host profiler (obs/profiler.py): reads the serving
        # thread's stacks from its own thread — wire-inert by
        # construction. The server does not start/stop it (the soak
        # harness owns the window); it only exports its artifacts.
        self.profiler = profiler if profiler is not None else null_profiler
        self.timeseries = (
            timeseries if timeseries is not None else null_timeseries
        )
        # ONE server-level speculation ledger; each slot group writes
        # through a scoped view so entries carry the server-wide flat
        # slot id (group * per_group + slot — the SLO/metrics key).
        self.ledger = ledger if ledger is not None else null_ledger
        self._ledger_seq = 0  # run_frame's incremental tail() watermark
        self.frame_ms = float(frame_ms)
        self._clock = clock
        # Watchdog: a session's host work (poll + inputs + advance) gets
        # two frame budgets before a miss counts as a strike — generous
        # enough for GC hiccups, tight enough that a hung session is
        # fenced within strike_limit frames.
        self.watchdog_budget_ms = (
            2.0 * self.frame_ms
            if watchdog_budget_ms is None
            else float(watchdog_budget_ms)
        )
        self.watchdog_strike_limit = int(watchdog_strike_limit)
        self.recovery_deadline_frames = int(recovery_deadline_frames)
        self.lane_error_limit = int(lane_error_limit)
        G = max(1, int(stagger_groups))
        per_group = -(-int(capacity) // G)  # ceil: capacity is a floor
        self.capacity = per_group * G
        self._exec = BatchedTickExecutor(
            schedule, per_group, int(max_prediction) + 2, int(num_branches),
            int(spec_frames or max_prediction),
        )
        self.groups: List[BatchedSessionCore] = [
            BatchedSessionCore(
                schedule, initial_state, max_prediction, num_players,
                input_spec, per_group, num_branches=num_branches,
                spec_frames=spec_frames, branch_values=branch_values,
                metrics=self.metrics, tracer=self.tracer,
                executor=self._exec, report_checksums=report_checksums,
                timeseries=self.timeseries,
                ledger=self.ledger.scoped(g * per_group),
                device=self.device,
            )
            for g in range(G)
        ]
        # Lane-runner construction parameters (recovery lanes are built
        # on demand; they all share one warmed rollout executor so the
        # drain -> recover -> readmit cycle prepares nothing).
        from bevy_ggrs_tpu_torch.rollout import RolloutExecutor

        self._schedule = schedule
        self._max_prediction = int(max_prediction)
        self._num_players = int(num_players)
        self._input_spec = input_spec
        self._report_checksums = bool(report_checksums)
        self._template = self.groups[0]._template
        self._recovery_exec = RolloutExecutor(schedule, self._max_prediction + 2)
        self._codec = None
        self._matches: Dict[MatchHandle, _Match] = {}
        self._lanes: Dict[MatchHandle, RecoveryLane] = {}
        self._reserved: Dict[int, set] = {g: set() for g in range(G)}
        self.checkpointer = (
            ServerCheckpointer(
                checkpoint_dir, checkpoint_interval, checkpoint_keep
            )
            if checkpoint_dir is not None
            else None
        )
        self.frames_served = 0
        self.faults_total = 0
        self.readmissions_total = 0
        self.evictions_total = 0
        self.last_recovery_frames: Optional[int] = None
        self.last_stagger_jitter_ms: Optional[float] = None
        # Slot SLO engine (obs/slo.py): per-tick samples reduce to
        # burn-rate levels every slo_export_interval frames, exported
        # through the labeled metrics path and fed to each slot's FSM.
        self._per_group = per_group
        self.slo = SlotSLO(config=slo_config, metrics=self.metrics)
        self.slo_export_interval = max(1, int(slo_export_interval))
        self.slo_levels: Dict[int, str] = {}
        self.trace_dir = trace_dir
        # Admission queue: enqueue_match reserves the slot immediately and
        # returns the handle, but the expensive part of a join (session
        # warm, initial-state build, device admit) drains AFTER every
        # group has dispatched — a slow join costs the joiner latency,
        # never a sibling group its deadline. admit_budget bounds drains
        # per frame so an arrival storm cannot own the inter-frame gap.
        self.admit_budget = max(1, int(admit_budget))
        self._admit_queue: List[tuple] = []
        self._pending_first: Dict[MatchHandle, object] = {}
        self.admissions_completed = 0
        # Slot template pool (filled by warmup): codec-round-tripped
        # (ring, state) pairs a fresh admission reuses instead of
        # re-deriving ring_init(template) per joiner — the migration
        # warmup trick extended to the front door. Entries are immutable
        # device arrays (the admit program copies them into slot rows),
        # so consuming one recycles it and the pool never drains.
        self._slot_templates: List[tuple] = []
        self.templates_admitted = 0
        # Server-scope SLOs over the online time-series windows (the
        # signals the front-door knee detector and the balancer read).
        self.admission_slo_ms = (
            2.0 * self.frame_ms
            if admission_slo_ms is None
            else float(admission_slo_ms)
        )
        objectives = {
            "admission": (
                "admission_ms", self.admission_slo_ms, 0.99,
            ),
            "frame_deadline": ("frame_ms", self.frame_ms, 0.99),
        }
        if self.ledger.enabled:
            # spec_spill is 0.0 for a fully-absorbed rollback and 1.0
            # otherwise (WindowSLO counts samples ABOVE threshold as
            # bad): the objective is 75% of rollbacks fully absorbed.
            objectives["spec_spill"] = ("spec_spill", 0.5, 0.75)
        self.window_slo = WindowSLO(
            self.timeseries,
            objectives,
            config=slo_config,
            metrics=self.metrics,
        )
        self.front_door_levels: Dict[str, str] = {}
        # Fleet membership: with a socket + balancer address configured,
        # the server emits a FleetHeartbeat every heartbeat_interval served
        # frames — the balancer's liveness signal (missed beats past its
        # timeout mean THIS server is dead and its matches fail over).
        self.server_id = int(server_id)
        self.fleet_socket = fleet_socket
        self.fleet_addr = fleet_addr
        self.heartbeat_interval = max(1, int(heartbeat_interval))
        self.heartbeats_sent = 0
        # SDC attestation cadence in served frames (None disables): every
        # interval, one digest launch per group re-verifies all ring
        # rows; mismatches self-heal in place via repair_slot, escalating
        # unrepairable slots to the recovery-lane / checkpoint ladder
        # (docs/serving.md#self-healing). Detection latency <= interval.
        self.attest_interval = (
            None if attest_interval is None else max(1, int(attest_interval))
        )
        self.sdc_repairs_total = 0

    def _flat_slot(self, handle: MatchHandle) -> int:
        """Server-wide slot id (group-qualified) — the SLO/metrics key.
        Distinct from ``handle.slot``, which repeats across groups."""
        return handle.group * self._per_group + handle.slot

    # -- gauges ---------------------------------------------------------

    @property
    def slots_active(self) -> int:
        """Matches currently served: batched slots + recovery lanes."""
        return sum(g.active_count for g in self.groups) + len(self._lanes)

    @property
    def slots_free(self) -> int:
        reserved = sum(len(r) for r in self._reserved.values())
        return (
            self.capacity
            - sum(g.active_count for g in self.groups)
            - reserved
        )

    @property
    def slots_quarantined(self) -> int:
        return sum(
            1
            for m in self._matches.values()
            if m.fsm.state is SlotHealth.QUARANTINED
        )

    @property
    def slots_recovering(self) -> int:
        return sum(
            1
            for m in self._matches.values()
            if m.fsm.state is SlotHealth.RECOVERING
        )

    def cache_size(self) -> int:
        return self._exec.cache_size()

    def heartbeat(self):
        """The liveness + load beacon a :class:`~bevy_ggrs_tpu_torch.fleet.
        FleetBalancer` consumes — also readable in-process for balancers
        colocated with their servers."""
        from bevy_ggrs_tpu_torch.session.protocol import FleetHeartbeat

        spec_hit_permille = spec_waste_permille = 0
        if self.ledger.enabled:
            s = self.ledger.summary()
            spec_hit_permille = int(
                round(1000.0 * s["spec_full_hit_rate"])
            )
            spec_waste_permille = int(
                round(1000.0 * s["spec_waste_ratio"])
            )
        return FleetHeartbeat(
            server_id=self.server_id,
            frames_served=self.frames_served,
            slots_active=self.slots_active,
            slots_free=self.slots_free,
            quarantined=self.slots_quarantined + self.slots_recovering,
            pages=sum(
                1 for lvl in self.slo_levels.values() if lvl == "page"
            ),
            spec_hit_permille=spec_hit_permille,
            spec_waste_permille=spec_waste_permille,
            # Monotonic send counter (1-based on the wire): the balancer
            # refuses to let a beat whose seq it already advanced past
            # refresh liveness, so chaos reorder can't fake freshness.
            beat_seq=self.heartbeats_sent + 1,
        )

    def free_slot_handles(self) -> List[MatchHandle]:
        """Every admittable (group, slot), busiest group with room first
        (pack-first, same policy as :meth:`_pick_slot` — fewest hot
        groups, fewest fixed-cost dispatch programs) — the fleet
        balancer's stagger-aware placement domain. Reserved slots
        (recovering matches) are never offered."""
        order = sorted(
            range(len(self.groups)),
            key=lambda g: (len(self._free_unreserved(g)), g),
        )
        return [
            MatchHandle(g, s)
            for g in order
            for s in self._free_unreserved(g)
        ]

    def health_of(self, handle: MatchHandle) -> SlotHealth:
        return self._matches[handle].fsm.state

    def state_codec(self):
        """The server's StateCodec (relay-tier flat-byte layout), built
        lazily from the world template — checkpoints and parity checks
        share one deterministic encoding."""
        if self._codec is None:
            from bevy_ggrs_tpu_torch.relay.delta import StateCodec
            from bevy_ggrs_tpu_torch.state import to_host

            self._codec = StateCodec(to_host(self._template))
        return self._codec

    # -- lifecycle ------------------------------------------------------

    def warmup(self) -> None:
        """Run the shared batched tick + admit write once (one tick
        through group 0 covers every group — they share the executor) AND
        the shared recovery-lane runner, so the drain -> recover ->
        readmit cycle builds and prepares nothing from here on.

        Also round-trips one template ticket through the checkpoint/
        migration blob codec: landing a migrated-in match is steady state
        for a fleet destination.

        The decoded record seeds the **slot template pool**: fresh
        admissions (``initial_state=None``) reuse its pre-built
        ``(ring_init(state), state)`` pair instead of re-deriving it per
        joiner, so the per-admission device-upload prep amortizes to ~0.
        The codec round-trip is the bitwise witness — the decoded state
        is flat-byte identical to the live template, so a template-
        admitted match is indistinguishable from a cold-admitted one
        (tests/test_native_batch.py pins this)."""
        self.groups[0].warmup()
        lane = self._make_lane_runner()
        lane.warmup()
        from .faults import pack_match_record, unpack_match_record

        codec = self.state_codec()
        rec = unpack_match_record(
            codec,
            pack_match_record(
                codec,
                {
                    "handle": None,
                    "kind": "synctest",
                    "frame": 0,
                    "state": lane.state,
                    "ring": lane.ring,
                    "input_log": {},
                    "spec_on": True,
                    "session_state": None,
                },
            ),
            self._template,
        )
        from bevy_ggrs_tpu_torch.state import ring_init

        tpl_state = rec["ticket"].state
        tpl_ring = ring_init(tpl_state, self.groups[0].ring_depth)
        # One entry per drain slot per group: every admission a single
        # frame can complete finds a template waiting. All entries share
        # the same tensors, which admission only reads (it copies them
        # into slot rows) — the pool is bookkeeping, not copies.
        self._slot_templates = [
            (tpl_ring, tpl_state)
            for _ in range(self.admit_budget * len(self.groups))
        ]

    def _make_lane_runner(self):
        from bevy_ggrs_tpu_torch.runner import RollbackRunner

        runner = RollbackRunner(
            self._schedule, self._template, self._max_prediction,
            self._num_players, self._input_spec,
            report_checksums=self._report_checksums,
            metrics=self.metrics, tracer=self.tracer, device=self.device,
        )
        runner.executor = self._recovery_exec
        runner._input_log = {}
        return runner

    def _free_unreserved(self, group: int) -> List[int]:
        reserved = self._reserved[group]
        return [
            i
            for i in self.groups[group].free_slots()
            if i not in reserved
        ]

    def _register(
        self,
        handle: MatchHandle,
        session,
        local_inputs,
        spec_on: bool,
        initial: SlotHealth = SlotHealth.HEALTHY,
        supervisor=None,
    ) -> _Match:
        fsm = SlotHealthFSM(
            handle.slot,
            metrics=self.metrics,
            tracer=self.tracer,
            strike_limit=self.watchdog_strike_limit,
            initial=initial,
        )
        if supervisor is None and _supervisable(session):
            from bevy_ggrs_tpu_torch.session.supervisor import SessionSupervisor

            supervisor = SessionSupervisor(
                session,
                _SlotRunnerFacade(self.groups[handle.group], handle.slot),
                metrics=self.metrics,
                tracer=self.tracer,
                clock=self._clock,
            )
        m = _Match(session, local_inputs, fsm, supervisor, bool(spec_on))
        self._matches[handle] = m
        return m

    def _pick_slot(self) -> MatchHandle:
        # Pack-first: the busiest group that still has room. A group's
        # batched tick costs the same at one live slot as at
        # full occupancy, so the number of HOT groups — not the number
        # of live matches — sets the per-frame device bill; packing
        # keeps it minimal at partial occupancy. The least-loaded
        # spread this replaces existed to balance the per-slot Python
        # host loop across groups, and the batched native plane made
        # that cost flat in occupancy.
        candidates = [
            g for g in range(len(self.groups))
            if self._free_unreserved(g)
        ]
        if not candidates:
            raise RuntimeError("server at capacity")
        group = min(
            candidates,
            key=lambda g: (len(self._free_unreserved(g)), g),
        )
        return MatchHandle(group, self._free_unreserved(group)[0])

    def add_match(
        self,
        session,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        initial_state=None,
        spec_on: bool = True,
        trace=None,
    ) -> MatchHandle:
        """Admit a match synchronously: its session + a ``local_inputs
        (frame, handle) -> bits`` callback feeding the session's local
        handles each frame. Slots balance across stagger groups
        (least-loaded first); slots reserved for recovering matches are
        never handed out. ``trace`` (an :class:`~bevy_ggrs_tpu_torch.serve.
        admission.AdmissionTrace`) gets the slot_warm/admit stages and
        first-frame completion recorded against it."""
        handle = self._pick_slot()
        self._admit_at(
            handle, session, local_inputs, initial_state, spec_on, trace
        )
        return handle

    def enqueue_match(
        self,
        session,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        initial_state=None,
        spec_on: bool = True,
        trace=None,
    ) -> MatchHandle:
        """Admit a match OFF the frame-critical path: the slot is
        reserved and the handle returned now, but session warm +
        initial-state build + device admit run at the end of a
        :meth:`run_frame` (after every group dispatched), bounded by
        ``admit_budget`` per frame. ``initial_state`` may be a zero-arg
        callable — the lazy-build hook that keeps an expensive world
        construction off sibling groups' deadlines."""
        handle = self._pick_slot()
        self._reserved[handle.group].add(handle.slot)
        if trace is not None:
            trace.begin("first_frame")
        self._admit_queue.append(
            (handle, session, local_inputs, initial_state, spec_on, trace)
        )
        self.metrics.count("admissions_queued")
        return handle

    def _admit_at(
        self, handle, session, local_inputs, initial_state, spec_on, trace
    ) -> None:
        """The expensive half of admission, shared by the synchronous
        path and the queue drain: build the slot's initial state
        (resolving a lazy callable), device-admit, register the match."""
        core = self.groups[handle.group]
        if trace is not None:
            trace.begin("slot_warm")
        if callable(initial_state):
            initial_state = initial_state()
        template = None
        if initial_state is None and self._slot_templates:
            # Pre-warmed path: pop a codec-round-tripped template and
            # recycle it (admit copies it, never writes it), so slot_warm
            # is a pool pop instead of a
            # per-joiner ring build.
            template = self._slot_templates.pop()
            self._slot_templates.append(template)
            self.templates_admitted += 1
            self.metrics.count("template_admissions")
        m = None
        try:
            if trace is not None:
                trace.end("slot_warm")
                trace.begin("admit")
            core.admit(
                initial_state=initial_state,
                slot=handle.slot,
                spec_on=spec_on,
                template=template,
            )
            m = self._register(handle, session, local_inputs, spec_on)
        finally:
            if trace is not None and trace.is_open("admit"):
                trace.end("admit")
            if m is not None:
                # Pending even without a trace: admissions_completed and
                # the admission_ms series count EVERY admission.
                self._pending_first[handle] = trace
                if trace is not None and not trace.is_open("first_frame"):
                    trace.begin("first_frame")

    def retire_match(self, handle: MatchHandle) -> None:
        # A match retired while still in the admit queue (an abandon that
        # beat its own admission) just releases its reservation.
        for i, pending in enumerate(self._admit_queue):
            if pending[0] == handle:
                del self._admit_queue[i]
                self._reserved[handle.group].discard(handle.slot)
                trace = pending[5]
                if trace is not None:
                    trace.finish()
                return
        lane = self._lanes.pop(handle, None)
        if lane is not None:
            self._reserved[handle.group].discard(handle.slot)
        else:
            self.groups[handle.group].retire(handle.slot)
        self._matches.pop(handle, None)
        self._pending_first.pop(handle, None)
        self._vacate_slo(handle)

    def suspend_match(self, handle: MatchHandle) -> SlotTicket:
        """Voluntary drain: extract the match's full trajectory state as a
        :class:`SlotTicket` and free its slot. The SAME match (same
        session, same frame counters) can later :meth:`resume_match` —
        possibly into a different slot or a different server — and
        continue bitwise. Not valid while the match is on a recovery
        lane."""
        if handle in self._lanes:
            raise RuntimeError(
                f"match {handle} is on a recovery lane; wait for "
                "readmission or retire it"
            )
        ticket = self.groups[handle.group].extract(handle.slot)
        self._matches.pop(handle, None)
        self._vacate_slo(handle)
        return ticket

    def _vacate_slo(self, handle: MatchHandle) -> None:
        """Slot SLO history is per-tenancy: a vacated slot's frozen
        window must not keep the server paging (or damn its next
        tenant), so drop it with the match."""
        flat = self._flat_slot(handle)
        self.slo.forget(flat)
        self.slo_levels.pop(flat, None)

    def resume_match(
        self,
        session,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        ticket: Optional[SlotTicket] = None,
        handle=None,
    ) -> MatchHandle:
        """Readmit a suspended (or checkpoint-restored) match from its
        ticket, mid-trajectory. ``handle`` pins the exact (group, slot) —
        crash-restart re-seeds every match where it lived, keeping
        user-held handles valid."""
        if ticket is None:
            raise ValueError("resume_match requires a ticket")
        if handle is not None:
            handle = MatchHandle(*handle) if isinstance(handle, tuple) else handle
            if handle.slot in self._reserved[handle.group]:
                raise RuntimeError(f"slot {handle} is reserved")
            group, slot = handle.group, handle.slot
        else:
            group = max(
                range(len(self.groups)),
                key=lambda g: (len(self._free_unreserved(g)), -g),
            )
            free = self._free_unreserved(group)
            if not free:
                raise RuntimeError("server at capacity")
            slot = free[0]
        core = self.groups[group]
        slot = core.admit(slot=slot, ticket=ticket)
        handle = MatchHandle(group, slot)
        self._register(handle, session, local_inputs, ticket.spec_on)
        return handle

    def adopt_rejoin(
        self,
        handle,
        session,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        donor=None,
    ) -> MatchHandle:
        """Crash-restart path for a P2P match: reserve its slot and start
        a RECOVERING lane whose supervisor adopts a full checkpoint from
        ``donor`` (the surviving peer) via :meth:`~bevy_ggrs_tpu_torch.session.
        supervisor.SessionSupervisor.begin_rejoin`. The match readmits at
        the reserved slot once caught up and out of its frozen-input
        window."""
        from bevy_ggrs_tpu_torch.session.supervisor import SessionSupervisor

        handle = MatchHandle(*handle) if isinstance(handle, tuple) else handle
        if self.groups[handle.group].slots[handle.slot].active:
            raise RuntimeError(f"slot {handle} is occupied")
        runner = self._make_lane_runner()
        supervisor = SessionSupervisor(
            session, runner, metrics=self.metrics, tracer=self.tracer,
            clock=self._clock,
        )
        if donor is not None:
            supervisor.begin_rejoin(donor)
        m = self._register(
            handle, session, local_inputs, True,
            initial=SlotHealth.RECOVERING, supervisor=supervisor,
        )
        self._reserved[handle.group].add(handle.slot)
        self._lanes[handle] = RecoveryLane(
            handle, session, runner, supervisor=supervisor,
            local_inputs=local_inputs, fault_frame=None,
        )
        return handle

    def _finish_admission(self, handle: MatchHandle, trace) -> None:
        """The arrival's terminal stage: its slot just rode a successful
        group dispatch. Closes the trace and feeds the admission series
        the window SLO + knee detector read. ``trace`` may be None
        (untraced admissions still count)."""
        self.admissions_completed += 1
        self.metrics.count("admissions_completed")
        if trace is None:
            return
        if trace.is_open("first_frame"):
            trace.end("first_frame")
        trace.finish(server_id=self.server_id, handle=handle)
        total = trace.total_ms
        self.metrics.observe("admission_ms", total)
        self.timeseries.observe("admission_ms", total)
        for stage, ms in trace.durations.items():
            self.timeseries.observe(f"admission_{stage}_ms", ms)

    # -- fault containment ----------------------------------------------

    def _fault(
        self,
        handle: MatchHandle,
        m: _Match,
        reason: str,
        cause: Optional[BaseException] = None,
        pending: Optional[Tuple[List[object], object]] = None,
    ) -> None:
        """Fence a sick match off the batch: quarantine its FSM, extract
        its slot into a ticket (reserving the slot index for readmission),
        and stand up a recovery lane seeded from it. The ``pending``
        request list the faulting tick dropped replays on the lane's
        singleton runner first — the escape hatch for request shapes the
        batch can't express (RestoreGameState, non-canonical bursts)."""
        core = self.groups[handle.group]
        frame = core.slots[handle.slot].frame
        m.fsm.to(SlotHealth.QUARANTINED, reason=reason, frame=frame)
        self.faults_total += 1
        self.metrics.count("slot_faults")
        self.metrics.count(
            "slot_faults",
            labels={"match_slot": handle.slot, "reason": reason},
        )
        self.tracer.instant(
            "slot_fault",
            group=handle.group,
            slot=handle.slot,
            reason=reason,
            frame=frame,
            cause=repr(cause) if cause is not None else "",
        )
        ticket = core.extract(handle.slot)
        self._reserved[handle.group].add(handle.slot)
        runner = self._make_lane_runner()
        adopt_ticket(runner, ticket)
        if m.supervisor is not None:
            m.supervisor.retarget(runner)
        self._lanes[handle] = RecoveryLane(
            handle, m.session, runner, supervisor=m.supervisor,
            local_inputs=m.local_inputs, pending=pending, fault_frame=frame,
        )

    def _readmit(self, handle: MatchHandle, lane: RecoveryLane) -> None:
        m = self._matches[handle]
        core = self.groups[handle.group]
        ticket = lane.ticket(spec_on=m.spec_on)
        core.admit(slot=handle.slot, ticket=ticket)
        self._reserved[handle.group].discard(handle.slot)
        del self._lanes[handle]
        if m.supervisor is not None:
            m.supervisor.retarget(_SlotRunnerFacade(core, handle.slot))
        m.fsm.to(SlotHealth.HEALTHY)
        self.readmissions_total += 1
        self.metrics.count("slot_readmissions")
        recovery = (
            None
            if lane.fault_frame is None
            else ticket.frame - lane.fault_frame
        )
        if recovery is not None:
            self.last_recovery_frames = recovery
            self.metrics.observe("slot_recovery_frames", recovery)
        self.tracer.instant(
            "slot_recover",
            group=handle.group,
            slot=handle.slot,
            frame=ticket.frame,
            recovery_frames=-1 if recovery is None else recovery,
        )

    def _evict(self, handle: MatchHandle, lane: RecoveryLane) -> None:
        m = self._matches[handle]
        m.fsm.to(SlotHealth.EVICTED, reason="recovery_deadline")
        del self._lanes[handle]
        self._reserved[handle.group].discard(handle.slot)
        self._matches.pop(handle, None)
        self._vacate_slo(handle)
        self.evictions_total += 1
        self.metrics.count("slot_evictions")
        self.metrics.count(
            "slot_evictions", labels={"match_slot": handle.slot}
        )
        self.tracer.instant(
            "slot_evict",
            group=handle.group,
            slot=handle.slot,
            errors=lane.errors,
            last_error=repr(lane.last_error),
        )

    # -- SDC attestation (bevy_ggrs_tpu_torch.integrity) ----------------------

    def _attest_sweep(self) -> None:
        """One silent-corruption sweep over every group and recovery lane:
        recompute all ring-row digests (one checksum launch per group),
        self-heal mismatched slots in place via ``repair_slot`` (one
        batched tick each, siblings untouched), and escalate
        anything unrepairable down the ladder — batched slot -> recovery
        lane (``_fault(reason="sdc")``), lane -> the eviction/checkpoint
        rung. A repair that lands bitwise keeps the match on the batch:
        quarantine-free."""
        from bevy_ggrs_tpu_torch.integrity import StateFault

        for g, core in enumerate(self.groups):
            with self.tracer.span("attest", group=g):
                detected = core.attest()
            for slot, bad in detected.items():
                handle = MatchHandle(g, slot)
                m = self._matches.get(handle)
                if m is None or handle in self._lanes:
                    continue
                try:
                    rep = core.repair_slot(slot, bad)
                except StateFault as e:
                    self._fault(handle, m, "sdc", cause=e)
                    continue
                self.sdc_repairs_total += 1
                self.tracer.instant(
                    "sdc_repair", group=g, slot=slot,
                    frames=rep["repair_frames"], bitwise=rep["bitwise"],
                    field=rep["first_corrupt_field"] or "",
                )
                if not rep["bitwise"]:
                    # Dispatched but did not land bitwise: the slot's
                    # timeline can no longer be trusted on the batch.
                    self._fault(handle, m, "sdc_nonbitwise")
        for handle, lane in list(self._lanes.items()):
            runner = lane.runner
            attest = getattr(runner, "attest_and_repair", None)
            if attest is None:
                continue
            try:
                with self.tracer.span(
                    "attest", group=handle.group, slot=handle.slot
                ):
                    attest()
            except StateFault as e:
                # Lane state unrepairable locally: strike the lane's error
                # ladder — persistent corruption rides it to eviction, and
                # the fleet checkpoint rung re-seats the match.
                lane.errors += 1
                lane.last_error = e
            for rec in runner.state_faults:
                self.tracer.instant(
                    "sdc_fault", group=handle.group, slot=handle.slot,
                    repaired=bool(rec.get("repaired")),
                    bitwise=bool(rec.get("bitwise")),
                    field=rec.get("field") or "",
                )
            runner.state_faults.clear()

    # -- crash-restart checkpoints --------------------------------------

    def snapshot_matches(self) -> List[Dict]:
        """Uniform per-match state records for the checkpointer: batched
        slots read their device rows, recovering matches read their lane
        runner — both carry frame, world state, full ring, and the as-used
        input-log tail."""
        out: List[Dict] = []
        for handle, m in self._matches.items():
            lane = self._lanes.get(handle)
            if lane is not None:
                r = lane.runner
                state, ring, frame = r.state, r.ring, int(r.frame)
                log = dict(r._input_log or {})
            else:
                core = self.groups[handle.group]
                s = core.slots[handle.slot]
                state = core.slot_state(handle.slot)
                ring = core.slot_ring(handle.slot)
                frame, log = int(s.frame), dict(s.input_log)
            session_state = None
            kind = "p2p"
            if m.supervisor is None:
                sd = getattr(m.session, "state_dict", None)
                if sd is not None:
                    session_state = sd()
                    kind = "synctest"
            out.append(
                {
                    "handle": handle,
                    "kind": kind,
                    "frame": frame,
                    "state": state,
                    "ring": ring,
                    "input_log": log,
                    "spec_on": m.spec_on,
                    "session_state": session_state,
                }
            )
        return out

    # -- the frame loop -------------------------------------------------

    def run_frame(self) -> None:
        """Serve one 60 Hz frame: each stagger group collects its matches'
        inputs, advances their sessions, and dispatches one batched tick —
        at its offset within the frame. The loop itself never sleeps (the
        caller owns pacing, as everywhere in this codebase); the jitter
        gauge records how far each group's dispatch drifted from its ideal
        offset given the work that preceded it.

        Fault containment: any match whose host work raises or blows the
        watchdog budget is fenced BEFORE the group dispatch; a
        :class:`SlotFault` from the dispatch itself (pre-mutation, so
        sibling slots are untouched) drops that slot and re-ticks the
        rest. Recovery lanes step after the groups, readmitting or
        evicting as they resolve."""
        t_wall = time.perf_counter()
        # Fast-path admission drain, TOP of frame: a pre-warmed joiner
        # (initial_state None with a slot template pooled) costs ~a
        # template pop + one small device-admit program, so it drains
        # BEFORE the group loop and rides THIS frame's dispatch —
        # first_frame loses a whole serve-frame of queue wait. Strictly
        # FIFO: the scan stops at the first admission that needs a real
        # state build, so nothing ever overtakes a slow joiner. Those
        # slow/lazy builds keep the after-dispatch drain below (a slow
        # join costs the joiner latency, never a sibling group its
        # deadline). One admit_budget bounds both drains per frame.
        admit_budget_left = self.admit_budget
        while (
            admit_budget_left > 0
            and self._admit_queue
            and self._admit_queue[0][3] is None
            and self._slot_templates
        ):
            handle, session, local_inputs, initial_state, spec_on, trace = (
                self._admit_queue.pop(0)
            )
            self._reserved[handle.group].discard(handle.slot)
            admit_budget_left -= 1
            with self.tracer.span(
                "admit_fast", group=handle.group, slot=handle.slot
            ):
                self._admit_at(
                    handle, session, local_inputs, initial_state, spec_on,
                    trace,
                )
        t0 = self._clock()
        worst_jitter = 0.0
        by_group: Dict[int, Dict[int, Tuple[MatchHandle, _Match]]] = {}
        for handle, m in self._matches.items():
            if handle in self._lanes:
                continue  # draining/recovering: not on the batch path
            by_group.setdefault(handle.group, {})[handle.slot] = (handle, m)
        for g, core in enumerate(self.groups):
            matches = by_group.get(g)
            if not matches:
                continue
            # Deliver last tick's deferred checksum reports BEFORE any
            # session polls: a rollback's corrected re-report must land
            # before the session can send that frame's checksum to peers,
            # or a settled-but-stale value leaks out as a false desync.
            core.flush_reports()
            ideal_off = g * self.frame_ms / len(self.groups)
            actual_off = (self._clock() - t0) * 1000.0
            jitter = actual_off - ideal_off
            worst_jitter = max(worst_jitter, abs(jitter))
            self.metrics.observe("stagger_jitter", jitter)
            with self.tracer.span(
                "serve_tick", group=g, matches=len(matches)
            ), self.metrics.timer("serve_tick"):
                work = {}
                for slot, (handle, m) in matches.items():
                    session = m.session
                    t_m = self._clock()
                    try:
                        sup = m.supervisor
                        if sup is not None:
                            sup.tick(t_m)
                            if not sup.should_advance():
                                # Lost a desync ballot (or mid-rejoin):
                                # the state transfer needs a real runner.
                                self._fault(
                                    handle, m, "supervisor_quarantine"
                                )
                                continue
                        poll = getattr(session, "poll_remote_clients", None)
                        if poll is not None:
                            poll()
                        cur = getattr(session, "current_state", None)
                        if (
                            cur is not None
                            and cur() != SessionState.RUNNING
                        ):
                            continue  # still synchronizing: no work yet
                        frame = core.slots[slot].frame
                        if m.local_inputs is not None:
                            for h in session.local_player_handles():
                                bits = m.local_inputs(frame, h)
                                if sup is not None:
                                    bits = sup.input_for(h, bits)
                                session.add_local_input(h, bits)
                        requests = session.advance_frame()
                        conf = getattr(session, "confirmed_frame", None)
                        confirmed = conf() if conf is not None else None
                    except PredictionThreshold:
                        continue  # backpressure, not a fault: no-op frame
                    except SlotFault as f:
                        self._fault(handle, m, f.reason, cause=f)
                        continue
                    except Exception as e:
                        self._fault(handle, m, "session_error", cause=e)
                        continue
                    elapsed_ms = (self._clock() - t_m) * 1000.0
                    # SLO sample: deadline hit + rollback depth (every
                    # AdvanceFrame past the first in a canonical burst is
                    # a resimulated frame).
                    depth = max(
                        0,
                        sum(
                            1 for r in requests
                            if isinstance(r, AdvanceFrame)
                        ) - 1,
                    )
                    self.slo.observe_tick(
                        self._flat_slot(handle),
                        deadline_ok=elapsed_ms <= self.watchdog_budget_ms,
                        rollback_depth=depth,
                    )
                    if elapsed_ms > self.watchdog_budget_ms:
                        if m.fsm.strike(frame):
                            # Deadline expiry: the requests are already in
                            # hand — they ride to the lane so session and
                            # runner frame counters stay converged.
                            self._fault(
                                handle, m, "watchdog_timeout",
                                pending=(requests, session),
                            )
                            continue
                    else:
                        m.fsm.clear()
                    work[slot] = (requests, confirmed, session)
                while work:
                    try:
                        core.tick(work)
                        break
                    except SlotFault as f:
                        requests, _conf, session = work.pop(f.slot)
                        handle = MatchHandle(g, f.slot)
                        self._fault(
                            handle, self._matches[handle], f.reason,
                            cause=f, pending=(requests, session),
                        )
                # Any slot that just rode its first successful dispatch
                # completes its admission trace: first_frame_served.
                if work and self._pending_first:
                    for slot in work:
                        h = MatchHandle(g, slot)
                        if h in self._pending_first:
                            self._finish_admission(
                                h, self._pending_first.pop(h)
                            )
        # Slow-path admission drain: immediately AFTER every group issued
        # its dispatch — the tick programs are still in flight on device
        # (dispatch is async), so a joiner's session warm + state build
        # + device-admit enqueue overlaps dispatch N instead of
        # serializing behind the attest/lane sweeps (which block on
        # device results). A slow join still costs the joiner latency,
        # never a sibling group its deadline. Shares the frame's
        # admit_budget with the fast-path drain at the top of the frame.
        # Freshly admitted slots are attest-safe before their first
        # dispatch: their ring frames are all -1 and attest_ring masks
        # unoccupied rows.
        for _ in range(min(admit_budget_left, len(self._admit_queue))):
            handle, session, local_inputs, initial_state, spec_on, trace = (
                self._admit_queue.pop(0)
            )
            self._reserved[handle.group].discard(handle.slot)
            with self.tracer.span(
                "admit_drain", group=handle.group, slot=handle.slot
            ):
                self._admit_at(
                    handle, session, local_inputs, initial_state, spec_on,
                    trace,
                )
        # Periodic SDC attestation sweep, off the hot path like the lanes:
        # detection within attest_interval frames, self-healing in place.
        if (
            self.attest_interval is not None
            and self.frames_served % self.attest_interval == 0
        ):
            self._attest_sweep()
        # Recovery lanes: off the hot path, after every group dispatched.
        now = self._clock()
        # Group head frames — a lane's recovery debt is how far it trails
        # the most-advanced batched slot of its group.
        heads: Dict[int, int] = {}
        for g, core in enumerate(self.groups):
            frames = [
                s.frame for s in core.slots if getattr(s, "active", False)
            ]
            if frames:
                heads[g] = max(frames)
        for handle, lane in list(self._lanes.items()):
            m = self._matches.get(handle)
            if m is None:
                continue
            with self.tracer.span(
                "lane_step", group=handle.group, slot=handle.slot
            ):
                lane.step(now)
            if m.fsm.state is SlotHealth.QUARANTINED and lane.advancing:
                m.fsm.to(SlotHealth.RECOVERING)
            debt = max(
                0,
                heads.get(handle.group, int(lane.runner.frame))
                - int(lane.runner.frame),
            )
            self.slo.observe_tick(
                self._flat_slot(handle),
                deadline_ok=True,  # lanes are off the deadline path
                recovery_debt=debt,
                quarantined=m.fsm.state is SlotHealth.QUARANTINED,
            )
            if lane.ready and m.fsm.state is SlotHealth.RECOVERING:
                self._readmit(handle, lane)
            elif (
                lane.frames_stepped > self.recovery_deadline_frames
                or lane.errors > self.lane_error_limit
            ):
                self._evict(handle, lane)
        self.last_stagger_jitter_ms = worst_jitter
        self.frames_served += 1
        self.metrics.count("frames_served")
        if self.timeseries.enabled:
            # perf_counter, not self._clock: frame cost is real host work
            # even when the serving loop runs on a virtual clock.
            self.timeseries.observe(
                "frame_ms", (time.perf_counter() - t_wall) * 1000.0
            )
            self.timeseries.observe("stagger_jitter_ms", worst_jitter)
            self.timeseries.observe("slots_active", self.slots_active)
            self.timeseries.observe(
                "admit_queue_depth", len(self._admit_queue)
            )
            if self.ledger.enabled:
                # Incremental ledger drain into the live windows: one
                # spec_spill sample per rollback (0 = fully absorbed —
                # the WindowSLO objective), per-player blame streams,
                # and the hit-rank distribution.
                for e in self.ledger.tail(self._ledger_seq):
                    self._ledger_seq = e["seq"] + 1
                    self.timeseries.observe(
                        "spec_spill",
                        0.0 if e["outcome"] == "full" else 1.0,
                    )
                    if e.get("rank") is not None:
                        self.timeseries.observe(
                            "spec_hit_rank", float(e["rank"])
                        )
                    bp = e.get("blame_player")
                    if bp is not None:
                        self.timeseries.observe(f"spec_blame_p{bp}", 1.0)
                disp = self.ledger.spec_frames_dispatched
                if disp:
                    self.timeseries.observe(
                        "spec_waste_ratio",
                        max(
                            0.0,
                            1.0
                            - self.ledger.frames_recovered_total / disp,
                        ),
                    )
        if self.frames_served % self.slo_export_interval == 0:
            self.slo_levels = self.slo.export()
            for handle, m in self._matches.items():
                lvl = self.slo_levels.get(self._flat_slot(handle))
                if lvl is not None:
                    m.fsm.slo_signal(lvl, frame=self.frames_served)
            if self.timeseries.enabled:
                self.front_door_levels = self.window_slo.export()
        if (
            self.fleet_socket is not None
            and self.fleet_addr is not None
            and self.frames_served % self.heartbeat_interval == 0
        ):
            from bevy_ggrs_tpu_torch.session import protocol as _proto

            self.fleet_socket.send_to(
                _proto.encode(self.heartbeat()), self.fleet_addr
            )
            self.heartbeats_sent += 1
            self.metrics.count("fleet_heartbeats_sent")
        if self.checkpointer is not None:
            self.checkpointer.maybe_save(self)

    # -- telemetry export -----------------------------------------------

    def export_telemetry(
        self, directory: Optional[str] = None, prefix: str = "server"
    ) -> Optional[Dict[str, str]]:
        """Dump the server's telemetry set under ``directory`` (default:
        the ``trace_dir`` it was built with): Perfetto trace (when the
        tracer is enabled), Prometheus exposition, SLO snapshot JSON, and
        the self-contained HTML ops report. Returns {artifact: path}, or
        None when no directory is configured."""
        import json as _json
        import os as _os

        from bevy_ggrs_tpu_torch.obs.prom import export_prometheus
        from bevy_ggrs_tpu_torch.obs.report import build_report

        directory = directory if directory is not None else self.trace_dir
        if directory is None:
            return None
        _os.makedirs(directory, exist_ok=True)
        out: Dict[str, str] = {}
        if getattr(self.tracer, "enabled", False):
            p = _os.path.join(directory, f"{prefix}_trace.json")
            self.tracer.export_perfetto(p)
            out["trace"] = p
        if getattr(self.profiler, "enabled", False):
            p = _os.path.join(directory, f"{prefix}_profile.folded")
            self.profiler.export_folded(p)
            out["profile_folded"] = p
            p = _os.path.join(directory, f"{prefix}_profile_counters.json")
            self.profiler.export_perfetto(p)
            out["profile_counters"] = p
            p = _os.path.join(directory, f"{prefix}_profile.json")
            self.profiler.export_report_json(p)
            out["profile"] = p
        p = _os.path.join(directory, f"{prefix}_metrics.prom")
        export_prometheus(
            self.metrics,
            path=p,
            timeseries=(
                self.timeseries if self.timeseries.enabled else None
            ),
            ledger=self.ledger if self.ledger.enabled else None,
        )
        out["metrics"] = p
        if self.ledger.enabled:
            p = _os.path.join(directory, f"{prefix}_spec_ledger.jsonl")
            self.ledger.export_jsonl(p)
            out["spec_ledger"] = p
        p = _os.path.join(directory, f"{prefix}_slo.json")
        with open(p, "w") as f:
            _json.dump(self.slo.snapshot(), f, indent=2)
        out["slo"] = p
        if self.timeseries.enabled:
            p = _os.path.join(directory, f"{prefix}_front_door_slo.json")
            with open(p, "w") as f:
                _json.dump(self.window_slo.snapshot(), f, indent=2)
            out["front_door_slo"] = p
        p = _os.path.join(directory, f"{prefix}_report.html")
        build_report(
            p,
            title=f"{prefix} ops report",
            slo=self.slo,
            tracers={prefix: self.tracer},
            metrics=self.metrics,
            timeseries=(
                self.timeseries if self.timeseries.enabled else None
            ),
            ledger=self.ledger if self.ledger.enabled else None,
            profile=(
                self.profiler
                if getattr(self.profiler, "enabled", False) else None
            ),
            notes=(
                f"frames_served={self.frames_served} "
                f"faults={self.faults_total} "
                f"readmissions={self.readmissions_total} "
                f"evictions={self.evictions_total}"
            ),
        )
        out["report"] = p
        return out
