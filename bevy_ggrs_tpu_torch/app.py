"""App layer: the GGRSPlugin builder and the fixed-timestep stage driver.

Counterpart of ``bevy_ggrs_tpu/app.py``:

- :class:`GGRSPlugin` — fluent builder collecting the update frequency,
  input system, rollback type registrations, rollback schedule and
  device; ``build()`` wires a :class:`GGRSStage` into a
  :class:`RollbackApp`.
- :class:`RollbackApp` — headless app shell: the session, its
  :class:`SessionType`, the stage, and render systems that run outside
  the rollback domain.
- :class:`GGRSStage` — the per-render-frame driver: wall-clock
  accumulation into fixed simulation steps, ×1.1 frame-period stretch
  while ahead of peers, the session's network pumped every render frame,
  each step dispatched on the session flavor, and a reset when the
  session is removed.

The stage runs SyncTest, P2P and spectator sessions. With
``GGRSPlugin.with_speculation(n)`` a P2P step is one
:meth:`~bevy_ggrs_tpu_torch.spec_runner.SpeculativeRollbackRunner.tick`
(the burst, any branch commit and the next n-branch rollout).
``GGRSPlugin.with_mesh`` shards the session's world, ring and rollouts over
a device mesh (``parallel/sharding.py``); every rank then runs the same app
in lockstep.
"""

from __future__ import annotations

import dataclasses
import enum
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.schedule import InputSpec, Schedule
from bevy_ggrs_tpu_torch.session.common import (
    EventKind,
    NotSynchronized,
    PredictionThreshold,
    SessionEvent,
    SessionState,
)
from bevy_ggrs_tpu_torch.session.p2p import P2PSession
from bevy_ggrs_tpu_torch.session.spectator import SpectatorSession
from bevy_ggrs_tpu_torch.session.synctest import SyncTestSession
from bevy_ggrs_tpu_torch.state import DEVICE_ID_BASE, HostWorld, TypeRegistry, WorldState
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

DEFAULT_FPS = 60


class SessionType(enum.Enum):
    """Which session flavor the app runs; SyncTest by default."""

    SYNC_TEST = "sync_test"
    P2P = "p2p"
    SPECTATOR = "spectator"


class RollbackIdProvider:
    """Monotonic rollback-id allocator over the host id space
    ``0 .. DEVICE_ID_BASE-1``."""

    def __init__(self) -> None:
        self._next = 0

    def next_id(self) -> int:
        if self._next >= DEVICE_ID_BASE:
            raise OverflowError(
                "RollbackIdProvider: host id space exhausted "
                f"(0..{DEVICE_ID_BASE - 1}; above is device-minted)"
            )
        out = self._next
        self._next += 1
        return out


# An input system reads a local player's controls for this step:
# (handle, app) -> bits.
InputSystem = Callable[[int, "RollbackApp"], np.ndarray]
# A render system runs once per render frame, outside the rollback domain.
RenderSystem = Callable[["RollbackApp"], None]


class RollbackApp:
    """Headless app shell: session + stage + non-rollback systems."""

    def __init__(self) -> None:
        self.stage: Optional[GGRSStage] = None
        self.session = None
        self.session_type: Optional[SessionType] = None
        self.rollback_id_provider = RollbackIdProvider()
        self._render_systems: List[RenderSystem] = []
        self.events: List[object] = []

    def insert_session(self, session, session_type: SessionType) -> "RollbackApp":
        self.session = session
        self.session_type = session_type
        return self

    def remove_session(self) -> "RollbackApp":
        self.session = None
        self.session_type = None
        return self

    def add_render_system(self, system: RenderSystem) -> "RollbackApp":
        self._render_systems.append(system)
        return self

    def world(self):
        """Host view of the current rollback world (device->host sync)."""
        return self.stage.runner.world()

    @property
    def frame(self) -> int:
        return self.stage.runner.frame

    def update(self, now: Optional[float] = None) -> int:
        """One render frame; returns the simulation steps executed."""
        steps = self.stage.run(self, now)
        for system in self._render_systems:
            system(self)
        return steps

    def run_for(self, render_frames: int, dt: Optional[float] = None) -> None:
        """Drive ``render_frames`` frames. With ``dt`` given, time is
        virtual (deterministic tests); else wall clock."""
        if dt is None:
            for _ in range(render_frames):
                self.update()
        else:
            now = self.stage.last_time if self.stage.last_time is not None else 0.0
            for _ in range(render_frames):
                now += dt
                self.update(now)


class GGRSStage:
    """Fixed-timestep driver executing the session request protocol on the
    device-resident runner."""

    def __init__(
        self,
        schedule: Schedule,
        input_system: InputSystem,
        initial_state: WorldState,
        num_players: int,
        input_spec: InputSpec,
        max_prediction: int,
        update_frequency: int = DEFAULT_FPS,
        clock=None,
        metrics=None,
        speculation: Optional[int] = None,
        speculation_opts: Optional[dict] = None,
        mesh=None,
        entity_axis: str = "entity",
        branch_axis: str = "branch",
    ):
        self.metrics = metrics if metrics is not None else null_metrics
        self.input_system = input_system
        self.update_frequency = int(update_frequency)
        runner_args = dict(max_prediction=max_prediction, num_players=num_players,
                           input_spec=input_spec, metrics=self.metrics,
                           device=initial_state.device, mesh=mesh, entity_axis=entity_axis)
        if speculation:
            from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

            self.runner = SpeculativeRollbackRunner(
                schedule, initial_state, num_branches=speculation, branch_axis=branch_axis,
                **runner_args, **(speculation_opts or {}))
        else:
            self.runner = RollbackRunner(schedule, initial_state, **runner_args)
        self._clock = clock if clock is not None else _time.monotonic
        self.runner.warmup()
        self.accumulator = 0.0
        self.last_time: Optional[float] = None
        self.run_slow = False
        self.steps_total = 0
        self.frames_skipped = 0

    def reset(self) -> None:
        """Clear the driver state when the session disappears."""
        self.accumulator = 0.0
        self.last_time = None
        self.run_slow = False

    def run(self, app: RollbackApp, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        if app.session is None:
            self.reset()
            return 0
        if self.last_time is None:
            self.last_time = now
        delta = max(0.0, now - self.last_time)
        self.last_time = now

        fps_delta = 1.0 / self.update_frequency
        if self.run_slow:
            fps_delta *= 1.1  # catch-up stretch

        # Pump the network every render frame, unconditionally. Deferred
        # checksum reports flush first: the session's send gate runs inside
        # poll, and a frame's corrected re-report must reach the session
        # before it may transmit that frame's checksum.
        if app.session_type in (SessionType.P2P, SessionType.SPECTATOR):
            flush = getattr(self.runner, "flush_reports", None)
            if flush is not None:
                flush(app.session)
            with self.metrics.timer("poll"):
                app.session.poll_remote_clients(now)
            app.events.extend(app.session.events())

        self.accumulator += delta
        steps = 0
        while self.accumulator >= fps_delta:
            self.accumulator -= fps_delta
            if app.session_type == SessionType.SYNC_TEST:
                self._step_synctest(app)
            elif app.session_type == SessionType.P2P:
                self._step_p2p(app)
            elif app.session_type == SessionType.SPECTATOR:
                self._step_spectator(app)
            steps += 1
        self.steps_total += steps
        return steps

    def _step_synctest(self, app: RollbackApp) -> None:
        session: SyncTestSession = app.session
        for handle in session.local_player_handles():
            session.add_local_input(handle, self.input_system(handle, app))
        self.runner.handle_requests(session.advance_frame(), session)

    def _step_p2p(self, app: RollbackApp) -> None:
        session: P2PSession = app.session
        if session.current_state() != SessionState.RUNNING:
            return
        self.run_slow = session.frames_ahead() > 0
        for handle in session.local_player_handles():
            session.add_local_input(handle, self.input_system(handle, app))
        try:
            requests = session.advance_frame()
        except PredictionThreshold:
            self.frames_skipped += 1  # too far past the peers: skip the step
            return
        # The speculative runner runs the whole tick (burst, branch commit,
        # next rollout) in one call; the plain runner runs the burst.
        tick = getattr(self.runner, "tick", None)
        if tick is not None:
            tick(requests, session.confirmed_frame(), session)
        else:
            self.runner.handle_requests(requests, session)

    def _step_spectator(self, app: RollbackApp) -> None:
        session: SpectatorSession = app.session
        if session.current_state() != SessionState.RUNNING:
            return
        try:
            requests = session.advance_frame()
        except (PredictionThreshold, NotSynchronized):
            self.frames_skipped += 1  # waiting for the host's inputs
            return
        self.runner.handle_requests(requests, session)


class GGRSPlugin:
    """Fluent builder of a rollback app."""

    def __init__(self, input_spec: InputSpec = InputSpec()):
        self.input_spec = input_spec
        self.update_frequency = DEFAULT_FPS
        self.registry = TypeRegistry()
        self.schedule = Schedule()
        self.input_system: Optional[InputSystem] = None
        self.capacity = 64
        self.max_prediction = 8
        self.num_players = 2
        self._setup: Optional[Callable[[HostWorld, RollbackApp], None]] = None
        self.clock = None
        self.metrics = None
        self.device = None
        self.mesh = None
        self.entity_axis = "entity"
        self.branch_axis = "branch"
        self.speculation: Optional[int] = None
        self.speculation_opts: Optional[dict] = None

    def with_update_frequency(self, fps: int) -> "GGRSPlugin":
        self.update_frequency = int(fps)
        return self

    def with_input_system(self, system: InputSystem) -> "GGRSPlugin":
        self.input_system = system
        return self

    def register_rollback_component(
        self, name: str, shape=(), dtype: torch.dtype = torch.float32, default=0
    ) -> "GGRSPlugin":
        self.registry.register_component(name, shape, dtype, default)
        return self

    def register_rollback_resource(self, name: str, initial) -> "GGRSPlugin":
        self.registry.register_resource(name, initial)
        return self

    def with_rollback_schedule(self, schedule: Schedule) -> "GGRSPlugin":
        self.schedule = schedule
        return self

    def with_world_capacity(self, capacity: int) -> "GGRSPlugin":
        self.capacity = int(capacity)
        return self

    def with_num_players(self, n: int) -> "GGRSPlugin":
        self.num_players = int(n)
        return self

    def with_max_prediction_window(self, frames: int) -> "GGRSPlugin":
        self.max_prediction = int(frames)
        return self

    def with_setup_system(
        self, setup: Callable[[HostWorld, RollbackApp], None]
    ) -> "GGRSPlugin":
        """The scene-spawn hook: receives the staging world and the app
        (for ``rollback_id_provider``)."""
        self._setup = setup
        return self

    def with_clock(self, clock) -> "GGRSPlugin":
        self.clock = clock
        return self

    def with_metrics(self, metrics) -> "GGRSPlugin":
        """Install a :class:`bevy_ggrs_tpu_torch.utils.metrics.Metrics`
        sink for per-phase timings and rollback histograms."""
        self.metrics = metrics
        return self

    def with_device(self, device) -> "GGRSPlugin":
        """Run the session on ``device`` (default ``cuda``)."""
        self.device = device
        return self

    def with_mesh(self, mesh, entity_axis: str = "entity",
                  branch_axis: str = "branch") -> "GGRSPlugin":
        """Run the session's world, snapshot ring and (with speculation)
        live rollouts sharded over ``mesh`` (a ``DeviceMesh`` from
        :func:`bevy_ggrs_tpu_torch.parallel.sharding.branch_mesh`): the
        entity axis splits on ``entity_axis``, speculative branches on
        ``branch_axis``. A speculating session needs both axes; the runner
        rejects a mesh missing one at construction. Every rank builds and
        runs the same app in lockstep."""
        self.mesh = mesh
        self.entity_axis = entity_axis
        self.branch_axis = branch_axis
        return self

    def with_speculation(self, num_branches: int, branch_values=None, attest: bool = True,
                         predictor=None) -> "GGRSPlugin":
        """Precompute rollback recoveries with a ``num_branches``-wide
        speculative rollout each P2P tick (see
        :mod:`bevy_ggrs_tpu_torch.spec_runner`); values <= 0 disable it.

        ``branch_values`` overrides the candidate input values the branch
        tree enumerates (default: the model's ``InputSpec.values``). With
        ``attest`` (default), warmup checks that the batched rollout and
        the serial burst agree bitwise for this model and disables
        speculation, with a ``SPECULATION_DISABLED`` event in
        ``app.events``, when they do not. ``predictor`` configures the
        learned input predictor seeding the branch tree (see
        :class:`~bevy_ggrs_tpu_torch.spec_runner.SpeculativeRollbackRunner`;
        ``None`` consults ``GGRS_PREDICTOR``). Configure the same weights
        on the session with ``SessionBuilder.with_input_predictor``, which
        folds their hash into the handshake, so peers with other weights
        are refused instead of speculating on other trees."""
        n = int(num_branches)
        self.speculation = n if n > 0 else None
        self.speculation_opts = {"attest": bool(attest)}
        if branch_values is not None:
            self.speculation_opts["branch_values"] = list(branch_values)
        if predictor is not None:
            self.speculation_opts["predictor"] = predictor
        return self

    def build(self, app: Optional[RollbackApp] = None) -> RollbackApp:
        if self.input_system is None:
            raise ValueError("GGRSPlugin: no input system was given")
        app = app if app is not None else RollbackApp()
        host = HostWorld(self.registry, self.capacity)
        if self._setup is not None:
            self._setup(host, app)
        app.stage = GGRSStage(
            schedule=self.schedule,
            input_system=self.input_system,
            initial_state=host.commit(device=self.device),
            num_players=self.num_players,
            input_spec=self.input_spec,
            max_prediction=self.max_prediction,
            update_frequency=self.update_frequency,
            clock=self.clock,
            metrics=self.metrics,
            speculation=self.speculation,
            speculation_opts=self.speculation_opts,
            mesh=self.mesh,
            entity_axis=self.entity_axis,
            branch_axis=self.branch_axis,
        )
        attestation = getattr(app.stage.runner, "attestation", None)
        if attestation is not None and not attestation.ok:
            app.events.append(SessionEvent(EventKind.SPECULATION_DISABLED,
                                           data=dataclasses.asdict(attestation)))
        return app
