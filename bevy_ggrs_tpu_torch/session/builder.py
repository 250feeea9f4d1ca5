"""SessionBuilder + PlayerType: the ggrs session-construction surface.

Counterpart of ``bevy_ggrs_tpu/session/builder.py``. The builder is host
code: the sessions it starts hold no tensors, and the runners they feed
choose the device.

Mirrors the builder the reference consumes (`SessionBuilder::{new,
with_num_players, with_max_prediction_window, with_input_delay,
with_check_distance, add_player}` + ``start_*_session`` — usage at
`bevy_ggrs/examples/box_game/box_game_p2p.rs:34-58`,
`box_game_synctest.rs:27-38`, `box_game_spectator.rs:34-37`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.schedule import InputSpec
from bevy_ggrs_tpu_torch.session.common import InvalidRequest
from bevy_ggrs_tpu_torch.session.p2p import P2PSession
from bevy_ggrs_tpu_torch.session.spectator import SpectatorSession
from bevy_ggrs_tpu_torch.session.synctest import SyncTestSession


class PlayerKind(enum.Enum):
    LOCAL = "local"
    REMOTE = "remote"
    SPECTATOR = "spectator"


@dataclasses.dataclass(frozen=True)
class PlayerType:
    """``PlayerType::{Local, Remote(addr), Spectator(addr)}`` analog
    (consumed at `box_game_p2p.rs:43-53`)."""

    kind: PlayerKind
    addr: object = None

    @staticmethod
    def local() -> "PlayerType":
        return PlayerType(PlayerKind.LOCAL)

    @staticmethod
    def remote(addr) -> "PlayerType":
        return PlayerType(PlayerKind.REMOTE, addr)

    @staticmethod
    def spectator(addr) -> "PlayerType":
        return PlayerType(PlayerKind.SPECTATOR, addr)


class SessionBuilder:
    def __init__(self, input_spec: InputSpec = InputSpec()):
        self.input_spec = input_spec
        self.num_players = 2
        self.max_prediction = 8
        self.input_delay = 0
        self.check_distance = 2
        self.fps = 60
        self.disconnect_timeout = 2.0
        self.disconnect_notify_start = 0.5
        self.catchup_threshold = 8
        self.max_frames_behind = 4
        self.seed = 0
        self.desync_detection = "auto"
        self.interaction_mode: Optional[str] = None
        # The learned input predictor: its weights' hash is the digest the
        # handshake advertises and enforces (see with_input_predictor).
        self.input_predictor = None
        self._players: Dict[int, PlayerType] = {}
        self._spectators: List[object] = []

    # Fluent configuration ------------------------------------------------

    def with_num_players(self, n: int) -> "SessionBuilder":
        self.num_players = int(n)
        return self

    def with_max_prediction_window(self, frames: int) -> "SessionBuilder":
        self.max_prediction = int(frames)
        return self

    def with_input_delay(self, frames: int) -> "SessionBuilder":
        self.input_delay = int(frames)
        return self

    def with_check_distance(self, frames: int) -> "SessionBuilder":
        self.check_distance = int(frames)
        return self

    def with_fps(self, fps: int) -> "SessionBuilder":
        if fps <= 0:
            raise InvalidRequest(f"fps must be positive, got {fps}")
        self.fps = int(fps)
        return self

    def with_disconnect_timeout(self, seconds: float) -> "SessionBuilder":
        self.disconnect_timeout = float(seconds)
        return self

    def with_disconnect_notify_delay(self, seconds: float) -> "SessionBuilder":
        self.disconnect_notify_start = float(seconds)
        return self

    def with_catchup_speed(
        self, catchup_threshold: int, max_frames_behind: int
    ) -> "SessionBuilder":
        self.catchup_threshold = int(catchup_threshold)
        self.max_frames_behind = int(max_frames_behind)
        return self

    def with_seed(self, seed: int) -> "SessionBuilder":
        self.seed = int(seed)
        return self

    def with_interaction_mode(self, mode: Optional[str]) -> "SessionBuilder":
        """Default pairwise-interaction mode for schedules built without an
        explicit one: "dense" (O(N²) kernels), "grid" (the spatial-binning
        neighbor grid, :mod:`bevy_ggrs_tpu_torch.ops.neighbor`), or "auto" (grid
        at N ≥ ``neighbor.GRID_AUTO_THRESHOLD``). ``None`` clears it.

        Installs the process-wide trace-time default (see
        ``neighbor.set_default_interaction_mode``): it applies to schedules
        traced AFTER this call, sits below the ``GGRS_FORCE_MODE`` env
        override, and never overrides a mode a model was given explicitly
        (so pinned parity tests keep their pinned paths). Every executable
        of one session resolves the same mode, which is what keeps serial,
        fused-speculative and sharded ticks bitwise-equal."""
        from bevy_ggrs_tpu_torch.ops import neighbor

        neighbor.set_default_interaction_mode(mode)
        self.interaction_mode = mode
        return self

    def with_input_predictor(self, predictor) -> "SessionBuilder":
        """Configure the learned input predictor
        (:mod:`bevy_ggrs_tpu_torch.predict`) for sessions this builder
        starts.

        ``predictor``: ``True``/``"default"`` for the committed default
        artifact, an artifact path, :class:`PredictorWeights`, an
        :class:`InputPredictor`, ``False`` to force prediction off
        (ignoring ``GGRS_PREDICTOR``), or ``None`` (the default) to consult
        the ``GGRS_PREDICTOR`` env var at session start.

        The resolved weights' 64-bit content hash becomes the session's wire
        config digest: every sync-handshake leg carries it, and a peer
        advertising another digest is refused with a typed
        ``CONFIG_MISMATCH`` event (the handshake does not complete; never a
        desync). The weights are validated here, so a bad path fails this
        call and not a session mid-start."""
        from bevy_ggrs_tpu_torch.predict import resolve_predictor_config

        resolve_predictor_config(predictor)  # validate eagerly
        self.input_predictor = predictor
        return self

    def _config_digest(self) -> int:
        """The wire config digest for sessions started now: the resolved
        predictor's weight content hash, 0 when prediction is off."""
        from bevy_ggrs_tpu_torch.predict import resolve_predictor_config

        ip = resolve_predictor_config(self.input_predictor)
        return 0 if ip is None else ip.content_hash

    def with_desync_detection(self, interval_frames) -> "SessionBuilder":
        """Configure the P2P checksum exchange (the ggrs
        ``DesyncDetection`` session config, survey §2.2).

        ``interval_frames`` > 0: exchange confirmed-frame checksums every
        that many frames. ``None`` or <= 0: off — no exchange, no
        ``DESYNC_DETECTED`` events, and rollback bursts never pay a
        device->host checksum sync. Unset ("auto", the default): the
        largest interval not exceeding ``max_prediction``, chosen so the
        divergent frame is usually still inside the snapshot ring at
        detection time and ``runner.diagnose_frame(frame)`` can name the
        diverging component instead of falling back to current-state
        diffing. Smaller intervals localize desyncs faster but cost a
        host sync (and a datagram) proportionally more often."""
        self.desync_detection = interval_frames
        return self

    def add_player(self, player: PlayerType, handle: int) -> "SessionBuilder":
        """Players get handles 0..num_players-1; spectators get handles
        ≥ num_players (the ggrs convention)."""
        if player.kind == PlayerKind.SPECTATOR:
            self._spectators.append(player.addr)
            return self
        if not 0 <= handle < self.num_players:
            raise InvalidRequest(
                f"player handle {handle} out of range 0..{self.num_players - 1}"
            )
        if handle in self._players:
            raise InvalidRequest(f"handle {handle} added twice")
        self._players[handle] = player
        return self

    # Session constructors ------------------------------------------------

    def _check_players(self) -> Tuple[Dict[int, None], Dict[int, object]]:
        missing = [h for h in range(self.num_players) if h not in self._players]
        if missing:
            raise InvalidRequest(f"players not added for handles {missing}")
        local = {
            h: None
            for h, p in self._players.items()
            if p.kind == PlayerKind.LOCAL
        }
        remote = {
            h: p.addr
            for h, p in self._players.items()
            if p.kind == PlayerKind.REMOTE
        }
        return local, remote

    def start_p2p_session(
        self, socket, clock=None, metrics=None, tracer=None
    ) -> P2PSession:
        local, remote = self._check_players()
        return P2PSession(
            num_players=self.num_players,
            input_spec=self.input_spec,
            socket=socket,
            local_players=local,
            remote_players=remote,
            spectators=self._spectators,
            max_prediction=self.max_prediction,
            input_delay=self.input_delay,
            disconnect_timeout=self.disconnect_timeout,
            disconnect_notify_start=self.disconnect_notify_start,
            fps=self.fps,
            seed=self.seed,
            clock=clock,
            desync_detection=self.desync_detection,
            metrics=metrics,
            tracer=tracer,
            config_digest=self._config_digest(),
        )

    def start_synctest_session(self) -> SyncTestSession:
        return SyncTestSession(
            num_players=self.num_players,
            input_spec=self.input_spec,
            check_distance=self.check_distance,
            max_prediction=self.max_prediction,
            input_delay=self.input_delay,
        )

    def start_spectator_session(
        self, host_addr, socket, clock=None
    ) -> SpectatorSession:
        return SpectatorSession(
            num_players=self.num_players,
            input_spec=self.input_spec,
            socket=socket,
            host_addr=host_addr,
            catchup_threshold=self.catchup_threshold,
            max_frames_behind=self.max_frames_behind,
            seed=self.seed,
            clock=clock,
            config_digest=self._config_digest(),
        )
