"""SpectatorSession: receive confirmed inputs from a host; never roll back.

Counterpart of ``bevy_ggrs_tpu/session/spectator.py``. The reference's
spectator flavor (`bevy_ggrs/src/ggrs_stage.rs:195-211`)
advances only on confirmed host data — its request lists contain ONLY
``AdvanceFrame`` (no saves, no loads), and when the host's inputs haven't
arrived it waits (`ggrs_stage.rs:205-207` logs "waiting for host").

Catch-up: when more than ``catchup_threshold`` confirmed frames are buffered,
``advance_frame()`` emits up to ``max_frames_behind`` advances in one call so
a lagging spectator converges on the live session instead of falling ever
further behind.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional

import numpy as np

from bevy_ggrs_tpu_torch.schedule import CONFIRMED, InputSpec
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import (
    EventKind,
    NetworkStats,
    NotSynchronized,
    PredictionThreshold,
    SessionEvent,
    SessionState,
    NULL_FRAME,
    restore_spans,
    serialize_spans,
)
from bevy_ggrs_tpu_torch.session.endpoint import PeerEndpoint, PeerState
from bevy_ggrs_tpu_torch.session.input_queue import make_queue_set
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame

# Hard per-call burst cap on catch-up, independent of configuration: one
# ``advance_frame()`` never emits more than this many advances even when a
# caller sets ``max_frames_behind`` huge or a spectator resumes hundreds of
# frames behind (long partition / checkpoint resume). The host loop driving
# the spectator therefore has bounded per-poll work — a returning spectator
# converges over several polls instead of stalling one poll for an
# unbounded dispatch burst.
CATCHUP_BURST_CAP = 16


class SpectatorSession:
    def __init__(
        self,
        num_players: int,
        input_spec: InputSpec,
        socket,
        host_addr,
        catchup_threshold: int = 8,
        max_frames_behind: int = 4,
        seed: int = 0,
        clock=None,
        config_digest: int = 0,
    ):
        self.num_players = int(num_players)
        self.input_spec = input_spec
        self.socket = socket
        self.host_addr = host_addr
        self.catchup_threshold = int(catchup_threshold)
        self.max_frames_behind = int(max_frames_behind)
        self._clock = clock if clock is not None else _time.monotonic

        self._zero = input_spec.zeros_np(1)[0]
        self._qset = make_queue_set(self._zero, [0] * num_players)
        self._queues = self._qset.queues
        rng = np.random.RandomState(seed)
        self._endpoint = PeerEndpoint(
            host_addr, rng, config_digest=config_digest
        )
        self.current_frame = 0
        self._events: List[SessionEvent] = []
        # Per-handle streak of consecutive POLLS whose input messages for
        # that handle all started AHEAD of our confirmed frontier: the host
        # has trimmed past us (stale-checkpoint resume) and that handle's
        # gap will never close. Tracked per handle — one permanently gapped
        # handle must surface even while the others keep progressing — and
        # per poll, not per message, so resend rate doesn't skew the count.
        self._gap_streak = [0] * self.num_players
        self._poll_gap = [False] * self.num_players
        self._poll_ok = [False] * self.num_players

    # ------------------------------------------------------------------

    def current_state(self) -> SessionState:
        if self._endpoint.state == PeerState.SYNCHRONIZING:
            return SessionState.SYNCHRONIZING
        return SessionState.RUNNING

    def local_player_handles(self) -> List[int]:
        return []  # spectators never contribute input

    def frames_behind_host(self) -> int:
        host_frame = self._endpoint.remote_frame
        return max(0, host_frame - self.current_frame) if host_frame != NULL_FRAME else 0

    def network_stats(self) -> NetworkStats:
        return self._endpoint.stats(self._clock(), self.current_frame)

    def events(self) -> List[SessionEvent]:
        out, self._events = self._events, []
        return out

    # ------------------------------------------------------------------

    def poll_remote_clients(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        got_inputs = False
        for addr, data in self.socket.receive_all():
            if addr != self.host_addr:
                continue
            msg = proto.decode(data)
            if msg is None:
                self._endpoint.note_undecodable(data)
                continue
            if isinstance(msg, proto.InputMsg):
                got_inputs = True
            self._endpoint.on_message(msg, now, self._on_inputs)
        if got_inputs:
            # Ack per handle so the host trims its pending span — without
            # this the host's redundant resend grows O(frames) forever.
            for h, q in enumerate(self._queues):
                if q.last_confirmed_frame >= 0:
                    self._endpoint.send_input_ack(h, q.last_confirmed_frame, now)
        # Fold this poll's per-handle observations into the gap streaks: a
        # handle whose only messages this poll started past our frontier
        # extends its streak; any message overlapping the frontier (host
        # still retains our next frame) resets it. Polls with no input
        # traffic for a handle leave its streak unchanged (a silent host is
        # loss/idle, not evidence of trimmed history).
        for h in range(self.num_players):
            if self._poll_ok[h]:
                self._gap_streak[h] = 0
            elif self._poll_gap[h]:
                self._gap_streak[h] += 1
            self._poll_ok[h] = False
            self._poll_gap[h] = False
        self._endpoint.poll(now, self.current_frame, 0)
        self._events.extend(self._endpoint.events)
        self._endpoint.events.clear()
        for data in self._endpoint.outbox:
            self.socket.send_to(data, self.host_addr)
        self._endpoint.outbox.clear()

    def _on_inputs(self, msg: proto.InputMsg) -> None:
        h = msg.handle
        if not 0 <= h < self.num_players:
            return
        queue = self._queues[h]
        if msg.start_frame > queue.last_confirmed_frame + 1:
            # Span starts past our frontier. Transiently possible only if
            # reordering outran the redundant resend; persistently it means
            # the host trimmed history we never received (a checkpoint
            # staler than the host's retained window) — flag it so
            # advance_frame can fail loudly instead of stalling forever.
            self._poll_gap[h] = True
            return
        # Span reaches our frontier: the host still retains our next frame,
        # so this handle's gap (if any) is bridgeable.
        self._poll_ok[h] = True
        for frame, bits in proto.unpack_input_span(
            msg, np.dtype(self._zero.dtype), self._zero.shape
        ):
            if frame <= queue.last_confirmed_frame:
                continue
            if frame != queue.last_confirmed_frame + 1:
                break  # gap: wait for the redundant resend
            queue.add_input(frame, bits)

    # ------------------------------------------------------------------
    # Checkpoint / resume

    def state_dict(self) -> dict:
        """Resumable local state: frame counter + buffered confirmed spans.

        Contract (narrower than the P2P host's): a restored spectator can
        only rejoin while the HOST still buffers inputs past this
        checkpoint's frontier — i.e. resume from the NEWEST checkpoint,
        promptly. Everything the spectator acked after this checkpoint was
        trimmed host-side and is unrecoverable; in that case
        ``advance_frame`` raises :class:`NotSynchronized` with an
        unbridgeable-gap message (instead of stalling silently) and the
        right move is to rejoin as a fresh spectator."""
        inputs = serialize_spans(self._queues, max(0, self.current_frame - 4))
        return {"current_frame": self.current_frame, "inputs": inputs}

    def load_state_dict(self, sd: dict) -> None:
        self.current_frame = int(sd["current_frame"])
        restore_spans(
            self._queues, sd["inputs"], self.current_frame,
            self._zero.dtype, self._zero.shape,
        )

    # ------------------------------------------------------------------

    def _confirmed_frame(self) -> int:
        return self._qset.min_confirmed()

    def advance_frame(self) -> List[AdvanceFrame]:
        """Only ``AdvanceFrame`` requests, only on confirmed data.

        Raises :class:`PredictionThreshold` when the host's inputs for the
        next frame haven't arrived (the reference logs "Waiting for input
        from host" and skips, `ggrs_stage.rs:205-207`).
        """
        if self.current_state() != SessionState.RUNNING:
            raise NotSynchronized("spectator has not synchronized with host")
        confirmed = self._confirmed_frame()
        if confirmed < self.current_frame:
            if max(self._gap_streak) > 120:
                raise NotSynchronized(
                    "confirmed-input stream has an unbridgeable gap (the "
                    "host no longer retains frames past our frontier — "
                    "e.g. a resume from a checkpoint older than the host's "
                    "buffered window); rejoin as a fresh spectator"
                )
            raise PredictionThreshold(
                f"waiting for host input for frame {self.current_frame}"
            )
        behind = confirmed - self.current_frame + 1
        n = 1
        if behind > self.catchup_threshold:
            n = min(behind, self.max_frames_behind, CATCHUP_BURST_CAP)
        requests = []
        for _ in range(n):
            frame = self.current_frame
            bits, _ = self._qset.gather(frame)
            status = np.full((self.num_players,), CONFIRMED, dtype=np.int32)
            requests.append(AdvanceFrame(bits=bits, status=status))
            self.current_frame = frame + 1
        self._qset.discard_before(self.current_frame - 2)
        return requests
