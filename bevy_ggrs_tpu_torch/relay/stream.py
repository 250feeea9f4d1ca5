"""Confirmed-state stream endpoints: host-side publisher, spectator-side
subscriber.

Counterpart of ``bevy_ggrs_tpu/relay/stream.py``: the same keyframe and
delta bytes for the same world (``StateCodec`` is byte-identical). The
publisher reads settled rows of the runner's snapshot ring, which lives on
the card: every probe of a row's frame and every leaf of an encoded row is
a read back to the host, counted in :attr:`StatePublisher.readbacks`.

:class:`StatePublisher` rides a live peer (session + runner): each call to
``publish()`` serializes newly *settled* confirmed frames out of the
snapshot ring through a :class:`~bevy_ggrs_tpu_torch.relay.delta.StateCodec` and
ships them to the relay — a keyframe (chunked, integrity-digested) every
``keyframe_interval`` published frames or whenever the relay instance
changed (epoch), XOR/RLE deltas otherwise. The host uploads the stream
ONCE; the relay replicates it to every spectator (that asymmetry is the
whole point of the fan-out tier).

:class:`StreamSpectator` is the new broadcast-scale spectator kind: it
never receives inputs and never simulates — it reconstructs the confirmed
state bitwise from keyframes + deltas, acks its contiguous frontier for the
relay's flow control, and re-subscribes (with its resumable cursor) through
relay silence or shed. Catch-up work is bounded per poll
(``max_apply_per_poll``) exactly like the input-driven
``SpectatorSession``'s burst cap.
"""

from __future__ import annotations

import time as _time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.relay.client import RELAY_CONTROL
from bevy_ggrs_tpu_torch.relay.delta import (
    StateCodec,
    delta_apply,
    delta_encode,
    payload_digest,
)
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import NULL_FRAME
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics
from bevy_ggrs_tpu_torch.obs import null_tracer

__all__ = ["StatePublisher", "StreamSpectator"]

# Keyframe fragments mirror the supervisor's state-transfer chunking.
CHUNK_PAYLOAD = 1024


class StatePublisher:
    def __init__(
        self,
        session,
        runner,
        socket=None,
        relay_addr=RELAY_CONTROL,
        keyframe_interval: int = 20,
        max_frames_per_publish: int = 4,
        metrics=None,
        tracer=None,
    ):
        self.session = session
        self.runner = runner
        self.socket = socket if socket is not None else session.socket
        self.relay_addr = relay_addr
        self.keyframe_interval = int(keyframe_interval)
        self.max_frames_per_publish = int(max_frames_per_publish)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer

        self.codec: Optional[StateCodec] = None
        self._prev: Optional[bytes] = None
        self._prev_frame = NULL_FRAME
        self._since_keyframe = 0
        self.published_frames = 0
        # Device-to-host reads: one per ring-row frame probe, one per leaf
        # of each encoded row (each a sync when the ring is on the card).
        self.readbacks = 0

    # ------------------------------------------------------------------

    def rehost(self, runner=None, socket=None, session=None) -> None:
        """Re-point the publisher at a new runner/socket/session after a
        live cross-server match migration. The delta chain state
        (``_prev``/``_prev_frame``) is KEPT — the destination server
        resumed the match bitwise, so the last published payload is still
        the true chain base — but the next published frame is forced to
        be a keyframe so any spectator whose chain walk straddles the hop
        resyncs from a checkpoint instead of degrading. Spectator cursors
        survive: a keyframe at frame > cursor always supersedes."""
        if runner is not None:
            self.runner = runner
        if socket is not None:
            self.socket = socket
        if session is not None:
            self.session = session
        self._since_keyframe = self.keyframe_interval

    def _send(self, msg: proto.Message) -> None:
        data = proto.encode(msg)
        self.socket.send_to(data, self.relay_addr)
        self.metrics.count("stream_bytes_published", len(data))

    def _send_keyframe(self, frame: int, cur: bytes) -> None:
        digest = payload_digest(cur)
        chunks = [
            cur[i : i + CHUNK_PAYLOAD]
            for i in range(0, len(cur), CHUNK_PAYLOAD)
        ] or [b""]
        total = len(chunks)
        for seq, payload in enumerate(chunks):
            self._send(
                proto.StreamKeyframe(
                    frame, seq, total,
                    zlib.crc32(payload) & 0xFFFFFFFF, digest, payload,
                )
            )
        self.metrics.count("stream_keyframes_published")

    def _publishable_frames(self) -> List[int]:
        from bevy_ggrs_tpu_torch.state import ring_frame_at

        session, runner = self.session, self.runner
        bound = min(session.confirmed_frame(), runner.frame)
        if bound <= self._prev_frame:
            return []
        lo = max(self._prev_frame + 1, bound - runner.max_prediction)
        frames = []
        for f in range(lo, bound + 1):
            self.readbacks += 1
            if ring_frame_at(runner.ring, f) == f and session._settled(f):
                frames.append(f)
        # Bounded work per call: a host recovering from a stall publishes
        # the NEWEST frames and lets the delta chain skip the gap (deltas
        # are keyed by "previous published frame", not frame-1).
        return frames[-self.max_frames_per_publish :]

    def publish(self, now: Optional[float] = None) -> int:
        """Serialize + ship newly settled confirmed frames; returns how
        many frames went out."""
        from bevy_ggrs_tpu_torch.state import ring_load

        consume = getattr(self.socket, "consume_epoch_change", None)
        epoch_changed = bool(consume()) if consume is not None else False
        frames = self._publishable_frames()
        if not frames and not epoch_changed:
            return 0
        if not frames and epoch_changed and self._prev is not None:
            # New relay instance but no new settled frame yet: re-seed the
            # fresh buffer with the last published state as a keyframe.
            self._send_keyframe(self._prev_frame, self._prev)
            self._since_keyframe = 0
            return 0
        sent = 0
        with self.tracer.span("stream_publish", frames=len(frames)):
            for f in frames:
                state = ring_load(self.runner.ring, f)
                if self.codec is None:
                    self.codec = StateCodec.for_state(state)
                    self.readbacks += len(self.codec._leaves)
                cur = self.codec.encode(state)
                self.readbacks += len(self.codec._leaves)
                keyframe = (
                    self._prev is None
                    or epoch_changed
                    or self._since_keyframe >= self.keyframe_interval
                )
                if keyframe:
                    self._send_keyframe(f, cur)
                    self._since_keyframe = 0
                if self._prev is not None and not epoch_changed:
                    # The chain delta rides along even on keyframe frames:
                    # keyframes are checkpoints ON the stream, not breaks
                    # IN it. Without this, no delta has the pre-keyframe
                    # frame as its base, and every subscriber's chain walk
                    # hits a gap at every keyframe boundary — a spurious
                    # degrade/recover cycle per subscriber per keyframe.
                    delta = delta_encode(self._prev, cur)
                    self._send(
                        proto.StreamDelta(
                            f, self._prev_frame,
                            zlib.crc32(cur) & 0xFFFFFFFF, delta,
                        )
                    )
                    self._since_keyframe += int(not keyframe)
                epoch_changed = False
                self._prev, self._prev_frame = cur, f
                self.published_frames += 1
                sent += 1
        return sent


class StreamSpectator:
    """Reconstructs the confirmed-state stream from a relay; failover and
    shed-resume are both "re-subscribe with my cursor"."""

    def __init__(
        self,
        socket,
        relays: List[object],
        session_id: int = 0,
        window: int = 16,
        codec: Optional[StateCodec] = None,
        clock: Optional[Callable[[], float]] = None,
        sub_interval: float = 0.2,
        resub_timeout: float = 0.6,
        max_apply_per_poll: int = 32,
        metrics=None,
        tracer=None,
    ):
        if not relays:
            raise ValueError("StreamSpectator needs at least one relay address")
        self.socket = socket
        self.relays = list(relays)
        self._idx = 0
        self.relay_addr = self.relays[0]
        self.session_id = int(session_id)
        self.window = int(window)
        self.codec = codec
        self._clock = clock if clock is not None else _time.monotonic
        self.sub_interval = float(sub_interval)
        self.resub_timeout = float(resub_timeout)
        self.max_apply_per_poll = int(max_apply_per_poll)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer

        self.current_frame = NULL_FRAME
        self.state_bytes: Optional[bytes] = None
        self.head_seen = NULL_FRAME
        self.keyframes_applied = 0
        self.deltas_applied = 0
        self.failovers = 0
        # base_frame -> (frame, crc, payload); bounded — the relay resends.
        self._pending: Dict[int, Tuple[int, int, bytes]] = {}
        # frame -> {"total", "digest", "chunks": {seq: payload}}
        self._assembly: Dict[int, Dict] = {}
        now = self._clock()
        self._last_data = now
        self._last_sub = float("-inf")

    # ------------------------------------------------------------------

    def frames_behind(self) -> int:
        if self.head_seen == NULL_FRAME or self.current_frame == NULL_FRAME:
            return 0
        return max(0, self.head_seen - self.current_frame)

    def world(self):
        """Decoded host-side view of the reconstructed state (requires a
        codec built from the same world template as the publisher's)."""
        if self.state_bytes is None or self.codec is None:
            return None
        return self.codec.decode(self.state_bytes)

    def _subscribe(self, now: float) -> None:
        self._last_sub = now
        self.socket.send_to(
            proto.encode(
                proto.Subscribe(self.session_id, self.current_frame, self.window)
            ),
            self.relay_addr,
        )

    def _failover(self, now: float) -> None:
        self._idx = (self._idx + 1) % len(self.relays)
        self.relay_addr = self.relays[self._idx]
        self.failovers += 1
        self.metrics.count("spectator_relay_failovers")
        self._last_data = now  # grace on the new relay
        self._subscribe(now)

    def retarget(self, relays: List[object], now: Optional[float] = None) -> None:
        """Re-home to a new relay list (tree re-home ladder: a dead
        mid-tier relay's spectators move to a sibling or grandparent).
        The resumable cursor is client-side state, so the swap is just
        "subscribe over there with what I hold": when the new relay
        still buffers the chain, the chain-aware resume promotes the
        cursor straight to FULL and the swap costs zero keyframe
        bytes."""
        if not relays:
            raise ValueError("StreamSpectator.retarget needs >= 1 relay")
        self.relays = list(relays)
        self._idx = 0
        self.relay_addr = self.relays[0]
        self.metrics.count("spectator_retargets")
        now = self._clock() if now is None else now
        self._last_data = now  # grace on the new tree position
        self._subscribe(now)

    def _on_keyframe(self, msg: proto.StreamKeyframe) -> None:
        if msg.frame <= self.current_frame:
            return
        if zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc & 0xFFFFFFFF:
            self.metrics.count("stream_chunk_corrupt")
            return
        asm = self._assembly.setdefault(
            msg.frame, {"total": msg.total, "digest": msg.digest, "chunks": {}}
        )
        asm["chunks"][msg.seq] = msg.payload
        if len(asm["chunks"]) < asm["total"]:
            return
        data = b"".join(asm["chunks"][s] for s in sorted(asm["chunks"]))
        del self._assembly[msg.frame]
        if payload_digest(data) != asm["digest"]:
            self.metrics.count("stream_keyframe_rejected")
            return
        self.state_bytes = data
        self.current_frame = msg.frame
        self.keyframes_applied += 1
        self.metrics.count("stream_keyframes_applied")
        self.tracer.instant("stream_keyframe_applied", frame=msg.frame)
        # Everything older is now irrelevant.
        self._pending = {
            b: v for b, v in self._pending.items() if b >= self.current_frame
        }
        self._assembly = {
            f: a for f, a in self._assembly.items() if f > self.current_frame
        }

    def poll(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        got_data = False
        for addr, raw in self.socket.receive_all():
            if addr not in self.relays:
                continue
            msg = proto.decode(raw)
            if msg is None:
                self.metrics.count("stream_undecodable")
                continue
            if isinstance(msg, proto.StreamDelta):
                got_data = True
                self.metrics.count("stream_delta_bytes_received", len(raw))
                self.head_seen = max(self.head_seen, msg.frame)
                if msg.frame > self.current_frame:
                    self._pending[msg.base_frame] = (
                        msg.frame, msg.crc, msg.payload
                    )
            elif isinstance(msg, proto.StreamKeyframe):
                got_data = True
                # Split byte accounting per datagram class: the warm-
                # failover contract ("zero keyframe bytes across a swap
                # whose chain is contiguous") is pinned on this counter.
                self.metrics.count("stream_keyframe_bytes_received", len(raw))
                self.head_seen = max(self.head_seen, msg.frame)
                self._on_keyframe(msg)
        if got_data:
            self._last_data = now

        # Apply the contiguous delta chain, bounded per poll (the same
        # burst discipline as SpectatorSession.CATCHUP_BURST_CAP): a
        # spectator way behind converges over several polls instead of
        # stalling its render loop once, hugely.
        applied = 0
        while (
            applied < self.max_apply_per_poll
            and self.state_bytes is not None
            and self.current_frame in self._pending
        ):
            frame, crc, payload = self._pending.pop(self.current_frame)
            try:
                self.state_bytes = delta_apply(
                    self.state_bytes, payload, expect_crc=crc
                )
            except ValueError:
                # Corrupt delta: drop it and wait for the relay's
                # redundant resend of the same frame.
                self.metrics.count("stream_delta_rejected")
                break
            self.current_frame = frame
            self.deltas_applied += 1
            applied += 1
        if applied:
            self.metrics.count("stream_deltas_applied", applied)
        # Prune stale pendings (bases behind our frontier can never apply).
        if len(self._pending) > 4 * self.window:
            self._pending = {
                b: v
                for b, v in self._pending.items()
                if b >= self.current_frame
            }

        # Liveness: ack progress; (re-)subscribe through silence or shed.
        if self.state_bytes is not None:
            self.socket.send_to(
                proto.encode(proto.StreamAck(self.current_frame)),
                self.relay_addr,
            )
        if now - self._last_data > self.resub_timeout:
            self._failover(now)
        elif self.state_bytes is None and now - self._last_sub > self.sub_interval:
            self._subscribe(now)
