"""RelayServer: peer-traffic termination + broadcast spectator fan-out.

Counterpart of ``bevy_ggrs_tpu/relay/server.py``: host code that never
decodes a state, so it forwards the same bytes as the JAX package's.

One pump-driven server doing two jobs over a single socket:

1. **Forwarding plane** — peers register with :class:`RelayHello` and
   exchange their normal wire traffic (types 1–10, state transfer
   included) inside :class:`RelayForward` envelopes. The relay never
   parses the inner datagram: it validates the envelope's ``src`` against
   the sender's registration (cheap spoof guard) and re-sends the
   *received datagram verbatim* to the destination peer's address — zero
   re-encode on the hot path.

2. **Fan-out plane** — a publishing peer streams the confirmed state as
   keyframe chunks + XOR/RLE deltas (relay/stream.py); the relay buffers
   the raw datagrams and replays them to each subscriber under
   per-subscriber flow control. The degradation ladder, per subscriber:

   - FULL: resend every unacked delta each pump, at most ``window``
     frames past the last ack (ack-window backpressure; loss tolerance is
     redundant resend, the same discipline as input spans — no retransmit
     timers).
   - KEYFRAME_ONLY: entered when the ack frontier stalls for
     ``degrade_after`` consecutive pumps while the subscriber is more
     than a window behind, or when the subscriber's next delta has aged
     out of the buffer. Only the newest complete keyframe is resent; one
     ack at/past it returns the subscriber to FULL.
   - SHED: no ack for ``shed_after`` seconds → the subscriber is dropped.
     Recovery is subscriber-driven: it re-subscribes with its cursor
     (frames it already holds are never resent) and lands on the ladder
     wherever its cursor still chains — O(1) rejoin via the newest
     keyframe in the worst case.
"""

from __future__ import annotations

import itertools
import time as _time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.obs import null_tracer
from bevy_ggrs_tpu_torch.relay.delta import payload_digest
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import NULL_FRAME
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

__all__ = ["KeyframeCache", "RelayServer"]

# Relay-instance epochs: module-level counter keeps them unique (and
# deterministic) within one process — a restarted relay gets a fresh epoch,
# which is all publishers need to know to re-seed the stream with a
# keyframe.
_EPOCHS = itertools.count(1)

MODE_FULL = "full"
MODE_KEYFRAME = "keyframe_only"


class _Stream:
    """Per-session stream buffer: raw delta datagrams keyed by their BASE
    frame (the chain walks base → frame), plus keyframe chunk sets."""

    def __init__(self, delta_retention: int, keyframe_retention: int):
        self.delta_retention = delta_retention
        self.keyframe_retention = keyframe_retention
        self.deltas: Dict[int, Tuple[int, bytes]] = {}  # base -> (frame, raw)
        self._delta_order: List[int] = []
        # frame -> {"total": int, "chunks": {seq: raw}, "complete": bool}
        self.keyframes: Dict[int, Dict] = {}
        self.latest_keyframe: Optional[int] = None
        self.head = NULL_FRAME

    def add_delta(self, msg: proto.StreamDelta, raw: bytes) -> None:
        if msg.base_frame in self.deltas:
            self.deltas[msg.base_frame] = (msg.frame, raw)
            return
        self.deltas[msg.base_frame] = (msg.frame, raw)
        self._delta_order.append(msg.base_frame)
        while len(self._delta_order) > self.delta_retention:
            self.deltas.pop(self._delta_order.pop(0), None)
        self.head = max(self.head, msg.frame)

    def add_keyframe(self, msg: proto.StreamKeyframe, raw: bytes) -> None:
        kf = self.keyframes.setdefault(
            msg.frame,
            {
                "total": msg.total,
                "chunks": {},
                "complete": False,
                "digest": msg.digest,
            },
        )
        kf["chunks"][msg.seq] = raw
        if not kf["complete"] and len(kf["chunks"]) >= kf["total"]:
            kf["complete"] = True
            if self.latest_keyframe is None or msg.frame > self.latest_keyframe:
                self.latest_keyframe = msg.frame
            self.head = max(self.head, msg.frame)
            complete = sorted(
                f for f, k in self.keyframes.items() if k["complete"]
            )
            for f in complete[: -self.keyframe_retention]:
                self.keyframes.pop(f, None)


class KeyframeCache:
    """Shared keyframe cache, content-addressed by the 64-bit payload
    digest every :class:`StreamKeyframe` chunk already carries on the
    wire. N cold joins inside one keyframe interval cost ONE upstream
    encode and N local re-sends of the same cached chunk datagrams.

    Entries are validated at SERVE time, not insert time: each chunk's
    crc32 must match its payload and the reassembled payload's digest
    must equal the cache key. A cached entry that rots (bit-flip, bad
    RAM, truncation) is therefore refused, purged, counted as
    ``corrupt`` and the serve falls back to the live stream buffer —
    the cache can never launder bytes the publisher didn't sign."""

    def __init__(self, capacity: int = 4):
        self.capacity = int(capacity)
        # digest -> {"frame": int, "chunks": [raw, ...] in seq order}
        self._entries: Dict[int, Dict] = {}
        self._order: List[int] = []
        self.hits = 0
        self.misses = 0
        self.corrupt = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: int) -> bool:
        return digest in self._entries

    def put(self, digest: int, frame: int, chunks: List[bytes]) -> None:
        if digest in self._entries:
            return
        self._entries[digest] = {"frame": frame, "chunks": list(chunks)}
        self._order.append(digest)
        while len(self._order) > self.capacity:
            self._entries.pop(self._order.pop(0), None)

    def purge(self, digest: int) -> None:
        self._entries.pop(digest, None)
        try:
            self._order.remove(digest)
        except ValueError:
            pass

    def clear(self) -> None:
        self._entries.clear()
        self._order.clear()

    def lookup(self, digest: int) -> Optional[List[bytes]]:
        """Validated fetch: the raw chunk datagrams for ``digest``, or
        ``None`` on miss OR on a corrupt entry (purged + counted)."""
        entry = self._entries.get(digest)
        if entry is None:
            self.misses += 1
            return None
        payloads = []
        for raw in entry["chunks"]:
            msg = proto.decode(raw)
            if (
                not isinstance(msg, proto.StreamKeyframe)
                or msg.digest != digest
                or zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc & 0xFFFFFFFF
            ):
                payloads = None
                break
            payloads.append((msg.seq, msg.payload))
        if payloads is not None:
            data = b"".join(p for _, p in sorted(payloads))
            if payload_digest(data) != digest:
                payloads = None
        if payloads is None:
            self.purge(digest)
            self.corrupt += 1
            self.misses += 1
            return None
        self.hits += 1
        return entry["chunks"]


class _Subscriber:
    __slots__ = (
        "addr", "session_id", "window", "acked", "last_ack_time",
        "last_acked_value", "mode", "stall_pumps",
    )

    def __init__(self, addr, session_id: int, cursor: int, window: int, now: float):
        self.addr = addr
        self.session_id = session_id
        self.window = window
        self.acked = cursor
        self.last_ack_time = now
        self.last_acked_value = cursor
        # A cold join (no cursor) starts on the keyframe rung by design —
        # that's the O(1) join, not a degradation event.
        self.mode = MODE_KEYFRAME if cursor < 0 else MODE_FULL
        self.stall_pumps = 0


class RelayServer:
    def __init__(
        self,
        socket,
        epoch: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        default_window: int = 16,
        max_window: int = 64,
        degrade_after: int = 12,
        shed_after: float = 2.0,
        delta_retention: int = 240,
        keyframe_retention: int = 3,
        max_subscribers: int = 4096,
        metrics=None,
        tracer=None,
    ):
        self.socket = socket
        self.addr = getattr(socket, "addr", None)
        self.epoch = next(_EPOCHS) if epoch is None else int(epoch)
        self._clock = clock if clock is not None else _time.monotonic
        self.default_window = int(default_window)
        self.max_window = int(max_window)
        self.degrade_after = int(degrade_after)
        self.shed_after = float(shed_after)
        self.max_subscribers = int(max_subscribers)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer

        self._delta_retention = int(delta_retention)
        self._keyframe_retention = int(keyframe_retention)
        # session_id -> peer_id -> addr, plus the reverse for validation.
        self._peers: Dict[int, Dict[int, object]] = {}
        self._rev: Dict[object, Tuple[int, int]] = {}
        self._streams: Dict[int, _Stream] = {}
        self._subs: Dict[object, _Subscriber] = {}
        self.keyframe_cache = KeyframeCache()
        self._cache_corrupt_seen = 0
        # A draining relay (autopilot scale-down) serves existing
        # subscribers but refuses NEW ones; it retires once empty.
        self.draining = False

    # ------------------------------------------------------------------

    def subscriber_count(self) -> int:
        return len(self._subs)

    def stream_head(self, session_id: int) -> int:
        st = self._streams.get(session_id)
        return st.head if st is not None else NULL_FRAME

    def stream_latest_keyframe(self, session_id: int) -> Optional[int]:
        st = self._streams.get(session_id)
        return st.latest_keyframe if st is not None else None

    def ingest(self, session_id: int, raw: bytes) -> bool:
        """Feed one raw upstream stream datagram VERBATIM into the
        per-session buffer — the tier-link path (relay/tree.py). A child
        relay's TierLink already authenticated its parent by address, so
        this bypasses the publisher registration (``_rev``) the socket
        path demands. The datagram is stored unmodified, which is what
        makes tree fan-out bitwise-exact at any depth."""
        msg = proto.decode(raw)
        if isinstance(msg, proto.StreamDelta):
            self._stream(session_id).add_delta(msg, raw)
            self.metrics.count("fanout_frames_buffered")
            return True
        if isinstance(msg, proto.StreamKeyframe):
            self._stream(session_id).add_keyframe(msg, raw)
            return True
        self.metrics.count("relay_undecodable")
        return False

    def reset_stream(self, session_id: int) -> None:
        """Drop the per-session stream buffer and the keyframe cache.
        The tier link calls this when its upstream epoch breaks (parent
        restart with a fresh stream): buffered frames and cached
        keyframes from the old instance must not serve new joins."""
        self._streams.pop(session_id, None)
        self.keyframe_cache.clear()
        self.metrics.count("fanout_stream_resets")

    def subscriber_mode(self, addr) -> Optional[str]:
        sub = self._subs.get(addr)
        return sub.mode if sub is not None else None

    def _stream(self, sid: int) -> _Stream:
        st = self._streams.get(sid)
        if st is None:
            st = self._streams[sid] = _Stream(
                self._delta_retention, self._keyframe_retention
            )
        return st

    # -- inbound ---------------------------------------------------------

    def _on_hello(self, msg: proto.RelayHello, addr) -> None:
        peers = self._peers.setdefault(msg.session_id, {})
        old = peers.get(msg.peer_id)
        if old is not None and old != addr:
            self._rev.pop(old, None)  # peer moved (restart on a new port)
        peers[msg.peer_id] = addr
        self._rev[addr] = (msg.session_id, msg.peer_id)
        self.socket.send_to(
            proto.encode(
                proto.RelayWelcome(msg.session_id, msg.peer_id, self.epoch)
            ),
            addr,
        )

    def _on_forward(self, msg: proto.RelayForward, addr, raw: bytes) -> None:
        reg = self._rev.get(addr)
        if reg is None or reg[1] != msg.src:
            self.metrics.count("relay_forward_rejected")
            return
        dst_addr = self._peers.get(reg[0], {}).get(msg.dst)
        if dst_addr is None:
            self.metrics.count("relay_forward_unroutable")
            return
        # Verbatim re-send of the received datagram: the envelope already
        # carries the true src, so the receiver unwraps it unchanged.
        self.socket.send_to(raw, dst_addr)
        self.metrics.count("relay_forwarded")
        self.metrics.count("relay_forwarded_bytes", len(raw))

    def _chain_alive(self, stream: _Stream, acked: int) -> bool:
        """True when a cursor at ``acked`` still chains: the next delta's
        base is buffered, the cursor is at/past the newest keyframe, or
        the cursor is already at the head (nothing to send)."""
        return (
            acked in stream.deltas
            or acked >= stream.head
            or (
                stream.latest_keyframe is not None
                and acked >= stream.latest_keyframe
            )
        )

    def _on_subscribe(self, msg: proto.Subscribe, addr, now: float) -> None:
        sub = self._subs.get(addr)
        if sub is None:
            if len(self._subs) >= self.max_subscribers or self.draining:
                self.metrics.count("fanout_subscribe_rejected")
                return
            window = min(max(int(msg.window) or self.default_window, 1),
                         self.max_window)
            self._subs[addr] = _Subscriber(
                addr, msg.session_id, msg.cursor, window, now
            )
            self.metrics.count("fanout_subscribed")
            self.tracer.instant("fanout_subscribe", cursor=msg.cursor)
        else:
            # Resume: never move the frontier backwards — the cursor is
            # what the spectator HOLDS, and acks may already be ahead.
            sub.acked = max(sub.acked, msg.cursor)
            sub.last_ack_time = now
            self.metrics.count("fanout_resubscribed")
            # Chain-aware resume: while the spectator was away (relay
            # swap, shed-and-return bounce) this entry's ack frontier
            # stalled and the ladder degraded it to KEYFRAME_ONLY. The
            # stale rung must not outlive the absence: if the returning
            # cursor still chains into the buffer, promote straight back
            # to FULL — a warm failover costs zero keyframe bytes.
            if sub.mode == MODE_KEYFRAME and sub.acked >= 0:
                stream = self._streams.get(sub.session_id)
                if stream is not None and self._chain_alive(stream, sub.acked):
                    sub.mode = MODE_FULL
                    sub.stall_pumps = 0
                    sub.last_acked_value = sub.acked
                    self.metrics.count("fanout_resumed_warm")

    # -- fan-out ---------------------------------------------------------

    def _send_keyframe(self, sub: _Subscriber, stream: _Stream) -> int:
        if stream.latest_keyframe is None:
            return 0
        kf = stream.keyframes.get(stream.latest_keyframe)
        if kf is None or not kf["complete"]:
            return 0
        # Shared-keyframe cache: every serve of the same keyframe after
        # the first comes out of the content-addressed cache — N cold
        # joins in one interval cost one upstream encode, N local sends.
        digest = kf.get("digest")
        chunks: Optional[List[bytes]] = None
        if digest is not None:
            chunks = self.keyframe_cache.lookup(digest)
            self.metrics.count(
                "keyframe_cache_hits" if chunks is not None
                else "keyframe_cache_misses"
            )
        if chunks is None:
            chunks = [kf["chunks"][seq] for seq in sorted(kf["chunks"])]
            if digest is not None:
                if self.keyframe_cache.corrupt > self._cache_corrupt_seen:
                    self.metrics.count(
                        "keyframe_cache_corrupt",
                        self.keyframe_cache.corrupt - self._cache_corrupt_seen,
                    )
                    self._cache_corrupt_seen = self.keyframe_cache.corrupt
                self.keyframe_cache.put(
                    digest, stream.latest_keyframe, chunks
                )
        sent = 0
        for raw in chunks:
            self.socket.send_to(raw, sub.addr)
            self.metrics.count("fanout_bytes_sent", len(raw))
            sent += 1
        self.metrics.count("fanout_keyframe_chunks_sent", sent)
        return sent

    def _pump_subscriber(self, sub: _Subscriber, now: float) -> None:
        stream = self._streams.get(sub.session_id)
        if stream is None or stream.head == NULL_FRAME:
            return
        behind = stream.head - sub.acked

        # Backpressure accounting: the ack frontier stalling while there is
        # work outstanding is the loss/slow-link signal.
        if sub.acked == sub.last_acked_value and behind > 0:
            sub.stall_pumps += 1
        elif sub.acked != sub.last_acked_value:
            sub.stall_pumps = 0
            sub.last_acked_value = sub.acked

        if sub.mode == MODE_FULL:
            chain_alive = self._chain_alive(stream, sub.acked)
            sustained_loss = (
                sub.stall_pumps > self.degrade_after and behind > sub.window
            )
            if (behind > 0 and not chain_alive) or sustained_loss:
                sub.mode = MODE_KEYFRAME
                self.metrics.count("fanout_degraded")
                self.tracer.instant(
                    "fanout_degrade", behind=behind,
                    sustained=int(sustained_loss),
                )
        if sub.mode == MODE_KEYFRAME:
            if (
                stream.latest_keyframe is not None
                and sub.acked >= stream.latest_keyframe
            ):
                sub.mode = MODE_FULL
                sub.stall_pumps = 0
                self.metrics.count("fanout_recovered")
            else:
                self._send_keyframe(sub, stream)
                return
        # FULL: walk the delta chain from the ack frontier, window-capped.
        base = sub.acked
        sent = 0
        while sent < sub.window:
            nxt = stream.deltas.get(base)
            if nxt is None:
                break
            frame, raw = nxt
            self.socket.send_to(raw, sub.addr)
            self.metrics.count("fanout_bytes_sent", len(raw))
            self.metrics.count("fanout_deltas_sent")
            base = frame
            sent += 1

    def pump(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self.tracer.span("relay_pump"):
            for addr, raw in self.socket.receive_all():
                msg = proto.decode(raw)
                if msg is None:
                    self.metrics.count("relay_undecodable")
                    continue
                if isinstance(msg, proto.RelayHello):
                    self._on_hello(msg, addr)
                elif isinstance(msg, proto.RelayForward):
                    self._on_forward(msg, addr, raw)
                elif isinstance(msg, proto.StreamDelta):
                    reg = self._rev.get(addr)
                    if reg is None:
                        self.metrics.count("fanout_publish_rejected")
                        continue
                    self._stream(reg[0]).add_delta(msg, raw)
                    self.metrics.count("fanout_frames_buffered")
                elif isinstance(msg, proto.StreamKeyframe):
                    reg = self._rev.get(addr)
                    if reg is None:
                        self.metrics.count("fanout_publish_rejected")
                        continue
                    self._stream(reg[0]).add_keyframe(msg, raw)
                elif isinstance(msg, proto.Subscribe):
                    self._on_subscribe(msg, addr, now)
                elif isinstance(msg, proto.StreamAck):
                    sub = self._subs.get(addr)
                    if sub is not None:
                        sub.acked = max(sub.acked, msg.frame)
                        sub.last_ack_time = now
                # Anything else addressed AT the relay (keepalives from
                # confused clients, etc.) is dropped silently.

            for addr in list(self._subs):
                sub = self._subs[addr]
                if now - sub.last_ack_time > self.shed_after:
                    # Shed: the resumable cursor lives client-side (its
                    # next Subscribe carries it), so dropping the entry IS
                    # the whole operation.
                    del self._subs[addr]
                    self.metrics.count("fanout_shed")
                    self.tracer.instant("fanout_shed", acked=sub.acked)
                    continue
                self._pump_subscriber(sub, now)

    def close(self) -> None:
        close = getattr(self.socket, "close", None)
        if close is not None:
            close()
