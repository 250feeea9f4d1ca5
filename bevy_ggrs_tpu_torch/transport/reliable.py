"""ReliableSocket: at-least-once + idempotent delivery for control frames.

Counterpart of ``bevy_ggrs_tpu/transport/reliable.py``.

The fleet control plane (migration types 18-21) rides UDP, so under a
ChaosPlan a single lost MigrateOffer used to wedge an in-flight migration
until a wall-clock timeout fired — and a DUPLICATED offer could start the
same transfer twice. This wrapper turns that wire into something a control
plane can actually stand on:

* **Selective enveloping.** ``send_to`` peeks at the outgoing type byte;
  frames in ``RELIABLE_TYPES`` (the migration family) are wrapped in a
  :class:`~bevy_ggrs_tpu_torch.session.protocol.CtrlFrame` envelope carrying a
  per-peer sequence number and a CRC32 over the payload. Everything else —
  heartbeats above all — passes through untouched: a liveness beacon that
  retransmits defeats its own purpose (the NEXT beat is the retry), and
  the data plane has its own redundancy.
* **Ack-driven retransmit.** Unacked envelopes are resent by :meth:`pump`
  with exponential backoff plus seeded jitter (deterministic under a fixed
  seed, so chaos soaks replay). After ``max_retries`` the entry is dropped
  and counted in ``gave_up`` — the caller's migration-timeout path remains
  the backstop for a truly severed peer.
* **Idempotent receive.** Every intact envelope is acked (even duplicates:
  the ack may be the thing that was lost), delivered at most once per
  (peer, seq) via a contiguous floor + out-of-order set, and CRC failures
  are dropped silently (the sender retransmits). Non-envelope datagrams
  are yielded unchanged, so one socket carries both sublayers.

Layering: wrap ABOVE the chaos/fault injector (acks and retransmits must
cross the faulty wire too) and BELOW any provenance sidecar that wants to
see clean inner frames — or anywhere else, since
``obs/provenance`` unwraps envelopes when classifying.
"""

from __future__ import annotations

import random
import time as _time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from bevy_ggrs_tpu_torch.session import protocol


RELIABLE_TYPES = frozenset(
    {
        protocol.T_MIGRATE_OFFER,
        protocol.T_MIGRATE_ACCEPT,
        protocol.T_MIGRATE_CHUNK,
        protocol.T_MIGRATE_DONE,
    }
)


class _Peer:
    __slots__ = ("next_seq", "floor", "seen")

    def __init__(self):
        self.next_seq = 1  # next seq to assign on send
        self.floor = 0  # all received seqs <= floor already delivered
        self.seen: Set[int] = set()  # delivered seqs above floor


class ReliableSocket:
    """Wrap any ``NonBlockingSocket``; see module docstring."""

    def __init__(
        self,
        inner,
        clock: Optional[Callable[[], float]] = None,
        seed: int = 0,
        rto: float = 0.05,
        max_rto: float = 1.0,
        max_retries: int = 12,
    ):
        self.inner = inner
        self._clock = clock if clock is not None else _time.monotonic
        self.rto = float(rto)
        self.max_rto = float(max_rto)
        self.max_retries = int(max_retries)
        self._jitter = random.Random(int(seed) & 0xFFFFFFFF)
        self._peers: Dict[object, _Peer] = {}
        # (addr, seq) -> [env_bytes, addr, due_time, attempt]
        self._pending: Dict[Tuple[object, int], list] = {}
        # Counters (the bench/obs surface).
        self.retransmits = 0
        self.duplicates_dropped = 0
        self.crc_drops = 0
        self.gave_up = 0
        self.acked = 0

    # ------------------------------------------------------------------

    def _peer(self, addr) -> _Peer:
        p = self._peers.get(addr)
        if p is None:
            p = self._peers[addr] = _Peer()
        return p

    @staticmethod
    def _type_of(data: bytes) -> Optional[int]:
        if len(data) >= protocol._HDR.size:
            magic, version, mtype = protocol._HDR.unpack_from(data)
            if magic == protocol.MAGIC and version == protocol.VERSION:
                return mtype
        return None

    def send_to(self, data: bytes, addr) -> None:
        if self._type_of(data) not in RELIABLE_TYPES:
            self.inner.send_to(data, addr)
            return
        peer = self._peer(addr)
        seq = peer.next_seq
        peer.next_seq += 1
        env = protocol.encode(
            protocol.CtrlFrame(seq, zlib.crc32(data) & 0xFFFFFFFF, data)
        )
        self._pending[(addr, seq)] = [env, addr, self._clock() + self.rto, 0]
        self.inner.send_to(env, addr)

    def pump(self, now: Optional[float] = None) -> None:
        """Retransmit every due unacked envelope (call on the drain
        cadence; :meth:`receive_all` also pumps)."""
        if not self._pending:
            return
        if now is None:
            now = self._clock()
        for key in list(self._pending):
            entry = self._pending.get(key)
            if entry is None or entry[2] > now:
                continue
            entry[3] += 1
            if entry[3] > self.max_retries:
                del self._pending[key]
                self.gave_up += 1
                continue
            self.retransmits += 1
            backoff = min(self.rto * (2.0 ** entry[3]), self.max_rto)
            entry[2] = now + backoff * (1.0 + 0.25 * self._jitter.random())
            self.inner.send_to(entry[0], entry[1])

    def receive_all(self) -> Iterable[Tuple[object, bytes]]:
        self.pump()
        out: List[Tuple[object, bytes]] = []
        for addr, data in self.inner.receive_all():
            mtype = self._type_of(data)
            if mtype == protocol.T_CTRL_ACK:
                msg = protocol.decode(data)
                if msg is not None:
                    if self._pending.pop((addr, msg.seq), None) is not None:
                        self.acked += 1
                continue
            if mtype != protocol.T_CTRL_FRAME:
                out.append((addr, data))
                continue
            msg = protocol.decode(data)
            if msg is None or zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc:
                self.crc_drops += 1
                continue
            # Ack unconditionally — a duplicate usually means OUR ack died.
            self.inner.send_to(
                protocol.encode(protocol.CtrlAck(msg.seq)), addr
            )
            peer = self._peer(addr)
            if msg.seq <= peer.floor or msg.seq in peer.seen:
                self.duplicates_dropped += 1
                continue
            peer.seen.add(msg.seq)
            while peer.floor + 1 in peer.seen:
                peer.floor += 1
                peer.seen.discard(peer.floor)
            out.append((addr, msg.payload))
        return out

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def close(self) -> None:
        self._pending.clear()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        # local_port / faults / addr / fileno passthrough to the wrapped
        # transport so callers don't care about the extra layer.
        return getattr(self.inner, name)
