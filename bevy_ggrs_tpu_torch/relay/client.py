"""RelaySocket: a ``NonBlockingSocket`` that tunnels peer traffic through a
RelayServer, with transparent failover to standby relays.

Counterpart of ``bevy_ggrs_tpu/relay/client.py``.

Sessions key endpoints by opaque addresses, so the trick is to hand them
*logical* addresses: peer ``p`` is always ``("relay-peer", p)`` no matter
which physical relay carries the traffic. ``send_to`` wraps the datagram in
a :class:`~bevy_ggrs_tpu_torch.session.protocol.RelayForward` envelope addressed
to the current relay; ``receive_all`` unwraps inbound envelopes back to the
logical source address. When the relay dies, the socket re-handshakes to the
next relay in its standby list — the endpoint map, sync state, and input
history never notice (docs/relay.md, "failover contract").

Liveness mirrors the endpoint sync FSM's retry discipline
(session/endpoint.py): a periodic :class:`RelayHello` doubles as NAT
keepalive and liveness probe, every hello is answered by a
:class:`RelayWelcome`, and sustained welcome silence triggers failover with
exponential backoff between successive relay switches (so a total outage
cycles the standby list at a bounded rate instead of spinning).
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional, Tuple

from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

__all__ = ["RelaySocket", "peer_addr", "RELAY_CONTROL"]

# Virtual destination meaning "the currently-live relay itself" — stream
# publishers send keyframes/deltas here so failover re-routes them too.
RELAY_CONTROL = ("relay", "control")

HELLO_INTERVAL = 0.1
# Welcome silence that triggers failover. Deliberately far below any sane
# disconnect_timeout: the whole point is that peers hop to the standby and
# resume BEFORE their endpoints declare each other disconnected, keeping
# the failover inside the "network blip" regime (zero desync structurally).
RELAY_TIMEOUT = 0.35
FAILOVER_BACKOFF_MAX = 2.0


def peer_addr(peer_id: int) -> Tuple[str, int]:
    """The logical session address of peer ``peer_id`` behind any relay."""
    return ("relay-peer", int(peer_id))


class RelaySocket:
    def __init__(
        self,
        inner,
        relays: List[object],
        session_id: int,
        peer_id: int,
        clock: Optional[Callable[[], float]] = None,
        metrics=None,
        hello_interval: float = HELLO_INTERVAL,
        relay_timeout: float = RELAY_TIMEOUT,
    ):
        if not relays:
            raise ValueError("RelaySocket needs at least one relay address")
        self.inner = inner
        self.addr = getattr(inner, "addr", None)
        self.relays = list(relays)
        self.session_id = int(session_id)
        self.peer_id = int(peer_id)
        self._clock = clock if clock is not None else _time.monotonic
        self.metrics = metrics if metrics is not None else null_metrics
        self.hello_interval = float(hello_interval)
        self.relay_timeout = float(relay_timeout)

        self._idx = 0
        self.relay_addr = self.relays[0]
        self.epoch: Optional[int] = None
        self._epoch_dirty = False
        now = self._clock()
        self._last_welcome = now  # grace: don't fail over before first probe
        self._last_hello = float("-inf")
        self._backoff = self.relay_timeout
        self.failovers = 0

    # ------------------------------------------------------------------

    def consume_epoch_change(self) -> bool:
        """True once per relay-instance change (restart or failover) —
        publishers force a keyframe on it, because the new instance's
        stream buffer holds none of the delta chain's bases."""
        dirty, self._epoch_dirty = self._epoch_dirty, False
        return dirty

    def _hello(self, now: float) -> None:
        if now - self._last_hello < self.hello_interval:
            return
        self._last_hello = now
        self.inner.send_to(
            proto.encode(proto.RelayHello(self.session_id, self.peer_id)),
            self.relay_addr,
        )

    def _failover(self, now: float) -> None:
        self._idx = (self._idx + 1) % len(self.relays)
        self.relay_addr = self.relays[self._idx]
        self.failovers += 1
        self.metrics.count("relay_failovers")
        # Grace period on the new relay grows exponentially while the whole
        # list stays silent (total outage), resetting on the next welcome —
        # the endpoint sync-retry discipline applied to relay selection.
        self._last_welcome = now + self._backoff - self.relay_timeout
        self._backoff = min(self._backoff * 2.0, FAILOVER_BACKOFF_MAX)
        self._last_hello = float("-inf")  # re-handshake immediately
        self._hello(now)

    # -- NonBlockingSocket ----------------------------------------------

    def send_to(self, data: bytes, addr) -> None:
        if addr == RELAY_CONTROL:
            self.inner.send_to(data, self.relay_addr)
            return
        if isinstance(addr, tuple) and len(addr) == 2 and addr[0] == "relay-peer":
            env = proto.RelayForward(self.peer_id, int(addr[1]), bytes(data))
            self.inner.send_to(proto.encode(env), self.relay_addr)
            return
        # Direct (non-relayed) addresses pass through untouched, so mixed
        # topologies (some peers direct, some behind the relay) just work.
        self.inner.send_to(data, addr)

    def receive_all(self) -> List[Tuple[object, bytes]]:
        now = self._clock()
        self._hello(now)
        out: List[Tuple[object, bytes]] = []
        for addr, data in self.inner.receive_all():
            if addr not in self.relays:
                out.append((addr, data))
                continue
            msg = proto.decode(data)
            if isinstance(msg, proto.RelayWelcome):
                if addr != self.relay_addr:
                    continue  # stale welcome from a relay we already left
                self._last_welcome = now
                self._backoff = self.relay_timeout
                if self.epoch != msg.epoch:
                    if self.epoch is not None:
                        self._epoch_dirty = True
                        self.metrics.count("relay_epoch_changes")
                    self.epoch = msg.epoch
                continue
            if isinstance(msg, proto.RelayForward):
                self._last_welcome = max(self._last_welcome, now)
                out.append((peer_addr(msg.src), msg.payload))
                continue
            # Anything else from a relay address is surfaced verbatim
            # (future relay-side control traffic degrades to "ignored").
            out.append((addr, data))
        if now - self._last_welcome > self.relay_timeout:
            self._failover(now)
        return out

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
