"""Deterministic in-memory transport with fault injection.

Counterpart of ``bevy_ggrs_tpu/transport/loopback.py``.

The reference's test story is "run two processes on localhost"
(`bevy_ggrs/examples/README.md:34-48`) — no fake transport, no mock
clock. This module is the upgrade the survey's §4 demands: every peer's
socket lives in one :class:`LoopbackNetwork` with a *virtual clock*, so
multi-peer sessions run deterministically inside one test process, and
latency / jitter / packet loss are injected from a seeded RNG
(ggrs-upstream keeps packet-loss simulation internal; here it is a
first-class test fixture).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np


class LoopbackNetwork:
    def __init__(
        self,
        latency: float = 0.0,
        jitter: float = 0.0,
        loss: float = 0.0,
        seed: int = 0,
    ):
        """``latency``/``jitter`` in virtual seconds; ``loss`` ∈ [0, 1) drops
        datagrams i.i.d. from a seeded RNG, so a failing run replays
        exactly."""
        self.latency = float(latency)
        self.jitter = float(jitter)
        self.loss = float(loss)
        self._rng = np.random.RandomState(seed)
        self.now = 0.0
        self._sockets: Dict[object, "LoopbackSocket"] = {}
        self._in_flight: List[Tuple[float, int, object, object, bytes]] = []
        self._seq = itertools.count()
        self.sent = 0
        self.dropped = 0

    def socket(self, addr: object) -> "LoopbackSocket":
        if addr in self._sockets:
            raise ValueError(f"address {addr!r} already bound")
        sock = LoopbackSocket(self, addr)
        self._sockets[addr] = sock
        return sock

    def _send(self, src: object, dst: object, msg: bytes) -> None:
        self.sent += 1
        if self.loss and self._rng.random_sample() < self.loss:
            self.dropped += 1
            return
        delay = self.latency
        if self.jitter:
            delay += float(self._rng.random_sample()) * self.jitter
        heapq.heappush(
            self._in_flight, (self.now + delay, next(self._seq), src, dst, msg)
        )

    def advance(self, dt: float) -> None:
        """Move the virtual clock and deliver every datagram whose arrival
        time has come (in send order among equal times)."""
        self.now += float(dt)
        while self._in_flight and self._in_flight[0][0] <= self.now:
            _, _, src, dst, msg = heapq.heappop(self._in_flight)
            sock = self._sockets.get(dst)
            if sock is not None:
                sock._inbox.append((src, msg))


class LoopbackSocket:
    def __init__(self, network: LoopbackNetwork, addr: object):
        self._network = network
        self.addr = addr
        self._inbox: List[Tuple[object, bytes]] = []

    def send_to(self, msg: bytes, addr: object) -> None:
        self._network._send(self.addr, addr, bytes(msg))

    def receive_all(self) -> List[Tuple[object, bytes]]:
        out, self._inbox = self._inbox, []
        return out

    def close(self) -> None:
        """Release the address (a crashed process's port closing); the
        address can then be re-bound by a restarted peer."""
        self._network._sockets.pop(self.addr, None)
