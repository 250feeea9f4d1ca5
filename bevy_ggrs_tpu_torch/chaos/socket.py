"""ChaosSocket: fault-injecting wrapper over any ``NonBlockingSocket``.

Counterpart of ``bevy_ggrs_tpu/chaos/socket.py``.

Sits between a session and its real socket (loopback OR UDP) and applies the
plan's directives to OUTGOING datagrams: partition drops, probabilistic
loss, single-bit corruption, duplication, and reorder-by-delay. Injecting on
send keeps the wrapper transport-agnostic (no peeking into a kernel receive
queue) while still exercising the receiver's real code paths — a corrupted
datagram really crosses the wire and really hits ``protocol.decode``.

Determinism: each socket derives its RNG from ``plan.seed ^ crc32(addr)``,
so a multi-peer harness re-run with the same plan and same traffic pattern
replays the identical fault sequence; every injected fault is appended to
``faults`` as ``(time, kind, dst)`` for assertion/inspection.
"""

from __future__ import annotations

import time as _time
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np

from bevy_ggrs_tpu_torch.chaos.plan import (
    ChaosPlan,
    Corrupt,
    Duplicate,
    LossBurst,
    Reorder,
)


class ChaosSocket:
    def __init__(
        self,
        inner,
        plan: ChaosPlan,
        clock: Optional[Callable[[], float]] = None,
        addr=None,
    ):
        self.inner = inner
        self.plan = plan
        self._clock = clock if clock is not None else _time.monotonic
        # Identity for Partition matching + RNG derivation. Loopback sockets
        # carry .addr; for UDP pass the local (host, port) explicitly.
        self.addr = addr if addr is not None else getattr(inner, "addr", None)
        self._rng = np.random.RandomState(
            (int(plan.seed) ^ zlib.crc32(repr(self.addr).encode()))
            & 0x7FFFFFFF
        )
        # Reordered datagrams: (due_time, seq, data, dst). seq keeps sort
        # stable for equal due times.
        self._held: List[Tuple[float, int, bytes, object]] = []
        self._seq = 0
        # Injected-fault log: (time, kind, dst) — the replay-determinism
        # witness (two runs of one plan produce identical lists).
        self.faults: List[Tuple[float, str, object]] = []

    # ------------------------------------------------------------------

    def _flush_held(self, now: float) -> None:
        if not self._held:
            return
        due = [h for h in self._held if h[0] <= now]
        if not due:
            return
        self._held = [h for h in self._held if h[0] > now]
        for _, _, data, dst in sorted(due):
            self.inner.send_to(data, dst)

    def send_to(self, data: bytes, addr) -> None:
        now = self._clock()
        self._flush_held(now)

        if self.plan.partitioned(self.addr, addr, now):
            self.faults.append((now, "partition", addr))
            return
        for d in self.plan.active(LossBurst, now):
            if self._rng.random_sample() < d.rate:
                self.faults.append((now, "loss", addr))
                return
        for d in self.plan.active(Corrupt, now):
            if self._rng.random_sample() < d.rate:
                buf = bytearray(data)
                if buf:
                    i = int(self._rng.randint(0, len(buf)))
                    buf[i] ^= 1 << int(self._rng.randint(0, 8))
                data = bytes(buf)
                self.faults.append((now, "corrupt", addr))
                break
        dup = False
        for d in self.plan.active(Duplicate, now):
            if self._rng.random_sample() < d.rate:
                dup = True
                self.faults.append((now, "duplicate", addr))
                break
        for d in self.plan.active(Reorder, now):
            if self._rng.random_sample() < d.rate:
                self.faults.append((now, "reorder", addr))
                self._held.append((now + d.delay, self._seq, bytes(data), addr))
                self._seq += 1
                if dup:  # the duplicate ships now, the original late
                    self.inner.send_to(data, addr)
                return
        self.inner.send_to(data, addr)
        if dup:
            self.inner.send_to(data, addr)

    def receive_all(self):
        # Receives also flush: a peer that stops sending (e.g. while
        # quarantined) must still release its held reorder queue.
        self._flush_held(self._clock())
        return self.inner.receive_all()

    def close(self) -> None:
        self._held.clear()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
