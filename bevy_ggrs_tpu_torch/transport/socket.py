"""The non-blocking socket interface (ggrs ``NonBlockingSocket`` trait
analog — the seam the survey (§4) identifies for injecting fake transports).

Counterpart of ``bevy_ggrs_tpu/transport/socket.py``.
"""

from __future__ import annotations

from typing import Any, List, Protocol, Tuple

Address = Any  # ("host", port) for UDP; any hashable for loopback


class NonBlockingSocket(Protocol):
    def send_to(self, msg: bytes, addr: Address) -> None:
        """Queue one datagram to ``addr``; never blocks."""
        ...

    def receive_all(self) -> List[Tuple[Address, bytes]]:
        """Drain every datagram that has arrived since the last call;
        never blocks."""
        ...
