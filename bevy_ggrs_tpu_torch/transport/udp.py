"""Non-blocking UDP socket (``UdpNonBlockingSocket`` analog, bevy_ggrs
``examples/box_game/box_game_p2p.rs:57``).

Counterpart of ``bevy_ggrs_tpu/transport/udp.py``, pure Python: one
``recvfrom`` per datagram. The JAX package can drain through a native
``recvmmsg`` poller; the port's copy of that poller is not written yet
(ROADMAP.md, port queue item 3, 'The native C++ data plane'), so
``use_native=True`` raises instead of falling back.
"""

from __future__ import annotations

import socket
from typing import List, Tuple

_MAX_DGRAM = 65536


class UdpSocket:
    def __init__(self, port: int, host: str = "0.0.0.0", use_native: bool = False):
        if use_native:
            raise NotImplementedError(
                "the native UDP poller is not ported yet (ROADMAP.md, port "
                "queue item 3: 'The native C++ data plane')"
            )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind((host, port))

    @classmethod
    def bind_to_port(cls, port: int) -> "UdpSocket":
        return cls(port)

    def send_to(self, msg: bytes, addr: Tuple[str, int]) -> None:
        try:
            self._sock.sendto(msg, addr)
        except (BlockingIOError, InterruptedError):
            pass  # non-blocking contract: drop on transient backpressure

    def receive_all(self) -> List[Tuple[Tuple[str, int], bytes]]:
        out = []
        while True:
            try:
                msg, addr = self._sock.recvfrom(_MAX_DGRAM)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            out.append((addr, msg))
        return out

    def local_port(self) -> int:
        """The bound local port — the way a socket constructed with port 0
        (kernel-assigned ephemeral) learns its own address to advertise."""
        return self._sock.getsockname()[1]

    def close(self) -> None:
        self._sock.close()
