"""Transport layer (L0′): non-blocking datagram sockets for peer I/O.

Counterpart of ``bevy_ggrs_tpu/transport``. The reference rides ggrs's ``NonBlockingSocket`` trait with a UDP
implementation (`bevy_ggrs/examples/box_game/box_game_p2p.rs:57`
``UdpNonBlockingSocket::bind_to_port``). Peer traffic is tiny (input bitmasks
+ protocol chatter) and latency-bound, so it stays on the host CPU, never
on the card. Implementations:

- :class:`UdpSocket` — real UDP, non-blocking, for actual multi-host play.
- :class:`ReliableSocket` — ack-driven retransmit + idempotent dedup for
  the fleet control plane's migration frames (types 18-21), selective by
  type byte so heartbeats stay fire-and-forget.
- :class:`LoopbackNetwork` / :class:`LoopbackSocket` — deterministic
  in-memory transport with virtual time, configurable latency, jitter, and
  seeded packet loss: the injection seam the reference lacks (survey §4
  explicitly calls for it) enabling multi-peer tests in one process.
- :class:`UdpSocket`'s receive loop is the native ``recvmmsg`` poller by
  default (``bevy_ggrs_tpu_torch/native/udp_poller.cpp``, built at first
  use); ``use_native=False`` or ``GGRS_NO_NATIVE=1`` refuse it and select
  the Python socket.
"""

from bevy_ggrs_tpu_torch.transport.socket import NonBlockingSocket
from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork, LoopbackSocket
from bevy_ggrs_tpu_torch.transport.udp import UdpSocket
from bevy_ggrs_tpu_torch.transport.reliable import ReliableSocket
