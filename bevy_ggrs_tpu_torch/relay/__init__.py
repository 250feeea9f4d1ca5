"""Relay transport tier + broadcast spectator fan-out.

Counterpart of ``bevy_ggrs_tpu/relay``, with the same exports: the client,
server, streams and fan-out tree are host code copied from the JAX
package; the state codec reads the card's snapshot rings.

The reference's networking is strictly peer-to-peer and its spectator
flavor strictly 1:1. This package adds the delivery tier production needs
(ROADMAP: "one match watched by 100k spectators"):

- :class:`~bevy_ggrs_tpu_torch.relay.server.RelayServer` — terminates peer
  traffic (NAT-friendly: everyone dials the relay) by forwarding opaque
  wire datagrams between registered peers, and fans the confirmed-state
  stream out to subscribers under per-subscriber flow control with a
  graceful degradation ladder (full deltas → keyframe-only → shed with a
  resumable cursor).
- :class:`~bevy_ggrs_tpu_torch.relay.client.RelaySocket` — a
  ``NonBlockingSocket`` giving sessions stable *logical* peer addresses
  through the relay, with transparent failover to standby relays.
- :class:`~bevy_ggrs_tpu_torch.relay.delta.StateCodec` + XOR/RLE delta codec —
  exact (bitwise) confirmed-state deltas; confirmed frames are
  bitwise-stable, so the stream needs no tolerance anywhere.
- :class:`~bevy_ggrs_tpu_torch.relay.stream.StatePublisher` /
  :class:`~bevy_ggrs_tpu_torch.relay.stream.StreamSpectator` — the host-side
  uploader (one stream up, N streams out) and the broadcast spectator
  that reconstructs every confirmed frame bitwise.

Contracts and the chaos-soak story live in docs/relay.md.
"""

from bevy_ggrs_tpu_torch.relay.client import RELAY_CONTROL, RelaySocket, peer_addr
from bevy_ggrs_tpu_torch.relay.delta import (
    StateCodec,
    delta_apply,
    delta_encode,
    payload_digest,
)
from bevy_ggrs_tpu_torch.relay.server import KeyframeCache, RelayServer
from bevy_ggrs_tpu_torch.relay.stream import StatePublisher, StreamSpectator
from bevy_ggrs_tpu_torch.relay.tree import (
    ProcRelayTier,
    RelayProcess,
    RelayTree,
    TierLink,
)

__all__ = [
    "RELAY_CONTROL",
    "KeyframeCache",
    "ProcRelayTier",
    "RelayProcess",
    "RelayServer",
    "RelaySocket",
    "RelayTree",
    "StateCodec",
    "StatePublisher",
    "StreamSpectator",
    "TierLink",
    "delta_apply",
    "delta_encode",
    "payload_digest",
    "peer_addr",
]
