"""Seeded, deterministic fault injection on the real transport path.

Counterpart of ``bevy_ggrs_tpu/chaos/__init__.py``.

``transport/loopback.py`` can already drop/delay datagrams, but only inside
its own virtual network — the faults never exercise a real
``NonBlockingSocket``. This package wraps ANY socket (UDP included) in a
:class:`~bevy_ggrs_tpu_torch.chaos.socket.ChaosSocket` driven by a replayable
:class:`~bevy_ggrs_tpu_torch.chaos.plan.ChaosPlan`: scheduled loss bursts,
reordering, duplication, byte corruption, asymmetric partitions with heal
windows, and peer kill/restart scripts. Every fault a soak run finds is
reproducible from the plan's seed (docs/chaos.md).
"""

from bevy_ggrs_tpu_torch.chaos.plan import (
    BalancerPartition,
    ChaosPlan,
    CheckpointCorrupt,
    Corrupt,
    Duplicate,
    KillRestart,
    LossBurst,
    MigrateMatch,
    Partition,
    RelayKillRestart,
    RelayTreeKill,
    Reorder,
    ServerDrain,
    ServerKillRestart,
    ServerLoss,
    ServerSpawn,
    SnapshotCorrupt,
)
from bevy_ggrs_tpu_torch.chaos.socket import ChaosSocket

__all__ = [
    "BalancerPartition",
    "ChaosPlan",
    "ChaosSocket",
    "CheckpointCorrupt",
    "Corrupt",
    "Duplicate",
    "KillRestart",
    "LossBurst",
    "MigrateMatch",
    "Partition",
    "RelayKillRestart",
    "RelayTreeKill",
    "Reorder",
    "ServerDrain",
    "ServerKillRestart",
    "ServerLoss",
    "ServerSpawn",
    "SnapshotCorrupt",
]
