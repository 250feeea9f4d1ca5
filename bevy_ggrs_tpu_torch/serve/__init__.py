"""Batched multi-session serving: one batched tick, S concurrent matches.

Counterpart of ``bevy_ggrs_tpu/serve``. ``serve.batch`` holds the
session-axis core — :class:`BatchedTickExecutor` (the fused tick over a
leading slot axis, one checksum launch a burst step for all S slots) and
:class:`BatchedSessionCore` (fixed-capacity slot lifecycle + the per-slot
speculation host logic). ``serve.server`` drives it: :class:`MatchServer`
multiplexes per-match sessions into slots, staggers group ticks across
the frame, and exposes the occupancy/jitter gauges the flight recorder
captures. ``serve.faults`` is the containment layer: typed
:class:`SlotFault`, the per-slot :class:`SlotHealthFSM`, singleton
:class:`RecoveryLane` drains, and :class:`ServerCheckpointer`
crash-restart.
"""

from bevy_ggrs_tpu_torch.serve.admission import (
    STAGES as ADMISSION_STAGES,
    AdmissionTrace,
    admission_key,
)
from bevy_ggrs_tpu_torch.serve.batch import BatchedSessionCore, BatchedTickExecutor
from bevy_ggrs_tpu_torch.serve.faults import (
    RecoveryLane,
    ServerCheckpointer,
    SlotFault,
    SlotHealth,
    SlotHealthFSM,
    SlotTicket,
    load_checkpoint_matches,
    pack_match_record,
    unpack_match_record,
)
from bevy_ggrs_tpu_torch.serve.server import MatchHandle, MatchServer

__all__ = [
    "ADMISSION_STAGES",
    "AdmissionTrace",
    "BatchedSessionCore",
    "admission_key",
    "BatchedTickExecutor",
    "MatchHandle",
    "MatchServer",
    "RecoveryLane",
    "ServerCheckpointer",
    "SlotFault",
    "SlotHealth",
    "SlotHealthFSM",
    "SlotTicket",
    "load_checkpoint_matches",
    "pack_match_record",
    "unpack_match_record",
]
