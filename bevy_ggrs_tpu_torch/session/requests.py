"""The Save/Load/Advance request protocol.

``advance_frame()`` on every session flavor returns an ordered list of these;
the driver MUST execute them in order (`/root/reference/src/ggrs_stage.rs:
259-269`). The driver may fuse a ``[Load?, (Save, Advance)*]`` run into one
device rollout (see :class:`bevy_ggrs_tpu_torch.rollout.RolloutExecutor`) — the
observable semantics are identical to serial execution.

Request invariants (the compatibility contract, survey §7 "hard parts"):
- ``SaveGameState.frame`` always equals the driver's current frame
  (`ggrs_stage.rs:277`'s ``assert_eq!``): saves are labeled pre-advance.
- ``AdvanceFrame`` increments the driver frame by one (`ggrs_stage.rs:305`).
- ``LoadGameState.frame`` targets a frame still in the ring (within
  ``max_prediction`` of current — guaranteed by the protocol).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SaveGameState:
    """Snapshot the current world, labeled ``frame``; report the checksum
    back to the session via ``session.report_checksum(frame, cs)`` (the
    ``GameStateCell::save(frame, None, Some(checksum))`` analog,
    `ggrs_stage.rs:282-283`)."""

    frame: int


@dataclasses.dataclass(frozen=True)
class LoadGameState:
    """Roll back: restore the world saved as ``frame`` and set the driver
    frame to it (`ggrs_stage.rs:290-299`)."""

    frame: int


@dataclasses.dataclass(frozen=True)
class RestoreGameState:
    """Adopt an externally supplied world (supervisor state transfer, not
    the ring): set the driver frame to ``frame``, replace the device state
    with ``state``, and re-seed the snapshot ring from it. Outside the
    reference's request vocabulary — ggrs stops at DesyncDetected; this is
    the repair path (docs/chaos.md). Unlike ``LoadGameState`` there is no
    within-``max_prediction`` bound: the adopted frame replaces history
    rather than rewinding into it."""

    frame: int
    state: object  # WorldState


@dataclasses.dataclass(frozen=True)
class AdvanceFrame:
    """Run one simulated frame with these per-player inputs
    (`ggrs_stage.rs:301-306`). ``bits[p]`` payload, ``status[p]`` ∈
    {CONFIRMED, PREDICTED, DISCONNECTED}."""

    bits: np.ndarray  # [num_players, *input_shape]
    status: np.ndarray  # int32[num_players]

    def __post_init__(self):
        object.__setattr__(self, "bits", np.asarray(self.bits))
        object.__setattr__(
            self, "status", np.asarray(self.status, dtype=np.int32)
        )
