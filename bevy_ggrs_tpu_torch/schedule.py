"""Step engine: systems on tensors composed into a rollback schedule.

Counterpart of ``bevy_ggrs_tpu/schedule.py``. A system is a function
``(WorldState, PlayerInputs) -> WorldState``; a :class:`Schedule` runs its
systems in order, and one call is one simulated frame. Inputs are
positional per player: ``inputs.bits[player_handle]``, each with an input
status (confirmed / predicted / disconnected).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.state import WorldState, np_dtype, resolve_device

# ggrs::InputStatus (per player, per frame).
CONFIRMED = 0
PREDICTED = 1
DISCONNECTED = 2


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape and dtype of one player's input for one frame; ``values``
    optionally declares the input-value universe (e.g. ``range(16)`` for
    a 4-bit bitmask)."""

    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.uint8
    values: Optional[Tuple[int, ...]] = None

    def zeros(self, num_players: int, device=None) -> torch.Tensor:
        """Every player's zero input on ``device`` (default ``cuda``,
        raising when there is no GPU)."""
        return torch.zeros((num_players,) + self.shape, dtype=self.dtype,
                           device=resolve_device(device))

    def zeros_np(self, num_players: int) -> np.ndarray:
        return np.zeros((num_players,) + self.shape, dtype=np_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class PlayerInputs:
    """Inputs of all players for one simulated frame: ``bits[p]`` is
    player ``p``'s payload, ``status[p]`` its input status."""

    bits: torch.Tensor  # [num_players, *input_shape]; [B, num_players, ...] for branches
    status: torch.Tensor  # int32[num_players]; [B, num_players] for branches

    @property
    def num_players(self) -> int:
        return self.status.shape[-1]


def make_inputs(bits, status=None, device=None) -> PlayerInputs:
    """:class:`PlayerInputs` from ``bits`` (a tensor, or anything
    ``torch.as_tensor`` takes) and ``status`` (default: every player
    confirmed, ``int32[num_players]``), on ``device``: a tensor's own
    device when ``device`` is None, else the resolved one (``cuda``
    unless another is named)."""
    if device is None and isinstance(bits, torch.Tensor):
        device = bits.device
    device = resolve_device(device)
    bits = torch.as_tensor(bits, device=device)
    if status is None:
        status = torch.zeros((bits.shape[0],), dtype=torch.int32, device=device)
    return PlayerInputs(bits=bits, status=torch.as_tensor(status, dtype=torch.int32,
                                                          device=device))


System = Callable[[WorldState, PlayerInputs], WorldState]


class Schedule:
    """An ordered composition of systems: one simulated frame."""

    def __init__(self, systems: Sequence[System] = ()):
        self._systems = tuple(systems)

    def add_system(self, system: System) -> "Schedule":
        """Run ``system`` after the schedule's others; returns the schedule."""
        self._systems += (system,)
        return self

    @property
    def systems(self) -> Tuple[System, ...]:
        return self._systems

    def __call__(self, state: WorldState, inputs: PlayerInputs) -> WorldState:
        for system in self._systems:
            state = system(state, inputs)
        return state
