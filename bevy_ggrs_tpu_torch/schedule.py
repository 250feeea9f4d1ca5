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

from bevy_ggrs_tpu_torch.state import WorldState, np_dtype

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

    def zeros_np(self, num_players: int) -> np.ndarray:
        return np.zeros((num_players,) + self.shape, dtype=np_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class PlayerInputs:
    """Inputs of all players for one simulated frame: ``bits[p]`` is
    player ``p``'s payload, ``status[p]`` its input status."""

    bits: torch.Tensor  # [num_players, *input_shape]
    status: torch.Tensor  # int32[num_players]

    @property
    def num_players(self) -> int:
        return self.status.shape[0]


System = Callable[[WorldState, PlayerInputs], WorldState]


class Schedule:
    """An ordered composition of systems: one simulated frame."""

    def __init__(self, systems: Sequence[System] = ()):
        self._systems = tuple(systems)

    def __call__(self, state: WorldState, inputs: PlayerInputs) -> WorldState:
        for system in self._systems:
            state = system(state, inputs)
        return state
