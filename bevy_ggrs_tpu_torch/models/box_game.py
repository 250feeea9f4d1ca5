"""box_game: the reference's example game, as a PyTorch step.

Counterpart of ``bevy_ggrs_tpu/models/box_game.py``: each player's cube
accelerates on exclusive key presses, gets friction when neither key of a
pair is held, is speed-clamped to ``MAX_SPEED``, integrates into its
translation and is clamped to the plane; a ``frame_count`` resource counts
frames. Every operation is one correctly rounded float32 operation, in the
JAX step's order, so the two are bitwise equal on the CPU and on a GPU
(the JAX package's ``step_np`` is the NumPy oracle for both).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bevy_ggrs_tpu_torch.schedule import InputSpec, PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import HostWorld, TypeRegistry, WorldState, resolve_device

# Input bitmask.
INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3

# Physics constants.
MOVEMENT_SPEED = 0.005
MAX_SPEED = 0.05
FRICTION = 0.9
PLANE_SIZE = 5.0
CUBE_SIZE = 0.2

# The float32 values the JAX step uses, as Python floats (exact).
_SPEED = float(np.float32(MOVEMENT_SPEED))
_FRICTION = float(np.float32(FRICTION))
_MAX_SPEED = float(np.float32(MAX_SPEED))
_HALF = float(np.float32((PLANE_SIZE - CUBE_SIZE) * 0.5))

# 4 movement bits -> value universe 0..15.
INPUT_SPEC = InputSpec(shape=(), dtype=torch.uint8, values=tuple(range(16)))


def make_registry() -> TypeRegistry:
    """The rollback type registrations of the box_game example."""
    reg = TypeRegistry()
    reg.register_component("translation", shape=(3,), dtype=torch.float32)
    reg.register_component("velocity", shape=(3,), dtype=torch.float32)
    reg.register_component("player_handle", shape=(), dtype=torch.int32, default=-1)
    reg.register_resource("frame_count", np.uint32(0))
    return reg


def spawn_players(world: HostWorld, num_players: int, next_id=None) -> None:
    """Spawn one rollback-tagged cube per player on the setup circle.
    ``next_id`` hands out unique rollback ids."""
    if next_id is None:
        counter = iter(range(num_players))
        next_id = lambda: next(counter)
    r = PLANE_SIZE / 4.0
    for handle in range(num_players):
        rot = handle / num_players * 2.0 * math.pi
        world.spawn(
            {
                "translation": np.array(
                    [r * math.cos(rot), CUBE_SIZE / 2.0, r * math.sin(rot)],
                    dtype=np.float32,
                ),
                "velocity": np.zeros(3, dtype=np.float32),
                "player_handle": handle,
            },
            rollback_id=next_id(),
        )


def make_world(num_players: int, capacity: int = 16, device=None) -> HostWorld:
    """The staged box_game world; it commits to ``device`` (default
    ``cuda``, raising when there is no GPU)."""
    world = HostWorld(make_registry(), capacity, device=resolve_device(device))
    spawn_players(world, num_players)
    return world


def _magnitude(vx: torch.Tensor, vy: torch.Tensor, vz: torch.Tensor) -> torch.Tensor:
    """``sqrt(vx*vx + vy*vy + vz*vz)`` with every operation correctly
    rounded in float32. Products and sums stay separate operations (a
    fused multiply-add would change bits), and the root is taken in
    float64 and rounded once: torch's vectorised float32 ``sqrt`` on the
    CPU is off by an ulp for some inputs, while a float64 root rounded to
    float32 equals the correctly rounded float32 root."""
    return torch.sqrt((vx * vx + vy * vy + vz * vz).double()).float()


def move_cube_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """All cubes in one masked update; non-player and dead slots pass
    through unchanged."""
    t = state.components["translation"]
    v = state.components["velocity"]
    handle = state.components["player_handle"]

    safe_handle = handle.clamp(0, inputs.num_players - 1).long()
    inp = inputs.bits[safe_handle].to(torch.int32)  # [capacity]

    up = (inp & INPUT_UP) != 0
    down = (inp & INPUT_DOWN) != 0
    left = (inp & INPUT_LEFT) != 0
    right = (inp & INPUT_RIGHT) != 0

    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    # Exclusive press accelerates; neither pressed -> friction; both -> as-is.
    vz = torch.where(up & ~down, vz - _SPEED, vz)
    vz = torch.where(down & ~up, vz + _SPEED, vz)
    vz = torch.where(~up & ~down, vz * _FRICTION, vz)
    vx = torch.where(left & ~right, vx - _SPEED, vx)
    vx = torch.where(right & ~left, vx + _SPEED, vx)
    vx = torch.where(~left & ~right, vx * _FRICTION, vx)
    vy = vy * _FRICTION

    mag = _magnitude(vx, vy, vz)
    # A tensor numerator: ``scalar / tensor`` is ``reciprocal(t) * scalar``
    # in torch, two roundings where JAX has one.
    factor = torch.where(mag > _MAX_SPEED, torch.full_like(mag, _MAX_SPEED) / mag,
                         torch.ones_like(mag))
    vx, vy, vz = vx * factor, vy * factor, vz * factor

    tx = torch.clamp(t[:, 0] + vx, -_HALF, _HALF)
    ty = t[:, 1] + vy
    tz = torch.clamp(t[:, 2] + vz, -_HALF, _HALF)

    new_t = torch.stack([tx, ty, tz], dim=1)
    new_v = torch.stack([vx, vy, vz], dim=1)

    sel = (
        state.alive
        & state.present["player_handle"]
        & state.present["translation"]
        & state.present["velocity"]
        & (handle >= 0)
    )[:, None]
    return state.replace(
        components={
            **state.components,
            "translation": torch.where(sel, new_t, t),
            "velocity": torch.where(sel, new_v, v),
        }
    )


def increment_u32(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a ``uint32`` tensor (wrapping), through an ``int32``
    view: torch's ``uint32`` has no arithmetic."""
    return (x.view(torch.int32) + 1).view(torch.uint32)


def increase_frame_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """Count simulated frames in the ``frame_count`` resource."""
    del inputs
    return state.replace(
        resources={
            **state.resources,
            "frame_count": increment_u32(state.resources["frame_count"]),
        }
    )


def make_schedule() -> Schedule:
    """The example's rollback schedule: move cubes, then count the frame."""
    return Schedule([move_cube_system, increase_frame_system])
