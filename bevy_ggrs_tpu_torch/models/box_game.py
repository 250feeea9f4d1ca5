"""box_game: the reference's example game, as a PyTorch step.

Counterpart of ``bevy_ggrs_tpu/models/box_game.py``: each player's cube
accelerates on exclusive key presses, gets friction when neither key of a
pair is held, is speed-clamped to ``MAX_SPEED``, integrates into its
translation and is clamped to the plane; a ``frame_count`` resource counts
frames. Every operation is one correctly rounded float32 operation, in the
JAX step's order, so the two are bitwise equal on the CPU and on a GPU;
:func:`step_np` is the NumPy oracle for both.

The systems take a world with leading axes as well: a ``[B, capacity]``
world (the speculative rollout's branches, where JAX vmaps the step) with
``bits[B, players]``, each branch reading its own inputs. Every operation
is elementwise, so each branch's bits equal the single world's step.
Both systems are entity-local: under entity sharding each rank steps its
own rows (``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops.exact import sqrt_f32
from bevy_ggrs_tpu_torch.parallel.sharding import entity_local
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
    fused multiply-add would change bits), and the root is
    :func:`~bevy_ggrs_tpu_torch.ops.exact.sqrt_f32`: torch's vectorised
    float32 ``sqrt`` on the CPU is off by an ulp for some inputs."""
    return sqrt_f32(vx * vx + vy * vy + vz * vz)


@entity_local
def move_cube_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """All cubes in one masked update; non-player and dead slots pass
    through unchanged. Over leading axes (``[..., capacity]``), each world
    reads its own ``bits[..., players]``."""
    t = state.components["translation"]
    v = state.components["velocity"]
    handle = state.components["player_handle"]

    safe_handle = handle.clamp(0, inputs.num_players - 1).long()
    inp = torch.gather(inputs.bits, -1, safe_handle).to(torch.int32)  # [..., capacity]

    up = (inp & INPUT_UP) != 0
    down = (inp & INPUT_DOWN) != 0
    left = (inp & INPUT_LEFT) != 0
    right = (inp & INPUT_RIGHT) != 0

    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
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

    tx = torch.clamp(t[..., 0] + vx, -_HALF, _HALF)
    ty = t[..., 1] + vy
    tz = torch.clamp(t[..., 2] + vz, -_HALF, _HALF)

    new_t = torch.stack([tx, ty, tz], dim=-1)
    new_v = torch.stack([vx, vy, vz], dim=-1)

    sel = (
        state.alive
        & state.present["player_handle"]
        & state.present["translation"]
        & state.present["velocity"]
        & (handle >= 0)
    )[..., None]
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


@entity_local
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


# ---------------------------------------------------------------------------
# NumPy twin (the bit-exact determinism oracle)
# ---------------------------------------------------------------------------


def move_cubes_np(
    translation: np.ndarray,
    velocity: np.ndarray,
    handles: np.ndarray,
    mask: np.ndarray,
    input_bits: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`move_cube_system` in NumPy, one cube at a time: every
    operation one float32 operation, in the step's order."""
    t = translation.astype(np.float32).copy()
    v = velocity.astype(np.float32).copy()
    speed = np.float32(MOVEMENT_SPEED)
    friction = np.float32(FRICTION)
    max_speed = np.float32(MAX_SPEED)
    half = np.float32((PLANE_SIZE - CUBE_SIZE) * 0.5)
    for i in np.flatnonzero(mask):
        inp = int(input_bits[int(handles[i])])
        up, down = inp & INPUT_UP, inp & INPUT_DOWN
        left, right = inp & INPUT_LEFT, inp & INPUT_RIGHT
        vx, vy, vz = v[i, 0], v[i, 1], v[i, 2]
        if up and not down:
            vz = vz - speed
        if down and not up:
            vz = vz + speed
        if not up and not down:
            vz = vz * friction
        if left and not right:
            vx = vx - speed
        if right and not left:
            vx = vx + speed
        if not left and not right:
            vx = vx * friction
        vy = vy * friction
        mag = np.float32(np.sqrt(vx * vx + vy * vy + vz * vz))
        if mag > max_speed:
            factor = max_speed / mag
            vx, vy, vz = vx * factor, vy * factor, vz * factor
        tx = min(max(t[i, 0] + vx, -half), half)
        ty = t[i, 1] + vy
        tz = min(max(t[i, 2] + vz, -half), half)
        t[i] = [tx, ty, tz]
        v[i] = [vx, vy, vz]
    return t, v


def step_np(host: Dict[str, np.ndarray], input_bits: np.ndarray) -> Dict[str, np.ndarray]:
    """One frame of box_game on host arrays (the dict layout of
    ``state.to_host``): the oracle the step is held to, bitwise."""
    mask = (
        host["alive"]
        & host["present"]["player_handle"]
        & host["present"]["translation"]
        & host["present"]["velocity"]
        & (host["components"]["player_handle"] >= 0)
    )
    t, v = move_cubes_np(
        host["components"]["translation"],
        host["components"]["velocity"],
        host["components"]["player_handle"],
        mask,
        input_bits,
    )
    return {
        **host,
        "components": {**host["components"], "translation": t, "velocity": v},
        "resources": {
            **host["resources"],
            "frame_count": np.uint32(host["resources"]["frame_count"] + np.uint32(1)),
        },
    }
