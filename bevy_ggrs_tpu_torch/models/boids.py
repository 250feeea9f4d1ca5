"""Boids flocking: the entity-count scaling model, dense interactions.

Counterpart of the dense part of ``bevy_ggrs_tpu/models/boids.py``. All
boids couple through separation, alignment and cohesion, an O(N²)
pairwise interaction per frame; players steer flock leaders with the same
u8 bitmask as box_game. The pairwise forces go through the hand-written
kernel (:func:`bevy_ggrs_tpu_torch.ops.pairwise.pairwise_force_rows`, the
counterpart of ``kernel="pallas"``) on a GPU and through its plain
version on the CPU. The matrix-unit kernels and grid mode are later parts
of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.models.box_game import increment_u32
from bevy_ggrs_tpu_torch.ops.pairwise import (
    pairwise_force_rows as pairwise_force_rows_kernel,
    pairwise_force_rows_plain,
)
from bevy_ggrs_tpu_torch.schedule import InputSpec, PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import HostWorld, TypeRegistry, WorldState, resolve_device

INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3

# 4 steering bits -> value universe 0..15.
INPUT_SPEC = InputSpec(shape=(), dtype=torch.uint8, values=tuple(range(16)))

# Flocking parameters (2D plane).
NEIGHBOR_RADIUS = 1.0
SEPARATION_RADIUS = 0.35
W_SEPARATION = np.float32(0.08)
W_ALIGNMENT = np.float32(0.05)
W_COHESION = np.float32(0.03)
LEADER_STEER = np.float32(0.02)
MAX_SPEED = np.float32(0.08)
MIN_SPEED = np.float32(0.02)
WORLD_HALF = np.float32(8.0)


def make_registry() -> TypeRegistry:
    reg = TypeRegistry()
    reg.register_component("position", shape=(2,), dtype=torch.float32)
    reg.register_component("velocity", shape=(2,), dtype=torch.float32)
    # Leader boids carry the player handle steering them; -1 = flock member.
    reg.register_component("leader_handle", shape=(), dtype=torch.int32, default=-1)
    reg.register_resource("frame_count", np.uint32(0))
    return reg


def make_world(
    num_boids: int,
    num_players: int,
    capacity: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> HostWorld:
    """``num_boids`` flock members on a deterministic spawn spiral; the
    first ``num_players`` of them are player-steered leaders. The world
    commits to ``device`` (default ``cuda``, raising when there is no
    GPU)."""
    capacity = num_boids if capacity is None else capacity
    world = HostWorld(make_registry(), capacity, device=resolve_device(device))
    spawn_flock(world, num_boids, num_players, seed)
    return world


def spawn_flock(world: HostWorld, num_boids: int, num_players: int,
                seed: int = 0) -> None:
    """Spawn the flock of :func:`make_world` into a staging world (the
    setup system of a boids app)."""
    rng = np.random.RandomState(seed)
    for i in range(num_boids):
        ang = i * 2.399963  # golden-angle spiral: deterministic, spread out
        rad = 0.15 * math.sqrt(i + 1)
        vel = rng.uniform(-0.03, 0.03, size=2).astype(np.float32)
        world.spawn(
            {
                "position": np.array(
                    [rad * math.cos(ang), rad * math.sin(ang)], dtype=np.float32
                ),
                "velocity": vel,
                "leader_handle": np.int32(i if i < num_players else -1),
            },
            rollback_id=i,
        )


def _kernel_params() -> dict:
    """The five flocking constants every force-kernel call shares, built in
    one place so the paths can never diverge on a tuning change."""
    return dict(
        neighbor_radius=float(NEIGHBOR_RADIUS),
        separation_radius=float(SEPARATION_RADIUS),
        w_separation=float(W_SEPARATION),
        w_alignment=float(W_ALIGNMENT),
        w_cohesion=float(W_COHESION),
    )


def pairwise_force_rows(
    row_pos: torch.Tensor,  # [R, 2]
    row_vel: torch.Tensor,  # [R, 2]
    all_pos: torch.Tensor,  # [N, 2]
    all_vel: torch.Tensor,  # [N, 2]
    row_active: torch.Tensor,  # float[R]
    all_active: torch.Tensor,  # float[N]
) -> torch.Tensor:
    """Separation/alignment/cohesion force on each row boid from all boids,
    in plain PyTorch on any device: the plain version of the force
    kernel with the model's constants."""
    return pairwise_force_rows_plain(
        row_pos, row_vel, all_pos, all_vel, row_active, all_active,
        **_kernel_params())


def _kernel_forces(pos, vel, active):
    return pairwise_force_rows_kernel(
        pos, vel, pos, vel, active, active, **_kernel_params())


def _flock_step(state: WorldState, inputs: PlayerInputs, pairwise_fn) -> WorldState:
    pos = state.components["position"]  # [N, 2]
    vel = state.components["velocity"]
    leader = state.components["leader_handle"]
    active = (state.alive & state.present["position"]).to(torch.float32)  # [N]

    force = pairwise_fn(pos, vel, active)

    # Leader steering (player inputs), box_game-style exclusive keys.
    safe = leader.clamp(0, inputs.num_players - 1).long()
    bits = inputs.bits[safe].to(torch.int32)
    is_leader = (leader >= 0) & state.alive
    steer_x = (((bits & INPUT_RIGHT) != 0).to(torch.float32)
               - ((bits & INPUT_LEFT) != 0).to(torch.float32))
    steer_y = (((bits & INPUT_DOWN) != 0).to(torch.float32)
               - ((bits & INPUT_UP) != 0).to(torch.float32))
    steer = torch.stack([steer_x, steer_y], dim=1) * float(LEADER_STEER)
    force = force + torch.where(is_leader[:, None], steer, 0.0)

    new_vel = vel + force
    # Speed clamp to [MIN_SPEED, MAX_SPEED].
    speed = torch.sqrt((new_vel * new_vel).sum(dim=1, keepdim=True))
    speed_safe = torch.clamp(speed, min=1e-6)
    clamped = torch.clamp(speed_safe, float(MIN_SPEED), float(MAX_SPEED))
    new_vel = new_vel * (clamped / speed_safe)

    new_pos = pos + new_vel
    # Toroidal wrap keeps the flock bounded without wall dynamics.
    half = float(WORLD_HALF)
    new_pos = torch.where(new_pos > half, new_pos - 2 * half, new_pos)
    new_pos = torch.where(new_pos < -half, new_pos + 2 * half, new_pos)

    sel = (state.alive & state.present["position"] & state.present["velocity"])[
        :, None
    ]
    return state.replace(
        components={
            **state.components,
            "position": torch.where(sel, new_pos, pos),
            "velocity": torch.where(sel, new_vel, vel),
        }
    )


def flock_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """One flocking step with the pairwise forces from the force kernel
    (its plain version for a CPU state), then leader steering and clamped
    integration."""
    return _flock_step(state, inputs, _kernel_forces)


def increase_frame_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    del inputs
    return state.replace(
        resources={
            **state.resources,
            "frame_count": increment_u32(state.resources["frame_count"]),
        }
    )


def make_schedule(kernel: str = "pallas", mode: Optional[str] = None) -> Schedule:
    """The boids schedule: dense flocking forces, then the frame count.

    ``kernel="pallas"`` names the JAX package's tiled force kernel, whose
    counterpart here is the CUDA force kernel. The matrix-unit kernels
    (``kernel="mxu"``) and the neighbour grid (``mode="grid"`` or
    ``"auto"``) are not ported yet."""
    if kernel == "mxu":
        raise NotImplementedError(
            "the matrix-unit force kernels are not ported yet (ROADMAP.md, "
            "port queue: 'Entity models and the grid')"
        )
    if kernel != "pallas":
        raise ValueError(f"unknown force kernel {kernel!r}")
    if mode not in (None, "dense"):
        raise NotImplementedError(
            f"interaction mode {mode!r} is not ported yet (ROADMAP.md, port "
            "queue: 'Entity models and the grid')"
        )
    return Schedule([flock_system, increase_frame_system])
