"""Boids flocking: the entity-count scaling model.

Counterpart of ``bevy_ggrs_tpu/models/boids.py`` on one device. All boids
couple through separation, alignment and cohesion; players steer flock
leaders with the same u8 bitmask as box_game. The pair interaction runs in
one of three hand-written kernels on a GPU, and in its plain version on
the CPU:

- ``kernel="pallas"``, dense: the f32 force kernel
  (:func:`bevy_ggrs_tpu_torch.ops.pairwise.pairwise_force_rows`);
- ``kernel="mxu"``, dense: the tensor-core kernels, the triangle
  (:func:`~bevy_ggrs_tpu_torch.ops.pairwise.pairwise_force_square_mxu_tri`)
  at 4,096 boids and more, the general one
  (:func:`~bevy_ggrs_tpu_torch.ops.pairwise.pairwise_force_rows_mxu2`)
  below;
- ``mode="grid"`` with either kernel: the neighbour grid
  (:mod:`bevy_ggrs_tpu_torch.ops.neighbor`), its per-cell sums in the cell
  kernel (:func:`~bevy_ggrs_tpu_torch.ops.cell_gather.cell_slot_forces`).

The paths are allclose to each other, not bitwise: a session uses one.

Every system also steps a world stacked over B speculative branches
(``[B, N, ...]``), as the speculative rollout runs it: each branch reads
its own ``bits[..., players]``, the force wrappers take the leading axis
(one launch for all B on the card), and branch ``b``'s result is bitwise
the step of its world alone. The path is chosen from the boid count ``N
= shape[-2]``, never from B, so a rollout and a serial burst always take
the same kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.models.box_game import increment_u32
from bevy_ggrs_tpu_torch.ops import neighbor
from bevy_ggrs_tpu_torch.ops import pairwise as pw
from bevy_ggrs_tpu_torch.ops.pairwise import (
    _squared,
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
    """One step of ``[..., N]`` worlds: ``[N]`` or ``[B, N]``."""
    pos = state.components["position"]  # [..., N, 2]
    vel = state.components["velocity"]
    leader = state.components["leader_handle"]
    active = (state.alive & state.present["position"]).to(torch.float32)  # [..., N]

    force = pairwise_fn(pos, vel, active)

    # Leader steering (player inputs), box_game-style exclusive keys; each
    # world reads its own bits[..., players].
    safe = leader.clamp(0, inputs.num_players - 1).long()
    bits = torch.gather(inputs.bits, -1, safe).to(torch.int32)
    is_leader = (leader >= 0) & state.alive
    steer_x = (((bits & INPUT_RIGHT) != 0).to(torch.float32)
               - ((bits & INPUT_LEFT) != 0).to(torch.float32))
    steer_y = (((bits & INPUT_DOWN) != 0).to(torch.float32)
               - ((bits & INPUT_UP) != 0).to(torch.float32))
    steer = torch.stack([steer_x, steer_y], dim=-1) * float(LEADER_STEER)
    force = force + torch.where(is_leader[..., None], steer, 0.0)

    new_vel = vel + force
    # Speed clamp to [MIN_SPEED, MAX_SPEED].
    speed = torch.sqrt((new_vel * new_vel).sum(dim=-1, keepdim=True))
    speed_safe = torch.clamp(speed, min=1e-6)
    clamped = torch.clamp(speed_safe, float(MIN_SPEED), float(MAX_SPEED))
    new_vel = new_vel * (clamped / speed_safe)

    new_pos = pos + new_vel
    # Toroidal wrap keeps the flock bounded without wall dynamics.
    half = float(WORLD_HALF)
    new_pos = torch.where(new_pos > half, new_pos - 2 * half, new_pos)
    new_pos = torch.where(new_pos < -half, new_pos + 2 * half, new_pos)

    sel = (state.alive & state.present["position"] & state.present["velocity"])[
        ..., None
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


def flock_system_mxu(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """:func:`flock_system` with the neighbourhood sums on the tensor
    cores. The dispatch is static by world size, as in JAX: the triangle
    kernel for the square all-vs-all case at 4,096 boids and more, the
    general kernel below, so every world size uses one float path. The
    size is ``shape[-2]``: under a branch axis ``shape[0]`` is B."""
    params = _kernel_params()

    def forces(pos, vel, active):
        if pos.shape[-2] >= 4096:
            return pw.pairwise_force_square_mxu_tri(pos, vel, active, **params)
        return pw.pairwise_force_rows_mxu2(pos, vel, pos, vel, active, active,
                                           **params)

    return _flock_step(state, inputs, forces)


# ---------------------------------------------------------------------------
# Grid mode: the same rules over the neighbour grid, O(N·(9K+S)) pairs.
# ---------------------------------------------------------------------------


def _flock_accumulate(dx, dy, d2, row, col):
    """Per-pair flocking terms, with the masks of
    :func:`pairwise_force_rows`: the same f32 d² thresholds and the same
    d ≈ 0 self-exclusion, so borderline pairs classify alike in both
    modes."""
    both = row["active"] * col["active"]
    is_self = (d2 < 1e-10).to(torch.float32)
    neigh = both * (d2 < _squared(NEIGHBOR_RADIUS)).to(torch.float32) * (1.0 - is_self)
    inv_d = torch.rsqrt(torch.clamp(d2, min=1e-12))
    close = neigh * (d2 < _squared(SEPARATION_RADIUS)).to(torch.float32)
    w = inv_d * close
    return (
        neigh,                                  # neighbour count
        dx * w, dy * w,                         # separation
        col["vx"] * neigh, col["vy"] * neigh,   # alignment sums
        col["px"] * neigh, col["py"] * neigh,   # cohesion sums
    )


def _flock_combine(sums, row):
    n, sx, sy, svx, svy, spx, spy = sums
    n_safe = torch.clamp(n, min=1.0)
    has = (n > 0).to(torch.float32)
    ws, wa, wc = float(W_SEPARATION), float(W_ALIGNMENT), float(W_COHESION)
    fx = (ws * sx + wa * (svx / n_safe - row["vx"]) * has
          + wc * (spx / n_safe - row["px"]) * has)
    fy = (ws * sy + wa * (svy / n_safe - row["vy"]) * has
          + wc * (spy / n_safe - row["py"]) * has)
    return (fx * row["active"], fy * row["active"])


FLOCK_PAIR_KERNEL = neighbor.PairKernel(
    radius=float(NEIGHBOR_RADIUS),
    out_dim=2,
    n_terms=7,
    accumulate=_flock_accumulate,
    combine=_flock_combine,
    row_feats=("vx", "vy"),
    col_feats=("vx", "vy"),
    name="flock",
    params=pw._launch_params(**_kernel_params()),
)


def grid_config(num_boids: int) -> neighbor.GridConfig:
    """The boids neighbour grid: cell edge ``NEIGHBOR_RADIUS`` over the
    ±``WORLD_HALF`` torus (spawn-spiral positions beyond it alias modulo G,
    false candidates that the radius mask rejects)."""
    return neighbor.default_grid_config(
        num_boids, float(NEIGHBOR_RADIUS), float(WORLD_HALF))


def _grid_forces(pos, vel, active, impl):
    return neighbor.interact(
        pos, active, FLOCK_PAIR_KERNEL,
        feats={"vx": vel[..., 0], "vy": vel[..., 1]},
        mode="grid", config=grid_config(pos.shape[-2]), impl=impl,
    )


def flock_system_grid(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """:func:`flock_system` over the neighbour grid, the per-cell sums in
    the cell kernel's plain version on any device."""
    return _flock_step(state, inputs, lambda p, v, a: _grid_forces(p, v, a, "xla"))


def flock_system_grid_pallas(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """:func:`flock_system` over the neighbour grid, the per-cell sums in
    the cell kernel (its plain version for a CPU state): the single-device
    path for tens of thousands of boids."""
    return _flock_step(state, inputs, lambda p, v, a: _grid_forces(p, v, a, "pallas"))


_DENSE_SYSTEMS = {"pallas": flock_system, "mxu": flock_system_mxu}


def make_schedule(kernel: str = "pallas", mode: Optional[str] = None) -> Schedule:
    """The boids schedule: flocking forces, then the frame count.

    ``kernel`` names the JAX package's kernel whose counterpart computes
    the dense forces: ``"pallas"`` (the f32 force kernel) or ``"mxu"``
    (the tensor-core kernels). ``mode`` picks the interaction structure:
    ``"dense"``, ``"grid"`` (either kernel then routes the per-cell sums
    through the cell kernel), ``"auto"`` (grid at
    ``neighbor.GRID_AUTO_THRESHOLD`` boids and more) or ``None`` (dense,
    unless ``GGRS_FORCE_MODE`` or the process default says otherwise); it
    resolves through :func:`bevy_ggrs_tpu_torch.ops.neighbor.resolve_mode`
    at every step. ``kernel="xla"``, whose purpose is partitioning across
    devices, waits for the port's sharding."""
    if kernel == "xla":
        raise NotImplementedError(
            "kernel='xla' exists for entity sharding, which is not ported "
            "yet (ROADMAP.md, port queue: 'Sharding')"
        )
    if kernel not in _DENSE_SYSTEMS:
        raise ValueError(f"unknown force kernel {kernel!r}")
    neighbor.resolve_mode(mode, 0)  # rejects an unknown mode now
    dense_system = _DENSE_SYSTEMS[kernel]

    def flock(state: WorldState, inputs: PlayerInputs) -> WorldState:
        n = state.components["position"].shape[-2]  # boids, whatever B
        grid = neighbor.resolve_mode(mode, n) == "grid"
        return (flock_system_grid_pallas if grid else dense_system)(state, inputs)

    return Schedule([flock, increase_frame_system])
