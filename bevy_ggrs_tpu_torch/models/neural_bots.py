"""Neural bots: agents steered by a learned int8 MLP policy.

Counterpart of ``bevy_ggrs_tpu/models/neural_bots.py``. Every bot steers
by a shared small MLP, ``obs[cap, 8] @ W1[8, H] -> tanh -> @ W2[H, 4]``,
evaluated for all capacity slots each simulated frame; players move the
target points the bots pursue with box_game's bitmask keys. The policy's
int8 weights and float32 biases are a rollback resource (a dict), rolled
back and hashed with everything else.

Every reduction over a variable-length axis is integer, as in the
reference: the two products are int8 x int8 with exact int32 sums
(:func:`bevy_ggrs_tpu_torch.ops.exact.int_matmul`), and the flock centroid
accumulates in Q8.8 fixed point. So a ``[B]`` world's products, with the
policy a per-branch resource (``[B, cap, 8] x [B, 8, H]``), are bitwise
each branch's own. The float work is elementwise or a fixed 2-term sum,
written op by op in the order of the JAX step run eagerly (unjitted),
each operation rounded once: ``tanh`` is XLA:CPU's own approximation
(:func:`~bevy_ggrs_tpu_torch.ops.exact.tanh_f32`), roots are
:func:`~bevy_ggrs_tpu_torch.ops.exact.sqrt_f32`, and every division by a
constant divides by a tensor on the world's device (torch on CUDA turns a
division by a host scalar into a product with its reciprocal). The jitted
JAX step contracts ``vel + accel * ACCEL_SCALE`` and the squared norms
into FMAs on the CPU and so differs from its own unjitted step in the last
bits; the port matches the unjitted one.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.models.box_game import increment_u32
from bevy_ggrs_tpu_torch.ops.exact import int_matmul, sqrt_f32, tanh_f32
from bevy_ggrs_tpu_torch.schedule import InputSpec, PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import HostWorld, TypeRegistry, WorldState, resolve_device

INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3

# 4 command bits -> value universe 0..15.
INPUT_SPEC = InputSpec(shape=(), dtype=torch.uint8, values=tuple(range(16)))

OBS_DIM = 8
HIDDEN = 32
ACT_DIM = 4

MAX_PLAYERS = 8

TARGET_SPEED = np.float32(0.12)
ACCEL_SCALE = np.float32(0.02)
MAX_SPEED = np.float32(0.15)
WORLD_HALF = np.float32(6.0)

# Fixed-point scales: part of the game's content.
QA = np.float32(127.0)
QW = np.float32(64.0)
POS_Q = np.float32(256.0)
# Per-feature observation bounds (velocity 2, to_target 2, dist 1,
# to_centroid 2, bias 1).
OBS_NORM = np.array([0.15, 0.15, 12.0, 12.0, 17.0, 12.0, 12.0, 1.0], np.float32)


def make_policy_params(seed: int = 0, hidden: int = HIDDEN):
    """Deterministic int8-quantized MLP weights (the fixed seed is part of
    the game's content), quantized once, here: bitwise the JAX package's."""
    rng = np.random.RandomState(seed)
    scale1 = 1.0 / math.sqrt(OBS_DIM)
    scale2 = 1.0 / math.sqrt(hidden)

    def q(w):
        return np.clip(np.round(w * QW), -127, 127).astype(np.int8)

    return {
        "w1": q(rng.randn(OBS_DIM, hidden) * scale1),
        "b1": np.zeros((hidden,), np.float32),
        "w2": q(rng.randn(hidden, ACT_DIM) * scale2),
        "b2": np.zeros((ACT_DIM,), np.float32),
    }


def make_registry(hidden: int = HIDDEN) -> TypeRegistry:
    reg = TypeRegistry()
    reg.register_component("position", shape=(2,), dtype=torch.float32)
    reg.register_component("velocity", shape=(2,), dtype=torch.float32)
    # Which player's target this bot pursues.
    reg.register_component("team", shape=(), dtype=torch.int32, default=0)
    # Per-player target points.
    reg.register_resource("targets", np.zeros((MAX_PLAYERS, 2), np.float32))
    reg.register_resource("policy", make_policy_params(hidden=hidden))
    reg.register_resource("frame_count", np.uint32(0))
    return reg


def spawn_bots(world: HostWorld, num_bots: int, num_players: int, seed: int = 0) -> None:
    """Spawn :func:`make_world`'s bots and set the players' targets on a
    circle (the setup system of a neural_bots app)."""
    if not 1 <= num_players <= MAX_PLAYERS:
        raise ValueError(
            f"neural_bots supports 1..{MAX_PLAYERS} players "
            f"(fixed-shape targets resource), got {num_players}")
    rng = np.random.RandomState(seed)
    for i in range(num_bots):
        ang = i * 2.399963
        rad = 0.2 * math.sqrt(i + 1)
        world.spawn(
            {
                "position": np.array([rad * math.cos(ang), rad * math.sin(ang)], np.float32),
                "velocity": rng.uniform(-0.02, 0.02, 2).astype(np.float32),
                "team": np.int32(i % num_players),
            },
            rollback_id=i,
        )
    targets = np.zeros((MAX_PLAYERS, 2), np.float32)
    for p in range(num_players):
        ang = 2 * math.pi * p / num_players
        targets[p] = [3.0 * math.cos(ang), 3.0 * math.sin(ang)]
    world.set_resource("targets", targets)


def make_world(num_bots: int, num_players: int, capacity: Optional[int] = None,
               seed: int = 0, hidden: int = HIDDEN, device=None) -> HostWorld:
    """``num_bots`` bots on a spiral, teams in turn; the world commits to
    ``device`` (default ``cuda``, raising when there is no GPU)."""
    capacity = num_bots if capacity is None else capacity
    world = HostWorld(make_registry(hidden), capacity, device=resolve_device(device))
    spawn_bots(world, num_bots, num_players, seed)
    return world


@functools.lru_cache(maxsize=None)
def _divisors(device: torch.device) -> dict:
    """The step's divisors as float32 tensors on ``device``, made once: a
    tensor divisor on the world's device is divided by, where torch on
    CUDA multiplies by a host scalar's reciprocal."""
    return {name: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for name, v in (("pos_q", POS_Q), ("obs_norm", OBS_NORM), ("scale", QA * QW))}


def steer_targets_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """Players move their target points with box_game's bitmask keys."""
    targets = state.resources["targets"]  # [..., 8, 2]
    bits = inputs.bits.to(torch.int32)
    pad = targets.shape[-2] - inputs.num_players
    bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    dx = ((bits & INPUT_RIGHT) != 0).to(torch.float32) - ((bits & INPUT_LEFT) != 0).to(torch.float32)
    dy = ((bits & INPUT_DOWN) != 0).to(torch.float32) - ((bits & INPUT_UP) != 0).to(torch.float32)
    moved = targets + torch.stack([dx, dy], dim=-1) * float(TARGET_SPEED)
    half = float(WORLD_HALF)
    return state.replace(resources={**state.resources,
                                    "targets": torch.clamp(moved, -half, half)})


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """``v[..., 0]**2 + v[..., 1]**2`` as ``[..., 1]``: two products and
    one sum, each rounded (a 2-term sum is the same in any order)."""
    return v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]


def policy_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """Quantized MLP inference to an acceleration, then a clamped
    integration."""
    del inputs
    pos = state.components["position"]  # [..., cap, 2]
    vel = state.components["velocity"]
    team = state.components["team"].clamp(0, MAX_PLAYERS - 1)
    active_i = (state.alive & state.present["position"]).to(torch.int32)
    sel = active_i.to(torch.bool)[..., None]

    all_targets = state.resources["targets"]  # [..., 8, 2]
    targets = torch.gather(all_targets, -2, team.long()[..., None].expand(*team.shape, 2))
    to_target = targets - pos
    dist = sqrt_f32(_norm2(to_target) + 1e-8)
    n_alive = torch.clamp(active_i.sum(dim=-1), min=1).to(torch.float32)  # [...]
    pos_q = torch.round(pos * float(POS_Q)).to(torch.int32)  # Q8.8
    q_sum = (pos_q * active_i[..., None]).sum(dim=-2, keepdim=True).to(torch.float32)
    div = _divisors(pos.device)
    centroid = q_sum / (div["pos_q"] * n_alive[..., None, None])
    to_centroid = centroid - pos

    obs = torch.cat([vel, to_target, dist, to_centroid, torch.ones_like(dist)], dim=-1)
    obs_q = torch.clamp(torch.round(obs / div["obs_norm"] * float(QA)),
                        -127, 127).to(torch.int8)

    p = state.resources["policy"]
    scale = div["scale"]
    acc1 = int_matmul(obs_q, p["w1"])  # [..., cap, H]
    hidden = tanh_f32(acc1.to(torch.float32) / scale + p["b1"][..., None, :])
    hidden_q = torch.round(hidden * float(QA)).to(torch.int8)
    acc2 = int_matmul(hidden_q, p["w2"])  # [..., cap, 4]
    act = tanh_f32(acc2.to(torch.float32) / scale + p["b2"][..., None, :])
    accel = torch.stack([act[..., 0] - act[..., 1], act[..., 2] - act[..., 3]], dim=-1)

    new_vel = vel + accel * float(ACCEL_SCALE)
    speed = sqrt_f32(_norm2(new_vel) + 1e-12)
    new_vel = new_vel * torch.clamp(torch.full_like(speed, float(MAX_SPEED)) / speed, max=1.0)
    half = float(WORLD_HALF)
    new_pos = torch.clamp(pos + new_vel, -half, half)
    return state.replace(components={
        **state.components,
        "position": torch.where(sel, new_pos, pos),
        "velocity": torch.where(sel, new_vel, vel),
    })


def increase_frame_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    del inputs
    return state.replace(resources={
        **state.resources,
        "frame_count": increment_u32(state.resources["frame_count"]),
    })


def make_schedule() -> Schedule:
    return Schedule([steer_targets_system, policy_system, increase_frame_system])
