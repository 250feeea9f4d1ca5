"""Projectiles: entities spawned and despawned inside the step.

Counterpart of ``bevy_ggrs_tpu/models/projectiles.py``. Each player steers
a turret on a 2D arena; the FIRE bit spawns a projectile entity inside the
step, in a free capacity slot, with a fresh rollback id from the
``next_rollback_id`` resource; projectiles fly straight and despawn when
their time runs out, when they leave the arena, or when they pass within
``HIT_RADIUS`` of an opposing turret (a point for their owner). Rolling
back rewinds the id allocator with everything else, so a projectile
respawned on resimulation gets the id it had, and speculative branches
mint ids of their own.

The JAX step's spawn is a shape-static masked scatter, and so is this one:
firing players are ranked with a cumulative sum and matched rank for rank
to free slots (``searchsorted`` over the free-slot prefix sum). JAX's
``.at[target].set(..., mode="drop")`` becomes a per-slot select: a slot
that a firer claims takes that firer's values, every other slot keeps its
own, and a shot aimed at the capacity (no free slot) claims nothing. Every operation is integer work, a compare, or one
correctly rounded float32 operation in the JAX step's order, so the two
steps are bitwise equal (jitted or not: the JAX step has no product that
XLA could contract into an FMA with other bits).

The hit test's terms are 0/1 floats, so their sums are exact integers in
any order: dense and grid hit counts are bitwise equal. Dense mode is one
``[..., capacity, capacity]`` pass over any leading ``[B]`` (bitwise each
branch's own, the sums being exact); grid mode goes through
:func:`bevy_ggrs_tpu_torch.ops.neighbor.interact` with its plain per-cell
path, as JAX's runs ``impl="xla"``, binning a branch at a time. A world
stacked over B speculative branches (``[B, capacity, ...]``) steps every
system at once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.models.box_game import increment_u32
from bevy_ggrs_tpu_torch.ops import neighbor
from bevy_ggrs_tpu_torch.ops.exact import sqrt_f32
from bevy_ggrs_tpu_torch.schedule import InputSpec, PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import (
    DEVICE_ID_BASE,
    HostWorld,
    TypeRegistry,
    WorldState,
    resolve_device,
)

INPUT_UP = 1 << 0
INPUT_DOWN = 1 << 1
INPUT_LEFT = 1 << 2
INPUT_RIGHT = 1 << 3
INPUT_FIRE = 1 << 4

# 4 movement bits and FIRE: the value universe 0..31, so the speculative
# tree can enumerate a fire press.
INPUT_SPEC = InputSpec(shape=(), dtype=torch.uint8, values=tuple(range(32)))

KIND_TURRET = 0
KIND_PROJECTILE = 1

TURRET_SPEED = np.float32(0.06)
PROJ_SPEED = np.float32(0.25)
PROJ_TTL = 48  # frames a projectile lives
FIRE_COOLDOWN = 6  # frames between shots per player
HIT_RADIUS = np.float32(0.35)
ARENA_HALF = np.float32(4.0)

MAX_PLAYERS = 8

_HIT_R2 = float(HIT_RADIUS * HIT_RADIUS)  # the float32 product, as JAX's
_MIN_NORM = float(np.float32(1e-6))


def make_registry() -> TypeRegistry:
    reg = TypeRegistry()
    reg.register_component("position", shape=(2,), dtype=torch.float32)
    reg.register_component("velocity", shape=(2,), dtype=torch.float32)
    # The facing direction a fired projectile inherits.
    reg.register_component("aim", shape=(2,), dtype=torch.float32)
    reg.register_component("kind", shape=(), dtype=torch.int32, default=KIND_TURRET)
    reg.register_component("owner", shape=(), dtype=torch.int32, default=-1)
    reg.register_component("ttl", shape=(), dtype=torch.int32, default=0)
    reg.register_resource("frame_count", np.uint32(0))
    # The in-step rollback-id allocator.
    reg.register_resource("next_rollback_id", np.int32(DEVICE_ID_BASE))
    reg.register_resource("fire_cooldown", np.zeros((MAX_PLAYERS,), np.int32))
    reg.register_resource("score", np.zeros((MAX_PLAYERS,), np.int32))
    return reg


def spawn_turrets(world: HostWorld, num_players: int) -> None:
    """One turret per player on a circle (the setup system of a
    projectiles app); rollback ids are the handles."""
    if not 1 <= num_players <= MAX_PLAYERS:
        raise ValueError(f"num_players must be 1..{MAX_PLAYERS}")
    r = float(ARENA_HALF) * 0.5
    for handle in range(num_players):
        ang = 2.0 * np.pi * handle / num_players
        world.spawn(
            {
                "position": np.array([r * np.cos(ang), r * np.sin(ang)], dtype=np.float32),
                "velocity": np.zeros(2, np.float32),
                "aim": np.array([1.0, 0.0], np.float32),
                "kind": KIND_TURRET,
                "owner": handle,
                "ttl": 0,
            },
            rollback_id=handle,
        )


def make_world(num_players: int, capacity: int = 64,
               registry: Optional[TypeRegistry] = None, device=None) -> HostWorld:
    """Turrets on a circle; the rest of the capacity is projectile
    headroom. The world commits to ``device`` (default ``cuda``, raising
    when there is no GPU)."""
    world = HostWorld(registry or make_registry(), capacity, device=resolve_device(device))
    spawn_turrets(world, num_players)
    return world


# ---------------------------------------------------------------------------
# Systems (any leading axes: [..., capacity])
# ---------------------------------------------------------------------------


def _input_dirs(bits: torch.Tensor) -> torch.Tensor:
    """``[..., P, 2]`` move and aim direction per player from the
    bitmask."""
    b = bits.to(torch.int32)
    dx = ((b & INPUT_RIGHT) != 0).to(torch.float32) - ((b & INPUT_LEFT) != 0).to(torch.float32)
    dy = ((b & INPUT_UP) != 0).to(torch.float32) - ((b & INPUT_DOWN) != 0).to(torch.float32)
    return torch.stack([dx, dy], dim=-1)


def _rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per world: ``x`` ``[..., N, 2]``, ``idx``
    ``[..., M]`` gives ``[..., M, 2]``."""
    return torch.gather(x, -2, idx.long()[..., None].expand(*idx.shape, x.shape[-1]))


def move_turret_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """Turrets move by their player's direction keys and re-aim while a
    direction is held (box_game's movement, flattened to 2D)."""
    pos = state.components["position"]
    aim = state.components["aim"]
    kind = state.components["kind"]
    owner = state.components["owner"]

    dirs = _input_dirs(inputs.bits)  # [..., P, 2]
    d = _rows_at(dirs, owner.clamp(0, inputs.num_players - 1))  # [..., cap, 2]
    is_turret = (state.alive & state.present["position"] & (kind == KIND_TURRET)
                 & (owner >= 0))
    sel = is_turret[..., None]
    half = float(ARENA_HALF)
    new_pos = torch.clamp(pos + d * float(TURRET_SPEED), -half, half)
    moved = (d != 0.0).any(dim=-1, keepdim=True)
    new_aim = torch.where(moved, d, aim)
    return state.replace(components={
        **state.components,
        "position": torch.where(sel, new_pos, pos),
        "aim": torch.where(sel, new_aim, aim),
    })


def fire_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    """Spawn one projectile per firing player, inside the step. Firing
    players, ranked by handle, take free slots in ascending slot order;
    shots beyond the free capacity fizzle (their writes are dropped), and
    every firing player restarts their cooldown."""
    cap = state.capacity
    num_players = inputs.num_players
    dev = state.device
    bits = inputs.bits.to(torch.int32)
    cooldown = state.resources["fire_cooldown"]
    kind = state.components["kind"]
    owner = state.components["owner"]

    is_turret = state.alive & (kind == KIND_TURRET) & (owner >= 0)
    p_range = torch.arange(num_players, dtype=torch.int32, device=dev)
    one_hot = is_turret[..., None, :] & (owner[..., None, :] == p_range[:, None])  # [..., P, cap]
    turret_slot = torch.argmax(one_hot.to(torch.int32), dim=-1)  # the first, as jnp.argmax
    has_turret = one_hot.any(dim=-1)

    firing = ((bits & INPUT_FIRE) != 0) & (cooldown[..., :num_players] <= 0) & has_turret
    rank = torch.cumsum(firing.to(torch.int32), dim=-1, dtype=torch.int32) - 1  # [..., P]
    free_prefix = torch.cumsum((~state.alive).to(torch.int32), dim=-1, dtype=torch.int32)
    n_free = free_prefix[..., -1:]
    # The k-th free slot (0-based) is the first index whose prefix is k + 1.
    slots = torch.searchsorted(free_prefix, rank + 1, side="left")
    can = firing & (rank < n_free)
    target = torch.where(can, slots, cap)  # cap: the dropped slot

    next_id = state.resources["next_rollback_id"]
    tpos = _rows_at(state.components["position"], turret_slot)  # [..., P, 2]
    taim = _rows_at(state.components["aim"], turret_slot)
    # Unit aim, so a diagonal shot is no faster.
    norm = sqrt_f32(taim[..., 0:1] * taim[..., 0:1] + taim[..., 1:2] * taim[..., 1:2])
    aim_unit = taim / norm.clamp(min=_MIN_NORM)

    # The writes JAX drops at ``target == cap``: each slot takes the values
    # of the firer that claims it (one at most), or keeps its own.
    claim = target[..., :, None] == torch.arange(cap, device=dev)  # [..., P, cap]
    spawn = claim.any(dim=-2)  # [..., cap]
    firer = torch.argmax(claim.to(torch.int32), dim=-2)  # [..., cap]
    rows = firer[..., None].expand(*firer.shape, 2)

    def put(arr, per_firer):  # per_firer [..., P, 2] -> the spawned slots' rows
        return torch.where(spawn[..., None], torch.gather(per_firer, -2, rows), arr)

    comps = dict(state.components)
    comps["position"] = put(comps["position"], tpos)
    comps["velocity"] = put(comps["velocity"], aim_unit * float(PROJ_SPEED))
    comps["aim"] = put(comps["aim"], aim_unit)
    comps["kind"] = torch.where(spawn, KIND_PROJECTILE, comps["kind"])
    comps["owner"] = torch.where(spawn, firer.to(torch.int32), comps["owner"])
    comps["ttl"] = torch.where(spawn, PROJ_TTL, comps["ttl"])
    # Only the components written above become present: a user registry's
    # extra components keep the slot's old occupant's values hidden.
    pres = dict(state.present)
    for name in ("position", "velocity", "aim", "kind", "owner", "ttl"):
        pres[name] = pres[name] | spawn
    new_ids = torch.gather(next_id[..., None] + rank, -1, firer)

    spawned = can.to(torch.int32).sum(dim=-1).to(torch.int32)
    cd_now = torch.where(firing, FIRE_COOLDOWN, cooldown[..., :num_players])
    cooldown = torch.cat([cd_now, cooldown[..., num_players:]], dim=-1)
    return state.replace(
        alive=state.alive | spawn,
        rollback_id=torch.where(spawn, new_ids, state.rollback_id),
        components=comps,
        present=pres,
        resources={**state.resources, "next_rollback_id": next_id + spawned,
                   "fire_cooldown": cooldown},
    )


def _hit_accumulate(dx, dy, d2, row, col):
    """Projectile row against turret column, a 0/1 float: sums over the
    candidates are exact integers, so dense and grid agree bitwise."""
    del dx, dy
    return (
        row["is_proj"]
        * col["is_turret"]
        * (row["owner"] != col["owner"]).to(torch.float32)
        * (d2 < _HIT_R2).to(torch.float32),
    )


def _hit_combine(sums, row):
    return (sums[0] * row["is_proj"],)


HIT_PAIR_KERNEL = neighbor.PairKernel(
    radius=float(HIT_RADIUS),
    out_dim=1,
    n_terms=1,
    accumulate=_hit_accumulate,
    combine=_hit_combine,
    row_feats=("owner", "is_proj"),
    col_feats=("owner", "is_turret"),
)


def _hits_dense(pos, feats) -> torch.Tensor:
    """The dense hit test: rows against broadcast columns, the terms
    summed over the columns, in one ``[..., cap, cap]`` pass over any
    leading ``[B]``. The sums are exact 0/1 counts, so a branch's hits are
    bitwise its own pass's. Inactive slots need no mask: ``is_proj`` and
    ``is_turret`` are zero there."""
    rows = {"px": pos[..., 0], "py": pos[..., 1], **feats}
    row = {k: v[..., :, None] for k, v in rows.items()}
    col = {k: v[..., None, :] for k, v in rows.items()}
    dx = row["px"] - col["px"]
    dy = row["py"] - col["py"]
    d2 = dx * dx + dy * dy
    sums = tuple(t.sum(dim=-1) for t in HIT_PAIR_KERNEL.accumulate(dx, dy, d2, row, col))
    return torch.stack(HIT_PAIR_KERNEL.combine(sums, rows), dim=-1)


def projectile_system(state: WorldState, inputs: PlayerInputs, *,
                      mode: Optional[str] = None) -> WorldState:
    """Fly, age, collide, expire: entity destruction inside the step. A
    hit projectile scores one point for its owner, even when it grazes two
    turrets in one frame."""
    del inputs
    pos = state.components["position"]
    vel = state.components["velocity"]
    kind = state.components["kind"]
    owner = state.components["owner"]
    ttl = state.components["ttl"]

    is_proj = state.alive & (kind == KIND_PROJECTILE)
    is_turret = state.alive & (kind == KIND_TURRET) & (owner >= 0)
    new_pos = torch.where(is_proj[..., None], pos + vel, pos)
    new_ttl = torch.where(is_proj, ttl - 1, ttl)

    feats = {"owner": owner.to(torch.float32), "is_proj": is_proj.to(torch.float32),
             "is_turret": is_turret.to(torch.float32)}
    if neighbor.resolve_mode(mode, state.capacity) == "dense":
        hits = _hits_dense(new_pos, feats)
    else:
        hits = neighbor.interact(new_pos, state.alive, HIT_PAIR_KERNEL, feats=feats,
                                 mode=mode, world_half=float(ARENA_HALF))
    proj_hit = hits[..., 0] > 0.0

    safe_owner = owner.clamp(0, MAX_PLAYERS - 1).long()
    score = state.resources["score"].scatter_add(-1, safe_owner, proj_hit.to(torch.int32))

    out = (new_pos.abs() > float(ARENA_HALF)).any(dim=-1)
    gone = is_proj & ((new_ttl <= 0) | out | proj_hit)
    return state.replace(
        alive=state.alive & ~gone,
        rollback_id=torch.where(gone, -1, state.rollback_id),
        components={**state.components, "position": new_pos, "ttl": new_ttl},
        present={n: p & ~gone for n, p in state.present.items()},
        resources={**state.resources, "score": score},
    )


def cooldown_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    del inputs
    cd = state.resources["fire_cooldown"]
    return state.replace(resources={**state.resources,
                                    "fire_cooldown": torch.clamp(cd - 1, min=0)})


def increase_frame_system(state: WorldState, inputs: PlayerInputs) -> WorldState:
    del inputs
    return state.replace(resources={
        **state.resources,
        "frame_count": increment_u32(state.resources["frame_count"]),
    })


def make_schedule(mode: Optional[str] = None) -> Schedule:
    """The rollback schedule; ``mode`` is the hit test's interaction mode
    ("dense", "grid" or "auto"; None follows ``GGRS_FORCE_MODE`` and the
    session default, else dense: :func:`neighbor.resolve_mode`)."""

    def projectiles(state: WorldState, inputs: PlayerInputs) -> WorldState:
        return projectile_system(state, inputs, mode=mode)

    return Schedule([move_turret_system, fire_system, projectiles, cooldown_system,
                     increase_frame_system])
