"""One boids step, written again in plain PyTorch from the flock's equations.

Every boid feels separation, alignment and cohesion from the live boids
within ``NEIGHBOR_RADIUS`` (itself excluded by ``d2 < 1e-10``):

- separation: the sum of unit vectors ``(p_i - p_j) / |p_i - p_j|`` over
  neighbours within ``SEPARATION_RADIUS``;
- alignment: the neighbours' mean velocity minus the boid's own;
- cohesion: the neighbours' mean position minus the boid's own;

weighted ``W_SEPARATION``, ``W_ALIGNMENT`` and ``W_COHESION``. Leaders
(``leader_handle >= 0``) add ``LEADER_STEER`` along the steering keys of
their player's u8 bitmask (right - left, down - up). The new velocity is
clamped in speed to ``[MIN_SPEED, MAX_SPEED]``, the position advances by
it and wraps on the torus of half-width ``WORLD_HALF``; the frame count
goes up by one (mod 2**32). Entities that are not alive, or lack position
or velocity, keep their state.

``d2`` and the radius tests are float32 without fused multiply-adds, as
the configuration states; the neighbourhood sums are matrix products of
the pair masks and weights with the boids' features, in float32 with
TF32 off (``precision="f32"``). ``precision="tf32"`` rounds both operands
of those products to TF32 (10 stored mantissa bits, to nearest even) and
is the control that a comparison must fail. Rows are taken in blocks, so
the ``[rows, N]`` pair matrices fit beside whatever else is on the device.

Each step also gives every boid its rounding scale (``"rounding"`` in the
result): how far a program that keeps ``ROUNDING_BITS`` significant bits
of each operand of the neighbourhood sums may honestly stray from this
step, in velocity. It is ``2**-ROUNDING_BITS`` times the size of every
term the boid's force sums (the separation's ``|p_i| sum w + sum w |p_j|``,
the mean neighbour's ``|v|`` and ``|p|``, each by its weight), times the
speed clamp's gain where it lifts a slow boid to ``MIN_SPEED``, plus
``MAX_SPEED``: so a boid with a neighbour almost on top of it (a
separation weight near 1e4) gets the room its rounding takes, and every
other boid only its own.

Nothing here imports the program: the comparison hands in host copies of
the program's states.
"""

from __future__ import annotations

import numpy as np
import torch

NEIGHBOR_RADIUS = np.float32(1.0)
SEPARATION_RADIUS = np.float32(0.35)
W_SEPARATION = 0.08
W_ALIGNMENT = 0.05
W_COHESION = 0.03
LEADER_STEER = 0.02
MAX_SPEED = 0.08
MIN_SPEED = 0.02
WORLD_HALF = 8.0

UP, DOWN, LEFT, RIGHT = 1, 2, 4, 8

# The float32 squares the radius tests compare d2 against.
NEIGHBOR_R2 = float(NEIGHBOR_RADIUS * NEIGHBOR_RADIUS)
SEPARATION_R2 = float(SEPARATION_RADIUS * SEPARATION_RADIUS)
SELF_D2 = 1e-10

PRECISIONS = ("f32", "tf32")

# Significant bits of each operand a program's neighbourhood sums keep
# (the force kernels' hi/lo bfloat16 halves hold about 16); the rounding
# scale is 2**-ROUNDING_BITS times the size of the terms summed.
ROUNDING_BITS = 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (the 13 low mantissa bits cleared,
    to nearest, ties to even), still stored as float32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def forces(pos: torch.Tensor, vel: torch.Tensor, active: torch.Tensor,
           precision: str = "f32", block: int = 4096):
    """``(force, size)``, each ``f32[N, 2]`` and ``f32[N]``: the flocking
    force on every boid (0 on inactive ones) from ``pos``/``vel``
    ``f32[N, 2]`` and ``active`` ``f32[N]``, and the size of the terms it
    sums (the rounding scale before its ``2**-ROUNDING_BITS``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    n = pos.shape[0]
    feats = torch.stack([torch.ones_like(active), pos[:, 0], pos[:, 1],
                         vel[:, 0], vel[:, 1]], dim=1)  # [N, 5]
    big_p, big_v = pos.abs().amax(dim=1), vel.abs().amax(dim=1)
    sizes = torch.stack([big_p, big_v], dim=1) * active[:, None]  # [N, 2]
    out = torch.empty((n, 2), dtype=torch.float32, device=pos.device)
    size = torch.empty((n,), dtype=torch.float32, device=pos.device)
    for r0 in range(0, n, block):
        rows = slice(r0, min(r0 + block, n))
        rp, rv, ra = pos[rows], vel[rows], active[rows]
        dx = rp[:, 0:1] - pos[None, :, 0]
        dy = rp[:, 1:2] - pos[None, :, 1]
        d2 = dx * dx
        d2 += dy * dy
        del dx, dy
        live = (ra[:, None] > 0) & (active[None, :] > 0)
        neigh = live & (d2 < NEIGHBOR_R2) & (d2 >= SELF_D2)
        del live
        w = torch.where(neigh & (d2 < SEPARATION_R2), torch.rsqrt(d2), 0.0)
        del d2
        nf = neigh.to(torch.float32)
        del neigh
        s = _product(nf, feats, precision)  # [R, 5]
        s_big = nf @ sizes  # [R, 2]: the sums of |p| and |v| over neighbours
        del nf
        sw = _product(w, feats[:, :3], precision)  # [R, 3]
        sw_big = w @ sizes[:, 0]  # [R]: the separation's sum of w |p_j|
        del w
        cnt, spx, spy, svx, svy = s.unbind(1)
        n_safe = torch.clamp(cnt, min=1.0)
        has = (cnt > 0).to(torch.float32)
        fx = (W_SEPARATION * (rp[:, 0] * sw[:, 0] - sw[:, 1])
              + W_ALIGNMENT * (svx / n_safe - rv[:, 0]) * has
              + W_COHESION * (spx / n_safe - rp[:, 0]) * has)
        fy = (W_SEPARATION * (rp[:, 1] * sw[:, 0] - sw[:, 2])
              + W_ALIGNMENT * (svy / n_safe - rv[:, 1]) * has
              + W_COHESION * (spy / n_safe - rp[:, 1]) * has)
        out[rows] = torch.stack([fx, fy], dim=1) * ra[:, None]
        size[rows] = (W_SEPARATION * (big_p[rows] * sw[:, 0] + sw_big)
                      + (W_ALIGNMENT * s_big[:, 1] + W_COHESION * s_big[:, 0]) / n_safe
                      + W_ALIGNMENT * big_v[rows] + W_COHESION * big_p[rows]) * ra
    return out, size


def step(world: dict, bits, device, precision: str = "f32") -> dict:
    """The world one frame on: ``world`` a host dict (``alive``,
    ``rollback_id``, ``present``, ``components``, ``resources``) and
    ``bits`` the players' ``u8[P]`` inputs for this frame; the result is a
    host dict of the same form."""
    t = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in world["components"].items()}
    alive = torch.as_tensor(np.asarray(world["alive"]), device=device)
    present = {k: torch.as_tensor(np.asarray(v), device=device)
               for k, v in world["present"].items()}
    pos, vel, leader = t["position"], t["velocity"], t["leader_handle"].reshape(-1)
    active = (alive & present["position"]).to(torch.float32)
    force, size = forces(pos, vel, active, precision)

    bits = torch.as_tensor(np.asarray(bits).astype(np.int64), device=device)
    key = bits[leader.clamp(0, bits.shape[0] - 1).long()]
    steer_x = ((key & RIGHT) != 0).to(torch.float32) - ((key & LEFT) != 0).to(torch.float32)
    steer_y = ((key & DOWN) != 0).to(torch.float32) - ((key & UP) != 0).to(torch.float32)
    steer = torch.stack([steer_x, steer_y], dim=1) * LEADER_STEER
    force = force + torch.where(((leader >= 0) & alive)[:, None], steer, 0.0)

    new_vel = vel + force
    speed = torch.sqrt((new_vel * new_vel).sum(dim=1, keepdim=True))
    speed_safe = torch.clamp(speed, min=1e-6)
    gain = torch.clamp(speed_safe, MIN_SPEED, MAX_SPEED) / speed_safe
    new_vel = new_vel * gain
    moves = _moves(world, device)
    new_vel = torch.where(moves[:, None], new_vel, vel).cpu().numpy()
    lifted = size * gain[:, 0].clamp(min=1.0)
    rounding = 2.0**-ROUNDING_BITS * (torch.where(moves, lifted, 0.0) + MAX_SPEED)
    components = dict(world["components"])
    components["position"] = integrate(world, new_vel)
    components["velocity"] = new_vel
    resources = dict(world["resources"])
    resources["frame_count"] = np.uint32((int(resources["frame_count"]) + 1) & 0xFFFFFFFF)
    return {"alive": world["alive"], "rollback_id": world["rollback_id"],
            "present": world["present"], "components": components,
            "resources": resources, "rounding": rounding.cpu().numpy()}


def _moves(world: dict, device=None) -> torch.Tensor:
    present = world["present"]
    sel = np.asarray(world["alive"]) & np.asarray(present["position"]) & np.asarray(
        present["velocity"])
    return torch.as_tensor(sel, device=device)


def integrate(world: dict, new_vel: np.ndarray) -> np.ndarray:
    """``f32[N, 2]``: every moving entity's position advanced by
    ``new_vel`` in float32 and wrapped on the torus; the others keep
    theirs."""
    pos = np.asarray(world["components"]["position"], np.float32)
    new_pos = pos + np.asarray(new_vel, np.float32)
    half = np.float32(WORLD_HALF)
    new_pos = np.where(new_pos > half, new_pos - 2 * half, new_pos)
    new_pos = np.where(new_pos < -half, new_pos + 2 * half, new_pos)
    return np.where(_moves(world).numpy()[:, None], new_pos, pos).astype(np.float32)
