"""Dense all-pairs boids forces through the hand-written CUDA kernel.

Counterpart of ``bevy_ggrs_tpu/ops/pairwise.py``'s
``pairwise_force_rows_pallas``: the separation / alignment / cohesion
force on ``R`` row boids from ``N`` column boids (the row-subset contract
a sharded caller uses), with the same five float parameters. The kernel
is ``csrc/pairwise.cu``; :func:`pairwise_force_rows_plain` is its plain
PyTorch version, taken for CPU tensors.

The kernel sums the columns in one fixed order without atomics, so it is
bitwise equal to itself from launch to launch; against the plain version
and the JAX paths it is allclose (another summation order, and CUDA's
``rsqrtf``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops import _build


def _squared(radius: float) -> float:
    """The float32 square JAX compares ``d2`` against
    (``jnp.float32(radius) ** 2``)."""
    r = np.float32(radius)
    return float(r * r)


def pairwise_force_rows_plain(
    row_pos: torch.Tensor,  # f32[R, 2]
    row_vel: torch.Tensor,  # f32[R, 2]
    all_pos: torch.Tensor,  # f32[N, 2]
    all_vel: torch.Tensor,  # f32[N, 2]
    row_active: torch.Tensor,  # f32[R]
    all_active: torch.Tensor,  # f32[N]
    *,
    neighbor_radius: float,
    separation_radius: float,
    w_separation: float,
    w_alignment: float,
    w_cohesion: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same arithmetic per pair
    over dense ``[R, N]`` tensors. Self-interaction drops out through the
    d2 ≈ 0 mask."""
    dx = row_pos[:, 0:1] - all_pos[None, :, 0]  # [R, N]
    dy = row_pos[:, 1:2] - all_pos[None, :, 1]
    d2 = dx * dx + dy * dy
    both = row_active[:, None] * all_active[None, :]
    not_self = 1.0 - (d2 < 1e-10).to(torch.float32)
    neigh = both * (d2 < _squared(neighbor_radius)).to(torch.float32) * not_self
    close = neigh * (d2 < _squared(separation_radius)).to(torch.float32)
    inv_d = torch.rsqrt(torch.clamp(d2, min=1e-12))
    n = neigh.sum(dim=1)
    sx = (dx * inv_d * close).sum(dim=1)
    sy = (dy * inv_d * close).sum(dim=1)
    svx = (all_vel[None, :, 0] * neigh).sum(dim=1)
    svy = (all_vel[None, :, 1] * neigh).sum(dim=1)
    spx = (all_pos[None, :, 0] * neigh).sum(dim=1)
    spy = (all_pos[None, :, 1] * neigh).sum(dim=1)
    n_safe = torch.clamp(n, min=1.0)
    has = (n > 0).to(torch.float32)
    fx = (w_separation * sx
          + w_alignment * (svx / n_safe - row_vel[:, 0]) * has
          + w_cohesion * (spx / n_safe - row_pos[:, 0]) * has)
    fy = (w_separation * sy
          + w_alignment * (svy / n_safe - row_vel[:, 1]) * has
          + w_cohesion * (spy / n_safe - row_pos[:, 1]) * has)
    return torch.stack([fx, fy], dim=1) * row_active[:, None]


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def pairwise_force_rows(
    row_pos: torch.Tensor,
    row_vel: torch.Tensor,
    all_pos: torch.Tensor,
    all_vel: torch.Tensor,
    row_active: torch.Tensor,
    all_active: torch.Tensor,
    *,
    neighbor_radius: float,
    separation_radius: float,
    w_separation: float,
    w_alignment: float,
    w_cohesion: float,
) -> torch.Tensor:
    """``f32[R, 2]`` flocking force on each row boid from all boids.

    A CPU tensor takes :func:`pairwise_force_rows_plain`; a CUDA tensor
    launches the kernel (``csrc/pairwise.cu``) on the current stream, and
    anything it cannot take raises."""
    params = dict(neighbor_radius=neighbor_radius,
                  separation_radius=separation_radius,
                  w_separation=w_separation, w_alignment=w_alignment,
                  w_cohesion=w_cohesion)
    R, N = row_pos.shape[0], all_pos.shape[0]
    expected = {
        "row_pos": (row_pos, (R, 2)), "row_vel": (row_vel, (R, 2)),
        "all_pos": (all_pos, (N, 2)), "all_vel": (all_vel, (N, 2)),
        "row_active": (row_active, (R,)), "all_active": (all_active, (N,)),
    }
    device = row_pos.device
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
    if device.type == "cpu":
        return pairwise_force_rows_plain(
            row_pos, row_vel, all_pos, all_vel, row_active, all_active,
            **params)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for name, (t, _) in expected.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R == 0:
        raise ValueError("no row boids")
    out = torch.empty((R, 2), dtype=torch.float32, device=device)
    fn = _build.function("pairwise", "ggrs_pairwise_force_rows", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(row_pos.data_ptr(), row_vel.data_ptr(), row_active.data_ptr(),
                 all_pos.data_ptr(), all_vel.data_ptr(), all_active.data_ptr(),
                 out.data_ptr(), R, N,
                 _squared(neighbor_radius), _squared(separation_radius),
                 float(np.float32(w_separation)), float(np.float32(w_alignment)),
                 float(np.float32(w_cohesion)), stream)
    _build.check(err, "pairwise_force_rows")
    pairwise_force_rows.launches += 1
    return out


pairwise_force_rows.launches = 0
