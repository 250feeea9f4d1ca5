"""Dense all-pairs boids forces through the hand-written CUDA kernels.

Counterpart of ``bevy_ggrs_tpu/ops/pairwise.py``: the separation /
alignment / cohesion force on ``R`` row boids from ``N`` column boids (the
row-subset contract a sharded caller uses), with the same five float
parameters, in three kernels:

- :func:`pairwise_force_rows` (``csrc/pairwise.cu``), for
  ``pairwise_force_rows_pallas``: f32 sums on the CUDA cores;
- :func:`pairwise_force_rows_mxu2` (``csrc/pairwise_mxu.cu``), for
  ``pairwise_force_rows_mxu2``: the neighbourhood sums as bf16 products of
  pair matrices with hi/lo-split features, on the tensor cores;
- :func:`pairwise_force_square_mxu_tri` (``csrc/pairwise_tri.cu``), for
  ``pairwise_force_square_mxu_tri``: the square all-vs-all case of the
  second with each pair's masks built once for both boids.

Each has a ``*_plain`` PyTorch version, taken for CPU tensors. Every
kernel sums in one fixed order without float atomics, so it is bitwise
equal to itself from launch to launch; against its plain version and the
JAX paths it is allclose (another summation order, and CUDA's ``rsqrtf``).

Every wrapper and plain version takes one world (``[R, 2]`` rows, ``[N,
2]`` columns) or a world stacked over B speculative branches, a leading
``[B]`` on every operand (JAX vmaps its kernels over that axis). Branch
``b`` of a batched call is bitwise the unbatched call on branch ``b``'s
operands:

- a kernel takes the branch as ``blockIdx.y`` and runs each branch's
  blocks exactly as an unbatched launch runs them. Its launch shape comes
  from the per-world ``R`` and ``N`` only (:func:`force_rows_launch_shape`,
  :func:`mxu2_launch_shape`), never from B: mxu2's cluster size fixes the
  order in which its stages add, so a size chosen from B would give other
  bits, and attestation would switch speculation off;
- a plain version loops over the branches, one unbatched call each: a
  batched product (``[B, 10, N] @ [B, N, N]``) can sum in another order
  than B single ones on the CPU, where the tests attest.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops import _build


def _squared(radius: float) -> float:
    """The float32 square JAX compares ``d2`` against
    (``jnp.float32(radius) ** 2``)."""
    r = np.float32(radius)
    return float(r * r)


def _branch_axes(t: torch.Tensor, ndim: int) -> Tuple[int, ...]:
    """``()`` when ``t`` has a world's ``ndim`` axes, ``(B,)`` when it has a
    leading branch axis too; anything else raises."""
    if t.dim() not in (ndim, ndim + 1):
        raise ValueError(f"expected {ndim} axes, or a branch axis and {ndim}, "
                         f"got shape {list(t.shape)}")
    return tuple(t.shape[:t.dim() - ndim])


def per_branch(one_world):
    """Extend a plain version over one world (its first operand ``[R, 2]``)
    to a leading branch axis on every operand: one call a branch, stacked,
    so each branch gets the bits of its unbatched call."""

    @functools.wraps(one_world)
    def plain(*args, **params):
        if args[0].dim() == 2:
            return one_world(*args, **params)
        return torch.stack([one_world(*(a[b] for a in args), **params)
                            for b in range(args[0].shape[0])])

    return plain


def _check_inputs(**expected) -> torch.device:
    """Check that every ``name=(tensor, shape)`` is float32 of that shape on
    one device, and return the device. A CPU device passes as it is; any
    other must be CUDA, with contiguous tensors, at least one branch and at
    least one boid, or this raises: the wrappers launch their kernel there
    or fail."""
    device = next(iter(expected.values()))[0].device
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for name, (t, shape) in expected.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if min(shape) == 0:
            raise ValueError(f"{name} holds no boids")
    return device


def _rows_operands(row_pos, row_vel, all_pos, all_vel, row_active, all_active):
    """Check the six operands of a rows-against-columns call; returns
    ``(device, B, R, N)``, B = 1 for one world."""
    lead = _branch_axes(row_pos, 2)
    R, N = row_pos.shape[-2], all_pos.shape[-2]
    device = _check_inputs(
        row_pos=(row_pos, lead + (R, 2)), row_vel=(row_vel, lead + (R, 2)),
        all_pos=(all_pos, lead + (N, 2)), all_vel=(all_vel, lead + (N, 2)),
        row_active=(row_active, lead + (R,)), all_active=(all_active, lead + (N,)))
    return device, (lead[0] if lead else 1), R, N


@per_branch
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
    over dense ``[R, N]`` tensors (a branch at a time over a leading
    ``[B]``). Self-interaction drops out through the d2 ≈ 0 mask."""
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


_SMS = 132  # streaming multiprocessors of an H100 SXM
_FORCE_WARPS = (8, 4, 2, 1)  # rows (one warp each) per block of csrc/pairwise.cu
FORCE_LANES = 32  # threads that split each row's columns: one warp


def force_rows_launch_shape(r: int) -> Tuple[int, int]:
    """``(W, blocks)`` of the f32 force kernel for ``r`` rows: one warp per
    row, ``W`` rows a block, ``blocks = ceil(r / W)``. ``W`` halves from 8
    while the blocks would fill fewer than half the SMs, so that small
    ``r`` still spreads over the card; every block stages all the columns,
    so fewer, larger blocks stage less (8 at ``r = 1,024``: 128 blocks)."""
    for w in _FORCE_WARPS:
        blocks = -(-r // w)
        if 2 * blocks >= _SMS:
            break
    return w, blocks


def force_rows_lane_columns(n: int, lane: int) -> range:
    """The columns, in the order summed, that lane ``lane`` of a row's warp
    walks in ``csrc/pairwise.cu``: ``lane, lane + 32, ...`` (the shared-
    memory tiles hold a multiple of 32 columns, so the stride runs on
    across them)."""
    return range(lane, n, FORCE_LANES)


# The C entries of csrc/pairwise.cu and csrc/pairwise_mxu.cu: seven
# pointers, B, R, N, the launch shape's W or P, five floats and the stream.
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
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
    """``f32[R, 2]`` flocking force on each row boid from all boids
    (``[B, R, 2]`` over a leading branch axis).

    A CPU tensor takes :func:`pairwise_force_rows_plain`; a CUDA tensor
    launches the kernel (``csrc/pairwise.cu``) once on the current stream,
    in blocks of :func:`force_rows_launch_shape` for every branch, and
    anything it cannot take raises."""
    params = dict(neighbor_radius=neighbor_radius,
                  separation_radius=separation_radius,
                  w_separation=w_separation, w_alignment=w_alignment,
                  w_cohesion=w_cohesion)
    args = (row_pos, row_vel, all_pos, all_vel, row_active, all_active)
    device, B, R, N = _rows_operands(*args)
    if device.type == "cpu":
        return pairwise_force_rows_plain(*args, **params)
    warps, _ = force_rows_launch_shape(R)
    out = torch.empty(row_pos.shape, dtype=torch.float32, device=device)
    fn = _build.function("pairwise", "ggrs_pairwise_force_rows", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(row_pos.data_ptr(), row_vel.data_ptr(), row_active.data_ptr(),
                 all_pos.data_ptr(), all_vel.data_ptr(), all_active.data_ptr(),
                 out.data_ptr(), B, R, N, warps, *_launch_params(**params),
                 stream)
    _build.check(err, "pairwise_force_rows")
    pairwise_force_rows.launches += 1
    return out


pairwise_force_rows.launches = 0


# ---------------------------------------------------------------------------
# Tensor-core variants: the neighbourhood sums as pair-matrix products
# ---------------------------------------------------------------------------


def _hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as ``bf16(x) + bf16(x - bf16(x))``, both rounded to nearest
    even, as JAX's ``astype`` and CUDA's ``__float2bfloat16_rn`` round."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def _lane_feats(px, py, vx, vy, act) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N]`` column coordinates -> the bf16 hi/lo feature stacks
    ``(feat_t[10, N], sep_t[6, N])``. Activity multiplies into the
    features here, so inactive and padded columns vanish from every
    neighbourhood sum."""
    f32feat = torch.stack([act, act * px, act * py, act * vx, act * vy])
    hi, lo = _hi_lo(f32feat)
    return torch.cat([hi, lo]), torch.cat([hi[0:3], lo[0:3]])


def _pair_masks(rpx, rpy, cpx, cpy, *, neighbor_radius, separation_radius):
    """Rows ``[R, 1]`` against columns ``[1, C]`` -> the bf16 neighbour
    mask and the hi/lo halves of the separation weight, ``[R, C]`` each.

    ``d2`` and the compares stay f32. ``rsqrt(d2)`` takes no clamp and
    ``where`` selects it: pairs with ``d2 < 1e-10`` are outside ``nb``, so
    an ``inf`` is never selected (a product with the mask would make it a
    NaN)."""
    dx = rpx - cpx
    dy = rpy - cpy
    d2 = dx * dx + dy * dy
    nb = (d2 < _squared(neighbor_radius)) & (d2 >= 1e-10)
    w = torch.where(nb & (d2 < _squared(separation_radius)), torch.rsqrt(d2), 0.0)
    w_hi, w_lo = _hi_lo(w)
    return nb.to(torch.bfloat16), w_hi, w_lo


def _acc_sums(acc_n, acc_w, cacc_n=None, cacc_w=None):
    """Hi + lo sums of the accumulator rows (``acc_n[10, R]``,
    ``acc_w[6, R]``); the triangle's column-side accumulators, when given,
    add to each row first."""
    def row(acc, cacc, i):
        return acc[i] if cacc is None else acc[i] + cacc[i]

    n = row(acc_n, cacc_n, 0) + row(acc_n, cacc_n, 5)
    spx = row(acc_n, cacc_n, 1) + row(acc_n, cacc_n, 6)
    spy = row(acc_n, cacc_n, 2) + row(acc_n, cacc_n, 7)
    svx = row(acc_n, cacc_n, 3) + row(acc_n, cacc_n, 8)
    svy = row(acc_n, cacc_n, 4) + row(acc_n, cacc_n, 9)
    sw = row(acc_w, cacc_w, 0) + row(acc_w, cacc_w, 3)
    swx = row(acc_w, cacc_w, 1) + row(acc_w, cacc_w, 4)
    swy = row(acc_w, cacc_w, 2) + row(acc_w, cacc_w, 5)
    return n, spx, spy, svx, svy, sw, swx, swy


def _combine_forces(sums, rpx, rpy, rvx, rvy, ra, *,
                    w_separation, w_alignment, w_cohesion):
    """The accumulator sums (from :func:`_acc_sums`) -> the ``[R]`` force
    components. The separation sum of pair differences is
    ``rpx·Σw − Σw·cpx``."""
    n, spx, spy, svx, svy, sw, swx, swy = sums
    n_safe = torch.clamp(n, min=1.0)
    has = (n > 0).to(torch.float32)
    fx = (w_separation * (rpx * sw - swx)
          + w_alignment * (svx / n_safe - rvx) * has
          + w_cohesion * (spx / n_safe - rpx) * has)
    fy = (w_separation * (rpy * sw - swy)
          + w_alignment * (svy / n_safe - rvy) * has
          + w_cohesion * (spy / n_safe - rpy) * has)
    return fx * ra, fy * ra


def _mxu_forces(row_pos, row_vel, row_active, col_pos, feat_t, sep_t, *,
                neighbor_radius, separation_radius, **weights):
    neigh, w_hi, w_lo = _pair_masks(
        row_pos[:, 0:1], row_pos[:, 1:2], col_pos[None, :, 0],
        col_pos[None, :, 1], neighbor_radius=neighbor_radius,
        separation_radius=separation_radius)
    # bf16 x bf16 products are exact in f32: the plain version multiplies
    # the upcast operands in f32 (with TF32 off on the card).
    feat, sep = feat_t.to(torch.float32), sep_t.to(torch.float32)
    acc_n = feat @ neigh.to(torch.float32).T  # [10, R]
    acc_w = sep @ w_hi.to(torch.float32).T + sep @ w_lo.to(torch.float32).T
    fx, fy = _combine_forces(
        _acc_sums(acc_n, acc_w), row_pos[:, 0], row_pos[:, 1],
        row_vel[:, 0], row_vel[:, 1], row_active, **weights)
    return torch.stack([fx, fy], dim=1)


def _feats_of(pos, vel, active):
    return _lane_feats(pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], active)


@per_branch
def pairwise_force_rows_mxu2_plain(
    row_pos: torch.Tensor,  # f32[R, 2]
    row_vel: torch.Tensor,  # f32[R, 2]
    all_pos: torch.Tensor,  # f32[N, 2]
    all_vel: torch.Tensor,  # f32[N, 2]
    row_active: torch.Tensor,  # f32[R]
    all_active: torch.Tensor,  # f32[N]
    **params,
) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core kernel: the bf16 pair
    matrices over dense ``[R, N]`` tensors, one f32 product each (a branch
    at a time over a leading ``[B]``)."""
    feat_t, sep_t = _feats_of(all_pos, all_vel, all_active)
    return _mxu_forces(row_pos, row_vel, row_active, all_pos, feat_t, sep_t,
                       **params)


@per_branch
def pairwise_force_square_mxu_tri_plain(
    pos: torch.Tensor,  # f32[N, 2]
    vel: torch.Tensor,  # f32[N, 2]
    active: torch.Tensor,  # f32[N]
    **params,
) -> torch.Tensor:
    """Plain PyTorch version of the triangle kernel: the same function,
    every boid against every boid, over the full ``[N, N]`` pair matrices
    (building each pair's masks once is the kernel's saving); a branch at
    a time over a leading ``[B]``."""
    feat_t, sep_t = _feats_of(pos, vel, active)
    return _mxu_forces(pos, vel, active, pos, feat_t, sep_t, **params)


def _launch_params(neighbor_radius, separation_radius, w_separation,
                   w_alignment, w_cohesion):
    return (_squared(neighbor_radius), _squared(separation_radius),
            float(np.float32(w_separation)), float(np.float32(w_alignment)),
            float(np.float32(w_cohesion)))


MXU_TILE = 64  # the tensor-core kernels' tile edge (csrc/pair_mxu.cuh kTile)
_CLUSTER_SIZES = (1, 2, 4, 8)  # 8 is the portable thread-block cluster limit


def mxu2_launch_shape(r: int, n: int) -> Tuple[int, int]:
    """``(P, row_blocks)`` of the general tensor-core kernel for ``r`` rows
    and ``n`` columns: each 64-row block's column tiles are split over a
    cluster of ``P`` blocks, and the grid is ``row_blocks * P`` blocks.
    ``P`` doubles from 1 while ``row_blocks * P`` is short of the SMs and
    every block of the cluster still gets a column tile."""
    row_blocks = -(-r // MXU_TILE)
    tiles = -(-n // MXU_TILE)
    p = _CLUSTER_SIZES[0]
    for bigger in _CLUSTER_SIZES[1:]:
        if row_blocks * p >= _SMS or bigger > tiles:
            break
        p = bigger
    return p, row_blocks


def mxu2_tile_ranges(n: int, p: int) -> Tuple[Tuple[int, int], ...]:
    """The column tiles ``[start, end)`` that each block rank of a cluster
    of ``p`` walks, as ``csrc/pairwise_mxu.cu`` splits them."""
    tiles = -(-n // MXU_TILE)
    return tuple((q * tiles // p, (q + 1) * tiles // p) for q in range(p))


def pairwise_force_rows_mxu2(
    row_pos: torch.Tensor,
    row_vel: torch.Tensor,
    all_pos: torch.Tensor,
    all_vel: torch.Tensor,
    row_active: torch.Tensor,
    all_active: torch.Tensor,
    **params,
) -> torch.Tensor:
    """``f32[R, 2]`` flocking force on each row boid from all boids, the
    sums on the tensor cores (``[B, R, 2]`` over a leading branch axis).
    ``params`` are the five floats of :func:`pairwise_force_rows`.

    A CPU tensor takes :func:`pairwise_force_rows_mxu2_plain`; a CUDA
    tensor launches ``csrc/pairwise_mxu.cu`` once on the current stream, as
    clusters of :func:`mxu2_launch_shape` for every branch, and the kernel
    builds the feature stacks itself. Anything it cannot take, and a
    cluster launch the card refuses, raises."""
    args = (row_pos, row_vel, all_pos, all_vel, row_active, all_active)
    device, B, R, N = _rows_operands(*args)
    if device.type == "cpu":
        return pairwise_force_rows_mxu2_plain(*args, **params)
    p, _ = mxu2_launch_shape(R, N)
    out = torch.empty(row_pos.shape, dtype=torch.float32, device=device)
    fn = _build.function("pairwise_mxu", "ggrs_pairwise_force_rows_mxu",
                         _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(row_pos.data_ptr(), row_vel.data_ptr(), row_active.data_ptr(),
                 all_pos.data_ptr(), all_vel.data_ptr(), all_active.data_ptr(),
                 out.data_ptr(), B, R, N, p, *_launch_params(**params),
                 stream)
    _build.check(err, "pairwise_force_rows_mxu2")
    pairwise_force_rows_mxu2.launches += 1
    return out


pairwise_force_rows_mxu2.launches = 0

_TRI_PARTS = 16  # accumulator rows kept per boid and tile side

_TRI_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def tri_scratch_shape(n: int) -> Tuple[int, int, int, int]:
    """Shape of the triangle kernel's partial-sum scratch: for each side
    (row side, then column side) one ``[16, 64]`` block per upper-triangle
    tile, in the tile order of :func:`tri_tile_of`. A batched call
    allocates one such scratch a branch, ``[B, *tri_scratch_shape(N)]``."""
    nb = -(-n // MXU_TILE)
    return 2, nb * (nb + 1) // 2, _TRI_PARTS, MXU_TILE


def _strip_start(ri: int, nb: int) -> int:
    return ri * (2 * nb - ri + 1) // 2


def tri_tile_of(b: int, nb: int) -> Tuple[int, int]:
    """The tile ``(ri, cj >= ri)`` that block ``b`` of the triangle
    kernel's tile pass takes among ``nb`` strips: the ``b``-th tile of the
    upper triangle in row-major order, as ``tile_of`` in
    ``csrc/pairwise_tri.cu`` computes it (the root of the strip's start,
    then put right in integers)."""
    m = 2.0 * nb + 1.0
    r = int((m - np.sqrt(m * m - 8.0 * b)) * 0.5)
    r = max(0, min(r, nb - 1))
    while r > 0 and _strip_start(r, nb) > b:
        r -= 1
    while r + 1 < nb and _strip_start(r + 1, nb) <= b:
        r += 1
    return r, r + b - _strip_start(r, nb)


def pairwise_force_square_mxu_tri(
    pos: torch.Tensor,
    vel: torch.Tensor,
    active: torch.Tensor,
    **params,
) -> torch.Tensor:
    """``f32[N, 2]`` all-vs-all flocking force, each pair's masks built once
    for both boids (square case only: every boid is a row and a column);
    ``[B, N, 2]`` over a leading branch axis.

    A CPU tensor takes :func:`pairwise_force_square_mxu_tri_plain`; a CUDA
    tensor launches the two passes of ``csrc/pairwise_tri.cu`` on the
    current stream, each over every branch, with their partial-sum scratch
    allocated here; the kernel builds the feature tiles itself, so nothing
    but ``torch.empty`` runs here. Anything it cannot take raises."""
    lead = _branch_axes(pos, 2)
    N = pos.shape[-2]
    device = _check_inputs(pos=(pos, lead + (N, 2)), vel=(vel, lead + (N, 2)),
                           active=(active, lead + (N,)))
    if device.type == "cpu":
        return pairwise_force_square_mxu_tri_plain(pos, vel, active, **params)
    part = torch.empty(lead + tri_scratch_shape(N), dtype=torch.float32,
                       device=device)
    out = torch.empty(pos.shape, dtype=torch.float32, device=device)
    fn = _build.function("pairwise_tri", "ggrs_pairwise_force_square_tri",
                         _TRI_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), vel.data_ptr(), active.data_ptr(),
                 part.data_ptr(), out.data_ptr(), lead[0] if lead else 1, N,
                 *_launch_params(**params), stream)
    _build.check(err, "pairwise_force_square_mxu_tri")
    pairwise_force_square_mxu_tri.launches += 1
    return out


pairwise_force_square_mxu_tri.launches = 0
