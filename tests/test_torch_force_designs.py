"""PyTorch port, the designs of the f32 force kernel and the triangle
tensor-core kernel, checked where the CPU can check them: float32 numpy
emulations of the orders in which ``csrc/pairwise.cu`` and
``csrc/pairwise_tri.cu`` sum, held against the port's plain versions and
the JAX package's Pallas kernels (interpret mode), and the launch shapes
and tile mapping that the wrappers and kernels share.

- The f32 kernel gives each row a warp: lane ``l`` sums the columns
  ``l, l + 32, ...`` in ascending order, and the 32 lane sums meet in a
  ``__shfl_xor_sync`` tree (offsets 16, 8, 4, 2, 1), read at lane 0.
  Another order of the same float32 terms: ``atol=2e-6``, the JAX suite's
  tolerance for this kernel (``tests/test_ops.py``).
- The triangle's tile pass writes each upper tile's row-side and
  column-side partial sums to scratch; its combine gives each (boid,
  accumulator row) a thread but adds the partials in the order of the
  design before it (one thread per boid): the row side in ascending column
  tile, the column side in ascending row tile, then the two. The
  emulations of both combines are bitwise equal, and the forces are
  within the tensor-core tolerances of ``tests/test_torch_mxu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops import pairwise as jpw
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import pairwise as tpw

F32 = np.float32
FORCE_ATOL = 2e-6
SAME_KERNEL_RTOL = 1e-5
XLA_RTOL = 1e-3
PARAMS = tboids._kernel_params()
NR2 = F32(tpw._squared(PARAMS["neighbor_radius"]))
SR2 = F32(tpw._squared(PARAMS["separation_radius"]))
WS, WA, WC = (F32(PARAMS[k]) for k in ("w_separation", "w_alignment", "w_cohesion"))
SIZES = [1, 64, 65, 1000, 1024, 4096, 4100]


def flock(n, seed, half=2.5):
    """Positions dense enough that every boid has neighbours and some sit
    inside the separation radius; every 7th boid inactive."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-half, half, size=(n, 2)).astype(F32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(F32)
    active = np.ones(n, F32)
    active[::7] = 0.0
    return pos, vel, active


# --- the f32 force kernel: a warp per row


def warp_per_row_forces(rows, cols):
    """``csrc/pairwise.cu``'s order in float32, one rounding per
    operation: per lane the columns of ``force_rows_lane_columns`` from
    +0, then the xor tree, then the combine."""
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    lanes = np.zeros((7, rp.shape[0], tpw.FORCE_LANES), F32)
    for lane in range(tpw.FORCE_LANES):
        for j in tpw.force_rows_lane_columns(cp.shape[0], lane):
            dx = rp[:, 0] - cp[j, 0]
            dy = rp[:, 1] - cp[j, 1]
            d2 = dx * dx + dy * dy
            both = ra * ca[j]
            not_self = F32(1) - (d2 < F32(1e-10)).astype(F32)
            neigh = both * (d2 < NR2).astype(F32) * not_self
            close = neigh * (d2 < SR2).astype(F32)
            inv_d = F32(1) / np.sqrt(np.maximum(d2, F32(1e-12)))
            for t, term in enumerate((neigh, dx * inv_d * close, dy * inv_d * close,
                                      cv[j, 0] * neigh, cv[j, 1] * neigh,
                                      cp[j, 0] * neigh, cp[j, 1] * neigh)):
                lanes[t, :, lane] += term
    ids = np.arange(tpw.FORCE_LANES)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, ids ^ off]
    n, sx, sy, svx, svy, spx, spy = lanes[:, :, 0]
    n_safe = np.maximum(n, F32(1))
    has = (n > 0).astype(F32)
    fx = WS * sx + WA * (svx / n_safe - rv[:, 0]) * has + WC * (spx / n_safe - rp[:, 0]) * has
    fy = WS * sy + WA * (svy / n_safe - rv[:, 1]) * has + WC * (spy / n_safe - rp[:, 1]) * has
    return np.stack([fx * ra, fy * ra], axis=1)


def f32_references(rows, cols):
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    plain = tpw.pairwise_force_rows_plain(
        *[torch.from_numpy(a) for a in (rp, rv, cp, cv, ra, ca)], **PARAMS).numpy()
    pallas = jpw.pairwise_force_rows_pallas(
        *[jnp.asarray(a) for a in (rp, rv, cp, cv, ra, ca)], col_block=128,
        interpret=True, **jboids._kernel_params())
    return plain, np.asarray(pallas)


@pytest.mark.parametrize("n,seed", [(40, 0), (200, 1), (300, 2), (300, 3)])
def test_warp_per_row_order_matches_plain_and_jax(n, seed):
    f = flock(n, seed)
    got = warp_per_row_forces(f, f)
    assert np.abs(got).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_array_equal(got[::7], 0.0)  # inactive rows
    for want in f32_references(f, f):
        np.testing.assert_allclose(got, want, rtol=0, atol=FORCE_ATOL)


def test_warp_per_row_order_on_a_row_subset():
    """Rows 32..64 of 128 against all 128 columns: the sharded caller's
    row-subset contract."""
    pos, vel, active = flock(128, seed=4)
    rows, cols = (pos[32:64], vel[32:64], active[32:64]), (pos, vel, active)
    got = warp_per_row_forces(rows, cols)
    for want in f32_references(rows, cols):
        np.testing.assert_allclose(got, want, rtol=0, atol=FORCE_ATOL)
    np.testing.assert_array_equal(got, warp_per_row_forces(cols, cols)[32:64])


@pytest.mark.parametrize("r", SIZES + [5, 20, 256])
def test_force_launch_shape_covers_every_row_and_column_once(r):
    w, blocks = tpw.force_rows_launch_shape(r)
    assert w in (1, 2, 4, 8) and blocks == -(-r // w)
    rows = [b * w + k for b in range(blocks) for k in range(w)]
    assert [i for i in rows if i < r] == list(range(r))  # the rest idle
    assert 2 * blocks >= 132 or w == 1  # fewer blocks only with one row each
    if w < 8:  # a larger block was declined: it would leave SMs idle
        assert 2 * -(-r // (2 * w)) < 132
    n = r  # columns: the lanes' strided sets partition them, ascending
    cols = [list(tpw.force_rows_lane_columns(n, lane)) for lane in range(tpw.FORCE_LANES)]
    assert all(c == sorted(c) for c in cols)
    assert sorted(j for c in cols for j in c) == list(range(n))


def test_force_launch_shape_at_the_main_path():
    assert tpw.force_rows_launch_shape(1024) == (8, 128)  # 32 pairs a thread
    assert tpw.force_rows_launch_shape(256) == (2, 128)
    assert tpw.force_rows_launch_shape(4096) == (8, 512)


# --- the triangle kernel: tile mapping, scratch and combine order


@pytest.mark.parametrize("n", SIZES + [32768])
def test_tri_tile_mapping_covers_every_upper_tile_once(n):
    nb = -(-n // tpw.MXU_TILE)
    sides, tiles, parts, width = tpw.tri_scratch_shape(n)
    assert (sides, parts, width) == (2, 16, tpw.MXU_TILE)
    got = [tpw.tri_tile_of(b, nb) for b in range(tiles)]
    want = [(ri, cj) for ri in range(nb) for cj in range(ri, nb)]
    assert got == want  # each once, in row-major order: no idle block


def tri_partials(pos, vel, active):
    """What the tile pass writes: ``part[side][b][q][t]`` for the b-th
    upper tile, rows ``q < 10`` the neighbour sums and ``10..15`` the
    separation sums, in float32 from the same bf16 operands."""
    n = pos.shape[0]
    nb = -(-n // tpw.MXU_TILE)
    pad = nb * tpw.MXU_TILE - n
    t = [torch.from_numpy(np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)))
         for a in (pos, vel, active)]
    feat, sep = (x.to(torch.float32) for x in tpw._feats_of(*t))
    part = np.zeros(tpw.tri_scratch_shape(n), F32)
    for b in range(part.shape[1]):
        ri, cj = tpw.tri_tile_of(b, nb)
        r = slice(ri * tpw.MXU_TILE, (ri + 1) * tpw.MXU_TILE)
        c = slice(cj * tpw.MXU_TILE, (cj + 1) * tpw.MXU_TILE)
        rp, cp = t[0][r], t[0][c]
        neigh, w_hi, w_lo = (m.to(torch.float32) for m in tpw._pair_masks(
            rp[:, 0:1], rp[:, 1:2], cp[None, :, 0], cp[None, :, 1],
            neighbor_radius=PARAMS["neighbor_radius"],
            separation_radius=PARAMS["separation_radius"]))
        neigh[:, max(0, n - cj * tpw.MXU_TILE):] = 0  # columns past N
        w_hi[:, max(0, n - cj * tpw.MXU_TILE):] = 0
        w_lo[:, max(0, n - cj * tpw.MXU_TILE):] = 0
        part[0, b, :10] = (feat[:, c] @ neigh.T).numpy()
        part[0, b, 10:] = (sep[:, c] @ w_hi.T + sep[:, c] @ w_lo.T).numpy()
        if cj > ri:
            part[1, b, :10] = (feat[:, r] @ neigh).numpy()
            part[1, b, 10:] = (sep[:, r] @ w_hi + sep[:, r] @ w_lo).numpy()
    return part


def combine_one_thread_per_boid(part, nb):
    """The combine of the design before: each boid's thread adds all 16
    rows, row side over ascending cj, then column side over ascending ri,
    each from +0, then the two."""
    s = np.zeros(part.shape[2:] + (nb,), F32)  # [q, t, strip]
    for k in range(nb):
        acc, cacc = np.zeros(part.shape[2:], F32), np.zeros(part.shape[2:], F32)
        for cj in range(k, nb):
            acc = acc + part[0, tpw._strip_start(k, nb) + cj - k]
        for ri in range(k):
            cacc = cacc + part[1, tpw._strip_start(ri, nb) + k - ri]
        s[..., k] = acc + cacc
    return s


def combine_thread_per_row(part, nb, ahead=8):
    """``tri_combine_kernel``'s order: each (accumulator row, boid) a
    thread, its partials loaded ``ahead`` at a time and added in
    ascending order from +0 (``sum_partials``), row side then column
    side, then the two."""
    def sum_partials(n, offset, q, t):
        s = F32(0)
        for j0 in range(0, n, ahead):
            v = [part.flat[offset(j) + q * part.shape[3] + t] if j < n else F32(0)
                 for j in range(j0, j0 + ahead)]
            for j, x in zip(range(j0, j0 + ahead), v):
                if j < n:
                    s = F32(s + x)
        return s

    stride = part.shape[2] * part.shape[3]
    side = part.shape[1] * stride
    out = np.zeros(part.shape[2:] + (nb,), F32)
    for k in range(nb):
        for q in range(part.shape[2]):
            for t in range(part.shape[3]):
                s = sum_partials(nb - k, lambda j: (tpw._strip_start(k, nb) + j) * stride, q, t)
                c = sum_partials(k, lambda ri: side + (tpw._strip_start(ri, nb) + k - ri) * stride,
                                 q, t)
                out[q, t, k] = s + c
    return out


def forces_from_sums(sums, pos, vel, active):
    """The kernel's ``combine`` over the summed rows ``[16, N]``."""
    acc = torch.from_numpy(np.ascontiguousarray(sums))
    fx, fy = tpw._combine_forces(
        tpw._acc_sums(acc[:10], acc[10:]),
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in (
            pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], active)],
        w_separation=PARAMS["w_separation"], w_alignment=PARAMS["w_alignment"],
        w_cohesion=PARAMS["w_cohesion"])
    return torch.stack([fx, fy], dim=1).numpy()


@pytest.mark.parametrize("n", [64, 130])
def test_tri_combine_keeps_the_earlier_order_bitwise(n):
    pos, vel, active = flock(n, seed=n, half=2.0)
    nb = -(-n // tpw.MXU_TILE)
    part = tri_partials(pos, vel, active)
    before = combine_one_thread_per_boid(part, nb)
    now = combine_thread_per_row(part, nb)
    assert np.array_equal(before.view(np.uint32), now.view(np.uint32))


@pytest.mark.parametrize("n", [64, 200, 300])
def test_tri_kernel_order_matches_plain_and_jax(n):
    pos, vel, active = flock(n, seed=n, half=2.0)
    nb = -(-n // tpw.MXU_TILE)
    sums = combine_thread_per_row(tri_partials(pos, vel, active), nb)
    # [q, t, strip] -> [q, boid], boid = strip * 64 + t
    got = forces_from_sums(sums.transpose(0, 2, 1).reshape(16, -1)[:, :n],
                           pos, vel, active)
    plain = tpw.pairwise_force_square_mxu_tri_plain(
        *[torch.from_numpy(a) for a in (pos, vel, active)], **PARAMS).numpy()
    tri = np.asarray(jpw.pairwise_force_square_mxu_tri(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(active), block=128,
        interpret=True, **jboids._kernel_params()))
    xla = np.asarray(jboids.pairwise_force_rows(
        *[jnp.asarray(a) for a in (pos, vel, pos, vel, active, active)]))
    scale = np.abs(xla).max()
    assert scale > 1e-2
    for same_kernel in (plain, tri):
        np.testing.assert_allclose(got, same_kernel, rtol=0, atol=SAME_KERNEL_RTOL * scale)
    np.testing.assert_allclose(got, xla, rtol=0, atol=max(XLA_RTOL * scale, 1e-6))
    np.testing.assert_array_equal(got[::7], 0.0)
