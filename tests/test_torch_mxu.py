"""PyTorch port, the tensor-core force kernels: the plain versions of
``pairwise_force_rows_mxu2`` and ``pairwise_force_square_mxu_tri`` against
the JAX package's kernels of the same names (interpret mode, small
blocks, as its own tests run them off a TPU) and against its dense XLA
forces, plus the schedule's static dispatch between the two.

Tolerances, relative to the largest force:
- against the same-named JAX kernel, ``1e-5``: both multiply the same
  bf16 hi/lo operands, whose products are exact in f32, so only the order
  of the f32 sums (128-column blocks against one product) and an ulp of
  ``rsqrt`` differ (about 3e-6 measured);
- against the dense f32 XLA forces, ``1e-3`` with a ``1e-6`` floor, the
  JAX suite's own tolerance for these kernels (``tests/test_ops.py``):
  the hi/lo split keeps about 16 bits of each operand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops import pairwise as jpw
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.schedule import PlayerInputs

SAME_KERNEL_RTOL = 1e-5
XLA_RTOL = 1e-3


def flock(n, seed):
    """The JAX suite's flock (tests/test_ops.py): every 7th boid
    inactive."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-2, 2, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(np.float32)
    active = np.ones(n, np.float32)
    active[::7] = 0.0
    return pos, vel, active


def check_close(got, same_kernel, xla):
    scale = np.abs(xla).max()
    assert scale > 1e-2  # the forces are not trivially small
    np.testing.assert_allclose(got, same_kernel, rtol=0,
                               atol=SAME_KERNEL_RTOL * scale)
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=max(XLA_RTOL * scale, 1e-6))


def jax_rows(rows, cols):
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    args = [jnp.asarray(a) for a in (rp, rv, cp, cv, ra, ca)]
    mxu = jpw.pairwise_force_rows_mxu2(*args, col_block=128,
                                       **jboids._kernel_params())
    return np.asarray(mxu), np.asarray(jboids.pairwise_force_rows(*args))


def torch_rows(rows, cols):
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    t = [torch.from_numpy(a) for a in (rp, rv, cp, cv, ra, ca)]
    return tpw.pairwise_force_rows_mxu2(*t, **tboids._kernel_params()).numpy()


@pytest.mark.parametrize("n", [64, 200, 300])
def test_mxu2_plain_matches_jax(n):
    f = flock(n, seed=n)
    got = torch_rows(f, f)
    check_close(got, *jax_rows(f, f))
    np.testing.assert_array_equal(got[::7], 0.0)  # inactive rows


def test_mxu2_row_subset_matches_jax():
    """Rows 32..64 of 128 against all 128 columns: the sharded caller's
    row-subset contract."""
    pos, vel, active = flock(128, seed=5)
    rows, cols = (pos[32:64], vel[32:64], active[32:64]), (pos, vel, active)
    got = torch_rows(rows, cols)
    check_close(got, *jax_rows(rows, cols))
    np.testing.assert_array_equal(got, torch_rows(cols, cols)[32:64])


@pytest.mark.parametrize("n", [256, 300, 512])
def test_tri_plain_matches_jax(n):
    """n = 300 pads the JAX triangle's last 128-block."""
    pos, vel, active = flock(n, seed=n)
    params = jboids._kernel_params()
    tri = jpw.pairwise_force_square_mxu_tri(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(active), block=128,
        **params)
    xla = jboids.pairwise_force_rows(
        *[jnp.asarray(a) for a in (pos, vel, pos, vel, active, active)])
    got = tpw.pairwise_force_square_mxu_tri(
        *[torch.from_numpy(a) for a in (pos, vel, active)],
        **tboids._kernel_params()).numpy()
    check_close(got, np.asarray(tri), np.asarray(xla))
    np.testing.assert_array_equal(got[::7], 0.0)


def test_hi_lo_split_is_bitwise_jax():
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 10.0
    jhi, jlo = jpw._hi_lo(jnp.asarray(x))
    thi, tlo = tpw._hi_lo(torch.from_numpy(x))
    np.testing.assert_array_equal(thi.float().numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(tlo.float().numpy(), np.asarray(jlo, np.float32))


def test_feature_stacks_are_bitwise_jax():
    pos, vel, active = flock(200, seed=3)
    cols = [pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], active]
    jfeat, jsep = jpw._lane_feats(*[jnp.asarray(c)[None, :] for c in cols])
    tfeat, tsep = tpw._lane_feats(*[torch.from_numpy(c.copy()) for c in cols])
    assert tfeat.shape == (10, 200) and tsep.shape == (6, 200)
    assert tfeat.dtype == tsep.dtype == torch.bfloat16
    np.testing.assert_array_equal(tfeat.float().numpy(), np.asarray(jfeat, np.float32))
    np.testing.assert_array_equal(tsep.float().numpy(), np.asarray(jsep, np.float32))


def test_pair_masks_match_jax():
    """The neighbour mask is bitwise (f32 d² and compares); the weight
    halves agree to an ulp of rsqrt, and no inf or NaN reaches them."""
    pos, _, _ = flock(150, seed=4)
    pos[7] = pos[3]  # a coincident pair: d² = 0, outside the mask
    r, c = pos[:, None, :], pos[None, :, :]
    kw = dict(neighbor_radius=float(jboids.NEIGHBOR_RADIUS),
              separation_radius=float(jboids.SEPARATION_RADIUS))
    jn, jhi, jlo = jpw._pair_masks(
        jnp.asarray(r[..., 0]), jnp.asarray(r[..., 1]),
        jnp.asarray(c[..., 0]), jnp.asarray(c[..., 1]), **kw)
    tn, thi, tlo = tpw._pair_masks(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in
          (r[..., 0], r[..., 1], c[..., 0], c[..., 1])], **kw)
    np.testing.assert_array_equal(tn.float().numpy(), np.asarray(jn, np.float32))
    jw = np.asarray(jhi, np.float32) + np.asarray(jlo, np.float32)
    tw = (thi.float() + tlo.float()).numpy()
    assert np.isfinite(tw).all() and tw[3, 7] == tw[7, 3] == 0.0
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)


def test_acc_sums_and_combine_match_jax():
    rng = np.random.RandomState(6)
    acc_n = rng.rand(10, 32).astype(np.float32) * 5
    acc_n[0] = np.round(acc_n[0])
    acc_n[0, :4] = 0.0  # rows with no neighbours
    acc_n[5] = 0.0
    acc_w = rng.randn(6, 32).astype(np.float32)
    rows = [rng.randn(32).astype(np.float32) for _ in range(4)] + [
        (rng.rand(32) > 0.3).astype(np.float32)]
    w = dict(w_separation=float(jboids.W_SEPARATION),
             w_alignment=float(jboids.W_ALIGNMENT),
             w_cohesion=float(jboids.W_COHESION))
    jn, jw = jnp.asarray(acc_n), jnp.asarray(acc_w)
    jfx, jfy = jpw._combine_forces(jpw._acc_sums(jn, jw),
                                   *[jnp.asarray(r)[None, :] for r in rows], **w)
    tfx, tfy = tpw._combine_forces(
        tpw._acc_sums(torch.from_numpy(acc_n), torch.from_numpy(acc_w)),
        *[torch.from_numpy(r) for r in rows], **w)
    np.testing.assert_allclose(tfx.numpy(), np.asarray(jfx)[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tfy.numpy(), np.asarray(jfy)[0], rtol=1e-6, atol=1e-7)


def test_flock_mxu_step_matches_jax():
    """One step of the JAX package's ``make_schedule(kernel="mxu")`` and
    the port's, on a CPU world of 200 boids: within the same-kernel
    tolerance, and bitwise with itself."""
    bits = np.array([tboids.INPUT_RIGHT, 0], np.uint8)
    jstate = jboids.make_world(200, 2).commit()
    jout = jboids.make_schedule(kernel="mxu")(jstate, make_inputs(jnp.asarray(bits)))
    tstate = tboids.make_world(200, 2, device="cpu").commit()
    inputs = PlayerInputs(torch.from_numpy(bits), torch.zeros(2, dtype=torch.int32))
    step = tboids.make_schedule(kernel="mxu")
    a, b = step(tstate, inputs), step(tstate, inputs)
    for name in ("position", "velocity"):
        np.testing.assert_allclose(a.components[name].numpy(),
                                   np.asarray(jout.components[name]),
                                   rtol=0, atol=1e-6)
        assert torch.equal(a.components[name], b.components[name])


def _spy(monkeypatch, name, calls):
    def fake(pos, vel, *args, **params):
        calls.append((name, pos.shape[0]))
        return torch.zeros_like(pos)

    monkeypatch.setattr(tpw, name, fake)


@pytest.mark.parametrize("n,kernel", [(4095, "pairwise_force_rows_mxu2_plain"),
                                      (4096, "pairwise_force_square_mxu_tri_plain")])
def test_mxu_schedule_picks_the_triangle_from_4096(monkeypatch, n, kernel):
    """The dispatch is static by world size, as in JAX
    (``bevy_ggrs_tpu/models/boids.py:170``)."""
    calls = []
    for name in ("pairwise_force_rows_mxu2_plain",
                 "pairwise_force_square_mxu_tri_plain"):
        _spy(monkeypatch, name, calls)
    state = tboids.make_world(n, 2, device="cpu").commit()
    inputs = PlayerInputs(torch.zeros(2, dtype=torch.uint8),
                          torch.zeros(2, dtype=torch.int32))
    tboids.make_schedule(kernel="mxu")(state, inputs)
    assert calls == [(kernel, n)]


def test_wrappers_check_inputs_and_never_launch_on_cpu():
    pos, vel, active = (torch.from_numpy(a) for a in flock(16, seed=1))
    params = tboids._kernel_params()
    before = (tpw.pairwise_force_rows_mxu2.launches,
              tpw.pairwise_force_square_mxu_tri.launches)
    tpw.pairwise_force_rows_mxu2(pos, vel, pos, vel, active, active, **params)
    tpw.pairwise_force_square_mxu_tri(pos, vel, active, **params)
    assert (tpw.pairwise_force_rows_mxu2.launches,
            tpw.pairwise_force_square_mxu_tri.launches) == before
    with pytest.raises(ValueError, match="float32"):
        tpw.pairwise_force_rows_mxu2(pos.double(), vel, pos, vel, active,
                                     active, **params)
    with pytest.raises(ValueError, match="active"):
        tpw.pairwise_force_square_mxu_tri(pos, vel, active[:-1], **params)


def test_tri_scratch_holds_one_block_per_upper_tile():
    """One buffer: the row side's blocks, then the column side's."""
    assert tpw.tri_scratch_shape(4096) == (2, 64 * 65 // 2, 16, 64)
    assert tpw.tri_scratch_shape(4100) == (2, 65 * 66 // 2, 16, 64)
    assert tpw.tri_scratch_shape(1) == (2, 1, 16, 64)
