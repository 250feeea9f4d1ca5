"""PyTorch port, dense boids forces: the plain version of the force kernel
against the JAX package's Pallas kernel (interpret mode, as its own tests
run it off a TPU) and its dense XLA path, within ``atol=2e-6``, the JAX
suite's own tolerance for this kernel (summation order and rsqrt differ
by ulps between the paths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops.pairwise import pairwise_force_rows_pallas
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import pairwise as tpw

ATOL = 2e-6


def flock(n, seed=0):
    """Positions dense enough that every boid has neighbours and some sit
    inside the separation radius; every 7th boid inactive."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-2.5, 2.5, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(np.float32)
    active = np.ones(n, np.float32)
    active[::7] = 0.0
    return pos, vel, active


def jax_forces(rows, cols):
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    args = [jnp.asarray(a) for a in (rp, rv, cp, cv, ra, ca)]
    pallas = pairwise_force_rows_pallas(*args, col_block=128,
                                        **jboids._kernel_params())
    dense = jboids.pairwise_force_rows(*args)
    return np.asarray(pallas), np.asarray(dense)


def torch_forces(rows, cols):
    (rp, rv, ra), (cp, cv, ca) = rows, cols
    t = [torch.from_numpy(a) for a in (rp, rv, cp, cv, ra, ca)]
    return tpw.pairwise_force_rows(*t, **tboids._kernel_params()).numpy()


@pytest.mark.parametrize("n", [64, 200, 300])
def test_plain_forces_match_jax(n):
    f = flock(n)
    got = torch_forces(f, f)
    pallas, dense = jax_forces(f, f)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)
    assert np.abs(got).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_array_equal(got[::7], 0.0)  # inactive rows


def test_row_subset_matches_jax():
    """Rows 32..64 of 128 against all 128 columns: the sharded caller's
    row-subset contract."""
    pos, vel, active = flock(128, seed=1)
    rows = (pos[32:64], vel[32:64], active[32:64])
    cols = (pos, vel, active)
    got = torch_forces(rows, cols)
    pallas, dense = jax_forces(rows, cols)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, torch_forces(cols, cols)[32:64],
                               rtol=0, atol=0)


def test_model_plain_forces_are_the_wrappers_plain_version():
    pos, vel, active = (torch.from_numpy(a) for a in flock(64, seed=2))
    a = tboids.pairwise_force_rows(pos, vel, pos, vel, active, active)
    b = tpw.pairwise_force_rows(pos, vel, pos, vel, active, active,
                                **tboids._kernel_params())
    assert torch.equal(a, b)


def test_wrapper_checks_inputs_and_never_launches_on_cpu():
    pos, vel, active = (torch.from_numpy(a) for a in flock(16))
    params = tboids._kernel_params()
    before = tpw.pairwise_force_rows.launches
    tpw.pairwise_force_rows(pos, vel, pos, vel, active, active, **params)
    assert tpw.pairwise_force_rows.launches == before
    with pytest.raises(ValueError, match="float32"):
        tpw.pairwise_force_rows(pos.double(), vel, pos, vel, active, active,
                                **params)
    with pytest.raises(ValueError, match="row_active"):
        tpw.pairwise_force_rows(pos, vel, pos, vel, active[:-1], active,
                                **params)
