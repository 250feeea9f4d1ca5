"""PyTorch port, the force kernels over a leading branch axis (boids under
speculation).

Each wrapper (``pairwise_force_rows``, ``pairwise_force_rows_mxu2``,
``pairwise_force_square_mxu_tri``, ``cell_slot_forces``) and
``neighbor.interact`` in grid mode takes a world stacked over B branches.
On the CPU the batched result is bitwise the per-branch one (the plain
versions loop over the branches), and allclose to ``jax.vmap`` of the JAX
package's Pallas function, run in interpret mode as the JAX suite runs it
off a TPU, at the port's stated tolerances:

- ``atol=2e-6`` for the f32 kernel (the JAX suite's, ``tests/test_ops.py``);
- ``1e-4`` of the largest force for the tensor-core kernels on spawn-spiral
  flocks (same bf16 operands; f32 sums in another order);
- ``atol=1e-5`` for the cell kernel and the grid (``tests/test_neighbor.py``).

The port's ``SpeculativeExecutor`` on boids (pallas, mxu and grid) gives
JAX's positions within ``rtol=1e-5, atol=1e-6`` (the tolerance
``tests/test_boids.py`` holds its own paths to) and velocities within
``1e-4`` (the speed clamp magnifies the force paths' difference near
zero speed, the JAX suite's one-step mxu class), and its checksums are
bitwise the port's own serial burst, branch by branch. The mxu path picks
its kernel from the boid count ``shape[-2]``, never from B.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops import cell_gather as jcg
from bevy_ggrs_tpu.ops import neighbor as jnb
from bevy_ggrs_tpu.ops import pairwise as jpw
from bevy_ggrs_tpu.parallel import speculate as jspec
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import neighbor as tnb
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.parallel import speculate as tspec
from bevy_ggrs_tpu_torch.rollout import RolloutExecutor

F32_ATOL = 2e-6
MXU_RTOL = 1e-4
CELL_ATOL = 1e-5
P = 2


def branch_flocks(n, branches, seed):
    """``branches`` spawn-spiral flocks of ``n`` boids (``make_world``'s
    positions, each branch jittered by up to 0.02 and given velocities of
    its own), every 7th boid inactive: numpy ``pos [B, n, 2]``, ``vel``,
    ``active [B, n]``."""
    spiral = tboids.make_world(n, P, device="cpu").commit().components["position"].numpy()
    rng = np.random.RandomState(seed)
    pos = (spiral[None] + rng.uniform(-0.02, 0.02, (branches, n, 2))).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, (branches, n, 2)).astype(np.float32)
    active = np.ones((branches, n), np.float32)
    active[:, ::7] = 0.0
    return pos, vel, active


def per_branch(fn, args, branches):
    return torch.stack([fn(*(a[b] for a in args)) for b in range(branches)])


def rows_args(pos, vel, active):
    return tuple(torch.from_numpy(a) for a in (pos, vel, pos, vel, active, active))


PARAMS = tboids._kernel_params()
DENSE = {
    "f32": (lambda *a: tpw.pairwise_force_rows(*a, **PARAMS),
            lambda *a: jpw.pairwise_force_rows_pallas(*a, col_block=128, **PARAMS)),
    "mxu2": (lambda *a: tpw.pairwise_force_rows_mxu2(*a, **PARAMS),
             lambda *a: jpw.pairwise_force_rows_mxu2(*a, col_block=128, **PARAMS)),
}


@pytest.mark.parametrize("branches", [1, 3, 4])
@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("kernel", sorted(DENSE))
def test_rows_kernels_over_branches(kernel, n, branches):
    port, jax_fn = DENSE[kernel]
    pos, vel, active = branch_flocks(n, branches, seed=10 * n + branches)
    args = rows_args(pos, vel, active)
    got = port(*args)
    assert got.shape == (branches, n, 2)
    assert torch.equal(got, per_branch(port, args, branches))
    want = np.asarray(jax.vmap(jax_fn)(*(jnp.asarray(a.numpy()) for a in args)))
    scale = np.abs(want).max()
    assert scale > 1e-3
    atol = F32_ATOL if kernel == "f32" else MXU_RTOL * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.numpy()[:, ::7], 0.0)


@pytest.mark.parametrize("branches", [1, 3, 4])
@pytest.mark.parametrize("n", [64, 65])
def test_triangle_over_branches(n, branches):
    pos, vel, active = branch_flocks(n, branches, seed=20 * n + branches)
    args = tuple(torch.from_numpy(a) for a in (pos, vel, active))

    def port(*a):
        return tpw.pairwise_force_square_mxu_tri(*a, **PARAMS)

    got = port(*args)
    assert torch.equal(got, per_branch(port, args, branches))
    want = np.asarray(jax.vmap(
        lambda p, v, a: jpw.pairwise_force_square_mxu_tri(p, v, a, block=128, **PARAMS))(
            *(jnp.asarray(a) for a in (pos, vel, active))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MXU_RTOL * np.abs(want).max())


def grid_world(branches, n=256, seed=3):
    """``branches`` uniform flocks of ``n`` boids over ±3 (about 7 a cell of
    the grid), every 9th inactive: numpy ``pos``, ``vel``, ``active``."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3, 3, (branches, n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, (branches, n, 2)).astype(np.float32)
    active = np.ones((branches, n), np.float32)
    active[:, ::9] = 0.0
    return pos, vel, active


def torch_tables(pos, vel, active):
    feats = {"vx": torch.from_numpy(vel[..., 0].copy()),
             "vy": torch.from_numpy(vel[..., 1].copy())}
    grid, cand, padded = tnb.build_grid_tables(
        torch.from_numpy(pos), torch.from_numpy(active), tboids.grid_config(pos.shape[-2]),
        feats)
    return tnb.gather_tables(tboids.FLOCK_PAIR_KERNEL, grid.slots, cand, padded)


@pytest.mark.parametrize("branches", [1, 3, 4])
def test_cell_kernel_over_branches(branches):
    pos, vel, active = grid_world(branches)
    rowvals, colvals = torch_tables(pos, vel, active)
    assert rowvals["px"].dim() == 3 and rowvals["px"].shape[0] == branches
    kernel = tboids.FLOCK_PAIR_KERNEL
    got = tcg.cell_slot_forces(kernel, rowvals, colvals)
    for b in range(branches):
        one = tcg.cell_slot_forces(kernel, {k: v[b] for k, v in rowvals.items()},
                                   {k: v[b] for k, v in colvals.items()})
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))
    want = jax.vmap(lambda r, c: jcg.cell_slot_forces_pallas(jboids.FLOCK_PAIR_KERNEL, r, c))(
        {k: jnp.asarray(v.numpy()) for k, v in rowvals.items()},
        {k: jnp.asarray(v.numpy()) for k, v in colvals.items()})
    assert max(float(np.abs(np.asarray(w)).max()) for w in want) > 1e-3
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0, atol=CELL_ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("branches", [1, 3, 4])
def test_grid_interact_over_branches(branches, impl):
    pos, vel, active = grid_world(branches, seed=branches)
    config = tboids.grid_config(256)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(active)
    feats = {"vx": torch.from_numpy(vel[..., 0].copy()),
             "vy": torch.from_numpy(vel[..., 1].copy())}
    got, grid = tnb.interact(tp, ta, tboids.FLOCK_PAIR_KERNEL, feats, mode="grid",
                             config=config, impl=impl, return_grid=True)
    assert got.shape == (branches, 256, 2) and grid.slots.shape[0] == branches
    for b in range(branches):
        one = tnb.interact(tp[b], ta[b], tboids.FLOCK_PAIR_KERNEL,
                           {k: v[b] for k, v in feats.items()}, mode="grid",
                           config=config, impl=impl)
        assert torch.equal(got[b], one)
    want = jax.vmap(lambda p, a, vx, vy: jnb.interact(
        p, a, jboids.FLOCK_PAIR_KERNEL, {"vx": vx, "vy": vy}, mode="grid",
        config=jboids.grid_config(256), impl=impl))(
        jnp.asarray(pos), jnp.asarray(active), jnp.asarray(vel[..., 0]),
        jnp.asarray(vel[..., 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CELL_ATOL)


def test_spilling_grid_over_branches():
    """Clustered flocks overflow their cells: the spill pass runs a branch
    at a time, each bitwise its unbatched call."""
    rng = np.random.RandomState(8)
    pos = rng.uniform(-0.8, 0.8, (3, 300, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, (3, 300, 2)).astype(np.float32)
    tp, ta = torch.from_numpy(pos), torch.ones(3, 300)
    feats = {"vx": torch.from_numpy(vel[..., 0].copy()),
             "vy": torch.from_numpy(vel[..., 1].copy())}
    config = tboids.grid_config(300)
    got, grid = tnb.interact(tp, ta, tboids.FLOCK_PAIR_KERNEL, feats, mode="grid",
                             config=config, impl="pallas", return_grid=True)
    assert (grid.n_spilled > 0).all() and (grid.n_dropped == 0).all()
    for b in range(3):
        one = tnb.interact(tp[b], ta[b], tboids.FLOCK_PAIR_KERNEL,
                           {k: v[b] for k, v in feats.items()}, mode="dense")
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=0, atol=CELL_ATOL)
        single = tnb.interact(tp[b], ta[b], tboids.FLOCK_PAIR_KERNEL,
                              {k: v[b] for k, v in feats.items()}, mode="grid",
                              config=config, impl="pallas")
        assert torch.equal(got[b], single)


def test_one_branch_is_the_unbatched_call():
    pos, vel, active = branch_flocks(65, 1, seed=4)
    args = rows_args(pos, vel, active)
    for port, _ in DENSE.values():
        assert torch.equal(port(*args)[0], port(*(a[0] for a in args)))
    tri = tpw.pairwise_force_square_mxu_tri(*(torch.from_numpy(a) for a in (pos, vel, active)),
                                            **PARAMS)
    assert torch.equal(tri[0], tpw.pairwise_force_square_mxu_tri(
        *(torch.from_numpy(a[0]) for a in (pos, vel, active)), **PARAMS))


def test_branch_axis_checks_every_operand():
    pos, vel, active = (torch.from_numpy(a) for a in branch_flocks(16, 3, seed=1))
    with pytest.raises(ValueError, match="all_pos"):
        tpw.pairwise_force_rows_mxu2(pos, vel, pos[0], vel, active, active, **PARAMS)
    with pytest.raises(ValueError, match="active"):
        tpw.pairwise_force_square_mxu_tri(pos, vel, active[:2], **PARAMS)
    with pytest.raises(ValueError, match="axes"):
        tpw.pairwise_force_rows(pos[None], vel, pos, vel, active, active, **PARAMS)
    before = (tpw.pairwise_force_rows.launches, tpw.pairwise_force_rows_mxu2.launches,
              tpw.pairwise_force_square_mxu_tri.launches, tcg.cell_slot_forces.launches)
    tpw.pairwise_force_rows(pos, vel, pos, vel, active, active, **PARAMS)
    assert (tpw.pairwise_force_rows.launches, tpw.pairwise_force_rows_mxu2.launches,
            tpw.pairwise_force_square_mxu_tri.launches,
            tcg.cell_slot_forces.launches) == before  # the CPU never launches


# ---------------------------------------------------------------------------
# The speculative rollout on boids
# ---------------------------------------------------------------------------

B, FRAMES = 4, 3
ROLLOUTS = {  # (kernel, mode, boids)
    "pallas": ("pallas", "dense", 64),
    "mxu": ("mxu", "dense", 64),
    "grid": ("pallas", "grid", 256),
}


@pytest.mark.parametrize("path", sorted(ROLLOUTS))
def test_boids_rollout_against_jax_and_the_serial_burst(path):
    kernel, mode, n = ROLLOUTS[path]
    rng = np.random.RandomState(len(path))
    bits = rng.randint(0, 16, size=(B, FRAMES, P)).astype(np.uint8)
    state = tboids.make_world(n, P, device="cpu").commit()
    schedule = tboids.make_schedule(kernel=kernel, mode=mode)
    res = tspec.SpeculativeExecutor(schedule, B, FRAMES).run(state, 7, bits)
    jres = jspec.SpeculativeExecutor(jboids.make_schedule(kernel=kernel, mode=mode),
                                     B, FRAMES).run(jboids.make_world(n, P).commit(), 7, bits)
    np.testing.assert_allclose(res.states.components["position"].numpy(),
                               np.asarray(jres.states.components["position"]),
                               rtol=1e-5, atol=1e-6)
    # The speed clamp rescales near-zero velocities, which magnifies the
    # paths' ~1e-6 force difference: the JAX suite's one-step mxu class.
    np.testing.assert_allclose(res.states.components["velocity"].numpy(),
                               np.asarray(jres.states.components["velocity"]),
                               rtol=0, atol=1e-4)
    serial = RolloutExecutor(schedule, FRAMES + 2)
    for b in range(B):
        _, end, cs = serial.run(ts.ring_init(state, FRAMES), state, 7, bits[b],
                                np.ones((FRAMES, P), np.int32), n_frames=FRAMES)
        assert torch.equal(cs[:FRAMES], res.checksums[b]), (path, b)
        assert torch.equal(end.components["position"], res.states.components["position"][b])


@pytest.mark.parametrize("n,kernel", [(4095, "pairwise_force_rows_mxu2_plain"),
                                      (4096, "pairwise_force_square_mxu_tri_plain")])
def test_rollout_picks_the_kernel_from_the_boid_count(monkeypatch, n, kernel):
    """At a ``[B]`` world the mxu schedule reads N as ``shape[-2]``: 4,096
    boids take the triangle in the rollout, as in the serial burst, and
    4,095 the general kernel (``shape[0]`` would be B = 2)."""
    calls = []
    for name in ("pairwise_force_rows_mxu2_plain", "pairwise_force_square_mxu_tri_plain"):
        def spy(pos, vel, *args, name=name, **params):
            calls.append((name, tuple(pos.shape)))
            return torch.zeros_like(pos)
        monkeypatch.setattr(tpw, name, spy)
    state = tboids.make_world(n, P, device="cpu").commit()
    bits = np.zeros((2, 1, P), np.uint8)
    tspec.SpeculativeExecutor(tboids.make_schedule(kernel="mxu"), 2, 1).run(state, 0, bits)
    RolloutExecutor(tboids.make_schedule(kernel="mxu"), 2).run(
        ts.ring_init(state, 1), state, 0, bits[0], np.ones((1, P), np.int32), n_frames=1)
    assert calls == [(kernel, (2, n, 2)), (kernel, (n, 2))]
