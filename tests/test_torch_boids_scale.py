"""PyTorch port, boids at entity scale on the CPU: SyncTest rollback through
``GGRSPlugin`` with ``make_schedule(kernel="mxu")`` (dense) and with
``mode="grid"``, no ``MismatchedChecksum``, the first frames held against
the JAX package's schedules, and the schedule's mode resolution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu_torch.app import GGRSPlugin, SessionType
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import neighbor as tnb
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.schedule import PlayerInputs
from bevy_ggrs_tpu_torch.session import SyncTestSession

PLAYERS = 2
DT = 1.01 / 60.0  # one simulation step per update


def steer(handle, app):
    return np.uint8((app.session.current_frame + handle) % 16)


def boids_app(n, schedule):
    return (
        GGRSPlugin(tboids.INPUT_SPEC)
        .with_input_system(steer)
        .register_rollback_component("position", shape=(2,))
        .register_rollback_component("velocity", shape=(2,))
        .register_rollback_component("leader_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(schedule)
        .with_num_players(PLAYERS)
        .with_max_prediction_window(8)
        .with_world_capacity(n)
        .with_setup_system(lambda world, app: tboids.spawn_flock(world, n, PLAYERS))
        .with_device("cpu")
        .build()
    )


def jax_frames(schedule, n, frames):
    state = jboids.make_world(n, PLAYERS).commit()
    for frame in range(frames):
        bits = np.array([(frame + h) % 16 for h in range(PLAYERS)], np.uint8)
        state = schedule(state, make_inputs(jnp.asarray(bits)))
    return state


@pytest.mark.parametrize("n,mode,jax_schedule", [
    (64, "dense", lambda: jboids.make_schedule(kernel="mxu")),
    (300, "grid", lambda: jboids.make_schedule(kernel="xla", mode="grid")),
])
def test_synctest_runs_clean_and_matches_jax(n, mode, jax_schedule):
    frames, check_distance = 24, 4
    app = boids_app(n, tboids.make_schedule(kernel="mxu", mode=mode))
    app.insert_session(
        SyncTestSession(PLAYERS, tboids.INPUT_SPEC, check_distance=check_distance),
        SessionType.SYNC_TEST)
    app.run_for(5, dt=DT)  # the first update only arms the clock
    assert app.frame == 4
    after4 = app.world()
    want = jax_frames(jax_schedule(), n, 4)
    for name in ("position", "velocity"):
        np.testing.assert_allclose(after4["components"][name],
                                   np.asarray(want.components[name]),
                                   rtol=0, atol=1e-5)
    app.run_for(frames - 4, dt=DT)  # raises MismatchedChecksum on a desync
    assert app.frame == frames
    assert app.stage.runner.rollbacks_total == frames - check_distance
    assert np.isfinite(app.world()["components"]["position"]).all()


def test_grid_schedule_goes_through_the_cell_kernel_wrapper(monkeypatch):
    """mode="grid" routes the per-cell sums through ``cell_slot_forces``
    (its plain version here), whichever dense kernel was named."""
    calls = []
    real = tnb.cell_slot_forces

    def spy(kernel, rowvals, colvals):
        calls.append(kernel.name)
        return real(kernel, rowvals, colvals)

    monkeypatch.setattr(tnb, "cell_slot_forces", spy)
    state = tboids.make_world(200, PLAYERS, device="cpu").commit()
    inputs = PlayerInputs(torch.zeros(PLAYERS, dtype=torch.uint8),
                          torch.zeros(PLAYERS, dtype=torch.int32))
    for kernel in ("pallas", "mxu"):
        tboids.make_schedule(kernel=kernel, mode="grid")(state, inputs)
    assert calls == ["flock", "flock"]


def test_schedule_resolves_the_mode_at_each_step(monkeypatch):
    calls = []
    for module, name in ((tpw, "pairwise_force_rows_mxu2_plain"),
                         (tnb, "cell_slot_forces")):
        real = getattr(module, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    monkeypatch.delenv("GGRS_FORCE_MODE", raising=False)
    state = tboids.make_world(64, PLAYERS, device="cpu").commit()
    inputs = PlayerInputs(torch.zeros(PLAYERS, dtype=torch.uint8),
                          torch.zeros(PLAYERS, dtype=torch.int32))
    auto = tboids.make_schedule(kernel="mxu", mode="auto")
    auto(state, inputs)  # 64 < GRID_AUTO_THRESHOLD: dense
    monkeypatch.setenv("GGRS_FORCE_MODE", "grid")
    auto(state, inputs)
    tboids.make_schedule(kernel="mxu", mode="dense")(state, inputs)
    assert calls == ["pairwise_force_rows_mxu2_plain", "cell_slot_forces",
                     "pairwise_force_rows_mxu2_plain"]


def test_grid_and_dense_steps_agree():
    state = tboids.make_world(300, PLAYERS, device="cpu").commit()
    inputs = PlayerInputs(torch.tensor([tboids.INPUT_RIGHT, 0], dtype=torch.uint8),
                          torch.zeros(PLAYERS, dtype=torch.int32))
    dense = tboids.make_schedule(kernel="pallas", mode="dense")(state, inputs)
    grid = tboids.make_schedule(kernel="pallas", mode="grid")(state, inputs)
    for name in ("position", "velocity"):
        np.testing.assert_allclose(grid.components[name].numpy(),
                                   dense.components[name].numpy(),
                                   rtol=0, atol=1e-5)


def test_make_schedule_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="[Ss]harding"):
        tboids.make_schedule(kernel="xla")
    with pytest.raises(ValueError, match="kernel"):
        tboids.make_schedule(kernel="mosaic")
    with pytest.raises(ValueError, match="mode"):
        tboids.make_schedule(kernel="mxu", mode="sparse")


def test_flock_pair_kernel_names_its_instantiation():
    k = tboids.FLOCK_PAIR_KERNEL
    assert (k.name, k.out_dim, k.n_terms) == ("flock", 2, 7)
    assert k.row_names == k.col_names == ("px", "py", "active", "vx", "vy")
    assert k.params == tpw._launch_params(**tboids._kernel_params())
