"""PyTorch port, the slice as a whole on the CPU: SyncTest rollback through
``GGRSPlugin`` -> ``RollbackApp`` -> ``RollbackRunner`` for box_game and a
boids flock, held against the JAX package, plus desync detection and ring
corruption repair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.app import GGRSPlugin as JaxPlugin
from bevy_ggrs_tpu.app import SessionType as JaxSessionType
from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.schedule import Schedule as JaxSchedule
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu.session import SyncTestSession as JaxSyncTest
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import GGRSPlugin, SessionType
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.schedule import Schedule
from bevy_ggrs_tpu_torch.session import MismatchedChecksum, SyncTestSession

PLAYERS = 2
# A render frame a little longer than a simulation step: every update then
# runs exactly one step (the surplus stays under one step for 100 frames).
DT = 1.01 / 60.0


def scripted(handle, app):
    """Keys change every 3 frames, so cube speeds stay under the clamp
    where the jitted JAX step's fused magnitude would differ (see
    tests/test_torch_box_game.py)."""
    keys = [jbox.INPUT_UP, jbox.INPUT_RIGHT, jbox.INPUT_DOWN, 0]
    return np.uint8(keys[(app.session.current_frame // 3 + handle) % len(keys)])


def record(session):
    """Wrap ``report_checksum`` to log every (frame, checksum) reported."""
    log = []
    report = session.report_checksum

    def wrapped(frame, cs):
        log.append((frame, cs))
        report(frame, cs)

    session.report_checksum = wrapped
    return log


def box_plugin(plugin_cls, model, dtypes, schedule):
    f32, i32, frame_count = dtypes

    def setup(world, app):
        model.spawn_players(world, PLAYERS, next_id=app.rollback_id_provider.next_id)

    return (
        plugin_cls(model.INPUT_SPEC)
        .with_input_system(scripted)
        .register_rollback_component("translation", shape=(3,), dtype=f32)
        .register_rollback_component("velocity", shape=(3,), dtype=f32)
        .register_rollback_component("player_handle", dtype=i32, default=-1)
        .register_rollback_resource("frame_count", frame_count)
        .with_rollback_schedule(schedule)
        .with_num_players(PLAYERS)
        .with_max_prediction_window(8)
        .with_world_capacity(16)
        .with_setup_system(setup)
    )


def run_box_app(app, session, session_type, frames):
    log = record(session)
    app.insert_session(session, session_type)
    app.run_for(frames + 1, dt=DT)  # the first update only arms the clock
    return log


@pytest.mark.parametrize("check_distance", [2, 7])
def test_box_game_checksum_stream_bitwise_equals_jax(check_distance):
    frames = 64
    japp = box_plugin(JaxPlugin, jbox, (jnp.float32, jnp.int32, jnp.uint32(0)),
                      jbox.make_schedule()).build()
    tapp = (box_plugin(GGRSPlugin, tbox, (torch.float32, torch.int32, np.uint32(0)),
                       tbox.make_schedule())
            .with_device("cpu").build())
    jlog = run_box_app(
        japp, JaxSyncTest(PLAYERS, jbox.INPUT_SPEC, check_distance=check_distance),
        JaxSessionType.SYNC_TEST, frames)
    tlog = run_box_app(
        tapp, SyncTestSession(PLAYERS, tbox.INPUT_SPEC, check_distance=check_distance),
        SessionType.SYNC_TEST, frames)
    assert tapp.frame == japp.frame == frames
    assert tapp.stage.runner.rollbacks_total > 0
    # Every frame is saved once and then once per forced rollback over it.
    assert len(tlog) > (check_distance + 1) * (frames - check_distance)
    assert tlog == jlog
    world = tapp.world()
    assert world["resources"]["frame_count"] == tapp.frame
    np.testing.assert_array_equal(world["components"]["translation"],
                                  japp.world()["components"]["translation"])


def test_nondeterministic_system_raises_mismatched_checksum():
    calls = [0]

    def drift(state, inputs):
        calls[0] += 1  # differs between the first pass and the resimulation
        t = state.components["translation"]
        return state.replace(components={**state.components,
                                         "translation": t + calls[0] * 1e-3})

    schedule = Schedule([tbox.move_cube_system, drift])
    app = (box_plugin(GGRSPlugin, tbox, (torch.float32, torch.int32, np.uint32(0)),
                      schedule)
           .with_device("cpu").build())
    app.insert_session(SyncTestSession(PLAYERS, tbox.INPUT_SPEC, check_distance=2),
                       SessionType.SYNC_TEST)
    with pytest.raises(MismatchedChecksum):
        app.run_for(10, dt=DT)


def test_boids_synctest_runs_clean_and_matches_jax_pallas():
    n, frames, check_distance = 64, 30, 4

    def steer(handle, app):
        return np.uint8((app.session.current_frame + handle) % 16)

    app = (
        GGRSPlugin(tboids.INPUT_SPEC)
        .with_input_system(steer)
        .register_rollback_component("position", shape=(2,))
        .register_rollback_component("velocity", shape=(2,))
        .register_rollback_component("leader_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(tboids.make_schedule())
        .with_num_players(PLAYERS)
        .with_max_prediction_window(8)
        .with_world_capacity(n)
        .with_setup_system(lambda world, app: tboids.spawn_flock(world, n, PLAYERS))
        .with_device("cpu")
        .build()
    )
    session = SyncTestSession(PLAYERS, tboids.INPUT_SPEC, check_distance=check_distance)
    app.insert_session(session, SessionType.SYNC_TEST)
    app.run_for(5, dt=DT)  # the first update only arms the clock
    assert app.frame == 4
    after4 = app.world()

    jstate = jboids.make_world(n, PLAYERS).commit()
    step = JaxSchedule([jboids.flock_system_pallas, jboids.increase_frame_system])
    for frame in range(4):
        bits = np.array([(frame + h) % 16 for h in range(PLAYERS)], np.uint8)
        jstate = step(jstate, make_inputs(bits))
    for name in ("position", "velocity"):
        np.testing.assert_allclose(after4["components"][name],
                                   np.asarray(jstate.components[name]),
                                   rtol=0, atol=1e-5)

    app.run_for(frames - 4, dt=DT)  # raises MismatchedChecksum on a desync
    assert app.frame == frames
    assert app.stage.runner.rollbacks_total == frames - check_distance


def test_ring_bit_flip_is_detected_and_repaired_bitwise():
    session = SyncTestSession(PLAYERS, tbox.INPUT_SPEC, check_distance=2)
    runner = RollbackRunner(tbox.make_schedule(),
                            tbox.make_world(PLAYERS, device="cpu").commit(),
                            max_prediction=8, num_players=PLAYERS,
                            input_spec=tbox.INPUT_SPEC, device="cpu")
    twin = RollbackRunner(tbox.make_schedule(),
                          tbox.make_world(PLAYERS, device="cpu").commit(),
                          max_prediction=8, num_players=PLAYERS,
                          input_spec=tbox.INPUT_SPEC, device="cpu")
    twin_session = SyncTestSession(PLAYERS, tbox.INPUT_SPEC, check_distance=2)
    rng = np.random.RandomState(0)
    for _ in range(30):
        bits = rng.randint(0, 16, size=PLAYERS).astype(np.uint8)
        for s, r in ((session, runner), (twin_session, twin)):
            for h in range(PLAYERS):
                s.add_local_input(h, bits[h])
            r.handle_requests(s.advance_frame(), s)

    frame = runner.frame - 5
    row = frame % runner.ring.depth
    assert integrity.verify_row(runner.ring, frame)
    runner.ring, info = integrity.flip_ring_bit(runner.ring, row,
                                                np.random.RandomState(3))
    assert not integrity.verify_row(runner.ring, frame)
    assert integrity.attest_ring(runner.ring)[row]
    report = runner.attest_and_repair()
    assert report["repaired"] == 1 and report["bitwise"] is True
    assert report["corrupt_frames"] == [frame]
    assert report["first_corrupt_field"] in (info["field"],
                                             f"component/{info['field']}")
    assert not integrity.attest_ring(runner.ring).any()
    assert ts.combine64(ts.checksum(runner.state)) == ts.combine64(
        ts.checksum(twin.state))
