"""PyTorch port, box_game: the step is bitwise equal to the JAX schedule and
to the NumPy oracle ``step_np`` over 500 frames of random inputs.

The JAX schedule is called op by op here. Under ``jax.jit`` XLA:CPU
contracts ``vx*vx + vy*vy + vz*vz`` into fused multiply-adds, so the
jitted reference leaves ``step_np`` by an ulp wherever the speed clamp
engages; the port keeps one rounding per operation, as ``step_np`` does
(``test_jitted_jax_step_contracts_the_speed_magnitude``).
"""

import jax
import numpy as np
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.schedule import PlayerInputs


def assert_worlds_equal(a: dict, b: dict) -> None:
    for key in ("alive", "rollback_id"):
        np.testing.assert_array_equal(a[key], b[key])
    for group in ("components", "present"):
        assert set(a[group]) == set(b[group])
        for name in a[group]:
            assert a[group][name].dtype == b[group][name].dtype
            np.testing.assert_array_equal(a[group][name], b[group][name])
    assert a["resources"]["frame_count"] == b["resources"]["frame_count"]
    assert np.asarray(b["resources"]["frame_count"]).dtype == np.uint32


def test_make_world_equals_jax():
    assert_worlds_equal(ts.to_host(tbox.make_world(3, device="cpu").commit()),
                        js.to_host(jbox.make_world(3).commit()))


def test_500_frames_bitwise_against_jax_and_step_np():
    num_players = 4
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, 16, size=(500, num_players)).astype(np.uint8)
    # Long runs of held keys drive the cubes into the speed clamp and the
    # plane's edges, where mag/factor and the clip rounding bite.
    inputs[100:250] = inputs[100]

    step_j = jbox.make_schedule()
    step_t = tbox.make_schedule()
    jw = jbox.make_world(num_players).commit()
    tw = tbox.make_world(num_players, device="cpu").commit()
    host = js.to_host(jw)
    status = torch.zeros(num_players, dtype=torch.int32)
    for frame, bits in enumerate(inputs):
        jw = step_j(jw, make_inputs(bits))
        tw = step_t(tw, PlayerInputs(bits=torch.from_numpy(bits), status=status))
        host = jbox.step_np(host, bits)
        if frame % 50 == 49:
            got = ts.to_host(tw)
            assert_worlds_equal(got, js.to_host(jw))
            assert_worlds_equal(got, host)
            assert ts.combine64(ts.checksum(tw)) == js.combine64(js.checksum(jw))
    assert int(tw.resources["frame_count"]) == 500


def test_non_player_and_dead_slots_pass_through():
    world = tbox.make_world(2, device="cpu")
    world.spawn({"translation": [1.0, 2.0, 3.0]}, rollback_id=50)  # no handle
    slot = world.spawn({"translation": [0.5, 0.0, 0.5], "velocity": [0.1, 0, 0],
                        "player_handle": 1}, rollback_id=51)
    world.despawn(slot)
    tw = world.commit()
    bits = torch.full((2,), jbox.INPUT_UP | jbox.INPUT_RIGHT, dtype=torch.uint8)
    out = tbox.move_cube_system(tw, PlayerInputs(bits, torch.zeros(2, dtype=torch.int32)))
    moved = ~torch.all(out.components["translation"] == tw.components["translation"], dim=1)
    assert moved.tolist()[:2] == [True, True]
    assert not moved[2:].any()


def test_jitted_jax_step_contracts_the_speed_magnitude():
    """The reason the comparison above calls JAX op by op: jitted, the
    magnitude is a chain of fused multiply-adds; in the port it is
    correctly rounded per operation, like ``step_np``."""
    rng = np.random.RandomState(0)
    v = ((rng.rand(4096, 3) - 0.5) * 0.12).astype(np.float32)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    want = np.sqrt(x * x + y * y + z * z)
    jitted = np.asarray(jax.jit(lambda a: jax.numpy.sqrt(
        a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2]))(v))
    tv = torch.from_numpy(v)
    np.testing.assert_array_equal(
        tbox._magnitude(tv[:, 0], tv[:, 1], tv[:, 2]).numpy(), want)
    assert (jitted != want).any()
