"""The plain reference against the program's own plain path, at a tiny size
on the CPU: the hash bit for bit, one flock step within the tolerance of
the force kernels' plain versions, and TF32 rounding."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import compare, flock
from benchmark.reference import hash as ref_hash

CPU = torch.device("cpu")


def _world(n=96, players=2, seed=5, holes=True):
    w = harness.make_flock({"num_boids": n, "players": players}, seed, CPU)
    if holes:  # dead slots and a missing component must hash and step right
        w.alive[7] = False
        w.rollback_id[7] = -1
        w.present["velocity"][11] = False
        w.resources["frame_count"].fill_(41)
    return w


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_hash_equals_the_ports_checksum(seed):
    from bevy_ggrs_tpu_torch.ops.checksum import checksum_plain
    from bevy_ggrs_tpu_torch.state import checksum

    w = _world(seed=seed)
    want = checksum(w).numpy().astype(np.uint64)
    assert np.array_equal(ref_hash.lanes(harness.world_to_host(w)), want)
    assert np.array_equal(checksum_plain(w).numpy().astype(np.uint64), want)


@pytest.mark.parametrize("kernel,tol", [("pallas", 2e-6), ("mxu", 1e-4)])
def test_one_step_matches_the_ports_plain_step(kernel, tol):
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.schedule import make_inputs

    w = _world()
    bits = np.array([9, 6], np.uint8)
    got = harness.world_to_host(
        boids.make_schedule(kernel=kernel, mode="dense")(w, make_inputs(torch.as_tensor(bits))))
    ref = flock.step(harness.world_to_host(w), bits, CPU)
    assert compare.count_unequal(got, ref, floats=False) == 0
    for k in ("position", "velocity"):
        np.testing.assert_allclose(got["components"][k], ref["components"][k], atol=tol, rtol=0)
    assert int(ref["resources"]["frame_count"]) == 42


def test_leaders_steer_and_the_speed_is_clamped():
    w = _world(n=8, holes=False)
    host = harness.world_to_host(w)
    right = flock.step(host, np.array([flock.RIGHT, 0], np.uint8), CPU)
    left = flock.step(host, np.array([flock.LEFT, 0], np.uint8), CPU)
    assert right["components"]["velocity"][0, 0] > left["components"]["velocity"][0, 0]
    np.testing.assert_array_equal(right["components"]["velocity"][1:],
                                  left["components"]["velocity"][1:])
    speed = np.linalg.norm(right["components"]["velocity"], axis=1)
    assert (speed <= flock.MAX_SPEED * (1 + 1e-6)).all()
    assert (speed >= flock.MIN_SPEED * (1 - 1e-6)).all()


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12,
                      3.14159265], dtype=torch.float32)
    got = flock.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, 3.140625])
    assert torch.equal(got, want)


def test_the_control_reads_far_above_the_program():
    """At 256 boids on the CPU the TF32 control's velocity gap is over 30
    times the program's (the mxu path's plain version)."""
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.schedule import make_inputs

    w = _world(n=256, holes=False)
    bits = np.array([3, 12], np.uint8)
    host = harness.world_to_host(w)
    got = harness.world_to_host(
        boids.make_schedule(kernel="mxu", mode="dense")(w, make_inputs(torch.as_tensor(bits))))
    program, control = compare.Tally(control=True), None
    compare.follow(program, {0: host}, lambda f: bits, CPU, last=(1, got))
    control = program.control
    assert control.values["vel_gap_p90"] > 30 * program.values["vel_gap_p90"]
