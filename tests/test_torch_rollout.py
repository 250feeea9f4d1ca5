"""PyTorch port, rollout bursts: ``RolloutExecutor.run`` against the JAX
package's. Ring frames, ring checksums, per-step checksums and the final
state are bitwise equal, with and without a load, with advance-only
masks, with padding; an over-long burst raises."""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.rollout import RolloutExecutor as JaxExecutor
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.rollout import RolloutExecutor, advance_n

MAX_FRAMES = 6
PLAYERS = 2


@pytest.fixture(scope="module")
def jax_executor():
    # One executor for the module: each JAX executor compiles on first use.
    return JaxExecutor(jbox.make_schedule(), MAX_FRAMES)


def burst_inputs(seed, n):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 16, size=(n, PLAYERS)).astype(np.uint8)
    return bits, np.zeros((n, PLAYERS), np.int32)


def run_both(jax_executor, bursts):
    """Run the same list of bursts (kwargs of ``run``) through both
    executors from the box_game start, checking after every burst."""
    jstate = jbox.make_world(PLAYERS).commit()
    tstate = tbox.make_world(PLAYERS, device="cpu").commit()
    jring = js.ring_init(jstate, MAX_FRAMES - 1)
    tring = ts.ring_init(tstate, MAX_FRAMES - 1)
    texec = RolloutExecutor(tbox.make_schedule(), MAX_FRAMES)
    for kw in bursts:
        jring, jstate, jcs = jax_executor.run(jring, jstate, **kw)
        tring, tstate, tcs = texec.run(tring, tstate, **kw)
        assert tcs.shape == (MAX_FRAMES, 2)
        np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs).astype(np.int64))
        np.testing.assert_array_equal(tring.frames.numpy(), np.asarray(jring.frames))
        np.testing.assert_array_equal(tring.checksums.numpy(),
                                      np.asarray(jring.checksums).astype(np.int64))
        assert ts.combine64(ts.checksum(tstate)) == js.combine64(js.checksum(jstate))
        for r in range(tring.depth):
            assert ts.combine64(ts.checksum(ts.ring_load(tring, r))) == js.combine64(
                js.checksum(js.ring_load(jring, r)))
    np.testing.assert_array_equal(
        ts.to_host(tstate)["components"]["translation"],
        js.to_host(jstate)["components"]["translation"])
    return tcs


def test_plain_bursts_with_padding(jax_executor):
    bits, status = burst_inputs(0, 9)
    cs = run_both(jax_executor, [
        dict(start_frame=0, bits=bits[:4], status=status[:4], n_frames=4),
        dict(start_frame=4, bits=bits[4:9], status=status[4:9], n_frames=5),
    ])
    assert (cs[5:] == 0).all()  # padding reports 0


def test_load_then_resimulate(jax_executor):
    bits, status = burst_inputs(1, 10)
    run_both(jax_executor, [
        dict(start_frame=0, bits=bits[:5], status=status[:5], n_frames=5),
        dict(start_frame=5, bits=bits[2:8], status=status[2:8], n_frames=6,
             load_frame=2),
        dict(start_frame=8, bits=bits[8:10], status=status[8:10], n_frames=2),
    ])


def test_advance_only_and_save_only_masks(jax_executor):
    bits, status = burst_inputs(2, 5)
    cs = run_both(jax_executor, [
        dict(start_frame=0, bits=bits, status=status, n_frames=5,
             save_mask=np.zeros(5, bool), adv_mask=np.ones(5, bool)),
        dict(start_frame=5, bits=bits[:3], status=status[:3], n_frames=3,
             save_mask=np.array([True, False, True]),
             adv_mask=np.array([True, True, False])),
    ])
    assert (cs[1] == 0).all() and (cs[0] != 0).any() and (cs[2] != 0).any()


def test_burst_longer_than_max_frames_raises():
    bits, status = burst_inputs(3, MAX_FRAMES + 1)
    state = tbox.make_world(PLAYERS, device="cpu").commit()
    with pytest.raises(ValueError, match="exceeds max_frames"):
        RolloutExecutor(tbox.make_schedule(), MAX_FRAMES).run(
            ts.ring_init(state, 3), state, 0, bits, status, n_frames=MAX_FRAMES + 1)


def test_advance_n_equals_schedule_loop():
    bits, status = burst_inputs(4, 7)
    schedule = tbox.make_schedule()
    state = tbox.make_world(PLAYERS, device="cpu").commit()
    tbits = torch.from_numpy(bits)
    out = advance_n(schedule, state, tbits)
    ring = ts.ring_init(state, 8)
    _, looped, _ = RolloutExecutor(schedule, 8).run(ring, state, 0, bits, status,
                                                    n_frames=7)
    assert ts.combine64(ts.checksum(out)) == ts.combine64(ts.checksum(looped))
