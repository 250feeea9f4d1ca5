"""PyTorch port, the serving tier's kernel paths on the CPU.

The checksum kernel's save over ``[S]`` match slots, each slot at its own
frame with a keep-mask (``ops/checksum.py::world_checksum(state, "save",
frames=..., keep=...)``; its plain version here), equals S single saves
and ``jax.vmap`` of the JAX package's ``rollout._masked_ring_save``:
masked slots keep their rows and get lanes 0, rows follow the frame's
floor mod. The per-slot ring load is a gather into a fresh world; the
slot-batched burst equals S serial bursts; the force wrappers refuse a
branch axis over the kernels' ``gridDim.y`` cap. Every comparison is
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bevy_ggrs_tpu import rollout as jrollout
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu_torch import rollout as trollout
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.schedule import PlayerInputs
from tests.test_torch_speculate import box_worlds, bytes_of, jax_world, leaves, stack

P = 2


def slot_rings(worlds, depth, seed):
    """``[S, depth]`` rings whose rows already hold saves (frames 0..depth-1
    of seeded worlds), so a masked slot's untouched rows are visible."""
    S = len(worlds)
    rings = ts.branch_rings(worlds[0], S, depth)
    fill = stack([ts.from_host(tbox.make_registry(), h, device="cpu")
                  for h in box_worlds(seed, S)])
    for f in range(depth):
        ts.ring_save(rings, fill, f)
    return rings


def clone_rings(r):
    return ts.clone_ring(r)


@pytest.mark.parametrize("depth,frames,keep", [
    (5, [7, 0, 12, 3, 9, 4], [1, 1, 0, 1, 0, 1]),
    (3, [-1, -5, 2, 30, 31, 6], [1, 1, 1, 1, 1, 1]),
    (9, [100, 101, 102, 103, 104, 105], [0, 0, 0, 0, 0, 0]),
])
def test_slot_save_equals_single_saves(depth, frames, keep):
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu")
              for h in box_worlds(depth + 10, len(frames))]
    rings = slot_rings(worlds, depth, seed=depth)
    before = clone_rings(rings)
    out = torch.full((len(worlds), 2), -7, dtype=torch.int64)
    lanes = tck.world_checksum(stack(worlds), "save", ring=rings,
                               frames=torch.tensor(frames, dtype=torch.int32),
                               keep=torch.tensor(keep, dtype=torch.bool), out=out)
    assert torch.equal(lanes, out)
    for s, (world, f, k) in enumerate(zip(worlds, frames, keep)):
        single = ts.SnapshotRing(states=ts.tree_map(lambda x: x[s].clone(), before.states),
                                 frames=before.frames[s].clone(),
                                 checksums=before.checksums[s].clone())
        if k:
            _, one = ts.ring_save(single, world, f)
            assert torch.equal(lanes[s], one)
            assert int(rings.frames[s, f % depth]) == f  # the floor mod
        else:
            assert lanes[s].tolist() == [0, 0]
        assert torch.equal(rings.frames[s], single.frames)
        assert torch.equal(rings.checksums[s], single.checksums)
        for r in range(depth):
            mine = leaves(ts.tree_map(lambda x: x[s, r], rings.states))
            theirs = leaves(ts.tree_map(lambda x: x[r], single.states))
            assert [bytes_of(x) for x in mine] == [bytes_of(x) for x in theirs]


def test_slot_save_random_registry():
    """bool, u8, i16, f16, i32, f32, narrowed i64/f64 components, nested
    resources: every slot's row equals its single save."""
    reg = chip_smoke.random_registry(ts)
    worlds = [ts.from_host(reg, chip_smoke.random_host(700 + s, 9), device="cpu")
              for s in range(4)]
    rings = ts.branch_rings(worlds[0], 4, 3)
    singles = [ts.ring_init(w, 3) for w in worlds]
    lanes = tck.world_checksum(stack(worlds), "save", ring=rings,
                               frames=torch.tensor([4, 2, 9, 1], dtype=torch.int32),
                               keep=torch.tensor([True, False, True, True]))
    for s, f in enumerate([4, 2, 9, 1]):
        if s == 1:
            assert lanes[s].tolist() == [0, 0] and int(rings.frames[s].max()) == -1
            continue
        _, one = ts.ring_save(singles[s], worlds[s], f)
        assert torch.equal(lanes[s], one) and torch.equal(rings.checksums[s], singles[s].checksums)


def test_slot_save_equals_jax_vmap_masked_ring_save():
    S, depth = 6, 4
    hosts = box_worlds(21, S)
    frames = np.array([3, 0, 5, 8, 2, 6], np.int32)
    keep = np.array([True, False, True, True, False, True])
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in hosts]
    rings = ts.SnapshotRing(
        states=ts.tree_map(lambda x: x[:, None].expand((S, depth) + x.shape[1:]).contiguous(),
                           stack(worlds)),
        frames=torch.full((S, depth), -1, dtype=torch.int32),
        checksums=torch.zeros((S, depth, 2), dtype=torch.int64))
    lanes = tck.world_checksum(stack(worlds), "save", ring=rings, frames=torch.tensor(frames),
                               keep=torch.tensor(keep))
    jworlds = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[jax_world(h) for h in hosts])
    jrings = jax.vmap(lambda w: js.ring_init(w, depth))(jworlds)
    jring, jcs = jax.vmap(jrollout._masked_ring_save)(jrings, jworlds, jnp.asarray(frames),
                                                      jnp.asarray(keep))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jcs).astype(np.int64))
    np.testing.assert_array_equal(rings.frames.numpy(), np.asarray(jring.frames))
    np.testing.assert_array_equal(rings.checksums.numpy(),
                                  np.asarray(jring.checksums).astype(np.int64))
    mine = ts.to_host(rings.states)
    theirs = js.to_host(jring.states)
    for name in mine["components"]:
        assert mine["components"][name].tobytes() == theirs["components"][name].tobytes()
    assert mine["rollback_id"].tobytes() == theirs["rollback_id"].tobytes()


def test_slot_save_checks_its_operands():
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in box_worlds(2, 3)]
    rings = ts.branch_rings(worlds[0], 3, 4)
    with pytest.raises(ValueError, match="frames must be int32"):
        tck.world_checksum(stack(worlds), "save", ring=rings, frames=torch.zeros(3))
    with pytest.raises(ValueError, match="keep must be bool"):
        tck.world_checksum(stack(worlds), "save", ring=rings,
                           frames=torch.zeros(3, dtype=torch.int32), keep=torch.ones(3))
    with pytest.raises(ValueError, match="needs per-slot frames"):
        tck.world_checksum(stack(worlds), "save", ring=rings, keep=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="belong to the save mode"):
        tck.world_checksum(stack(worlds), "checksum", frames=torch.zeros(3, dtype=torch.int32))


def test_ring_load_slots_is_a_fresh_gather():
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in box_worlds(5, 4)]
    rings = slot_rings(worlds, 5, seed=9)
    loaded = trollout.ring_load_slots(rings, [3, 7, -1, 0])
    for s, f in enumerate([3, 7, -1, 0]):
        one = ts.ring_load(ts.select_branch(rings, s), f)
        assert [bytes_of(x) for x in leaves(ts.tree_map(lambda x: x[s], loaded))] == [
            bytes_of(x) for x in leaves(one)]
    loaded.components["translation"].add_(1.0)  # a copy: the rings stay
    again = trollout.ring_load_slots(rings, [3, 7, -1, 0])
    assert not torch.equal(again.components["translation"], loaded.components["translation"])


def test_slot_burst_equals_serial_bursts():
    """Per-slot start frames, loads, masks and inputs: one burst over the
    ``[S]`` world equals S single-world bursts, with one save launch and
    one schedule step per step at most."""
    S, T, depth = 5, 6, 5
    rng = np.random.RandomState(3)
    hosts = box_worlds(33, S)
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in hosts]
    starts = np.array([0, 4, 11, 2, 7])
    n = np.array([6, 3, 0, 1, 5])
    save = np.arange(T)[None] < n[:, None]
    adv = save.copy()
    save[4, 2] = False  # an advance without its save (a spectator's step)
    bits = rng.randint(0, 16, (S, T, P)).astype(np.uint8)
    status = rng.randint(0, 2, (S, T, P)).astype(np.int32)
    rings = slot_rings(worlds, depth, seed=4)
    singles = [ts.select_branch(rings, s) for s in range(S)]
    schedule = tbox.make_schedule()
    calls = {"save": 0, "step": 0}
    real_save = tck.world_checksum

    def spy(*a, **k):
        calls["save"] += 1
        return real_save(*a, **k)

    tck.world_checksum = spy
    try:
        rings, states, cs = trollout.rollout_burst_slots(
            schedule, rings, stack(worlds), starts, torch.as_tensor(bits),
            torch.as_tensor(status), save, adv)
    finally:
        tck.world_checksum = real_save
    assert calls["save"] == int(save.any(axis=0).sum())
    for s in range(S):
        ring, state, one = trollout.rollout_burst(
            schedule, singles[s], worlds[s], int(starts[s]), torch.as_tensor(bits[s]),
            torch.as_tensor(status[s]), save[s], adv[s])
        assert torch.equal(cs[s], one)
        assert torch.equal(rings.frames[s], ring.frames)
        assert torch.equal(rings.checksums[s], ring.checksums)
        got = leaves(ts.tree_map(lambda x: x[s], states))
        assert [bytes_of(x) for x in got] == [bytes_of(x) for x in leaves(state)]


def test_slot_step_equals_single_steps():
    """The box_game step over ``[S]`` slots with inputs of their own equals
    S single steps (the precondition of the slot-batched burst)."""
    hosts = box_worlds(8, 6)
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in hosts]
    bits = torch.as_tensor(np.random.RandomState(1).randint(0, 16, (6, P)).astype(np.uint8))
    status = torch.zeros((6, P), dtype=torch.int32)
    out = tbox.make_schedule()(stack(worlds), PlayerInputs(bits=bits, status=status))
    for s, w in enumerate(worlds):
        one = tbox.make_schedule()(w, PlayerInputs(bits=bits[s], status=status[s]))
        assert [bytes_of(x) for x in leaves(ts.tree_map(lambda x: x[s], out))] == [
            bytes_of(x) for x in leaves(one)]


def test_force_wrappers_refuse_the_branch_cap():
    """Branches past gridDim.y's 65,535 fold into gridDim.z: the wrappers
    no longer refuse them, and the grid covers every branch once."""
    for b in (1, 8192, 65535, 65536, 70000, 65535 * 3 + 1):
        tpw.check_branch_cap(b, "pairwise_force_rows")
        x, y, z = tpw.branch_grid(7, b)
        # Branch yi + y * zi: every branch gets a block, no z-row is idle.
        assert (x, y) == (7, min(b, 65535)) and y * (z - 1) < b <= y * z
    assert tpw.branch_grid(1, 70000) == (1, 65535, 2)
    tpw.check_branch_cap(tpw.MAX_BRANCHES, "pairwise_force_rows")
    with pytest.raises(ValueError, match="gridDim.z"):
        tpw.check_branch_cap(tpw.MAX_BRANCHES + 1, "pairwise_force_rows")
