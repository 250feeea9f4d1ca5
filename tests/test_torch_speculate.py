"""PyTorch port, speculative branch batching against the JAX package.

The checksum kernel's save mode over a branch axis (its plain version on
the CPU): a ``[B]`` world saved into a ``[B, depth]`` stack of rings equals
B single-world saves row for row, and its lanes equal JAX's vmapped
checksum. The box_game step over a ``[B, capacity]`` world equals B serial
steps bitwise, and the port's ``SpeculativeExecutor`` gives JAX's
per-branch checksum streams, final states and ring rows. ``match_branch``,
``merge_rings`` and ``absorb_branch_frames`` equal JAX's; the samplers
keep branch 0 repeat-last and draw reproducibly from their seed. Every
comparison is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bevy_ggrs_tpu import fused as jfused
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.parallel import speculate as jspec
from bevy_ggrs_tpu_torch import fused as tfused
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.parallel import speculate as tspec
from bevy_ggrs_tpu_torch.schedule import PlayerInputs

P = 2
B, F = 8, 4


def box_worlds(seed, n, players=P):
    """``n`` box_game worlds (single, on the CPU) with seeded velocities
    and translations, and the same as JAX worlds."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        host = ts.to_host(tbox.make_world(players, device="cpu").commit())
        comps = host["components"]
        comps["translation"] = (comps["translation"]
                                + rng.uniform(-1, 1, comps["translation"].shape)
                                .astype(np.float32))
        comps["velocity"] = rng.uniform(-0.04, 0.04, comps["velocity"].shape).astype(np.float32)
        host["resources"]["frame_count"] = np.uint32(rng.randint(0, 1000))
        out.append(host)
    return out


def stack(worlds):
    """A ``[B]`` world of single worlds."""
    return ts.tree_map(lambda *xs: torch.stack(xs), *worlds)


def bytes_of(t):
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def jax_world(host):
    """The JAX world of a host dict (both packages' ``to_host`` layout)."""
    return js.WorldState(
        alive=jnp.asarray(host["alive"]),
        rollback_id=jnp.asarray(host["rollback_id"]),
        components={n: jnp.asarray(a) for n, a in host["components"].items()},
        present={n: jnp.asarray(a) for n, a in host["present"].items()},
        resources=jax.tree_util.tree_map(jnp.asarray, host["resources"]),
    )


def leaves(state):
    return ts.tree_leaves([state.alive, state.rollback_id, state.components,
                           state.present, state.resources])


# ---------------------------------------------------------------------------
# 1. The batched save
# ---------------------------------------------------------------------------


def check_batched_save(worlds, depth, frames):
    batched = stack(worlds)
    rings = ts.branch_rings(worlds[0], len(worlds), depth)
    singles = [ts.ring_init(w, depth) for w in worlds]
    for frame in frames:
        out = torch.full((len(worlds), 2), -7, dtype=torch.int64)
        _, lanes = ts.ring_save(rings, batched, frame, out=out)
        assert lanes.shape == (len(worlds), 2) and torch.equal(lanes, out)
        for b, (ring, world) in enumerate(zip(singles, worlds)):
            _, one = ts.ring_save(ring, world, frame)
            assert torch.equal(lanes[b], one)
    for b, ring in enumerate(singles):
        assert torch.equal(rings.frames[b], ring.frames)
        assert torch.equal(rings.checksums[b], ring.checksums)
        saved = ring.frames >= 0
        for r in torch.nonzero(saved).flatten().tolist():
            mine = leaves(ts.tree_map(lambda x: x[b, r], rings.states))
            theirs = leaves(ts.tree_map(lambda x: x[r], ring.states))
            assert [bytes_of(x) for x in mine] == [bytes_of(x) for x in theirs]


@pytest.mark.parametrize("depth,frames", [(4, [0, 1, 2]), (3, [5, 6, 7, 8, 9]), (9, [0])])
def test_batched_save_equals_single_saves(depth, frames):
    hosts = box_worlds(depth, 5)
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in hosts]
    check_batched_save(worlds, depth, frames)


@pytest.mark.parametrize("cap", [7, 40])
def test_batched_save_random_registry(cap):
    """A world of bool, u8, i16, f16, i32, f32, narrowed i64 and f64
    components and nested resources with 2- and 8-byte leaves."""
    reg = chip_smoke.random_registry(ts)
    worlds = [ts.from_host(reg, chip_smoke.random_host(100 * cap + s, cap), device="cpu")
              for s in range(4)]
    check_batched_save(worlds, 3, [0, 1, 2, 3])
    lanes = tck.checksum_plain(stack(worlds))
    for b, w in enumerate(worlds):
        assert torch.equal(lanes[b], ts.checksum(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_lanes_equal_jax_vmap_checksum(seed):
    hosts = box_worlds(seed, B)
    ours = tck.checksum_plain(stack([ts.from_host(tbox.make_registry(), h, device="cpu")
                                     for h in hosts]))
    jworlds = [jax_world(h) for h in hosts]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jworlds)
    theirs = np.asarray(jax.vmap(js.checksum)(jstack)).astype(np.int64)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_batched_save_into_a_strided_out():
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in box_worlds(3, B)]
    rings = ts.branch_rings(worlds[0], B, F)
    cs = torch.zeros((B, F, 2), dtype=torch.int64)
    for t in range(F):
        ts.ring_save(rings, stack(worlds), 10 + t, out=cs[:, t])
    assert torch.equal(cs[:, 1], rings.checksums[:, 11 % F])
    assert (rings.frames == torch.tensor([[12, 13, 10, 11]] * B, dtype=torch.int32)).all()


def test_branch_helpers_copy_and_refuse():
    world = tbox.make_world(P, device="cpu").commit()
    rings = ts.branch_rings(world, 3, 4)
    assert rings.frames.shape == (3, 4) and (rings.frames == -1).all()
    assert rings.checksums.shape == (3, 4, 2) and rings.depth == 4
    worlds = ts.broadcast_branches(world, 3)
    assert worlds.alive.shape == (3, world.capacity) and worlds.alive.is_contiguous()
    ts.ring_save(rings, worlds, 0)
    one = ts.select_branch(rings, 1)
    assert one.frames.shape == (4,)
    ts.ring_save(rings, ts.tree_map(lambda x: x.clone(), worlds), 4)
    assert int(one.frames[0]) == 0  # a copy: the stack's later save is not in it
    state = ts.select_branch(worlds, 2)
    assert state.alive.data_ptr() != worlds.alive.data_ptr()
    with pytest.raises(ValueError, match="leading axes"):
        ts.ring_save(ts.branch_rings(world, 2, 4), worlds, 0)  # 3 worlds, 2 rings
    with pytest.raises(ValueError, match="leading axes"):
        ts.ring_save(rings, world, 0)  # a single world into a stack


def test_guard_refuses_a_stack_of_rings():
    world = tbox.make_world(P, device="cpu").commit()
    rings = ts.branch_rings(world, 2, 3)
    with pytest.raises(ValueError, match="single ring"):
        tck.world_checksum(None, "guard", ring=rings, frame=0)


# ---------------------------------------------------------------------------
# 2. The batched step and the spec rollout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_step_equals_serial_steps(seed):
    rng = np.random.RandomState(seed)
    hosts = box_worlds(seed + 10, B)
    worlds = [ts.from_host(tbox.make_registry(), h, device="cpu") for h in hosts]
    batched = stack(worlds)
    schedule = tbox.make_schedule()
    status = torch.zeros(P, dtype=torch.int32)
    for _ in range(10):
        bits = torch.from_numpy(rng.randint(0, 16, size=(B, P)).astype(np.uint8))
        batched = schedule(batched, PlayerInputs(bits, status.expand(B, P)))
        worlds = [schedule(w, PlayerInputs(bits[b], status)) for b, w in enumerate(worlds)]
    for b, w in enumerate(worlds):
        mine = leaves(ts.tree_map(lambda x: x[b], batched))
        theirs = leaves(w)
        assert [bytes_of(x) for x in mine] == [bytes_of(x) for x in theirs]


@pytest.fixture(scope="module")
def jax_spec_executor():
    return jspec.SpeculativeExecutor(jbox.make_schedule(), B, F)


@pytest.mark.parametrize("seed,start", [(0, 0), (1, 13)])
def test_spec_rollout_streams_equal_jax(jax_spec_executor, seed, start):
    rng = np.random.RandomState(seed)
    host = box_worlds(seed + 20, 1)[0]
    bits = rng.randint(0, 16, size=(B, F, P)).astype(np.uint8)
    tres = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F).run(
        ts.from_host(tbox.make_registry(), host, device="cpu"), start, bits)
    jres = jax_spec_executor.run(jax_world(host), start, bits)
    assert tres.checksums.shape == (B, F, 2)
    np.testing.assert_array_equal(tres.checksums.numpy(),
                                  np.asarray(jres.checksums).astype(np.int64))
    np.testing.assert_array_equal(tres.rings.frames.numpy(), np.asarray(jres.rings.frames))
    np.testing.assert_array_equal(tres.rings.checksums.numpy(),
                                  np.asarray(jres.rings.checksums).astype(np.int64))
    for b in range(B):
        mine = ts.to_host(ts.select_branch(tres.states, b))
        theirs = js.to_host(jax.tree_util.tree_map(lambda x: x[b], jres.states))
        for name in ("translation", "velocity"):
            np.testing.assert_array_equal(mine["components"][name],
                                          theirs["components"][name])
        ring_t, state_t = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F).commit(tres, b)
        assert ts.combine64(ts.checksum(state_t)) == js.combine64(
            js.checksum(jax.tree_util.tree_map(lambda x: x[b], jres.states)))
        for r in range(F):  # every row is saved
            assert ts.combine64(ts.checksum(ts.ring_load(ring_t, r))) == js.combine64(
                js.checksum(js.ring_load(jax.tree_util.tree_map(lambda x: x[b], jres.rings), r)))


def test_spec_rollout_equals_serial_bursts():
    """Branch by branch, the rollout's lanes equal the serial burst's on
    the same inputs (the claim attestation checks on a live runner)."""
    from bevy_ggrs_tpu_torch.rollout import RolloutExecutor

    rng = np.random.RandomState(4)
    state = tbox.make_world(P, device="cpu").commit()
    bits = rng.randint(0, 16, size=(B, F, P)).astype(np.uint8)
    res = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F).run(state, 5, bits)
    ex = RolloutExecutor(tbox.make_schedule(), F + 2)
    for b in range(B):
        _, end, cs = ex.run(ts.ring_init(state, F), state, 5, bits[b],
                            np.full((F, P), 1, np.int32), n_frames=F)
        assert torch.equal(cs[:F], res.checksums[b])
        assert ts.combine64(ts.checksum(end)) == ts.combine64(
            ts.checksum(ts.select_branch(res.states, b)))


def test_rollouts_own_their_tensors():
    """A later rollout writes rings of its own: an earlier result stays as
    it was (the fused tick reads the previous rollout after dispatching
    the next)."""
    state = tbox.make_world(P, device="cpu").commit()
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F)
    first = ex.run(state, 0, np.ones((B, F, P), np.uint8))
    kept = (first.checksums.clone(), first.rings.frames.clone(),
            ts.tree_map(torch.clone, first.rings.states))
    ex.run(state, 0, np.full((B, F, P), 6, np.uint8))
    assert torch.equal(first.checksums, kept[0]) and torch.equal(first.rings.frames, kept[1])
    assert all(torch.equal(a, b) for a, b in zip(leaves(first.rings.states), leaves(kept[2])))


def test_executor_checks_shapes_and_mesh():
    """Shapes are checked; a mesh is accepted (a 1 x 1 mesh here: the
    rollout equals the unmeshed one); the session axis and a mesh are
    exclusive, with the JAX package's ValueError."""
    from bevy_ggrs_tpu_torch.parallel.sharding import branch_mesh

    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F)
    with pytest.raises(ValueError, match="configured"):
        ex.run(tbox.make_world(P, device="cpu").commit(), 0, np.zeros((B, F + 1, P), np.uint8))
    mesh = branch_mesh(device_type="cpu")
    state = tbox.make_world(P, device="cpu").commit()
    bits = np.random.RandomState(2).randint(0, 16, (B, F, P)).astype(np.uint8)
    meshed = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F, mesh=mesh,
                                       entity_axis="entity", state_template=state)
    assert torch.equal(meshed.run(state, 0, bits).checksums, ex.run(state, 0, bits).checksums)
    tfused.FusedTickExecutor(tbox.make_schedule(), 10, B, F, mesh=mesh)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfused.FusedTickExecutor(tbox.make_schedule(), 10, B, F, mesh=mesh, session_axis=2)


# ---------------------------------------------------------------------------
# 3. match_branch, merge_rings, absorb_branch_frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_match_branch_equals_jax(seed):
    rng = np.random.RandomState(seed)
    nb, nf = int(rng.randint(1, 12)), int(rng.randint(1, 9))
    values = int(rng.randint(1, 4))  # few values: ties and long prefixes
    bb = rng.randint(0, values, size=(nb, nf, P)).astype(np.uint8)
    for k in range(nf + 1):
        cb = rng.randint(0, values, size=(k, P)).astype(np.uint8)
        if k and rng.rand() < 0.5:
            cb = bb[int(rng.randint(nb)), :k].copy()
        want = (0, 0) if k == 0 else jspec._match_branch_numpy(bb, cb, k)
        assert tspec.match_branch(bb, cb) == want == jspec.match_branch(bb, cb)


def test_match_branch_ties_break_low():
    bb = np.zeros((4, 3, P), np.uint8)
    assert tspec.match_branch(bb, np.zeros((2, P), np.uint8)) == (0, 2)
    bb[2, 1] = 5
    cb = np.array([[0, 0], [5, 0]], np.uint8)
    assert tspec.match_branch(bb, cb) == (0, 1)  # branch 0 stops at frame 1
    cb = np.array([[0, 0], [5, 5]], np.uint8)
    bb[2, 1] = [5, 5]
    assert tspec.match_branch(bb, cb) == (2, 2)


def jax_ring_from(tring):
    return js.SnapshotRing(
        states=jax_world(ts.to_host(tring.states)),
        frames=jnp.asarray(tring.frames.numpy()),
        checksums=jnp.asarray(tring.checksums.numpy().astype(np.uint32)))


def saved_rows_equal(tring, jring):
    frames = tring.frames.numpy()
    np.testing.assert_array_equal(frames, np.asarray(jring.frames))
    np.testing.assert_array_equal(tring.checksums.numpy()[frames >= 0],
                                  np.asarray(jring.checksums).astype(np.int64)[frames >= 0])
    th, jh = ts.to_host(tring.states), js.to_host(jring.states)
    for r in np.flatnonzero(frames >= 0):
        for name in th["components"]:
            np.testing.assert_array_equal(th["components"][name][r], jh["components"][name][r])
        np.testing.assert_array_equal(th["resources"]["frame_count"][r],
                                      jh["resources"]["frame_count"][r])


def rollout_pair(seed, start):
    rng = np.random.RandomState(seed)
    host = box_worlds(seed + 30, 1)[0]
    bits = rng.randint(0, 16, size=(B, F, P)).astype(np.uint8)
    tres = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F).run(
        ts.from_host(tbox.make_registry(), host, device="cpu"), start, bits)
    jres = jspec.SpeculativeExecutor(jbox.make_schedule(), B, F).run(
        jax_world(host), start, bits)
    return tres, jres, host


def main_rings(host, depth, frames):
    """The same session ring in both packages, rows saved at ``frames``."""
    tstate = ts.from_host(tbox.make_registry(), host, device="cpu")
    tring = ts.ring_init(tstate, depth)
    for f in frames:
        ts.ring_save(tring, tstate, f)
    return tring, jax_ring_from(tring)


@pytest.mark.parametrize("branch", [0, 5])
def test_merge_rings_equals_jax(branch):
    tres, jres, host = rollout_pair(branch, 3)
    tmain, jmain = main_rings(host, F, [0, 1])
    tspec_ring = ts.select_branch(tres.rings, branch)
    tspec_ring.frames[1] = -1  # an unsaved row keeps the main ring's
    jspec_ring = jax.tree_util.tree_map(lambda x: x[branch], jres.rings)
    jspec_ring = jspec_ring.__class__(states=jspec_ring.states,
                                      frames=jspec_ring.frames.at[1].set(-1),
                                      checksums=jspec_ring.checksums)
    merged = tspec.merge_rings(tmain, tspec_ring)
    assert merged is tmain  # in place
    saved_rows_equal(merged, jspec.merge_rings(jmain, jspec_ring))
    with pytest.raises(ValueError, match="depth"):
        tspec.merge_rings(ts.ring_init(ts.ring_load(tmain, 0), F + 1), tspec_ring)


@pytest.mark.parametrize("first,n", [(3, 2), (4, 3), (3, 4), (5, 0)])
def test_absorb_branch_frames_equals_jax(first, n):
    anchor, branch, max_steps = 3, 2, 10
    tres, jres, host = rollout_pair(first + n, anchor)
    tmain, jmain = main_rings(host, 9, [0, 1, 2, 3])
    tring, tstate, tcs = tfused.absorb_branch_frames(
        tmain, ts.select_branch(tres.rings, branch), ts.select_branch(tres.states, branch),
        first, n, anchor, F, max_steps)
    jring, jstate, jcs = jfused.absorb_branch_frames(
        jmain, jax.tree_util.tree_map(lambda x: x[branch], jres.rings),
        jax.tree_util.tree_map(lambda x: x[branch], jres.states),
        jnp.int32(first), jnp.int32(n), jnp.int32(anchor), jnp.int32(F), max_steps)
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs).astype(np.int64))
    saved_rows_equal(tring, jring)
    if n:
        assert ts.combine64(ts.checksum(tstate)) == js.combine64(js.checksum(jstate))
    else:
        assert tstate is None


# ---------------------------------------------------------------------------
# 4. Samplers
# ---------------------------------------------------------------------------


def test_repeat_last_sampler_and_default():
    last = np.array([3, 9], np.uint8)
    bits = tspec.enumerate_branches(torch.Generator().manual_seed(0), last, 5, 4)
    assert bits.shape == (5, 4, P) and (bits.numpy() == last).all()
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jspec.enumerate_branches(jax.random.PRNGKey(0), last, 5, 4)))


@pytest.mark.parametrize("seed", [0, 7])
def test_bitmask_sampler_structure_and_seed(seed):
    last = np.array([3, 9], np.uint8)
    sampler = tspec.bitmask_sampler(num_bits=4, keep_prob=0.5)
    draw = lambda: tspec.enumerate_branches(  # noqa: E731
        torch.Generator().manual_seed(seed), last, 16, 8, sampler=sampler).numpy()
    bits = draw()
    assert bits.shape == (16, 8, P) and bits.dtype == np.uint8
    assert (bits[0] == last).all()  # branch 0 is repeat-last
    assert (bits < 16).all() and not (bits[1:] == last).all()
    np.testing.assert_array_equal(draw(), bits)  # reproducible from the seed
    other = tspec.enumerate_branches(torch.Generator().manual_seed(seed + 1), last, 16, 8,
                                     sampler=sampler).numpy()
    assert not np.array_equal(other, bits)
