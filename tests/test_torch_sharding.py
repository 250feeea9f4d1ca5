"""PyTorch port, sharding (``parallel/sharding.py``) on gloo ranks on the CPU.

Ranks are processes started with ``torch.multiprocessing.spawn``, joined
through a ``file://`` rendezvous under ``tmp_path`` (no TCP port to race
for under xdist), several checks a spawn. Each check holds the port's
sharded run bitwise against the port's unsharded run on the same rank, and
the result against the JAX package's run of the same inputs in this
process (unsharded: the JAX suite proves its sharded runs bitwise its
unsharded ones):

- phase 19 of ``chip_smoke.py`` on the CPU at a small size: a world-size-1
  group (an entity-meshed SyncTest and a meshed speculating P2P pair
  through ``GGRSPlugin.with_mesh``, each with attestation on the sharded
  programs), two ranks (box_game, boids pallas, mxu and mxu grid, an xla
  frame, the branch-sharded rollout and its cross-rank commits, a meshed
  runner's checkpoint loaded unmeshed and the reverse, and a repair) and
  ``GGRS_SESSION_AXIS=3``;
- two ranks with the CPU test's extra runs: boids xla, dense and grid,
  and projectiles through the gather rule; box_game's and
  projectiles' checksum streams bitwise JAX's, boids within the tolerance
  of ``test_torch_synctest.py``;
- four ranks: a 1 x 4 entity mesh for the same runs and a 2 x 2 mesh's
  speculating P2P pair;
- in this process: the byte-view collectives, the layouts, the resource
  flag of the checksum, the row-chunked xla forces and the tensor-core
  plain version at the whole world's launch shape.

Box_game's keys change every 3 frames (below the speed clamp, where the
jitted JAX step's fused magnitude would differ). About 60 s on one core.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.parallel import sharding

BOIDS_ATOL = 1e-5  # tests/test_torch_synctest.py's boids tolerance against JAX


def jax_synctest(model, frames, keys, cd, world, schedule, players=2):
    """The JAX package's SyncTest of the same inputs: the reported
    (frame, checksum) stream and the final host world."""
    from bevy_ggrs_tpu.runner import RollbackRunner
    from bevy_ggrs_tpu.session import SyncTestSession
    from bevy_ggrs_tpu.state import to_host

    runner = RollbackRunner(schedule, world, max_prediction=8, num_players=players,
                            input_spec=model.INPUT_SPEC)
    session = SyncTestSession(players, model.INPUT_SPEC, check_distance=cd, max_prediction=8)
    log = chip_smoke.shard_reports(session)
    for f in range(frames):
        for h in range(players):
            session.add_local_input(h, keys(h, f))
        runner.handle_requests(session.advance_frame(), session)
    return [list(x) for x in log], to_host(runner.state)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's runs of the ranks' inputs, once for the module."""
    from bevy_ggrs_tpu.models import boids as jboids
    from bevy_ggrs_tpu.models import box_game as jbox
    from bevy_ggrs_tpu.models import projectiles as jproj

    cfg = chip_smoke.SHARD_CPU
    out = {"box": jax_synctest(jbox, cfg["sync_frames"], chip_smoke.sup_keys,
                               chip_smoke.SHARD_CD, jbox.make_world(2).commit(),
                               jbox.make_schedule())[0],
           "projectiles": jax_synctest(
               jproj, cfg["proj_frames"], lambda h, f: np.uint8((f * 3 + h * 5) % 32),
               chip_smoke.SHARD_CD, jproj.make_world(2, capacity=32).commit(),
               jproj.make_schedule())[0]}
    for kernel, mode in (("pallas", "dense"), ("mxu", "dense"), ("xla", "dense"),
                         ("xla", "grid"), ("mxu", "grid")):
        _, host = jax_synctest(jboids, cfg["boids_frames"], lambda h, f: np.uint8((f + h) % 16),
                               4, jboids.make_world(cfg["boids"], 2).commit(),
                               jboids.make_schedule(kernel=kernel, mode=mode))
        out[f"boids_{kernel}_{mode}"] = host["components"]
    return out


def check_ranks(ranks, jax_refs, world):
    """Every rank's sharded runs bitwise its unsharded ones and the same
    on every rank; box_game and projectiles bitwise JAX; boids within
    tolerance of JAX."""
    for r in ranks:
        for name, run in r.items():
            if isinstance(run, dict) and "equal" in run:
                assert run["equal"], (world, name)
        assert r["rollout"]["lanes_equal"] and all(r["rollout"]["commits_equal"].values())
        if "xla_frame" in r:
            assert r["xla_frame"]["checksum"] == r["xla_frame"]["plain_checksum"]
    assert ranks[0]["box_synctest"]["stream"] == ranks[-1]["box_synctest"]["stream"]
    assert ranks[0]["box_synctest"]["stream"] == jax_refs["box"]
    assert ranks[0]["box_synctest"]["collectives"]["all_reduce"] > 0
    # The rollout's last branch lives on the last branch rank.
    assert ranks[0]["rollout"]["owner_of_last"] == world - 1
    if "projectiles" in ranks[0]:
        assert ranks[0]["projectiles"]["stream"] == jax_refs["projectiles"]
    for name in ("boids_pallas_dense", "boids_mxu_dense", "boids_xla_dense",
                 "boids_xla_grid", "boids_mxu_grid"):
        if name not in ranks[0]:
            continue
        assert ranks[0][name]["collectives"]["all_gather"] > 0, name
        for comp in ("position", "velocity"):
            np.testing.assert_allclose(np.asarray(ranks[0][name]["world"][comp]),
                                       np.asarray(jax_refs[name][comp]),
                                       rtol=0, atol=BOIDS_ATOL, err_msg=name)


def test_chip_smoke_phase_19_on_the_cpu(tmp_path, jax_refs):
    """Phase 19 small, its two ranks with the CPU test's extra runs, held
    against JAX too."""
    line = chip_smoke.sharding_phase("cpu", chip_smoke.SHARD_CPU, out_dir=str(tmp_path),
                                     runs=chip_smoke.SHARD_RUNS_CPU)
    assert line["a"]["synctest_bitwise"] and line["a"]["p2p_bitwise"]
    assert line["a"]["settled_compared"] > 0
    assert all(line["b"]["bitwise"].values()) and len(line["b"]["bitwise"]) == 10
    for r in line["ranks"]:
        # A meshed runner's checkpoint is the unmeshed one's file, and a
        # flipped ring bit on one rank is repaired on both.
        assert r["checkpoint"]["checkpoint_bytes_equal"]
        assert r["checkpoint"]["repair"]["repaired"] == 1 and r["checkpoint"]["repair"]["bitwise"]
    assert line["c"]["synctest_bitwise"] and line["c"]["p2p_bitwise"]
    assert line["world_sizes"] == {"a": 1, "b": 2}
    # The meshed P2P pair summed its lanes over the (size-1) groups.
    assert line["a"]["collectives"]["p2p"]["all_reduce"] > 0
    check_ranks(line["ranks"], jax_refs, 2)


def test_four_ranks_and_a_two_by_two_mesh(tmp_path, jax_refs):
    """A 1 x 4 entity mesh's SyncTest, a 4 x 1 branch mesh's rollout, and
    a 2 x 2 mesh's speculating P2P pair bitwise the unmeshed pair."""
    ranks = chip_smoke.shard_spawn(4, "cpu", chip_smoke.SHARD_CPU, str(tmp_path),
                                   chip_smoke.SHARD_RUNS_2X2)
    check_ranks(ranks, jax_refs, 4)
    plain = ranks[0]["p2p_plain"]
    for r in ranks:
        meshed = r["p2p_2x2"]
        assert meshed["settled"] == plain["settled"] and meshed["settled"]
        assert meshed["desyncs"] == 0 and all(meshed["attested"])
        assert meshed["real_checked"] == plain["real_checked"]
        # The chosen branches crossed the branch axis.
        assert meshed["collectives"]["broadcast"] > 0
    assert ranks[0]["p2p_2x2"]["settled"] == ranks[3]["p2p_2x2"]["settled"]


def test_session_axis_env_is_bitwise(monkeypatch):
    """``GGRS_SESSION_AXIS=3``: the speculating runner's ticks through the
    slot-batched tick, bitwise the singleton (frames, ring lanes, hits)."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

    monkeypatch.delenv("GGRS_SESSION_AXIS", raising=False)
    plain = chip_smoke.shard_spec_synctest("cpu", 20, 8)
    monkeypatch.setenv("GGRS_SESSION_AXIS", "3")
    axed = chip_smoke.shard_spec_synctest("cpu", 20, 8)
    assert (axed["stream"], axed["ring"], axed["hits"], axed["frame"]) == (
        plain["stream"], plain["ring"], plain["hits"], plain["frame"])
    runner = SpeculativeRollbackRunner(
        box_game.make_schedule(), box_game.make_world(2, device="cpu").commit(),
        max_prediction=8, num_players=2, input_spec=box_game.INPUT_SPEC, num_branches=4,
        device="cpu")
    assert runner._fused.session_axis == 3 and runner._fused._batched is None


def world_mesh():
    return sharding.branch_mesh(device_type="cpu")


def test_layouts_and_mesh_errors():
    mesh = world_mesh()
    assert tuple(mesh.mesh_dim_names) == ("branch", "entity")
    with pytest.raises(ValueError, match="not divisible by entity_shards=2"):
        sharding.branch_mesh(entity_shards=2, device_type="cpu")
    state = tboids.make_world(8, 2, device="cpu").commit()
    specs = sharding.world_pspecs(state, "entity")
    assert specs.alive == sharding.P("entity") and specs.components["position"] == ("entity",)
    assert specs.resources["frame_count"] == sharding.P()
    assert sharding.world_pspecs(state).alive == sharding.P()
    state_s, ring_s = sharding.world_and_ring_shardings(state, mesh, "entity", ("branch",))
    assert state_s.alive.spec == ("branch", "entity")
    assert ring_s.states.alive.spec == ("branch", None, "entity")
    assert ring_s.frames == sharding.NamedSharding(mesh, sharding.P("branch"))
    assert sharding.branch_pspec(mesh).spec == ("branch",)
    assert sharding.replicated(mesh).spec == ()
    # One rank holds the whole world: its shard is the world, and the
    # branch block is every branch.
    own = sharding.shard_world(state, mesh, "entity")
    assert all(torch.equal(a, b) for a, b in zip(ts.tree_leaves(own.components),
                                                 ts.tree_leaves(state.components)))
    bits = np.arange(24).reshape(4, 3, 2)
    assert np.array_equal(sharding.shard_branch_axis(torch.as_tensor(bits), mesh).numpy(), bits)
    assert sharding.mesh_key(mesh)[:2] == (("branch", "entity"), (1, 1))


def test_byte_view_collectives_on_a_one_rank_group():
    """uint32, uint16, bool and bfloat16 leaves cross the group as bytes
    (gloo refuses the first two); the lanes' sum wraps at 32 bits."""
    mesh = world_mesh()
    group = mesh.get_group("entity")
    leaves = [torch.tensor([[0xFFFFFFFF, 7]], dtype=torch.uint32),
              torch.tensor([[0xFFFF, 3, 9]], dtype=torch.uint16),
              torch.tensor([[True, False]]),
              torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16),
              torch.tensor([[3]], dtype=torch.int32)]
    got = sharding.all_gather_rows(leaves, [1] * len(leaves), group)
    for a, b in zip(got, leaves):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    sent = sharding.broadcast_tensors(leaves, 0, group)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(sent, leaves))
    lanes = torch.tensor([[0xFFFFFFFF, 5]], dtype=torch.int64)
    assert torch.equal(sharding.sum_lanes(lanes, group), lanes)
    before = dict(sharding.COLLECTIVES)
    sharding.sum_lanes(lanes, group)
    assert sharding.COLLECTIVES["all_reduce"] == before["all_reduce"] + 1


def test_checksum_resource_flag_splits_the_lanes():
    """Lanes without the resources plus the resources' own hash are the
    whole checksum: what the entity group's sum relies on."""
    state = tboids.make_world(40, 2, device="cpu").commit()
    state = state.replace(resources={"frame_count": torch.tensor(9, dtype=torch.uint32)})
    full = tck.world_checksum(state)
    bare = tck.world_checksum(state, resources=False)
    res = ts._resources_checksum(state.resources, state.device)
    assert torch.equal((bare + res) & 0xFFFFFFFF, full)
    # Two row blocks' bare lanes plus one resource hash: the whole world.
    halves = [state.replace(
        alive=state.alive[i * 20:(i + 1) * 20],
        rollback_id=state.rollback_id[i * 20:(i + 1) * 20],
        components={k: v[i * 20:(i + 1) * 20] for k, v in state.components.items()},
        present={k: v[i * 20:(i + 1) * 20] for k, v in state.present.items()})
        for i in range(2)]
    lanes = tck.checksum_plain(halves[0]) + tck.checksum_plain(halves[1], resources=False)
    assert torch.equal(lanes & 0xFFFFFFFF, full)


def slot_worlds(S=3, n=24):
    """A ``[S]`` boids world whose slots differ in positions and in their
    frame counts (a resource), and ``[S, 4]`` rings of zeros for it."""
    one = tboids.make_world(n, 2, device="cpu").commit()
    worlds = [one.replace(
        components={**one.components, "position": one.components["position"] + s},
        resources={"frame_count": torch.tensor(3 + 7 * s, dtype=torch.uint32)})
        for s in range(S)]
    stacked = ts.tree_map(lambda *xs: torch.stack(xs), *worlds)
    rings = ts.branch_rings(one, S, 4)
    ts.tree_map(lambda x: x.view(torch.uint8).zero_(), rings.states)  # rows are not filled
    return worlds, stacked, rings


def ring_bytes(ring):
    st = ring.states
    leaves = ts.tree_leaves([st.alive, st.rollback_id, st.components, st.present,
                             st.resources])
    return [x.view(torch.uint8) for x in leaves] + [ring.frames, ring.checksums]


SLOT_FRAMES = torch.tensor([5, -3, 2], dtype=torch.int32)


def test_a_slot_save_without_resources_leaves_them_out_on_the_cpu():
    """The save at a frame a slot with ``resources=False`` gives each slot
    the lanes and the rows a single save without resources gives it."""
    worlds, stacked, rings = slot_worlds()
    singles = [ts.select_branch(rings, s) for s in range(len(worlds))]
    lanes = tck.world_checksum(stacked, "save", ring=rings, frames=SLOT_FRAMES,
                               resources=False)
    for s, (world, ring) in enumerate(zip(worlds, singles)):
        want = tck.save_plain(ring, world, int(SLOT_FRAMES[s]), resources=False)
        assert torch.equal(lanes[s], want)
        assert all(torch.equal(a, b) for a, b in zip(ring_bytes(ts.select_branch(rings, s)),
                                                     ring_bytes(ring)))
    assert not torch.equal(lanes, tck.checksum_plain(stacked))


@pytest.mark.parametrize("hook", [None, tck.checksum_plain], ids=["kernel", "checksum hook"])
def test_an_entity_shards_slot_save_equals_its_single_saves(hook):
    """``EntityShard.save`` at a frame a slot (``frames=``) on a one-rank
    CPU mesh: bitwise the shard's host-frame save of each slot alone, in
    the rows, the frames and the digests."""
    worlds, stacked, rings = slot_worlds()
    shard = sharding.EntityShard(world_mesh(), "entity", worlds[0].capacity)
    singles = [ts.select_branch(rings, s) for s in range(len(worlds))]
    out = torch.zeros((len(worlds), 2), dtype=torch.int64)
    ts.set_checksum_impl(hook)
    try:
        lanes = shard.save(rings, stacked, frames=SLOT_FRAMES, out=out)
        want = [shard.save(ring, world, int(SLOT_FRAMES[s]))
                for s, (world, ring) in enumerate(zip(worlds, singles))]
    finally:
        ts.set_checksum_impl(None)
    assert torch.equal(lanes, torch.stack(want)) and torch.equal(out, lanes)
    for s, ring in enumerate(singles):
        assert all(torch.equal(a, b) for a, b in zip(ring_bytes(ts.select_branch(rings, s)),
                                                     ring_bytes(ring)))


def test_xla_forces_take_row_blocks_bitwise():
    """The row-chunked xla forces: a row block is bitwise the same rows of
    the whole call, whatever its alignment to the chunks."""
    n = 300
    state = tboids.make_world(n, 2, device="cpu").commit()
    pos, vel = state.components["position"], state.components["velocity"]
    act = state.alive.to(torch.float32)
    whole = tboids.xla_force_rows(pos, vel, pos, vel, act, act)
    for lo, hi in ((0, 150), (150, 300), (37, 291)):
        part = tboids.xla_force_rows(pos[lo:hi], vel[lo:hi], pos, vel, act[lo:hi], act)
        assert torch.equal(part, whole[lo:hi]), (lo, hi)


def test_mxu2_plain_at_the_whole_worlds_launch_shape():
    """A row block with ``launch_rows`` = the world's rows is bitwise the
    same rows of the whole call; the launch shape would otherwise give a
    block of 2,048 of 4,096 rows a larger cluster."""
    assert tpw.mxu2_launch_shape(2048, 4096)[0] > tpw.mxu2_launch_shape(4096, 4096)[0]
    n = 256
    state = tboids.make_world(n, 2, device="cpu").commit()
    pos, vel = state.components["position"], state.components["velocity"]
    act = state.alive.to(torch.float32)
    params = tboids._kernel_params()
    whole = tpw.pairwise_force_rows_mxu2(pos, vel, pos, vel, act, act, **params)
    for lo, hi in ((0, 128), (128, 256), (64, 100)):
        part = tpw.pairwise_force_rows_mxu2(pos[lo:hi], vel[lo:hi], pos, vel, act[lo:hi], act,
                                            launch_rows=n, **params)
        assert torch.equal(part, whole[lo:hi]), (lo, hi)


def test_the_gather_rule_wraps_only_coupled_systems():
    """Entity-local systems run on the shard as they are; any other one
    runs through the gather rule (the whole world on every rank)."""
    from bevy_ggrs_tpu_torch.models import box_game, projectiles

    mesh = world_mesh()
    shard = sharding.EntityShard(mesh, "entity", 16)
    box = sharding.shard_schedule(box_game.make_schedule(), shard)
    assert box.systems == box_game.make_schedule().systems
    plain = projectiles.make_schedule()
    assert not any(getattr(s, "entity_local", False) for s in plain.systems)
    proj = sharding.shard_schedule(plain, shard)
    assert all(s.entity_local for s in proj.systems)
    assert not set(proj.systems) & set(plain.systems)
    flock = tboids.make_sharded_schedule(mesh, "entity", "mxu")
    assert sharding.shard_schedule(flock, shard).systems == flock.systems
    assert sharding.shard_schedule(box_game.make_schedule(), None).systems == box.systems
    # A capacity that does not divide over two entity ranks.
    with pytest.raises(ValueError, match="capacity=15 not divisible"):
        sharding._block(15, 2, 0, "capacity")
