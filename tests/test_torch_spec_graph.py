"""The speculative rollout as one CUDA graph (``parallel/speculate.py``):
which path ``SpeculativeExecutor.run`` takes, what a captured rollout is
keyed by, and, with a stand-in for the CUDA graph on the CPU, that replays
give the eager rollout's bits, that every result owns its tensors and that
the kernel wrappers' launches stay true. The card's own replays are held to
the eager rollout by ``chip_smoke.py``'s phase 11."""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch import ops
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import pairwise
from bevy_ggrs_tpu_torch.ops.checksum import checksum_plain
from bevy_ggrs_tpu_torch.parallel import speculate as tspec
from bevy_ggrs_tpu_torch.parallel.sharding import MeshLayout, branch_mesh
from bevy_ggrs_tpu_torch.schedule import PREDICTED, Schedule, make_inputs

B, F, P = 8, 4, 2
CUDA = torch.device("cuda")  # a device object only: nothing here needs a GPU


def world(players=P):
    return tbox.make_world(players, device="cpu").commit()


def tree(seed, b=B, f=F, players=P):
    return np.random.RandomState(seed).randint(0, 16, (b, f, players)).astype(np.uint8)


STATUS = np.full((F, P), PREDICTED, np.int32)


class StubGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured body
    again into its own outputs and, as a real replay, calls no kernel
    wrapper's count."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        before = ops.launch_counts()
        rings, states, lanes = self.body()
        ops.add_launches({k: before[k] - v for k, v in ops.launch_counts().items()})
        out_rings, out_states, out_lanes = self.out
        ts.tree_map(lambda o, n: o.copy_(n), out_rings.states, rings.states)
        out_rings.frames.copy_(rings.frames)
        out_rings.checksums.copy_(rings.checksums)
        ts.tree_map(lambda o, n: o.copy_(n), out_states, states)
        out_lanes.copy_(lanes)


def stub_capture(body):
    out = body()
    return StubGraph(body, out), out


@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph path on the CPU, through :class:`StubGraph`."""
    monkeypatch.setattr(tspec, "_capture", stub_capture)
    monkeypatch.setattr(tspec, "graph_path", lambda device, layout: True)


def counted(schedule):
    """``schedule`` with a system that counts one launch of the mxu2
    wrapper a step, as the kernel's wrapper does on the card."""

    def launch(state, inputs):
        pairwise.pairwise_force_rows_mxu2.launches += 1
        return state

    return Schedule(schedule.systems + (launch,))


def leaves(state):
    return ts.tree_leaves([state.alive, state.rollback_id, state.components, state.present,
                           state.resources])


def same(res, want) -> bool:
    rings, states, lanes = want
    return (torch.equal(res.rings.frames, rings.frames)
            and torch.equal(res.rings.checksums, rings.checksums)
            and torch.equal(res.checksums, lanes)
            and all(torch.equal(a, b) for a, b in zip(leaves(res.rings.states),
                                                      leaves(rings.states)))
            and all(torch.equal(a, b) for a, b in zip(leaves(res.states), leaves(states))))


# ---------------------------------------------------------------------------
# The path and the key
# ---------------------------------------------------------------------------


def test_graph_path_needs_a_cuda_world_without_mesh_or_checksum_hook():
    sched = tbox.make_schedule()
    plain = MeshLayout(sched, B)
    assert tspec.graph_path(CUDA, plain)
    assert not tspec.graph_path(torch.device("cpu"), plain)
    mesh = branch_mesh(device_type="cpu")
    assert not tspec.graph_path(CUDA, MeshLayout(sched, B, mesh))
    assert not tspec.graph_path(CUDA, MeshLayout(sched, B, mesh, branch_axis=None,
                                                 entity_axis="entity",
                                                 state_template=world()))
    ts.set_checksum_impl(checksum_plain)
    try:
        assert not tspec.graph_path(CUDA, plain)
    finally:
        ts.set_checksum_impl(None)
    assert tspec.graph_path(CUDA, plain)


@pytest.mark.parametrize("kind", ["cpu", "branch mesh", "entity mesh", "checksum hook"])
def test_cpu_meshed_and_hooked_runs_take_the_eager_path(kind):
    state = world()
    kw = {}
    if kind == "branch mesh":
        kw = dict(mesh=branch_mesh(device_type="cpu"))
    if kind == "entity mesh":
        kw = dict(mesh=branch_mesh(device_type="cpu"), branch_axis=None,
                  entity_axis="entity", state_template=state)
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F, **kw)
    want = tspec.rollout_branches(tbox.make_schedule(), state, 3, tree(1), STATUS, F)
    if kind == "checksum hook":
        ts.set_checksum_impl(checksum_plain)
    try:
        res = [ex.run(state, 3, tree(1)) for _ in range(2)]
    finally:
        ts.set_checksum_impl(None)
    assert (ex.eager_runs, ex.graph_captures, ex.graph_replays) == (2, 0, 0)
    assert torch.equal(res[1].checksums, want[2])


def test_the_key_holds_shapes_structure_and_schedule_not_values():
    sched = tbox.make_schedule()
    key = tspec.rollout_key(sched, world(), tree(0), STATUS, F)
    moved = ts.tree_map(lambda x: x.clone(), world())
    moved.components["translation"] += 1.0
    assert tspec.rollout_key(sched, moved, tree(5), STATUS + 0, F) == key
    other = {
        "B": tspec.rollout_key(sched, world(), tree(0, b=B + 1), STATUS, F),
        "F": tspec.rollout_key(sched, world(), tree(0, f=F + 1),
                               np.full((F + 1, P), PREDICTED, np.int32), F + 1),
        "depth": tspec.rollout_key(sched, world(), tree(0), STATUS, F + 2),
        "players": tspec.rollout_key(sched, world(3), tree(0, players=3),
                                     np.full((F, 3), PREDICTED, np.int32), F),
        "dtype": tspec.rollout_key(sched, ts.tree_map(
            lambda x: x.to(torch.float16) if x.dtype == torch.float32 else x, world()),
            tree(0), STATUS, F),
        "resources": tspec.rollout_key(sched, world().replace(resources={}), tree(0),
                                       STATUS, F),
        "schedule": tspec.rollout_key(tbox.make_schedule(), world(), tree(0), STATUS, F),
        "bits dtype": tspec.rollout_key(sched, world(), tree(0).astype(np.int32), STATUS, F),
    }
    assert all(k != key for k in other.values())
    assert len(set(other.values())) == len(other)


def test_a_new_key_captures_again_and_the_old_one_still_replays(stub_graphs):
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F)
    small, big = world(), world(3)
    for state, players in ((small, P), (big, 3), (small, P), (big, 3)):
        ex.run(state, 7, tree(2, players=players))
    assert (ex.graph_captures, ex.graph_replays, ex.eager_runs) == (2, 2, 0)


# ---------------------------------------------------------------------------
# Replays, with the CPU stand-in for the graph
# ---------------------------------------------------------------------------


def test_replays_give_the_eager_rollouts_bits(stub_graphs):
    """The capturing call, a replay at the captured start frame and others
    at other frames and from other worlds, each bitwise the eager
    ``rollout_branches``."""
    sched = tbox.make_schedule()
    ex = tspec.SpeculativeExecutor(sched, B, F)
    later = sched(world(), make_inputs(np.array([1, 8], np.uint8), device="cpu"))
    calls = [(world(), 60, 0), (world(), 60, 1), (later, 61, 2), (world(), -5, 3),
             (later, 2**31 - F, 4)]
    for state, start, seed in calls:
        res = ex.run(state, start, tree(seed))
        assert same(res, tspec.rollout_branches(sched, state, start, tree(seed), STATUS, F))
        assert res.start_frame == start
    assert (ex.graph_captures, ex.graph_replays) == (1, len(calls) - 1)


def test_a_replay_keeps_the_systems_it_captured(stub_graphs, monkeypatch):
    """The key holds the schedule by identity: a system added after the
    key's first call runs in no replay (the graph keeps what it captured,
    as JAX's executor, jitted once, keeps its trace), while an eager run on
    the CPU runs it at once."""
    sched = tbox.make_schedule()
    ex = tspec.SpeculativeExecutor(sched, B, F)
    ex.run(world(), 0, tree(0))
    calls = []

    def added(state, inputs):
        calls.append(inputs.bits.shape)
        return state

    sched.add_system(added)
    res = ex.run(world(), 9, tree(1))
    assert calls == [] and (ex.graph_captures, ex.graph_replays) == (1, 1)
    assert same(res, tspec.rollout_branches(tbox.make_schedule(), world(), 9, tree(1),
                                            STATUS, F))
    monkeypatch.undo()  # the CPU's own path: eager
    ex.run(world(), 9, tree(1))
    assert calls == [(B, P)] * F and ex.eager_runs == 1


def test_a_result_owns_its_tensors(stub_graphs):
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F)
    ex.run(world(), 0, tree(0))
    res = ex.run(world(), 10, tree(1))
    kept = [t.clone() for t in leaves(res.rings.states) + leaves(res.states)]
    kept += [res.rings.frames.clone(), res.rings.checksums.clone(), res.checksums.clone()]
    ex.run(world(), 20, tree(2))
    ex.run(world(), 30, tree(3))
    now = leaves(res.rings.states) + leaves(res.states)
    now += [res.rings.frames, res.rings.checksums, res.checksums]
    assert all(torch.equal(a, b) for a, b in zip(now, kept))


def test_frames_past_int32_are_refused(stub_graphs):
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), B, F)
    ex.run(world(), 0, tree(0))
    with pytest.raises(ValueError, match="int32"):
        ex.run(world(), 2**31 - F + 1, tree(0))


def test_launches_count_what_ran(stub_graphs):
    """The capture launches nothing (the capturing call counts its eager
    run alone), a replay adds what its graph holds, and N calls count
    what N eager rollouts count."""
    sched = counted(tbox.make_schedule())
    ex = tspec.SpeculativeExecutor(sched, B, F)
    name = pairwise.pairwise_force_rows_mxu2.__name__
    graph = []
    for i in range(5):
        before = ops.launch_counts()
        ex.run(world(), i, tree(i))
        graph.append({k: v - before[k] for k, v in ops.launch_counts().items()})
    before = ops.launch_counts()
    for i in range(5):
        tspec.rollout_branches(sched, world(), i, tree(i), STATUS, F)
    eager = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert all(g == {**{k: 0 for k in g}, name: F} for g in graph)
    assert {k: sum(g[k] for g in graph) for k in eager} == eager
    assert (ex.graph_captures, ex.graph_replays) == (1, 4)


def test_a_single_branch_result_owns_its_tensors(stub_graphs):
    """At B = 1 the broadcast of the start world is the start buffer
    itself: the capturing call's result must not share it."""
    ex = tspec.SpeculativeExecutor(tbox.make_schedule(), 1, F)
    first = ex.run(world(), 0, tree(0, b=1))
    kept = [t.clone() for t in leaves(first.states)]
    other = world()
    other.rollback_id.fill_(7)
    ex.run(other, 0, tree(1, b=1))
    assert all(torch.equal(a, b) for a, b in zip(leaves(first.states), kept))
