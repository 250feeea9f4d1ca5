"""PyTorch port, ``parallel/multihost.py``: process-group bootstrap and the
global mesh, two gloo processes on the CPU.

The JAX package's ``tests/test_multihost.py`` (with
``multihost_worker.py``) skips on the CPU, whose jaxlib has no
cross-process transport; the port's gloo group runs the same two phases
here: (1) a branch-sharded box_game rollout (8 branches x 4 frames over
both processes) and the commit of branch 5, which lives on the other
process for process 0; (2) a lockstep SyncTest (``check_distance`` 2,
``max_prediction`` 4) with the world row-sharded across the processes.
Both processes' checksums equal each other's and the JAX package's
single-process run of the same inputs (computed in this process). The
processes start with ``torch.multiprocessing.spawn`` and meet at a
``file://`` rendezvous under ``tmp_path``. About 15 s on one core.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from bevy_ggrs_tpu_torch.parallel import multihost

B, F, P = 8, 4, 2
LIVE_FRAMES = 10


def phase_bits() -> np.ndarray:
    """The rollout's branch tensor, the same on every process (JAX's
    worker draws it so)."""
    return np.random.RandomState(7).randint(0, 16, (B, F, P), dtype=np.uint8)


def worker(rank: int, rdv: str, out_dir: str) -> None:
    """One process: the topology calls, then the two phases; writes its
    results to ``rank<k>.json``."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.ops.checksum import checksum
    from bevy_ggrs_tpu_torch.parallel.speculate import SpeculativeExecutor
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import SyncTestSession
    from bevy_ggrs_tpu_torch.state import combine64

    out = {"init": list(multihost.initialize(f"file://{rdv}", 2, rank, device="cpu"))}
    try:
        out["topology"] = multihost.process_topology()
        out["slice"] = list(multihost.local_branch_slice(B))
        try:
            multihost.local_branch_slice(B + 1)
            out["odd_slice"] = "no error"
        except ValueError as exc:
            out["odd_slice"] = str(exc)
        out["again"] = list(multihost.initialize(f"file://{rdv}", 2, rank, device="cpu"))
        # Phase 1: every process builds the same branch tensor and rolls
        # out its block; the commit of branch 5 crosses processes.
        mesh = multihost.global_branch_mesh(device_type="cpu")
        out["mesh"] = [list(mesh.mesh_dim_names), [mesh.size(0), mesh.size(1)]]
        state = box_game.make_world(P, device="cpu").commit()
        ex = SpeculativeExecutor(box_game.make_schedule(), B, F, mesh=mesh)
        res = ex.run(state, 0, phase_bits())
        out["block"] = [res.first_branch, int(res.checksums.shape[0])]
        ring, final = ex.commit(res, 5)
        out["rollout_checksum"] = combine64(checksum(final))
        out["ring_lanes"] = ring.checksums.tolist()
        # Phase 2: a live SyncTest, the world sharded over both processes.
        mesh2 = multihost.global_branch_mesh(entity_shards=2, device_type="cpu")
        session = SyncTestSession(P, box_game.INPUT_SPEC, check_distance=2, max_prediction=4)
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(P, device="cpu").commit(),
                                max_prediction=4, num_players=P,
                                input_spec=box_game.INPUT_SPEC, device="cpu", mesh=mesh2)
        for f in range(LIVE_FRAMES):
            for h in range(P):
                session.add_local_input(h, chip_smoke.sup_keys(h, f))
            runner.handle_requests(session.advance_frame(), session)
        out["frame"] = runner.frame
        out["rows"] = int(runner.state.capacity)
        out["live_checksum"] = combine64(runner.layout.entity.checksum(runner.state))
        everyone = [None, None]
        dist.all_gather_object(everyone, out["live_checksum"])
        out["everyone"] = everyone
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def jax_reference() -> dict:
    """The JAX package's single-process run of both phases."""
    from bevy_ggrs_tpu.models import box_game as jbox
    from bevy_ggrs_tpu.parallel.speculate import SpeculativeExecutor
    from bevy_ggrs_tpu.runner import RollbackRunner
    from bevy_ggrs_tpu.session import SyncTestSession
    from bevy_ggrs_tpu.state import checksum, combine64

    ex = SpeculativeExecutor(jbox.make_schedule(), B, F)
    res = ex.run(jbox.make_world(P).commit(), 0, phase_bits())
    ring, final = ex.commit(res, 5)
    session = SyncTestSession(P, jbox.INPUT_SPEC, check_distance=2, max_prediction=4)
    runner = RollbackRunner(jbox.make_schedule(), jbox.make_world(P).commit(),
                            max_prediction=4, num_players=P, input_spec=jbox.INPUT_SPEC)
    for f in range(LIVE_FRAMES):
        for h in range(P):
            session.add_local_input(h, chip_smoke.sup_keys(h, f))
        runner.handle_requests(session.advance_frame(), session)
    return {"rollout": combine64(np.asarray(checksum(final))),
            "ring_lanes": np.asarray(ring.checksums).astype(np.int64).tolist(),
            "live": combine64(np.asarray(checksum(runner.state)))}


def test_two_processes_run_both_phases_like_jax(tmp_path, monkeypatch):
    import torch.multiprocessing as mp

    monkeypatch.setenv("PYTHONHASHSEED", "0")
    mp.spawn(worker, args=(str(tmp_path / "rdv"), str(tmp_path)), nprocs=2, join=True)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    ref = jax_reference()
    for r, out in enumerate(ranks):
        assert out["init"] == out["again"] == [r, 2]
        assert out["topology"] == {"process_index": r, "process_count": 2,
                                   "local_devices": ["cpu"], "global_device_count": 2}
        assert out["slice"] == [r * B // 2, (r + 1) * B // 2]
        assert "not divisible by process_count=2" in out["odd_slice"]
        assert out["mesh"] == [["branch", "entity"], [2, 1]]
        assert out["block"] == [r * B // 2, B // 2]
        assert out["rollout_checksum"] == ref["rollout"]
        assert out["ring_lanes"] == ref["ring_lanes"]
        assert out["frame"] == LIVE_FRAMES and out["rows"] == 8
        assert out["live_checksum"] == ref["live"]
        assert out["everyone"] == [ref["live"], ref["live"]]


def test_single_process_calls_are_no_ops(monkeypatch):
    """One process: ``initialize`` returns ``(0, 1)`` without a group when
    one process is asked for or nothing names a cluster; the slice is
    every branch and the topology one device."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(num_processes=1) == (0, 1)
    assert multihost.initialize("127.0.0.1:1", num_processes=0) == (0, 1)
    was = dist.is_initialized()
    assert multihost.initialize() == ((0, 1) if not was else
                                      (dist.get_rank(), dist.get_world_size()))
    assert dist.is_initialized() == was
    if not was:
        assert multihost.local_branch_slice(7) == (0, 7)
        topo = multihost.process_topology()
        assert (topo["process_index"], topo["process_count"],
                topo["global_device_count"]) == (0, 1, 1)
        assert topo["local_devices"] == (["cpu"] if not torch.cuda.is_available()
                                         else [f"cuda:{torch.cuda.current_device()}"])


def test_a_mesh_without_a_group_makes_a_one_process_group():
    """A mesh asked for without an initialized group gets a world-size-1
    group (gloo on the CPU, named); the global mesh then spans that one rank."""
    mesh = multihost.global_branch_mesh(device_type="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert tuple(mesh.mesh_dim_names) == ("branch", "entity")
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    assert multihost.local_branch_slice(6) == (0, 6)
    with pytest.raises(ValueError, match="not divisible by entity_shards=3"):
        multihost.global_branch_mesh(entity_shards=3, device_type="cpu")
