"""PyTorch port, isolation: the port, ``chip_smoke.py``,
``time_kernels.py``, ``bench_torch.py`` and the examples of
``examples_torch/`` import nothing of JAX or of the JAX package, and its entry points run on ``cuda`` unless told
otherwise, raising when there is no GPU instead of falling back to the
CPU (the models' worlds, the predictor's batched ranker, the runners and
the bench included). The fleet's and the relay tree's child processes
serve on ``cuda`` unless their config says ``"cpu"``, and refuse to start
without a GPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import GGRSPlugin, RollbackApp, SessionType
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.models import neural_bots as tbots
from bevy_ggrs_tpu_torch.models import projectiles as tproj
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.predict import InputPredictor, load_default
from bevy_ggrs_tpu_torch.predict.batch import BatchedRanker
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.serve import BatchedSessionCore, MatchServer
from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENTRY_FILES = sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "bench_torch.py"]
PORT_FILES = sorted((ROOT / "bevy_ggrs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_kernels.py"
] + ENTRY_FILES
FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_ggrs_tpu")


def imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if is_forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import bevy_ggrs_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print(len(new))\n"
        "print(' '.join(m for m in new if m.split('.')[0] in %r))\n" % (FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.splitlines()
    assert int(out[0]) > 20  # the whole port was imported
    assert out[1:] in ([], [""]), f"the port loaded {out[1]}"


def test_importing_the_bench_and_the_examples_loads_no_jax_module():
    code = (
        "import sys, importlib.util, pathlib\n"
        "sys.path.insert(0, %r)\n"
        "before = set(sys.modules)\n"
        "for path in %r:\n"
        "    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print(' '.join(m for m in new if m.split('.')[0] in %r))\n"
        % (str(ROOT / "examples_torch"), [str(p) for p in ENTRY_FILES], FORBIDDEN)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "", f"the entry points loaded {out}"
    assert len(ENTRY_FILES) == 7


ENTRY_POINTS = {
    "bench_torch.set_device": lambda: bench_torch.set_device("cuda"),
    "init_state": lambda: ts.init_state(tbox.make_registry(), 4),
    "HostWorld.commit": lambda: ts.HostWorld(tbox.make_registry(), 4).commit(),
    "from_host": lambda: ts.from_host(
        tbox.make_registry(), ts.to_host(tbox.make_world(2, device="cpu").commit())),
    "box_game.make_world": lambda: tbox.make_world(2),
    "boids.make_world": lambda: tboids.make_world(8, 2),
    "projectiles.make_world().commit()": lambda: tproj.make_world(4).commit(),
    "neural_bots.make_world().commit()": lambda: tbots.make_world(8, 2).commit(),
    "BatchedRanker": lambda: BatchedRanker(
        InputPredictor(load_default()).bind(list(range(16)), np.uint8), 8),
    "RollbackRunner": lambda: RollbackRunner(
        tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
        max_prediction=4, num_players=2, input_spec=tbox.INPUT_SPEC),
    "GGRSPlugin.build": lambda: (
        GGRSPlugin(tbox.INPUT_SPEC)
        .with_input_system(lambda handle, app: np.uint8(0))
        .register_rollback_component("translation", shape=(3,))
        .build()),
    "GGRSPlugin.build (P2P stage)": lambda: p2p_app(),
    "GGRSPlugin.build (speculation)": lambda: p2p_app(speculation=4),
    "BatchedSessionCore": lambda: BatchedSessionCore(
        tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(), 4, 2,
        tbox.INPUT_SPEC, num_slots=2),
    "MatchServer": lambda: MatchServer(
        tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(), 4, 2,
        tbox.INPUT_SPEC, capacity=2, stagger_groups=1),
    "SpeculativeRollbackRunner": lambda: SpeculativeRollbackRunner(
        tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
        max_prediction=4, num_players=2, input_spec=tbox.INPUT_SPEC, num_branches=4),
}


def p2p_session():
    """A P2P session: host code, built without touching a device."""
    builder = SessionBuilder(tbox.INPUT_SPEC).with_num_players(2)
    builder.add_player(PlayerType.local(), 0)
    builder.add_player(PlayerType.remote(("peer", 1)), 1)
    return builder.start_p2p_session(LoopbackNetwork().socket(("peer", 0)))


def p2p_app(speculation=0):
    app = RollbackApp().insert_session(p2p_session(), SessionType.P2P)
    return (GGRSPlugin(tbox.INPUT_SPEC)
            .with_input_system(lambda handle, app: np.uint8(0))
            .register_rollback_component("translation", shape=(3,))
            .with_speculation(speculation)
            .build(app))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_session_builder_is_host_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p2p_session().current_state().name == "SYNCHRONIZING"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ts.resolve_device(None) == torch.device("cuda")
    assert ts.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    world = ts.init_state(tbox.make_registry(), 8, device="meta")
    ring = ts.SnapshotRing(
        states=ts.tree_map(lambda x: x[None].expand((2,) + x.shape), world),
        frames=torch.zeros((2,), dtype=torch.int32, device="meta"),
        checksums=torch.zeros((2, 2), dtype=torch.int64, device="meta"))
    for call in (lambda: tck.world_checksum(world),
                 lambda: tck.world_checksum(world, "save", ring=ring, frame=0),
                 lambda: tck.world_checksum(None, "guard", ring=ring, frame=0)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    pos = torch.zeros((8, 2), device="meta")
    act = torch.zeros((8,), device="meta")
    params = tboids._kernel_params()
    with pytest.raises(ValueError, match="no kernel"):
        tpw.pairwise_force_rows(pos, pos, pos, pos, act, act, **params)
    with pytest.raises(ValueError, match="no kernel"):
        tpw.pairwise_force_rows_mxu2(pos, pos, pos, pos, act, act, **params)
    with pytest.raises(ValueError, match="no kernel"):
        tpw.pairwise_force_square_mxu_tri(pos, pos, act, **params)
    kernel = tboids.FLOCK_PAIR_KERNEL
    rows = {name: torch.zeros((4, 16), device="meta") for name in kernel.row_names}
    cols = {name: torch.zeros((4, 160), device="meta") for name in kernel.col_names}
    with pytest.raises(ValueError, match="no kernel"):
        tcg.cell_slot_forces(kernel, rows, cols)


def test_slot_save_launches_or_raises_off_the_cpu():
    """The save over ``[S]`` slots with per-slot frames never takes its
    plain version for a tensor off the CPU."""
    world = ts.init_state(tbox.make_registry(), 8, device="meta")
    slots = ts.tree_map(lambda x: x[None].expand((3,) + x.shape), world)
    rings = ts.SnapshotRing(
        states=ts.tree_map(lambda x: x[:, None].expand((3, 2) + x.shape[1:]), slots),
        frames=torch.zeros((3, 2), dtype=torch.int32, device="meta"),
        checksums=torch.zeros((3, 2, 2), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tck.world_checksum(slots, "save", ring=rings,
                           frames=torch.zeros(3, dtype=torch.int32, device="meta"),
                           keep=torch.ones(3, dtype=torch.bool, device="meta"))


CHILDREN = {
    "bevy_ggrs_tpu_torch.fleet.proc": {"fps": 0, "capacity": 2, "stagger_groups": 1},
    "bevy_ggrs_tpu_torch.relay.tree": {"relay_id": 1},
}


def run_child(module, config, env_extra):
    """Start ``python -m module '<config>'``; return its first stdout line
    (or ``""``), its exit code and its stderr, after asking it to stop."""
    import json
    import os

    env = dict(os.environ, **env_extra)
    proc = subprocess.Popen([sys.executable, "-m", module, json.dumps(config)], cwd=ROOT,
                            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    first = proc.stdout.readline().decode()
    if first:
        proc.stdin.write(b'{"cmd": "shutdown"}\n')
        proc.stdin.flush()
    out, err = proc.communicate(timeout=120)
    return first, proc.returncode, err.decode()


@pytest.mark.parametrize("module", sorted(CHILDREN))
def test_children_default_to_cuda_and_raise_without_a_gpu(module):
    import importlib

    mod = importlib.import_module(module)
    defaults = getattr(mod, "DEFAULT_CONFIG", None) or mod.DEFAULT_RELAY_PROC_CONFIG
    assert defaults["device"] is None
    first, rc, err = run_child(module, CHILDREN[module], {"CUDA_VISIBLE_DEVICES": ""})
    assert first == "" and rc != 0 and "no CUDA device" in err, err[-2000:]
    first, rc, err = run_child(module, dict(CHILDREN[module], device="cpu"), {})
    assert '"event": "ready"' in first and rc == 0, err[-2000:]
