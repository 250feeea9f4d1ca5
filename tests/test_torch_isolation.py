"""PyTorch port, isolation: the port, ``chip_smoke.py`` and
``time_kernels.py`` import nothing of JAX or of the JAX package, and its entry points run on ``cuda`` unless told
otherwise, raising when there is no GPU instead of falling back to the
CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import GGRSPlugin
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.runner import RollbackRunner

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bevy_ggrs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_kernels.py"
]
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


ENTRY_POINTS = {
    "init_state": lambda: ts.init_state(tbox.make_registry(), 4),
    "HostWorld.commit": lambda: ts.HostWorld(tbox.make_registry(), 4).commit(),
    "from_host": lambda: ts.from_host(
        tbox.make_registry(), ts.to_host(tbox.make_world(2, device="cpu").commit())),
    "box_game.make_world": lambda: tbox.make_world(2),
    "boids.make_world": lambda: tboids.make_world(8, 2),
    "RollbackRunner": lambda: RollbackRunner(
        tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
        max_prediction=4, num_players=2, input_spec=tbox.INPUT_SPEC),
    "GGRSPlugin.build": lambda: (
        GGRSPlugin(tbox.INPUT_SPEC)
        .with_input_system(lambda handle, app: np.uint8(0))
        .register_rollback_component("translation", shape=(3,))
        .build()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


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
