"""PyTorch port: the last of the JAX package's public surface.

Each name here is held against the JAX package's on the same inputs, made
from a numpy seed: ``InputSpec.zeros`` and ``make_inputs`` (values and
dtypes), ``Schedule.add_system`` (the same schedule as the constructor's),
``WorldState.num_alive``, box_game's NumPy oracle ``step_np`` (byte-equal
to JAX's over 500 frames, and the port's CPU step bitwise it), the
checksum hook (``set_checksum_impl`` / ``active_checksum``: with the
plain checksum installed every save and integrity reader gives the bytes
and digests of the port's own route, which are JAX's), and the mesh
constructors, which name their device or raise. Last, the ``ast`` walk:
every public name the JAX package defines is in the port's counterpart
module or in the README's map of names without one. About 10 s on one
core.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import schedule as jsch
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.models import projectiles as jproj
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import schedule as tsch
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.models import projectiles as tproj
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.parallel import sharding
from bevy_ggrs_tpu_torch.rollout import rollout_burst_slots

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape,dtype,jdtype", [
    ((), torch.uint8, np.uint8), ((3,), torch.int16, np.int16), ((2, 2), torch.int32, np.int32),
], ids=["u8", "i16x3", "i32x2x2"])
def test_input_spec_zeros_and_make_inputs_equal_jax(shape, dtype, jdtype):
    tspec, jspec = tsch.InputSpec(shape, dtype), jsch.InputSpec(shape, jdtype)
    got, want = tspec.zeros(5, device="cpu").numpy(), np.asarray(jspec.zeros(5))
    assert got.dtype == want.dtype and got.shape == want.shape and not got.any()
    rng = np.random.RandomState(21)
    bits = rng.randint(0, 100, (4,) + shape).astype(jdtype)
    status = rng.randint(0, 3, 4).astype(np.int64)
    for st in (None, status):
        t = tsch.make_inputs(bits, st, device="cpu")
        j = jsch.make_inputs(bits, st)
        for a, b in ((t.bits, j.bits), (t.status, j.status)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert t.num_players == j.num_players == 4
    # A tensor's own device is the default one.
    assert tsch.make_inputs(torch.from_numpy(bits)).bits.device.type == "cpu"


def test_input_helpers_without_a_device_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsch.InputSpec().zeros(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsch.make_inputs(np.zeros(2, np.uint8))


def test_add_system_equals_the_constructor():
    def schedules(pkg):
        mod = tbox if pkg == "torch" else jbox
        built = (tsch if pkg == "torch" else jsch).Schedule()
        assert built.add_system(mod.move_cube_system) is built
        built.add_system(mod.increase_frame_system)
        return built, mod.make_schedule()

    (t_added, t_made), (j_added, j_made) = schedules("torch"), schedules("jax")
    assert t_added.systems == t_made.systems and j_added.systems == j_made.systems
    rng = np.random.RandomState(3)
    tw = [tbox.make_world(3, device="cpu").commit()] * 2
    jw = jbox.make_world(3).commit()
    for _ in range(20):
        bits = rng.randint(0, 16, 3).astype(np.uint8)
        inputs = tsch.make_inputs(bits, device="cpu")
        tw = [t_added(tw[0], inputs), t_made(tw[1], inputs)]
        jw = j_added(jw, jsch.make_inputs(bits))
    a, b, c = ts.to_host(tw[0]), ts.to_host(tw[1]), js.to_host(jw)
    for name in ("translation", "velocity"):
        assert a["components"][name].tobytes() == b["components"][name].tobytes() \
            == c["components"][name].tobytes()
    assert int(a["resources"]["frame_count"]) == int(c["resources"]["frame_count"]) == 20


def test_num_alive_equals_jax():
    rng = np.random.RandomState(8)
    tw, jw = tbox.make_world(2, capacity=32, device="cpu"), jbox.make_world(2, capacity=32)
    slots = []
    for k in range(20):
        comps = {"translation": rng.rand(3).astype(np.float32).tolist()}
        slots.append((tw.spawn(comps, rollback_id=100 + k), jw.spawn(comps, rollback_id=100 + k)))
    for i in rng.choice(len(slots), 7, replace=False):
        tw.despawn(slots[i][0])
        jw.despawn(slots[i][1])
    got, want = tw.commit().num_alive(), jw.commit().num_alive()
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    assert int(got) == int(want) == 2 + 20 - 7


def test_step_np_is_jax_step_np_and_the_cpu_step_bitwise():
    """500 seeded frames, a held stretch driving the cubes into the speed
    clamp and the plane's edges: the port's ``step_np`` byte-equal to
    JAX's, and the port's CPU step bitwise the port's ``step_np``."""
    players = 4
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, 16, size=(500, players)).astype(np.uint8)
    inputs[100:250] = inputs[100]
    host = ts.to_host(tbox.make_world(players, device="cpu").commit())
    jhost = js.to_host(jbox.make_world(players).commit())
    world = tbox.make_world(players, device="cpu").commit()
    step = tbox.make_schedule()
    fastest = 0.0
    for frame, bits in enumerate(inputs):
        host = tbox.step_np(host, bits)
        fastest = max(fastest, np.linalg.norm(host["components"]["velocity"], axis=1).max())
        jhost = jbox.step_np(jhost, bits)
        world = step(world, tsch.make_inputs(bits, device="cpu"))
        if frame % 50 == 49 or frame == len(inputs) - 1:
            got = ts.to_host(world)
            for name in ("translation", "velocity"):
                assert host["components"][name].dtype == np.float32
                assert host["components"][name].tobytes() == jhost["components"][name].tobytes()
                assert got["components"][name].tobytes() == host["components"][name].tobytes()
            assert host["resources"]["frame_count"] == jhost["resources"]["frame_count"] \
                == got["resources"]["frame_count"] == frame + 1
            assert np.asarray(host["resources"]["frame_count"]).dtype == np.uint32
    assert fastest > 0.049  # the held keys reached the speed clamp


# ---------------------------------------------------------------------------
# The checksum hook
# ---------------------------------------------------------------------------


class Counting:
    """``checksum_plain`` behind a call count."""

    def __init__(self):
        self.calls = 0

    def __call__(self, state):
        self.calls += 1
        return tck.checksum_plain(state)


@pytest.fixture
def no_hook():
    ts.set_checksum_impl(None)
    yield
    ts.set_checksum_impl(None)


def hook_worlds():
    """Seeded box_game and projectiles worlds (the latter with spawns and
    despawns, so its resources and gaps count), each with JAX's twin."""
    rng = np.random.RandomState(5)
    out = []
    for tmod, jmod, players, values in ((tbox, jbox, 3, 16), (tproj, jproj, 4, 32)):
        t = tmod.make_world(players, device="cpu").commit()
        j = jmod.make_world(players).commit()
        tstep, jstep = tmod.make_schedule(), jmod.make_schedule()
        frames = []
        for f in range(12):
            bits = rng.randint(0, values, players).astype(np.uint8)
            t = tstep(t, tsch.make_inputs(bits, device="cpu"))
            j = jstep(j, jsch.make_inputs(bits))
            frames.append((t, j))
        out.append(frames)
    return out


def host_bytes(tree, keep) -> list:
    """The bytes of the ``keep`` rows of every array of a ``to_host``
    dict, in key order."""
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in host_bytes(tree[k], keep)]
    return [np.ascontiguousarray(np.asarray(tree)[keep]).tobytes()]


def ring_bytes(ring):
    """A ring's saved rows (frames >= 0: a stack's unsaved rows are
    memory never written), frames and digests."""
    keep = ring.frames.numpy() >= 0
    return host_bytes(ts.to_host(ring.states), keep) + [ring.frames.numpy().tobytes(),
                                                        ring.checksums.numpy().tobytes()]


def save_run(frames, depth=5):
    """Every world saved into a fresh ring: the ring's bytes, the digests
    ``ring_save`` returned, and the integrity readers' answers."""
    ring = ts.ring_init(frames[0][0], depth)
    digests = []
    out = torch.zeros(2, dtype=torch.int64)
    for f, (world, _) in enumerate(frames):
        _, cs = ts.ring_save(ring, world, f, out=out)
        assert torch.equal(cs, out)
        digests.append(cs.tolist())
    clean = integrity.attest_ring(ring).tolist()
    guards = [integrity.verify_row(ring, f) for f in range(len(frames) - depth, len(frames))]
    live = ts.active_checksum(frames[-1][0]).tolist()
    return ring, digests, clean, guards, live, integrity.ring_digests(ring).tolist()


def test_checksum_hook_round_trip_equals_the_route_and_jax(no_hook):
    for frames in hook_worlds():
        plain = save_run(frames)
        spy = Counting()
        ts.set_checksum_impl(spy)
        assert ts.checksum_impl() is spy
        hooked = save_run(frames)
        # 12 saves, 1 ring digest pass, 5 guards, 1 live digest, 1 ring digest pass.
        assert spy.calls == 12 + 1 + 5 + 1 + 1
        ts.set_checksum_impl(None)
        again = save_run(frames)
        for run in (hooked, again):
            assert ring_bytes(run[0]) == ring_bytes(plain[0])
            assert run[1:] == plain[1:]
        assert plain[2] == [False] * 5 and plain[3] == [True] * 5
        # The route's digests are JAX's.
        jring = js.ring_init(frames[0][1], 5)
        for f, (_, jworld) in enumerate(frames):
            jring, jcs = js.ring_save(jring, jworld, f)
            assert np.asarray(jcs).astype(np.int64).tolist() == plain[1][f]
        assert np.asarray(js.active_checksum(frames[-1][1])).astype(np.int64).tolist() \
            == plain[4]


def test_checksum_hook_reaches_a_corrupt_row(no_hook):
    frames = hook_worlds()[0]
    ring = save_run(frames)[0]
    ring, _ = integrity.flip_ring_bit(ring, 2, np.random.RandomState(1))
    frame = int(ring.frames[2])
    want = (integrity.attest_ring(ring).tolist(), integrity.verify_row(ring, frame))
    ts.set_checksum_impl(Counting())
    assert (integrity.attest_ring(ring).tolist(), integrity.verify_row(ring, frame)) == want
    assert want[0][2] and not want[1]


def test_checksum_hook_in_slot_saves_and_entity_shards(no_hook):
    frames = hook_worlds()[0]
    worlds = [w for w, _ in frames[-3:]]
    S, T, P = 3, 4, 3
    states = ts.tree_map(lambda *xs: torch.stack(xs).contiguous(), *worlds)
    rng = np.random.RandomState(9)
    bits = torch.from_numpy(rng.randint(0, 16, (S, T, P)).astype(np.uint8))
    status = torch.zeros((S, T, P), dtype=torch.int32)
    save = rng.rand(S, T) < 0.7
    adv = np.ones((S, T), bool)

    def slots():
        rings = ts.branch_rings(worlds[0], S, 4)
        _, out, cs = rollout_burst_slots(tbox.make_schedule(), rings, states,
                                         np.array([3, 10, 7]), bits, status, save, adv)
        return ring_bytes(rings), ts.to_host(out)["components"]["translation"].tobytes(), \
            cs.tolist()

    mesh = sharding.branch_mesh(device_type="cpu")
    shard = sharding.EntityShard(mesh, "entity", worlds[0].capacity)

    def sharded():
        ring = ts.ring_init(worlds[0], 4)
        lanes = [shard.save(ring, w, f).tolist() for f, w in enumerate(worlds)]
        return ring_bytes(ring), lanes, shard.checksum(worlds[-1]).tolist(), \
            shard.guard(ring, 2)

    plain = (slots(), sharded())
    spy = Counting()
    ts.set_checksum_impl(spy)
    assert (slots(), sharded()) == plain
    # A save step a save column of the burst, one a shard save, checksum, guard.
    assert spy.calls == int(save.any(axis=0).sum()) + 3 + 1 + 1


# ---------------------------------------------------------------------------
# No silent CPU mesh
# ---------------------------------------------------------------------------

MESH_PROBE = r"""
import json
from bevy_ggrs_tpu_torch.parallel import multihost, sharding

out = {}
for name, fn in (
    ("branch_mesh", lambda: sharding.branch_mesh()),
    ("ensure_process_group", lambda: sharding.ensure_process_group()),
    ("global_branch_mesh", lambda: multihost.global_branch_mesh()),
    ("initialize", lambda: multihost.initialize("127.0.0.1:1", 2, 0)),
):
    try:
        fn()
        out[name] = "built"
    except RuntimeError as exc:
        out[name] = str(exc)
import torch.distributed as dist
out["initialized"] = dist.is_initialized()
mesh = sharding.branch_mesh(device_type="cpu")
out["cpu"] = [list(mesh.mesh_dim_names), dist.get_backend(), dist.get_world_size()]
print(json.dumps(out))
"""


def test_meshes_without_a_device_raise_without_a_gpu():
    """In a process that sees no GPU, a mesh, a group or a multi-process
    group asked for without a device raises, and builds nothing; with
    ``device_type="cpu"`` the mesh is a world-size-1 gloo one."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-c", MESH_PROBE], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    for name in ("branch_mesh", "ensure_process_group", "global_branch_mesh", "initialize"):
        assert out[name].startswith("no CUDA device is available"), (name, out[name])
    assert out["initialized"] is False
    assert out["cpu"] == [["branch", "entity"], "gloo", 1]


# ---------------------------------------------------------------------------
# The JAX package's public names
# ---------------------------------------------------------------------------

# A JAX module whose port counterpart has another path.
RENAMED = {"utils/xla_cache.py": "utils/build_cache.py"}
# A JAX module some of whose names the port keeps in another module.
ELSEWHERE = {"native/core.py": "session/input_queue.py"}


def defined_names(path: Path, imports: bool) -> set:
    """The public names a module defines at its top level (functions,
    classes with their public methods as ``Class.method``, assignments),
    and with ``imports`` the names it imports too."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def readme_map() -> set:
    """``module::name`` entries of the README's map of JAX names without a
    counterpart in the port."""
    text = (ROOT / "README.md").read_text()
    start = text.index("### JAX names without a counterpart in the port")
    end = text.find("\n#", start + 1)
    return set(re.findall(r"`([\w/]+\.py::[\w.]+)`", text[start:end]))


def test_every_jax_public_name_has_a_counterpart_or_a_readme_entry():
    jroot, troot = ROOT / "bevy_ggrs_tpu", ROOT / "bevy_ggrs_tpu_torch"
    listed = readme_map()
    missing, stale, known = [], [], set()
    for jpath in sorted(jroot.rglob("*.py")):
        rel = jpath.relative_to(jroot).as_posix()
        tpath = troot / RENAMED.get(rel, rel)
        have = defined_names(tpath, imports=True) if tpath.exists() else set()
        if rel in ELSEWHERE:
            have |= defined_names(troot / ELSEWHERE[rel], imports=True)
        for name in sorted(defined_names(jpath, imports=False)):
            key = f"{rel}::{name}"
            known.add(key)
            if name not in have and key not in listed:
                missing.append(key)
            elif name in have and key in listed:
                stale.append(key)
    assert not missing, f"JAX names with no port counterpart and no README entry: {missing}"
    assert not stale, f"README lists names the port has: {stale}"
    assert listed and listed <= known, f"README entries of no JAX name: {listed - known}"


def test_chip_smoke_phase_4_step_and_hook_checks_on_the_cpu(no_hook):
    """Phase 4's new checks on the CPU: the step over 500 frames bitwise
    ``step_np``, and the hook round trip (no kernel launch on the CPU)."""
    import chip_smoke
    from bevy_ggrs_tpu_torch.models import boids

    world, out = chip_smoke.check_box_step(ts, tbox, device="cpu")
    assert out["reads"] == 10 and out["fastest"] > 0.049
    hook = chip_smoke.check_checksum_hook(ts, tck, integrity, [
        ("box_game", world), ("boids-64", boids.make_world(64, 2, device="cpu").commit())])
    assert hook["box_game"]["launches"] == hook["boids-64"]["launches"] == [0, 0, 0]
    assert ts.checksum_impl() is None
