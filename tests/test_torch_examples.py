"""PyTorch port, the example CLIs (``examples_torch/``) against their JAX
twins (``examples/``), each run as a subprocess on the CPU (``--device
cpu`` / ``--platform cpu``) at 60 frames or fewer.

- box_game SyncTest: the printed worlds are equal; the interactive demo's
  non-TTY scripted fallback prints the same world.
- box_game P2P (two peers over UDP on 127.0.0.1, input delay 12 at 5 fps)
  and a spectator of peer 0, for each package: the spectator's world and
  each peer's whose frames were all confirmed equal the world that the
  scripted inputs give at the printed frame, no desync event fires, and
  the port peers' settled checksums agree. The scripts' keys stay below
  box_game's speed clamp.
- model_zoo: projectiles' final checksum and rollback counts equal JAX's;
  boids (the f32 kernel's plain version against JAX's Pallas kernel in
  interpret mode) and neural_bots have equal rollback counts and positions
  within the force kernels' tolerance; ``--kernel xla`` (JAX's XLA forces
  in plain PyTorch) runs, its positions within the same tolerance of
  JAX's.
- No example falls back to the CPU: on a machine without CUDA,
  ``--device cuda`` exits non-zero.

About 90 s on one core (the subprocesses of a test run together; the P2P
sessions play 12 s on the wall clock).
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from chip_smoke import example_world, free_udp_ports

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "examples_torch"
JAX = ROOT / "examples"
FRAMES = 60
# P2P on the wall clock: 60 render frames at 5 fps are 12 s, so even the
# processes' start-up skew under a loaded machine (6 s seen: a JAX peer
# that ran only 15 of 48 frames at 8 fps) leaves the peers 30 frames
# together; an input delay of 12 frames means a peer rarely predicts a
# remote input before the other peer has stopped.
P2P_FRAMES, P2P_FPS, P2P_DELAY = 60, 5, 12
# The f32 forces' plain version and JAX's Pallas kernel (interpret mode)
# sum in other orders, ~1e-7 a step. A flock amplifies that about 2x every
# two frames (5.96e-8 after 1 frame, 7.2e-7 after 5, 1.05e-5 after 10, 6.4e-4
# after 20, measured here with 64 boids), so boids run 8 frames and hold the
# boids SyncTest's tolerance against the plain version (1e-5).
POSITION_ATOL = 1e-5
ZOO_FRAMES = {"projectiles": 24, "boids": 8, "neural_bots": 24}


def start(script: pathlib.Path, *args, stdin=None) -> subprocess.Popen:
    """Start an example; its output goes to files, never to a pipe that a
    chatty process (XLA's loader warnings) could fill while the test waits
    on another process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return spawn([sys.executable, str(script), *map(str, args)], env, stdin)


def spawn(cmd, env, stdin=None) -> subprocess.Popen:
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err, stdin=stdin,
                            text=True)
    proc.files = (out, err)
    return proc


def finish(proc: subprocess.Popen, ok: bool = True, timeout: float = 300) -> str:
    proc.wait(timeout=timeout)
    texts = []
    for f in proc.files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    out, err = texts
    if ok:
        assert proc.returncode == 0, f"rc {proc.returncode}: {err[-3000:]}"
    return out + ("\n" + err if not ok else "")


def sim_frames(out: str, tag: str) -> int:
    line = next(line for line in out.splitlines() if tag in line)
    return int(re.search(r"frame_count=(\d+)", line).group(1))


def expected_world(frames: int, delay: int, players: int = 2) -> list:
    """The printed world that box_game's scripted inputs give after
    ``frames`` frames when a local input reaches the simulation ``delay``
    frames after it was read (blank inputs before), on the port's CPU
    step."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.schedule import PlayerInputs

    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    schedule = box_game.make_schedule()
    state = box_game.make_world(players, device="cpu").commit()
    for f in range(frames):
        bits = [keys[((f - delay) // 3 + h) % 4] if f >= delay else 0 for h in range(players)]
        state = schedule(state, PlayerInputs(bits=torch.tensor(bits, dtype=torch.uint8),
                                             status=torch.zeros(players, dtype=torch.int32)))
    from bevy_ggrs_tpu_torch.state import to_host

    host = to_host(state)
    t = host["components"]["translation"]
    block = [f"frame_count={int(host['resources']['frame_count'])}"]
    for i in range(len(host["alive"])):
        if host["alive"][i]:
            block.append(f"  cube {int(host['components']['player_handle'][i])}: "
                         f"({t[i][0]:+.3f}, {t[i][1]:+.3f}, {t[i][2]:+.3f})")
    return block


def test_synctest_and_interactive_print_jax_worlds(capsys):
    """The SyncTest against its JAX twin; the interactive demo's non-TTY
    run (in this process: a SyncTest at distance 2 on the same script)
    prints the same world."""
    procs = {
        "port_sync": start(PORT / "box_game_synctest.py", "--device", "cpu",
                           "--frames", FRAMES, "--check-distance", 7),
        "jax_sync": start(JAX / "box_game_synctest.py", "--platform", "cpu",
                          "--frames", FRAMES, "--check-distance", 7),
    }
    assert example_main("box_game_interactive.py")(
        ["--device", "cpu", "--frames", str(FRAMES)]) == 0
    tty = example_world(capsys.readouterr().out, "interactive session ended")
    out = {k: finish(p) for k, p in procs.items()}
    sync = example_world(out["port_sync"], "synctest ok")
    assert sync == example_world(out["jax_sync"], "synctest ok")
    assert sync[0] == f"frame_count={FRAMES - 1}" and len(sync) == 3
    assert tty == sync


def p2p_session(pkg: str, base: int) -> dict:
    """Two P2P peers and a spectator of peer 0 of one package over UDP."""
    root, dev = (PORT, ("--device", "cpu")) if pkg == "port" else (JAX, ("--platform", "cpu"))
    common = (*dev, "--frames", P2P_FRAMES, "--fps", P2P_FPS)
    a, b, s = base, base + 1, base + 2
    procs = {
        "peer0": start(root / "box_game_p2p.py", "--local-port", a, "--players", "localhost",
                       f"127.0.0.1:{b}", "--spectators", f"127.0.0.1:{s}",
                       "--input-delay", P2P_DELAY, *common),
        "peer1": start(root / "box_game_p2p.py", "--local-port", b, "--players",
                       f"127.0.0.1:{a}", "localhost", "--input-delay", P2P_DELAY, *common),
        "spectator": start(root / "box_game_spectator.py", "--local-port", s, "--host",
                           f"127.0.0.1:{a}", *common),
    }
    return procs


def test_p2p_and_spectator_worlds_equal_for_both_packages():
    # Both packages at once, each on three ports of its own: no datagram
    # of one session can reach the other.
    base = free_udp_ports(6)
    runs = {pkg: p2p_session(pkg, base + offset) for offset, pkg in ((0, "port"), (3, "jax"))}
    out = {pkg: {k: finish(p) for k, p in procs.items()} for pkg, procs in runs.items()}
    for pkg, logs in out.items():
        frames = {who: sim_frames(log, "spectator done" if who == "spectator" else "p2p done")
                  for who, log in logs.items()}
        for who, log in logs.items():
            tag = "spectator done" if who == "spectator" else "p2p done"
            n = frames[who]
            assert n > P2P_DELAY + 6, f"{pkg} {who}: only {n} frames: {log[-3000:]}"
            assert "desync" not in log, f"{pkg} {who}: a desync event"
            other = frames["peer1" if who == "peer0" else "peer0"]
            # A peer's world is confirmed when the other peer's inputs for
            # every frame it ran were sent: the other peer, at its last
            # frame m, had sent its inputs up to frame m - 1 + delay. A peer
            # that ran past that after the other one stopped predicted.
            if who == "spectator" or n <= other + P2P_DELAY:
                assert example_world(log, tag) == expected_world(n, P2P_DELAY), f"{pkg} {who}"
    settled = [json.loads(next(line for line in out["port"][p].splitlines()
                                if line.startswith("[settled] "))[len("[settled] "):])
               for p in ("peer0", "peer1")]
    common = set(settled[0]) & set(settled[1])
    assert common and all(settled[0][f] == settled[1][f] for f in common)


def zoo_args(model: str, *args) -> tuple:
    return ("--model", model, "--frames", ZOO_FRAMES[model], "--check-distance", 4, *args)


def jax_zoo(cases: dict) -> subprocess.Popen:
    """The JAX twin of model_zoo_synctest, one run a case in one process
    (one JAX import), under a wrapper that also prints each run's
    positions."""
    runs = [["--platform", "cpu", *map(str, zoo_args(m, *args))] for m, args in cases.items()]
    code = (
        "import json, runpy, sys, numpy as np\n"
        "import bevy_ggrs_tpu.runner as r\n"
        "made = []\n"
        "init = r.RollbackRunner.__init__\n"
        "def spy(self, *a, **k):\n"
        "    init(self, *a, **k)\n"
        "    made.append(self)\n"
        "r.RollbackRunner.__init__ = spy\n"
        "script = sys.argv[1]\n"
        "sys.path.insert(0, script.rsplit('/', 1)[0])\n"
        "main = runpy.run_path(script, run_name='zoo')['main']\n"
        "for argv in json.loads(sys.argv[2]):\n"
        "    made.clear()\n"
        "    sys.argv = [script] + argv\n"
        "    assert main() == 0\n"
        "    w = made[0].world()['components']\n"
        "    if 'position' in w:\n"
        "        pos = np.asarray(w['position'], np.float64).ravel()\n"
        "        print(f'[{argv[argv.index(\"--model\") + 1]} positions] '"
        " + ' '.join(f'{v:.9e}' for v in pos))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return spawn([sys.executable, "-c", code, str(JAX / "model_zoo_synctest.py"),
                  json.dumps(runs)], env)


def zoo_line(out: str, model: str) -> dict:
    line = next(line for line in out.splitlines() if line.startswith(f"[{model} synctest ok]"))
    return dict(re.findall(r"(\w+)=(\S+)", line))


def zoo_positions(out: str, model: str) -> np.ndarray:
    line = next(line for line in out.splitlines() if line.startswith(f"[{model} positions]"))
    return np.asarray([float(v) for v in line.split("] ", 1)[1].split()])


def test_model_zoo_matches_jax(capsys):
    cases = {
        "projectiles": ("--entities", 64),
        "boids": ("--entities", 64, "--kernel", "pallas"),
        "neural_bots": ("--entities", 16),
    }
    procs = {m: start(PORT / "model_zoo_synctest.py", "--device", "cpu", *zoo_args(m, *args))
             for m, args in cases.items()}
    procs["jax"] = jax_zoo(cases)
    # --kernel xla, in this process meanwhile: JAX's XLA forces in plain
    # PyTorch run the same SyncTest.
    assert example_main("model_zoo_synctest.py")(
        ["--device", "cpu", *map(str, zoo_args("boids", "--entities", 64, "--kernel", "xla"))]
    ) == 0
    xla_out = capsys.readouterr().out
    out = {k: finish(p) for k, p in procs.items()}
    xla, ref = zoo_line(xla_out, "boids"), zoo_line(out["jax"], "boids")
    assert all(xla[k] == ref[k] for k in ("frames", "frame_count", "rollbacks", "resimulated"))
    np.testing.assert_allclose(zoo_positions(xla_out, "boids"),
                               zoo_positions(out["jax"], "boids"), rtol=0, atol=POSITION_ATOL)
    for model in cases:
        port, ref = zoo_line(out[model], model), zoo_line(out["jax"], model)
        for key in ("frames", "frame_count", "rollbacks", "resimulated"):
            assert port[key] == ref[key], (model, key)
        if model == "projectiles":
            assert port["final_checksum"] == ref["final_checksum"]
        else:
            np.testing.assert_allclose(zoo_positions(out[model], model),
                                       zoo_positions(out["jax"], model),
                                       rtol=0, atol=POSITION_ATOL)


def example_main(script: str):
    """An example's ``main``, imported in this process."""
    import importlib.util

    sys.path.insert(0, str(PORT))
    try:
        spec = importlib.util.spec_from_file_location(f"example_{script[:-3]}", PORT / script)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(PORT))
    return module.main


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
@pytest.mark.parametrize("script,args", [
    ("box_game_synctest.py", ()),
    ("box_game_interactive.py", ()),
    ("box_game_p2p.py", ("--local-port", "1", "--players", "localhost", "127.0.0.1:2")),
    ("box_game_spectator.py", ("--local-port", "1", "--host", "127.0.0.1:2")),
    ("model_zoo_synctest.py", ()),
])
def test_cuda_without_a_gpu_is_an_error(script, args):
    with pytest.raises(SystemExit) as exc:
        example_main(script)(["--device", "cuda", "--frames", "5", *args])
    assert "no CUDA device is available" in str(exc.value.code)
