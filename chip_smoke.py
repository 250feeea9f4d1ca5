#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the rollback engine on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device and build: the card's name and power limit, then both CUDA
   kernels built from ``bevy_ggrs_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel).
2. Checksum kernel against its plain version on the card: random worlds
   (bool/u8/i32/f32 components, more than 64 words a slot, ragged
   capacities), single worlds and stacked ring rows, bitwise.
3. Force kernel against its plain version on the card: N in {1000, 1024,
   4096} and a row subset, within ``atol=2e-6``; a second launch on the
   same inputs is bitwise equal to the first.
4. box_game SyncTest on ``cuda`` through ``GGRSPlugin``: 2 players,
   ``check_distance`` 7, 300 frames, no ``MismatchedChecksum``, and its
   checksum stream bitwise equal to the same run's on the CPU.
5. boids SyncTest on ``cuda``: a 1,024-boid flock, 2 players,
   ``check_distance`` 7, 120 frames, no mismatch; the force kernel ran once
   per advanced frame and the checksum kernel at least once per save. Its
   first frames agree with the plain CPU path within ``atol=1e-5``.
6. Times with CUDA events: each kernel and its plain version at the main
   path's shapes, on the device alone (a CUDA graph of many calls,
   replayed) and per call with the host's work, beside the least time the
   card could take for the same work; the main path's pieces around the
   kernels; and the per-tick times of phases 4 and 5.

The kernel counters are set to 0 just before each SyncTest of phases 4-5
and read just after; launches made to compare a kernel with its plain
version are not counted. The last three lines are the kernel table
(JSON), the card's name and power limit, and the result (JSON).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks at a 700 W power limit (NVIDIA's data sheet): device
# memory bandwidth, float32 outside the tensor cores, and int32 at half the
# float32 rate (64 integer multiply-adds a clock per SM against 128 float).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_I32_PER_S = 33.5e12

CHECKSUM_OPS_PER_WORD = 2 * 11  # both lanes: 3 mul, 2 rotate (3 ops each), xor, add
FMIX_OPS = 2 * 8
FORCE_OPS_PER_PAIR = 30  # 26 float ops, 3 compares and one rsqrt per pair
FORCE_ATOL = 2e-6
BOIDS_ATOL = 1e-5
DT = 1.001 / 60.0  # one simulation step per update for well over 300 updates


def check(ok: bool, what: str) -> None:
    """Fail the run, with a non-zero exit, unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls on the current stream, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 100, replays: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph and replayed ``replays`` times, so the host's Python
    and launch work is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


# ---------------------------------------------------------------------------
# Phase 2: the checksum kernel
# ---------------------------------------------------------------------------

COMPONENTS = {  # name -> (shape, numpy dtype, torch dtype)
    "flag": ((), np.bool_, torch.bool),
    "bytes": ((3,), np.uint8, torch.uint8),
    "hp": ((), np.int32, torch.int32),
    "pos": ((2,), np.float32, torch.float32),
    "grid": ((70,), np.float32, torch.float32),
}


def random_registry(ts):
    reg = ts.TypeRegistry()
    for name, (shape, _, tdt) in COMPONENTS.items():
        reg.register_component(name, shape, tdt)
    reg.register_resource("frame_count", np.uint32(0))
    reg.register_resource("multi", {"a": np.zeros(3, np.float32),
                                    "b": (np.int32(0), np.zeros((2, 2), bool))})
    return reg


def random_host(seed: int, cap: int) -> dict:
    rng = np.random.RandomState(seed)
    alive = rng.rand(cap) < 0.7
    comps = {}
    for name, (shape, dt, _) in COMPONENTS.items():
        if dt == np.bool_:
            comps[name] = rng.rand(cap, *shape) < 0.5
        elif dt == np.float32:
            comps[name] = rng.randn(cap, *shape).astype(np.float32)
        else:
            info = np.iinfo(dt)
            comps[name] = rng.randint(info.min, info.max, size=(cap,) + shape,
                                      dtype=np.int64).astype(dt)
    present = {n: alive & (rng.rand(cap) < 0.8) for n in comps}
    present["hp"][:] = False
    return {
        "alive": alive,
        "rollback_id": np.where(alive, rng.randint(0, 1 << 20, cap), -1).astype(np.int32),
        "components": comps,
        "present": present,
        "resources": {
            "frame_count": np.array(rng.randint(0, 2**32, dtype=np.int64), np.uint32),
            "multi": {"a": rng.randn(3).astype(np.float32),
                      "b": (np.array(rng.randint(-100, 100), np.int32),
                            rng.rand(2, 2) < 0.5)},
        },
    }


def check_checksum_kernel(ts, tck) -> None:
    reg = random_registry(ts)
    depth = 9
    for cap in (37, 600, 1000, 1024):
        hosts = [random_host(seed, cap) for seed in range(depth)]
        cpu = [ts.from_host(reg, h, device="cpu") for h in hosts]
        gpu = [ts.from_host(reg, h, device="cuda") for h in hosts]
        W = tck._word_matrix(gpu[0]).shape[1]
        for c, g in zip(cpu, gpu):  # B = 1
            want = ts.checksum(c)
            got = tck.checksum(g).cpu()
            check(torch.equal(got, want), f"checksum cap={cap}: {got} != {want}")
        stacked = ts.tree_map(lambda *xs: torch.stack(xs), *gpu)  # B = depth
        words, alive = tck._word_matrix(stacked), stacked.alive.view(torch.uint8)
        got = tck.entity_hash_sum(words, alive).cpu()
        want = tck._entity_hash_sum_plain(words.cpu(), alive.cpu())
        check(torch.equal(got, want), f"checksum cap={cap}: ring rows")
        check(torch.equal(tck.checksum(stacked).cpu(),
                          torch.stack([ts.checksum(c) for c in cpu])),
              f"checksum cap={cap}: stacked worlds")
        print(f"checksum cap={cap} W={W} B=1 and B={depth}: bitwise equal")


# ---------------------------------------------------------------------------
# Phase 3: the force kernel
# ---------------------------------------------------------------------------


def flock_inputs(n: int, seed: int = 0):
    """A flock as dense as the spawn spiral's (about 14 boids a unit of
    area, so some sit inside the separation radius); every 7th boid
    inactive."""
    rng = np.random.RandomState(seed)
    half = 0.13 * np.sqrt(n)
    pos = rng.uniform(-half, half, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(np.float32)
    active = np.ones(n, np.float32)
    active[::7] = 0.0
    return [torch.from_numpy(a).cuda() for a in (pos, vel, active)]


def check_force_kernel(tpw, params) -> float:
    worst = 0.0
    cases = [(n, slice(0, n)) for n in (1000, 1024, 4096)] + [(1024, slice(256, 512))]
    for n, rows in cases:
        pos, vel, act = flock_inputs(n, seed=n)
        args = (pos[rows].contiguous(), vel[rows].contiguous(), pos, vel,
                act[rows].contiguous(), act)
        a = tpw.pairwise_force_rows(*args, **params)
        b = tpw.pairwise_force_rows_plain(*args, **params)
        c = tpw.pairwise_force_rows(*args, **params)
        torch.cuda.synchronize()
        err = (a - b).abs().max().item()
        check(err <= FORCE_ATOL, f"forces N={n} rows={rows}: error {err}")
        check(torch.equal(a, c), f"forces N={n} rows={rows}: launch to launch")
        check(a.abs().max().item() > 1e-3, f"forces N={n}: all near zero")
        worst = max(worst, err)
        print(f"forces N={n} rows={rows.start}:{rows.stop} max_abs_err={err:.3e} "
              f"(atol {FORCE_ATOL}) repeat bitwise")
    return worst


# ---------------------------------------------------------------------------
# Phases 4-5: SyncTest sessions through GGRSPlugin
# ---------------------------------------------------------------------------


def record(session):
    """Wrap the session so every reported checksum and every request is
    logged."""
    log = {"checksums": [], "saves": 0, "advances": 0}
    report, advance = session.report_checksum, session.advance_frame

    def report_checksum(frame, cs):
        log["checksums"].append((frame, cs))
        report(frame, cs)

    def advance_frame():
        requests = advance()
        for r in requests:
            kind = type(r).__name__
            log["saves"] += kind == "SaveGameState"
            log["advances"] += kind == "AdvanceFrame"
        return requests

    session.report_checksum, session.advance_frame = report_checksum, advance_frame
    return log


def drive(app, session, session_type, frames: int):
    """Run ``frames`` simulation steps, one per update; returns the request
    log and the per-tick milliseconds (host clock, ending in a device
    synchronise)."""
    log = record(session)
    app.insert_session(session, session_type)
    now = 0.0
    app.update(now)  # arms the clock
    ticks = []
    for _ in range(frames):
        now += DT
        t0 = time.perf_counter()
        app.update(now)
        if app.stage.runner.device.type == "cuda":
            torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
    check(app.frame == frames, f"ran {app.frame} frames, not {frames}")
    return log, ticks


def box_app(device):
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import box_game

    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN,
            box_game.INPUT_LEFT, box_game.INPUT_UP | box_game.INPUT_RIGHT, 0]

    def inputs(handle, app):
        return np.uint8(keys[(app.session.current_frame // 20 + 3 * handle) % len(keys)])

    def setup(world, app):
        box_game.spawn_players(world, 2, next_id=app.rollback_id_provider.next_id)

    return (
        GGRSPlugin(box_game.INPUT_SPEC)
        .with_input_system(inputs)
        .register_rollback_component("translation", shape=(3,), dtype=torch.float32)
        .register_rollback_component("velocity", shape=(3,), dtype=torch.float32)
        .register_rollback_component("player_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(box_game.make_schedule())
        .with_num_players(2)
        .with_max_prediction_window(8)
        .with_world_capacity(16)
        .with_setup_system(setup)
        .with_device(device)
        .build()
    )


def boids_app(n: int, device):
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import boids

    def steer(handle, app):
        return np.uint8((app.session.current_frame // 5 + 7 * handle) % 16)

    return (
        GGRSPlugin(boids.INPUT_SPEC)
        .with_input_system(steer)
        .register_rollback_component("position", shape=(2,))
        .register_rollback_component("velocity", shape=(2,))
        .register_rollback_component("leader_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(boids.make_schedule())
        .with_num_players(2)
        .with_max_prediction_window(8)
        .with_world_capacity(n)
        .with_setup_system(lambda world, app: boids.spawn_flock(world, n, 2))
        .with_device(device)
        .build()
    )


def timings(label: str, kernel, plain, nbytes: int, ops: int, peak_ops: float) -> dict:
    """The kernel's and its plain version's device time per call (CUDA
    graph replay) and the least time the card could take: the larger of
    ``nbytes`` over the memory rate and ``ops`` over ``peak_ops``. The
    per-call time with the host's work included is printed beside them."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    out = {
        "ms": graph_ms(kernel),
        "plain_ms": graph_ms(plain, iters=10, replays=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(f"{label}: kernel {out['ms']:.6f} ms, plain {out['plain_ms']:.6f} ms "
          f"(device, graph replay); per call with host work: kernel "
          f"{cuda_ms(kernel):.6f} ms, plain {cuda_ms(plain, iters=50):.6f} ms; "
          f"bound {out['bound_ms']:.6f} ms ({out['bound_by']}: {nbytes} bytes, {ops} ops)")
    return out


def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def tick_stats(ticks):
    t = np.asarray(ticks)
    return {"mean_ms": float(t.mean()), "p99_ms": float(np.percentile(t, 99)),
            "ticks": len(ticks)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "bevy_ggrs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import boids, box_game
    from bevy_ggrs_tpu_torch.ops import _build
    from bevy_ggrs_tpu_torch.ops import checksum as tck
    from bevy_ggrs_tpu_torch.ops import pairwise as tpw
    from bevy_ggrs_tpu_torch.rollout import advance_n
    from bevy_ggrs_tpu_torch.schedule import PlayerInputs
    from bevy_ggrs_tpu_torch.session import SyncTestSession

    kernels = (tck.entity_hash_sum, tpw.pairwise_force_rows)
    params = boids._kernel_params()

    phase("1 device and build")
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build seconds: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall {time.perf_counter() - t0:.2f}")
    for name in _build.KERNELS:
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"{name}: " + " | ".join(
            line.replace("ptxas info    :", "").strip() for line in log.splitlines()
            if "Used" in line or "spill" in line))

    phase("2 checksum kernel against its plain version")
    check_checksum_kernel(ts, tck)

    phase("3 force kernel against its plain version")
    force_err = check_force_kernel(tpw, params)

    phase("4 box_game SyncTest on cuda and on the cpu")
    frames = 300
    logs = {}
    box_app_gpu = box_app("cuda")
    reset_counts(kernels)
    logs["cuda"], box_ticks = drive(
        box_app_gpu, SyncTestSession(2, box_game.INPUT_SPEC, check_distance=7),
        SessionType.SYNC_TEST, frames)
    box_launches = {fn.__name__: fn.launches for fn in kernels}
    box_app_cpu = box_app("cpu")
    logs["cpu"], _ = drive(
        box_app_cpu, SyncTestSession(2, box_game.INPUT_SPEC, check_distance=7),
        SessionType.SYNC_TEST, frames)
    check(logs["cuda"]["checksums"] == logs["cpu"]["checksums"],
          "box_game checksum stream on cuda differs from the cpu's")
    world = box_app_gpu.world()
    check(np.isfinite(world["components"]["translation"]).all(), "box_game: not finite")
    check(int(world["resources"]["frame_count"]) == frames, "box_game: frame_count")
    check(box_app_gpu.stage.runner.rollbacks_total == frames - 7, "box_game: rollbacks")
    check(box_launches["entity_hash_sum"] >= logs["cuda"]["saves"],
          f"box_game: checksum launches {box_launches}")
    print(f"box_game: {frames} frames, {logs['cuda']['saves']} saves, "
          f"{len(logs['cuda']['checksums'])} checksums bitwise equal to the cpu's, "
          f"launches {box_launches}")

    phase("5 boids SyncTest on cuda (N=1024)")
    n, frames = 1024, 120
    flock_gpu = boids.make_world(n, 2, device="cuda").commit()
    flock_cpu = boids.make_world(n, 2, device="cpu").commit()
    bits = torch.tensor([[(f + h) % 16 for h in range(2)] for f in range(4)],
                        dtype=torch.uint8)
    a = advance_n(boids.make_schedule(), flock_gpu, bits.cuda())
    b = advance_n(boids.make_schedule(), flock_cpu, bits)
    for name in ("position", "velocity"):
        err = (a.components[name].cpu() - b.components[name]).abs().max().item()
        check(err <= BOIDS_ATOL, f"boids {name}: cuda against cpu {err}")
    print(f"boids: 4 frames on cuda within {BOIDS_ATOL} of the plain cpu path")
    flock = boids_app(n, "cuda")
    reset_counts(kernels)
    boids_log, boids_ticks = drive(
        flock, SyncTestSession(2, boids.INPUT_SPEC, check_distance=7),
        SessionType.SYNC_TEST, frames)
    boids_launches = {fn.__name__: fn.launches for fn in kernels}
    pos = flock.world()["components"]["position"]
    check(pos.shape == (n, 2) and np.isfinite(pos).all(), "boids: positions")
    check(boids_launches["pairwise_force_rows"] == boids_log["advances"],
          f"boids: force launches {boids_launches}, {boids_log['advances']} advances")
    check(boids_launches["entity_hash_sum"] >= boids_log["saves"],
          f"boids: checksum launches {boids_launches}")
    print(f"boids: {frames} frames, {boids_log['advances']} advances, "
          f"{boids_log['saves']} saves, launches {boids_launches}")

    phase("6 times")
    state = flock.stage.runner.state
    # Checksum at the main path's shape: one boids world, cap 1,024 x W 9.
    words = tck._word_matrix(state)
    alive = state.alive.reshape(1, -1).view(torch.uint8)
    B, W, cap = words.shape
    ck = {
        "name": "entity_hash_sum", "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/checksum.cu",
        "replaces": "bevy_ggrs_tpu/ops/checksum.py:95",
        "launches": box_launches["entity_hash_sum"] + boids_launches["entity_hash_sum"],
        "max_abs_err": 0.0,
        **timings(
            f"checksum B={B} W={W} cap={cap}",
            lambda: tck.entity_hash_sum(words, alive),
            lambda: tck._entity_hash_sum_plain(words, alive),
            nbytes=words.numel() * 4 + alive.numel() + B * 2 * 4,
            ops=B * cap * (W * CHECKSUM_OPS_PER_WORD + FMIX_OPS),
            peak_ops=PEAK_I32_PER_S),
    }
    forces = {}
    for n_boids in (1024, 4096):
        pos, vel, act = flock_inputs(n_boids, seed=n_boids)
        args = (pos, vel, pos, vel, act, act)
        forces[n_boids] = {
            "name": "pairwise_force_rows", "route": "cuda",
            "source": "bevy_ggrs_tpu_torch/csrc/pairwise.cu",
            "replaces": "bevy_ggrs_tpu/ops/pairwise.py:176",
            "launches": boids_launches["pairwise_force_rows"],
            "max_abs_err": force_err,
            **timings(
                f"forces R=N={n_boids}",
                lambda: tpw.pairwise_force_rows(*args, **params),
                lambda: tpw.pairwise_force_rows_plain(*args, **params),
                nbytes=n_boids * 5 * 4 * 2 + n_boids * 2 * 4,
                ops=n_boids * n_boids * FORCE_OPS_PER_PAIR,
                peak_ops=PEAK_F32_PER_S),
        }
    print("library_ms: no single PyTorch call computes either function "
          "(a murmur3 hash chain; the three boids rules), so there is none")
    # The main path's pieces around the kernels, for the per-tick breakdown.
    ring = flock.stage.runner.ring
    step_bits = torch.zeros((2,), dtype=torch.uint8, device="cuda")
    step_status = torch.zeros((2,), dtype=torch.int32, device="cuda")
    inputs = PlayerInputs(step_bits, step_status)
    schedule = boids.make_schedule()
    pieces = {
        "boids_checksum_ms": cuda_ms(lambda: tck.checksum(state), iters=50),
        "boids_ring_save_ms": cuda_ms(lambda: ts.ring_save(ring, state, 0), iters=50),
        "boids_ring_load_ms": cuda_ms(lambda: ts.ring_load(ring, 0), iters=50),
        "boids_step_ms": cuda_ms(lambda: schedule(state, inputs), iters=50),
    }
    print("pieces " + json.dumps(pieces))
    ticks = {"box_game_synctest": tick_stats(box_ticks),
             "boids1024_synctest": tick_stats(boids_ticks)}
    print("ticks " + json.dumps(ticks))
    print(json.dumps({"kernels": [ck, forces[1024]]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
