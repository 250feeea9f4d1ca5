"""The port's benchmark: BASELINE.md's configs 1-5 and the headline on the
PyTorch port, on one NVIDIA GPU.

Headline (BASELINE.md's target): resimulate 8 rollback frames x 256
speculative input branches for box_game inside one 60 Hz render frame
(16 ms). ``python3 bench_torch.py`` prints ONE JSON line on stdout,
``{"metric": ..., "value": N, "unit": "ms", "vs_baseline": N}``, where
``vs_baseline`` > 1 means faster than the 16 ms budget.

``python3 bench_torch.py --all`` measures every config below, each in its
OWN subprocess (``--config NAME``), and writes the rows to
``BENCH_TORCH_DETAIL.json``; per-config lines go to stderr. The configs:
the rollouts (1: parity 4f x 1b, 2: 8f x 64b, 3: 4 players 8f x 256b,
4: 1,024 boids 8f x 128b on the f32 and the tensor-core kernels, the
entity-scaling rows to 64k boids, 5: 8 players 12f x 1,024b,
neural_bots and projectiles), the recovery comparisons (speculative
commit against serial resimulation), live paced P2P sessions (4 models x
speculation on/off over loopback, box_game over UDP, config 5 with 8
players and a spectator), and batched serving (box_game and boids at S =
16 to 1,024 matches, a fault-injected server and a data-corruption one).

Columns of a rollout row:

- ``value``: device milliseconds of one rollout, the union of the kernel
  and copy intervals ``torch.profiler`` records over 20 rollouts, divided
  by 20 (on the CPU, ``--device cpu``, the wall ``latency_ms``);
- ``latency_ms``: wall milliseconds of one rollout that ends with
  ``torch.cuda.synchronize()`` (median of 20);
- ``sustained_ms``: wall milliseconds a rollout over 20 rollouts issued back
  to back with one synchronize at the end.

The 16 ms budget is judged on both: ``within_budget_device`` on ``value``,
``within_budget_wall`` on ``latency_ms``. Each row carries ``platform``
(``cuda-h100`` on an H100, ``torch-cpu`` under ``--device cpu``) and the
card's name and power limit as ``nvidia-smi`` gives them (``card``).

Every entry runs on ``cuda`` unless ``--device cpu`` is given; without a
GPU it raises. The bench never writes ``BENCH_DETAIL.json`` (the JAX
bench's file).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bevy_ggrs_tpu_torch.ops import launch_counts  # noqa: E402

BUDGET_MS = 16.0  # one 60 Hz render frame
HEADLINE = "box_game_rollback_8f_x_256b_latency"
DETAIL_FILE = "BENCH_TORCH_DETAIL.json"
ROLLOUT_CALLS = 20  # rollouts a timing averages over

# H100 SXM5 peaks at its 700 W limit, from NVIDIA's H100 data sheet: HBM3
# bandwidth, float32 on the CUDA cores, dense bf16 on the tensor cores.
H100_PEAKS = {"bytes_per_s": 3.35e12, "f32_flops": 67e12, "bf16_tc_flops": 989e12}

_STATE = {"device": None, "card": None}


def set_device(name: str) -> torch.device:
    """Select the device every entry runs on; ``cuda`` needs a GPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    _STATE["device"] = torch.device(name)
    _STATE["card"] = None
    return _STATE["device"]


def _dev() -> torch.device:
    if _STATE["device"] is None:
        set_device("cuda")
    return _STATE["device"]


def _cuda() -> bool:
    return _dev().type == "cuda"


def _sync() -> None:
    if _cuda():
        torch.cuda.synchronize()


def _platform() -> str:
    if not _cuda():
        return "torch-cpu"
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        return "cuda-h100"
    return "cuda-" + re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")


def _card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if _STATE["card"] is None:
        if _cuda():
            _STATE["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
        else:
            _STATE["card"] = "cpu"
    return _STATE["card"]


def _launch_delta(before: dict) -> dict:
    """The kernel launches since ``before`` (a ``launch_counts()``)."""
    now = launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] - before.get(k, 0)}


# Kineto drops a device record that falls at the edge of the profiler's
# window; the profiled calls sit this far inside it on both sides.
_PROFILE_MARGIN_S = 0.005


def device_ms(fn, calls: int = ROLLOUT_CALLS):
    """``(busy ms a call, {kernel: ms a call})`` of ``fn`` on the card: the
    union of the kernel and copy intervals ``torch.profiler`` records over
    ``calls`` calls, divided by ``calls``, and the five costliest kernels.
    ``(None, {})`` on the CPU."""
    if not _cuda():
        return None, {}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(_PROFILE_MARGIN_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(_PROFILE_MARGIN_S)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("bench_torch: the profiler saw no device activity")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + (t1 - t0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy_us / 1e3 / calls, {k: v / 1e3 / calls for k, v in top}


def wall_stats(fn, iters: int = ROLLOUT_CALLS):
    """``(latency ms, sustained ms)``: the median wall time of ``fn``
    followed by a synchronize, and the wall time a call of ``iters`` calls
    issued back to back with one synchronize at the end."""
    fn()
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    sustained = (time.perf_counter() - t0) * 1000.0 / iters
    return float(np.median(times)), float(sustained)


def op_percentiles(fn, iters: int = 50):
    """``(p50, p99)`` wall ms of ``fn`` followed by a synchronize."""
    fn()
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.percentile(times, 50)), float(np.percentile(times, 99))


def host_device_rtt_ms() -> float:
    """One tiny operation and a synchronize: the host's round trip to the
    device (0 on the CPU)."""
    if not _cuda():
        return 0.0
    x = torch.zeros((), device=_dev())
    (x + 1).item()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        (x + 1).item()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


def _entry(metric: str, value_ms: float, frames: int, branches: int,
           rtt_ms: float = None, **extra) -> dict:
    """A row in the JAX bench's schema, with the port's ``platform`` and
    ``card``."""
    if rtt_ms is None:
        rtt_ms = host_device_rtt_ms()
    value_ms = max(float(value_ms), 1e-6)
    out = {
        "metric": metric,
        "value": round(value_ms, 6),
        "unit": "ms",
        "vs_baseline": round(BUDGET_MS / value_ms, 3),
        "frames": frames,
        "branches": branches,
        "platform": _platform(),
        "card": _card(),
        "host_device_rtt_ms": round(rtt_ms, 4),
        "rollback_frames_per_sec": round(frames * branches / (value_ms / 1000.0)),
    }
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# Rollouts: B branches x F frames from one state
# ---------------------------------------------------------------------------


def _spec_case(schedule, state, players: int, frames: int, branches: int, seed: int):
    """An executor, its start state and its branch bits ``[B, F, P]`` (host
    numpy): box_game-style bitmask trees drawn from a ``torch.Generator``
    seeded with ``seed`` (branch 0 repeats the last input)."""
    from bevy_ggrs_tpu_torch.parallel.speculate import (
        SpeculativeExecutor,
        bitmask_sampler,
        enumerate_branches,
    )

    ex = SpeculativeExecutor(schedule, branches, frames)
    gen = torch.Generator().manual_seed(seed)
    bits = enumerate_branches(gen, np.zeros((players,), np.uint8), branches, frames,
                              sampler=bitmask_sampler())
    return ex, state, bits.numpy()


def _box_game_case(players: int, frames: int, branches: int, seed: int = 0):
    from bevy_ggrs_tpu_torch.models import box_game

    return _spec_case(box_game.make_schedule(),
                      box_game.make_world(players, device=_dev()).commit(),
                      players, frames, branches, seed)


def _neural_bots_case(num_bots: int, players: int, frames: int, branches: int,
                      hidden: int = None):
    from bevy_ggrs_tpu_torch.models import neural_bots

    kw = {} if hidden is None else {"hidden": hidden}
    return _spec_case(neural_bots.make_schedule(),
                      neural_bots.make_world(num_bots, players, device=_dev(), **kw).commit(),
                      players, frames, branches, seed=7)


def _boids_case(num_boids: int, players: int, frames: int, branches: int, kernel: str,
                mode: str = None):
    from bevy_ggrs_tpu_torch.models import boids

    return _spec_case(boids.make_schedule(kernel=kernel, mode=mode),
                      boids.make_world(num_boids, players, device=_dev()).commit(),
                      players, frames, branches, seed=4)


def _projectiles_case(players: int, capacity: int, frames: int, branches: int):
    from bevy_ggrs_tpu_torch.models import projectiles

    return _spec_case(projectiles.make_schedule(),
                      projectiles.make_world(players, capacity, device=_dev()).commit(),
                      players, frames, branches, seed=11)


def _config_flop_model(name: str):
    """``(useful flops a frame-branch, unit, note)`` of a rollout config:
    the arithmetic ``mfu_pct`` divides by, against the peak of the unit
    that does the work (``tc``: the bf16 tensor cores, for the tensor-core
    force kernels; ``f32``: the CUDA cores). 'Useful' counts the model's
    logical work, not padded work."""
    if name.startswith("boids") and name.endswith("_grid"):
        from bevy_ggrs_tpu_torch.models import boids

        n = int(re.search(r"boids_(\d+)k", name).group(1)) * 1024
        m = boids.grid_config(n).padded_cols
        return n * m * 31, "f32", (
            f"31 flops/pair x N x padded_cols pairs (grid mode: 9*cell_capacity + "
            f"spill_capacity candidates per entity, padded to {m}); counts dispatched "
            "candidate work, not the O(N^2) pairs the grid avoids")
    if name.startswith("boids"):
        n = int(re.search(r"boids_(\d+)k", name).group(1)) * 1024
        unit = "tc" if name.endswith("_mxu") else "f32"
        return n * n * 31, unit, (
            "31 flops/pair x N^2 pairs (17 mask ops + 7 accumulator multiply-adds); "
            + ("the products run on the bf16 tensor cores (mxu2 below 4,096 boids, the "
               "triangle kernel from 4,096, which computes half the pairs)"
               if unit == "tc" else "the f32 force kernel on the CUDA cores"))
    if name.startswith("neural_bots"):
        from bevy_ggrs_tpu_torch.models.neural_bots import HIDDEN, OBS_DIM

        m = re.search(r"_h(\d+)_", name)
        hidden = int(m.group(1)) if m else HIDDEN
        cap, actions = 512, 4
        return 2 * cap * (OBS_DIM * hidden + hidden * actions), "f32", (
            f"2*N*(OBS*H + H*A) MLP multiply-adds, N={cap}, OBS={OBS_DIM}, H={hidden}, "
            f"A={actions} (exact integer products as float32 on the CUDA cores); "
            "elementwise physics not counted")
    if name.startswith("box_game"):
        m = re.search(r"(\d+)p", name)
        players = int(m.group(1)) if m else 2
        return players * 64, "f32", (
            "~64 elementwise flops per cube (integrate + clamp + checksum mixing); far "
            "below any compute roofline: rollout time is launch and save overhead")
    if name.startswith("projectiles"):
        return 64 * 96, "f32", ("~96 flops per capacity slot (move + collide + "
                                "spawn/despawn scatter ranks), capacity 64")
    return None, None, None


def measure_rollout(name: str, case, frames: int, branches: int) -> dict:
    """A rollout row: device ms (``value``), wall latency and sustained ms,
    the launches of each kernel in one rollout, its costliest kernels, the
    flop model's achieved rate and utilization."""
    ex, state, bits = case()
    run = lambda: ex.run(state, 0, bits)  # noqa: E731
    run()
    _sync()
    before = launch_counts()
    run()
    _sync()
    per_rollout = _launch_delta(before)
    latency, sustained = wall_stats(run)
    device, top = device_ms(run)
    value = device if device is not None else latency
    extra = {}
    flops_fb, unit, note = _config_flop_model(name)
    if flops_fb is not None and device is not None:
        gflops = flops_fb * frames * branches / (value / 1000.0) / 1e9
        peak = H100_PEAKS["bf16_tc_flops" if unit == "tc" else "f32_flops"]
        extra = {"achieved_gflops": round(gflops, 3),
                 "mfu_pct": round(100.0 * gflops * 1e9 / peak, 4),
                 "mfu_unit": "bf16 tensor cores" if unit == "tc" else "f32 CUDA cores",
                 "flop_model": note}
    if name.startswith("boids") and name.endswith("_grid"):
        from bevy_ggrs_tpu_torch.models import boids
        from bevy_ggrs_tpu_torch.ops import neighbor

        pos = state.components["position"]
        active = (state.alive & state.present["position"]).to(pos.dtype)
        stats = neighbor.grid_stats(pos, active, boids.grid_config(pos.shape[0]))
        extra.update({f"grid_{k}": v for k, v in stats.items()})
    return _entry(
        name, value, frames, branches,
        value_source="device (torch.profiler)" if device is not None else "wall (cpu)",
        latency_ms=round(latency, 6),
        sustained_ms=round(sustained, 6),
        within_budget_device=(bool(device <= BUDGET_MS) if device is not None else None),
        within_budget_wall=bool(latency <= BUDGET_MS),
        sustained_rollback_frames_per_sec=round(frames * branches / (sustained / 1000.0)),
        device_busy_share=(round(device / latency, 4) if device is not None else None),
        kernel_launches_per_rollout=per_rollout,
        device_top_kernels_ms=top,
        **extra,
    )


def run_headline() -> dict:
    return measure_rollout(HEADLINE, lambda: _box_game_case(2, 8, 256), 8, 256)


# name -> (case builder, frames, branches); each runs in its own
# subprocess under --all, the headline first. boids_1k_8f_x_128b_xla waits
# for the port's sharding.
_CONFIGS = {
    HEADLINE: (lambda: _box_game_case(2, 8, 256), 8, 256),
    # 1: the CPU reference's parity point: one branch, 4-frame recovery.
    "box_game_2p_4f_x_1b": (lambda: _box_game_case(2, 4, 1), 4, 1),
    # 2: the first speculative batch.
    "box_game_2p_8f_x_64b": (lambda: _box_game_case(2, 8, 64), 8, 64),
    # 3: the determinism harness's scale (4-player synctest shape).
    "box_game_4p_8f_x_256b": (lambda: _box_game_case(4, 8, 256), 8, 256),
    # 4: entity-count scaling, 1k boids on the f32 and tensor-core kernels.
    "boids_1k_8f_x_128b_pallas": (lambda: _boids_case(1024, 2, 8, 128, "pallas"), 8, 128),
    "boids_1k_8f_x_128b_mxu": (lambda: _boids_case(1024, 2, 8, 128, "mxu"), 8, 128),
    # The entity-scaling curve; N >= 4096 takes the triangle kernel.
    "boids_4k_8f_x_8b_mxu": (lambda: _boids_case(4096, 2, 8, 8, "mxu"), 8, 8),
    "boids_8k_8f_x_2b_mxu": (lambda: _boids_case(8192, 2, 8, 2, "mxu"), 8, 2),
    "boids_16k_8f_x_1b_mxu": (lambda: _boids_case(16384, 2, 8, 1, "mxu"), 8, 1),
    "boids_32k_8f_x_1b_mxu": (lambda: _boids_case(32768, 2, 8, 1, "mxu"), 8, 1),
    # The neighbour grid: the cell kernel.
    "boids_32k_8f_x_1b_grid": (
        lambda: _boids_case(32768, 2, 8, 1, "pallas", mode="grid"), 8, 1),
    "boids_64k_8f_x_1b_grid": (
        lambda: _boids_case(65536, 2, 8, 1, "pallas", mode="grid"), 8, 1),
    # 5: depth x breadth: 8 players, 12 frames, a 1,024-branch tree.
    "box_game_8p_12f_x_1024b": (lambda: _box_game_case(8, 12, 1024), 12, 1024),
    # Batched MLP inference inside the rollback domain, and wider MLPs.
    "neural_bots_512_8f_x_64b": (lambda: _neural_bots_case(512, 2, 8, 64), 8, 64),
    "neural_bots_512_h256_8f_x_64b": (
        lambda: _neural_bots_case(512, 2, 8, 64, hidden=256), 8, 64),
    "neural_bots_512_h512_8f_x_64b": (
        lambda: _neural_bots_case(512, 2, 8, 64, hidden=512), 8, 64),
    # Dynamic entity lifecycle: spawn/despawn scatters over the branch axis.
    "projectiles_4p_64cap_8f_x_64b": (lambda: _projectiles_case(4, 64, 8, 64), 8, 64),
}


# ---------------------------------------------------------------------------
# Recovery: speculative commit against serial resimulation
# ---------------------------------------------------------------------------

_RECOVERY_CONFIGS = {
    "box_game_recovery_8f_spec_vs_serial": ("box_game", 8, 32),
    "boids_recovery_8f_spec_vs_serial": ("boids", 8, 32),
    "projectiles_recovery_8f_spec_vs_serial": ("projectiles", 8, 32),
    "neural_bots_recovery_8f_spec_vs_serial": ("neural_bots", 8, 32),
}


def recovery_pair(model: str, frames: int, branches: int):
    """``(serial, spec)``: two closures that recover from a full-depth
    rollback of ``frames`` frames. ``serial`` reloads frame 0 and
    resimulates branch 3's inputs (the port's ``RolloutExecutor``);
    ``spec`` commits branch 3 of a precomputed rollout
    (``SpeculativeExecutor.commit``) and absorbs its frames into the
    session's ring (``fused.absorb_branch_frames``). Each returns
    ``(ring, state, checksums)``."""
    from bevy_ggrs_tpu_torch.fused import absorb_branch_frames
    from bevy_ggrs_tpu_torch.models import boids, box_game, neural_bots, projectiles
    from bevy_ggrs_tpu_torch.parallel.speculate import SpeculativeExecutor
    from bevy_ggrs_tpu_torch.rollout import RolloutExecutor
    from bevy_ggrs_tpu_torch.state import ring_init, ring_save

    players, dev = 2, _dev()
    if model == "boids":
        schedule = boids.make_schedule(kernel="mxu")
        state = boids.make_world(1024, 2, device=dev).commit()
    elif model == "projectiles":
        players = 4
        schedule = projectiles.make_schedule()
        state = projectiles.make_world(players, 64, device=dev).commit()
    elif model == "neural_bots":
        schedule = neural_bots.make_schedule()
        state = neural_bots.make_world(512, 2, device=dev).commit()
    else:
        schedule = box_game.make_schedule()
        state = box_game.make_world(2, device=dev).commit()
    rng = np.random.RandomState(0)
    hi = 32 if model == "projectiles" else 16
    host_bits = rng.randint(0, hi, (branches, frames, players)).astype(np.uint8)
    status = np.zeros((frames, players), np.int32)

    ex = SpeculativeExecutor(schedule, branches, frames)
    res = ex.run(state, 0, host_bits)
    serial_ex = RolloutExecutor(schedule, frames)
    ring = ring_init(state, frames)
    ring_save(ring, state, 0)
    replay_bits = host_bits[3]

    def serial():
        return serial_ex.run(ring, state, 0, replay_bits, status, n_frames=frames,
                             load_frame=0)

    def spec():
        spec_ring, spec_state = ex.commit(res, 3)
        return absorb_branch_frames(ring, spec_ring, spec_state, 0, frames, 0, frames,
                                    max_steps=frames)

    return serial, spec


def recovery_case(model: str, frames: int, branches: int) -> dict:
    serial, spec = recovery_pair(model, frames, branches)
    rtt = host_device_rtt_ms()
    serial_dev, serial_top = device_ms(serial)
    spec_dev, spec_top = device_ms(spec)
    serial_p50, serial_p99 = op_percentiles(serial)
    spec_p50, spec_p99 = op_percentiles(spec)
    if spec_dev is None:  # the CPU: wall medians stand in for device time
        serial_dev, spec_dev = serial_p50, spec_p50
    return _entry(
        f"{model}_recovery_{frames}f_spec_vs_serial", spec_dev, frames, 1, rtt_ms=rtt,
        value_source="device (torch.profiler)" if _cuda() else "wall (cpu)",
        recovery_p50_ms=round(spec_p50, 6),
        recovery_p99_ms=round(spec_p99, 6),
        serial_resim_ms=round(serial_dev, 6),
        serial_resim_p50_ms=round(serial_p50, 6),
        serial_resim_p99_ms=round(serial_p99, 6),
        spec_commit_speedup=round(serial_dev / spec_dev, 3),
        serial_top_kernels_ms=serial_top,
        spec_top_kernels_ms=spec_top,
    )


# ---------------------------------------------------------------------------
# Live paced sessions: real P2P sessions over loopback (latency, jitter,
# loss, a virtual 60 Hz clock) or UDP on 127.0.0.1, for thousands of render
# ticks on scripted misprediction-heavy inputs: per-tick host time,
# rollback-tick p50/p99, the render deadline's hit rate, speculation
# counters and the host dispatch timers.
# ---------------------------------------------------------------------------

DEADLINE_MS = 1000.0 / 60.0
_DT = 1.0 / 60.0
HOST_DISPATCH_BUDGET_MS = 1.0


def _live_model_zoo():
    from bevy_ggrs_tpu_torch.models import boids, box_game, neural_bots, projectiles

    dev = _dev()
    return {
        "box_game": dict(
            players=2, frames=6000, branches=64,
            schedule=lambda: box_game.make_schedule(),
            world=lambda p: box_game.make_world(p, device=dev).commit(),
            input_spec=box_game.INPUT_SPEC,
            keys=[box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0],
        ),
        "boids": dict(
            players=2, frames=1500, branches=16,
            schedule=lambda: boids.make_schedule(kernel="mxu"),
            world=lambda p: boids.make_world(1024, p, device=dev).commit(),
            input_spec=boids.INPUT_SPEC,
            keys=[boids.INPUT_UP, boids.INPUT_RIGHT, boids.INPUT_DOWN, 0],
        ),
        "projectiles": dict(
            players=4, frames=4000, branches=64,
            schedule=lambda: projectiles.make_schedule(),
            world=lambda p: projectiles.make_world(p, 64, device=dev).commit(),
            input_spec=projectiles.INPUT_SPEC,
            keys=[projectiles.INPUT_UP, projectiles.INPUT_FIRE, projectiles.INPUT_RIGHT, 0],
        ),
        "neural_bots": dict(
            players=2, frames=3000, branches=32,
            schedule=lambda: neural_bots.make_schedule(),
            world=lambda p: neural_bots.make_world(512, p, device=dev).commit(),
            input_spec=neural_bots.INPUT_SPEC,
            keys=[1, 2, 4, 0],
        ),
    }


def _dispatch_floor_ms(runner0, players: int, input_spec) -> float:
    """Host ms of one empty burst (``n_frames=0``) of the session's own
    executor, over 20 chained calls, then synchronized."""
    zeros0 = input_spec.zeros_np(players)
    bits0 = np.zeros((0,) + zeros0.shape, zeros0.dtype)
    status0 = np.zeros((0, players), np.int32)
    pr, ps, _ = runner0.executor.run(runner0.ring, runner0.state, 0, bits0, status0,
                                     n_frames=0)
    _sync()
    t0 = time.perf_counter()
    for _ in range(20):
        pr, ps, _ = runner0.executor.run(pr, ps, 0, bits0, status0, n_frames=0)
    floor = (time.perf_counter() - t0) * 1000.0 / 20
    _sync()
    return floor


def _fused_dispatch_floor_ms(runner0) -> float:
    """Host ms of one dispatch of the speculating runner's own rollout
    (zero branch bits), over 20 calls, then synchronized; 0.0 for a runner
    that does not speculate. The budget gate charges the tick's dispatch
    timers net of it."""
    if not hasattr(runner0, "_dispatch_rollout"):
        return 0.0
    zeros = runner0.input_spec.zeros_np(runner0.num_players)
    bb = np.zeros((runner0.num_branches, runner0.spec_frames) + zeros.shape, zeros.dtype)
    before = runner0.device_dispatches_total
    runner0._dispatch_rollout(runner0.frame, bb)
    _sync()
    t0 = time.perf_counter()
    for _ in range(20):
        runner0._dispatch_rollout(runner0.frame, bb)
    floor = (time.perf_counter() - t0) * 1000.0 / 20
    _sync()
    runner0.device_dispatches_total = before  # a probe, not session work
    return floor


def _live_common_columns(metrics, runner0, executed_ticks, tick_ms, tick_sync,
                         rollback_tick_ms, ready_rollback_ms, desync_events, paced,
                         fused_floor=0.0) -> dict:
    """The columns every live row shares (the JAX bench's): tick
    percentiles, the deadline's hit rates, recovery and readiness,
    speculation counters, host timers, the host budget gate and the
    dispatches a tick."""
    tick = np.asarray(tick_ms)
    no_data = tick.size == 0
    if no_data:
        tick = np.asarray([0.0])
    nosync = tick[~np.asarray(tick_sync, bool)] if len(tick_sync) else tick
    if nosync.size == 0:
        nosync = tick
    rb = np.asarray(rollback_tick_ms)
    summary = metrics.summary()

    def series(name):
        sr = summary.get(name, {})
        return round(sr.get("p50", 0.0), 4), round(sr.get("p99", 0.0), 4)

    spec_p50, spec_p99 = series("speculate_dispatch_ms")
    build_p50, build_p99 = series("structured_bits_build_ms")
    known_p50, known_p99 = series("known_inputs_query_ms")
    tickd_p50, tickd_p99 = series("tick_dispatch_ms")
    match_p50, _ = series("match_branch_ms")
    hostd_p50, hostd_p99 = series("spec_host_dispatch_ms")
    host_dispatch_p50 = (build_p50 + known_p50 + match_p50
                         + max(0.0, max(tickd_p50, spec_p50) - fused_floor))
    dispatches_total = int(getattr(runner0, "device_dispatches_total", 0))

    def pct(a, q):
        return round(float(np.percentile(a, q)), 4) if len(a) else 0.0

    return dict(
        frames_driven=int(len(tick_ms)),
        tick_p50_ms=round(float(np.percentile(tick, 50)), 4),
        tick_p99_ms=round(float(np.percentile(tick, 99)), 4),
        deadline_hit_rate=0.0 if no_data else round(float((tick <= DEADLINE_MS).mean()), 4),
        deadline_hit_rate_nosync=(0.0 if no_data
                                  else round(float((nosync <= DEADLINE_MS).mean()), 4)),
        paced=paced,
        rollback_ticks=int(rb.size),
        recovery_p50_ms=pct(rb, 50),
        recovery_p99_ms=pct(rb, 99),
        recovery_ready_p50_ms=pct(ready_rollback_ms, 50),
        recovery_ready_p99_ms=pct(ready_rollback_ms, 99),
        desync_events=int(desync_events),
        rollbacks_total=int(runner0.rollbacks_total),
        rollback_frames_resimulated=int(runner0.rollback_frames_total),
        rollback_frames_recovered=int(getattr(runner0, "rollback_frames_recovered_total", 0)),
        spec_hits=int(getattr(runner0, "spec_hits", 0)),
        spec_partial_hits=int(getattr(runner0, "spec_partial_hits", 0)),
        spec_misses=int(getattr(runner0, "spec_misses", 0)),
        spec_dispatches_skipped=int(getattr(runner0, "spec_dispatches_skipped", 0)),
        speculate_dispatch_p50_ms=spec_p50,
        speculate_dispatch_p99_ms=spec_p99,
        tick_dispatch_p50_ms=tickd_p50,
        tick_dispatch_p99_ms=tickd_p99,
        spec_host_dispatch_p50_ms=hostd_p50,
        spec_host_dispatch_p99_ms=hostd_p99,
        match_branch_p50_ms=match_p50,
        structured_bits_build_p50_ms=build_p50,
        structured_bits_build_p99_ms=build_p99,
        known_inputs_query_p50_ms=known_p50,
        known_inputs_query_p99_ms=known_p99,
        ticks_total=executed_ticks,
        device_dispatches_total=dispatches_total,
        dispatches_per_tick=(round(dispatches_total / executed_ticks, 3)
                             if executed_ticks else 0.0),
        host_dispatch_p50_ms=round(host_dispatch_p50, 4),
        host_dispatch_budget_ms=HOST_DISPATCH_BUDGET_MS,
        host_dispatch_within_budget=bool(host_dispatch_p50 <= HOST_DISPATCH_BUDGET_MS),
        fused_dispatch_floor_ms=round(fused_floor, 4),
        **_ledger_columns(getattr(runner0, "ledger", None)),
        **_predictor_columns(runner0),
    )


def _ledger_columns(ledger) -> dict:
    """Branch-economics columns from a speculation ledger; every
    spec-capable row carries them (``tools/bench_gate.py`` checks them)."""
    if ledger is None or not getattr(ledger, "enabled", False):
        return dict(spec_full_hit_rate=0.0, spec_hit_rank_p50=0, spec_hit_rank_p99=0,
                    spec_waste_ratio=0.0, blame_top_player_share=0.0)
    s = ledger.summary()
    return dict(
        spec_full_hit_rate=round(float(s["spec_full_hit_rate"]), 4),
        spec_hit_rank_p50=int(s["spec_hit_rank_p50"]),
        spec_hit_rank_p99=int(s["spec_hit_rank_p99"]),
        spec_waste_ratio=round(float(s["spec_waste_ratio"]), 4),
        blame_top_player_share=round(float(s["blame_top_player_share"]), 4),
    )


def _predictor_columns(obj) -> dict:
    """Which policy seeded the branch trees ("learned": the predictor;
    "current": the heuristic ranker) and the mean host ms of a ranking."""
    bound = getattr(obj, "_predictor", None)
    n = int(getattr(obj, "predictor_rank_builds", 0)
            or getattr(obj, "predictor_rank_dispatches", 0))
    total = float(getattr(obj, "predictor_rank_ms_total", 0.0))
    return dict(spec_policy="learned" if bound is not None else "current",
                predictor_rank_ms=round(total / n, 4) if n else 0.0)


def _drive_peer(session, runner, scripted, counts) -> tuple:
    """One peer's part of a render tick: flush, poll, drain events, add
    inputs and run the tick. Returns ``(ran, had_rollback)``."""
    from bevy_ggrs_tpu_torch.session import PredictionThreshold, SessionState

    flush = getattr(runner, "flush_reports", None)
    if flush is not None:
        flush(session)
    session.poll_remote_clients()
    for ev in session.events():
        if ev.kind.name == "DESYNC_DETECTED":
            counts["desyncs"] += 1
    if session.current_state() != SessionState.RUNNING:
        return False, False
    for h in session.local_player_handles():
        session.add_local_input(h, scripted(h, session.current_frame))
    try:
        requests = session.advance_frame()
    except PredictionThreshold:
        return False, False
    had_rollback = any(type(r).__name__ == "LoadGameState" for r in requests)
    tick_fn = getattr(runner, "tick", None)
    if tick_fn is not None:
        tick_fn(requests, session.confirmed_frame(), session)
    else:
        runner.handle_requests(requests, session)
    return True, had_rollback


def _live_session_case(model: str, speculate: bool, transport: str) -> dict:
    from bevy_ggrs_tpu_torch.obs import FlightRecorder, SpanTracer
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    case_t0 = time.perf_counter()
    cfg = _live_model_zoo()[model]
    dev = _dev()
    if not _cuda() and model in ("boids", "neural_bots"):
        # On the CPU the plain versions run: a smaller world (as the JAX
        # bench's _cpuhost rows) so the rollout fits the frame's budget.
        from bevy_ggrs_tpu_torch.models import boids, neural_bots

        if model == "boids":
            cfg = dict(cfg, branches=4,
                       schedule=lambda: boids.make_schedule(kernel="pallas"),
                       world=lambda p: boids.make_world(128, p, device=dev).commit())
        else:
            cfg = dict(cfg, branches=16,
                       world=lambda p: neural_bots.make_world(128, p, device=dev).commit())
    players = cfg["players"]
    # GGRS_LIVE_FRAMES overrides the tick count (a short smoke run).
    frames = int(os.environ.get("GGRS_LIVE_FRAMES", cfg["frames"]))
    max_prediction = 8
    if transport == "loopback":
        from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork

        net = LoopbackNetwork(latency=2 * _DT, jitter=1 * _DT, loss=0.03, seed=5)
        socks = {me: net.socket(("peer", me)) for me in range(2)}
        clock = lambda: net.now  # noqa: E731
        addr_of = lambda h: ("peer", h)  # noqa: E731
    else:  # UDP on 127.0.0.1, the wall clock
        from bevy_ggrs_tpu_torch.transport.udp import UdpSocket

        base = 47000 + (os.getpid() % 500) * 2
        socks = {me: UdpSocket(base + me, host="127.0.0.1") for me in range(2)}
        clock = None
        addr_of = lambda h: ("127.0.0.1", base + h)  # noqa: E731
    keys = cfg["keys"]
    dtype = cfg["input_spec"].zeros_np(1).dtype

    def scripted(handle, frame):
        return np.asarray(keys[(frame // 3 + handle) % len(keys)], dtype)

    peers = []
    metrics = Metrics()
    tracer = SpanTracer(process_name=f"live_{model}_{transport}")
    recorder = FlightRecorder()
    for me in range(2):
        builder = (SessionBuilder(cfg["input_spec"]).with_num_players(players)
                   .with_max_prediction_window(max_prediction))
        for h in range(players):
            if h % 2 == me:
                builder.add_player(PlayerType.local(), h)
            else:
                builder.add_player(PlayerType.remote(addr_of(1 - me)), h)
        session = builder.start_p2p_session(socks[me], clock=clock,
                                            metrics=metrics if me == 0 else None,
                                            tracer=tracer if me == 0 else None)
        if me == 0 and speculate:
            from bevy_ggrs_tpu_torch.obs.ledger import SpeculationLedger

            runner = SpeculativeRollbackRunner(
                cfg["schedule"](), cfg["world"](players), max_prediction=max_prediction,
                num_players=players, input_spec=cfg["input_spec"],
                num_branches=cfg["branches"], metrics=metrics, tracer=tracer,
                ledger=SpeculationLedger(), device=dev)
        else:
            runner = RollbackRunner(
                cfg["schedule"](), cfg["world"](players), max_prediction=max_prediction,
                num_players=players, input_spec=cfg["input_spec"],
                metrics=metrics if me == 0 else None, tracer=tracer if me == 0 else None,
                device=dev)
        runner.warmup()
        peers.append((session, runner))
    setup_warmup_ms = (time.perf_counter() - case_t0) * 1000.0

    tick_ms, tick_sync, rollback_tick_ms, ready_rollback_ms = [], [], [], []
    counts = {"desyncs": 0}
    first_frame_ms = None
    session0, runner0 = peers[0]
    sync_series = metrics.series["checksum_sync_ms"]
    dispatch_floor_ms = _dispatch_floor_ms(runner0, players, cfg["input_spec"])
    fused_floor = _fused_dispatch_floor_ms(runner0)
    # Real-time pacing (GGRS_LIVE_PACED=0: as fast as possible): each
    # render tick sleeps to the next 16.7 ms boundary, a 60 Hz game's duty
    # cycle.
    paced = os.environ.get("GGRS_LIVE_PACED", "1") != "0"
    before = launch_counts()
    executed_ticks = 0
    for _ in range(frames):
        wall0 = time.perf_counter()
        if transport == "loopback":
            net.advance(_DT)
        for me, (session, runner) in enumerate(peers):
            t0 = time.perf_counter()
            n_sync0 = len(sync_series)
            ran, had_rollback = _drive_peer(session, runner, scripted, counts)
            if not ran or me != 0:
                continue
            executed_ticks += 1
            if first_frame_ms is None:
                first_frame_ms = (time.perf_counter() - case_t0) * 1000.0
            ms = (time.perf_counter() - t0) * 1000.0
            tick_ms.append(ms)
            tick_sync.append(len(sync_series) > n_sync0)
            if had_rollback:
                rollback_tick_ms.append(ms)
                # Recovery readiness: the tick plus a read of one small
                # state leaf (what a render system waits for).
                runner.state.alive.cpu()
                ready_rollback_ms.append((time.perf_counter() - t0) * 1000.0)
            recorder.capture(session=session, runner=runner)
        if paced:
            leftover = _DT - (time.perf_counter() - wall0)
            if leftover > 0:
                time.sleep(leftover)
    for sock in socks.values():
        close = getattr(sock, "close", None)
        if close:
            close()
    rb = np.asarray(rollback_tick_ms)
    return _entry(
        f"live_{model}_{transport}_spec_{'on' if speculate else 'off'}",
        max(float(np.percentile(rb, 99)) if rb.size else 0.0, 1e-3),
        max_prediction, cfg["branches"] if speculate else 1,
        value_source="wall p99 of peer 0's rollback ticks",
        dispatch_floor_ms=round(dispatch_floor_ms, 4),
        setup_warmup_ms=round(setup_warmup_ms, 1),
        cold_start_to_first_frame_ms=(round(first_frame_ms, 1)
                                      if first_frame_ms is not None else -1.0),
        confirmed_frames=int(session0.confirmed_frame()),
        kernel_launches=_launch_delta(before),
        rollback_depth_histogram={str(d): n for d, n in recorder.rollback_histogram().items()},
        span_summary={name: {"count": s["count"], "mean_ms": round(s["mean_ms"], 4),
                             "max_ms": round(s["max_ms"], 4)}
                      for name, s in sorted(tracer.summary().items())},
        **_live_common_columns(metrics, runner0, executed_ticks, tick_ms, tick_sync,
                               rollback_tick_ms, ready_rollback_ms, counts["desyncs"],
                               paced, fused_floor=fused_floor),
    )


def _live_8p_spectator_case(speculate: bool, predictor=None) -> dict:
    """Config 5 live: a paced 8-player P2P session over loopback with the
    12-frame prediction window, peer 0 speculating a 1,024-branch tree (its
    tree seeded by ``predictor`` when given) and a live spectator of peer 0."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import (
        PlayerType,
        PredictionThreshold,
        SessionBuilder,
        SessionState,
    )
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
    from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P, MAXPRED, BRANCHES = 8, 12, 1024
    dev = _dev()
    case_t0 = time.perf_counter()
    frames = int(os.environ.get("GGRS_LIVE_FRAMES", 1800))
    net = LoopbackNetwork(latency=2 * _DT, jitter=1 * _DT, loss=0.02, seed=7)
    metrics = Metrics()
    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]

    def scripted(handle, frame):
        return np.uint8(keys[(frame // 3 + handle) % len(keys)])

    def world():
        return box_game.make_world(P, device=dev).commit()

    peers = []
    for me in range(P):
        builder = SessionBuilder(box_game.INPUT_SPEC).with_num_players(P) \
            .with_max_prediction_window(MAXPRED)
        if predictor is not None:
            builder.with_input_predictor(predictor)
        for h in range(P):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(("peer", h)), h)
        if me == 0:
            builder.add_player(PlayerType.spectator(("spec", 0)), P)
        session = builder.start_p2p_session(net.socket(("peer", me)), clock=lambda: net.now)
        if me == 0 and speculate:
            from bevy_ggrs_tpu_torch.obs.ledger import SpeculationLedger

            runner = SpeculativeRollbackRunner(
                box_game.make_schedule(), world(), max_prediction=MAXPRED, num_players=P,
                input_spec=box_game.INPUT_SPEC, num_branches=BRANCHES, spec_frames=MAXPRED,
                metrics=metrics, ledger=SpeculationLedger(), predictor=predictor, device=dev)
        else:
            runner = RollbackRunner(
                box_game.make_schedule(), world(), max_prediction=MAXPRED, num_players=P,
                input_spec=box_game.INPUT_SPEC, metrics=metrics if me == 0 else None,
                device=dev)
        runner.warmup()
        peers.append((session, runner))
    spec_builder = SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
    if predictor is not None:  # the handshake compares the weights' digest
        spec_builder.with_input_predictor(predictor)
    spec_session = spec_builder.start_spectator_session(("peer", 0), net.socket(("spec", 0)),
                                                        clock=lambda: net.now)
    spec_runner = RollbackRunner(box_game.make_schedule(), world(), max_prediction=MAXPRED,
                                 num_players=P, input_spec=box_game.INPUT_SPEC, device=dev)
    spec_runner.warmup()

    paced = os.environ.get("GGRS_LIVE_PACED", "1") != "0"
    setup_warmup_ms = (time.perf_counter() - case_t0) * 1000.0
    tick_ms, tick_sync, rollback_tick_ms, ready_rollback_ms = [], [], [], []
    spectator_lag = []
    counts = {"desyncs": 0}
    first_frame_ms = None
    executed_ticks = 0
    session0, runner0 = peers[0]
    dispatch_floor = _dispatch_floor_ms(runner0, P, box_game.INPUT_SPEC)
    fused_floor = _fused_dispatch_floor_ms(runner0)
    sync_series = metrics.series["checksum_sync_ms"]
    before = launch_counts()
    for _ in range(frames):
        wall0 = time.perf_counter()
        net.advance(_DT)
        for me, (session, runner) in enumerate(peers):
            t0 = time.perf_counter()
            n_sync0 = len(sync_series)
            ran, had_rollback = _drive_peer(session, runner, scripted, counts)
            if not ran or me != 0:
                continue
            executed_ticks += 1
            if first_frame_ms is None:
                first_frame_ms = (time.perf_counter() - case_t0) * 1000.0
            ms = (time.perf_counter() - t0) * 1000.0
            tick_ms.append(ms)
            tick_sync.append(len(sync_series) > n_sync0)
            if had_rollback:
                rollback_tick_ms.append(ms)
                runner.state.alive.cpu()
                ready_rollback_ms.append((time.perf_counter() - t0) * 1000.0)
        # The live spectator consumes the host's fan-out every frame.
        spec_session.poll_remote_clients()
        if spec_session.current_state() == SessionState.RUNNING:
            try:
                spec_runner.handle_requests(spec_session.advance_frame(), spec_session)
            except PredictionThreshold:
                pass
            spectator_lag.append(session0.current_frame - spec_session.current_frame)
        if paced:
            leftover = _DT - (time.perf_counter() - wall0)
            if leftover > 0:
                time.sleep(leftover)

    rb = np.asarray(rollback_tick_ms)
    lag = np.asarray(spectator_lag) if spectator_lag else None
    name = f"live_box_game_8p_spectator_spec_{'on' if speculate else 'off'}"
    if predictor is not None:
        name += "_predictor"
    extra = {}
    if predictor is not None:
        extra["notes"] = (
            "predictor on: zero full hits at 1,024 branches are the reference's own result "
            "(the JAX package's runner gives the same counters on the same session, "
            "tests/test_torch_predictor_sessions.py); bench_gate's full-hit check fails "
            "such a row by design")
    return _entry(
        name, max(float(np.percentile(rb, 99)) if rb.size else 0.0, 1e-3),
        MAXPRED, BRANCHES if speculate else 1,
        value_source="wall p99 of peer 0's rollback ticks",
        dispatch_floor_ms=round(dispatch_floor, 4),
        setup_warmup_ms=round(setup_warmup_ms, 1),
        cold_start_to_first_frame_ms=(round(first_frame_ms, 1)
                                      if first_frame_ms is not None else -1.0),
        confirmed_frames=int(session0.confirmed_frame()),
        kernel_launches=_launch_delta(before),
        **_live_common_columns(metrics, runner0, executed_ticks, tick_ms, tick_sync,
                               rollback_tick_ms, ready_rollback_ms, counts["desyncs"],
                               paced, fused_floor=fused_floor),
        spectator_frames=int(spec_session.current_frame),
        spectator_lag_p50_frames=(round(float(np.percentile(lag, 50)), 2)
                                  if lag is not None else -1.0),
        spectator_lag_p99_frames=(round(float(np.percentile(lag, 99)), 2)
                                  if lag is not None else -1.0),
        **extra,
    )


_LIVE_CONFIGS = {}
for _m in ("box_game", "boids", "projectiles", "neural_bots"):
    for _s in (True, False):
        _LIVE_CONFIGS[f"live_{_m}_loopback_spec_{'on' if _s else 'off'}"] = (_m, _s, "loopback")
_LIVE_CONFIGS["live_box_game_udp_spec_on"] = ("box_game", True, "udp")
# Config 5 live: 8 players + a live spectator, a 12-frame window, a
# 1,024-branch tree; and the same with the learned predictor seeding it.
_EIGHTP_CONFIGS = {
    "live_box_game_8p_spectator_spec_on": (True, None),
    "live_box_game_8p_spectator_spec_off": (False, None),
    "live_box_game_8p_spectator_spec_on_predictor": (True, "default"),
}


# ---------------------------------------------------------------------------
# Batched multi-session serving: S matches advanced by one batched tick.
# The headline column is matches_per_chip_at_60hz = S x 16.7 ms / tick p99,
# gated on zero desyncs in the in-bench serial-replay parity check and zero
# builds through churn.
# ---------------------------------------------------------------------------

_SERVE_CONFIGS = {}
for _m in ("box_game", "boids"):
    for _S in (16, 64, 256, 1024):
        _SERVE_CONFIGS[f"serve_batched_{_m}_S{_S}"] = (_m, _S)
_SERVE_CHAOS_CONFIGS = {"serve_chaos_S64": 64}
_SERVE_SDC_CONFIGS = {"serve_sdc_S64": 64}


def _serve_script(num_players: int, seed: int, ticks: int) -> list:
    """``(requests, confirmed_frame)`` ticks in the canonical session
    shape: 3 confirmed steps, a 2-deep predicted stall, then the rollback
    recovery tick (one rollback every 6 ticks); a seed per match gives
    every match its own inputs."""
    from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame, LoadGameState, SaveGameState

    rng = np.random.RandomState(seed)

    def adv(bits):
        return AdvanceFrame(bits=np.asarray(bits, np.uint8),
                            status=np.zeros(num_players, np.int32))

    script, frame = [], 0
    while len(script) < ticks:
        for _ in range(3):
            bits = rng.randint(0, 16, size=num_players)
            script.append(([SaveGameState(frame), adv(bits)], frame))
            frame += 1
        frontier = frame - 1
        pred = rng.randint(0, 16, size=num_players)
        for d in range(2):
            script.append(([SaveGameState(frame + d), adv(pred)], frontier))
        frame += 2
        reqs = [LoadGameState(frame - 2)]
        for t in range(2):
            bits = pred if rng.rand() < 0.5 else rng.randint(0, 16, size=num_players)
            reqs += [SaveGameState(frame - 2 + t), adv(bits)]
        reqs += [SaveGameState(frame), adv(rng.randint(0, 16, size=num_players))]
        script.append((reqs, frame))
        frame += 1
    return script[:ticks]


def _serve_model(model: str, P: int):
    from bevy_ggrs_tpu_torch.models import boids, box_game

    if model == "boids":
        return (boids.make_schedule(), boids.make_world(64, P, device=_dev()).commit(),
                boids.INPUT_SPEC)
    return (box_game.make_schedule(), box_game.make_world(P, device=_dev()).commit(),
            box_game.INPUT_SPEC)


def _bench_trace_dir(config: str):
    """The config's telemetry directory under ``--trace-dir``
    (``GGRS_TRACE_DIR``), or None when tracing is off."""
    base = os.environ.get("GGRS_TRACE_DIR")
    if not base:
        return None
    d = os.path.join(base, config)
    os.makedirs(d, exist_ok=True)
    return d


def _serve_batched_case(model: str, S: int) -> dict:
    """Throughput and contracts of the batched serving core at S slots:
    windowed per-tick time (all S matches advancing, speculation on, a
    depth-2 rollback every 6th tick), a serial singleton baseline for the
    per-match speedup, a bitwise replay of sampled slots, and a churn phase
    that must build nothing."""
    from bevy_ggrs_tpu_torch.obs import AttributionProbe, profile_window
    from bevy_ggrs_tpu_torch.obs.ledger import SpeculationLedger
    from bevy_ggrs_tpu_torch.serve.batch import BatchedSessionCore
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
    from bevy_ggrs_tpu_torch.state import checksum, combine64
    from bevy_ggrs_tpu_torch.utils import build_cache

    P, MAXPRED, B, F = 2, 4, 8, 4
    dev = _dev()
    schedule, initial, input_spec = _serve_model(model, P)
    ticks = int(os.environ.get("GGRS_SERVE_TICKS", "240") or "240")
    warm, window = 6, 6  # cycle-aligned: every window sees one rollback
    ticks = max(warm + 2 * window, ticks - ticks % window)
    rtt0 = host_device_rtt_ms()
    build_cache.install_compile_listeners()
    td = _bench_trace_dir(f"serve_batched_{model}_S{S}")
    tracer = None
    if td is not None:
        from bevy_ggrs_tpu_torch.obs import SpanTracer

        tracer = SpanTracer(pid=0, process_name=f"serve_{model}_S{S}")
    ledger = SpeculationLedger()
    core = BatchedSessionCore(schedule, initial, MAXPRED, P, input_spec, num_slots=S,
                              num_branches=B, spec_frames=F, ledger=ledger, device=dev,
                              **({"tracer": tracer} if tracer is not None else {}))
    core._exec.enable_cost_capture(f"serve_batched_{model}_S{S}")
    core.warmup()
    slots = [core.admit() for _ in range(S)]
    scripts = {s: _serve_script(P, 1000 + s, ticks) for s in slots}
    for t in range(warm):
        core.tick({s: scripts[s][t] + (None,) for s in slots})
    _sync()

    probe = AttributionProbe()
    times = []
    t_idx = warm
    before = launch_counts()
    with profile_window(os.environ.get("GGRS_PROFILE_DIR")):
        while t_idx + window <= ticks:
            t0 = time.perf_counter()
            with probe.host():
                for t in range(t_idx, t_idx + window):
                    core.tick({s: scripts[s][t] + (None,) for s in slots})
            with probe.device_wait():
                _sync()
            times.append((time.perf_counter() - t0) * 1000.0 / window)
            t_idx += window
    timed_launches = _launch_delta(before)
    ran = t_idx
    probe.snapshot_compiles()
    tick_p50 = float(np.percentile(times, 50))
    tick_p99 = float(np.percentile(times, 99))

    # Parity: sampled slots' scripts replayed through fresh singletons;
    # frame, state checksum and ring digests must be bitwise the slot's.
    desyncs = 0
    sample = sorted({slots[0], slots[S // 2], slots[-1]})
    for s in sample:
        oracle = SpeculativeRollbackRunner(schedule, initial, max_prediction=MAXPRED,
                                           num_players=P, input_spec=input_spec,
                                           num_branches=B, spec_frames=F, device=dev)
        oracle.warmup()
        for reqs, confirmed in scripts[s][:ran]:
            oracle.tick(reqs, confirmed, None)
        ok = (core.slots[s].frame == oracle.frame
              and combine64(checksum(core.slot_state(s))) == combine64(checksum(oracle.state))
              and torch.equal(core.rings.checksums[s].cpu(), oracle.ring.checksums.cpu()))
        desyncs += 0 if ok else 1

    # Churn: retire and readmit under load; nothing may build.
    compiles0 = build_cache.compile_counters()["backend_compiles"]
    cache0 = core._exec.cache_size()
    churned = slots[: min(4, S)]
    for s in churned:
        core.retire(s)
    readmitted = [core.admit() for _ in churned]
    churn_scripts = {s: _serve_script(P, 9000 + s, 2 * window) for s in readmitted}
    for t in range(2 * window):
        core.tick({s: churn_scripts[s][t] + (None,) for s in readmitted})
    _sync()
    churn_recompiles = build_cache.compile_counters()["backend_compiles"] - compiles0

    # The serial singleton baseline on the same device and script shape.
    serial = SpeculativeRollbackRunner(schedule, initial, max_prediction=MAXPRED,
                                       num_players=P, input_spec=input_spec,
                                       num_branches=B, spec_frames=F, device=dev)
    serial.warmup()
    sticks = min(ran, 120)
    sscript = _serve_script(P, 1000 + slots[0], sticks)
    for t in range(warm):
        serial.tick(*sscript[t], None)
    _sync()
    stimes = []
    sprobe = AttributionProbe()
    t_idx = warm
    while t_idx + window <= sticks:
        t0 = time.perf_counter()
        with sprobe.host():
            for t in range(t_idx, t_idx + window):
                serial.tick(*sscript[t], None)
        with sprobe.device_wait():
            _sync()
        stimes.append((time.perf_counter() - t0) * 1000.0 / window)
        t_idx += window
    serial_per_match = float(np.percentile(stimes, 50))
    serial_device = sprobe.device_ms / max(sprobe.dispatches, 1)
    attribution = probe.result(lanes=S, serial_device_ms=serial_device,
                               cost=core._exec.cost() or None)
    attribution["attr_serial_device_ms"] = round(serial_device, 4)
    if td is not None:
        from bevy_ggrs_tpu_torch.obs import build_report

        if tracer is not None:
            tracer.export_perfetto(os.path.join(td, "serve_trace.json"))
        build_report(os.path.join(td, "serve_report.html"),
                     title=f"serve_batched_{model}_S{S}",
                     tracers={} if tracer is None else {"serve": tracer},
                     attribution={f"serve_batched_{model}_S{S}": attribution},
                     ledger=ledger)
    per_match = tick_p50 / S
    return _entry(
        f"serve_batched_{model}_S{S}", tick_p50, S, B, rtt_ms=rtt0,
        value_source="wall p50 of a batched tick (windows of 6 ticks, synchronized)",
        sessions=S, model=model, ticks=int(ran),
        tick_p50_ms=round(tick_p50, 4),
        tick_p99_ms=round(tick_p99, 4),
        per_match_ms=round(per_match, 6),
        serial_per_match_ms=round(serial_per_match, 4),
        per_match_speedup=round(serial_per_match / per_match, 3),
        matches_per_chip_at_60hz=int(S * (1000.0 / 60.0) / tick_p99),
        desyncs=desyncs,
        parity_slots_checked=len(sample),
        churn_recompiles=int(churn_recompiles),
        cache_size_stable=bool(core._exec.cache_size() == cache0),
        kernel_launches=timed_launches,
        **_ledger_columns(ledger),
        **_predictor_columns(core),
        **attribution,
        notes=("spec on, a depth-2 rollback every 6th tick on every match; gated on "
               "desyncs == 0 (bitwise serial replay) and churn_recompiles == 0 (no "
               "kernel build, layout or tick-structure preparation during churn)"),
    )


def _synctest_maker(P: int, MAXPRED: int):
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session.builder import SessionBuilder

    def make():
        return (SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
                .with_max_prediction_window(MAXPRED).with_check_distance(2)
                .start_synctest_session())

    return make


def _inputs_for(seed):
    def f(frame, handle):
        return np.uint8((frame * 3 + handle * 5 + seed) % 16)

    return f


class _Flaky:
    """``advance_frame`` raises exactly once: the 'session crashed' fault."""

    def __init__(self, inner, fail_at):
        self._inner, self._fail_at, self.failed = inner, fail_at, False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def advance_frame(self):
        if not self.failed and self._inner.current_frame == self._fail_at:
            self.failed = True
            raise RuntimeError("injected session crash")
        return self._inner.advance_frame()


class _Hung:
    """Burns fake-clock time inside ``advance_frame`` for a window of
    frames: the watchdog-fenced fault."""

    def __init__(self, inner, clk, hang_frames, hang_s=0.2):
        self._inner, self._clk = inner, clk
        self._hang = set(hang_frames)
        self._hang_s = hang_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def advance_frame(self):
        if self._inner.current_frame in self._hang:
            self._clk[0] += self._hang_s
        return self._inner.advance_frame()


def _serve_chaos_case(S: int) -> dict:
    """S SyncTest matches on a ``MatchServer`` under injected slot faults
    (3 session crashes, 2 watchdog-fenced hangs, a kill and restart from
    checkpoints): recovery frames per fault class, the quarantine duty
    cycle and the healthy tick against a fault-free baseline, gated on
    zero evictions and zero builds through the faults."""
    import shutil
    import tempfile

    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.serve import MatchServer, SlotHealth
    from bevy_ggrs_tpu_torch.utils import build_cache
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P, MAXPRED, B, F = 2, 4, 8, 3
    dev = _dev()
    ticks = max(int(os.environ.get("GGRS_SERVE_TICKS", "240") or "240"), 240)
    kill_at, down_ticks = 160, 12
    rtt0 = host_device_rtt_ms()
    make_synctest = _synctest_maker(P, MAXPRED)
    ckpt_dir = tempfile.mkdtemp(prefix="ggrs_serve_chaos_")
    clk = [0.0]
    flaky = {3: 40, 17: 55, 33: 70}  # match -> the frame its session crashes at
    hung = {9: range(100, 103), 46: range(101, 104)}  # match -> its hang window

    def build(metrics):
        server = MatchServer(
            box_game.make_schedule(), box_game.make_world(P, device=dev).commit(),
            MAXPRED, P, box_game.INPUT_SPEC, num_branches=B, spec_frames=F, capacity=S,
            stagger_groups=4, metrics=metrics, clock=lambda: clk[0],
            watchdog_budget_ms=50.0, watchdog_strike_limit=3, checkpoint_dir=ckpt_dir,
            checkpoint_interval=60, checkpoint_keep=3, device=dev)
        server.warmup()
        return server

    def run(chaos):
        clk[0] = 0.0
        for f in os.listdir(ckpt_dir):
            os.unlink(os.path.join(ckpt_dir, f))
        metrics = Metrics()
        server = build(metrics)
        handle_of = {}
        for m in range(S):
            sess = make_synctest()
            if chaos and m in flaky:
                sess = _Flaky(sess, flaky[m])
            elif chaos and m in hung:
                sess = _Hung(sess, clk, hung[m])
            handle_of[m] = server.add_match(sess, _inputs_for(m))
        compiles_seg = build_cache.compile_counters()["backend_compiles"]
        churn_recompiles = 0
        times, per_class = [], {}
        prev_lanes, prev_obs = set(), 0
        pre_kill = {}
        for t in range(ticks):
            if chaos and t == kill_at:
                # kill -9 mid-run; the rebuild's own warmup is not churn.
                pre_kill = {(e["handle"].group, e["handle"].slot): e["frame"]
                            for e in server.snapshot_matches()}
                churn_recompiles += (build_cache.compile_counters()["backend_compiles"]
                                     - compiles_seg)
                server = None
            if server is None:
                if t == kill_at + down_ticks:
                    server = build(metrics)
                    server.checkpointer.restore(server, {
                        (h.group, h.slot): {"session": make_synctest(),
                                            "local_inputs": _inputs_for(m)}
                        for m, h in handle_of.items()})
                    compiles_seg = build_cache.compile_counters()["backend_compiles"]
                    prev_lanes = set()
                    prev_obs = len(metrics.series.get("slot_recovery_frames", ()))
                    post = {(e["handle"].group, e["handle"].slot): e["frame"]
                            for e in server.snapshot_matches()}
                    per_class["server_kill_restart"] = [
                        float(pre_kill[k] - post[k] + down_ticks) for k in pre_kill]
                else:
                    clk[0] += 1.0 / 60.0
                    continue
            t0 = time.perf_counter()
            server.run_frame()
            _sync()
            times.append(((time.perf_counter() - t0) * 1000.0, len(server._lanes)))
            cur = set(server._lanes)
            obs = metrics.series.get("slot_recovery_frames", ())
            if len(obs) > prev_obs:
                fresh = [h for h in prev_lanes - cur if h in server._matches]
                for h, v in zip(fresh, obs[prev_obs:]):
                    reason = server._matches[h].fsm.last_reason
                    per_class.setdefault(reason, []).append(float(v))
                prev_obs = len(obs)
            prev_lanes = cur
            clk[0] += 1.0 / 60.0
        churn_recompiles += build_cache.compile_counters()["backend_compiles"] - compiles_seg
        return server, metrics, times, per_class, churn_recompiles

    try:
        _, _, base_times, _, _ = run(chaos=False)
        server, metrics, times, per_class, churn_recompiles = run(chaos=True)
        healthy = [ms for ms, lanes in times if lanes == 0]
        fenced = [ms for ms, lanes in times if lanes > 0]
        base_p50 = float(np.percentile([ms for ms, _ in base_times], 50))
        healthy_p50 = float(np.percentile(healthy, 50))
        duty = sum(lanes for _, lanes in times) / float(S * len(times))
        all_healthy = all(server.health_of(h) is SlotHealth.HEALTHY for h in server._matches)
        recovery_cols = {}
        for reason, vals in sorted(per_class.items()):
            recovery_cols[f"recovery_p50_frames_{reason}"] = float(np.percentile(vals, 50))
            recovery_cols[f"recovery_p99_frames_{reason}"] = float(np.percentile(vals, 99))
            recovery_cols[f"recovery_events_{reason}"] = len(vals)
        td = _bench_trace_dir(f"serve_chaos_S{S}")
        if td is not None:
            server.export_telemetry(td, prefix=f"serve_chaos_S{S}")
        return _entry(
            f"serve_chaos_S{S}", healthy_p50, S, B, rtt_ms=rtt0,
            value_source="wall p50 of a healthy server frame (synchronized)",
            sessions=S, model="box_game", ticks=len(times),
            tick_p50_healthy_ms=round(healthy_p50, 4),
            tick_p50_fault_window_ms=(round(float(np.percentile(fenced, 50)), 4)
                                      if fenced else None),
            baseline_tick_p50_ms=round(base_p50, 4),
            healthy_tick_delta_ms=round(healthy_p50 - base_p50, 4),
            quarantine_duty_cycle=round(duty, 6),
            faults_total=int(metrics.counters.get("slot_faults", 0)),
            readmissions_total=int(metrics.counters.get("slot_readmissions", 0)),
            evictions_total=int(metrics.counters.get("slot_evictions", 0)),
            all_slots_healthy=bool(all_healthy),
            churn_recompiles=int(churn_recompiles),
            **recovery_cols,
            notes=("3 session crashes + 2 watchdog-fenced hangs + 1 server kill-restart "
                   f"(checkpoint interval 60f, 12f down) over {len(times)} driven frames; "
                   "per-class recovery is frames from fault to bitwise readmission; gated "
                   "on zero evictions and churn_recompiles == 0; baseline and chaos run in "
                   "one process"),
        )
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _serve_sdc_case(S: int) -> dict:
    """The silent-data-corruption lifecycle under load: single-bit ring
    flips into a batched server, each detected by the digest sweep and
    repaired bitwise in place, and a 2-peer P2P match under a corrupting
    wire whose flipped datagrams are dropped on their CRC."""
    from bevy_ggrs_tpu_torch import integrity
    from bevy_ggrs_tpu_torch.chaos import ChaosPlan, ChaosSocket, Corrupt
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.serve import MatchServer, SlotHealth
    from bevy_ggrs_tpu_torch.session import (
        PlayerType,
        PredictionThreshold,
        SessionBuilder,
        SessionState,
    )
    from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
    from bevy_ggrs_tpu_torch.utils import build_cache
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P, MAXPRED, B, F = 2, 4, 8, 3
    ATTEST = 4
    dev = _dev()
    ticks = max(int(os.environ.get("GGRS_SERVE_TICKS", "240") or "240"), 240)
    inject_target = 8
    rtt0 = host_device_rtt_ms()
    sdc_rng = np.random.RandomState(0x5DC)
    make_synctest = _synctest_maker(P, MAXPRED)
    clk = [0.0]
    metrics = Metrics()
    server = MatchServer(
        box_game.make_schedule(), box_game.make_world(P, device=dev).commit(), MAXPRED, P,
        box_game.INPUT_SPEC, num_branches=B, spec_frames=F, capacity=S, stagger_groups=4,
        metrics=metrics, clock=lambda: clk[0], attest_interval=ATTEST, device=dev)
    server.warmup()
    handle_of = {m: server.add_match(make_synctest(), _inputs_for(m)) for m in range(S)}

    def inject(m):
        """Flip one checksum-covered bit in match m's ring row holding
        frame-3: below the SyncTest's reload depth, and resident until this
        tick's sweep."""
        h = handle_of[m]
        if h in server._lanes:
            return False
        core = server.groups[h.group]
        s = core.slots[h.slot]
        if not s.active or s.frame < 3:
            return False
        frames_h = core.rings.frames[h.slot].cpu().numpy()
        rows = np.flatnonzero(frames_h == s.frame - 3)
        if rows.size == 0:
            return False
        core.rings, _ = integrity.flip_ring_bit(core.rings, int(rows[0]), sdc_rng,
                                                slot=h.slot)
        return True

    sdc_injected = 0
    compiles_seg = None
    tick_ms = []  # (ms, sweep tick)
    for t in range(ticks):
        if t == 16:
            # Admission and warmup are over: nothing past here may build.
            compiles_seg = build_cache.compile_counters()["backend_compiles"]
        if t >= 40 and sdc_injected < inject_target and server.frames_served % ATTEST == 0:
            if inject((sdc_injected * 11) % S):
                sdc_injected += 1
        t0 = time.perf_counter()
        server.run_frame()
        _sync()
        tick_ms.append(((time.perf_counter() - t0) * 1000.0,
                        server.frames_served % ATTEST == 0))
        clk[0] += 1.0 / 60.0
    churn_recompiles = build_cache.compile_counters()["backend_compiles"] - compiles_seg
    all_healthy = all(server.health_of(h) is SlotHealth.HEALTHY for h in server._matches)
    repair_frames = [float(v) for v in metrics.series.get("sdc_repair_frames", ())]

    # The wire: a 2-peer P2P match under a Corrupt window.
    net = LoopbackNetwork()
    plan = ChaosPlan(0x5DC, (Corrupt(0.3, 4.0, 0.10),))
    wire_metrics = Metrics()
    peers = []
    for me in range(2):
        sock = ChaosSocket(net.socket(("peer", me)), plan, clock=lambda: net.now,
                           addr=("peer", me))
        builder = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
                   .with_max_prediction_window(MAXPRED))
        for h in range(P):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(("peer", h)), h)
        session = builder.start_p2p_session(sock, clock=lambda: net.now)
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(P, device=dev).commit(),
                                max_prediction=MAXPRED, num_players=P,
                                input_spec=box_game.INPUT_SPEC,
                                metrics=wire_metrics if me == 0 else None, device=dev)
        runner.warmup()
        peers.append((session, runner))
    desyncs = 0
    for _ in range(400):
        net.advance(1.0 / 60.0)
        for session, runner in peers:
            flush = getattr(runner, "flush_reports", None)
            if flush is not None:
                flush(session)
            session.poll_remote_clients()
            for ev in session.events():
                if ev.kind.name == "DESYNC_DETECTED":
                    desyncs += 1
            if session.current_state() != SessionState.RUNNING:
                continue
            for h in session.local_player_handles():
                session.add_local_input(h, np.uint8((session.current_frame // 3 + h) % 4))
            try:
                runner.handle_requests(session.advance_frame(), session)
            except PredictionThreshold:
                continue
    data_crc_drops = sum(ep.data_crc_drops for session, _ in peers
                         for ep in session._endpoints.values())
    corrupted_sends = sum(1 for session, _ in peers
                          for _, kind, _ in session.socket.faults if kind == "corrupt")
    healthy = [ms for ms, sweep in tick_ms[16:] if not sweep]
    sweeps = [ms for ms, sweep in tick_ms[16:] if sweep]
    healthy_p50 = float(np.percentile(healthy, 50))
    return _entry(
        f"serve_sdc_S{S}", healthy_p50, S, B, rtt_ms=rtt0,
        value_source="wall p50 of a server frame without a sweep (synchronized)",
        sessions=S, model="box_game", ticks=len(tick_ms),
        tick_p50_healthy_ms=round(healthy_p50, 4),
        tick_p50_sweep_ms=round(float(np.percentile(sweeps, 50)), 4),
        attest_interval=ATTEST,
        sdc_injected=int(sdc_injected),
        sdc_detected=int(metrics.counters.get("sdc_detected", 0)),
        sdc_repaired=int(metrics.counters.get("sdc_repaired", 0)),
        sdc_repaired_bitwise=int(metrics.counters.get("sdc_repaired_bitwise", 0)),
        sdc_unrepairable=int(metrics.counters.get("sdc_unrepairable", 0)),
        repair_frames_p50=(round(float(np.percentile(repair_frames, 50)), 2)
                           if repair_frames else None),
        repair_frames_p99=(round(float(np.percentile(repair_frames, 99)), 2)
                           if repair_frames else None),
        data_crc_drops=int(data_crc_drops),
        corrupted_sends=int(corrupted_sends),
        desyncs=int(desyncs + wire_metrics.counters.get("desyncs_detected", 0)),
        matches_lost=int(server.evictions_total),
        all_slots_healthy=bool(all_healthy),
        churn_recompiles=int(churn_recompiles),
        notes=(f"{sdc_injected} single-bit ring flips injected sweep-aligned into {S} "
               f"batched SyncTest matches (attest_interval {ATTEST}), each detected and "
               "repaired bitwise in place; the wire segment runs a 2-peer P2P match under "
               "Corrupt(10%) for 400 frames, its flipped datagrams dropped on their CRC"),
    )


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

# Configs of the JAX bench that wait for modules the port lacks.
WAITING = {
    "boids_1k_8f_x_128b_xla": "parallel/sharding.py (boids' kernel='xla')",
    "live_multihost_2proc_spmd": "parallel/multihost.py",
    "relay_fanout_64spec": "relay/ client, server, stream",
    "relay_tree_1k": "relay/tree.py",
    "fleet_migrate_S64": "fleet/",
    "front_door_S256": "fleet/",
    "fleet_autoscale_*": "fleet/",
}


def all_configs() -> list:
    return (list(_CONFIGS) + list(_RECOVERY_CONFIGS) + list(_LIVE_CONFIGS)
            + list(_EIGHTP_CONFIGS) + list(_SERVE_CONFIGS) + list(_SERVE_CHAOS_CONFIGS)
            + list(_SERVE_SDC_CONFIGS))


def run_config(name: str) -> dict:
    if name in _RECOVERY_CONFIGS:
        return recovery_case(*_RECOVERY_CONFIGS[name])
    if name in _LIVE_CONFIGS:
        return _live_session_case(*_LIVE_CONFIGS[name])
    if name in _EIGHTP_CONFIGS:
        return _live_8p_spectator_case(*_EIGHTP_CONFIGS[name])
    if name in _SERVE_CONFIGS:
        return _serve_batched_case(*_SERVE_CONFIGS[name])
    if name in _SERVE_CHAOS_CONFIGS:
        return _serve_chaos_case(_SERVE_CHAOS_CONFIGS[name])
    if name in _SERVE_SDC_CONFIGS:
        return _serve_sdc_case(_SERVE_SDC_CONFIGS[name])
    if name in _CONFIGS:
        case, frames, branches = _CONFIGS[name]
        return measure_rollout(name, case, frames, branches)
    waiting = next((why for pat, why in WAITING.items()
                    if name == pat or (pat.endswith("*") and name.startswith(pat[:-1]))), None)
    if waiting:
        raise NotImplementedError(f"{name} waits for the port's {waiting}")
    raise KeyError(f"unknown config {name!r}")


def _write_detail(platform, detail, path=None) -> str:
    path = path or os.path.join(ROOT, DETAIL_FILE)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"platform": platform, "budget_ms": BUDGET_MS, "configs": detail}, f,
                  indent=2)
    os.replace(tmp, path)
    return path


def run_matrix(names=None, out=None) -> list:
    """Every config (headline first), one subprocess each; the rows are
    written to ``BENCH_TORCH_DETAIL.json`` (or ``out``) after every config."""
    detail, platform = [], None
    for name in names or all_configs():
        cmd = [sys.executable, os.path.abspath(__file__), "--config", name,
               "--device", _dev().type]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if proc.stderr.strip():
            print(proc.stderr.rstrip()[-2000:], file=sys.stderr)
        if proc.returncode != 0:
            print(f"bench_torch[{name}]: FAILED (rc {proc.returncode})", file=sys.stderr)
            continue
        e = json.loads(proc.stdout.strip().splitlines()[-1])
        platform = platform or e.get("platform")
        detail.append(e)
        aux = ""
        if "sustained_ms" in e:
            aux = f" (latency {e['latency_ms']:.4f} / sustained {e['sustained_ms']:.4f} ms)"
        elif "recovery_p99_ms" in e:
            aux = f" (p50 {e['recovery_p50_ms']:.4f} / p99 {e['recovery_p99_ms']:.4f} ms)"
        print(f"bench_torch[{name}]: {e['value']:.4f} ms, {e['vs_baseline']}x budget{aux} "
              f"[{e.get('platform')}; {e.get('card')}]", file=sys.stderr, flush=True)
        _write_detail(platform, detail, out)
    return detail


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--config", default=None, help="run one config, print its row")
    ap.add_argument("--all", action="store_true", help="run every config, one process each")
    ap.add_argument("--out", default=None,
                    help=f"with --all: the detail file (default {DETAIL_FILE})")
    ap.add_argument("--trace-dir", default=None,
                    help="per-config telemetry under DIR/<config>/")
    args = ap.parse_args(argv)
    try:
        set_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    if args.trace_dir:
        os.environ["GGRS_TRACE_DIR"] = os.path.abspath(args.trace_dir)
    if args.config:
        print(f"bench_torch: running {args.config} on {_dev()} ({_card()})", file=sys.stderr)
        print(json.dumps(run_config(args.config)))
        return 0
    if args.all:
        # The parent stays off the card: every config measures in its own
        # process.
        names = all_configs()
        detail = run_matrix(names, args.out)
        headline = next((e for e in detail if e["metric"] == HEADLINE),
                        detail[-1] if detail else None)
        failed = len(names) - len(detail)
    else:
        headline, failed = run_headline(), 0
    if headline is not None:
        print(json.dumps({k: headline[k] for k in ("metric", "value", "unit", "vs_baseline")}))
    if failed:
        print(f"bench_torch: {failed} config(s) failed", file=sys.stderr)
    return 1 if failed or headline is None else 0


if __name__ == "__main__":
    sys.exit(main())
