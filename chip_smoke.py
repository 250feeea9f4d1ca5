#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the rollback engine on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device and build: the card's name and power limit, then the five CUDA
   kernels built from ``bevy_ggrs_tpu_torch/csrc`` (one ``nvcc`` each, all
   started together), with ptxas's register and shared-memory report.
2. Checksum kernel against its plain versions on the card, bitwise, in
   its three modes: random worlds (bool, u8, i16, f16, i32, f32, i64 and
   f64 components, more than 64 words a slot, nested resources with 2-
   and 8-byte leaves) at capacities 37, 600, 1,000, 1,024, 32,768 and
   40,000 (clusters of 1 and 8 blocks), as single worlds, a ``[5]`` ring
   and a ``[2, 5]`` stack; the save mode's ring rows, frames, digests and
   output; the guard on a clean row, a corrupted one and a frame that is
   not resident; a component that is not slot-major (copied by the
   wrapper, the copy counted); a world of 202 parts, and one of 302
   refused. Under
   ``torch.profiler``, ``ring_save``, ``checksum`` and ``verify_row`` each
   run one CUDA kernel and no host-to-device copy.
3. Force kernel against its plain version on the card: N in {1000, 1024,
   4096}, a row subset, a single row, five rows, 20 boids (fewer than a
   warp's 32 lanes) and 4,100 (a ragged last column tile and row block),
   within ``atol=2e-6``; a second launch on the same inputs is bitwise
   equal to the first.
4. box_game SyncTest on ``cuda`` through ``GGRSPlugin``: 2 players,
   ``check_distance`` 7, 300 frames, no ``MismatchedChecksum``, and its
   checksum stream bitwise equal to the same run's on the CPU; the
   checksum kernel ran exactly once per save and once per restore guard.
5. boids SyncTest on ``cuda``: a 1,024-boid flock, 2 players,
   ``check_distance`` 7, 120 frames, no mismatch; the force kernel ran once
   per advanced frame and the checksum kernel once per save and guard. Its
   first frames agree with the plain CPU path within ``atol=1e-5``.
6. Tensor-core force kernels against their plain versions on the card,
   on spawn-spiral flocks with every 7th boid inactive: the general kernel
   at (R, N) = (1,024, 1,024), (1,000, 1,000), rows 256..512 of 1,024,
   (1, 1,024), (65, 1,000), (1,024, 64), (1,024, 65), (1,024, 4,100) and
   (4,096, 4,096), which take clusters of 1 to 8 blocks, ragged row blocks
   and a ragged last column tile; the triangle at N = 20 and 64 (one
   diagonal tile, ragged or full), 65, 1,000, 4,096 and 4,100 (a ragged
   last strip); within ``1e-4`` of the largest force; and on uniform random flocks,
   whose near-coincident pairs amplify the hi/lo rounding, within ``1e-3``
   of it. A second launch is bitwise equal to the first.
7. Cell kernel against its plain version on the card, on the
   boids-32,768 grid tables, on a clustered 600-boid grid that spills, and
   on random cells with half of the rows and candidates inactive inside
   their lists, one cell without a live candidate and one without a live
   row, within ``atol=1e-5``, bitwise from launch to launch, with the
   pairs computed (live rows times live candidates) printed; the clustered
   grid's forces within ``1e-5`` of the dense f32 forces; a pair kernel
   without an instantiation is refused. Binning on ``cuda`` is bitwise
   equal to binning on the CPU at 32,768 boids.
8. boids SyncTests at entity scale on ``cuda``, ``check_distance`` 7, no
   mismatch: 1,024 boids with ``kernel="mxu"`` (120 frames, the general
   tensor-core kernel), 4,096 with ``kernel="mxu"`` (60 frames, the
   triangle) and 32,768 with ``kernel="mxu", mode="grid"`` (60 frames, the
   cell kernel). The path's kernel ran once per advanced frame, no other
   force kernel ran, and the checksum kernel ran once per save and guard
   (the contiguity copies its wrapper made are printed); one step agrees with the plain version (on the CPU
   for the dense runs, on the card for the grid) within ``1e-4``, as the
   JAX suite holds one mxu step; the
   grid's statistics are printed at the first and the last frame.
9. Times with CUDA events: each kernel and its plain version at the main
   path's shapes, on the device alone (a CUDA graph of many calls,
   replayed) and per call with the host's work, beside the least time the
   card could take for the same work (the checksum in each of its three
   modes, at 1,024 and at 32,768 boids); the main path's pieces around the
   kernels; the triangle's tile pass and combine apart (device time under
   ``torch.profiler``); the per-tick times of phases 4, 5 and 8; and, under
   ``torch.profiler``, the device's busy time per tick of the boids
   SyncTests, continued for 8 more ticks after their counts were read.

The kernel counters are set to 0 just before each SyncTest of phases 4, 5
and 8 and read just after; launches made to compare a kernel with its
plain version are not counted. The last three lines are the kernel table
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
PEAK_BF16_TC_PER_S = 989e12  # dense bf16 on the tensor cores

CHECKSUM_OPS_PER_WORD = 2 * 11  # both lanes: 3 mul, 2 rotate (3 ops each), xor, add
FMIX_OPS = 2 * 8
FORCE_OPS_PER_PAIR = 30  # 26 float ops, 3 compares and one rsqrt per pair
# Tensor-core kernels, per pair: the masks on the CUDA cores (2 subtracts,
# 2 multiplies and an add for d2, 3 compares, 2 ands, rsqrt, select, 3
# conversions to bf16, one back and a subtract for the lo half: 18), and
# the useful products on the tensor cores (2 flops x (10 + 6 + 6) feature
# rows: 44).
MXU_MASK_OPS_PER_PAIR = 18
MXU_TC_FLOPS_PER_PAIR = 44
FORCE_ATOL = 2e-6
BOIDS_ATOL = 1e-5
# The tensor-core kernels and their plain versions multiply the same bf16
# operands, whose products are exact in f32; they differ only in the order
# and rounding of the f32 sums, which the separation's rpx·Σw − Σw·cpx
# cancellation amplifies. On spawn-spiral flocks (the main path's data)
# that stays under 1e-4 of the largest force; a uniform random flock has
# near-coincident pairs whose 1/d weights reach 1e4, and there the bound
# is the JAX suite's own class for these kernels, 1e-3.
MXU_RTOL = 1e-4
MXU_RANDOM_RTOL = 1e-3
# One step of a boids schedule against its plain version: the JAX suite's
# one-step tolerance for the mxu path against XLA (tests/test_ops.py:290).
# The speed clamp rescales near-zero velocities to MIN_SPEED, magnifying
# the force paths' ~1e-6 (tensor cores) or ~3e-7 (cell kernel) difference
# to ~1e-5.
STEP_ATOL = 1e-4
# The cell kernel and its plain version sum the same f32 terms in another
# order (and CUDA's rsqrtf): the JAX suite's grid tolerance.
CELL_ATOL = 1e-5
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
    "short": ((2,), np.int16, torch.int16),
    "half": ((), np.float16, torch.float16),
    "long": ((), np.int64, torch.int64),
    "double": ((2,), np.float64, torch.float64),
}
# Capacities: ragged, the main path's 1,024, one block's limit passed
# (1,000 against 1,024 threads), the grid world's 32,768 (a cluster of 8,
# four slots a thread) and 40,000 (the largest cluster, a second chunk).
CHECKSUM_CAPS = (37, 600, 1000, 1024, 32768, 40000)
CHECKSUM_DEPTH, CHECKSUM_STACK = 5, 2


def random_registry(ts):
    reg = ts.TypeRegistry()
    for name, (shape, _, tdt) in COMPONENTS.items():
        reg.register_component(name, shape, tdt)
    reg.register_resource("frame_count", np.uint32(0))
    reg.register_resource("multi", {"a": np.zeros(3, np.float32),
                                    "b": (np.int32(0), np.zeros((2, 2), bool)),
                                    "c": np.zeros(2, np.int16)})
    reg.register_resource("wide", np.zeros(2, np.int64))
    return reg


def random_host(seed: int, cap: int) -> dict:
    rng = np.random.RandomState(seed)
    alive = rng.rand(cap) < 0.7
    comps = {}
    for name, (shape, dt, _) in COMPONENTS.items():
        if dt == np.bool_:
            comps[name] = rng.rand(cap, *shape) < 0.5
        elif np.issubdtype(dt, np.floating):
            comps[name] = rng.randn(cap, *shape).astype(dt)
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
                            rng.rand(2, 2) < 0.5),
                      "c": rng.randint(-2**15, 2**15, size=2).astype(np.int16)},
            "wide": rng.randint(-2**62, 2**62, size=2, dtype=np.int64),
        },
    }


def same_bytes(a, b) -> bool:
    """Two tensors with the same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def world_leaves(ts, state) -> list:
    """Every tensor of a world state."""
    return ts.tree_leaves([state.alive, state.rollback_id, state.components,
                           state.present, state.resources])


def clone_ring(ts, ring):
    return ts.SnapshotRing(states=ts.tree_map(torch.clone, ring.states),
                           frames=ring.frames.clone(), checksums=ring.checksums.clone())


def check_checksum_kernel(ts, tck, integrity) -> None:
    """The kernel against its plain versions, bitwise, in all three modes."""
    reg = random_registry(ts)
    depth, S = CHECKSUM_DEPTH, CHECKSUM_STACK
    for cap in CHECKSUM_CAPS:
        hosts = [random_host(1000 * cap + seed, cap) for seed in range(S * depth)]
        gpu = [ts.from_host(reg, h, device="cuda") for h in hosts]
        lay = tck.layout(gpu[0])
        for h, g in zip(hosts[:2], gpu[:2]):  # B = 1, against the cpu too
            got = tck.checksum(g)
            check(torch.equal(got, tck.checksum_plain(g)), f"checksum cap={cap}: B=1")
            check(torch.equal(got.cpu(), ts.checksum(ts.from_host(reg, h, device="cpu"))),
                  f"checksum cap={cap}: B=1 against the cpu")
        ring_rows = ts.tree_map(lambda *xs: torch.stack(xs), *gpu[:depth])
        check(torch.equal(tck.checksum(ring_rows), tck.checksum_plain(ring_rows)),
              f"checksum cap={cap}: a [{depth}] ring")
        stack = ts.tree_map(lambda *xs: torch.stack(xs).reshape((S, depth) + xs[0].shape), *gpu)
        check(torch.equal(tck.checksum(stack), tck.checksum_plain(stack)),
              f"checksum cap={cap}: an [{S}, {depth}] stack")
        # Save mode: rows, frames, digests and the caller's out against the
        # plain sequence on a twin ring; two rounds over the rows.
        ring = ts.ring_init(gpu[-1], depth)
        twin = clone_ring(ts, ring)
        outs = torch.zeros((2 * depth, 2), dtype=torch.int64, device="cuda")
        twin_outs = outs.clone()
        for frame in range(2 * depth):
            w = gpu[frame % len(gpu)]
            _, got = ts.ring_save(ring, w, frame, out=outs[frame])
            want = tck.save_plain(twin, w, frame, out=twin_outs[frame])
            check(torch.equal(got, want), f"save cap={cap} frame={frame}: lanes")
        check(all(same_bytes(a, b) for a, b in zip(world_leaves(ts, ring.states),
                                                   world_leaves(ts, twin.states))),
              f"save cap={cap}: ring rows")
        check(torch.equal(ring.frames, twin.frames) and torch.equal(ring.checksums, twin.checksums)
              and torch.equal(outs, twin_outs), f"save cap={cap}: frames, digests, out")
        # Guard mode: clean, corrupted and not resident.
        frame = 2 * depth - 2
        row = frame % depth
        clean = integrity.verify_row(ring, frame)
        corrupt, info = integrity.flip_ring_bit(ring, row, np.random.RandomState(cap))
        flagged = integrity.verify_row(corrupt, frame)
        stale = integrity.verify_row(corrupt, frame - depth)
        check(clean and not flagged and stale,
              f"guard cap={cap}: clean {clean}, corrupt {flagged} ({info}), not resident {stale}")
        for r, f in ((ring, frame), (corrupt, frame), (corrupt, frame - depth)):
            check(torch.equal(tck.world_checksum(None, "guard", ring=r, frame=f),
                              tck.guard_plain(r, f)), f"guard cap={cap} frame={f}: plain")
        # A part that is not slot-major is copied (and counted), and the
        # copy lives until the launch has read it.
        strided = gpu[0].replace(components={
            **gpu[0].components, "pos": gpu[0].components["pos"].t().contiguous().t()})
        copies = tck.world_checksum.copies
        ring = ts.ring_init(gpu[0], depth)
        twin = clone_ring(ts, ring)
        check(torch.equal(tck.checksum(strided), tck.checksum_plain(gpu[0]))
              and torch.equal(ts.ring_save(ring, strided, 1)[1], tck.save_plain(twin, gpu[0], 1))
              and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, ring.states),
                                                       world_leaves(ts, twin.states))),
              f"checksum cap={cap}: a part that is not slot-major")
        check(tck.world_checksum.copies == copies + 2, f"checksum cap={cap}: contiguity copies")
        P, threads = tck.launch_shape(cap)
        print(f"checksum cap={cap} parts={len(lay.parts)} cluster {P} x {threads} threads: "
              f"B=1, a [{depth}] ring, an [{S}, {depth}] stack, save (ring rows, frames, "
              f"digests, out), guard (clean, corrupt {info['field']}, not resident), a "
              f"part that is not slot-major (copied): bitwise equal to the plain version")


def check_many_parts(ts, tck) -> None:
    """Worlds of 202 parts (the largest parameter struct) and of 302 (over
    the limit, refused on the card)."""
    rng = np.random.RandomState(7)
    kinds = [(torch.int8, np.int8), (torch.int16, np.int16), (torch.float32, np.float32),
             (torch.int64, np.int64)]
    for n_comps, fits in ((100, True), (150, False)):
        reg = ts.TypeRegistry()
        for i in range(n_comps):
            reg.register_component(f"c{i:03d}", (1 + i % 3,), kinds[i % 4][0])
        host = ts.to_host(ts.init_state(reg, 37, device="cpu"))
        host["alive"][:] = rng.rand(37) < 0.8
        for i, name in enumerate(sorted(host["components"])):
            a = host["components"][name]
            host["components"][name] = rng.randint(-100, 100, size=a.shape).astype(a.dtype)
            host["present"][name][:] = rng.rand(37) < 0.5
        world = ts.from_host(reg, host, device="cuda")
        if not fits:
            try:
                tck.checksum(world)
            except ValueError as e:
                check(f"limit of {tck.MAX_PARTS}" in str(e), f"over the limit: {e}")
                print(f"a world of {2 * n_comps + 2} parts is refused on the card: {e}")
                continue
            check(False, f"a world of {2 * n_comps + 2} parts was not refused")
        ring_rows = ts.tree_map(lambda x: torch.stack([x, x.flip(0)]), world)
        check(torch.equal(tck.checksum(world), tck.checksum_plain(world))
              and torch.equal(tck.checksum(ring_rows), tck.checksum_plain(ring_rows)),
              f"checksum of {len(tck.layout(world).parts)} parts")
        check(torch.equal(tck.checksum(world).cpu(), ts.checksum(ts.from_host(reg, host, device="cpu"))),
              "checksum of many parts against the cpu")
        print(f"checksum of {len(tck.layout(world).parts)} parts (cap 37, B=1 and B=2): "
              f"bitwise equal to the plain version and the cpu")


def device_work(fn) -> dict:
    """The CUDA kernels and copies one call of ``fn`` runs, under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": [n for n in names if not n.startswith(("Memcpy", "Memset"))],
            "h2d": [n for n in names if "HtoD" in n],
            "d2h": [n for n in names if "DtoH" in n]}


def check_one_launch(ts, tck, integrity, boids) -> None:
    """``ring_save``, ``checksum`` and ``verify_row`` each run one CUDA
    kernel and copy nothing to the device; the guard reads back 4 bytes."""
    state = boids.make_world(1024, 2, device="cuda").commit()
    ring = ts.ring_init(state, 9)
    ts.ring_save(ring, state, 3)
    for name, fn, d2h in (("ring_save", lambda: ts.ring_save(ring, state, 3), 0),
                          ("checksum", lambda: tck.checksum(state), 0),
                          ("verify_row", lambda: integrity.verify_row(ring, 3), 1)):
        work = device_work(fn)
        check(len(work["kernels"]) == 1 and not work["h2d"] and len(work["d2h"]) == d2h,
              f"{name} under the profiler: {work}")
        print(f"{name} (boids-1,024) under torch.profiler: 1 CUDA kernel "
              f"({work['kernels'][0][:60]}), 0 host-to-device copies, "
              f"{len(work['d2h'])} device-to-host copies"
              + (" (the guard's int32 flag, 4 bytes)" if d2h else ""))


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


# The f32 kernel's cases: (boids, row boids). Beside the main path's square
# case they cover a row subset, one row (a block of one warp), five rows,
# fewer columns than a warp has lanes, and N = 4,100: a ragged last
# column tile (1,024 a tile) and a ragged last block of 8 rows.
FORCE_CASES = (
    (1000, slice(0, 1000)), (1024, slice(0, 1024)), (4096, slice(0, 4096)),
    (1024, slice(256, 512)), (1024, slice(1, 2)), (1024, slice(1, 6)),
    (20, slice(0, 20)), (4100, slice(0, 4100)),
)


def check_force_kernel(tpw, params) -> float:
    worst = 0.0
    for n, rows in FORCE_CASES:
        pos, vel, act = flock_inputs(n, seed=n)
        args = (pos[rows].contiguous(), vel[rows].contiguous(), pos, vel,
                act[rows].contiguous(), act)
        a = tpw.pairwise_force_rows(*args, **params)
        b = tpw.pairwise_force_rows_plain(*args, **params)
        c = tpw.pairwise_force_rows(*args, **params)
        torch.cuda.synchronize()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= FORCE_ATOL, f"forces N={n} rows={rows}: error {err}")
        check(torch.equal(a, c), f"forces N={n} rows={rows}: launch to launch")
        check(scale > 1e-3, f"forces N={n} rows={rows}: all near zero")
        worst = max(worst, err)
        w, blocks = tpw.force_rows_launch_shape(args[0].shape[0])
        print(f"forces N={n} rows={rows.start}:{rows.stop} ({blocks} blocks of {w} rows) "
              f"max_abs_err={err:.3e} (atol {FORCE_ATOL}, largest force {scale:.4f}) "
              f"repeat bitwise")
    return worst


# ---------------------------------------------------------------------------
# Phase 6: the tensor-core force kernels
# ---------------------------------------------------------------------------


def spiral_flock(boids, n: int):
    """The main path's data: ``make_world``'s spawn spiral, every 7th boid
    inactive."""
    state = boids.make_world(n, 2, device="cuda").commit()
    active = torch.ones(n, device="cuda")
    active[::7] = 0.0
    return state.components["position"], state.components["velocity"], active


def held(name: str, a, b, again, rtol: float) -> float:
    """Check kernel output ``a`` against plain ``b`` within ``rtol`` of the
    largest force and bitwise against its repeat ``again``; returns the
    error."""
    torch.cuda.synchronize()
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    check(scale > 1e-3, f"{name}: forces all near zero")
    check(err <= rtol * scale, f"{name}: error {err} over {rtol} x {scale}")
    check(torch.equal(a, again), f"{name}: launch to launch")
    print(f"{name}: max_abs_err={err:.3e} (limit {rtol} x scale {scale:.4f}) "
          f"repeat bitwise")
    return err


# The general kernel's cases: (boids in the flock, its row boids, its first
# N boids as the columns). Beside the main path's square case they cover a
# single row, ragged row blocks, fewer columns than rows, one column tile
# and two (clusters of 1 and 2 blocks), a ragged last tile with a tile
# count that the cluster size does not divide (N = 4,100: 65 tiles over 8
# blocks) and a cluster of 4 (4,096).
MXU2_CASES = (
    (1024, slice(0, 1024), 1024), (1000, slice(0, 1000), 1000),
    (1024, slice(256, 512), 1024), (1024, slice(1, 2), 1024),
    (1000, slice(0, 65), 1000), (1024, slice(0, 1024), 64),
    (1024, slice(0, 1024), 65), (4100, slice(0, 1024), 4100),
    (4096, slice(0, 4096), 4096),
)


# The triangle's cases: one diagonal tile, ragged (20) or full (64); two
# strips, the second of one boid (65); a ragged last strip of 16 (1,000)
# or 4 boids (4,100); and the main path's 4,096.
TRI_CASES = (20, 64, 65, 1000, 4096, 4100)


def check_mxu_kernels(tpw, boids, params) -> dict:
    worst = {"mxu2": 0.0, "tri": 0.0}
    for data, rtol in (("spiral", MXU_RTOL), ("random", MXU_RANDOM_RTOL)):
        def flock(n):
            return spiral_flock(boids, n) if data == "spiral" else flock_inputs(n, seed=n)

        for n, rows, n_cols in MXU2_CASES:
            pos, vel, act = flock(n)
            args = (pos[rows].contiguous(), vel[rows].contiguous(),
                    pos[:n_cols].contiguous(), vel[:n_cols].contiguous(),
                    act[rows].contiguous(), act[:n_cols].contiguous())
            p, row_blocks = tpw.mxu2_launch_shape(args[0].shape[0], n_cols)
            err = held(f"mxu2 {data} R={args[0].shape[0]} (rows {rows.start}:{rows.stop}) "
                       f"N={n_cols} cluster {p} x {row_blocks} row blocks",
                       tpw.pairwise_force_rows_mxu2(*args, **params),
                       tpw.pairwise_force_rows_mxu2_plain(*args, **params),
                       tpw.pairwise_force_rows_mxu2(*args, **params), rtol)
            worst["mxu2"] = max(worst["mxu2"], err)
        for n in TRI_CASES:
            pos, vel, act = flock(n)
            err = held(f"tri {data} N={n}",
                       tpw.pairwise_force_square_mxu_tri(pos, vel, act, **params),
                       tpw.pairwise_force_square_mxu_tri_plain(pos, vel, act, **params),
                       tpw.pairwise_force_square_mxu_tri(pos, vel, act, **params), rtol)
            worst["tri"] = max(worst["tri"], err)
    return worst


# ---------------------------------------------------------------------------
# Phase 7: the cell kernel and the binning
# ---------------------------------------------------------------------------


def grid_operands(tnb, boids, pos, vel, active, config):
    """The cell kernel's operands for a world, as ``slot_forces`` gathers
    them, and the binning."""
    grid, cand, padded = tnb.build_grid_tables(
        pos, active, config, {"vx": vel[:, 0], "vy": vel[:, 1]})
    kernel = boids.FLOCK_PAIR_KERNEL
    rowvals = {name: padded[name][grid.slots] for name in kernel.row_names}
    colvals = {name: padded[name][cand] for name in kernel.col_names}
    return grid, cand, rowvals, colvals


def live_pairs(rowvals, colvals) -> int:
    """The pairs the cell kernel computes: live rows times live candidates,
    summed over the cells."""
    rows = (rowvals["active"] != 0).sum(1)
    cols = (colvals["active"] != 0).sum(1)
    return int((rows * cols).sum())


def scattered_cells(seed: int):
    """Eight cells of the boids-32,768 grid's shape (K = 256, M = 2,816) and
    density (about 128 live rows and 1,400 live candidates a cell, over
    3 x 3 units), but with half of the rows and candidates inactive at
    random places in their lists; cell 3 has no live candidate and cell 5
    no live row."""
    rng = np.random.RandomState(seed)
    cells, k, m = 8, 256, 2816

    def feats(n):
        f = {"px": rng.uniform(-1.5, 1.5, (cells, n)), "py": rng.uniform(-1.5, 1.5, (cells, n)),
             "active": rng.rand(cells, n) < 0.5,
             "vx": rng.uniform(-0.05, 0.05, (cells, n)), "vy": rng.uniform(-0.05, 0.05, (cells, n))}
        return {name: torch.from_numpy(v.astype(np.float32)).cuda() for name, v in f.items()}

    rowvals, colvals = feats(k), feats(m)
    colvals["active"][3] = 0.0
    rowvals["active"][5] = 0.0
    return rowvals, colvals


def check_cell_kernel(tcg, tnb, boids) -> float:
    kernel = boids.FLOCK_PAIR_KERNEL
    worst = 0.0
    rng = np.random.RandomState(3)
    clustered = [torch.from_numpy(a).cuda() for a in (
        rng.uniform(-1.5, 1.5, size=(600, 2)).astype(np.float32),
        rng.uniform(-0.05, 0.05, size=(600, 2)).astype(np.float32),
        np.ones(600, np.float32))]
    big = boids.make_world(32768, 2, device="cuda").commit()
    worlds = {
        "boids-32768": (big.components["position"], big.components["velocity"],
                        big.alive.float(), boids.grid_config(32768)),
        "clustered-600": (*clustered, boids.grid_config(600)),
    }
    operands = {}
    for name, (pos, vel, act, config) in worlds.items():
        grid, _, rowvals, colvals = grid_operands(tnb, boids, pos, vel, act, config)
        operands[name] = (rowvals, colvals,
                          f"C={config.num_cells} K={config.cell_capacity} M={config.padded_cols} "
                          f"spilled {int(grid.n_spilled)} dropped {int(grid.n_dropped)}")
    for seed in (5, 6):
        rowvals, colvals = scattered_cells(seed)
        operands[f"scattered-{seed}"] = (
            rowvals, colvals, "C=8 K=256 M=2816, half inactive inside the lists, "
            "cell 3 without live candidates, cell 5 without live rows")
    for name, (rowvals, colvals, about) in operands.items():
        a = tcg.cell_slot_forces(kernel, rowvals, colvals)
        b = tcg.cell_slot_forces_plain(kernel, rowvals, colvals)
        again = tcg.cell_slot_forces(kernel, rowvals, colvals)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(a, b))
        check(err <= CELL_ATOL, f"cell {name}: error {err}")
        check(all(torch.equal(x, y) for x, y in zip(a, again)),
              f"cell {name}: launch to launch")
        check(max(x.abs().max().item() for x in b) > 1e-3, f"cell {name}: all zero")
        if name.startswith("scattered"):
            check(all(x[5].abs().max().item() == 0 for x in a), f"cell {name}: dead cell 5")
        worst = max(worst, err)
        c, k = rowvals["px"].shape
        print(f"cell {name} {about}: max_abs_err={err:.3e} (atol {CELL_ATOL}) repeat "
              f"bitwise; pairs computed {live_pairs(rowvals, colvals)} of "
              f"{c * k * colvals['px'].shape[1]} in the tables")
    pos, vel, act, config = worlds["clustered-600"]
    feats = {"vx": vel[:, 0], "vy": vel[:, 1]}
    grid_f, g = tnb.interact(pos, act, kernel, feats, mode="grid", config=config,
                             impl="pallas", return_grid=True)
    dense_f = tnb.interact(pos, act, kernel, feats, mode="dense")
    err = (grid_f - dense_f).abs().max().item()
    check(int(g.n_spilled) > 0 and int(g.n_dropped) == 0, "clustered grid: no spill")
    check(err <= CELL_ATOL, f"clustered grid against dense: error {err}")
    print(f"clustered-600 grid forces (spill {int(g.n_spilled)}) within {err:.3e} "
          f"of dense (atol {CELL_ATOL})")
    unnamed = tnb.PairKernel(radius=1.0, out_dim=2, n_terms=7,
                             accumulate=kernel.accumulate, combine=kernel.combine,
                             row_feats=("vx", "vy"), col_feats=("vx", "vy"))
    try:
        tcg.cell_slot_forces(unnamed, rowvals, colvals)
    except ValueError as e:
        print(f"a pair kernel without an instantiation is refused: {e}")
    else:
        check(False, "the cell kernel ran a pair kernel it has no instantiation for")
    return worst


def check_binning(tnb, boids) -> None:
    rng = np.random.RandomState(4)
    n = 32768
    config = boids.grid_config(n)
    big = boids.make_world(n, 2, device="cuda").commit()
    random_active = torch.from_numpy(rng.rand(n) > 0.125)
    worlds = {
        "spawn spiral": (big.components["position"], big.alive),
        "uniform, 1/8 inactive": (
            torch.from_numpy(rng.uniform(-8, 8, size=(n, 2)).astype(np.float32)).cuda(),
            random_active.cuda()),
    }
    for name, (pos, act) in worlds.items():
        gpu = tnb.bin_entities(pos, act, config)
        cpu = tnb.bin_entities(pos.cpu(), act.cpu(), config)
        for field, a, b in zip(gpu._fields, gpu, cpu):
            check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                  f"binning {name}: {field} on cuda differs from the cpu's")
        print(f"binning {name} N={n}: cuda bitwise equal to cpu in "
              f"{', '.join(gpu._fields)}; spilled {int(gpu.n_spilled)}")


# ---------------------------------------------------------------------------
# Phases 4, 5 and 8: SyncTest sessions through GGRSPlugin
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


def boids_app(n: int, device, schedule=None):
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
        .with_rollback_schedule(schedule or boids.make_schedule())
        .with_num_players(2)
        .with_max_prediction_window(8)
        .with_world_capacity(n)
        .with_setup_system(lambda world, app: boids.spawn_flock(world, n, 2))
        .with_device(device)
        .build()
    )


def timings(label: str, kernel, plain, nbytes: int, ops: int = 0,
            peak_ops: float = PEAK_F32_PER_S, tc_flops: int = 0) -> dict:
    """The kernel's and its plain version's device time per call (CUDA
    graph replay) and the least time the card could take: the larger of
    ``nbytes`` over the memory rate, ``ops`` over ``peak_ops`` and
    ``tc_flops`` over the tensor cores' bf16 rate (the two kinds of
    operations run on separate units). The per-call time with the host's
    work included is printed beside them."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / peak_ops, tc_flops / PEAK_BF16_TC_PER_S) * 1e3
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
          f"bound {out['bound_ms']:.6f} ms ({out['bound_by']}: {nbytes} bytes, {ops} ops, "
          f"{tc_flops} tensor-core flops)")
    return out


def kernel_device_ms(fn, calls: int = 50) -> dict:
    """Device milliseconds a call of each CUDA kernel that ``fn`` launches,
    by kernel name, over ``calls`` calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return {name: us / 1e3 / calls for name, us in by_name.items()}


def device_busy(app, ticks: int = 8) -> dict:
    """Run ``ticks`` more updates of a SyncTest app under ``torch.profiler``
    and return, per tick, the wall milliseconds (profiler on), the device's
    busy milliseconds (the union of its kernel and copy intervals) and the
    device milliseconds of the four costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    now = app.frame * DT
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            now += DT
            app.update(now)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > 0, "the profiler saw no device activity")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for t_start, t_end, name in spans:
        busy_us += max(0.0, t_end - max(t_start, end))
        end = max(end, t_end)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (t_end - t_start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms_per_tick": wall_ms / ticks,
            "device_busy_ms_per_tick": busy_us / 1e3 / ticks,
            "busy_share": busy_us / 1e3 / wall_ms,
            "top_kernels_ms_per_tick": {k: v / 1e3 / ticks for k, v in top}}


def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "copies"):
            fn.copies = 0


def check_checksum_launches(label: str, tck, launches: dict, log: dict, runner) -> str:
    """The checksum kernel ran exactly once per save and once per restore
    guard (one per rollback); returns the line's words on it."""
    guards = runner.rollbacks_total if runner.verify_restores else 0
    got = launches["world_checksum"]
    check(got == log["saves"] + guards,
          f"{label}: {got} checksum launches, {log['saves']} saves + {guards} guards")
    return (f"checksum launches {got} = {log['saves']} saves + {guards} guards, "
            f"contiguity copies {tck.world_checksum.copies}")


def checksum_modes(ts, tck, integrity, state, depth: int) -> dict:
    """Each mode's device milliseconds a call (a CUDA graph of many calls,
    replayed), milliseconds a call with the host's work (CUDA events; the
    guard's includes its 4-byte read), and the least time the card could
    take: the world's own bytes (read once; a save writes them again) over
    the memory rate, or the hash's integer operations over live slots and
    resource words at the int32 rate, whichever is larger."""
    lay = tck.layout(state)
    nbytes = sum(p.row_bytes for p in lay.parts)
    words = sum(p.words for p in lay.parts if p.role not in (tck.ALIVE, tck.RESOURCE))
    ops = (int(state.alive.sum()) * (words * CHECKSUM_OPS_PER_WORD + FMIX_OPS)
           + lay.resource_words * (CHECKSUM_OPS_PER_WORD + FMIX_OPS))
    ring = ts.ring_init(state, depth)  # a scratch ring: the session's is not touched
    frame = 3
    ts.ring_save(ring, state, frame)
    modes = {
        # (device call, call with the host's work, bytes moved)
        "checksum": (lambda: tck.checksum(state), lambda: tck.checksum(state), nbytes + 16),
        "save": (lambda: ts.ring_save(ring, state, frame), lambda: ts.ring_save(ring, state, frame),
                 2 * nbytes + 2 * 16 + 4),
        "guard": (lambda: tck.world_checksum(None, "guard", ring=ring, frame=frame),
                  lambda: integrity.verify_row(ring, frame), nbytes + 16 + 4 + 4),
    }
    out = {"state_bytes": nbytes, "ops": ops}
    for mode, (device_fn, call_fn, moved) in modes.items():
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_I32_PER_S * 1e3
        out[mode] = {"ms": graph_ms(device_fn), "call_ms": cuda_ms(call_fn),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": moved}
    check(integrity.verify_row(ring, frame), "the timed guard found its row corrupt")
    return out


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
    from bevy_ggrs_tpu_torch import integrity
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import boids, box_game
    from bevy_ggrs_tpu_torch.ops import _build
    from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
    from bevy_ggrs_tpu_torch.ops import checksum as tck
    from bevy_ggrs_tpu_torch.ops import neighbor as tnb
    from bevy_ggrs_tpu_torch.ops import pairwise as tpw
    from bevy_ggrs_tpu_torch.rollout import advance_n
    from bevy_ggrs_tpu_torch.schedule import PlayerInputs, Schedule
    from bevy_ggrs_tpu_torch.session import SyncTestSession

    # The plain versions' f32 products run in full f32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    force_kernels = (tpw.pairwise_force_rows, tpw.pairwise_force_rows_mxu2,
                     tpw.pairwise_force_square_mxu_tri, tcg.cell_slot_forces)
    kernels = (tck.world_checksum,) + force_kernels
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
    check_checksum_kernel(ts, tck, integrity)
    check_many_parts(ts, tck)
    check_one_launch(ts, tck, integrity, boids)

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
    box_checksums = check_checksum_launches("box_game", tck, box_launches, logs["cuda"],
                                            box_app_gpu.stage.runner)
    print(f"box_game: {frames} frames, {logs['cuda']['saves']} saves, "
          f"{len(logs['cuda']['checksums'])} checksums bitwise equal to the cpu's, "
          f"launches {box_launches}, {box_checksums}")

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
    boids_checksums = check_checksum_launches("boids", tck, boids_launches, boids_log,
                                              flock.stage.runner)
    print(f"boids: {frames} frames, {boids_log['advances']} advances, "
          f"{boids_log['saves']} saves, launches {boids_launches}, {boids_checksums}")

    phase("6 tensor-core force kernels against their plain versions")
    mxu_err = check_mxu_kernels(tpw, boids, params)

    phase("7 cell kernel against its plain version, and the binning")
    cell_err = check_cell_kernel(tcg, tnb, boids)
    check_binning(tnb, boids)

    phase("8 boids SyncTests at entity scale on cuda")
    bits = torch.tensor([[(f + h) % 16 for h in range(2)] for f in range(4)],
                        dtype=torch.uint8)
    plain_grid = Schedule([boids.flock_system_grid, boids.increase_frame_system])
    scale = {}
    for label, n, frames, mode, fn in (
        ("boids1024_mxu", 1024, 120, "dense", tpw.pairwise_force_rows_mxu2),
        ("boids4096_tri", 4096, 60, "dense", tpw.pairwise_force_square_mxu_tri),
        ("boids32768_grid", 32768, 60, "grid", tcg.cell_slot_forces),
    ):
        # One step against the plain version (STEP_ATOL); over more steps
        # a difference moves a boid across a radius and the flocks part.
        schedule = boids.make_schedule(kernel="mxu", mode=mode)
        start = boids.make_world(n, 2, device="cuda").commit()
        a = advance_n(schedule, start, bits[:1].cuda())
        if mode == "dense":  # the plain version on the cpu
            b = advance_n(schedule, boids.make_world(n, 2, device="cpu").commit(), bits[:1])
        else:  # the cell kernel's plain version on the card
            b = advance_n(plain_grid, start, bits[:1].cuda())
        for name in ("position", "velocity"):
            err = (a.components[name].cpu() - b.components[name].cpu()).abs().max().item()
            check(err <= STEP_ATOL, f"{label} {name}: kernel against plain {err}")
        print(f"{label}: one step within {err:.3e} of the plain version (atol {STEP_ATOL}, "
              f"{'cpu' if mode == 'dense' else 'cuda'})")
        config = boids.grid_config(n)
        if mode == "grid":
            print(f"{label} grid_stats first frame: "
                  + json.dumps(tnb.grid_stats(start.components["position"], start.alive, config)))
        app = boids_app(n, "cuda", schedule)
        reset_counts(kernels)
        log, ticks = drive(app, SyncTestSession(2, boids.INPUT_SPEC, check_distance=7),
                           SessionType.SYNC_TEST, frames)
        launches = {k.__name__: k.launches for k in kernels}
        state = app.stage.runner.state
        check(torch.isfinite(state.components["position"]).all().item(), f"{label}: positions")
        check(launches[fn.__name__] == log["advances"],
              f"{label}: {fn.__name__} launches {launches}, {log['advances']} advances")
        check(all(launches[k.__name__] == 0 for k in force_kernels if k is not fn),
              f"{label}: another force kernel ran: {launches}")
        checksums = check_checksum_launches(label, tck, launches, log, app.stage.runner)
        if mode == "grid":
            active = state.alive & state.present["position"]
            print(f"{label} grid_stats last frame: "
                  + json.dumps(tnb.grid_stats(state.components["position"], active, config)))
        print(f"{label}: {frames} frames, {log['advances']} advances, {log['saves']} saves, "
              f"no mismatch, launches {launches}, {checksums}, "
              f"ticks {json.dumps(tick_stats(ticks))}")
        scale[label] = {"app": app, "log": log, "ticks": ticks, "launches": launches}

    phase("9 times")
    # The checksum in its three modes at the main path's shape (one boids
    # world, 1,024 slots, 9 parts) and at the grid world's (32,768 slots, a
    # cluster of 8 blocks).
    state = flock.stage.runner.state
    runs = [box_launches, boids_launches] + [r["launches"] for r in scale.values()]
    modes = checksum_modes(ts, tck, integrity, state, flock.stage.runner.ring.depth)
    grid_runner = scale["boids32768_grid"]["app"].stage.runner
    modes_grid = checksum_modes(ts, tck, integrity, grid_runner.state, grid_runner.ring.depth)
    plain_ms = cuda_ms(lambda: tck.checksum_plain(state), iters=20)
    for label, m in (("boids-1024", modes), ("boids-32768", modes_grid)):
        for mode in ("checksum", "save", "guard"):
            print(f"world_checksum {mode} {label} ({m['state_bytes']} state bytes, "
                  f"{m['ops']} ops): device {m[mode]['ms']:.6f} ms (graph replay), per call "
                  f"with host work {m[mode]['call_ms']:.6f} ms, bound {m[mode]['bound_ms']:.7f} ms "
                  f"({m[mode]['bound_by']}: {m[mode]['bytes']} bytes)")
    print(f"world_checksum plain version (checksum mode, boids-1024): {plain_ms:.6f} ms a call")
    ck = {
        "name": "world_checksum", "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/checksum.cu",
        "replaces": "bevy_ggrs_tpu/ops/checksum.py:95",
        "launches": sum(r["world_checksum"] for r in runs),
        "max_abs_err": 0.0,
        "ms": modes["checksum"]["ms"], "plain_ms": plain_ms,
        "bound_ms": modes["checksum"]["bound_ms"], "bound_by": modes["checksum"]["bound_by"],
        "library_ms": None,
        "modes": {mode: {k: modes[mode][k] for k in ("ms", "call_ms", "bound_ms")}
                  for mode in ("checksum", "save", "guard")},
        "modes_boids32768": {mode: {k: modes_grid[mode][k] for k in ("ms", "call_ms", "bound_ms")}
                             for mode in ("checksum", "save", "guard")},
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

    def flock_operands(label):
        s_ = scale[label]["app"].stage.runner.state
        return (s_.components["position"], s_.components["velocity"],
                (s_.alive & s_.present["position"]).float())

    pos, vel, act = flock_operands("boids1024_mxu")
    n_boids = pos.shape[0]
    args = (pos, vel, pos, vel, act, act)
    mxu2 = {
        "name": "pairwise_force_rows_mxu2", "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/pairwise_mxu.cu",
        "replaces": "bevy_ggrs_tpu/ops/pairwise.py:478",
        "launches": scale["boids1024_mxu"]["launches"]["pairwise_force_rows_mxu2"],
        "max_abs_err": mxu_err["mxu2"],
        **timings(
            f"mxu2 R=N={n_boids}",
            lambda: tpw.pairwise_force_rows_mxu2(*args, **params),
            lambda: tpw.pairwise_force_rows_mxu2_plain(*args, **params),
            nbytes=n_boids * 5 * 4 * 2 + n_boids * 2 * 4,
            ops=n_boids * n_boids * MXU_MASK_OPS_PER_PAIR,
            tc_flops=n_boids * n_boids * MXU_TC_FLOPS_PER_PAIR),
    }
    tri_pos, tri_vel, tri_act = flock_operands("boids4096_tri")
    n_boids = tri_pos.shape[0]
    tri = {
        "name": "pairwise_force_square_mxu_tri", "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/pairwise_tri.cu",
        "replaces": "bevy_ggrs_tpu/ops/pairwise.py:673",
        "launches": scale["boids4096_tri"]["launches"]["pairwise_force_square_mxu_tri"],
        "max_abs_err": mxu_err["tri"],
        **timings(
            f"tri N={n_boids}",
            lambda: tpw.pairwise_force_square_mxu_tri(tri_pos, tri_vel, tri_act, **params),
            lambda: tpw.pairwise_force_square_mxu_tri_plain(tri_pos, tri_vel, tri_act, **params),
            nbytes=n_boids * 5 * 4 + n_boids * 2 * 4,
            # masks once per unordered pair; products for every ordered pair
            ops=n_boids * (n_boids + 1) // 2 * MXU_MASK_OPS_PER_PAIR,
            tc_flops=n_boids * n_boids * MXU_TC_FLOPS_PER_PAIR),
    }
    passes = kernel_device_ms(
        lambda: tpw.pairwise_force_square_mxu_tri(tri_pos, tri_vel, tri_act, **params))
    split = {stage: sum(ms for name, ms in passes.items() if f"tri_{stage}_kernel" in name)
             for stage in ("tiles", "combine")}
    check(all(ms > 0 for ms in split.values()), f"tri passes not seen: {passes}")
    print(f"tri N={n_boids} passes (device ms a call, profiler): "
          f"tile pass {split['tiles']:.6f}, combine {split['combine']:.6f}")
    g_pos, g_vel, g_act = flock_operands("boids32768_grid")
    n_boids = g_pos.shape[0]
    config = boids.grid_config(n_boids)
    _, _, rowvals, colvals = grid_operands(tnb, boids, g_pos, g_vel, g_act, config)
    fk = boids.FLOCK_PAIR_KERNEL
    C, K, M = config.num_cells, config.cell_capacity, config.padded_cols
    # The pairs this run's data needs, which the kernel computes: live
    # slots against live candidates.
    pairs = live_pairs(rowvals, colvals)
    print(f"cell kernel C={C} K={K} M={M}: {C * K * M} slot-candidate pairs in the "
          f"tables, {pairs} computed (between live entities)")
    cell = {
        "name": "cell_slot_forces", "route": "cuda",
        "source": "bevy_ggrs_tpu_torch/csrc/cell_gather.cu",
        "replaces": "bevy_ggrs_tpu/ops/cell_gather.py:114",
        "launches": scale["boids32768_grid"]["launches"]["cell_slot_forces"],
        "max_abs_err": cell_err,
        **timings(
            f"cell C={C} K={K} M={M}",
            lambda: tcg.cell_slot_forces(fk, rowvals, colvals),
            lambda: tcg.cell_slot_forces_plain(fk, rowvals, colvals),
            nbytes=(len(fk.row_names) * C * K + len(fk.col_names) * C * M
                    + fk.out_dim * C * K) * 4,
            ops=pairs * FORCE_OPS_PER_PAIR),
    }
    print("library_ms: no single PyTorch call computes any of these functions "
          "(a murmur3 hash chain; the three boids rules, dense or per cell), "
          "so there is none")
    # The main path's pieces around the kernels, for the per-tick breakdowns.
    step_bits = torch.zeros((2,), dtype=torch.uint8, device="cuda")
    step_status = torch.zeros((2,), dtype=torch.int32, device="cuda")
    inputs = PlayerInputs(step_bits, step_status)
    pieces = {}
    for label, app, schedule in (
        ("boids1024", flock, boids.make_schedule()),
        ("boids1024_mxu", scale["boids1024_mxu"]["app"], boids.make_schedule(kernel="mxu")),
        ("boids4096_tri", scale["boids4096_tri"]["app"], boids.make_schedule(kernel="mxu")),
        ("boids32768_grid", scale["boids32768_grid"]["app"],
         boids.make_schedule(kernel="mxu", mode="grid")),
    ):
        s_ = app.stage.runner.state
        ring = ts.ring_init(s_, app.stage.runner.ring.depth)  # scratch: the session's untouched
        ts.ring_save(ring, s_, 0)
        iters = 20 if label == "boids32768_grid" else 50
        pieces[f"{label}_checksum_ms"] = cuda_ms(lambda: tck.checksum(s_), iters=iters)
        pieces[f"{label}_ring_save_ms"] = cuda_ms(lambda: ts.ring_save(ring, s_, 0), iters=iters)
        pieces[f"{label}_guard_ms"] = cuda_ms(lambda: integrity.verify_row(ring, 0), iters=iters)
        pieces[f"{label}_ring_load_ms"] = cuda_ms(lambda: ts.ring_load(ring, 0), iters=iters)
        pieces[f"{label}_step_ms"] = cuda_ms(lambda: schedule(s_, inputs), iters=iters)
    # The grid step's own pieces.
    feats = {"vx": g_vel[:, 0], "vy": g_vel[:, 1]}
    tables = tnb.build_grid_tables(g_pos, g_act, config, feats)
    slot_f = tnb.slot_forces(fk, tables[0].slots, tables[1], tables[2], impl="pallas")
    spill_f = tnb.spill_forces(fk, tables[0].spill, tables[2])
    pieces.update({
        "grid_bin_and_tables_ms": cuda_ms(
            lambda: tnb.build_grid_tables(g_pos, g_act, config, feats), iters=20),
        "grid_slot_forces_ms": cuda_ms(
            lambda: tnb.slot_forces(fk, tables[0].slots, tables[1], tables[2], impl="pallas"),
            iters=20),
        "grid_spill_forces_ms": cuda_ms(
            lambda: tnb.spill_forces(fk, tables[0].spill, tables[2]), iters=20),
        "grid_scatter_ms": cuda_ms(
            lambda: tnb.scatter_forces(n_boids, tables[0].slots, tables[0].spill,
                                       slot_f, spill_f), iters=20),
    })
    print("pieces " + json.dumps(pieces))
    # Device busy time per tick under the profiler, after each run's counts
    # were read.
    busy = {"boids1024_synctest": device_busy(flock)}
    busy.update({f"{label}_synctest": device_busy(r["app"]) for label, r in scale.items()})
    print("busy " + json.dumps(busy))
    ticks = {"box_game_synctest": tick_stats(box_ticks),
             "boids1024_synctest": tick_stats(boids_ticks)}
    ticks.update({f"{label}_synctest": tick_stats(r["ticks"]) for label, r in scale.items()})
    print("ticks " + json.dumps(ticks))
    print(json.dumps({"kernels": [ck, forces[1024], mxu2, tri, cell]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
