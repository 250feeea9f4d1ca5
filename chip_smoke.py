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
   run one CUDA kernel and no host-to-device copy, and so does the save of
   64 box_game branches into a ``[64, 8]`` stack of rings (phase 11).
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

10. P2P and spectator sessions on ``cuda``, every peer an app of its own
   driven through ``GGRSStage`` with input delay 2, ``max_prediction`` 8
   and desync detection "auto" (a checksum exchange every 8 frames), on
   seeded random inputs: box_game, 2 peers, 600 frames over a loopback
   network with 40 ms latency, 10 ms jitter and 5 % loss, each peer's
   socket wrapped in a ``ChaosSocket`` with a reorder, a duplicate and a
   corrupt window, and a spectator following peer 0 (its world's checksum
   at every exchange frame equal to the peers'); the same run on the CPU,
   its confirmed checksum stream bitwise the card's; box_game, 4 peers in
   a full mesh, 300 frames; boids-1,024 with ``kernel="mxu"``, 2 peers,
   120 frames; box_game, 2 peers over real UDP on 127.0.0.1, 120 frames on
   the wall clock. In every run both peers reach RUNNING, no
   ``DESYNC_DETECTED`` fires, and the peers' settled checksums are equal;
   the box_game run compares at least 30 exchanges a peer, rolls back on
   each peer and drops corrupt datagrams on their CRC. On each peer the
   checksum kernel ran once per save and once per restore guard, and the
   boids run's tensor-core kernel once per advanced frame (resimulated
   frames included) and no other force kernel. Per peer: ticks (mean,
   p99), rollbacks, resimulated frames, the deepest rollback, exchanges
   compared, launches; the device's busy share of 30 render frames of the
   box_game run under ``torch.profiler``.

11. Speculation on ``cuda``. The checksum kernel's save mode over a
   branch axis against its plain version, bitwise: box_game worlds at B =
   1 (equal to the single-world save too), 64 and 256, and random-registry
   worlds of 1,000 slots (clusters of 8 blocks) at B = 64, into ``[B,
   depth]`` stacks of rings (phase 2 checks under ``torch.profiler`` that
   one such save is one CUDA kernel and no host-to-device copy); its device
   time by graph replay
   at B = 64 and 256 beside its bytes bound. The warmup attestation of a
   box_game runner at B = 64, F = 8 (``ok``, ``real_checked``,
   ``scanned_branches``), the live ring bitwise unchanged by it. Then
   box_game, 2 peers, both ``with_speculation(64)``, 600 frames over phase
   10's lossy loopback (no chaos) on seeded held-key runs: both RUNNING, no
   ``DESYNC_DETECTED``, hits (full or partial) on each peer, and the
   confirmed checksum stream bitwise equal to the same run with
   speculation off and to the same run on the CPU; on each peer the
   checksum kernel ran once per serial save, once per restore guard and F
   times per rollout dispatched. Per peer, with speculation on and off:
   ticks (mean, p99), recovery ticks (ticks that rolled back: p50, p99),
   hits, partial hits, misses, skipped dispatches, ``spec_host_dispatch``
   ms, and the device's busy share of one profiled render frame.
   Then boids under speculation ("11b"): the batched save of boids-1,024
   worlds (B = 8, and B = 128 in the rollout's shape) bitwise against its
   plain version, with the box_game cases above; each force kernel over a
   leading branch axis, bitwise equal to B unbatched launches and within
   its tolerance of its batched plain version (a branch at a time): the
   f32 kernel at B = 16, N = 1,024 and B = 3, N = 1,000; the general
   tensor-core kernel at B = 128, R = N = 1,024, B = 3, (R, N) = (65,
   1,000) and B = 1; the triangle at B = 8, N = 4,096 and B = 2, N =
   4,100; the cell kernel on the boids-32,768 grid at B = 2 and on a
   clustered 600-boid grid that spills at B = 4; each timed at the first
   shape (device and per call, beside B unbatched launches in one graph
   and B times one world's bound). The warmup attestation of boids runners,
   fresh, ``ok`` with ``real_checked`` 2B: mxu 1,024 at B = 128, pallas
   1,024 at B = 16, mxu 4,096 (the triangle) at B = 8 and the mxu grid at
   32,768 at B = 2, all at F = 8, with the path's force kernel launched F
   times a rollout and F times a replayed branch, and no other. Then
   boids-1,024 ``kernel="mxu"``, 2 peers, both ``with_speculation(128)``
   (BASELINE.md config 4), 300 frames over the same loopback on held-key
   runs, against the same run with speculation off: both RUNNING, no
   ``DESYNC_DETECTED``, hits on each peer, the confirmed streams bitwise
   equal; on each peer the general tensor-core kernel ran once per frame
   advanced serially (advances less the frames a hit copied) plus F times
   per rollout, no other force kernel ran, and the checksum kernel once
   per serial save, guard and F times per rollout; the same numbers per
   peer as box_game's. Every phase prints its wall seconds.

The kernel counters are set to 0 just before each SyncTest of phases 4, 5
and 8, each P2P run of phases 10 and 11 and each boids attestation of
phase 11, and read just after (the P2P runs read them around each peer's
update); launches made to compare a kernel with its plain version are not
counted. The last three lines are
the kernel table (JSON), the card's name and power limit, and the result
(JSON).
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


_PHASE = {"name": None, "t0": None}


def phase(name) -> None:
    """Print the wall seconds the previous phase took, then open the next
    (``None`` closes the last)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"phase {_PHASE['name'].split()[0]} wall {now - _PHASE['t0']:.1f} s", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
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
    kernel and copy nothing to the device; the guard reads back 4 bytes.
    So does the save of 64 box_game branches into a ``[64, 8]`` stack of
    rings (phase 11's batched save; checked here, where the script's first
    profiler sessions run)."""
    state = boids.make_world(1024, 2, device="cuda").commit()
    ring = ts.ring_init(state, 9)
    ts.ring_save(ring, state, 3)
    worlds = box_branch_worlds(ts, 64, "cuda")
    branches = branch_worlds(ts, worlds)
    rings = ts.branch_rings(worlds[0], 64, 8)
    for name, fn, d2h in (("ring_save", lambda: ts.ring_save(ring, state, 3), 0),
                          ("checksum", lambda: tck.checksum(state), 0),
                          ("verify_row", lambda: integrity.verify_row(ring, 3), 1),
                          ("batched ring_save", lambda: ts.ring_save(rings, branches, 3), 0)):
        work = device_work(fn)
        check(len(work["kernels"]) == 1 and not work["h2d"] and len(work["d2h"]) == d2h,
              f"{name} under the profiler: {work}")
        world = "box_game, B=64" if name.startswith("batched") else "boids-1,024"
        print(f"{name} ({world}) under torch.profiler: 1 CUDA kernel "
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
    rows = (rowvals["active"] != 0).sum(-1)  # [C] or, over branches, [B, C]
    cols = (colvals["active"] != 0).sum(-1)
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
    log = {"checksums": [], "saves": 0, "advances": 0, "resimulated": []}
    report, advance = getattr(session, "report_checksum", None), session.advance_frame

    def report_checksum(frame, cs):
        log["checksums"].append((frame, cs))
        report(frame, cs)

    def advance_frame():
        requests = advance()
        for r in requests:
            kind = type(r).__name__
            log["saves"] += kind == "SaveGameState"
            log["advances"] += kind == "AdvanceFrame"
        if requests and type(requests[0]).__name__ == "LoadGameState":
            # A rollback: every advance but the new frame's resimulates.
            log["resimulated"].append(
                sum(type(r).__name__ == "AdvanceFrame" for r in requests) - 1)
        return requests

    if report is not None:
        session.report_checksum = report_checksum
    session.advance_frame = advance_frame
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


def box_app(device, inputs=None, players: int = 2, speculation: int = 0):
    """A box_game app; ``inputs`` is the input system (default: keys held
    for 20 frames in turn); ``speculation`` branches (0: none), with a
    metrics sink on the runner."""
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN,
            box_game.INPUT_LEFT, box_game.INPUT_UP | box_game.INPUT_RIGHT, 0]

    def held_keys(handle, app):
        return np.uint8(keys[(app.session.current_frame // 20 + 3 * handle) % len(keys)])

    def setup(world, app):
        box_game.spawn_players(world, players, next_id=app.rollback_id_provider.next_id)

    return (
        GGRSPlugin(box_game.INPUT_SPEC)
        .with_input_system(inputs or held_keys)
        .register_rollback_component("translation", shape=(3,), dtype=torch.float32)
        .register_rollback_component("velocity", shape=(3,), dtype=torch.float32)
        .register_rollback_component("player_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(box_game.make_schedule())
        .with_num_players(players)
        .with_max_prediction_window(8)
        .with_world_capacity(16)
        .with_setup_system(setup)
        .with_device(device)
        .with_speculation(speculation)
        .with_metrics(Metrics() if speculation else None)
        .build()
    )


def boids_app(n: int, device, schedule=None, inputs=None, speculation: int = 0):
    """A boids app of ``n`` boids; ``speculation`` branches (0: none), with
    a metrics sink on the runner."""
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    def steer(handle, app):
        return np.uint8((app.session.current_frame // 5 + 7 * handle) % 16)

    return (
        GGRSPlugin(boids.INPUT_SPEC)
        .with_input_system(inputs or steer)
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
        .with_speculation(speculation)
        .with_metrics(Metrics() if speculation else None)
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


# ---------------------------------------------------------------------------
# Phase 10: P2P and spectator sessions through GGRSPlugin
# ---------------------------------------------------------------------------

P2P_DT = DT  # one render frame of the network's virtual clock
P2P_INPUT_DELAY = 2
P2P_MAX_PREDICTION = 8
P2P_MIN_COMPARED = 30  # checksum exchanges each peer must have compared (600 frames)
# The lossy loopback of the box_game and boids runs: 40 ms latency, 10 ms
# jitter and 5 % of the datagrams lost, from a seed.
P2P_NET = {"latency": 0.040, "jitter": 0.010, "loss": 0.05, "seed": 7}


def p2p_chaos_plan(seconds: float):
    """Faults on each peer's outgoing datagrams on top of the network's
    loss, in windows of a fifth of a run of ``seconds`` each: a reorder
    window, then a duplicate window, then a corrupt window (for the
    600-frame box_game run: 1-3 s, 3-5 s, 5-7 s of its 10 s)."""
    from bevy_ggrs_tpu_torch.chaos import ChaosPlan, Corrupt, Duplicate, Reorder

    w = seconds / 5
    return ChaosPlan(seed=11, directives=(
        Reorder(0.5 * w, 1.5 * w, rate=0.2, delay=0.03),
        Duplicate(1.5 * w, 2.5 * w, rate=0.2),
        Corrupt(2.5 * w, 3.5 * w, rate=0.1),
    ))


def seeded_inputs(seed: int, frames: int, players: int):
    """An input system reading a seeded random table: the same bits for a
    frame and handle on every device and in every run."""
    table = np.random.RandomState(seed).randint(0, 16, size=(frames + 64, players))
    table = table.astype(np.uint8)
    return lambda handle, app: table[app.session.current_frame, handle]


def held_key_table(seed: int, frames: int, players: int) -> np.ndarray:
    """Held keys, as players press: a key held, released, the opposite
    key held, released, each for a seeded run of 2 to 6 frames; even
    players press UP and DOWN, odd ones LEFT and RIGHT. A run of 6 frames
    brings a cube to 0.03 on its axis, which then turns, so the speed stays
    below box_game's clamp of 0.05. Each player's runs come from a
    generator of its own, so a shorter table is a prefix of a longer one.
    ``uint8[frames, players]``."""
    from bevy_ggrs_tpu_torch.models import box_game

    axes = ([box_game.INPUT_UP, 0, box_game.INPUT_DOWN, 0],
            [box_game.INPUT_LEFT, 0, box_game.INPUT_RIGHT, 0])
    table = np.zeros((frames, players), np.uint8)
    for h in range(players):
        rng = np.random.RandomState([seed, h])  # a player's runs, whatever ``frames``
        cycle = axes[h % 2]
        f, k = 0, h
        while f < frames:
            run = int(rng.randint(2, 7))
            table[f:f + run, h] = cycle[k % len(cycle)]
            f, k = f + run, k + 1
    return table


def held_key_runs(seed: int, frames: int, players: int):
    """An input system reading :func:`held_key_table`."""
    table = held_key_table(seed, frames + 64, players)
    return lambda handle, app: table[app.session.current_frame, handle]


# Runner counters an update's deltas are kept of.
RUNNER_COUNTS = ("saves_total", "restore_guards_total", "spec_rollouts_total",
                 "rollbacks_total", "rollback_frames_recovered_total")


class P2PRun:
    """``players`` P2P peers (and optionally a spectator of peer 0), each an
    app of its own built by ``make_app(device, inputs)`` and driven through
    ``GGRSStage`` on one clock: the loopback network's virtual clock, or
    the wall clock over real UDP on 127.0.0.1. ``inputs(seed, frames,
    players)`` makes the input system (seeded random bits by default)."""

    def __init__(self, make_app, device, players: int, seed: int, frames: int,
                 transport: str = "loopback", chaos: bool = False,
                 spectator: bool = False, inputs=None):
        from bevy_ggrs_tpu_torch.app import SessionType
        from bevy_ggrs_tpu_torch.chaos import ChaosSocket
        from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
        from bevy_ggrs_tpu_torch.transport import LoopbackNetwork, UdpSocket
        from bevy_ggrs_tpu_torch.utils.metrics import Metrics

        self.frames = frames
        self.device = torch.device(device)
        self.virtual = transport == "loopback"
        inputs = (inputs or seeded_inputs)(seed, 4 * frames, players)
        if self.virtual:
            self.net = LoopbackNetwork(**P2P_NET)
            sockets = [self.net.socket(("peer", h)) for h in range(players)]
            addrs = [("peer", h) for h in range(players)]
            clock = lambda: self.net.now  # noqa: E731
        else:  # a bind failure raises, and fails the phase
            self.net = None
            sockets = [UdpSocket(0, host="127.0.0.1") for _ in range(players)]
            addrs = [("127.0.0.1", s.local_port()) for s in sockets]
            clock = time.monotonic
        spec_addr = ("spec", 0)
        self.peers = []
        for me in range(players):
            app = make_app(device, inputs)
            builder = (SessionBuilder(app.stage.runner.input_spec)
                       .with_num_players(players)
                       .with_max_prediction_window(P2P_MAX_PREDICTION)
                       .with_input_delay(P2P_INPUT_DELAY))
            for h in range(players):
                builder.add_player(PlayerType.local() if h == me
                                   else PlayerType.remote(addrs[h]), h)
            if spectator and me == 0:
                builder.add_player(PlayerType.spectator(spec_addr), players)
            sock = sockets[me]
            if chaos:
                sock = ChaosSocket(sock, p2p_chaos_plan(frames * P2P_DT), clock=clock,
                                   addr=addrs[me])
            metrics = Metrics()
            session = builder.start_p2p_session(sock, clock=clock, metrics=metrics)
            log = record(session)
            app.insert_session(session, SessionType.P2P)
            self.peers.append({"app": app, "session": session, "socket": sock,
                               "metrics": metrics, "log": log, "ticks": [],
                               "launches": {}})
        self.spectator = None
        if spectator:
            app = make_app(device, inputs)
            session = (SessionBuilder(app.stage.runner.input_spec)
                       .with_num_players(players)
                       .start_spectator_session(addrs[0], self.net.socket(spec_addr),
                                                clock=clock))
            app.insert_session(session, SessionType.SPECTATOR)
            self.spectator = {"app": app, "session": session, "checksums": {},
                              "launches": {}}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def update(self, entry, kernels, now) -> None:
        """One render frame of one app, adding its kernel launches and its
        runner's counts to the entry; a render frame that ran a simulation
        step is a tick, and its milliseconds (ending in a device
        synchronise) are kept, apart too when the tick rolled back."""
        runner = entry["app"].stage.runner
        before = {fn.__name__: fn.launches for fn in kernels}
        counts = {k: getattr(runner, k, 0) for k in RUNNER_COUNTS}
        t0 = time.perf_counter()
        steps = entry["app"].update(now)
        self.sync()
        ms = (time.perf_counter() - t0) * 1e3
        for fn in kernels:
            entry["launches"][fn.__name__] = (entry["launches"].get(fn.__name__, 0)
                                              + fn.launches - before[fn.__name__])
        counted = entry.setdefault("counts", {})
        for k in RUNNER_COUNTS:
            counted[k] = counted.get(k, 0) + getattr(runner, k, 0) - counts[k]
        entry["polls"] = entry.get("polls", 0) + 1
        if steps:
            entry.setdefault("ticks", []).append(ms)
            if runner.rollbacks_total > counts["rollbacks_total"]:
                entry.setdefault("recovery_ticks", []).append(ms)

    def step(self, kernels, ts, tck) -> None:
        """One render frame of every app, in turn."""
        if self.virtual:
            self.net.advance(P2P_DT)
        for peer in self.peers:
            self.update(peer, kernels, self.net.now if self.virtual else None)
        if self.spectator is not None:
            spec = self.spectator
            self.update(spec, kernels, self.net.now)
            runner = spec["app"].stage.runner
            interval = self.peers[0]["session"].desync_interval
            if runner.frame % interval == 0 and runner.frame not in spec["checksums"]:
                # The spectator's world at frame F is the state every peer
                # saved for F; counted apart from the apps' launches.
                spec["checksums"][runner.frame] = ts.combine64(tck.checksum(runner.state))

    def run(self, kernels, ts, tck, max_seconds: float = 120.0) -> "P2PRun":
        """Step until every peer has advanced ``frames`` frames (and the
        spectator, when there is one, has followed to within 2 checksum
        intervals of the host's end)."""
        t0 = time.perf_counter()
        while True:
            frames = [p["app"].stage.runner.frame for p in self.peers]
            done = min(frames) >= self.frames
            if done and self.spectator is not None:
                host = self.peers[0]["session"].confirmed_frame()
                done = self.spectator["app"].stage.runner.frame >= host - 16
            if done:
                self.seconds = time.perf_counter() - t0
                return self
            check(time.perf_counter() - t0 < max_seconds,
                  f"P2P run stalled at frames {frames} after {max_seconds} s")
            self.step(kernels, ts, tck)

    def settled(self) -> int:
        """The last frame whose checksum is final on every peer: confirmed,
        and below any rollback still pending."""
        upto = []
        for p in self.peers:
            s = p["session"]
            pending = s._tracker.first_incorrect
            upto.append(s.confirmed_frame() if pending < 0
                        else min(s.confirmed_frame(), pending - 1))
        return min(upto)

    def confirmed_stream(self, peer) -> dict:
        """Frame -> the last checksum the peer reported for it, over the
        frames settled on every peer (later reports of a frame replace the
        ones a rollback made stale)."""
        upto = self.settled()
        stream = {}
        for frame, cs in peer["log"]["checksums"]:
            stream[frame] = cs
        return {f: cs for f, cs in sorted(stream.items()) if f <= upto}

    def summary(self, label: str) -> dict:
        """Check the run's invariants and return its numbers."""
        from bevy_ggrs_tpu_torch.session import EventKind, SessionState

        out = {"peers": []}
        streams = [self.confirmed_stream(p) for p in self.peers]
        for i, (peer, stream) in enumerate(zip(self.peers, streams)):
            session, runner = peer["session"], peer["app"].stage.runner
            events = peer["app"].events
            check(session.current_state() == SessionState.RUNNING,
                  f"{label} peer {i}: not RUNNING")
            check(any(e.kind == EventKind.SYNCHRONIZED for e in events),
                  f"{label} peer {i}: never synchronized")
            desyncs = [e for e in events if e.kind == EventKind.DESYNC_DETECTED]
            check(not desyncs, f"{label} peer {i}: DESYNC_DETECTED {desyncs[:2]}")
            check(stream == streams[0],
                  f"{label}: peer {i}'s confirmed checksums differ from peer 0's")
            resim = peer["log"]["resimulated"]
            crc = sum(ep.data_crc_drops for ep in session._endpoints.values())
            out["peers"].append({
                "frames": runner.frame,
                "ticks": tick_stats(peer["ticks"]),
                "render_frames": peer["polls"],
                "rollbacks": runner.rollbacks_total,
                "resimulated_frames": sum(resim),
                "deepest_rollback": max(resim, default=0),
                "compared": int(peer["metrics"].counters["checksums_compared"]),
                "data_crc_drops": crc,
                "skipped_steps": peer["app"].stage.frames_skipped,
                "launches": dict(peer["launches"]),
                "saves": peer["log"]["saves"],
                "advances": peer["log"]["advances"],
                "guards": runner.rollbacks_total if runner.verify_restores else 0,
            })
        out["confirmed_checksums"] = len(streams[0])
        out["seconds"] = self.seconds
        if self.spectator is not None:
            host = streams[0]
            seen = {f: cs for f, cs in self.spectator["checksums"].items() if f in host}
            check(len(seen) >= 10, f"{label}: spectator compared only {len(seen)} frames")
            bad = [f for f, cs in seen.items() if host[f] != cs]
            check(not bad, f"{label}: spectator checksums differ from the host's at {bad[:5]}")
            spec_runner = self.spectator["app"].stage.runner
            check(spec_runner.rollbacks_total == 0, f"{label}: the spectator rolled back")
            out["spectator"] = {"frames": spec_runner.frame, "compared_with_host": len(seen),
                                "launches": dict(self.spectator["launches"])}
        return out

    def close(self) -> None:
        for peer in self.peers:
            close = getattr(peer["socket"], "close", None)
            if close is not None and not self.virtual:
                close()


def p2p_print(label: str, result: dict, card: str) -> None:
    for i, peer in enumerate(result["peers"]):
        print(f"{label} peer {i}: " + json.dumps(peer))
    if "spectator" in result:
        print(f"{label} spectator: " + json.dumps(result["spectator"]))
    print(f"{label}: {result['confirmed_checksums']} confirmed frames' checksums equal "
          f"on every peer; {result['seconds']:.1f} s; {card}")


def check_p2p_launches(label: str, result: dict, force=None, others=()) -> None:
    """On each peer the checksum kernel ran once per save and once per
    restore guard, and the force kernel ``force`` (when given) once per
    advanced frame, resimulated ones included, and no other force kernel."""
    for i, peer in enumerate(result["peers"]):
        got = peer["launches"].get("world_checksum", 0)
        check(got == peer["saves"] + peer["guards"],
              f"{label} peer {i}: {got} checksum launches, {peer['saves']} saves + "
              f"{peer['guards']} guards")
        if force is not None:
            check(peer["launches"].get(force, 0) == peer["advances"],
                  f"{label} peer {i}: {force} launches {peer['launches']}, "
                  f"{peer['advances']} advances")
            check(all(peer["launches"].get(k, 0) == 0 for k in others),
                  f"{label} peer {i}: another force kernel ran: {peer['launches']}")


def p2p_busy(run: P2PRun, kernels, ts, tck, iters: int = 30) -> dict:
    """``iters`` more render frames of a loopback P2P run under
    ``torch.profiler``: the wall milliseconds a render frame (every peer's
    update, profiler on) and the device's busy share of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run.step(kernels, ts, tck)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > 0, "the profiler saw no device activity in the P2P run")
    busy_us, end = 0.0, float("-inf")
    for t_start, t_end in spans:
        busy_us += max(0.0, t_end - max(t_start, end))
        end = max(end, t_end)
    return {"wall_ms_per_render_frame": wall_ms / iters,
            "device_busy_ms_per_render_frame": busy_us / 1e3 / iters,
            "busy_share": busy_us / 1e3 / wall_ms}


def p2p_phase(kernels, force_kernels, ts, tck, tpw, box_frames: int = 600,
              mesh_frames: int = 300, boids_frames: int = 120,
              udp_frames: int = 120, boids_n: int = 1024, device: str = "cuda") -> dict:
    """Phase 10: the five P2P runs. ``device="cpu"`` runs the same sessions
    on the plain versions (no kernel counts)."""
    from bevy_ggrs_tpu_torch.models import boids

    on_card = device == "cuda"
    card = smi() if on_card else "cpu"
    results = {}

    def box(players):
        return lambda dev, inputs: box_app(dev, inputs, players=players)

    def reset():
        if on_card:
            reset_counts(kernels)

    # 1. box_game, 2 peers over the lossy loopback with chaos, a spectator.
    reset()
    run = P2PRun(box(2), device, 2, seed=1, frames=box_frames, chaos=True,
                 spectator=True).run(kernels, ts, tck)
    results["box2"] = run.summary("p2p box_game 2 peers")
    check(all(p["rollbacks"] > 0 for p in results["box2"]["peers"]),
          "p2p box_game: a peer never rolled back")
    check(all(p["compared"] >= min(P2P_MIN_COMPARED, box_frames // 20)
              for p in results["box2"]["peers"]),
          f"p2p box_game: too few checksum exchanges {results['box2']['peers']}")
    check(sum(p["data_crc_drops"] for p in results["box2"]["peers"]) > 0,
          "p2p box_game: the corrupt window caused no crc drop")
    box_streams = [run.confirmed_stream(p) for p in run.peers]
    if on_card:
        check_p2p_launches("p2p box_game", results["box2"])
        # After the streams were read: the profiled frames run on.
        results["box2"]["busy"] = p2p_busy(run, kernels, ts, tck)
    p2p_print("p2p box_game 2 peers", results["box2"], card)

    # 2. the same run on the cpu: the same confirmed checksum stream.
    if on_card:
        cpu = P2PRun(box(2), "cpu", 2, seed=1, frames=box_frames, chaos=True,
                     spectator=True).run(kernels, ts, tck)
        cpu_result = cpu.summary("p2p box_game 2 peers, cpu")
        cpu_streams = [cpu.confirmed_stream(p) for p in cpu.peers]
        for i, (a, b) in enumerate(zip(box_streams, cpu_streams)):
            common = sorted(set(a) & set(b))
            check(len(common) >= 10 and all(a[f] == b[f] for f in common),
                  f"p2p box_game peer {i}: cuda and cpu confirmed checksums differ")
            print(f"p2p box_game peer {i}: cuda stream {len(a)} frames, cpu stream "
                  f"{len(b)} frames, {len(common)} in common, bitwise equal"
                  + ("" if len(a) == len(b) else " (the streams differ in length)"))
        results["box2_cpu"] = cpu_result

    # 3. box_game, 4 peers in a full mesh.
    reset()
    results["box4"] = P2PRun(box(4), device, 4, seed=2, frames=mesh_frames).run(
        kernels, ts, tck).summary("p2p box_game 4 peers")
    if on_card:
        check_p2p_launches("p2p box_game 4 peers", results["box4"])
    p2p_print("p2p box_game 4 peers", results["box4"], card)

    # 4. boids-1,024 with the general tensor-core kernel, 2 peers.
    n = boids_n
    reset()
    schedule = boids.make_schedule(kernel="mxu")
    results["boids1024_mxu"] = P2PRun(
        lambda dev, inputs: boids_app(n, dev, schedule, inputs), device, 2, seed=3,
        frames=boids_frames).run(kernels, ts, tck).summary("p2p boids-1024 mxu")
    if on_card:
        check_p2p_launches("p2p boids-1024 mxu", results["boids1024_mxu"],
                           force=tpw.pairwise_force_rows_mxu2.__name__,
                           others=[k.__name__ for k in force_kernels
                                   if k is not tpw.pairwise_force_rows_mxu2])
    p2p_print("p2p boids-1024 mxu", results["boids1024_mxu"], card)

    # 5. box_game, 2 peers over real UDP on 127.0.0.1, on the wall clock.
    reset()
    udp = P2PRun(box(2), device, 2, seed=4, frames=udp_frames, transport="udp")
    try:
        results["udp"] = udp.run(kernels, ts, tck, max_seconds=60.0).summary(
            "p2p box_game over udp")
    finally:
        udp.close()
    if on_card:
        check_p2p_launches("p2p box_game over udp", results["udp"])
    p2p_print("p2p box_game over udp", results["udp"], card)
    return results


# ---------------------------------------------------------------------------
# Phase 11: speculation
# ---------------------------------------------------------------------------

SPEC_BRANCHES = 64
SPEC_TIMED_BRANCHES = (64, 256)  # BASELINE configs 2 and "HL": 8 frames x 64 / 256


def branch_worlds(ts, worlds):
    """A ``[B]`` world of single worlds."""
    return ts.tree_map(lambda *xs: torch.stack(xs).contiguous(), *worlds)


def box_branch_worlds(ts, n: int, device, seed: int = 0):
    """``n`` box_game worlds with seeded translations and velocities."""
    from bevy_ggrs_tpu_torch.models import box_game

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        host = ts.to_host(box_game.make_world(2, device="cpu").commit())
        comps = host["components"]
        comps["translation"] += rng.uniform(-1, 1, comps["translation"].shape).astype(np.float32)
        comps["velocity"] = rng.uniform(-0.04, 0.04, comps["velocity"].shape).astype(np.float32)
        host["resources"]["frame_count"] = np.uint32(rng.randint(0, 1000))
        out.append(ts.from_host(box_game.make_registry(), host, device=device))
    return out


def boids_branch_worlds(boids, n: int, branches: int, seed: int):
    """``branches`` boids-``n`` worlds on the card, each with the positions
    and velocities of :func:`branch_flocks`."""
    world = boids.make_world(n, 2, device="cuda").commit()
    pos, vel, _ = branch_flocks(branches, world.components["position"], seed)
    return [world.replace(components={**world.components, "position": pos[b].clone(),
                                      "velocity": vel[b].clone()}) for b in range(branches)]


def check_batched_save(ts, tck, boids) -> None:
    """The save mode over a branch axis against its plain version, bitwise:
    the rings' bytes, frames and digests and the lanes, over saves that
    wrap the rings; B = 1 also against the single-world save. The
    rollout-shaped cases have the spec rollout's own shape: B rings of
    depth F = 8 (box_game at B = 64, boids-1,024 at B = 128), each save's
    lanes written through the strided view ``lanes[:, t]`` of an
    ``int64[B, F, 2]`` tensor, as ``SpecResult.checksums`` is filled."""
    reg = random_registry(ts)
    F = P2P_MAX_PREDICTION
    cases = [("box_game", B, box_branch_worlds(ts, B, "cuda", seed=B), 3, False)
             for B in (1, 64, 256)]
    cases.append(("random registry cap 1000", 64,
                  [ts.from_host(reg, random_host(7000 + s, 1000), device="cuda")
                   for s in range(64)], 3, False))
    cases.append(("box_game rollout-shaped", SPEC_BRANCHES,
                  box_branch_worlds(ts, SPEC_BRANCHES, "cuda", seed=99), F, True))
    cases.append(("boids-1024", 8, boids_branch_worlds(boids, BOIDS_SPEC_N, 8, seed=8), 3,
                  False))
    cases.append(("boids-1024 rollout-shaped", BOIDS_SPEC_BRANCHES,
                  boids_branch_worlds(boids, BOIDS_SPEC_N, BOIDS_SPEC_BRANCHES, seed=128), F,
                  True))
    for label, B, worlds, depth, strided in cases:
        state = branch_worlds(ts, worlds)
        rings = ts.branch_rings(worlds[0], B, depth)
        plain = clone_ring(ts, rings)
        frames = range(depth + 2) if strided else (0, 1, 2, 3, 7)
        lanes_k = torch.zeros((B, depth, 2), dtype=torch.int64, device="cuda")
        lanes_p = lanes_k.clone()
        for frame in frames:
            if strided:  # a view with a row step of 2 * depth
                out, out_p = lanes_k[:, frame % depth], lanes_p[:, frame % depth]
            else:
                out, out_p = torch.zeros((B, 2), dtype=torch.int64, device="cuda"), None
            before = tck.world_checksum.launches
            _, lanes = ts.ring_save(rings, state, frame, out=out)
            check(tck.world_checksum.launches == before + 1, f"{label} B={B}: one launch")
            want = tck.save_plain(plain, state, frame, out=out_p)
            check(torch.equal(lanes, want) and torch.equal(out, want),
                  f"{label} B={B} frame {frame}: lanes differ from the plain version")
        check(torch.equal(lanes_k, lanes_p), f"{label} B={B}: the strided lanes differ")
        check(torch.equal(rings.frames, plain.frames)
              and torch.equal(rings.checksums, plain.checksums)
              and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, rings.states),
                                                       world_leaves(ts, plain.states))),
              f"{label} B={B}: the rings differ from the plain version's")
        if B == 1:
            single = ts.ring_init(worlds[0], depth)
            for frame in frames:
                _, one = ts.ring_save(single, worlds[0], frame)
            check(torch.equal(rings.frames[0], single.frames)
                  and torch.equal(rings.checksums[0], single.checksums)
                  and torch.equal(one, lanes[0])
                  and all(same_bytes(a[0], b) for a, b in zip(
                      world_leaves(ts, rings.states), world_leaves(ts, single.states))),
                  "B=1 differs from the single-world save")
        print(f"batched save {label} B={B} depth {depth}: rings, frames, digests and lanes "
              f"bitwise equal to the plain version over {len(frames)} saves"
              + (", lanes through a strided [:, t] view" if strided else "")
              + (" and to the single-world save" if B == 1 else ""))


def batched_save_times(ts, tck) -> dict:
    """The batched save's device time (graph replay) at the timed branch
    counts, beside its least time: B worlds read once and written once,
    with their digests and frames, over the memory rate, or the hash's
    integer operations at the int32 rate."""
    out = {}
    for B in SPEC_TIMED_BRANCHES:
        worlds = box_branch_worlds(ts, B, "cuda", seed=B + 1)
        state = branch_worlds(ts, worlds)
        rings = ts.branch_rings(worlds[0], B, 8)
        lay = tck.layout(state)
        world_bytes = sum(p.row_bytes for p in lay.parts)
        words = sum(p.words for p in lay.parts if p.role not in (tck.ALIVE, tck.RESOURCE))
        ops = (int(state.alive.sum()) * (words * CHECKSUM_OPS_PER_WORD + FMIX_OPS)
               + B * lay.resource_words * (CHECKSUM_OPS_PER_WORD + FMIX_OPS))
        moved = B * (2 * world_bytes + 2 * 16 + 4)
        t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_I32_PER_S * 1e3
        plain = clone_ring(ts, rings)
        singles = [ts.ring_init(w, 8) for w in worlds]

        def serial():  # the B single-world saves the batched save replaces
            for ring, world in zip(singles, worlds):
                ts.ring_save(ring, world, 3)

        out[f"B{B}"] = {
            "ms": graph_ms(lambda: ts.ring_save(rings, state, 3)),
            "call_ms": cuda_ms(lambda: ts.ring_save(rings, state, 3)),
            "plain_ms": cuda_ms(lambda: tck.save_plain(plain, state, 3), iters=20),
            "serial_ms": graph_ms(serial, iters=4),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": moved, "ops": ops, "world_bytes": world_bytes,
        }
        m = out[f"B{B}"]
        print(f"batched save box_game B={B} ({world_bytes} bytes a world): device "
              f"{m['ms']:.6f} ms (graph replay), per call with host work {m['call_ms']:.6f} ms, "
              f"plain {m['plain_ms']:.6f} ms a call; {B} single-world saves (one graph of "
              f"{B} launches) {m['serial_ms']:.6f} ms of device time; bound "
              f"{m['bound_ms']:.7f} ms ({m['bound_by']}: {moved} bytes, {ops} ops)")
    return out


def check_attestation(ts, device: str = "cuda", branches: int = SPEC_BRANCHES,
                      spec_frames: int = P2P_MAX_PREDICTION, model=None,
                      label: str = "box_game") -> dict:
    """A runner's warmup attestation at ``branches`` x ``spec_frames``: it
    passes with every branch of both tensors replayed (``real_checked``
    2B), and leaves the live ring bitwise as it was. ``model`` is
    ``(schedule, committed world, input spec)``, box_game's by default."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

    schedule, world, input_spec = model or (
        box_game.make_schedule(), box_game.make_world(2, device=device).commit(),
        box_game.INPUT_SPEC)
    runner = SpeculativeRollbackRunner(
        schedule, world, max_prediction=P2P_MAX_PREDICTION, num_players=2,
        input_spec=input_spec, num_branches=branches, spec_frames=spec_frames,
        device=device)
    before = clone_ring(ts, runner.ring)
    state = [t.clone() for t in world_leaves(ts, runner.state)]
    t0 = time.perf_counter()
    runner.warmup()
    seconds = time.perf_counter() - t0
    report = runner.attestation
    check(report is not None and report.ok and runner.speculation_enabled,
          f"attestation {label} failed: {report}")
    check(report.scanned_branches == branches and report.structured_checked
          and report.real_checked == 2 * branches, f"attestation {label} coverage: {report}")
    check(torch.equal(before.frames, runner.ring.frames)
          and torch.equal(before.checksums, runner.ring.checksums)
          and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, before.states),
                                                   world_leaves(ts, runner.ring.states)))
          and all(same_bytes(a, b) for a, b in zip(state, world_leaves(ts, runner.state)))
          and runner.frame == 0, f"the attestation of {label} changed the live ring or state")
    out = {"ok": report.ok, "real_checked": report.real_checked,
           "scanned_branches": report.scanned_branches, "frames": report.frames,
           "warmup_seconds": seconds, "rollouts": runner.spec_rollouts_total}
    print(f"attestation {label} B={branches} F={spec_frames} on {device}: "
          + json.dumps(out) + "; the live ring and state bitwise unchanged")
    return out


def spec_peer_numbers(run: P2PRun, spec: bool) -> list:
    """Per peer: ticks, recovery ticks, the speculation counters and the
    host time of the speculating tick."""
    out = []
    for peer in run.peers:
        runner = peer["app"].stage.runner
        rec = np.asarray(peer.get("recovery_ticks", [0.0]))
        entry = {"ticks": tick_stats(peer["ticks"]),
                 "recovery_ticks": {"p50_ms": float(np.percentile(rec, 50)),
                                    "p99_ms": float(np.percentile(rec, 99)),
                                    "ticks": len(peer.get("recovery_ticks", []))},
                 "rollbacks": runner.rollbacks_total,
                 "resimulated_frames": runner.rollback_frames_total}
        if spec:
            host = np.asarray(runner.metrics.series.get("spec_host_dispatch_ms", [0.0]))
            entry.update({
                "spec_hits": runner.spec_hits, "spec_partial_hits": runner.spec_partial_hits,
                "spec_misses": runner.spec_misses,
                "spec_dispatches_skipped": runner.spec_dispatches_skipped,
                "frames_recovered": runner.rollback_frames_recovered_total,
                "spec_host_dispatch_ms": {"mean": float(host.mean()),
                                          "p99": float(np.percentile(host, 99))},
                "rollouts": peer["counts"]["spec_rollouts_total"],
            })
        out.append(entry)
    return out


def check_spec_launches(label: str, run: P2PRun, spec_frames: int) -> None:
    """On each peer the checksum kernel ran once per save into the
    session's ring, once per restore guard and ``spec_frames`` times per
    rollout (every branch of a frame in one launch)."""
    for i, peer in enumerate(run.peers):
        c = peer["counts"]
        want = (c["saves_total"] + c["restore_guards_total"]
                + spec_frames * c["spec_rollouts_total"])
        got = peer["launches"].get("world_checksum", 0)
        check(got == want, f"{label} peer {i}: {got} checksum launches, {c['saves_total']} "
                           f"saves + {c['restore_guards_total']} guards + {spec_frames} x "
                           f"{c['spec_rollouts_total']} rollouts")


def spec_phase(kernels, ts, tck, frames: int = 600, branches: int = SPEC_BRANCHES,
               device: str = "cuda") -> dict:
    """Phase 11's P2P runs: box_game, 2 peers speculating with
    ``branches`` branches, against the same run with speculation off and
    (on the card) the same run on the CPU."""
    on_card = device == "cuda"
    card = smi() if on_card else "cpu"

    def box(spec):
        return lambda dev, inputs: box_app(dev, inputs, players=2, speculation=spec)

    def play(spec, dev, n):
        if on_card and dev == "cuda":
            reset_counts(kernels)
        run = P2PRun(box(spec), dev, 2, seed=5, frames=n, inputs=held_key_runs)
        run.run(kernels, ts, tck, max_seconds=300.0)
        return run, run.summary(f"spec box_game 2 peers B={spec} on {dev}")

    results = {}
    on_run, on = play(branches, device, frames)
    off_run, off = play(0, device, frames)
    spec_frames = on_run.peers[0]["app"].stage.runner.spec_frames
    for i, peer in enumerate(on_run.peers):
        runner = peer["app"].stage.runner
        check(runner.speculation_enabled, f"spec peer {i}: speculation disabled")
        check(runner.spec_hits + runner.spec_partial_hits > 0,
              f"spec peer {i}: no speculative hit in {runner.rollbacks_total} rollbacks")
    streams = {"on": [on_run.confirmed_stream(p) for p in on_run.peers],
               "off": [off_run.confirmed_stream(p) for p in off_run.peers]}
    others = [("off", off_run)]
    if on_card:
        cpu_run, _ = play(branches, "cpu", frames)
        streams["cpu"] = [cpu_run.confirmed_stream(p) for p in cpu_run.peers]
        others.append(("cpu", cpu_run))
    for name, other in others:
        need = min(30, min(frames, other.frames) // 20)  # exchanges: one every 8 frames
        for i, (a, b) in enumerate(zip(streams["on"], streams[name])):
            common = sorted(set(a) & set(b))
            check(len(common) >= need, f"spec peer {i}: {len(common)} frames in common "
                                       f"with the {name} run, fewer than {need}")
            check(all(a[f] == b[f] for f in common),
                  f"spec peer {i}: the confirmed stream differs from the {name} run's")
            print(f"spec box_game peer {i}: speculating stream on {device} {len(a)} frames, "
                  f"{name} run {len(b)} frames, {len(common)} in common, bitwise equal")
    if on_card:
        check_spec_launches("spec box_game", on_run, spec_frames)
        check_p2p_launches("spec off box_game", off)
    # Read every number before the profiled render frame, which steps the
    # runs once more and would add its launches, counts and tick.
    results["on"] = {"peers": spec_peer_numbers(on_run, True),
                     "launches": [dict(p["launches"]) for p in on_run.peers],
                     "counts": [dict(p["counts"]) for p in on_run.peers],
                     "confirmed_checksums": on["confirmed_checksums"], "seconds": on["seconds"]}
    results["off"] = {"peers": spec_peer_numbers(off_run, False),
                      "confirmed_checksums": off["confirmed_checksums"],
                      "seconds": off["seconds"]}
    for key, run in (("on", on_run), ("off", off_run)):
        results[key]["busy"] = p2p_busy(run, kernels, ts, tck, iters=1) if on_card else None
    for key in ("on", "off"):
        for i, peer in enumerate(results[key]["peers"]):
            print(f"spec box_game speculation {key} peer {i}: " + json.dumps(peer) + f"; {card}")
        print(f"spec box_game speculation {key}: busy " + json.dumps(results[key]["busy"])
              + f", {results[key]['confirmed_checksums']} confirmed frames, "
              f"{results[key]['seconds']:.1f} s; {card}")
    return results


# ---------------------------------------------------------------------------
# Phase 11: boids under speculation
# ---------------------------------------------------------------------------

# BASELINE.md config 4: 1,024 boids x 128 branches x 8 frames, kernel="mxu".
BOIDS_SPEC_BRANCHES = 128
BOIDS_SPEC_N = 1024
# The warmup attestations: (label, kernel, mode, boids, branches, the
# force kernel the path launches); F = 8.
BOIDS_ATTESTATIONS = (
    ("mxu-1024", "mxu", "dense", 1024, 128, "pairwise_force_rows_mxu2"),
    ("pallas-1024", "pallas", "dense", 1024, 16, "pairwise_force_rows"),
    ("mxu-4096-tri", "mxu", "dense", 4096, 8, "pairwise_force_square_mxu_tri"),
    ("mxu-grid-32768", "mxu", "grid", 32768, 2, "cell_slot_forces"),
)


def branch_flocks(branches: int, base_pos, seed: int):
    """``branches`` flocks on the card, ``[B, n, ...]``, from the positions
    ``base_pos [n, 2]``: each branch's positions jittered by up to 0.02 and
    its velocities its own (up to 0.05), every 7th boid inactive."""
    n = base_pos.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    jitter = (torch.rand((branches, n, 2), generator=g, device="cuda") - 0.5) * 0.04
    vel = (torch.rand((branches, n, 2), generator=g, device="cuda") - 0.5) * 0.1
    active = torch.ones((branches, n), device="cuda")
    active[:, ::7] = 0.0
    return (base_pos[None] + jitter).contiguous(), vel, active


def batched_grid_operands(tnb, boids, pos, vel, active, config):
    """The cell kernel's ``[B, C, ...]`` operands for a ``[B]`` world, as
    ``slot_forces`` gathers them, and the binning."""
    grid, cand, padded = tnb.build_grid_tables(
        pos, active, config, {"vx": vel[..., 0], "vy": vel[..., 1]})
    rowvals, colvals = tnb.gather_tables(boids.FLOCK_PAIR_KERNEL, grid.slots, cand, padded)
    return grid, rowvals, colvals


def branch_case(label: str, batched, singles, plain, atol_of, bound: dict) -> dict:
    """A force kernel over a ``[B]`` world: bitwise the B unbatched launches
    ``singles``, and within ``atol_of(largest force)`` of the batched plain
    version; returns the call's pieces for the times."""
    got = batched()
    one = torch.stack([f() for f in singles])
    again = batched()
    torch.cuda.synchronize()
    check(torch.equal(got, one), f"{label}: the batched launch differs from "
                                 f"{len(singles)} unbatched launches")
    check(torch.equal(got, again), f"{label}: launch to launch")
    want = plain()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(scale > 1e-3, f"{label}: forces all near zero")
    check(err <= atol_of(scale), f"{label}: error {err} over {atol_of(scale)}")
    print(f"{label}: bitwise equal to {len(singles)} unbatched launches; max_abs_err="
          f"{err:.3e} against the batched plain version (limit {atol_of(scale):.3e}, "
          f"largest force {scale:.4f})")
    return {"label": label, "batched": batched, "singles": singles, "plain": plain,
            "err": err, "bound": bound}


def check_batched_forces(tpw, tcg, tnb, boids, params) -> dict:
    """Each force kernel over a leading branch axis on the card, at the
    speculative paths' shapes and at ragged ones: bitwise equal to B
    unbatched launches, within its tolerance of its batched plain version.
    Returns, per kernel, its worst error and the case at the phase-11
    shape (timed later)."""
    spiral = {n: boids.make_world(n, 2, device="cuda").commit().components["position"]
              for n in (1000, 1024, 4096, 4100)}
    out = {"pairwise_force_rows": {"err": 0.0}, "pairwise_force_rows_mxu2": {"err": 0.0},
           "pairwise_force_square_mxu_tri": {"err": 0.0}, "cell_slot_forces": {"err": 0.0}}

    def keep(name, case, timed):
        out[name]["err"] = max(out[name]["err"], case["err"])
        if timed:
            out[name]["case"] = case

    def rows_case(fn, plain, B, n, rows, seed):
        pos, vel, act = branch_flocks(B, spiral[n], seed)
        args = (pos[:, rows].contiguous(), vel[:, rows].contiguous(), pos, vel,
                act[:, rows].contiguous(), act)
        return args, (lambda: fn(*args, **params)), [
            (lambda b=b: fn(*(a[b] for a in args), **params)) for b in range(B)], (
            lambda: plain(*args, **params))

    for B, n, rows, timed in ((16, 1024, slice(0, 1024), True), (3, 1000, slice(0, 1000), False)):
        args, batched, singles, plain = rows_case(
            tpw.pairwise_force_rows, tpw.pairwise_force_rows_plain, B, n, rows, seed=B)
        r = args[0].shape[1]
        keep("pairwise_force_rows", branch_case(
            f"f32 over branches B={B} R={r} N={n}", batched, singles, plain,
            lambda scale: FORCE_ATOL,
            {"nbytes": B * (r * 5 + n * 5 + r * 2) * 4, "ops": B * r * n * FORCE_OPS_PER_PAIR}),
             timed)
    for B, n, rows, timed in ((BOIDS_SPEC_BRANCHES, 1024, slice(0, 1024), True),
                              (3, 1000, slice(0, 65), False), (1, 1024, slice(0, 1024), False)):
        args, batched, singles, plain = rows_case(
            tpw.pairwise_force_rows_mxu2, tpw.pairwise_force_rows_mxu2_plain, B, n, rows,
            seed=100 + B)
        r = args[0].shape[1]
        p, row_blocks = tpw.mxu2_launch_shape(r, n)
        keep("pairwise_force_rows_mxu2", branch_case(
            f"mxu2 over branches B={B} R={r} N={n} (cluster {p} x {row_blocks} row blocks "
            f"x {B} branches)", batched, singles, plain, lambda scale: MXU_RTOL * scale,
            {"nbytes": B * (r * 5 + n * 5 + r * 2) * 4, "ops": B * r * n * MXU_MASK_OPS_PER_PAIR,
             "tc_flops": B * r * n * MXU_TC_FLOPS_PER_PAIR}), timed)
    def tri_case(B, n, seed):
        args = branch_flocks(B, spiral[n], seed)
        fn, plain = tpw.pairwise_force_square_mxu_tri, tpw.pairwise_force_square_mxu_tri_plain
        return branch_case(
            f"tri over branches B={B} N={n}", lambda: fn(*args, **params),
            [(lambda b=b: fn(*(a[b] for a in args), **params)) for b in range(B)],
            lambda: plain(*args, **params), lambda scale: MXU_RTOL * scale,
            {"nbytes": B * n * 7 * 4, "ops": B * n * (n + 1) // 2 * MXU_MASK_OPS_PER_PAIR,
             "tc_flops": B * n * n * MXU_TC_FLOPS_PER_PAIR})

    for B, n, timed in ((8, 4096, True), (2, 4100, False)):
        keep("pairwise_force_square_mxu_tri", tri_case(B, n, seed=200 + B), timed)
    kernel = boids.FLOCK_PAIR_KERNEL
    big = boids.make_world(32768, 2, device="cuda").commit().components["position"]
    rng = np.random.RandomState(3)
    clustered = torch.from_numpy(rng.uniform(-1.5, 1.5, (600, 2)).astype(np.float32)).cuda()
    for label, B, base, n, timed in (("boids-32768", 2, big, 32768, True),
                                     ("clustered-600", 4, clustered, 600, False)):
        pos, vel, act = branch_flocks(B, base, seed=300 + B)
        config = boids.grid_config(n)
        grid, rowvals, colvals = batched_grid_operands(tnb, boids, pos, vel, act, config)
        if label.startswith("clustered"):
            check(bool((grid.n_spilled > 0).all()) and bool((grid.n_dropped == 0).all()),
                  f"cell {label}: every branch must spill and none drop")
        pairs = live_pairs(rowvals, colvals)
        C, K, M = config.num_cells, config.cell_capacity, config.padded_cols
        keep("cell_slot_forces", branch_case(
            f"cell over branches {label} B={B} C={C} K={K} M={M} (spilled "
            f"{grid.n_spilled.tolist()}, pairs computed {pairs})",
            lambda rv=rowvals, cv=colvals: torch.stack(tcg.cell_slot_forces(kernel, rv, cv), -1),
            [(lambda b=b, rv=rowvals, cv=colvals: torch.stack(tcg.cell_slot_forces(
                kernel, {k: v[b] for k, v in rv.items()}, {k: v[b] for k, v in cv.items()}), -1))
             for b in range(B)],
            lambda rv=rowvals, cv=colvals: torch.stack(
                tcg.cell_slot_forces_plain(kernel, rv, cv), -1),
            lambda scale: CELL_ATOL,
            {"nbytes": B * (len(kernel.row_names) * C * K + len(kernel.col_names) * C * M
                            + kernel.out_dim * C * K) * 4, "ops": pairs * FORCE_OPS_PER_PAIR}),
             timed)
    return out


def batched_times(case: dict) -> dict:
    """A batched kernel's device time (graph replay) and per-call time,
    beside B unbatched launches captured in one graph, the batched plain
    version's per-call time and the bound: the batch's bytes over the
    memory rate or its operations over their units' rates (B times one
    world's bound)."""
    b = case["bound"]
    t_bytes = b["nbytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = max(b["ops"] / PEAK_F32_PER_S, b.get("tc_flops", 0) / PEAK_BF16_TC_PER_S) * 1e3
    singles = case["singles"]
    out = {
        "B": len(singles),
        "ms": graph_ms(case["batched"]),
        "call_ms": cuda_ms(case["batched"], iters=50),
        "unbatched_ms": graph_ms(lambda: [f() for f in singles], iters=4, replays=10),
        "plain_call_ms": cuda_ms(case["plain"], iters=3, warmup=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    print(f"{case['label']}: device {out['ms']:.6f} ms (graph replay), per call with host "
          f"work {out['call_ms']:.6f} ms; {out['B']} unbatched launches in one graph "
          f"{out['unbatched_ms']:.6f} ms; batched plain version {out['plain_call_ms']:.4f} ms "
          f"a call; bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def boids_attestations(kernels, force_kernels, ts, boids, device: str = "cuda",
                       cases=BOIDS_ATTESTATIONS,
                       spec_frames: int = P2P_MAX_PREDICTION) -> dict:
    """The warmup attestation of a boids runner on each path, fresh (the
    memo off): ok with every branch of both tensors replayed. On the card,
    counted around each warmup, the path's force kernel ran F times per
    rollout (every branch at once) and F times per replayed branch, and no
    other force kernel ran."""
    import os

    out = {}
    memo = os.environ.get("GGRS_ATTEST_CACHE")
    os.environ["GGRS_ATTEST_CACHE"] = "0"
    try:
        for label, kernel, mode, n, branches, force in cases:
            model = (boids.make_schedule(kernel=kernel, mode=mode),
                     boids.make_world(n, 2, device=device).commit(), boids.INPUT_SPEC)
            if device == "cuda":
                reset_counts(kernels)
            att = check_attestation(ts, device, branches, spec_frames, model=model,
                                    label=f"boids {label}")
            if device == "cuda":
                launches = {fn.__name__: fn.launches for fn in force_kernels}
                want = (att["rollouts"] + 2 * branches) * spec_frames
                check(launches[force] == want and all(
                    v == 0 for k, v in launches.items() if k != force),
                    f"attestation boids {label}: launches {launches}, want {force} = "
                    f"({att['rollouts']} rollouts + {2 * branches} replays) x {spec_frames}")
                att.update(launches=launches[force],
                           batched_launches=att["rollouts"] * spec_frames)
                print(f"attestation boids {label}: {force} launches {launches[force]} = "
                      f"{att['rollouts']} rollouts x {spec_frames} (one launch a frame for all "
                      f"{branches} branches) + {2 * branches} serial replays x {spec_frames}")
            out[label] = att
    finally:
        if memo is None:
            os.environ.pop("GGRS_ATTEST_CACHE", None)
        else:
            os.environ["GGRS_ATTEST_CACHE"] = memo
    return out


def check_boids_spec_launches(label: str, run: P2PRun, spec_frames: int, force: str,
                              others) -> list:
    """On each peer the force kernel ran once per frame advanced serially
    (the advances the session asked for, less the frames a hit copied) and
    ``spec_frames`` times per rollout, and no other force kernel ran;
    returns each peer's launches a rollout, read from the counters."""
    per_rollout = []
    for i, peer in enumerate(run.peers):
        c = peer["counts"]
        serial = peer["log"]["advances"] - c["rollback_frames_recovered_total"]
        got = peer["launches"].get(force, 0)
        want = serial + spec_frames * c["spec_rollouts_total"]
        check(got == want, f"{label} peer {i}: {force} launches {got}, {serial} serial "
                           f"advances + {spec_frames} x {c['spec_rollouts_total']} rollouts")
        check(all(peer["launches"].get(k, 0) == 0 for k in others),
              f"{label} peer {i}: another force kernel ran: {peer['launches']}")
        per_rollout.append((got - serial) / max(1, c["spec_rollouts_total"]))
    return per_rollout


def boids_spec_phase(kernels, force_kernels, ts, tck, tpw, frames: int = 300,
                     branches: int = BOIDS_SPEC_BRANCHES, n: int = BOIDS_SPEC_N,
                     device: str = "cuda") -> dict:
    """Phase 11's boids P2P runs: ``n`` boids, ``kernel="mxu"``, 2 peers
    speculating with ``branches`` branches, against the same run with
    speculation off."""
    from bevy_ggrs_tpu_torch.models import boids

    on_card = device == "cuda"
    card = smi() if on_card else "cpu"
    schedule = boids.make_schedule(kernel="mxu")
    label = f"spec boids-{n} mxu"

    def play(spec):
        if on_card:
            reset_counts(kernels)
        run = P2PRun(lambda dev, inputs: boids_app(n, dev, schedule, inputs, speculation=spec),
                     device, 2, seed=5, frames=frames, inputs=held_key_runs)
        run.run(kernels, ts, tck, max_seconds=300.0)
        return run, run.summary(f"{label} 2 peers B={spec} on {device}")

    on_run, on = play(branches)
    off_run, off = play(0)
    spec_frames = on_run.peers[0]["app"].stage.runner.spec_frames
    for i, peer in enumerate(on_run.peers):
        runner = peer["app"].stage.runner
        check(runner.speculation_enabled, f"{label} peer {i}: speculation disabled")
        check(runner.spec_hits + runner.spec_partial_hits > 0,
              f"{label} peer {i}: no speculative hit in {runner.rollbacks_total} rollbacks")
    need = min(30, frames // 20)
    for i, (a, b) in enumerate(zip(on_run.peers, off_run.peers)):
        on_s, off_s = on_run.confirmed_stream(a), off_run.confirmed_stream(b)
        common = sorted(set(on_s) & set(off_s))
        check(len(common) >= need, f"{label} peer {i}: {len(common)} frames in common with "
                                   f"the run without speculation, fewer than {need}")
        check(all(on_s[f] == off_s[f] for f in common),
              f"{label} peer {i}: the confirmed stream differs from the run without speculation")
        print(f"{label} peer {i}: speculating stream {len(on_s)} frames, without speculation "
              f"{len(off_s)} frames, {len(common)} in common, bitwise equal")
    results = {}
    force = tpw.pairwise_force_rows_mxu2.__name__
    others = [k.__name__ for k in force_kernels if k.__name__ != force]
    if on_card:
        check_spec_launches(label, on_run, spec_frames)
        results["mxu2_launches_per_rollout"] = check_boids_spec_launches(
            label, on_run, spec_frames, force, others)
        check_p2p_launches(f"{label} speculation off", off, force=force, others=others)
    results["on"] = {"peers": spec_peer_numbers(on_run, True),
                     "launches": [dict(p["launches"]) for p in on_run.peers],
                     "counts": [dict(p["counts"]) for p in on_run.peers],
                     "advances": [p["log"]["advances"] for p in on_run.peers],
                     "confirmed_checksums": on["confirmed_checksums"], "seconds": on["seconds"]}
    results["off"] = {"peers": spec_peer_numbers(off_run, False),
                      "launches": [dict(p["launches"]) for p in off_run.peers],
                      "confirmed_checksums": off["confirmed_checksums"],
                      "seconds": off["seconds"]}
    for key, run in (("on", on_run), ("off", off_run)):
        results[key]["busy"] = p2p_busy(run, kernels, ts, tck, iters=1) if on_card else None
    for key in ("on", "off"):
        for i, peer in enumerate(results[key]["peers"]):
            print(f"{label} speculation {key} peer {i}: " + json.dumps(peer) + f"; {card}")
        print(f"{label} speculation {key}: busy " + json.dumps(results[key]["busy"])
              + f", {results[key]['confirmed_checksums']} confirmed frames, "
              f"{results[key]['seconds']:.1f} s; {card}")
    if on_card:
        print(f"{label}: {force} launches a rollout on each peer, read from the counters: "
              + json.dumps(results["mxu2_launches_per_rollout"]))
    return results


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

    phase("10 P2P and spectator sessions on cuda")
    p2p = p2p_phase(kernels, force_kernels, ts, tck, tpw)
    p2p_runs = [r for label, r in p2p.items() if label != "box2_cpu"]
    ck["launches"] += sum(peer["launches"].get("world_checksum", 0)
                          for r in p2p_runs for peer in r["peers"])
    mxu2["launches"] += sum(peer["launches"].get("pairwise_force_rows_mxu2", 0)
                            for peer in p2p["boids1024_mxu"]["peers"])
    print("p2p busy " + json.dumps(p2p["box2"]["busy"]))

    phase("11 speculation on cuda")
    check_batched_save(ts, tck, boids)
    ck["batched_save"] = batched_save_times(ts, tck)
    attestation = check_attestation(ts)
    spec = spec_phase(kernels, ts, tck)
    ck["launches"] += sum(l.get("world_checksum", 0) for l in spec["on"]["launches"])
    # Checksum launches a rollout of B branches x F frames made on each
    # peer: the launches past the session ring's saves and guards, over the
    # rollouts dispatched (F with the batched save, B x F without it).
    ck["launches_per_rollout"] = [
        (l.get("world_checksum", 0) - c["saves_total"] - c["restore_guards_total"])
        / c["spec_rollouts_total"]
        for l, c in zip(spec["on"]["launches"], spec["on"]["counts"])]
    print("spec " + json.dumps({"attestation": attestation,
                                "counts": spec["on"]["counts"]}))

    phase("11b boids under speculation on cuda")
    batched = check_batched_forces(tpw, tcg, tnb, boids, params)
    boids_att = boids_attestations(kernels, force_kernels, ts, boids)
    boids_spec = boids_spec_phase(kernels, force_kernels, ts, tck, tpw)
    runs = [boids_spec["on"]["launches"], boids_spec["off"]["launches"]]
    ck["launches"] += sum(l.get("world_checksum", 0) for r in runs for l in r)
    entries = {"pairwise_force_rows": forces[1024], "pairwise_force_rows_mxu2": mxu2,
               "pairwise_force_square_mxu_tri": tri, "cell_slot_forces": cell}
    att_of = {force: boids_att[label] for label, *_, force in BOIDS_ATTESTATIONS}
    for name, entry in entries.items():
        entry["max_abs_err"] = max(entry["max_abs_err"], batched[name]["err"])
        entry["batched"] = batched_times(batched[name]["case"])
        entry["launches"] += att_of[name]["launches"]
        entry["batched"]["launches"] = att_of[name]["batched_launches"]
    # The P2P runs' launches: serial frames and, on the speculating run, F
    # batched launches a rollout.
    mxu2["launches"] += sum(l.get("pairwise_force_rows_mxu2", 0) for r in runs for l in r)
    mxu2["batched"]["launches"] += P2P_MAX_PREDICTION * sum(
        c["spec_rollouts_total"] for c in boids_spec["on"]["counts"])
    mxu2["batched"]["launches_per_rollout"] = boids_spec["mxu2_launches_per_rollout"]
    print("spec boids " + json.dumps({"attestations": boids_att,
                                      "counts": boids_spec["on"]["counts"],
                                      "advances": boids_spec["on"]["advances"]}))
    phase(None)
    print(json.dumps({"kernels": [ck, forces[1024], mxu2, tri, cell]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
