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
   Then box_game's step on the card over 500 seeded frames (4 cubes, a
   held stretch into the speed clamp), read back every 50 frames bitwise
   the port's own NumPy oracle ``box_game.step_np``; and the checksum
   hook: ``state.set_checksum_impl(checksum_plain)`` installed, then
   removed, on the last box_game world and a boids-1,024 world, each time
   6 saves, the ring's digests, attestation, 4 guards and a live digest,
   the ring's bytes and every digest bitwise the kernel route's, with 13
   kernel launches before, none while installed and 13 after (these
   comparison launches are not counted in the kernel table).
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
   120 frames; box_game, 2 peers over real UDP on 127.0.0.1 through the
   native ``recvmmsg`` poller, 120 frames on the wall clock. Every
   session's queues and tracker, every speculating runner's branch builder
   and input log, and every UDP socket are on the native data plane
   (``bevy_ggrs_tpu_torch/native``, built with ``g++``), here and in
   phases 4-12. In every run both peers reach RUNNING, no
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
   at B = 64 and 256 beside its bytes bound. ``SpeculativeExecutor.run``'s
   CUDA graph (boids-1,024 mxu at B = 128 and box_game at B = 64, F = 8):
   the capturing call and replays at the captured start frame and at
   another, from another world, each bitwise the eager
   ``rollout_branches`` (rings' bytes, frames, lanes, final states,
   stream); a result unchanged by two later calls; the wrappers'
   launches over N replays equal to N eager rollouts'; under
   ``torch.profiler`` a replay is one ``cudaGraphLaunch`` running F
   launches of each of the eager rollout's hand-written kernels; and
   each call's host ms, eager and replayed. The warmup attestation of a
   box_game runner at B = 64, F = 8 (``ok``, ``real_checked``,
   ``scanned_branches``), the live ring bitwise unchanged by it. Then
   box_game, 2 peers, both ``with_speculation(64)``, 600 frames over phase
   10's lossy loopback (no chaos) on seeded held-key runs: both RUNNING, no
   ``DESYNC_DETECTED``, hits (full or partial) on each peer, and the
   confirmed checksum stream bitwise equal to the same run with
   speculation off and to the same run on the CPU; on each peer the checksum kernel ran once per serial save, once per restore guard and F
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
   peer as box_game's.

12. BASELINE.md config 5 on the native data plane. The batched save of
   1,024 8-player box_game worlds into ``[1024, 12]`` rings (the rollout's
   shape, lanes through ``lanes[:, t]``) bitwise against its plain
   version, and timed beside its bound. Then box_game, 8 peers and a
   spectator of peer 0, ``max_prediction`` 12, no input delay, peer 0
   ``with_speculation(1024)`` (12 frames), over a loopback of 2 frames'
   latency, 1 frame's jitter and 2 % loss (seed 7) on the JAX bench's key
   script, ``CONFIG5_FRAMES`` frames, four times in turns: on the native
   plane, under ``GGRS_NO_NATIVE=1`` on the Python one, Python again and
   native again, in turns in one child process (``chip_smoke.py
   --config5``) with ``PYTHONHASHSEED=0``; the first leg attests and the
   others reuse its memoized verdict. Each leg checks
   its plane on every peer, RUNNING, no ``DESYNC_DETECTED``, equal
   confirmed streams, the spectator's checksums equal to the host's, the
   attestation at 1,024 x 12 (``real_checked`` 2,048), a hit, and checksum
   launches = saves + guards + 12 x rollouts on every peer. All four legs
   give equal speculation counters on peer 0 and equal confirmed streams
   on every peer and on the spectator. Per peer and leg: ticks, recovery
   ticks, rollbacks, and on peer 0 the host pieces
   (``structured_bits_build``, ``known_inputs_query``, ``match_branch``,
   ``spec_host_dispatch``); the spectator's lag in frames; the busy share
   of one profiled render frame. Every phase prints its wall seconds.

13. projectiles and neural_bots. The exact primitives of
   ``ops/exact.py`` on the card against their cpu runs, bitwise:
   ``int_matmul`` at neural_bots' shapes (512 bots, H = 32, 256 and 512,
   batched over 32 branches) and the ranker's (396 and 32 deep), and
   ``tanh_f32`` and ``sqrt_f32`` on 1 M float32 values with the edges (NaN
   to NaN on both); what PyTorch's own integer products do on the card is
   printed. The checksum kernel's three modes bitwise their plain versions
   on a projectiles world after spawns and despawns and on a neural_bots
   H = 512 world (its dict resource ``policy``: int8 and float32 leaves);
   the batched save of 64 projectiles worlds and of 32 neural_bots H = 512
   worlds into ``[B, 8]`` rings bitwise and timed beside its bound.
   SyncTests at ``check_distance`` 7, cuda against cpu bitwise, the
   checksum kernel once per save and guard and no force kernel:
   projectiles (4 players, capacity 64, the live zoo's script with FIRE)
   for 300 frames in dense and in grid mode, the two streams bitwise
   equal (ids minted, live entities and scores printed; the grid is held
   against the dense cpu run); neural_bots (512 bots, 2 players) for 300
   frames at H = 32 and 60 at H = 256 and 512, their cpu runs a prefix
   (``BOT_CPU_FRAMES``). Every cpu run of this phase (its twins) plays in
   a child process started after phase 1 (``--model-twins``, on
   ``TWIN_THREADS`` threads, no GPU), beside the card's runs of phases
   2-13, which wait for a result only when they compare it.
   Then P2P over phase 10's lossy loopback: projectiles, 4 peers each
   ``with_speculation(64)``, and neural_bots, 2 peers each
   ``with_speculation(32)``, 8 frames, ``MODEL_SPEC_FRAMES`` frames, each
   against speculation off and a shorter cpu run (``MODEL_CPU_FRAMES``,
   at least ``TWIN_COMMON_FRAMES`` confirmed frames in common on each
   peer): the attestation of every peer at
   full coverage, no ``DESYNC_DETECTED``, a hit on every peer, the
   confirmed streams bitwise equal, checksum launches = saves + guards +
   8 x rollouts; per peer the speculation counters, ticks, recovery ticks
   and one profiled render frame's busy share.

14. The learned input predictor. ``BatchedRanker`` on the card bitwise
   its cpu run and the host ``BoundPredictor`` rollout at S = 64 slots,
   P = 2 and 8 and F = 8 and 12 on random windows with gaps, ``rank``
   timed a call. Then a fifth leg of config 5 (native plane,
   ``PYTHONHASHSEED=0``) with every session built
   ``with_input_predictor("default")`` and peer 0 seeding its tree with
   it: its confirmed streams equal phase 12's first leg's; peer 0's full /
   partial / misses beside that leg's, ``predictor_rank`` ms and the
   ticks printed.

15. Supervised sessions and checkpoints on ``cuda``: box_game peers
   (16 slots, ``max_prediction`` 8) driven through ``SessionSupervisor``
   over a loopback on its stepped clock, on ``tests/test_supervisor.py``'s
   harness and key script. (a) Three peers; after 40 render frames peer
   2's cubes are moved 1.0 off their trajectory, then 200 more: peer 2
   alone is quarantined once and recovers once by a ring transfer, no
   ``DESYNC_DETECTED`` names a frame after the recovery, and at least 3
   settled frames after it are bitwise equal on all three peers. (b) Two
   peers; peer 1's socket closes at render frame 50 as a ``KillRestart``
   directive scripts it, peer 0 plays 60 frames alone, then a fresh cuda
   peer 1 ``begin_rejoin``s and plays 200: one recovery by a full
   transfer, ``PLAYER_REJOINED`` on peer 0, the freeze window passed, and
   the settled frames after the restart bitwise equal. Every transfer
   digest, served and adopted, is one launch of the checksum kernel and
   equal to ``checksum_plain`` of the same world on the CPU. (c) One ring
   bit flipped (``integrity.flip_ring_bit``) under peers attested every 4
   frames: one ``sdc_faults``, repaired in place bitwise, no quarantine,
   and the checksums and worlds equal to a clean twin's. (d) A SyncTest
   with a ``CheckpointManager`` (every 30 frames, 3 kept) crashes at frame
   100; ``restore_latest`` into a fresh runner and session resumes at 90
   and plays to 200, its stream bitwise the uninterrupted run's and its
   cpu twin's; one bit flipped in the newest file for each of 8 seeds:
   a file that no longer loads makes ``restore_latest`` fall back to the
   one before (one such run plays on to 200, bitwise), one that still
   loads gives the same world, and at least half fall back. (e) The peers
   of (a) carry a ``SpanTracer`` and a ``FlightRecorder``, exported to a
   temporary directory (Perfetto, spans and frames in JSONL,
   ``metrics.prom``): the victim's trace and records hold the health edges
   healthy -> quarantined -> healthy, the Prometheus text its recovery
   counters. One ``supervisor`` line: the counters, recovery latency (on
   the loopback's clock) and frames, transfer chunks and bytes, digests,
   checksum launches, each check, the phase's wall seconds.

16. Batched multi-session serving on ``cuda`` (``serve/``): the checksum
   kernel's save over ``[S]`` slots (a frame and a keep flag a slot, one
   launch) bitwise its plain version at S = 1,024 over random frames
   (negative ones too) and keep-masks, and timed; (a) box_game
   ``BatchedSessionCore`` at the JAX bench's largest serving config (S =
   1,024, 2 players, ``max_prediction`` 4, 8 branches x 4 frames), 120
   ticks of ``bench.py``'s serve script, each tick exactly (burst steps in
   which a slot saved) + 4 checksum launches; at tick 60 64 slots retire
   and 64 fresh matches take them with every build counter
   (``utils.build_cache``) unchanged from warmup; slots 0, 512, 1,023 and
   a churned one bitwise their singleton ``SpeculativeRollbackRunner``
   replays on the card (frame, 64-bit state checksum, ring digests); slots
   0-15 at tick 60 bitwise a cpu twin's; (b) boids-64 at S = 256: the f32
   force kernel once a burst step over the ``[S]`` world and once a
   rollout frame over 2,048 worlds, three slots bitwise their singletons;
   (c) ``MatchServer`` with 64 SyncTest matches (``serve_chaos_S64``'s
   shapes) beside a control server: one session crash fenced and
   readmitted, one ring bit flipped and repaired by ``_attest_sweep``, the
   server killed at frame 120 and restored from its checkpoint; 24 frames
   later every match bitwise the control's, no build counter moved; (d) a
   ``serve`` line: tick p50/p99 over windows of 6 ticks,
   ``matches_per_chip_at_60hz`` (S x 16.7 / p99), launches a tick, the
   host split (``branch_build``, ``arg_assembly``) and the card.

17. The entry points on ``cuda``, as a user starts them. Started together
   as processes: ``examples_torch/box_game_synctest.py`` at
   ``check_distance`` 7 for 120 frames on ``cuda`` and with ``--device
   cpu`` (the printed worlds equal), two ``box_game_p2p.py`` peers over UDP
   on 127.0.0.1 for 120 frames (input delay 20 at 20 fps: zero desync
   events and, on every settled frame both report, equal checksums), and
   ``model_zoo_synctest.py --model boids --entities 1024 --kernel mxu`` for
   60 frames (the tensor-core kernel once per advanced frame). Meanwhile,
   in this process, ``bench_torch.py``'s rows of the headline,
   ``box_game_4p_8f_x_256b``, ``box_game_8p_12f_x_1024b``,
   ``boids_1k_8f_x_128b_mxu`` and ``box_game_recovery_8f_spec_vs_serial``,
   each printed; the headline's rollout checksums on ``cuda`` are bitwise
   the same rollout's on the CPU. The examples print their kernels'
   launches (``--report-metrics``); they join the kernel table.

18. The fleet and the relay on ``cuda`` (``fleet/``, ``relay/``). (a) A
   ``FleetBalancer`` over a loopback network runs two ``MatchServer`` objects at
   ``fleet_migrate_S64``'s shape (2 players, ``max_prediction`` 4, 8
   branches x 3 frames), 16 matches: 4 live migrations over the type 18-21
   wire, then server 0 stops, its heartbeat silence is detected and its
   matches fail over from its on-disk checkpoint. Every match's state
   checksum at its frame is bitwise that of a never-migrated SyncTest
   control of the same match on the CPU (the input script ``(frame*3 +
   handle*5 + match) % 16``); each restored world's kernel checksum on the
   card equals ``checksum_plain`` of its CPU copy; no build counter moves
   after warmup. (b) A ``ProcFleet`` of two ``python -m
   bevy_ggrs_tpu_torch.fleet.proc`` children on ``cuda``, each with a
   stderr file (its tail printed if a child dies unasked): 4 matches
   admitted, one migrated between the children over UDP, the source
   SIGKILLed and its matches failed over to the survivor from the parent's
   re-pack of its checkpoint; 0 matches lost, ``compiles == 0`` in the
   survivor's status and ``bye`` after warmup, the survivor's checksum
   launches from its ``bye`` (counted from the ``rebase_compiles`` command
   sent once the admitted matches serve). (c) A 2-peer box_game P2P match on ``cuda``
   entirely through the root of an in-process depth-2 ``RelayTree`` (root,
   2 mids, 4 leaves); its ``StatePublisher`` streams to 16 spectators at
   the root and 64 at the leaves. Every spectator ends bitwise on the
   publisher's ring row at the stream's head; that row's
   ``checksum_plain`` on the CPU equals the digest the peer's save kernel
   wrote; the peers' settled checksums agree. A ``fleet`` line (migrations,
   failovers, matches lost, each child's warmup seconds and builds) and a
   ``relay`` line (spectators bitwise, published frames and the read-backs
   they cost, the phase's wall seconds) are printed.
19. Sharding on ``cuda`` (``parallel/sharding.py``, ``multihost.py``).
   (a) A world-size-1 NCCL group in this process on ``cuda:0``: an
   entity-meshed box_game SyncTest (``check_distance`` 7) and two
   box_game apps speculating on 64 branches x 8 frames on a 1 x 1 mesh
   (``GGRSPlugin.with_mesh``), each bitwise its unmeshed twin (reported
   checksum streams, worlds, settled checksums). (b) Two ranks on
   ``cuda:0`` as processes (NCCL refuses two ranks on one GPU, so the
   group is gloo and the collectives stage CUDA tensors through host
   buffers): the box_game SyncTest entity-sharded over both ranks;
   boids-1,024 SyncTests through ``make_sharded_schedule`` with the f32
   kernel and with the tensor-core kernel at the whole world's launch
   shape; one ``kernel="xla"`` frame of 32,768 boids sharded over both
   ranks; a B = 128 box_game rollout split 64/64 with commits of branches
   0 and 127 (each owned by the other rank on one rank); each bitwise its
   unsharded twin on the same rank. (c) ``GGRS_SESSION_AXIS=4``: a
   speculating box_game SyncTest and a speculating P2P pair, bitwise the
   singleton. A ``sharding`` line (backends, world sizes, each run's
   equality, collectives, the phase's wall seconds). Then the four force
   kernels at B = 70,000 branches (past gridDim.y's 65,535, folded into
   gridDim.z): branches 0, 65,534, 65,535, 65,536 and the last bitwise
   their unbatched launches and within tolerance of the plain version
   (``branch grid`` line).

The kernel counters are set to 0 just before each SyncTest of phases 4, 5,
8 and 13, each P2P run of phases 10-14 (in the legs' process for 12 and
14), each boids attestation of phase 11, each piece of phase 15, each
tick of phase 16 (each run of its server), each bench row and example
process of phase 17, phase 18's in-process fleet and relay match (the
children set their own to 0 at the ``rebase_compiles`` command sent just
before the migration), and each sharded run of phase 19 (in its rank's
process for (b)), and
read just after (the P2P
runs read them around each peer's update); launches made to compare a kernel with its plain version are not
counted. The last three lines are
the kernel table (JSON), the card's name and power limit, and the result
(JSON).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import pathlib
import re
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


_PHASE = {"name": None, "t0": None, "walls": {}}


def phase(name) -> None:
    """Print the wall seconds the previous phase took, then open the next
    (``None`` closes the last)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        wall = now - _PHASE["t0"]
        _PHASE["walls"][_PHASE["name"].split()[0]] = round(wall, 1)
        print(f"phase {_PHASE['name'].split()[0]} wall {wall:.1f} s", flush=True)
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


# Kineto drops a device record whose time, converted to the host's clock,
# falls outside the profiler's capture window, so a kernel launched at the
# window's first instant may go unrecorded (a guard's 4-byte read has been
# seen recorded without its kernel). The profiled call sits this far inside
# the window on both sides.
PROFILE_MARGIN_S = 0.005


def device_work(fn) -> dict:
    """The CUDA kernels and copies one call of ``fn`` runs, under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": [n for n in names if not n.startswith(("Memcpy", "Memset"))],
            "h2d": [n for n in names if "HtoD" in n],
            "d2h": [n for n in names if "DtoH" in n]}


def check_box_step(ts, box_game, frames: int = 500, players: int = 4, device: str = "cuda"):
    """box_game's step on the card (or ``device``) over ``frames`` seeded
    frames, a held stretch driving the cubes into the speed clamp and the
    plane's edges, read back every 50 frames and held bitwise to the
    port's own NumPy oracle (``box_game.step_np``). Returns the last world
    and the numbers."""
    from bevy_ggrs_tpu_torch.schedule import make_inputs

    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, 16, size=(frames, players)).astype(np.uint8)
    inputs[100:250] = inputs[100]
    world = box_game.make_world(players, device=device).commit()
    host = ts.to_host(world)
    step = box_game.make_schedule()
    bits = torch.from_numpy(inputs).to(device)
    fastest, reads = 0.0, 0
    for f in range(frames):
        world = step(world, make_inputs(bits[f]))
        host = box_game.step_np(host, inputs[f])
        fastest = max(fastest, float(np.linalg.norm(host["components"]["velocity"], axis=1).max()))
        if f % 50 == 49 or f == frames - 1:
            got = ts.to_host(world)
            for name in ("translation", "velocity"):
                check(got["components"][name].tobytes() == host["components"][name].tobytes(),
                      f"box_game step on {device}: {name} differs from step_np at frame {f + 1}")
            check(int(got["resources"]["frame_count"]) == int(host["resources"]["frame_count"])
                  == f + 1, f"box_game step on {device}: frame_count at frame {f + 1}")
            reads += 1
    check(fastest > 0.049, f"box_game step: the speed clamp was not reached ({fastest})")
    out = {"frames": frames, "players": players, "reads": reads, "fastest": fastest,
           "seconds": time.perf_counter() - t0}
    print(f"box_game step: {frames} frames of {players} cubes on {device} bitwise the port's "
          f"step_np at {reads} read-backs (fastest cube {fastest:.6f}, the clamp 0.05), "
          f"{out['seconds']:.2f} s")
    return world, out


def check_checksum_hook(ts, tck, integrity, worlds) -> dict:
    """``state.set_checksum_impl(checksum_plain)`` installed on the card,
    then removed, over ``worlds``: 6 saves into a depth-4 ring, the ring's
    digests, attestation, 4 restore guards and a live digest each time.
    Ring bytes, frames, digests and answers equal the kernel route's; no
    kernel launch while the function is installed, and the route's
    launches again after removal."""
    t0 = time.perf_counter()

    def run(world):
        ring = ts.ring_init(world, 4)
        before = tck.world_checksum.launches
        lanes = torch.stack([ts.ring_save(ring, world, f)[1] for f in range(6)])
        digests = integrity.ring_digests(ring)
        attest = integrity.attest_ring(ring).tolist()
        guards = [integrity.verify_row(ring, f) for f in range(2, 6)]
        live = ts.active_checksum(world)
        if world.device.type == "cuda":
            torch.cuda.synchronize()
        return {"ring": ring, "lanes": lanes, "digests": digests, "attest": attest,
                "guards": guards, "live": live,
                "launches": tck.world_checksum.launches - before}

    def same(a, b) -> bool:
        return (all(same_bytes(x, y) for x, y in zip(world_leaves(ts, a["ring"].states),
                                                     world_leaves(ts, b["ring"].states)))
                and torch.equal(a["ring"].frames, b["ring"].frames)
                and torch.equal(a["ring"].checksums, b["ring"].checksums)
                and all(torch.equal(a[k], b[k]) for k in ("lanes", "digests", "live"))
                and a["attest"] == b["attest"] and a["guards"] == b["guards"])

    out = {}
    try:
        for label, world in worlds:
            route = run(world)
            ts.set_checksum_impl(tck.checksum_plain)
            hooked = run(world)
            ts.set_checksum_impl(None)
            again = run(world)
            check(same(route, hooked) and same(route, again),
                  f"checksum hook {label}: the installed plain checksum's ring or digests "
                  f"differ from the kernel's")
            on_card = world.device.type == "cuda"
            check(route["launches"] == again["launches"] == 13 * on_card
                  and hooked["launches"] == 0,
                  f"checksum hook {label}: kernel launches {route['launches']} with the "
                  f"route, {hooked['launches']} installed, {again['launches']} removed")
            check(route["attest"] == [False] * 4 and route["guards"] == [True] * 4,
                  f"checksum hook {label}: a clean ring attested corrupt")
            out[label] = {"launches": [route["launches"], hooked["launches"],
                                       again["launches"]]}
    finally:
        ts.set_checksum_impl(None)
    out["seconds"] = time.perf_counter() - t0
    print(f"checksum hook: checksum_plain installed then removed, ring bytes, frames, "
          f"digests, attestation and guards bitwise the kernel's; kernel launches (route, "
          f"installed, removed) " + json.dumps(out))
    return out


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
        before = tck.world_checksum.launches
        work = device_work(fn)
        launched = tck.world_checksum.launches - before - 1  # less device_work's warm call
        check(len(work["kernels"]) == 1 and not work["h2d"] and len(work["d2h"]) == d2h,
              f"{name} under the profiler: {work}; the wrapper counted {launched} launch(es)")
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


def held_forces(tpw, label: str, args, params) -> tuple:
    """The f32 force kernel on ``args`` within :data:`FORCE_ATOL` of its
    plain version and bitwise its repeat; returns ``(error, largest
    force)``."""
    a = tpw.pairwise_force_rows(*args, **params)
    b = tpw.pairwise_force_rows_plain(*args, **params)
    c = tpw.pairwise_force_rows(*args, **params)
    if a.is_cuda:
        torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    check(err <= FORCE_ATOL, f"{label}: error {err}")
    check(torch.equal(a, c), f"{label}: launch to launch")
    check(scale > 1e-3, f"{label}: all near zero")
    return err, scale


def check_force_kernel(tpw, params) -> float:
    worst = 0.0
    for n, rows in FORCE_CASES:
        pos, vel, act = flock_inputs(n, seed=n)
        args = (pos[rows].contiguous(), vel[rows].contiguous(), pos, vel,
                act[rows].contiguous(), act)
        err, scale = held_forces(tpw, f"forces N={n} rows={rows}", args, params)
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
            geo = tpw.mxu2_geometry(1, args[0].shape[0], n_cols)
            err = held(f"mxu2 {data} R={args[0].shape[0]} (rows {rows.start}:{rows.stop}) "
                       f"N={n_cols} {geo.ranks} ranks, {geo.warp_tiles} row tiles a warp, "
                       f"{geo.blocks} blocks",
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
    check_plane("SyncTest", session)
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


def box_app(device, inputs=None, players: int = 2, speculation: int = 0,
            max_prediction: int = 8, predictor=None):
    """A box_game app; ``inputs`` is the input system (default: keys held
    for 20 frames in turn); ``speculation`` branches (0: none, else as many
    frames as ``max_prediction``), with a metrics sink on the runner, and
    ``predictor`` seeding its tree (None: off)."""
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
        .with_max_prediction_window(max_prediction)
        .with_world_capacity(16)
        .with_setup_system(setup)
        .with_device(device)
        .with_speculation(speculation, predictor=predictor if speculation else None)
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
    return busy_of(prof, wall_ms, ticks)


def busy_of(prof, wall_ms: float, ticks: int) -> dict:
    """Per tick of a profiled window: wall ms, the device's busy ms (the
    union of its kernel and copy intervals), the busy share and the four
    costliest kernels' device ms."""
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


def check_plane(label: str, session, runner=None, sock=None) -> None:
    """The session's queues and tracker, the speculative runner's branch
    builder and its input log, and a UDP socket's poller are all the
    native ones, or all the Python ones under ``GGRS_NO_NATIVE=1``."""
    from bevy_ggrs_tpu_torch.native import core as native_core
    from bevy_ggrs_tpu_torch.native import spec as native_spec
    from bevy_ggrs_tpu_torch.native.udp import NativeUdpSocket

    native = not native_core.switched_off()
    why = f" ({native_core.load_error()})" if native_core.load_error() else ""
    parts = {"queues": isinstance(session._qset, native_core.NativeQueueSet)}
    if hasattr(session, "_tracker"):
        parts["tracker"] = isinstance(session._tracker, native_core.NativeTracker)
    if hasattr(runner, "_native"):
        parts["spec builder"] = runner._native is not None
        parts["input log"] = isinstance(runner._input_log, native_spec.MirroredLog)
    if sock is not None:
        parts["udp poller"] = isinstance(getattr(sock, "_native", None), NativeUdpSocket)
    wrong = [name for name, is_native in parts.items() if is_native != native]
    check(not wrong, f"{label}: {wrong} not on the {'native' if native else 'Python'} "
                     f"data plane{why}")


class P2PRun:
    """``players`` P2P peers (and optionally a spectator of peer 0), each an
    app of its own built by ``make_app(device, inputs)`` and driven through
    ``GGRSStage`` on one clock: the loopback network's virtual clock, or
    the wall clock over real UDP on 127.0.0.1. ``inputs(seed, frames,
    players)`` makes the input system (seeded random bits by default);
    ``net`` the loopback's latency, jitter, loss and seed (``P2P_NET`` by
    default). Every peer, the spectator and (over UDP) every socket must
    be on the native data plane unless ``GGRS_NO_NATIVE=1`` selects the
    Python one (:func:`check_plane`). ``predictor`` configures every
    session's input predictor (its weights' hash is the handshake's
    digest)."""

    def __init__(self, make_app, device, players: int, seed: int, frames: int,
                 transport: str = "loopback", chaos: bool = False,
                 spectator: bool = False, inputs=None, net=None,
                 max_prediction: int = P2P_MAX_PREDICTION,
                 input_delay: int = P2P_INPUT_DELAY, predictor=None):
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
            self.net = LoopbackNetwork(**(net or P2P_NET))
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
                       .with_max_prediction_window(max_prediction)
                       .with_input_delay(input_delay)
                       .with_input_predictor(predictor))
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
            check_plane(f"peer {me}", session, app.stage.runner,
                        None if self.virtual else sockets[me])
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
                       .with_input_predictor(predictor)
                       .start_spectator_session(addrs[0], self.net.socket(spec_addr),
                                                clock=clock))
            check_plane("spectator", session, app.stage.runner)
            app.insert_session(session, SessionType.SPECTATOR)
            self.spectator = {"app": app, "session": session, "checksums": {},
                              "launches": {}, "lag": []}

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
            spec["lag"].append(self.peers[0]["app"].stage.runner.frame - runner.frame)
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
            lag = np.asarray(self.spectator["lag"])
            out["spectator"] = {"frames": spec_runner.frame, "compared_with_host": len(seen),
                                "lag_frames": {"mean": float(lag.mean()),
                                               "p99": float(np.percentile(lag, 99)),
                                               "max": int(lag.max()), "last": int(lag[-1])},
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
# A shorter cpu twin of a P2P run is held against the card's stream over
# at least this many confirmed frames on each peer.
TWIN_COMMON_FRAMES = 10
SPEC_TIMED_BRANCHES = (64, 256)  # BASELINE configs 2 and "HL": 8 frames x 64 / 256


def branch_worlds(ts, worlds):
    """A ``[B]`` world of single worlds."""
    return ts.tree_map(lambda *xs: torch.stack(xs).contiguous(), *worlds)


def box_branch_worlds(ts, n: int, device, seed: int = 0, players: int = 2):
    """``n`` box_game worlds of ``players`` cubes with seeded translations
    and velocities."""
    from bevy_ggrs_tpu_torch.models import box_game

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        host = ts.to_host(box_game.make_world(players, device="cpu").commit())
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
        check_batched_save_case(ts, tck, label, B, worlds, depth, strided)


def check_batched_save_case(ts, tck, label: str, B: int, worlds, depth: int,
                            strided: bool) -> None:
    """One case of :func:`check_batched_save`: ``B`` worlds saved into
    ``[B, depth]`` rings, against the plain version."""
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


SPEC_GRAPH_REPLAYS = 8  # replays whose launches are held to as many eager rollouts'


def check_spec_graph(ts, boids, box_game) -> dict:
    """``SpeculativeExecutor.run`` through its CUDA graph against the eager
    ``rollout_branches``, bitwise, on boids-1,024 (mxu) at B = 128 and
    box_game at B = 64, F = 8: the capturing call at frame 60, a replay
    at 60 and one at 61 from a world one step on; a result unchanged by
    two later calls on other trees; the kernel wrappers' launches over
    :data:`SPEC_GRAPH_REPLAYS` replays equal to as many eager rollouts';
    one replay under ``torch.profiler``: one ``cudaGraphLaunch`` running F
    launches of each hand-written kernel the eager rollout runs. Returns
    per case the host ms of a call (after a synchronize), eager and
    replayed."""
    from torch.profiler import ProfilerActivity, profile

    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch.parallel.speculate import SpeculativeExecutor, rollout_branches
    from bevy_ggrs_tpu_torch.schedule import PREDICTED, make_inputs

    F = P2P_MAX_PREDICTION
    cases = [("boids-1024 mxu", boids.make_schedule(kernel="mxu", mode="dense"),
              boids.make_world(BOIDS_SPEC_N, 2, device="cuda").commit(),
              BOIDS_SPEC_BRANCHES, ("pairwise_force_rows_mxu_kernel", "world_checksum_kernel")),
             ("box_game", box_game.make_schedule(), box_game.make_world(2, device="cuda").commit(),
              SPEC_BRANCHES, ("world_checksum_kernel",))]
    out = {}
    for label, sched, world, B, kernels in cases:
        rng = np.random.RandomState(B)
        trees = [rng.randint(0, 16, (B, F, 2)).astype(np.uint8) for _ in range(5)]
        status = np.full((F, 2), PREDICTED, np.int32)
        later = sched(world, make_inputs(torch.tensor([1, 8], dtype=torch.uint8,
                                                      device="cuda")))

        def eager(w, start, tree):
            return rollout_branches(sched, w, start, tree, status, F)

        def same(res, want, what):
            rings, states, lanes = want
            check(torch.equal(res.rings.frames, rings.frames)
                  and torch.equal(res.rings.checksums, rings.checksums)
                  and torch.equal(res.checksums, lanes)
                  and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, res.rings.states),
                                                           world_leaves(ts, rings.states)))
                  and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, res.states),
                                                           world_leaves(ts, states))),
                  f"spec graph {label}: {what} differs from the eager rollout")

        ex = SpeculativeExecutor(sched, B, F)
        calls = [(world, 60, trees[0], "the capturing call"),
                 (world, 60, trees[1], "a replay at the captured frame"),
                 (later, 61, trees[2], "a replay at another frame and world")]
        results = []
        for w, start, tree, what in calls:
            results.append(ex.run(w, start, tree))
            same(results[-1], eager(w, start, tree), what)
        kept = [t.clone() for t in world_leaves(ts, results[1].rings.states)
                + world_leaves(ts, results[1].states)] + [results[1].checksums.clone()]
        ex.run(world, 62, trees[3])
        ex.run(later, 63, trees[4])
        now = world_leaves(ts, results[1].rings.states) + world_leaves(ts, results[1].states)
        check(all(same_bytes(a, b) for a, b in zip(now + [results[1].checksums], kept)),
              f"spec graph {label}: a result changed after two later calls")
        torch.cuda.synchronize()
        before = ops.launch_counts()
        for i in range(SPEC_GRAPH_REPLAYS):
            ex.run(world, 60 + i, trees[i % len(trees)])
        torch.cuda.synchronize()
        replayed = {k: v - before[k] for k, v in ops.launch_counts().items()}
        before = ops.launch_counts()
        for i in range(SPEC_GRAPH_REPLAYS):
            eager(world, 60 + i, trees[i % len(trees)])
        torch.cuda.synchronize()
        eagerly = {k: v - before[k] for k, v in ops.launch_counts().items()}
        check(replayed == eagerly, f"spec graph {label}: launches over "
              f"{SPEC_GRAPH_REPLAYS} replays {replayed} != eager {eagerly}")
        check((ex.graph_captures, ex.eager_runs) == (1, 0)
              and ex.graph_replays == len(calls) + 1 + SPEC_GRAPH_REPLAYS,
              f"spec graph {label}: counters {ex.graph_captures} / {ex.graph_replays} / "
              f"{ex.eager_runs}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ex.run(world, 60, trees[0])
            torch.cuda.synchronize()
        names = [(e.device_type() == torch.autograd.DeviceType.CUDA, e.name())
                 for e in prof.profiler.kineto_results.events()]
        graph_launches = sum(not dev and n.startswith("cudaGraphLaunch") for dev, n in names)
        per_kernel = {k: sum(dev and k in n for dev, n in names) for k in kernels}
        check(graph_launches == 1 and all(c == F for c in per_kernel.values()),
              f"spec graph {label}: {graph_launches} graph launches, kernels {per_kernel}")
        host = {}
        for name, fn in (("eager", lambda i: eager(world, 60, trees[i % 5])),
                         ("replay", lambda i: ex.run(world, 60, trees[i % 5]))):
            times = []
            for i in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(i)
                times.append((time.perf_counter() - t0) * 1e3)
            host[f"{name}_host_ms"] = float(np.median(times))
        torch.cuda.synchronize()
        out[label] = dict(host, kernels_per_replay=per_kernel, launches_per_replay={
            k: v / SPEC_GRAPH_REPLAYS for k, v in replayed.items() if v})
        print(f"spec graph {label} B={B} F={F}: the capturing call and replays at frames "
              f"60 and 61 bitwise the eager rollout; a result unchanged by two later "
              f"calls; launches over {SPEC_GRAPH_REPLAYS} replays equal to as many eager "
              f"rollouts' {replayed}; one cudaGraphLaunch a replay, kernels {per_kernel}; "
              f"host ms eager {host['eager_host_ms']:.3f}, replay {host['replay_host_ms']:.3f}")
    return out


def batched_save_times(ts, tck) -> dict:
    """The batched save's device time at the timed branch counts of phase
    11 (2-player box_game worlds into ``[B, 8]`` rings)."""
    return {f"B{B}": batched_save_time(ts, tck, B, 8, 2, seed=B + 1)
            for B in SPEC_TIMED_BRANCHES}


def batched_save_time(ts, tck, B: int, depth: int, players: int, seed: int) -> dict:
    """The batched save of ``B`` box_game worlds of ``players`` cubes into
    ``[B, depth]`` rings, timed beside B real single-world saves captured
    in one graph (:func:`time_batched_save`)."""
    worlds = box_branch_worlds(ts, B, "cuda", seed=seed, players=players)
    m = time_batched_save(ts, tck, f"box_game {players} players", worlds, depth, serial=True)
    m["players"] = players
    return m


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


def spec_peer_numbers(run: P2PRun) -> list:
    """Per peer: ticks, recovery ticks and, on a speculating peer, the
    speculation counters and the host time of the speculating tick."""
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
        if hasattr(runner, "spec_hits"):
            host = np.asarray(runner.metrics.series.get("spec_host_dispatch_ms", [0.0]))
            entry.update({
                "spec_hits": runner.spec_hits, "spec_partial_hits": runner.spec_partial_hits,
                "spec_misses": runner.spec_misses,
                "spec_dispatches_skipped": runner.spec_dispatches_skipped,
                "frames_recovered": runner.rollback_frames_recovered_total,
                "spec_host_dispatch_ms": {"mean": float(host.mean()),
                                          "p99": float(np.percentile(host, 99))},
                "rollouts": peer["counts"]["spec_rollouts_total"],
                "host_ms": {name: series_stats(runner.metrics, name) for name in SPEC_PIECES},
            })
        out.append(entry)
    return out


# The speculating tick's host pieces (metrics timers): the branch tree, the
# known inputs read from the session (none when the builder reads the
# native queues in-process), the branch match and the predictor's seed
# (no call without a predictor).
SPEC_PIECES = ("structured_bits_build", "known_inputs_query", "match_branch",
               "predictor_rank")


def series_stats(metrics, name: str) -> dict:
    """Calls, mean and p99 milliseconds of a metrics timer."""
    t = np.asarray(metrics.series.get(f"{name}_ms", []))
    if not t.size:
        return {"calls": 0}
    return {"calls": int(t.size), "mean": float(t.mean()), "p99": float(np.percentile(t, 99))}


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

    def box(spec):
        return lambda dev, inputs: box_app(dev, inputs, players=2, speculation=spec)

    return spec_p2p(kernels, ts, tck, "spec box_game", box, 2, frames, branches,
                    held_key_runs, device)


def p2p_twin(kernels, ts, tck, label: str, make, players: int, frames: int, branches: int,
             inputs) -> dict:
    """The CPU run that stands beside a speculating P2P run on the card:
    ``players`` peers of ``make(branches)`` for ``frames`` frames on the
    lossy loopback, checked as every run is; returns each peer's
    confirmed stream, the frames and the seconds."""
    t0 = time.perf_counter()
    run = P2PRun(make(branches), "cpu", players, seed=5, frames=frames, inputs=inputs)
    run.run(kernels, ts, tck, max_seconds=300.0)
    run.summary(f"{label} {players} peers B={branches} on cpu")
    return {"streams": [run.confirmed_stream(p) for p in run.peers], "frames": run.frames,
            "seconds": time.perf_counter() - t0}


def spec_p2p(kernels, ts, tck, label: str, make, players: int, frames: int, branches: int,
             inputs, device: str = "cuda", attestation: bool = False,
             cpu_twin=None) -> dict:
    """``players`` peers, each speculating with ``branches`` branches
    (``make(spec)`` gives the run's ``make_app``), over the lossy loopback
    on the input system ``inputs``, against the same run with speculation
    off and (on the card) the same run on the CPU: no desync, a hit on
    each peer, the confirmed streams bitwise equal, and on the card the
    checksum kernel F times a rollout besides the serial saves and
    guards. ``cpu_twin`` (on the card) returns that CPU run's
    :func:`p2p_twin` result, played elsewhere and maybe shorter (its
    stream is compared over the frames it confirmed, at least
    ``TWIN_COMMON_FRAMES`` of them), in place of playing it here. With
    ``attestation``, every
    peer's warmup attestation covered every branch of both tensors."""
    on_card = device == "cuda"
    card = smi() if on_card else "cpu"

    def play(spec, dev, n):
        if on_card and dev == "cuda":
            reset_counts(kernels)
        run = P2PRun(make(spec), dev, players, seed=5, frames=n, inputs=inputs)
        run.run(kernels, ts, tck, max_seconds=300.0)
        return run, run.summary(f"{label} {players} peers B={spec} on {dev}")

    results = {}
    on_run, on = play(branches, device, frames)
    off_run, off = play(0, device, frames)
    spec_frames = on_run.peers[0]["app"].stage.runner.spec_frames
    for i, peer in enumerate(on_run.peers):
        runner = peer["app"].stage.runner
        check(runner.speculation_enabled, f"{label} peer {i}: speculation disabled")
        check(runner.spec_hits + runner.spec_partial_hits > 0,
              f"{label} peer {i}: no speculative hit in {runner.rollbacks_total} rollbacks")
        att = runner.attestation
        check(not attestation or (att.ok and att.scanned_branches == branches
                                  and att.real_checked == 2 * branches),
              f"{label} peer {i}: attestation {att}")
    streams = {"on": [on_run.confirmed_stream(p) for p in on_run.peers],
               "off": [off_run.confirmed_stream(p) for p in off_run.peers]}
    others = [("off", off_run.frames)]
    if on_card:
        t0 = time.perf_counter()
        if cpu_twin is None:
            twin = p2p_twin(kernels, ts, tck, label, make, players, frames, branches, inputs)
        else:
            twin = cpu_twin()
        streams["cpu"] = twin["streams"]
        others.append(("cpu", twin["frames"]))
        print(f"{label}: the cpu run of {twin['frames']} frames took {twin['seconds']:.1f} s"
              + ("" if cpu_twin is None else
                 f" in the twins' process, {time.perf_counter() - t0:.1f} s waited for here"))
    for name, other_frames in others:
        need = min(30, min(frames, other_frames) // 20)  # exchanges: one every 8 frames
        if name == "cpu":
            need = max(need, TWIN_COMMON_FRAMES)
        for i, (a, b) in enumerate(zip(streams["on"], streams[name])):
            common = sorted(set(a) & set(b))
            check(len(common) >= need, f"{label} peer {i}: {len(common)} frames in common "
                                       f"with the {name} run, fewer than {need}")
            check(all(a[f] == b[f] for f in common),
                  f"{label} peer {i}: the confirmed stream differs from the {name} run's")
            print(f"{label} peer {i}: speculating stream on {device} {len(a)} frames, "
                  f"{name} run {len(b)} frames, {len(common)} in common, bitwise equal")
    if on_card:
        check_spec_launches(label, on_run, spec_frames)
        check_p2p_launches(f"{label} off", off)
    # Read every number before the profiled render frame, which steps the
    # runs once more and would add its launches, counts and tick.
    results["on"] = {"peers": spec_peer_numbers(on_run),
                     "launches": [dict(p["launches"]) for p in on_run.peers],
                     "counts": [dict(p["counts"]) for p in on_run.peers],
                     "confirmed_checksums": on["confirmed_checksums"], "seconds": on["seconds"]}
    results["off"] = {"peers": spec_peer_numbers(off_run),
                      "launches": [dict(p["launches"]) for p in off_run.peers],
                      "confirmed_checksums": off["confirmed_checksums"],
                      "seconds": off["seconds"]}
    if attestation:
        att = on_run.peers[0]["app"].stage.runner.attestation
        results["on"]["attestation"] = {"ok": att.ok, "real_checked": att.real_checked,
                                        "scanned_branches": att.scanned_branches,
                                        "frames": att.frames}
    for key, run in (("on", on_run), ("off", off_run)):
        results[key]["busy"] = p2p_busy(run, kernels, ts, tck, iters=1) if on_card else None
    for key in ("on", "off"):
        for i, peer in enumerate(results[key]["peers"]):
            print(f"{label} speculation {key} peer {i}: " + json.dumps(peer) + f"; {card}")
        print(f"{label} speculation {key}: busy " + json.dumps(results[key]["busy"])
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
              for n in (300, 1000, 1024, 4096, 4100)}
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
    # mxu2: phase 11's batch, the spec cell's (512), a row subset, one
    # world, and N = 300: 4 ranks, two row groups a block, a ragged last rank.
    for B, n, rows, timed in ((BOIDS_SPEC_BRANCHES, 1024, slice(0, 1024), True),
                              (512, 1024, slice(0, 1024), False),
                              (3, 1000, slice(0, 65), False), (1, 1024, slice(0, 1024), False),
                              (4, 300, slice(0, 300), False)):
        args, batched, singles, plain = rows_case(
            tpw.pairwise_force_rows_mxu2, tpw.pairwise_force_rows_mxu2_plain, B, n, rows,
            seed=100 + B)
        r = args[0].shape[1]
        geo = tpw.mxu2_geometry(B, r, n)
        keep("pairwise_force_rows_mxu2", branch_case(
            f"mxu2 over branches B={B} R={r} N={n} ({geo.ranks} ranks, {geo.warp_tiles} row "
            f"tiles a warp, {geo.blocks} blocks x {B} branches)", batched, singles, plain,
            lambda scale: MXU_RTOL * scale,
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
    results["on"] = {"peers": spec_peer_numbers(on_run),
                     "launches": [dict(p["launches"]) for p in on_run.peers],
                     "counts": [dict(p["counts"]) for p in on_run.peers],
                     "advances": [p["log"]["advances"] for p in on_run.peers],
                     "confirmed_checksums": on["confirmed_checksums"], "seconds": on["seconds"]}
    results["off"] = {"peers": spec_peer_numbers(off_run),
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


# ---------------------------------------------------------------------------
# Phase 12: BASELINE config 5 on the native data plane
# ---------------------------------------------------------------------------

# BASELINE.md config 5, the JAX package's live case (bench.py
# _live_8p_spectator_case): box_game, 8 peers and a spectator of peer 0,
# max_prediction 12, no input delay, peer 0 speculating 1,024 branches x 12
# frames, over a loopback of 2 frames' latency, 1 frame's jitter and 2 %
# loss from seed 7. The JAX bench plays 1,800 frames; the card's run is cut
# to CONFIG5_FRAMES a leg: phase 12 runs four legs in one process, the
# first paying the attestation at 1,024 x 12 (about 26 s) and the others
# reusing its memoized verdict, and phase 14 a fifth in a process of its own.
CONFIG5_PLAYERS = 8
CONFIG5_MAX_PREDICTION = 12
CONFIG5_BRANCHES = 1024
CONFIG5_FRAMES = 150
CONFIG5_NET = {"latency": 2 / 60, "jitter": 1 / 60, "loss": 0.02, "seed": 7}
# The legs run in a child process with this string-hash seed: the
# sessions' endpoint order, and with it their timing, follows str hashing.
CONFIG5_HASH_SEED = "0"
CONFIG5_LEG_SECONDS = 420
CONFIG5_COUNTERS = ("spec_hits", "spec_partial_hits", "spec_misses", "spec_dispatches_skipped",
                    "spec_rollouts_total", "rollbacks_total", "rollback_frames_recovered_total")


def config5_inputs(seed, frames, players):
    """The JAX bench's script: player h presses key ``(frame // 3 + h) %
    4`` of UP, RIGHT, DOWN and none (below box_game's speed clamp)."""
    from bevy_ggrs_tpu_torch.models import box_game

    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    return lambda handle, app: np.uint8(keys[(app.session.current_frame // 3 + handle) % 4])


def config5_leg(kernels, ts, tck, device, frames: int, branches: int,
                predictor=None) -> dict:
    """One run of config 5 in this process, on the data plane the
    environment selects (every peer, the spectator and peer 0's branch
    builder on it: :func:`check_plane`). Returns what the two legs compare
    (peer 0's speculation counters, every peer's confirmed checksum stream,
    the spectator's) and print. ``predictor`` (phase 14): every session
    advertises its digest and peer 0's tree is seeded by it."""
    from bevy_ggrs_tpu_torch.native import core as native_core

    on_card = device == "cuda"
    card = smi() if on_card else "cpu"
    plane = "python" if native_core.switched_off() else "native"
    label = f"config5 {plane}" + (f" predictor {predictor}" if predictor else "")
    if on_card:
        reset_counts(kernels)
    builds, built = [], {}

    def make_app(dev, inputs):  # the first app built (peer 0) speculates
        spec = branches if not builds else 0
        t0 = time.perf_counter()
        app = box_app(dev, inputs, players=CONFIG5_PLAYERS, speculation=spec,
                      max_prediction=CONFIG5_MAX_PREDICTION, predictor=predictor)
        builds.append(time.perf_counter() - t0)
        if spec:  # the build's warmup and attestation rollouts
            built.update({k: getattr(app.stage.runner, k) for k in CONFIG5_COUNTERS})
        return app

    run = P2PRun(make_app, device, CONFIG5_PLAYERS, seed=7, frames=frames, spectator=True,
                 inputs=config5_inputs, net=CONFIG5_NET,
                 max_prediction=CONFIG5_MAX_PREDICTION, input_delay=0, predictor=predictor)
    run.run(kernels, ts, tck, max_seconds=CONFIG5_LEG_SECONDS - 60)
    summary = run.summary(label)
    runner0 = run.peers[0]["app"].stage.runner
    att = runner0.attestation
    check(runner0.speculation_enabled and att is not None and att.ok
          and att.scanned_branches == branches and att.real_checked == 2 * branches,
          f"{label}: attestation {att}")
    check(runner0.spec_frames == CONFIG5_MAX_PREDICTION, f"{label}: {runner0.spec_frames} frames")
    check((runner0._predictor is not None) == bool(predictor),
          f"{label}: predictor {runner0._predictor}")
    check(runner0.spec_hits + runner0.spec_partial_hits > 0,
          f"{label}: no speculative hit in {runner0.rollbacks_total} rollbacks")
    if on_card:
        check_spec_launches(label, run, CONFIG5_MAX_PREDICTION)
    numbers = spec_peer_numbers(run)
    for entry, peer, line in zip(numbers, run.peers, summary["peers"]):
        entry.update(frames=line["frames"], compared=line["compared"],
                     deepest_rollback=line["deepest_rollback"],
                     launches=dict(peer["launches"]), counts=dict(peer["counts"]))
    out = {
        "plane": plane,
        "predictor": predictor,
        # Counted from the build on: a leg that reuses a memoized
        # attestation dispatches fewer rollouts while it builds.
        "counters": {k: getattr(runner0, k) - built[k] for k in CONFIG5_COUNTERS},
        "streams": [{str(f): cs for f, cs in run.confirmed_stream(p).items()}
                    for p in run.peers],
        "spectator_stream": {str(f): cs for f, cs in sorted(run.spectator["checksums"].items())},
        "peers": numbers,
        "spectator": summary["spectator"],
        "attestation": {"scanned_branches": att.scanned_branches,
                        "real_checked": att.real_checked, "frames": att.frames,
                        "memo_hits": getattr(runner0.metrics, "counters", {}).get(
                            "attestation_cache_hits", 0),
                        "app_build_seconds": builds[0]},
        "confirmed_checksums": summary["confirmed_checksums"],
        "seconds": summary["seconds"],
    }
    # After every number was read: the profiled render frame steps on.
    out["busy"] = p2p_busy(run, kernels, ts, tck, iters=1) if on_card else None
    for i, entry in enumerate(numbers):
        print(f"{label} peer {i}: " + json.dumps(entry) + f"; {card}")
    print(f"{label} spectator: " + json.dumps(out["spectator"]))
    print(f"{label}: attestation " + json.dumps(out["attestation"]) + ", busy "
          + json.dumps(out["busy"]) + f", {out['confirmed_checksums']} confirmed frames, "
          f"{out['seconds']:.1f} s; {card}")
    return out


def config5_child(argv) -> int:
    """``chip_smoke.py --config5 DEVICE FRAMES BRANCHES PLANES [PREDICTOR]``:
    legs of phase 12 or 14 (:func:`config5_leg`) in this process, one for
    each of the comma-separated ``PLANES``, each selected the way a user
    does (``GGRS_NO_NATIVE=1`` for the Python plane); each leg's result is
    a ``CONFIG5`` line."""
    import gc

    device, frames, branches = argv[0], int(argv[1]), int(argv[2])
    planes = argv[3].split(",")
    predictor = argv[4] if len(argv) > 4 else None
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.ops import checksum as tck

    for plane in planes:
        if plane == "python":
            os.environ["GGRS_NO_NATIVE"] = "1"
        else:
            os.environ.pop("GGRS_NO_NATIVE", None)
        t0 = time.perf_counter()
        result = config5_leg(ops.wrappers(), ts, tck, device, frames, branches, predictor)
        result["leg_seconds"] = time.perf_counter() - t0
        print("CONFIG5 " + json.dumps(result), flush=True)
        gc.collect()
    return 0


def config5_run_legs(planes, device, frames: int, branches: int, predictor=None) -> list:
    """Run a leg for each of ``planes`` in turn in one child process:
    ``PYTHONHASHSEED`` fixed, the Python legs under ``GGRS_NO_NATIVE=1``.
    The child's other lines are printed here."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("GGRS_NO_NATIVE", "BEVY_GGRS_TPU_NATIVE", "GGRS_PREDICTOR")}
    env["PYTHONHASHSEED"] = CONFIG5_HASH_SEED
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--config5", str(device),
           str(frames), str(branches), ",".join(planes)] + ([predictor] if predictor else [])
    t0 = time.perf_counter()
    done = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=CONFIG5_LEG_SECONDS * len(planes))
    lines = done.stdout.splitlines()
    for line in lines:
        if not line.startswith("CONFIG5 "):
            print(line)
    results = [json.loads(line[len("CONFIG5 "):]) for line in lines
               if line.startswith("CONFIG5 ")]
    check(done.returncode == 0 and len(results) == len(planes),
          f"config5 legs {planes} (predictor {predictor}): rc {done.returncode}, "
          f"{len(results)} results: {done.stderr[-4000:]}")
    for plane, result in zip(planes, results):
        check(result["plane"] == plane, f"config5: a {plane} leg ran on {result['plane']}")
    print(f"config5: {len(planes)} leg(s) in one process of {time.perf_counter() - t0:.1f} s")
    return results


def config5_phase(kernels, ts, tck, frames: int = CONFIG5_FRAMES,
                  branches: int = CONFIG5_BRANCHES, device: str = "cuda",
                  planes=("native", "python", "python", "native")) -> dict:
    """Phase 12. On the card, the batched save of ``branches`` 8-player
    box_game worlds into ``[branches, 12]`` rings bitwise against its
    plain version, and timed. Then a leg of config 5 for each of
    ``planes``, in turns in one child process, by default native, Python
    under ``GGRS_NO_NATIVE=1``, Python, native, so that the host's drift
    over the phase falls on both planes alike. Every leg gives the first one's
    speculation counters on peer 0 and its confirmed streams on every peer
    and on the spectator."""
    out = {}
    if device == "cuda":
        worlds = box_branch_worlds(ts, branches, "cuda", seed=5, players=CONFIG5_PLAYERS)
        check_batched_save_case(ts, tck, f"box_game {CONFIG5_PLAYERS} players rollout-shaped",
                                branches, worlds, CONFIG5_MAX_PREDICTION, True)
        del worlds
        out["batched_save"] = batched_save_time(ts, tck, branches, CONFIG5_MAX_PREDICTION,
                                                CONFIG5_PLAYERS, seed=6)
    legs = config5_run_legs(planes, device, frames, branches)
    first = legs[0]
    check(first["plane"] == "native" and {leg["plane"] for leg in legs} == {"native", "python"},
          f"config5: the legs must start native and run both planes, not {planes}")
    check(len(first["spectator_stream"]) >= 10
          and all(len(stream) >= 10 for stream in first["streams"]),
          "config5: fewer than 10 confirmed frames on a peer or the spectator")
    for k, leg in enumerate(legs[1:], 1):
        what = f"config5 leg {k} ({leg['plane']}) against leg 0 (native)"
        check(leg["counters"] == first["counters"],
              f"{what}: counters {leg['counters']} and {first['counters']}")
        for i, (a, b) in enumerate(zip(first["streams"], leg["streams"])):
            check(a == b, f"{what}: peer {i}'s confirmed streams differ")
        check(leg["spectator_stream"] == first["spectator_stream"],
              f"{what}: the spectator streams differ")
    print(f"config5: legs {', '.join(planes)} equal: peer 0 counters "
          + json.dumps(first["counters"]) + f", {len(first['streams'][0])} confirmed frames "
          f"on each of {len(first['streams'])} peers, {len(first['spectator_stream'])} "
          f"spectator frames; legs " + ", ".join(f"{leg['leg_seconds']:.1f}" for leg in legs)
          + " s")
    for plane in ("native", "python"):
        mine = [leg for leg in legs if leg["plane"] == plane]
        summary = {
            "peer0_tick_mean_ms": [leg["peers"][0]["ticks"]["mean_ms"] for leg in mine],
            "peers1_7_tick_mean_ms": [float(np.mean([p["ticks"]["mean_ms"]
                                                     for p in leg["peers"][1:]]))
                                      for leg in mine],
            "spec_host_dispatch_mean_ms": [leg["peers"][0]["spec_host_dispatch_ms"]["mean"]
                                           for leg in mine],
            "host_ms": [leg["peers"][0]["host_ms"] for leg in mine],
            "attestation_app_build_s": [leg["attestation"]["app_build_seconds"]
                                        for leg in mine],
        }
        print(f"config5 {plane} legs: " + json.dumps(summary))
    out["legs"] = legs
    return out

# ---------------------------------------------------------------------------
# Phase 13: projectiles and neural_bots
# ---------------------------------------------------------------------------

# The JAX bench's live-zoo scripts: player h presses keys[(frame // 3 + h) % 4].
PROJECTILE_KEYS = (1, 16, 8, 0)  # UP, FIRE, RIGHT, none
BOT_KEYS = (1, 2, 4, 0)
PROJECTILE_PLAYERS, PROJECTILE_CAP, PROJECTILE_BRANCHES = 4, 64, 64
BOTS, BOT_PLAYERS, BOT_BRANCHES = 512, 2, 32
BOT_HIDDEN = (32, 256, 512)
# The P2P runs play 300 frames on the card (cut from 600 to fit the
# script's time), and their cpu twins fewer (the CPU steps a
# 64-branch projectiles or a 32-branch, 512-bot neural_bots rollout in
# hundreds of ms): 88 frames, 11 checksum exchanges, so that
# TWIN_COMMON_FRAMES of them are confirmed on both.
MODEL_SPEC_FRAMES = 300
MODEL_CPU_FRAMES = (88, 88)
# The cpu twins of the neural_bots SyncTests play a prefix of the card's
# frames: 150 of 300 at H = 32, 20 of 60 at H = 256 and 512 (a [512, H]
# tanh_f32 step takes tens of ms on the CPU).
BOT_CPU_FRAMES = (150, 20)
# 1 M float32 values for tanh_f32 and sqrt_f32, edges included.
EXACT_VALUES = 1 << 20


def key_script(keys):
    """An ``inputs(seed, frames, players)`` factory for :class:`P2PRun` and
    an input system: ``keys[(frame // 3 + handle) % len(keys)]``."""
    def inputs(seed=0, frames=0, players=0):
        return lambda handle, app: np.uint8(
            keys[(app.session.current_frame // 3 + handle) % len(keys)])
    return inputs


def model_app(device, model: str, inputs=None, speculation: int = 0, mode=None,
              hidden: int = 32, bots: int = BOTS, predictor=None):
    """A projectiles app (4 players, capacity 64, the hit test in ``mode``)
    or a neural_bots app (``bots`` bots of 2 players, hidden width
    ``hidden``), registered through ``GGRSPlugin`` from the model's
    registry; ``speculation`` branches (0: none) with a metrics sink."""
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import neural_bots, projectiles
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    if model == "projectiles":
        players, keys, capacity = PROJECTILE_PLAYERS, PROJECTILE_KEYS, PROJECTILE_CAP
        registry, schedule = projectiles.make_registry(), projectiles.make_schedule(mode)
        spec = projectiles.INPUT_SPEC
        setup = lambda world, app: projectiles.spawn_turrets(world, players)  # noqa: E731
    else:
        players, keys, capacity = BOT_PLAYERS, BOT_KEYS, bots
        registry, schedule = neural_bots.make_registry(hidden), neural_bots.make_schedule()
        spec = neural_bots.INPUT_SPEC
        setup = lambda world, app: neural_bots.spawn_bots(world, bots, players)  # noqa: E731
    plugin = GGRSPlugin(spec).with_input_system(inputs or key_script(keys)())
    for d in registry.components.values():
        plugin.register_rollback_component(d.name, shape=d.shape, dtype=d.dtype,
                                           default=d.default)
    for d in registry.resources.values():
        plugin.register_rollback_resource(d.name, d.initial)
    return (plugin.with_rollback_schedule(schedule)
            .with_num_players(players)
            .with_max_prediction_window(P2P_MAX_PREDICTION)
            .with_world_capacity(capacity)
            .with_setup_system(setup)
            .with_device(device)
            .with_speculation(speculation, predictor=predictor if speculation else None)
            .with_metrics(Metrics() if speculation else None)
            .build())


def exact_inputs(n: int) -> np.ndarray:
    """``n`` float32 values for the exact primitives: uniform over +-10,
    small normals, values around the tanh's 0.0004 cut, any bit pattern,
    and the edges (+-0, +-inf, NaN, the clamp, past 8)."""
    rng = np.random.RandomState(13)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 8.0, -8.0, 9.0, 1e30,
                      7.99881172180175781, 0.0004, -0.0004, np.float32(0.0004) * 1.0000001,
                      1e-8, 1e-12], np.float32)
    k = (n - edges.size) // 4
    parts = [rng.uniform(-10, 10, k), rng.standard_normal(k) * 0.01,
             rng.uniform(-0.001, 0.001, k),
             rng.randint(0, 2 ** 32, n - edges.size - 3 * k, dtype=np.uint64)]
    parts = [p.astype(np.float32) for p in parts[:3]] + [
        parts[3].astype(np.uint32).view(np.float32)]
    return np.concatenate(parts + [edges])


def check_exact(tx) -> dict:
    """The exact primitives on the card against their cpu runs, bitwise:
    ``int_matmul`` at neural_bots' and the ranker's shapes, batched too,
    and ``tanh_f32`` and ``sqrt_f32`` on :data:`EXACT_VALUES` values (NaN
    in gives NaN out on both, compared by ``isnan``). Also what PyTorch's
    own integer products do on the card."""
    rng = np.random.RandomState(3)
    cases = []
    for h in BOT_HIDDEN:
        cases += [((BOTS, 8), (8, h)), ((BOTS, h), (h, 4)), ((BOT_BRANCHES, BOTS, 8),
                                                             (BOT_BRANCHES, 8, h))]
    cases += [((64, 8, 396), (396, 32)), ((64, 8, 32), (32, 32))]  # the ranker, S = 64, P = 8
    for sa, sb in cases:
        lo = 0 if sa[-1] == 396 else -127  # the ranker's features are 0/1
        a = torch.from_numpy(rng.randint(lo, 128 if lo else 2, sa).astype(np.int8))
        b = torch.from_numpy(rng.randint(-127, 128, sb).astype(np.int8))
        got = tx.int_matmul(a.cuda(), b.cuda())
        want = tx.int_matmul(a, b)
        ref = np.matmul(a.numpy().astype(np.int64), b.numpy().astype(np.int64))
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), want)
              and np.array_equal(want.numpy(), ref), f"int_matmul {sa} x {sb} on cuda")
    print(f"int_matmul: {len(cases)} shapes bitwise the cpu int32 product and numpy's int64 "
          f"one: " + ", ".join(f"{sa}x{sb}" for sa, sb in cases))
    library = {}
    a8 = torch.ones((32, 8), dtype=torch.int8, device="cuda")
    b8 = torch.ones((8, 4), dtype=torch.int8, device="cuda")
    for name, fn in (("matmul int8", lambda: torch.matmul(a8, b8)),
                     ("matmul int32", lambda: torch.matmul(a8.int(), b8.int())),
                     ("_int_mm n=4", lambda: torch._int_mm(a8, b8)),
                     ("_int_mm 32x8x8", lambda: torch._int_mm(a8, a8.t().contiguous()[:, :8]))):
        try:
            out = fn()
            torch.cuda.synchronize()
            library[name] = f"ran: {out.dtype} {tuple(out.shape)}"
        except Exception as e:  # noqa: BLE001 - recorded, not a failure
            library[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    print("integer products in PyTorch on the card: " + json.dumps(library))
    x = torch.from_numpy(exact_inputs(EXACT_VALUES))
    out = {}
    for name, fn in (("tanh_f32", tx.tanh_f32), ("sqrt_f32", tx.sqrt_f32)):
        arg = x if name == "tanh_f32" else x.abs()
        got, want = fn(arg.cuda()).cpu(), fn(arg)
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan), f"{name}: NaN differs on cuda")
        check(torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
              f"{name}: cuda differs from cpu in "
              f"{int((got[~nan].view(torch.int32) != want[~nan].view(torch.int32)).sum())} values")
        out[name] = {"values": int(x.numel()), "nan": int(nan.sum()),
                     "ms": cuda_ms(lambda: fn(arg.cuda()), iters=20)}
    print(f"tanh_f32, sqrt_f32: {x.numel()} float32 values bitwise equal on cuda and cpu, "
          f"NaN to NaN on both: " + json.dumps(out))
    out["library"] = library
    return out


def model_worlds(ts, model: str, n: int, seed: int, hidden: int = 32, frames: int = 100):
    """``n`` worlds of a model on the card, each the state after ``frames``
    steps of its own seeded random inputs on the CPU: projectiles worlds
    after spawns and despawns (FIRE pressed), neural_bots worlds of
    :data:`BOTS` bots at hidden width ``hidden``."""
    from bevy_ggrs_tpu_torch.models import neural_bots, projectiles
    from bevy_ggrs_tpu_torch.schedule import PlayerInputs

    if model == "projectiles":
        world = projectiles.make_world(PROJECTILE_PLAYERS, PROJECTILE_CAP, device="cpu")
        schedule, reg, values = projectiles.make_schedule(), projectiles.make_registry(), 32
    else:
        world = neural_bots.make_world(BOTS, BOT_PLAYERS, hidden=hidden, device="cpu")
        schedule, reg, values = neural_bots.make_schedule(), neural_bots.make_registry(hidden), 16
    start = world.commit()
    players = PROJECTILE_PLAYERS if model == "projectiles" else BOT_PLAYERS
    out = []
    for k in range(n):
        rng = np.random.RandomState([seed, k])
        state = start
        for _ in range(frames):
            bits = torch.from_numpy(rng.randint(0, values, players).astype(np.uint8))
            state = schedule(state, PlayerInputs(bits, torch.zeros(players, dtype=torch.int32)))
        out.append(ts.from_host(reg, ts.to_host(state), device="cuda"))
    return out


def check_model_checksum(ts, tck, integrity, label: str, state) -> None:
    """The checksum kernel's three modes against their plain versions on
    one world of a model, bitwise."""
    check(torch.equal(tck.checksum(state), tck.checksum_plain(state)),
          f"{label}: checksum differs from the plain version")
    ring, plain = ts.ring_init(state, 4), ts.ring_init(state, 4)
    for frame in (0, 1, 5):
        _, lanes = ts.ring_save(ring, state, frame)
        want = tck.save_plain(plain, state, frame)
        check(torch.equal(lanes, want), f"{label}: save lanes at frame {frame}")
    check(torch.equal(ring.frames, plain.frames) and torch.equal(ring.checksums, plain.checksums)
          and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, ring.states),
                                                   world_leaves(ts, plain.states))),
          f"{label}: the saved ring differs from the plain version's")
    check(int(integrity.verify_row(ring, 5)) == int(tck.guard_plain(ring, 5)[0]) == 1,
          f"{label}: the guard")
    lay = tck.layout(state)
    print(f"{label}: checksum, save and guard bitwise their plain versions "
          f"({len(lay.parts)} parts, {lay.resource_words} resource words, "
          f"{int(state.alive.sum())} live of {state.capacity})")


def time_batched_save(ts, tck, label: str, worlds, depth: int, serial: bool = False) -> dict:
    """The batched save's device time (graph replay) of ``worlds`` into
    ``[B, depth]`` rings, beside its least time: B worlds read once and
    written once, with their digests and frames, over the memory rate, or
    the hash's integer operations at the int32 rate. With ``serial``, also
    the B single-world saves it replaces, captured in one graph."""
    B = len(worlds)
    state = branch_worlds(ts, worlds)
    rings = ts.branch_rings(worlds[0], B, depth)
    lay = tck.layout(state)
    world_bytes = sum(p.row_bytes for p in lay.parts)
    words = sum(p.words for p in lay.parts if p.role not in (tck.ALIVE, tck.RESOURCE))
    ops = (int(state.alive.sum()) * (words * CHECKSUM_OPS_PER_WORD + FMIX_OPS)
           + B * lay.resource_words * (CHECKSUM_OPS_PER_WORD + FMIX_OPS))
    moved = B * (2 * world_bytes + 2 * 16 + 4)
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_I32_PER_S * 1e3
    plain = clone_ring(ts, rings)
    m = {
        "ms": graph_ms(lambda: ts.ring_save(rings, state, 3)),
        "call_ms": cuda_ms(lambda: ts.ring_save(rings, state, 3)),
        "plain_ms": cuda_ms(lambda: tck.save_plain(plain, state, 3), iters=20),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
        else "operations", "bytes": moved, "ops": ops, "world_bytes": world_bytes,
        "depth": depth, "branches": B,
    }
    line = ""
    if serial:
        singles = [ts.ring_init(w, depth) for w in worlds]

        def saves():  # the B single-world saves the batched save replaces
            for ring, world in zip(singles, worlds):
                ts.ring_save(ring, world, 3)

        m["serial_ms"] = graph_ms(saves, iters=4)
        line = (f"; {B} single-world saves (one graph of {B} launches) "
                f"{m['serial_ms']:.6f} ms of device time")
    print(f"batched save {label} B={B} depth {depth} ({world_bytes} bytes a world): device "
          f"{m['ms']:.6f} ms (graph replay), per call with host work {m['call_ms']:.6f} ms, "
          f"plain {m['plain_ms']:.6f} ms a call{line}; bound {m['bound_ms']:.7f} ms "
          f"({m['bound_by']}: {moved} bytes, {ops} ops)")
    return m


def model_synctest(kernels, ts, tck, label: str, make, frames: int, cpu_stream) -> dict:
    """A SyncTest of ``make("cuda")`` at ``check_distance`` 7 on the card:
    no mismatch, the checksum kernel once per save and guard, and its
    stream bitwise the cpu's: ``cpu_stream``, a cpu run's stream (a
    prefix of a longer run's is compared over its length), or a function
    returning one played elsewhere (:class:`ModelTwins`)."""
    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.session import SyncTestSession

    t0 = time.perf_counter()
    app = make("cuda")
    runner = app.stage.runner
    reset_counts(kernels)
    log, ticks = drive(app, SyncTestSession(runner.num_players, runner.input_spec,
                                            check_distance=7),
                       SessionType.SYNC_TEST, frames)
    launches = {fn.__name__: fn.launches for fn in kernels}
    words = check_checksum_launches(label, tck, launches, log, runner)
    check(all(v == 0 for k, v in launches.items() if k != "world_checksum"),
          f"{label}: a force kernel ran: {launches}")
    seconds = time.perf_counter() - t0
    if callable(cpu_stream):
        cpu_stream = cpu_stream()
    check(len(cpu_stream) > 0 and log["checksums"][:len(cpu_stream)] == cpu_stream,
          f"{label}: the checksum stream on cuda differs from the cpu's")
    print(f"{label}: {frames} frames, {log['saves']} saves, {len(log['checksums'])} "
          f"checksums, the first {len(cpu_stream)} bitwise the cpu's, {words}, ticks "
          f"{json.dumps(tick_stats(ticks))}; {seconds:.1f} s on cuda")
    return {"cuda": {"app": app, "log": log, "ticks": ticks, "seconds": seconds},
            "stream": log["checksums"], "cpu_stream": cpu_stream, "launches": launches}


def model_twin_jobs(sync_frames: int = 300, wide_frames: int = 60, bots: int = BOTS,
                    branches=(PROJECTILE_BRANCHES, BOT_BRANCHES),
                    p2p_frames=MODEL_CPU_FRAMES) -> list:
    """Phase 13's cpu twins, in the order the card's runs need them: the
    SyncTests' (projectiles dense; neural_bots at each hidden width, a
    prefix of the card's frames) and the speculating P2P runs' (at
    :data:`MODEL_CPU_FRAMES`)."""
    jobs = [{"kind": "sync", "label": "projectiles_dense", "model": "projectiles",
             "mode": "dense", "hidden": 32, "bots": bots, "frames": sync_frames}]
    for h in BOT_HIDDEN:
        first = h == BOT_HIDDEN[0]
        jobs.append({"kind": "sync", "label": f"neural_bots_H{h}", "model": "neural_bots",
                     "mode": None, "hidden": h, "bots": bots,
                     "frames": min(BOT_CPU_FRAMES[0 if first else 1],
                                   sync_frames if first else wide_frames)})
    for k, (model, players) in enumerate((("projectiles", PROJECTILE_PLAYERS),
                                          ("neural_bots", BOT_PLAYERS))):
        jobs.append({"kind": "p2p", "label": f"spec {model}", "model": model,
                     "players": players, "frames": p2p_frames[k],
                     "branches": branches[k], "bots": bots})
    return jobs


def model_twin(kernels, ts, tck, job: dict) -> dict:
    """One job of :func:`model_twin_jobs`, on the CPU: a SyncTest's
    checksum stream, or a P2P run's :func:`p2p_twin` result; JSON-ready."""
    t0 = time.perf_counter()
    if job["kind"] == "sync":
        from bevy_ggrs_tpu_torch.app import SessionType
        from bevy_ggrs_tpu_torch.session import SyncTestSession

        app = model_app("cpu", job["model"], mode=job["mode"], hidden=job["hidden"],
                        bots=job["bots"])
        runner = app.stage.runner
        log, _ = drive(app, SyncTestSession(runner.num_players, runner.input_spec,
                                            check_distance=7),
                       SessionType.SYNC_TEST, job["frames"])
        out = {"stream": [[int(f), int(cs)] for f, cs in log["checksums"]]}
    else:
        keys = PROJECTILE_KEYS if job["model"] == "projectiles" else BOT_KEYS

        def make(spec):
            return lambda dev, inputs: model_app(dev, job["model"], inputs, speculation=spec,
                                                 bots=job["bots"])

        twin = p2p_twin(kernels, ts, tck, job["label"], make, job["players"], job["frames"],
                        job["branches"], key_script(keys))
        out = {"streams": [[[int(f), int(cs)] for f, cs in st.items()]
                           for st in twin["streams"]], "frames": twin["frames"]}
    out.update(label=job["label"], seconds=time.perf_counter() - t0)
    return out


def model_twins_child(argv) -> int:
    """``chip_smoke.py --model-twins OUT CONFIG``: the jobs of ``CONFIG``
    (JSON: ``threads``, ``jobs`` from :func:`model_twin_jobs`) on the CPU
    with ``threads`` threads, each result appended to ``OUT`` as a JSON
    line as soon as it is done."""
    out_path, cfg = argv[0], json.loads(argv[1])
    torch.set_num_threads(int(cfg["threads"]))
    sys.path.insert(0, str(ROOT))
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.ops import checksum as tck

    kernels = ops.wrappers()
    t0 = time.perf_counter()
    for job in cfg["jobs"]:
        result = model_twin(kernels, ts, tck, job)
        result["since_start"] = time.perf_counter() - t0
        with open(out_path, "a") as f:
            f.write(json.dumps(result) + "\n")
        print(f"twin {job['label']}: {result['seconds']:.1f} s", flush=True)
    return 0


# Phase 13's cpu twins run in a child process beside the card's runs of
# phases 2-13, on this many of the host's 8 cores (the card's runs
# dispatch from one).
TWIN_THREADS = 4
TWIN_SECONDS = 1000.0


class ModelTwins:
    """The child process (:func:`model_twins_child`) that plays phase 13's
    cpu twins while this process drives the card; :meth:`stream` and
    :meth:`p2p` wait for one job's result. The child sees no GPU."""

    def __init__(self, jobs, threads: int = TWIN_THREADS):
        import tempfile

        self.closed = False
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_twins_")
        self.out = os.path.join(self.dir, "twins.jsonl")
        self.log_path = os.path.join(self.dir, "twins.log")
        self.threads = threads
        self.results = {}
        self.t0 = time.perf_counter()
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--model-twins", self.out,
                 json.dumps({"threads": threads, "jobs": jobs})],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)

    def _read(self) -> None:
        if os.path.exists(self.out):
            with open(self.out) as f:
                for line in f:
                    if line.endswith("\n"):
                        r = json.loads(line)
                        self.results[r["label"]] = r

    def log_tail(self, n: int = 4000) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    def result(self, label: str) -> dict:
        t0 = time.perf_counter()
        while True:
            self._read()
            if label in self.results:
                break
            if self.proc.poll() is not None:
                self._read()
                check(label in self.results, f"the twins' process ended (rc "
                                             f"{self.proc.returncode}) without {label}: "
                                             f"{self.log_tail()}")
                break
            check(time.perf_counter() - self.t0 < TWIN_SECONDS,
                  f"the twins' process took over {TWIN_SECONDS} s: {self.log_tail()}")
            time.sleep(0.2)
        r = self.results[label]
        print(f"twin {label}: {r['seconds']:.1f} s in the twins' process, "
              f"{time.perf_counter() - t0:.1f} s waited for here")
        return r

    def stream(self, label: str) -> list:
        return [tuple(x) for x in self.result(label)["stream"]]

    def p2p(self, label: str) -> dict:
        r = self.result(label)
        return {"streams": [{f: cs for f, cs in st} for st in r["streams"]],
                "frames": r["frames"], "seconds": r["seconds"]}

    def close(self, ok: bool = True) -> None:
        """Wait for the child's end (kill it at once unless ``ok``, or past
        its time), then remove its files. A second call does nothing."""
        import shutil

        if self.closed:
            return
        self.closed = True
        if not ok:
            self.proc.kill()
        try:
            self.proc.wait(timeout=max(1.0, TWIN_SECONDS - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        rc = self.proc.returncode
        tail = self.log_tail()
        shutil.rmtree(self.dir, ignore_errors=True)
        if ok:
            check(rc == 0, f"the twins' process: rc {rc}: {tail}")
            last = max((r["since_start"] for r in self.results.values()), default=0.0)
            print(f"twins' process: {len(self.results)} jobs in "
                  f"{sum(r['seconds'] for r in self.results.values()):.1f} s, the last done "
                  f"{last:.1f} s after its start, on {self.threads} threads")


def models_phase(kernels, ts, tck, integrity, device: str = "cuda", sync_frames: int = 300,
                 wide_frames: int = 60, spec_frames: int = MODEL_SPEC_FRAMES,
                 bots: int = BOTS, branches=(PROJECTILE_BRANCHES, BOT_BRANCHES),
                 twins=None) -> dict:
    """Phase 13 (on the card: the exact primitives, the checksum and the
    batched save on both models' worlds, and the SyncTests, first). Then
    the P2P runs, ``device="cpu"`` runs them alone at a small size: the
    projectiles and neural_bots peers speculating, against speculation off
    and (on the card) the cpu. On the card the cpu twins play in a child
    process: ``twins`` (a :class:`ModelTwins` of :func:`model_twin_jobs`
    at these sizes, started earlier), or one started here."""
    if device != "cuda":
        return _models_phase(kernels, ts, tck, integrity, device, sync_frames, wide_frames,
                             spec_frames, bots, branches, None)
    twins = twins or ModelTwins(model_twin_jobs(sync_frames, wide_frames, bots, branches))
    try:
        out = _models_phase(kernels, ts, tck, integrity, device, sync_frames, wide_frames,
                            spec_frames, bots, branches, twins)
    except BaseException:
        twins.close(ok=False)
        raise
    twins.close()
    return out


def _models_phase(kernels, ts, tck, integrity, device, sync_frames, wide_frames, spec_frames,
                  bots, branches, twins) -> dict:
    from bevy_ggrs_tpu_torch.ops import exact as tx
    from bevy_ggrs_tpu_torch.state import DEVICE_ID_BASE

    on_card = device == "cuda"
    out = {}
    t0 = time.perf_counter()
    if on_card:
        out["exact"] = check_exact(tx)
        proj = model_worlds(ts, "projectiles", PROJECTILE_BRANCHES, seed=13)
        bots512 = model_worlds(ts, "neural_bots", BOT_BRANCHES, seed=14, hidden=512, frames=4)
        check_model_checksum(ts, tck, integrity, "projectiles after spawns and despawns",
                             proj[0])
        check_model_checksum(ts, tck, integrity, "neural_bots H=512", bots512[0])
        saves = {}
        for label, worlds in (("projectiles", proj), ("neural_bots H=512", bots512)):
            check_batched_save_case(ts, tck, label, len(worlds), worlds, P2P_MAX_PREDICTION, True)
            saves[label] = time_batched_save(ts, tck, label, worlds, P2P_MAX_PREDICTION)
        out["batched_save"] = saves
        del proj, bots512
        print(f"models: exact primitives, checksums and batched saves "
              f"{time.perf_counter() - t0:.1f} s")
        sync = {}
        # Dense and grid give one stream; the grid's cpu run (the plain
        # per-cell path, minutes on the CPU) is the dense cpu run's stream.
        for mode in ("dense", "grid"):
            sync[f"projectiles_{mode}"] = model_synctest(
                kernels, ts, tck, f"projectiles {mode}",
                lambda dev, mode=mode: model_app(dev, "projectiles", mode=mode), sync_frames,
                cpu_stream=sync["projectiles_dense"]["cpu_stream"] if mode == "grid"
                else lambda: twins.stream("projectiles_dense"))
        check(sync["projectiles_dense"]["stream"] == sync["projectiles_grid"]["stream"],
              "projectiles: the dense stream differs from the grid stream")
        world = sync["projectiles_dense"]["cuda"]["app"].world()
        res = world["resources"]
        minted = int(res["next_rollback_id"]) - DEVICE_ID_BASE
        check(minted > 0 and int(res["score"].sum()) > 0, "projectiles: no spawn or no hit")
        print(f"projectiles: dense stream bitwise the grid stream; ids minted {minted}, live "
              f"entities {int(world['alive'].sum())}, scores {res['score'].tolist()}")
        for h in BOT_HIDDEN:
            sync[f"neural_bots_H{h}"] = model_synctest(
                kernels, ts, tck, f"neural_bots {bots} H={h}",
                lambda dev, h=h: model_app(dev, "neural_bots", hidden=h, bots=bots),
                sync_frames if h == BOT_HIDDEN[0] else wide_frames,
                cpu_stream=lambda h=h: twins.stream(f"neural_bots_H{h}"))
            pos = sync[f"neural_bots_H{h}"]["cuda"]["app"].world()["components"]["position"]
            check(pos.shape == (bots, 2) and np.isfinite(pos).all(), f"neural_bots H={h}")
        out["sync"] = {k: {"launches": v["launches"], "ticks": tick_stats(v["cuda"]["ticks"]),
                           "saves": v["cuda"]["log"]["saves"]} for k, v in sync.items()}
        del sync

    def projectiles_make(spec):
        return lambda dev, inputs: model_app(dev, "projectiles", inputs, speculation=spec)

    def bots_make(spec):
        return lambda dev, inputs: model_app(dev, "neural_bots", inputs, speculation=spec,
                                             bots=bots)

    out["projectiles_p2p"] = spec_p2p(kernels, ts, tck, "spec projectiles", projectiles_make,
                                      PROJECTILE_PLAYERS, spec_frames, branches[0],
                                      key_script(PROJECTILE_KEYS), device, attestation=True,
                                      cpu_twin=twins and (lambda: twins.p2p("spec projectiles")))
    out["neural_bots_p2p"] = spec_p2p(kernels, ts, tck, "spec neural_bots", bots_make,
                                      BOT_PLAYERS, spec_frames, branches[1],
                                      key_script(BOT_KEYS), device, attestation=True,
                                      cpu_twin=twins and (lambda: twins.p2p("spec neural_bots")))
    return out


# ---------------------------------------------------------------------------
# Phase 14: the learned input predictor
# ---------------------------------------------------------------------------

RANKER_SLOTS = 64


def ranker_windows(bound, slots: int, players: int, seed: int):
    """Random ``[S, W, P]`` universe-index windows with -1 gaps, and
    anchors."""
    rng = np.random.RandomState(seed)
    V, W = len(bound.universe), bound.weights.window
    win = rng.randint(0, V, (slots, W, players)).astype(np.int32)
    win[rng.random_sample(win.shape) < 0.2] = -1
    return win, rng.randint(0, 10_000, slots).astype(np.int32)


def check_ranker(device: str = "cuda", slots: int = RANKER_SLOTS) -> dict:
    """``BatchedRanker`` on ``device`` against its CPU run and the host
    ``BoundPredictor`` rollout, bitwise, at P = 2 and 8 players and F = 8
    and 12 frames; ``rank`` timed a call on the card."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.predict import InputPredictor, load_default
    from bevy_ggrs_tpu_torch.predict.batch import BatchedRanker

    bound = InputPredictor(load_default()).bind(list(box_game.INPUT_SPEC.values), np.uint8)
    V = len(bound.universe)
    out = {}
    for players in (2, 8):
        for frames in (8, 12):
            win, anchors = ranker_windows(bound, slots, players, seed=players * 100 + frames)
            ranker = BatchedRanker(bound, frames, device=device)
            traj, order = ranker.rank(win, anchors)
            cpu_traj, cpu_order = BatchedRanker(bound, frames, device="cpu").rank(win, anchors)
            check(np.array_equal(traj, cpu_traj) and np.array_equal(order, cpu_order),
                  f"ranker P={players} F={frames}: {device} differs from cpu")
            for s_ in range(slots):
                host_traj, logits = bound.rollout(win[s_], int(anchors[s_]), frames)
                host_order = np.argsort(-logits[:, :V], axis=1, kind="stable")
                check(np.array_equal(traj[s_], host_traj)
                      and np.array_equal(order[s_], host_order),
                      f"ranker P={players} F={frames} slot {s_}: differs from the host rollout")
            key = f"P{players}_F{frames}"
            out[key] = {"rank_ms": cuda_ms(lambda: ranker.rank(win, anchors), iters=20,
                                           warmup=2) if device == "cuda" else None}
    print(f"BatchedRanker on {device}: S={slots}, bitwise its cpu run and the host rollout "
          f"at P = 2, 8 and F = 8, 12; rank ms a call " + json.dumps(out))
    return out


def predictor_phase(kernels, ts, tck, off_legs, frames: int = CONFIG5_FRAMES,
                    branches: int = CONFIG5_BRANCHES, device: str = "cuda",
                    slots: int = RANKER_SLOTS) -> dict:
    """Phase 14: the ranker (:func:`check_ranker`), then a leg of config 5
    on the native plane with every session built with the default
    predictor and peer 0's tree seeded by it; its confirmed streams equal
    ``off_legs[0]``'s (phase 12, predictor off)."""
    out = {"ranker": check_ranker(device, slots)}
    leg = config5_run_legs(("native",), device, frames, branches, predictor="default")[0]
    first = off_legs[0]
    for i, (a, b) in enumerate(zip(first["streams"], leg["streams"])):
        check(a == b, f"config5 predictor leg: peer {i}'s confirmed streams differ from leg 0's")
    check(leg["spectator_stream"] == first["spectator_stream"],
          "config5 predictor leg: the spectator stream differs from leg 0's")
    peer0 = leg["peers"][0]
    on, off = leg["counters"], first["counters"]
    print(f"config5 predictor: peer 0 full / partial / misses {on['spec_hits']} / "
          f"{on['spec_partial_hits']} / {on['spec_misses']} with the predictor, "
          f"{off['spec_hits']} / {off['spec_partial_hits']} / {off['spec_misses']} without; "
          f"predictor_rank ms {json.dumps(peer0['host_ms']['predictor_rank'])}, ticks "
          f"{json.dumps(peer0['ticks'])}; confirmed streams equal to leg 0's")
    out["leg"] = leg
    return out


# ---------------------------------------------------------------------------
# Phase 15: supervised sessions and checkpoints
# ---------------------------------------------------------------------------

SUP_DT = 1.0 / 60.0
# Iterations of each piece (``tests/test_supervisor.py``'s harness): the
# desync heal, three peers, 40 before the shift and 120 + 80 after; the
# rejoin, two peers, killed at 50, peer 0 alone for 60 and the rejoin for
# 200; the ring bit, two peers, 60 before the flip and 90 after, attested
# every 4 frames.
SUP_HEAL_ITERS = (40, 120, 80)
SUP_REJOIN_ITERS = (50, 60, 200)
SUP_SDC_ITERS = (60, 90)
SUP_ATTEST_INTERVAL = 4
# The resumed SyncTest: 200 frames, crashed at 100, a checkpoint every 30
# frames, the newest 3 kept; bits flipped in the newest file for 8 seeds.
SUP_DISK = {"frames": 200, "crash": 100, "interval": 30, "keep": 3}
SUP_FLIP_SEEDS = 8


def sup_keys(handle, frame):
    """A key every 3 frames (UP, RIGHT, DOWN, none), below box_game's
    speed clamp: ``tests/test_p2p.py``'s script."""
    keys = (1, 8, 2, 0)  # INPUT_UP, INPUT_RIGHT, INPUT_DOWN, none
    return np.uint8(keys[(frame // 3 + handle) % 4])


def sup_peer(net, n, me, device, tracer=None, disconnect_timeout=0.5):
    """One supervised box_game peer, 16 slots, ``max_prediction`` 8:
    ``(session, runner, supervisor, metrics)``; the session, runner and
    supervisor share one ``Metrics``."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.session.supervisor import SessionSupervisor
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    builder = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(n)
               .with_max_prediction_window(P2P_MAX_PREDICTION)
               .with_disconnect_timeout(disconnect_timeout))
    for h in range(n):
        builder.add_player(PlayerType.local() if h == me else PlayerType.remote(("peer", h)), h)
    metrics = Metrics()
    session = builder.start_p2p_session(net.socket(("peer", me)), clock=lambda: net.now,
                                        metrics=metrics, tracer=tracer)
    check_plane(f"supervised peer {me}", session)
    runner = RollbackRunner(box_game.make_schedule(),
                            box_game.make_world(n, device=device).commit(),
                            max_prediction=P2P_MAX_PREDICTION, num_players=n,
                            input_spec=box_game.INPUT_SPEC, metrics=metrics, tracer=tracer,
                            device=device)
    return session, runner, SessionSupervisor(session, runner, metrics=metrics), metrics


def sup_step(net, peer, inputs_for=sup_keys, events=None, recorder=None) -> None:
    """One render frame of the supervisor's drive loop (the contract in
    ``session/supervisor.py``'s docstring) on one peer; a rejoiner catches
    up with up to 4 more steps a frame. States and exceptions are read by
    name, so a peer of the JAX package runs through the same loop."""
    session, runner, sup, _ = peer
    session.poll_remote_clients()
    got = sup.tick(net.now)
    if events is not None:
        events.extend(got)
    if session.current_state().name == "RUNNING" and sup.should_advance():
        for _ in range(1 + min(sup.frames_behind(), 4)):
            for h in session.local_player_handles():
                session.add_local_input(h, sup.input_for(h, inputs_for(h, session.current_frame)))
            try:
                runner.handle_requests(session.advance_frame(), session)
            except Exception as e:  # either package's PredictionThreshold or StateFault
                if type(e).__name__ == "PredictionThreshold":
                    break
                if type(e).__name__ == "StateFault":
                    sup.on_state_fault(now=net.now)
                    break
                raise
    if recorder is not None:
        recorder.capture(session=session, runner=runner, supervisor=sup, events=got)


def sup_run(net, peers, iters: int, events=None, recorders=None, inputs_for=sup_keys) -> None:
    """``iters`` render frames of ``sup_step`` on every peer."""
    for _ in range(iters):
        net.advance(SUP_DT)
        for i, peer in enumerate(peers):
            sup_step(net, peer, inputs_for, None if events is None else events[i],
                     None if recorders is None else recorders[i])


def sup_settled(sessions) -> dict:
    """The exchange frames settled on every session, and their checksums."""
    upto = min(s.confirmed_frame() for s in sessions)
    frames = sorted(f for f in sessions[0]._local_checksums
                    if f <= upto and all(f in s._local_checksums for s in sessions[1:]))
    return {f: [s._local_checksums[f] for s in sessions] for f in frames}


def sup_kinds(events, name):
    return [e for e in events if e.kind.name == name]


# The supervisor's own counters, printed from a peer's metrics.
SUP_COUNTERS = ("desyncs_detected", "desync_votes_won", "quarantines", "recoveries",
                "state_transfers_served", "transfer_failures", "corrupt_chunks",
                "peer_disconnects", "reconnects_initiated", "players_rejoined",
                "network_interruptions", "sdc_faults", "sdc_escalations", "state_restores")


def sup_counters(metrics) -> dict:
    return {k: int(metrics.counters[k]) for k in SUP_COUNTERS if k in metrics.counters}


def sup_transfers(peers) -> dict:
    """Chunks and payload bytes the peers' supervisors served."""
    chunks = [c for _, _, sup, _ in peers for cs in sup._served.values() for c in cs]
    return {"chunks": len(chunks), "bytes": sum(len(c.payload) for c in chunks)}


class DigestSpy:
    """Records every transfer digest the supervisors compute, with a host
    copy of its world and the checksum kernel's launches it made."""

    def __init__(self, sup_mod, ts, tck):
        self.sup_mod, self.ts, self.tck = sup_mod, ts, tck
        self.real = sup_mod.transfer_digest
        self.records = []

    def __enter__(self):
        def spy(state):
            before = self.tck.world_checksum.launches
            digest = self.real(state)
            self.records.append({"device": state.device.type,
                                 "launches": self.tck.world_checksum.launches - before,
                                 "state": self.ts.tree_map(lambda x: x.cpu(), state),
                                 "digest": digest})
            return digest

        self.sup_mod.transfer_digest = spy
        return self

    def __exit__(self, *exc):
        self.sup_mod.transfer_digest = self.real
        return False

    def check(self, ts, tck, label: str, device: str) -> int:
        """Every digest is the plain checksum of the same world on the CPU,
        and on the card each took one launch of the kernel."""
        for r in self.records:
            plain = ts.combine64(tck.checksum_plain(r["state"]))
            check(r["digest"] == plain, f"{label}: a transfer digest differs from the plain "
                                        "checksum on the cpu")
            check(r["device"] == device and (device != "cuda" or r["launches"] == 1),
                  f"{label}: a digest on {r['device']} took {r['launches']} kernel launches")
        check(self.records, f"{label}: no transfer digest was computed")
        return len(self.records)


def sup_heal(kernels, ts, tck, device, out_dir, iters=SUP_HEAL_ITERS) -> dict:
    """(a) and (e): three supervised peers, each with a span tracer and a
    flight recorder; peer 2's cubes shifted 1.0 off their trajectory."""
    from bevy_ggrs_tpu_torch import obs
    from bevy_ggrs_tpu_torch.session import protocol as proto
    from bevy_ggrs_tpu_torch.session import supervisor as sup_mod
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

    net = LoopbackNetwork()
    tracers = [obs.SpanTracer(pid=i, process_name=f"peer-{i}") for i in range(3)]
    recorders = [obs.FlightRecorder() for _ in range(3)]
    peers = [sup_peer(net, 3, me, device, tracers[me]) for me in range(3)]
    events = [[], [], []]
    reset_counts(kernels)
    with DigestSpy(sup_mod, ts, tck) as spy:
        sup_run(net, peers, iters[0], events, recorders)
        check(all(s.current_state().name == "RUNNING" for s, *_ in peers),
              "supervisor heal: a peer is not RUNNING")
        victim = peers[2]
        comps = dict(victim[1].state.components)
        comps["translation"] = comps["translation"] + 1.0
        victim[1].state = victim[1].state.replace(components=comps)
        sup_run(net, peers, iters[1] + iters[2], events, recorders)
    launches = tck.world_checksum.launches
    m = victim[3]
    recovered = sup_kinds(events[2], "RECOVERED")
    checks = {}
    checks["victim_quarantined_once"] = m.counters["quarantines"] == 1
    checks["victim_recovered_once"] = m.counters["recoveries"] == 1
    checks["recovery_is_a_ring_transfer"] = bool(recovered) and all(
        e.data["kind"] == proto.STATE_KIND_RING for e in recovered)
    check(all(checks.values()), f"supervisor heal: {checks}, counters {dict(m.counters)}")
    at = recovered[0].data["frame"]
    late = [e for ev in events for e in sup_kinds(ev, "DESYNC_DETECTED") if e.data["frame"] > at]
    checks["no_desync_after_recovery"] = not late
    settled = sup_settled([s for s, *_ in peers])
    tail = {f: row for f, row in settled.items() if f > at}
    checks["settled_after_recovery_equal"] = len(tail) >= 3 and all(
        len(set(row)) == 1 for row in tail.values())
    check(all(checks.values()), f"supervisor heal: {checks}; {len(tail)} frames after {at}")
    checks["digests_equal_plain"] = spy.check(ts, tck, "supervisor heal", device) > 0
    for i in (0, 1):
        check(peers[i][3].counters.get("quarantines", 0) == 0,
              f"supervisor heal: majority peer {i} quarantined")
    # (e) the exports.
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    for i, (tr, rec) in enumerate(zip(tracers, recorders)):
        obs.export_perfetto(tr, os.path.join(out_dir, f"peer{i}.perfetto.json"))
        files[f"peer{i}_spans"] = tr.export_jsonl(os.path.join(out_dir, f"peer{i}.spans.jsonl"))
        files[f"peer{i}_frames"] = rec.export_jsonl(os.path.join(out_dir, f"peer{i}.frames.jsonl"))
    prom = obs.export_prometheus(m, recorders[2], path=os.path.join(out_dir, "metrics.prom"))
    with open(os.path.join(out_dir, "peer2.perfetto.json")) as f:
        trace = json.load(f)
    edges = [(e["args"]["prev"], e["args"]["to"]) for e in trace["traceEvents"]
             if e["name"] == "health" and e["ph"] == "i"]
    checks["trace_health_edges"] = edges == [("healthy", "quarantined"), ("quarantined", "healthy")]
    checks["recorder_health_edges"] = [t[1:] for t in recorders[2].health_transitions()] == [
        ("HEALTHY", "QUARANTINED"), ("QUARANTINED", "HEALTHY")]
    checks["prom_recovery_counters"] = all(
        f"ggrs_{k}_total 1" in prom for k in ("quarantines", "recoveries")) and \
        "ggrs_recovery_latency_ms_count 1" in prom
    check(all(checks.values()), f"supervisor heal exports: {checks}, edges {edges}")
    spans = tracers[2].summary()
    return {
        "checks": checks, "counters": [sup_counters(p[3]) for p in peers],
        "recovery_latency_ms": list(m.series["recovery_latency_ms"]),
        "recovery_frames": list(m.series["recovery_frames"]), "recovery_frame": at,
        "settled_after_recovery": len(tail), "transfer": sup_transfers(peers),
        "digests": len(spy.records), "launches": launches,
        "frames": [r.frame for _, r, *_ in peers],
        "spans": {k: spans[k] for k in ("sup_tick", "sup_apply_transfer") if k in spans},
        "exports": files,
    }


def sup_rejoin(kernels, ts, tck, device, iters=SUP_REJOIN_ITERS) -> dict:
    """(b): peer 1 dies as a ``KillRestart`` directive scripts (its socket
    closed), and a fresh peer 1 rejoins from peer 0's full checkpoint."""
    from bevy_ggrs_tpu_torch.chaos import ChaosPlan, KillRestart
    from bevy_ggrs_tpu_torch.session import protocol as proto
    from bevy_ggrs_tpu_torch.session import supervisor as sup_mod
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

    plan = ChaosPlan(7, (KillRestart(at=iters[0] * SUP_DT, peer=("peer", 1),
                                     down_for=iters[1] * SUP_DT),))
    (kill,) = plan.kill_restarts()
    net = LoopbackNetwork()
    a, b = (sup_peer(net, 2, me, device) for me in range(2))
    ev = [[], []]
    reset_counts(kernels)
    with DigestSpy(sup_mod, ts, tck) as spy:
        sup_run(net, [a, b], round(kill.at / SUP_DT), ev)
        check(a[0].current_state().name == "RUNNING", "supervisor rejoin: peer 0 not RUNNING")
        b[0].socket.close()
        sup_run(net, [a], round(kill.down_for / SUP_DT), ev)
        restart = a[0].current_frame
        b2 = sup_peer(net, 2, 1, device)
        b2[2].begin_rejoin(("peer", 0))
        check(not b2[2].should_advance(), "supervisor rejoin: advancing before adoption")
        sup_run(net, [a, b2], iters[2], ev)
    launches = tck.world_checksum.launches
    recovered = sup_kinds(ev[1], "RECOVERED")
    checks = {
        "peer0_saw_the_disconnect": a[3].counters["peer_disconnects"] == 1,
        "rejoiner_recovered_once": b2[3].counters["recoveries"] == 1,
        "recovery_is_a_full_transfer": bool(recovered) and all(
            e.data["kind"] == proto.STATE_KIND_FULL for e in recovered),
        "player_rejoined_on_peer0": bool(sup_kinds(ev[0], "PLAYER_REJOINED")),
        "freeze_window_passed": b2[2]._freeze_until is None,
    }
    settled = sup_settled([a[0], b2[0]])
    tail = {f: row for f, row in settled.items() if f > restart}
    checks["settled_after_restart_equal"] = len(tail) >= 3 and all(
        row[0] == row[1] for row in tail.values())
    check(all(checks.values()), f"supervisor rejoin: {checks}, {len(tail)} frames after "
                                f"{restart}, counters {dict(b2[3].counters)}")
    checks["digests_equal_plain"] = spy.check(ts, tck, "supervisor rejoin", device) > 0
    return {
        "checks": checks, "counters": [sup_counters(a[3]), sup_counters(b2[3])],
        "recovery_latency_ms": list(b2[3].series["recovery_latency_ms"]),
        "recovery_frames": list(b2[3].series["recovery_frames"]), "restart_frame": restart,
        "settled_after_restart": len(tail), "transfer": sup_transfers([a]),
        "digests": len(spy.records), "launches": launches,
        "frames": [a[1].frame, b2[1].frame],
    }


def sup_sdc(kernels, ts, tck, integrity, device, iters=SUP_SDC_ITERS) -> dict:
    """(c): one bit flipped in peer 0's ring; the attestation repairs the
    row in place. The same session without the flip is the clean twin."""
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

    def play(flip: bool):
        net = LoopbackNetwork()
        peers = [sup_peer(net, 2, me, device) for me in range(2)]
        for _, _, sup, _ in peers:
            sup.attest_interval = SUP_ATTEST_INTERVAL
        ev = [[], []]
        sup_run(net, peers, iters[0], ev)
        info = None
        if flip:
            ring = peers[0][1].ring
            frames = sorted(int(f) for f in ring.frames.cpu().numpy() if f >= 0)
            peers[0][1].ring, info = integrity.flip_ring_bit(
                ring, frames[len(frames) // 2] % ring.depth, np.random.RandomState(21))
        sup_run(net, peers, iters[1], ev)
        return peers, ev, info

    reset_counts(kernels)
    peers, ev, info = play(True)
    twin, _, _ = play(False)
    launches = tck.world_checksum.launches
    m = peers[0][3]
    faults = sup_kinds(ev[0], "STATE_FAULT")
    checks = {
        "one_sdc_fault": m.counters.get("sdc_faults", 0) == 1 and len(faults) == 1,
        "repaired_in_place_bitwise": bool(faults) and faults[0].data["repaired"] is True
        and faults[0].data["bitwise"] is True and faults[0].data["field"] == info["field"],
        "no_quarantine": m.counters.get("quarantines", 0) == 0
        and m.counters.get("desyncs_detected", 0) == 0,
        "healthy": peers[0][2].health.name == "HEALTHY",
    }
    streams = [s._local_checksums for s, *_ in peers]
    twin_streams = [s._local_checksums for s, *_ in twin]
    checks["trajectory_equals_clean_twin"] = streams == twin_streams and all(
        ts.combine64(tck.checksum(r.state)) == ts.combine64(tck.checksum(t.state))
        for (_, r, *_), (_, t, *_) in zip(peers, twin))
    check(all(checks.values()), f"supervisor sdc: {checks}, {info}, counters {dict(m.counters)}")
    return {"checks": checks, "counters": sup_counters(m), "flipped": info,
            "fault": {k: faults[0].data[k] for k in ("frames", "field", "bitwise")},
            "launches": launches, "frames": [r.frame for _, r, *_ in peers],
            "compared_with_twin": len(streams[0])}


def sup_disk(kernels, ts, tck, integrity, device, ckpt_dir, disk=SUP_DISK,
             seeds=SUP_FLIP_SEEDS) -> dict:
    """(d): a SyncTest with a ``CheckpointManager`` crashes, and a fresh
    runner and session resume from the newest checkpoint; a bit flipped in
    that file makes the manager fall back to the one before."""
    import shutil

    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import SyncTestSession
    from bevy_ggrs_tpu_torch.utils.persistence import CheckpointManager, restore_runner

    def pair(dev):
        session = SyncTestSession(2, box_game.INPUT_SPEC, check_distance=7,
                                  max_prediction=P2P_MAX_PREDICTION)
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(2, device=dev).commit(),
                                max_prediction=P2P_MAX_PREDICTION, num_players=2,
                                input_spec=box_game.INPUT_SPEC, device=dev)
        return session, runner

    def play(session, runner, upto, stream, mgr=None):
        while runner.frame < upto:
            for h in range(2):
                session.add_local_input(h, sup_keys(h, runner.frame))
            runner.handle_requests(session.advance_frame(), session)
            stream[runner.frame] = ts.combine64(tck.checksum(runner.state))
            if mgr is not None:
                mgr.maybe_save(runner, session=session)
        return stream

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    frames = disk["frames"]
    reset_counts(kernels)
    straight = play(*pair(device), frames, {})
    mgr = CheckpointManager(ckpt_dir, interval=disk["interval"], keep=disk["keep"])
    crashed = play(*pair(device), disk["crash"], {}, mgr)
    saved = [f for f, _ in mgr._checkpoints()]
    session, runner = pair(device)
    meta = mgr.restore_latest(runner, session=session)
    resumed_at = (runner.frame, session.current_frame)
    resumed = play(session, runner, frames, {})
    launches = tck.world_checksum.launches
    cpu = play(*pair("cpu"), frames, {})
    newest = max(saved)
    checks = {
        "kept_newest": saved == [newest - disk["interval"] * k
                                 for k in range(disk["keep"] - 1, -1, -1)],
        "restored_newest": meta is not None and resumed_at == (newest, newest),
        "resumed_equals_straight": all(resumed[f] == straight[f] for f in resumed)
        and len(resumed) == frames - newest,
        "crashed_prefix_equals_straight": all(crashed[f] == straight[f] for f in crashed),
        "cuda_equals_cpu": straight == cpu,
    }
    check(all(checks.values()), f"supervisor disk: {checks}, saved {saved}, resumed at "
                                f"{resumed_at}")
    # The newest file with one bit flipped, seed by seed: a file that no
    # longer loads is skipped for the one before; a flip in bytes no reader
    # uses (a zip header's date, say) loads the same world.
    previous = sorted(saved)[-2]
    outcomes = []
    for seed in range(seeds):
        flipped = f"{ckpt_dir}_flip{seed}"
        shutil.rmtree(flipped, ignore_errors=True)
        shutil.copytree(ckpt_dir, flipped)
        path = os.path.join(flipped, f"ckpt_{newest}.npz")
        integrity.flip_file_bit(path, np.random.RandomState(seed))
        try:
            restore_runner(path, pair("cpu")[1])
            refused = False
        except Exception:  # whatever the damaged file raises
            refused = True
        s2, r2 = pair(device)
        got = CheckpointManager(flipped, interval=disk["interval"],
                                keep=disk["keep"]).restore_latest(r2, session=s2)
        check(got is not None, f"supervisor disk: seed {seed}: nothing restored")
        if refused:
            check(r2.frame == previous, f"supervisor disk: seed {seed}: a refused newest file "
                                        f"restored frame {r2.frame}, not {previous}")
            if not any(o["fell_back"] for o in outcomes):
                # One fallback plays on to the end, bitwise the straight run.
                again = play(s2, r2, frames, {})
                check(all(again[f] == straight[f] for f in again),
                      "supervisor disk: the run resumed from the older file differs")
        else:
            check(r2.frame == newest and ts.combine64(tck.checksum(r2.state))
                  == straight[newest], f"supervisor disk: seed {seed}: a flip that loads "
                                       "gave another world")
        outcomes.append({"seed": seed, "fell_back": refused, "restored": r2.frame})
        shutil.rmtree(flipped)
    checks["flip_falls_back"] = sum(o["fell_back"] for o in outcomes) >= seeds // 2
    check(checks["flip_falls_back"], f"supervisor disk: flips {outcomes}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"checks": checks, "saved": saved, "resumed_at": resumed_at[0],
            "fallbacks": sum(o["fell_back"] for o in outcomes), "seeds": seeds,
            "launches": launches, "frames": frames}


def supervisor_phase(kernels, ts, tck, integrity, device: str = "cuda", out_dir=None,
                     heal=SUP_HEAL_ITERS, rejoin=SUP_REJOIN_ITERS, sdc=SUP_SDC_ITERS,
                     disk=SUP_DISK, seeds=SUP_FLIP_SEEDS) -> dict:
    """Phase 15: (a) a desync healed by a ring transfer with (e) its span
    trace, frame records and Prometheus text exported, (b) a killed and
    restarted peer rejoining from a full checkpoint, (c) a ring bit
    repaired in place by the attestation, (d) a SyncTest resumed from disk.
    Prints one ``supervisor`` line; returns it."""
    import tempfile

    t0 = time.perf_counter()
    card = smi() if device == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sup_") as tmp:
        out = {
            "heal": sup_heal(kernels, ts, tck, device, out_dir or os.path.join(tmp, "obs"),
                             heal),
            "rejoin": sup_rejoin(kernels, ts, tck, device, rejoin),
            "sdc": sup_sdc(kernels, ts, tck, integrity, device, sdc),
            "disk": sup_disk(kernels, ts, tck, integrity, device, os.path.join(tmp, "ckpt"),
                             disk, seeds),
        }
    out["launches"] = sum(v["launches"] for v in out.values())
    out["wall_s"] = time.perf_counter() - t0
    print("supervisor " + json.dumps(out) + f"; {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 16: batched multi-session serving
# ---------------------------------------------------------------------------

# The largest serving config of the JAX package's bench
# (serve_batched_box_game_S1024): 1,024 1v1 matches on one card, each with
# max_prediction 4 and an 8-branch x 4-frame speculative rollout.
SERVE_PLAYERS, SERVE_MAXPRED, SERVE_BRANCHES, SERVE_SPEC_FRAMES = 2, 4, 8, 4
SERVE_SLOTS = 1024
SERVE_TICKS = 120
SERVE_WINDOW = 6  # ticks a timed window: one rollback each
SERVE_CHURN = (64, 60)  # slots retired and admitted fresh, at this tick
SERVE_SAMPLED = (0, 512, 1023)
SERVE_TWIN = (16, 60)  # the cpu twin: slots 0..15 for 60 ticks
SERVE_BOIDS = (64, 256, 24)  # boids per world, slots, ticks
# serve_chaos_S64's shapes: 64 SyncTest matches in 4 stagger groups,
# max_prediction 4, 8 branches x 3 frames, a 50 ms watchdog on a fake
# clock, checkpoints every 60 frames.
SERVE_SERVER = {"matches": 64, "groups": 4, "spec_frames": 3, "flaky": (3, 40),
                "sdc_at": 90, "kill_at": 120, "after": 24, "interval": 60}


def serve_script(treq, players: int, seed: int, ticks: int) -> list:
    """``(requests, confirmed_frame)`` ticks in the canonical session shape
    (the JAX package's ``bench.py::_serve_script``): 3 confirmed steps, a
    2-deep predicted stall, then the rollback recovery tick; a seed a
    match gives every match its own inputs."""
    rng = np.random.RandomState(seed)

    def adv(bits):
        return treq.AdvanceFrame(bits=np.asarray(bits, np.uint8),
                                 status=np.zeros(players, np.int32))

    script, frame = [], 0
    while len(script) < ticks:
        for _ in range(3):
            bits = rng.randint(0, 16, size=players)
            script.append(([treq.SaveGameState(frame), adv(bits)], frame))
            frame += 1
        frontier = frame - 1
        pred = rng.randint(0, 16, size=players)
        for d in range(2):
            script.append(([treq.SaveGameState(frame + d), adv(pred)], frontier))
        frame += 2
        reqs = [treq.LoadGameState(frame - 2)]
        for t in range(2):
            bits = pred if rng.rand() < 0.5 else rng.randint(0, 16, size=players)
            reqs += [treq.SaveGameState(frame - 2 + t), adv(bits)]
        reqs += [treq.SaveGameState(frame), adv(rng.randint(0, 16, size=players))]
        script.append((reqs, frame))
        frame += 1
    return script[:ticks]


def serve_model(model: str, device, n: int = SERVE_BOIDS[0]):
    """``(schedule, initial world, input spec)`` of a serving model (boids
    with ``n`` boids a world)."""
    from bevy_ggrs_tpu_torch.models import boids, box_game

    if model == "boids":
        return (boids.make_schedule(), boids.make_world(n, SERVE_PLAYERS, device=device).commit(),
                boids.INPUT_SPEC)
    return (box_game.make_schedule(), box_game.make_world(SERVE_PLAYERS, device=device).commit(),
            box_game.INPUT_SPEC)


def serve_core(model: str, slots: int, device, metrics=None, n: int = SERVE_BOIDS[0]):
    """A warmed core; its warmup tick (every slot's rollout) is priced:
    ``core._exec.cost()`` holds its peak device bytes on the card."""
    from bevy_ggrs_tpu_torch.serve import BatchedSessionCore

    schedule, world, spec = serve_model(model, device, n)
    core = BatchedSessionCore(schedule, world, SERVE_MAXPRED, SERVE_PLAYERS, spec,
                              num_slots=slots, num_branches=SERVE_BRANCHES,
                              spec_frames=SERVE_SPEC_FRAMES, metrics=metrics, device=device)
    core._exec.enable_cost_capture(f"serve_{model}_S{slots}")
    core.warmup()
    return core


def serve_slot_record(ts, core, slot: int) -> tuple:
    """A slot's frame, state bytes and ring frames and digests, on the host."""
    host = ts.to_host(core.slot_state(slot))
    return (core.slots[slot].frame, [a.tobytes() for a in ts.tree_leaves(host)],
            core.rings.frames[slot].cpu().numpy().tobytes(),
            core.rings.checksums[slot].cpu().numpy().tobytes())


def serve_singleton_equal(ts, model: str, core, slot: int, script, device,
                          n: int = SERVE_BOIDS[0]) -> None:
    """The zero-desync gate (``bench.py``'s): a port singleton
    ``SpeculativeRollbackRunner`` on the same device plays the slot's
    script; frame, ``combine64(checksum(state))`` and the ring's digests
    must be bitwise the slot's."""
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

    schedule, world, spec = serve_model(model, device, n)
    oracle = SpeculativeRollbackRunner(
        schedule, world, max_prediction=SERVE_MAXPRED, num_players=SERVE_PLAYERS,
        input_spec=spec, num_branches=SERVE_BRANCHES, spec_frames=SERVE_SPEC_FRAMES,
        device=device)
    oracle.warmup()
    for reqs, confirmed in script:
        oracle.tick(reqs, confirmed, None)
    check(core.slots[slot].frame == oracle.frame
          and ts.combine64(ts.checksum(core.slot_state(slot)))
          == ts.combine64(ts.checksum(oracle.state))
          and torch.equal(core.rings.checksums[slot].cpu(), oracle.ring.checksums.cpu()),
          f"serve {model}: slot {slot} differs from its singleton replay")


def check_slot_save(ts, tck, state, depth: int, masked: bool = True,
                    label: str = "slot save") -> dict:
    """The save of the ``[S]`` world ``state`` into ``[S, depth]`` rings (a
    frame a slot and, with ``masked``, a keep flag a slot; one launch)
    against its plain version on the same inputs, bitwise: lanes, ring
    rows, frames and digests, over rounds of random frames (negative ones
    too: floor mod) on rings already full, with keep-masks of every
    density or (unmasked, as the rollout saves) none; then its device time
    at that shape (every slot saving), its plain version's and its
    bound."""
    rng = np.random.RandomState(16)
    device = state.device.type
    slots = int(state.alive.shape[0])
    rings = ts.branch_rings(ts.tree_map(lambda x: x[0], state), slots, depth)
    for f in range(depth):
        ts.ring_save(rings, state, f)
    plain = clone_ring(ts, rings)
    for r in range(4):
        frames = torch.as_tensor(rng.randint(-50, 100000, slots).astype(np.int32), device=device)
        keep = (torch.as_tensor(rng.rand(slots) < (1.0, 0.5, 0.1, 0.0)[r], device=device)
                if masked else None)
        before = tck.world_checksum.launches
        got = tck.world_checksum(state, "save", ring=rings, frames=frames, keep=keep)
        check(device == "cpu" or tck.world_checksum.launches == before + 1,
              f"{label}: one launch")
        want = tck.save_slots_plain(plain, state, frames, keep)
        check(torch.equal(got, want), f"{label} round {r}: lanes differ from the plain version")
        check(torch.equal(rings.frames, plain.frames)
              and torch.equal(rings.checksums, plain.checksums)
              and all(same_bytes(a, b) for a, b in zip(world_leaves(ts, rings.states),
                                                       world_leaves(ts, plain.states))),
              f"{label} round {r}: the rings differ from the plain version's")
    masks = ("keep-masks (all, half, a tenth, none)" if masked
             else "no keep-mask (every slot saves)")
    print(f"{label} S={slots} depth {depth}: lanes, rows, frames and digests bitwise equal "
          f"to the plain version over 4 rounds of random frames and {masks}")
    if device != "cuda":
        return {}
    frames = torch.arange(slots, dtype=torch.int32, device=device)
    keep = torch.ones(slots, dtype=torch.bool, device=device) if masked else None
    lay = tck.layout(state)
    world_bytes = sum(p.row_bytes for p in lay.parts)
    words = sum(p.words for p in lay.parts if p.role not in (tck.ALIVE, tck.RESOURCE))
    ops = (int(state.alive.sum()) * (words * CHECKSUM_OPS_PER_WORD + FMIX_OPS)
           + slots * lay.resource_words * (CHECKSUM_OPS_PER_WORD + FMIX_OPS))
    # Each world read once and written once, its digest and frame written,
    # its frame (and keep flag) read.
    moved = slots * (2 * world_bytes + 16 + 4 + 4 + (1 if masked else 0))
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_I32_PER_S * 1e3
    m = {"S": slots, "depth": depth, "masked": masked, "world_bytes": world_bytes,
         "ms": graph_ms(lambda: tck.world_checksum(state, "save", ring=rings, frames=frames,
                                                   keep=keep)),
         "call_ms": cuda_ms(lambda: tck.world_checksum(state, "save", ring=rings, frames=frames,
                                                       keep=keep)),
         "plain_ms": cuda_ms(lambda: tck.save_slots_plain(plain, state, frames, keep), iters=20),
         "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
         else "operations", "bytes": moved, "ops": ops}
    print(f"{label} S={slots} ({world_bytes} bytes a world): device {m['ms']:.6f} ms (graph "
          f"replay), per call with host work {m['call_ms']:.6f} ms, plain {m['plain_ms']:.6f} "
          f"ms a call; bound {m['bound_ms']:.7f} ms ({m['bound_by']}: {moved} bytes, {ops} ops)")
    return m


def serve_ticks(core, scripts: dict, ticks, kernels, force=None, timed=None,
                probe=None) -> dict:
    """Tick every slot of ``scripts`` through ``ticks`` (a range), the
    kernel counts set to 0 just before each tick and read just after: the
    checksum kernel must have launched once per burst step in which some
    slot saved plus once per rollout frame, and ``force`` (when given)
    once per burst step with an advance plus once per rollout frame. With
    ``timed``, whole windows of :data:`SERVE_WINDOW` ticks are timed (the
    card synchronized at each window's end) and appended to it. With
    ``probe`` (an ``obs.AttributionProbe``), each tick is its host window
    and the core's dispatch its device window."""
    from bevy_ggrs_tpu_torch.ops import checksum as tck

    cuda = core.device.type == "cuda"
    F = core.spec_frames
    totals = {"world_checksum": 0, "force": 0, "ticks": 0, "branch_build_ms": 0.0,
              "arg_assembly_ms": 0.0}
    t0 = time.perf_counter()
    for n, t in enumerate(ticks):
        reset_counts(kernels)
        core.attribution = probe
        with probe.host() if probe is not None else contextlib.nullcontext():
            core.tick({s: sc[t] + (None,) for s, sc in scripts.items()})
        core.attribution = None
        ex = core._exec
        if cuda:
            check(tck.world_checksum.launches == ex.last_save_steps + F,
                  f"tick {t}: {tck.world_checksum.launches} checksum launches, "
                  f"{ex.last_save_steps} saving burst steps + {F}")
            if force is not None:
                check(force.launches == ex.last_adv_steps + F,
                      f"tick {t}: {force.launches} {force.__name__} launches, "
                      f"{ex.last_adv_steps} advancing burst steps + {F}")
        totals["world_checksum"] += tck.world_checksum.launches
        totals["force"] += force.launches if force is not None else 0
        totals["ticks"] += 1
        totals["branch_build_ms"] += core.last_branch_build_ms
        totals["arg_assembly_ms"] += core.last_arg_assembly_ms
        if timed is not None and (n + 1) % SERVE_WINDOW == 0:
            if cuda:
                torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0) * 1e3 / SERVE_WINDOW)
            t0 = time.perf_counter()
    return totals


def serve_core_phase(kernels, ts, tck, device="cuda", slots: int = SERVE_SLOTS,
                     ticks: int = SERVE_TICKS, churn=SERVE_CHURN, twin=SERVE_TWIN,
                     sampled=SERVE_SAMPLED) -> dict:
    """(a) The box_game core: ``slots`` matches, ``ticks`` ticks, windows
    of :data:`SERVE_WINDOW` ticks timed (the first is warmup); mid-run
    ``churn[0]`` slots retire and as many are admitted fresh, with every
    build counter unchanged from warmup on; the sampled slots (and a
    churned one) bitwise their singleton replays; slots 0..15 at the churn
    tick bitwise a cpu twin's."""
    from bevy_ggrs_tpu_torch.obs import AttributionProbe
    from bevy_ggrs_tpu_torch.ops import checksum as tck
    from bevy_ggrs_tpu_torch.session import requests as treq
    from bevy_ggrs_tpu_torch.utils import build_cache
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P = SERVE_PLAYERS
    t_warm = time.perf_counter()
    core = serve_core("box_game", slots, device, metrics=Metrics())
    admitted = [core.admit() for _ in range(slots)]
    warm_s = time.perf_counter() - t_warm
    counters0 = build_cache.compile_counters()
    shapes0 = core._exec.cache_size()
    scripts = {s: serve_script(treq, P, 1000 + s, ticks) for s in admitted}
    n_churn, at = churn
    times: list = []
    totals = serve_ticks(core, scripts, range(at), kernels, timed=times)
    twin_slots, twin_ticks = twin
    twin_records = None
    if at == twin_ticks:
        twin_records = [serve_slot_record(ts, core, s) for s in range(twin_slots)]
    # Churn: the slots from 100 on (fewer on a small run) retire; fresh
    # matches take them.
    first = min(100, slots - n_churn - 1)
    churned = list(range(first, first + n_churn))
    t_churn = time.perf_counter()
    for s in churned:
        core.retire(s)
    for s in churned:
        check(core.admit() == s, "a fresh match takes the lowest free slot")
    churn_ms = (time.perf_counter() - t_churn) * 1e3
    fresh = {s: serve_script(treq, P, 9000 + s, ticks - at) for s in churned}
    late = {s: ([None] * at + fresh[s] if s in fresh else sc) for s, sc in scripts.items()}
    busy = attribution = None
    if device == "cuda":  # the last window under torch.profiler, untimed
        from torch.profiler import ProfilerActivity, profile

        more = serve_ticks(core, late, range(at, ticks - SERVE_WINDOW), kernels, timed=times)
        torch.cuda.synchronize()
        probe = AttributionProbe()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            last = serve_ticks(core, late, range(ticks - SERVE_WINDOW, ticks), kernels,
                               probe=probe)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_prof) * 1e3
        busy = busy_of(prof, wall_ms, SERVE_WINDOW)
        attribution = probe.result(lanes=slots)
        for k in ("world_checksum", "force", "ticks", "branch_build_ms", "arg_assembly_ms"):
            more[k] += last[k]
    else:
        more = serve_ticks(core, late, range(at, ticks), kernels, timed=times)
    check(build_cache.compile_counters() == counters0 and core._exec.cache_size() == shapes0 == 1,
          f"serve: churn built or prepared something: {counters0} -> "
          f"{build_cache.compile_counters()}, shapes {shapes0} -> {core._exec.cache_size()}")
    for k in ("world_checksum", "force", "ticks", "branch_build_ms", "arg_assembly_ms"):
        totals[k] += more[k]
    for s in sampled:
        serve_singleton_equal(ts, "box_game", core, s, scripts[s][:ticks], device)
    serve_singleton_equal(ts, "box_game", core, churned[0], fresh[churned[0]], device)
    # The rollout's own save: the last rollout's [S x B] worlds into fresh
    # [S x B, F] rings, every slot saving.
    SB = slots * SERVE_BRANCHES
    rollout_save = check_slot_save(
        ts, tck, ts.tree_map(lambda x: x.reshape((SB,) + tuple(x.shape[2:])), core.prev_states),
        SERVE_SPEC_FRAMES, masked=False, label="rollout save")
    if twin_records is not None:
        cpu = serve_core("box_game", twin_slots, "cpu")
        for _ in range(twin_slots):
            cpu.admit()
        serve_ticks(cpu, {s: scripts[s] for s in range(twin_slots)}, range(twin_ticks),
                    kernels)
        check(all(serve_slot_record(ts, cpu, s) == twin_records[s] for s in range(twin_slots)),
              f"serve: the cpu twin's {twin_slots} slots differ from the card's")
    windows = times[1:] if len(times) > 1 else times
    p50, p99 = float(np.percentile(windows, 50)), float(np.percentile(windows, 99))
    out = {"S": slots, "B": SERVE_BRANCHES, "F": SERVE_SPEC_FRAMES, "ticks": totals["ticks"],
           "tick_p50_ms": p50, "tick_p99_ms": p99,
           "matches_per_chip_at_60hz": slots * 16.7 / p99,
           "launches_per_tick": {"world_checksum": totals["world_checksum"] / totals["ticks"]},
           "launches": {"world_checksum": totals["world_checksum"]},
           "host_ms_per_tick": {k: totals[k] / totals["ticks"]
                                for k in ("branch_build_ms", "arg_assembly_ms")},
           "spec": {"hits": core.spec_hits, "partial": core.spec_partial_hits,
                    "misses": core.spec_misses, "rollbacks": core.rollbacks_total},
           "cost": core._exec.cost(), "busy": busy, "attribution": attribution,
           "rollout_save": rollout_save,
           "dispatch_ms": {k: v for k, v in core.metrics.summary().get(
               "serve_dispatch_ms", {}).items() if k in ("mean", "p50", "p99")},
           "warmup_and_admission_s": warm_s, "churn_ms": churn_ms,
           "windows_ms": windows, "sampled_bitwise": list(sampled) + [churned[0]],
           "cpu_twin": f"{twin_slots} slots x {twin_ticks} ticks bitwise"}
    print(f"serve box_game S={slots}: {totals['ticks']} ticks, tick p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms (windows of {SERVE_WINDOW}), {out['launches_per_tick']} launches a "
          f"tick; the batched tick's host call {out['dispatch_ms']} ms; device busy "
          f"{json.dumps(busy)}; last window attributed {json.dumps(attribution)}; churn of "
          f"{n_churn} slots in {churn_ms:.1f} ms with no build; "
          f"slots {out['sampled_bitwise']} bitwise their singletons; cpu twin equal")
    return out


def serve_boids_phase(kernels, ts, tpw, device="cuda", boids=SERVE_BOIDS) -> dict:
    """(b) The boids core: ``slots`` boids-``n`` matches; the f32 force
    kernel once a burst step over the ``[S]`` world and once a rollout
    frame over the ``[S x B]`` one; sampled slots bitwise their
    singletons. One more tick records the kernel's operands at both
    shapes (the last call at each), and the kernel is held against its
    plain version on them."""
    from bevy_ggrs_tpu_torch.models import boids as tboids
    from bevy_ggrs_tpu_torch.session import requests as treq

    n, slots, ticks = boids
    force = tpw.pairwise_force_rows
    core = serve_core("boids", slots, device, n=n)
    for _ in range(slots):
        core.admit()
    scripts = {s: serve_script(treq, SERVE_PLAYERS, 2000 + s, ticks + 1) for s in range(slots)}
    times: list = []
    totals = serve_ticks(core, scripts, range(ticks), kernels, force=force, timed=times)
    seen = {}

    def spy(*args, **params):
        seen[tuple(args[0].shape[:-2])] = tuple(a.clone() for a in args)
        return force(*args, **params)

    tboids.pairwise_force_rows_kernel = spy
    try:
        last = serve_ticks(core, scripts, range(ticks, ticks + 1), kernels, force=force)
    finally:
        tboids.pairwise_force_rows_kernel = force
    for k in ("world_checksum", "force", "ticks"):
        totals[k] += last[k]
    check(sorted(seen) == [(slots,), (slots * SERVE_BRANCHES,)],
          f"serve boids: the force kernel ran at {sorted(seen)}")
    force_err = 0.0
    for lead, args in sorted(seen.items()):
        err, scale = held_forces(tpw, f"serve boids forces {lead} x {n}", args,
                                 tboids._kernel_params())
        force_err = max(force_err, err)
        print(f"serve boids forces over {lead[0]} worlds x {n} (the tick's own operands): "
              f"max_abs_err={err:.3e} (atol {FORCE_ATOL}, largest force {scale:.4f}) "
              f"repeat bitwise")
    pos = core.states.components["position"]
    check(bool(torch.isfinite(pos).all()) and tuple(pos.shape[:2]) == (slots, n),
          "serve boids: positions")
    for s in sorted({0, slots // 2, slots - 1}):
        serve_singleton_equal(ts, "boids", core, s, scripts[s], device, n)
    windows = times[1:] if len(times) > 1 else times
    out = {"S": slots, "n": n, "worlds_a_rollout_frame": slots * SERVE_BRANCHES,
           "ticks": totals["ticks"], "tick_p50_ms": float(np.percentile(windows, 50)),
           "tick_p99_ms": float(np.percentile(windows, 99)), "force_err": force_err,
           "launches": {"world_checksum": totals["world_checksum"],
                        force.__name__: totals["force"]}}
    print(f"serve boids-{n} S={slots}: {totals['ticks']} ticks, {totals['force']} "
          f"{force.__name__} launches (one a step, {slots * SERVE_BRANCHES} worlds a rollout "
          f"frame), tick p50 {out['tick_p50_ms']:.3f} ms; slots 0, {slots // 2}, {slots - 1} "
          f"bitwise their singletons")
    return out


class FlakySession:
    """``advance_frame`` raises exactly once, before the inner session
    moves: the injected session crash."""

    def __init__(self, inner, fail_at):
        self._inner, self._fail_at, self.failed = inner, fail_at, False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def advance_frame(self):
        if not self.failed and self._inner.current_frame == self._fail_at:
            self.failed = True
            raise RuntimeError("injected session crash")
        return self._inner.advance_frame()


def serve_server_phase(kernels, ts, integrity, device="cuda", out_dir=None,
                       cfg=SERVE_SERVER) -> dict:
    """(c) ``MatchServer`` with ``cfg["matches"]`` SyncTest matches against
    a control server: one session crash, fenced to a recovery lane and
    readmitted; a ring bit flipped and found by ``_attest_sweep``, repaired
    in place; the server killed after ``kill_at`` frames and restored from
    its newest checkpoint into a fresh server; after ``after`` more frames
    every match bitwise the control's, and no build counter moved from
    warmup on."""
    import tempfile

    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.serve import MatchHandle, MatchServer
    from bevy_ggrs_tpu_torch.session.builder import SessionBuilder
    from bevy_ggrs_tpu_torch.utils import build_cache
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P, M = SERVE_PLAYERS, cfg["matches"]
    clk = [0.0]
    tmp = tempfile.TemporaryDirectory(dir=out_dir)
    ckpt = os.path.join(tmp.name, "ckpt")

    def build(checkpoint: bool):
        server = MatchServer(
            box_game.make_schedule(), box_game.make_world(P, device=device).commit(),
            SERVE_MAXPRED, P, box_game.INPUT_SPEC, capacity=M, stagger_groups=cfg["groups"],
            num_branches=SERVE_BRANCHES, spec_frames=cfg["spec_frames"], metrics=Metrics(),
            clock=lambda: clk[0], watchdog_budget_ms=50.0, watchdog_strike_limit=3,
            checkpoint_dir=ckpt if checkpoint else None,
            checkpoint_interval=cfg["interval"], checkpoint_keep=3, attest_interval=None,
            device=device)
        server.warmup()
        return server

    def synctest():
        return (SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
                .with_max_prediction_window(SERVE_MAXPRED).with_check_distance(2)
                .start_synctest_session())

    def inputs_for(seed):
        def f(frame, handle):
            return np.uint8((frame * 3 + handle * 5 + seed) % 16)
        return f

    t0 = time.perf_counter()
    control, server = build(False), build(True)
    counters0 = build_cache.compile_counters()
    flaky_match, fail_at = cfg["flaky"]
    handles, c_handles = [], []
    for m in range(M):
        sess = synctest()
        if m == flaky_match:
            sess = FlakySession(sess, fail_at)
        handles.append(server.add_match(sess, inputs_for(m)))
        c_handles.append(control.add_match(synctest(), inputs_for(m)))
    check(handles == c_handles, "the two servers placed the matches alike")
    reset_counts(kernels)
    injected = None
    for frame in range(cfg["kill_at"]):
        if frame == cfg["sdc_at"]:
            h = handles[M // 2 + 1]
            core = server.groups[h.group]
            row = (core.slots[h.slot].frame - 2) % core.ring_depth
            core.rings, injected = integrity.flip_ring_bit(
                core.rings, row, np.random.RandomState(16), slot=h.slot)
            server._attest_sweep()
        server.run_frame()
        control.run_frame()
    detected = server.metrics.counters.get("sdc_detected", 0)
    check(injected is not None and detected == 1 and server.sdc_repairs_total == 1,
          f"serve sdc: detected {detected}, repaired {server.sdc_repairs_total} of 1 injected")
    check(server.faults_total == 1 and server.readmissions_total == 1,
          f"serve crash: {server.faults_total} faults, {server.readmissions_total} readmissions")
    check(server.checkpointer.saves_total == cfg["kill_at"] // cfg["interval"],
          f"serve: {server.checkpointer.saves_total} checkpoints")
    launches = {k.__name__: k.launches for k in kernels}
    faults = {"faults": server.faults_total, "readmissions": server.readmissions_total,
              "last_recovery_frames": server.last_recovery_frames,
              "sdc_injected": 1, "sdc_detected": detected,
              "sdc_field": injected["field"], "checkpoints": server.checkpointer.saves_total}
    del server  # the process dies: what survives is on disk
    reborn = build(True)
    restored = reborn.checkpointer.restore(reborn, {
        (h.group, h.slot): {"session": synctest(), "local_inputs": inputs_for(m)}
        for m, h in enumerate(handles)})
    check(sorted(restored, key=lambda h: (h.group, h.slot))
          == sorted(handles, key=lambda h: (h.group, h.slot)), "serve: restored handles")
    reset_counts(kernels)
    for _ in range(cfg["after"]):
        reborn.run_frame()
        control.run_frame()
    for k in kernels:
        launches[k.__name__] += k.launches
    end = cfg["kill_at"] + cfg["after"]
    for h in handles:
        a, b = reborn.groups[h.group], control.groups[h.group]
        check(a.slots[h.slot].frame == b.slots[h.slot].frame == end
              and serve_slot_record(ts, a, h.slot) == serve_slot_record(ts, b, h.slot),
              f"serve server: match {h} differs from the control's after the restore")
    check(build_cache.compile_counters() == counters0,
          "serve server: faults, readmission or the restore built or prepared something")
    faults.update(matches=M, frames=end, wall_s=time.perf_counter() - t0,
                  launches=launches)
    tmp.cleanup()
    print(f"serve server: {M} matches, {end} frames: crash fenced and readmitted "
          f"(recovery {faults['last_recovery_frames']} frames), sdc in "
          f"{faults['sdc_field']} detected and repaired, killed at {cfg['kill_at']} and "
          f"restored from disk; every match bitwise the control's, no build")
    return faults


def serve_phase(kernels, ts, tck, integrity, tpw, device="cuda", out_dir=None,
                small: bool = False) -> dict:
    """Phase 16, serving: the burst's slot save against its plain version,
    (a) the box_game core (and the rollout's save on its worlds), (b) the
    boids core, (c) the match server; ``small`` cuts every size for a run
    on the CPU."""
    t0 = time.perf_counter()
    depth = SERVE_MAXPRED + 1
    if small:
        save = check_slot_save(ts, tck, branch_worlds(ts, box_branch_worlds(ts, 8, device, 16)),
                               depth)
        core = serve_core_phase(kernels, ts, tck, device, slots=8, ticks=18, churn=(2, 12),
                                twin=(4, 12), sampled=(0, 7))
        boids_run = serve_boids_phase(kernels, ts, tpw, device, boids=(16, 2, 12))
        server = serve_server_phase(kernels, ts, integrity, device, out_dir, cfg={
            **SERVE_SERVER, "matches": 4, "groups": 2, "flaky": (1, 8), "sdc_at": 16,
            "kill_at": 24, "after": 6, "interval": 12})
    else:
        save = check_slot_save(
            ts, tck, branch_worlds(ts, box_branch_worlds(ts, SERVE_SLOTS, device, 16)), depth)
        core = serve_core_phase(kernels, ts, tck, device)
        boids_run = serve_boids_phase(kernels, ts, tpw, device)
        server = serve_server_phase(kernels, ts, integrity, device, out_dir)
    line = {**{k: core[k] for k in ("S", "B", "F", "tick_p50_ms", "tick_p99_ms",
                                    "matches_per_chip_at_60hz", "launches_per_tick",
                                    "host_ms_per_tick")},
            "card": smi() if device == "cuda" else "cpu", "core": core, "boids": boids_run,
            "server": server, "slot_save": save, "rollout_save": core["rollout_save"],
            "wall_s": time.perf_counter() - t0}
    print("serve " + json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# Phase 17: the entry points (examples_torch/ and bench_torch.py)
# ---------------------------------------------------------------------------

ENTRY_SYNC_FRAMES = 120
ENTRY_P2P = {"frames": 120, "fps": 20, "delay": 20}
ENTRY_ZOO = {"entities": 1024, "frames": 60}
ENTRY_BENCH = ("box_game_rollback_8f_x_256b_latency", "box_game_4p_8f_x_256b",
               "box_game_8p_12f_x_1024b", "boids_1k_8f_x_128b_mxu",
               "box_game_recovery_8f_spec_vs_serial")
ENTRY_SECONDS = 300


def free_udp_ports(n: int) -> int:
    """The first of ``n`` free UDP ports in a row on 127.0.0.1."""
    import socket

    for base in range(23000 + (os.getpid() % 400) * 10, 60000, 10):
        socks = []
        try:
            for port in range(base, base + n):
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no free UDP ports")


def start_example(name: str, *args):
    """An example of ``examples_torch/`` as a process, its output in files."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, str(ROOT / "examples_torch" / name),
                             *map(str, args)], cwd=ROOT, stdout=out, stderr=err,
                            stdin=subprocess.DEVNULL, text=True)
    proc.files = (out, err)
    return proc


def finish_example(label: str, proc) -> str:
    try:
        proc.wait(timeout=ENTRY_SECONDS)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    texts = []
    for f in proc.files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    out, err = texts
    check(proc.returncode == 0, f"entry points: {label} rc {proc.returncode}: {err[-3000:]}")
    return out


def example_world(out: str, tag: str) -> list:
    """A printed world: from ``frame_count`` on the line holding ``tag``,
    and the cube lines after it."""
    lines = out.splitlines()
    i = next(k for k, line in enumerate(lines) if tag in line)
    block = [lines[i][lines[i].index("frame_count"):]]
    block += [line for line in lines[i + 1:i + 9] if line.startswith("  cube")]
    return block


def example_launches(out: str) -> dict:
    line = next(line for line in out.splitlines() if line.startswith("[kernels] "))
    return json.loads(line[len("[kernels] "):])


def entry_points_phase(kernels, ts, device: str = "cuda") -> dict:
    """Phase 17 (its docstring entry). Returns the launches of the
    checksum and mxu2 kernels in the examples' processes and the bench
    rows, and the largest checksum difference (0) of the headline's
    rollout, cuda against cpu."""
    import bench_torch
    from bevy_ggrs_tpu_torch import ops

    on_card = device == "cuda"
    t0 = time.perf_counter()
    p2p = ENTRY_P2P
    base = free_udp_ports(2)
    procs = {
        "synctest": start_example("box_game_synctest.py", "--device", device,
                                  "--check-distance", 7, "--frames", ENTRY_SYNC_FRAMES,
                                  "--report-metrics"),
        "synctest cpu": start_example("box_game_synctest.py", "--device", "cpu",
                                      "--check-distance", 7, "--frames", ENTRY_SYNC_FRAMES),
        "peer0": start_example("box_game_p2p.py", "--device", device, "--local-port", base,
                               "--players", "localhost", f"127.0.0.1:{base + 1}",
                               "--frames", p2p["frames"], "--fps", p2p["fps"],
                               "--input-delay", p2p["delay"], "--report-metrics"),
        "peer1": start_example("box_game_p2p.py", "--device", device, "--local-port",
                               base + 1, "--players", f"127.0.0.1:{base}", "localhost",
                               "--frames", p2p["frames"], "--fps", p2p["fps"],
                               "--input-delay", p2p["delay"], "--report-metrics"),
        "model_zoo": start_example("model_zoo_synctest.py", "--device", device,
                                   "--model", "boids", "--entities", ENTRY_ZOO["entities"],
                                   "--kernel", "mxu", "--check-distance", 7,
                                   "--frames", ENTRY_ZOO["frames"], "--report-metrics"),
    }
    # The bench rows, in this process, while the examples run.
    bench_torch.set_device(device)
    rows, launches = {}, {}
    for name in ENTRY_BENCH:
        reset_counts(kernels)
        rows[name] = bench_torch.run_config(name)
        launches[name] = {k: n for k, n in ops.launch_counts().items() if n}
        print(f"entry bench {name}: " + json.dumps(rows[name]), flush=True)
    # The headline's rollout on the card and on the CPU, on the same bits.
    ex, state, bits = bench_torch._box_game_case(2, 8, 256)
    res = ex.run(state, 0, bits)
    bench_torch.set_device("cpu")
    ex_cpu, state_cpu, bits_cpu = bench_torch._box_game_case(2, 8, 256)
    res_cpu = ex_cpu.run(state_cpu, 0, bits_cpu)
    bench_torch.set_device(device)
    check(np.array_equal(bits, bits_cpu), "entry points: the headline's bits differ")
    lanes, lanes_cpu = (r.checksums.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
                        for r in (res, res_cpu))
    check(np.array_equal(lanes, lanes_cpu),
          "entry points: the headline's rollout checksums on cuda differ from the cpu's")
    for name, row in rows.items():
        check(row["value"] > 0 and row["platform"] == bench_torch._platform(),
              f"entry points: bench row {name}: {row.get('value')} {row.get('platform')}")
        if on_card:
            check(launches[name].get("world_checksum", 0) > 0,
                  f"entry points: bench row {name} launched no checksum kernel")
    if on_card:
        check(launches["boids_1k_8f_x_128b_mxu"].get("pairwise_force_rows_mxu2", 0) > 0,
              "entry points: the config-4 row launched no mxu2 kernel")

    out = {k: finish_example(k, p) for k, p in procs.items()}
    sync, sync_cpu = (example_world(out[k], "synctest ok") for k in ("synctest", "synctest cpu"))
    check(sync == sync_cpu and int(sync[0].split("=")[1]) >= ENTRY_SYNC_FRAMES - 3,
          f"entry points: synctest worlds {sync} != {sync_cpu}")
    settled = []
    for peer in ("peer0", "peer1"):
        log = out[peer]
        check("desync" not in log, f"entry points: {peer} saw a desync: {log[-2000:]}")
        frames = int(re.search(r"p2p done after (\d+) sim frames", log).group(1))
        check(frames > p2p["delay"] + 30, f"entry points: {peer} ran {frames} frames")
        line = next(x for x in log.splitlines() if x.startswith("[settled] "))
        settled.append(json.loads(line[len("[settled] "):]))
    common = sorted(set(settled[0]) & set(settled[1]), key=int)
    check(len(common) >= 1 and all(settled[0][f] == settled[1][f] for f in common),
          f"entry points: settled checksums differ on {common}")
    zoo = dict(re.findall(r"(\w+)=(\S+)", next(
        x for x in out["model_zoo"].splitlines() if x.startswith("[boids synctest ok]"))))
    check(int(zoo["rollbacks"]) > 0, f"entry points: model_zoo {zoo}")
    ex_launches = {k: example_launches(out[k]) for k in ("synctest", "peer0", "peer1",
                                                         "model_zoo")}
    if on_card:
        advanced = int(zoo["frames"]) + int(zoo["resimulated"])
        check(ex_launches["model_zoo"]["pairwise_force_rows_mxu2"] == advanced,
              f"entry points: model_zoo mxu2 launches {ex_launches['model_zoo']} != "
              f"{advanced} advanced frames")
        for k, v in ex_launches.items():
            check(v["world_checksum"] > 0, f"entry points: {k} launched no checksum kernel")
    summary = {
        "bench": {name: {k: row.get(k) for k in (
            "value", "latency_ms", "sustained_ms", "within_budget_device",
            "within_budget_wall", "spec_commit_speedup", "serial_resim_ms",
            "kernel_launches_per_rollout")} for name, row in rows.items()},
        "synctest_world": sync, "p2p_settled_common": len(common),
        "p2p_frames": [int(re.search(r"after (\d+) sim", out[p]).group(1))
                       for p in ("peer0", "peer1")],
        "model_zoo": zoo, "example_launches": ex_launches,
        "seconds": round(time.perf_counter() - t0, 2),
    }
    print("entry " + json.dumps(summary), flush=True)
    total = {"world_checksum": 0, "pairwise_force_rows_mxu2": 0}
    for counts in list(launches.values()) + list(ex_launches.values()):
        for k in total:
            total[k] += counts.get(k, 0)
    return {"launches": total, "summary": summary}


# ---------------------------------------------------------------------------
# Phase 18: the fleet and the relay on cuda
# ---------------------------------------------------------------------------

FLEET = {"matches": 16, "players": 2, "max_prediction": 4, "branches": 8, "spec_frames": 3,
         "groups": 4, "ramp": 20, "migrations": 4, "mig_every": 6, "checkpoint": 30,
         "kill_after": 20, "after": 20}
FLEET_PROC = {"matches": 4, "checkpoint": 40, "timeout": 120.0}
RELAY = {"frames": 240, "spectators": 16, "tree_spectators": 64, "drain": 60}
# The same legs cut for a run on the CPU.
FLEET_SMALL = dict(FLEET, matches=6, migrations=2, ramp=8, checkpoint=12, after=8)
RELAY_SMALL = dict(RELAY, frames=120, spectators=4, tree_spectators=8, drain=40)


def fleet_inputs(match_id: int):
    """The fleet's input script: a pure function of (frame, handle, match)."""
    def f(frame, handle):
        return np.uint8((frame * 3 + handle * 5 + match_id) % 16)

    return f


def fleet_control_checksums(ts, box_game, frames_of: dict, cfg=FLEET) -> dict:
    """Each match's 64-bit state checksum at its frame, from a never-migrated
    SyncTest control of the same match on the CPU."""
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import SessionBuilder

    out = {}
    for mid, frame in frames_of.items():
        session = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(cfg["players"])
                   .with_max_prediction_window(cfg["max_prediction"])
                   .with_check_distance(2).start_synctest_session())
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(cfg["players"], device="cpu").commit(),
                                cfg["max_prediction"], cfg["players"], box_game.INPUT_SPEC,
                                device="cpu")
        inputs = fleet_inputs(mid)
        while session.current_frame < frame:
            for h in range(cfg["players"]):
                session.add_local_input(h, inputs(session.current_frame, h))
            runner.handle_requests(session.advance_frame(), session)
        out[mid] = ts.combine64(ts.checksum(runner.state))
    return out


def fleet_inprocess(kernels, ts, tck, device, root, cfg=FLEET) -> dict:
    """Leg (a): a FleetBalancer over a loopback network runs two
    MatchServers on ``device``; live migrations, then a failover of server 0
    from its on-disk checkpoint after heartbeat silence. Every match bitwise
    its CPU control; the restored worlds' kernel checksum equals the plain
    version's on a CPU copy; nothing is built after warmup."""
    from bevy_ggrs_tpu_torch.fleet import FleetBalancer
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.serve import MatchServer
    from bevy_ggrs_tpu_torch.session import SessionBuilder
    from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
    from bevy_ggrs_tpu_torch.utils import build_cache
    from bevy_ggrs_tpu_torch.utils.metrics import Metrics

    P, S = cfg["players"], cfg["matches"]
    net = LoopbackNetwork()
    metrics = Metrics()
    bal = FleetBalancer(socket=net.socket(("fleet", "bal")), addr=("fleet", "bal"),
                        heartbeat_timeout=0.5, clock=lambda: net.now, metrics=metrics)

    def synctest():
        return (SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
                .with_max_prediction_window(cfg["max_prediction"])
                .with_check_distance(2).start_synctest_session())

    servers = {}
    for k in range(2):
        ck_dir = os.path.join(root, f"srv{k}")
        srv = MatchServer(
            box_game.make_schedule(), box_game.make_world(P, device=device).commit(),
            cfg["max_prediction"], P, box_game.INPUT_SPEC, num_branches=cfg["branches"],
            spec_frames=cfg["spec_frames"], capacity=S + 4, stagger_groups=cfg["groups"],
            metrics=metrics, clock=lambda: net.now, checkpoint_dir=ck_dir,
            checkpoint_interval=cfg["checkpoint"], server_id=k,
            fleet_socket=net.socket(("hb", k)), fleet_addr=("fleet", "bal"),
            heartbeat_interval=8, device=device)
        srv.warmup()
        bal.register(k, srv, addr=("mig", k), sock=net.socket(("mig", k)), checkpoint_dir=ck_dir)
        servers[k] = srv
    for m in range(S):
        bal.place_match(m, synctest(), fleet_inputs(m), server_id=m % 2)
    warm_id = 10_000  # a dummy on the survivor: server 0's checkpoints hold real matches only
    bal.place_match(warm_id, synctest(), fleet_inputs(warm_id), server_id=1)

    def tick():
        net.advance(1.0 / 60.0)
        for srv in servers.values():
            srv.run_frame()
        bal.pump()

    for _ in range(cfg["ramp"]):
        tick()
    for dst in (0, 1):  # the churn paths, warm once per server
        warm = bal.begin_migration(warm_id, dst_id=dst)
        net.advance(0.0)
        check(bal.complete_migration(warm) is not None, "fleet: warm migration")
    base = build_cache.compile_counters()
    reset_counts(kernels)
    migrated, stalls = [], []
    for i in range(cfg["migrations"]):
        mid = 2 * i  # server 0's matches
        mig = bal.begin_migration(mid, dst_id=1)
        tick()
        net.advance(0.0)
        handle = bal.complete_migration(mig)
        check(handle is not None and not mig.aborted, f"fleet: migration of match {mid}")
        migrated.append(mid)
        stalls.append(int(mig.stall_frames))
        for _ in range(cfg["mig_every"]):
            tick()
    # A checkpoint of server 0 with every match it still hosts, then its loss.
    on0 = [m for m, pl in bal.placements.items() if pl.server_id == 0]
    for _ in range(cfg["checkpoint"] + 1):
        tick()
    del servers[0]
    killed_at = net.now
    dead, ticks = [], 0
    while not dead:
        tick()
        dead = bal.check()
        ticks += 1
        check(ticks < 300, "fleet: server 0's silence never detected")
    check(dead == [0], f"fleet: dead {dead}")
    recovered = bal.failover(0)
    for _ in range(cfg["after"]):
        tick()
    launches = {k: n for k, n in ((fn.__name__, fn.launches) for fn in kernels) if n}
    builds = {k: v - base[k] for k, v in build_cache.compile_counters().items() if v != base[k]}
    check(not builds, f"fleet: builds after warmup {builds}")
    check(bal.matches_lost == 0, f"fleet: {bal.matches_lost} matches lost")
    check(sorted(m for m, _, _ in recovered) == sorted(on0),
          f"fleet: recovered {sorted(m for m, _, _ in recovered)} of {sorted(on0)}")
    srv1 = servers[1]
    frames_of, got = {}, {}
    for m in range(S):
        pl = bal.placements[m]
        check(pl.server_id == 1, f"fleet: match {m} on server {pl.server_id}")
        frames_of[m] = srv1.groups[pl.handle.group].slots[pl.handle.slot].frame
        got[m] = ts.combine64(ts.checksum(srv1.groups[pl.handle.group].slot_state(
            pl.handle.slot)))
    control = fleet_control_checksums(ts, box_game, frames_of, cfg)
    moved = sorted(set(migrated) | set(on0))
    bad = [m for m in range(S) if got[m] != control[m]]
    check(not bad, f"fleet: matches {bad} differ from their CPU controls")
    # The kernel against its plain version on the restored worlds.
    for m, _, h in recovered:
        state = srv1.groups[h.group].slot_state(h.slot)
        kern = tck.world_checksum(state).cpu()
        plain = tck.checksum_plain(ts.tree_map(lambda x: x.cpu(), state))
        check(torch.equal(kern, plain), f"fleet: restored match {m}: {kern} != {plain}")
    return {"migrations": len(migrated), "migration_stall_frames": stalls,
            "failovers": int(bal.failovers), "recovered": len(recovered),
            "matches_lost": int(bal.matches_lost), "bitwise_vs_cpu_control": len(moved),
            "detect_s": round(net.now - killed_at, 3), "launches": launches,
            "builds_after_warmup": builds}


def child_log_tail(member) -> str:
    path = getattr(member.process._stderr, "name", None)
    if not path or not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return f.read()[-3000:].decode(errors="replace")


def fleet_processes(device, root, cfg=FLEET_PROC) -> dict:
    """Leg (b): a ProcFleet of two ``python -m bevy_ggrs_tpu_torch.fleet.proc``
    children on ``device``; admissions, one migration over real UDP, a
    SIGKILL and the parent's checkpoint failover onto the survivor."""
    from bevy_ggrs_tpu_torch.fleet.proc import ProcFleet

    fleet = ProcFleet(root, base_config={"fps": 0, "heartbeat_interval": 8,
                                         "status_interval": 20,
                                         "checkpoint_interval": cfg["checkpoint"],
                                         "device": device},
                      heartbeat_timeout=2.0)
    killed = set()

    def until(pred, what, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            fleet.pump()
            for sid, m in fleet.members.items():
                if sid not in killed and not m.process.alive():
                    check(False, f"fleet proc: child {sid} died: {child_log_tail(m)}")
            if pred():
                return
            time.sleep(0.02)
        tails = {sid: child_log_tail(m) for sid, m in fleet.members.items()}
        check(False, f"fleet proc: timed out waiting for {what}; stderr {tails}")

    def frames(sid):
        st = fleet.members[sid].status or {}
        return {int(k): v for k, v in st.get("matches", {}).items()}

    try:
        a = fleet.spawn_server(wait_ready=True, timeout=cfg["timeout"])
        b = fleet.spawn_server(wait_ready=True, timeout=cfg["timeout"])
        mids = list(range(41, 41 + cfg["matches"]))
        for mid in mids:
            check(fleet.admit(mid, a) == a, f"fleet proc: admit {mid}")
        until(lambda: all(frames(a).get(m, 0) > 5 for m in mids), "matches serving")
        for sid in (a, b):
            fleet.members[sid].process.send(cmd="rebase_compiles")
        check(fleet.migrate(mids[-1], b), "fleet proc: migrate")
        until(lambda: fleet.migrations_completed == 1 and frames(b).get(mids[-1], 0) > 0,
              "the migration")
        base_frames = (fleet.members[a].status or {}).get("frames", 0)
        until(lambda: (fleet.members[a].status or {}).get("frames", 0)
              > base_frames + 2 * cfg["checkpoint"], "checkpoint coverage")
        at_kill = frames(a)
        killed.add(a)
        fleet.members[a].process.kill()
        dead = []
        until(lambda: bool(dead.extend(fleet.check()) or dead), "death detection", 15.0)
        check(dead == [a], f"fleet proc: dead {dead}")
        fleet.failover(a, preferred={m: b for m in mids[:-1]})
        until(lambda: fleet.matches_recovered + fleet.matches_lost >= len(mids) - 1,
              "the failover")
        check(fleet.matches_lost == 0, f"fleet proc: {fleet.matches_lost} matches lost")
        until(lambda: all(frames(b).get(m, 0) > at_kill.get(m, 0) for m in mids[:-1]),
              "recovered matches serving on")
        st = fleet.members[b].status
        check(st["faults"] == 0 and st["evictions"] == 0 and st["compiles"] == 0,
              f"fleet proc: survivor status {st}")
    finally:
        fleet.close()
    bye = fleet.members[b].status
    check(bye.get("event") == "bye", f"fleet proc: no bye from the survivor: {bye}")
    built = {sid: (m.status or {}).get("compiles") for sid, m in fleet.members.items()}
    check(all(n == 0 for n in built.values()), f"fleet proc: builds after warmup {built}")
    launches = bye["launches"].get("world_checksum", 0)
    if device == "cuda":
        check(launches > 0, "fleet proc: the survivor launched no checksum kernel")
    return {"children": {sid: {"warmup_s": m.warmup_s, "first_beat_s": m.first_beat_s,
                               "compiles": (m.status or {}).get("compiles")}
                         for sid, m in fleet.members.items()},
            "migrations": fleet.migrations_completed, "failovers": fleet.failovers,
            "recovered": fleet.matches_recovered, "matches_lost": fleet.matches_lost,
            "survivor_frames": bye["frames"], "survivor_launches": launches}


def relay_leg(kernels, ts, tck, device, cfg=RELAY) -> dict:
    """Leg (c): a 2-peer box_game match on ``device`` entirely through the
    root relay of a depth-2 RelayTree (root, 2 mids, 4 leaves) over
    loopback; the root serves ``spectators`` StreamSpectators, the leaves
    ``tree_spectators``. Every spectator ends on the publisher's ring row,
    bitwise; the row's plain checksum on the CPU equals the peer's saved
    digest."""
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.relay import (RelaySocket, StateCodec, StatePublisher,
                                           StreamSpectator, peer_addr)
    from bevy_ggrs_tpu_torch.relay.tree import RelayTree
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import (PlayerType, PredictionThreshold,
                                             SessionBuilder, SessionState)
    from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork

    P, MAXPRED = 2, 8
    net = LoopbackNetwork()
    n_spec = cfg["spectators"] + cfg["tree_spectators"]
    tree = RelayTree(net.socket, session_id=1, clock=lambda: net.now, max_depth=2,
                     fanout_capacity=4096, server_kwargs={"max_subscribers": 4096})
    root = tree.add_relay()
    mids = [tree.add_relay(parent=root.addr) for _ in range(2)]
    leaves = [tree.add_relay(parent=mid.addr) for mid in mids for _ in range(2)]
    peers = []
    for me in range(P):
        sock = RelaySocket(net.socket(("peer", me)), [root.addr], session_id=1, peer_id=me,
                           clock=lambda: net.now)
        builder = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(P)
                   .with_max_prediction_window(MAXPRED))
        for h in range(P):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(peer_addr(h)), h)
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(P, device=device).commit(), MAXPRED, P,
                                box_game.INPUT_SPEC, device=device)
        peers.append((builder.start_p2p_session(sock, clock=lambda: net.now), runner))
    pub = StatePublisher(*peers[0], socket=peers[0][0].socket)
    codec = StateCodec.for_state(box_game.make_world(P, device="cpu").commit())
    targets = [root.addr] * cfg["spectators"] + [
        leaves[s % len(leaves)].addr for s in range(cfg["tree_spectators"])]
    specs = [StreamSpectator(net.socket(("spec", s)), relays=[addr], session_id=1, codec=codec,
                             clock=lambda: net.now) for s, addr in enumerate(targets)]
    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    reset_counts(kernels)
    t0 = time.perf_counter()
    for _ in range(cfg["frames"]):
        net.advance(1.0 / 60.0)
        for session, runner in peers:
            session.poll_remote_clients()
            if session.current_state() != SessionState.RUNNING:
                continue
            for h in session.local_player_handles():
                session.add_local_input(h, np.uint8(keys[(session.current_frame // 3 + h) % 4]))
            try:
                runner.handle_requests(session.advance_frame(), session)
            except PredictionThreshold:
                pass
        pub.publish(net.now)
        tree.pump(net.now)
        for spec in specs:
            spec.poll(net.now)
    for _ in range(cfg["drain"]):  # the stream flushes to its head
        net.advance(1.0 / 60.0)
        for session, _ in peers:
            session.poll_remote_clients()
        pub.publish(net.now)
        tree.pump(net.now)
        for spec in specs:
            spec.poll(net.now)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in ((fn.__name__, fn.launches) for fn in kernels) if n}
    head, head_bytes = pub._prev_frame, pub._prev
    runner0 = peers[0][1]
    check(ts.ring_frame_at(runner0.ring, head) == head,
          f"relay: the publisher's ring no longer holds frame {head}")
    row = ts.ring_load(runner0.ring, head)
    check(codec.encode(row) == head_bytes, "relay: the last published bytes are not the ring row")
    exact = sum(1 for s in specs if s.current_frame == head and s.state_bytes == head_bytes)
    check(exact == n_spec, f"relay: {n_spec - exact} of {n_spec} spectators not bitwise "
          f"at frame {head}")
    plain = tck.checksum_plain(codec.decode_state(head_bytes))
    saved = runner0.ring.checksums[head % runner0.ring.depth].cpu()
    check(torch.equal(plain, saved), f"relay: plain {plain} != the peer's saved digest {saved}")
    sessions = [s for s, _ in peers]
    upto = min(s.confirmed_frame() for s in sessions)
    common = [f for f in sessions[0]._local_checksums
              if f <= upto and all(f in s._local_checksums for s in sessions[1:])]
    check(common and all(len({int(s._local_checksums[f]) for s in sessions}) == 1
                         for f in common), "relay: the peers' settled checksums differ")
    if head in sessions[0]._local_checksums:
        check(int(sessions[0]._local_checksums[head]) == ts.combine64(plain),
              "relay: the peer's settled checksum is not the decoded state's")
    if device == "cuda":
        check(launches.get("world_checksum", 0) > 0, "relay: no checksum launch")
    return {"frames": int(runner0.frame), "published_frames": int(pub.published_frames),
            "readbacks": int(pub.readbacks), "spectators": n_spec, "spectators_bitwise": exact,
            "root_spectators": cfg["spectators"], "tree_spectators": cfg["tree_spectators"],
            "tree_depth": tree.depth(), "head": int(head), "settled_compared": len(common),
            "launches": launches, "wall_s": round(wall, 2)}


def fleet_relay_phase(kernels, ts, tck) -> dict:
    """Phase 18 (its docstring entry): the in-process fleet, the process
    fleet and the relay, on the card. Prints a ``fleet`` line and a
    ``relay`` line; returns the checksum launches they made."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        inproc = fleet_inprocess(kernels, ts, tck, "cuda", os.path.join(tmp, "inproc"))
        procs = fleet_processes("cuda", os.path.join(tmp, "procs"))
    relay = relay_leg(kernels, ts, tck, "cuda")
    card = smi()
    fleet_line = {"in_process": inproc, "processes": procs,
                  "migrations": inproc["migrations"] + procs["migrations"],
                  "failovers": inproc["failovers"] + procs["failovers"],
                  "matches_lost": inproc["matches_lost"] + procs["matches_lost"],
                  "card": card}
    print("fleet " + json.dumps(fleet_line), flush=True)
    relay["phase_wall_s"] = round(time.perf_counter() - t0, 2)
    relay["card"] = card
    print("relay " + json.dumps(relay), flush=True)
    return {"launches": (inproc["launches"].get("world_checksum", 0)
                         + procs["survivor_launches"]
                         + relay["launches"].get("world_checksum", 0)),
            "fleet": fleet_line, "relay": relay}


# ---------------------------------------------------------------------------
# Phase 19: sharding
# ---------------------------------------------------------------------------

# Phase 19's sizes on the card, and the small ones its CPU test runs.
SHARD = dict(sync_frames=48, boids=1024, boids_frames=10, big=32768,
             rollout=(128, 8), p2p_iters=150, p2p_branches=64,
             axis=4, axis_frames=48, axis_iters=90, axis_branches=16)
SHARD_CPU = dict(sync_frames=24, proj_frames=12, boids=64, boids_frames=5, big=256,
                 rollout=(16, 4), p2p_iters=60, p2p_branches=8,
                 axis=3, axis_frames=24, axis_iters=60, axis_branches=8)
SHARD_CD = 7  # the SyncTests' check distance (the boids ones take 4)
SHARD_DT = 1.0 / 60.0


def shard_reports(session) -> list:
    """Wrap ``report_checksum``: every (frame, checksum) reported, in
    order."""
    log = []
    report = session.report_checksum

    def wrapped(frame, cs):
        log.append((int(frame), int(cs)))
        report(frame, cs)

    session.report_checksum = wrapped
    return log


def shard_synctest(device, frames: int, mesh=None, schedule=None, world=None,
                   keys=sup_keys, players: int = 2, cd: int = SHARD_CD,
                   input_spec=None) -> dict:
    """A SyncTest through a :class:`RollbackRunner` (``mesh`` shards its
    world's entity axis): box_game unless ``schedule``/``world`` say
    otherwise. Returns the reported checksum stream and the launches."""
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.parallel import sharding
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import SyncTestSession

    spec = input_spec or box_game.INPUT_SPEC
    runner = RollbackRunner(schedule or box_game.make_schedule(),
                            world if world is not None
                            else box_game.make_world(players, device=device).commit(),
                            max_prediction=8, num_players=players, input_spec=spec,
                            device=device, mesh=mesh)
    runner.warmup()
    session = SyncTestSession(players, spec, check_distance=cd, max_prediction=8)
    log = shard_reports(session)
    reset_counts(ops.wrappers())
    sharding.reset_collectives()
    for f in range(frames):
        for h in range(players):
            session.add_local_input(h, keys(h, f))
        runner.handle_requests(session.advance_frame(), session)
    return {"stream": log, "launches": ops.launch_counts(),
            "collectives": dict(sharding.COLLECTIVES), "world": runner.world()}


def shard_worlds_equal(a: dict, b: dict) -> bool:
    """Two host worlds (``to_host`` dicts) hold the same bytes."""
    from bevy_ggrs_tpu_torch.state import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb))


def shard_boids_sync(device, n: int, kernel: str, frames: int, mesh=None,
                     mode=None) -> dict:
    """A boids-``n`` SyncTest at check distance 4: through
    ``make_sharded_schedule`` on a mesh, else ``make_schedule``."""
    from bevy_ggrs_tpu_torch.models import boids

    sched = (boids.make_sharded_schedule(mesh, "entity", kernel, mode) if mesh is not None
             else boids.make_schedule(kernel, mode))
    return shard_synctest(device, frames, mesh, sched,
                          boids.make_world(n, 2, device=device).commit(),
                          keys=lambda h, f: np.uint8((f + h) % 16), cd=4,
                          input_spec=boids.INPUT_SPEC)


def shard_xla_frame(device, n: int, mesh) -> dict:
    """One ``kernel="xla"`` frame of an ``n``-boid world, unsharded and
    sharded over ``mesh``'s entity axis: the whole world's bytes after it
    and its checksums."""
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.ops.checksum import checksum
    from bevy_ggrs_tpu_torch.parallel import sharding
    from bevy_ggrs_tpu_torch.rollout import advance_n
    from bevy_ggrs_tpu_torch.state import combine64, to_host

    state = boids.make_world(n, 2, device=device).commit()
    bits = torch.tensor([[1, 8]], dtype=torch.uint8, device=device)
    plain = advance_n(boids.make_schedule("xla"), state, bits)
    shard = sharding.EntityShard(mesh, "entity", n)
    sharding.reset_collectives()
    out = advance_n(boids.make_sharded_schedule(mesh, "entity", "xla"), shard.own(state), bits)
    cs = combine64(shard.checksum(out))
    whole = to_host(shard.whole(out))
    return {"equal": shard_worlds_equal(to_host(plain), whole),
            "checksum": cs, "plain_checksum": combine64(checksum(plain)),
            "collectives": dict(sharding.COLLECTIVES)}


def shard_rollout(device, B: int, F: int, mesh) -> dict:
    """A box_game rollout of ``B`` branches x ``F`` frames split over
    ``mesh``'s branch axis against the unsharded one: every branch's
    lanes, and commits of the first and the last branch (each owned by
    another rank on some rank). The launches are those of the sharded
    rollout and its commits; the twin's and the comparisons' come after
    they are read."""
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.parallel import sharding
    from bevy_ggrs_tpu_torch.parallel.speculate import SpeculativeExecutor
    from bevy_ggrs_tpu_torch.state import combine64
    from bevy_ggrs_tpu_torch.ops.checksum import checksum

    sched = box_game.make_schedule()
    state = box_game.make_world(2, device=device).commit()
    bits = np.random.RandomState(12).randint(0, 16, (B, F, 2)).astype(np.uint8)
    plain_ex = SpeculativeExecutor(sched, B, F)
    plain = plain_ex.run(state, 0, bits)
    reset_counts(ops.wrappers())
    sharding.reset_collectives()
    ex = SpeculativeExecutor(sched, B, F, mesh=mesh)
    res = ex.run(state, 0, bits)
    lanes = ex.layout.all_checksums(res.checksums)
    committed = {j: ex.commit(res, j) for j in (0, B - 1)}
    launches, collectives = ops.launch_counts(), dict(sharding.COLLECTIVES)
    commits = {}
    for j, (ring, st) in committed.items():
        pring, pst = plain_ex.commit(plain, j)
        commits[j] = (torch.equal(ring.checksums, pring.checksums)
                      and combine64(checksum(st)) == combine64(checksum(pst)))
    return {"lanes_equal": torch.equal(lanes.cpu(), plain.checksums.cpu()),
            "commits_equal": commits, "owner_of_last": ex.layout.branch.owner(B - 1)[0],
            "launches": launches, "collectives": collectives}


def shard_checkpoint(device, frames: int, mesh) -> dict:
    """Checkpoints and repair of a box_game SyncTest entity-sharded over
    ``mesh``: its checkpoint (``dumps_runner``, the whole world gathered)
    against an unsharded twin's; each checkpoint loaded into the other
    kind of runner, the three runs carried on ``frames`` more frames; then
    a bit flipped in the first entity rank's ring rows, attested over the
    group and repaired by resimulation."""
    from bevy_ggrs_tpu_torch import integrity
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.parallel.sharding import axis_rank
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import SyncTestSession
    from bevy_ggrs_tpu_torch.utils.persistence import dumps_runner, loads_runner

    def pair(m):
        runner = RollbackRunner(box_game.make_schedule(),
                                box_game.make_world(2, device=device).commit(),
                                max_prediction=8, num_players=2,
                                input_spec=box_game.INPUT_SPEC, device=device, mesh=m)
        session = SyncTestSession(2, box_game.INPUT_SPEC, check_distance=SHARD_CD,
                                  max_prediction=8)
        return runner, session, shard_reports(session)

    def play(runner, session, f0, f1):
        for f in range(f0, f1):
            for h in range(2):
                session.add_local_input(h, sup_keys(h, f))
            runner.handle_requests(session.advance_frame(), session)

    sharded, plain = pair(mesh), pair(None)
    for r, sess, _ in (sharded, plain):
        play(r, sess, 0, frames)
    data = [dumps_runner(r, session=sess) for r, sess, _ in (sharded, plain)]
    meshed_from_plain, plain_from_meshed = pair(mesh), pair(None)
    loads_runner(data[1], meshed_from_plain[0], meshed_from_plain[1])
    loads_runner(data[0], plain_from_meshed[0], plain_from_meshed[1])
    runs = (sharded, plain, meshed_from_plain, plain_from_meshed)
    for r, sess, _ in runs:
        play(r, sess, frames, 2 * frames)
    worlds = [r.world() for r, _, _ in runs]
    n = len(runs[3][2])  # the reports since the loads
    tail = [log[len(log) - n:] for _, _, log in runs]
    runner = sharded[0]
    if axis_rank(mesh, "entity") == 0:
        runner.ring, _ = integrity.flip_ring_bit(
            runner.ring, (runner.frame - 2) % runner.ring.depth, np.random.RandomState(4))
    report = runner.attest_and_repair()
    return {"equal": data[0] == data[1]
            and all(shard_worlds_equal(worlds[0], w) for w in worlds[1:])
            and all(t == tail[0] for t in tail[1:]) and n > 0
            and report["repaired"] == 1 and report["bitwise"]
            and shard_worlds_equal(runner.world(), worlds[0]),
            "checkpoint_bytes_equal": data[0] == data[1], "repair": report}


def shard_box_plugin(device, mesh=None, branches: int = 0):
    """The box_game app of both peers of :func:`shard_p2p`."""
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import box_game

    plugin = (GGRSPlugin(box_game.INPUT_SPEC)
              .with_input_system(lambda h, app: sup_keys(h, app.session.current_frame))
              .register_rollback_component("translation", shape=(3,))
              .register_rollback_component("velocity", shape=(3,))
              .register_rollback_component("player_handle", dtype=torch.int32, default=-1)
              .register_rollback_resource("frame_count", np.uint32(0))
              .with_rollback_schedule(box_game.make_schedule())
              .with_num_players(2)
              .with_world_capacity(16)
              .with_setup_system(lambda w, app: box_game.spawn_players(
                  w, 2, next_id=app.rollback_id_provider.next_id))
              .with_device(device))
    if branches:
        plugin.with_speculation(branches)
    if mesh is not None:
        plugin.with_mesh(mesh)
    return plugin


def shard_p2p(device, iters: int, branches: int, mesh=None) -> dict:
    """Two box_game apps speculating on ``branches`` branches
    (``GGRSPlugin.with_mesh`` when ``mesh`` is given) over a loopback
    network at 2.5 frames of latency:
    the settled checksums of both peers, each peer's hits and its
    attestation."""
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.parallel import sharding
    from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

    net = LoopbackNetwork(latency=2.5 * SHARD_DT, seed=21)
    apps = []
    for me in range(2):
        app = shard_box_plugin(device, mesh, branches).build()
        builder = SessionBuilder(box_game.INPUT_SPEC).with_num_players(2)
        for h in range(2):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(("peer", h)), h)
        app.insert_session(builder.start_p2p_session(
            net.socket(("peer", me)), clock=lambda: net.now), SessionType.P2P)
        apps.append(app)
    reset_counts(ops.wrappers())
    sharding.reset_collectives()
    for _ in range(iters):
        net.advance(SHARD_DT)
        for app in apps:
            app.update(net.now)
    runners = [app.stage.runner for app in apps]
    settled = sup_settled([app.session for app in apps])
    return {"settled": {str(f): [int(c) for c in cs] for f, cs in settled.items()},
            "frames": [app.frame for app in apps],
            "hits": [r.spec_hits + r.spec_partial_hits for r in runners],
            "rollbacks": [r.rollbacks_total for r in runners],
            "attested": [bool(r.attestation.ok) for r in runners],
            "real_checked": [r.attestation.real_checked for r in runners],
            "desyncs": sum(e.kind.name == "DESYNC_DETECTED" for app in apps
                           for e in app.events),
            "launches": ops.launch_counts(), "collectives": dict(sharding.COLLECTIVES)}


def shard_spec_synctest(device, frames: int, branches: int) -> dict:
    """A box_game SyncTest through a speculating runner's ``tick`` (no
    session reports: the ring's rows are the stream)."""
    from bevy_ggrs_tpu_torch import ops
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session import SyncTestSession
    from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
    from bevy_ggrs_tpu_torch.state import combine64

    runner = SpeculativeRollbackRunner(
        box_game.make_schedule(), box_game.make_world(2, device=device).commit(),
        max_prediction=8, num_players=2, input_spec=box_game.INPUT_SPEC,
        num_branches=branches, spec_frames=4, seed=3, device=device)
    runner.warmup()
    session = SyncTestSession(2, box_game.INPUT_SPEC, check_distance=SHARD_CD,
                              max_prediction=8)
    reset_counts(ops.wrappers())
    stream = []
    for f in range(frames):
        for h in range(2):
            session.add_local_input(h, sup_keys(h, f))
        runner.tick(session.advance_frame(), max(f - SHARD_CD, -1), None)
        stream.append(combine64(runner.ring.checksums[f % runner.ring.depth]))
    return {"stream": stream, "frame": runner.frame,
            "ring": runner.ring.checksums.cpu().numpy().tolist(),
            "hits": [runner.spec_hits, runner.spec_misses],
            "launches": ops.launch_counts()}


@contextlib.contextmanager
def session_axis(s: int):
    """``GGRS_SESSION_AXIS=s`` while the block builds its runners."""
    old = os.environ.get("GGRS_SESSION_AXIS")
    os.environ["GGRS_SESSION_AXIS"] = str(s)
    try:
        yield
    finally:
        if old is None:
            del os.environ["GGRS_SESSION_AXIS"]
        else:
            os.environ["GGRS_SESSION_AXIS"] = old


# The runs of phase 19 (b) on the card, and the CPU tests' sets.
SHARD_RUNS = ("box", "boids", "boids_grid", "xla", "rollout", "checkpoint")
SHARD_RUNS_CPU = SHARD_RUNS + ("boids_extra", "projectiles")
SHARD_RUNS_2X2 = ("box", "rollout", "p2p")


def shard_rank_runs(device, cfg: dict, world: int, runs=SHARD_RUNS) -> dict:
    """Phase 19 (b) on one rank of ``world`` (every rank runs it in
    lockstep): each sharded run and its unsharded twin, with the launches
    and collectives of the sharded run. ``runs`` names them: ``box``
    (the box_game SyncTest entity-sharded over every rank), ``boids``
    (pallas and mxu SyncTests through ``make_sharded_schedule``),
    ``boids_grid`` (the mxu grid mode's, each rank on its slice of the
    cells), ``boids_extra`` (xla, dense and grid), ``xla`` (one
    xla frame of ``cfg["big"]`` boids), ``rollout`` (the box_game rollout
    split over every rank's branch block), ``checkpoint``
    (:func:`shard_checkpoint` on the entity mesh), ``projectiles`` (its SyncTest
    through the gather rule), ``p2p`` (a speculating pair on a 2 x k
    mesh; its unmeshed twin on global rank 0 only)."""
    from bevy_ggrs_tpu_torch.parallel.sharding import branch_mesh

    entity = branch_mesh(entity_shards=world, device_type=device)
    branch = branch_mesh(entity_shards=1, device_type=device)
    out = {}
    if "box" in runs:
        sharded = shard_synctest(device, cfg["sync_frames"], entity)
        plain = shard_synctest(device, cfg["sync_frames"])
        out["box_synctest"] = {"equal": sharded["stream"] == plain["stream"]
                               and shard_worlds_equal(sharded["world"], plain["world"]),
                               "stream": sharded["stream"], "launches": sharded["launches"],
                               "collectives": sharded["collectives"]}
    boids_runs = [("pallas", None), ("mxu", None)] if "boids" in runs else []
    if "boids_grid" in runs:
        boids_runs.append(("mxu", "grid"))
    if "boids_extra" in runs:
        boids_runs += [("xla", None), ("xla", "grid")]
    for kernel, mode in boids_runs:
        s = shard_boids_sync(device, cfg["boids"], kernel, cfg["boids_frames"], entity, mode)
        p = shard_boids_sync(device, cfg["boids"], kernel, cfg["boids_frames"], None, mode)
        out[f"boids_{kernel}_{mode or 'dense'}"] = {
            "equal": s["stream"] == p["stream"] and shard_worlds_equal(s["world"], p["world"]),
            "launches": s["launches"], "collectives": s["collectives"],
            "world": {k: s["world"]["components"][k].tolist() for k in ("position", "velocity")}}
    if "xla" in runs:
        out["xla_frame"] = shard_xla_frame(device, cfg["big"], entity)
    if "rollout" in runs:
        out["rollout"] = shard_rollout(device, *cfg["rollout"], branch)
    if "checkpoint" in runs:
        out["checkpoint"] = shard_checkpoint(device, cfg["sync_frames"] // 2, entity)
    if "p2p" in runs:
        mesh = branch_mesh(entity_shards=world // 2, device_type=device)
        out["p2p_2x2"] = shard_p2p(device, cfg["p2p_iters"], cfg["p2p_branches"], mesh)
        if mesh.get_rank() == 0:  # the unmeshed twin issues no collective
            out["p2p_plain"] = shard_p2p(device, cfg["p2p_iters"], cfg["p2p_branches"])
    if "projectiles" in runs:
        from bevy_ggrs_tpu_torch.models import projectiles

        def proj():
            return projectiles.make_world(2, capacity=32, device=device).commit()

        keys = lambda h, f: np.uint8((f * 3 + h * 5) % 32)  # noqa: E731
        frames = cfg.get("proj_frames", cfg["sync_frames"])
        s = shard_synctest(device, frames, entity, projectiles.make_schedule(),
                           proj(), keys=keys, input_spec=projectiles.INPUT_SPEC)
        p = shard_synctest(device, frames, None, projectiles.make_schedule(),
                           proj(), keys=keys, input_spec=projectiles.INPUT_SPEC)
        out["projectiles"] = {"equal": s["stream"] == p["stream"]
                              and shard_worlds_equal(s["world"], p["world"]),
                              "stream": s["stream"], "collectives": s["collectives"]}
    return out


def shard_rank(rank: int, world: int, rdv: str, device: str, cfg: dict, out_dir: str,
               runs=SHARD_RUNS) -> None:
    """One rank of phase 19 (b): joins a gloo group through the
    ``file://`` rendezvous ``rdv``, runs :func:`shard_rank_runs` and writes
    ``rank<k>.json`` into ``out_dir``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    # A rank that dies leaves the other waiting in a collective: fail in
    # minutes, not gloo's default half hour.
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        t0 = time.perf_counter()
        out = shard_rank_runs(device, cfg, world, runs)
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def shard_spawn(world: int, device: str, cfg: dict, out_dir: str,
                runs=SHARD_RUNS) -> list:
    """Phase 19 (b)'s ranks as processes (``torch.multiprocessing``),
    ``PYTHONHASHSEED`` pinned so every rank's sessions time alike; their
    results in rank order."""
    import torch.multiprocessing as mp

    old = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        mp.spawn(shard_rank, args=(world, os.path.join(out_dir, "rdv"), device, cfg,
                                   out_dir, runs), nprocs=world, join=True)
    finally:
        if old is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = old
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def shard_group_one(device: str):
    """Phase 19 (a)'s world-size-1 group in this process (NCCL on
    ``cuda``, gloo on ``cpu``), or None when one is already up."""
    import torch.distributed as dist

    from bevy_ggrs_tpu_torch.parallel import sharding

    if dist.is_initialized():
        return None
    sharding.ensure_process_group(device)
    return dist.get_backend()


def shard_branch_grid(tpw, tcg, device: str = "cuda", B: int = 70000, n: int = 32) -> dict:
    """The four force kernels at ``B`` branches of ``n`` boids (past
    gridDim.y's 65,535: folded into gridDim.z): branches 0, 65,534, 65,535,
    65,536 and the last bitwise equal to their unbatched launches and
    within tolerance of the plain version."""
    from bevy_ggrs_tpu_torch.models import boids

    params = boids._kernel_params()
    g = torch.Generator().manual_seed(5)
    pos = (torch.rand((B, n, 2), generator=g) * 6 - 3).to(device)
    vel = (torch.rand((B, n, 2), generator=g) * 0.06 - 0.03).to(device)
    act = (torch.rand((B, n), generator=g) > 0.1).float().to(device)
    picks = [0, 65534, 65535, 65536, B - 1]
    out = {}
    for name, fn, plain in (
            ("pairwise_force_rows", lambda p, v, a: tpw.pairwise_force_rows(p, v, p, v, a, a, **params),
             lambda p, v, a: tpw.pairwise_force_rows_plain(p, v, p, v, a, a, **params)),
            ("pairwise_force_rows_mxu2",
             lambda p, v, a: tpw.pairwise_force_rows_mxu2(p, v, p, v, a, a, **params),
             lambda p, v, a: tpw.pairwise_force_rows_mxu2_plain(p, v, p, v, a, a, **params)),
            ("pairwise_force_square_mxu_tri",
             lambda p, v, a: tpw.pairwise_force_square_mxu_tri(p, v, a, **params),
             lambda p, v, a: tpw.pairwise_force_square_mxu_tri_plain(p, v, a, **params))):
        batched = fn(pos, vel, act)
        err, bitwise = 0.0, True
        for b in picks:
            one = fn(pos[b].contiguous(), vel[b].contiguous(), act[b].contiguous())
            bitwise &= torch.equal(one, batched[b])
            ref = plain(pos[b].cpu(), vel[b].cpu(), act[b].cpu())
            err = max(err, float((batched[b].cpu() - ref).abs().max()))
        scale = MXU_RANDOM_RTOL * float(batched.abs().max()) if "mxu" in name else FORCE_ATOL
        check(bitwise and err <= max(scale, FORCE_ATOL),
              f"branch grid: {name} at B={B}: bitwise {bitwise}, err {err:.3g}")
        out[name] = {"bitwise": bitwise, "max_abs_err": err}
    # The cell kernel on random tables: B branches of 2 cells x 4 slots x
    # 16 candidates.
    kern = boids.FLOCK_PAIR_KERNEL
    rows = {k: (torch.rand((B, 2, 4), generator=g) * (2 if k in ("px", "py") else 0.06))
            .to(device) for k in kern.row_names}
    rows["active"] = (rows["active"] > 0.01).float()
    cols = {k: (torch.rand((B, 2, 16), generator=g) * (2 if k in ("px", "py") else 0.06))
            .to(device) for k in kern.col_names}
    cols["active"] = (cols["active"] > 0.01).float()
    batched = torch.stack(tcg.cell_slot_forces(kern, rows, cols), dim=-1)
    err, bitwise = 0.0, True
    for b in picks:
        one = torch.stack(tcg.cell_slot_forces(
            kern, {k: v[b].contiguous() for k, v in rows.items()},
            {k: v[b].contiguous() for k, v in cols.items()}), dim=-1)
        bitwise &= torch.equal(one, batched[b])
        ref = torch.stack(tcg.cell_slot_forces_plain(
            kern, {k: v[b].cpu() for k, v in rows.items()},
            {k: v[b].cpu() for k, v in cols.items()}), dim=-1)
        err = max(err, float((batched[b].cpu() - ref).abs().max()))
    check(bitwise and err <= CELL_ATOL,
          f"branch grid: cell_slot_forces at B={B}: bitwise {bitwise}, err {err:.3g}")
    out["cell_slot_forces"] = {"bitwise": bitwise, "max_abs_err": err}
    return out


def sharding_phase(device: str = "cuda", cfg=None, out_dir=None, runs=SHARD_RUNS) -> dict:
    """Phase 19: (a) a world-size-1 group in this process (NCCL on the
    card): an entity-meshed box_game SyncTest and a speculating P2P pair
    on a 1 x 1 mesh, each bitwise its unmeshed twin; (b) two ranks over
    gloo (:func:`shard_spawn`); (c) ``GGRS_SESSION_AXIS`` runs bitwise the
    singleton. Prints the ``sharding`` line; returns its fields (the
    launches of the sharded runs by kernel among them) and, under
    ``ranks``, the results of (b)'s ranks (``runs`` picks them:
    :func:`shard_rank_runs`)."""
    import tempfile

    import torch.distributed as dist

    from bevy_ggrs_tpu_torch.parallel.sharding import branch_mesh

    cfg = cfg or SHARD
    t0 = time.perf_counter()
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + int(v)

    # (a) world size 1 in this process.
    made = shard_group_one(device)
    try:
        backend_a = dist.get_backend()
        mesh = branch_mesh(entity_shards=1, device_type=device)
        s = shard_synctest(device, cfg["sync_frames"], mesh)
        p = shard_synctest(device, cfg["sync_frames"])
        a_sync = s["stream"] == p["stream"] and shard_worlds_equal(s["world"], p["world"])
        check(a_sync, "phase 19 (a): the meshed SyncTest is not bitwise the unmeshed one")
        add(s["launches"])
        sp = shard_p2p(device, cfg["p2p_iters"], cfg["p2p_branches"], mesh)
        pp = shard_p2p(device, cfg["p2p_iters"], cfg["p2p_branches"])
        a_p2p = sp["settled"] == pp["settled"] and len(sp["settled"]) > 0
        check(a_p2p and sp["desyncs"] == 0 and all(sp["attested"]),
              f"phase 19 (a): the meshed P2P pair: equal {a_p2p}, desyncs {sp['desyncs']}, "
              f"attested {sp['attested']}")
        add(sp["launches"])
    finally:
        if made is not None:
            dist.destroy_process_group()
    # (b) two ranks over gloo.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ranks = shard_spawn(2, device, cfg, tmp, runs)
    b_equal = {}
    for name in ranks[0]:
        if isinstance(ranks[0][name], dict) and "equal" in ranks[0][name]:
            b_equal[name] = all(r[name]["equal"] for r in ranks)
    b_equal["rollout"] = all(r["rollout"]["lanes_equal"]
                             and all(r["rollout"]["commits_equal"].values()) for r in ranks)
    check(all(b_equal.values()), f"phase 19 (b): not bitwise: {b_equal}")
    check(ranks[0]["box_synctest"]["stream"] == ranks[1]["box_synctest"]["stream"],
          "phase 19 (b): the ranks' SyncTest streams differ")
    for r in ranks:
        for name in ("box_synctest", "boids_pallas_dense", "boids_mxu_dense",
                     "boids_mxu_grid", "rollout"):
            add(r[name]["launches"])
    check(device != "cuda" or (
        all(r["boids_mxu_dense"]["launches"]["pairwise_force_rows_mxu2"] > 0 for r in ranks)
        and all(r["boids_pallas_dense"]["launches"]["pairwise_force_rows"] > 0 for r in ranks)
        and all(r["boids_mxu_grid"]["launches"]["cell_slot_forces"] > 0 for r in ranks)
        and all(r["box_synctest"]["launches"]["world_checksum"] > 0 for r in ranks)),
        "phase 19 (b): a sharded run launched none of its kernels")
    # (c) the session-axis conformance mode.
    single = shard_spec_synctest(device, cfg["axis_frames"], cfg["axis_branches"])
    pair = shard_p2p(device, cfg["axis_iters"], cfg["axis_branches"])
    with session_axis(cfg["axis"]):
        axed = shard_spec_synctest(device, cfg["axis_frames"], cfg["axis_branches"])
        axed_pair = shard_p2p(device, cfg["axis_iters"], cfg["axis_branches"])
    c_sync = (axed["stream"], axed["ring"], axed["hits"]) == (
        single["stream"], single["ring"], single["hits"])
    c_p2p = axed_pair["settled"] == pair["settled"] and axed_pair["hits"] == pair["hits"]
    check(c_sync and c_p2p, f"phase 19 (c): GGRS_SESSION_AXIS={cfg['axis']} is not "
                            f"bitwise the singleton: synctest {c_sync}, p2p {c_p2p}")
    add(axed["launches"])
    add(axed_pair["launches"])
    line = {
        "backends": {"a": backend_a, "b": "gloo (CUDA tensors staged through host buffers)"
                     if device == "cuda" else "gloo"},
        "world_sizes": {"a": 1, "b": 2},
        "a": {"synctest_bitwise": a_sync, "p2p_bitwise": a_p2p,
              "p2p_hits": sp["hits"], "settled_compared": len(sp["settled"]),
              "collectives": {"synctest": s["collectives"], "p2p": sp["collectives"]}},
        "b": {"bitwise": b_equal,
              "collectives": {k: v["collectives"] for k, v in ranks[0].items()
                              if isinstance(v, dict) and "collectives" in v},
              "rank_seconds": [round(r["seconds"], 2) for r in ranks]},
        "c": {"session_axis": cfg["axis"], "synctest_bitwise": c_sync, "p2p_bitwise": c_p2p},
        "launches": launches,
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    print("sharding " + json.dumps(line), flush=True)
    return dict(line, ranks=ranks)


def main() -> int:
    if sys.argv[1:2] == ["--config5"]:
        return config5_child(sys.argv[2:])
    if sys.argv[1:2] == ["--model-twins"]:
        return model_twins_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "bevy_ggrs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from bevy_ggrs_tpu_torch import integrity, ops
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
    kernels = ops.wrappers()
    force_kernels = kernels[1:]
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

    # Phase 13's cpu twins start now, beside the card's runs of phases 2-13.
    twins = ModelTwins(model_twin_jobs())
    atexit.register(twins.close, False)

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
    box_world, _ = check_box_step(ts, box_game)
    check_checksum_hook(ts, tck, integrity, [
        ("box_game after 500 frames", box_world),
        ("boids-1024", boids.make_world(1024, 2, device="cuda").commit())])

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
    spec_graph = check_spec_graph(ts, boids, box_game)
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
    print("spec " + json.dumps({"attestation": attestation, "graph": spec_graph,
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

    phase("12 BASELINE config 5 on the native data plane")
    config5 = config5_phase(kernels, ts, tck)
    ck["launches"] += sum(p["launches"].get("world_checksum", 0)
                          for leg in config5["legs"] for p in leg["peers"])
    ck["batched_save"][f"B{CONFIG5_BRANCHES}"] = config5["batched_save"]
    peer0 = config5["legs"][0]["peers"][0]
    ck["batched_save"][f"B{CONFIG5_BRANCHES}"]["launches_per_rollout"] = (
        peer0["launches"].get("world_checksum", 0) - peer0["counts"]["saves_total"]
        - peer0["counts"]["restore_guards_total"]) / peer0["counts"]["spec_rollouts_total"]

    phase("13 projectiles and neural_bots on cuda")
    models = models_phase(kernels, ts, tck, integrity, twins=twins)
    ck["launches"] += sum(v["launches"]["world_checksum"] for v in models["sync"].values())
    for key in ("projectiles_p2p", "neural_bots_p2p"):
        ck["launches"] += sum(l.get("world_checksum", 0) for run in ("on", "off")
                              for l in models[key][run]["launches"])
    for label, m in models["batched_save"].items():
        ck["batched_save"][f"{label} B{m['branches']}"] = m
    print("models " + json.dumps({k: models[k] for k in ("exact", "sync")}))

    phase("14 the learned input predictor on cuda")
    pred = predictor_phase(kernels, ts, tck, config5["legs"])
    ck["launches"] += sum(p["launches"].get("world_checksum", 0) for p in pred["leg"]["peers"])

    phase("15 supervised sessions and checkpoints on cuda")
    ck["launches"] += supervisor_phase(kernels, ts, tck, integrity)["launches"]

    phase("16 serving on cuda")
    serve = serve_phase(kernels, ts, tck, integrity, tpw)
    ck["slot_save"] = serve["slot_save"]
    ck["rollout_slot_save"] = serve["rollout_save"]
    ck["launches"] += (serve["core"]["launches"]["world_checksum"]
                       + serve["boids"]["launches"]["world_checksum"]
                       + serve["server"]["launches"]["world_checksum"])
    forces[1024]["launches"] += serve["boids"]["launches"]["pairwise_force_rows"]
    forces[1024]["max_abs_err"] = max(force_err, serve["boids"]["force_err"])

    phase("17 entry points on cuda")
    entry = entry_points_phase(kernels, ts)
    ck["launches"] += entry["launches"]["world_checksum"]
    mxu2["launches"] += entry["launches"]["pairwise_force_rows_mxu2"]

    phase("18 fleet and relay on cuda")
    ck["launches"] += fleet_relay_phase(kernels, ts, tck)["launches"]

    phase("19 sharding on cuda")
    shard = sharding_phase("cuda")
    ck["launches"] += shard["launches"]["world_checksum"]
    forces[1024]["launches"] += shard["launches"]["pairwise_force_rows"]
    mxu2["launches"] += shard["launches"]["pairwise_force_rows_mxu2"]
    tri["launches"] += shard["launches"]["pairwise_force_square_mxu_tri"]
    cell["launches"] += shard["launches"]["cell_slot_forces"]
    print("branch grid " + json.dumps(shard_branch_grid(tpw, tcg)), flush=True)
    phase(None)
    walls = _PHASE["walls"]
    print(f"phase walls (s) {json.dumps(walls)}, sum {sum(walls.values()):.1f}; {smi()}")
    print(json.dumps({"kernels": [ck, forces[1024], mxu2, tri, cell]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
