"""The speculative-rollout window: ``SpeculativeExecutor.run`` back to back.

Set-up makes the configuration's flock from the seed, steps it the mix's
``anchor_frames`` frames through the boids schedule with seeded inputs
(the anchor), draws a pool of ``tree_pool`` branch trees
(``enumerate_branches`` with ``bitmask_sampler``; branch 0 repeats the
last input) and runs a few rollouts. The window then issues
``SpeculativeExecutor(schedule, B, F).run(anchor, frame, tree)`` over
the pool in turn, with no synchronize between rollouts, so the host
dispatches ahead of the card; one synchronize closes it. A traced run
then times ``PROBES`` more rollouts, each issued after a synchronize, for
the host's own cost of ``run`` (``rollout_enqueue_ms``).

End-to-end: ``branch_frames_per_s`` (B x F x rollouts over the window)
and ``setup_s``. The comparison takes a sample of the window's rollouts
and of their branches, drawn from the seed (branch 0 and the last rollout
always among them), and for each: the first saved row bit for bit the
anchor, the frame labels, the stored lanes (in the rings and in the
rollout's stream) against the reference hash, and one reference step from
each saved frame to the next and from the last to the branch's final
world. The anchor's own frames are followed the same way from the world
the benchmark made.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness
from benchmark.reference import compare

KEPT_ROLLOUTS = 3  # rollouts of the window kept for the comparison, besides the last
KEPT_FROM = 200  # drawn from the first this many rollouts of the window
KEPT_BRANCHES = 16  # branches of each kept rollout compared, besides branch 0
PROBES = 16  # rollouts after a traced window, each after a synchronize


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> harness.Outcome:
    import torch

    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.parallel.speculate import (
        SpeculativeExecutor,
        bitmask_sampler,
        enumerate_branches,
    )
    from bevy_ggrs_tpu_torch.schedule import make_inputs

    phases = dict(harness.EARLY_PHASES, imported=time.perf_counter() - t_start)
    cfg, mix = cell.config, cell.traffic
    players = int(cfg["players"])
    B, F = int(mix["branches"]), int(mix["frames"])
    schedule = boids.make_schedule(kernel=cfg["kernel"], mode=cfg["mode"])
    bits = harness.uniform_bitmask(seed, int(mix["anchor_frames"]), players,
                                   int(mix["inputs"]["bits"]))
    world = harness.make_flock(cfg, seed, device)
    chain = [harness.world_to_host(world)]
    for f in range(len(bits)):
        world = schedule(world, make_inputs(torch.as_tensor(bits[f], device=device)))
        chain.append(harness.world_to_host(world))
    anchor, frame0 = world, len(bits)
    phases["anchor"] = time.perf_counter() - t_start

    gen = torch.Generator().manual_seed(harness.torch_seed(seed, 3))
    sampler = bitmask_sampler(int(mix["inputs"]["bits"]), float(mix["keep_prob"]))
    pool = [enumerate_branches(gen, bits[-1], B, F, sampler=sampler).numpy()
            for _ in range(int(mix["tree_pool"]))]
    ex = SpeculativeExecutor(schedule, B, F)
    phases["trees"] = time.perf_counter() - t_start
    for i in range(int(mix["warmup_rollouts"])):
        ex.run(anchor, frame0, pool[i % len(pool)])
    harness.sync(device)

    pick = harness.rng(seed, 4)
    keep_at = set(int(k) for k in pick.choice(KEPT_FROM, KEPT_ROLLOUTS, replace=False))
    kept = {}
    spans = harness.Spans()
    run_once = ex.run
    if trace:
        spans.wrap(ex, "run", "layer.speculate.run")
    before = harness.launch_counts()
    window = {"n": 0}

    def loop():
        n = 0
        t0 = time.perf_counter()
        res = None
        while time.perf_counter() - t0 < seconds:
            res = ex.run(anchor, frame0, pool[n % len(pool)])
            if n in keep_at:
                kept[n] = res
            n += 1
        harness.sync(device)
        window.update(n=n, t0=t0, end=time.perf_counter(), last=res)

    setup_s = time.perf_counter() - t_start
    prof = harness.traced(loop) if trace else loop()
    n, elapsed = window["n"], window["end"] - window["t0"]
    dev = harness.device_info(device)
    counters = dict(harness.delta(harness.launch_counts(), before), rollouts=n,
                    branches=B, frames=F)
    kept[n - 1] = window.pop("last")
    if trace:  # the host's own cost of a rollout, with the card's queue empty
        for i in range(PROBES):
            harness.sync(device)
            spans.call("probe.speculate.run", run_once, anchor, frame0, pool[i % len(pool)])
        harness.sync(device)

    # What the comparison reads, then the program's state is freed.
    branches = [0] + [int(b) for b in pick.choice(range(1, B), min(KEPT_BRANCHES, B - 1),
                                                  replace=False)]
    samples = []
    for i in sorted(kept):
        res = kept[i]
        ring_lanes = res.rings.checksums.cpu().numpy().copy()
        stream = res.checksums.cpu().numpy().copy()
        labels = res.rings.frames.cpu().numpy().copy()
        depth = labels.shape[1]  # frame f lies in ring row f % depth
        for b in branches:
            at = [(res.start_frame + t) % depth for t in range(F)]
            rows = {res.start_frame + t: harness.world_to_host(res.rings.states, (b, r))
                    for t, r in enumerate(at)}
            samples.append(dict(rows=rows, lanes=ring_lanes[b, at], stream=stream[b],
                                labels=labels[b, at], bits=res.branch_bits[b],
                                last=(res.start_frame + F,
                                      harness.world_to_host(res.states, (b,)))))
    anchor_host = harness.world_to_host(anchor)
    window_obj = None
    if trace:
        window_obj = harness.Window(cell, elapsed, n, spans, counters,
                                    harness.DeviceTrace.of(prof, spans))
    del kept, res, anchor, world, ex, run_once, prof
    harness.free(device)

    tally = check(chain, bits, anchor_host, frame0, samples, device, control)
    notes = {"rollouts": n, "window_s": elapsed, "setup_phases_s": phases,
             "steps_compared": tally.steps,
             "rows_hashed": tally.rows_hashed, "branches_compared": len(samples),
             "card": harness.card_state()}
    notes["widest"] = tally.widest
    if tally.control is not None:
        notes["control"] = tally.control.values
        notes["control_widest"] = tally.control.widest
    return harness.Outcome(
        attempted=n, failed=0,
        end_to_end={"setup_s": setup_s, "branch_frames_per_s": B * F * n / elapsed},
        window=window_obj, checks=tally.checks(cell.limits), device=dev, notes=notes)


def check(chain, bits, anchor, frame0, samples, device, control=False) -> compare.Tally:
    """Hold the run to the reference: the anchor's frames from the world
    the benchmark made, and each sampled branch from the anchor."""
    tally = compare.Tally(control)
    compare.follow(tally, dict(enumerate(chain)), lambda f: bits[f], device)
    for s in samples:
        rows = s["rows"]
        tally.exact(compare.count_unequal(rows[frame0], anchor))
        want = np.arange(frame0, frame0 + len(rows))
        tally.exact(int((np.asarray(s["labels"]) != want).sum()))
        for t, f in enumerate(sorted(rows)):
            tally.hashed(rows[f], [s["lanes"][t], s["stream"][t]])
        compare.follow(tally, rows, lambda f, s=s: s["bits"][f - frame0], device,
                       last=s["last"])
    return tally
