"""The SyncTest window: ``RollbackApp.update`` ticks back to back.

The app is built by ``GGRSPlugin`` as ``examples_torch/box_game_synctest.py``
builds it, for the configuration's world (its components registered for
rollback, its schedule, ``max_prediction``, 60 Hz); the world the
benchmark made from the seed is adopted as frame 0
(``RollbackRunner.restore_state``). Each call of ``update`` gets a ``now``
one frame period on, so it runs exactly one ``GGRSStage._step_synctest``:
``SyncTestSession.advance_frame`` (the new frame, then from frame
``check_distance`` on a rollback that deep) and
``RollbackRunner.handle_requests`` (load, resimulate, the new frame, a
save each, a restore guard, the checksums read back and compared). The
loop is closed and never sleeps; the window's last tick ends in a
synchronize.

End-to-end: ``ticks_per_s`` (ticks over the window), ``tick_p95_ms`` (95th
percentile of every tick's wall time) and ``setup_s``. A traced run also
gives the runner a ``SpanTracer``, whose spans (``handle_requests``,
``checksum_sync``) ``runner_host_ms`` reads. The comparison
then follows the program through the 13 saved rows and the live state,
and checks the start (frame 0 saved bit for bit as made; frame 1 one
reference step from it).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness
from benchmark.reference import compare


class _Clock:
    """``now`` for ``update``: a frame period and a hair more a call, so
    the stage's accumulator yields one step every call."""

    def __init__(self, fps: int):
        self.dt = (1.0 / fps) * (1.0 + 1e-6)
        self.now = 0.0

    def tick(self) -> float:
        self.now += self.dt
        return self.now


def build(cell: harness.Cell, seed: int, device):
    import torch

    from bevy_ggrs_tpu_torch.app import GGRSPlugin, SessionType
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.session import SessionBuilder

    cfg, mix = cell.config, cell.traffic
    players = int(cfg["players"])
    inputs = mix["inputs"]
    bits = harness.uniform_bitmask(seed, int(inputs["frames"]), players, int(inputs["bits"]))

    def input_system(handle, app):
        return bits[app.session.current_frame % len(bits), handle]

    reg = boids.make_registry()
    plugin = (GGRSPlugin(boids.INPUT_SPEC)
              .with_update_frequency(int(cfg["update_frequency"]))
              .with_input_system(input_system))
    for name, d in reg.components.items():
        plugin.register_rollback_component(name, d.shape, d.dtype, d.default)
    for name, d in reg.resources.items():
        plugin.register_rollback_resource(name, d.initial)
    plugin = (plugin.with_rollback_schedule(boids.make_schedule(kernel=cfg["kernel"],
                                                                mode=cfg["mode"]))
              .with_num_players(players)
              .with_max_prediction_window(int(cfg["max_prediction"]))
              .with_world_capacity(int(cfg["num_boids"]))
              .with_device(device))
    app = plugin.build()
    world = harness.make_flock(cfg, seed, device)
    start = harness.world_to_host(world)
    app.stage.runner.restore_state(0, world)
    session = (SessionBuilder(boids.INPUT_SPEC)
               .with_num_players(players)
               .with_check_distance(int(mix["check_distance"]))
               .with_max_prediction_window(int(cfg["max_prediction"]))
               .start_synctest_session())
    app.insert_session(session, SessionType.SYNC_TEST)
    del world
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return app, bits, start


def _one(app, clock) -> None:
    steps = app.update(clock.tick())
    if steps != 1:
        raise RuntimeError(f"update ran {steps} steps, not one")


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> harness.Outcome:
    from bevy_ggrs_tpu_torch.integrity import StateFault
    from bevy_ggrs_tpu_torch.session import MismatchedChecksum

    phases = dict(harness.EARLY_PHASES, imported=time.perf_counter() - t_start)
    app, bits, start = build(cell, seed, device)
    phases["built"] = time.perf_counter() - t_start
    clock = _Clock(int(cell.config["update_frequency"]))
    app.update(clock.now)  # the stage's first call only starts its clock
    runner = app.stage.runner
    _one(app, clock)  # frame 0: saved, then advanced to frame 1
    first = (harness.world_to_host(runner.ring.states, (0,)),
             runner.ring.checksums[0].cpu().numpy().copy(), harness.world_to_host(runner.state))
    phases["first_tick"] = time.perf_counter() - t_start
    failed = 0
    try:
        for _ in range(int(cell.traffic["warmup_ticks"]) - 1):
            _one(app, clock)
    except (MismatchedChecksum, StateFault):  # the session's or the guard's verdict
        failed, seconds = 1, 0.0
    harness.sync(device)

    spans = harness.Spans()
    if trace:
        from bevy_ggrs_tpu_torch.obs.trace import SpanTracer

        spans.wrap(app.session, "advance_frame", "layer.session.advance_frame")
        spans.wrap(runner, "handle_requests", "layer.runner.handle_requests")
        runner.tracer = SpanTracer()  # the runner's own spans, read by runner_host_ms
    ticks: list = []
    before = dict(harness.launch_counts(), saves=runner.saves_total,
                  guards=runner.restore_guards_total)
    window = {}

    def loop():
        nonlocal failed
        t0 = last = time.perf_counter()
        window["t0"] = t0
        try:
            while last - t0 < seconds:
                _one(app, clock)
                now = time.perf_counter()
                ticks.append(now - last)
                last = now
        except (MismatchedChecksum, StateFault):
            failed += 1
        harness.sync(device)
        end = time.perf_counter()
        if ticks:
            ticks[-1] += end - last
        window["end"] = end

    setup_s = time.perf_counter() - t_start
    prof = harness.traced(loop) if trace else loop()
    elapsed = window["end"] - window["t0"]
    dev = harness.device_info(device)
    counters = harness.delta(dict(harness.launch_counts(), saves=runner.saves_total,
                                  guards=runner.restore_guards_total), before)

    # What the comparison reads, then the program's state is freed.
    ring = runner.ring
    frames = ring.frames.cpu().numpy().copy()
    lanes = ring.checksums.cpu().numpy().copy()
    rows = {int(f): (harness.world_to_host(ring.states, (r,)), lanes[r])
            for r, f in enumerate(frames) if f >= 0}
    live = (int(runner.frame), harness.world_to_host(runner.state))
    window_obj = None
    if trace:
        window_obj = harness.Window(cell, elapsed, len(ticks), spans, counters,
                                    harness.DeviceTrace.of(prof, spans),
                                    program_spans=runner.tracer.summary())
    del app, runner, ring, prof
    harness.free(device)

    tally = check(start, first, rows, live, bits, device, control)
    e2e = {"setup_s": setup_s}
    if ticks:
        e2e["ticks_per_s"] = len(ticks) / elapsed
        e2e["tick_p95_ms"] = 1000.0 * float(np.percentile(ticks, 95))
    notes = {"ticks": len(ticks), "window_s": elapsed, "setup_phases_s": phases,
             "steps_compared": tally.steps,
             "rows_hashed": tally.rows_hashed, "card": harness.card_state()}
    notes["widest"] = tally.widest
    if tally.control is not None:
        notes["control"] = tally.control.values
        notes["control_widest"] = tally.control.widest
    return harness.Outcome(attempted=len(ticks) + failed, failed=failed, end_to_end=e2e,
                           window=window_obj, checks=tally.checks(cell.limits),
                           device=dev, notes=notes)


def check(start, first, rows, live, bits, device, control=False) -> compare.Tally:
    """Hold the run to the reference: the start, every saved row's lanes,
    and one reference step from each saved frame to the next saved frame
    or the live state."""
    tally = compare.Tally(control)
    row0, lanes0, frame1 = first
    tally.exact(compare.count_unequal(row0, start))
    tally.hashed(row0, [lanes0])
    compare.follow(tally, {0: start}, lambda f: bits[f % len(bits)], device,
                   last=(1, frame1))
    frames = sorted(rows)
    if frames != list(range(frames[0], frames[0] + len(frames))) or frames[-1] + 1 != live[0]:
        tally.exact(len(frames))  # the ring does not hold the frames it should
    for f in frames:
        world, stored = rows[f]
        if int(world["resources"]["frame_count"]) != f:
            tally.exact(1)
        tally.hashed(world, [stored])
    compare.follow(tally, {f: rows[f][0] for f in frames}, lambda f: bits[f % len(bits)],
                   device, last=live)
    return tally
