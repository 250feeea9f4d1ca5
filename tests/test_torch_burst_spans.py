"""PyTorch port, the runner's and the burst's host spans on the CPU.

A boids SyncTest at check distance 7 through ``GGRSPlugin`` with a
``SpanTracer`` on its runner records one ``handle_requests`` a tick. Past
the check distance it holds the new frame's segment (a ``dispatch`` of
one ``burst_setup``, ``burst_save`` and ``burst_step``, and its
``checksum_sync``), then the rollback's: one ``restore_guard``, one
``dispatch`` (one ``burst_setup``, then a ``burst_save`` and a
``burst_step`` for each of the 8 frames resimulated) and one
``checksum_sync``, nested so in the Perfetto export.
``SpeculativeExecutor`` records the same burst spans under its
``spec_branch_dispatch``. A span's stamp plus ``wall_t0`` lies on
``torch.profiler``'s clock, alone and through ``obs/merge.py --align
wall``; the null tracer records nothing.
"""

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from bevy_ggrs_tpu_torch.app import GGRSPlugin, SessionType
from bevy_ggrs_tpu_torch.models import boids
from bevy_ggrs_tpu_torch.obs import merge
from bevy_ggrs_tpu_torch.obs.trace import SpanTracer, null_tracer
from bevy_ggrs_tpu_torch.parallel.speculate import SpeculativeExecutor
from bevy_ggrs_tpu_torch.session import SyncTestSession

PLAYERS = 2
CHECK_DISTANCE = 7
DT = 1.01 / 60.0  # one simulation step an update


def steer(handle, app):
    return np.uint8((app.session.current_frame * 3 + handle) % 16)


def synctest_app(n=256):
    app = (
        GGRSPlugin(boids.INPUT_SPEC)
        .with_input_system(steer)
        .register_rollback_component("position", shape=(2,))
        .register_rollback_component("velocity", shape=(2,))
        .register_rollback_component("leader_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(boids.make_schedule(kernel="mxu", mode="dense"))
        .with_num_players(PLAYERS)
        .with_max_prediction_window(12)
        .with_world_capacity(n)
        .with_setup_system(lambda world, app: boids.spawn_flock(world, n, PLAYERS))
        .with_device("cpu")
        .build()
    )
    app.insert_session(
        SyncTestSession(PLAYERS, boids.INPUT_SPEC, check_distance=CHECK_DISTANCE),
        SessionType.SYNC_TEST)
    return app


def span_trees(trace):
    """The Perfetto export's spans as trees: ``(name, args, children)``,
    the roots in order, nested by the B/E events of each track."""
    roots, stacks = [], {}
    for ev in trace["traceEvents"]:
        if ev["ph"] not in "BE":
            continue
        stack = stacks.setdefault((ev["pid"], ev["tid"]), [])
        if ev["ph"] == "B":
            node = (ev["name"], ev.get("args"), [])
            (stack[-1][2] if stack else roots).append(node)
            stack.append(node)
        else:
            assert stack and stack[-1][0] == ev["name"]
            stack.pop()
    assert not any(stacks.values())
    return roots


def shape(node):
    return (node[0], [shape(c) for c in node[2]])


def burst(frames, head):
    steps = [s for _ in range(frames) for s in (("burst_save", []), ("burst_step", []))]
    return (head, [("burst_setup", [])] + steps)


def test_a_synctest_tick_records_its_spans():
    app = synctest_app()
    runner = app.stage.runner
    runner.tracer = SpanTracer()  # set after construction, as a benchmark does
    ticks = 14
    app.run_for(ticks + 1, dt=DT)  # the first update only arms the clock
    assert app.frame == ticks

    roots = span_trees(runner.tracer.export_perfetto())
    assert [r[0] for r in roots] == ["handle_requests"] * ticks
    assert [r[1] for r in roots] == [{"frame": f} for f in range(ticks)]
    new_frame = [burst(1, "dispatch"), ("checksum_sync", [])]
    for tick, root in enumerate(roots):
        want = list(new_frame)
        if tick >= CHECK_DISTANCE:  # a load, then 8 frames saved and stepped again
            want += [("restore_guard", []), burst(CHECK_DISTANCE + 1, "dispatch"),
                     ("checksum_sync", [])]
        assert shape(root) == ("handle_requests", want), tick

    summary = runner.tracer.summary()
    rolled = ticks - CHECK_DISTANCE
    assert summary["restore_guard"]["count"] == rolled == runner.restore_guards_total
    assert summary["burst_setup"]["count"] == summary["dispatch"]["count"] == ticks + rolled
    assert summary["checksum_sync"]["count"] == ticks + rolled
    assert summary["burst_save"]["count"] == runner.saves_total
    assert summary["burst_step"]["count"] == ticks + rolled * (CHECK_DISTANCE + 1)
    inner = sum(summary[k]["total_ms"] for k in
                ("restore_guard", "dispatch", "checksum_sync"))
    assert inner <= summary["handle_requests"]["total_ms"]


def test_a_null_tracer_records_nothing():
    app = synctest_app(n=64)
    runner = app.stage.runner
    assert runner.tracer is null_tracer
    app.run_for(CHECK_DISTANCE + 3, dt=DT)
    assert runner.restore_guards_total == 2
    assert null_tracer.summary() == {}
    assert null_tracer.export_perfetto()["traceEvents"] == []
    assert null_tracer.span("burst_step") is null_tracer.span("restore_guard")


def test_a_speculative_rollout_records_the_burst_spans():
    B, F = 3, 4
    world = boids.make_world(64, PLAYERS, device="cpu").commit()
    tracer = SpanTracer()
    ex = SpeculativeExecutor(boids.make_schedule(kernel="mxu", mode="dense"), B, F,
                             tracer=tracer)
    bits = np.random.RandomState(5).randint(0, 16, (B, F, PLAYERS)).astype(np.uint8)
    res = ex.run(world, 3, bits)
    assert tuple(res.checksums.shape) == (B, F, 2)
    trace = tracer.export_perfetto()
    roots = span_trees(trace)
    # The export puts "spec_" spans on the spec track, the burst's on the
    # session track: one rollout's spans, inside its dispatch in time.
    assert [shape(r) for r in roots] == [("spec_branch_dispatch", [])] + burst(F, "")[1]
    assert roots[0][1] == {"branches": B, "frames": F}
    ts = {(e["name"], e["ph"]): e["ts"] for e in trace["traceEvents"] if e["ph"] in "BE"}
    stamps = [e["ts"] for e in trace["traceEvents"]
              if e["ph"] in "BE" and e["name"].startswith("burst_")]
    assert ts["spec_branch_dispatch", "B"] <= min(stamps)
    assert max(stamps) <= ts["spec_branch_dispatch", "E"]


def _matmul_under_profiler(tracer):
    x = torch.randn(256, 256)
    x @ x  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("matmul"):
            x @ x
    return prof


def test_span_stamps_lie_on_the_profilers_clock():
    tracer = SpanTracer()
    prof = _matmul_under_profiler(tracer)
    origin_us = round(tracer.wall_t0 * 1e6)
    begin, end = (origin_us + e["ts"] for e in tracer.export_perfetto()["traceEvents"]
                  if e["name"] == "matmul")
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ops) == 1
    # Both clocks in whole microseconds of the wall clock.
    assert begin <= ops[0].start_ns() // 1000 <= ops[0].end_ns() // 1000 <= end
    assert end - begin < 10_000_000  # one clock, not two origins


def test_merge_lays_a_profiler_trace_on_the_tracers_timeline(tmp_path):
    tracer = SpanTracer(pid=0, process_name="peer-0")
    prof = _matmul_under_profiler(tracer)
    prof.export_chrome_trace(str(tmp_path / "device.json"))
    tracer.export_perfetto(str(tmp_path / "spans.json"))
    paths = [str(tmp_path / "spans.json"), str(tmp_path / "device.json")]
    merged = merge.merge_traces(paths, align="wall", path=str(tmp_path / "merged.json"))
    assert json.loads((tmp_path / "merged.json").read_text()) == merged

    ev = merged["traceEvents"]
    begin, end = (e["ts"] for e in ev if e.get("name") == "matmul")
    (mm,) = [e for e in ev if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    # The merge shifts each file by whole microseconds: one of slack.
    assert begin - 1 <= mm["ts"] <= mm["ts"] + mm["dur"] <= end + 1
    pids = {e["pid"] for e in ev if e.get("name") in ("matmul", "aten::mm")}
    assert len(pids) == 2  # the profiler's process kept apart from the tracer's
