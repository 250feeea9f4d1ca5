#!/usr/bin/env python
"""box_game P2P over UDP on the PyTorch port: two (or more) processes on
localhost.

CLI of ``examples/box_game_p2p.py``: ``--local-port``, ``--players`` (with
``localhost`` marking the local slot), ``--spectators``, a 12-frame max
prediction window and a 2-frame input delay by default, and the options
``--speculate``, ``--checkpoint-dir``/``--resume``, ``--chaos-seed``,
``--trace-dir`` and ``--interactive``.

Terminal A:  python examples_torch/box_game_p2p.py --local-port 7000 \
                 --players localhost 127.0.0.1:7001 --frames 600
Terminal B:  python examples_torch/box_game_p2p.py --local-port 7001 \
                 --players 127.0.0.1:7000 localhost --frames 600
"""

import argparse
import contextlib
import json
import os
import sys
import time

from box_game_common import (
    Instruments,
    add_common_args,
    build_app,
    make_stats_system,
    print_events_system,
    print_world,
    scripted_input,
    select_device,
)


def parse_addr(s: str):
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def settled_checksums(runner, session) -> dict:
    """Frame -> checksum of the ring rows at or below the session's
    confirmed frame: what every peer of the session must agree on, whatever
    frame it stopped at."""
    from bevy_ggrs_tpu_torch.state import combine64

    confirmed = session.confirmed_frame()
    frames = runner.ring.frames.cpu().tolist()
    lanes = runner.ring.checksums.cpu()
    return {str(f): hex(combine64(lanes[i])) for i, f in sorted(enumerate(frames), key=lambda x: x[1])
            if 0 <= f <= confirmed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--local-port", type=int, required=True)
    parser.add_argument("--players", nargs="+", required=True,
                        help="player slots in handle order; 'localhost' = me")
    parser.add_argument("--spectators", nargs="*", default=[],
                        help="spectator addresses host:port")
    parser.add_argument("--input-delay", type=int, default=2)
    parser.add_argument("--max-prediction", type=int, default=12)
    parser.add_argument("--disconnect-timeout", type=float, default=5.0,
                        help="seconds of peer silence before disconnect")
    parser.add_argument("--speculate", type=int, default=0, metavar="B",
                        help="precompute rollback recoveries with B "
                             "speculative input branches per frame (0 = off)")
    parser.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                        help="write rolling crash-recovery checkpoints "
                             "(runner + session) into DIR")
    parser.add_argument("--checkpoint-interval", type=int, default=60)
    parser.add_argument("--resume", action="store_true",
                        help="restore the newest checkpoint from "
                             "--checkpoint-dir before joining")
    parser.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                        help="wrap the UDP socket in a seeded deterministic "
                             "fault injector (loss bursts, reorder, dup, "
                             "corruption: bevy_ggrs_tpu_torch.chaos); the same "
                             "seed replays the same fault schedule")
    parser.add_argument("--chaos-duration", type=float, default=None,
                        help="chaos plan horizon in seconds (default: the "
                             "whole --frames run)")
    parser.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="record spans + a frame-timeline flight recorder "
                             "and write the artifacts (Perfetto trace.json, "
                             "spans.jsonl, frames.jsonl, metrics.prom) into "
                             "DIR at exit: bevy_ggrs_tpu_torch.obs")
    parser.add_argument("--interactive", action="store_true",
                        help="read the local player's input from the keyboard "
                             "(W/A/S/D, raw-mode TTY) instead of the scripted "
                             "bitmask; requires a TTY stdin, falls back to "
                             "scripted otherwise")
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = select_device(args.device)

    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
    from bevy_ggrs_tpu_torch.transport.udp import UdpSocket

    num_players = len(args.players)
    builder = (
        SessionBuilder(box_game.INPUT_SPEC)
        .with_num_players(num_players)
        .with_max_prediction_window(args.max_prediction)
        .with_input_delay(args.input_delay)
        .with_fps(args.fps)
        .with_disconnect_timeout(args.disconnect_timeout)
    )
    for handle, slot in enumerate(args.players):
        if slot == "localhost":
            builder.add_player(PlayerType.local(), handle)
        else:
            builder.add_player(PlayerType.remote(parse_addr(slot)), handle)
    for i, spec in enumerate(args.spectators):
        builder.add_player(PlayerType.spectator(parse_addr(spec)), num_players + i)

    # Build the app (and its kernels) BEFORE binding the socket, so the
    # handshake starts only when we can actually service it.
    inst = Instruments(args)
    tracer = recorder = None
    if args.trace_dir:
        from bevy_ggrs_tpu_torch import obs
        from bevy_ggrs_tpu_torch.utils.metrics import Metrics

        tracer = obs.SpanTracer(pid=args.local_port, process_name=f"peer:{args.local_port}")
        recorder = obs.FlightRecorder()
        if inst.metrics is None:
            # The Prometheus snapshot needs a live sink even when
            # --report-metrics is off.
            inst.metrics = Metrics()
    keys = None
    input_fn = scripted_input
    if args.interactive:
        from box_game_interactive import TtyKeys

        keys = TtyKeys()
        if keys.is_tty:
            def input_fn(handle, app):
                # The keyboard drives the FIRST local handle only; further
                # local slots stay scripted (one keyboard cannot be two
                # players). poll() happens once per render frame below.
                if handle == app.session.local_player_handles()[0]:
                    return keys.bits()
                return scripted_input(handle, app)
        else:
            print("[interactive] stdin is not a TTY; using scripted input", file=sys.stderr)
            keys = None
    app = build_app(num_players, args.max_prediction, args.fps, input_fn, device,
                    speculation=args.speculate, metrics=inst.metrics)
    socket = UdpSocket.bind_to_port(args.local_port)
    chaos = None
    if args.chaos_seed is not None:
        from bevy_ggrs_tpu_torch.chaos import ChaosPlan, ChaosSocket

        duration = args.chaos_duration
        if duration is None:
            duration = args.frames / args.fps
        plan = ChaosPlan.generate(args.chaos_seed, duration)
        # Plan times live on a zero-based epoch; the default clock
        # (process uptime) would place every window in the past.
        chaos_t0 = time.monotonic()
        socket = chaos = ChaosSocket(
            socket, plan, addr=("127.0.0.1", args.local_port),
            clock=lambda: time.monotonic() - chaos_t0,
        )
        print(f"[chaos] seed={args.chaos_seed} directives={len(plan.directives)} "
              f"horizon={plan.horizon():.1f}s")
    session = builder.start_p2p_session(socket, metrics=inst.metrics, tracer=tracer)
    app.insert_session(session, SessionType.P2P)
    if tracer is not None:
        # The session was built with the tracer; the runner (and its
        # speculative executor, if any) pick it up here.
        app.stage.runner.tracer = tracer
        spec = getattr(app.stage.runner, "_spec", None)
        if spec is not None:
            spec.tracer = tracer
    app.add_render_system(print_events_system)
    app.add_render_system(make_stats_system())

    mgr = None
    if args.checkpoint_dir:
        from bevy_ggrs_tpu_torch.utils.persistence import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, interval=args.checkpoint_interval)
        if args.resume:
            meta = mgr.restore_latest(app.stage.runner, session=session)
            if meta is not None:
                print(f"[resume] restored frame {meta['frame']} from {args.checkpoint_dir}")
            else:
                print("[resume] no usable checkpoint; starting fresh")

    dt = 1.0 / args.fps
    with inst, (keys if keys is not None else contextlib.nullcontext()):
        for _ in range(args.frames):
            t0 = time.monotonic()
            if keys is not None:
                keys.poll()
                if keys.quit:
                    break
            app.update()
            if recorder is not None:
                recorder.capture(session=session, runner=app.stage.runner)
            if mgr is not None and session.current_state().name == "RUNNING":
                mgr.maybe_save(app.stage.runner, session=session)
            lead = dt - (time.monotonic() - t0)
            if lead > 0:
                time.sleep(lead)
    runner = app.stage.runner
    extra = ""
    if args.speculate:
        extra = (f", spec_hits={runner.spec_hits}"
                 f", spec_partial={runner.spec_partial_hits}"
                 f", spec_misses={runner.spec_misses}"
                 f", recovered={runner.rollback_frames_recovered_total}")
    if chaos is not None:
        extra += f", chaos_faults={len(chaos.faults)}"
    if args.trace_dir:
        from bevy_ggrs_tpu_torch import obs

        os.makedirs(args.trace_dir, exist_ok=True)
        obs.export_perfetto(tracer, os.path.join(args.trace_dir, "trace.json"))
        tracer.export_jsonl(os.path.join(args.trace_dir, "spans.jsonl"))
        recorder.export_jsonl(os.path.join(args.trace_dir, "frames.jsonl"))
        obs.export_prometheus(inst.metrics, recorder,
                              path=os.path.join(args.trace_dir, "metrics.prom"))
        print(f"[obs] trace + flight-recorder artifacts in {args.trace_dir}/")
    print_world(app, f"p2p done after {app.frame} sim frames "
                     f"(rollbacks={runner.rollbacks_total}, "
                     f"resimulated={runner.rollback_frames_total}{extra})")
    print("[settled] " + json.dumps(settled_checksums(runner, session)))
    inst.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
