"""Shared wiring for the box_game examples of the PyTorch port.

The same examples as ``examples/``, on ``bevy_ggrs_tpu_torch``: plugin
construction with rollback type registrations, the setup system spawning
one rollback-tagged cube per player, an input system, and the event and
stat printing systems that the P2P and spectator binaries install outside
the rollback schedule.

Headless: instead of a keyboard, the input system is a deterministic script
(change direction every few frames); the framework path exercised is the
same. Every example runs on ``cuda`` unless ``--device cpu`` is given, and
exits with an error when ``cuda`` is asked for and there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def select_device(name: str) -> torch.device:
    """The torch device of ``--device``: ``cuda`` needs a GPU, and there is
    no fallback to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(name)


def build_app(num_players: int, max_prediction: int, fps: int, input_fn, device,
              clock=None, speculation: int = 0, metrics=None):
    from bevy_ggrs_tpu_torch.app import GGRSPlugin
    from bevy_ggrs_tpu_torch.models import box_game

    def setup(world, app):
        # One cube per player on the spawn circle, tagged with a unique
        # rollback id.
        box_game.spawn_players(world, num_players, next_id=app.rollback_id_provider.next_id)

    plugin = (
        GGRSPlugin(box_game.INPUT_SPEC)
        .with_update_frequency(fps)
        .with_input_system(input_fn)
        .register_rollback_component("translation", shape=(3,), dtype=torch.float32)
        .register_rollback_component("velocity", shape=(3,), dtype=torch.float32)
        .register_rollback_component("player_handle", dtype=torch.int32, default=-1)
        .register_rollback_resource("frame_count", np.uint32(0))
        .with_rollback_schedule(box_game.make_schedule())
        .with_num_players(num_players)
        .with_max_prediction_window(max_prediction)
        .with_world_capacity(16)
        .with_setup_system(setup)
        .with_device(device)
    )
    if clock is not None:
        plugin.with_clock(clock)
    if speculation:
        plugin.with_speculation(speculation)
    if metrics is not None:
        plugin.with_metrics(metrics)
    return plugin.build()


def scripted_input(handle: int, app) -> np.uint8:
    """Deterministic movement: cycle through UP/RIGHT/DOWN/idle, offset per
    player, switching every 3 simulated frames."""
    from bevy_ggrs_tpu_torch.models import box_game

    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    frame = app.session.current_frame if app.session is not None else 0
    return np.uint8(keys[(frame // 3 + handle) % len(keys)])


def print_events_system(app) -> None:
    """Print the session's events; a desync prints the per-component
    checksum breakdown of the divergent frame's snapshot (or of the live
    state once that frame left the ring), so both sides can diff and name
    the diverging registered type."""
    from bevy_ggrs_tpu_torch.session.common import EventKind

    for event in app.events:
        print(f"[event] {event.kind.value} addr={event.addr} data={event.data}")
        if event.kind == EventKind.DESYNC_DETECTED:
            frame = (event.data or {}).get("frame")
            parts = None
            if frame is not None:
                parts = app.stage.runner.diagnose_frame(frame)
            which = f"frame {frame} snapshot"
            if parts is None:
                from bevy_ggrs_tpu_torch.state import checksum_breakdown

                parts = checksum_breakdown(app.stage.runner.state)
                which = "live state (divergent frame left the ring)"
            print(f"[desync diagnosis] per-part checksums of {which} "
                  "(diff against the other peer's):")
            for name, cs in sorted(parts.items()):
                print(f"  {name}: {cs:#018x}")
    app.events.clear()


def make_stats_system(interval_frames: int = 60):
    """Print each remote player's network stats every ``interval_frames``."""
    last = [-1]

    def system(app) -> None:
        f = app.frame
        if f // interval_frames == last[0] or f % interval_frames:
            return
        last[0] = f // interval_frames
        session = app.session
        if session is None or not hasattr(session, "network_stats"):
            return
        if hasattr(session, "remote_player_handles"):
            for h in session.remote_player_handles():
                try:
                    s = session.network_stats(h)
                    print(f"[stats] frame={f} player={h} ping={s.ping_ms:.1f}ms "
                          f"kbps={s.kbps_sent:.1f} queue={s.send_queue_len}")
                except Exception:
                    pass
        else:
            s = session.network_stats()
            print(f"[stats] frame={f} host ping={s.ping_ms:.1f}ms kbps={s.kbps_sent:.1f}")

    return system


def print_world(app, label: str) -> None:
    world = app.world()
    t = world["components"]["translation"]
    alive = world["alive"]
    fc = int(world["resources"]["frame_count"])
    print(f"[{label}] frame_count={fc}")
    for i in range(len(alive)):
        if alive[i]:
            print(f"  cube {int(world['components']['player_handle'][i])}: "
                  f"({t[i][0]:+.3f}, {t[i][1]:+.3f}, {t[i][2]:+.3f})")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--frames", type=int, default=300,
                        help="render frames to run (headless bound)")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="torch device (cuda needs a GPU; there is no fallback)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="capture a torch.profiler trace of the run and "
                             "write it to DIR/trace.json (Chrome trace format)")
    parser.add_argument("--report-metrics", action="store_true",
                        help="collect per-phase timings + rollback-depth "
                             "histograms and print the summary at exit, with "
                             "the launches of each CUDA kernel")


class Instruments:
    """Wires --profile / --report-metrics into an app run.

    Usage::

        inst = Instruments(args)
        app = build_app(..., metrics=inst.metrics)
        with inst:
            ... run loop ...
        inst.finish()   # prints the metrics report when enabled
    """

    def __init__(self, args):
        from bevy_ggrs_tpu_torch.utils.metrics import Metrics

        self.profile_dir = getattr(args, "profile", None)
        self.metrics = Metrics() if getattr(args, "report_metrics", False) else None
        self._prof = None

    def __enter__(self):
        if self.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            print(f"[profile] trace written to {path}")
        return False

    def finish(self) -> None:
        if self.metrics is not None:
            print("[metrics]")
            print(self.metrics.report())
            from bevy_ggrs_tpu_torch.ops import launch_counts

            print("[kernels] " + json.dumps(launch_counts()))
