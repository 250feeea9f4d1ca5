#!/usr/bin/env python
"""box_game spectator on the PyTorch port: follow a P2P host's confirmed
game, never roll back.

CLI of ``examples/box_game_spectator.py``: ``--local-port``,
``--num-players``, ``--host``.

    python examples_torch/box_game_spectator.py --local-port 7002 \
        --num-players 2 --host 127.0.0.1:7000 --frames 600
(and start the host with ``--spectators 127.0.0.1:7002``)
"""

import argparse
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
from box_game_p2p import parse_addr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--local-port", type=int, required=True)
    parser.add_argument("--num-players", type=int, default=2)
    parser.add_argument("--host", required=True, help="host address host:port")
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = select_device(args.device)

    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session import SessionBuilder
    from bevy_ggrs_tpu_torch.transport.udp import UdpSocket

    inst = Instruments(args)
    app = build_app(args.num_players, 8, args.fps, scripted_input, device,
                    metrics=inst.metrics)
    socket = UdpSocket.bind_to_port(args.local_port)
    session = (
        SessionBuilder(box_game.INPUT_SPEC)
        .with_num_players(args.num_players)
        .with_fps(args.fps)
        .start_spectator_session(parse_addr(args.host), socket)
    )
    app.insert_session(session, SessionType.SPECTATOR)
    app.add_render_system(print_events_system)
    app.add_render_system(make_stats_system())

    dt = 1.0 / args.fps
    with inst:
        for _ in range(args.frames):
            t0 = time.monotonic()
            app.update()
            lead = dt - (time.monotonic() - t0)
            if lead > 0:
                time.sleep(lead)
    print_world(app, f"spectator done after {app.frame} sim frames")
    inst.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
