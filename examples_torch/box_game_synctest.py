#!/usr/bin/env python
"""box_game SyncTest on the PyTorch port: the determinism harness, headless.

CLI of ``examples/box_game_synctest.py``: ``--num-players``,
``--check-distance``. Every simulated frame forces a rollback
``check_distance`` frames deep and re-simulates; any checksum mismatch
between the original and resimulated pass aborts with a desync error.
Exits 0 with a final world printout when the run stays deterministic.

    python examples_torch/box_game_synctest.py --num-players 2 --check-distance 7
    python examples_torch/box_game_synctest.py --device cpu
"""

import argparse
import sys

from box_game_common import (
    Instruments,
    add_common_args,
    build_app,
    print_world,
    scripted_input,
    select_device,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--num-players", type=int, default=2)
    parser.add_argument("--check-distance", type=int, default=2)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = select_device(args.device)

    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session import MismatchedChecksum, SessionBuilder

    session = (
        SessionBuilder(box_game.INPUT_SPEC)
        .with_num_players(args.num_players)
        .with_check_distance(args.check_distance)
        .with_max_prediction_window(max(8, args.check_distance))
        .start_synctest_session()
    )
    inst = Instruments(args)
    app = build_app(args.num_players, max(8, args.check_distance), args.fps,
                    scripted_input, device, metrics=inst.metrics)
    app.insert_session(session, SessionType.SYNC_TEST)

    try:
        with inst:
            app.run_for(args.frames, dt=1.0 / args.fps)
    except MismatchedChecksum as exc:
        print(f"DESYNC: {exc}", file=sys.stderr)
        return 1
    print_world(app, f"synctest ok after {app.frame} frames")
    inst.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
