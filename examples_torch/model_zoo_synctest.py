#!/usr/bin/env python
"""SyncTest determinism harness for the extension models (boids,
neural_bots, projectiles) on the PyTorch port. The box_game CLIs cover the
reference's own game; this drives the entity-scaling, tensor-core and
dynamic-lifecycle model families through the same forced-rollback
machinery.

    python examples_torch/model_zoo_synctest.py --model boids --entities 1024 \
        --check-distance 5 --frames 120 --kernel mxu
    python examples_torch/model_zoo_synctest.py --model neural_bots
    python examples_torch/model_zoo_synctest.py --model projectiles --device cpu

boids' kernels: ``--kernel xla`` (the default, as in the JAX example)
JAX's XLA forces in plain PyTorch, ``pallas`` (or ``--pallas``) the f32
force kernel, ``mxu`` the tensor-core kernels (the triangle kernel from
4,096 boids); grid mode (``GGRS_FORCE_MODE=grid``) routes the last two
through the cell kernel and ``xla`` through its plain version.
"""

import argparse
import sys

import numpy as np

from box_game_common import Instruments, add_common_args, select_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", choices=["boids", "neural_bots", "projectiles"],
                        default="boids")
    parser.add_argument("--entities", type=int, default=256)
    parser.add_argument("--num-players", type=int, default=2)
    parser.add_argument("--check-distance", type=int, default=4)
    parser.add_argument("--pallas", action="store_true",
                        help="boids: use the f32 force kernel")
    parser.add_argument("--kernel", choices=["xla", "pallas", "mxu"], default=None,
                        help="boids force kernel (mxu = the tensor-core "
                             "kernels; overrides --pallas)")
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = select_device(args.device)

    from bevy_ggrs_tpu_torch.models import boids, neural_bots, projectiles
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import MismatchedChecksum, SyncTestSession
    from bevy_ggrs_tpu_torch.state import checksum, combine64

    if args.model == "boids":
        model = boids
        schedule = boids.make_schedule(kernel=args.kernel, use_pallas=args.pallas)
        world = boids.make_world(args.entities, args.num_players, device=device)
    elif args.model == "projectiles":
        model = projectiles
        schedule = projectiles.make_schedule()
        world = projectiles.make_world(args.num_players, capacity=args.entities,
                                       device=device)
    else:
        model = neural_bots
        schedule = neural_bots.make_schedule()
        world = neural_bots.make_world(args.entities, args.num_players, device=device)

    max_prediction = max(8, args.check_distance)
    session = SyncTestSession(
        args.num_players, model.INPUT_SPEC,
        check_distance=args.check_distance, max_prediction=max_prediction,
    )
    runner = RollbackRunner(
        schedule, world.commit(), max_prediction=max_prediction,
        num_players=args.num_players, input_spec=model.INPUT_SPEC, device=device,
    )
    inst = Instruments(args)
    if inst.metrics is not None:
        runner.metrics = inst.metrics

    rng = np.random.RandomState(0)
    # projectiles adds a FIRE bit (1<<4): include it so the harness
    # exercises spawn/despawn under the forced rollbacks.
    hi = 32 if args.model == "projectiles" else 16
    try:
        with inst:
            for _ in range(args.frames):
                for h in range(args.num_players):
                    session.add_local_input(h, np.uint8(rng.randint(0, hi)))
                runner.handle_requests(session.advance_frame(), session)
    except MismatchedChecksum as exc:
        print(f"DESYNC: {exc}", file=sys.stderr)
        return 1

    host = runner.world()
    fc = int(host["resources"]["frame_count"])
    print(f"[{args.model} synctest ok] frames={runner.frame} "
          f"frame_count={fc} entities={args.entities} "
          f"rollbacks={runner.rollbacks_total} "
          f"resimulated={runner.rollback_frames_total} "
          f"final_checksum={hex(combine64(checksum(runner.state)))}")
    if args.model in ("boids", "neural_bots"):
        # Positions, for holding a run against another within the force
        # kernels' tolerance (the checksum is bitwise only on one path).
        pos = host["components"]["position"]
        print(f"[{args.model} positions] " + " ".join(
            f"{v:.9e}" for v in np.asarray(pos, np.float64).ravel()))
    inst.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
