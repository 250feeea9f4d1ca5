#!/usr/bin/env python3
"""Readings for a cell's correctness limits, at the cell's own size, on one card.

    python3 benchmark/calibrate.py --workload boids_32k.synctest_cd7 \
        --seconds 3 --seeds 11 12 13 --out chiprun_out/calibrate.json

For each seed, one run of the cell in this process (a short window at the
cell's own load) and its comparison, once with the program and once with
the control put in the program's place: the reference in TF32, one step
from every state the program saved. Prints a JSON line a seed and a
summary: the lower reading of each number (the largest over the
program's seeds) and the upper one (the smallest over the control's).
A limit is set between them (``benchmark/workloads/<cell>.json``); the
benchmark's own runs never run the control.

With ``--fault <name>`` (``benchmark/faults.py``) every run has that fault
planted under the timed path, and the summary gives the smallest reading
of each number over the seeds: what the fault reads at the cell's size.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.reference import compare

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    control = args.fault is None
    for seed in args.seeds:
        t0 = time.perf_counter()
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            line = harness.run_cell(args.workload, seed, args.seconds, False,
                                    torch.device("cuda", 0), control=control)
        row = {"seed": seed, "correct": line["correct"],
               "program": {k: v["value"] for k, v in line["checks"].items()},
               "control": line["notes"].get("control"),
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "notes": {k: v for k, v in line["notes"].items() if k != "control"},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if control:
        summary = {n: {"lower": max(r["program"][n] for r in rows),
                       "upper": min(r["control"][n] for r in rows)}
                   for n in compare.NUMBERS}
    else:
        summary = {n: {"fault_least": min(r["program"][n] for r in rows)}
                   for n in compare.NUMBERS}
    out = {"workload": args.workload, "seeds": args.seeds, "seconds": args.seconds,
           "fault": args.fault, "card": harness.card_state(), "summary": summary,
           "runs": rows}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
