#!/usr/bin/env python3
"""Run one cell of the benchmark of ``bevy_ggrs_tpu_torch`` once, on one card.

    python3 benchmark/run.py --workload boids_32k.synctest_cd7 --seed 7 \
        --seconds 20 --trace 0

Loads the cell's configuration and traffic mix (``BENCHMARK.json``,
``benchmark/configs``, ``benchmark/traffic``), makes its world and inputs
from ``--seed``, warms up every shape the window uses (set-up), measures
for ``--seconds``, then holds what the window produced to the plain
reference (``benchmark/reference``) and prints one JSON line: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics and the
device trace's breakdown with ``--trace 1``. The numbers compared are also
the last lines on standard error, each beside its limit.

It exits non-zero and prints no result when there is no CUDA device (or
fewer than the cell asks for), and when the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Kernel caches of the libraries the program may use, at fixed places
    # inside the checkout (the program's own kernels build into
    # bevy_ggrs_tpu_torch/_build/).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)

    import torch

    from benchmark import harness

    harness.EARLY_PHASES["torch_imported"] = time.perf_counter() - T_START
    cell = harness.Cell.named(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.EARLY_PHASES["card_found"] = time.perf_counter() - T_START
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
