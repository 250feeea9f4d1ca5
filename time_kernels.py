#!/usr/bin/env python3
"""Time the port's redesigned kernels, and another tree's, on one GPU.

    python3 time_kernels.py                       # this checkout's kernels
    python3 time_kernels.py --tree DIR [--tree DIR2 ...]

Each tree is a directory holding a ``bevy_ggrs_tpu_torch/`` package (this
checkout is ``.``). With several trees, each is timed in a process of its
own, in turns forward then backward (A, B, B, A), so that versions are
compared within one call on one card. An earlier version of a kernel is
timed by unpacking its commit into a git-ignored directory::

    git archive <commit> bevy_ggrs_tpu_torch | tar -x -C _scratch/old
    python3 time_kernels.py --tree _scratch/old --tree .

Per tree and turn it prints one JSON line with four kernels on the spawn
spiral that ``boids.make_world`` lays out (every boid live): the f32
force kernel (``pairwise_force_rows``) and the general tensor-core kernel
(``pairwise_force_rows_mxu2``) at R = N = 1,024, the triangle
(``pairwise_force_square_mxu_tri``) at N = 4,096, and the cell kernel
(``cell_slot_forces``) at the boids-32,768 grid. Each has its device
milliseconds a call (a CUDA graph of many calls, replayed), its
milliseconds a call with the host's work, the largest difference from its
plain version on the same inputs, and the SHA-256 of its output's bytes,
so that two trees' outputs can be compared bit for bit.

Beside them, the checksum through the three calls every tree since the
first shares (``ops.checksum.checksum(state)``, ``state.ring_save(ring,
state, 0)`` and ``integrity.verify_row(ring, 0)``) on the boids-1,024
world and the boids-32,768 grid world, each with its milliseconds a call
(CUDA events, the host's work included), its device milliseconds a call
(the sum of the device intervals ``torch.profiler`` records, kernels and
copies: an older tree's calls copy from the host, which keeps them out of
a CUDA graph), its kernels and host-to-device copies a call, and the
SHA-256 of the lanes, or of the saved ring row with its frame and digest,
and whether the lanes equal the plain ``state.checksum``. And the
checksum's save over a branch axis (the speculative rollout's, one launch
for every branch), where the tree has it: ``state.ring_save`` of box_game
worlds at B = 64 and B = 256 into ``[B, 8]`` stacks of rings, with its
device milliseconds by graph replay, its kernels and host-to-device copies
a call, its milliseconds a call and the SHA-256 of the saved rows. And
the four force kernels over a leading branch axis (boids under
speculation, one launch for every branch), where the tree takes one, at
``chip_smoke.py`` phase 11's shapes: the f32 kernel at B = 16 and the
general tensor-core kernel at B = 128 and B = 512 (R = N = 1,024; 512 is
the speculative rollout cell's batch), the triangle at B = 8 (N = 4,096)
and the cell kernel at B = 2 (the boids-32,768 grid), on
``chip_smoke.branch_flocks`` data, with the same four numbers as the
unbatched kernels. Each general tensor-core row also gives its bound
(``bound_ms``: B x R x N pairs at ``chip_smoke.MXU_MASK_OPS_PER_PAIR`` f32
operations each, at 67 TFLOP/s).

Only public signatures are used, so any tree of the port since they were
written runs. The last lines are the mean of each tree's turns, whether
each output's bits were the same in every turn of every tree, and the
card's name and power limit. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def sha256(*tensors) -> str:
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def timed(cs, kernel, got, want) -> dict:
    """``kernel``'s device and per-call milliseconds, and its output
    ``got`` against the plain version's ``want`` (tensors or tuples of
    them)."""
    got, want = ((x,) if hasattr(x, "shape") else tuple(x) for x in (got, want))
    return {
        "device_ms": cs.graph_ms(kernel),
        "call_ms": cs.cuda_ms(kernel),
        "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got, want)),
        "sha256": sha256(*got),
    }


def profiled(fn, calls: int = 50) -> dict:
    """Device milliseconds, kernels and host-to-device copies a call of
    ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {
        "device_ms": sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / calls,
        "kernels_per_call": sum(not e.name.startswith(("Memcpy", "Memset"))
                                for e in events) / calls,
        "h2d_per_call": sum("HtoD" in e.name for e in events) / calls,
    }


def checksum_calls(cs, boids, n: int) -> dict:
    """The checksum, a ring save and a restore guard on a boids-``n``
    world, through the calls every tree of the port shares."""
    import torch

    from bevy_ggrs_tpu_torch import integrity
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.ops import checksum as ck

    state = boids.make_world(n, 2, device="cuda").commit()
    ring = ts.ring_init(state, 9)
    ts.ring_save(ring, state, 0)
    lanes = ck.checksum(state)
    st = ring.states
    leaves = ts.tree_leaves([st.alive, st.rollback_id, st.components, st.present, st.resources])
    row = [t[0] for t in leaves] + [ring.frames[:1], ring.checksums[0]]
    out = {}
    for name, fn, digest in (
        ("checksum", lambda: ck.checksum(state), sha256(lanes)),
        ("ring_save", lambda: ts.ring_save(ring, state, 0), sha256(*row)),
        ("verify_row", lambda: integrity.verify_row(ring, 0),
         sha256(torch.tensor([integrity.verify_row(ring, 0)]))),
    ):
        out[f"{name}_boids{n}"] = {**profiled(fn), "call_ms": cs.cuda_ms(fn), "sha256": digest}
    out[f"checksum_boids{n}"]["equals_state_checksum"] = bool((lanes == ts.checksum(state)).all())
    return out


def batched_save_calls(cs) -> dict:
    """The save of B box_game worlds into a ``[B, 8]`` stack of rings, at
    B = 64 and 256 (BASELINE configs 2 and "HL"); empty for a tree without
    branch rings."""
    import torch

    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.models import box_game

    if not hasattr(ts, "branch_rings"):
        return {}
    out = {}
    for B in (64, 256):
        world = box_game.make_world(2, device="cuda").commit()
        state = ts.broadcast_branches(world, B)
        step = torch.arange(B, device="cuda", dtype=torch.float32)[:, None, None] * 0.01
        state.components["translation"].add_(step)  # every branch its own bits
        rings = ts.branch_rings(world, B, 8)
        ts.ring_save(rings, state, 3)
        st = rings.states
        leaves = ts.tree_leaves([st.alive, st.rollback_id, st.components, st.present,
                                 st.resources])
        digest = sha256(*(t[:, 3] for t in leaves), rings.frames[:, 3], rings.checksums[:, 3])
        fn = lambda: ts.ring_save(rings, state, 3)  # noqa: E731
        out[f"batched_save_box_game_B{B}"] = {**profiled(fn), "device_ms": cs.graph_ms(fn),
                                              "call_ms": cs.cuda_ms(fn), "sha256": digest}
    return out


def batched_force_calls(cs, boids, tpw, tcg, tnb) -> dict:
    """The four force kernels over a leading branch axis at phase 11's
    shapes; empty for a tree whose wrappers refuse a branch axis."""
    if hasattr(tpw, "check_no_branch_axis"):
        return {}
    params = boids._kernel_params()
    out = {}
    base = boids.make_world(1024, 2, device="cuda").commit().components["position"]
    for name, fn, plain, B in (
        ("f32", tpw.pairwise_force_rows, tpw.pairwise_force_rows_plain, 16),
        ("mxu2", tpw.pairwise_force_rows_mxu2, tpw.pairwise_force_rows_mxu2_plain, 128),
        ("mxu2", tpw.pairwise_force_rows_mxu2, tpw.pairwise_force_rows_mxu2_plain, 512),
    ):
        pos, vel, act = cs.branch_flocks(B, base, seed=B)
        args = (pos, vel, pos, vel, act, act)
        out[f"{name}_B={B}_R=N=1024"] = timed(
            cs, lambda fn=fn, args=args: fn(*args, **params), fn(*args, **params),
            plain(*args, **params))
        if name == "mxu2":
            out[f"{name}_B={B}_R=N=1024"]["bound_ms"] = mxu2_bound_ms(cs, B, 1024, 1024)
    base = boids.make_world(4096, 2, device="cuda").commit().components["position"]
    tri = cs.branch_flocks(8, base, seed=8)
    out["tri_B=8_N=4096"] = timed(
        cs, lambda: tpw.pairwise_force_square_mxu_tri(*tri, **params),
        tpw.pairwise_force_square_mxu_tri(*tri, **params),
        tpw.pairwise_force_square_mxu_tri_plain(*tri, **params))
    n = 32768
    base = boids.make_world(n, 2, device="cuda").commit().components["position"]
    config = boids.grid_config(n)
    _, rowvals, colvals = cs.batched_grid_operands(tnb, boids, *cs.branch_flocks(2, base, 2),
                                                   config)
    fk = boids.FLOCK_PAIR_KERNEL
    out[f"cell_B=2_C={config.num_cells}_K={config.cell_capacity}_M={config.padded_cols}"] = {
        **timed(cs, lambda: tcg.cell_slot_forces(fk, rowvals, colvals),
                tcg.cell_slot_forces(fk, rowvals, colvals),
                tcg.cell_slot_forces_plain(fk, rowvals, colvals)),
        "live_pairs": cs.live_pairs(rowvals, colvals),
    }
    return out


def mxu2_bound_ms(cs, B: int, R: int, N: int) -> float:
    """The general tensor-core kernel's least time: its masks' f32
    operations for B x R x N pairs at the card's f32 peak."""
    return B * R * N * cs.MXU_MASK_OPS_PER_PAIR / cs.PEAK_F32_PER_S * 1e3


def measure(tree: pathlib.Path) -> dict:
    """Import the port from ``tree`` and time its four force kernels and
    its checksum."""
    import torch

    import chip_smoke as cs  # this checkout's timing helpers

    sys.path.insert(0, str(tree))
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
    from bevy_ggrs_tpu_torch.ops import neighbor as tnb
    from bevy_ggrs_tpu_torch.ops import pairwise as tpw

    torch.backends.cuda.matmul.allow_tf32 = False
    source = pathlib.Path(tpw.__file__).resolve().parents[2]
    if source != tree.resolve():
        raise SystemExit(f"time_kernels: imported the port from {source}, not {tree}")
    params = boids._kernel_params()
    out = {"tree": str(tree)}

    state = boids.make_world(1024, 2, device="cuda").commit()
    pos, vel = state.components["position"], state.components["velocity"]
    act = (state.alive & state.present["position"]).float()
    args = (pos, vel, pos, vel, act, act)
    out["f32_R=N=1024"] = timed(
        cs, lambda: tpw.pairwise_force_rows(*args, **params),
        tpw.pairwise_force_rows(*args, **params),
        tpw.pairwise_force_rows_plain(*args, **params))
    out["mxu2_R=N=1024"] = timed(
        cs, lambda: tpw.pairwise_force_rows_mxu2(*args, **params),
        tpw.pairwise_force_rows_mxu2(*args, **params),
        tpw.pairwise_force_rows_mxu2_plain(*args, **params))
    out["mxu2_R=N=1024"]["bound_ms"] = mxu2_bound_ms(cs, 1, 1024, 1024)

    state = boids.make_world(4096, 2, device="cuda").commit()
    tri = (state.components["position"], state.components["velocity"],
           (state.alive & state.present["position"]).float())
    out["tri_N=4096"] = timed(
        cs, lambda: tpw.pairwise_force_square_mxu_tri(*tri, **params),
        tpw.pairwise_force_square_mxu_tri(*tri, **params),
        tpw.pairwise_force_square_mxu_tri_plain(*tri, **params))

    n = 32768
    state = boids.make_world(n, 2, device="cuda").commit()
    config = boids.grid_config(n)
    _, _, rowvals, colvals = cs.grid_operands(
        tnb, boids, state.components["position"], state.components["velocity"],
        (state.alive & state.present["position"]).float(), config)
    fk = boids.FLOCK_PAIR_KERNEL
    out[f"cell_C={config.num_cells}_K={config.cell_capacity}_M={config.padded_cols}"] = {
        **timed(cs, lambda: tcg.cell_slot_forces(fk, rowvals, colvals),
                tcg.cell_slot_forces(fk, rowvals, colvals),
                tcg.cell_slot_forces_plain(fk, rowvals, colvals)),
        "live_pairs": cs.live_pairs(rowvals, colvals),
    }
    for n in (1024, 32768):
        out.update(checksum_calls(cs, boids, n))
    out.update(batched_save_calls(cs))
    out.update(batched_force_calls(cs, boids, tpw, tcg, tnb))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=pathlib.Path,
                    help="a directory holding bevy_ggrs_tpu_torch/ (repeatable)")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    if args.one is not None:
        print(json.dumps(measure(args.one)), flush=True)
        return 0
    trees = [t.resolve() for t in args.tree] if args.tree else [ROOT]
    turns = trees + trees[::-1] if len(trees) > 1 else trees
    rows = []
    for tree in turns:
        res = subprocess.run([sys.executable, str(ROOT / "time_kernels.py"), "--one", str(tree)],
                             cwd=ROOT, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"time_kernels: the turn of {tree} failed (rc {res.returncode})")
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    means = {}
    for row in rows:
        for kernel, vals in row.items():
            if kernel == "tree":
                continue
            for key in ("device_ms", "call_ms"):
                means.setdefault(row["tree"], {}).setdefault(kernel, {}).setdefault(key, []).append(vals[key])
    print("mean " + json.dumps({tree: {k: {key: sum(v) / len(v) for key, v in d.items()}
                                       for k, d in kernels.items()}
                                for tree, kernels in means.items()}))
    names = sorted({kernel for row in rows for kernel in row} - {"tree"})
    print("same bits in every turn " + json.dumps({
        kernel: len({row[kernel]["sha256"] for row in rows if kernel in row}) == 1
        for kernel in names}))
    import chip_smoke as cs
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
