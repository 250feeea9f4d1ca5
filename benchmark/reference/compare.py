"""The comparison that decides ``correct``: the program's saved and live
states held to the plain reference, frame by frame.

A flock doubles a small difference every few frames, so the reference
cannot follow a run of hundreds of frames from its start. It follows the
program one frame at a time instead: from each state the program saved,
one reference step, compared with the state the program saved (or holds)
for the next frame. The start (the world the benchmark made) is compared
bit for bit with the program's first saved row, and every saved row's
lanes with the reference hash of that row.

Numbers, each against the cell's limit (``benchmark/workloads/<cell>.json``):

- ``hash_mismatches``: saved rows whose stored lanes differ from
  :func:`benchmark.reference.hash.lanes` of the row;
- ``exact_mismatches``: entries that must be equal bit for bit and are
  not: alive, rollback ids, presence, leader handles and the frame count
  after a step; every field of the first row against the world the
  benchmark made; frame labels of saved rows;
- ``integration_mismatches``: position entries that are not, bit for bit,
  the previous position plus the program's own new velocity in float32,
  wrapped on the torus (the reference's integration of the velocity the
  program gives; an entity that does not move keeps its position);
- ``vel_gap_p90``: over the steps compared, the largest 90th percentile
  over live boids of ``max(|dvx|, |dvy|) / MAX_SPEED`` between the
  program's velocity and the reference's. A percentile, not the widest
  gap: the few boids with a neighbour almost on top of them (a separation
  weight near 1e4) carry the program's rounding a thousand times over,
  and the widest gap swings with them from seed to seed.
- ``vel_gap_rounding_max``: over the steps compared and every boid, the
  largest ``max(|dvx|, |dvy|)`` divided by the boid's own rounding scale
  (:mod:`benchmark.reference.flock`: ``2**-16`` times the size of the
  terms its force sums). The percentile leaves a tenth of the boids
  unheld; this holds each of them, to the room its own sums give it, so a
  force kernel that gets one tile of rows wrong, or drops a share of the
  pairs, fails here.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from benchmark.reference import flock
from benchmark.reference import hash as ref_hash

NUMBERS = ("hash_mismatches", "exact_mismatches", "integration_mismatches", "vel_gap_p90",
           "vel_gap_rounding_max")


class Tally:
    """The numbers of one run, gathered over every comparison. With
    ``control`` it also gathers, in ``self.control``, the numbers of the
    control: the reference in TF32 put in the program's place at every step
    (for setting limits, never in the benchmark's own runs)."""

    def __init__(self, control: bool = False) -> None:
        self.values: Dict[str, float] = {n: 0 for n in NUMBERS}
        self.steps = 0
        self.rows_hashed = 0
        self.widest: Dict[str, float] = {}  # where vel_gap_rounding_max was read
        self.control = Tally() if control else None

    def exact(self, count: int) -> None:
        self.values["exact_mismatches"] += int(count)

    def hashed(self, world: dict, stored: Iterable[np.ndarray]) -> None:
        """Compare each of ``stored`` (``[lo, hi]`` lanes) with the
        reference hash of ``world``."""
        want = ref_hash.lanes(world)
        self.rows_hashed += 1
        for lanes in stored:
            got = np.asarray(lanes).astype(np.int64).reshape(2) & ref_hash.M32
            if not np.array_equal(got.astype(np.uint64), want):
                self.values["hash_mismatches"] += 1

    def stepped(self, prev: dict, got: dict, ref: dict) -> None:
        """Hold ``got``, the program's state a frame after ``prev``, to
        ``ref``, the reference's step from ``prev``."""
        self.steps += 1
        self.exact(count_unequal(got, ref, floats=False))
        moved = flock.integrate(prev, got["components"]["velocity"])
        self.values["integration_mismatches"] += int(
            (moved.view(np.uint32) != got["components"]["position"].view(np.uint32)).sum())
        live = np.asarray(ref["alive"], bool)
        dv = np.abs(got["components"]["velocity"].astype(np.float64)
                    - ref["components"]["velocity"].astype(np.float64)).max(axis=1)
        if live.any():
            p90 = float(np.percentile(dv[live], 90)) / flock.MAX_SPEED
            self.values["vel_gap_p90"] = max(self.values["vel_gap_p90"], p90)
        scaled = dv / ref["rounding"].astype(np.float64)
        i = int(np.argmax(scaled))
        if scaled[i] > self.values["vel_gap_rounding_max"]:
            self.values["vel_gap_rounding_max"] = float(scaled[i])
            self.widest = {"step": self.steps, "boid": i, "gap": float(dv[i]),
                           "rounding": float(ref["rounding"][i])}

    def checks(self, limits: Dict[str, float]) -> Dict[str, dict]:
        return {n: {"value": self.values[n], "limit": limits[n]} for n in NUMBERS}


def count_unequal(a: dict, b: dict, floats: bool = True) -> int:
    """Entries of two host worlds that differ bit for bit: alive, rollback
    ids, presence, integer components, resources, and with ``floats`` the
    float components too."""
    pairs = [(a["alive"], b["alive"]), (a["rollback_id"], b["rollback_id"])]
    pairs += [(a["present"][k], b["present"][k]) for k in b["present"]]
    for k, v in b["components"].items():
        if floats or not np.issubdtype(np.asarray(v).dtype, np.floating):
            pairs.append((a["components"][k], v))
    pairs += [(a["resources"][k], v) for k, v in b["resources"].items()]
    n = 0
    for x, y in pairs:
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            n += max(x.size, y.size)
            continue
        if np.issubdtype(x.dtype, np.floating):  # bits, so -0.0 != 0.0
            x, y = x.view(f"u{x.dtype.itemsize}"), y.view(f"u{y.dtype.itemsize}")
        n += int((x != y).sum())
    return n


def follow(tally: Tally, frames: Dict[int, dict], bits_of, device,
           last: Optional[tuple] = None) -> None:
    """Step the reference from each saved frame ``f`` of ``frames`` (frame
    -> host world) whose next frame is also saved, with ``bits_of(f)``, and
    hold frame ``f + 1`` to it; ``last`` = ``(frame, world)`` is one more
    state to reach the same way (a live state past the saved rows)."""
    have = dict(frames)
    if last is not None:
        have[last[0]] = last[1]
    for f in sorted(frames):
        if f + 1 in have:
            ref = flock.step(frames[f], bits_of(f), device)
            tally.stepped(frames[f], have[f + 1], ref)
            if tally.control is not None:
                tally.control.stepped(frames[f], flock.step(frames[f], bits_of(f), device,
                                                            "tf32"), ref)
