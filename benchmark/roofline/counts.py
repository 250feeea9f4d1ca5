"""Operations and bytes a kernel's work needs, from the shapes alone, and
the least time the card could take for them.

The least time is the larger of operations / peak rate and bytes / peak
bandwidth (``peaks.json``), where every input byte is read once and every
output byte written once, whatever a kernel reads again.

- Dense forces: the force step needs every unordered pair of boids once:
  ``N (N - 1) / 2`` pairs a world, at ``PAIR_OPS`` float32 operations a
  pair (the pair's difference, squared distance, both radius tests, the
  self test and the separation weight), on the CUDA cores' float32 peak.
  The same count holds for whichever kernel computes the dense forces, so
  a kernel doing the same work another way reads on the same yardstick.
  Bytes: position, velocity and activity in, the force out.
- World checksums: bytes only. A save reads the world once and writes
  its ring row, frame label and two lanes; a guard reads a ring row and
  its stored frame and lanes, and writes one flag.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

PAIR_OPS = 18  # float32 operations a pair of boids needs for its masks and weight

_ITEMSIZE = {"float32": 4, "int32": 4, "uint32": 4, "int16": 2, "uint16": 2,
             "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1, "bool": 1}


def least_seconds(ops: float, nbytes: float, peak: str = "f32_flops") -> float:
    return max(ops / PEAKS[peak], nbytes / PEAKS["hbm_bytes_per_s"])


def dense_force_ops(n: int) -> float:
    return PAIR_OPS * n * (n - 1) / 2


def dense_force_bytes(n: int) -> float:
    return n * (2 + 2 + 1) * 4 + n * 2 * 4


def dense_force_least_s(n: int, worlds: int = 1) -> float:
    """Least seconds of the dense force step of ``worlds`` worlds of ``n``
    boids each."""
    return least_seconds(worlds * dense_force_ops(n), worlds * dense_force_bytes(n))


def world_bytes(config: dict) -> int:
    """Bytes of one world of the configuration: per entity its alive flag,
    rollback id (4 bytes) and, per component, its presence flag and its
    values; per resource its words."""
    per = 1 + 4
    for dtype, width in config["components"].values():
        per += 1 + _ITEMSIZE[dtype] * int(width)
    res = sum(_ITEMSIZE[dtype] for dtype in config["resources"].values())
    return int(config["num_boids"]) * per + res


def save_bytes(config: dict) -> int:
    """A save of one world: the world read, its row, frame (4) and lanes
    (16) written."""
    w = world_bytes(config)
    return 2 * w + 4 + 16


def guard_bytes(config: dict) -> int:
    """A guard of one ring row: the row, its frame and lanes read, a flag
    written."""
    return world_bytes(config) + 4 + 16 + 4


def checksum_least_s(config: dict, saves: float, guards: float = 0.0) -> float:
    return least_seconds(0.0, saves * save_bytes(config) + guards * guard_bytes(config))
