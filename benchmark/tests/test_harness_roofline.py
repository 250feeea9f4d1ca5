"""The roofline counts against shapes worked by hand."""

import json
from pathlib import Path

import pytest

from benchmark.roofline import counts

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_dense_force_ops_and_bytes():
    # 4,096 boids: 4,096 x 4,095 / 2 = 8,386,560 unordered pairs, 18 ops each.
    assert counts.dense_force_ops(4096) == 150_958_080
    assert counts.dense_force_bytes(4096) == 4096 * 20 + 4096 * 8
    # The f32 peak bounds it: 150,958,080 / 67e12 s = 2.2531e-6 s, as
    # chip_smoke's bound of the triangle at 4,096 (0.002254 ms).
    assert counts.dense_force_least_s(4096) == pytest.approx(2.2531e-6, rel=1e-4)
    # 512 worlds of 1,024 boids: 512 x 523,776 pairs x 18 = 4.8271e9 ops.
    assert counts.dense_force_least_s(1024, 512) == pytest.approx(4.82714e9 / 67e12, rel=1e-5)


def test_world_and_checksum_bytes():
    # A boid: alive 1 + rollback id 4 + (1 + 8) position + (1 + 8) velocity
    # + (1 + 4) leader handle = 28 bytes; the frame count 4 more.
    assert counts.world_bytes(_config("boids_1k")) == 1024 * 28 + 4 == 28_676
    assert counts.world_bytes(_config("boids_32k")) == 32768 * 28 + 4
    assert counts.save_bytes(_config("boids_1k")) == 2 * 28_676 + 20
    assert counts.guard_bytes(_config("boids_1k")) == 28_676 + 24
    # Bytes only: 8 saves and a guard of the 32k world at 3.35 TB/s.
    w = 32768 * 28 + 4
    assert counts.checksum_least_s(_config("boids_32k"), 8, 1) == pytest.approx(
        (8 * (2 * w + 20) + (w + 24)) / 3.35e12)


def test_least_time_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)
