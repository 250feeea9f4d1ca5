"""The harness's whole control flow on the CPU at a small size, through
``harness.run_cell`` (the path only these tests take: ``run.py`` itself
refuses to run without a card), and the same runs with the timed path
broken underneath, which the comparison must catch."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SMALL = {
    "boids_32k.synctest_cd7": {"config": {"num_boids": 128}, "traffic": {"warmup_ticks": 10}},
    "boids_1k.spec_512b_8f": {"config": {"num_boids": 96},
                              "traffic": {"branches": 6, "anchor_frames": 4, "tree_pool": 3}},
}
CELLS = sorted(SMALL)


def _run(cell, seed=2**31 + 7, seconds=0.4, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, CPU, overrides=SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.Cell.named(cell).end_to_end}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert line["notes"]["steps_compared"] > 0 and line["notes"]["rows_hashed"] > 0
    json.dumps(line)


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 3, 2**40])
def test_the_same_seed_gives_the_same_inputs(seed):
    from benchmark.reference import compare

    cfg = {"num_boids": 64, "players": 2}
    a, b = (harness.world_to_host(harness.make_flock(cfg, seed, CPU)) for _ in range(2))
    c = harness.world_to_host(harness.make_flock(cfg, seed + 1, CPU))
    assert compare.count_unequal(a, b) == 0 and compare.count_unequal(a, c) > 0
    x, y = (harness.uniform_bitmask(seed, 50, 2, 4) for _ in range(2))
    assert (x == y).all() and x.dtype.name == "uint8" and x.max() < 16
    assert (x != harness.uniform_bitmask(seed + 1, 50, 2, 4)).any()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_host_layers(cell):
    line = _run(cell, seconds=0.15, trace=True)
    assert line["correct"]
    host = {m["name"] for m in harness.Cell.named(cell).per_layer
            if m["source"] in ("host_clock", "program_span")}
    assert host and host <= set(line["metrics"])
    # No card: nothing of the device is reported, never a 0 in its place.
    assert not any("roofline" in k or "idle" in k for k in line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.NAMES))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    with faults.planted(fault):
        line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_wrong_tile_is_caught_by_the_widest_gap(cell):
    """A tile of rows under a tenth of the boids slips under the 90th
    percentile; the widest gap in rounding units holds every boid."""
    from benchmark.reference import compare

    n = SMALL[cell]["config"]["num_boids"]
    rows = faults.tile_rows(n)
    assert 0 < rows.stop - rows.start < n / 10
    with faults.planted("one_tile"):
        line = _run(cell)
    checks = line["checks"]
    assert checks["vel_gap_p90"]["value"] <= checks["vel_gap_p90"]["limit"]
    assert checks["vel_gap_rounding_max"]["value"] > checks["vel_gap_rounding_max"]["limit"]
    assert set(checks) == set(compare.NUMBERS)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_lanes_are_not_correct(cell, monkeypatch):
    """The checksum altered where it is produced: every save's lanes, in
    the ring and in the burst's stream, one bit off."""
    from bevy_ggrs_tpu_torch import rollout

    real = rollout.ring_save

    def save(ring, state, frame, out=None):
        ring, lanes = real(ring, state, frame, out=out)
        row = (Ellipsis, int(frame) % ring.depth, 0)
        ring.checksums[row] ^= 1
        if out is not None:
            out[..., 0] ^= 1
        return ring, lanes

    monkeypatch.setattr(rollout, "ring_save", save)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["hash_mismatches"]["value"] > 0


def _run_py(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "boids_32k.synctest_cd7", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_run_py_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_py_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
