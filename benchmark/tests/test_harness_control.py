"""The control must come out not correct: the reference in TF32, put in the
program's place at every step, against each cell's limits. On the CPU at a
size a test run holds; on the card at the cell's own size (marked ``card``,
``python -m pytest benchmark/tests -m card`` there)."""

import json

import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
CELLS = ["boids_32k.synctest_cd7", "boids_1k.spec_512b_8f"]
# Sizes where the flock is as dense as the cell's own, so the control's
# gaps are of the same order.
SMALL = {
    "boids_32k.synctest_cd7": {"config": {"num_boids": 1024}, "traffic": {"warmup_ticks": 9}},
    "boids_1k.spec_512b_8f": {"config": {"num_boids": 1024},
                              "traffic": {"branches": 3, "anchor_frames": 3, "tree_pool": 2,
                                          "warmup_rollouts": 1}},
}


def _failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    """Both drivers at 1,024 boids, the size and density of ``boids_1k``,
    held to that cell's limits."""
    line = harness.run_cell(cell, 2**31 + 99, 0.05, False, CPU, overrides=SMALL[cell],
                            control=True)
    limits = harness.Cell.named("boids_1k.spec_512b_8f").limits
    program = {k: {"value": c["value"], "limit": limits[k]} for k, c in line["checks"].items()}
    control = {k: {"value": v, "limit": limits[k]} for k, v in line["notes"]["control"].items()}
    assert line["failed"] == 0 and _failed(program) == [], program
    assert _failed(control) == ["vel_gap_p90", "vel_gap_rounding_max"], control


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell, card, tmp_path):
    from benchmark import calibrate

    out = tmp_path / "cal.json"
    assert calibrate.main(["--workload", cell, "--seconds", "2", "--seeds", "5", "6", "7",
                           "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    limits = harness.Cell.named(cell).limits
    for run in got["runs"]:
        assert run["correct"]
        assert run["control"]["vel_gap_p90"] > limits["vel_gap_p90"]
        assert run["control"]["vel_gap_rounding_max"] > limits["vel_gap_rounding_max"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_one_wrong_tile_fails_at_the_cells_own_size(cell, card, tmp_path):
    from benchmark import calibrate

    out = tmp_path / "tile.json"
    assert calibrate.main(["--workload", cell, "--seconds", "2", "--seeds", "5", "6", "7",
                           "--fault", "one_tile", "--out", str(out)]) == 0
    for run in json.loads(out.read_text())["runs"]:
        assert not run["correct"], run["program"]
