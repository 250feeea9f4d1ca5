"""The SyncTest cell's host split on the CPU at a small size: the program's
spans read by ``step_host_ms``, ``save_host_ms``, ``guard_wait_ms``,
``burst_setup_ms`` and ``runner_self_ms`` make up ``runner_host_ms``."""

import pytest
import torch

from benchmark import harness

CELL = "boids_32k.synctest_cd7"
PARTS = ("step_host_ms", "save_host_ms", "guard_wait_ms", "burst_setup_ms", "runner_self_ms")


def test_the_host_split_sums_to_the_runners_time():
    line = harness.run_cell(CELL, 2**33 + 5, 0.15, True, torch.device("cpu"),
                            overrides={"config": {"num_boids": 128},
                                       "traffic": {"warmup_ticks": 10}})
    assert line["correct"], line["checks"]
    got = {k: line["metrics"][k]["value"] for k in PARTS + ("runner_host_ms",)}
    assert all(v is not None for v in got.values())
    # A negative self time: a span counted twice, or outside handle_requests.
    assert got["runner_self_ms"] >= 0
    assert sum(got[k] for k in PARTS) == pytest.approx(got["runner_host_ms"], rel=0.01)
    assert all(got[k] > 0 for k in ("step_host_ms", "save_host_ms", "guard_wait_ms",
                                    "burst_setup_ms"))
