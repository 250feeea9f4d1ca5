"""``graph_launches_per_rollout``: the ``cudaGraphLaunch`` calls of a traced
window over its rollouts, read from the host's CUDA runtime calls."""

import json

from benchmark import harness
from benchmark.tests.test_harness_files import SPEC


def window(host_names, units, ops=1):
    trace = harness.DeviceTrace(ops=[(0, 1, "kernel")] * ops,
                                host=[(i, i + 1, n) for i, n in enumerate(host_names)],
                                spans=[])
    return harness.Window(harness.Cell.named("boids_1k.spec_512b_8f"), 1.0, units,
                          harness.Spans(), {}, trace)


def test_one_graph_launch_a_rollout_reads_one():
    read = harness.metric_reader("graph_launches_per_rollout")
    calls = ["cudaMemcpyAsync", "cudaGraphLaunch", "cudaEventRecord"] * 3
    assert read(window(calls, 3)) == 1.0


def test_eager_rollouts_read_zero_and_no_trace_reads_nothing():
    read = harness.metric_reader("graph_launches_per_rollout")
    assert read(window(["cudaLaunchKernel", "cudaMemcpyAsync"] * 50, 2)) == 0.0
    assert read(window(["cudaGraphLaunch"], 1, ops=0)) is None
    assert read(window(["cudaGraphLaunch"], 0)) is None


def test_the_metric_is_declared_for_the_spec_cell():
    m = next(x for x in SPEC["per_layer"] if x["name"] == "graph_launches_per_rollout")
    assert m == {"name": "graph_launches_per_rollout", "unit": "launches", "better": "higher",
                 "source": "device_trace",
                 "layer": "speculation (parallel/speculate.py, rollout.py)",
                 "moves": "branch_frames_per_s", "workloads": ["boids_1k.spec_512b_8f"]}
    assert SPEC["per_layer"][-1] == m
    json.dumps(m)
