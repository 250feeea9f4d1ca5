"""PyTorch port, ``bench_torch.py`` on the CPU (``--device cpu``).

The rollout configs' executors give the JAX package's
``SpeculativeExecutor`` checksums bitwise on the same numpy branch bits (the
port draws its bits from a ``torch.Generator``, JAX from
``jax.random``: the parity is held on one bits array); a recovery config's
serial resimulation and speculative commit reach the same state bitwise;
rows of a rollout, a batched-serving and a live loopback config carry the
columns ``tools/bench_gate.py::check_row`` demands and pass it, and so does
``relay_fanout_64spec`` at 4 spectators; the six host-tier configs are in
the matrix and only sharding's two wait; the bench writes its own detail
file, never ``BENCH_DETAIL.json``.

About 35 s on one core.
"""

import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.parallel.speculate import SpeculativeExecutor as JSpecExecutor
from bevy_ggrs_tpu.state import checksum as jchecksum
from bevy_ggrs_tpu.state import combine64 as jcombine64
from bevy_ggrs_tpu_torch import state as ts
from tools.bench_gate import check_row

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_the_cpu():
    bench_torch.set_device("cpu")
    yield


def gate(row: dict) -> dict:
    """``check_row`` without a baseline: the schema and health checks."""
    verdict = check_row(row, None, rel_tol=0.35, abs_tol=0.05)
    assert verdict["status"] == "skipped", verdict
    assert verdict["detail"] == "no committed baseline row"
    return verdict


@pytest.mark.parametrize("players,frames,branches", [(2, 4, 1), (2, 8, 16)])
def test_rollout_checksums_are_jax_on_the_same_bits(players, frames, branches):
    """Config 1's executor and the headline's at B = 16."""
    ex, state, bits = bench_torch._box_game_case(players, frames, branches)
    assert bits.shape == (branches, frames, players) and bits.dtype == np.uint8
    assert (bits[0] == 0).all()  # branch 0 repeats the last input
    port = ex.run(state, 0, bits)
    jex = JSpecExecutor(jbox.make_schedule(), branches, frames)
    ref = jex.run(jbox.make_world(players).commit(), 0, jnp.asarray(bits))
    got = port.checksums.numpy().astype(np.int64) & 0xFFFFFFFF
    assert np.array_equal(got, np.asarray(ref.checksums).astype(np.int64))
    for b in range(branches):  # the final states too
        jstate = jax.tree_util.tree_map(lambda x: x[b], ref.states)
        assert ts.combine64(ts.checksum(ts.select_branch(port.states, b))) == \
            jcombine64(jchecksum(jstate))


def test_recovery_serial_and_spec_reach_the_same_state():
    serial, spec = bench_torch.recovery_pair("box_game", 8, 32)
    ring_a, state_a, cs_a = serial()
    lanes_a = ring_a.checksums.clone()
    ring_b, state_b, cs_b = spec()
    leaves_a, leaves_b = (ts.tree_leaves(ts.to_host(s)) for s in (state_a, state_b))
    assert len(leaves_a) == len(leaves_b) > 0
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ts.combine64(ts.checksum(state_a)) == ts.combine64(ts.checksum(state_b))
    assert torch.equal(lanes_a, ring_b.checksums)
    assert torch.equal(cs_a[:8].to(torch.int64) & 0xFFFFFFFF, cs_b[:8] & 0xFFFFFFFF)


def test_a_rollout_row_passes_the_gate():
    row = bench_torch.run_config("box_game_2p_4f_x_1b")
    assert row["platform"] == "torch-cpu" and row["card"] == "cpu"
    assert row["value"] == row["latency_ms"] and row["value_source"] == "wall (cpu)"
    assert row["within_budget_device"] is None and "mfu_pct" not in row
    for key in ("metric", "unit", "vs_baseline", "frames", "branches", "sustained_ms",
                "rollback_frames_per_sec", "host_device_rtt_ms"):
        assert key in row
    gate(row)


def test_serve_and_live_rows_pass_the_gate(monkeypatch):
    monkeypatch.setenv("GGRS_SERVE_TICKS", "18")
    monkeypatch.setenv("GGRS_LIVE_FRAMES", "120")
    monkeypatch.setenv("GGRS_LIVE_PACED", "0")
    serve = bench_torch.run_config("serve_batched_box_game_S16")
    assert serve["desyncs"] == 0 and serve["churn_recompiles"] == 0
    assert serve["attr_verdict"] and serve["parity_slots_checked"] == 3
    live = bench_torch.run_config("live_box_game_loopback_spec_on")
    assert live["desync_events"] == 0 and live["rollbacks_total"] > 0
    assert live["spec_full_hit_rate"] > 0 and live["spec_policy"] == "current"
    for row in (serve, live):
        assert row["platform"] == "torch-cpu"
        json.dumps(row)  # a row is plain JSON
        gate(row)


def test_the_bench_never_writes_the_jax_detail_file(tmp_path):
    jax_detail = ROOT / "BENCH_DETAIL.json"
    before = hashlib.sha256(jax_detail.read_bytes()).hexdigest()
    out = tmp_path / "detail.json"
    rows = bench_torch.run_matrix(["box_game_2p_4f_x_1b"], out=str(out))
    assert [r["metric"] for r in rows] == ["box_game_2p_4f_x_1b"]
    assert json.loads(out.read_text())["configs"][0]["platform"] == "torch-cpu"
    assert hashlib.sha256(jax_detail.read_bytes()).hexdigest() == before
    assert bench_torch.DETAIL_FILE == "BENCH_TORCH_DETAIL.json"
    assert not (tmp_path / "BENCH_DETAIL.json").exists()


def test_waiting_configs_say_what_they_wait_for():
    """Nothing waits any more: the two configs that waited for the
    sharding slice are configs, and an unknown name is a KeyError."""
    names = bench_torch.all_configs()
    assert len(names) == len(set(names)) >= 42
    for name in ("boids_1k_8f_x_128b_xla", "live_multihost_2proc_spmd"):
        assert name in names
    assert bench_torch.WAITING == {}
    with pytest.raises(KeyError, match="unknown config"):
        bench_torch.run_config("no_such_config")


HOST_TIER_CONFIGS = ("relay_fanout_64spec", "relay_tree_1k", "fleet_migrate_S64",
                     "front_door_S256", "fleet_autoscale_N3", "fleet_autoscale_N3_chaos")


@pytest.mark.parametrize("name", HOST_TIER_CONFIGS)
def test_host_tier_configs_are_in_the_matrix(name):
    assert name in bench_torch.all_configs()


def test_relay_fanout_row_passes_the_gate(monkeypatch):
    """``relay_fanout_64spec`` at 4 spectators and 330 frames (180 of
    baseline pumps, 120 of settling, then lag samples)."""
    monkeypatch.setenv("GGRS_RELAY_SPECTATORS", "4")
    monkeypatch.setenv("GGRS_RELAY_FRAMES", "330")
    row = bench_torch.run_config("relay_fanout_64spec")
    assert row["platform"] == "torch-cpu" and row["spectators"] == 4
    assert row["published_frames"] > 200 and row["fanout_shed"] == 0
    assert row["spectator_lag_p99_frames"] <= 2.0
    json.dumps(row)
    gate(row)
