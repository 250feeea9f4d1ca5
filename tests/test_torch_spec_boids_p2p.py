"""PyTorch port, boids under speculation in P2P sessions.

Two port peers play boids-64 with ``kernel="mxu"`` over a lossy loopback
on the virtual clock, both ``with_speculation(8)``: no desync, speculative
hits on both peers, and a confirmed checksum stream bitwise equal to the
same run with speculation off. Counted through the plain version (the
kernel's stand-in on the CPU), the force kernel runs once per frame
advanced serially and once per speculative frame for all branches, as
``chip_smoke.py`` checks with the kernel's own counter on the card. The
boids attestations and P2P runs of ``chip_smoke.py``'s phase 11 run here
at a small size.
"""

import chip_smoke
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

FRAMES, N, BRANCHES = 120, 64, 8
KERNELS = (tck.world_checksum,)


def boids_run(branches, spy=None):
    schedule = tboids.make_schedule(kernel="mxu")
    run = chip_smoke.P2PRun(
        lambda dev, inputs: chip_smoke.boids_app(N, dev, schedule, inputs, speculation=branches),
        "cpu", 2, seed=5, frames=FRAMES, inputs=chip_smoke.held_key_runs)
    if spy is not None:
        spy.clear()  # the apps' warmups (attestation) are not the session's
    run.run(KERNELS, ts, tck)
    return run, run.summary(f"spec boids-{N} B={branches}")  # RUNNING, no desync, equal streams


def test_speculating_boids_peers_against_speculation_off(monkeypatch):
    calls = []
    plain = tpw.pairwise_force_rows_mxu2_plain

    def counted(row_pos, *args, **params):
        calls.append(row_pos.dim())
        return plain(row_pos, *args, **params)

    monkeypatch.setattr(tpw, "pairwise_force_rows_mxu2_plain", counted)
    on_run, on = boids_run(BRANCHES, calls)
    on_calls = list(calls)
    off_run, _ = boids_run(0, calls)
    for peer in on_run.peers:
        runner = peer["app"].stage.runner
        assert isinstance(runner, SpeculativeRollbackRunner) and runner.speculation_enabled
        assert runner.attestation.ok and runner.attestation.real_checked == 2 * BRANCHES
        assert runner.rollbacks_total > 0 and runner.spec_hits > 0
    for a, b in zip(on_run.peers, off_run.peers):
        on_s, off_s = on_run.confirmed_stream(a), off_run.confirmed_stream(b)
        common = sorted(set(on_s) & set(off_s))
        assert len(common) >= FRAMES // 10
        assert [on_s[f] for f in common] == [off_s[f] for f in common]
    # Batched calls: F a rollout; single calls: the advances no hit copied.
    spec_frames = on_run.peers[0]["app"].stage.runner.spec_frames
    rollouts = sum(p["counts"]["spec_rollouts_total"] for p in on_run.peers)
    serial = sum(p["log"]["advances"] - p["counts"]["rollback_frames_recovered_total"]
                 for p in on_run.peers)
    assert rollouts > 0 and serial > 0
    assert on_calls.count(3) == spec_frames * rollouts
    assert on_calls.count(2) == serial
    assert calls.count(3) == 0  # speculation off: serial steps only
    assert calls.count(2) == sum(p["log"]["advances"] for p in off_run.peers)
    assert on["confirmed_checksums"] >= 6


def test_chip_smoke_boids_attestations_on_the_cpu():
    """Phase 11's boids attestations, small: every path attests ``ok``
    with every branch of both tensors replayed."""
    cases = (("mxu-64", "mxu", "dense", 64, 4, "pairwise_force_rows_mxu2"),
             ("pallas-64", "pallas", "dense", 64, 4, "pairwise_force_rows"),
             ("mxu-grid-256", "mxu", "grid", 256, 2, "cell_slot_forces"))
    out = chip_smoke.boids_attestations(KERNELS, (), ts, tboids, device="cpu", cases=cases,
                                        spec_frames=3)
    assert set(out) == {c[0] for c in cases}
    for (label, *_, branches, _), att in zip(cases, out.values()):
        assert att["ok"] and att["real_checked"] == 2 * branches, label


def test_chip_smoke_boids_spec_phase_on_the_cpu():
    """Phase 11's boids P2P runs at boids-64 and 8 branches on the CPU."""
    out = chip_smoke.boids_spec_phase(KERNELS, (), ts, tck, tpw, frames=FRAMES,
                                      branches=BRANCHES, n=N, device="cpu")
    assert set(out) == {"on", "off"}
    for peer in out["on"]["peers"]:
        assert peer["spec_hits"] + peer["spec_partial_hits"] > 0
        assert peer["rollouts"] > 0 and peer["spec_host_dispatch_ms"]["mean"] > 0
    assert out["on"]["confirmed_checksums"] >= 6
