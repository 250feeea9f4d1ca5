"""PyTorch port, projectiles and neural_bots in P2P sessions, speculating.

A JAX peer and a port peer, both speculating, play 600 frames of
projectiles with FIRE presses and zero desyncs; two speculating
neural_bots port peers keep the stream of speculation off;
``chip_smoke.py``'s phase 13 P2P runs here at a small size.
"""

import numpy as np

import chip_smoke
from bevy_ggrs_tpu.models import projectiles as jp
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import projectiles as tp
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner
from tests.test_torch_p2p_mixed import Peer, exchanged, net, play
from tests.test_torch_spec_p2p import SpecPeer

PLAYERS, CAP = 4, 64


def spec_runner(pkg, branches=8, players=2):
    """A speculating projectiles runner of either package (the JAX one
    unattested: attestation is the port's concern here)."""
    if pkg == "jax":
        return JSpecRunner(jp.make_schedule(), jp.make_world(players, CAP).commit(),
                           max_prediction=8, num_players=players, input_spec=jp.INPUT_SPEC,
                           num_branches=branches, attest=False)
    return TSpecRunner(tp.make_schedule(), tp.make_world(players, CAP, device="cpu").commit(),
                       max_prediction=8, num_players=players, input_spec=tp.INPUT_SPEC,
                       num_branches=branches, device="cpu")


class ModelSpecPeer(SpecPeer):
    """A speculating peer of either package whose runner ``make_runner(pkg)``
    builds (the session is the mixed harness's, bytes being bytes)."""

    def __init__(self, pkg, network, me, make_runner, predictor=None):
        Peer.__init__(self, pkg, network, me, predictor=predictor)
        self.runner = make_runner(pkg)
        self.runner.warmup()


def key_table(keys, frames, players=2):
    """The live zoo's script, ``keys[(frame // 3 + h) % 4]``, as a table."""
    return np.array([[keys[(f // 3 + h) % len(keys)] for h in range(players)]
                     for f in range(frames)], np.uint8)


def test_jax_and_port_peers_both_speculating_with_fire():
    frames = 600
    network = net()
    peers = [ModelSpecPeer("jax", network, 0, spec_runner),
             ModelSpecPeer("torch", network, 1, spec_runner)]
    play(peers, key_table(chip_smoke.PROJECTILE_KEYS, frames + 200), network, frames=frames)
    a, b = peers
    assert min(p.runner.frame for p in peers) >= frames
    assert not a.desyncs() and not b.desyncs()
    assert b.runner.attestation.ok and b.runner.speculation_enabled
    for p in peers:
        assert p.runner.rollbacks_total > 0
        assert p.runner.spec_hits + p.runner.spec_partial_hits > 0
    shared = exchanged(a, b)
    assert len(shared) >= frames // 8 - 6
    assert [a.reports[f] for f in shared] == [b.reports[f] for f in shared]
    minted = int(b.runner.state.resources["next_rollback_id"]) - ts.DEVICE_ID_BASE
    assert minted > 50


def test_chip_smoke_phase_13_on_the_cpu():
    """Phase 13's P2P runs, small: 4 speculating projectiles peers and 2
    neural_bots-64 peers at 8 branches, each against speculation off
    (attestation at full coverage, no desync, equal streams, hits)."""
    out = chip_smoke.models_phase((tck.world_checksum,), ts, tck, integrity, device="cpu",
                                  spec_frames=100, bots=64, branches=(8, 8))
    for key, players in (("projectiles_p2p", PLAYERS), ("neural_bots_p2p", 2)):
        on = out[key]["on"]
        assert len(on["peers"]) == players
        assert on["attestation"] == {"ok": True, "real_checked": 16, "scanned_branches": 8,
                                     "frames": 8}
        assert all(p["rollouts"] > 0 and p["spec_hits"] + p["spec_partial_hits"] > 0
                   for p in on["peers"])
        assert on["confirmed_checksums"] >= 10


def test_two_speculating_port_peers_equal_speculation_off():
    def make(spec):
        return lambda dev, inputs: chip_smoke.model_app(dev, "neural_bots", inputs,
                                                        speculation=spec, bots=64)

    out = chip_smoke.spec_p2p((tck.world_checksum,), ts, tck, "spec neural_bots", make,
                              2, 120, 8, chip_smoke.key_script(chip_smoke.BOT_KEYS),
                              "cpu", attestation=True)
    on = out["on"]
    assert on["attestation"]["ok"] and on["attestation"]["real_checked"] == 16
    assert all(p["spec_hits"] + p["spec_partial_hits"] > 0 for p in on["peers"])
    assert on["confirmed_checksums"] >= 10


def test_chip_smoke_phase_13_twins_in_a_child_process():
    """Phase 13's cpu twins as the card's run plays them, small: the
    SyncTests' and a neural_bots P2P run's in the child process
    (``ModelTwins``), each SyncTest stream the one the same job gives in
    this process."""
    jobs = [j for j in chip_smoke.model_twin_jobs(sync_frames=10, wide_frames=4, bots=16,
                                                  branches=(4, 4), p2p_frames=(24, 24))
            if j["label"] != "spec projectiles"]
    twins = chip_smoke.ModelTwins(jobs, threads=1)
    try:
        got = {j["label"]: twins.result(j["label"]) for j in jobs}
    except BaseException:
        twins.close(ok=False)
        raise
    twins.close()
    assert list(got) == ["projectiles_dense", "neural_bots_H32", "neural_bots_H256",
                         "neural_bots_H512", "spec neural_bots"]
    for job in jobs[:2]:
        here = chip_smoke.model_twin((tck.world_checksum,), ts, tck, job)
        assert here["stream"] == got[job["label"]]["stream"] and len(here["stream"]) >= 10
    bots = twins.p2p("spec neural_bots")
    assert bots["frames"] == 24 and len(bots["streams"]) == 2
    assert all(st and all(isinstance(f, int) for f in st) for st in bots["streams"])
