"""PyTorch port, sessions with the learned input predictor.

A JAX box_game peer and a port one, both on the default predictor (its
hash the handshake digest), speculate with zero desyncs; in an 8-peer
config-5 mesh peer 0's speculation counters are the same for the JAX
package's runner and the port's with the predictor;
``chip_smoke.py``'s phase 14 runs here at a small size.
"""

import chip_smoke
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner
from tests.test_torch_models_p2p import ModelSpecPeer, key_table
from tests.test_torch_p2p_mixed import exchanged, net, play

FPS_DT = 1.0 / 60.0


def test_jax_and_port_box_game_peers_with_the_predictor():
    """Both sessions advertise the default weights' digest; both runners
    seed their trees with them; 300 frames, zero desyncs, equal reports."""
    frames = 300

    def runner(pkg):
        if pkg == "jax":
            return JSpecRunner(jbox.make_schedule(), jbox.make_world(2).commit(),
                               max_prediction=8, num_players=2, input_spec=jbox.INPUT_SPEC,
                               num_branches=16, predictor="default", attest=False)
        return TSpecRunner(tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
                           max_prediction=8, num_players=2, input_spec=tbox.INPUT_SPEC,
                           num_branches=16, predictor="default", device="cpu")

    network = net()
    peers = [ModelSpecPeer(pkg, network, me, runner, predictor="default")
             for me, pkg in enumerate(("jax", "torch"))]
    play(peers, key_table([1, 8, 2, 0], frames + 200), network, frames=frames)
    a, b = peers
    assert min(p.runner.frame for p in peers) >= frames
    assert not a.desyncs() and not b.desyncs()
    assert b.runner._predictor is not None and b.runner.predictor_rank_builds > 0
    assert b.runner.attestation.ok
    for p in peers:
        assert p.runner.spec_hits + p.runner.spec_partial_hits > 0
    shared = exchanged(a, b)
    assert len(shared) >= frames // 8 - 6
    assert [a.reports[f] for f in shared] == [b.reports[f] for f in shared]


# ---------------------------------------------------------------------------
# Phase 14, small
# ---------------------------------------------------------------------------


def test_chip_smoke_phase_14_on_the_cpu():
    """The ranker against its host rollout, then config 5 small with the
    default predictor on every session (a child process, native plane),
    its confirmed streams equal to the predictor-off leg's."""
    frames, branches = 150, 32
    off = chip_smoke.config5_run_leg("native", "cpu", frames, branches)
    out = chip_smoke.predictor_phase((tck.world_checksum,), ts, tck, [off], frames=frames,
                                     branches=branches, device="cpu", slots=8)
    leg = out["leg"]
    assert leg["predictor"] == "default" and off["predictor"] is None
    assert leg["peers"][0]["host_ms"]["predictor_rank"]["calls"] > 0
    assert off["peers"][0]["host_ms"]["predictor_rank"] == {"calls": 0}
    assert leg["attestation"]["real_checked"] == 2 * branches
    assert leg["streams"] == off["streams"]


def test_eight_peer_mesh_counts_equal_jax():
    """Config 5 small: peer 0 speculating with the default predictor,
    either the JAX package's runner or the port's, among seven port peers
    on one seeded loopback: peer 0's speculation counters are the same
    for both packages, so a live hit rate the predictor does not raise
    is the reference's, not the port's."""
    predictor = "default"
    import tests.test_torch_spec_8p as t8
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork as Net

    P, F, B, frames = t8.P, t8.MAXPRED, 16, 120
    table = key_table([1, 8, 2, 0], frames + 200, P)
    counts = []
    for pkg in ("jax", "torch"):
        network = Net(**chip_smoke.CONFIG5_NET)
        peers = [t8.Peer("jax" if me == 0 and pkg == "jax" else "torch", network, me)
                 for me in range(P)]
        if pkg == "jax":
            runner = JSpecRunner(jbox.make_schedule(), jbox.make_world(P).commit(),
                                 max_prediction=F, num_players=P, input_spec=jbox.INPUT_SPEC,
                                 num_branches=B, spec_frames=F, attest=False,
                                 predictor=predictor)
        else:
            runner = TSpecRunner(tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
                                 max_prediction=F, num_players=P, input_spec=tbox.INPUT_SPEC,
                                 num_branches=B, spec_frames=F, attest=False,
                                 predictor=predictor, device="cpu")
        runner.warmup()
        peers[0].runner = runner
        for _ in range(4 * frames):
            network.advance(FPS_DT)
            for peer in peers:
                peer.step(table)
            if min(p.runner.frame for p in peers) >= frames:
                break
        assert min(p.runner.frame for p in peers) >= frames
        counts.append((runner.spec_hits, runner.spec_partial_hits, runner.spec_misses,
                       runner.rollbacks_total, runner.rollback_frames_recovered_total))
    assert counts[0] == counts[1] and counts[0][3] > 0
