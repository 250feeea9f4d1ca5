"""PyTorch port, sessions with the learned input predictor.

A JAX box_game peer and a port one, both on the default predictor (its
hash the handshake digest), speculate with zero desyncs; in an 8-peer
config-5 mesh peer 0's speculation counters are the same for the JAX
package's runner and the port's with the predictor;
``chip_smoke.py``'s phase 14 runs here at a small size.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

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
ROOT = pathlib.Path(__file__).resolve().parent.parent


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
    off = chip_smoke.config5_run_legs(("native",), "cpu", frames, branches)[0]
    out = chip_smoke.predictor_phase((tck.world_checksum,), ts, tck, [off], frames=frames,
                                     branches=branches, device="cpu", slots=8)
    leg = out["leg"]
    assert leg["predictor"] == "default" and off["predictor"] is None
    assert leg["peers"][0]["host_ms"]["predictor_rank"]["calls"] > 0
    assert off["peers"][0]["host_ms"]["predictor_rank"] == {"calls": 0}
    assert leg["attestation"]["real_checked"] == 2 * branches
    assert leg["streams"] == off["streams"]


# Each leg of the mesh test runs in a child process under this string-hash
# seed: the sessions build their endpoints in ``set`` order of address
# tuples, so their timing, and whether peer 0 rolls back at all, follows
# str hashing (under seed 4 neither leg rolls back in 120 frames).
MESH_HASH_SEED = "0"
MESH_FRAMES = 120


def mesh_counts(pkg: str, branches: int, frames: int = MESH_FRAMES) -> tuple:
    """Config 5 small in this process: peer 0 speculating ``branches`` x
    12 with the default predictor, the JAX package's runner (``pkg ==
    "jax"``) or the port's, among seven port peers on one seeded loopback.
    Returns peer 0's speculation counters."""
    predictor = "default"
    import tests.test_torch_spec_8p as t8
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork as Net

    P, F, B = t8.P, t8.MAXPRED, branches
    table = key_table([1, 8, 2, 0], frames + 200, P)
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
    return (runner.spec_hits, runner.spec_partial_hits, runner.spec_misses,
            runner.rollbacks_total, runner.rollback_frames_recovered_total)


def mesh_leg(pkg: str, branches: int) -> subprocess.Popen:
    """Start :func:`mesh_counts` in a child process under
    ``MESH_HASH_SEED``; its counters are the last line of its output."""
    env = dict(os.environ, PYTHONHASHSEED=MESH_HASH_SEED)
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import tests.conftest; "
            "from tests.test_torch_predictor_sessions import mesh_counts; "
            "print(json.dumps(mesh_counts(sys.argv[2], int(sys.argv[3]))))")
    return subprocess.Popen([sys.executable, "-c", code, str(ROOT), pkg, str(branches)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("branches", [16, 1024])
def test_eight_peer_mesh_counts_equal_jax(branches):
    """Config 5 small: peer 0 speculating with the default predictor,
    either the JAX package's runner or the port's, among seven port peers
    on one seeded loopback: peer 0's speculation counters are the same
    for both packages, so a live hit rate the predictor does not raise
    is the reference's, not the port's. Each leg runs in a child process
    under one pinned ``PYTHONHASHSEED``, so the endpoint order, and with
    it the count of rollbacks, does not depend on the test's own process."""
    legs = [mesh_leg(pkg, branches) for pkg in ("jax", "torch")]
    counts = []
    for leg in legs:
        out, err = leg.communicate(timeout=600)
        assert leg.returncode == 0, err[-4000:]
        counts.append(tuple(json.loads(out.strip().splitlines()[-1])))
    assert counts[0] == counts[1] and counts[0][3] > 0
