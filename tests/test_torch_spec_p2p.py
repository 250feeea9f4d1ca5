"""PyTorch port, speculation in P2P sessions.

A port peer with ``with_speculation(8)`` and a plain port peer play over a
lossy loopback on the virtual clock: no desync, speculative hits on the
speculating peer, and a confirmed checksum stream bitwise equal to the
same run with speculation off on both peers. A speculating JAX peer and a
speculating port peer play one session on held keys below box_game's
speed clamp with zero desyncs. ``chip_smoke.py``'s phase 11 runs here at
a small size on the CPU.
"""

import numpy as np

import chip_smoke
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner
from tests.test_torch_p2p_mixed import Peer, exchanged, first_differing_frames, net, play

FRAMES = 300


def held_keys(seed=5, frames=FRAMES + 200):
    return chip_smoke.held_key_table(seed, frames, 2)


def test_held_key_script_stays_below_the_clamp():
    """The mixed sessions' script: the jitted JAX step and the port's
    agree at every frame (the check of ``test_seeds_below_the_clamp``)."""
    for seed in (5, 6):
        assert first_differing_frames(held_keys(seed)[:FRAMES + 100]) == [], seed
    table = held_keys()
    runs = np.diff(np.flatnonzero(np.diff(table[:, 0].astype(int)) != 0))
    assert runs.min() >= 2 and runs.max() <= 6


def test_held_key_table_does_not_depend_on_its_length():
    """The card's run and its cpu twin may play different frame counts and
    still press the same keys: a shorter table is a prefix of a longer."""
    long = chip_smoke.held_key_table(5, 700, 3)
    for frames in (1, 64, 364):
        assert (chip_smoke.held_key_table(5, frames, 3) == long[:frames]).all()
    assert not (long[:, 0] == chip_smoke.held_key_table(6, 700, 3)[:, 0]).all()


def spec_or_plain(branches):
    """``make_app`` for ``chip_smoke.P2PRun``: the first peer built
    speculates with ``branches`` branches, the others do not."""
    built = []

    def make(dev, inputs):
        spec = branches if not built else 0
        built.append(spec)
        return chip_smoke.box_app(dev, inputs, players=2, speculation=spec)

    return make


def run_pair(make_app):
    run = chip_smoke.P2PRun(make_app, "cpu", 2, seed=5, frames=FRAMES,
                            inputs=chip_smoke.held_key_runs)
    run.run((tck.world_checksum,), ts, tck)
    return run, run.summary("spec test")  # checks RUNNING, no desync, equal streams


def test_speculating_peer_against_a_plain_peer():
    spec_run, _ = run_pair(spec_or_plain(8))
    plain_run, _ = run_pair(spec_or_plain(0))
    speculating = spec_run.peers[0]["app"].stage.runner
    assert isinstance(speculating, TSpecRunner) and speculating.speculation_enabled
    assert not isinstance(spec_run.peers[1]["app"].stage.runner, TSpecRunner)
    assert speculating.rollbacks_total > 0 and speculating.spec_hits > 0
    assert speculating.rollback_frames_recovered_total > 0
    for a, b in zip(spec_run.peers, plain_run.peers):
        on, off = spec_run.confirmed_stream(a), plain_run.confirmed_stream(b)
        common = sorted(set(on) & set(off))
        assert len(common) >= FRAMES // 10
        assert [on[f] for f in common] == [off[f] for f in common]
    # Every rollback is one ledger outcome: hits + partial + miss + unmatched.
    c = spec_run.peers[0]["counts"]
    assert c["spec_rollouts_total"] > 0
    assert speculating.spec_hits + speculating.spec_partial_hits + speculating.spec_misses \
        <= speculating.rollbacks_total


class SpecPeer(Peer):
    """A peer of either package whose runner speculates: the stage's step
    (flush the deferred reports, poll, then one tick)."""

    def __init__(self, pkg, network, me, branches=16):
        super().__init__(pkg, network, me)
        if pkg == "jax":
            # Attestation is the port's concern here; JAX's compiles the
            # same claim on its own programs in its own suite.
            self.runner = JSpecRunner(jbox.make_schedule(), jbox.make_world(2).commit(),
                                      max_prediction=8, num_players=2,
                                      input_spec=jbox.INPUT_SPEC, num_branches=branches,
                                      attest=False)
        else:
            self.runner = TSpecRunner(tbox.make_schedule(),
                                      tbox.make_world(2, device="cpu").commit(),
                                      max_prediction=8, num_players=2,
                                      input_spec=tbox.INPUT_SPEC, num_branches=branches,
                                      device="cpu")
        self.runner.warmup()

    def step(self, inputs) -> None:
        s = self.session
        self.runner.flush_reports(s)
        s.poll_remote_clients()
        self.events.extend(s.events())
        if s.current_state().name != "RUNNING":
            return
        for h in s.local_player_handles():
            s.add_local_input(h, inputs[s.current_frame, h])
        try:
            requests = s.advance_frame()
        except Exception as e:  # either package's PredictionThreshold
            if type(e).__name__ == "PredictionThreshold":
                return
            raise
        self.runner.tick(requests, s.confirmed_frame(), s)


def test_jax_and_port_peers_both_speculating():
    network = net()
    peers = [SpecPeer("jax", network, 0), SpecPeer("torch", network, 1)]
    play(peers, held_keys(), network, frames=FRAMES)
    a, b = peers
    assert min(p.runner.frame for p in peers) >= FRAMES
    assert not a.desyncs() and not b.desyncs()
    assert b.runner.attestation.ok and b.runner.speculation_enabled
    for p in peers:
        assert p.runner.rollbacks_total > 0
        assert p.runner.spec_hits + p.runner.spec_partial_hits > 0
    frames = exchanged(a, b)
    assert len(frames) >= FRAMES // 8 - 6
    assert [a.reports[f] for f in frames] == [b.reports[f] for f in frames]


def test_chip_smoke_phase_11_on_the_cpu():
    """``chip_smoke.py``'s phase 11 at a small size on the CPU: the
    attestation leaves the live ring unchanged, and two speculating peers
    give the stream of the same run with speculation off (the kernel
    counts are the card's only)."""
    att = chip_smoke.check_attestation(ts, device="cpu", branches=8, spec_frames=4)
    assert att["ok"] and att["scanned_branches"] == 8 and att["real_checked"] >= 8
    out = chip_smoke.spec_phase((tck.world_checksum,), ts, tck, frames=120, branches=8,
                                device="cpu")
    assert set(out) == {"on", "off"}
    for peer in out["on"]["peers"]:
        assert peer["spec_hits"] + peer["spec_partial_hits"] > 0
        assert peer["rollouts"] > 0 and peer["spec_host_dispatch_ms"]["mean"] > 0
        assert peer["recovery_ticks"]["ticks"] > 0
    assert out["on"]["confirmed_checksums"] >= 6
