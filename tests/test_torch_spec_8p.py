"""PyTorch port, BASELINE config 5 at a small size on the CPU: 8 box_game
peers and a spectator of peer 0, ``max_prediction`` 12, peer 0 speculating
64 branches x 12 frames (the card runs 1,024), over ``chip_smoke.py``'s
phase-12 loopback (2 frames' latency, 1 frame's jitter, 2 % loss, seed 7)
on the JAX bench's key script.

The run on the native data plane and the run under ``GGRS_NO_NATIVE=1``
are indistinguishable: equal speculation counters on peer 0 and equal
confirmed checksum streams on every peer and on the spectator (the
sessions run on the network's virtual clock). A JAX speculating peer 0
plays the same session with seven port peers and a port spectator without
a desync.
``chip_smoke.py``'s phase 12 runs here too, its legs in one child process.
"""

import numpy as np

import chip_smoke
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.session import PlayerType as JPlayerType
from bevy_ggrs_tpu.session import SessionBuilder as JBuilder
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import spec_runner as tsr
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.runner import RollbackRunner as TRunner
from bevy_ggrs_tpu_torch.session import PlayerType as TPlayerType
from bevy_ggrs_tpu_torch.session import SessionBuilder as TBuilder
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

P = chip_smoke.CONFIG5_PLAYERS
MAXPRED = chip_smoke.CONFIG5_MAX_PREDICTION
FRAMES = 150
BRANCHES = 64


def leg(monkeypatch, python: bool) -> dict:
    """One run of phase 12's session in this process, native or under the
    switch; each pays its own attestation (the verdict is memoized)."""
    with monkeypatch.context() as m:
        if python:
            m.setenv("GGRS_NO_NATIVE", "1")
        m.setattr(tsr, "_ATTEST_MEMO", {})
        return chip_smoke.config5_leg((tck.world_checksum,), ts, tck, "cpu", FRAMES, BRANCHES)


def test_eight_peers_native_and_switch_agree(monkeypatch):
    native = leg(monkeypatch, python=False)
    python = leg(monkeypatch, python=True)
    assert (native["plane"], python["plane"]) == ("native", "python")
    assert native["counters"] == python["counters"]
    assert native["streams"] == python["streams"]
    assert native["spectator_stream"] == python["spectator_stream"]
    assert len(native["streams"]) == P and all(len(s) >= 10 for s in native["streams"])
    assert len(native["spectator_stream"]) >= 10
    c = native["counters"]
    assert c["rollbacks_total"] > 0 and c["spec_hits"] + c["spec_partial_hits"] > 0
    host = native["peers"][0]["host_ms"]
    # The native builder reads peer 0's queues in-process: no known-inputs
    # query; the Python leg queries every tree it builds.
    assert host["known_inputs_query"]["calls"] == 0
    assert host["structured_bits_build"]["calls"] > 0
    assert python["peers"][0]["host_ms"]["known_inputs_query"]["calls"] == \
        python["peers"][0]["host_ms"]["structured_bits_build"]["calls"]
    assert native["spectator"]["lag_frames"]["max"] >= native["spectator"]["lag_frames"]["mean"]


class Peer:
    """One peer of either package, on a shared loopback: its session,
    runner, events and the checksums it reported."""

    def __init__(self, pkg, network, me, spectator=None):
        jax_side = pkg == "jax"
        builder = ((JBuilder if jax_side else TBuilder)(
            jbox.INPUT_SPEC if jax_side else tbox.INPUT_SPEC)
            .with_num_players(P).with_max_prediction_window(MAXPRED))
        player = JPlayerType if jax_side else TPlayerType
        if me is None:  # a port spectator of peer 0
            self.session = builder.start_spectator_session(
                ("peer", 0), network.socket(spectator), clock=lambda: network.now)
        else:
            for h in range(P):
                builder.add_player(player.local() if h == me else player.remote(("peer", h)),
                                   h)
            if spectator is not None:
                builder.add_player(player.spectator(spectator), P)
            self.session = builder.start_p2p_session(network.socket(("peer", me)),
                                                     clock=lambda: network.now)
        if jax_side:
            # Attestation is the port's concern here; the JAX suite attests
            # its own programs.
            self.runner = JSpecRunner(jbox.make_schedule(), jbox.make_world(P).commit(),
                                      max_prediction=MAXPRED, num_players=P,
                                      input_spec=jbox.INPUT_SPEC, num_branches=BRANCHES,
                                      spec_frames=MAXPRED, attest=False)
        else:
            self.runner = TRunner(tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
                                  max_prediction=MAXPRED, num_players=P,
                                  input_spec=tbox.INPUT_SPEC, device="cpu")
        self.runner.warmup()
        self.events, self.reports = [], {}
        report = getattr(self.session, "report_checksum", None)

        def logged(frame, cs):
            self.reports[frame] = cs
            report(frame, cs)

        if report is not None:
            self.session.report_checksum = logged

    def step(self, inputs) -> None:
        s = self.session
        flush = getattr(self.runner, "flush_reports", None)
        if flush is not None:
            flush(s)
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
        tick = getattr(self.runner, "tick", None)
        if tick is not None:
            tick(requests, s.confirmed_frame(), s)
        else:
            self.runner.handle_requests(requests, s)


def test_jax_speculating_peer_with_seven_port_peers():
    keys = [jbox.INPUT_UP, jbox.INPUT_RIGHT, jbox.INPUT_DOWN, 0]
    inputs = np.array([[keys[(f // 3 + h) % 4] for h in range(P)]
                       for f in range(FRAMES + 200)], np.uint8)
    network = LoopbackNetwork(**chip_smoke.CONFIG5_NET)
    spec_addr = ("spec", 0)
    peers = [Peer("jax" if me == 0 else "torch", network, me,
                  spectator=spec_addr if me == 0 else None) for me in range(P)]
    spectator = Peer("torch", network, None, spectator=spec_addr)
    seen = {}
    for _ in range(4 * FRAMES):
        network.advance(1 / 60)
        for peer in peers + [spectator]:
            peer.step(inputs)
        f = spectator.runner.frame
        if f % 8 == 0 and f not in seen:
            seen[f] = ts.combine64(ts.checksum(spectator.runner.state))
        if min(p.runner.frame for p in peers) >= FRAMES:
            break
    assert min(p.runner.frame for p in peers) >= FRAMES
    for p in peers:
        assert not [e for e in p.events if e.kind.name == "DESYNC_DETECTED"]
    # Which peers run ahead, and roll back, follows the process's string
    # hashing (the sessions' endpoint order); the mesh as a whole does.
    assert sum(p.runner.rollbacks_total for p in peers[1:]) > 0
    jax_runner = peers[0].runner
    assert jax_runner.spec_hits + jax_runner.spec_partial_hits > 0

    def settled(s):
        pending = s._tracker.first_incorrect
        return s.confirmed_frame() if pending < 0 else min(s.confirmed_frame(), pending - 1)

    upto = min(settled(p.session) for p in peers)
    frames = sorted(f for f in peers[0].reports if f <= upto)
    assert len(frames) >= FRAMES // 8 - 6
    for p in peers[1:]:
        assert [p.reports[f] for f in frames] == [peers[0].reports[f] for f in frames]
    # The port spectator of the JAX host: the host's checksum at every
    # exchange frame it reached.
    followed = sorted(f for f in seen if f in frames)
    assert len(followed) >= 5 and spectator.runner.rollbacks_total == 0
    assert [seen[f] for f in followed] == [peers[0].reports[f] for f in followed]


def test_chip_smoke_phase_12_on_the_cpu():
    """``chip_smoke.py``'s phase 12 at the small size on the CPU, with two
    of the card's four legs: native and Python (``GGRS_NO_NATIVE=1``),
    in turns in one child process, their counters and streams equal, the
    second leg reusing the first one's attestation (the batched save and
    the kernel counts are the card's only)."""
    out = chip_smoke.config5_phase((tck.world_checksum,), ts, tck, frames=FRAMES,
                                   branches=BRANCHES, device="cpu", planes=("native", "python"))
    assert [leg["plane"] for leg in out["legs"]] == ["native", "python"]
    native = out["legs"][0]
    assert native["attestation"]["real_checked"] == 2 * BRANCHES
    assert native["attestation"]["memo_hits"] == 0
    assert out["legs"][1]["attestation"]["memo_hits"] == 1
    assert native["attestation"]["frames"] == MAXPRED
    assert len(native["peers"]) == P and all(p["frames"] >= FRAMES for p in native["peers"])
    assert native["spectator"]["compared_with_host"] >= 10
