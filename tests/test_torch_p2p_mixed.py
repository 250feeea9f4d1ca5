"""A JAX peer and a PyTorch peer play one P2P session.

The JAX package's session, runner and (jitted) box_game step on one side,
the port's on ``device="cpu"`` on the other, over one loopback network: a
socket is any object with ``send_to``/``receive_all``, and the wire is the
same bytes. With seeded random inputs the two steps are bitwise equal, so
600 frames under latency and loss run with zero ``DESYNC_DETECTED``,
rollbacks on both sides and equal checksums at every exchanged frame; a
spectator of either package follows a host of the other.

Held keys drive the cubes into the speed clamp, where the jitted JAX step
contracts ``vx*vx + vy*vy + vz*vz`` into fused multiply-adds and the port
rounds once per operation (as ``step_np`` and the Rust original do). Those
worlds part from frame 105, and both peers must detect it through the
reference's own checksum exchange: the limit is detected, not hidden.
"""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.runner import RollbackRunner as JRunner
from bevy_ggrs_tpu.session import PlayerType as JPlayerType
from bevy_ggrs_tpu.session import SessionBuilder as JBuilder
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.runner import RollbackRunner as TRunner
from bevy_ggrs_tpu_torch.session import EventKind, PredictionThreshold, SessionState
from bevy_ggrs_tpu_torch.session import PlayerType as TPlayerType
from bevy_ggrs_tpu_torch.session import SessionBuilder as TBuilder
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

FPS_DT = 1.0 / 60.0
FRAMES = 600


def random_inputs(seed, frames=FRAMES + 200, players=2):
    return np.random.RandomState(seed).randint(0, 16, size=(frames, players)).astype(np.uint8)


# Random inputs can hold a direction long enough to reach the speed clamp
# too: of seeds 0-5 over 600 frames, the jitted JAX step leaves the port's
# at frame 124 for seed 1 and at frame 63 for seed 2, and never for 0, 3, 4
# and 5 (``test_seeds_below_the_clamp``). The mixed sessions play those.
CLEAN_SEEDS = (0, 3, 4, 5)


def held_key_inputs(frames=FRAMES + 200, players=2):
    """The port's box_game test script: keys held from frame 100 to 250."""
    inputs = random_inputs(0, frames, players)
    inputs[100:250] = inputs[100]
    return inputs


class Peer:
    """One peer of either package: its session, runner and checksum reader."""

    def __init__(self, pkg, net, me, spectators=(), host=None, predictor=None):
        jax_side = pkg == "jax"
        self.pkg = pkg
        builder_cls = JBuilder if jax_side else TBuilder
        player = JPlayerType if jax_side else TPlayerType
        spec = jbox.INPUT_SPEC if jax_side else tbox.INPUT_SPEC
        builder = builder_cls(spec).with_num_players(2).with_max_prediction_window(8)
        if predictor is not None:  # its hash is the handshake's digest
            builder.with_input_predictor(predictor)
        sock = net.socket(("spec", 0) if host is not None else ("peer", me))
        if host is not None:
            self.session = builder.start_spectator_session(host, sock, clock=lambda: net.now)
        else:
            for h in range(2):
                builder.add_player(player.local() if h == me
                                   else player.remote(("peer", h)), h)
            for addr in spectators:
                builder.add_player(player.spectator(addr), 3)
            self.session = builder.start_p2p_session(sock, clock=lambda: net.now)
        if jax_side:
            self.runner = JRunner(jbox.make_schedule(), jbox.make_world(2).commit(),
                                  max_prediction=8, num_players=2, input_spec=spec)
        else:
            self.runner = TRunner(tbox.make_schedule(),
                                  tbox.make_world(2, device="cpu").commit(),
                                  max_prediction=8, num_players=2, input_spec=spec,
                                  device="cpu")
        self.events = []
        # Every checksum the runner reported, the last one per frame (a
        # rollback re-reports the frames it resimulates).
        self.reports = {}
        report = getattr(self.session, "report_checksum", None)
        if report is not None:
            def logged(frame, cs):
                self.reports[frame] = cs
                report(frame, cs)
            self.session.report_checksum = logged

    def checksum(self) -> int:
        if self.pkg == "jax":
            return js.combine64(js.checksum(self.runner.state))
        return ts.combine64(ts.checksum(self.runner.state))

    def step(self, inputs) -> None:
        s = self.session
        s.poll_remote_clients()
        self.events.extend(s.events())
        if s.current_state().name != SessionState.RUNNING.name:  # either package's enum
            return
        for h in s.local_player_handles():
            s.add_local_input(h, inputs[s.current_frame, h])
        try:
            requests = s.advance_frame()
        except Exception as e:  # either package's PredictionThreshold
            if type(e).__name__ in (PredictionThreshold.__name__, "NotSynchronized"):
                return
            raise
        self.runner.handle_requests(requests, s)

    def desyncs(self):
        return [e for e in self.events if e.kind.name == EventKind.DESYNC_DETECTED.name]


def settled(session) -> int:
    pending = session._tracker.first_incorrect
    return session.confirmed_frame() if pending < 0 else min(
        session.confirmed_frame(), pending - 1)


def net():
    return LoopbackNetwork(latency=2 * FPS_DT, jitter=FPS_DT, loss=0.05, seed=5)


def play(peers, inputs, network, frames=FRAMES, spectator=None, until=None):
    """Step every peer once per render frame until each has advanced
    ``frames`` (or ``until()`` holds); the spectator, when given, advances
    on confirmed inputs and its world's checksum is read at every
    exchange frame it reaches."""
    seen = {}
    for _ in range(3 * frames):
        network.advance(FPS_DT)
        for peer in peers:
            peer.step(inputs)
        if spectator is not None:
            spectator.step(inputs)
            f = spectator.runner.frame
            if f % 8 == 0 and f not in seen:
                seen[f] = spectator.checksum()
        if until is not None and until():
            break
        if until is None and min(p.runner.frame for p in peers) >= frames:
            break
    return seen


def exchanged(a, b):
    """The exchange frames both peers reported and have settled."""
    upto = min(settled(a.session), settled(b.session))
    return sorted(f for f in a.reports if f <= upto and f in b.reports)


def first_differing_frames(inputs):
    """Frames where the jitted JAX step and the port's step, run alone on
    the same inputs, give different worlds (the step moves only the
    cubes' translation and velocity)."""
    import jax

    from bevy_ggrs_tpu.schedule import make_inputs
    from bevy_ggrs_tpu_torch.schedule import PlayerInputs

    step_j, step_t = jax.jit(jbox.make_schedule()), tbox.make_schedule()
    jw, tw = jbox.make_world(2).commit(), tbox.make_world(2, device="cpu").commit()
    status = torch.zeros(2, dtype=torch.int32)
    out = []
    for frame, bits in enumerate(inputs):
        jw = step_j(jw, make_inputs(bits))
        tw = step_t(tw, PlayerInputs(torch.from_numpy(bits), status))
        if any((np.asarray(jw.components[n]) != tw.components[n].numpy()).any()
               for n in ("translation", "velocity")):
            out.append(frame)
    return out


def test_seeds_below_the_clamp():
    for seed in CLEAN_SEEDS:
        assert first_differing_frames(random_inputs(seed)[:FRAMES]) == [], seed
    assert first_differing_frames(random_inputs(1)[:FRAMES])[0] == 124
    assert first_differing_frames(held_key_inputs()[:FRAMES])[0] == 105


@pytest.mark.parametrize("jax_handle,seed", [(0, 0), (1, 3)])
def test_jax_and_port_peers_play_600_frames(jax_handle, seed):
    network = net()
    peers = [Peer("jax" if me == jax_handle else "torch", network, me) for me in range(2)]
    play(peers, random_inputs(seed), network)
    a, b = peers
    assert min(p.runner.frame for p in peers) >= FRAMES
    assert not a.desyncs() and not b.desyncs()
    assert a.runner.rollbacks_total > 0 and b.runner.rollbacks_total > 0
    frames = exchanged(a, b)
    assert len(frames) >= FRAMES // 8 - 6
    assert [a.reports[f] for f in frames] == [b.reports[f] for f in frames]
    # Each side compared the other's reports through the exchange.
    assert all(p.session._last_checksum_sent >= FRAMES - 40 for p in peers)


@pytest.mark.parametrize("host_pkg,spec_pkg,seed", [("jax", "torch", 4), ("torch", "jax", 5)])
def test_spectator_of_the_other_package(host_pkg, spec_pkg, seed):
    network = net()
    other = "torch" if host_pkg == "jax" else "jax"
    peers = [Peer(host_pkg, network, 0, spectators=[("spec", 0)]), Peer(other, network, 1)]
    spectator = Peer(spec_pkg, network, None, host=("peer", 0))
    seen = play(peers, random_inputs(seed), network, frames=300, spectator=spectator)
    host = peers[0]
    assert not host.desyncs() and not peers[1].desyncs()
    assert spectator.runner.frame >= 200 and spectator.runner.rollbacks_total == 0
    upto = settled(host.session)
    compared = [f for f in seen if f <= upto and f in host.reports]
    assert len(compared) >= 20
    assert [seen[f] for f in compared] == [host.reports[f] for f in compared]


def test_held_keys_are_detected_as_a_desync_on_both_sides():
    network = net()
    peers = [Peer("jax", network, 0), Peer("torch", network, 1)]
    play(peers, held_key_inputs(), network, frames=400,
         until=lambda: all(p.desyncs() for p in peers))
    jax_peer, torch_peer = peers
    assert jax_peer.desyncs() and torch_peer.desyncs()
    first = min(e.data["frame"] for p in peers for e in p.desyncs())
    # The first differing frame is 105; the exchange compares every 8th.
    assert 104 <= first <= 160
    for p in peers:
        e = p.desyncs()[0]
        assert e.data["local"] != e.data["remote"]
    # Before the clamp engaged the two agreed at every exchange.
    early = [f for f in exchanged(jax_peer, torch_peer) if f < 100]
    assert len(early) >= 8
    assert all(jax_peer.reports[f] == torch_peer.reports[f] for f in early)
