"""PyTorch port, the relay tier: ``relay/client.py``, ``server.py`` and
``stream.py``.

Every scenario runs in both packages on the same scripted inputs, and the
port's results are held equal to JAX's:

- the publisher's keyframe and delta datagrams are the same bytes, and a
  spectator of either package replaying them reconstructs every frame
  bitwise the publisher's ring rows and a serial replay;
- two peers play entirely through a relay, and through a relay's death
  and their failover to a standby, with the same settled checksums;
- a spectator rides the degradation ladder (keyframe-only, shed, cursor
  resume) through the same frames and ends on the same bytes;
- a publisher re-pointed after a migration forces a keyframe and keeps
  its delta chain.
"""

import importlib
import types

import numpy as np
import pytest

from bevy_ggrs_tpu_torch import relay as trelay
from bevy_ggrs_tpu_torch.relay.stream import StatePublisher
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
from tests.test_torch_p2p import FPS_DT, drive, make_group, scripted_input

MAX_PRED = 8


def ns(pkg):
    """The names a relay harness needs, from ``pkg``'s package."""
    root = "bevy_ggrs_tpu_torch" if pkg == "torch" else "bevy_ggrs_tpu"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    relay, session, chaos = mod("relay"), mod("session"), mod("chaos")
    box = mod("models.box_game")
    dev = {"device": "cpu"} if pkg == "torch" else {}

    def runner(n):
        return mod("runner").RollbackRunner(
            box.make_schedule(), box.make_world(n, **dev).commit(), max_prediction=MAX_PRED,
            num_players=n, input_spec=box.INPUT_SPEC, **dev)

    return types.SimpleNamespace(
        pkg=pkg, relay=relay, server=mod("relay.server"), session=session, chaos=chaos,
        box=box, runner=runner, world=lambda n: box.make_world(n, **dev).commit(),
        Net=mod("transport.loopback").LoopbackNetwork, Metrics=mod("utils.metrics").Metrics,
        Supervisor=mod("session.supervisor").SessionSupervisor,
        AdvanceFrame=mod("session.requests").AdvanceFrame)


class FakeSocket:
    """Capture-only socket: records sends, replays queued inbound."""

    def __init__(self, addr=("fake", 0)):
        self.addr, self.sent, self.inbox = addr, [], []

    def send_to(self, data, addr):
        self.sent.append((bytes(data), addr))

    def receive_all(self):
        out, self.inbox = self.inbox, []
        return out

    def close(self):
        pass


def make_pair(p, net):
    peers = []
    for me in range(2):
        b = p.session.SessionBuilder(p.box.INPUT_SPEC).with_num_players(2) \
            .with_max_prediction_window(MAX_PRED)
        for h in range(2):
            b.add_player(p.session.PlayerType.local() if h == me
                         else p.session.PlayerType.remote(("peer", h)), h)
        peers.append((b.start_p2p_session(net.socket(("peer", me)), clock=lambda: net.now),
                      p.runner(2)))
    return peers


def step(p, session, runner):
    session.poll_remote_clients()
    if session.current_state() != p.session.SessionState.RUNNING:
        return
    for h in session.local_player_handles():
        session.add_local_input(h, scripted_input(h, session.current_frame))
    try:
        runner.handle_requests(session.advance_frame(), session)
    except p.session.PredictionThreshold:
        pass


def make_relay_peer(p, net, n, me, relays, disconnect_timeout=1.0):
    rsock = p.relay.RelaySocket(net.socket(("peer", me)), relays, session_id=7, peer_id=me,
                                clock=lambda: net.now)
    b = p.session.SessionBuilder(p.box.INPUT_SPEC).with_num_players(n) \
        .with_max_prediction_window(MAX_PRED).with_disconnect_timeout(disconnect_timeout)
    for h in range(n):
        b.add_player(p.session.PlayerType.local() if h == me
                     else p.session.PlayerType.remote(p.relay.peer_addr(h)), h)
    session = b.start_p2p_session(rsock, clock=lambda: net.now)
    runner = p.runner(n)
    metrics = p.Metrics()
    return session, runner, p.Supervisor(session, runner, metrics=metrics), metrics


def sup_step(p, net, peer, events):
    session, runner, sup, _ = peer
    session.poll_remote_clients()
    events.extend(e.kind.name for e in sup.tick(net.now))
    if session.current_state() != p.session.SessionState.RUNNING or not sup.should_advance():
        return
    for _ in range(1 + min(sup.frames_behind(), 4)):
        for h in session.local_player_handles():
            session.add_local_input(h, sup.input_for(h, scripted_input(h, session.current_frame)))
        try:
            runner.handle_requests(session.advance_frame(), session)
        except p.session.PredictionThreshold:
            break


def settled_checksums(sessions):
    upto = min(s.confirmed_frame() for s in sessions)
    frames = sorted(f for f in sessions[0]._local_checksums
                    if f <= upto and all(f in s._local_checksums for s in sessions[1:]))
    return [(f, [int(s._local_checksums[f]) for s in sessions]) for f in frames]


def serial_bytes(p, codec, n, frames):
    """The true trajectory's bytes after ``frames`` frames of the scripted
    inputs, from a serial replay."""
    ref = p.runner(n)
    for f in range(frames):
        bits = np.stack([scripted_input(h, f) for h in range(n)])
        ref.handle_requests([p.AdvanceFrame(bits=bits, status=np.zeros(n, np.int32))])
    return codec.encode(ref.world())


# ---------------------------------------------------------------------------
# The published stream
# ---------------------------------------------------------------------------


def published_stream(pkg):
    p = ns(pkg)
    net = p.Net()
    peers = make_pair(p, net)
    capture = FakeSocket()
    pub = p.relay.StatePublisher(*peers[0], socket=capture, keyframe_interval=7,
                                 max_frames_per_publish=1)
    authoritative = {}
    for _ in range(150):
        net.advance(FPS_DT)
        for session, runner in peers:
            step(p, session, runner)
        before = pub.published_frames
        pub.publish(net.now)
        if pub.published_frames > before:
            authoritative[pub._prev_frame] = pub._prev
    return capture, authoritative, pub


def replay(p, codec, datagrams, authoritative):
    sock = FakeSocket()
    spec = p.relay.StreamSpectator(sock, relays=[("fake", 0)], codec=codec,
                                   clock=lambda: 0.0, resub_timeout=1e9, max_apply_per_poll=1)
    checked = 0
    for data, _ in datagrams:
        sock.inbox.append((("fake", 0), data))
        prev = spec.current_frame
        spec.poll(0.0)
        while spec.current_frame != prev:
            if spec.current_frame in authoritative:
                assert spec.state_bytes == authoritative[spec.current_frame]
                checked += 1
            prev = spec.current_frame
            spec.poll(0.0)
    return spec, checked


def test_stream_bytes_equal_jax_and_replay_bitwise():
    tcap, tauth, tpub = published_stream("torch")
    jcap, jauth, _ = published_stream("jax")
    assert tcap.sent == jcap.sent
    assert tauth == jauth and len(tauth) >= 80
    assert tpub.readbacks > len(tauth)  # a probe and the leaves, per frame
    kinds = {type(proto.decode(d)).__name__ for d, _ in tcap.sent}
    assert kinds == {"StreamKeyframe", "StreamDelta"}
    for pkg in ("torch", "jax"):
        p = ns(pkg)
        codec = p.relay.StateCodec.for_state(p.world(2))
        spec, checked = replay(p, codec, tcap.sent, tauth)
        assert checked >= 80 and spec.keyframes_applied >= 5
        assert spec.current_frame == max(tauth)
        assert spec.state_bytes == serial_bytes(p, codec, 2, spec.current_frame)


def test_reseeds_keyframe_on_epoch_change():
    class EpochSock(FakeSocket):
        dirty = False

        def consume_epoch_change(self):
            d, self.dirty = self.dirty, False
            return d

    net = LoopbackNetwork()
    peers = make_group(net, 2)
    sock = EpochSock()
    pub = StatePublisher(*peers[0], socket=sock)
    drive(net, peers, scripted_input, 90)
    pub.publish(net.now)
    n_sent = len(sock.sent)
    sock.dirty = True
    pub.publish(net.now)
    reseed = [proto.decode(d) for d, _ in sock.sent[n_sent:]]
    assert reseed and all(isinstance(m, proto.StreamKeyframe) for m in reseed)
    assert reseed[0].frame == pub._prev_frame


def test_publisher_rehost_forces_keyframe_keeps_chain():
    net = LoopbackNetwork()
    peers = make_group(net, 2)
    session, runner = peers[0]
    sock_a = FakeSocket()
    pub = StatePublisher(session, runner, socket=sock_a, keyframe_interval=1000)

    def run(n):
        for _ in range(n):
            drive(net, peers, scripted_input, 3)
            pub.publish(net.now)

    run(30)
    pre_frame, pre_bytes = pub._prev_frame, pub._prev
    assert pub.published_frames > 10
    sock_b = FakeSocket()
    pub.rehost(runner=runner, socket=sock_b)
    assert pub._prev is pre_bytes and pub._prev_frame == pre_frame
    run(10)
    msgs = [proto.decode(d) for d, _ in sock_b.sent]
    kfs = [m for m in msgs if isinstance(m, proto.StreamKeyframe)]
    assert kfs and kfs[0].frame == pre_frame + 1
    deltas = [m for m in msgs if isinstance(m, proto.StreamDelta)]
    assert deltas and deltas[0].base_frame == pre_frame


# ---------------------------------------------------------------------------
# Peers through a relay, and through its death
# ---------------------------------------------------------------------------


def relayed_match(pkg, kill_at=None):
    """Two supervised peers whose only route is relay 0 (relay 1 stands
    by); relay 0 dies at ``kill_at`` seconds. A spectator follows the
    published stream."""
    p = ns(pkg)
    net = p.Net()
    relays = [("relay", 0), ("relay", 1)]
    servers = [p.relay.RelayServer(net.socket(a), clock=lambda: net.now, metrics=p.Metrics())
               for a in relays]
    peers = [make_relay_peer(p, net, 2, me, relays) for me in range(2)]
    pub = p.relay.StatePublisher(peers[0][0], peers[0][1], socket=peers[0][0].socket,
                                 keyframe_interval=20)
    codec = p.relay.StateCodec.for_state(p.world(2))
    spec = p.relay.StreamSpectator(net.socket(("spec", 0)), relays=list(relays), session_id=7,
                                   window=16, codec=codec, clock=lambda: net.now,
                                   resub_timeout=0.6)
    events = []
    for it in range(240):
        net.advance(FPS_DT)
        if kill_at is not None and servers[0] is not None and net.now >= kill_at:
            servers[0].close()
            servers[0] = None
        for srv in servers:
            if srv is not None:
                srv.pump(net.now)
        for peer in peers:
            sup_step(p, net, peer, events)
        pub.publish(net.now)
        spec.poll(net.now)
    for _ in range(30):  # the stream flushes to its head
        net.advance(FPS_DT)
        for srv in servers:
            if srv is not None:
                srv.pump(net.now)
        for session, *_ in peers:
            session.poll_remote_clients()
        pub.publish(net.now)
        spec.poll(net.now)
    forwarded = servers[1 if kill_at else 0].metrics.counters["relay_forwarded"]
    return dict(
        frames=[s.current_frame for s, *_ in peers],
        settled=settled_checksums([s for s, *_ in peers]),
        events=sorted(set(events)),
        failovers=[s.socket.failovers for s, *_ in peers],
        forwarded=forwarded,
        spec=(spec.current_frame, spec.failovers, spec.keyframes_applied, spec.deltas_applied,
              spec.state_bytes),
        head=pub._prev_frame,
        truth=serial_bytes(p, codec, 2, spec.current_frame),
    )


@pytest.mark.parametrize("kill_at", [None, 2.0], ids=["steady", "relay-death"])
def test_relayed_match_equals_jax(kill_at):
    mine, theirs = relayed_match("torch", kill_at), relayed_match("jax", kill_at)
    assert mine == theirs
    assert min(mine["frames"]) > 150 and mine["forwarded"] > 100
    assert "DESYNC_DETECTED" not in mine["events"] and "DISCONNECTED" not in mine["events"]
    assert len(mine["settled"]) >= 3
    assert all(len(set(row)) == 1 for _, row in mine["settled"])
    assert mine["failovers"] == ([0, 0] if kill_at is None else [1, 1])
    frame, spec_failovers, *_, state = mine["spec"]
    assert frame == mine["head"] and state == mine["truth"]
    # Silence before the first publish re-subscribes too (JAX's count).
    assert spec_failovers >= (0 if kill_at is None else 1)


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------


def ladder_run(pkg, window, relay_kw, iters):
    p = ns(pkg)
    net = p.Net()
    plan = p.chaos.ChaosPlan(21, (p.chaos.Partition(window[0], window[1], src=("spec", 0)),))
    relay = p.relay.RelayServer(net.socket(("relay", 0)), clock=lambda: net.now,
                                metrics=p.Metrics(), **relay_kw)
    peers = [make_relay_peer(p, net, 2, me, [("relay", 0)]) for me in range(2)]
    pub = p.relay.StatePublisher(peers[0][0], peers[0][1], socket=peers[0][0].socket,
                                 keyframe_interval=10)
    codec = p.relay.StateCodec.for_state(p.world(2))
    spec = p.relay.StreamSpectator(
        p.chaos.ChaosSocket(net.socket(("spec", 0)), plan, clock=lambda: net.now,
                            addr=("spec", 0)),
        relays=[("relay", 0)], session_id=7, window=8, codec=codec, clock=lambda: net.now,
        resub_timeout=0.4)
    trail, events = [], []
    for _ in range(iters):
        net.advance(FPS_DT)
        relay.pump(net.now)
        for peer in peers:
            sup_step(p, net, peer, events)
        pub.publish(net.now)
        spec.poll(net.now)
        trail.append((spec.current_frame, relay.subscriber_mode(("spec", 0)),
                      relay.subscriber_count()))
    return dict(trail=trail, counters=dict(relay.metrics.counters),
                spec=(spec.failovers, spec.keyframes_applied, spec.deltas_applied,
                      spec.frames_behind(), spec.state_bytes),
                truth=serial_bytes(p, codec, 2, spec.current_frame)), p


@pytest.mark.parametrize("case", ["keyframe-only", "shed"])
def test_degradation_ladder_equals_jax(case):
    args = (((1.0, 1.5), dict(degrade_after=8, shed_after=5.0), 210) if case == "keyframe-only"
            else ((1.0, 2.0), dict(degrade_after=8, shed_after=0.6), 240))
    (mine, p), (theirs, _) = ladder_run("torch", *args), ladder_run("jax", *args)
    assert mine == theirs
    counters, spec = mine["counters"], mine["spec"]
    if case == "keyframe-only":
        assert p.server.MODE_KEYFRAME in {m for _, m, _ in mine["trail"]}
        assert counters["fanout_degraded"] >= 1 and counters["fanout_recovered"] >= 1
        assert mine["trail"][-1][1] == p.server.MODE_FULL
    else:
        assert 0 in {n for _, _, n in mine["trail"]} and counters["fanout_shed"] >= 1
        assert mine["trail"][-1][2] == 1 and spec[0] >= 1
    frames = [f for f, _, _ in mine["trail"]]
    assert frames == sorted(frames)  # the frontier never rewinds
    assert spec[3] <= 8 and spec[4] == mine["truth"]


def test_relay_exports_equal_jax():
    import bevy_ggrs_tpu.relay as jrelay

    assert sorted(trelay.__all__) == sorted(jrelay.__all__)
    assert trelay.RELAY_CONTROL == jrelay.RELAY_CONTROL
    assert trelay.peer_addr(3) == jrelay.peer_addr(3)
