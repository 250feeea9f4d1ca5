"""PyTorch port: the JAX package's adversarial and soak contracts on the
port's sessions.

The four cases of ``tests/test_adversarial.py`` (hostile datagrams: inert
from an unknown address, absorbed without an exception when they spoof a
peer, an ack ahead of anything offered that cannot stall the victim, a
protocol version skew that surfaces as one ``VERSION_MISMATCH`` event)
and ``tests/test_soak.py``'s lossy two-peer session with a speculating
peer, cut from 1,500 frames to 400 and its progress bound scaled with it
(1,200 of 1,500 to 320 of 400), with the JAX package's memory bounds:
fewer than 40 local checksums, 200 pending output spans and 100 input
log entries, and no desync. Both peers run the port's sessions and
runners on ``device="cpu"`` over the port's loopback network, through
``tests/test_torch_p2p.py``'s helpers. About 25 s on one core.
"""

from bevy_ggrs_tpu_torch.models import box_game
from bevy_ggrs_tpu_torch.session import (
    EventKind,
    PredictionThreshold,
    SessionState,
)
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

from tests.test_torch_p2p import FPS_DT, common_checksums, make_group, scripted_input

HOSTILE = [
    proto.InputMsg(handle=250, start_frame=0, payload=b"\x01" * 8, num=8,
                   ack_frame=0, sender_frame=0, advantage=0),
    proto.InputMsg(handle=0, start_frame=2**31 - 2, payload=b"\x02", num=1,
                   ack_frame=2**31 - 2, sender_frame=2**31 - 2, advantage=0),
    proto.InputMsg(handle=1, start_frame=-5000, payload=b"\x03" * 4, num=4,
                   ack_frame=-1, sender_frame=-1, advantage=-30000),
    # num lies about the payload size (the unpacker must stop at the data).
    proto.InputMsg(handle=1, start_frame=5, payload=b"\x04", num=60000,
                   ack_frame=0, sender_frame=5, advantage=0),
    proto.InputAck(handle=200, ack_frame=2**31 - 1),
    proto.ChecksumReport(frame=2**30, checksum=0xDEADBEEF),
    proto.ChecksumReport(frame=-7, checksum=0),
    proto.QualityReport(send_time_ms=2**32 - 1, frame_advantage=-32768),
    proto.SyncReply(nonce=0x41414141),
]


def step_all(peers, events):
    """One frame of every peer: poll, inputs, advance, and a speculating
    runner's rollout."""
    for session, runner in peers:
        session.poll_remote_clients()
        events.extend(session.events())
        if session.current_state() != SessionState.RUNNING:
            continue
        for h in session.local_player_handles():
            session.add_local_input(h, scripted_input(h, session.current_frame))
        try:
            requests = session.advance_frame()
        except PredictionThreshold:
            continue
        runner.handle_requests(requests, session)
        if isinstance(runner, SpeculativeRollbackRunner):
            runner.speculate(session.confirmed_frame(), session)


def drive(net, peers, n, inject=None):
    """``n`` frames; ``inject(i)`` puts datagrams on the wire before
    frame ``i``'s delivery reaches the peers."""
    events = []
    for i in range(n):
        net.advance(FPS_DT)
        if inject is not None:
            inject(i)
        step_all(peers, events)
    return events


def hostile_from(net, src):
    def inject(i):
        for msg in HOSTILE[i % len(HOSTILE):][:2]:
            net._send(src, ("peer", 0), proto.encode(msg))
            net._send(src, ("peer", 1), proto.encode(msg))
    return inject


def assert_progress_and_agreement(peers, at_least):
    (_, ra), (_, rb) = peers
    assert ra.frame > at_least and rb.frame > at_least
    frames, rows = common_checksums([s for s, _ in peers])
    assert frames and all(len(set(row)) == 1 for row in rows)


def test_unknown_address_hostility_is_inert():
    """Garbage from a non-peer address: full progress, agreement and no
    desync event, as if the intruder were not there."""
    net = LoopbackNetwork(latency=1 * FPS_DT, seed=3)
    peers = make_group(net, 2)
    events = drive(net, peers, 90, hostile_from(net, ("intruder", 9)))
    assert_progress_and_agreement(peers, 40)
    assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)


def test_peer_spoofed_hostility_never_raises():
    """Garbage spoofing peer 1's address toward both peers: nothing
    raises, and the sessions stay usable."""
    net = LoopbackNetwork(latency=1 * FPS_DT, seed=3)
    peers = make_group(net, 2)
    drive(net, peers, 90, hostile_from(net, ("peer", 1)))
    for session, _ in peers:
        session.events()
        session.current_state()
        for h in session.remote_player_handles():
            session.network_stats(h)


def test_lying_ack_ahead_cannot_stall_the_victim():
    """Acks of frames never offered, for every handle, both ways: the
    clamped ack keeps the genuine resend flowing and the pair runs on."""
    net = LoopbackNetwork(latency=1 * FPS_DT, seed=5)
    peers = make_group(net, 2)
    lies = [proto.encode(proto.InputAck(handle=h, ack_frame=2**31 - 1)) for h in (0, 1)]

    def inject(i):
        for lie in lies:
            net._send(("peer", 1), ("peer", 0), lie)
            net._send(("peer", 0), ("peer", 1), lie)

    drive(net, peers, 90, inject)
    assert_progress_and_agreement(peers, 40)


def test_version_skew_surfaces_instead_of_silent_stall():
    """Datagrams of the next protocol version are dropped one by one, and
    after a handful the session emits one ``VERSION_MISMATCH``; a
    datagram with the wrong magic is not skew."""
    net = LoopbackNetwork(latency=1 * FPS_DT, seed=11)
    peers = make_group(net, 2)
    skewed = bytearray(proto.encode(proto.SyncRequest(nonce=1234)))
    assert skewed[1] == proto.VERSION
    skewed[1] = proto.VERSION + 1
    events = []
    for _ in range(30):
        net.advance(FPS_DT)
        net._send(("peer", 1), ("peer", 0), bytes(skewed))
        for session, _ in peers:
            session.poll_remote_clients()
            events.extend(session.events())
    mismatches = [e for e in events if e.kind == EventKind.VERSION_MISMATCH]
    assert len(mismatches) == 1, "one event per skewed peer, not per datagram"
    assert mismatches[0].data["peer_version"] == proto.VERSION + 1
    assert mismatches[0].data["local_version"] == proto.VERSION
    assert mismatches[0].data["count"] >= 5
    assert proto.version_mismatch(b"\x00" * 16) is None


SOAK_FRAMES = 400


def test_two_peer_lossy_soak_stays_bounded():
    """400 frames at 10 % loss with latency and jitter, peer 0
    speculating (16 branches x 8 frames): both peers past 320 frames, no
    desync, the settled checksums equal, every host-side structure within
    the JAX package's bound, and speculation hit."""
    net = LoopbackNetwork(latency=1.5 * FPS_DT, jitter=1 * FPS_DT, loss=0.1, seed=13)
    peers = make_group(net, 2, max_prediction=8)
    s0, _ = peers[0]
    peers[0] = (s0, SpeculativeRollbackRunner(
        box_game.make_schedule(), box_game.make_world(2, device="cpu").commit(),
        max_prediction=8, num_players=2, input_spec=box_game.INPUT_SPEC,
        num_branches=16, spec_frames=8, device="cpu"))
    events = drive(net, peers, SOAK_FRAMES)
    (sa, ra), (sb, rb) = peers
    bound = SOAK_FRAMES * 1200 // 1500
    assert ra.frame > bound and rb.frame > bound
    frames, rows = common_checksums([sa, sb])
    assert len(frames) >= 2 and all(len(set(row)) == 1 for row in rows)
    assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)
    for s in (sa, sb):
        assert len(s._local_checksums) < 40, "checksum map grew unbounded"
        for ep in s._endpoints.values():
            for spans in ep._pending_output.values():
                assert len(spans) < 200, "unacked output grew unbounded"
    assert len(ra._input_log) < 100, "spec input log grew unbounded"
    assert ra.spec_hits + ra.spec_partial_hits > 0
