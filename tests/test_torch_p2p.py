"""PyTorch port, P2P and spectator sessions on ``device="cpu"``.

The behaviours of the JAX package's ``test_p2p.py``, ``test_p2p_multi.py``
and ``test_spectator.py``, played by the port's sessions and runners over
the port's deterministic loopback network: peers synchronize, roll back
and agree on every confirmed checksum under latency, jitter and loss;
input delay, the prediction threshold, disconnects, reconnects, a
perturbed world (a desync, detected and localized), the spectator's
catch-up, a 4-peer mesh, a session checkpoint, and the app's P2P and
spectator stages. The misprediction tracker is held against the JAX
package's on the same inputs.
"""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.native import core as jcore
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import GGRSPlugin, SessionType
from bevy_ggrs_tpu_torch.models import box_game
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.session import (
    EventKind,
    PlayerType,
    PredictionThreshold,
    SessionBuilder,
    SessionState,
)
from bevy_ggrs_tpu_torch.session import input_queue as tiq
from bevy_ggrs_tpu_torch.session.endpoint import PeerState
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame
from bevy_ggrs_tpu_torch.session.spectator import CATCHUP_BURST_CAP, SpectatorSession
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

FPS_DT = 1.0 / 60.0


def make_runner(num_players, max_prediction=8):
    return RollbackRunner(
        box_game.make_schedule(), box_game.make_world(num_players, device="cpu").commit(),
        max_prediction=max_prediction, num_players=num_players,
        input_spec=box_game.INPUT_SPEC, device="cpu")


def make_peer(net, me, num_players, max_prediction=8, input_delay=0, spectators=(),
              desync_detection="auto", disconnect_timeout=2.0):
    builder = (SessionBuilder(box_game.INPUT_SPEC)
               .with_num_players(num_players)
               .with_max_prediction_window(max_prediction)
               .with_input_delay(input_delay)
               .with_disconnect_timeout(disconnect_timeout))
    if desync_detection != "auto":
        builder.with_desync_detection(desync_detection)
    for h in range(num_players):
        builder.add_player(PlayerType.local() if h == me
                           else PlayerType.remote(("peer", h)), h)
    for addr in spectators:
        builder.add_player(PlayerType.spectator(addr), num_players + 1)
    session = builder.start_p2p_session(net.socket(("peer", me)), clock=lambda: net.now)
    return session, make_runner(num_players, max_prediction)


def make_group(net, n, spectators=(), **kw):
    """``n`` peers in a full mesh; spectators attach to peer 0."""
    return [make_peer(net, me, n, spectators=spectators if me == 0 else (), **kw)
            for me in range(n)]


def step_peer(session, runner, inputs_for, events=None):
    session.poll_remote_clients()
    if events is not None:
        events.extend(session.events())
    if session.current_state() != SessionState.RUNNING:
        return False
    for h in session.local_player_handles():
        session.add_local_input(h, inputs_for(h, session.current_frame))
    try:
        requests = session.advance_frame()
    except PredictionThreshold:
        return False
    runner.handle_requests(requests, session)
    return True


def drive(net, peers, inputs_for, n_iters, events=None):
    for _ in range(n_iters):
        net.advance(FPS_DT)
        for session, runner in peers:
            step_peer(session, runner, inputs_for, events)


def scripted_input(handle, frame):
    """Changes every 3 frames: plenty of mispredictions against
    repeat-last."""
    keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    return np.uint8(keys[(frame // 3 + handle) % len(keys)])


def settled(session) -> int:
    pending = session._tracker.first_incorrect
    return session.confirmed_frame() if pending < 0 else min(
        session.confirmed_frame(), pending - 1)


def common_checksums(sessions):
    """The frames every session holds a settled checksum for, with the
    checksums side by side."""
    upto = min(settled(s) for s in sessions)
    frames = sorted(f for f in sessions[0]._local_checksums
                    if f <= upto and all(f in s._local_checksums for s in sessions))
    return frames, [[s._local_checksums[f] for s in sessions] for f in frames]


def assert_agree(sessions, at_least):
    frames, rows = common_checksums(sessions)
    assert len(frames) >= at_least, frames
    assert all(len(set(row)) == 1 for row in rows), "desync between peers"


def perturb(runner):
    st = runner.state
    runner.state = st.replace(components={
        **st.components, "translation": st.components["translation"] + 0.25})


class TestP2P:
    def test_synchronizes_then_runs(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2)
        events = []
        drive(net, peers, scripted_input, 12, events)
        assert all(s.current_state() == SessionState.RUNNING for s, _ in peers)
        assert any(e.kind == EventKind.SYNCHRONIZED for e in events)

    @pytest.mark.parametrize("net_kwargs", [
        {"latency": 3 * FPS_DT},
        {"latency": 2 * FPS_DT, "jitter": 2 * FPS_DT, "loss": 0.2, "seed": 7},
    ], ids=["latency", "loss_and_jitter"])
    def test_rollbacks_and_peers_agree(self, net_kwargs):
        net = LoopbackNetwork(**net_kwargs)
        peers = make_group(net, 2)
        events = []
        drive(net, peers, scripted_input, 150, events)
        assert all(r.rollbacks_total > 0 for _, r in peers)
        assert_agree([s for s, _ in peers], 4)
        assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)
        # The checksum exchange ran: every peer compared reports.
        assert all(s._checksum_votes or s._last_checksum_sent > 0 for s, _ in peers)

    def test_input_delay_applies(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, input_delay=2)
        (sa, ra), _ = peers
        while sa.current_state() != SessionState.RUNNING:
            net.advance(FPS_DT)
            for session, _ in peers:
                session.poll_remote_clients()
        assert step_peer(sa, ra, scripted_input)
        queue = sa._queues[0]
        # The input issued at frame 0 takes effect at frame 2; 0 and 1 are
        # the zero input, and the remote player's are still predictions.
        assert [int(queue.confirmed(f)) for f in range(3)] == [
            0, 0, int(scripted_input(0, 0))]
        assert queue.confirmed(3) is None and sa._queues[1].confirmed(0) is None
        drive(net, peers, scripted_input, 40)
        assert ra.frame > 30
        assert_agree([s for s, _ in peers], 2)

    def test_prediction_threshold_when_peer_silent(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, max_prediction=4)
        drive(net, peers, scripted_input, 14)
        (sa, ra), _ = peers
        assert sa.current_state() == SessionState.RUNNING
        hit = 0
        for _ in range(20):
            net.advance(FPS_DT)
            sa.poll_remote_clients()
            try:
                sa.add_local_input(0, np.uint8(0))
                ra.handle_requests(sa.advance_frame(), sa)
            except PredictionThreshold:
                hit += 1
        assert hit > 0
        assert sa.current_frame - sa.confirmed_frame() <= sa.max_prediction + 1

    def test_frames_ahead_signals_pacing(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, max_prediction=12)
        drive(net, peers, scripted_input, 14)
        (sa, ra), (sb, _) = peers
        for _ in range(6):
            net.advance(FPS_DT)
            sa.poll_remote_clients()
            sa.add_local_input(0, np.uint8(0))
            ra.handle_requests(sa.advance_frame(), sa)
        sb.poll_remote_clients()
        assert sa.frames_ahead() >= 1


class TestDisconnect:
    def test_timeout_freezes_the_silent_peer(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, max_prediction=30)
        drive(net, peers, scripted_input, 14)
        (sa, ra), _ = peers
        events = []
        for _ in range(int(2.5 / FPS_DT)):
            net.advance(FPS_DT)
            sa.poll_remote_clients()
            events.extend(sa.events())
        kinds = {e.kind for e in events}
        assert {EventKind.NETWORK_INTERRUPTED, EventKind.DISCONNECTED} <= kinds
        before = sa.current_frame
        for _ in range(5):
            net.advance(FPS_DT)
            sa.poll_remote_clients()
            sa.add_local_input(0, np.uint8(box_game.INPUT_LEFT))
            ra.handle_requests(sa.advance_frame(), sa)
        assert sa.current_frame == before + 5

    def test_disconnect_player_and_reconnect_peer(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, max_prediction=8)
        drive(net, peers, scripted_input, 20)
        (sa, ra), (sb, rb) = peers
        sa.disconnect_player(1)
        events = sa.events()
        assert any(e.kind == EventKind.DISCONNECTED for e in events)
        assert 1 in sa._disconnected
        with pytest.raises(Exception, match="not remote"):
            sa.disconnect_player(0)
        # A runs on alone, past any prediction window: B's input is frozen.
        for _ in range(3 * sa.max_prediction):
            net.advance(FPS_DT)
            assert step_peer(sa, ra, scripted_input)
        # B, silent to A now, times A out and re-arms A's address; A does
        # the same for B. Both fresh endpoints handshake without gating
        # either session.
        for _ in range(int(2.5 / FPS_DT)):
            net.advance(FPS_DT)
            sb.poll_remote_clients()
        assert sb._endpoints[("peer", 0)].state == PeerState.DISCONNECTED
        assert sa.reconnect_peer(("peer", 1)) and sb.reconnect_peer(("peer", 0))
        assert not sa.reconnect_peer(("peer", 1))  # only a dead endpoint
        assert sa._endpoints[("peer", 1)].reconnecting
        assert sa.current_state() == SessionState.RUNNING
        events = []
        drive(net, peers, scripted_input, 30, events)
        assert any(e.kind == EventKind.SYNCHRONIZED for e in events)
        assert sa._endpoints[("peer", 1)].state == PeerState.RUNNING
        assert sb._endpoints[("peer", 0)].state == PeerState.RUNNING


class TestDesync:
    def test_perturbed_world_is_detected_and_localized(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2)
        (sa, ra), (sb, rb) = peers
        assert sa.desync_interval == 8  # auto: min(16, max_prediction)
        perturb(rb)
        hit = None
        for _ in range(200):
            net.advance(FPS_DT)
            for session, runner in peers:
                events = []
                step_peer(session, runner, lambda h, f: np.uint8(0), events)
                hit = hit or next((e for e in events
                                   if e.kind == EventKind.DESYNC_DETECTED), None)
            if hit is not None:
                break
        assert hit is not None, "desync never detected"
        frame = hit.data["frame"]
        da, db = ra.diagnose_frame(frame), rb.diagnose_frame(frame)
        assert da is not None and db is not None
        diff = {k for k in da if da[k] != db.get(k)}
        assert "component/translation" in diff and "component/velocity" not in diff
        assert sa.checksum_votes(frame) or sb.checksum_votes(frame)

    def test_detection_off_is_silent_and_reports_nothing(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, desync_detection=None)
        (sa, _), (sb, rb) = peers
        perturb(rb)
        events = []
        drive(net, peers, lambda h, f: np.uint8(0), 80, events)
        assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)
        assert not sa._local_checksums and not sb._local_checksums
        assert not sa.wants_checksum(0) and not sa.wants_checksum(16)

    def test_interval_knob_controls_which_frames_report(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, desync_detection=4)
        (sa, _), (sb, rb) = peers
        assert sa.desync_interval == 4
        perturb(rb)
        events = []
        drive(net, peers, lambda h, f: np.uint8(0), 60, events)
        desyncs = [e for e in events if e.kind == EventKind.DESYNC_DETECTED]
        assert desyncs and all(e.data["frame"] % 4 == 0 for e in desyncs)
        assert all(f % 4 == 0 for f in sa._local_checksums)


class TestMesh:
    def test_four_peer_mesh_agrees(self):
        net = LoopbackNetwork(latency=2 * FPS_DT, jitter=FPS_DT, loss=0.05, seed=2)
        peers = make_group(net, 4)
        events = []
        drive(net, peers, scripted_input, 100, events)
        assert min(s.confirmed_frame() for s, _ in peers) > 25
        assert_agree([s for s, _ in peers], 3)
        assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)

    def test_survivors_converge_after_a_death(self):
        net = LoopbackNetwork(latency=2 * FPS_DT, jitter=2 * FPS_DT, seed=5)
        peers = make_group(net, 3, disconnect_timeout=0.3)
        drive(net, peers, scripted_input, 40)
        pre_death = peers[0][0].current_frame
        events = []
        drive(net, peers[:2], scripted_input, 60, events)
        assert any(e.kind == EventKind.DISCONNECTED for e in events)
        assert all(s.current_frame > pre_death + 25 for s, _ in peers[:2])
        assert_agree([s for s, _ in peers[:2]], 3)
        assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)


class TestSpectator:
    def test_spectator_follows_the_host(self):
        net = LoopbackNetwork(latency=FPS_DT)
        peers = make_group(net, 2, spectators=[("spec", 0)])
        spec = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(2)
                .start_spectator_session(("peer", 0), net.socket(("spec", 0)),
                                         clock=lambda: net.now))
        spec_runner = make_runner(2)
        for _ in range(120):
            net.advance(FPS_DT)
            for session, runner in peers:
                step_peer(session, runner, scripted_input)
            spec.poll_remote_clients()
            if spec.current_state() == SessionState.RUNNING:
                try:
                    spec_runner.handle_requests(spec.advance_frame(), spec)
                except PredictionThreshold:
                    pass
        assert spec_runner.frame >= 40 and spec_runner.rollbacks_total == 0
        ref = make_runner(2)
        for f in range(spec_runner.frame):
            bits = np.stack([scripted_input(h, f) for h in range(2)])
            ref.handle_requests([AdvanceFrame(bits=bits, status=np.zeros(2, np.int32))])
        np.testing.assert_array_equal(spec_runner.world()["components"]["translation"],
                                      ref.world()["components"]["translation"])
        pending = peers[0][0]._endpoints[("spec", 0)]._pending_output
        assert max((len(d) for d in pending.values()), default=0) < 20

    def test_catchup_is_capped_per_call(self):
        net = LoopbackNetwork()
        session = SpectatorSession(2, box_game.INPUT_SPEC, net.socket(("spec", 9)),
                                   ("peer", 0), max_frames_behind=10_000,
                                   clock=lambda: net.now)
        session._endpoint.state = PeerState.RUNNING
        for h in range(2):
            for f in range(500):
                session._queues[h].add_input(f, scripted_input(h, f))
        assert len(session.advance_frame()) == CATCHUP_BURST_CAP
        total = CATCHUP_BURST_CAP
        while session.current_frame < 499:
            batch = session.advance_frame()
            assert 1 <= len(batch) <= CATCHUP_BURST_CAP
            total += len(batch)
        assert total == session.current_frame
        assert session.local_player_handles() == []

    def test_spectator_waits_without_host_data(self):
        net = LoopbackNetwork()
        peers = make_group(net, 2, spectators=[("spec", 0)])
        spec = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(2)
                .start_spectator_session(("peer", 0), net.socket(("spec", 0)),
                                         clock=lambda: net.now))
        for _ in range(20):
            net.advance(FPS_DT)
            for session, _ in peers:
                session.poll_remote_clients()
            spec.poll_remote_clients()
        assert spec.current_state() == SessionState.RUNNING
        with pytest.raises(PredictionThreshold):
            spec.advance_frame()


def test_session_checkpoint_round_trip():
    """A crashes mid-match and restarts from its session ``state_dict`` and a
    copy of its runner; it re-handshakes with the live peer B and both run
    on in agreement."""
    net = LoopbackNetwork(latency=1.5 * FPS_DT, seed=21)
    (sa, ra), (sb, rb) = make_group(net, 2)
    ckpt = None
    for i in range(60):
        net.advance(FPS_DT)
        step_peer(sa, ra, scripted_input)
        step_peer(sb, rb, scripted_input)
        if i % 5 == 0 and sa.current_state() == SessionState.RUNNING:
            ring = ts.SnapshotRing(ts.tree_map(torch.clone, ra.ring.states),
                                   ra.ring.frames.clone(), ra.ring.checksums.clone())
            ckpt = (sa.state_dict(), ra.frame, ts.tree_map(torch.clone, ra.state), ring)
    sd, frame, state, ring = ckpt
    sa.socket.close()
    events_b = []
    for _ in range(50):
        net.advance(FPS_DT)
        step_peer(sb, rb, scripted_input, events_b)
    sa2, ra2 = make_peer(net, 0, 2)
    sa2.load_state_dict(sd)
    ra2.state, ra2.ring, ra2.frame = state, ring, frame
    assert sa2.current_frame == ra2.frame == sd["current_frame"]
    assert sa2.state_dict()["inputs"] == sd["inputs"]
    events_a = []
    for _ in range(200):
        net.advance(FPS_DT)
        step_peer(sa2, ra2, scripted_input, events_a)
        step_peer(sb, rb, scripted_input, events_b)
    assert any(e.kind == EventKind.SYNCHRONIZED for e in events_a)
    assert any(e.kind == EventKind.NETWORK_RESUMED for e in events_b)
    assert ra2.frame > frame + 100
    assert_agree([sa2, sb], 3)
    assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events_a + events_b)


def box_plugin(num_players=2):
    rng = np.random.RandomState(0)
    table = rng.randint(0, 16, size=(1000, num_players)).astype(np.uint8)
    return (GGRSPlugin(box_game.INPUT_SPEC)
            .with_input_system(lambda h, app: table[app.session.current_frame, h])
            .register_rollback_component("translation", shape=(3,))
            .register_rollback_component("velocity", shape=(3,))
            .register_rollback_component("player_handle", dtype=torch.int32, default=-1)
            .register_rollback_resource("frame_count", np.uint32(0))
            .with_rollback_schedule(box_game.make_schedule())
            .with_num_players(num_players)
            .with_world_capacity(16)
            .with_setup_system(lambda w, app: box_game.spawn_players(
                w, num_players, next_id=app.rollback_id_provider.next_id))
            .with_device("cpu"))


def test_app_stage_runs_p2p_and_spectator_sessions():
    """Two P2P apps and a spectator app through ``GGRSStage`` on a virtual
    clock: the network is pumped every render frame, steps run from
    ``frames_ahead`` pacing, and the spectator's world equals the host's."""
    net = LoopbackNetwork(latency=2 * FPS_DT, loss=0.05, seed=1)
    apps = []
    for me in range(2):
        app = box_plugin().build()
        builder = (SessionBuilder(box_game.INPUT_SPEC).with_num_players(2)
                   .with_input_delay(2))
        for h in range(2):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(("peer", h)), h)
        if me == 0:
            builder.add_player(PlayerType.spectator(("spec", 0)), 3)
        app.insert_session(builder.start_p2p_session(
            net.socket(("peer", me)), clock=lambda: net.now), SessionType.P2P)
        apps.append(app)
    spec_app = box_plugin().build()
    spec_app.insert_session(
        SessionBuilder(box_game.INPUT_SPEC).with_num_players(2).start_spectator_session(
            ("peer", 0), net.socket(("spec", 0)), clock=lambda: net.now),
        SessionType.SPECTATOR)
    for _ in range(150):
        net.advance(FPS_DT)
        for app in apps + [spec_app]:
            app.update(net.now)
    assert all(app.frame > 100 for app in apps)
    assert all(app.stage.runner.rollbacks_total > 0 for app in apps)
    events = [e for app in apps for e in app.events]
    assert any(e.kind == EventKind.SYNCHRONIZED for e in events)
    assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)
    assert_agree([app.session for app in apps], 4)
    # The spectator's world at an exchange frame is the world every peer
    # saved for that frame.
    host, compared = apps[0].session, 0
    for _ in range(60):
        net.advance(FPS_DT)
        for app in apps + [spec_app]:
            app.update(net.now)
        frame = spec_app.frame
        if frame % 8 == 0 and frame <= settled(host) and frame in host._local_checksums:
            assert ts.combine64(ts.checksum(spec_app.stage.runner.state)) == \
                host._local_checksums[frame]
            compared += 1
    assert compared >= 3
    assert spec_app.frame > 100 and spec_app.stage.runner.rollbacks_total == 0


def test_unported_options_raise(monkeypatch):
    """Every plugin option is ported now: speculation, the input predictor
    (the predictor's weights' hash is the handshake digest, 0 when off)
    and meshes (``with_mesh`` records the mesh and its axes and returns
    the plugin)."""
    from bevy_ggrs_tpu_torch.predict import load_default

    monkeypatch.delenv("GGRS_PREDICTOR", raising=False)
    plugin = box_plugin()
    assert plugin.with_speculation(4) is plugin  # ported: builds a speculating stage
    mesh = object()
    assert plugin.with_mesh(mesh, entity_axis="e", branch_axis="b") is plugin
    assert (plugin.mesh, plugin.entity_axis, plugin.branch_axis) == (mesh, "e", "b")
    assert plugin.with_mesh(None) is plugin and plugin.mesh is None
    builder = SessionBuilder(box_game.INPUT_SPEC)
    assert builder._config_digest() == 0
    assert builder.with_input_predictor(True) is builder
    assert builder._config_digest() == load_default().content_hash


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_against_jax(seed):
    """The same recorded and confirmed inputs give the same rollback target
    and used inputs in the port's tracker and the JAX package's."""
    rng = np.random.RandomState(seed)
    players = 3
    zero = np.zeros((), np.uint8)
    jt, tt = jcore.PyTracker(players, zero), tiq.make_tracker(players, zero)
    for frame in range(200):
        bits = rng.randint(0, 4, size=players).astype(np.uint8)
        status = rng.randint(0, 3, size=players).astype(np.int32)
        for t in (jt, tt):
            t.record_used(frame, bits, status)
        for _ in range(int(rng.randint(0, 3))):
            h, f = int(rng.randint(players)), int(rng.randint(max(0, frame - 8), frame + 1))
            b = np.uint8(rng.randint(0, 4))
            for t in (jt, tt):
                t.note_confirmed(h, f, b)
        assert tt.first_incorrect == jt.first_incorrect
        if rng.rand() < 0.2:
            for t in (jt, tt):
                t.clear_first_incorrect()
        if frame % 16 == 0:
            for t in (jt, tt):
                t.discard_before(frame - 10)
        for f in range(max(0, frame - 12), frame + 1):
            a, b = jt.get_used(f), tt.get_used(f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
    assert tiq.NEVER_DISCONNECTED == jcore.NEVER_DISCONNECTED == 2**31 - 1


def test_chip_smoke_phase_10_on_the_cpu():
    """``chip_smoke.py``'s P2P phase, at a small size on the CPU: the same
    five runs and checks but the kernel counts (the card's only)."""
    import chip_smoke
    from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
    from bevy_ggrs_tpu_torch.ops import checksum as tck
    from bevy_ggrs_tpu_torch.ops import pairwise as tpw

    force = (tpw.pairwise_force_rows, tpw.pairwise_force_rows_mxu2,
             tpw.pairwise_force_square_mxu_tri, tcg.cell_slot_forces)
    out = chip_smoke.p2p_phase((tck.world_checksum,) + force, force, ts, tck, tpw,
                               box_frames=100, mesh_frames=60, boids_frames=20,
                               udp_frames=30, boids_n=64, device="cpu")
    assert set(out) == {"box2", "box4", "boids1024_mxu", "udp"}
    box = out["box2"]
    assert all(p["rollbacks"] > 0 and p["frames"] >= 100 for p in box["peers"])
    assert sum(p["data_crc_drops"] for p in box["peers"]) > 0
    assert box["spectator"]["compared_with_host"] >= 10
    assert [len(r["peers"]) for r in out.values()] == [2, 4, 2, 2]
