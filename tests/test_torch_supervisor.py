"""The port's SessionSupervisor against the JAX package's, on the CPU.

The cases of ``tests/test_supervisor.py`` on the port: sync backoff, the
three-peer desync heal (its counters and recovery frames equal to JAX's
same harness run in the same process), the majority never pausing, kill,
restart and rejoin from a full checkpoint, and a partition that heals. The
port's peers run box_game on ``device="cpu"``, its sessions on the native
data plane (the default), 16 slots and ``max_prediction`` 8. Peers of both
packages go through ``chip_smoke.py``'s drive loop (``sup_step``), the
port's built by its ``sup_peer``.
"""

import numpy as np

from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.runner import RollbackRunner as JRunner
from bevy_ggrs_tpu.session import PlayerType as JPlayerType
from bevy_ggrs_tpu.session import SessionBuilder as JBuilder
from bevy_ggrs_tpu.session.endpoint import PeerEndpoint as JEndpoint
from bevy_ggrs_tpu.session.supervisor import SessionSupervisor as JSupervisor
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JLoopback
from bevy_ggrs_tpu.utils.metrics import Metrics as JMetrics
from bevy_ggrs_tpu_torch.chaos import ChaosPlan, ChaosSocket, KillRestart, Partition
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.session import EventKind
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.endpoint import PeerEndpoint
from bevy_ggrs_tpu_torch.session.supervisor import Health
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork
from chip_smoke import SUP_DT, sup_keys, sup_kinds, sup_peer, sup_run, sup_settled, sup_step

MAX_PRED = 8


def make_supervised(net, n, me, pkg="torch", disconnect_timeout=0.5, device="cpu",
                    tracer=None):
    """One supervised box_game peer of either package for slot ``me``:
    ``(session, runner, supervisor, metrics)``. The port's is
    ``chip_smoke.sup_peer``; the JAX package's is built the same way, its
    session, runner and supervisor sharing one ``Metrics``."""
    if pkg == "torch":
        return sup_peer(net, n, me, device, tracer, disconnect_timeout)
    builder = (JBuilder(jbox.INPUT_SPEC).with_num_players(n).with_max_prediction_window(MAX_PRED)
               .with_disconnect_timeout(disconnect_timeout))
    for h in range(n):
        builder.add_player(JPlayerType.local() if h == me else JPlayerType.remote(("peer", h)), h)
    metrics = JMetrics()
    session = builder.start_p2p_session(net.socket(("peer", me)), clock=lambda: net.now,
                                        metrics=metrics)
    runner = JRunner(jbox.make_schedule(), jbox.make_world(n).commit(), max_prediction=MAX_PRED,
                     num_players=n, input_spec=jbox.INPUT_SPEC, metrics=metrics)
    return session, runner, JSupervisor(session, runner, metrics=metrics), metrics


# The one counter the port's session keeps and the JAX package's does not:
# the settled checksums it compared (``chip_smoke.py``'s phase 10 reads it).
PORT_ONLY_COUNTERS = {"checksums_compared"}


def counters(metrics, pkg="torch") -> dict:
    """A peer's counters, the port's without its own extra ones."""
    return {k: v for k, v in metrics.counters.items()
            if pkg != "torch" or k not in PORT_ONLY_COUNTERS}


def event_log(events):
    """Each peer's events in order, by kind name, with address and data."""
    return [[(e.kind.name, e.addr, e.data) for e in ev] for ev in events]


def shift_translation(runner):
    """The injected desync: every cube 1.0 off its trajectory."""
    comps = dict(runner.state.components)
    comps["translation"] = comps["translation"] + np.float32(1.0)
    runner.state = runner.state.replace(components=comps)


def desync_heal(pkg, net):
    """Three supervised peers; peer 2's world shifted after 40 iterations,
    then 120 and 80 more. Returns the numbers the packages must share."""
    trio = [make_supervised(net, 3, me, pkg) for me in range(3)]
    events = [[], [], []]
    sup_run(net, trio, 40, events)
    assert all(s.current_state().name == "RUNNING" for s, *_ in trio)
    shift_translation(trio[2][1])
    sup_run(net, trio, 120, events)
    sup_run(net, trio, 80, events)
    recovered = sup_kinds(events[2], "RECOVERED")
    return {
        "trio": trio, "events": events, "recovered": recovered,
        "counters": [counters(m, pkg) for *_, m in trio],
        "recovery_frames": list(trio[2][3].series["recovery_frames"]),
        "recovery_at": [(e.data["frame"], e.data["kind"]) for e in recovered],
        "settled": sup_settled([s for s, *_ in trio]),
        "runner_frames": [r.frame for _, r, *_ in trio],
    }


class TestSyncBackoff:
    def sends(self, endpoint_cls):
        ep = endpoint_cls(("peer", 1), np.random.RandomState(3))
        sends, t = [], 0.0
        while t < 40.0:
            before = len(ep.outbox)
            ep.poll(t, 0, 0)
            if len(ep.outbox) > before:
                sends.append(t)
            t += 0.05
        return sends

    def test_unanswered_sync_requests_back_off_exponentially(self):
        sends = self.sends(PeerEndpoint)
        assert sends == self.sends(JEndpoint)
        gaps = [b - a for a, b in zip(sends, sends[1:])]
        assert len(sends) >= 5
        assert gaps[0] < 0.5
        assert max(gaps) >= 4.0
        cap_at = next(i for i, g in enumerate(gaps) if g >= 4.0)
        rising = gaps[: cap_at + 1]
        assert all(a < b for a, b in zip(rising, rising[1:]))
        assert all(g >= 4.0 for g in gaps[cap_at:])

    def test_progress_resets_backoff(self):
        ep = PeerEndpoint(("peer", 1), np.random.RandomState(3))
        for i in range(200):
            ep.poll(i * 0.2, 0, 0)
        assert ep._sync_failures > 3
        ep.on_message(proto.SyncReply(ep._sync_nonce), 40.0, lambda m: None)
        assert ep._sync_failures == 0


class TestDesyncQuarantineRecovery:
    def test_three_peer_heal_matches_jax(self):
        """The injected desync quarantines exactly the victim, which adopts
        a settled ring snapshot, replays and rejoins bitwise; the counters,
        recovery frames and settled streams equal JAX's same harness."""
        port = desync_heal("torch", LoopbackNetwork())
        ref = desync_heal("jax", JLoopback())
        for key in ("counters", "recovery_frames", "recovery_at", "settled", "runner_frames"):
            assert port[key] == ref[key], key
        assert event_log(port["events"]) == event_log(ref["events"])

        trio, events, recovered = port["trio"], port["events"], port["recovered"]
        victim = trio[2]
        m = victim[3]
        assert m.counters["desyncs_detected"] >= 1
        assert m.counters["quarantines"] == 1
        assert m.counters["recoveries"] == 1
        assert recovered and recovered[0].data["kind"] == proto.STATE_KIND_RING
        assert sup_kinds(events[2], "QUARANTINED")
        assert victim[2].health == Health.HEALTHY
        assert len(m.series["recovery_latency_ms"]) == 1
        assert len(m.series["recovery_frames"]) == 1
        for i in (0, 1):
            assert trio[i][3].counters["quarantines"] == 0
        assert sum(trio[i][3].counters["state_transfers_served"] for i in (0, 1)) >= 1
        recovery_frame = recovered[0].data["frame"]
        tail = {f: row for f, row in port["settled"].items() if f > recovery_frame}
        assert len(tail) >= 3
        for f, row in tail.items():
            assert row[0] == row[1] == row[2], f"frame {f} diverged: {row}"
        for ev in events:
            assert not [e for e in sup_kinds(ev, "DESYNC_DETECTED")
                        if e.data["frame"] > recovery_frame]

    def test_majority_side_never_pauses(self):
        net = LoopbackNetwork()
        trio = [make_supervised(net, 3, me) for me in range(3)]
        sup_run(net, trio, 40)
        shift_translation(trio[2][1])
        sup_run(net, trio, 120)
        for i in (0, 1):
            assert trio[i][2].health == Health.HEALTHY
            assert trio[i][3].counters["quarantines"] == 0


def kill_restart(net, pkgs=("torch", "torch"), iters=(50, 60, 200), device="cpu"):
    """Peer 1 dies after ``iters[0]`` iterations (its socket closed, as a
    ``KillRestart`` directive scripts), peer 0 runs on alone for
    ``iters[1]``, then a fresh peer 1 of ``pkgs[1]`` rejoins from peer 0's
    full checkpoint for ``iters[2]``."""
    plan = ChaosPlan(7, (KillRestart(at=iters[0] * SUP_DT, peer=("peer", 1),
                                     down_for=iters[1] * SUP_DT),))
    a = make_supervised(net, 2, 0, pkgs[0], device=device)
    b = make_supervised(net, 2, 1, pkgs[1], device=device)
    ev_a = []
    sup_run(net, [a, b], iters[0])
    assert a[0].current_state().name == "RUNNING"
    (kill,) = plan.kill_restarts()
    b[0].socket.close()
    sup_run(net, [a], round(kill.down_for / SUP_DT), [ev_a])
    frame_at_restart = a[0].current_frame
    b2 = make_supervised(net, 2, 1, pkgs[1], device=device)
    b2[2].begin_rejoin(("peer", 0))
    assert not b2[2].should_advance()
    sup_run(net, [a, b2], iters[2], [ev_a, None])
    return a, b2, ev_a, frame_at_restart


def check_rejoin(a, b2, ev_a, frame_at_restart):
    assert b2[3].counters["recoveries"] == 1
    assert b2[2].health.name == "HEALTHY"
    assert sup_kinds(ev_a, "PLAYER_REJOINED")
    assert 1 not in a[0]._disconnected
    assert a[3].counters["state_transfers_served"] >= 1
    assert b2[0].current_frame > frame_at_restart + MAX_PRED
    assert b2[2]._freeze_until is None
    tail = {f: row for f, row in sup_settled([a[0], b2[0]]).items() if f > frame_at_restart}
    assert len(tail) >= 3
    for f, row in tail.items():
        assert row[0] == row[1], f"frame {f} diverged after rejoin: {row}"


class TestCrashRejoin:
    def test_kill_restart_full_state_rejoin(self):
        net = LoopbackNetwork()
        a, b2, ev_a, frame_at_restart = kill_restart(net)
        assert a[3].counters["peer_disconnects"] == 1
        assert a[3].counters["reconnects_initiated"] == 1
        assert a[0].current_state().name == "RUNNING"
        check_rejoin(a, b2, ev_a, frame_at_restart)
        # The native queues took the gap-fill: the rejoiner's own handle is
        # confirmed up to its session's frontier.
        q = b2[0]._queues[1]
        assert type(q).__name__ == "_NativeQueueView"
        assert q.last_confirmed_frame >= b2[0].current_frame - 1

    def test_rejoin_on_the_python_plane(self, monkeypatch):
        monkeypatch.setenv("GGRS_NO_NATIVE", "1")
        net = LoopbackNetwork()
        a, b2, ev_a, frame_at_restart = kill_restart(net)
        assert type(b2[0]._queues[1]).__name__ == "InputQueue"
        check_rejoin(a, b2, ev_a, frame_at_restart)


class TestPartitionHeal:
    def test_asymmetric_partition_interrupts_then_heals(self):
        net = LoopbackNetwork()
        a = make_supervised(net, 2, 0, disconnect_timeout=2.0)
        b = make_supervised(net, 2, 1, disconnect_timeout=2.0)
        t0 = 0.6
        plan = ChaosPlan(11, (Partition(t0, t0 + 1.0, src=("peer", 0)),))
        a[0].socket = ChaosSocket(a[0].socket, plan, clock=lambda: net.now, addr=("peer", 0))
        ev_b = []
        for _ in range(240):
            net.advance(SUP_DT)
            sup_step(net, a, sup_keys)
            sup_step(net, b, sup_keys, ev_b)
        names = [e.kind for e in ev_b]
        assert EventKind.NETWORK_INTERRUPTED in names
        assert EventKind.NETWORK_RESUMED in names
        assert EventKind.DISCONNECTED not in names
        assert b[2].health == Health.HEALTHY
        assert b[3].counters["network_interruptions"] >= 1
        healed = {f: r for f, r in sup_settled([a[0], b[0]]).items() if f > 0}
        assert len(healed) >= 3
        assert all(r[0] == r[1] for r in healed.values())
        assert any(k == "partition" for _, k, _ in a[0].socket.faults)


def test_a_degraded_peer_reports_each_health_edge():
    """The supervisor's FSM goes healthy -> degraded -> healthy through a
    partition, and every edge reaches the tracer as a ``health`` instant
    (the records FlightRecorder and the Perfetto export read)."""
    from bevy_ggrs_tpu_torch.obs import SpanTracer

    net = LoopbackNetwork()
    tracer = SpanTracer(clock=lambda: net.now)
    a = make_supervised(net, 2, 0, disconnect_timeout=2.0)
    b = make_supervised(net, 2, 1, disconnect_timeout=2.0, tracer=tracer)
    plan = ChaosPlan(11, (Partition(0.6, 1.6, src=("peer", 0)),))
    a[0].socket = ChaosSocket(a[0].socket, plan, clock=lambda: net.now, addr=("peer", 0))
    sup_run(net, [a, b], 240)
    edges = [(ev[3]["prev"], ev[3]["to"]) for ev in tracer._events
             if ev[0] == "I" and ev[1] == "health"]
    assert edges == [("healthy", "degraded"), ("degraded", "healthy")]
    assert b[2].tracer is tracer


def test_transfer_digest_is_the_world_checksum():
    from bevy_ggrs_tpu_torch.ops.checksum import checksum_plain
    from bevy_ggrs_tpu_torch.session.supervisor import transfer_digest
    from bevy_ggrs_tpu_torch.state import combine64

    import bevy_ggrs_tpu.state as js

    world = tbox.make_world(2, device="cpu").commit()
    jworld = jbox.make_world(2).commit()
    digest = transfer_digest(world)
    assert digest == combine64(checksum_plain(world))
    assert digest == js.combine64(js.checksum(jworld))

