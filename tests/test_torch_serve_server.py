"""PyTorch port, the match server: ``serve/server.py``.

SyncTest matches served by the port's ``MatchServer`` give, match by
match and frame by frame, the state checksums the JAX package's server
gives; occupancy gauges, the flight recorder and the Prometheus labels
follow churn. A session that raises is fenced to a recovery lane and
readmitted, a hung one is fenced by the watchdog, and a suspended match
resumes: each bitwise an uninterrupted control, with no build or layout
preparation after warmup. ``chip_smoke.py``'s phase 16 runs here small.
"""

import numpy as np

import chip_smoke
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.serve.server import MatchServer as JServer
from bevy_ggrs_tpu.session.builder import SessionBuilder as JBuilder
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.obs.prom import export_prometheus
from bevy_ggrs_tpu_torch.obs.recorder import FlightRecorder
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.serve import MatchServer, SlotHealth
from bevy_ggrs_tpu_torch.session.builder import SessionBuilder
from bevy_ggrs_tpu_torch.utils import build_cache
from bevy_ggrs_tpu_torch.utils.metrics import Metrics

P, MAXPRED, BRANCHES, SPEC_FRAMES = 2, 4, 8, 3


def make_server(pkg="torch", metrics=None, **kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("stagger_groups", 2)
    if pkg == "torch":
        server = MatchServer(tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
                             MAXPRED, P, tbox.INPUT_SPEC, num_branches=BRANCHES,
                             spec_frames=SPEC_FRAMES, metrics=metrics, device="cpu", **kw)
    else:
        server = JServer(jbox.make_schedule(), jbox.make_world(P).commit(), MAXPRED, P,
                         jbox.INPUT_SPEC, num_branches=BRANCHES, spec_frames=SPEC_FRAMES,
                         metrics=metrics, **kw)
    server.warmup()
    return server


def make_synctest(pkg="torch"):
    builder = SessionBuilder(tbox.INPUT_SPEC) if pkg == "torch" else JBuilder(jbox.INPUT_SPEC)
    return (builder.with_num_players(P).with_max_prediction_window(MAXPRED)
            .with_check_distance(2).start_synctest_session())


def inputs_for(seed):
    def f(frame, handle):
        return np.uint8((frame * 3 + handle * 5 + seed) % 16)

    return f


def slot_cs(server, h, pkg="torch"):
    core = server.groups[h.group]
    if pkg == "torch":
        return ts.combine64(ts.checksum(core.slot_state(h.slot)))
    return js.combine64(js.checksum(core.slot_state(h.slot)))


def test_synctest_streams_equal_jax_server(tmp_path):
    metrics = Metrics()
    servers = {"torch": make_server(metrics=metrics), "jax": make_server("jax")}
    handles = {pkg: [s.add_match(make_synctest(pkg), inputs_for(k)) for k in range(3)]
               for pkg, s in servers.items()}
    streams = {pkg: [] for pkg in servers}
    for frame in range(16):
        if frame == 12:
            for pkg, s in servers.items():
                s.retire_match(handles[pkg][0])
        for pkg, s in servers.items():
            s.run_frame()
            live = handles[pkg][1:] if frame >= 12 else handles[pkg]
            streams[pkg].append([(s.groups[h.group].slots[h.slot].frame, slot_cs(s, h, pkg))
                                 for h in live])
    assert streams["torch"] == streams["jax"]
    port = servers["torch"]
    assert [(h.group, h.slot) for h in handles["torch"]] == [
        (h.group, h.slot) for h in handles["jax"]]
    assert port.faults_total == 0 and port.slots_active == 2 and port.slots_free == 2
    rec = FlightRecorder().capture(server=port)
    assert rec.slots_active == 2 and rec.slots_free == 2 and rec.stagger_jitter_ms is not None
    text = export_prometheus(metrics)
    assert 'match_slot="' in text and "ggrs_frames_served_total" in text
    out = port.export_telemetry(str(tmp_path))
    assert {"metrics", "slo", "report"} <= set(out)
    assert "serve" in (tmp_path / "server_report.html").read_text()


def test_served_p2p_matches_are_supervised():
    """A P2P match on the server gets a ``SessionSupervisor`` over its
    batch slot; two matches against external supervised port peers over
    the loopback run 90 frames with no desync and no fault, each slot's
    confirmed frames bitwise its peer's."""
    from bevy_ggrs_tpu_torch.runner import RollbackRunner
    from bevy_ggrs_tpu_torch.session import PlayerType
    from bevy_ggrs_tpu_torch.session.supervisor import SessionSupervisor
    from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

    net = LoopbackNetwork()
    metrics = Metrics()
    server = make_server(metrics=metrics, capacity=2, stagger_groups=1,
                         clock=lambda: net.now, attest_interval=None)

    def session(m, local):
        b = (SessionBuilder(tbox.INPUT_SPEC).with_num_players(P)
             .with_max_prediction_window(MAXPRED).with_disconnect_timeout(1.0))
        for h in range(P):
            b.add_player(PlayerType.local() if h == local else PlayerType.remote(
                (("ext", "srv")[local], m)), h)
        return b.start_p2p_session(net.socket((("srv", "ext")[local], m)),
                                   clock=lambda: net.now)

    handles = [server.add_match(session(m, 0), lambda f, h: chip_smoke.sup_keys(h, f))
               for m in range(2)]
    ext = []
    for m in range(2):
        sess = session(m, 1)
        runner = RollbackRunner(tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
                                max_prediction=MAXPRED, num_players=P,
                                input_spec=tbox.INPUT_SPEC, device="cpu")
        ext.append((sess, runner, SessionSupervisor(sess, runner, metrics=Metrics()), Metrics()))
    assert all(server._matches[h].supervisor is not None for h in handles)
    for _ in range(90):
        net.advance(1.0 / 60.0)
        server.run_frame()
        for peer in ext:
            chip_smoke.sup_step(net, peer)
    server.groups[0].flush_reports()
    assert server.faults_total == 0 and not metrics.counters.get("desyncs_detected")
    for h, (sess, runner, sup, _) in zip(handles, ext):
        core = server.groups[h.group]
        assert core.slots[h.slot].frame > 60 and runner.frame > 60
        assert sup.health.name == "HEALTHY"
        # A frame both rings still hold and both sides confirmed.
        f = min(core.slots[h.slot].frame, runner.frame) - MAXPRED - 1
        row = f % core.ring_depth
        assert int(core.rings.frames[h.slot, row]) == int(runner.ring.frames[row]) == f
        assert core.rings.checksums[h.slot, row].tolist() == runner.ring.checksums[row].tolist()


class HungSession:
    """Burns fake-clock time inside ``advance_frame`` for some frames."""

    def __init__(self, inner, clk, hang_frames, hang_s=0.2):
        self._inner, self._clk, self._hang, self._hang_s = inner, clk, set(hang_frames), hang_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def advance_frame(self):
        if self._inner.current_frame in self._hang:
            self._clk[0] += self._hang_s
        return self._inner.advance_frame()


def test_session_error_isolated_readmitted_no_build():
    metrics = Metrics()
    server, control = make_server(metrics=metrics), make_server()
    handles = [server.add_match(chip_smoke.FlakySession(make_synctest(), 5), inputs_for(9)),
               server.add_match(make_synctest(), inputs_for(1)),
               server.add_match(make_synctest(), inputs_for(2))]
    c_handles = [control.add_match(make_synctest(), inputs_for(k)) for k in (9, 1, 2)]
    for _ in range(4):
        server.run_frame()
        control.run_frame()
    base = build_cache.compile_counters()
    recovering = 0
    for _ in range(11):
        server.run_frame()
        control.run_frame()
        recovering += FlightRecorder().capture(server=server).slots_recovering
    assert server.faults_total == 1 and server.readmissions_total == 1 and recovering >= 1
    assert 0 < server.last_recovery_frames <= 8
    assert metrics.counters["slot_faults"] == 1
    bad = server._matches[handles[0]]
    assert bad.fsm.state is SlotHealth.HEALTHY and bad.fsm.last_reason == "session_error"
    assert build_cache.compile_counters() == base and server.cache_size() == 1
    for h, c in zip(handles, c_handles):
        assert server.groups[h.group].slots[h.slot].frame == 15
        assert slot_cs(server, h) == slot_cs(control, c)


def test_watchdog_fences_hung_session():
    clk = [0.0]
    metrics = Metrics()
    server = make_server(metrics=metrics, clock=lambda: clk[0], watchdog_budget_ms=50.0,
                         watchdog_strike_limit=3)
    hung = server.add_match(HungSession(make_synctest(), clk, {4, 5, 6}), inputs_for(3))
    blip = server.add_match(HungSession(make_synctest(), clk, {2}), inputs_for(4))
    ok = server.add_match(make_synctest(), inputs_for(5))
    for _ in range(4):
        server.run_frame()
    assert server.health_of(hung) is SlotHealth.HEALTHY
    server.run_frame()
    assert server.health_of(hung) is SlotHealth.DEGRADED and server.faults_total == 0
    for _ in range(7):
        server.run_frame()
    assert server.faults_total == 1 and server.readmissions_total == 1
    m = server._matches[hung]
    assert m.fsm.state is SlotHealth.HEALTHY and m.fsm.last_reason == "watchdog_timeout"
    assert sum(v for k, v in metrics.counters.items() if k.startswith("watchdog_strikes")) >= 4
    assert server.health_of(blip) is SlotHealth.HEALTHY
    assert server.groups[ok.group].slots[ok.slot].frame == 12
    assert m.session.current_frame >= 12


def test_suspend_resume_same_match():
    server, ref = make_server(), make_server()
    sess = make_synctest()
    h = server.add_match(sess, inputs_for(7))
    other = server.add_match(make_synctest(), inputs_for(8))
    r = ref.add_match(make_synctest(), inputs_for(7))
    for _ in range(6):
        server.run_frame()
        ref.run_frame()
    ticket = server.suspend_match(h)
    assert ticket.frame == 6 and server.slots_active == 1
    for _ in range(4):
        server.run_frame()
    h2 = server.resume_match(sess, inputs_for(7), ticket)
    for _ in range(6):
        server.run_frame()
        ref.run_frame()
    assert server.groups[h2.group].slots[h2.slot].frame == 12
    assert slot_cs(server, h2) == slot_cs(ref, r)
    assert server.groups[other.group].slots[other.slot].frame == 16


def test_chip_smoke_phase_16_on_the_cpu(tmp_path):
    """Phase 16 at a small size on the CPU: the burst's and the rollout's
    slot saves against their plain version, the box_game core (churn,
    sampled singletons, a cpu twin), the boids core (its force operands at
    both shapes) and the server's crash, sdc and kill/restore."""
    kernels = (tck.world_checksum, tpw.pairwise_force_rows)
    line = chip_smoke.serve_phase(kernels, ts, tck, integrity, tpw, device="cpu",
                                  out_dir=str(tmp_path), small=True)
    assert line["server"]["faults"] == line["server"]["readmissions"] == 1
    assert line["server"]["sdc_detected"] == line["server"]["sdc_injected"] == 1
    # 12 timed boids ticks and the one that records the force operands.
    assert line["core"]["ticks"] == 18 and line["boids"]["ticks"] == 13
    assert line["boids"]["force_err"] == 0.0  # the plain version on the CPU
