"""The port's observability modules against the JAX package's, on the CPU.

For the same inputs both packages give equal output: ``SpanTracer``'s
Perfetto trace, JSONL stream, summary and open-span stack for one span
script on a stepped clock; ``FlightRecorder``'s records of a supervised
two-peer session under a chaos socket; ``DesyncForensics``' dumps of an
injected desync; ``export_prometheus``'s text for equal ``Metrics``,
``TimeSeries`` and recorder; and the ``P2Quantile`` / ``MetricWindow``
estimates, float for float. Last, ``chip_smoke.py``'s phase 15 (the
supervised sessions, their exports and the checkpoints) on the CPU.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from bevy_ggrs_tpu import obs as jobs
from bevy_ggrs_tpu.chaos import ChaosPlan as JPlan
from bevy_ggrs_tpu.chaos import ChaosSocket as JChaos
from bevy_ggrs_tpu.chaos import Corrupt as JCorrupt
from bevy_ggrs_tpu.chaos import LossBurst as JLoss
from bevy_ggrs_tpu.obs import trace as jtrace
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JLoopback
from bevy_ggrs_tpu.utils.metrics import Metrics as JMetrics
from bevy_ggrs_tpu_torch import obs
from bevy_ggrs_tpu_torch.chaos import ChaosPlan, ChaosSocket, Corrupt, LossBurst
from bevy_ggrs_tpu_torch.obs import trace as ttrace
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork
from bevy_ggrs_tpu_torch.utils.metrics import Metrics

from chip_smoke import SUP_DT, sup_keys, sup_step
from tests.test_torch_supervisor import make_supervised, shift_translation

PKGS = {
    "jax": types.SimpleNamespace(obs=jobs, trace=jtrace, Metrics=JMetrics, net=JLoopback,
                                 Plan=JPlan, Chaos=JChaos, Loss=JLoss, Corrupt=JCorrupt),
    "torch": types.SimpleNamespace(obs=obs, trace=ttrace, Metrics=Metrics, net=LoopbackNetwork,
                                   Plan=ChaosPlan, Chaos=ChaosSocket, Loss=LossBurst,
                                   Corrupt=Corrupt),
}


class Stepped:
    """A clock that moves 0.25 ms each read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.00025
        return self.t


def span_script(pkg, tmp_path, capacity=200_000):
    m = PKGS[pkg]
    tr = m.obs.SpanTracer(capacity=capacity, clock=Stepped(), pid=3, tid=1,
                          process_name="peer-3", wall_t0=1234.5)
    # The span stack registry is per thread and per process: spans other
    # tests on this thread left open sit below this script's.
    below = len(m.trace.open_span_stack(threading.get_ident()))
    stacks = []
    with tr.span("sup_tick"):
        with tr.span("dispatch", frames=8):
            tr.instant("health", prev="healthy", to="quarantined")
            stacks.append(m.trace.open_span_stack(threading.get_ident())[below:])
        with tr.span("spec_rollout", branches=64):
            with tr.span("serve_tick"):
                pass
        with tr.span("relay_fanout"):
            tr.instant("drop")
    outer = tr.span("attest")
    outer.__enter__()
    with tr.span("sdc_repair", frames=3):
        pass
    tok = m.trace.push_span("manual")
    stacks.append(m.trace.open_span_stack(threading.get_ident())[below:])
    m.trace.pop_span(tok)
    m.trace.pop_span(tok)  # a second pop is a no-op
    path = tmp_path / f"{pkg}.jsonl"
    n = tr.export_jsonl(str(path))
    trace = m.obs.export_perfetto(tr, str(tmp_path / f"{pkg}.json"))
    with open(tmp_path / f"{pkg}.json") as f:
        assert json.load(f) == trace
    outer.__exit__(None, None, None)
    return {"trace": trace, "jsonl": path.read_text(), "n": n, "summary": tr.summary(),
            "stacks": stacks}


@pytest.mark.parametrize("capacity", [200_000, 7], ids=["whole", "evicted"])
def test_span_tracer_exports_equal_jax(tmp_path, capacity):
    port, ref = span_script("torch", tmp_path, capacity), span_script("jax", tmp_path, capacity)
    assert port == ref
    events = port["trace"]["traceEvents"]
    tracks = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    if capacity > 100:
        assert tracks == {"session", "spec", "server", "relay"}
        assert port["stacks"] == [("sup_tick", "dispatch"), ("attest", "manual")]
        assert port["summary"]["dispatch"]["count"] == 1
    # Every begin has its end, the open "attest" closed at export.
    body = [e for e in events if e["ph"] in "BE"]
    assert sum(e["ph"] == "B" for e in body) == sum(e["ph"] == "E" for e in body)


def test_null_tracer_is_shared_and_empty():
    assert obs.null_tracer.span("x") is obs.null_tracer.span("y")
    assert obs.null_tracer.summary() == {}
    assert obs.null_tracer.export_perfetto() == jobs.null_tracer.export_perfetto()


def recorded_session(pkg):
    """Two supervised peers on a lossy network, peer 0 behind a chaos
    socket, captured every iteration by a recorder on the network clock."""
    m = PKGS[pkg]
    net = m.net(latency=2 * SUP_DT, loss=0.05, seed=3)
    peers = [make_supervised(net, 2, me, pkg) for me in range(2)]
    plan = m.Plan(5, (m.Loss(0.3, 0.6, 0.5), m.Corrupt(0.8, 1.0, 0.3)))
    peers[0][0].socket = m.Chaos(peers[0][0].socket, plan, clock=lambda: net.now,
                                 addr=("peer", 0))
    recorders = [m.obs.FlightRecorder(capacity=512, clock=lambda: net.now) for _ in peers]
    for i in range(150):
        net.advance(SUP_DT)
        for peer, rec in zip(peers, recorders):
            sup_step(net, peer, sup_keys, recorder=rec)
        if i == 60:
            shift_translation(peers[1][1])  # a quarantine, a transfer, a recovery
    return peers, recorders


def test_flight_recorder_records_equal_jax(tmp_path):
    (peers, recs), (jpeers, jrecs) = recorded_session("torch"), recorded_session("jax")
    for rec, jrec in zip(recs, jrecs):
        assert rec.to_dicts() == jrec.to_dicts()
        assert rec.rollback_histogram() == jrec.rollback_histogram()
        assert rec.health_transitions() == jrec.health_transitions()
        assert rec.export_jsonl(str(tmp_path / "a.jsonl")) == len(rec.records)
        jrec.export_jsonl(str(tmp_path / "b.jsonl"))
        assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()
    records = recs[1].to_dicts()
    assert any(r["faults"] for r in recs[0].to_dicts())
    assert any(r["rollbacks"] for r in records)
    assert [t[1:] for t in recs[1].health_transitions()] == [
        ("HEALTHY", "QUARANTINED"), ("QUARANTINED", "HEALTHY")]
    assert any("RECOVERED" in r["events"] for r in records)
    # Every frontier the recorder read is the runner's own counter.
    assert records[-1]["frame"] == peers[1][0].current_frame


def forensics_dumps(pkg, tmp_path):
    m = PKGS[pkg]
    net = m.net()
    peers = [make_supervised(net, 2, me, pkg) for me in range(2)]
    recs = [m.obs.FlightRecorder(clock=lambda: net.now) for _ in peers]
    out = tmp_path / pkg
    fx = [m.obs.DesyncForensics(p[0], p[1], rec, out_dir=str(out), tag=f"_p{i}")
          for i, (p, rec) in enumerate(zip(peers, recs))]
    for i in range(90):
        net.advance(SUP_DT)
        for peer, f, rec in zip(peers, fx, recs):
            session, runner = peer[0], peer[1]
            session.poll_remote_clients()
            events = session.events()
            f.scan(events)
            if session.current_state().name == "RUNNING":
                for h in session.local_player_handles():
                    session.add_local_input(h, sup_keys(h, session.current_frame))
                try:
                    runner.handle_requests(session.advance_frame(), session)
                except Exception as e:
                    if type(e).__name__ != "PredictionThreshold":
                        raise
            rec.capture(session=session, runner=runner, events=events)
        if i == 30:
            shift_translation(peers[1][1])
    return [f.dumps for f in fx], sorted(p.name for p in out.iterdir())


def test_desync_forensics_dumps_equal_jax(tmp_path):
    port, files = forensics_dumps("torch", tmp_path)
    ref, jfiles = forensics_dumps("jax", tmp_path)
    assert port == ref and files == jfiles
    assert all(port), "both peers dumped the desync"
    dump = port[1][0]
    assert dump["schema"] == "bevy_ggrs_tpu/desync-forensics/v1"
    assert dump["breakdown_source"] == "ring"
    diff = obs.DesyncForensics.compare(port[0][0], port[1][0])
    assert diff == jobs.DesyncForensics.compare(ref[0][0], ref[1][0])
    assert "component/translation" in diff["divergent_fields"]


def fill(pkg):
    """Equal instruments of a package: Metrics (counters, series, labeled),
    a TimeSeries and a recorder over a stub runner."""
    m = PKGS[pkg]
    rng = np.random.RandomState(11)
    metrics = m.Metrics()
    series = m.obs.TimeSeries(window=64)
    rec = m.obs.FlightRecorder(clock=lambda: 0.0)
    runner = types.SimpleNamespace(frame=0, rollbacks_total=0, rollback_frames_total=0,
                                   ledger=None)
    for i in range(300):
        metrics.count("frames_advanced")
        metrics.count("recoveries", labels={"peer": f'p"{i % 3}'})
        metrics.observe("recovery_latency_ms", float(rng.gamma(2.0, 3.0)))
        metrics.observe("tick_ms", float(rng.standard_normal()) + 5, labels={"slot": i % 2})
        series.observe("tick_ms", float(rng.exponential(4.0)))
        series.observe(f"s{i % 5}", float(i))
        runner.frame += 1
        if i % 7 == 0:
            runner.rollbacks_total += 1
            runner.rollback_frames_total += 1 + i % 5
        rec.capture(runner=runner)
    return metrics, series, rec


def test_prometheus_text_equal_jax(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    port, ref = fill("torch"), fill("jax")
    now[0] = 112.5
    text = obs.export_prometheus(*port[:1], recorder=port[2], timeseries=port[1])
    ref_text = jobs.export_prometheus(*ref[:1], recorder=ref[2], timeseries=ref[1])
    # Each package's text carries its process's compile section (JAX's
    # XLA compiles, the port's builds) once anything in the process
    # built; the rest is equal. test_torch_serve_obs.py holds the two
    # compile sections equal for equal events.
    assert [line for line in text.splitlines() if "ggrs_xla_" not in line] == [
        line for line in ref_text.splitlines() if "ggrs_xla_" not in line]
    assert "ggrs_recoveries_total{peer=\"p\\\"0\"}" in text
    assert 'ggrs_ts_tick_ms{quantile="0.99"}' in text
    assert "ggrs_rollback_depth_bucket" in text


def test_p2_quantile_and_windows_equal_jax():
    rng = np.random.RandomState(5)
    stream = np.concatenate([rng.exponential(3.0, 2000), rng.standard_normal(500) * 50])
    for q in (0.5, 0.9, 0.95, 0.99):
        a, b = obs.P2Quantile(q), jobs.P2Quantile(q)
        for i, x in enumerate(stream):
            a.add(x)
            b.add(x)
            if i in (0, 3, 4, 5, 100):
                assert a.value() == b.value()
        assert a.value() == b.value() and a.count == b.count
    wa, wb = obs.MetricWindow("w", window=100), jobs.MetricWindow("w", window=100)
    for x in stream[:777]:
        wa.observe(x)
        wb.observe(x)
    assert wa.snapshot() == wb.snapshot()
    assert wa.window_values() == wb.window_values()
    ta, tb = obs.TimeSeries(max_series=2), jobs.TimeSeries(max_series=2)
    for name in ("a", "b", "c"):
        ta.observe(name, 1.0)
        tb.observe(name, 1.0)
    assert ta.snapshot() == tb.snapshot() and ta.dropped == tb.dropped == 1
    assert obs.null_timeseries.snapshot() == {} and not obs.null_timeseries.enabled


def test_exports_match_jax_names():
    """Every name the port's ``obs`` exports is one the JAX package's
    exports too."""
    assert set(obs.__all__) <= set(jobs.__all__)
    assert {"SpanTracer", "FlightRecorder", "FrameRecord", "DesyncForensics",
            "desync_report", "MetricWindow", "P2Quantile", "TimeSeries", "null_timeseries",
            "export_prometheus", "export_perfetto", "null_tracer"} <= set(obs.__all__)


def test_chip_smoke_phase_15_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s supervisor phase on the CPU: the same four
    pieces and checks (the heal with its exports, the rejoin, the ring bit,
    the resume from disk), the resumed SyncTest and the flips smaller; the
    digests' kernel launches are the card's only."""
    import json

    import chip_smoke
    from bevy_ggrs_tpu_torch import integrity
    from bevy_ggrs_tpu_torch import state as ts
    from bevy_ggrs_tpu_torch.ops import checksum as tck

    obs_dir = tmp_path / "obs"
    out = chip_smoke.supervisor_phase(
        (tck.world_checksum,), ts, tck, integrity, device="cpu", out_dir=str(obs_dir),
        disk={"frames": 90, "crash": 70, "interval": 20, "keep": 3}, seeds=4)
    for piece in ("heal", "rejoin", "sdc", "disk"):
        assert out[piece]["checks"] and all(out[piece]["checks"].values()), piece
    heal = out["heal"]
    assert heal["counters"][2]["quarantines"] == heal["counters"][2]["recoveries"] == 1
    assert len(heal["recovery_latency_ms"]) == len(heal["recovery_frames"]) == 1
    assert heal["transfer"]["chunks"] >= 1 and heal["transfer"]["bytes"] > 0
    assert heal["digests"] >= 2  # served and adopted
    assert out["rejoin"]["counters"][1]["recoveries"] == 1
    assert out["rejoin"]["counters"][0]["players_rejoined"] == 1
    assert out["disk"]["saved"] == [20, 40, 60] and out["disk"]["resumed_at"] == 60
    assert out["disk"]["fallbacks"] >= 2
    trace = json.loads((obs_dir / "peer2.perfetto.json").read_text())
    assert any(e["name"] == "sup_apply_transfer" for e in trace["traceEvents"])
    assert "ggrs_recoveries_total 1" in (obs_dir / "metrics.prom").read_text()
    assert len((obs_dir / "peer2.frames.jsonl").read_text().splitlines()) == 240
