"""PyTorch port, the serving tier's observability against the JAX package.

For the same inputs (and clocks) the port's ``obs/provenance.py``
records and exports, ``serve/admission.py`` traces, ``obs/slo.py`` slot
and window levels, ``obs/profiler.py`` folded stacks, flame trees and
reports, ``obs/report.py`` HTML, ``obs/attribution.py`` breakdowns and
``obs/prom.py``'s compile section (fed by ``utils/build_cache.py``, JAX's
by ``utils/xla_cache.py``) equal the JAX package's.
"""

import time

import numpy as np
import pytest

from bevy_ggrs_tpu import obs as jobs
from bevy_ggrs_tpu.obs import attribution as jattr
from bevy_ggrs_tpu.obs import profiler as jprof
from bevy_ggrs_tpu.obs import provenance as jprov
from bevy_ggrs_tpu.obs import report as jreport
from bevy_ggrs_tpu.obs import slo as jslo
from bevy_ggrs_tpu.serve import admission as jadm
from bevy_ggrs_tpu.session import protocol as jproto
from bevy_ggrs_tpu.utils import metrics as jmetrics
from bevy_ggrs_tpu.utils import xla_cache
from bevy_ggrs_tpu_torch import obs as tobs
from bevy_ggrs_tpu_torch.obs import attribution as tattr
from bevy_ggrs_tpu_torch.obs import profiler as tprof
from bevy_ggrs_tpu_torch.obs import provenance as tprov
from bevy_ggrs_tpu_torch.obs import report as treport
from bevy_ggrs_tpu_torch.obs import slo as tslo
from bevy_ggrs_tpu_torch.serve import admission as tadm
from bevy_ggrs_tpu_torch.utils import build_cache
from bevy_ggrs_tpu_torch.utils import metrics as tmetrics


def stepped(step=0.0015):
    now = [10.0]

    def clock():
        now[0] += step
        return now[0]

    return clock


def datagrams():
    msgs = [jproto.InputMsg(1, 40, bytes([3, 4, 5]), 3, 38, 41, -1),
            jproto.ChecksumReport(33, 0xDEADBEEF12345678), jproto.KeepAlive(),
            jproto.SyncRequest(7, 99), jproto.QualityReport(1234, 2)]
    out = [jproto.encode(m) for m in msgs]
    out += [b"", b"\x00\x01garbage", bytes(range(40))]
    return out


def test_provenance_records_and_export_equal_jax(tmp_path):
    for data in datagrams():
        assert tprov.flow_key(data) == jprov.flow_key(data)
    logs = [mod.ProvenanceLog("peer0", pid=3, clock=stepped(), wall_t0=1.7e9)
            for mod in (tprov, jprov)]
    for log in logs:
        log.set_context(match=5, epoch=2)
        for i, data in enumerate(datagrams()):
            log.record("tx" if i % 2 else "rx", data, ("127.0.0.1", 7000 + i))
        log.set_context(epoch=None)
        log.record("tx", datagrams()[0], "relay")
    assert logs[0].records() == logs[1].records()
    paths = [tmp_path / f"{k}.jsonl" for k in ("torch", "jax")]
    assert logs[0].export_jsonl(str(paths[0])) == logs[1].export_jsonl(str(paths[1]))
    assert paths[0].read_text() == paths[1].read_text()


def test_admission_traces_equal_jax():
    assert tadm.STAGES == jadm.STAGES
    for m in (0, 1, 77, 2**40 + 3):
        assert tadm.admission_key(m) == jadm.admission_key(m)
    snaps = []
    for mod in (tadm, jadm):
        tr = mod.AdmissionTrace(match_id=12, clock=stepped(0.002))
        tr.begin("first_frame")
        tr.begin("slot_warm")
        tr.end("slot_warm")
        with tr.stage("admit"):
            pass
        tr.record("session_warm", 1.25)
        assert tr.is_open("first_frame")
        tr.end("first_frame")
        tr.finish(server_id=2, handle=(1, 3))
        snaps.append((tr.snapshot(), tr.total_ms, tr.complete, dict(tr.durations)))
    assert snaps[0] == snaps[1]


def test_slot_and_window_slo_equal_jax():
    rng = np.random.RandomState(12)
    cfg = dict(short_window=16, long_window=64, min_samples=4)
    port = tslo.SlotSLO(config=tslo.SLOConfig(**cfg), metrics=tmetrics.Metrics())
    ref = jslo.SlotSLO(config=jslo.SLOConfig(**cfg), metrics=jmetrics.Metrics())
    for t in range(300):
        for slot in range(6):
            kw = dict(deadline_ok=bool(rng.rand() > 0.02 * slot),
                      rollback_depth=int(rng.randint(0, 8 + slot)),
                      recovery_debt=int(rng.randint(0, 40)) if slot == 5 else 0,
                      quarantined=bool(slot == 4 and t % 10 < 3))
            port.observe_tick(slot, **kw)
            ref.observe_tick(slot, **kw)
        if t % 25 == 24:
            assert port.export() == ref.export()
            for slot in range(6):
                assert port.burn_rates(slot) == ref.burn_rates(slot)
        if t == 200:
            port.forget(2)
            ref.forget(2)
    assert port.snapshot() == ref.snapshot()
    series = [tobs.TimeSeries(), jobs.TimeSeries()]
    objectives = {"admission": ("admission_ms", 8.0, 0.99), "frame": ("frame_ms", 16.7, 0.9)}
    wins = [tslo.WindowSLO(series[0], objectives, config=tslo.SLOConfig(**cfg)),
            jslo.WindowSLO(series[1], objectives, config=jslo.SLOConfig(**cfg))]
    for t in range(200):
        a, f = float(rng.exponential(4.0)), float(rng.normal(14.0, 3.0))
        for s in series:
            s.observe("admission_ms", a)
            s.observe("frame_ms", f)
        if t % 20 == 19:
            assert wins[0].export() == wins[1].export()
            assert wins[0].burn_rates("frame") == wins[1].burn_rates("frame")
    assert wins[0].snapshot() == wins[1].snapshot()


def fed(mod):
    p = mod.HostProfiler(interval_ms=2.0, seed=0, clock=lambda: 0.0, max_depth=3)
    stacks = [["main (x.py)", "tick (serve.py)", "build (batch.py)"],
              ["main (x.py)", "tick (serve.py)"], [], ["idle (x.py)"],
              ["main (x.py)", "a (b.py)", "c (d.py)", "e (f.py)"]]
    spans = [("serve_tick",), ("serve_tick", "serve_branch_build"), ("admission_admit",),
             (), ("serve_arg_assembly",)]
    t = 0.0
    for i in range(40):
        p.sample_once(now=t, frames=stacks[i % 5], span_stack=spans[(i * 3) % 5])
        t += 0.0017 + 0.0003 * (i % 4)
    return p


def test_profiler_output_equal_jax(tmp_path):
    assert tprof.NO_SPAN == jprof.NO_SPAN and tprof.UNATTRIBUTED == jprof.UNATTRIBUTED
    a, b = fed(tprof), fed(jprof)
    assert a.folded() == b.folded()
    assert a.stage_table() == b.stage_table()
    assert a.flame_tree() == b.flame_tree()
    assert a.report() == b.report()
    assert a.profile_blob(top_k=2) == b.profile_blob(top_k=2)
    assert a.attributed_frac("serve_") == b.attributed_frac("serve_")
    for name in ("export_folded", "export_report_json"):
        pa, pb = tmp_path / f"a_{name}", tmp_path / f"b_{name}"
        getattr(a, name)(str(pa))
        getattr(b, name)(str(pb))
        assert pa.read_text() == pb.read_text()
    assert not tobs.null_profiler.enabled and not jobs.null_profiler.enabled


def test_report_html_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "gmtime", lambda *a: time.struct_time((2026, 1, 2, 3, 4, 5, 4, 2, 0)))
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    built = []
    for k, (mod, obs, metrics_mod, slo, prof) in enumerate((
            (treport, tobs, tmetrics, tslo, tprof), (jreport, jobs, jmetrics, jslo, jprof))):
        metrics = metrics_mod.Metrics()
        series = obs.TimeSeries()
        s = slo.SlotSLO(config=slo.SLOConfig(short_window=8, long_window=32, min_samples=2))
        for t in range(40):
            metrics.count("frames_served")
            metrics.count("spec_hits", labels={"match_slot": t % 3})
            metrics.observe("serve_tick", 1.0 + (t % 7) * 0.25)
            series.observe("frame_ms", 10.0 + t % 5)
            s.observe_tick(t % 3, deadline_ok=t % 11 != 0, rollback_depth=t % 4)
        metrics.count("sdc_detected", 2)
        metrics.count("sdc_repaired", 2)
        now[0] = 112.5
        path = tmp_path / f"report{k}.html"
        mod.build_report(str(path), title="serve ops report", slo=s, tracers={},
                         metrics=metrics, timeseries=series, profile=fed(prof),
                         notes="frames_served=40 faults=1")
        built.append(path.read_text())
        now[0] = 100.0
    assert built[0] == built[1]


def test_attribution_breakdown_equal_jax():
    results = []
    for mod in (tattr, jattr):
        probe = mod.AttributionProbe(clock=stepped(0.004))
        for _ in range(5):
            with probe.host():
                with probe.device_wait():
                    pass
            with probe.device_wait():
                pass
        probe.snapshot_compiles()
        results.append(probe.result(lanes=8, serial_device_ms=0.5,
                                    cost={"hbm_peak_bytes": 1.5e6}))
    assert results[0] == results[1]


def test_prom_compile_section_equal_jax(monkeypatch):
    events = [{"ms": 812.5, "fingerprint": "checksum-ab12.so"},
              {"ms": 3.25, "fingerprint": ""},
              {"ms": 41.0, "fingerprint": "session_core-77.so"}]
    counters = {"backend_compiles": 3, "cache_tasks": 5, "cache_hits": 2}
    monkeypatch.setattr(xla_cache, "_COMPILE_EVENTS", [dict(e) for e in events])
    monkeypatch.setattr(xla_cache, "_COUNTERS", dict(counters))
    monkeypatch.setattr(build_cache, "_COMPILE_EVENTS", [dict(e) for e in events])
    monkeypatch.setattr(build_cache, "_COUNTERS", dict(counters))
    assert build_cache.compile_summary() == xla_cache.compile_summary()
    metrics = [tmetrics.Metrics(), jmetrics.Metrics()]
    for m in metrics:
        m.count("frames_served", 3)
    text = tobs.export_prometheus(metrics[0])
    ref = jobs.export_prometheus(metrics[1])
    section = [line for line in text.splitlines() if "_xla_" in line]
    assert section and section == [line for line in ref.splitlines() if "_xla_" in line]
    assert "ggrs_xla_backend_compiles_total 3" in text


def test_build_counters_count_builds_and_layouts(monkeypatch):
    monkeypatch.setattr(build_cache, "_COMPILE_EVENTS", [])
    monkeypatch.setattr(build_cache, "_COUNTERS", {"backend_compiles": 0, "cache_tasks": 0,
                                                   "cache_hits": 0})
    monkeypatch.setattr(build_cache, "_KINDS", {"nvcc": 0, "gxx": 0, "layout": 0, "shape": 0})
    assert build_cache.install_compile_listeners()
    with build_cache.timed("layout", "box_game"):
        pass
    build_cache.record_compile("nvcc", 900.0, "checksum.so")
    build_cache.record_cache_hit()
    c = build_cache.compile_counters()
    assert (c["backend_compiles"], c["cache_tasks"], c["cache_hits"]) == (2, 3, 1)
    assert (c["nvcc_builds"], c["layout_misses"], c["gxx_builds"]) == (1, 1, 0)
    assert build_cache.compile_summary()["fingerprints"] == ["box_game", "checksum.so"]
    # No GPU here: the cost record is empty, as JAX's without memory analysis.
    assert build_cache.record_executable_cost("noop", lambda: 7) == {}
    assert build_cache.priced_call("noop2", lambda x: x + 1, 1) == 2


def test_obs_exports_cover_the_serving_modules():
    for name in ("AttributionProbe", "HostProfiler", "ProvenanceLog", "SLOConfig",
                 "SidecarSocket", "SlotSLO", "WindowSLO", "build_report", "flow_key",
                 "null_profiler", "profile_window"):
        assert name in tobs.__all__ and name in jobs.__all__
    assert set(tobs.__all__) <= set(jobs.__all__)
    with tattr.profile_window(None):
        pass
