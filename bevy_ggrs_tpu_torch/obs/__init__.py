"""Observability of the port: flight recorder, span tracer, desync
forensics, time series, and Perfetto/Prometheus export, under the names
``bevy_ggrs_tpu.obs`` exports them.

Quick start::

    from bevy_ggrs_tpu_torch import obs

    tracer = obs.SpanTracer(pid=0, process_name="peer-0")
    recorder = obs.FlightRecorder()
    session = builder.start_p2p_session(sock, metrics=metrics, tracer=tracer)
    runner = RollbackRunner(..., metrics=metrics, tracer=tracer)
    forensics = obs.DesyncForensics(session, runner, recorder, out_dir="obs/")

    # drive loop:
    session.poll_remote_clients()
    forensics.scan(session.events())
    runner.handle_requests(session.advance_frame(), session)
    recorder.capture(session=session, runner=runner)

    obs.export_perfetto(tracer, "trace.json")     # -> ui.perfetto.dev
    obs.export_prometheus(metrics, recorder)      # -> text exposition

The serving tier's modules (provenance, slo, report, profiler,
attribution) and the fleet's trace merger (``merge``) are here too.
"""

from .attribution import AttributionProbe, profile_window
from .forensics import DesyncForensics, desync_report
from .ledger import SpeculationLedger, blame_divergence, null_ledger, replay_baseline
from .merge import follow, frame_flows, merge_traces
from .profiler import HostProfiler, null_profiler
from .prom import export_prometheus
from .provenance import ProvenanceLog, SidecarSocket, flow_key
from .recorder import FlightRecorder, FrameRecord
from .report import build_report
from .slo import SLOConfig, SlotSLO, WindowSLO
from .timeseries import MetricWindow, P2Quantile, TimeSeries, null_timeseries
from .trace import SpanTracer, null_tracer


def export_perfetto(tracer, path=None):
    """Module-level convenience: Chrome-trace/Perfetto JSON for ``tracer``."""
    return tracer.export_perfetto(path)


__all__ = [
    "AttributionProbe",
    "DesyncForensics",
    "FlightRecorder",
    "FrameRecord",
    "HostProfiler",
    "MetricWindow",
    "P2Quantile",
    "ProvenanceLog",
    "SLOConfig",
    "SidecarSocket",
    "SlotSLO",
    "SpanTracer",
    "SpeculationLedger",
    "TimeSeries",
    "WindowSLO",
    "blame_divergence",
    "build_report",
    "desync_report",
    "export_perfetto",
    "export_prometheus",
    "flow_key",
    "follow",
    "frame_flows",
    "merge_traces",
    "null_ledger",
    "null_profiler",
    "null_timeseries",
    "null_tracer",
    "profile_window",
    "replay_baseline",
]
