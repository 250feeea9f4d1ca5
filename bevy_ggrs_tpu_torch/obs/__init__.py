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

The JAX package's serving-side modules (provenance, merge, slo, report,
profiler, attribution) are not ported yet, and neither are their names.
"""

from .forensics import DesyncForensics, desync_report
from .ledger import SpeculationLedger, blame_divergence, null_ledger, replay_baseline
from .prom import export_prometheus
from .recorder import FlightRecorder, FrameRecord
from .timeseries import MetricWindow, P2Quantile, TimeSeries, null_timeseries
from .trace import SpanTracer, null_tracer


def export_perfetto(tracer, path=None):
    """Module-level convenience: Chrome-trace/Perfetto JSON for ``tracer``."""
    return tracer.export_perfetto(path)


__all__ = [
    "DesyncForensics",
    "FlightRecorder",
    "FrameRecord",
    "MetricWindow",
    "P2Quantile",
    "SpanTracer",
    "SpeculationLedger",
    "TimeSeries",
    "blame_divergence",
    "desync_report",
    "export_perfetto",
    "export_prometheus",
    "null_ledger",
    "null_timeseries",
    "null_tracer",
    "replay_baseline",
]
