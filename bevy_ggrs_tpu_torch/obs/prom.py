"""Prometheus text-exposition snapshot fed from the existing ``Metrics``
sink (plus, optionally, the flight recorder's rollback-depth histogram).

Counterpart of ``bevy_ggrs_tpu/obs/prom.py``: for equal ``Metrics``,
recorder, time series, ledger and compile events it renders the same
text. The compile section keeps the JAX exporter's names
(``{ns}_xla_compile_ms`` and the ``{ns}_xla_*_total`` counters) so one
dashboard reads both packages; in the port it is fed by
``utils/build_cache.py`` (kernel and native builds, layout preparations)
instead of XLA's compile events.

This is a *snapshot* exporter — it renders the current state of a
:class:`~bevy_ggrs_tpu_torch.utils.metrics.Metrics` object as the text format a
Prometheus scrape or a pushgateway upload expects. There is no HTTP
server here on purpose: the drive loop owns the clock in this codebase
(virtual-clock tests, pinned-core benches), so exposition is a pull the
*caller* schedules, typically once per second or once at exit.

Mapping:

- counters  -> ``{ns}_{name}_total`` (counter) and ``{ns}_{name}_per_sec``
  (gauge, the sink's lifetime rate);
- series    -> a summary: ``{quantile="0.5|0.95|0.99"}`` samples plus
  ``_count`` and ``_sum`` (reconstructed as mean*count);
- recorder  -> ``{ns}_rollback_depth`` cumulative histogram buckets;
- ledger    -> ``{ns}_spec_*`` branch-economics samples (lifetime
  counters, hit-rate/waste gauges, a hit-rank summary, and per-player
  ``{ns}_spec_blame_share{player="p"}`` gauges).

Labeled instruments (``Metrics.count(..., labels={"match_slot": s})``)
arrive as ``name{k="v"}`` keys — the label block is split off, preserved
verbatim, and re-attached after the ``_total``/``_per_sec``/quantile
suffix, so per-slot serving metrics export as proper labeled samples
(``ggrs_frames_advanced_total{match_slot="3"} 42``) instead of being
mangled into one flat name per label set. ``# TYPE`` is emitted once per
metric family, not once per label set.

Label values are escaped per the text-format spec (backslash, double
quote, newline) at *encode* time — ``Metrics`` builds its keys through
:func:`escape_label_value`, so the blocks this exporter preserves are
already valid exposition. Any label value this module emits itself must
go through the same helper.
"""

from __future__ import annotations

import re
from typing import Optional

from ..utils.metrics import escape_label_value  # noqa: F401  (re-export)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    clean = _NAME_RE.sub("_", name)
    if clean and clean[0].isdigit():
        clean = "_" + clean
    return clean


def _split_labels(name: str):
    """``name{k="v"}`` -> (sanitized base, '{k="v"}' | '')."""
    if name.endswith("}") and "{" in name:
        base, labels = name.split("{", 1)
        return _sanitize(base), "{" + labels
    return _sanitize(name), ""


def _merge(labels: str, extra: str) -> str:
    """Merge a preserved label block with an extra ``k="v"`` pair."""
    if not labels:
        return "{" + extra + "}"
    return labels[:-1] + "," + extra + "}"


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def export_prometheus(
    metrics,
    recorder=None,
    namespace: str = "ggrs",
    path: Optional[str] = None,
    timeseries=None,
    ledger=None,
) -> str:
    lines = []
    typed = set()  # one "# TYPE" per family across its label sets

    def type_line(base: str, kind: str) -> None:
        if base not in typed:
            typed.add(base)
            lines.append(f"# TYPE {base} {kind}")

    for name, stats in sorted(metrics.summary().items()):
        raw_base, labels = _split_labels(name)
        base = f"{namespace}_{raw_base}"
        if "total" in stats:  # counter
            type_line(f"{base}_total", "counter")
            lines.append(f"{base}_total{labels} {_num(stats['total'])}")
            type_line(f"{base}_per_sec", "gauge")
            lines.append(f"{base}_per_sec{labels} {_num(stats['per_sec'])}")
        else:  # series -> summary
            count = stats["count"]
            type_line(base, "summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                qlabels = _merge(labels, f'quantile="{q}"')
                lines.append(f"{base}{qlabels} {_num(stats[key])}")
            lines.append(f"{base}_sum{labels} {_num(stats['mean'] * count)}")
            lines.append(f"{base}_count{labels} {_num(count)}")
    if timeseries is not None:
        # Online pipeline (obs/timeseries.py): whole-stream P² quantiles
        # as a summary, plus the exact live-window percentiles as gauges
        # ({window="..."}) — the capacity signal a scrape reads mid-run.
        for name, snap in sorted(timeseries.snapshot().items()):
            raw_base, labels = _split_labels(name)
            base = f"{namespace}_ts_{raw_base}"
            type_line(base, "summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                qlabels = _merge(labels, f'quantile="{q}"')
                lines.append(f"{base}{qlabels} {_num(snap[key])}")
            lines.append(
                f"{base}_sum{labels} {_num(snap['mean'] * snap['count'])}"
            )
            lines.append(f"{base}_count{labels} {_num(snap['count'])}")
            type_line(f"{base}_window", "gauge")
            for q, key in (
                ("0.5", "window_p50"),
                ("0.95", "window_p95"),
                ("0.99", "window_p99"),
            ):
                qlabels = _merge(labels, f'quantile="{q}"')
                lines.append(f"{base}_window{qlabels} {_num(snap[key])}")
    if ledger is not None:
        # Speculation ledger (obs/ledger.py): branch economics as gauges.
        # Counts are also counters in spirit, but the ledger is bounded
        # (deque) while the *_total attrs are lifetime — export the
        # lifetime attrs so scrapes never see a value go backwards.
        s = ledger.summary()
        base = f"{namespace}_spec"
        for key, suffix, kind in (
            ("rollbacks", "rollbacks_total", "counter"),
            ("spec_full", "full_total", "counter"),
            ("spec_partial", "partial_total", "counter"),
            ("spec_miss", "miss_total", "counter"),
            ("spec_unmatched", "unmatched_total", "counter"),
            ("spec_frames_dispatched", "frames_dispatched_total", "counter"),
            ("frames_recovered_total", "frames_recovered_total", "counter"),
            ("spec_full_hit_rate", "full_hit_rate", "gauge"),
            ("spec_waste_ratio", "waste_ratio", "gauge"),
            ("blame_top_player_share", "blame_top_player_share", "gauge"),
        ):
            name = f"{base}_{suffix}"
            type_line(name, kind)
            lines.append(f"{name} {_num(s[key])}")
        type_line(f"{base}_hit_rank", "summary")
        for q, key in (("0.5", "spec_hit_rank_p50"), ("0.99", "spec_hit_rank_p99")):
            lines.append(f'{base}_hit_rank{{quantile="{q}"}} {_num(s[key])}')
        type_line(f"{base}_blame_share", "gauge")
        for player, share in sorted(ledger.blame_shares().items()):
            lines.append(
                f'{base}_blame_share{{player="{player}"}} {_num(share)}'
            )
    # Build observatory (utils/build_cache.py): per-build wall times as a
    # ggrs_xla_compile_ms summary plus the build/cache counters, under the
    # JAX exporter's names. Process-global state, so it rides along in
    # every export; zero builds emit nothing.
    from ..utils import build_cache as _xla

    cs = _xla.compile_summary()
    if cs["count"]:
        times = sorted(e["ms"] for e in _xla.compile_events())
        base = f"{namespace}_xla_compile_ms"
        type_line(base, "summary")
        for q in (0.5, 0.95, 0.99):
            idx = min(int(q * len(times)), len(times) - 1)
            lines.append(
                f'{base}{{quantile="{q}"}} {_num(times[idx])}'
            )
        lines.append(f"{base}_sum {_num(cs['total_ms'])}")
        lines.append(f"{base}_count {_num(cs['count'])}")
        counters = _xla.compile_counters()
        for key in ("backend_compiles", "cache_tasks", "cache_hits"):
            name = f"{namespace}_xla_{key}_total"
            type_line(name, "counter")
            lines.append(f"{name} {_num(counters.get(key, 0))}")
    if recorder is not None:
        hist = recorder.rollback_histogram()
        base = f"{namespace}_rollback_depth"
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        total = 0.0
        for depth in sorted(hist):
            cum += hist[depth]
            total += depth * hist[depth]
            lines.append(f'{base}_bucket{{le="{depth}"}} {cum}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{base}_sum {_num(total)}")
        lines.append(f"{base}_count {cum}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
