"""Self-contained HTML ops report: the artifact CI uploads on failure.

One file, zero external assets, loadable from an artifact zip in any
browser. It assembles what the obs stack already collects:

- per-slot SLO state (level + burn rates per objective),
- span summaries per component tracer,
- the flight-recorder tail (last N frames per recorder) and the
  rollback-depth histogram,
- host/device attribution rows from benches,
- speculation-ledger branch economics (outcomes, hit ranks, waste,
  per-player blame shares),
- the raw metrics summary,

so a failed soak ships its own forensics viewer instead of a directory
of JSONL files someone has to re-tool over. Everything is optional: the
report renders whatever subset the caller has.
"""

from __future__ import annotations

import html
import json
import time
from typing import Dict, Iterable, Optional

_CSS = """
body { font: 13px/1.45 system-ui, sans-serif; margin: 1.5em; color: #222; }
h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.6em;
  border-bottom: 1px solid #ddd; padding-bottom: .2em; }
table { border-collapse: collapse; margin: .5em 0; }
th, td { border: 1px solid #ccc; padding: .2em .55em; text-align: right; }
th { background: #f2f2f2; } td.l, th.l { text-align: left; }
.ok { background: #e6f4e6; } .warn { background: #fff3cd; }
.page { background: #f8d7da; font-weight: 600; }
.small { color: #777; font-size: .92em; }
pre { background: #f7f7f7; padding: .6em; overflow-x: auto; }
.flame { font: 11px/1.3 ui-monospace, monospace; margin: .6em 0; }
.frow { display: flex; }
.fcell { min-width: 0; }
.fnode { border: 1px solid #fff; padding: 0 .25em; overflow: hidden;
  white-space: nowrap; text-overflow: ellipsis; }
"""


def _esc(v) -> str:
    return html.escape(str(v))


def _fmt(v) -> str:
    if isinstance(v, float):
        return str(int(v)) if v.is_integer() else f"{v:.3f}"
    return str(v)


def _table(headers: Iterable[str], rows: Iterable[Iterable], left=1) -> str:
    h = "".join(
        f'<th class="l">{_esc(c)}</th>' if i < left else f"<th>{_esc(c)}</th>"
        for i, c in enumerate(headers)
    )
    body = []
    for row in rows:
        cells = []
        cls = ""
        for i, c in enumerate(row):
            if isinstance(c, tuple):  # (value, css-class)
                c, cls = c
            k = ' class="l"' if i < left else (f' class="{cls}"' if cls else "")
            cells.append(f"<td{k}>{_esc(_fmt(c))}</td>")
            cls = ""
        body.append("<tr>" + "".join(cells) + "</tr>")
    return f"<table><tr>{h}</tr>{''.join(body)}</table>"


def _slo_section(slo_snapshot: dict) -> str:
    slots = slo_snapshot.get("slots", {})
    if not slots:
        return "<p class='small'>no SLO samples</p>"
    rows = []
    for slot, st in sorted(slots.items(), key=lambda kv: int(kv[0])):
        lvl = st.get("level", "ok")
        row = [f"slot {slot}", (lvl, lvl)]
        for name in ("deadline", "rollback", "recovery", "quarantine"):
            obj = st.get("objectives", {}).get(name, {})
            row.append(f"{obj.get('short_burn', 0.0):.2f}")
            row.append(f"{obj.get('long_burn', 0.0):.2f}")
        rows.append(row)
    headers = ["slot", "level"]
    for name in ("deadline", "rollback", "recovery", "quarantine"):
        headers += [f"{name} s-burn", f"{name} l-burn"]
    cfg = slo_snapshot.get("config", {})
    return (
        _table(headers, rows, left=1)
        + f"<p class='small'>config: {_esc(json.dumps(cfg))}</p>"
    )


def _fleet_section(rows) -> str:
    """Per-server fleet table: occupancy, burn, speculation quality —
    the rows :meth:`~bevy_ggrs_tpu_torch.fleet.balancer.FleetBalancer.
    fleet_rows` (or a ProcFleet) produces. When the cost observatory ran
    in a child, its rows also carry XLA compile wall-time
    (``xla_compile_ms``) and peak executable HBM (``hbm_peak_bytes``)."""
    rows = list(rows)
    if not rows:
        return "<p class='small'>no fleet members</p>"
    out = []
    for r in sorted(rows, key=lambda r: r.get("server_id", 0)):
        state = (
            "dead" if not r.get("alive", True)
            else ("draining" if r.get("draining") else "up")
        )
        state_cls = {"dead": "page", "draining": "warn", "up": "ok"}[state]
        pages = r.get("pages", 0)
        quar = r.get("quarantined", 0)
        occ = r.get("occupancy")
        compile_ms = r.get("xla_compile_ms")
        hbm = r.get("hbm_peak_bytes")
        out.append([
            f"server {r.get('server_id')}",
            (state, state_cls),
            r.get("matches", ""),
            r.get("slots_active", ""),
            r.get("slots_free", ""),
            "" if occ is None else f"{100.0 * occ:.0f}%",
            (pages, "page" if pages else "ok"),
            (quar, "warn" if quar else "ok"),
            r.get("spec_hit_permille", ""),
            r.get("spec_waste_permille", ""),
            "" if compile_ms is None else f"{float(compile_ms):.0f}",
            "" if hbm is None else f"{float(hbm) / 1e6:.1f}",
            "" if r.get("score") is None else f"{r['score']:.3f}",
        ])
    return _table(
        ["server", "state", "matches", "active", "free", "occupancy",
         "pages", "quarantined", "spec hit ‰", "spec waste ‰",
         "compile ms", "hbm MB", "score"],
        out,
    )


def _relay_tree_section(rows) -> str:
    """Relay-tree topology table: one row per relay, indented by tier —
    the dicts :meth:`~bevy_ggrs_tpu_torch.relay.tree.RelayTree.topology_rows`
    produces."""
    rows = list(rows)
    if not rows:
        return "<p class='small'>no relay-tree members</p>"
    out = []
    for r in sorted(rows, key=lambda r: (r.get("tier", 0), r.get("relay_id", 0))):
        state = (
            "dead" if not r.get("alive", True)
            else ("draining" if r.get("draining") else "up")
        )
        state_cls = {"dead": "page", "draining": "warn", "up": "ok"}[state]
        lag = r.get("lag_frames", 0)
        hits = r.get("cache_hits", 0)
        misses = r.get("cache_misses", 0)
        corrupt = r.get("cache_corrupt", 0)
        total = hits + misses
        hit_rate = "" if not total else f"{100.0 * hits / total:.0f}%"
        indent = " " * (2 * int(r.get("tier", 0)))
        out.append([
            f"{indent}relay {r.get('relay_id')} (tier {r.get('tier', 0)})",
            (state, state_cls),
            "" if r.get("parent") is None else str(r.get("parent")),
            r.get("subscribers", ""),
            r.get("frontier", ""),
            (lag, "warn" if lag and lag > 2 else "ok"),
            hit_rate,
            (corrupt, "page" if corrupt else "ok"),
        ])
    return _table(
        ["relay", "state", "parent", "subscribers", "frontier",
         "lag (frames)", "kf-cache hit", "cache corrupt"],
        out,
    )


def _spans_section(tracers: Dict[str, object]) -> str:
    parts = []
    for comp, tracer in sorted(tracers.items()):
        summ = tracer.summary() if hasattr(tracer, "summary") else dict(tracer)
        if not summ:
            continue
        rows = [
            [name, s["count"], f"{s['total_ms']:.2f}",
             f"{s['mean_ms']:.3f}", f"{s['max_ms']:.3f}"]
            for name, s in sorted(summ.items())
        ]
        parts.append(f"<h3>{_esc(comp)}</h3>")
        parts.append(
            _table(["span", "count", "total ms", "mean ms", "max ms"], rows)
        )
    return "".join(parts) or "<p class='small'>no spans</p>"


def _recorder_section(recorders: Dict[str, object], tail: int = 40) -> str:
    parts = []
    for comp, rec in sorted(recorders.items()):
        records = list(getattr(rec, "records", lambda: rec)())
        hist = (
            rec.rollback_histogram()
            if hasattr(rec, "rollback_histogram") else {}
        )
        if hist:
            parts.append(f"<h3>{_esc(comp)} rollback depth</h3>")
            parts.append(
                _table(
                    ["depth", "frames"],
                    [[d, hist[d]] for d in sorted(hist)],
                )
            )
        if records:
            last = records[-tail:]
            fields = [
                f for f in (
                    "frame", "confirmed_frame", "rollback_depth",
                    "slots_active", "slots_quarantined", "slots_recovering",
                    "stagger_jitter_ms",
                )
                if any(getattr(r, f, None) is not None for r in last)
            ]
            rows = [
                [getattr(r, f, "") if getattr(r, f, None) is not None else ""
                 for f in fields]
                for r in last
            ]
            parts.append(
                f"<h3>{_esc(comp)} flight-recorder tail "
                f"({len(last)}/{len(records)} frames)</h3>"
            )
            parts.append(_table(fields, rows, left=0))
    return "".join(parts) or "<p class='small'>no flight-recorder data</p>"


def _attribution_section(attribution: Dict[str, dict]) -> str:
    if not attribution:
        return "<p class='small'>no attribution rows</p>"
    keys = sorted({k for row in attribution.values() for k in row})
    rows = [
        [name] + [row.get(k, "") for k in keys]
        for name, row in sorted(attribution.items())
    ]
    return _table(["bench"] + keys, rows)


def _timeseries_section(timeseries) -> str:
    snap = (
        timeseries.snapshot()
        if hasattr(timeseries, "snapshot") else dict(timeseries)
    )
    if not snap:
        return "<p class='small'>no time-series samples</p>"
    headers = [
        "series", "count", "last", "mean", "p50", "p95", "p99",
        "window p50", "window p99", "min", "max",
    ]
    rows = [
        [
            name, s.get("count", 0), s.get("last", 0.0), s.get("mean", 0.0),
            s.get("p50", 0.0), s.get("p95", 0.0), s.get("p99", 0.0),
            s.get("window_p50", 0.0), s.get("window_p99", 0.0),
            s.get("min", 0.0), s.get("max", 0.0),
        ]
        for name, s in sorted(snap.items())
    ]
    return _table(headers, rows)


def _ledger_section(ledger) -> str:
    s = ledger.summary() if hasattr(ledger, "summary") else dict(ledger)
    if not s.get("rollbacks"):
        return "<p class='small'>no rollbacks recorded</p>"
    outcome_rows = [
        ["full hits", s["spec_full"]],
        ["partial hits", s["spec_partial"]],
        ["misses", s["spec_miss"]],
        ["unmatched", s["spec_unmatched"]],
        ["rollbacks total", s["rollbacks"]],
    ]
    econ_rows = [
        ["full-hit rate", f"{s['spec_full_hit_rate']:.3f}"],
        ["hit rank p50", s["spec_hit_rank_p50"]],
        ["hit rank p99", s["spec_hit_rank_p99"]],
        ["waste ratio", f"{s['spec_waste_ratio']:.3f}"],
        ["spec frames dispatched", s["spec_frames_dispatched"]],
        ["frames recovered", s["frames_recovered_total"]],
        ["frames resimulated", s["frames_resimulated_total"]],
    ]
    parts = [
        "<h3>outcomes</h3>", _table(["outcome", "count"], outcome_rows),
        "<h3>branch economics</h3>", _table(["stat", "value"], econ_rows),
    ]
    shares = (
        ledger.blame_shares() if hasattr(ledger, "blame_shares") else {}
    )
    if shares:
        parts.append("<h3>blame by player</h3>")
        parts.append(
            _table(
                ["player", "share"],
                [
                    [f"player {p}", f"{share:.3f}"]
                    for p, share in sorted(
                        shares.items(), key=lambda kv: -kv[1]
                    )
                ],
            )
        )
    return "".join(parts)


_SDC_COUNTERS = (
    # (counter, meaning, css class when nonzero)
    ("data_crc_drops", "corrupt datagrams dropped at the wire (v5 crc)", ""),
    ("sdc_detected", "corrupt ring rows found by the attestation sweep", ""),
    ("sdc_repaired", "slots self-healed in place by resimulation", ""),
    ("sdc_repaired_bitwise", "repairs verified bitwise against the "
     "expected digests", ""),
    ("sdc_unrepairable", "slots with no clean snapshot left (escalated)",
     "page"),
    ("sdc_faults", "typed StateFault records drained by the supervisor", ""),
    ("sdc_escalations", "faults escalated to the donor-transfer rung",
     "warn"),
)


def _sdc_section(metrics) -> str:
    """Data-plane integrity ledger (docs/serving.md "Self-healing"): the
    detect -> repair -> verify accounting for silent corruption, plus the
    repair-resimulation spans. Rendered only when the metrics object
    carries any of the SDC counters; a repair count that trails the
    detect count, or any non-bitwise repair, is flagged."""
    counters = getattr(metrics, "counters", None)
    series = getattr(metrics, "series", None)
    if counters is None:
        return ""
    present = [
        (name, meaning, bad_cls)
        for name, meaning, bad_cls in _SDC_COUNTERS
        if name in counters
    ]
    if not present:
        return ""
    rows = []
    for name, meaning, bad_cls in present:
        v = counters.get(name, 0)
        cls = bad_cls if (bad_cls and v) else ""
        rows.append([name, (v, cls), meaning])
    detected = counters.get("sdc_detected", 0)
    repaired = counters.get("sdc_repaired", 0)
    bitwise = counters.get("sdc_repaired_bitwise", 0)
    notes = []
    if repaired < detected:
        notes.append(
            f"{int(detected - repaired)} detection(s) without an in-place "
            "repair — check sdc_unrepairable / the eviction ladder"
        )
    if bitwise < repaired:
        notes.append(
            f"{int(repaired - bitwise)} repair(s) did NOT land bitwise — "
            "the slot's timeline left the batch"
        )
    parts = ["<h2>Data integrity (SDC)</h2>",
             _table(["counter", "count", "meaning"], rows, left=1)]
    for n in notes:
        parts.append(f"<p class='page'>{_esc(n)}</p>")
    spans = list((series or {}).get("sdc_repair_frames", ()))
    if spans:
        spans.sort()
        parts.append(
            "<p class='small'>repair resimulation spans (frames): "
            f"n={len(spans)} p50={_fmt(spans[len(spans) // 2])} "
            f"max={_fmt(spans[-1])}</p>"
        )
    per_slot = sorted(
        (k, v) for k, v in counters.items()
        if k.startswith('sdc_detected{')
    )
    if per_slot:
        parts.append(_table(["slot", "detections"], per_slot, left=1))
    return "".join(parts)


def _flame_hue(name: str) -> int:
    return sum(ord(c) for c in name) * 37 % 360


def _flame_node(node, root_ms: float, depth: int = 0) -> str:
    """One icicle level: the node's box, then a flex row of children
    sized by their share of the node. Pure HTML/CSS — the report stays
    loadable from an artifact zip with no external JS."""
    ms = float(node.get("ms", 0.0))
    if ms <= 0.0 or depth > 16:
        return ""
    label = f"{node.get('name', '?')} {ms:.1f}ms"
    h = _flame_hue(str(node.get("name", "")))
    parts = [
        f"<div class='fnode' style='background:hsl({h},60%,85%)' "
        f"title='{_esc(label)}'>{_esc(label)}</div>"
    ]
    kids = [
        c for c in node.get("children", ())
        # skip slivers under 0.15% of the whole profile: unreadable at
        # any width and they blow up the document size
        if root_ms > 0 and 100.0 * float(c.get("ms", 0.0)) / root_ms >= 0.15
    ]
    if kids:
        cells = []
        for c in kids:
            w = 100.0 * float(c.get("ms", 0.0)) / ms
            cells.append(
                f"<div class='fcell' style='width:{w:.2f}%'>"
                + _flame_node(c, root_ms, depth + 1)
                + "</div>"
            )
        parts.append("<div class='frow'>" + "".join(cells) + "</div>")
    return "".join(parts)


def _profile_section(profile) -> str:
    """Host-profiler section (obs/profiler.py): sample header, per-stage
    self-time culprit tables, and a self-contained CSS flame graph over
    the stage -> frame-path tree."""
    prof = profile.report() if hasattr(profile, "report") else dict(profile)
    if not prof or not prof.get("samples"):
        return "<p class='small'>no profile samples</p>"
    parts = [
        "<p class='small'>"
        f"samples={prof.get('samples', 0)} "
        f"profiled={_fmt(prof.get('total_ms', 0.0))}ms "
        f"interval={_fmt(prof.get('interval_ms', 0.0))}ms "
        f"seed={prof.get('seed', '')} "
        f"attributed={100.0 * float(prof.get('attributed_frac', 0.0)):.1f}%"
        "</p>"
    ]
    stages = prof.get("stages", {})
    if stages:
        rows = []
        for stage, st in sorted(
            stages.items(), key=lambda kv: -float(kv[1].get("total_ms", 0))
        ):
            top = st.get("top") or [
                [f, m] for f, m in st.get("self_ms", {}).items()
            ]
            culprits = "; ".join(
                f"{frame} {float(ms):.1f}ms" for frame, ms in top[:5]
            )
            rows.append([stage, f"{float(st.get('total_ms', 0.0)):.1f}",
                         culprits])
        parts.append(
            _table(["stage", "self ms", "top frames (self-time)"], rows,
                   left=1)
        )
    tree = prof.get("tree")
    if tree and tree.get("ms"):
        parts.append(
            "<div class='flame'>"
            + _flame_node(tree, float(tree["ms"]))
            + "</div>"
        )
    return "".join(parts)


def _metrics_section(metrics) -> str:
    summ = metrics.summary() if hasattr(metrics, "summary") else dict(metrics)
    if not summ:
        return "<p class='small'>no metrics</p>"
    rows = []
    for name, stats in sorted(summ.items()):
        body = " ".join(f"{k}={_fmt(v)}" for k, v in stats.items())
        rows.append([name, body])
    return _table(["metric", "stats"], rows, left=2)


def build_report(
    path: Optional[str] = None,
    *,
    title: str = "ggrs ops report",
    slo=None,
    tracers: Optional[Dict[str, object]] = None,
    recorders: Optional[Dict[str, object]] = None,
    attribution: Optional[Dict[str, dict]] = None,
    metrics=None,
    timeseries=None,
    ledger=None,
    fleet=None,
    relay_tree=None,
    profile=None,
    notes: Optional[str] = None,
) -> str:
    """Render the report; write it to ``path`` when given. ``slo`` is a
    :class:`~bevy_ggrs_tpu_torch.obs.slo.SlotSLO` or its ``snapshot()`` dict;
    ``tracers`` / ``recorders`` map component name -> object;
    ``attribution`` maps bench name -> attribution row dict;
    ``timeseries`` is a :class:`~bevy_ggrs_tpu_torch.obs.timeseries.TimeSeries`
    or its ``snapshot()`` dict; ``ledger`` is a
    :class:`~bevy_ggrs_tpu_torch.obs.ledger.SpeculationLedger` or its
    ``summary()`` dict; ``fleet`` is a list of per-server row dicts
    (:meth:`~bevy_ggrs_tpu_torch.fleet.balancer.FleetBalancer.fleet_rows`);
    ``relay_tree`` is a list of per-relay row dicts
    (:meth:`~bevy_ggrs_tpu_torch.relay.tree.RelayTree.topology_rows`);
    ``profile`` is a :class:`~bevy_ggrs_tpu_torch.obs.profiler.HostProfiler`
    or its ``report()`` dict (rendered as per-stage culprit tables plus
    a pure-CSS flame graph — no external JS)."""
    sections = []
    if notes:
        sections.append(f"<p>{_esc(notes)}</p>")
    if fleet is not None:
        sections.append("<h2>Fleet</h2>" + _fleet_section(fleet))
    if relay_tree is not None:
        sections.append(
            "<h2>Relay tree</h2>" + _relay_tree_section(relay_tree)
        )
    if slo is not None:
        snap = slo.snapshot() if hasattr(slo, "snapshot") else dict(slo)
        sections.append("<h2>Slot SLO state</h2>" + _slo_section(snap))
    if attribution:
        sections.append(
            "<h2>Device-time attribution</h2>"
            + _attribution_section(attribution)
        )
    if timeseries is not None:
        sections.append(
            "<h2>Time series (live windows)</h2>"
            + _timeseries_section(timeseries)
        )
    if ledger is not None:
        sections.append(
            "<h2>Speculation ledger</h2>" + _ledger_section(ledger)
        )
    if profile is not None:
        sections.append(
            "<h2>Host profile (flame)</h2>" + _profile_section(profile)
        )
    if metrics is not None:
        sdc = _sdc_section(metrics)
        if sdc:
            sections.append(sdc)
    if tracers:
        sections.append("<h2>Span summaries</h2>" + _spans_section(tracers))
    if recorders:
        sections.append(
            "<h2>Flight recorder</h2>" + _recorder_section(recorders)
        )
    if metrics is not None:
        sections.append("<h2>Metrics</h2>" + _metrics_section(metrics))
    stamp = time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())
    doc = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>"
        f"<h1>{_esc(title)}</h1>"
        f"<p class='small'>generated {stamp}</p>"
        + "".join(sections)
        + "</body></html>"
    )
    if path is not None:
        with open(path, "w") as f:
            f.write(doc)
    return doc
