"""Trace merge: stitch per-process exports into one fleet timeline.

Counterpart of ``bevy_ggrs_tpu/obs/merge.py``: the same merged JSON for
the same exports.

Each process exports two artifacts: a Perfetto/Chrome trace from its
:class:`~bevy_ggrs_tpu_torch.obs.trace.SpanTracer` (spans on per-component
tracks) and a provenance JSONL from its
:class:`~bevy_ggrs_tpu_torch.obs.provenance.ProvenanceLog` (one record per
datagram with an FNV-1a flow key). This module merges N of each into a
single Chrome trace:

- span events are copied through with process identity preserved (pid
  collisions between files are remapped, ``process_name`` metadata kept);
- host-profiler exports (:meth:`~bevy_ggrs_tpu_torch.obs.profiler.
  HostProfiler.export_perfetto` — ``ph:"C"`` counter samples on tid 8)
  are the same file shape and merge through the same path: pass them as
  additional trace files and the counter track lands on its process row,
  wall-aligned with the span timeline via the shared ``wall_t0`` anchor;
- a ``torch.profiler`` Chrome trace (``prof.export_chrome_trace``) is one
  more trace file: its events carry microseconds since the trace's own
  ``baseTimeNanoseconds`` on the wall clock, which is its ``wall_t0``, so
  with ``align="wall"`` the device's kernels and copies land on the
  tracer's timeline (whose default clock is the same wall clock), and an
  idle gap between kernels sits under the span the host was in;
- every provenance record becomes a thin ``X`` slice on a dedicated
  "wire" track of its component's process;
- records sharing a flow key are chained with Chrome flow events
  (``s``/``t``/``f``), which Perfetto draws as arrows — peer tx → relay
  rx → relay tx → destination rx — because the relay forwards envelope
  bytes verbatim, so the digest is identical at every hop.

Alignment: with ``align="none"`` (default) timestamps are taken as-is —
correct whenever all processes share a clock (the LoopbackNetwork virtual
clock in soaks). ``align="wall"`` shifts each file by its recorded
``wall_t0`` so real multi-process captures line up on the wall clock.

Usable as a library (:func:`merge_traces`, :func:`follow`,
:func:`frame_flows`) or a CLI::

    python -m bevy_ggrs_tpu_torch.obs.merge --out merged.json \
        peer0/trace.json relay/trace.json server/trace.json \
        --provenance peer0/provenance.jsonl relay/provenance.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

#: tid of the per-process datagram track (outside the 0..3 component
#: range a tid-0 SpanTracer occupies).
WIRE_TID = 9

def _causal_order(items, owner_of, rec_of, ts_of):
    """Sort one flow's hops by (ts, causal rank). Timestamps dominate;
    the rank only breaks exact ties, which happen whenever every hop of
    a datagram lands on the same virtual-clock tick (LoopbackNetwork).
    Rank comes from what each owner recorded for this key: a tx with no
    matching rx originates (0), a relaying owner goes rx (1) then tx
    (2), an rx-only owner terminates (3) — peer tx -> relay rx -> relay
    tx -> destination rx even at identical timestamps."""
    dirs: Dict[object, set] = {}
    for it in items:
        dirs.setdefault(owner_of(it), set()).add(rec_of(it).get("dir"))

    def rank(it):
        rec = rec_of(it)
        both = {"tx", "rx"} <= dirs[owner_of(it)]
        if rec.get("dir") == "tx":
            return 2 if both else 0
        return 1 if both else 3

    items.sort(key=lambda it: (ts_of(it), rank(it)))


def _load_trace(path: str) -> Tuple[List[dict], dict]:
    with open(path) as f:
        trace = json.load(f)
    other = dict(trace.get("otherData", {}))
    base_ns = trace.get("baseTimeNanoseconds")
    if base_ns is not None and "wall_t0" not in other:
        # A torch.profiler Chrome trace: its ts count from its base time.
        other["wall_t0"] = int(base_ns) / 1e9
    return list(trace.get("traceEvents", ())), other


def _load_provenance(path: str) -> Tuple[dict, List[dict]]:
    meta: dict = {}
    records: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "meta" in obj and not records and not meta:
                meta = obj["meta"]
            else:
                records.append(obj)
    return meta, records


def _slice_name(rec: dict) -> str:
    name = f"{rec.get('dir', '?')} {rec.get('type', '?')}"
    if rec.get("inner"):
        name += f"[{rec['inner']}]"
    if rec.get("frame") is not None:
        name += f" f{rec['frame']}"
    return name


def merge_traces(
    trace_paths: Sequence[str],
    provenance_paths: Sequence[str] = (),
    path: Optional[str] = None,
    align: str = "none",
) -> dict:
    """Merge per-process Perfetto traces + provenance logs into one
    Chrome trace dict (written to ``path`` when given)."""
    events: List[dict] = []
    # Process identity across files: the SAME (pid, name) pair is the
    # same process (a tracer export and a provenance log from one
    # process share both), so its artifacts merge onto one process row.
    # A pid collision with a different/unknown name is two distinct
    # processes and the later file is remapped to a fresh pid.
    assigned: Dict[Tuple[int, str], int] = {}
    taken: set = set()

    def claim_pid(want: int, name: Optional[str]) -> int:
        key = (want, name)
        if name is not None and key in assigned:
            return assigned[key]
        pid = want
        while pid in taken:
            pid += 1
        taken.add(pid)
        if name is not None:
            assigned[key] = pid
        return pid

    wall_anchor: Optional[float] = None
    shifts: List[Tuple[List[dict], float, dict]] = []

    for tp in trace_paths:
        tevents, other = _load_trace(tp)
        w = other.get("wall_t0")
        if align == "wall" and w is not None:
            wall_anchor = w if wall_anchor is None else min(wall_anchor, w)
        shifts.append((tevents, w if w is not None else 0.0, other))

    prov_loaded = [_load_provenance(pp) for pp in provenance_paths]
    if align == "wall":
        for meta, _ in prov_loaded:
            w = meta.get("wall_t0")
            if w is not None:
                wall_anchor = w if wall_anchor is None else min(wall_anchor, w)

    def shift_us(wall_t0: float) -> int:
        if align != "wall" or wall_anchor is None:
            return 0
        return int((wall_t0 - wall_anchor) * 1e6)

    # 1. Span traces, pid-remapped. One file = one process: every event
    # in it moves to the file's claimed pid.
    for tevents, wall_t0, other in shifts:
        file_pids: Dict[int, int] = {}
        dt = shift_us(wall_t0)
        fpid, fname = other.get("pid"), other.get("process_name")
        for ev in tevents:
            ev = dict(ev)
            opid = ev.get("pid", 0)
            # A profiler trace also has rows named by a string ("Spans"):
            # they cannot collide with a number and keep their names.
            if not isinstance(opid, str) or opid.isdigit():
                opid = int(opid)
                if opid not in file_pids:
                    name = fname if fname is not None and opid == fpid else None
                    file_pids[opid] = claim_pid(opid, name)
                ev["pid"] = file_pids[opid]
            if "ts" in ev:
                # A profiler's fractional microseconds stay fractional.
                ts = ev["ts"]
                ev["ts"] = (ts if isinstance(ts, float) else int(ts)) + dt
            events.append(ev)

    # 2. Provenance records -> wire-track slices, collecting flow groups.
    flows: Dict[int, List[dict]] = {}
    for meta, records in prov_loaded:
        pid = claim_pid(int(meta.get("pid", 0)), meta.get("component"))
        dt = shift_us(float(meta.get("wall_t0", 0.0)))
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": WIRE_TID,
                "args": {"name": f"wire:{meta.get('component', '?')}"},
            }
        )
        if meta.get("component"):
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": WIRE_TID,
                    "args": {"name": str(meta["component"])},
                }
            )
        for rec in records:
            ts = int(rec.get("ts_us", 0)) + dt
            args = {
                k: v
                for k, v in rec.items()
                if k not in ("ts_us", "dir", "type", "addr")
            }
            args["key"] = f"{int(rec.get('key', 0)):016x}"
            ev = {
                "name": _slice_name(rec),
                "cat": "wire",
                "ph": "X",
                "ts": ts,
                "dur": 1,
                "pid": pid,
                "tid": WIRE_TID,
                "args": args,
            }
            events.append(ev)
            key = int(rec.get("key", 0))
            flows.setdefault(key, []).append(
                {"ts": ts, "pid": pid, "rec": rec}
            )

    # 3. Flow chains: every key seen more than once becomes an arrow
    # sequence s -> t... -> f bound to the wire slices above.
    for key, hops in flows.items():
        if len(hops) < 2:
            continue
        _causal_order(
            hops,
            owner_of=lambda h: h["pid"],
            rec_of=lambda h: h["rec"],
            ts_of=lambda h: h["ts"],
        )
        for i, hop in enumerate(hops):
            ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
            ev = {
                "name": hop["rec"].get("type", "datagram"),
                "cat": "flow",
                "ph": ph,
                "id": f"{key:016x}",
                "ts": hop["ts"],
                "pid": hop["pid"],
                "tid": WIRE_TID,
            }
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)

    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def follow(
    provenance_paths: Sequence[str], key: int
) -> List[Tuple[str, dict]]:
    """The hop chain for one flow key across provenance files:
    [(component, record), ...] in timestamp order. This is "follow one
    input from peer send to relay forward to destination" as data."""
    hops: List[Tuple[str, dict]] = []
    for pp in provenance_paths:
        meta, records = _load_provenance(pp)
        comp = str(meta.get("component", pp))
        for rec in records:
            if int(rec.get("key", 0)) == key:
                hops.append((comp, rec))
    _causal_order(
        hops,
        owner_of=lambda h: h[0],
        rec_of=lambda h: h[1],
        ts_of=lambda h: h[1].get("ts_us", 0),
    )
    return hops


def frame_flows(
    provenance_paths: Sequence[str], frame: int
) -> Dict[int, List[Tuple[str, dict]]]:
    """All flow keys whose records carry provenance ``frame``, each with
    its full hop chain (which may include hops recorded without a frame
    field, e.g. at the relay)."""
    keys = set()
    for pp in provenance_paths:
        _, records = _load_provenance(pp)
        for rec in records:
            if rec.get("frame") == frame:
                keys.add(int(rec.get("key", 0)))
    return {k: follow(provenance_paths, k) for k in keys}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-process trace + provenance exports into "
        "one Perfetto-loadable Chrome trace."
    )
    ap.add_argument("traces", nargs="*",
                    help="per-process trace.json files (SpanTracer or HostProfiler "
                    "exports, torch.profiler Chrome traces)")
    ap.add_argument(
        "--provenance", nargs="*", default=[],
        help="per-process provenance.jsonl files",
    )
    ap.add_argument("--out", required=True, help="merged trace output path")
    ap.add_argument(
        "--align", choices=("none", "wall"), default="none",
        help="timestamp alignment across files (default: shared clock)",
    )
    args = ap.parse_args(argv)
    trace = merge_traces(
        args.traces, args.provenance, path=args.out, align=args.align
    )
    n_flow = sum(1 for e in trace["traceEvents"] if e.get("cat") == "flow")
    n_counter = sum(
        1 for e in trace["traceEvents"] if e.get("ph") == "C"
    )
    print(
        f"merged {len(args.traces)} trace(s) + {len(args.provenance)} "
        f"provenance log(s) -> {args.out} "
        f"({len(trace['traceEvents'])} events, {n_flow} flow hops, "
        f"{n_counter} counter samples)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
