"""What every cell of the benchmark shares: the files found by name, the
inputs made from the seed, host spans, the profiler's device trace, the
per-layer readers and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module
``benchmark/drivers/<driver>.py`` that runs that kind of window); its
correctness limits are ``benchmark/workloads/<cell>.json``. A per-layer
metric ``<name>`` is read by ``benchmark/metrics/<name>.py``, or, where
that file is missing, by the file of the part of its name before the
first dot (``device_idle_pct.py`` reads ``device_idle_pct.tick``, and a
later cell's ``device_idle_pct.<kind>``). So a later cell, mix or metric
is new files and entries, and no edit here.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# Seconds from process start to each step ``run.py`` takes before the
# driver starts (torch imported, the card found), for the drivers' notes.
EARLY_PHASES: Dict[str, float] = {}

# Top-level module names the process must not hold once the window has
# closed: the JAX package the program was ported from, and JAX itself.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bevy_ggrs_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One cell: its ``BENCHMARK.json`` entry, configuration, traffic mix,
    correctness limits, and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def named(cls, name: str, overrides: Optional[dict] = None) -> "Cell":
        """The cell ``name``; ``overrides`` (``{"config": {...}, "traffic":
        {...}}``) replaces entries of its files, for tests at a small
        size."""
        spec = benchmark_spec()
        entry = {w["name"]: w for w in spec["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        config = next(c for c in spec["configs"] if c["name"] == entry["config"])
        cfg = load_json(ROOT / config["file"])
        traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
        limits = load_json(BENCH / "workloads" / f"{name}.json")["limits"]
        overrides = overrides or {}
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))

        def mine(m):
            return name in m.get("workloads", [name])

        e2e = [m for m in spec["end_to_end"] if mine(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"] if mine(m) and m["moves"] in reported]
        return cls(name, int(entry["chips"]), cfg, traffic, limits, e2e, per_layer)


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py`` (a name may hold dots),
    else of the file named by the part of ``name`` before the first dot."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + path.stem.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Inputs from the seed
# ---------------------------------------------------------------------------


def rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one use of the seed (``stream`` tells the uses
    apart), for any whole-number seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def torch_seed(seed: int, stream: int) -> int:
    return int(rng(seed, stream).integers(0, 2**62))


def uniform_bitmask(seed: int, frames: int, players: int, bits: int) -> np.ndarray:
    """``u8[frames, players]``: each player's bitmask a frame, uniform over
    the low ``bits`` bits."""
    return rng(seed, 1).integers(0, 1 << bits, (frames, players)).astype(np.uint8)


def make_flock(cfg: dict, seed: int, device):
    """The configuration's flock as a world on ``device``: the golden-angle
    spawn spiral of ``models/boids.py`` (boid ``i`` at radius ``0.15 *
    sqrt(i + 1)``, angle ``2.399963 i``), velocities uniform in ``[-0.03,
    0.03]`` from a ``torch.Generator`` on the device seeded from ``seed``,
    the first ``players`` boids the player-steered leaders. A few calls,
    all on the device."""
    import torch

    from bevy_ggrs_tpu_torch.state import WorldState

    n, players = int(cfg["num_boids"]), int(cfg["players"])
    i = torch.arange(n, dtype=torch.float64, device=device)
    ang, rad = i * 2.399963, 0.15 * torch.sqrt(i + 1)
    pos = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], 1).to(torch.float32)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    vel = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float32) * 0.06 - 0.03
    ids = torch.arange(n, dtype=torch.int32, device=device)
    every = torch.ones((n,), dtype=torch.bool, device=device)
    return WorldState(
        alive=every.clone(), rollback_id=ids.clone(),
        components={"position": pos, "velocity": vel,
                    "leader_handle": torch.where(ids < players, ids, -1)},
        present={k: every.clone() for k in ("position", "velocity", "leader_handle")},
        resources={"frame_count": torch.zeros((), dtype=torch.uint32, device=device)})


def world_to_host(state, index: Tuple = ()) -> dict:
    """Host copy of one world: of ``state`` itself, or of ``state``'s
    entry ``index`` along its leading axes (a ring row, a branch)."""
    def h(t):
        return t[index].detach().cpu().numpy().copy()

    return {"alive": h(state.alive), "rollback_id": h(state.rollback_id),
            "present": {k: h(v) for k, v in state.present.items()},
            "components": {k: h(v) for k, v in state.components.items()},
            "resources": {k: h(v) for k, v in state.resources.items()}}


# ---------------------------------------------------------------------------
# Host spans and the device trace
# ---------------------------------------------------------------------------


class Spans:
    """Host spans the benchmark records around its calls into the program's
    layers: each call's start and end in wall-clock nanoseconds, the clock
    the profiler's events carry, so a gap on the device can be named by the
    span the host was in."""

    def __init__(self) -> None:
        self.calls: Dict[str, List[Tuple[int, int]]] = {}

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)
        calls = self.calls.setdefault(name, [])

        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                calls.append((t0, time.time_ns()))

        setattr(obj, attr, timed)

    def call(self, name: str, fn: Callable, *args):
        """``fn(*args)``, its span recorded under ``name``."""
        t0 = time.time_ns()
        try:
            return fn(*args)
        finally:
            self.calls.setdefault(name, []).append((t0, time.time_ns()))

    def mean_ms(self, name: str) -> Optional[float]:
        c = self.calls.get(name)
        return sum(t1 - t0 for t0, t1 in c) / len(c) / 1e6 if c else None

    def sorted(self) -> List[Tuple[int, int, str]]:
        return sorted((t0, t1, n) for n, c in self.calls.items() for t0, t1 in c)


def _containing(intervals: List[Tuple], starts: List, t) -> Optional[Tuple]:
    """Of ``intervals`` (sorted by start), the one that holds ``t`` among
    the 64 that start last before it, or None."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - 64, -1), -1):
        if intervals[j][1] >= t:
            return intervals[j]
    return None


@dataclasses.dataclass
class DeviceTrace:
    """The device operations ``torch.profiler`` recorded in a window, read
    from its raw events: ``ops`` ``(start_ns, end_ns, name)`` of every
    kernel, copy and set; ``host`` the CUDA runtime calls the host made;
    ``spans`` the benchmark's own host spans."""

    ops: List[Tuple[int, int, str]]
    host: List[Tuple[int, int, str]]
    spans: List[Tuple[int, int, str]]

    @classmethod
    def of(cls, prof, spans: Spans) -> "DeviceTrace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ops, host = [], []
        for e in prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() != cuda:
                host.append(rec)
            elif not getattr(e, "is_user_annotation", lambda: False)():
                ops.append(rec)
        ops.sort()
        host.sort()
        return cls(ops, host, spans.sorted())

    def busy_s(self) -> float:
        busy, end = 0, None
        for t0, t1, _ in self.ops:
            busy += max(0, t1 - (t0 if end is None else max(t0, end)))
            end = t1 if end is None else max(end, t1)
        return busy / 1e9

    def seconds_of(self, *names: str) -> Tuple[float, int]:
        """Total seconds and count of the ops whose name holds any of
        ``names``."""
        t, n = 0, 0
        for t0, t1, name in self.ops:
            if any(k in name for k in names):
                t += t1 - t0
                n += 1
        return t / 1e9, n

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for t0, t1, name in self.ops:
            by[name[:96]] = by.get(name[:96], 0) + (t1 - t0)
        return [[n, s / 1e9] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def host_calls(self, k: int = 8) -> List[list]:
        """The ``k`` CUDA runtime calls the host spent most time in: name,
        count, total seconds, longest call. A launch or copy that waits for
        the card shows here as a long call."""
        by: Dict[str, list] = {}
        for t0, t1, name in self.host:
            row = by.setdefault(name[:64], [name[:64], 0, 0, 0])
            row[1] += 1
            row[2] += t1 - t0
            row[3] = max(row[3], t1 - t0)
        rows = sorted(by.values(), key=lambda r: -r[2])[:k]
        return [[n, c, t / 1e9, m / 1e9] for n, c, t, m in rows]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest gaps between device operations, each named by
        the benchmark span the host was in at its middle and the CUDA
        runtime call it was making then (``python`` when none)."""
        gaps, end = [], None
        for t0, t1, _ in self.ops:
            if end is not None and t0 > end:
                gaps.append((t0 - end, end, t0))
            end = t1 if end is None else max(end, t1)
        gaps.sort(reverse=True)
        span_starts = [s[0] for s in self.spans]
        host_starts = [h[0] for h in self.host]
        out = []
        for width, g0, g1 in gaps[:k]:
            mid = (g0 + g1) // 2
            span = _containing(self.spans, span_starts, mid)
            call = _containing(self.host, host_starts, mid)
            out.append([f"{span[2] if span else 'harness'} / {call[2][:64] if call else 'python'}",
                        width / 1e9])
        return out


@dataclasses.dataclass
class Window:
    """What a traced window gives the per-layer readers."""

    cell: Cell
    seconds: float  # host clock, start to the closing synchronize
    units: int  # ticks or rollouts completed
    spans: Spans
    counters: Dict[str, float]
    trace: DeviceTrace
    # The program's own spans in the window (``SpanTracer.summary()``: name
    # -> count, total_ms, mean_ms, max_ms), where the driver gave it one.
    program_spans: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def ops_per_unit(self) -> Optional[float]:
        """Device operations (kernels, copies and sets) in the trace per
        tick or rollout."""
        if not self.trace.ops or not self.units:
            return None
        return len(self.trace.ops) / self.units


def traced(fn: Callable[[], None]):
    """Run ``fn`` under ``torch.profiler`` and return the profiler: device
    activity only on a card (host ops are not recorded, which keeps the
    profiler's own cost off the host's dispatch), host ops on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        fn()
    return prof


def launch_counts() -> Dict[str, int]:
    from bevy_ggrs_tpu_torch.ops import launch_counts as counts

    return counts()


def delta(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


# ---------------------------------------------------------------------------
# The result line
# ---------------------------------------------------------------------------


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Return the memory of objects the caller dropped (the program's state,
    before the reference runs)."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_info(device) -> dict:
    """The result's ``device``, its peak memory read now (right after the
    window)."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    # The tests' rehearsal only: main() refuses to run without a card.
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def card_state() -> Optional[str]:
    """The card's name and power limit, and its clock, temperature and draw
    now, as ``nvidia-smi`` reads them (None where it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "temperature.gpu,power.draw", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: end-to-end numbers (``--trace 0``) or the
    traced window (``--trace 1``), the work attempted and failed, the
    comparison's tally, and the device's peak memory read right after the
    window."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    window: Optional[Window]
    checks: Dict[str, dict]
    device: dict
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def result_line(cell: Cell, out: Outcome, trace: bool) -> dict:
    metrics = {}
    breakdown = None
    if trace:
        w = out.window
        out.device["busy_s"], out.device["window_s"] = w.trace.busy_s(), w.seconds
        for m in cell.per_layer:
            value = metric_reader(m["name"])(w)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = {"device_ops": w.trace.top_ops(), "idle_gaps": w.trace.idle_gaps()}
        out.notes["host_calls"] = w.trace.host_calls()
    else:
        for m in cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                      "unit": m["unit"]}
    within = all(c["value"] <= c["limit"] for c in out.checks.values())
    line = {"correct": bool(out.failed == 0 and within and out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": out.device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["notes"] = out.notes
    line["checks"] = out.checks
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[dict] = None, t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line.
    ``main`` passes the card; the tests pass the CPU and a small size.
    ``control`` also reads the control's numbers (``notes.control``): the
    limits' calibration and its tests, never the benchmark's own runs."""
    cell = Cell.named(name, overrides)
    t_start = time.perf_counter() if t_start is None else t_start
    out = driver(cell).run(cell, int(seed), float(seconds), bool(trace), device, t_start,
                           control=control)
    return result_line(cell, out, trace)
