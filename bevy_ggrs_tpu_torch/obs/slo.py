"""Slot SLO engine: windowed objectives + multi-window burn-rate alerts.

`serve/faults.py` gave each slot a health FSM, but its only *input* is
the watchdog (a per-tick boolean). A fleet balancer needs rates: a slot
that misses its frame deadline 2% of the time is fine for one tick and
fatal over an hour. This module keeps small per-slot sample windows and
reduces them to the standard SRE signal — error-budget **burn rate**
(bad fraction divided by allowed fraction) over a short and a long
window — so one number says "how fast is this slot spending its budget".

Objectives per slot (all windowed, all configurable):

==============  ====================================================
deadline        fraction of ticks inside the frame budget
rollback        fraction of ticks whose rollback depth stays <= limit
recovery        fraction of ticks with recovery debt <= limit frames
quarantine      duty-cycle bound: fraction of ticks NOT quarantined
==============  ====================================================

Alert levels follow the multi-window pattern (fast burn on BOTH windows
pages; slow burn on the long window warns), which is robust to the two
classic failure modes: a single bad tick never pages (short window alone
is noisy), and a slow leak can't hide (long window catches it).

Outputs:

- :meth:`SlotSLO.level` -> ``"ok" | "warn" | "page"`` per slot, which
  :meth:`~bevy_ggrs_tpu_torch.serve.faults.SlotHealthFSM.slo_signal` consumes
  (a paging slot is driven to DEGRADED even when every individual tick
  passed the watchdog; a recovered budget clears it);
- labeled Prometheus exposition through the existing ``Metrics`` path
  (``slo_burn{match_slot,objective}`` series + level-transition
  counters), bounded by the label-cardinality guard;
- :meth:`SlotSLO.snapshot` for the HTML ops report.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional, Tuple

from ..utils.metrics import null_metrics

LEVEL_OK = "ok"
LEVEL_WARN = "warn"
LEVEL_PAGE = "page"


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    # Objectives: allowed good-fraction per window.
    deadline_objective: float = 0.99
    rollback_objective: float = 0.95
    recovery_objective: float = 0.95
    quarantine_objective: float = 0.80  # <= 20% duty cycle quarantined
    # What counts as a bad tick.
    rollback_depth_limit: int = 6   # frames resimulated in one tick
    recovery_debt_limit: int = 30   # frames behind the group head
    # Windows are in ticks (the server tick IS the sampling clock).
    short_window: int = 64
    long_window: int = 512
    # Burn thresholds (SRE convention: burn 1.0 = spending exactly the
    # error budget; 14.4 = a 30-day budget gone in 2 days).
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    # Minimum samples before a window is trusted (no paging on 3 ticks).
    min_samples: int = 16


_OBJECTIVES = ("deadline", "rollback", "recovery", "quarantine")


class _SlotWindow:
    """Per-slot bounded rings of per-tick bad/good booleans."""

    __slots__ = ("bad",)

    def __init__(self, long_window: int):
        self.bad: Dict[str, Deque[bool]] = {
            name: collections.deque(maxlen=long_window)
            for name in _OBJECTIVES
        }


class SlotSLO:
    def __init__(
        self,
        config: Optional[SLOConfig] = None,
        metrics=null_metrics,
    ):
        self.config = config or SLOConfig()
        self.metrics = metrics
        self._slots: Dict[int, _SlotWindow] = {}
        self._levels: Dict[int, str] = {}

    # -- sampling --------------------------------------------------------

    def observe_tick(
        self,
        slot: int,
        *,
        deadline_ok: bool,
        rollback_depth: int = 0,
        recovery_debt: int = 0,
        quarantined: bool = False,
    ) -> None:
        """Record one server tick for one slot."""
        cfg = self.config
        w = self._slots.get(slot)
        if w is None:
            w = self._slots[slot] = _SlotWindow(cfg.long_window)
        w.bad["deadline"].append(not deadline_ok)
        w.bad["rollback"].append(rollback_depth > cfg.rollback_depth_limit)
        w.bad["recovery"].append(recovery_debt > cfg.recovery_debt_limit)
        w.bad["quarantine"].append(bool(quarantined))

    def forget(self, slot: int) -> None:
        """Drop one slot's windows. A slot's SLO history is per-tenancy:
        when its match leaves (retire, suspend/migrate, evict), keeping
        the frozen window would hold the slot at its last level forever —
        an evacuated-then-idle server would page indefinitely — and the
        NEXT tenant would inherit the previous tenant's burn."""
        self._slots.pop(slot, None)
        self._levels.pop(slot, None)

    # -- reduction -------------------------------------------------------

    def _objective(self, name: str) -> float:
        return getattr(self.config, f"{name}_objective")

    def burn_rates(self, slot: int) -> Dict[str, Dict[str, float]]:
        """Per objective: bad fraction and burn rate over both windows.
        Burn = bad_fraction / (1 - objective); 1.0 means the budget is
        being spent exactly at the allowed rate."""
        w = self._slots.get(slot)
        out: Dict[str, Dict[str, float]] = {}
        if w is None:
            return out
        short_n = self.config.short_window
        for name in _OBJECTIVES:
            ring = w.bad[name]
            budget = max(1.0 - self._objective(name), 1e-9)
            long_list = list(ring)
            short_list = long_list[-short_n:]
            stats = {}
            for label, vals in (("short", short_list), ("long", long_list)):
                n = len(vals)
                frac = (sum(vals) / n) if n else 0.0
                stats[f"{label}_n"] = n
                stats[f"{label}_bad"] = frac
                stats[f"{label}_burn"] = frac / budget
            out[name] = stats
        return out

    def level(self, slot: int) -> str:
        """Alert level for one slot: fast burn on BOTH windows -> page;
        slow burn on the long window -> warn; else ok. Windows below
        ``min_samples`` never alert."""
        cfg = self.config
        worst = LEVEL_OK
        for stats in self.burn_rates(slot).values():
            if stats["short_n"] < cfg.min_samples:
                continue
            if (
                stats["short_burn"] >= cfg.fast_burn
                and stats["long_burn"] >= cfg.fast_burn
            ):
                return LEVEL_PAGE
            if stats["long_burn"] >= cfg.slow_burn:
                worst = LEVEL_WARN
        return worst

    # -- export ----------------------------------------------------------

    def export(self) -> Dict[int, str]:
        """Push the current SLO state through the labeled metrics path
        and return {slot: level}. Level *transitions* count (so the
        exposition shows flap rates, not just the latest state)."""
        levels: Dict[int, str] = {}
        for slot in sorted(self._slots):
            lab = {"match_slot": slot}
            for name, stats in self.burn_rates(slot).items():
                self.metrics.observe(
                    "slo_burn_short", stats["short_burn"],
                    labels={"match_slot": slot, "objective": name},
                )
            lvl = self.level(slot)
            levels[slot] = lvl
            prev = self._levels.get(slot)
            if prev != lvl:
                self._levels[slot] = lvl
                self.metrics.count(
                    "slo_level_transitions", 1,
                    labels={"match_slot": slot, "to": lvl},
                )
            if lvl != LEVEL_OK:
                self.metrics.count(
                    "slo_not_ok_ticks", 1, labels=lab
                )
        return levels

    def snapshot(self) -> Dict[str, object]:
        """Full state for the ops report: per-slot levels + burn rates."""
        return {
            "config": dataclasses.asdict(self.config),
            "slots": {
                str(slot): {
                    "level": self.level(slot),
                    "objectives": self.burn_rates(slot),
                }
                for slot in sorted(self._slots)
            },
        }


class WindowSLO:
    """Server-scope SLO objectives evaluated over the online time-series
    pipeline (:class:`~bevy_ggrs_tpu_torch.obs.timeseries.TimeSeries`) instead
    of per-slot tick booleans — how the SLO engine consumes latency
    series that have no per-tick producer (admission latency, frame
    wall time).

    Each objective names a series and a threshold: a sample above the
    threshold is a bad sample. Burn over the short window (the tail of
    the ring) and the long window (the whole ring) reduces with the same
    multi-window fast/slow rules as :class:`SlotSLO`, so the front-door
    knee detector and the fleet balancer read one vocabulary of levels
    everywhere."""

    def __init__(
        self,
        timeseries,
        objectives: Dict[str, Tuple[str, float, float]],
        config: Optional[SLOConfig] = None,
        metrics=null_metrics,
    ):
        """``objectives``: name -> (series_name, threshold, objective) —
        e.g. ``{"admission": ("admission_ms", 8.0, 0.99)}`` reads "99% of
        admissions complete within 8 ms"."""
        self.timeseries = timeseries
        self.objectives = dict(objectives)
        self.config = config or SLOConfig()
        self.metrics = metrics
        self._levels: Dict[str, str] = {}

    def burn_rates(self, name: str) -> Dict[str, float]:
        series_name, threshold, objective = self.objectives[name]
        w = self.timeseries.window_for(series_name)
        budget = max(1.0 - float(objective), 1e-9)
        if w is None:
            return {
                "short_n": 0, "short_bad": 0.0, "short_burn": 0.0,
                "long_n": 0, "long_bad": 0.0, "long_burn": 0.0,
            }
        vals = w.window_values()
        short = vals[-self.config.short_window:]
        stats: Dict[str, float] = {}
        for label, window in (("short", short), ("long", vals)):
            n = len(window)
            frac = (
                sum(1 for v in window if v > threshold) / n if n else 0.0
            )
            stats[f"{label}_n"] = n
            stats[f"{label}_bad"] = frac
            stats[f"{label}_burn"] = frac / budget
        return stats

    def level(self, name: str) -> str:
        cfg = self.config
        stats = self.burn_rates(name)
        if stats["short_n"] < cfg.min_samples:
            return LEVEL_OK
        if (
            stats["short_burn"] >= cfg.fast_burn
            and stats["long_burn"] >= cfg.fast_burn
        ):
            return LEVEL_PAGE
        if stats["long_burn"] >= cfg.slow_burn:
            return LEVEL_WARN
        return LEVEL_OK

    def export(self) -> Dict[str, str]:
        """Levels for every objective, pushed through the labeled metrics
        path (transition counters, like :meth:`SlotSLO.export`)."""
        levels: Dict[str, str] = {}
        for name in sorted(self.objectives):
            stats = self.burn_rates(name)
            self.metrics.observe(
                "slo_burn_short", stats["short_burn"],
                labels={"objective": name},
            )
            lvl = self.level(name)
            levels[name] = lvl
            if self._levels.get(name) != lvl:
                self._levels[name] = lvl
                self.metrics.count(
                    "slo_level_transitions", 1,
                    labels={"objective": name, "to": lvl},
                )
        return levels

    def snapshot(self) -> Dict[str, object]:
        return {
            "config": dataclasses.asdict(self.config),
            "objectives": {
                name: {
                    "series": self.objectives[name][0],
                    "threshold": self.objectives[name][1],
                    "objective": self.objectives[name][2],
                    "level": self.level(name),
                    "burn": self.burn_rates(name),
                }
                for name in sorted(self.objectives)
            },
        }
