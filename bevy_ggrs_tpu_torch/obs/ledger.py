"""Speculation ledger: per-rollback causal accounting for the branch tree.

Counterpart of ``bevy_ggrs_tpu/obs/ledger.py`` (its entries, aggregates,
scoped views and exports; host code, bitwise the same outputs). The
speculative runner's aggregate counters (``spec_hits`` /
``spec_partial_hits`` / ``spec_misses``) say *whether* speculation pays,
never *why* it fails. The ledger records one causal entry per rollback:

- **blame**: which player's input at which frame diverged from the
  branch-0 prediction (from the corrected-history diff the prefix matcher
  already computes; no device read);
- **rank**: which branch matched. The structured tree enumerates
  candidates rank-major (``spec_runner._structured_bits``), so the matched
  branch index is the candidate rank;
- **economics**: frames recovered against frames resimulated per rollback,
  and speculative frames dispatched against frames committed over the run
  (the **waste ratio**: a rollout computes B×F frames of which at most F
  ever commit).

Outcomes, one entry per rollback, reconciled against the runner's
counters:

- ``full``: the whole recovery burst absorbed (``spec_hits``);
- ``partial``: a prefix absorbed, the tail resimulated
  (``spec_partial_hits``);
- ``miss``: a branch match was attempted and no branch covered the
  corrected history (``spec_misses``);
- ``unmatched``: a rollback with no match attempt (no pending rollout,
  anchor out of window, input-log gap, non-canonical burst, speculation
  disabled, restore-path recovery).
  ``full + partial + miss + unmatched == rollbacks_total``.

The ``null_ledger`` singleton keeps every call site unconditional. The
JAX module's counterfactual replay harness and its command line wait for
the predictor and the other models (ROADMAP.md, port queue items 4-5).
"""

from __future__ import annotations

import json
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Entry outcomes, in reconciliation order (see module docstring).
OUTCOMES: Tuple[str, ...] = ("full", "partial", "miss", "unmatched")


def blame_divergence(predicted, corrected) -> Optional[Tuple[int, int]]:
    """First ``(frame_offset, player)`` at which ``corrected`` diverges
    from the branch-0 ``predicted`` rows (both ``[k, P, *payload]``),
    scanning frame-major then player: the earliest mispredicted input is
    the causal one. ``None`` when the rows agree."""
    pred = np.asarray(predicted)
    corr = np.asarray(corrected)
    k = min(int(pred.shape[0]), int(corr.shape[0]))
    if k <= 0:
        return None
    P = int(corr.shape[1])
    diff = (
        pred[:k].reshape(k, P, -1) != corr[:k].reshape(k, P, -1)
    ).any(axis=2)
    if not diff.any():
        return None
    j, p = np.unravel_index(int(np.argmax(diff)), diff.shape)
    return int(j), int(p)


class SpeculationLedger:
    """Bounded per-rollback entry ring and persistent aggregate totals.

    Entries are plain dicts (JSONL-exportable as they are) on a ``deque``
    of ``capacity``; the aggregates (outcome counts, blame and rank
    histograms, frame economics) survive ring eviction, so ``summary()``
    covers the whole run. ``seq`` is monotonic: a polling consumer reads
    only new entries through :meth:`tail`.
    """

    enabled = True

    def __init__(
        self,
        capacity: int = 65536,
        clock=time.perf_counter,
        component: str = "spec",
        pid: int = 0,
        wall_t0: Optional[float] = None,
    ):
        self.capacity = int(capacity)
        self.component = component
        self.pid = int(pid)
        self.wall_t0 = time.time() if wall_t0 is None else float(wall_t0)
        self._clock = clock
        self._origin = clock()
        self.entries: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.outcome_counts: Counter = Counter()
        self.frames_recovered_total = 0
        self.frames_resimulated_total = 0
        self.rollouts_dispatched = 0
        self.spec_frames_dispatched = 0
        self.blame_counts: Counter = Counter()  # player -> entries blamed
        self.rank_hist: Counter = Counter()  # branch rank -> hit count

    # -- writers ---------------------------------------------------------

    def _now_us(self) -> int:
        return int((self._clock() - self._origin) * 1e6)

    def record(
        self,
        outcome: str,
        *,
        depth: int = 0,
        frames_recovered: int = 0,
        frames_resimulated: int = 0,
        branch: Optional[int] = None,
        rank: Optional[int] = None,
        blame_player: Optional[int] = None,
        blame_frame: Optional[int] = None,
        slot: Optional[int] = None,
        load_frame: Optional[int] = None,
    ) -> None:
        """One causal entry per rollback. ``depth`` is the rollback span;
        ``frames_recovered + frames_resimulated == depth``."""
        entry = {
            "seq": self._seq,
            "ts_us": self._now_us(),
            "outcome": outcome,
            "depth": int(depth),
            "frames_recovered": int(frames_recovered),
            "frames_resimulated": int(frames_resimulated),
        }
        if branch is not None:
            entry["branch"] = int(branch)
        if rank is not None:
            entry["rank"] = int(rank)
        if blame_player is not None:
            entry["blame_player"] = int(blame_player)
            self.blame_counts[int(blame_player)] += 1
        if blame_frame is not None:
            entry["blame_frame"] = int(blame_frame)
        if slot is not None:
            entry["slot"] = int(slot)
        if load_frame is not None:
            entry["load_frame"] = int(load_frame)
        self._seq += 1
        self.entries.append(entry)
        self.outcome_counts[outcome] += 1
        self.frames_recovered_total += int(frames_recovered)
        self.frames_resimulated_total += int(frames_resimulated)
        if rank is not None and outcome in ("full", "partial"):
            self.rank_hist[int(rank)] += 1

    def record_rollout(self, frames: int, slot: Optional[int] = None) -> None:
        """One speculative rollout dispatched: ``frames`` = B×F frames of
        branch compute (of which at most F can ever commit)."""
        self.rollouts_dispatched += 1
        self.spec_frames_dispatched += int(frames)

    # -- readers ---------------------------------------------------------

    @property
    def rollbacks(self) -> int:
        return sum(self.outcome_counts[o] for o in OUTCOMES)

    def tail(self, since_seq: int) -> List[dict]:
        """Entries with ``seq >= since_seq``, oldest first (pass the last
        seen ``seq + 1``)."""
        if not self.entries or self.entries[-1]["seq"] < since_seq:
            return []
        return [e for e in self.entries if e["seq"] >= since_seq]

    def _rank_percentile(self, q: float) -> float:
        total = sum(self.rank_hist.values())
        if total == 0:
            return 0.0
        target = max(1, int(np.ceil(q * total)))  # nearest rank
        cum = 0
        for rank in sorted(self.rank_hist):
            cum += self.rank_hist[rank]
            if cum >= target:
                return float(rank)
        return float(max(self.rank_hist))

    def summary(self) -> Dict[str, float]:
        """Whole-run hit rate, hit-rank percentiles, waste ratio and blame
        concentration."""
        rb = self.rollbacks
        blamed = sum(self.blame_counts.values())
        dispatched = self.spec_frames_dispatched
        committed = self.frames_recovered_total
        return {
            "rollbacks": rb,
            "spec_full": self.outcome_counts["full"],
            "spec_partial": self.outcome_counts["partial"],
            "spec_miss": self.outcome_counts["miss"],
            "spec_unmatched": self.outcome_counts["unmatched"],
            "spec_full_hit_rate": (
                self.outcome_counts["full"] / rb if rb else 0.0
            ),
            "spec_hit_rank_p50": self._rank_percentile(0.5),
            "spec_hit_rank_p99": self._rank_percentile(0.99),
            "spec_waste_ratio": (
                max(0.0, 1.0 - committed / dispatched) if dispatched else 0.0
            ),
            "blame_top_player_share": (
                max(self.blame_counts.values()) / blamed if blamed else 0.0
            ),
            "frames_recovered_total": committed,
            "frames_resimulated_total": self.frames_resimulated_total,
            "rollouts_dispatched": self.rollouts_dispatched,
            "spec_frames_dispatched": dispatched,
        }

    def blame_shares(self) -> Dict[int, float]:
        """player -> share of blamed rollbacks (empty until one blames)."""
        total = sum(self.blame_counts.values())
        if not total:
            return {}
        return {
            p: c / total for p, c in sorted(self.blame_counts.items())
        }

    def scoped(self, slot_base: int) -> "_ScopedLedger":
        """A writer view that offsets every entry's ``slot`` by
        ``slot_base`` into this ledger."""
        return _ScopedLedger(self, int(slot_base))

    def clear(self) -> None:
        self.entries.clear()
        self.outcome_counts.clear()
        self.blame_counts.clear()
        self.rank_hist.clear()
        self.frames_recovered_total = 0
        self.frames_resimulated_total = 0
        self.rollouts_dispatched = 0
        self.spec_frames_dispatched = 0

    # -- exports ---------------------------------------------------------

    def export_jsonl(self, path: str) -> None:
        """The entry ring as JSON lines, the first line a meta header."""
        with open(path, "w") as f:
            f.write(json.dumps({"meta": {
                "component": self.component, "pid": self.pid,
                "wall_t0": self.wall_t0, "summary": self.summary(),
            }}) + "\n")
            for e in self.entries:
                f.write(json.dumps(e) + "\n")

    def export_provenance(self, path: str, provenance_records) -> int:
        """Blamed entries as provenance-format JSONL: each resolves the
        ``flow_key`` of the last received input datagram (from
        ``provenance_records``: a list of record dicts, or an object whose
        ``records`` attribute or method gives one) whose start frame is at
        most the blamed frame, and re-emits it as a received ``spec_resim``
        record under this ledger's component. Returns the records
        written."""
        records = getattr(provenance_records, "records", provenance_records)
        if callable(records):
            records = records()
        rx_inputs = [
            r for r in records
            if r.get("dir") == "rx" and r.get("type") == "input"
            and r.get("frame") is not None
        ]
        written = 0
        with open(path, "w") as f:
            f.write(json.dumps({"meta": {
                "component": self.component, "pid": self.pid,
                "wall_t0": self.wall_t0,
            }}) + "\n")
            for e in self.entries:
                bf = e.get("blame_frame")
                if bf is None:
                    continue
                cands = [r for r in rx_inputs if r["frame"] <= bf]
                if not cands:
                    continue
                src = max(cands, key=lambda r: (r["frame"], r["ts_us"]))
                rec = {
                    # Strictly after the source datagram, so a merged flow
                    # ends here even across clock-origin skew.
                    "ts_us": max(e["ts_us"], src["ts_us"] + 1),
                    "dir": "rx",
                    "key": src["key"],
                    "len": 0,
                    "type": "spec_resim",
                    "frame": bf,
                    "blame_player": e.get("blame_player"),
                    "outcome": e["outcome"],
                    "depth": e["depth"],
                }
                if "slot" in e:
                    rec["slot"] = e["slot"]
                f.write(json.dumps(rec) + "\n")
                written += 1
        return written


class _ScopedLedger:
    """Per-slot-group writer view over a parent ledger (see
    :meth:`SpeculationLedger.scoped`); readers go through the parent."""

    __slots__ = ("parent", "slot_base")

    def __init__(self, parent: SpeculationLedger, slot_base: int):
        self.parent = parent
        self.slot_base = slot_base

    @property
    def enabled(self) -> bool:
        return self.parent.enabled

    def record(self, outcome: str, *, slot: Optional[int] = None, **kw) -> None:
        self.parent.record(
            outcome,
            slot=self.slot_base + (slot or 0),
            **kw,
        )

    def record_rollout(self, frames: int, slot: Optional[int] = None) -> None:
        self.parent.record_rollout(
            frames, slot=self.slot_base + (slot or 0)
        )


class _NullLedger:
    """Disabled ledger: writers are no-ops, readers are empty, so call
    sites stay unconditional. ``enabled`` is False, so blame computation
    is skipped at the match sites."""

    enabled = False
    entries: Tuple[dict, ...] = ()
    rollbacks = 0
    frames_recovered_total = 0
    frames_resimulated_total = 0
    rollouts_dispatched = 0
    spec_frames_dispatched = 0

    def record(self, outcome: str, **kw) -> None:
        pass

    def record_rollout(self, frames: int, slot: Optional[int] = None) -> None:
        pass

    def tail(self, since_seq: int) -> List[dict]:
        return []

    def summary(self) -> Dict[str, float]:
        return {}

    def blame_shares(self) -> Dict[int, float]:
        return {}

    def scoped(self, slot_base: int) -> "_NullLedger":
        return self

    def clear(self) -> None:
        pass

    def export_jsonl(self, path: str) -> None:
        pass

    def export_provenance(self, path: str, provenance_records) -> int:
        return 0


null_ledger = _NullLedger()
