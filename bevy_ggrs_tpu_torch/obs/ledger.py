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

The ``null_ledger`` singleton keeps every call site unconditional.

The counterfactual replay harness (:func:`replay_config`,
:func:`replay_baseline`, ``python -m bevy_ggrs_tpu_torch.obs.ledger
replay``) scores branch-ranking policies (``POLICY_REGISTRY``:
``current``, ``repeat_last``, ``learned``) over the canonical scripted
input logs of the four models' speculating configurations, host-only, with
the speculative runner's own tree code; its scores equal the JAX
package's.
"""

from __future__ import annotations

import json
import time
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Tuple

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


# ----------------------------------------------------------------------
# Counterfactual ranking harness (offline, host-only).
# ----------------------------------------------------------------------

#: Pluggable ranking-policy registry. A policy is registered under a name
#: as a FACTORY: it receives the fresh per-run ``_ReplayBuilder`` (the
#: branch-tree geometry and the growing canonical input log; it may swap
#: the log for a native ``MirroredLog`` or attach a ``_predictor``) and
#: returns the per-anchor callable ``fn(anchor, last, known, mask) ->
#: (bits, n_branches)``. Built-ins:
#:
#: - ``current``: the production structured tree (history-ranked
#:   candidates and periodic extrapolation, through the native builder
#:   when it loads);
#: - ``repeat_last``: the single forward-fill branch, the reference
#:   engine's whole prediction policy and the floor any learned ranker
#:   must clear;
#: - ``learned``: the ``predict/`` tier, the committed int8 MLP artifact
#:   seeding the same structured tree.
PolicyFactory = Callable[..., Callable]

POLICY_REGISTRY: Dict[str, PolicyFactory] = {}


def register_policy(name: str):
    """Decorator: ``@register_policy("mine")`` over a policy factory."""

    def deco(factory):
        POLICY_REGISTRY[name] = factory
        return factory

    return deco


def _replay_configs() -> Dict[str, dict]:
    """The live paced pairs' model configs (the JAX bench's model zoo
    shapes) and the 8-player, 1,024-branch spectator config, with the
    benches' key cycles (``keys[(frame // 3 + handle) % len(keys)]``)."""
    from bevy_ggrs_tpu_torch.models import boids, box_game, neural_bots, projectiles

    box_keys = [box_game.INPUT_UP, box_game.INPUT_RIGHT, box_game.INPUT_DOWN, 0]
    return {
        "box_game": dict(input_spec=box_game.INPUT_SPEC, players=2, branches=64,
                         spec_frames=8, keys=box_keys),
        "boids": dict(input_spec=boids.INPUT_SPEC, players=2, branches=16, spec_frames=8,
                      keys=[boids.INPUT_UP, boids.INPUT_RIGHT, boids.INPUT_DOWN, 0]),
        "projectiles": dict(input_spec=projectiles.INPUT_SPEC, players=4, branches=64,
                            spec_frames=8,
                            keys=[projectiles.INPUT_UP, projectiles.INPUT_FIRE,
                                  projectiles.INPUT_RIGHT, 0]),
        "neural_bots": dict(input_spec=neural_bots.INPUT_SPEC, players=2, branches=32,
                            spec_frames=8, keys=[1, 2, 4, 0]),
        "box_game_8p_B1024": dict(input_spec=box_game.INPUT_SPEC, players=8, branches=1024,
                                  spec_frames=12, keys=box_keys),
    }


class _ReplayBuilder:
    """Host-only stand-in that borrows the speculative runner's unbound
    branch-tree methods, so the harness builds bitwise the tree the live
    runner dispatches without a world, a schedule or an executor."""

    def __init__(self, input_spec, players, branches, frames, values):
        from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as R

        self.input_spec = input_spec
        self.num_players = int(players)
        self.num_branches = int(branches)
        self.spec_frames = int(frames)
        self._branch_values = list(values)
        self._input_log: dict = {}
        self._structured_bits = R._structured_bits.__get__(self)
        self._candidate_values = R._candidate_values.__get__(self)
        self._extrapolate_base = R._extrapolate_base.__get__(self)
        self._history_fingerprint = R._history_fingerprint.__get__(self)


def _branch_values_for(input_spec) -> list:
    # The runner's default universe.
    if getattr(input_spec, "values", None):
        return list(input_spec.values)
    return list(range(16))


@register_policy("current")
def _policy_current(builder: "_ReplayBuilder"):
    """The production structured tree, native builder when it loads."""
    from bevy_ggrs_tpu_torch.native import spec as native_spec

    native = native_spec.make_spec_builder(
        builder.input_spec, builder.num_players, builder.num_branches,
        builder.spec_frames, builder._branch_values,
    )
    if native is not None:
        builder._input_log = native_spec.MirroredLog(native)

    def fn(anchor, last, known, mask):
        if native is not None:
            bits, _ = native.build(anchor, None, known, mask, False, None)
        else:
            bits = builder._structured_bits(np.asarray(last), known, mask, anchor)
        return np.asarray(bits), builder.num_branches

    return fn


@register_policy("repeat_last")
def _policy_repeat_last(builder: "_ReplayBuilder"):
    """The single forward-fill branch."""
    from bevy_ggrs_tpu_torch.spec_runner import _forward_fill

    def fn(anchor, last, known, mask):
        base = _forward_fill(np.asarray(last), known, mask)
        return np.broadcast_to(base, (1,) + base.shape).copy(), 1

    return fn


@register_policy("learned")
def _policy_learned(builder: "_ReplayBuilder"):
    """The committed int8 MLP artifact bound to this config's universe,
    seeding the structured tree the live path builds (branch 0 stays the
    forward fill inside ``_structured_bits``)."""
    from bevy_ggrs_tpu_torch.predict import InputPredictor, load_default

    spec = builder.input_spec
    n_field = 1
    if getattr(spec, "shape", ()):
        n_field = int(np.prod(spec.shape, dtype=np.int64))
    bound = InputPredictor(load_default()).bind(
        builder._branch_values, spec.zeros_np(1).dtype, n_field)
    if bound is None:
        raise ValueError(
            "learned policy: predictor does not apply to this config "
            f"(n_field={n_field}, universe={len(builder._branch_values)})")
    builder._predictor = bound

    def fn(anchor, last, known, mask):
        bits = builder._structured_bits(np.asarray(last), known, mask, anchor)
        return np.asarray(bits), builder.num_branches

    return fn


#: Registration-ordered policy names; the command line scores them all.
POLICIES: Tuple[str, ...] = tuple(POLICY_REGISTRY)


def replay_config(name: str, cfg: dict, frames: int, policies=POLICIES) -> Dict[str, dict]:
    """Score each ranking policy over ``frames`` anchors of the canonical
    scripted input log of one model config. Host work only: branch tensors
    are built and prefix-matched against the scripted truth; no rollout
    runs (the waste is the dispatch-side B x F accounting the live ledger
    records per rollout)."""
    from bevy_ggrs_tpu_torch.parallel.speculate import match_branch

    spec = cfg["input_spec"]
    P, B, F = cfg["players"], cfg["branches"], cfg["spec_frames"]
    keys = cfg["keys"]
    values = _branch_values_for(spec)
    zeros = spec.zeros_np(P)
    dtype = spec.zeros_np(1).dtype

    def frame_input(f: int) -> np.ndarray:
        row = zeros.copy()
        for h in range(P):
            row[h] = np.asarray(keys[(f // 3 + h) % len(keys)], dtype)
        return row

    # The span is scored as pure prediction (no pinned known inputs):
    # pinning would shift every policy alike.
    known = np.broadcast_to(zeros, (F,) + zeros.shape).copy()
    mask = np.zeros((F, P), dtype=bool)

    out: Dict[str, dict] = {}
    for policy in policies:
        factory = POLICY_REGISTRY.get(policy)
        if factory is None:
            raise ValueError(f"unknown ranking policy {policy!r} "
                             f"(registered: {', '.join(POLICY_REGISTRY)})")
        builder = _ReplayBuilder(spec, P, B, F, values)
        policy_fn = factory(builder)
        ledger = SpeculationLedger(capacity=frames + 1)
        full_hits = 0
        anchors = 0
        builder._input_log[0] = frame_input(0)
        for a in range(1, max(2, frames - F)):
            last = builder._input_log[a - 1]
            bits, n_branches = policy_fn(a, last, known, mask)
            truth = np.stack([frame_input(a + t) for t in range(F)])
            branch, depth = match_branch(np.asarray(bits), truth)
            branch, depth = int(branch), int(depth)
            anchors += 1
            ledger.record_rollout(n_branches * F)
            blame = blame_divergence(np.asarray(bits)[0], truth)
            outcome = "full" if depth == F else ("partial" if depth > 0 else "miss")
            if depth == F:
                full_hits += 1
            ledger.record(
                outcome, depth=F, frames_recovered=depth, frames_resimulated=F - depth,
                branch=branch if depth > 0 else None, rank=branch if depth > 0 else None,
                blame_player=None if blame is None else blame[1],
                blame_frame=None if blame is None else a + blame[0],
                load_frame=a,
            )
            builder._input_log[a] = frame_input(a)
        s = ledger.summary()
        out[policy] = {
            "anchors": anchors,
            "full_hits": full_hits,
            "full_hit_rate": round(full_hits / anchors, 4) if anchors else 0.0,
            "hit_rank_p50": s["spec_hit_rank_p50"],
            "hit_rank_p99": s["spec_hit_rank_p99"],
            "waste_ratio": round(s["spec_waste_ratio"], 4),
            "blame_top_player_share": round(s["blame_top_player_share"], 4),
            "mean_commit_depth": (round(s["frames_recovered_total"] / anchors, 3)
                                  if anchors else 0.0),
        }
    return out


def replay_baseline(frames: int = 240, configs: Optional[List[str]] = None,
                    policies=POLICIES) -> dict:
    """Every config x policy scored over the same canonical input log:
    the table (``spec_baseline.json`` in the JAX package's layout) a
    learned ranking policy must beat."""
    all_cfgs = _replay_configs()
    names = configs or list(all_cfgs)
    table = {
        "generated_by": "python -m bevy_ggrs_tpu_torch.obs.ledger replay",
        "frames_per_config": int(frames),
        "policies": list(policies),
        "configs": {},
    }
    for name in names:
        cfg = all_cfgs[name]
        table["configs"][name] = {
            "players": cfg["players"],
            "branches": cfg["branches"],
            "spec_frames": cfg["spec_frames"],
            "policies": replay_config(name, cfg, frames, policies),
        }
    return table


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m bevy_ggrs_tpu_torch.obs.ledger",
                                 description="Speculation-ledger offline tools.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("replay", help="score branch-ranking policies over the canonical "
                                       "input log and write the baseline table")
    rp.add_argument("--frames", type=int, default=240,
                    help="anchors scored per config (default 240)")
    rp.add_argument("--configs", default=None,
                    help="comma-separated config subset (default: all)")
    rp.add_argument("--policies", default=",".join(POLICIES),
                    help="comma-separated policy subset")
    rp.add_argument("--out", default="spec_baseline.json",
                    help="output table path (default spec_baseline.json)")
    args = ap.parse_args(argv)

    if args.cmd == "replay":
        table = replay_baseline(
            frames=args.frames,
            configs=args.configs.split(",") if args.configs else None,
            policies=tuple(args.policies.split(",")),
        )
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
            f.write("\n")
        for name, cfg in table["configs"].items():
            for policy, row in cfg["policies"].items():
                print(f"{name:>20} {policy:>12}: hit_rate={row['full_hit_rate']:.3f} "
                      f"rank_p50={row['hit_rank_p50']:.0f} waste={row['waste_ratio']:.3f}")
        print(f"baseline table -> {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
