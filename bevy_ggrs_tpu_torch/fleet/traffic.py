"""Open-loop traffic: seeded, replayable arrival schedules + a matchmaker.

Counterpart of ``bevy_ggrs_tpu/fleet/traffic.py``: the same plan JSON,
byte for byte, for the same seed and rates.

Every bench before this admitted a fixed batch and ran; nothing measured
*arrival*. This module makes arrival a first-class workload with the same
discipline as :class:`~bevy_ggrs_tpu_torch.chaos.plan.ChaosPlan`:

- a :class:`TrafficPlan` is a seed plus a list of time-stamped events —
  Poisson **match arrivals** (each carrying per-player join delays and an
  input seed), **spectator subscribes**, and **abandons** — JSON-round-
  trippable, byte-identical replay from the same seed, times in seconds
  on whatever clock drives the run (loopback virtual clock in tests);
- **open-loop**: event times are fixed by the plan, never by the
  system's response — the load does not politely slow down when the
  fleet saturates, which is the whole point of a saturation ladder;
- the RNG discipline matches ``ChaosPlan.generate``: the spectator and
  abandon families draw from the main stream FIRST and the arrival
  family draws LAST, so changing the arrival rate (the knob a ladder
  sweeps) leaves every prior family's stream byte-identical for a given
  seed. Per-match attributes (join delays, input seed) come from a
  per-match derived RNG and never touch the main stream at all.

:class:`Matchmaker` routes due arrivals through
:meth:`~bevy_ggrs_tpu_torch.fleet.balancer.FleetBalancer.place_match` onto
fleet placements, holding each arrival until the last player's join
delay has elapsed, then starting an :class:`~bevy_ggrs_tpu_torch.serve.
admission.AdmissionTrace` and carrying it through matchmake (session/
input assembly) -> place -> slot-warm -> admit -> first-frame-served.
The join-delay wait itself is plan-scheduled (open-loop) and is NOT
billed to admission latency — it surfaces as a ``matchmake_wait``
tracer instant instead. Abandons retire live matches
(or cancel still-matchmaking arrivals); spectator subscribes resolve
their target fraction against the live match set and count against it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from bevy_ggrs_tpu_torch.serve.admission import AdmissionTrace


@dataclasses.dataclass(frozen=True)
class MatchArrival:
    """One match wants a slot at ``at``. ``join_delays`` (seconds, one
    per player) stagger the players' arrivals — matchmaking completes at
    ``at + max(join_delays)``. ``input_seed`` seeds the match's input
    stream so a replayed plan replays the same gameplay."""

    at: float
    match_id: int
    num_players: int
    input_seed: int
    join_delays: Tuple[float, ...] = ()

    @property
    def ready_at(self) -> float:
        return self.at + (max(self.join_delays) if self.join_delays else 0.0)


@dataclasses.dataclass(frozen=True)
class SpectatorSubscribe:
    """A spectator subscribes at ``at`` to the live match selected by
    ``target_frac`` (a [0,1) fraction resolved against the sorted live
    match ids at apply time — independent of the arrival schedule, so
    the spectator stream is byte-stable across arrival-rate sweeps)."""

    at: float
    target_frac: float


@dataclasses.dataclass(frozen=True)
class MatchAbandon:
    """The live match selected by ``target_frac`` (same resolution rule
    as :class:`SpectatorSubscribe`) is abandoned at ``at`` — retired if
    admitted, cancelled if still matchmaking."""

    at: float
    target_frac: float


TrafficEvent = Union[MatchArrival, SpectatorSubscribe, MatchAbandon]

_KINDS = {
    "arrival": MatchArrival,
    "spectate": SpectatorSubscribe,
    "abandon": MatchAbandon,
}
_NAMES = {cls: name for name, cls in _KINDS.items()}


def _match_rng(seed: int, match_id: int) -> np.random.RandomState:
    """Per-match derived stream: never touches the plan's main RNG, so
    per-match draws cannot perturb any family's schedule."""
    return np.random.RandomState((seed * 1000003 + match_id) & 0x7FFFFFFF)


def _poisson_times(
    rng: np.random.RandomState, rate: float, duration: float
) -> List[float]:
    """Arrival instants of a Poisson process at ``rate``/s over
    ``duration`` seconds (exponential inter-arrivals, cumulative)."""
    if rate <= 0.0:
        return []
    times: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            return times
        times.append(t)


@dataclasses.dataclass(frozen=True)
class TrafficPlan:
    seed: int
    events: Tuple[TrafficEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # -- queries ---------------------------------------------------------

    def arrivals(self) -> List[MatchArrival]:
        return sorted(
            (e for e in self.events if isinstance(e, MatchArrival)),
            key=lambda e: e.at,
        )

    def spectates(self) -> List[SpectatorSubscribe]:
        return sorted(
            (e for e in self.events if isinstance(e, SpectatorSubscribe)),
            key=lambda e: e.at,
        )

    def abandons(self) -> List[MatchAbandon]:
        return sorted(
            (e for e in self.events if isinstance(e, MatchAbandon)),
            key=lambda e: e.at,
        )

    def horizon(self) -> float:
        t = 0.0
        for e in self.events:
            t = max(t, e.ready_at if isinstance(e, MatchArrival) else e.at)
        return t

    # -- (de)serialization: the replay artifact --------------------------

    def to_json(self) -> str:
        out = []
        for e in self.events:
            entry = {"kind": _NAMES[type(e)]}
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                entry[f.name] = list(v) if isinstance(v, tuple) else v
            out.append(entry)
        return json.dumps({"seed": self.seed, "events": out}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrafficPlan":
        raw = json.loads(text)
        events = []
        for entry in raw["events"]:
            entry = dict(entry)
            kind = _KINDS[entry.pop("kind")]
            if "join_delays" in entry:
                entry["join_delays"] = tuple(entry["join_delays"])
            events.append(kind(**entry))
        return cls(int(raw["seed"]), tuple(events))

    # -- generation ------------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        duration: float,
        match_rate: float,
        spectate_rate: float = 0.0,
        abandon_rate: float = 0.0,
        num_players: int = 2,
        max_join_delay: float = 0.25,
        first_match_id: int = 0,
    ) -> "TrafficPlan":
        """A deterministic open-loop schedule over ``duration`` seconds.
        Same ``(seed, duration, rates, ...)`` -> same plan, always.

        RNG-stream discipline (the replayability contract a ladder
        sweep depends on): the **spectate** and **abandon** families
        draw from the main stream first; the **arrival** family — the
        one whose rate a saturation ladder sweeps — draws LAST, so
        changing ``match_rate`` leaves the spectate/abandon schedules a
        seed produces byte-identical. Per-match join delays and input
        seeds come from per-match derived RNGs (never the main stream),
        so per-match shape changes can't perturb any schedule either."""
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        span = max(float(duration), 1e-9)
        events: List[TrafficEvent] = []
        for t in _poisson_times(rng, float(spectate_rate), span):
            events.append(SpectatorSubscribe(t, float(rng.uniform())))
        for t in _poisson_times(rng, float(abandon_rate), span):
            events.append(MatchAbandon(t, float(rng.uniform())))
        # Arrivals draw LAST (see docstring); per-arrival attributes come
        # from the derived per-match stream.
        for i, t in enumerate(_poisson_times(rng, float(match_rate), span)):
            mid = int(first_match_id) + i
            mr = _match_rng(seed, mid)
            delays = tuple(
                float(mr.uniform(0.0, max_join_delay))
                for _ in range(int(num_players))
            )
            events.append(
                MatchArrival(
                    at=t,
                    match_id=mid,
                    num_players=int(num_players),
                    input_seed=int(mr.randint(0, 2 ** 31)),
                    join_delays=delays,
                )
            )
        return cls(seed, tuple(events))


class Matchmaker:
    """Applies a :class:`TrafficPlan` against a fleet: due arrivals
    matchmake (waiting out their join delays), place through the
    balancer's policy (paging servers refused), and admit — each
    carrying an :class:`AdmissionTrace` end to end. Abandons retire or
    cancel; spectator subscribes resolve and count.

    The callbacks build the match's concrete pieces from an arrival:

    - ``make_session(arrival) -> session`` (required)
    - ``make_inputs(arrival) -> local_inputs callback`` (optional)
    - ``make_state(arrival) -> initial_state | zero-arg callable``
      (optional; a callable rides the admit queue's lazy slot-warm hook)
    """

    def __init__(
        self,
        balancer,
        plan: TrafficPlan,
        make_session: Callable[[MatchArrival], object],
        make_inputs: Optional[Callable[[MatchArrival], object]] = None,
        make_state: Optional[Callable[[MatchArrival], object]] = None,
        spec_on: bool = True,
        queue_admissions: bool = True,
        clock=None,
        metrics=None,
        tracer=None,
    ):
        import time as _time

        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.balancer = balancer
        self.plan = plan
        self.make_session = make_session
        self.make_inputs = make_inputs
        self.make_state = make_state
        self.spec_on = bool(spec_on)
        self.queue_admissions = bool(queue_admissions)
        self._clock = clock if clock is not None else _time.monotonic
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self._pending = sorted(plan.events, key=lambda e: (e.at, _order(e)))
        self._matchmaking: List[MatchArrival] = []
        self.live: Dict[int, int] = {}  # match_id -> server_id
        self.traces: Dict[int, AdmissionTrace] = {}
        self.spectators: Dict[int, int] = {}
        self.arrivals_seen = 0
        self.admissions_started = 0
        self.admissions_rejected = 0
        self.abandons_applied = 0
        self.abandons_cancelled = 0
        self.spectates_applied = 0
        self.spectates_unresolved = 0

    # -- event application ----------------------------------------------

    def _resolve(self, frac: float) -> Optional[int]:
        """[0,1) fraction -> live match id (sorted order) — stable under
        any arrival schedule, which keeps the spectate/abandon streams
        meaningful across ladder steps."""
        if not self.live:
            return None
        ids = sorted(self.live)
        return ids[min(len(ids) - 1, int(frac * len(ids)))]

    def _admit(self, arrival: MatchArrival, trace: AdmissionTrace) -> None:
        # Session/input construction is matchmake work by the stage
        # contract ("resolved the arrival into a session + inputs").
        t0 = self._clock()
        session = self.make_session(arrival)
        inputs = (
            self.make_inputs(arrival)
            if self.make_inputs is not None else None
        )
        state = (
            self.make_state(arrival) if self.make_state is not None else None
        )
        trace.record("matchmake", (self._clock() - t0) * 1000.0)
        try:
            server_id, _handle = self.balancer.place_match(
                arrival.match_id,
                session,
                inputs,
                initial_state=state,
                spec_on=self.spec_on,
                trace=trace,
                queue=self.queue_admissions,
            )
        except RuntimeError:
            # Fleet full: open-loop load does not retry — the drop IS
            # the saturation signal the ladder reads.
            self.admissions_rejected += 1
            self.metrics.count("traffic_admissions_rejected")
            trace.finish()
            return
        self.live[arrival.match_id] = server_id
        self.admissions_started += 1
        self.metrics.count("traffic_admissions_started")

    def _abandon(self, mid: int) -> None:
        server_id = self.live.pop(mid)
        pl = self.balancer.placements.pop(mid, None)
        if pl is not None:
            self.balancer.members[server_id].server.retire_match(pl.handle)
        self.spectators.pop(mid, None)
        self.abandons_applied += 1
        self.metrics.count("traffic_abandons")
        self.tracer.instant("traffic_abandon", match=mid, server=server_id)

    def pump(self, now: float) -> Dict[str, int]:
        """Apply every event due at ``now`` (and finish any matchmaking
        arrival whose last player has joined). Returns this call's event
        counts. Call once per served frame, like the balancer's pump."""
        applied = {"arrivals": 0, "admissions": 0, "spectates": 0,
                   "abandons": 0}
        while self._pending and self._pending[0].at <= now:
            e = self._pending.pop(0)
            if isinstance(e, MatchArrival):
                self.arrivals_seen += 1
                applied["arrivals"] += 1
                # No trace yet: the join-delay window is the PLAN's wait
                # (open-loop, outside the system's control), so it must
                # not be billed as admission latency. The AdmissionTrace
                # starts when the last player joins (below) — its
                # matchmake stage then measures real matchmaker work
                # (session/input assembly in _admit), not the wait.
                self._matchmaking.append(e)
                self.metrics.count("traffic_arrivals")
            elif isinstance(e, MatchAbandon):
                mid = self._resolve(e.target_frac)
                if mid is not None:
                    self._abandon(mid)
                    applied["abandons"] += 1
                else:
                    # No live match yet: cancel the oldest matchmaking
                    # arrival instead (a party dissolving pre-admission).
                    if self._matchmaking:
                        self._matchmaking.pop(0)
                        self.abandons_cancelled += 1
                        self.metrics.count("traffic_abandons_cancelled")
            elif isinstance(e, SpectatorSubscribe):
                mid = self._resolve(e.target_frac)
                if mid is None:
                    self.spectates_unresolved += 1
                    self.metrics.count("traffic_spectates_unresolved")
                else:
                    self.spectators[mid] = self.spectators.get(mid, 0) + 1
                    self.spectates_applied += 1
                    applied["spectates"] += 1
                    self.metrics.count("traffic_spectates")
                    self.tracer.instant("traffic_spectate", match=mid)
        # Matchmaking completes when the slowest join delay has elapsed.
        # The trace is born HERE: admission_ms measures the system's
        # pipeline (matchmake work -> place -> slot_warm -> admit ->
        # first_frame), never the plan-scheduled join wait. The wait
        # stays visible as a tracer instant for timeline forensics.
        still: List[MatchArrival] = []
        for arrival in self._matchmaking:
            if arrival.ready_at <= now:
                trace = AdmissionTrace(
                    arrival.match_id, clock=self._clock, tracer=self.tracer
                )
                self.traces[arrival.match_id] = trace
                self.tracer.instant(
                    "matchmake_wait",
                    match=arrival.match_id,
                    plan_wait_ms=round(
                        (arrival.ready_at - arrival.at) * 1000.0, 4
                    ),
                    flow=trace.key,
                )
                self._admit(arrival, trace)
                applied["admissions"] += 1
            else:
                still.append(arrival)
        self._matchmaking = still
        return applied

    @property
    def drained(self) -> bool:
        """Every plan event applied and no arrival stuck in matchmaking."""
        return not self._pending and not self._matchmaking


def _order(e: TrafficEvent) -> int:
    # Same-instant determinism: arrivals before abandons before spectates.
    return (
        0 if isinstance(e, MatchArrival)
        else 1 if isinstance(e, MatchAbandon)
        else 2
    )
