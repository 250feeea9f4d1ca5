"""FleetAutopilot: the policy loop that makes the fleet elastic.

Counterpart of ``bevy_ggrs_tpu/fleet/autopilot.py``: the same decisions
and the same ledger bytes for the same observations.

The :class:`~bevy_ggrs_tpu_torch.fleet.balancer.FleetBalancer` can move a
match between servers and survive a server loss — but every one of those
acts is *scripted* by a ChaosPlan. This module closes the control loop
(ROADMAP "make the fleet autonomous"; Podracer/Sebulba in PAPERS.md is
the blueprint: workers are disposable, one control plane owns placement,
packing, and scale). The autopilot consumes exactly two signal streams —
the type-22 :class:`~bevy_ggrs_tpu_torch.session.protocol.FleetHeartbeat`
beacons (SLO pages, occupancy, speculation hit/waste permille) and the
front door's window-SLO level — and *initiates*:

- **Burn preemption.** A server whose heartbeat reports SLO pages for
  ``preempt_confirm`` consecutive observations gets matches migrated off
  it to the calmest candidate. SLO burn pages long before the per-slot
  watchdog accumulates ``strike_limit`` CONSECUTIVE misses, so a
  preemption that lands while the source's fence count is still zero
  moved the match *before* the watchdog ever fired — the soak asserts
  exactly that.
- **Anti-affinity.** Every fleet-managed match is booked a *backup*
  server (deterministically: the lowest-id live server that is not its
  host) — the server its failover prefers. No placement or migration may
  co-locate a match with its backup: losing that one server must never
  take both the match and its recovery target. When the only admittable
  destination IS the backup, the move is refused with a typed reason
  rather than silently violating the rule.
- **Autoscale.** Fleet occupancy (active slots over non-draining
  capacity) above ``high_watermark`` for ``confirm_beats`` observations
  spawns a fresh server; below ``low_watermark`` (with more than
  ``min_servers`` members) picks the emptiest member and
  **drain-pack-retires** it: mark draining (no new placements), migrate
  its matches off through the existing type 18-21 live-migration wire
  (packing is "free" correctness-wise — migration is bitwise and
  zero-compile), retire only when empty. The watermark gap, the confirm
  streaks, and per-action cooldowns are the hysteresis — no flapping.

Every decision is a typed, reasoned :class:`AutopilotAction`. The policy
is a pure deterministic function of its observation sequence: no clock,
no RNG, sorted iteration everywhere. :class:`FleetAutopilot` records
every (observation, decisions) pair into a JSONL ledger, and
:func:`replay_ledger` re-derives the decisions offline from the recorded
heartbeats — ``python -m bevy_ggrs_tpu_torch.fleet.autopilot <ledger.jsonl>``
is the policy-simulation harness (and determinism check) for any soak's
recorded trace.

The autopilot acts through a *fleet adapter* — anything with
``samples() / placements() / pump_migrations() / migrate() / spawn() /
set_draining() / retire()``. :class:`BalancerFleet` adapts the
in-process :class:`FleetBalancer`; :class:`~bevy_ggrs_tpu_torch.fleet.proc.
ProcFleet` implements the same protocol over supervised subprocess
MatchServers on real UDP sockets.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "AutopilotAction",
    "AutopilotConfig",
    "AutopilotPolicy",
    "BalancerFleet",
    "FleetAutopilot",
    "FleetObservation",
    "RelayAutopilot",
    "RelayAutopilotConfig",
    "RelayObservation",
    "RelayPolicy",
    "RelaySample",
    "ServerSample",
    "heartbeat_score",
    "observation_from_json",
    "observation_to_json",
    "relay_observation_from_json",
    "relay_observation_to_json",
    "replay_ledger",
    "replay_relay_ledger",
    "verify_ledger",
    "verify_relay_ledger",
]


def heartbeat_score(
    hb,
    spec_hit_weight: float = 0.25,
    spec_waste_weight: float = 0.5,
) -> float:
    """The fleet's one load/burn number; lower is better. Works on any
    heartbeat-shaped object (:class:`~bevy_ggrs_tpu_torch.session.protocol.
    FleetHeartbeat` or :class:`ServerSample`). SLO pages dominate,
    quarantined/recovering slots next, occupancy breaks ties; the
    speculation economics ride below occupancy's unit scale — between
    two equally-loaded calm servers, the one wasting more speculative
    device time (or hitting less) loses."""
    total = max(1, hb.slots_active + hb.slots_free)
    return (
        100.0 * hb.pages
        + 25.0 * hb.quarantined
        + hb.slots_active / total
        + spec_waste_weight * hb.spec_waste_permille / 1000.0
        - spec_hit_weight * hb.spec_hit_permille / 1000.0
    )


@dataclasses.dataclass(frozen=True)
class ServerSample:
    """One server's state as the policy sees it: its freshest type-22
    heartbeat fields plus the control-plane flags the balancer owns."""

    server_id: int
    slots_active: int
    slots_free: int
    pages: int = 0
    quarantined: int = 0
    spec_hit_permille: int = 0
    spec_waste_permille: int = 0
    draining: bool = False
    alive: bool = True
    # Partition awareness: how many heartbeat periods have elapsed since
    # this server's last (monotonically newer) beat, and whether the
    # control plane can still reach it by a non-heartbeat path (process
    # probe / stdin pipe). ``missed_beats > 0`` with ``reachable=True``
    # is the network-suspect signature.
    missed_beats: int = 0
    reachable: bool = True

    @classmethod
    def from_heartbeat(
        cls,
        hb,
        draining: bool = False,
        missed_beats: int = 0,
        reachable: bool = True,
    ) -> "ServerSample":
        return cls(
            server_id=int(hb.server_id),
            slots_active=int(hb.slots_active),
            slots_free=int(hb.slots_free),
            pages=int(hb.pages),
            quarantined=int(hb.quarantined),
            spec_hit_permille=int(hb.spec_hit_permille),
            spec_waste_permille=int(hb.spec_waste_permille),
            draining=bool(draining),
            missed_beats=int(missed_beats),
            reachable=bool(reachable),
        )


@dataclasses.dataclass(frozen=True)
class FleetObservation:
    """One policy input: everything the autopilot knows at one tick.
    ``servers`` holds live members only (a dead server is not observed —
    failover is the balancer's reflex, not a policy decision);
    ``front_door`` is the admission window-SLO level (``ok``/``warn``/
    ``page``) — a paging front door collapses the scale-up confirm
    streak to one beat."""

    tick: int
    servers: Dict[int, ServerSample]
    placements: Dict[int, int]
    backups: Dict[int, int]
    front_door: str = "ok"


@dataclasses.dataclass(frozen=True)
class AutopilotAction:
    """One typed, reasoned decision. ``kind`` is one of
    ``scale_up | scale_down | preempt_migrate | pack_migrate | retire |
    refuse | partition_suspected | degraded_enter | degraded_exit``;
    ``reason`` is the human-readable justification every decision must
    carry (the ledger is an audit log, not a counter)."""

    kind: str
    tick: int
    reason: str
    server_id: Optional[int] = None
    match_id: Optional[int] = None
    dst_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Policy constants. The high/low watermark gap plus the confirm
    streaks plus the per-action cooldowns are the no-flap guarantee:
    a boundary-hugging occupancy cannot alternate scale directions
    faster than ``cooldown_scale_ticks``."""

    high_watermark: float = 0.80
    low_watermark: float = 0.35
    confirm_beats: int = 3
    preempt_pages: int = 1      # heartbeat pages >= this marks "burning"
    preempt_confirm: int = 2    # consecutive burning observations
    preempt_batch: int = 1      # matches moved per preemption decision
    pack_batch: int = 2         # matches packed off a draining server/tick
    cooldown_scale_ticks: int = 120
    cooldown_preempt_ticks: int = 30
    min_servers: int = 2
    max_servers: int = 8
    spec_hit_weight: float = 0.25
    spec_waste_weight: float = 0.5
    # Missed beats (while the control-plane probe still answers) that
    # mark a server network-suspect and put the policy in degraded mode.
    suspect_beats: int = 2


class AutopilotPolicy:
    """Pure decision core: ``decide(observation) -> [AutopilotAction]``.

    Deterministic by construction — internal state is only streak
    counters and cooldown stamps derived from the observation sequence,
    so the same trace of observations always yields the same actions
    (what :func:`replay_ledger` proves offline). Decision order within a
    tick is fixed: burn preemption (health first), scale-up (capacity),
    drain-pack progress (pack before retire, retire only when empty),
    scale-down initiation."""

    def __init__(self, config: Optional[AutopilotConfig] = None):
        self.config = config or AutopilotConfig()
        self._high_streak = 0
        self._low_streak = 0
        self._page_streak: Dict[int, int] = {}
        self._last_scale_tick: Optional[int] = None
        self._last_preempt: Dict[int, int] = {}
        # Refusals are emitted once per continuous blocking episode, not
        # once per tick — the ledger stays an audit log, not a firehose.
        self._refused: set = set()
        # Partition awareness: currently-suspect server ids and whether
        # the policy is in degraded mode (shrink-side actions frozen).
        self._suspected: set = set()
        self._degraded = False
        self.degraded_beats = 0

    # -- helpers ---------------------------------------------------------

    def _score(self, s: ServerSample) -> float:
        return heartbeat_score(
            s, self.config.spec_hit_weight, self.config.spec_waste_weight
        )

    def _is_suspect(self, s: ServerSample) -> bool:
        """Network-suspect: beats missing but the control-plane probe
        still answers. (An unreachable server is *dead* — the fleet's
        failover reflex, not a policy state.)"""
        return s.reachable and s.missed_beats >= self.config.suspect_beats

    def _refuse_once(
        self, acts: List[AutopilotAction], key, action: AutopilotAction
    ) -> None:
        if key in self._refused:
            return
        self._refused.add(key)
        acts.append(action)

    def _pick_dst(
        self, obs: FleetObservation, src_id: int, match_id: int
    ) -> Tuple[Optional[int], Optional[str]]:
        """Calmest admittable destination for ``match_id``, honoring
        anti-affinity. Returns (dst, None) or (None, refusal-reason)."""
        servers = obs.servers
        candidates = [
            sid
            for sid, s in sorted(servers.items())
            if sid != src_id and not s.draining and s.slots_free > 0
            and not self._is_suspect(s)
        ]
        backup = obs.backups.get(match_id)
        allowed = [sid for sid in candidates if sid != backup]
        if not allowed:
            if backup in candidates:
                return None, (
                    f"anti_affinity: match {match_id}'s only admittable "
                    f"destination is its backup server {backup}"
                )
            return None, None  # nowhere to go; not a policy violation
        return min(allowed, key=lambda d: (self._score(servers[d]), d)), None

    # -- the decision function -------------------------------------------

    def decide(self, obs: FleetObservation) -> List[AutopilotAction]:
        cfg = self.config
        acts: List[AutopilotAction] = []
        servers = obs.servers
        live = sorted(sid for sid, s in servers.items() if s.alive)
        pool = [sid for sid in live if not servers[sid].draining]
        total_active = sum(servers[sid].slots_active for sid in pool)
        total_slots = sum(
            servers[sid].slots_active + servers[sid].slots_free
            for sid in pool
        )
        occupancy = total_active / total_slots if total_slots else 1.0

        # 0) Partition awareness. A suspect server (missed beats, probe
        #    still answering) means the absence of signal is a NETWORK
        #    fact, not a server fact — so the policy stops acting on
        #    absence: scale-down and drain-packing freeze until every
        #    suspicion clears. Scale-up and burn preemption stay live
        #    (adding capacity and moving load off a *paging* server are
        #    safe under partition; both act on signals that arrived).
        suspects = sorted(
            sid for sid, s in servers.items() if self._is_suspect(s)
        )
        for sid in suspects:
            if sid not in self._suspected:
                acts.append(AutopilotAction(
                    "partition_suspected", obs.tick,
                    f"server {sid} missed "
                    f"{servers[sid].missed_beats} beat(s) but its "
                    "control-plane probe still answers: network suspect, "
                    "not dead",
                    server_id=sid,
                ))
        self._suspected = set(suspects)
        if suspects and not self._degraded:
            self._degraded = True
            acts.append(AutopilotAction(
                "degraded_enter", obs.tick,
                f"suspect server(s) {suspects}: freezing scale-down and "
                "drain-packing until the partition clears",
            ))
        elif not suspects and self._degraded:
            self._degraded = False
            acts.append(AutopilotAction(
                "degraded_exit", obs.tick,
                "no suspect servers remain; resuming normal elasticity",
            ))
        degraded = self._degraded
        if degraded:
            self.degraded_beats += 1

        # 1) Burn preemption — health outranks capacity.
        for sid in live:
            if servers[sid].pages >= cfg.preempt_pages:
                self._page_streak[sid] = self._page_streak.get(sid, 0) + 1
            else:
                self._page_streak[sid] = 0
                self._refused.discard(("preempt", sid))
        for sid in pool:
            streak = self._page_streak.get(sid, 0)
            if streak < cfg.preempt_confirm:
                continue
            last = self._last_preempt.get(sid)
            if (
                last is not None
                and obs.tick - last < cfg.cooldown_preempt_ticks
            ):
                self._refuse_once(
                    acts,
                    ("preempt", sid),
                    AutopilotAction(
                        "refuse", obs.tick,
                        f"cooldown: server {sid} still burning "
                        f"(pages x{streak} beats) but last preemption was "
                        f"{obs.tick - last} ticks ago "
                        f"(< {cfg.cooldown_preempt_ticks})",
                        server_id=sid,
                    ),
                )
                continue
            moved = 0
            for m in sorted(
                m for m, host in obs.placements.items() if host == sid
            ):
                if moved >= cfg.preempt_batch:
                    break
                dst, refusal = self._pick_dst(obs, sid, m)
                if dst is None:
                    if refusal:
                        self._refuse_once(
                            acts,
                            ("aa", m),
                            AutopilotAction(
                                "refuse", obs.tick, refusal,
                                server_id=sid, match_id=m,
                            ),
                        )
                    continue
                self._refused.discard(("aa", m))
                acts.append(AutopilotAction(
                    "preempt_migrate", obs.tick,
                    f"server {sid} paging (pages={servers[sid].pages}) for "
                    f"{streak} beats; evacuating match {m} to server {dst} "
                    "before the watchdog fences",
                    server_id=sid, match_id=m, dst_id=dst,
                ))
                moved += 1
            if moved:
                self._last_preempt[sid] = obs.tick
                self._refused.discard(("preempt", sid))

        # 2) Scale-up — a paging front door needs only one confirming beat.
        confirm = 1 if obs.front_door == "page" else cfg.confirm_beats
        if occupancy >= cfg.high_watermark and len(pool) < cfg.max_servers:
            self._high_streak += 1
        else:
            self._high_streak = 0
            self._refused.discard(("scale", "up"))
        in_scale_cooldown = (
            self._last_scale_tick is not None
            and obs.tick - self._last_scale_tick < cfg.cooldown_scale_ticks
        )
        if self._high_streak >= confirm:
            if in_scale_cooldown:
                self._refuse_once(
                    acts,
                    ("scale", "up"),
                    AutopilotAction(
                        "refuse", obs.tick,
                        f"cooldown: occupancy {occupancy:.2f} >= "
                        f"{cfg.high_watermark} but last scale action was "
                        f"{obs.tick - self._last_scale_tick} ticks ago "
                        f"(< {cfg.cooldown_scale_ticks})",
                    ),
                )
            else:
                acts.append(AutopilotAction(
                    "scale_up", obs.tick,
                    f"fleet occupancy {occupancy:.2f} >= high watermark "
                    f"{cfg.high_watermark} for {self._high_streak} beat(s)"
                    + (
                        " (front door paging: confirm collapsed to 1)"
                        if confirm == 1 else ""
                    ),
                ))
                self._last_scale_tick = obs.tick
                self._high_streak = 0
                self._low_streak = 0
                self._refused.discard(("scale", "up"))

        # 3) Drain-pack progress: pack strictly before retire; retire only
        #    once the draining server hosts nothing. Frozen while
        #    degraded — packing trusts occupancy arithmetic that a
        #    partition has falsified, and a retire issued on stale
        #    knowledge is unrecoverable.
        for sid in sorted(s for s in live if servers[s].draining):
            if degraded:
                break
            victims = sorted(
                m for m, host in obs.placements.items() if host == sid
            )
            if not victims:
                acts.append(AutopilotAction(
                    "retire", obs.tick,
                    f"server {sid} drained empty; retiring",
                    server_id=sid,
                ))
                continue
            moved = 0
            for m in victims:
                if moved >= cfg.pack_batch:
                    break
                dst, refusal = self._pick_dst(obs, sid, m)
                if dst is None:
                    if refusal:
                        self._refuse_once(
                            acts,
                            ("aa", m),
                            AutopilotAction(
                                "refuse", obs.tick, refusal,
                                server_id=sid, match_id=m,
                            ),
                        )
                    continue
                self._refused.discard(("aa", m))
                acts.append(AutopilotAction(
                    "pack_migrate", obs.tick,
                    f"packing match {m} off draining server {sid} "
                    f"to server {dst}",
                    server_id=sid, match_id=m, dst_id=dst,
                ))
                moved += 1

        # 4) Scale-down initiation — never while another drain is open.
        draining_open = any(servers[s].draining for s in live)
        if (
            occupancy <= cfg.low_watermark
            and len(pool) > cfg.min_servers
            and not draining_open
            and not degraded
        ):
            self._low_streak += 1
        else:
            self._low_streak = 0
            self._refused.discard(("scale", "down"))
        if self._low_streak >= cfg.confirm_beats:
            if in_scale_cooldown:
                self._refuse_once(
                    acts,
                    ("scale", "down"),
                    AutopilotAction(
                        "refuse", obs.tick,
                        f"cooldown: occupancy {occupancy:.2f} <= "
                        f"{cfg.low_watermark} but last scale action was "
                        f"{obs.tick - self._last_scale_tick} ticks ago "
                        f"(< {cfg.cooldown_scale_ticks})",
                    ),
                )
            else:
                # Emptiest member leaves; ties retire the newest id.
                victim = min(
                    pool,
                    key=lambda s: (servers[s].slots_active, -s),
                )
                acts.append(AutopilotAction(
                    "scale_down", obs.tick,
                    f"fleet occupancy {occupancy:.2f} <= low watermark "
                    f"{cfg.low_watermark} for {self._low_streak} beats; "
                    f"drain-pack-retiring emptiest server {victim} "
                    f"({servers[victim].slots_active} active)",
                    server_id=victim,
                ))
                self._last_scale_tick = obs.tick
                self._low_streak = 0
                self._high_streak = 0
                self._refused.discard(("scale", "down"))
        return acts


# ---------------------------------------------------------------------------
# Ledger (de)serialization + the offline policy-simulation harness
# ---------------------------------------------------------------------------


def observation_to_json(obs: FleetObservation) -> dict:
    return {
        "tick": obs.tick,
        "servers": {
            str(sid): dataclasses.asdict(s)
            for sid, s in sorted(obs.servers.items())
        },
        "placements": {
            str(m): sid for m, sid in sorted(obs.placements.items())
        },
        "backups": {
            str(m): sid for m, sid in sorted(obs.backups.items())
        },
        "front_door": obs.front_door,
    }


def observation_from_json(raw: dict) -> FleetObservation:
    return FleetObservation(
        tick=int(raw["tick"]),
        servers={
            int(sid): ServerSample(**s)
            for sid, s in raw["servers"].items()
        },
        placements={int(m): int(s) for m, s in raw["placements"].items()},
        backups={int(m): int(s) for m, s in raw["backups"].items()},
        front_door=raw.get("front_door", "ok"),
    )


def _action_to_json(a: AutopilotAction) -> dict:
    return {k: v for k, v in dataclasses.asdict(a).items() if v is not None}


def _load_ledger(records) -> List[dict]:
    if isinstance(records, str):
        with open(records) as f:
            return [json.loads(line) for line in f if line.strip()]
    return list(records)


def _split_header(
    recs: List[dict], config: Optional[AutopilotConfig]
) -> Tuple[Optional[AutopilotConfig], List[dict]]:
    """An exported ledger's first line is a config header — the policy
    constants the decisions were made under travel WITH the trace, so
    the offline harness replays under the same hysteresis. An explicit
    ``config`` argument still wins."""
    if recs and "config" in recs[0] and "observation" not in recs[0]:
        if config is None:
            config = AutopilotConfig(**recs[0]["config"])
        recs = recs[1:]
    return config, recs


def replay_ledger(
    records, config: Optional[AutopilotConfig] = None
) -> List[List[AutopilotAction]]:
    """Feed a recorded heartbeat trace (a ledger path or its parsed
    records) through a FRESH policy: the offline policy simulator. The
    returned per-tick action lists are what the policy decides given
    only the recorded observations."""
    config, recs = _split_header(_load_ledger(records), config)
    policy = AutopilotPolicy(config)
    return [
        policy.decide(observation_from_json(rec["observation"]))
        for rec in recs
    ]


def verify_ledger(
    records, config: Optional[AutopilotConfig] = None
) -> Tuple[bool, int]:
    """Determinism check: replay the recorded observations and compare
    against the recorded decisions. Returns (identical, ticks_checked)."""
    config, recs = _split_header(_load_ledger(records), config)
    replayed = replay_ledger(recs, config)
    for rec, acts in zip(recs, replayed):
        if [_action_to_json(a) for a in acts] != rec["actions"]:
            return False, len(recs)
    return True, len(recs)


# ---------------------------------------------------------------------------
# Actuators
# ---------------------------------------------------------------------------


class BalancerFleet:
    """Fleet adapter over an in-process :class:`FleetBalancer`:
    the autopilot's actuator for loopback soaks and benches. Owns the
    in-flight :class:`~bevy_ggrs_tpu_torch.fleet.balancer.Migration` set (a
    match mid-flight is hidden from ``placements()`` so the policy never
    double-moves it) and the spawner that builds + registers a fresh
    server on scale-up."""

    def __init__(
        self,
        balancer,
        spawner: Optional[Callable[[int], object]] = None,
        on_retire: Optional[Callable[[object], None]] = None,
    ):
        self.balancer = balancer
        self.spawner = spawner
        self.on_retire = on_retire
        self.inflight: List[object] = []
        self.events: List[dict] = []
        self.stall_frames: List[int] = []

    def samples(self) -> Dict[int, ServerSample]:
        out: Dict[int, ServerSample] = {}
        for sid, m in sorted(self.balancer.members.items()):
            if not m.alive or m.server is None:
                continue
            hb = m.info if m.info is not None else m.server.heartbeat()
            out[sid] = ServerSample.from_heartbeat(
                hb, draining=getattr(m, "draining", False),
                missed_beats=getattr(m, "missed_beats", 0),
                # In-process members have no separate probe path; alive
                # membership IS the control-plane reachability signal.
                reachable=bool(m.alive),
            )
        return out

    def placements(self) -> Dict[int, int]:
        moving = {mig.match_id for mig in self.inflight}
        return {
            mid: pl.server_id
            for mid, pl in self.balancer.placements.items()
            if mid not in moving
        }

    def pump_migrations(self) -> None:
        still = []
        for mig in self.inflight:
            self.balancer.complete_migration(mig)
            if not mig.resolved:
                still.append(mig)
                continue
            self.events.append({
                "event": "migrate_abort" if mig.aborted else "migrated",
                "match": mig.match_id,
                "src": mig.src_id,
                "dst": mig.dst_id,
                "stall_frames": mig.stall_frames,
            })
            if not mig.aborted and mig.stall_frames is not None:
                self.stall_frames.append(int(mig.stall_frames))
        self.inflight = still

    def migrate(self, match_id: int, dst_id: int) -> bool:
        if any(mig.match_id == match_id for mig in self.inflight):
            return False
        try:
            mig = self.balancer.begin_migration(match_id, dst_id)
        except (KeyError, ValueError, RuntimeError):
            return False
        self.inflight.append(mig)
        return True

    def spawn(self) -> bool:
        if self.spawner is None:
            return False
        sid = (
            max(self.balancer.members) + 1 if self.balancer.members else 0
        )
        self.spawner(sid)  # must register the member into the balancer
        self.events.append({"event": "spawned", "server": sid})
        return True

    def set_draining(self, server_id: int) -> bool:
        self.balancer.set_draining(server_id)
        self.events.append({"event": "draining", "server": server_id})
        return True

    def retire(self, server_id: int) -> bool:
        if any(mig.src_id == server_id for mig in self.inflight):
            return False  # a pack is still in flight; try next tick
        if any(
            pl.server_id == server_id
            for pl in self.balancer.placements.values()
        ):
            return False
        member = self.balancer.retire_member(server_id)
        if self.on_retire is not None:
            self.on_retire(member)
        self.events.append({"event": "retired", "server": server_id})
        return True


class FleetAutopilot:
    """The closed loop: each :meth:`step` pumps in-flight migrations,
    builds one :class:`FleetObservation` from the adapter (booking
    deterministic anti-affinity backups as matches appear), asks the
    policy, executes the actions, and appends the (observation,
    decisions, execution results) record to the in-memory ledger that
    :meth:`export_jsonl` turns into the offline-replayable artifact."""

    def __init__(
        self,
        fleet,
        config: Optional[AutopilotConfig] = None,
        front_door: Optional[Callable[[], str]] = None,
        metrics=None,
        tracer=None,
    ):
        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.fleet = fleet
        self.config = config or AutopilotConfig()
        self.policy = AutopilotPolicy(self.config)
        self.front_door = front_door if front_door is not None else (
            lambda: "ok"
        )
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.backups: Dict[int, int] = {}
        self.ledger: List[dict] = []
        self.actions: List[AutopilotAction] = []
        self.counts: Dict[str, int] = {}

    @property
    def degraded_beats(self) -> int:
        """Ticks spent in partition-degraded mode (shrink frozen)."""
        return self.policy.degraded_beats

    # -- anti-affinity bookkeeping ---------------------------------------

    def _assign_backups(
        self, samples: Dict[int, ServerSample], placements: Dict[int, int]
    ) -> None:
        eligible = [
            sid for sid, s in sorted(samples.items())
            if s.alive and not s.draining
        ]
        for m in list(self.backups):
            if m not in placements:
                del self.backups[m]
        for m, host in sorted(placements.items()):
            b = self.backups.get(m)
            if b is not None and b != host and b in eligible:
                continue
            cands = [sid for sid in eligible if sid != host]
            if cands:
                self.backups[m] = cands[0]
            else:
                self.backups.pop(m, None)

    # -- the loop --------------------------------------------------------

    def observe(self, tick: int) -> FleetObservation:
        samples = self.fleet.samples()
        placements = dict(self.fleet.placements())
        self._assign_backups(samples, placements)
        return FleetObservation(
            tick=int(tick),
            servers=samples,
            placements=placements,
            backups=dict(self.backups),
            front_door=self.front_door(),
        )

    def _execute(self, a: AutopilotAction) -> bool:
        if a.kind in ("preempt_migrate", "pack_migrate"):
            return bool(self.fleet.migrate(a.match_id, a.dst_id))
        if a.kind == "scale_up":
            return bool(self.fleet.spawn())
        if a.kind == "scale_down":
            return bool(self.fleet.set_draining(a.server_id))
        if a.kind == "retire":
            return bool(self.fleet.retire(a.server_id))
        # refuse / partition_suspected / degraded_enter / degraded_exit:
        # the recorded decision IS the act.
        return True

    def step(self, tick: int) -> List[AutopilotAction]:
        self.fleet.pump_migrations()
        obs = self.observe(tick)
        actions = self.policy.decide(obs)
        executed = []
        for a in actions:
            ok = self._execute(a)
            executed.append(bool(ok))
            self.counts[a.kind] = self.counts.get(a.kind, 0) + 1
            self.metrics.count(f"autopilot_{a.kind}")
            self.tracer.instant(
                f"autopilot_{a.kind}",
                reason=a.reason,
                server=a.server_id,
                match=a.match_id,
                dst=a.dst_id,
                executed=ok,
            )
        self.actions.extend(actions)
        self.ledger.append({
            "tick": int(tick),
            "observation": observation_to_json(obs),
            "actions": [_action_to_json(a) for a in actions],
            "executed": executed,
        })
        return actions

    def export_jsonl(self, path: str) -> int:
        with open(path, "w") as f:
            f.write(json.dumps(
                {"config": dataclasses.asdict(self.config)}
            ) + "\n")
            for rec in self.ledger:
                f.write(json.dumps(rec) + "\n")
        return len(self.ledger)


# ---------------------------------------------------------------------------
# Relay-tier elasticity: the same discipline applied to fan-out capacity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RelaySample:
    """One relay's state as the relay policy sees it. ``parent_id`` is
    None for the root; ``alive=False`` on a sample means the relay's
    PARENT is gone (an orphan needing a re-home) — a fully dead relay is
    simply absent from the observation, like a dead server."""

    relay_id: int
    tier: int
    parent_id: Optional[int]
    subscribers: int
    capacity: int
    alive: bool = True
    draining: bool = False


@dataclasses.dataclass(frozen=True)
class RelayObservation:
    tick: int
    relays: Dict[int, RelaySample]


@dataclasses.dataclass(frozen=True)
class RelayAutopilotConfig:
    """Fan-out watermarks are subscriber fill over serving capacity of
    the elastic (non-root) tier; the gap + confirm streaks + one scale
    cooldown are the same no-flap guarantee the fleet policy carries."""

    high_watermark: float = 0.80
    low_watermark: float = 0.35
    confirm_beats: int = 3
    cooldown_scale_ticks: int = 60
    min_relays: int = 1
    max_relays: int = 8


class RelayPolicy:
    """Pure decision core for relay-tier elasticity:
    ``decide(RelayObservation) -> [AutopilotAction]``, deterministic by
    construction (streaks + cooldown stamps only, sorted iteration).
    Decision order per tick: re-home orphans (topology health first),
    scale-up, retire drained-empty relays, scale-down initiation.
    Relay capacity is deliberately a SEPARATE policy from match-serving
    capacity (the Podracer decoupling): one match's fan-out can scale
    from one relay to a tree and back without the match fleet noticing."""

    def __init__(self, config: Optional[RelayAutopilotConfig] = None):
        self.config = config or RelayAutopilotConfig()
        self._high_streak = 0
        self._low_streak = 0
        self._last_scale_tick: Optional[int] = None
        self._refused: set = set()
        self._rehomed: set = set()

    def _rehome_target(
        self, obs: RelayObservation, orphan: RelaySample
    ) -> Optional[int]:
        """The re-home ladder over observed ids: the closest live,
        non-draining relay strictly above the orphan (highest tier =
        a sibling of the dead parent, then the grandparent's level),
        lowest id within a tier — deterministic across replays."""
        candidates = [
            r for r in obs.relays.values()
            if r.alive and not r.draining
            and r.relay_id != orphan.relay_id
            and r.tier < orphan.tier
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda r: (-r.tier, r.relay_id)).relay_id

    def decide(self, obs: RelayObservation) -> List[AutopilotAction]:
        cfg = self.config
        acts: List[AutopilotAction] = []
        relays = obs.relays
        # The elastic tier: live non-root relays. A sample with
        # alive=False is an orphan (its parent died) — still serving
        # from its buffer, but needing a new upstream.
        orphans = sorted(
            r.relay_id for r in relays.values()
            if not r.alive and r.parent_id is not None
        )
        serving = [
            r for r in relays.values()
            if r.alive and not r.draining and r.parent_id is not None
        ]

        # 0) Re-home orphans before any capacity arithmetic: a subtree
        #    cut off from the root serves stale frames no matter how
        #    well-sized it is. One action per orphan per episode.
        for rid in orphans:
            if rid in self._rehomed:
                continue
            dst = self._rehome_target(obs, relays[rid])
            if dst is None:
                self._refuse_once(acts, ("rehome", rid), AutopilotAction(
                    "refuse", obs.tick,
                    f"relay {rid} lost its parent but no live relay "
                    "above it remains to re-home to",
                    server_id=rid,
                ))
                continue
            self._rehomed.add(rid)
            acts.append(AutopilotAction(
                "relay_rehome", obs.tick,
                f"relay {rid}'s parent died; re-homing its subtree to "
                f"relay {dst} (resume from the client-side cursor, "
                "zero desync)",
                server_id=rid, dst_id=dst,
            ))
        self._rehomed &= set(orphans)
        for rid in list(self._refused):
            if isinstance(rid, tuple) and rid[0] == "rehome" \
                    and rid[1] not in orphans:
                self._refused.discard(rid)

        total_subs = sum(r.subscribers for r in serving)
        total_cap = sum(max(1, r.capacity) for r in serving)
        fill = total_subs / total_cap if total_cap else 1.0
        in_cooldown = (
            self._last_scale_tick is not None
            and obs.tick - self._last_scale_tick < cfg.cooldown_scale_ticks
        )

        # 1) Scale-up: fan-out fill above the high watermark.
        if fill >= cfg.high_watermark and len(serving) < cfg.max_relays:
            self._high_streak += 1
        else:
            self._high_streak = 0
            self._refused.discard(("scale", "up"))
        if self._high_streak >= cfg.confirm_beats:
            if in_cooldown:
                self._refuse_once(acts, ("scale", "up"), AutopilotAction(
                    "refuse", obs.tick,
                    f"cooldown: fan-out fill {fill:.2f} >= "
                    f"{cfg.high_watermark} but last scale action was "
                    f"{obs.tick - self._last_scale_tick} ticks ago "
                    f"(< {cfg.cooldown_scale_ticks})",
                ))
            else:
                acts.append(AutopilotAction(
                    "relay_spawn", obs.tick,
                    f"fan-out fill {fill:.2f} >= high watermark "
                    f"{cfg.high_watermark} for {self._high_streak} beat(s); "
                    "spawning a relay child",
                ))
                self._last_scale_tick = obs.tick
                self._high_streak = 0
                self._low_streak = 0
                self._refused.discard(("scale", "up"))

        # 2) Drain progress: a draining relay that has emptied retires.
        for r in sorted(
            (r for r in relays.values() if r.alive and r.draining),
            key=lambda r: r.relay_id,
        ):
            if r.subscribers == 0:
                acts.append(AutopilotAction(
                    "relay_retire", obs.tick,
                    f"relay {r.relay_id} drained empty; retiring",
                    server_id=r.relay_id,
                ))

        # 3) Scale-down initiation — never while another drain is open.
        draining_open = any(
            r.draining for r in relays.values() if r.alive
        )
        if (
            fill <= cfg.low_watermark
            and len(serving) > cfg.min_relays
            and not draining_open
        ):
            self._low_streak += 1
        else:
            self._low_streak = 0
            self._refused.discard(("scale", "down"))
        if self._low_streak >= cfg.confirm_beats:
            if in_cooldown:
                self._refuse_once(acts, ("scale", "down"), AutopilotAction(
                    "refuse", obs.tick,
                    f"cooldown: fan-out fill {fill:.2f} <= "
                    f"{cfg.low_watermark} but last scale action was "
                    f"{obs.tick - self._last_scale_tick} ticks ago "
                    f"(< {cfg.cooldown_scale_ticks})",
                ))
            else:
                victim = min(
                    serving, key=lambda r: (r.subscribers, -r.relay_id)
                )
                acts.append(AutopilotAction(
                    "relay_drain", obs.tick,
                    f"fan-out fill {fill:.2f} <= low watermark "
                    f"{cfg.low_watermark} for {self._low_streak} beats; "
                    f"draining emptiest relay {victim.relay_id} "
                    f"({victim.subscribers} subscribers)",
                    server_id=victim.relay_id,
                ))
                self._last_scale_tick = obs.tick
                self._low_streak = 0
                self._high_streak = 0
                self._refused.discard(("scale", "down"))
        return acts

    # Refusal audit discipline shared with AutopilotPolicy.
    _refuse_once = AutopilotPolicy._refuse_once


def relay_observation_to_json(obs: RelayObservation) -> dict:
    return {
        "tick": obs.tick,
        "relays": {
            str(rid): dataclasses.asdict(r)
            for rid, r in sorted(obs.relays.items())
        },
    }


def relay_observation_from_json(raw: dict) -> RelayObservation:
    return RelayObservation(
        tick=int(raw["tick"]),
        relays={
            int(rid): RelaySample(**r) for rid, r in raw["relays"].items()
        },
    )


def _split_relay_header(
    recs: List[dict], config: Optional[RelayAutopilotConfig]
) -> Tuple[Optional[RelayAutopilotConfig], List[dict]]:
    if recs and "config" in recs[0] and "observation" not in recs[0]:
        if config is None:
            config = RelayAutopilotConfig(**recs[0]["config"])
        recs = recs[1:]
    return config, recs


def replay_relay_ledger(
    records, config: Optional[RelayAutopilotConfig] = None
) -> List[List[AutopilotAction]]:
    config, recs = _split_relay_header(_load_ledger(records), config)
    policy = RelayPolicy(config)
    return [
        policy.decide(relay_observation_from_json(rec["observation"]))
        for rec in recs
    ]


def verify_relay_ledger(
    records, config: Optional[RelayAutopilotConfig] = None
) -> Tuple[bool, int]:
    """Determinism check for a relay-elasticity ledger: the recorded
    spawn→fan-out→drain arc must re-derive bit-identically from its
    observations alone."""
    config, recs = _split_relay_header(_load_ledger(records), config)
    replayed = replay_relay_ledger(recs, config)
    for rec, acts in zip(recs, replayed):
        if [_action_to_json(a) for a in acts] != rec["actions"]:
            return False, len(recs)
    return True, len(recs)


class RelayAutopilot:
    """The closed loop over a relay-tree adapter (``relay_samples /
    spawn_relay / drain_relay / retire_relay / rehome``) — RelayTree
    in-process, ProcRelayTier over subprocess UDP relays. Appends the
    same replayable JSONL record shape as :class:`FleetAutopilot`, with
    a ``kind: relay`` config header so the CLI harness routes the trace
    to the right policy."""

    def __init__(
        self,
        fleet,
        config: Optional[RelayAutopilotConfig] = None,
        metrics=None,
        tracer=None,
    ):
        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.fleet = fleet
        self.config = config or RelayAutopilotConfig()
        self.policy = RelayPolicy(self.config)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.ledger: List[dict] = []
        self.actions: List[AutopilotAction] = []
        self.counts: Dict[str, int] = {}

    def observe(self, tick: int) -> RelayObservation:
        return RelayObservation(
            tick=int(tick), relays=dict(self.fleet.relay_samples())
        )

    def _execute(self, a: AutopilotAction) -> bool:
        if a.kind == "relay_spawn":
            return bool(self.fleet.spawn_relay())
        if a.kind == "relay_drain":
            return bool(self.fleet.drain_relay(a.server_id))
        if a.kind == "relay_retire":
            return bool(self.fleet.retire_relay(a.server_id))
        if a.kind == "relay_rehome":
            return bool(self.fleet.rehome(a.server_id, a.dst_id))
        return True  # refuse: the recorded decision IS the act

    def step(self, tick: int) -> List[AutopilotAction]:
        obs = self.observe(tick)
        actions = self.policy.decide(obs)
        executed = []
        for a in actions:
            ok = self._execute(a)
            executed.append(bool(ok))
            self.counts[a.kind] = self.counts.get(a.kind, 0) + 1
            self.metrics.count(f"autopilot_{a.kind}")
            self.tracer.instant(
                f"autopilot_{a.kind}",
                reason=a.reason, relay=a.server_id, dst=a.dst_id,
                executed=ok,
            )
        self.actions.extend(actions)
        self.ledger.append({
            "tick": int(tick),
            "observation": relay_observation_to_json(obs),
            "actions": [_action_to_json(a) for a in actions],
            "executed": executed,
        })
        return actions

    def export_jsonl(self, path: str) -> int:
        with open(path, "w") as f:
            f.write(json.dumps({
                "config": dataclasses.asdict(self.config),
                "kind": "relay",
            }) + "\n")
            for rec in self.ledger:
                f.write(json.dumps(rec) + "\n")
        return len(self.ledger)


def _ledger_kind(recs: List[dict]) -> str:
    """Sniff whether a ledger is a fleet or a relay-elasticity trace:
    the exported header says so; headerless records are sniffed from the
    observation shape."""
    if recs and "config" in recs[0] and "observation" not in recs[0]:
        return recs[0].get("kind", "fleet")
    for rec in recs:
        if "observation" in rec:
            return "relay" if "relays" in rec["observation"] else "fleet"
    return "fleet"


def _main(argv: List[str]) -> int:
    """``python -m bevy_ggrs_tpu_torch.fleet.autopilot <ledger.jsonl>``: replay
    a recorded trace (fleet or relay-tier) through a fresh policy and
    report whether the decisions reproduce (the offline determinism
    check)."""
    if not argv:
        print("usage: python -m bevy_ggrs_tpu_torch.fleet.autopilot "
              "<autopilot_ledger.jsonl>")
        return 2
    recs = _load_ledger(argv[0])
    if _ledger_kind(recs) == "relay":
        ok, ticks = verify_relay_ledger(recs)
        body = _split_relay_header(recs, None)[1]
    else:
        ok, ticks = verify_ledger(recs)
        body = _split_header(recs, None)[1]
    n_actions = sum(len(r["actions"]) for r in body)
    print(f"ticks={ticks} actions={n_actions} "
          f"replay={'IDENTICAL' if ok else 'DIVERGED'}")
    return 0 if ok else 1


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(_main(sys.argv[1:]))
