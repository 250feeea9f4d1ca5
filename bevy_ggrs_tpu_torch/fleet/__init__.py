"""Fleet tier: health-driven balancing across N MatchServers.

Counterpart of ``bevy_ggrs_tpu/fleet``, with the same exports.

One MatchServer is one fault domain — it has slot quarantine and
crash-restart, but a fleet of servers needs the layer above: who gets the
next match, how a live match moves OFF a burning server without its
players noticing, and what happens when a whole server disappears.
:class:`~bevy_ggrs_tpu_torch.fleet.balancer.FleetBalancer` is that layer:

- **Placement** scores every member by its last
  :class:`~bevy_ggrs_tpu_torch.session.protocol.FleetHeartbeat` (SLO pages,
  quarantined slots, occupancy) and admits at the least-burning server's
  least-loaded stagger group.
- **Live migration** drains a match through the server's extract path
  into a digest-guarded :func:`~bevy_ggrs_tpu_torch.serve.faults.
  pack_match_record` blob, ships it over the type 18–21 migration wire,
  and readmits it bitwise-continuously on the destination — with an
  abort path that readmits the retained ticket at the source, so a
  corrupt blob or a refusing destination never loses the match.
- **Server-loss failover** turns heartbeat silence past the balancer's
  timeout into recovery: the dead server's matches re-seed from its last
  on-disk fleet checkpoint onto surviving servers (synctest bitwise, P2P
  via supervisor donor rejoin).

docs/serving.md "Fleet tier" covers the policy math; docs/chaos.md lists
the fleet fault model (BalancerPartition / MigrateMatch / ServerLoss).

``fleet.traffic`` is the front door's load side: :class:`TrafficPlan`
(seeded, replayable open-loop arrival schedules — Poisson match
arrivals, spectator subscribes, abandons) and :class:`Matchmaker`
(routes due arrivals through ``place_match`` with per-arrival
:class:`~bevy_ggrs_tpu_torch.serve.admission.AdmissionTrace` carried end to
end). docs/serving.md "Front door" covers the model.

``fleet.autopilot`` closes the control loop (docs/serving.md
"Autopilot"): :class:`FleetAutopilot` consumes the type-22 heartbeat
stream + front-door window-SLO levels and initiates burn preemption,
anti-affinity-aware placement, and watermark autoscaling
(spawn / drain-pack-retire) as typed, reasoned, offline-replayable
:class:`AutopilotAction` decisions. ``fleet.proc`` makes it real:
supervised subprocess MatchServers over real UDP sockets
(:class:`ProcFleet` / :class:`ServerProcess`).
"""

from bevy_ggrs_tpu_torch.fleet.autopilot import (
    AutopilotAction,
    AutopilotConfig,
    AutopilotPolicy,
    BalancerFleet,
    FleetAutopilot,
    FleetObservation,
    ServerSample,
    heartbeat_score,
)
from bevy_ggrs_tpu_torch.fleet.balancer import (
    FleetBalancer,
    FleetMember,
    Migration,
    Placement,
)
from bevy_ggrs_tpu_torch.fleet.proc import ProcFleet, ServerProcess
from bevy_ggrs_tpu_torch.fleet.traffic import (
    MatchAbandon,
    MatchArrival,
    Matchmaker,
    SpectatorSubscribe,
    TrafficPlan,
)

__all__ = [
    "AutopilotAction",
    "AutopilotConfig",
    "AutopilotPolicy",
    "BalancerFleet",
    "FleetAutopilot",
    "FleetBalancer",
    "FleetMember",
    "FleetObservation",
    "MatchAbandon",
    "MatchArrival",
    "Matchmaker",
    "Migration",
    "Placement",
    "ProcFleet",
    "ServerProcess",
    "ServerSample",
    "SpectatorSubscribe",
    "TrafficPlan",
    "heartbeat_score",
]
