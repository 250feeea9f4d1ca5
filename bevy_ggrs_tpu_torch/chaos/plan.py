"""ChaosPlan: a replayable fault schedule.

Counterpart of ``bevy_ggrs_tpu/chaos/plan.py``, the same JSON format and
directives, so one plan file drives either package's sockets.

A plan is a seed plus a list of time-windowed directives. The window times
are in seconds on whatever clock drives the sockets (the loopback virtual
clock in tests, wall time on real UDP), so the same plan file reproduces the
same fault sequence on either transport. Probabilistic directives (loss,
reorder, duplication, corruption) draw from per-socket RNGs derived from the
plan seed — two runs of the same plan over the same traffic make identical
drop/mangle decisions (docs/chaos.md, seed-replay workflow).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class LossBurst:
    """Drop each datagram with probability ``rate`` while
    ``start <= now < end``."""

    start: float
    end: float
    rate: float


@dataclasses.dataclass(frozen=True)
class Reorder:
    """Hold each datagram with probability ``rate`` for ``delay`` seconds
    before forwarding, letting later sends overtake it."""

    start: float
    end: float
    rate: float
    delay: float = 0.05


@dataclasses.dataclass(frozen=True)
class Duplicate:
    """Send each datagram twice with probability ``rate``."""

    start: float
    end: float
    rate: float


@dataclasses.dataclass(frozen=True)
class Corrupt:
    """Flip one random bit of each datagram with probability ``rate`` (the
    receiver's ``decode`` must reject it — corrupted-packet hardening)."""

    start: float
    end: float
    rate: float


@dataclasses.dataclass(frozen=True)
class Partition:
    """Drop ALL traffic matching ``src -> dst`` while the window is open
    (``end`` is the heal time). ``None`` is a wildcard, so one-sided
    entries model asymmetric partitions: ``Partition(t0, t1, src="a")``
    silences a's sends while a still hears everyone."""

    start: float
    end: float
    src: Optional[object] = None
    dst: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class KillRestart:
    """Script a peer-process death: ``peer`` goes down at ``at`` and may be
    restarted ``down_for`` seconds later. The socket layer ignores this
    directive — killing a process is the HARNESS's job (close the socket,
    drop the session, rebuild after the window; see tests/test_chaos.py) —
    but carrying it in the plan keeps the whole failure script in one
    replayable artifact."""

    at: float
    peer: object
    down_for: float


@dataclasses.dataclass(frozen=True)
class RelayKillRestart:
    """Script a RELAY-process death: the relay at address ``relay`` goes
    down at ``at`` and may be restarted ``down_for`` seconds later. Like
    :class:`KillRestart`, the socket layer ignores it — the harness closes
    the relay's socket and rebuilds it after the window (with a FRESH
    epoch, so publishers re-seed the stream buffer; see
    tests/test_relay.py). Carrying it in the plan makes relay failover
    replayable under a fixed seed, same as peer kill/restarts."""

    at: float
    relay: object
    down_for: float


@dataclasses.dataclass(frozen=True)
class ServerKillRestart:
    """Script a MATCH-SERVER process death: the :class:`~bevy_ggrs_tpu.
    serve.server.MatchServer` identified by ``server`` dies (kill -9 — no
    flush, no farewell) at ``at`` and may be restarted from its last
    on-disk checkpoint ``down_for`` seconds later. Like
    :class:`KillRestart` and :class:`RelayKillRestart`, the socket layer
    ignores it — the harness drops the server object at ``at`` and
    rebuilds it after the window via ``ServerCheckpointer.restore``
    (synctest matches resume bitwise from the checkpoint; P2P matches
    rejoin through the supervisor's crash-restart path; see
    tests/test_serve_chaos.py). Carrying it in the plan keeps the whole
    serve-tier failure script in one replayable artifact."""

    at: float
    server: object
    down_for: float


@dataclasses.dataclass(frozen=True)
class BalancerPartition:
    """Silence the fleet CONTROL plane for one server: heartbeats (and any
    migration traffic) between ``server`` and the balancer drop while the
    window is open. Unlike :class:`Partition` this is about the balancer's
    false-positive discipline — a server that is alive and serving but
    unheard must not be declared dead before ``grace`` (the balancer's
    heartbeat timeout) of CONTINUOUS silence, and a window shorter than
    that must cause zero failovers. Enforced at the fleet-socket level
    (the harness or the balancer's pump consults
    :meth:`ChaosPlan.balancer_partitioned`)."""

    start: float
    end: float
    server: object


@dataclasses.dataclass(frozen=True)
class MigrateMatch:
    """Script a FORCED live migration: at ``at``, the balancer drains
    match ``match_id`` from server ``src`` and readmits it on ``dst``
    through the digest-guarded snapshot wire. Harness/balancer-level like
    the kill family — sockets can't move matches — but carried in the
    plan so a fleet soak's migration schedule replays from its seed."""

    at: float
    match_id: int
    src: object
    dst: object


@dataclasses.dataclass(frozen=True)
class ServerLoss:
    """Script a PERMANENT server death (no restart — the difference from
    :class:`ServerKillRestart`): server ``server`` dies at ``at`` and
    never comes back. The balancer must detect the loss by heartbeat
    silence and restore the dead server's matches from its last fleet
    checkpoint onto SURVIVING servers (synctest bitwise, P2P via donor
    rejoin). Harness-level execution, replayable from the plan."""

    at: float
    server: object


@dataclasses.dataclass(frozen=True)
class ServerSpawn:
    """Script an ELASTIC fleet-size increase: at ``at`` the harness
    spawns a fresh MatchServer with id ``server`` and registers it with
    the control plane (for subprocess fleets, a real spawned process —
    see :class:`~bevy_ggrs_tpu.fleet.proc.ProcFleet`). Distinct from the
    autopilot's own watermark-driven scale-up: this one is *forced* by
    the plan, so an elastic soak exercises spawn-under-chaos at a seeded,
    replayable time regardless of where occupancy happens to sit.
    Harness-level execution, like the kill family."""

    at: float
    server: object


@dataclasses.dataclass(frozen=True)
class ServerDrain:
    """Script an ELASTIC fleet-size decrease: at ``at`` the harness marks
    server ``server`` draining; the autopilot (or the harness) must then
    drain-pack-retire it — migrate every hosted match off through the
    live-migration wire and retire the member only once empty. Forced by
    the plan for the same reason as :class:`ServerSpawn`: the
    drain-pack-retire sequence replays from the seed even when occupancy
    alone would never have triggered it."""

    at: float
    server: object


@dataclasses.dataclass(frozen=True)
class SnapshotCorrupt:
    """Script a SILENT in-memory corruption (the StateFault family): at
    ``at`` the harness flips one checksum-covered bit inside a live
    snapshot-ring row of ``target`` (a peer address, or a serve-tier slot
    — harness-interpreted, like the kill family's identities) via
    :func:`bevy_ggrs_tpu.integrity.flip_ring_bit`. The socket layer
    ignores it. The attestation sweep must DETECT the flip within its
    interval and repair it bitwise by rollback resimulation — zero
    desyncs, zero lost matches, no quarantine."""

    at: float
    target: object = None


@dataclasses.dataclass(frozen=True)
class CheckpointCorrupt:
    """Flip one random bit in the newest on-disk checkpoint file owned by
    ``target`` at ``at`` (:func:`bevy_ggrs_tpu.integrity.flip_file_bit`).
    The digest-guarded loaders must refuse the file with a typed
    ``ValueError`` — never restore a plausible impostor — and
    ``ServerCheckpointer.restore`` must fall back to the next-oldest
    retained checkpoint. Harness-level execution, replayable from the
    plan like the rest of the StateFault family."""

    at: float
    target: object = None


@dataclasses.dataclass(frozen=True)
class RelayTreeKill:
    """Script a MID-TIER relay death inside a relay tree: the non-root
    relay at address ``relay`` dies at ``at`` (crash semantics — its
    sockets close, no goodbye) and stays down for ``down_for`` seconds.
    Unlike :class:`RelayKillRestart` the victim is a TREE member, so the
    harness must also exercise the re-home ladder: orphaned child relays
    and spectators of the dead relay re-home to a sibling/grandparent
    and resume from their client-side cursors (zero desync, bounded
    resume lag; see tests/test_relay_tree.py). Harness-level execution,
    replayable from the plan like the rest of the kill family."""

    at: float
    relay: object
    down_for: float


Directive = Union[
    LossBurst, Reorder, Duplicate, Corrupt, Partition, KillRestart,
    RelayKillRestart, ServerKillRestart, BalancerPartition, MigrateMatch,
    ServerLoss, ServerSpawn, ServerDrain, SnapshotCorrupt, CheckpointCorrupt,
    RelayTreeKill,
]

_KINDS = {
    "loss": LossBurst,
    "reorder": Reorder,
    "duplicate": Duplicate,
    "corrupt": Corrupt,
    "partition": Partition,
    "kill_restart": KillRestart,
    "relay_kill_restart": RelayKillRestart,
    "server_kill_restart": ServerKillRestart,
    "balancer_partition": BalancerPartition,
    "migrate_match": MigrateMatch,
    "server_loss": ServerLoss,
    "server_spawn": ServerSpawn,
    "server_drain": ServerDrain,
    "snapshot_corrupt": SnapshotCorrupt,
    "checkpoint_corrupt": CheckpointCorrupt,
    "relay_tree_kill": RelayTreeKill,
}
_NAMES = {cls: name for name, cls in _KINDS.items()}


def _addr_to_json(addr):
    # (host, port) tuples survive JSON as lists; normalize on load instead.
    return addr


def _addr_from_json(addr):
    if isinstance(addr, list):
        return tuple(addr)
    return addr


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    seed: int
    directives: Tuple[Directive, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "directives", tuple(self.directives))

    # -- queries ---------------------------------------------------------

    def active(self, kind, now: float) -> List[Directive]:
        return [
            d
            for d in self.directives
            if isinstance(d, kind) and d.start <= now < d.end
        ]

    def partitioned(self, src, dst, now: float) -> bool:
        for d in self.directives:
            if not isinstance(d, Partition) or not d.start <= now < d.end:
                continue
            if (d.src is None or d.src == src) and (
                d.dst is None or d.dst == dst
            ):
                return True
        return False

    def kill_restarts(self) -> List[KillRestart]:
        return sorted(
            (d for d in self.directives if isinstance(d, KillRestart)),
            key=lambda d: d.at,
        )

    def relay_kill_restarts(self) -> List[RelayKillRestart]:
        return sorted(
            (d for d in self.directives if isinstance(d, RelayKillRestart)),
            key=lambda d: d.at,
        )

    def server_kill_restarts(self) -> List[ServerKillRestart]:
        return sorted(
            (d for d in self.directives if isinstance(d, ServerKillRestart)),
            key=lambda d: d.at,
        )

    def balancer_partitioned(self, server, now: float) -> bool:
        return any(
            isinstance(d, BalancerPartition)
            and d.server == server
            and d.start <= now < d.end
            for d in self.directives
        )

    def migrations(self) -> List[MigrateMatch]:
        return sorted(
            (d for d in self.directives if isinstance(d, MigrateMatch)),
            key=lambda d: d.at,
        )

    def server_losses(self) -> List[ServerLoss]:
        return sorted(
            (d for d in self.directives if isinstance(d, ServerLoss)),
            key=lambda d: d.at,
        )

    def server_spawns(self) -> List[ServerSpawn]:
        return sorted(
            (d for d in self.directives if isinstance(d, ServerSpawn)),
            key=lambda d: d.at,
        )

    def server_drains(self) -> List[ServerDrain]:
        return sorted(
            (d for d in self.directives if isinstance(d, ServerDrain)),
            key=lambda d: d.at,
        )

    def snapshot_corrupts(self) -> List[SnapshotCorrupt]:
        return sorted(
            (d for d in self.directives if isinstance(d, SnapshotCorrupt)),
            key=lambda d: d.at,
        )

    def checkpoint_corrupts(self) -> List[CheckpointCorrupt]:
        return sorted(
            (d for d in self.directives if isinstance(d, CheckpointCorrupt)),
            key=lambda d: d.at,
        )

    def relay_tree_kills(self) -> List[RelayTreeKill]:
        return sorted(
            (d for d in self.directives if isinstance(d, RelayTreeKill)),
            key=lambda d: d.at,
        )

    def horizon(self) -> float:
        """Time at which the last directive has expired/healed."""
        t = 0.0
        for d in self.directives:
            if isinstance(
                d,
                (
                    KillRestart, RelayKillRestart, ServerKillRestart,
                    RelayTreeKill,
                ),
            ):
                t = max(t, d.at + d.down_for)
            elif isinstance(
                d,
                (
                    MigrateMatch, ServerLoss, ServerSpawn, ServerDrain,
                    SnapshotCorrupt, CheckpointCorrupt,
                ),
            ):
                t = max(t, d.at)
            else:
                t = max(t, d.end)
        return t

    # -- (de)serialization: the replay artifact --------------------------

    def to_json(self) -> str:
        out = []
        for d in self.directives:
            entry = {"kind": _NAMES[type(d)]}
            for f in dataclasses.fields(d):
                v = getattr(d, f.name)
                entry[f.name] = _addr_to_json(v) if f.name in (
                    "src", "dst", "peer", "relay", "server", "target"
                ) else v
            out.append(entry)
        return json.dumps({"seed": self.seed, "directives": out}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ChaosPlan":
        raw = json.loads(text)
        directives = []
        for entry in raw["directives"]:
            entry = dict(entry)
            kind = _KINDS[entry.pop("kind")]
            for k in ("src", "dst", "peer", "relay", "server", "target"):
                if k in entry:
                    entry[k] = _addr_from_json(entry[k])
            directives.append(kind(**entry))
        return cls(int(raw["seed"]), tuple(directives))

    # -- generation ------------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        duration: float,
        peers: Tuple[object, ...] = (),
        kill_restart: bool = False,
        relay: Optional[object] = None,
        match_server: Optional[object] = None,
        fleet: Tuple[object, ...] = (),
        fleet_matches: int = 0,
        elastic: bool = False,
        control: bool = False,
        sdc: bool = False,
        relay_tree: Tuple[object, ...] = (),
    ) -> "ChaosPlan":
        """A deterministic mixed-fault schedule over ``duration`` seconds:
        a few loss bursts, one reorder window, one duplication window, one
        light corruption window, one asymmetric partition with a heal
        window, (opt-in) one peer kill/restart, when ``relay`` names a
        relay address one scripted relay kill/restart, and — when
        ``match_server`` names a serve-tier process — one scripted
        :class:`ServerKillRestart`. When ``fleet`` names ≥1 server ids the
        fleet family rides along: one :class:`BalancerPartition` (control-
        plane silence on a random member), with ≥2 members plus a
        ``fleet_matches`` domain one forced :class:`MigrateMatch`, and
        with ≥2 members one :class:`ServerLoss` late in the run. Fleet
        draws come AFTER every pre-existing draw, so adding them never
        perturbs the loss/reorder/kill schedule an older seed produced.
        With ``elastic=True`` (requires ``fleet``) the elastic family is
        appended LAST of all — one :class:`ServerSpawn` of a fresh id
        mid-run, one :class:`ServerDrain` of an existing member after it
        — so every pre-elastic plan a seed ever produced stays
        byte-identical. With ``control=True`` (requires ``fleet``) the
        control-plane family is appended after the elastic draws — one
        corruption window, one duplication window, and one asymmetric
        :class:`Partition` whose ``src`` is a fleet server id (matching
        the server-id identity fleet ChaosSockets carry) — aimed at the
        type 18–21 migration wire and the type-22 heartbeat stream. Same
        ``(seed, duration, peers, relay, match_server, fleet,
        fleet_matches, elastic, control)`` -> same plan, always. With
        ``sdc=True`` the StateFault family is appended LAST of all (after
        the control draws, preserving byte-identity of every pre-sdc
        schedule): two :class:`SnapshotCorrupt` silent bit flips targeting
        peers (or fleet members when no peers are named), and — when a
        ``match_server`` or ``fleet`` exists to own checkpoint files — one
        :class:`CheckpointCorrupt` late in the run. When ``relay_tree``
        names ≥1 MID-TIER relay addresses, one :class:`RelayTreeKill` of
        a random member is appended LAST of all (after the sdc family),
        so every pre-tree plan a seed ever produced stays
        byte-identical."""
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        span = max(float(duration), 1.0)
        d: List[Directive] = []
        for _ in range(3):
            t0 = float(rng.uniform(0.05 * span, 0.85 * span))
            d.append(LossBurst(t0, t0 + float(rng.uniform(0.02, 0.06) * span),
                               float(rng.uniform(0.1, 0.4))))
        t0 = float(rng.uniform(0.1 * span, 0.7 * span))
        d.append(Reorder(t0, t0 + 0.1 * span, float(rng.uniform(0.1, 0.3)),
                         delay=float(rng.uniform(0.02, 0.08))))
        t0 = float(rng.uniform(0.1 * span, 0.7 * span))
        d.append(Duplicate(t0, t0 + 0.1 * span, float(rng.uniform(0.1, 0.3))))
        t0 = float(rng.uniform(0.1 * span, 0.7 * span))
        d.append(Corrupt(t0, t0 + 0.08 * span, float(rng.uniform(0.05, 0.15))))
        if peers:
            victim = peers[int(rng.randint(0, len(peers)))]
            t0 = float(rng.uniform(0.2 * span, 0.5 * span))
            # One-sided: victim's sends vanish, it still hears the others —
            # the asymmetric shape that trips naive keepalive logic.
            d.append(Partition(t0, t0 + float(rng.uniform(0.04, 0.1) * span),
                               src=victim))
            if kill_restart:
                t0 = float(rng.uniform(0.6 * span, 0.8 * span))
                d.append(KillRestart(t0, victim,
                                     float(rng.uniform(0.05, 0.1) * span)))
        if relay is not None:
            t0 = float(rng.uniform(0.3 * span, 0.55 * span))
            d.append(RelayKillRestart(t0, relay,
                                      float(rng.uniform(0.03, 0.06) * span)))
        if match_server is not None:
            # Late in the run, after every network-fault window has had a
            # chance to open — a server crash layered onto an already-noisy
            # match is the shape the checkpoint/rejoin path must survive.
            t0 = float(rng.uniform(0.55 * span, 0.75 * span))
            d.append(ServerKillRestart(t0, match_server,
                                       float(rng.uniform(0.04, 0.08) * span)))
        if fleet:
            # Fleet family — drawn LAST so every earlier stream (and
            # therefore every pre-fleet plan a seed ever produced) is
            # byte-identical with or without these.
            victim = fleet[int(rng.randint(0, len(fleet)))]
            t0 = float(rng.uniform(0.15 * span, 0.4 * span))
            d.append(BalancerPartition(
                t0, t0 + float(rng.uniform(0.02, 0.05) * span), victim))
            if len(fleet) >= 2 and fleet_matches > 0:
                src_i = int(rng.randint(0, len(fleet)))
                dst_i = (
                    src_i + 1 + int(rng.randint(0, len(fleet) - 1))
                ) % len(fleet)
                mid = int(rng.randint(0, fleet_matches))
                t0 = float(rng.uniform(0.3 * span, 0.5 * span))
                d.append(MigrateMatch(t0, mid, fleet[src_i], fleet[dst_i]))
            if len(fleet) >= 2:
                # Late, after the migration and every network window: the
                # failover must land on a fleet already scarred by chaos.
                t0 = float(rng.uniform(0.6 * span, 0.8 * span))
                d.append(ServerLoss(
                    t0, fleet[int(rng.randint(0, len(fleet)))]))
        if fleet and elastic:
            # Elastic family — drawn LAST of all (after the fleet family),
            # preserving byte-identity of every pre-elastic schedule.
            fresh = max(int(s) for s in fleet) + 1
            t0 = float(rng.uniform(0.2 * span, 0.4 * span))
            d.append(ServerSpawn(t0, fresh))
            t0 = float(rng.uniform(0.45 * span, 0.6 * span))
            d.append(ServerDrain(
                t0, fleet[int(rng.randint(0, len(fleet)))]))
        if fleet and control:
            # Control-plane family — drawn after every other family, so
            # every pre-control plan a seed ever produced stays
            # byte-identical. These windows land on the fleet's OWN
            # sockets (server-id identities): migration frames get
            # corrupted and duplicated, and one member's outbound — its
            # heartbeats included — goes dark while it still hears the
            # world, the asymmetric shape split-brain fencing exists for.
            t0 = float(rng.uniform(0.15 * span, 0.55 * span))
            d.append(Corrupt(t0, t0 + 0.1 * span,
                             float(rng.uniform(0.05, 0.15))))
            t0 = float(rng.uniform(0.15 * span, 0.55 * span))
            d.append(Duplicate(t0, t0 + 0.1 * span,
                               float(rng.uniform(0.1, 0.3))))
            victim = fleet[int(rng.randint(0, len(fleet)))]
            t0 = float(rng.uniform(0.25 * span, 0.5 * span))
            d.append(Partition(
                t0, t0 + float(rng.uniform(0.03, 0.07) * span),
                src=victim))
        if sdc:
            # StateFault family — drawn LAST of all (after the control
            # draws), so every pre-sdc plan a seed ever produced stays
            # byte-identical. Targets prefer peers (P2P soaks); fleets
            # fall back to member ids; a bare serve soak gets None and the
            # harness picks its own victim slot.
            domain = peers if peers else fleet
            for _ in range(2):
                tgt = (
                    domain[int(rng.randint(0, len(domain)))]
                    if domain else None
                )
                t0 = float(rng.uniform(0.2 * span, 0.7 * span))
                d.append(SnapshotCorrupt(t0, tgt))
            if match_server is not None or fleet:
                tgt = (
                    match_server if match_server is not None
                    else fleet[int(rng.randint(0, len(fleet)))]
                )
                # Late: the rolling keep-window must already hold >1 file
                # so the restore fallback has somewhere to land.
                t0 = float(rng.uniform(0.6 * span, 0.85 * span))
                d.append(CheckpointCorrupt(t0, tgt))
        if relay_tree:
            # Relay-tree family — drawn LAST of all (after the sdc
            # draws), preserving byte-identity of every pre-tree plan.
            # Mid-run, so the tree is warm (keyframes cached, chains
            # flowing) when the mid-tier relay dies and the re-home
            # ladder has runway to prove zero-desync resume.
            victim = relay_tree[int(rng.randint(0, len(relay_tree)))]
            t0 = float(rng.uniform(0.35 * span, 0.6 * span))
            d.append(RelayTreeKill(
                t0, victim, float(rng.uniform(0.04, 0.08) * span)))
        return cls(seed, tuple(d))
