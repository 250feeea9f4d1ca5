"""Relay tree: tiered spectator fan-out (docs/relay.md, "Relay tree").

Counterpart of ``bevy_ggrs_tpu/relay/tree.py``. The subprocess relay
forwards bytes and does no device work, but like every entry point of the
port it belongs to the card unless its config's ``"device"`` says
otherwise: asked for ``cuda`` on a machine without a GPU it raises before
its ``ready`` event.

A single relay tops out at a few thousand spectators per core
(bench ``relay_fanout_64spec``); the 100k story is a TREE of relays. The
composition is deliberately boring: the Subscribe/StreamDelta/
StreamKeyframe/StreamAck cursor protocol (wire types 14-17) is
relay-agnostic, so *a relay can itself be a subscriber*. Each non-root
relay runs a :class:`TierLink` — the upstream half — that subscribes to
its parent with the same cursor discipline a spectator uses, and feeds
every stream datagram VERBATIM into the local
:class:`~bevy_ggrs_tpu_torch.relay.server.RelayServer` buffer
(``RelayServer.ingest``). The link never decodes state, so the bytes a
leaf spectator reconstructs are the exact bytes the root published, at
any depth — bitwise exactness is structural, not probabilistic.

Tier contract (per hop):

- The link tracks its **contiguous frontier** over raw datagrams: a
  delta advances it when its base equals the frontier; a complete
  keyframe is a checkpoint that jumps it. The frontier — never the
  newest frame seen — is what the link acks upstream, so parent-side
  flow control sees real downstream progress.
- Parent failover / autopilot re-homing resumes FROM the frontier. When
  the new parent still buffers the chain, the chain-aware resume
  (relay/server.py) promotes the cursor straight back to FULL: a warm
  swap costs zero keyframe bytes.
- A parent that degrades this link to KEYFRAME_ONLY does not silently
  break the children's delta chains: the keyframes the link ingests
  land in the local buffer + shared keyframe cache, the local ladder
  degrades this relay's own subscribers onto the keyframe rung, and
  everyone re-seeds from the cached keyframe — epoch-style, per tier.

Lag-vs-depth: ``pump()`` drives links before servers, so one pump moves
a datagram exactly one tier; added lag is bounded by one pump interval
per tier (the bench ``relay_tree_1k`` gates <= 2 frames per tier).

Elastic tiers: :class:`ProcRelayTier` supervises real subprocess relays
(``python -m bevy_ggrs_tpu_torch.relay.tree '<json>'``, one UDP serve port +
one uplink port each) behind the same adapter protocol
``RelayAutopilot`` (fleet/autopilot.py) drives, so fan-out capacity
scales independently of match-serving capacity — the Podracer
decoupling applied to delivery.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time as _time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from bevy_ggrs_tpu_torch.obs import null_tracer
from bevy_ggrs_tpu_torch.relay.delta import delta_apply, payload_digest
from bevy_ggrs_tpu_torch.relay.server import RelayServer
from bevy_ggrs_tpu_torch.relay.stream import CHUNK_PAYLOAD
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.session.common import NULL_FRAME
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

__all__ = [
    "TierLink",
    "RelayTree",
    "RelayTreeNode",
    "RelayProcess",
    "ProcRelayTier",
    "DEFAULT_RELAY_PROC_CONFIG",
]

SUB_INTERVAL = 0.2
RESUB_TIMEOUT = 0.6


class TierLink:
    """Upstream half of a non-root relay: a subscriber whose "apply" is
    feeding raw datagrams into the local relay's stream buffer."""

    def __init__(
        self,
        socket,
        server: RelayServer,
        parents: List[object],
        session_id: int = 0,
        window: int = 32,
        clock: Optional[Callable[[], float]] = None,
        sub_interval: float = SUB_INTERVAL,
        resub_timeout: float = RESUB_TIMEOUT,
        keyframe_interval: int = 20,
        metrics=None,
        tracer=None,
    ):
        if not parents:
            raise ValueError("TierLink needs at least one parent address")
        self.socket = socket
        self.server = server
        self.parents = list(parents)
        self._idx = 0
        self.parent_addr = self.parents[0]
        self.session_id = int(session_id)
        self.window = int(window)
        self._clock = clock if clock is not None else _time.monotonic
        self.sub_interval = float(sub_interval)
        self.resub_timeout = float(resub_timeout)
        self.keyframe_interval = int(keyframe_interval)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer

        # Highest frame held CONTIGUOUSLY in the local buffer — the
        # resumable cursor and the upstream ack, exactly a spectator's
        # ``current_frame`` but over raw datagrams (no state decode).
        self.frontier = NULL_FRAME
        self.head_seen = NULL_FRAME
        self._chain: Dict[int, int] = {}  # base -> frame, not yet contiguous
        self._kf_progress: Dict[int, Dict] = {}  # frame -> {"total","seen"}
        # Reconstructed state bytes AT the frontier. No codec, no world
        # decode — pure ``delta_apply`` over the CRC'd wire — but it lets
        # the link (a) verify every buffered datagram before acking past
        # it (a corrupt buffer entry holds the frontier until the
        # parent's per-pump resend repairs it) and (b) SYNTHESIZE a
        # fresh keyframe into the local buffer every
        # ``keyframe_interval`` frames. Parents only send keyframes to
        # cold/degraded subscribers, so without regeneration a warm
        # link's newest keyframe would age forever and cold joins below
        # this tier would eventually outrun the delta retention.
        # Synthesized keyframes carry the exact reconstructed payload
        # (chunking, crc and digest are deterministic), so bitwise
        # exactness is preserved at every depth.
        self._state: Optional[bytes] = None
        self._last_kf_frame = NULL_FRAME
        self.keyframes_synthesized = 0
        self.failovers = 0
        self.retargets = 0
        now = self._clock()
        self._last_data = now
        self._last_sub = float("-inf")

    # ------------------------------------------------------------------

    def lag_frames(self) -> int:
        """Frames between the newest frame seen from upstream and the
        contiguous frontier — this tier's added lag, in frames."""
        if self.head_seen == NULL_FRAME or self.frontier == NULL_FRAME:
            return 0
        return max(0, self.head_seen - self.frontier)

    def _subscribe(self, now: float) -> None:
        self._last_sub = now
        self.socket.send_to(
            proto.encode(
                proto.Subscribe(self.session_id, self.frontier, self.window)
            ),
            self.parent_addr,
        )

    def _failover(self, now: float) -> None:
        self._idx = (self._idx + 1) % len(self.parents)
        self.parent_addr = self.parents[self._idx]
        self.failovers += 1
        self.metrics.count("tier_parent_failovers")
        self._last_data = now  # grace on the new parent
        self._subscribe(now)

    def retarget(self, parents: List[object], now: Optional[float] = None) -> None:
        """Re-home to a new parent set (re-home ladder / autopilot
        rewiring). Chain state is KEPT: the next Subscribe carries the
        frontier, and a parent that still buffers the chain resumes the
        stream without a single keyframe byte."""
        if not parents:
            raise ValueError("TierLink.retarget needs >= 1 parent")
        self.parents = list(parents)
        self._idx = 0
        self.parent_addr = self.parents[0]
        self.retargets += 1
        self.metrics.count("tier_retargets")
        now = self._clock() if now is None else now
        self._last_data = now
        self._subscribe(now)

    def _accept_keyframe(self, frame: int) -> bool:
        """Assemble the buffered keyframe and verify its digest; on
        success it becomes the reconstructed state at ``frame``."""
        stream = self.server._streams.get(self.session_id)
        kf = stream.keyframes.get(frame) if stream is not None else None
        if kf is None:
            return False
        payloads = []
        for seq in sorted(kf["chunks"]):
            msg = proto.decode(kf["chunks"][seq])
            if not isinstance(msg, proto.StreamKeyframe):
                return False
            payloads.append(msg.payload)
        data = b"".join(payloads)
        if kf.get("digest") is not None and payload_digest(data) != kf["digest"]:
            return False
        self._state = data
        self._last_kf_frame = frame
        return True

    def _apply_delta(self, stream, base: int, nxt: int) -> bool:
        """Advance the reconstructed state across one buffered delta,
        CRC-verified. False = the buffer entry is corrupt/missing and
        the frontier must hold until the parent resends it."""
        if self._state is None or stream is None:
            return True  # nothing to maintain (pre-keyframe)
        ent = stream.deltas.get(base)
        if ent is None or ent[0] != nxt:
            return False
        msg = proto.decode(ent[1])
        if not isinstance(msg, proto.StreamDelta):
            return False
        try:
            self._state = delta_apply(
                self._state, msg.payload, expect_crc=msg.crc
            )
        except ValueError:
            return False
        return True

    def _synthesize_keyframe(self) -> None:
        """Re-originate a fresh checkpoint at the frontier from the
        reconstructed state — same chunking/crc/digest the publisher
        would produce for these exact bytes — so this tier's cold joins
        and degrade ladder always have a recent keyframe even though
        the warm uplink never receives one."""
        data = self._state
        digest = payload_digest(data)
        chunks = [
            data[i : i + CHUNK_PAYLOAD]
            for i in range(0, len(data), CHUNK_PAYLOAD)
        ] or [b""]
        total = len(chunks)
        for seq, payload in enumerate(chunks):
            self.server.ingest(
                self.session_id,
                proto.encode(
                    proto.StreamKeyframe(
                        self.frontier, seq, total,
                        zlib.crc32(payload) & 0xFFFFFFFF, digest, payload,
                    )
                ),
            )
        self._last_kf_frame = self.frontier
        self.keyframes_synthesized += 1
        self.metrics.count("tier_keyframes_synthesized")

    def pump(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        got_data = False
        for addr, raw in self.socket.receive_all():
            if addr != self.parent_addr and addr not in self.parents:
                continue
            msg = proto.decode(raw)
            if msg is None:
                self.metrics.count("tier_undecodable")
                continue
            if isinstance(msg, proto.StreamDelta):
                got_data = True
                self.head_seen = max(self.head_seen, msg.frame)
                if msg.frame > self.frontier:
                    self.server.ingest(self.session_id, raw)
                    self._chain[msg.base_frame] = msg.frame
            elif isinstance(msg, proto.StreamKeyframe):
                got_data = True
                self.head_seen = max(self.head_seen, msg.frame)
                if msg.frame > self.frontier:
                    self.server.ingest(self.session_id, raw)
                    prog = self._kf_progress.setdefault(
                        msg.frame, {"total": msg.total, "seen": set()}
                    )
                    prog["seen"].add(msg.seq)
                    if len(prog["seen"]) >= prog["total"]:
                        if self._accept_keyframe(msg.frame):
                            del self._kf_progress[msg.frame]
                            self.frontier = max(self.frontier, msg.frame)
                            self.metrics.count("tier_keyframes_ingested")
                        else:
                            # Digest mismatch: refuse the checkpoint and
                            # let the parent's resends rebuild it.
                            prog["seen"].clear()
                            self.metrics.count("tier_keyframe_rejected")
            # Anything else from the parent (welcomes for someone else,
            # future control traffic) is ignored.
        if got_data:
            self._last_data = now

        # Walk the contiguous frontier over buffered deltas, applying
        # each one to the reconstructed state as it is crossed — the ack
        # only ever covers VERIFIED bytes.
        advanced = 0
        stream = self.server._streams.get(self.session_id)
        while self.frontier in self._chain:
            nxt = self._chain[self.frontier]
            if not self._apply_delta(stream, self.frontier, nxt):
                # Corrupt or missing buffered delta: hold the frontier
                # (and the upstream ack) so the parent's per-pump chain
                # resend overwrites the bad entry; retry next pump.
                self.metrics.count("tier_delta_rejected")
                break
            del self._chain[self.frontier]
            self.frontier = nxt
            advanced += 1
        if advanced:
            self.metrics.count("tier_frames_advanced", advanced)
        if (
            self._state is not None
            and self.frontier != NULL_FRAME
            and self.frontier - self._last_kf_frame >= self.keyframe_interval
        ):
            self._synthesize_keyframe()
        if len(self._chain) > 4 * self.window:
            self._chain = {
                b: f for b, f in self._chain.items() if b >= self.frontier
            }
        if len(self._kf_progress) > 4:
            self._kf_progress = {
                f: p for f, p in self._kf_progress.items() if f > self.frontier
            }

        # Upstream flow control + liveness (the spectator discipline).
        if self.frontier != NULL_FRAME:
            self.socket.send_to(
                proto.encode(proto.StreamAck(self.frontier)),
                self.parent_addr,
            )
        if now - self._last_data > self.resub_timeout:
            self._failover(now)
        elif self.frontier == NULL_FRAME and now - self._last_sub > self.sub_interval:
            self._subscribe(now)

    def close(self) -> None:
        close = getattr(self.socket, "close", None)
        if close is not None:
            close()


class RelayTreeNode:
    __slots__ = (
        "relay_id", "addr", "server", "link", "parent", "tier",
        "alive", "draining",
    )

    def __init__(self, relay_id, addr, server, link, parent, tier):
        self.relay_id = relay_id
        self.addr = addr
        self.server = server
        self.link = link
        self.parent = parent  # parent addr, None for the root
        self.tier = tier
        self.alive = True
        self.draining = False


class RelayTree:
    """In-process relay tree over any socket factory (tests and the
    bench use a LoopbackNetwork; subprocess tiers are ProcRelayTier).

    Also implements the relay-autopilot adapter protocol
    (``relay_samples`` / ``spawn_relay`` / ``drain_relay`` /
    ``retire_relay`` / ``rehome``) so the same :class:`RelayAutopilot`
    policy drives an in-process tree in tests and subprocess tiers in
    production."""

    def __init__(
        self,
        socket_factory: Callable[[object], object],
        session_id: int = 0,
        clock: Optional[Callable[[], float]] = None,
        link_window: int = 32,
        fanout_capacity: int = 64,
        max_depth: int = 1,
        addr_for: Optional[Callable[[int], object]] = None,
        server_kwargs: Optional[dict] = None,
        link_kwargs: Optional[dict] = None,
        metrics_factory: Optional[Callable[[object], object]] = None,
        tracer_factory: Optional[Callable[[object], object]] = None,
    ):
        self._factory = socket_factory
        self.session_id = int(session_id)
        self._clock = clock if clock is not None else _time.monotonic
        self.link_window = int(link_window)
        self.fanout_capacity = int(fanout_capacity)
        self.max_depth = int(max_depth)
        self._addr_for = addr_for if addr_for is not None else (
            lambda rid: ("relay", rid)
        )
        self._server_kwargs = dict(server_kwargs or {})
        self._link_kwargs = dict(link_kwargs or {})
        self._metrics_factory = metrics_factory
        self._tracer_factory = tracer_factory
        self._ids = itertools.count(0)
        self.nodes: Dict[object, RelayTreeNode] = {}  # keyed by addr
        self.root: Optional[object] = None
        self.events: List[dict] = []

    # -- construction ----------------------------------------------------

    def _uplink_addr(self, addr: object) -> object:
        return (addr, "uplink")

    def add_relay(
        self,
        addr: Optional[object] = None,
        parent: Optional[object] = None,
    ) -> RelayTreeNode:
        relay_id = next(self._ids)
        if addr is None:
            addr = self._addr_for(relay_id)
        if addr in self.nodes:
            raise ValueError(f"relay address {addr!r} already in the tree")
        metrics = (
            self._metrics_factory(addr)
            if self._metrics_factory is not None else None
        )
        tracer = (
            self._tracer_factory(addr)
            if self._tracer_factory is not None else None
        )
        server = RelayServer(
            self._factory(addr),
            clock=self._clock,
            metrics=metrics,
            tracer=tracer,
            **self._server_kwargs,
        )
        if parent is None:
            if self.root is not None:
                raise ValueError("relay tree already has a root")
            self.root = addr
            node = RelayTreeNode(relay_id, addr, server, None, None, 0)
        else:
            pnode = self.nodes[parent]
            link = TierLink(
                self._factory(self._uplink_addr(addr)),
                server,
                [parent],
                session_id=self.session_id,
                window=self.link_window,
                clock=self._clock,
                metrics=metrics,
                tracer=tracer,
                **self._link_kwargs,
            )
            node = RelayTreeNode(
                relay_id, addr, server, link, parent, pnode.tier + 1
            )
        self.nodes[addr] = node
        self.events.append({"event": "spawn", "relay": addr, "tier": node.tier})
        return node

    # -- queries ---------------------------------------------------------

    def node(self, addr: object) -> RelayTreeNode:
        return self.nodes[addr]

    def children_of(self, addr: object) -> List[RelayTreeNode]:
        return [
            n for n in self.nodes.values() if n.parent == addr and n.alive
        ]

    def live_relays(self) -> List[object]:
        return [a for a, n in self.nodes.items() if n.alive]

    def depth(self) -> int:
        return max((n.tier for n in self.nodes.values() if n.alive), default=0)

    def tier_lag(self) -> Dict[int, int]:
        """Worst contiguous-frontier lag per tier, in frames."""
        lag: Dict[int, int] = {}
        for n in self.nodes.values():
            if not n.alive or n.link is None:
                continue
            lag[n.tier] = max(lag.get(n.tier, 0), n.link.lag_frames())
        return lag

    def topology_rows(self) -> List[dict]:
        """One dict per relay for the ops report's tree section."""
        rows = []
        for addr in sorted(self.nodes, key=lambda a: self.nodes[a].relay_id):
            n = self.nodes[addr]
            cache = n.server.keyframe_cache
            rows.append({
                "relay": repr(addr),
                "relay_id": n.relay_id,
                "tier": n.tier,
                "parent": repr(n.parent) if n.parent is not None else "",
                "alive": n.alive,
                "draining": n.draining,
                "subscribers": n.server.subscriber_count(),
                "frontier": (
                    n.link.frontier if n.link is not None
                    else n.server.stream_head(self.session_id)
                ),
                "lag_frames": n.link.lag_frames() if n.link is not None else 0,
                "cache_hits": cache.hits,
                "cache_misses": cache.misses,
                "cache_corrupt": cache.corrupt,
            })
        return rows

    # -- pumping ---------------------------------------------------------

    def pump(self, now: Optional[float] = None) -> None:
        """Links first, then servers: a datagram crosses at most one
        tier per pump, which is what bounds per-tier added lag to the
        pump cadence."""
        now = self._clock() if now is None else now
        for node in list(self.nodes.values()):
            if node.alive and node.link is not None:
                node.link.pump(now)
        for node in list(self.nodes.values()):
            if node.alive:
                node.server.pump(now)

    # -- failure + re-home ladder ---------------------------------------

    def kill(self, addr: object) -> List[object]:
        """Kill a relay (crash semantics: sockets close, no goodbye) and
        re-home its orphaned child relays. Returns the re-homed child
        addresses; client-side spectators of the dead relay re-home
        themselves via ``StreamSpectator.retarget`` (their cursor lives
        client-side)."""
        node = self.nodes[addr]
        node.alive = False
        node.server.close()
        if node.link is not None:
            node.link.close()
        self.events.append({"event": "kill", "relay": addr})
        orphans = [n for n in self.nodes.values() if n.parent == addr and n.alive]
        rehomed = []
        for orphan in orphans:
            target = self._rehome_target(orphan, dead_parent=node)
            if target is None:
                continue
            self._rewire(orphan, target)
            rehomed.append(orphan.addr)
        return rehomed

    def _rehome_target(
        self, orphan: RelayTreeNode, dead_parent: RelayTreeNode
    ) -> Optional[RelayTreeNode]:
        """The re-home ladder: a live sibling of the dead parent first
        (stays at the same depth, spreads load), else the grandparent,
        else the root. Deterministic — lowest relay_id wins — so every
        orphan of one death re-homes identically across runs."""
        siblings = [
            n for n in self.nodes.values()
            if n.alive and not n.draining
            and n.parent == dead_parent.parent
            and n.addr != orphan.addr
        ]
        if siblings:
            return min(siblings, key=lambda n: n.relay_id)
        if dead_parent.parent is not None:
            gp = self.nodes.get(dead_parent.parent)
            if gp is not None and gp.alive:
                return gp
        if self.root is not None and self.nodes[self.root].alive:
            return self.nodes[self.root]
        return None

    def _rewire(self, child: RelayTreeNode, new_parent: RelayTreeNode) -> None:
        child.parent = new_parent.addr
        child.tier = new_parent.tier + 1
        child.link.retarget([new_parent.addr])
        self.events.append({
            "event": "rehome", "relay": child.addr,
            "parent": new_parent.addr,
        })

    # -- relay-autopilot adapter ----------------------------------------

    def relay_samples(self) -> Dict[int, "object"]:
        from bevy_ggrs_tpu_torch.fleet.autopilot import RelaySample

        out: Dict[int, object] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            pnode = self.nodes.get(n.parent) if n.parent is not None else None
            out[n.relay_id] = RelaySample(
                relay_id=n.relay_id,
                tier=n.tier,
                parent_id=(pnode.relay_id if pnode is not None else None),
                subscribers=n.server.subscriber_count(),
                capacity=self.fanout_capacity,
                alive=n.alive and (pnode is None or pnode.alive),
                draining=n.draining,
            )
        return out

    def _node_by_id(self, relay_id: int) -> Optional[RelayTreeNode]:
        for n in self.nodes.values():
            if n.relay_id == relay_id:
                return n
        return None

    def spawn_relay(self) -> bool:
        """Grow the elastic tier: a new relay under the live,
        non-draining parent with the fewest children (root counts),
        capped at ``max_depth``."""
        candidates = [
            n for n in self.nodes.values()
            if n.alive and not n.draining and n.tier < self.max_depth
        ]
        if not candidates:
            return False
        parent = min(
            candidates,
            key=lambda n: (len(self.children_of(n.addr)), n.relay_id),
        )
        self.add_relay(parent=parent.addr)
        return True

    def drain_relay(self, relay_id: int) -> bool:
        node = self._node_by_id(relay_id)
        if node is None or not node.alive or node.addr == self.root:
            return False
        node.draining = True
        node.server.draining = True
        self.events.append({"event": "drain", "relay": node.addr})
        return True

    def retire_relay(self, relay_id: int) -> bool:
        node = self._node_by_id(relay_id)
        if node is None or not node.alive or node.addr == self.root:
            return False
        node.alive = False
        node.server.close()
        if node.link is not None:
            node.link.close()
        self.events.append({"event": "retire", "relay": node.addr})
        return True

    def rehome(self, relay_id: int, new_parent_id: int) -> bool:
        node = self._node_by_id(relay_id)
        target = self._node_by_id(int(new_parent_id))
        if (
            node is None or target is None or node.link is None
            or not node.alive or not target.alive
        ):
            return False
        self._rewire(node, target)
        return True

    def close(self) -> None:
        for node in self.nodes.values():
            if node.alive:
                node.server.close()
                if node.link is not None:
                    node.link.close()
                node.alive = False


# ---------------------------------------------------------------------------
# Subprocess tier: one relay per child process, real UDP data plane
# ---------------------------------------------------------------------------

DEFAULT_RELAY_PROC_CONFIG: Dict = {
    "relay_id": 0,
    "session_id": 0,
    "port": 0,           # serve port; 0 = kernel-assigned ephemeral
    "parents": [],       # [[host, port], ...]; empty = root relay
    "tick_hz": 240.0,
    "status_interval_s": 0.25,
    "duration_s": 0.0,   # 0 = run until a shutdown command
    "shed_after": 2.0,
    "degrade_after": 12,
    "device": None,      # None = cuda (raising without a GPU); tests: "cpu"
}


def _relay_child_main(argv: List[str]) -> int:
    """``python -m bevy_ggrs_tpu_torch.relay.tree '<json-config>'`` — one relay
    tier member: UDP serve socket + optional UDP uplink to a parent,
    line-JSON control over stdin (status / retarget / drain / shutdown)
    and status events over stdout — the ProcFleet control-plane idiom."""
    from bevy_ggrs_tpu_torch.state import resolve_device
    from bevy_ggrs_tpu_torch.transport.udp import UdpSocket

    cfg = dict(DEFAULT_RELAY_PROC_CONFIG)
    cfg.update(json.loads(argv[0]))
    resolve_device(cfg["device"])
    use_native = os.environ.get("GGRS_NO_NATIVE", "") != "1"
    serve_sock = UdpSocket(int(cfg["port"]), host="127.0.0.1",
                           use_native=use_native)
    server = RelayServer(
        serve_sock,
        shed_after=float(cfg["shed_after"]),
        degrade_after=int(cfg["degrade_after"]),
    )
    link = None
    link_sock = None
    if cfg["parents"]:
        link_sock = UdpSocket(0, host="127.0.0.1", use_native=use_native)
        link = TierLink(
            link_sock,
            server,
            [tuple(p) for p in cfg["parents"]],
            session_id=int(cfg["session_id"]),
        )

    def emit(**ev) -> None:
        sys.stdout.write(json.dumps(ev) + "\n")
        sys.stdout.flush()

    emit(
        event="ready",
        relay_id=int(cfg["relay_id"]),
        port=serve_sock.local_port(),
        root=not cfg["parents"],
    )

    os.set_blocking(sys.stdin.fileno(), False)
    buf = b""
    running = True
    t0 = _time.monotonic()
    last_status = t0
    tick = 1.0 / float(cfg["tick_hz"])
    next_t = _time.monotonic()
    while running:
        now = _time.monotonic()
        if link is not None:
            link.pump(now)
        server.pump(now)

        try:
            data = os.read(sys.stdin.fileno(), 65536)
            if data:
                buf += data
            else:
                running = False  # EOF: the supervisor went away
        except (BlockingIOError, InterruptedError):
            pass
        except (OSError, ValueError):
            running = False
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if not line.strip():
                continue
            try:
                cmd = json.loads(line)
            except ValueError:
                continue
            op = cmd.get("cmd")
            if op == "shutdown":
                running = False
            elif op == "drain":
                server.draining = True
            elif op == "retarget" and link is not None:
                link.retarget([tuple(p) for p in cmd.get("parents", [])])
                emit(event="retargeted", relay_id=int(cfg["relay_id"]))
            elif op == "status":
                last_status = float("-inf")  # force an immediate beat

        if now - last_status >= float(cfg["status_interval_s"]):
            last_status = now
            cache = server.keyframe_cache
            emit(
                event="status",
                relay_id=int(cfg["relay_id"]),
                subscribers=server.subscriber_count(),
                head=server.stream_head(int(cfg["session_id"])),
                frontier=(link.frontier if link is not None else NULL_FRAME),
                lag_frames=(link.lag_frames() if link is not None else 0),
                failovers=(link.failovers if link is not None else 0),
                cache_hits=cache.hits,
                cache_misses=cache.misses,
                draining=server.draining,
            )
        if cfg["duration_s"] and now - t0 > float(cfg["duration_s"]):
            running = False
        next_t += tick
        pause = next_t - _time.monotonic()
        if pause > 0:
            _time.sleep(pause)
        else:
            next_t = _time.monotonic()

    serve_sock.close()
    if link_sock is not None:
        link_sock.close()
    emit(event="stopped", relay_id=int(cfg["relay_id"]))
    return 0


class RelayProcess:
    """One supervised subprocess relay — ServerProcess pointed at this
    module's child entry."""

    def __init__(self, relay_id: int, config: dict,
                 stderr_path: Optional[str] = None,
                 env: Optional[dict] = None):
        from bevy_ggrs_tpu_torch.fleet.proc import ServerProcess

        self._inner = ServerProcess(
            relay_id, config, stderr_path=stderr_path, env=env,
            module="bevy_ggrs_tpu_torch.relay.tree",
        )
        self.relay_id = int(relay_id)

    def alive(self) -> bool:
        return self._inner.alive()

    def send(self, **cmd) -> bool:
        return self._inner.send(**cmd)

    def poll(self) -> List[dict]:
        return self._inner.poll()

    def kill(self) -> None:
        self._inner.kill()

    def stop(self, timeout: float = 30.0) -> None:
        self._inner.stop(timeout=timeout)


class ProcRelayTier:
    """Parent-side supervisor for an elastic subprocess relay tier under
    one root relay address, implementing the relay-autopilot adapter
    over real UDP children (the ProcFleet shape applied to fan-out
    capacity)."""

    def __init__(
        self,
        root_addr: Tuple[str, int],
        session_id: int = 0,
        base_config: Optional[dict] = None,
        stderr_dir: Optional[str] = None,
        capacity: int = 64,
    ):
        self.root_addr = tuple(root_addr)
        self.session_id = int(session_id)
        self.base_config = dict(base_config or {})
        self.stderr_dir = stderr_dir
        self.capacity = int(capacity)
        self._next_id = itertools.count(1)
        # relay_id -> {"proc", "port", "status", "draining", "parent_id"}
        self.members: Dict[int, dict] = {}
        self.events: List[dict] = []

    def addr_of(self, relay_id: int) -> Optional[Tuple[str, int]]:
        m = self.members.get(relay_id)
        if m is None or m["port"] is None:
            return None
        return ("127.0.0.1", m["port"])

    def spawn_relay(self, wait_ready: bool = True, timeout: float = 15.0) -> Optional[int]:
        relay_id = next(self._next_id)
        cfg = dict(DEFAULT_RELAY_PROC_CONFIG)
        cfg.update(self.base_config)
        cfg.update({
            "relay_id": relay_id,
            "session_id": self.session_id,
            "parents": [list(self.root_addr)],
        })
        stderr_path = (
            os.path.join(self.stderr_dir, f"relay-{relay_id}.stderr.log")
            if self.stderr_dir else None
        )
        proc = RelayProcess(relay_id, cfg, stderr_path=stderr_path)
        member = {
            "proc": proc, "port": None, "status": None,
            "draining": False, "parent_id": None,
        }
        self.members[relay_id] = member
        self.events.append({"event": "spawn", "relay_id": relay_id})
        if wait_ready:
            deadline = _time.monotonic() + timeout
            while member["port"] is None and _time.monotonic() < deadline:
                self.poll()
                if not proc.alive():
                    break
                _time.sleep(0.01)
            if member["port"] is None:
                proc.kill()
                del self.members[relay_id]
                return None
        return relay_id

    def poll(self) -> None:
        for relay_id, m in list(self.members.items()):
            for ev in m["proc"].poll():
                kind = ev.get("event")
                if kind == "ready":
                    m["port"] = int(ev["port"])
                elif kind == "status":
                    m["status"] = ev
                    m["draining"] = bool(ev.get("draining", False))

    def relay_samples(self) -> Dict[int, "object"]:
        from bevy_ggrs_tpu_torch.fleet.autopilot import RelaySample

        self.poll()
        out: Dict[int, object] = {}
        for relay_id, m in self.members.items():
            status = m["status"] or {}
            out[relay_id] = RelaySample(
                relay_id=relay_id,
                tier=1,
                parent_id=0,  # the supervised tier hangs off the root
                subscribers=int(status.get("subscribers", 0)),
                capacity=self.capacity,
                alive=m["proc"].alive(),
                draining=m["draining"],
            )
        return out

    def drain_relay(self, relay_id: int) -> bool:
        m = self.members.get(relay_id)
        if m is None:
            return False
        m["draining"] = True
        self.events.append({"event": "drain", "relay_id": relay_id})
        return m["proc"].send(cmd="drain")

    def retire_relay(self, relay_id: int) -> bool:
        m = self.members.pop(relay_id, None)
        if m is None:
            return False
        m["proc"].stop(timeout=10.0)
        self.events.append({"event": "retire", "relay_id": relay_id})
        return True

    def rehome(self, relay_id: int, new_parent_id: int) -> bool:
        m = self.members.get(relay_id)
        target = self.addr_of(int(new_parent_id))
        if m is None:
            return False
        parents = [list(target)] if target else [list(self.root_addr)]
        self.events.append({
            "event": "rehome", "relay_id": relay_id,
            "parent_id": new_parent_id,
        })
        return m["proc"].send(cmd="retarget", parents=parents)

    def kill_relay(self, relay_id: int) -> bool:
        """Crash lever for chaos drills — SIGKILL, no goodbye."""
        m = self.members.get(relay_id)
        if m is None:
            return False
        m["proc"].kill()
        self.events.append({"event": "kill", "relay_id": relay_id})
        return True

    def close(self) -> None:
        for m in self.members.values():
            m["proc"].stop(timeout=10.0)
        self.members.clear()


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.exit(_relay_child_main(sys.argv[1:]))
