"""PyTorch port, the relay tree: ``relay/tree.py`` and the relay
autopilot, held against the JAX package.

- A depth-2 tree (root, two mids, a leaf under mid 0) carries a real
  match's stream to spectators at every tier through a scripted mid-tier
  kill under spectator loss and reorder: the orphaned leaf re-homes, a
  replacement spawns, and every spectator ends bitwise the publisher and a
  serial replay. Every number of the run equals JAX's.
- The shared keyframe cache serves cold joins, refuses a corrupted entry
  by digest and forgets a reset stream with the same bytes as JAX's.
- The relay autopilot's elastic arc over an in-process tree decides and
  records what JAX's does, and each package verifies the other's ledger.
- The ops report renders the port's real ``fleet_rows()`` and
  ``topology_rows()`` into the HTML JAX renders for them.
- One subprocess relay (``python -m bevy_ggrs_tpu_torch.relay.tree``) on
  ``"cpu"`` streams bitwise over real UDP and drains; it runs the port's
  module and loads no JAX.
"""

import importlib
import json
import os
import time
import zlib

import pytest

from bevy_ggrs_tpu.fleet import autopilot as jap
from bevy_ggrs_tpu.fleet.balancer import FleetBalancer as JBalancer
from bevy_ggrs_tpu.obs.report import build_report as jreport
from bevy_ggrs_tpu_torch.fleet import autopilot as tap
from bevy_ggrs_tpu_torch.fleet.balancer import FleetBalancer
from bevy_ggrs_tpu_torch.obs.report import build_report
from bevy_ggrs_tpu_torch.relay import RelayServer, StreamSpectator, payload_digest
from bevy_ggrs_tpu_torch.relay.stream import CHUNK_PAYLOAD
from bevy_ggrs_tpu_torch.relay.tree import ProcRelayTier
from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.transport.udp import UdpSocket
from bevy_ggrs_tpu_torch.utils.metrics import Metrics
from tests.test_torch_p2p import FPS_DT
from tests.test_torch_relay import (
    FakeSocket,
    make_relay_peer,
    ns,
    serial_bytes,
    settled_checksums,
    sup_step,
)

SESSION = 7
ROOT = ("relay", 0)


def tree_ns(pkg):
    p = ns(pkg)
    root = "bevy_ggrs_tpu_torch" if pkg == "torch" else "bevy_ggrs_tpu"
    p.tree = importlib.import_module(f"{root}.relay.tree")
    p.ap = tap if pkg == "torch" else jap
    return p


def tree_fixture(p, net, mids, server_kwargs=None, max_depth=2):
    tree = p.tree.RelayTree(net.socket, session_id=SESSION, clock=lambda: net.now,
                            max_depth=max_depth, metrics_factory=lambda addr: p.Metrics(),
                            server_kwargs=server_kwargs or {})
    tree.add_relay(addr=ROOT)
    mid_nodes = [tree.add_relay(parent=ROOT) for _ in range(mids)]
    peers = [make_relay_peer(p, net, 2, me, [ROOT]) for me in range(2)]
    pub = p.relay.StatePublisher(peers[0][0], peers[0][1], socket=peers[0][0].socket,
                                 keyframe_interval=10, max_frames_per_publish=1)
    return tree, mid_nodes, peers, pub


# ---------------------------------------------------------------------------
# Depth 2, a mid-tier kill
# ---------------------------------------------------------------------------


def tree_kill_run(pkg):
    p = tree_ns(pkg)
    net = p.Net()
    tree, (mid0, mid1), peers, pub = tree_fixture(p, net, 2, dict(shed_after=5.0))
    leaf = tree.add_relay(parent=mid0.addr)
    assert leaf.tier == 2 and tree.depth() == 2
    c = p.chaos
    plan = c.ChaosPlan(91, (c.Reorder(1.0, 2.2, 0.2, delay=0.03),
                            c.RelayTreeKill(2.6, mid0.addr, 0.5)))
    spec_plan = c.ChaosPlan(92, (c.LossBurst(1.2, 2.4, 0.25),))
    kill = plan.relay_tree_kills()[0]
    codec = p.relay.StateCodec.for_state(p.world(2))
    specs = [p.relay.StreamSpectator(
        c.ChaosSocket(net.socket(("spec", i)), spec_plan, clock=lambda: net.now,
                      addr=("spec", i)),
        relays=[target], session_id=SESSION, window=8, codec=codec, clock=lambda: net.now,
        resub_timeout=0.6, metrics=p.Metrics())
        for i, target in enumerate([mid0.addr, leaf.addr, mid1.addr])]
    authoritative, checked = {}, [0, 0, 0]
    killed = respawned = False
    rehomed, events = [], []
    for _ in range(int(4.5 / FPS_DT)):
        net.advance(FPS_DT)
        if not killed and net.now >= kill.at:
            rehomed = tree.kill(mid0.addr)
            killed = True
            specs[0].retarget([mid1.addr], now=net.now)
        if killed and not respawned and net.now >= kill.at + kill.down_for:
            assert tree.spawn_relay()
            respawned = True
        tree.pump(net.now)
        for peer in peers:
            sup_step(p, net, peer, events)
        before = pub.published_frames
        pub.publish(net.now)
        if pub.published_frames > before:
            authoritative[pub._prev_frame] = pub._prev
        for i, spec in enumerate(specs):
            prev = spec.current_frame
            spec.poll(net.now)
            if spec.current_frame != prev and spec.current_frame in authoritative:
                assert spec.state_bytes == authoritative[spec.current_frame], (pkg, i)
                checked[i] += 1
    for _ in range(30):  # the stream flushes down the tree
        net.advance(FPS_DT)
        tree.pump(net.now)
        for session, *_ in peers:
            session.poll_remote_clients()
        pub.publish(net.now)
        for spec in specs:
            spec.poll(net.now)
    return dict(
        rehomed=rehomed, leaf=(leaf.parent, leaf.tier, leaf.link.retargets),
        tree_events=[e["event"] for e in tree.events],
        topology=tree.topology_rows(),
        events=sorted(set(events)),
        settled=settled_checksums([s for s, *_ in peers]),
        specs=[(s.current_frame, s.frames_behind(), s.failovers, s.keyframes_applied,
                s.deltas_applied, s.state_bytes) for s in specs],
        checked=checked, head=(pub._prev_frame, pub._prev),
        truth=serial_bytes(p, codec, 2, pub._prev_frame),
    ), (mid0.addr, mid1.addr, leaf.addr)


def test_depth2_tree_through_a_midtier_kill_equals_jax():
    (mine, addrs), (theirs, _) = tree_kill_run("torch"), tree_kill_run("jax")
    assert mine == theirs
    mid0, mid1, leaf = addrs
    assert mine["rehomed"] == [leaf] and mine["leaf"] == (mid1, 2, 1)
    assert "kill" in mine["tree_events"] and "rehome" in mine["tree_events"]
    assert "DESYNC_DETECTED" not in mine["events"] and "DISCONNECTED" not in mine["events"]
    assert all(len(set(row)) == 1 for _, row in mine["settled"]) and len(mine["settled"]) >= 3
    head_frame, head_bytes = mine["head"]
    assert head_bytes == mine["truth"]
    for i, (frame, behind, *_, state) in enumerate(mine["specs"]):
        assert frame == head_frame and behind == 0 and state == head_bytes, i
        assert mine["checked"][i] >= 60


# ---------------------------------------------------------------------------
# The shared keyframe cache
# ---------------------------------------------------------------------------


def kf_raws(frame, data):
    digest = payload_digest(data)
    chunks = [data[i:i + CHUNK_PAYLOAD] for i in range(0, len(data), CHUNK_PAYLOAD)] or [b""]
    return [proto.encode(proto.StreamKeyframe(frame, seq, len(chunks),
                                              zlib.crc32(c) & 0xFFFFFFFF, digest, c))
            for seq, c in enumerate(chunks)]


def cache_run(pkg):
    p = tree_ns(pkg)
    sock = FakeSocket(addr=("relay", 9))
    relay = p.relay.RelayServer(sock, clock=lambda: 0.0, metrics=p.Metrics())
    data = bytes(range(256)) * 10 + b"\x55" * 40
    digest = payload_digest(data)
    for raw in kf_raws(40, data):
        assert relay.ingest(SESSION, raw)

    def cold_join(addr):
        sock.inbox.append((addr, proto.encode(proto.Subscribe(SESSION, -1, 8))))
        relay.pump(0.0)

    for i in range(4):
        cold_join(("s", i))
    entry = relay.keyframe_cache._entries[digest]
    raw0 = bytearray(entry["chunks"][0])
    raw0[-1] ^= 0xFF
    entry["chunks"][0] = bytes(raw0)
    cold_join(("s", 4))
    healed = relay.keyframe_cache.lookup(digest) is not None
    relay.reset_stream(SESSION)
    emptied = len(relay.keyframe_cache)
    new = b"\xaa" * 2600
    for raw in kf_raws(50, new):
        relay.ingest(SESSION, raw)
    cold_join(("s", 5))
    cache = p.server.KeyframeCache(capacity=2)
    for i, d in enumerate([b"a" * 40, b"b" * 40, b"c" * 40]):
        cache.put(payload_digest(d), i, kf_raws(i, d))
    return dict(sent=sock.sent, counters=dict(relay.metrics.counters),
                cache=(relay.keyframe_cache.hits, relay.keyframe_cache.misses,
                       relay.keyframe_cache.corrupt, healed, emptied,
                       payload_digest(new) in relay.keyframe_cache),
                fifo=(len(cache), payload_digest(b"a" * 40) in cache,
                      cache.lookup(payload_digest(b"c" * 40)) is not None))


def test_keyframe_cache_equals_jax():
    mine, theirs = cache_run("torch"), cache_run("jax")
    assert mine == theirs
    hits, misses, corrupt, healed, emptied, repopulated = mine["cache"]
    assert misses >= 1 and hits >= 3 and corrupt == 1 and healed
    assert emptied == 0 and repopulated
    assert mine["fifo"] == (2, False, True)


# ---------------------------------------------------------------------------
# The relay autopilot
# ---------------------------------------------------------------------------


def relay_arc(pkg, path):
    p = tree_ns(pkg)
    net = p.Net()
    tree, (mid0,), peers, pub = tree_fixture(p, net, 1, dict(shed_after=0.4), max_depth=1)
    tree.fanout_capacity = 2
    pilot = p.ap.RelayAutopilot(tree, p.ap.RelayAutopilotConfig(
        high_watermark=0.8, low_watermark=0.4, confirm_beats=3, cooldown_scale_ticks=10,
        min_relays=1, max_relays=3), metrics=p.Metrics())
    codec = p.relay.StateCodec.for_state(p.world(2))
    specs = [p.relay.StreamSpectator(net.socket(("load", i)), relays=[mid0.addr],
                                     session_id=SESSION, window=8, codec=codec,
                                     clock=lambda: net.now, resub_timeout=0.6)
             for i in range(2)]
    for t in range(150):
        net.advance(FPS_DT)
        tree.pump(net.now)
        for peer in peers:
            sup_step(p, net, peer, [])
        pub.publish(net.now)
        for s in (specs if t < 60 else []):
            s.poll(net.now)
        pilot.step(t)
    pilot.export_jsonl(path)
    return [a.kind for a in pilot.actions], dict(pilot.counts), tree.live_relays()


def test_relay_autopilot_arc_equals_jax(tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in ("torch", "jax")}
    mine, theirs = relay_arc("torch", paths["torch"]), relay_arc("jax", paths["jax"])
    assert mine == theirs
    assert {"relay_spawn", "relay_drain", "relay_retire"} <= set(mine[0])
    ledger = open(paths["torch"], "rb").read()
    assert ledger == open(paths["jax"], "rb").read()
    assert tap.verify_relay_ledger(paths["jax"]) == (True, 150)
    assert jap.verify_relay_ledger(paths["torch"]) == (True, 150)
    assert tap._main([paths["jax"]]) == 0
    lines = ledger.decode().splitlines()
    k = next(i for i, line in enumerate(lines[1:], 1) if json.loads(line)["actions"])
    rec = json.loads(lines[k])
    rec["actions"] = []
    lines[k] = json.dumps(rec)
    tampered = tmp_path / "tampered.jsonl"
    tampered.write_text("\n".join(lines) + "\n")
    assert tap.verify_relay_ledger(str(tampered))[0] is False
    assert jap.verify_relay_ledger(str(tampered))[0] is False


# ---------------------------------------------------------------------------
# The ops report's fleet and tree tables
# ---------------------------------------------------------------------------


class StubServer:
    """The server surface ``fleet_rows`` reads when a member has no
    heartbeat yet."""

    def __init__(self, sid):
        self.sid = sid

    def heartbeat(self):
        return proto.FleetHeartbeat(self.sid, 0, 1, 3, 0, 0)


def test_report_renders_real_fleet_and_tree_rows_as_jax():
    bal = FleetBalancer()
    a = bal.register(0, StubServer(0))
    a.info = proto.FleetHeartbeat(0, 0, 3, 1, 1, 2, 640, 210)
    bal.register(1, StubServer(1))
    bal.register(2, StubServer(2)).alive = False
    bal.set_draining(1)
    p = tree_ns("torch")
    net = p.Net()
    tree, mids, _, _ = tree_fixture(p, net, 2)
    tree.add_relay(parent=mids[0].addr)
    fleet, topo = bal.fleet_rows(), tree.topology_rows()
    assert [r["tier"] for r in topo] == [0, 1, 1, 2] and len(fleet) == 3
    jbal = JBalancer()
    jm = jbal.register(0, StubServer(0))
    jm.info = a.info
    jbal.register(1, StubServer(1))
    jbal.register(2, StubServer(2)).alive = False
    jbal.set_draining(1)
    assert fleet == jbal.fleet_rows()
    mine = build_report(fleet=fleet, relay_tree=topo, title="fleet and tree")
    theirs = jreport(fleet=fleet, relay_tree=topo, title="fleet and tree")
    assert mine == theirs
    assert "Relay tree" in mine and "tier 2" in mine and "spec hit" in mine


# ---------------------------------------------------------------------------
# A subprocess relay
# ---------------------------------------------------------------------------


def test_subprocess_relay_streams_and_drains_on_the_cpu(tmp_path):
    root_sock = UdpSocket(0, host="127.0.0.1", use_native=False)
    root = RelayServer(root_sock, metrics=Metrics())
    state = bytes(range(256)) * 12  # 3 chunks
    for raw in kf_raws(30, state):
        root.ingest(0, raw)
    tier = ProcRelayTier(("127.0.0.1", root_sock.local_port()),
                         base_config={"status_interval_s": 0.1, "device": "cpu"},
                         stderr_dir=str(tmp_path))
    try:
        rid = tier.spawn_relay(timeout=60.0)
        assert rid is not None, (tmp_path / "relay-1.stderr.log").read_text()
        proc = tier.members[rid]["proc"]._inner.proc
        assert proc.args[:3] == [proc.args[0], "-m", "bevy_ggrs_tpu_torch.relay.tree"]
        loaded = open(f"/proc/{proc.pid}/maps").read() if os.path.exists(
            f"/proc/{proc.pid}/maps") else ""
        assert "jaxlib" not in loaded and "libjax" not in loaded
        spec_sock = UdpSocket(0, host="127.0.0.1", use_native=False)
        spec = StreamSpectator(spec_sock, relays=[tier.addr_of(rid)], session_id=0,
                               resub_timeout=2.0)
        deadline = time.monotonic() + 30.0
        while spec.state_bytes is None and time.monotonic() < deadline:
            root.pump()
            spec.poll()
            time.sleep(0.01)
        assert spec.state_bytes == state and spec.current_frame == 30
        assert tier.relay_samples()[rid].alive and tier.drain_relay(rid)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and not tier.relay_samples()[rid].draining:
            time.sleep(0.05)
        assert tier.relay_samples()[rid].draining
        spec_sock.close()
    finally:
        tier.close()
        root.close()
    assert [e["event"] for e in tier.events][:2] == ["spawn", "drain"]
