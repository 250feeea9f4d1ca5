"""PyTorch port, the in-process fleet: ``fleet/balancer.py``.

Held against the JAX package on the same scripted matches:

- the migration frames (types 18-21, inside the reliable sublayer's
  envelopes) and the type-22 heartbeats are the same bytes;
- a match migrates from a JAX ``MatchServer`` to a port ``MatchServer``
  over the loopback wire, and back, and stays bitwise a never-migrated
  port control's;
- a port-only live migration is bitwise and builds nothing;
- failover from an on-disk checkpoint recovers the same matches at the
  same frames with the same checksums as JAX's failover, bitwise an
  uninterrupted control, and builds nothing;
- heartbeat death detection under a control-plane partition decides what
  JAX's decides.
"""

import time

import pytest

from bevy_ggrs_tpu.chaos import BalancerPartition as JPartition
from bevy_ggrs_tpu.chaos import ChaosPlan as JPlan
from bevy_ggrs_tpu.fleet import balancer as jbalancer
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JNet
from bevy_ggrs_tpu_torch.chaos import BalancerPartition, ChaosPlan
from bevy_ggrs_tpu_torch.fleet import balancer as tbalancer
from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
from bevy_ggrs_tpu_torch.utils import build_cache
from bevy_ggrs_tpu_torch.utils.metrics import Metrics
from tests.test_torch_serve_server import inputs_for, make_server, make_synctest, slot_cs

FPS_DT = 1.0 / 60.0
PKG = {"torch": (tbalancer, LoopbackNetwork), "jax": (jbalancer, JNet)}


class Recording:
    """A raw socket that keeps every datagram it sends, in order."""

    def __init__(self, sock):
        self.sock, self.sent = sock, []

    def send_to(self, data, addr):
        self.sent.append((bytes(data), addr))
        self.sock.send_to(data, addr)

    def receive_all(self):
        return self.sock.receive_all()

    def close(self):
        self.sock.close()


def cs_of(bal, mid, pkg):
    pl = bal.placements[mid]
    srv = bal.members[pl.server_id].server
    return srv.groups[pl.handle.group].slots[pl.handle.slot].frame, slot_cs(srv, pl.handle, pkg)


# ---------------------------------------------------------------------------
# Wire bytes
# ---------------------------------------------------------------------------


def migrate_and_beat(pkg):
    """Two servers beating every 4 frames; match 0 migrates at frame 10.
    Returns every datagram sent and the matches' final checksums."""
    balancer, net_cls = PKG[pkg]
    net = net_cls()
    bal = balancer.FleetBalancer(metrics=Metrics(), clock=lambda: net.now)
    socks = []
    for k in range(2):
        hb = Recording(net.socket(("hb", k)))
        mig = Recording(net.socket(("mig", k)))
        socks += [hb, mig]
        srv = make_server(pkg, clock=lambda: net.now, server_id=k, fleet_socket=hb,
                          fleet_addr=("fleet", "bal"), heartbeat_interval=4)
        bal.register(k, srv, addr=("mig", k), sock=mig)
    for m, seed in enumerate((41, 42)):
        bal.place_match(m, make_synctest(pkg), inputs_for(seed), server_id=0)
    bal.place_match(99, make_synctest(pkg), inputs_for(99), server_id=1)
    servers = [bal.members[k].server for k in range(2)]

    def run(n):
        for _ in range(n):
            net.advance(FPS_DT)
            for srv in servers:
                srv.run_frame()

    run(10)
    mig = bal.begin_migration(0, dst_id=1)
    net.advance(0.0)
    assert bal.complete_migration(mig) is not None
    run(6)
    return [s.sent for s in socks], [cs_of(bal, m, pkg) for m in (0, 1, 99)]


def test_migration_and_heartbeat_wire_bytes_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # the record zip's member dates
    mine, theirs = migrate_and_beat("torch"), migrate_and_beat("jax")
    (tsent, tcs), (jsent, jcs) = mine, theirs
    for k, (a, b) in enumerate(zip(tsent, jsent)):
        assert a == b, f"socket {k} sent other bytes"
    # Heartbeats went out, and the migration's offer, chunks and done.
    assert len(tsent[0]) >= 4 and len(tsent[1]) >= 3
    assert tcs == jcs


# ---------------------------------------------------------------------------
# A JAX server and a port server on one wire
# ---------------------------------------------------------------------------


def ship(src_bal, dst_bal, dst_mod, mid, src_id, dst_id, session, inputs):
    """Send match ``mid`` from ``src_bal``'s server to ``dst_bal``'s: the
    source package drains and packs, the destination package reassembles,
    verifies and readmits; ``session`` is the destination package's
    session for the match, at the source's frame."""
    mig = src_bal.begin_migration(mid, dst_id=dst_id)
    epoch = max(mig.epoch, dst_bal._epochs.get(mid, 0) + 1)
    dst_bal._epochs[mid] = epoch
    dst_bal.placements[mid] = dst_mod.Placement(mid, src_id, mig.src_handle, session, inputs)
    dmig = dst_mod.Migration(
        nonce=mig.nonce, match_id=mid, src_id=src_id, dst_id=dst_id,
        src_handle=mig.src_handle, ticket=None, frame=mig.frame, total=mig.total,
        digest=mig.digest, begun_dst_frames=dst_bal.members[dst_id].server.frames_served,
        epoch=mig.epoch)
    src_bal._epochs[mid] = epoch
    return mig, dmig


def test_match_migrates_jax_to_port_and_back_bitwise():
    """Match 7 starts on a JAX server, hops to a port server at frame 10
    and back at frame 20, and ends at frame 30 bitwise a port control that
    never moved. Each balancer wraps its own server's socket in its
    package's reliable sublayer; the other borrows it."""
    net = LoopbackNetwork()
    jsrv = make_server("jax", server_id=0)
    tsrv = make_server("torch", server_id=1)
    ctrl = make_server("torch")
    jbal = jbalancer.FleetBalancer(metrics=Metrics(), clock=lambda: net.now)
    tbal = tbalancer.FleetBalancer(metrics=Metrics(), clock=lambda: net.now)
    jm = jbal.register(0, jsrv, addr=("mig", 0), sock=net.socket(("mig", 0)))
    tm = tbal.register(1, tsrv, addr=("mig", 1), sock=net.socket(("mig", 1)))
    jbal.register(1, tsrv, addr=("mig", 1), sock=tm.sock)
    tbal.register(0, jsrv, addr=("mig", 0), sock=jm.sock)
    jsession = make_synctest("jax")
    jbal.place_match(7, jsession, inputs_for(7), server_id=0)
    jbal.place_match(8, make_synctest("jax"), inputs_for(8), server_id=0)  # a sibling
    tsrv.add_match(make_synctest("torch"), inputs_for(9))  # the port server is busy
    ref = ctrl.add_match(make_synctest("torch"), inputs_for(7))

    def run(n, servers):
        for _ in range(n):
            net.advance(FPS_DT)
            for srv in servers + [ctrl]:
                srv.run_frame()

    run(10, [jsrv, tsrv])
    tsession = make_synctest("torch")
    tsession.load_state_dict(jsession.state_dict())
    _, dmig = ship(jbal, tbal, tbalancer, 7, 0, 1, tsession, inputs_for(7))
    net.advance(0.0)
    handle = tbal.complete_migration(dmig)
    assert handle is not None and not dmig.aborted
    assert tsrv.groups[handle.group].slots[handle.slot].frame == 10
    run(10, [jsrv, tsrv])
    assert slot_cs(tsrv, handle) == slot_cs(ctrl, ref)

    back = make_synctest("jax")
    back.load_state_dict(tsession.state_dict())
    _, jmig = ship(tbal, jbal, jbalancer, 7, 1, 0, back, inputs_for(7))
    net.advance(0.0)
    jhandle = jbal.complete_migration(jmig)
    assert jhandle is not None and not jmig.aborted
    run(10, [jsrv, tsrv])
    assert jsrv.groups[jhandle.group].slots[jhandle.slot].frame == 30
    assert ctrl.groups[ref.group].slots[ref.slot].frame == 30
    assert slot_cs(jsrv, jhandle, "jax") == slot_cs(ctrl, ref)
    assert tbal.migrations_completed == 1 and jbal.migrations_completed == 1


# ---------------------------------------------------------------------------
# The port alone: bitwise and build-free
# ---------------------------------------------------------------------------


def make_fleet(net, ckpt0=None):
    bal = tbalancer.FleetBalancer(metrics=Metrics())
    for k in range(2):
        kw = dict(checkpoint_dir=ckpt0, checkpoint_interval=6) if k == 0 and ckpt0 else {}
        bal.register(k, make_server(**kw), addr=("mig", k), sock=net.socket(("mig", k)),
                     checkpoint_dir=ckpt0 if k == 0 else None)
    return bal


def test_live_migration_bitwise_and_builds_nothing():
    net = LoopbackNetwork()
    bal = make_fleet(net)
    ref = make_server()
    for m, seed in enumerate((41, 42)):
        bal.place_match(m, make_synctest(), inputs_for(seed), server_id=0)
    refs = [ref.add_match(make_synctest(), inputs_for(seed)) for seed in (41, 42)]
    srv0, srv1 = bal.members[0].server, bal.members[1].server
    bal.place_match(99, make_synctest(), inputs_for(99), server_id=1)
    for _ in range(10):
        for srv in (srv0, srv1, ref):
            srv.run_frame()
    for warm_dst in (0, 1):  # churn paths warm, as in serving
        warm = bal.begin_migration(99, dst_id=warm_dst)
        net.advance(0.0)
        assert bal.complete_migration(warm) is not None
    base = build_cache.compile_counters()
    mig = bal.begin_migration(0, dst_id=1)
    net.advance(0.0)
    handle = bal.complete_migration(mig)
    assert handle is not None and mig.stall_frames == 0
    assert bal.placements[1].server_id == 0
    for _ in range(8):
        for srv in (srv0, srv1, ref):
            srv.run_frame()
    assert build_cache.compile_counters() == base
    assert srv0.cache_size() == 1 and srv1.cache_size() == 1
    for m, r in enumerate(refs):
        pl = bal.placements[m]
        srv = bal.members[pl.server_id].server
        assert srv.groups[pl.handle.group].slots[pl.handle.slot].frame == 18
        assert slot_cs(srv, pl.handle) == slot_cs(ref, r)
    assert bal.migrations_completed == 3 and bal.migrations_aborted == 0

    # A tampered blob digest aborts back to the source, bitwise.
    original = bal.placements[1].handle
    mig = bal.begin_migration(1, dst_id=1)
    mig.digest ^= 1
    net.advance(0.0)
    assert bal.complete_migration(mig) is None and mig.aborted
    assert bal.placements[1].handle == original
    for _ in range(4):
        for srv in (srv0, srv1, ref):
            srv.run_frame()
    assert slot_cs(srv0, original) == slot_cs(ref, refs[1])


# ---------------------------------------------------------------------------
# Failover from a checkpoint
# ---------------------------------------------------------------------------


def failover_run(pkg, tmp_path):
    balancer, net_cls = PKG[pkg]
    net = net_cls()
    ckpt = str(tmp_path / pkg)
    bal = balancer.FleetBalancer(metrics=Metrics())
    for k in range(2):
        kw = dict(checkpoint_dir=ckpt, checkpoint_interval=6) if k == 0 else {}
        bal.register(k, make_server(pkg, **kw), addr=("mig", k),
                     sock=net.socket(("mig", k)), checkpoint_dir=ckpt if k == 0 else None)
    for m, seed in enumerate((51, 52)):
        bal.place_match(m, make_synctest(pkg), inputs_for(seed), server_id=0)
    srv0, srv1 = bal.members[0].server, bal.members[1].server
    bal.place_match(99, make_synctest(pkg), inputs_for(99), server_id=1)
    for _ in range(12):  # checkpoints at frames 6 and 12
        srv0.run_frame()
        srv1.run_frame()
    for warm_dst in (0, 1):
        warm = bal.begin_migration(99, dst_id=warm_dst)
        net.advance(0.0)
        assert bal.complete_migration(warm) is not None
    bal.place_match(2, make_synctest(pkg), inputs_for(53), server_id=0)  # after the save
    for _ in range(2):
        srv0.run_frame()
    base = build_cache.compile_counters()
    recovered = bal.failover(0)
    at = [(m, sid, srv1.groups[h.group].slots[h.slot].frame) for m, sid, h in recovered]
    for _ in range(8):
        srv1.run_frame()
    out = dict(recovered=sorted(at), lost=bal.matches_lost,
               cs=[cs_of(bal, m, pkg) for m in (0, 1)],
               counters=(bal.metrics.counters["fleet_matches_recovered"],
                         bal.metrics.counters["fleet_matches_lost"]))
    if pkg == "torch":
        assert build_cache.compile_counters() == base
        assert srv1.cache_size() == 1
    return out


def test_failover_from_checkpoint_equals_jax_and_is_bitwise(tmp_path):
    mine, theirs = failover_run("torch", tmp_path), failover_run("jax", tmp_path)
    assert mine == theirs
    assert mine["recovered"] == [(0, 1, 12), (1, 1, 12)] and mine["lost"] == 1
    # Bitwise an uninterrupted control at frame 20.
    ref = make_server()
    refs = [ref.add_match(make_synctest(), inputs_for(seed)) for seed in (51, 52)]
    for _ in range(20):
        ref.run_frame()
    assert mine["cs"] == [(20, slot_cs(ref, r)) for r in refs]


# ---------------------------------------------------------------------------
# Heartbeats: liveness and the partition discipline
# ---------------------------------------------------------------------------


def death_run(pkg):
    balancer, net_cls = PKG[pkg]
    partition, plan_cls = (BalancerPartition, ChaosPlan) if pkg == "torch" \
        else (JPartition, JPlan)
    net = net_cls()
    bal = balancer.FleetBalancer(
        socket=net.socket(("fleet", "bal")), addr=("fleet", "bal"), heartbeat_timeout=0.5,
        clock=lambda: net.now, plan=plan_cls(1, (partition(0.5, 0.8, 1),)),
        metrics=Metrics())
    servers = []
    for k in range(2):
        srv = make_server(pkg, clock=lambda: net.now, server_id=k,
                          fleet_socket=net.socket(("hb", k)), fleet_addr=("fleet", "bal"),
                          heartbeat_interval=8)
        bal.register(k, srv)
        servers.append(srv)
    dead = []
    for frame in range(110):
        net.advance(FPS_DT)
        for k, srv in enumerate(servers):
            if frame < 70 or k == 1:  # server 0 stops at frame 70
                srv.run_frame()
        bal.pump()
        dead += [(frame, d) for d in bal.check()]
    return dead, bal.metrics.counters["fleet_heartbeats_dropped"], \
        [(m.alive, m.missed_beats) for m in bal.members.values()]


def test_death_detection_equals_jax():
    mine, theirs = death_run("torch"), death_run("jax")
    assert mine == theirs
    dead, dropped, members = mine
    assert [d for _, d in dead] == [0] and dead[0][0] > 70  # never during the partition
    assert dropped > 0 and members[1][0]
