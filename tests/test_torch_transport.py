"""PyTorch port, transports and fault injection against the JAX package's.

The loopback network's seeded latency, jitter and loss deliver the same
datagrams at the same virtual times in both packages; a ``ChaosSocket``
under one plan logs the same faults and sends the same (mangled) bytes; a
plan's JSON is the same string in both; the reliable control sublayer
retransmits and dedups alike; the port's pure-Python ``UdpSocket`` sends
and receives on 127.0.0.1 and refuses the native poller it does not have.
"""

import numpy as np
import pytest

from bevy_ggrs_tpu import chaos as jchaos
from bevy_ggrs_tpu import transport as jtransport
from bevy_ggrs_tpu.session import protocol as jproto
from bevy_ggrs_tpu_torch import chaos as tchaos
from bevy_ggrs_tpu_torch import transport as ttransport
from bevy_ggrs_tpu_torch.session import protocol as tproto

ADDRS = [("peer", 0), ("peer", 1), ("spec", 0)]


def traffic(seed: int, steps: int = 300):
    """A fixed send pattern: per step, a few (src, dst, bytes) datagrams."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        sends = []
        for _ in range(int(rng.randint(0, 4))):
            src, dst = rng.choice(len(ADDRS), 2, replace=False)
            sends.append((ADDRS[src], ADDRS[dst], rng.bytes(int(rng.randint(1, 40)))))
        out.append(sends)
    return out


def play(transport, chaos_pkg, net_kwargs, plan_json=None, steps=300, dt=1 / 60):
    """Run the traffic through one package's loopback network (each socket
    wrapped in a ChaosSocket when a plan is given); returns the delivered
    ``(time, src, dst, bytes)`` sequence, the per-socket fault logs and the
    network's counters."""
    net = transport.LoopbackNetwork(**net_kwargs)
    socks = {}
    for addr in ADDRS:
        sock = net.socket(addr)
        if plan_json is not None:
            plan = chaos_pkg.ChaosPlan.from_json(plan_json)
            sock = chaos_pkg.ChaosSocket(sock, plan, clock=lambda: net.now)
        socks[addr] = sock
    delivered = []
    for sends in traffic(5, steps):
        for src, dst, data in sends:
            socks[src].send_to(data, dst)
        net.advance(dt)
        for addr, sock in socks.items():
            for src, data in sock.receive_all():
                delivered.append((round(net.now, 9), src, addr, data))
    faults = {a: list(getattr(s, "faults", [])) for a, s in socks.items()}
    return delivered, faults, (net.sent, net.dropped)


NETS = [
    {},
    {"latency": 0.04, "jitter": 0.01, "loss": 0.05, "seed": 7},
    {"latency": 0.0, "jitter": 0.05, "loss": 0.3, "seed": 123},
]


@pytest.mark.parametrize("net_kwargs", NETS, ids=["ideal", "lossy", "heavy"])
def test_loopback_delivers_the_same_datagrams(net_kwargs):
    want = play(jtransport, jchaos, net_kwargs)
    got = play(ttransport, tchaos, net_kwargs)
    assert got == want
    assert len(want[0]) > 100


def chaos_plan_json():
    plan = jchaos.ChaosPlan(seed=11, directives=(
        jchaos.LossBurst(0.5, 1.5, rate=0.3),
        jchaos.Reorder(1.0, 3.0, rate=0.4, delay=0.05),
        jchaos.Duplicate(2.0, 3.5, rate=0.3),
        jchaos.Corrupt(3.0, 4.5, rate=0.3),
        jchaos.Partition(4.0, 4.5, src=("peer", 1)),
    ))
    return plan.to_json()


def test_chaos_sockets_log_the_same_faults():
    net = {"latency": 0.02, "jitter": 0.01, "loss": 0.05, "seed": 3}
    want = play(jtransport, jchaos, net, chaos_plan_json())
    got = play(ttransport, tchaos, net, chaos_plan_json())
    assert got[1] == want[1]  # fault logs, socket by socket
    assert got == want  # and the same bytes delivered at the same times
    kinds = {kind for log in want[1].values() for _, kind, _ in log}
    assert kinds == {"loss", "reorder", "duplicate", "corrupt", "partition"}


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_plan_json_round_trip_is_the_same_string(seed):
    peers = (("peer", 0), ("peer", 1))
    text = jchaos.ChaosPlan.generate(seed, 30.0, peers=peers, kill_restart=True,
                                     relay=("relay", 0)).to_json()
    assert tchaos.ChaosPlan.from_json(text).to_json() == text
    assert tchaos.ChaosPlan.generate(seed, 30.0, peers=peers, kill_restart=True,
                                     relay=("relay", 0)).to_json() == text
    assert jchaos.ChaosPlan.from_json(
        tchaos.ChaosPlan.from_json(text).to_json()).to_json() == text


def test_reliable_sublayer_retransmits_and_dedups_alike():
    """Migration frames over a lossy, duplicating wire: both packages'
    ReliableSockets deliver each frame once, with the same counters."""

    def run(transport, proto):
        net = transport.LoopbackNetwork(latency=0.01, loss=0.3, seed=9)
        clock = lambda: net.now  # noqa: E731
        a = transport.ReliableSocket(net.socket("a"), clock=clock, seed=1)
        b = transport.ReliableSocket(net.socket("b"), clock=clock, seed=2)
        got = []
        for i in range(20):
            a.send_to(proto.encode(proto.MigrateChunk(
                nonce=1, frame=i, seq=i, total=20, crc=0, payload=bytes([i]) * 8)), "b")
        for _ in range(400):
            net.advance(0.01)
            for sock in (a, b):
                sock.pump()
                for src, data in sock.receive_all():
                    got.append((src, data))
        counters = [(s.retransmits, s.duplicates_dropped, s.acked, s.gave_up) for s in (a, b)]
        return got, counters

    want = run(jtransport, jproto)
    assert run(ttransport, tproto) == want
    frames = sorted(jproto.decode(d).frame for _, d in want[0])
    assert frames == list(range(20))


def test_udp_socket_sends_and_receives_on_localhost():
    a = ttransport.UdpSocket(0, host="127.0.0.1")
    b = ttransport.UdpSocket(0, host="127.0.0.1")
    try:
        addr_b = ("127.0.0.1", b.local_port())
        wires = [tproto.encode(tproto.ChecksumReport(frame=f, checksum=2**63 + f))
                 for f in range(5)]
        for wire in wires:
            a.send_to(wire, addr_b)
        got = []
        for _ in range(2000):
            got += b.receive_all()
            if len(got) == len(wires):
                break
        assert [data for _, data in got] == wires
        assert {src for src, _ in got} == {("127.0.0.1", a.local_port())}
        assert b.receive_all() == []  # non-blocking when empty
    finally:
        a.close()
        b.close()


def test_udp_socket_refuses_the_native_poller():
    with pytest.raises(NotImplementedError, match="item 3"):
        ttransport.UdpSocket(0, host="127.0.0.1", use_native=True)
