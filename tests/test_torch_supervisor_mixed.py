"""Supervised sessions that mix JAX and port peers, on the CPU.

The two packages' supervisors speak one state-transfer protocol and one
checkpoint format, so a peer of either heals from a donor of the other:
a port victim of a forced desync adopts a JAX donor's ring snapshot and a
JAX victim a port donor's, and a killed and restarted peer rejoins from
the other package's full checkpoint. After each recovery the settled
checksums of every peer are bitwise equal and no desync fires.

The inputs are ``chip_smoke.sup_keys`` (a key every 3 frames), which stays
below box_game's speed clamp, where the jitted JAX step and the port's are
bitwise equal (held keys part them: ``tests/test_torch_p2p_mixed.py``).
"""

import pytest

from bevy_ggrs_tpu_torch.session import protocol as proto
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork

from chip_smoke import sup_kinds, sup_run, sup_settled
from tests.test_torch_supervisor import check_rejoin, kill_restart, make_supervised, shift_translation


@pytest.mark.parametrize("pkgs", [("jax", "jax", "torch"), ("torch", "torch", "jax")],
                         ids=["port_victim_jax_donor", "jax_victim_port_donor"])
def test_victim_heals_from_the_other_package(pkgs):
    net = LoopbackNetwork()
    trio = [make_supervised(net, 3, me, pkg) for me, pkg in enumerate(pkgs)]
    events = [[], [], []]
    sup_run(net, trio, 40, events)
    assert all(s.current_state().name == "RUNNING" for s, *_ in trio)
    shift_translation(trio[2][1])
    sup_run(net, trio, 120, events)
    sup_run(net, trio, 80, events)

    victim = trio[2]
    assert victim[3].counters["quarantines"] == 1
    assert victim[3].counters["recoveries"] == 1
    (recovered,) = sup_kinds(events[2], "RECOVERED")
    assert recovered.data["kind"] == proto.STATE_KIND_RING
    assert recovered.addr == ("peer", 0)  # the donor: the lowest handle of the majority
    assert trio[0][3].counters["state_transfers_served"] >= 1
    assert victim[2].health.name == "HEALTHY"
    tail = {f: row for f, row in sup_settled([s for s, *_ in trio]).items()
            if f > recovered.data["frame"]}
    assert len(tail) >= 3
    for f, row in tail.items():
        assert row[0] == row[1] == row[2], f"frame {f} diverged: {row}"
    for ev in events:
        assert not [e for e in sup_kinds(ev, "DESYNC_DETECTED")
                    if e.data["frame"] > recovered.data["frame"]]
    assert all(r.frame > 150 for _, r, *_ in trio)


@pytest.mark.parametrize("pkgs", [("jax", "torch"), ("torch", "jax")],
                         ids=["port_rejoins_from_jax", "jax_rejoins_from_port"])
def test_restarted_peer_rejoins_from_the_other_package(pkgs):
    net = LoopbackNetwork()
    a, b2, ev_a, frame_at_restart = kill_restart(net, pkgs)
    check_rejoin(a, b2, ev_a, frame_at_restart)
    assert a[3].counters["peer_disconnects"] == 1
    assert not sup_kinds(ev_a, "DESYNC_DETECTED")
