"""PyTorch port, the process fleet: ``fleet/proc.py`` on the CPU.

Two ``python -m bevy_ggrs_tpu_torch.fleet.proc`` children on ``"cpu"``,
each with a stderr file, run one lifecycle: admissions over the control
plane, heartbeats over real UDP, a live migration between the children
over real UDP, a SIGKILL, heartbeat-timeout death detection and the
parent's checkpoint re-pack onto the survivor. No match is lost, no child
builds or prepares anything after its compile baseline, and each child
runs the port's module and loads no JAX. (The same scenario runs on the
card in ``chip_smoke.py``'s phase 18.) Phase 18's in-process fleet and relay
legs run here at their small sizes.
"""

import os
import time

import pytest

import chip_smoke
from bevy_ggrs_tpu_torch import ops
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.fleet.proc import DEFAULT_CONFIG, ProcFleet
from bevy_ggrs_tpu_torch.ops import checksum as tck

BASE = {
    "fps": 60,  # paced: free-running children would take whole cores from other tests
    "heartbeat_interval": 8,
    "status_interval": 20,
    "checkpoint_interval": 40,
    "device": "cpu",
}


def pump_until(fleet, pred, timeout=60.0, msg=""):
    deadline = time.time() + timeout
    while time.time() < deadline:
        fleet.pump()
        if pred():
            return
        time.sleep(0.03)
    logs = {sid: _tail(m.process) for sid, m in fleet.members.items()}
    pytest.fail(f"timed out waiting for: {msg}; child stderr: {logs}")


def _tail(proc):
    path = getattr(proc._stderr, "name", None)
    if not path or not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return f.read()[-2000:].decode(errors="replace")


def match_frames(fleet, sid):
    st = fleet.members[sid].status or {}
    return {int(k): v for k, v in st.get("matches", {}).items()}


def test_default_child_serves_on_the_card():
    assert DEFAULT_CONFIG["device"] is None  # None = cuda, raising without a GPU


def test_proc_fleet_migrates_and_fails_over_on_the_cpu(tmp_path):
    fleet = ProcFleet(str(tmp_path), base_config=BASE, heartbeat_timeout=2.0)
    try:
        a = fleet.spawn_server(wait_ready=True, timeout=120.0)
        b = fleet.spawn_server(wait_ready=True, timeout=120.0)
        for sid in (a, b):
            proc = fleet.members[sid].process.proc
            assert proc.args[1:3] == ["-m", "bevy_ggrs_tpu_torch.fleet.proc"]
            with open(f"/proc/{proc.pid}/maps") as f:
                maps = f.read()
            assert "jaxlib" not in maps and "libjax" not in maps
            assert os.path.exists(tmp_path / f"srv{sid}.stderr.log")
        mids = [31, 32, 33, 34]
        for mid in mids:
            assert fleet.admit(mid, a) == a
        pump_until(fleet, lambda: all(match_frames(fleet, a).get(m, 0) > 5 for m in mids),
                   msg="matches serving")
        for sid in (a, b):  # churn from here on must build nothing
            fleet.members[sid].process.send(cmd="rebase_compiles")

        # A live migration between the children, over real UDP.
        assert fleet.migrate(34, b)
        pump_until(fleet, lambda: fleet.migrations_completed == 1
                   and match_frames(fleet, b).get(34, 0) > 0, msg="migration lands")
        assert fleet.book[34] == b

        # Checkpoint coverage, then SIGKILL the source.
        base_frames = (fleet.members[a].status or {}).get("frames", 0)
        pump_until(fleet, lambda: (fleet.members[a].status or {}).get("frames", 0)
                   > base_frames + 2 * BASE["checkpoint_interval"], msg="checkpoints")
        at_kill = match_frames(fleet, a)
        fleet.members[a].process.kill()
        dead = []
        pump_until(fleet, lambda: bool(dead.extend(fleet.check()) or dead), timeout=15,
                   msg="death detection")
        assert dead == [a]
        initiated = fleet.failover(a, preferred={m: b for m in mids[:3]})
        assert sorted(m for m, _ in initiated) == mids[:3]
        pump_until(fleet, lambda: fleet.matches_recovered + fleet.matches_lost >= 3,
                   msg="failover settles")
        assert fleet.matches_lost == 0 and fleet.matches_recovered == 3
        pump_until(fleet, lambda: all(match_frames(fleet, b).get(m, 0) > at_kill.get(m, 0)
                                      for m in mids[:3]), msg="recovered matches serve on")
        fleet.members[b].process.send(cmd="status")
        pump_until(fleet, lambda: (fleet.members[b].status or {}).get("frames", 0)
                   > 0 and fleet.members[b].status.get("compiles") is not None,
                   msg="status")
        st = fleet.members[b].status
        assert st["faults"] == 0 and st["evictions"] == 0 and st["compiles"] == 0
    finally:
        fleet.close()
    bye = fleet.members[b].status
    assert bye["compiles"] == 0
    assert bye["launches"]["world_checksum"] == 0  # the CPU takes the plain version
    assert not fleet.members[b].process.alive()


def test_chip_smoke_phase_18_legs_on_the_cpu(tmp_path):
    """Phase 18's leg (a), live migrations and a checkpoint failover over a
    loopback fleet, every match bitwise its CPU control; and leg (c), a
    relayed match streamed to spectators at the root and at a depth-2
    tree's leaves, every one bitwise the publisher's ring row."""
    kernels = ops.wrappers()
    fleet = chip_smoke.fleet_inprocess(kernels, ts, tck, "cpu", str(tmp_path),
                                       chip_smoke.FLEET_SMALL)
    assert fleet["migrations"] == 2 and fleet["recovered"] == 1
    assert fleet["matches_lost"] == 0 and not fleet["builds_after_warmup"]
    relay = chip_smoke.relay_leg(kernels, ts, tck, "cpu", chip_smoke.RELAY_SMALL)
    assert relay["spectators_bitwise"] == relay["spectators"] == 12
    assert relay["tree_depth"] == 2 and relay["readbacks"] > relay["published_frames"] > 60


def test_the_parent_records_where_a_burn_window_ends(tmp_path):
    """A child's ``hiccup_armed`` event gives its member the served frame
    at which the burn window ends; the autoscale arc waits for it."""
    from bevy_ggrs_tpu_torch.fleet.proc import _ProcMember

    fleet = ProcFleet(str(tmp_path), base_config=BASE)
    try:
        m = _ProcMember(server_id=0, process=None, checkpoint_dir=None, spawn_t0=0.0)
        assert m.hiccup_end is None
        fleet._handle_event(0, m, {"event": "hiccup_armed", "start": 7, "end": 407,
                                   "every": 3, "ms": 60.0})
        assert m.hiccup_end == 407
    finally:
        fleet.close()
