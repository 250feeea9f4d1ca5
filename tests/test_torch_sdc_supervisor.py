"""Silent corruption under the port's supervisor, on the CPU.

The supervisor cases of ``tests/test_sdc.py`` on the port: a ring bit
flipped under a supervised peer is caught by the periodic attestation,
repaired in place bitwise (a typed ``STATE_FAULT`` event, no quarantine,
no desync); a ring corrupted beyond local repair escalates to a donor
transfer and heals. Both run through one harness in each package, and
their events, ``STATE_FAULT`` data, counters and settled checksums equal
JAX's. And the disk rung: a bit flipped in the newest checkpoint file makes
``CheckpointManager.restore_latest`` fall back to the one before.
"""

import shutil

import numpy as np

from bevy_ggrs_tpu import integrity as jintegrity
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JLoopback
from bevy_ggrs_tpu.utils import persistence as JP
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork
from bevy_ggrs_tpu_torch.utils import persistence as P

from tests.test_torch_persistence import drive, make_pair
from chip_smoke import sup_kinds, sup_run, sup_settled
from tests.test_torch_supervisor import counters, event_log, make_supervised


def keys(h, f):
    return np.uint8((f // 3 + h) % 4)


def occupied_frames(ring):
    return sorted(int(f) for f in np.asarray(ring.frames).ravel() if f >= 0)


def heal_in_place(pkg, net, flip):
    peers = [make_supervised(net, 2, me, pkg) for me in range(2)]
    for _, _, sup, _ in peers:
        sup.attest_interval = 4
    sup_run(net, peers, 60, inputs_for=keys)
    session, runner, sup, metrics = peers[0]
    assert session.current_state().name == "RUNNING"
    occ = occupied_frames(runner.ring)
    runner.ring, info = flip(runner.ring, occ[len(occ) // 2] % runner.ring.depth,
                             np.random.RandomState(21))
    events = [[], []]
    sup_run(net, peers, 90, events, inputs_for=keys)
    return peers, events[0], info


def test_supervisor_attests_heals_in_place_and_emits_typed_event():
    peers, events, info = heal_in_place("torch", LoopbackNetwork(), integrity.flip_ring_bit)
    jpeers, jevents, jinfo = heal_in_place("jax", JLoopback(), jintegrity.flip_ring_bit)
    assert info == jinfo
    sdc = sup_kinds(events, "STATE_FAULT")
    assert [e.data for e in sdc] == [e.data for e in sup_kinds(jevents, "STATE_FAULT")]
    assert event_log([events]) == event_log([jevents])
    assert [counters(p[3]) for p in peers] == [counters(p[3], "jax") for p in jpeers]

    session, runner, sup, metrics = peers[0]
    assert len(sdc) >= 1
    assert sdc[0].data["reason"] == "sdc"
    assert sdc[0].data["repaired"] is True
    assert sdc[0].data["bitwise"] is True
    assert sdc[0].data["field"] == info["field"]
    assert metrics.counters["sdc_faults"] >= 1
    assert sup.health.name == "HEALTHY"
    assert metrics.counters.get("quarantines", 0) == 0
    assert metrics.counters.get("desyncs_detected", 0) == 0
    settled = sup_settled([peers[0][0], peers[1][0]])
    assert settled == sup_settled([jpeers[0][0], jpeers[1][0]])
    assert settled and all(r[0] == r[1] for r in settled.values())


def escalate(pkg, net, flip):
    """Every occupied row of peer 0's ring flipped: beyond local repair."""
    peers = [make_supervised(net, 2, me, pkg) for me in range(2)]
    for _, _, sup, _ in peers:
        sup.attest_interval = 4
    sup_run(net, peers, 60, inputs_for=keys)
    runner = peers[0][1]
    rng = np.random.RandomState(23)
    flipped = []
    for f in occupied_frames(runner.ring):
        runner.ring, info = flip(runner.ring, f % runner.ring.depth, rng)
        flipped.append(info)
    events = [[], []]
    sup_run(net, peers, 240, events, inputs_for=keys)
    return peers, events, flipped


def test_supervisor_escalates_unrepairable_to_donor_transfer():
    peers, events, flipped = escalate("torch", LoopbackNetwork(), integrity.flip_ring_bit)
    jpeers, jevents, jflipped = escalate("jax", JLoopback(), jintegrity.flip_ring_bit)
    assert flipped == jflipped
    faults = sup_kinds(events[0], "STATE_FAULT")
    assert [e.data for e in faults] == [e.data for e in sup_kinds(jevents[0], "STATE_FAULT")]
    assert event_log(events) == event_log(jevents)
    assert [counters(p[3]) for p in peers] == [counters(p[3], "jax") for p in jpeers]
    settled = sup_settled([peers[0][0], peers[1][0]])
    assert settled == sup_settled([jpeers[0][0], jpeers[1][0]])
    assert [r.frame for _, r, *_ in peers] == [r.frame for _, r, *_ in jpeers]

    session, runner, sup, metrics = peers[0]
    assert metrics.counters["sdc_escalations"] >= 1
    assert metrics.counters["recoveries"] >= 1
    assert any(e.data["repaired"] is False for e in faults)
    assert sup.health.name in ("HEALTHY", "DEGRADED")
    assert sup.health.name == jpeers[0][2].health.name
    assert session.current_state().name == "RUNNING"
    assert settled and all(r[0] == r[1] for r in settled.values())


def flip_outcomes(tmp_path, seeds):
    """For each seed, a bit flipped in the newest of two checkpoints (frames
    10 and 20) and ``restore_latest`` run by each package: the frame it
    restored, or the exception it raised."""
    session, runner = make_pair()
    base = tmp_path / "base"
    mgr = P.CheckpointManager(str(base), interval=10, keep=2)
    for _ in range(20):
        drive(session, runner, 1, seed_base=runner.frame)
        mgr.maybe_save(runner, session=session)
    good = ts.combine64(ts.checksum(runner.state))
    out = []
    for seed in seeds:
        d = tmp_path / f"s{seed}"
        shutil.copytree(base, d)
        integrity.flip_file_bit(str(d / "ckpt_20.npz"), np.random.RandomState(seed))
        got = {}
        for pkg, mod in (("torch", P), ("jax", JP)):
            s2, r2 = make_pair(pkg)
            try:
                mod.CheckpointManager(str(d), interval=10, keep=2).restore_latest(r2, session=s2)
                got[pkg] = r2.frame
                if pkg == "torch" and r2.frame == 20:
                    # A flip no reader looks at (a zip header field): the
                    # newest world, intact.
                    assert ts.combine64(ts.checksum(r2.state)) == good
            except Exception as e:
                got[pkg] = type(e).__name__
        out.append(got)
    return out


def test_corrupt_checkpoint_falls_back_to_the_one_before(tmp_path):
    outcomes = flip_outcomes(tmp_path, range(12))
    assert all(o["torch"] in (10, 20) for o in outcomes), outcomes
    assert sum(o["torch"] == 10 for o in outcomes) >= 6, outcomes
    # JAX's manager catches ValueError, OSError and KeyError only: a flip
    # in the compressed data escapes its restore_latest as the zip's CRC
    # error (BadZipFile) or inflate's (zlib.error).
    assert any(o["jax"] in ("BadZipFile", "error") for o in outcomes), outcomes
    assert all(o["torch"] == 10 for o in outcomes if o["jax"] in ("BadZipFile", "error"))
