"""P2P crash recovery, the port against the JAX package: checkpoint, die,
restore, re-sync, agree.

The cases of ``tests/test_p2p_resume.py``, each run through one harness by
both packages on the same network seed and input script, on the CPU: a
host restarts from its newest checkpoint with fresh endpoints and re-syncs
with its live peer; a checkpoint taken after a third player died does not
park the restored session in SYNCHRONIZING; a crashed spectator restores
and follows the host, while a stale spectator checkpoint fails loudly; and
a speculating runner survives a restore. Bitwise throughout: every
checkpoint file, the restore's metadata, the frames, each peer's events
(kind by name, address, data), counters, settled checksums and, at the
end, each live peer's ``dumps_runner`` bytes (the spectator's session
state included) equal JAX's.
"""

import hashlib
import types

import numpy as np
import torch

from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.runner import RollbackRunner as JRunner
from bevy_ggrs_tpu.session import PlayerType as JPlayerType
from bevy_ggrs_tpu.session import SessionBuilder as JBuilder
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JLoopback
from bevy_ggrs_tpu.utils import persistence as JP
from bevy_ggrs_tpu.utils.metrics import Metrics as JMetrics
from bevy_ggrs_tpu_torch.models import box_game
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.schedule import PlayerInputs
from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
from bevy_ggrs_tpu_torch.state import checksum, combine64
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork
from bevy_ggrs_tpu_torch.utils import persistence as P
from bevy_ggrs_tpu_torch.utils.metrics import Metrics
from chip_smoke import SUP_DT, sup_keys, sup_settled
from tests.test_torch_supervisor import counters, event_log

MAXPRED = 8
PKGS = {
    "jax": types.SimpleNamespace(
        box=jbox, Runner=JRunner, SpecRunner=JSpecRunner, Builder=JBuilder, Player=JPlayerType,
        Net=JLoopback, P=JP, Metrics=JMetrics, world=lambda n: jbox.make_world(n).commit(),
        device={}),
    "torch": types.SimpleNamespace(
        box=box_game, Runner=RollbackRunner, SpecRunner=SpeculativeRollbackRunner,
        Builder=SessionBuilder, Player=PlayerType, Net=LoopbackNetwork, P=P, Metrics=Metrics,
        world=lambda n: box_game.make_world(n, device="cpu").commit(), device={"device": "cpu"}),
}


class Harness:
    """One package's peers, spectator and checkpoints on one network, and
    the record two packages' runs must share."""

    def __init__(self, pkg, tmp_path, latency, seed):
        self.pkg, self.k = pkg, PKGS[pkg]
        self.net = self.k.Net(latency=latency * SUP_DT, seed=seed)
        self.dir = tmp_path / pkg
        self.dir.mkdir()
        self.record = {"saves": []}

    def runner(self, players=2, metrics=None):
        k = self.k
        return k.Runner(k.box.make_schedule(), k.world(players), max_prediction=MAXPRED,
                        num_players=players, input_spec=k.box.INPUT_SPEC, metrics=metrics,
                        **k.device)

    def spec_runner(self, metrics=None):
        k = self.k
        return k.SpecRunner(k.box.make_schedule(), k.world(2), max_prediction=MAXPRED,
                            num_players=2, input_spec=k.box.INPUT_SPEC, num_branches=16,
                            spec_frames=8, metrics=metrics, **k.device)

    def peer(self, me, players=2, disconnect_timeout=None, spectator=None, runner=None):
        """``(session, runner, metrics)`` for slot ``me``; the session and
        runner share the metrics."""
        k = self.k
        builder = (k.Builder(k.box.INPUT_SPEC).with_num_players(players)
                   .with_max_prediction_window(MAXPRED))
        if disconnect_timeout is not None:
            builder.with_disconnect_timeout(disconnect_timeout)
        for h in range(players):
            builder.add_player(k.Player.local() if h == me else k.Player.remote(("peer", h)), h)
        if spectator is not None:
            builder.add_player(k.Player.spectator(spectator), players)
        metrics = k.Metrics()
        session = builder.start_p2p_session(self.net.socket(("peer", me)),
                                            clock=lambda: self.net.now, metrics=metrics)
        runner = runner(metrics) if runner else self.runner(players, metrics)
        return session, runner, metrics

    def spectator(self):
        session = (self.k.Builder(self.k.box.INPUT_SPEC).with_num_players(2)
                   .start_spectator_session(("peer", 0), self.net.socket(("spec", 0)),
                                            clock=lambda: self.net.now))
        return session, self.runner()

    def save(self, name, runner, session):
        path = str(self.dir / name)
        self.k.P.save_runner(path, runner, session=session)
        with open(path, "rb") as f:
            self.record["saves"].append(hashlib.sha256(f.read()).hexdigest())
        return path

    def restore(self, path, runner, session=None):
        meta = self.k.P.restore_runner(path, runner, session=session)
        self.record.setdefault("meta", []).append(meta)
        return meta

    def finish(self, peers, events=None):
        """The record's end: each live peer's counters, the settled
        checksums, and each runner's ``dumps_runner`` bytes with its
        session's state."""
        rec = self.record
        rec["frames_end"] = [r.frame for _, r, _ in peers]
        rec["counters"] = [counters(m, self.pkg) for *_, m in peers]
        rec["settled"] = sup_settled([s for s, *_ in peers])
        rec["dumps"] = [hashlib.sha256(self.k.P.dumps_runner(r, session=s)).hexdigest()
                        for s, r, _ in peers]
        if events is not None:
            rec["events"] = event_log(events)
        return rec


def tick(session, runner, inputs_for=sup_keys):
    """One render frame of a plain P2P peer of either package."""
    session.poll_remote_clients()
    events = session.events()
    if session.current_state().name != "RUNNING":
        return events
    for h in session.local_player_handles():
        session.add_local_input(h, inputs_for(h, session.current_frame))
    try:
        requests = session.advance_frame()
    except Exception as e:  # either package's PredictionThreshold
        if type(e).__name__ != "PredictionThreshold":
            raise
        return events
    runner.handle_requests(requests, session)
    return events


def tick_spec(spec, spec_run):
    spec.poll_remote_clients()
    if spec.current_state().name != "RUNNING":
        return
    try:
        reqs = spec.advance_frame()
    except Exception as e:
        if type(e).__name__ != "PredictionThreshold":
            raise
        return
    spec_run.handle_requests(reqs, None)


def same_record(port, ref):
    assert port.keys() == ref.keys()
    for key in port:
        assert port[key] == ref[key], key


def host_crash(pkg, tmp_path):
    h = Harness(pkg, tmp_path, 1.5, 21)
    a, b = h.peer(0), h.peer(1)
    events = [[], []]
    for i in range(60):
        h.net.advance(SUP_DT)
        events[0] += tick(*a[:2])
        events[1] += tick(*b[:2])
        if i % 5 == 0 and a[0].current_state().name == "RUNNING":
            ckpt = h.save("host.npz", a[1], a[0])
    h.record["frame_at_crash"] = a[1].frame
    a[0].socket.close()
    del a
    for _ in range(50):
        h.net.advance(SUP_DT)
        events[1] += tick(*b[:2])
    a2 = h.peer(0)
    meta = h.restore(ckpt, a2[1], a2[0])
    h.record["restored"] = (a2[1].frame, a2[0].current_frame)
    ev_a2 = []
    for _ in range(200):
        h.net.advance(SUP_DT)
        ev_a2 += tick(*a2[:2])
        events[1] += tick(*b[:2])
    return h.finish([a2, b], [events[0], ev_a2, events[1]]), meta, (a2, b)


def test_host_crash_restore_resync(tmp_path):
    port, meta, (a2, b) = host_crash("torch", tmp_path)
    ref, _, _ = host_crash("jax", tmp_path)
    same_record(port, ref)
    frame_at_crash = port["frame_at_crash"]
    assert frame_at_crash > 30
    assert port["restored"] == (meta["frame"], meta["frame"]) and meta["frame"] <= frame_at_crash
    before, ev_a2, ev_b = port["events"]
    assert any(k == "NETWORK_INTERRUPTED" for k, *_ in ev_b)
    assert a2[0].current_state().name == "RUNNING"
    assert any(k == "SYNCHRONIZED" for k, *_ in ev_a2)
    assert any(k == "NETWORK_RESUMED" for k, *_ in ev_b)
    assert min(port["frames_end"]) > frame_at_crash
    assert port["settled"] and all(x == y for x, y in port["settled"].values())
    assert not any(k == "DESYNC_DETECTED" for k, *_ in ev_a2 + ev_b)


def dead_keys(handle, frame):
    """``sup_keys``, but handle 2 holds all four keys: a held input the
    dead player's repeat-last prediction keeps, under which its cube keeps
    its velocity. A held key that accelerates would reach box_game's speed
    clamp, where the jitted JAX step's FMAs part it from the port's
    (ROADMAP §3, a limit kept as JAX defines it)."""
    return np.uint8(15) if handle == 2 else sup_keys(handle, frame)


def dead_player(pkg, tmp_path):
    h = Harness(pkg, tmp_path, 1, 4)
    peers = [h.peer(me, players=3, disconnect_timeout=0.3) for me in range(3)]
    for _ in range(30):
        h.net.advance(SUP_DT)
        for s, r, _ in peers:
            tick(s, r, dead_keys)
    for _ in range(40):  # C (handle 2) is gone
        h.net.advance(SUP_DT)
        for s, r, _ in peers[:2]:
            tick(s, r, dead_keys)
    (sa, ra, _), b = peers[:2]
    h.record["dead_before"] = 2 in sa._disconnected
    frozen = np.asarray(sa._queues[2].last_input).tolist()
    ckpt = h.save("abc.npz", ra, sa)
    h.record["crash_frame"] = ra.frame
    sa.socket.close()
    del sa, ra, peers
    h.net.advance(10 * SUP_DT)
    a2 = h.peer(0, players=3, disconnect_timeout=0.3)
    h.restore(ckpt, a2[1], a2[0])
    h.record["dead_after"] = 2 in a2[0]._disconnected
    h.record["frozen"] = (frozen, np.asarray(a2[0]._queues[2].last_input).tolist())
    for _ in range(150):
        h.net.advance(SUP_DT)
        tick(*a2[:2], dead_keys)
        tick(*b[:2], dead_keys)
    h.record["state"] = a2[0].current_state().name
    return h.finish([a2, b])


def test_resume_with_dead_player_does_not_block_sync(tmp_path):
    port = dead_player("torch", tmp_path)
    same_record(port, dead_player("jax", tmp_path))
    assert port["dead_before"] and port["dead_after"]
    frozen, restored = port["frozen"]
    assert frozen == restored == 15
    assert port["state"] == "RUNNING"
    assert port["frames_end"][0] > port["crash_frame"]
    assert port["settled"] and all(x == y for x, y in port["settled"].values())


def spectator_crash(pkg, tmp_path):
    h = Harness(pkg, tmp_path, 1, 8)
    a, b = h.peer(0, spectator=("spec", 0)), h.peer(1)
    spec, spec_run = h.spectator()
    for _ in range(60):
        h.net.advance(SUP_DT)
        tick(*a[:2])
        tick(*b[:2])
        tick_spec(spec, spec_run)
    ckpt = h.save("spec.npz", spec_run, spec)
    h.record["crash_frame"] = spec_run.frame
    spec.socket.close()
    del spec, spec_run
    for _ in range(30):
        h.net.advance(SUP_DT)
        tick(*a[:2])
        tick(*b[:2])
    spec, spec_run = h.spectator()
    h.restore(ckpt, spec_run, spec)
    for _ in range(200):
        h.net.advance(SUP_DT)
        tick(*a[:2])
        tick(*b[:2])
        tick_spec(spec, spec_run)
    h.record["spectator"] = (spec_run.frame, spec.frames_behind_host(),
                             hashlib.sha256(h.k.P.dumps_runner(spec_run, session=spec)).hexdigest())
    return h.finish([a, b]), spec_run


def test_spectator_crash_restore(tmp_path):
    port, spec_run = spectator_crash("torch", tmp_path)
    ref, _ = spectator_crash("jax", tmp_path)
    same_record(port, ref)
    crash_frame = port["crash_frame"]
    frame, behind, _ = port["spectator"]
    assert crash_frame > 20
    assert frame > crash_frame + 20
    assert behind < 60
    # The restored spectator's world equals a straight run of the (fully
    # confirmed) input script.
    sched = box_game.make_schedule()
    oracle = box_game.make_world(2, device="cpu").commit()
    status = torch.zeros(2, dtype=torch.int32)
    for f in range(frame):
        bits = torch.tensor([int(sup_keys(h, f)) for h in range(2)], dtype=torch.uint8)
        oracle = sched(oracle, PlayerInputs(bits, status))
    assert combine64(checksum(spec_run.state)) == combine64(checksum(oracle))


def stale_spectator(pkg, tmp_path):
    h = Harness(pkg, tmp_path, 1, 9)
    a, b = h.peer(0, spectator=("spec", 0)), h.peer(1)
    spec, spec_run = h.spectator()
    ckpt = None
    for _ in range(120):
        h.net.advance(SUP_DT)
        tick(*a[:2])
        tick(*b[:2])
        tick_spec(spec, spec_run)
        if ckpt is None and spec_run.frame > 15:
            ckpt = h.save("stale.npz", spec_run, spec)
    h.record["frame_at_crash"] = spec_run.frame
    spec.socket.close()
    spec, spec_run = h.spectator()
    h.restore(ckpt, spec_run, spec)
    h.record["raised"] = None
    for i in range(400):
        h.net.advance(SUP_DT)
        tick(*a[:2])
        tick(*b[:2])
        try:
            tick_spec(spec, spec_run)
        except Exception as e:  # either package's NotSynchronized
            h.record["raised"] = (i, type(e).__name__, str(e))
            break
    return h.finish([a, b])


def test_spectator_stale_checkpoint_fails_loudly(tmp_path):
    port = stale_spectator("torch", tmp_path)
    same_record(port, stale_spectator("jax", tmp_path))
    assert port["saves"] and port["frame_at_crash"] > 60
    assert port["raised"] is not None, "stale-checkpoint stall was never detected"
    _, name, message = port["raised"]
    assert name == "NotSynchronized" and "unbridgeable gap" in message


def speculative_restore(pkg, tmp_path):
    h = Harness(pkg, tmp_path, 2, 31)
    a, b = h.peer(0, runner=h.spec_runner), h.peer(1)

    def drive(n):
        for _ in range(n):
            h.net.advance(SUP_DT)
            for s, r, _ in (a, b):
                tick(s, r)
                if hasattr(r, "speculate") and s.current_state().name == "RUNNING":
                    r.speculate(s.confirmed_frame(), s)

    drive(60)
    h.record["frame_at_save"] = a[1].frame
    ckpt = h.save("specrun.npz", a[1], a[0])
    a[0].socket.close()
    # Restoring into the live runner drops its pending rollout and log,
    # which describe the world before the restore.
    pending = (a[1]._result is not None, len(a[1]._input_log) > 0)
    h.restore(ckpt, a[1])
    h.record["dropped"] = (pending, a[1]._result is None, len(a[1]._input_log))
    a = h.peer(0, runner=h.spec_runner)
    h.restore(ckpt, a[1], a[0])
    drive(150)
    return h.finish([a, b])


def test_speculative_runner_survives_restore(tmp_path):
    port = speculative_restore("torch", tmp_path)
    same_record(port, speculative_restore("jax", tmp_path))
    assert port["frame_at_save"] > 30
    assert port["dropped"] == ((True, True), True, 0)
    assert port["frames_end"][1] > 100
    assert port["settled"] and all(x == y for x, y in port["settled"].values())
