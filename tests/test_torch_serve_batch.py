"""PyTorch port, batched multi-session serving: ``serve/batch.py``.

Mirrors ``tests/test_batched_sessions.py``: the port's
``BatchedSessionCore`` must give every slot the state bytes, frames and
ring digests of a serial singleton run of its own inputs (heterogeneous
rollback depths, speculative commits, admission and retirement mid-run),
deliver the serial run's checksum reports, reject a non-canonical burst
before touching any slot, and build or prepare nothing through churn
(``utils.build_cache``). The same scripts through the JAX package's core
and the port's give the same state bytes, frames, ring digests and hit
counters (box_game bitwise; boids within the float kernels' tolerance),
on the native data plane and on the Python one (``GGRS_NO_NATIVE=1``).
"""

import numpy as np
import pytest

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.serve.batch import BatchedSessionCore as JCore
from bevy_ggrs_tpu.session import requests as jreq
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.serve.batch import BatchedSessionCore
from bevy_ggrs_tpu_torch.serve.faults import SlotFault
from bevy_ggrs_tpu_torch.session import requests as treq
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
from bevy_ggrs_tpu_torch.utils import build_cache

P = 2
MAXPRED = 4
BRANCHES = 8
SPEC_FRAMES = 3


def requests_of(req, script):
    """A raw script (per tick: load frame or None, [(frame, bits)], confirmed)
    as one package's request lists."""
    out = []
    for load, steps, confirmed in script:
        reqs = [] if load is None else [req.LoadGameState(load)]
        for frame, bits in steps:
            reqs += [req.SaveGameState(frame),
                     req.AdvanceFrame(bits=np.asarray(bits, np.uint8),
                                      status=np.zeros(P, np.int32))]
        out.append((reqs, confirmed))
    return out


def make_script(seed, depth, cycles):
    """Steady confirmed ticks, ``depth`` predicted ticks (the frontier
    stalled), then the canonical recovery tick; a different seed and depth
    per slot: the heterogeneous shape one batched tick must absorb."""
    rng = np.random.RandomState(seed)
    script, frame = [], 0
    for _ in range(cycles):
        for _ in range(3):
            script.append((None, [(frame, rng.randint(0, 16, size=P))], frame))
            frame += 1
        frontier = frame - 1
        pred = rng.randint(0, 16, size=P)
        for d in range(depth):
            script.append((None, [(frame + d, pred)], frontier))
        frame += depth
        corrected = [pred if rng.rand() < 0.5 else rng.randint(0, 16, size=P)
                     for _ in range(depth)]
        steps = [(frame - depth + t, bits) for t, bits in enumerate(corrected)]
        steps.append((frame, rng.randint(0, 16, size=P)))
        script.append((frame - depth, steps, frame))
        frame += 1
    return script


def make_core(num_slots=4, **kw):
    core = BatchedSessionCore(
        tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(), MAXPRED, P,
        tbox.INPUT_SPEC, num_slots=num_slots, num_branches=BRANCHES,
        spec_frames=SPEC_FRAMES, device="cpu", **kw)
    core.warmup()
    return core


def make_singleton(spec=True, **kw):
    args = (tbox.make_schedule(), tbox.make_world(P, device="cpu").commit())
    if spec:
        r = SpeculativeRollbackRunner(*args, max_prediction=MAXPRED, num_players=P,
                                      input_spec=tbox.INPUT_SPEC, num_branches=BRANCHES,
                                      spec_frames=SPEC_FRAMES, device="cpu", **kw)
    else:
        r = RollbackRunner(*args, max_prediction=MAXPRED, num_players=P,
                           input_spec=tbox.INPUT_SPEC, device="cpu")
    r.warmup()
    return r


def assert_slot_equals_runner(core, slot, runner):
    assert core.slots[slot].frame == runner.frame
    assert ts.combine64(ts.checksum(core.slot_state(slot))) == ts.combine64(
        ts.checksum(runner.state))
    assert np.array_equal(core.rings.frames[slot].numpy(), runner.ring.frames.numpy())
    assert np.array_equal(core.rings.checksums[slot].numpy(), runner.ring.checksums.numpy())


def drive(core, scripts, req=treq):
    scripts = {s: requests_of(req, sc) for s, sc in scripts.items()}
    for t in range(max(len(s) for s in scripts.values())):
        core.tick({slot: (sc[t][0], sc[t][1], None)
                   for slot, sc in scripts.items() if t < len(sc)})


def singleton_run(script, spec=True, **kw):
    r = make_singleton(spec=spec, **kw)
    for reqs, confirmed in requests_of(treq, script):
        if spec:
            r.tick(reqs, confirmed, None)
        else:
            r.handle_requests(reqs, None)
    return r


def test_parity_heterogeneous_rollback_depths():
    """Four slots, rollback depths 1..4 with inputs of their own, against
    a speculating singleton's ticks and a plain serial replay."""
    core = make_core(num_slots=4)
    slots = [core.admit() for _ in range(4)]
    scripts = {s: make_script(seed=100 + s, depth=1 + s, cycles=3) for s in slots}
    drive(core, scripts)
    for s in slots:
        assert_slot_equals_runner(core, s, singleton_run(scripts[s]))
        serial = singleton_run(scripts[s], spec=False)
        assert core.slots[s].frame == serial.frame
        assert ts.combine64(ts.checksum(core.slot_state(s))) == ts.combine64(
            ts.checksum(serial.state))


def hit_script():
    script = [(None, [(f, [f % 4, (f + 1) % 4])], f) for f in range(3)]
    script.append((None, [(3, [2, 3])], 2))
    script.append((None, [(4, [2, 3])], 2))
    script.append((3, [(3, [1, 3]), (4, [1, 3]), (5, [1, 3])], 5))
    return script


def test_parity_spec_branches_commit():
    """A speculative commit (the absorb path) stays bitwise the singleton's."""
    core = make_core(num_slots=2, predictor=False)
    slot = core.admit()
    drive(core, {slot: hit_script()})
    assert core.spec_hits >= 1
    assert_slot_equals_runner(core, slot, singleton_run(hit_script(), predictor=False))


def test_parity_with_admit_retire_mid_run():
    """A retired slot's rows are dead weight and a slot admitted mid-run
    starts fresh: neither perturbs the slots that live on."""
    core = make_core(num_slots=3)
    s0, s1 = core.admit(), core.admit()
    sc0 = make_script(seed=7, depth=2, cycles=4)
    sc1 = make_script(seed=8, depth=3, cycles=4)
    half = len(sc1) // 2
    drive(core, {s0: sc0[:half], s1: sc1[:half]})
    core.retire(s0)
    s2 = core.admit()
    sc2 = make_script(seed=9, depth=1, cycles=2)
    drive(core, {s1: sc1[half:], s2: sc2})
    for slot, script in ((s1, sc1), (s2, sc2)):
        assert_slot_equals_runner(core, slot, singleton_run(script))


def test_admit_retire_builds_and_prepares_nothing():
    """After warmup, churn leaves the build counters and the executor's
    shape count as they were."""
    assert build_cache.install_compile_listeners()
    core = make_core(num_slots=4)
    s = core.admit()
    drive(core, {s: make_script(seed=1, depth=2, cycles=1)})
    shapes0 = core._exec.cache_size()
    base = build_cache.compile_counters()
    for k in range(3):
        core.retire(s)
        s = core.admit()
        s2 = core.admit()
        drive(core, {s: make_script(seed=20 + k, depth=1 + k, cycles=1),
                     s2: make_script(seed=30 + k, depth=2, cycles=1)})
        core.extract(s2)
    assert build_cache.compile_counters() == base
    assert core._exec.cache_size() == shapes0 == 1


def test_a_new_tick_structure_is_one_shape_preparation():
    """The batched tick's first run at a structure this process has not
    ticked is one shape preparation in the build counters (JAX compiling
    the vmapped tick); a second core at the same structure adds nothing."""
    base = build_cache.compile_counters()
    make_core(num_slots=11)
    first = build_cache.compile_counters()
    assert first["shape_preparations"] == base["shape_preparations"] + 1
    assert "serve tick S=11 B=8 F=3 cpu" in build_cache.compile_summary()["fingerprints"]
    make_core(num_slots=11)
    assert build_cache.compile_counters() == first


class Log:
    def __init__(self):
        self.seen = {}

    def wants_checksum(self, frame):
        return True

    def report_checksum(self, frame, cs):
        self.seen[frame] = int(cs)


def test_checksum_reports_match_serial():
    core = make_core(num_slots=2)
    slot = core.admit()
    script = make_script(seed=5, depth=2, cycles=2)
    log = Log()
    for reqs, confirmed in requests_of(treq, script):
        core.tick({slot: (reqs, confirmed, log)})
    core.flush_reports()
    oracle, olog = make_singleton(spec=False), Log()
    for reqs, _ in requests_of(treq, script):
        oracle.handle_requests(reqs, olog)
    assert olog.seen and all(log.seen[f] == cs for f, cs in olog.seen.items())


def test_non_standard_burst_rejected():
    core = make_core(num_slots=2)
    slot, other = core.admit(), core.admit()
    before = core.states.components["translation"].clone()
    with pytest.raises(SlotFault) as exc:
        core.tick({other: ([treq.SaveGameState(0), treq.AdvanceFrame(
                              bits=np.zeros(P, np.uint8), status=np.zeros(P, np.int32))], 0, None),
                   slot: ([treq.AdvanceFrame(bits=np.asarray([1, 2], np.uint8),
                                             status=np.zeros(P, np.int32))], 0, None)})
    assert exc.value.slot == slot and exc.value.reason == "non_canonical_burst"
    assert core.slots[other].frame == 0
    assert core.states.components["translation"].equal(before)


# ---------------------------------------------------------------------------
# Port against the JAX package's core
# ---------------------------------------------------------------------------


def jax_core(model, S, **kw):
    if model == "box_game":
        args = (jbox.make_schedule(), jbox.make_world(P).commit(), MAXPRED, P, jbox.INPUT_SPEC)
    else:
        args = (jboids.make_schedule(kernel="xla"), jboids.make_world(16, P).commit(),
                MAXPRED, P, jboids.INPUT_SPEC)
    core = JCore(*args, num_slots=S, num_branches=BRANCHES, spec_frames=SPEC_FRAMES,
                 predictor=False, **kw)
    core.warmup()
    return core


def port_core(model, S):
    if model == "box_game":
        args = (tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(), MAXPRED, P,
                tbox.INPUT_SPEC)
    else:
        args = (tboids.make_schedule(), tboids.make_world(16, P, device="cpu").commit(),
                MAXPRED, P, tboids.INPUT_SPEC)
    core = BatchedSessionCore(*args, num_slots=S, num_branches=BRANCHES,
                              spec_frames=SPEC_FRAMES, predictor=False, device="cpu")
    core.warmup()
    return core


def churn_run(core, req, S, cycles):
    """Slots 0..S-2 play scripts of depths 1..4 (one a hit script); half
    way slot 0 retires and the last slot is admitted fresh."""
    slots = [core.admit() for _ in range(S - 1)]
    scripts = {s: (hit_script() if s == 1 else make_script(200 + s, 1 + s % 4, cycles))
               for s in slots}
    half = 5
    drive(core, {s: sc[:half] for s, sc in scripts.items()}, req)
    core.retire(slots[0])
    last = core.admit()
    scripts.pop(slots[0])
    rest = {s: sc[half:] for s, sc in scripts.items()}
    rest[last] = make_script(300, 2, 1)
    drive(core, rest, req)
    core.scripts = {s: scripts[s] for s in scripts}
    core.scripts[last] = rest[last]
    return core


def snapshot(core, jax_side):
    """frames, states as host arrays, ring frames and digests, counters."""
    if jax_side:
        host = js.to_host(core.states)
        frames = np.asarray(core.rings.frames)
        cs = np.asarray(core.rings.checksums).astype(np.int64)
    else:
        host = ts.to_host(core.states)
        frames = core.rings.frames.numpy()
        cs = core.rings.checksums.numpy()
    active = [s.index for s in core.slots if s.active]
    return dict(slots=active, frames=[core.slots[i].frame for i in active], host=host,
                ring_frames=frames[active], ring_cs=cs[active],
                counters=(core.spec_hits, core.spec_partial_hits, core.spec_misses,
                          core.rollbacks_total, core.rollback_frames_total,
                          core.rollback_frames_recovered_total))


_JAX = {}


def jax_reference(model, S, cycles):
    key = (model, S, cycles)
    if key not in _JAX:
        _JAX[key] = snapshot(churn_run(jax_core(model, S), jreq, S, cycles), True)
    return _JAX[key]


def leaves(host, active):
    out = {}
    for k in ("alive", "rollback_id"):
        out[k] = host[k][active]
    for kind in ("components", "present"):
        for name, arr in host[kind].items():
            out[f"{kind}/{name}"] = arr[active]
    return out


@pytest.mark.parametrize("plane", ["native", "python"])
@pytest.mark.parametrize("model,S,cycles", [("box_game", 8, 2), ("boids", 4, 1)])
def test_port_core_equals_jax_core(monkeypatch, plane, model, S, cycles):
    if plane == "python":
        monkeypatch.setenv("GGRS_NO_NATIVE", "1")
    core = port_core(model, S)
    assert (core._plane is not None) == (plane == "native")
    got = snapshot(churn_run(core, treq, S, cycles), False)
    monkeypatch.delenv("GGRS_NO_NATIVE", raising=False)
    want = jax_reference(model, S, cycles)
    assert got["slots"] == want["slots"] and got["frames"] == want["frames"]
    assert np.array_equal(got["ring_frames"], want["ring_frames"])
    assert got["counters"] == want["counters"]
    a, b = leaves(got["host"], got["slots"]), leaves(want["host"], want["slots"])
    assert a.keys() == b.keys()
    if model == "box_game":
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
        assert np.array_equal(got["ring_cs"], want["ring_cs"])
    else:  # float pair forces: allclose to XLA, as the JAX kernels are
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=k)
    # Each port slot against a serial port replay of its own script,
    # bitwise, whatever the model.
    for slot, script in core.scripts.items():
        if model == "box_game":
            schedule, world = tbox.make_schedule(), tbox.make_world(P, device="cpu")
        else:
            schedule, world = tboids.make_schedule(), tboids.make_world(16, P, device="cpu")
        serial = RollbackRunner(schedule, world.commit(), max_prediction=MAXPRED,
                                num_players=P, input_spec=tbox.INPUT_SPEC, device="cpu")
        for reqs, _ in requests_of(treq, script):
            serial.handle_requests(reqs, None)
        assert_slot_equals_runner(core, slot, serial)
