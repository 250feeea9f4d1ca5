"""PyTorch port, the speculative runner and the speculation ledger.

Request-level scripts against a fixed branch tensor (hit, miss, partial
span, anchor offsets) give the bits of the port's serial runner, with the
right hit and miss counts. The structured branch tree, the candidate
ranking, the forward fill and the periodic extrapolation are bitwise the
JAX package's on seeded inputs, scalar and vector. Dispatch dedup, restore
invalidation, attestation (full coverage; the live ring untouched; a
status-reading model caught; the memo; exhaustive mode), the app's events,
the raise for meshes, the predictor's resolution, and boids under speculation (the
force wrappers over a branch axis; a boids app attests on every path).
The ledger's outputs equal the JAX ledger's.
"""

import json
import types

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import spec_runner as jsr
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.obs import ledger as jledger
from bevy_ggrs_tpu.schedule import InputSpec as JInputSpec
from bevy_ggrs_tpu_torch import spec_runner as tsr
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import GGRSPlugin
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.obs import ledger as tledger
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import neighbor as tnb
from bevy_ggrs_tpu_torch.ops import pairwise as tpw
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.schedule import InputSpec, Schedule
from bevy_ggrs_tpu_torch.session import EventKind
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner, attest_speculation_safety
from tests.test_torch_fused_tick import (
    ChecksumLog,
    make_spec_runner,
    rollback_requests,
    step_requests,
)

P = 2
MAXPRED = 8


def fixed_sampler(tensor):
    """A sampler that always returns ``tensor`` ([B, F, P] uint8)."""
    t = torch.as_tensor(np.asarray(tensor))

    def sample(generator, last_bits, num_branches, num_frames):
        assert t.shape[0] == num_branches and t.shape[1] == num_frames
        return t
    return sample


def make_runners(sampler=None, num_branches=4, spec_frames=4, **kw):
    world = lambda: tbox.make_world(P, device="cpu").commit()  # noqa: E731
    serial = RollbackRunner(tbox.make_schedule(), world(), max_prediction=MAXPRED,
                            num_players=P, input_spec=tbox.INPUT_SPEC, device="cpu")
    spec = SpeculativeRollbackRunner(tbox.make_schedule(), world(), max_prediction=MAXPRED,
                                     num_players=P, input_spec=tbox.INPUT_SPEC,
                                     num_branches=num_branches, sampler=sampler,
                                     spec_frames=spec_frames, device="cpu", **kw)
    return serial, spec


def run_both(serial, spec, script):
    logs = (ChecksumLog(), ChecksumLog())
    for item in script:
        if item[0] == "reqs":
            serial.handle_requests(item[1], logs[0])
            spec.handle_requests(item[1], logs[1])
        elif item[0] == "speculate":
            spec.speculate(item[1])
    assert serial.frame == spec.frame
    assert ts.combine64(ts.checksum(serial.state)) == ts.combine64(ts.checksum(spec.state))
    assert logs[0].seen == logs[1].seen
    return logs


def test_full_span_hit():
    corrected = np.array([[1, 4], [1, 8], [1, 2]], np.uint8)
    tensor = np.zeros((4, 4, P), np.uint8)
    tensor[2, :3] = corrected
    tensor[2, 3] = [9, 9]
    serial, spec = make_runners(fixed_sampler(tensor), 4, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(3)]
    script += [("speculate", 2), ("reqs", step_requests(3, [3, 4])),
               ("reqs", step_requests(4, [4, 5])),
               ("reqs", rollback_requests(3, list(corrected)))]
    run_both(serial, spec, script)
    assert spec.spec_hits == 1 and spec.spec_misses == 0


def test_miss_falls_back_serial():
    tensor = np.full((4, 4, P), 13, np.uint8)
    serial, spec = make_runners(fixed_sampler(tensor), 4, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(3)]
    script += [("speculate", 2), ("reqs", step_requests(3, [3, 4])),
               ("reqs", rollback_requests(3, [[5, 6], [6, 7]]))]
    run_both(serial, spec, script)
    assert spec.spec_hits == 0 and spec.spec_misses == 1


def test_partial_span_hit_load_after_anchor():
    used = {2: [2, 3], 3: [3, 4]}
    corrected = [[11, 1], [12, 2]]
    tensor = np.zeros((2, 4, P), np.uint8)
    tensor[1, 0], tensor[1, 1] = used[2], used[3]
    tensor[1, 2], tensor[1, 3] = corrected
    serial, spec = make_runners(fixed_sampler(tensor), 2, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(2)]
    script.append(("speculate", 1))  # anchor 2
    script += [("reqs", step_requests(f, used.get(f, [4, 5]))) for f in (2, 3, 4)]
    script.append(("reqs", rollback_requests(4, corrected)))
    run_both(serial, spec, script)
    assert spec.spec_hits == 1


def test_trajectory_mismatch_before_load_is_a_miss():
    corrected = [[11, 1]]
    tensor = np.zeros((2, 4, P), np.uint8)
    tensor[1, 0] = [99, 99]  # contradicts the as-used inputs of frame 2
    tensor[1, 1] = corrected[0]
    serial, spec = make_runners(fixed_sampler(tensor), 2, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(2)]
    script += [("speculate", 1), ("reqs", step_requests(2, [2, 3])),
               ("reqs", step_requests(3, [3, 4])), ("reqs", rollback_requests(3, corrected))]
    run_both(serial, spec, script)
    assert spec.spec_hits == 0 and spec.spec_misses == 1


def test_hit_through_rollout_end_uses_final_state():
    corrected = np.array([[5, 1], [6, 2], [7, 3], [8, 4]], np.uint8)
    tensor = np.zeros((2, 4, P), np.uint8)
    tensor[0] = corrected
    serial, spec = make_runners(fixed_sampler(tensor), 2, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(3)]
    script.append(("speculate", 2))  # anchor 3, the rollout covers 3..6
    script += [("reqs", step_requests(f, [f, f + 1])) for f in (3, 4, 5, 6)]
    script.append(("reqs", rollback_requests(3, list(corrected))))
    run_both(serial, spec, script)
    assert spec.spec_hits == 1


def test_partial_prefix_commit_resimulates_only_tail():
    corrected = [[11, 1], [12, 2], [13, 3]]
    tensor = np.zeros((2, 4, P), np.uint8)
    tensor[1, 0], tensor[1, 1] = corrected[0], corrected[1]
    tensor[1, 2] = [99, 99]
    serial, spec = make_runners(fixed_sampler(tensor), 2, 4)
    script = [("reqs", step_requests(f, [f, f + 1])) for f in range(3)]
    script += [("speculate", 2), ("reqs", step_requests(3, [3, 4])),
               ("reqs", step_requests(4, [4, 5])), ("reqs", rollback_requests(3, corrected))]
    run_both(serial, spec, script)
    assert spec.spec_partial_hits == 1 and spec.spec_hits == 0
    assert spec.rollback_frames_recovered_total == 2
    assert spec.rollback_frames_total == 1


def test_sampler_path_with_session_pinning():
    class FakeSession:
        def confirmed_input(self, handle, frame):
            return np.uint8(7 + handle) if frame <= 4 else None

    tensor = np.full((4, 4, P), 13, np.uint8)
    _, spec = make_runners(fixed_sampler(tensor), 4, 4)
    for f in range(3):
        spec.handle_requests(step_requests(f, [f, f + 1]), ChecksumLog())
    spec.speculate(2, FakeSession())  # anchor 3, span 3..6
    bits = np.asarray(spec._result.branch_bits)
    assert (bits[:, 0] == [7, 8]).all() and (bits[:, 1] == [7, 8]).all()
    assert (bits[0, 2] == [7, 8]).all()  # branch 0 forward-fills the known change
    assert (bits[1:, 2] == 13).all()


# ---------------------------------------------------------------------------
# The structured tree, bitwise against JAX
# ---------------------------------------------------------------------------

SCALAR = (tbox.INPUT_SPEC, jbox.INPUT_SPEC)
VECTOR = (InputSpec(shape=(3,), dtype=torch.uint8, values=tuple(range(6))),
          JInputSpec(shape=(3,), dtype=np.uint8, values=tuple(range(6))))
WIDE = (InputSpec(shape=(), dtype=torch.uint8, values=tuple(range(32))),
        JInputSpec(shape=(), dtype=np.uint8, values=tuple(range(32))))


def tree_pair(specs, B, F, players=P):
    t = SpeculativeRollbackRunner(
        tbox.make_schedule(), tbox.make_world(players, device="cpu").commit(),
        max_prediction=max(F, 8), num_players=players, input_spec=specs[0],
        num_branches=B, spec_frames=F, device="cpu")
    j = jsr.SpeculativeRollbackRunner(
        jbox.make_schedule(), jbox.make_world(players).commit(),
        max_prediction=max(F, 8), num_players=players, input_spec=specs[1],
        num_branches=B, spec_frames=F, predictor=False)
    return t, j


@pytest.mark.parametrize("specs,B,F,players,seed", [
    (SCALAR, 8, 4, 2, 0), (SCALAR, 96, 4, 2, 1), (SCALAR, 1024, 12, 8, 2),
    (VECTOR, 16, 4, 2, 3), (VECTOR, 64, 6, 3, 4), (WIDE, 64, 8, 2, 5),
], ids=["scalar-8", "scalar-96", "scalar-1024", "vector-16", "vector-64", "wide-64"])
def test_structured_bits_equal_jax(specs, B, F, players, seed):
    rng = np.random.RandomState(seed)
    t, j = tree_pair(specs, B, F, players)
    zeros = t.input_spec.zeros_np(players)
    hi = len(t._branch_values)
    for history in (False, True):
        if history:
            for f in range(30):
                v = rng.randint(0, hi, zeros.shape).astype(zeros.dtype)
                t._input_log[f] = v
                j._input_log[f] = v.copy()
        last = rng.randint(0, hi, zeros.shape).astype(zeros.dtype)
        known = rng.randint(0, hi, (F,) + zeros.shape).astype(zeros.dtype)
        mask = rng.rand(F, players) < 0.4
        for anchor in ((None,) if not history else (None, 30, 17)):
            got = t._structured_bits(last, known, mask, anchor)
            want = j._structured_bits(last, known, mask, anchor)
            np.testing.assert_array_equal(got, want)
        C, valid = t._candidate_values(last)
        jC, jvalid = j._candidate_values(last)
        np.testing.assert_array_equal(C, jC)
        np.testing.assert_array_equal(valid, jvalid)
        np.testing.assert_array_equal(tsr._forward_fill(last, known, mask),
                                      jsr._forward_fill(last, known, mask))
        if history:
            assert t._history_fingerprint(30) == j._history_fingerprint(30)


def test_structured_bits_all_pinned_and_periodic_equal_jax():
    t, j = tree_pair(SCALAR, 16, 8)
    keys = [1, 2, 4, 0]
    for f in range(40):
        v = np.array([keys[(f // 3) % 4], keys[(f // 3 + 1) % 4]], np.uint8)
        t._input_log[f], j._input_log[f] = v, v.copy()
    last = t._input_log[39]
    known = np.zeros((8, 2), np.uint8)
    mask = np.zeros((8, 2), bool)
    tree = t._structured_bits(last, known, mask, 40)
    np.testing.assert_array_equal(tree, j._structured_bits(last, known, mask, 40))
    truth = np.array([[keys[((40 + s) // 3 + h) % 4] for h in range(2)] for s in range(8)],
                     np.uint8)
    assert np.array_equal(tree[0], np.broadcast_to(last, (8, 2)))
    assert np.array_equal(tree[1], truth)  # the periodic future of both players
    pinned = t._structured_bits(last, np.full((8, 2), 5, np.uint8), np.ones((8, 2), bool), 40)
    assert (pinned == pinned[0]).all()


def test_extrapolation_falls_back_without_periodicity():
    rng = np.random.RandomState(9)
    t, j = tree_pair(SCALAR, 16, 8)
    for f in range(40):
        v = rng.randint(0, 16, (2,)).astype(np.uint8)
        t._input_log[f], j._input_log[f] = v, v.copy()
    last = t._input_log[39]
    known, mask = np.zeros((8, 2), np.uint8), np.zeros((8, 2), bool)
    assert t._extrapolate_base(np.broadcast_to(last, (8, 2)).copy(), known, mask, 40) is None
    tree = t._structured_bits(last, known, mask, 40)
    np.testing.assert_array_equal(tree, j._structured_bits(last, known, mask, 40))
    assert np.array_equal(tree[0], np.broadcast_to(last, (8, 2)))
    assert not np.array_equal(tree[1], tree[0])


def test_candidate_ranking_prioritizes_recent_and_toggles():
    """A player alternating UP and UP|FIRE in a 32-value universe: the two
    recent values lead, so the FIRE press is enumerated at every frame."""
    t, _ = tree_pair(WIDE, 64, 8)
    UP, FIRE = 1, 16
    for f, fire in enumerate([0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1]):
        t._input_log[f] = np.array([UP | (FIRE if fire else 0), 0], np.uint8)
    last = np.array([UP, 0], np.uint8)
    C, valid = t._candidate_values(last)
    assert (UP | FIRE) in [int(v) for v in C[0, 0][valid[0, 0]]][:2]
    tree = t._structured_bits(last, np.zeros((8, 2), np.uint8), np.zeros((8, 2), bool))
    for s in range(8):
        wanted = np.broadcast_to(last, (8, 2)).copy()
        wanted[s:, 0] = UP | FIRE
        assert any(np.array_equal(tree[b], wanted) for b in range(64)), s


# ---------------------------------------------------------------------------
# Dedup and invalidation
# ---------------------------------------------------------------------------


def test_speculate_dedups_identical_redispatch():
    class FakeSession:
        def __init__(self):
            self.inputs = {}

        def confirmed_input(self, handle, frame):
            return self.inputs.get((handle, frame))

    _, spec = make_runners(num_branches=4, spec_frames=4)
    session = FakeSession()
    for f in range(4):
        spec.handle_requests(step_requests(f, [f, f + 1]), None)
    spec.speculate(1, session)  # anchor 2 < frame 4: dedup applies
    first = spec._result
    assert first is not None and spec.spec_dispatches_skipped == 0
    spec.speculate(1, session)
    assert spec.spec_dispatches_skipped == 1 and spec._result is first
    session.inputs[(1, 3)] = np.uint8(9)  # a newly confirmed input in the span
    spec.speculate(1, session)
    assert spec.spec_dispatches_skipped == 1 and spec._result is not first
    second = spec._result
    spec.speculate(2, session)  # the frontier moved
    assert spec._result is not second
    spec.speculate(3, session)  # a live-state anchor never dedups
    live = spec._result
    spec.speculate(3, session)
    assert spec._result is not live


def test_restore_invalidates_speculative_transients():
    _, spec = make_runners(num_branches=4, spec_frames=4)
    for f in range(3):
        spec.handle_requests(step_requests(f, [f, f + 1]), None)
    checkpoint = ts.tree_map(torch.clone, spec.state)
    spec.handle_requests(step_requests(3, [3, 4]), None)
    spec.speculate(2)
    spec._pending_reports.append((torch.zeros((2, 2), dtype=torch.int64), [(0, 3)]))
    assert spec._result is not None and spec._input_log
    spec.restore_state(3, checkpoint)
    assert spec._result is None and spec._spec_sig is None
    assert not spec._input_log and not spec._pending_reports
    assert spec.frame == 3


def test_random_sampler_path_never_dedups():
    from bevy_ggrs_tpu_torch.parallel.speculate import bitmask_sampler

    _, spec = make_runners(num_branches=4, spec_frames=4)
    spec._sampler = bitmask_sampler()
    for f in range(4):
        spec.handle_requests(step_requests(f, [f, f + 1]), None)
    spec.speculate(1)
    first = spec._result
    spec.speculate(1)
    assert spec._result is not first and spec.spec_dispatches_skipped == 0
    assert (np.asarray(first.branch_bits)[0] == spec._input_log[1]).all()  # repeat-last


# ---------------------------------------------------------------------------
# Attestation
# ---------------------------------------------------------------------------


def ring_bytes(runner):
    leaves = ts.tree_leaves([runner.ring.states.alive, runner.ring.states.rollback_id,
                             runner.ring.states.components, runner.ring.states.present,
                             runner.ring.states.resources, runner.ring.frames,
                             runner.ring.checksums])
    return [x.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes() for x in leaves]


def test_box_game_attests_safe_with_full_coverage_and_leaves_the_ring(monkeypatch):
    monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
    _, runner = make_runners(num_branches=8, spec_frames=4)
    for f in range(3):  # a ring with saved rows and a live state past 0
        runner.handle_requests(step_requests(f, [f, f + 1]), None)
    before, state = ring_bytes(runner), ts.combine64(ts.checksum(runner.state))
    runner.warmup()
    report = runner.attestation
    assert report.ok and report.frames == 4 and report.branches_checked == 8
    assert report.scanned_branches == runner.num_branches and report.structured_checked
    assert report.real_checked == 2 * runner.num_branches and not report.scanned_proxy_divergence
    assert ring_bytes(runner) == before and runner.frame == 3
    assert ts.combine64(ts.checksum(runner.state)) == state


def status_leak(state, inputs):
    """A system that (illegally) writes the input status into state."""
    leak = inputs.status.sum(dim=-1).to(torch.int32)
    fc = state.resources["frame_count"]
    return state.replace(resources={**state.resources,
                                    "frame_count": (fc.view(torch.int32) + leak).view(torch.uint32)})


def test_status_reading_model_is_caught_and_disabled(monkeypatch):
    monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
    runner = SpeculativeRollbackRunner(
        Schedule([tbox.move_cube_system, status_leak]), tbox.make_world(P, device="cpu").commit(),
        max_prediction=8, num_players=P, input_spec=tbox.INPUT_SPEC, num_branches=4,
        spec_frames=4, device="cpu")
    runner.warmup()
    assert runner.attestation is not None and not runner.attestation.ok
    # Frame 0 is saved before any step; the first advance leaks into frame 1.
    assert runner.attestation.mismatch_branch == 0 and runner.attestation.mismatch_frame == 1
    assert not runner.speculation_enabled
    runner.speculate(0)
    assert runner._result is None


def box_plugin(schedule=None, branches=4, **kw):
    def setup(world, app):
        tbox.spawn_players(world, P, next_id=app.rollback_id_provider.next_id)

    plugin = (GGRSPlugin(tbox.INPUT_SPEC).with_num_players(P)
              .with_rollback_schedule(schedule or tbox.make_schedule())
              .with_input_system(lambda h, app: np.uint8(0))
              .with_setup_system(setup).with_device("cpu")
              .with_speculation(branches, **kw))
    plugin.registry = tbox.make_registry()
    return plugin


def test_app_surfaces_disable_event(monkeypatch):
    monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
    app = box_plugin(Schedule([tbox.move_cube_system, status_leak])).build()
    assert EventKind.SPECULATION_DISABLED in [e.kind for e in app.events]
    assert not app.stage.runner.speculation_enabled


def test_app_builds_the_speculative_runner():
    app = box_plugin(branches=8, branch_values=range(4)).build()
    runner = app.stage.runner
    assert isinstance(runner, SpeculativeRollbackRunner) and runner.num_branches == 8
    assert runner._branch_values == [0, 1, 2, 3] and runner.attestation.ok
    assert not app.events
    plain = box_plugin(branches=0).build().stage.runner
    assert not isinstance(plain, SpeculativeRollbackRunner)


def test_every_branch_of_both_tensors_is_replayed_once(monkeypatch):
    """One serial burst per branch of the random and the structured
    tensor, and no proxy: nothing flags a divergence, and the app adds no
    event."""
    monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
    _, runner = make_runners(num_branches=8, spec_frames=4)
    runs = []
    real_run = runner.executor.run
    monkeypatch.setattr(runner.executor, "run",
                        lambda *a, **kw: runs.append(a[3]) or real_run(*a, **kw))
    report = attest_speculation_safety(runner)
    assert report.ok and len(runs) == report.real_checked == 16
    assert not report.scanned_proxy_divergence and not report.exhaustive
    assert not box_plugin(branches=8).build().events


class TestAttestationMemo:
    def _fresh(self, monkeypatch, calls):
        monkeypatch.setattr(tsr, "_ATTEST_MEMO", {})
        real = tsr.attest_speculation_safety

        def counting(runner, **kw):
            calls.append(runner)
            return real(runner, **kw)

        monkeypatch.setattr(tsr, "attest_speculation_safety", counting)

    def test_same_model_same_shape_attests_once(self, monkeypatch):
        calls = []
        self._fresh(monkeypatch, calls)
        for _ in range(2):
            runner = make_spec_runner()
            assert runner.attestation.ok
        assert len(calls) == 1

    def test_different_shape_attests_fresh(self, monkeypatch):
        calls = []
        self._fresh(monkeypatch, calls)
        make_spec_runner()
        make_spec_runner(num_branches=16)
        assert len(calls) == 2

    def test_different_schedule_closure_attests_fresh(self, monkeypatch):
        """Two schedules from one factory share bytecode; the fingerprint
        splits them by what their closures capture."""
        calls = []
        self._fresh(monkeypatch, calls)

        def make_drag(scale):
            def drag(state, inputs):
                v = state.components["velocity"] * scale
                return state.replace(components={**state.components, "velocity": v})
            return drag

        for scale in (1.0, 0.5):
            runner = SpeculativeRollbackRunner(
                Schedule([tbox.move_cube_system, make_drag(scale)]),
                tbox.make_world(P, device="cpu").commit(), max_prediction=8, num_players=P,
                input_spec=tbox.INPUT_SPEC, num_branches=4, spec_frames=4, device="cpu")
            runner.warmup()
        assert len(calls) == 2
        assert tsr._fn_fp(make_drag(1.0)) == tsr._fn_fp(make_drag(1.0))

    def test_decorated_system_attests_fresh(self, monkeypatch):
        """A ``functools.wraps`` decorator is keyed by its own code and the
        settings its closure carries, never as the bare system it wraps;
        an ``lru_cache`` keys as the function it caches."""
        import functools

        def scaled(scale):
            def wrap(system):
                @functools.wraps(system)
                def wrapper(state, inputs):
                    state = system(state, inputs)
                    v = state.components["velocity"] * scale
                    return state.replace(components={**state.components, "velocity": v})
                return wrapper
            return wrap

        bare = tbox.move_cube_system
        fps = [tsr._fn_fp(bare), tsr._fn_fp(scaled(1.0)(bare)), tsr._fn_fp(scaled(0.5)(bare))]
        assert len(set(fps)) == 3
        assert tsr._fn_fp(scaled(0.5)(bare)) == fps[2]
        assert tsr._fn_fp(functools.lru_cache(maxsize=None)(bare)) == ("lru_cache", fps[0])

        calls = []
        self._fresh(monkeypatch, calls)
        for system in (bare, scaled(0.5)(bare)):
            runner = SpeculativeRollbackRunner(
                Schedule([system]), tbox.make_world(P, device="cpu").commit(),
                max_prediction=8, num_players=P, input_spec=tbox.INPUT_SPEC, num_branches=4,
                spec_frames=4, device="cpu")
            runner.warmup()
        assert len(calls) == 2

    def test_env_var_disables_cache(self, monkeypatch):
        calls = []
        self._fresh(monkeypatch, calls)
        monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
        for _ in range(2):
            make_spec_runner()
        assert len(calls) == 2


def test_exhaustive_mode_real_checks_every_branch(monkeypatch):
    monkeypatch.setenv("GGRS_ATTEST_EXHAUSTIVE", "1")
    _, runner = make_runners(num_branches=8, spec_frames=4)
    report = attest_speculation_safety(runner)
    assert report.ok and report.exhaustive
    assert report.branches_checked == runner.num_branches
    assert report.real_checked == 2 * runner.num_branches


def test_exhaustive_verdict_not_served_from_standard_cache(monkeypatch):
    monkeypatch.delenv("GGRS_ATTEST_EXHAUSTIVE", raising=False)
    _, runner = make_runners()
    standard = tsr._attestation_key(runner)
    monkeypatch.setenv("GGRS_ATTEST_EXHAUSTIVE", "1")
    exhaustive = tsr._attestation_key(runner)
    assert standard is not None and exhaustive is not None and standard != exhaustive


# ---------------------------------------------------------------------------
# What is not ported raises; boids speculates
# ---------------------------------------------------------------------------


def test_boids_mesh_and_predictor_raise(monkeypatch):
    """Boids no longer raises: its runner's warmup attests every branch of
    both tensors. Meshes still raise, naming their ROADMAP item. The
    predictor is ported: ``True``/``"default"`` and ``GGRS_PREDICTOR=1``
    bind the default weights, ``False`` and ``GGRS_PREDICTOR=off`` leave
    it off, and a missing artifact raises when the runner is built."""
    from bevy_ggrs_tpu_torch.predict import load_default

    monkeypatch.delenv("GGRS_PREDICTOR", raising=False)
    runner = SpeculativeRollbackRunner(tboids.make_schedule(kernel="mxu"),
                                       tboids.make_world(16, 2, device="cpu").commit(),
                                       max_prediction=8, num_players=2,
                                       input_spec=tboids.INPUT_SPEC, num_branches=4,
                                       device="cpu")
    runner.warmup()
    assert runner.attestation.ok and runner.speculation_enabled
    assert runner.attestation.real_checked == 2 * 4
    # A mesh without the runner's branch axis fails at construction, with
    # the JAX package's message.
    with pytest.raises(ValueError, match="live speculation needs a 2D"):
        make_runners(mesh=types.SimpleNamespace(mesh_dim_names=("entity",)))
    digest = load_default().content_hash
    for predictor in (True, "default"):
        assert make_runners(predictor=predictor)[1]._predictor.content_hash == digest
    with pytest.raises(OSError):
        make_runners(predictor="weights.ggrspred")
    assert make_runners(predictor=False)[1]._predictor is None
    assert make_runners()[1]._predictor is None
    monkeypatch.setenv("GGRS_PREDICTOR", "1")
    assert make_runners()[1]._predictor.content_hash == digest
    assert make_runners(predictor=False)[1]._predictor is None
    monkeypatch.setenv("GGRS_PREDICTOR", "off")
    assert make_runners()[1]._predictor is None
    app = box_plugin(predictor=True).build()
    assert app.stage.runner._predictor.content_hash == digest


def _branch_axis_calls():
    """Each force entry point on a ``[3]`` world of 16 boids, and on one
    branch of it: ``name -> call(branch or None)``."""
    b, n = 3, 16
    rng = np.random.RandomState(1)
    pos = torch.from_numpy(rng.uniform(-1, 1, (b, n, 2)).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, n, 2)).astype(np.float32))
    act = torch.ones(b, n)
    act[:, ::5] = 0.0
    params = tboids._kernel_params()
    k = tboids.FLOCK_PAIR_KERNEL
    feats = {"vx": vel[..., 0], "vy": vel[..., 1]}
    tables = tnb.build_grid_tables(pos, act, tboids.grid_config(n), feats)
    rows, cols = tnb.gather_tables(k, tables[0].slots, tables[1], tables[2])

    def one(t, i):
        if isinstance(t, dict):
            return {name: v if i is None else v[i] for name, v in t.items()}
        return t if i is None else t[i]

    return {
        "pairwise_force_rows": lambda i: tpw.pairwise_force_rows(
            *(one(t, i) for t in (pos, vel, pos, vel, act, act)), **params),
        "pairwise_force_rows_mxu2": lambda i: tpw.pairwise_force_rows_mxu2(
            *(one(t, i) for t in (pos, vel, pos, vel, act, act)), **params),
        "pairwise_force_square_mxu_tri": lambda i: tpw.pairwise_force_square_mxu_tri(
            one(pos, i), one(vel, i), one(act, i), **params),
        "cell_slot_forces": lambda i: torch.stack(
            tcg.cell_slot_forces(k, one(rows, i), one(cols, i))),
        "interact": lambda i: tnb.interact(one(pos, i), one(act, i), k, one(feats, i),
                                           mode="grid", config=tboids.grid_config(n)),
    }


@pytest.mark.parametrize("name", sorted(_branch_axis_calls()))
def test_force_wrappers_take_a_branch_axis(name):
    """Each force entry point (on the CPU, its plain version) takes a world
    with a leading branch axis, and each branch of the result is bitwise
    the call on that branch alone."""
    call = _branch_axis_calls()[name]
    batched = call(None)
    assert torch.isfinite(batched).all() and batched.abs().max() > 0
    for b in range(3):
        assert torch.equal(batched[b] if name != "cell_slot_forces" else batched[:, b],
                           call(b)), (name, b)


def boids_plugin(kernel, mode, branches=4, n=32):
    return (GGRSPlugin(tboids.INPUT_SPEC)
            .with_input_system(lambda h, app: np.uint8(0))
            .register_rollback_component("position", shape=(2,))
            .register_rollback_component("velocity", shape=(2,))
            .register_rollback_component("leader_handle", dtype=torch.int32, default=-1)
            .register_rollback_resource("frame_count", np.uint32(0))
            .with_rollback_schedule(tboids.make_schedule(kernel=kernel, mode=mode))
            .with_num_players(P).with_world_capacity(n)
            .with_setup_system(lambda world, app: tboids.spawn_flock(world, n, P))
            .with_device("cpu").with_speculation(branches))


@pytest.mark.parametrize("kernel,mode", [("pallas", "dense"), ("mxu", "dense"),
                                         ("pallas", "grid")])
def test_boids_app_with_speculation_attests(kernel, mode, monkeypatch):
    """A boids app with speculation builds: the stage's warmup attests the
    rollout against the serial burst on every branch of both tensors,
    whichever kernel and interaction mode the schedule uses."""
    monkeypatch.setenv("GGRS_ATTEST_CACHE", "0")
    app = boids_plugin(kernel, mode).build()
    runner = app.stage.runner
    assert isinstance(runner, SpeculativeRollbackRunner)
    report = runner.attestation
    assert report.ok and runner.speculation_enabled, report
    assert report.real_checked == 2 * 4 and report.structured_checked


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def ledger_pair(**kw):
    return (tledger.SpeculationLedger(clock=Clock(), wall_t0=1.0, **kw),
            jledger.SpeculationLedger(clock=Clock(), wall_t0=1.0, **kw))


RECORDS = [
    ("miss", dict(depth=1, frames_resimulated=1, blame_player=1, blame_frame=4, load_frame=4)),
    ("full", dict(depth=2, frames_recovered=2, branch=1, rank=1, blame_player=0,
                  blame_frame=5, slot=2, load_frame=4)),
    ("partial", dict(depth=3, frames_recovered=1, frames_resimulated=2, branch=3, rank=3,
                     blame_player=1, blame_frame=9, load_frame=9)),
    ("unmatched", dict(depth=2, frames_resimulated=2, load_frame=12)),
    ("full", dict(depth=4, frames_recovered=4, branch=0, rank=0, load_frame=15)),
]


def test_ledger_outputs_equal_jax(tmp_path):
    t, j = ledger_pair(capacity=4)
    for led in (t, j):
        for outcome, kw in RECORDS:
            led.record(outcome, **kw)
        led.record_rollout(64)
        led.record_rollout(64, slot=1)
    assert list(t.entries) == list(j.entries)  # the ring evicted the oldest
    assert t.summary() == j.summary() and t.blame_shares() == j.blame_shares()
    assert t.rollbacks == j.rollbacks == 5
    for since in (0, 2, 4, 9):
        assert t.tail(since) == j.tail(since)
    paths = [tmp_path / "t.jsonl", tmp_path / "j.jsonl"]
    t.export_jsonl(str(paths[0]))
    j.export_jsonl(str(paths[1]))
    assert paths[0].read_text() == paths[1].read_text()
    lines = [json.loads(x) for x in paths[0].read_text().splitlines()]
    assert lines[0]["meta"]["summary"]["spec_full"] == 2 and lines[1]["outcome"] == "full"
    records = [{"dir": "rx", "type": "input", "frame": f, "ts_us": 10 * f, "key": f"k{f}"}
               for f in (2, 3, 8)] + [{"dir": "tx", "type": "input", "frame": 1, "ts_us": 0,
                                       "key": "x"}]
    # The ring of 4 evicted the first entry: two blamed entries resolve.
    assert t.export_provenance(str(paths[0]), records) == j.export_provenance(
        str(paths[1]), records) == 2
    assert paths[0].read_text() == paths[1].read_text()
    t.clear()
    j.clear()
    assert t.summary() == j.summary() and t.rollbacks == 0


def test_scoped_null_and_blame_equal_jax():
    t, j = ledger_pair()
    for led in (t, j):
        scoped = led.scoped(8)
        scoped.record("full", depth=2, frames_recovered=2, rank=0, slot=3)
        scoped.record_rollout(64, slot=3)
        assert scoped.enabled
    assert list(t.entries) == list(j.entries) and t.entries[-1]["slot"] == 11
    assert t.spec_frames_dispatched == j.spec_frames_dispatched == 64
    null = tledger.null_ledger
    assert null.enabled is False and null.scoped(4) is null
    null.record("full", depth=1)
    null.record_rollout(100)
    assert (null.rollbacks, null.tail(0), null.summary(), null.blame_shares()) == (0, [], {}, {})
    assert null.export_provenance("unused", []) == 0
    rng = np.random.RandomState(0)
    for _ in range(20):
        k = int(rng.randint(0, 4))
        pred = rng.randint(0, 3, size=(k, 2)).astype(np.uint8)
        corr = pred.copy()
        if k and rng.rand() < 0.7:
            corr[rng.randint(k), rng.randint(2)] ^= 4
        assert tledger.blame_divergence(pred, corr) == jledger.blame_divergence(pred, corr)


def test_runner_ledger_reconciles_with_counters():
    """Over the fused-tick scripts, the port runner's ledger entries equal
    the JAX runner's (timestamps aside) and sum to the runner's
    counters."""
    from tests.test_torch_fused_tick import (
        SCRIPTS, _script_with_recovery, make_jax_spec_runner, run_tick, to_jax)

    for kind in sorted(SCRIPTS):
        script = _script_with_recovery(*SCRIPTS[kind])
        t, j = make_spec_runner(attest=False), make_jax_spec_runner()
        t.ledger, j.ledger = tledger.SpeculationLedger(), jledger.SpeculationLedger()
        run_tick(t, script)
        run_tick(j, [(to_jax(reqs), c) for reqs, c in script])
        strip = lambda entries: [{k: v for k, v in e.items() if k != "ts_us"}  # noqa: E731
                                 for e in entries]
        assert strip(t.ledger.entries) == strip(j.ledger.entries) and t.ledger.entries
        assert t.ledger.summary() == j.ledger.summary()
        counts = t.ledger.outcome_counts
        assert counts["full"] == t.spec_hits and counts["partial"] == t.spec_partial_hits
        assert counts["miss"] == t.spec_misses and t.ledger.rollbacks == t.rollbacks_total
        assert t.ledger.frames_recovered_total == t.rollback_frames_recovered_total
        assert t.ledger.rollouts_dispatched == t.spec_rollouts_total - 1  # warmup's rollout
