"""PyTorch port, the speculating P2P tick.

``SpeculativeRollbackRunner.tick()`` must give the bits of the legacy
``handle_requests(); speculate()`` pair on a full hit, a miss and a
partial hit, cost at most one call of the fused executor (one device
dispatch) on every canonical tick, keep the fallback paths correct and
deliver a frame's corrected checksum report after its stale one. The same
scripts through the JAX package's runner and the port's give the same
frames, ring frames and lanes, reported checksums and hit counters.
"""

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame, LoadGameState, SaveGameState
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner

P = 2
MAXPRED = 8


def make_spec_runner(num_branches=8, spec_frames=4, **kw):
    r = SpeculativeRollbackRunner(
        tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
        max_prediction=MAXPRED, num_players=P, input_spec=tbox.INPUT_SPEC,
        num_branches=num_branches, spec_frames=spec_frames, device="cpu", **kw)
    r.warmup()
    return r


def adv(bits):
    return AdvanceFrame(bits=np.asarray(bits, np.uint8), status=np.zeros(P, np.int32))


def step_requests(frame, bits):
    return [SaveGameState(frame), adv(bits)]


def rollback_requests(load, corrected):
    reqs = [LoadGameState(load)]
    for t, bits in enumerate(corrected):
        reqs += [SaveGameState(load + t), adv(bits)]
    return reqs


class ChecksumLog:
    def __init__(self):
        self.seen = {}

    def report_checksum(self, frame, cs):
        self.seen[frame] = int(cs)


# A script is a list of (requests, confirmed_frame) ticks. Predicted frames
# repeat frame 2's inputs ([2, 3]), the session's own forward-fill
# prediction, which the branch tree's base row models.
def _script_with_recovery(corrected, new_frame_bits):
    script = [(step_requests(f, [f % 4, (f + 1) % 4]), f) for f in range(3)]
    script.append((step_requests(3, [2, 3]), 2))
    script.append((step_requests(4, [2, 3]), 2))
    reqs = rollback_requests(3, list(corrected))
    reqs += step_requests(3 + len(corrected), new_frame_bits)
    script.append((reqs, 3 + len(corrected)))
    return script


SCRIPTS = {  # kind -> (corrected, new frame's bits)
    "hit": ([[1, 3], [1, 3]], [1, 3]),
    "miss": ([[3, 1], [2, 3]], [0, 0]),
    "partial": ([[1, 3], [1, 3]], [0, 0]),
}


def run_tick(runner, script):
    log = ChecksumLog()
    for reqs, confirmed in script:
        runner.tick(reqs, confirmed, log)
    runner.flush_reports(log)  # the last tick's deferred reports
    return log


def run_legacy(runner, script):
    log = ChecksumLog()
    for reqs, confirmed in script:
        runner.handle_requests(reqs, log)
        runner.speculate(confirmed, log)
    return log


def assert_equal_runners(a, b, log_a, log_b):
    assert a.frame == b.frame
    assert ts.combine64(ts.checksum(a.state)) == ts.combine64(ts.checksum(b.state))
    assert torch.equal(a.ring.frames, b.ring.frames)
    assert torch.equal(a.ring.checksums, b.ring.checksums)
    assert log_a.seen == log_b.seen
    assert (a.spec_hits, a.spec_partial_hits, a.spec_misses) == (
        b.spec_hits, b.spec_partial_hits, b.spec_misses)
    assert a.rollback_frames_recovered_total == b.rollback_frames_recovered_total
    assert a.rollback_frames_total == b.rollback_frames_total


def test_tick_equals_legacy_full_hit():
    # Player 0 pressed another mask at the first replayed frame and held
    # it: the single-change branch the tree enumerates.
    a, b = make_spec_runner(), make_spec_runner()
    script = _script_with_recovery(*SCRIPTS["hit"])
    log_a, log_b = run_tick(a, script), run_legacy(b, script)
    assert a.spec_hits >= 1
    assert_equal_runners(a, b, log_a, log_b)


def test_tick_equals_legacy_miss():
    # Both players changed at once: outside the single-change tree.
    a, b = make_spec_runner(), make_spec_runner()
    script = _script_with_recovery(*SCRIPTS["miss"])
    log_a, log_b = run_tick(a, script), run_legacy(b, script)
    assert a.spec_misses >= 1 and a.spec_hits == 0
    assert_equal_runners(a, b, log_a, log_b)


def test_tick_equals_legacy_partial_hit():
    # The change matches the two replayed frames; the new frame breaks it.
    a, b = make_spec_runner(), make_spec_runner()
    script = _script_with_recovery(*SCRIPTS["partial"])
    log_a, log_b = run_tick(a, script), run_legacy(b, script)
    assert a.spec_partial_hits >= 1
    assert_equal_runners(a, b, log_a, log_b)


@pytest.mark.parametrize("kind", ["hit", "miss"])
def test_one_dispatch_per_tick(kind):
    """Every canonical tick is at most one device dispatch and at most one
    call of the fused executor: steady and miss ticks run the whole tick,
    a full hit runs the absorb alone, dedup-skipped ticks the serial
    burst."""
    runner = make_spec_runner()
    for i, (reqs, confirmed) in enumerate(_script_with_recovery(*SCRIPTS[kind])):
        before = runner.device_dispatches_total, runner._fused.calls
        runner.tick(reqs, confirmed, None)
        spent = runner.device_dispatches_total - before[0]
        calls = runner._fused.calls - before[1]
        assert spent <= 1 and calls <= 1, f"tick {i}: {spent} dispatches, {calls} calls"
        assert calls == spent or (calls == 0 and spent == 1)  # a serial-only tick


def test_tick_fallback_paths_stay_correct():
    # An advance without a save is not the standard shape: the legacy path.
    a, b = make_spec_runner(), make_spec_runner()
    log_a, log_b = ChecksumLog(), ChecksumLog()
    reqs = [adv([1, 2])]
    a.tick(reqs, 0, log_a)
    b.handle_requests(reqs, log_b)
    b.speculate(0, log_b)
    assert a.frame == b.frame == 1
    assert ts.combine64(ts.checksum(a.state)) == ts.combine64(ts.checksum(b.state))
    # Two segments in one list: the legacy pair too.
    reqs = rollback_requests(0, [[1, 2]]) + rollback_requests(0, [[2, 1]])
    a.tick(reqs, 0, log_a)
    b.handle_requests(reqs, log_b)
    b.speculate(0, log_b)
    assert a.frame == b.frame == 1
    assert ts.combine64(ts.checksum(a.state)) == ts.combine64(ts.checksum(b.state))


class WantingLog(ChecksumLog):
    """A session stub that wants every frame's checksum and records the
    order reports arrive in."""

    def __init__(self):
        super().__init__()
        self.order = []

    def wants_checksum(self, frame):
        return True

    def report_checksum(self, frame, cs):
        super().report_checksum(frame, cs)
        self.order.append((frame, int(cs)))


def test_deferred_reports_deliver_corrections_before_send_gate():
    """A frame saved on a predicted advance queues a stale report; the
    rollback corrects and re-saves it. At the next flush (where the stage
    polls, right before the send gate) the corrected value must arrive
    after the stale one, never before it and never dropped."""
    spec, serial_oracle = make_spec_runner(), make_spec_runner()
    log, oracle_log = WantingLog(), WantingLog()
    script = _script_with_recovery(*SCRIPTS["hit"])
    for reqs, confirmed in script:
        spec.tick(reqs, confirmed, log)
    spec.flush_reports(log)
    for reqs, _ in script:
        serial_oracle.handle_requests(reqs, oracle_log)
    assert spec.spec_hits >= 1
    for f in (3, 4, 5):
        assert log.seen[f] == oracle_log.seen[f], f
        reports = [cs for frame, cs in log.order if frame == f]
        final = oracle_log.seen[f]
        assert all(cs == final for cs in reports[reports.index(final):]), (f, reports)


def test_the_previous_rollout_survives_the_next():
    """A tick absorbs from the previous rollout and dispatches the next
    one: each rollout owns its tensors, so the pending result read by a
    later commit is never overwritten."""
    runner = make_spec_runner()
    script = _script_with_recovery(*SCRIPTS["partial"])
    for reqs, confirmed in script[:4]:
        runner.tick(reqs, confirmed, None)
    prev = runner._result
    kept = (prev.checksums.clone(), prev.rings.frames.clone(), prev.rings.checksums.clone())
    reqs, confirmed = script[4]
    runner.tick(reqs, confirmed, None)
    assert runner._result is not None
    assert torch.equal(prev.checksums, kept[0]) and torch.equal(prev.rings.frames, kept[1])
    assert torch.equal(prev.rings.checksums, kept[2])


# ---------------------------------------------------------------------------
# The same scripts through the JAX package's runner and the port's
# ---------------------------------------------------------------------------


def make_jax_spec_runner():
    r = JSpecRunner(jbox.make_schedule(), jbox.make_world(P).commit(), max_prediction=MAXPRED,
                    num_players=P, input_spec=jbox.INPUT_SPEC, num_branches=8,
                    spec_frames=4, attest=False)
    r.warmup()
    return r


def to_jax(reqs):
    """The same requests as the JAX package's request classes."""
    from bevy_ggrs_tpu.session.requests import (
        AdvanceFrame as JAdvance, LoadGameState as JLoad, SaveGameState as JSave)

    out = []
    for r in reqs:
        if isinstance(r, AdvanceFrame):
            out.append(JAdvance(bits=r.bits, status=r.status))
        elif isinstance(r, SaveGameState):
            out.append(JSave(r.frame))
        else:
            out.append(JLoad(r.frame))
    return out


@pytest.mark.parametrize("kind", sorted(SCRIPTS))
def test_tick_equals_jax(kind):
    script = _script_with_recovery(*SCRIPTS[kind])
    t, j = make_spec_runner(attest=False), make_jax_spec_runner()
    log_t = run_tick(t, script)
    log_j = run_tick(j, [(to_jax(reqs), c) for reqs, c in script])
    assert t.frame == j.frame
    np.testing.assert_array_equal(t.ring.frames.numpy(), np.asarray(j.ring.frames))
    np.testing.assert_array_equal(t.ring.checksums.numpy(),
                                  np.asarray(j.ring.checksums).astype(np.int64))
    assert ts.combine64(ts.checksum(t.state)) == js.combine64(js.checksum(j.state))
    assert log_t.seen == log_j.seen and log_t.seen
    assert (t.spec_hits, t.spec_partial_hits, t.spec_misses,
            t.rollback_frames_recovered_total, t.rollback_frames_total) == (
        j.spec_hits, j.spec_partial_hits, j.spec_misses,
        j.rollback_frames_recovered_total, j.rollback_frames_total)
    np.testing.assert_array_equal(np.asarray(t._result.branch_bits),
                                  np.asarray(j._result.branch_bits))
    np.testing.assert_array_equal(t._result.checksums.numpy(),
                                  np.asarray(j._result.checksums).astype(np.int64))
