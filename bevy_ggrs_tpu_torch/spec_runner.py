"""SpeculativeRollbackRunner: misprediction recovery as a branch select.

Counterpart of ``bevy_ggrs_tpu/spec_runner.py``, off the device mesh. The
base :class:`~bevy_ggrs_tpu_torch.runner.RollbackRunner` pays for a
misprediction after it is detected: the session emits ``[Load(F_bad),
(Save, Advance) × k]`` and the runner resimulates. This runner spends the
device's idle time before the misprediction: each tick it rolls B
candidate input futures forward from the confirmed frontier (branch 0 is
the session's own prediction). When a rollback burst arrives and some
branch's inputs match the corrected history, recovery is a copy of that
branch's precomputed frames; on a miss it falls back to the serial burst,
with the same bits either way.

Speculation is invisible when the batched step and the serial step agree
bitwise. A branch commits only when its inputs match the corrected inputs
frame for frame, and the as-used inputs from its anchor up to the load
frame, so a committed state is the computation the serial replay would
run, over a leading branch axis. The warmup attestation
(:func:`attest_speculation_safety`) checks that claim on the model; the
periodic checksum exchange turns any violation into a detected desync.
Systems must not read ``PlayerInputs.status`` into state: rollouts run all
PREDICTED, a recovery burst runs CONFIRMED, and attestation catches a
system that does.

The structured branch tree, the candidate ranking and the dedup
signatures are NumPy code, bitwise the JAX package's pure-Python path (the
one it takes under ``GGRS_NO_NATIVE=1``, itself bitwise equal to its
native C++ path). The learned predictor (ROADMAP.md, port queue item 5) and
device meshes (item 8) raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import types
import zlib
from typing import List, Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.fused import FusedTickExecutor, absorb_branch_frames
from bevy_ggrs_tpu_torch.obs.ledger import blame_divergence
from bevy_ggrs_tpu_torch.parallel.speculate import (
    SpecResult,
    SpeculativeExecutor,
    enumerate_branches,
    match_branch,
)
from bevy_ggrs_tpu_torch.runner import RollbackRunner, _Step
from bevy_ggrs_tpu_torch.schedule import Schedule
from bevy_ggrs_tpu_torch.state import (
    WorldState,
    clone_ring,
    combine64,
    tree_leaves,
)


def _forward_fill(
    last: np.ndarray, known: np.ndarray, known_mask: np.ndarray
) -> np.ndarray:
    """The session's own prediction for a rollout span: per player, start
    from the anchor-1 input and forward-fill the latest confirmed value
    into unknown frames (a confirmed change inside the span keeps
    predicting the new value afterwards, as the repeat-last queues do).

    ``last[P, ...]``, ``known[F, P, ...]``, ``known_mask[F, P]``."""
    extra = known.ndim - 2
    mask = known_mask.reshape(known_mask.shape + (1,) * extra)
    base = np.empty_like(known)
    carry = np.array(last, copy=True)
    for t in range(known.shape[0]):
        carry = np.where(mask[t], known[t], carry)
        base[t] = carry
    return base


@dataclasses.dataclass(frozen=True)
class AttestationReport:
    """Outcome of the speculation-safety check (see
    :func:`attest_speculation_safety`).

    ``branches_checked`` counts branches of the random tensor replayed
    through the runner's serial burst (the code a speculation miss runs);
    ``scanned_branches`` counts branches covered by the all-branch check;
    ``structured_checked`` records that the structured tree's branch
    tensors (pinned known-input prefixes and single-field suffix changes,
    the shapes live recoveries commit) were attested too; ``real_checked``
    counts every serial replay, over both tensors."""

    ok: bool
    branches_checked: int
    frames: int
    mismatch_branch: Optional[int] = None
    mismatch_frame: Optional[int] = None
    scanned_branches: int = 0
    structured_checked: bool = False
    # The JAX package's flag for an all-branch proxy that disagreed with
    # the rollout while the serial burst agreed. The port replays every
    # branch through the serial burst and has no proxy, so it stays False.
    scanned_proxy_divergence: bool = False
    real_checked: int = 0
    exhaustive: bool = False


class _Unkeyable(Exception):
    """A schedule captured something that cannot be fingerprinted: the
    runner then attests afresh instead of risking a false memo hit."""


def _value_fp(v, depth: int = 0):
    """Conservative structural fingerprint of a closure-captured value."""
    if depth > 4:
        raise _Unkeyable(type(v))
    if isinstance(v, (int, float, str, bool, bytes, type(None))):
        return v
    if v is Ellipsis:  # ``x[..., 0]`` puts it in a code object's constants
        return ("ellipsis",)
    if isinstance(v, slice):
        return ("slice", _value_fp((v.start, v.stop, v.step), depth + 1))
    if isinstance(v, np.generic):
        return ("np", str(v.dtype), v.item())
    if isinstance(v, (tuple, list)):
        return tuple(_value_fp(x, depth + 1) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _value_fp(x, depth + 1)) for k, x in v.items()))
    if isinstance(v, torch.dtype):
        return ("dtype", str(v))
    if isinstance(v, (np.ndarray, torch.Tensor)):
        arr = v.detach().cpu() if isinstance(v, torch.Tensor) else np.asarray(v)
        if isinstance(arr, torch.Tensor):
            raw = arr.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()
            return ("tensor", tuple(arr.shape), str(arr.dtype),
                    hashlib.sha1(raw).hexdigest())
        return ("array", arr.shape, str(arr.dtype),
                hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest())
    if callable(v):
        return _fn_fp(v, depth + 1)
    raise _Unkeyable(type(v))


def _code_fp(code, depth: int):
    """The bytecode, its constants and nested code objects (a lambda's
    body lives in ``co_consts``)."""
    consts = []
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            consts.append(_code_fp(const, depth + 1))
        else:
            consts.append(_value_fp(const, depth + 1))
    return (hashlib.sha1(code.co_code).hexdigest(), tuple(consts))


def _all_co_names(code) -> set:
    """Global names read anywhere in a code object, nested functions,
    lambdas and comprehensions included."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _all_co_names(const)
    return names


def _fn_fp(fn, depth: int = 0):
    """Fingerprint a system function: its bytecode and constants, closure
    cells, default arguments and the module globals its code names.
    Modules and callables of other modules count by name; callables of
    the same module are fingerprinted recursively. Anything opaque raises
    :class:`_Unkeyable`."""
    if depth > 4:
        raise _Unkeyable(type(fn))
    if isinstance(fn, functools.partial):
        return ("partial", _fn_fp(fn.func, depth + 1), _value_fp(fn.args, depth + 1),
                _value_fp(fn.keywords, depth + 1))
    if getattr(fn, "__self__", None) is not None:
        raise _Unkeyable(type(fn))  # a bound method: instance state is opaque
    code = getattr(fn, "__code__", None)
    if code is None:
        raise _Unkeyable(type(fn))
    cells = ()
    if getattr(fn, "__closure__", None):
        cells = tuple(_value_fp(c.cell_contents, depth + 1) for c in fn.__closure__)
    defaults = _value_fp(getattr(fn, "__defaults__", None), depth + 1)
    kwdefaults = _value_fp(getattr(fn, "__kwdefaults__", None), depth + 1)
    globals_fp = []
    g = getattr(fn, "__globals__", {})
    own_module = getattr(fn, "__module__", "")
    for name in sorted(_all_co_names(code)):
        if name not in g:
            continue  # a builtin or an attribute name
        v = g[name]
        if isinstance(v, types.ModuleType):
            globals_fp.append((name, "module", getattr(v, "__name__", "")))
        elif callable(v):
            if getattr(v, "__module__", None) == own_module:
                globals_fp.append((name, _fn_fp(v, depth + 1)))
            else:
                globals_fp.append((name, "ext", getattr(v, "__module__", ""),
                                   getattr(v, "__qualname__", repr(type(v)))))
        else:
            globals_fp.append((name, _value_fp(v, depth + 1)))
    return (own_module, getattr(fn, "__qualname__", ""), _code_fp(code, depth), cells,
            defaults, kwdefaults, tuple(globals_fp))


def _state_fp(state: WorldState) -> tuple:
    def tree(t):
        if isinstance(t, dict):
            return ("dict", tuple((k, tree(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(tree(x) for x in t))
        return None if t is None else "leaf"

    fields = tuple((f.name, tree(getattr(state, f.name)))
                   for f in dataclasses.fields(WorldState))
    leaves = [x for f in dataclasses.fields(WorldState)
              for x in tree_leaves(getattr(state, f.name))]
    return (fields, tuple((tuple(x.shape), str(x.dtype)) for x in leaves))


def _attestation_key(runner: "SpeculativeRollbackRunner"):
    """The key under which an attestation verdict is reusable: the same
    device type, schedule (by structural fingerprint), state shapes and
    dtypes, rollout geometry and branch-value universe. None (attest
    afresh) when anything resists fingerprinting."""
    try:
        sched_fp = tuple(_fn_fp(s) for s in runner.schedule._systems)
        zeros1 = runner.input_spec.zeros_np(1)
        return (
            runner.device.type,
            # An exhaustive verdict proves more than a standard one: never
            # serve one kind from the other's memo entry.
            os.environ.get("GGRS_ATTEST_EXHAUSTIVE", "0") == "1",
            sched_fp,
            _state_fp(runner.state),
            (zeros1.shape, str(zeros1.dtype)),
            runner.num_branches,
            runner.spec_frames,
            runner.num_players,
            runner.max_prediction,
            runner.executor.max_frames,
            runner.ring.depth,
            tuple(np.asarray(v).tobytes() for v in runner._branch_values),
        )
    except Exception:  # noqa: BLE001 - anything unkeyable is a miss
        return None


# Process-level memo: key -> AttestationReport. GGRS_ATTEST_CACHE=0 forces
# a fresh attestation at every warmup.
_ATTEST_MEMO: dict = {}


def attest_speculation_safety(
    runner: "SpeculativeRollbackRunner",
    seed: int = 0x5EED,
) -> AttestationReport:
    """Check the claim speculation rests on: the batched rollout (the
    ``[B]``-world step and the batched save) and the serial burst give
    bitwise the same checksums for the same inputs.

    Two branch tensors are checked: a random one over the branch-value
    universe, then a structured tree with synthetic pinned known-input
    prefixes (:func:`_attestation_structured_bits`). Every branch of each
    is replayed once through the runner's serial burst (the code a
    speculation miss runs) and compared with the runner's own rollout
    (:meth:`SpeculativeRollbackRunner._dispatch_rollout`, the fused
    executor with absorb and burst off). The serial side runs CONFIRMED
    status where the rollout runs PREDICTED, as a real recovery does, so a
    system that reads the status into state is caught.

    The JAX package adds an all-branch proxy, a ``lax.scan`` recompilation
    of the burst that can round differently from both real programs, and
    replays through the real burst only the branches the proxy flags. The
    port has no second program: its proxy would be the serial burst
    itself, so every branch is replayed through the burst, the proxy
    cannot diverge (``scanned_proxy_divergence`` stays False), and
    ``GGRS_ATTEST_EXHAUSTIVE=1`` replays the same branches (it is recorded
    in the report and the memo key). Replays run on a scratch copy of the
    ring: the runner's live ring, state and frame are left bitwise as they
    were."""
    B, P = runner.num_branches, runner.num_players
    F = min(runner.spec_frames, runner.executor.max_frames)
    exhaustive = os.environ.get("GGRS_ATTEST_EXHAUSTIVE", "0") == "1"
    rng = np.random.RandomState(seed)
    zeros = runner.input_spec.zeros_np(P)
    if runner._branch_values:
        vals = np.asarray(runner._branch_values, dtype=zeros.dtype)
        bits = vals[rng.randint(0, len(vals), size=(B, runner.spec_frames) + zeros.shape)]
    else:
        bits = rng.randint(0, 16, size=(B, runner.spec_frames) + zeros.shape).astype(zeros.dtype)
    structured = _attestation_structured_bits(runner, rng)

    # The serial replays save into a scratch ring; the state is only read.
    scratch = clone_ring(runner.ring)
    state, frame = runner.state, runner.frame
    status = np.zeros((F, P), np.int32)  # CONFIRMED
    real_checked = 0
    for tensor_bits in (bits, structured):
        spec_cs = runner._dispatch_rollout(frame, tensor_bits).checksums.cpu().numpy()
        for b in range(B):
            _, _, checksums = runner.executor.run(scratch, state, frame, tensor_bits[b, :F],
                                                  status, n_frames=F)
            serial_cs = checksums.cpu().numpy()[:F]
            real_checked += 1
            differ = (serial_cs != spec_cs[b, :F]).any(axis=-1)
            if differ.any():
                on_structured = tensor_bits is structured
                return AttestationReport(
                    ok=False, branches_checked=B if on_structured else b + 1, frames=F,
                    mismatch_branch=b, mismatch_frame=frame + int(np.flatnonzero(differ)[0]),
                    scanned_branches=B if on_structured else 0,
                    structured_checked=on_structured,
                    real_checked=real_checked, exhaustive=exhaustive,
                )
    return AttestationReport(
        ok=True, branches_checked=B, frames=F, scanned_branches=B,
        structured_checked=True, real_checked=real_checked, exhaustive=exhaustive,
    )


def _attestation_structured_bits(runner: "SpeculativeRollbackRunner",
                                 rng: np.random.RandomState) -> np.ndarray:
    """A structured-tree branch tensor with a synthetic known-input
    pattern: per player, a random-length confirmed prefix pinned to random
    universe values."""
    P, F = runner.num_players, runner.spec_frames
    zeros = runner.input_spec.zeros_np(P)
    universe = runner._branch_values or list(range(16))
    vals = np.asarray(universe, dtype=zeros.dtype)

    def draw(shape):
        return vals[rng.randint(0, len(vals), size=shape)]

    last = draw(zeros.shape).astype(zeros.dtype)
    known = np.broadcast_to(zeros, (F,) + zeros.shape).copy()
    mask = np.zeros((F, P), dtype=bool)
    for p in range(P):
        prefix = rng.randint(0, F)  # 0 = a fully unknown player
        mask[:prefix, p] = True
        known[:prefix, p] = draw(known[:prefix, p].shape)
    return runner._structured_bits(last, known, mask)


def _check_predictor(predictor) -> None:
    """``None`` (with ``GGRS_PREDICTOR`` unset or off) and ``False`` mean no
    predictor, as in the JAX package; any other value raises."""
    if predictor is None:
        env = os.environ.get("GGRS_PREDICTOR", "").strip()
        if not env or env.lower() in ("0", "off", "false"):
            return
    elif predictor is False:
        return
    raise NotImplementedError(
        "the learned input predictor is not ported yet (ROADMAP.md, port queue "
        "item 5: 'Predictor')")


class SpeculativeRollbackRunner(RollbackRunner):
    """Drop-in :class:`RollbackRunner` that precomputes rollback
    recoveries.

    Extra knobs: ``num_branches`` (candidate futures per rollout),
    ``sampler`` (a branch enumeration policy; None selects the structured
    single-change tree with known-input pinning), ``branch_values`` (the
    candidate input values the tree enumerates; default the model's
    ``InputSpec.values``, else 0..15), ``spec_frames`` (rollout depth,
    default ``max_prediction``) and ``seed`` (the sampler's generator).
    Call :meth:`tick` once a P2P tick, or :meth:`handle_requests` then
    :meth:`speculate`. Counters: ``spec_hits``, ``spec_partial_hits``,
    ``spec_misses``, ``rollback_frames_recovered_total``,
    ``spec_rollouts_total``, and the metrics sink.
    """

    def __init__(
        self,
        schedule: Schedule,
        initial_state: WorldState,
        max_prediction: int,
        num_players: int,
        input_spec,
        num_branches: int = 64,
        sampler=None,
        spec_frames: Optional[int] = None,
        seed: int = 0,
        branch_values=None,
        attest: bool = True,
        mesh=None,
        predictor=None,
        **kwargs,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "speculation over a device mesh is not ported yet (ROADMAP.md, "
                "port queue item 8: 'Sharding')")
        _check_predictor(predictor)
        super().__init__(schedule, initial_state, max_prediction, num_players,
                         input_spec, **kwargs)
        self.spec_frames = int(spec_frames or max_prediction)
        self.num_branches = int(num_branches)
        if branch_values is not None:
            self._branch_values = list(branch_values)
        elif getattr(input_spec, "values", None):
            self._branch_values = list(input_spec.values)
        else:
            self._branch_values = list(range(16))  # 4-bit movement masks
        # Attestation at warmup: None = not yet attested; a failed report
        # disables speculation (every rollback then takes the serial path).
        self._attest = bool(attest)
        self.attestation: Optional[AttestationReport] = None
        self.speculation_enabled = True
        self._sampler = sampler
        self._spec = SpeculativeExecutor(schedule, self.num_branches, self.spec_frames,
                                         tracer=self.tracer)
        # The tick executor: absorb, serial burst and rollout. speculate()
        # and the attestation run it too (absorb and burst off), so the
        # rollout whose states commit is the rollout that was attested.
        self._fused = FusedTickExecutor(schedule, self.executor.max_frames,
                                        self.num_branches, self.spec_frames)
        self._generator = torch.Generator().manual_seed(int(seed))
        self._result: Optional[SpecResult] = None
        # Dispatch dedup: the signature of the live rollout.
        self._spec_sig = None
        # As-used inputs, frame -> bits (host); the base runner logs into it.
        self._input_log = {}
        self._predictor = None
        self._seed_memo = None
        # Deferred checksum reports: (device lanes, [(row, frame)]), read at
        # the start of the next tick.
        self._pending_reports = []
        self.spec_dispatches_skipped = 0
        self.spec_hits = 0
        self.spec_partial_hits = 0
        self.spec_misses = 0
        self.rollback_frames_recovered_total = 0
        self.spec_rollouts_total = 0  # rollouts dispatched (warmup and attestation too)

    def invalidate_speculation(self) -> None:
        """Drop every speculative transient: the pending rollout, its dedup
        signature, the as-used input log and the deferred reports. Called
        when the ring, state or frame are replaced from outside the request
        protocol (a checkpoint restore, a repair)."""
        self._result = None
        self._spec_sig = None
        self._ledger_note = None
        self._seed_memo = None
        self._input_log.clear()
        self._pending_reports.clear()

    def warmup(self) -> None:
        """Build the kernels and run each speculative path once (the
        rollout, the full-hit absorb and the fallback commit, each
        committing nothing), then attest the model, before the session
        goes live. The live ring, state and frame are left as they were."""
        super().warmup()
        zeros = self.input_spec.zeros_np(self.num_players)
        bits = np.zeros((self.num_branches, self.spec_frames) + zeros.shape, zeros.dtype)
        res = self._dispatch_rollout(self.frame, bits)
        # n_frames=0: commits nothing.
        self._fused.commit_absorb(self.ring, res.rings, res.states, 0, 0, 0, 0,
                                  res.num_frames)
        spec_ring, spec_state = self._spec.commit(res, 0)
        absorb_branch_frames(self.ring, spec_ring, spec_state, 0, 0, 0, res.num_frames,
                             self.executor.max_frames)
        if self._attest and self.attestation is None:
            key = None
            if os.environ.get("GGRS_ATTEST_CACHE", "1") != "0":
                key = _attestation_key(self)
            cached = _ATTEST_MEMO.get(key) if key is not None else None
            if cached is not None:
                self.attestation = cached
                self.metrics.count("attestation_cache_hits")
            else:
                self.attestation = attest_speculation_safety(self)
                if key is not None:
                    _ATTEST_MEMO[key] = self.attestation
            if not self.attestation.ok:
                self.speculation_enabled = False
                self.metrics.count("speculation_disabled")

    # ------------------------------------------------------------------

    def handle_requests(self, requests, session=None) -> None:
        from bevy_ggrs_tpu_torch.session.requests import RestoreGameState

        if any(isinstance(r, RestoreGameState) for r in requests):
            # The base splitter applies the restore (which invalidates
            # speculation) between batches; no commit spans it.
            super().handle_requests(requests, session)
            self._gc_log()
            return
        for load_frame, steps in self._segment(requests):
            if load_frame is not None and self._try_commit(load_frame, steps, session):
                continue
            self._run_segment(load_frame, steps, session)
        self._gc_log()

    def tick(self, requests, confirmed_frame: int, session=None) -> None:
        """One P2P tick: the request burst, any branch commit, and the next
        rollout, in one call of the fused executor. The same bits as
        ``handle_requests(requests)`` then ``speculate(confirmed_frame)``;
        every non-canonical shape (multi-segment request lists,
        non-standard bursts, ticks whose speculation is skipped or
        disabled) takes exactly that pair.

        Checksum reports from the fused paths are deferred one tick: the
        wanted lanes queue as device tensors and are read at the start of
        the next tick (the fallback paths read synchronously). The host
        side of the tick is measured as ``spec_host_dispatch`` (a tracer
        span and a metrics timer)."""
        with self.tracer.span("spec_tick"):
            with self.metrics.timer("spec_host_dispatch"), self.tracer.span(
                "spec_host_dispatch"
            ):
                self._tick(requests, confirmed_frame, session)

    def _tick(self, requests, confirmed_frame: int, session=None) -> None:
        self.ticks_total += 1
        self.flush_reports(session)
        if not self.speculation_enabled:
            self._result = None
            self.handle_requests(requests, session)
            return
        segments = self._segment(requests)
        if len(segments) != 1:
            self.handle_requests(requests, session)
            self.speculate(confirmed_frame, session)
            return
        load_frame, steps = segments[0]
        start = self.frame if load_frame is None else load_frame
        standard = bool(steps) and all(
            s.adv is not None and s.save_frame == start + t for t, s in enumerate(steps)
        )
        if not standard:
            self.handle_requests(requests, session)
            self.speculate(confirmed_frame, session)
            return
        n_steps = len(steps)
        end = start + n_steps
        anchor = confirmed_frame + 1
        # Ticks whose rollout would not dispatch (fully confirmed, anchor
        # out of the ring) run the serial burst alone.
        if anchor > end or anchor <= end - self.ring.depth:
            self.handle_requests(requests, session)
            self.speculate(confirmed_frame, session)  # records the reason
            return
        # The as-used log before the branch tree: the forward-fill base
        # reads anchor-1, which this burst may advance.
        for t, s in enumerate(steps):
            self._input_log[start + t] = np.asarray(s.adv.bits)
        # The commit decision first (host only; the branch tensor is on the
        # host since the last tick): a full hit takes the absorb alone.
        res = self._result
        absorb_branch, n_commit = 0, 0
        missed = False
        blame_player = blame_frame = None
        if load_frame is not None and res is not None and load_frame >= res.start_frame:
            matched = None
            needed = []
            complete = True
            for f in range(res.start_frame, load_frame):
                got = self._input_log.get(f)
                if got is None:
                    complete = False
                    break
                needed.append(got)
            if complete:
                needed.extend(np.asarray(s.adv.bits) for s in steps)
                needed_arr = np.stack(needed)[: res.num_frames]
                with self.metrics.timer("match_branch"):
                    matched = match_branch(res.branch_bits, needed_arr)
            if matched is not None:
                branch, depth = matched
                nc = min(depth - (load_frame - res.start_frame), n_steps)
                if nc > 0:
                    absorb_branch, n_commit = int(branch), int(nc)
                else:
                    missed = True
                    self.spec_misses += 1
                    self.metrics.count("spec_misses")
                if self.ledger.enabled:
                    blame_player, blame_frame = self._ledger_blame(res, load_frame, steps)
        if n_commit == n_steps and n_commit > 0:
            # Full hit: one absorb commits the precomputed frames; the
            # pending rollout stays valid, so no new one is dispatched.
            self._commit_full_hit(load_frame, n_commit, absorb_branch, res, steps, session)
            self.ledger.record(
                "full", depth=n_steps, frames_recovered=n_commit, branch=absorb_branch,
                rank=absorb_branch, blame_player=blame_player, blame_frame=blame_frame,
                load_frame=load_frame,
            )
            self._gc_log()
            return
        last = self._input_log.get(anchor - 1)
        if last is None:
            last = self.input_spec.zeros_np(self.num_players)
        with self.metrics.timer("known_inputs_query"):
            known, known_mask = self._known_inputs(anchor, session)
        if anchor < end and self._sampler is None:
            sig = self._dedup_sig(anchor, last, known, known_mask)
            # Dedup-skip steady ticks only: a rollback tick has already run
            # (and counted) its branch match above.
            if load_frame is None and self._result is not None and sig == self._spec_sig:
                self.spec_dispatches_skipped += 1
                self.metrics.count("spec_dispatches_skipped")
                self.handle_requests(requests, session)
                return
        else:
            sig = None
        bits = self._branch_tensor(last, known, known_mask, anchor)
        prev_r, prev_s = self._prev_buffers()
        self._spec_sig = sig
        # After a partial commit only the unmatched tail resimulates, with
        # no Load: the absorb positions the state.
        tail = steps[n_commit:]
        if n_commit > 0:
            burst_load, burst_start = None, load_frame + n_commit
        else:
            burst_load, burst_start = load_frame, start
        zeros = self.input_spec.zeros_np(self.num_players)
        tail_bits = (np.stack([np.asarray(s.adv.bits) for s in tail]) if tail
                     else np.zeros((0,) + zeros.shape, zeros.dtype))
        tail_status = (np.stack([np.asarray(s.adv.status) for s in tail]) if tail
                       else np.zeros((0, self.num_players), np.int32))
        self.device_dispatches_total += 1
        with self.metrics.timer("tick_dispatch"), self.tracer.span("tick_dispatch"):
            (self.ring, self.state, absorb_cs, burst_cs,
             spec_rings, spec_states, spec_cs) = self._fused.run(
                self.ring, self.state, prev_r, prev_s,
                branch=absorb_branch,
                absorb_first=load_frame if load_frame is not None else 0,
                absorb_n=n_commit,
                prev_anchor=res.start_frame if res is not None else 0,
                prev_total=res.num_frames if res is not None else 0,
                load_frame=burst_load, start_frame=burst_start,
                bits=tail_bits, status=tail_status, n_burst=len(tail),
                spec_anchor=anchor, spec_from_live=(anchor == end),
                branch_bits=bits,
            )
        self.saves_total += len(tail)
        self.spec_rollouts_total += 1
        self._result = SpecResult(rings=spec_rings, states=spec_states, checksums=spec_cs,
                                  branch_bits=bits, start_frame=int(anchor),
                                  num_frames=self.spec_frames)
        self.ledger.record_rollout(self.num_branches * self.spec_frames)
        self.frame = end
        self.metrics.count("frames_advanced", n_steps)
        if load_frame is not None:
            self.rollbacks_total += 1
            self.metrics.count("rollbacks")
            self.metrics.observe("rollback_depth", n_steps)
            if n_commit > 0:
                self.rollback_frames_recovered_total += n_commit
                self.metrics.count("rollback_frames_recovered", n_commit)
                if n_commit == n_steps:
                    self.spec_hits += 1
                    self.metrics.count("spec_hits")
                else:
                    self.spec_partial_hits += 1
                    self.metrics.count("spec_partial_hits")
                    self.rollback_frames_total += len(tail)
                    self.metrics.count("rollback_frames", len(tail))
            else:
                self.rollback_frames_total += n_steps
                self.metrics.count("rollback_frames", n_steps)
            outcome = (("full" if n_commit == n_steps else "partial") if n_commit > 0
                       else ("miss" if missed else "unmatched"))
            self.ledger.record(
                outcome, depth=n_steps, frames_recovered=n_commit,
                frames_resimulated=n_steps - n_commit,
                branch=absorb_branch if n_commit > 0 else None,
                rank=absorb_branch if n_commit > 0 else None,
                blame_player=blame_player, blame_frame=blame_frame, load_frame=load_frame,
            )
        if session is not None and self.report_checksums:
            wants = getattr(session, "wants_checksum", None)
            report_a = [(t, load_frame + t) for t in range(n_commit)
                        if wants is None or wants(load_frame + t)]
            report_b = [(t, burst_start + t) for t in range(len(tail))
                        if wants is None or wants(burst_start + t)]
            if report_a:
                self._pending_reports.append((absorb_cs, report_a))
            if report_b:
                self._pending_reports.append((burst_cs, report_b))
        self._gc_log()

    def flush_reports(self, session) -> None:
        """Deliver the deferred checksum reports (the device reads happen
        here, off the producing tick). Called at the start of every
        :meth:`tick` and by the stage before it polls the network."""
        if not self._pending_reports or session is None:
            return
        pending, self._pending_reports = self._pending_reports, []
        with self.metrics.timer("checksum_sync"):
            host = [(arr.cpu().numpy(), rows) for arr, rows in pending]
        for cs_host, rows in host:
            for t, frame in rows:
                session.report_checksum(frame, combine64(cs_host[t]))

    def _dedup_sig(self, anchor: int, last, known, known_mask) -> tuple:
        """What a rollout from a ring-fixed anchor depends on: the anchor,
        the inputs it starts from and pins, and the input-log window the
        tree reads."""
        return (anchor, np.asarray(last).tobytes(), known.tobytes(), known_mask.tobytes(),
                self._history_fingerprint(anchor))

    def _branch_tensor(self, last, known, known_mask, anchor: int) -> np.ndarray:
        """The next rollout's host branch tensor: the sampler's draw with
        the known inputs pinned and branch 0 the session's forward-fill
        prediction, or the structured tree."""
        if self._sampler is not None:
            bits = enumerate_branches(self._generator, np.asarray(last), self.num_branches,
                                      self.spec_frames, sampler=self._sampler)
            bits = np.array(np.asarray(bits))
            if known_mask.any():
                extra = bits.ndim - 3
                mask_b = known_mask.reshape((1,) + known_mask.shape + (1,) * extra)
                bits = np.where(mask_b, known[None], bits)
                bits[0] = _forward_fill(np.asarray(last), known, known_mask)
            return bits
        with self.metrics.timer("structured_bits_build"):
            return self._structured_bits(np.asarray(last), known, known_mask, anchor)

    def speculate(self, confirmed_frame: int, session=None) -> None:
        """Dispatch the next rollout from the confirmed frontier (frame
        ``confirmed_frame + 1``); a later rollback consumes it. Call after
        :meth:`handle_requests` each tick. With the ``session``, inputs
        already confirmed inside the span pin to their values in every
        branch."""
        if not self.speculation_enabled:
            self._result = None
            return
        anchor = confirmed_frame + 1
        if anchor > self.frame:
            self._result = None  # fully confirmed: nothing to speculate
            return
        if anchor <= self.frame - self.ring.depth:
            self._result = None  # the anchor left the ring
            return
        last = self._input_log.get(anchor - 1)
        if last is None:
            last = self.input_spec.zeros_np(self.num_players)
        with self.metrics.timer("known_inputs_query"):
            known, known_mask = self._known_inputs(anchor, session)
        if anchor < self.frame and self._sampler is None:
            # The anchor state is a ring snapshot and the tree is
            # deterministic in (anchor, last, known) and the input-log
            # window: the same signature is the same rollout. A live-state
            # anchor, or a random sampler, never dedups.
            sig = self._dedup_sig(anchor, last, known, known_mask)
            if self._result is not None and sig == self._spec_sig:
                self.spec_dispatches_skipped += 1
                self.metrics.count("spec_dispatches_skipped")
                return
            self._spec_sig = sig
        else:
            self._spec_sig = None
        bits = self._branch_tensor(last, known, known_mask, anchor)
        with self.metrics.timer("speculate_dispatch"), self.tracer.span("speculate_dispatch"):
            self._result = self._dispatch_rollout(anchor, bits)

    def _commit_full_hit(self, load_frame: int, n_commit: int, branch: int,
                         res: SpecResult, steps: List[_Step], session) -> None:
        """The full-hit path: one absorb commits the matched branch's
        precomputed frames. See :meth:`tick`."""
        self.device_dispatches_total += 1
        with self.metrics.timer("spec_commit"):
            self.ring, self.state, absorb_cs = self._fused.commit_absorb(
                self.ring, res.rings, res.states, branch, load_frame, n_commit,
                res.start_frame, res.num_frames)
        self.frame = load_frame + n_commit
        self.rollbacks_total += 1
        self.rollback_frames_recovered_total += n_commit
        self.spec_hits += 1
        self.metrics.count("rollbacks")
        self.metrics.count("rollback_frames_recovered", n_commit)
        self.metrics.count("frames_advanced", n_commit)
        self.metrics.observe("rollback_depth", len(steps))
        self.metrics.count("spec_hits")
        if session is not None and self.report_checksums:
            wants = getattr(session, "wants_checksum", None)
            report = [(t, load_frame + t) for t in range(n_commit)
                      if wants is None or wants(load_frame + t)]
            if report:
                self._pending_reports.append((absorb_cs, report))

    def _prev_buffers(self):
        """The previous rollout's branch rings and states, which the tick's
        absorb phase reads; ``(None, None)`` when no rollout is pending
        (the absorb phase is then off)."""
        res = self._result
        if res is not None:
            return res.rings, res.states
        return None, None

    def _dispatch_rollout(self, anchor: int, branch_bits) -> SpecResult:
        """A rollout alone from ``anchor`` (the live state when ``anchor ==
        self.frame``, else its ring snapshot): the fused executor with the
        absorb and burst phases off. The speculate() and attestation entry;
        it writes only the rollout's own rings."""
        zeros = self.input_spec.zeros_np(self.num_players)
        out = self._fused.run(
            self.ring, self.state, None, None,
            branch=0, absorb_first=0, absorb_n=0, prev_anchor=0, prev_total=0,
            load_frame=None, start_frame=self.frame,
            bits=np.zeros((0,) + zeros.shape, zeros.dtype),
            status=np.zeros((0, self.num_players), np.int32), n_burst=0,
            spec_anchor=anchor, spec_from_live=(anchor == self.frame),
            branch_bits=branch_bits,
        )
        self.device_dispatches_total += 1
        self.spec_rollouts_total += 1
        self.ledger.record_rollout(self.num_branches * self.spec_frames)
        _, _, _, _, spec_rings, spec_states, spec_cs = out
        return SpecResult(rings=spec_rings, states=spec_states, checksums=spec_cs,
                          branch_bits=np.asarray(branch_bits), start_frame=int(anchor),
                          num_frames=self.spec_frames)

    def _known_inputs(self, anchor: int, session):
        """``(known[F, P, ...], mask[F, P])``: inputs already confirmed
        inside the rollout span, from the session's bulk
        ``confirmed_span`` (or its per-frame ``confirmed_input``)."""
        F, P = self.spec_frames, self.num_players
        zeros = self.input_spec.zeros_np(P)
        known = np.broadcast_to(zeros, (F,) + zeros.shape).copy()
        mask = np.zeros((F, P), dtype=bool)
        span = getattr(session, "confirmed_span", None)
        if span is not None:
            for h in range(P):
                vals, m = span(h, anchor, F)
                if m.any():
                    known[m, h] = vals[m]
                    mask[:, h] = m
            return known, mask
        getter = getattr(session, "confirmed_input", None)
        if getter is None:
            return known, mask
        for t in range(F):
            for h in range(P):
                got = getter(h, anchor + t)
                if got is not None:
                    known[t, h] = np.asarray(got)
                    mask[t, h] = True
        return known, mask

    def _candidate_values(self, last: np.ndarray):
        """History-ranked candidates ``(C[P, n_field, R], valid[P,
        n_field, R])`` for the structured tree, best first: values the
        player used recently (newest first), then single-bit press/release
        toggles of ``last`` (recently toggling bits first), then the
        declared universe; all clamped to the universe."""
        P = self.num_players
        shape = self.input_spec.shape
        n_field = int(np.prod(shape, dtype=np.int64)) if shape else 1
        dtype = self.input_spec.zeros_np(1).dtype
        universe = np.asarray(self._branch_values, dtype=dtype).reshape(-1)
        lastf = np.asarray(last).reshape(P, n_field)
        frames = sorted(self._input_log)[-32:]
        hist = (np.stack([np.asarray(self._input_log[f]).reshape(P, n_field)
                          for f in frames])
                if frames else np.zeros((0, P, n_field), dtype))
        integer = np.issubdtype(dtype, np.integer)
        rows = []
        max_r = 0
        for h in range(P):
            for k in range(n_field):
                seq = hist[::-1, h, k]  # newest first
                if seq.size:
                    _, first = np.unique(seq, return_index=True)
                    recent = list(seq[np.sort(first)])
                else:
                    recent = []
                toggles = []
                if integer:
                    changed = (int(np.bitwise_or.reduce(np.bitwise_xor(seq[1:], seq[:-1])))
                               if seq.size >= 2 else 0)
                    top = int(max((int(v) for v in universe), default=0))
                    limit = max(changed, top)
                    all_bits = []
                    bit = 1
                    while bit <= limit:
                        all_bits.append(bit)
                        bit <<= 1
                    ordered = ([b for b in all_bits if changed & b]
                               + [b for b in all_bits if not (changed & b)])
                    toggles = [dtype.type(int(lastf[h, k]) ^ b) for b in ordered]
                allowed = {v.item() if hasattr(v, "item") else v for v in universe}
                row, seen = [], set()
                for v in [*recent, *toggles, *universe]:
                    key = v.item() if hasattr(v, "item") else v
                    if key not in seen and key in allowed:
                        seen.add(key)
                        row.append(v)
                rows.append(row)
                max_r = max(max_r, len(row))
        C = np.zeros((P, n_field, max_r), dtype)
        valid = np.zeros((P, n_field, max_r), bool)
        for i, row in enumerate(rows):
            h, k = divmod(i, n_field)
            C[h, k, : len(row)] = row
            valid[h, k, : len(row)] = True
        return C, valid

    def _history_fingerprint(self, anchor: int) -> tuple:
        """Digest of what the structured tree reads from the input log: the
        latest logged frame and a CRC of the contiguous window of up to 48
        frames ending at ``anchor - 1``."""
        L = anchor - 1
        start = L
        while start - 1 in self._input_log and L - (start - 1) < 48:
            start -= 1
        digest = 0
        for f in range(start, L + 1):
            got = self._input_log.get(f)
            if got is not None:
                digest = zlib.crc32(np.ascontiguousarray(got).tobytes(), digest)
        return (max(self._input_log, default=-1), start, digest)

    def _extrapolate_base(self, base: np.ndarray, known: np.ndarray,
                          known_mask: np.ndarray, anchor: int) -> Optional[np.ndarray]:
        """Per-(player, field) periodic extrapolation of the as-used input
        history: the smallest period p in 2..16 with ``seq[p:] ==
        seq[:-p]`` over a contiguous window of up to 48 frames ending at
        the anchor predicts future frame g as the logged value at ``g -
        p``. Returns the extrapolated base with the known slots pinned, or
        None when no player or field has a non-constant period."""
        F, P = self.spec_frames, self.num_players
        shape = self.input_spec.shape
        n_field = int(np.prod(shape, dtype=np.int64)) if shape else 1
        L = anchor - 1
        start = L
        while start - 1 in self._input_log and L - (start - 1) < 48:
            start -= 1
        if L not in self._input_log or L - start + 1 < 8:
            return None
        frames = range(start, L + 1)
        hist = np.stack([np.asarray(self._input_log[f]).reshape(P, n_field)
                         for f in frames])  # [W, P, K]
        predf = base.reshape(F, P, n_field).copy()
        universe = np.asarray(self._branch_values, dtype=hist.dtype).reshape(-1)
        found = False
        for h in range(P):
            for k in range(n_field):
                seq = hist[:, h, k]
                # A history with values outside the attested universe is
                # not replayed into branch bases.
                if universe.size and not np.isin(seq, universe).all():
                    continue
                n = seq.shape[0]
                period = 0
                for p in range(2, min(16, n // 2) + 1):
                    if np.array_equal(seq[p:], seq[:-p]):
                        period = p
                        break
                if not period or (seq[-period:] == seq[-1]).all():
                    continue  # aperiodic, or constant (= repeat-last)
                found = True
                for t in range(F):
                    off = (anchor + t) - L
                    g0 = (anchor + t) - period * (-(-off // period))
                    predf[t, h, k] = hist[g0 - start, h, k]
        if not found:
            return None
        knownf = np.asarray(known).reshape(F, P, n_field)
        predf = np.where(known_mask[:, :, None], knownf, predf)
        return predf.reshape(base.shape)

    def _structured_bits(self, last: np.ndarray, known: np.ndarray,
                         known_mask: np.ndarray, anchor: Optional[int] = None) -> np.ndarray:
        """The default branch tree: branch 0 is the session's own
        prediction (known inputs pinned, unknowns repeat-last); with a
        periodic history branch 1 is the extrapolated pattern; every other
        branch changes one player's unknown suffix (one field of it, for
        vector payloads) to one candidate value from one frame on. The
        enumeration is (candidate rank, frame, player, field)-major over
        :meth:`_candidate_values`, so every slot gets its best candidate
        before any slot gets its second."""
        F, P, B = self.spec_frames, self.num_players, self.num_branches
        shape = self.input_spec.shape
        base = _forward_fill(last, known, known_mask)  # [F, P, *shape]
        if B <= 1 or not self._branch_values:
            return np.broadcast_to(base, (B, F, P) + shape).copy()
        if anchor is None:
            anchor = max(self._input_log, default=0) + 1
        pred = self._extrapolate_base(base, known, known_mask, anchor)
        eff_base = base if pred is None else pred
        out = np.broadcast_to(eff_base, (B, F, P) + shape).copy()
        out[0] = base
        start_b = 1
        if pred is not None and not np.array_equal(pred, base):
            start_b = 2  # out[1] is the unperturbed extrapolation
        C, cvalid = self._candidate_values(last)  # [P, K, R]
        n_field = C.shape[1]
        basef = eff_base.reshape(F, P, n_field)
        free = ~known_mask  # [F, P]
        cv = C.transpose(2, 0, 1)  # [R, P, K]
        elig = (
            free[None, :, :, None]
            & cvalid.transpose(2, 0, 1)[:, None, :, :]
            & (cv[:, None, :, :] != basef[None, :, :, :])
        )  # [R, F, P, K]
        idx = np.flatnonzero(elig.reshape(-1))[: B - start_b]
        if idx.size == 0:
            return out
        r_i, t_i, h_i, k_i = np.unravel_index(idx, elig.shape)
        # Each branch writes its value over the changed player's unpinned
        # suffix (frames >= t not known for that player).
        suffix = (np.arange(F)[None, :] >= t_i[:, None]) & free[:, h_i].T  # [n_sel, F]
        bb, ff = np.nonzero(suffix)
        outf = out.reshape(B, F, P, n_field)
        outf[start_b + bb, ff, h_i[bb], k_i[bb]] = C[h_i[bb], k_i[bb], r_i[bb]]
        return out

    # ------------------------------------------------------------------

    def _ledger_blame(self, res: SpecResult, load_frame: int, steps):
        """``(blame_player, blame_frame)``: the first input at which the
        corrected history diverges from branch 0 over the rollback span;
        ``(None, None)`` when branch 0 agreed."""
        pre = load_frame - res.start_frame
        k = min(len(steps), res.num_frames - pre)
        if k <= 0:
            return None, None
        b0 = np.asarray(res.branch_bits)[0]
        corrected = np.stack([np.asarray(s.adv.bits) for s in steps[:k]])
        hit = blame_divergence(b0[pre:pre + k], corrected)
        if hit is None:
            return None, None
        return hit[1], load_frame + hit[0]

    def _try_commit(self, load_frame: int, steps: List[_Step], session) -> bool:
        """Commit a matching branch for a ``[Load, (Save, Advance)*]``
        burst; False (the serial path follows) when no branch matches."""
        res = self._result
        if res is None or not steps:
            return False
        anchor = res.start_frame
        n_steps = len(steps)
        if load_frame < anchor:
            return False
        # Only the standard recovery burst (save and advance every step,
        # saves labelled from the load frame) commits.
        if any(s.adv is None or s.save_frame != load_frame + t for t, s in enumerate(steps)):
            return False
        pre = load_frame - anchor
        needed = []
        for f in range(anchor, load_frame):
            got = self._input_log.get(f)
            if got is None:
                return False
            needed.append(got)
        needed.extend(np.asarray(s.adv.bits) for s in steps)
        needed_arr = np.stack(needed)[: res.num_frames]  # [k, P, ...]
        branch, depth = match_branch(res.branch_bits, needed_arr)
        n_commit = min(depth - pre, n_steps)
        if n_commit <= 0:
            self.spec_misses += 1
            self.metrics.count("spec_misses")
            if self.ledger.enabled:
                # The serial path that follows records this rollback's
                # entry, with the detail the matcher just computed.
                bp, bf = self._ledger_blame(res, load_frame, steps)
                self._ledger_note = {"outcome": "miss", "blame_player": bp,
                                     "blame_frame": bf}
            return False

        with self.metrics.timer("spec_commit"):
            self.device_dispatches_total += 3  # 2 branch selects + absorb
            spec_ring, spec_state = self._spec.commit(res, branch)
            self.ring, self.state, checksums = absorb_branch_frames(
                self.ring, spec_ring, spec_state, load_frame, n_commit, anchor,
                res.num_frames, self.executor.max_frames)
        if session is not None and self.report_checksums:
            wants = getattr(session, "wants_checksum", None)
            report = [t for t in range(n_commit) if wants is None or wants(load_frame + t)]
            if report:
                cs_host = checksums.cpu().numpy()  # [T, 2] lo/hi lanes
                for t in report:
                    session.report_checksum(load_frame + t, combine64(cs_host[t]))
        for t, s in enumerate(steps[:n_commit]):
            self._input_log[load_frame + t] = np.asarray(s.adv.bits)
        self.frame = load_frame + n_commit
        self.rollbacks_total += 1
        # Committed frames were never resimulated: not in rollback_frames_total.
        self.rollback_frames_recovered_total += n_commit
        self.metrics.count("rollbacks")
        self.metrics.count("rollback_frames_recovered", n_commit)
        self.metrics.count("frames_advanced", n_commit)
        self.metrics.observe("rollback_depth", n_steps)
        if self.ledger.enabled:
            bp, bf = self._ledger_blame(res, load_frame, steps)
        else:
            bp = bf = None
        self.ledger.record(
            "full" if n_commit == n_steps else "partial",
            depth=n_steps, frames_recovered=n_commit, frames_resimulated=n_steps - n_commit,
            branch=int(branch), rank=int(branch), blame_player=bp, blame_frame=bf,
            load_frame=load_frame,
        )
        if n_commit == n_steps:
            self.spec_hits += 1
            self.metrics.count("spec_hits")
        else:
            # A prefix hit: resimulate the unmatched tail from the
            # committed state (no Load: the state is already positioned).
            self.spec_partial_hits += 1
            self.metrics.count("spec_partial_hits")
            tail = steps[n_commit:]
            self.rollback_frames_total += len(tail)
            self.metrics.count("rollback_frames", len(tail))
            self._run_segment(None, tail, session)
        return True

    def _gc_log(self) -> None:
        # Matching needs a ring's depth of history; the candidate ranking
        # and the periodic extrapolation read up to 48 frames.
        horizon = self.frame - self.ring.depth - 64
        for f in [f for f in self._input_log if f < horizon]:
            del self._input_log[f]
