"""The session axis: S independent matches advanced by one batched tick.

Counterpart of ``bevy_ggrs_tpu/serve/batch.py``. A server hosting many
small matches would pay, per match, its own launches and its own slice of
the 16.7 ms frame. Here the fused tick (absorb + serial burst + B-branch
speculative rollout, ``fused.py``) runs over a leading ``[S]`` slot axis:
one batched tick advances S matches — each with its OWN frame counter,
rollback depth and branch tree. JAX vmaps its traced tick program over
the slot axis; the port runs the same four phases eagerly over the
stacked tensors (:class:`BatchedTickExecutor`):

1. absorb: each slot with a speculation hit copies its matched branch's
   rows into its ring (index gathers and writes over the slots that
   absorb, a step at a time);
2. the slot-batched burst (``rollout.rollout_burst_slots``): per step one
   checksum-kernel launch saves every slot that saves, at its own frame
   (per-slot frames and a keep-mask, computed in the kernel), and one
   ``[S]`` schedule step advances the slots whose advance is on;
3. anchors, per slot: the live state or its ring's row;
4. the rollout over the flattened ``[S·B]`` world into fresh ``[S·B, F]``
   rings, one save launch per frame for all S·B worlds.

So a tick makes exactly (burst steps in which some slot saves) + F
checksum launches, whatever S.

Design rules, as in the JAX package:

- **Fixed capacity, padding + no-op masks.** The batch always carries S
  slots. A slot with no work this tick runs with every phase off for it
  (``absorb_n=0``, all burst masks False, no load).
- **Admit/retire without new preparation.** Admission writes a fresh
  singleton (ring, state) into a slot row with ``index_copy_``, the slot
  index a device tensor. Retirement is host-only bookkeeping.
  ``utils.build_cache.compile_counters()`` (kernel builds, layout
  misses, tick structures met for the first time) is the observable
  this contract is asserted against.
- **No-op slots REPLAY their previous rollout.** Every tick's rollout
  covers all S slots and replaces the previous ``[S, B, ...]`` buffers,
  so a slot that is not ticking re-rolls its previous (anchor, from-live,
  branch tensor) rollout, bitwise the same (its ring and state rows are
  untouched by its own no-op phases).
- **Full hits re-dispatch.** A full hit is absorb + empty tail + a fresh
  rollout; hit counters may differ from a singleton run, committed state
  does not.
- **Copies, never aliases.** The port's rings are written in place, so
  admission, :meth:`BatchedSessionCore.extract` (and the
  :class:`~bevy_ggrs_tpu_torch.serve.faults.SlotTicket` it returns) and
  the per-slot views copy rows; each rollout writes rings of its own.

Host-side per-slot speculation (branch build, match, input log) reuses
the singleton implementation: the native builder per slot and the
consolidated ``NativeBatchPlane`` by default, or (``GGRS_NO_NATIVE=1``)
:class:`~bevy_ggrs_tpu_torch.spec_runner.SpeculativeRollbackRunner`'s
tree-builder methods borrowed unbound through :class:`_SlotSpecShim`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.native import spec as native_spec
from bevy_ggrs_tpu_torch.obs.ledger import blame_divergence
from bevy_ggrs_tpu_torch.obs.trace import pop_span, push_span
from bevy_ggrs_tpu_torch.parallel.speculate import match_branch
from bevy_ggrs_tpu_torch.predict.batch import BatchedRanker
from bevy_ggrs_tpu_torch.predict.model import resolve_predictor
from bevy_ggrs_tpu_torch.rollout import ring_load_slots, rollout_burst_slots, select_slots
from bevy_ggrs_tpu_torch.runner import RollbackRunner, _Step
from bevy_ggrs_tpu_torch.schedule import PREDICTED, Schedule
from bevy_ggrs_tpu_torch.serve.faults import SlotFault, SlotTicket
from bevy_ggrs_tpu_torch.session.requests import AdvanceFrame, RestoreGameState
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner
from bevy_ggrs_tpu_torch.state import (
    SnapshotRing,
    WorldState,
    branch_rings,
    combine64,
    resolve_device,
    ring_init,
    signed_view,
    tree_map,
)
from bevy_ggrs_tpu_torch.utils import build_cache

# The tick structures (world leaves, device, branch tensor) this process
# has run: a structure met for the first time is a shape preparation.
_TICK_SHAPES: set = set()


def _index(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def absorb_slots(rings: SnapshotRing, states: WorldState, prev_rings: SnapshotRing,
                 prev_states: WorldState, branch, first, n, anchor, total,
                 max_steps: int) -> Tuple[WorldState, torch.Tensor]:
    """Phase 1 over the slot axis (``fused.absorb_branch_frames`` per
    slot): slot ``s`` with ``n[s] > 0`` copies frames ``first[s] ..
    first[s] + n[s] - 1`` (rows, frames, stored digests) from branch
    ``branch[s]`` of its previous rollout (``prev_rings`` ``[S, B, F]``)
    into its ring, in place, and takes the state entering the frame after
    them: the branch ring's next row, or the branch's final state when the
    replay consumed the whole rollout. Host ``[S]`` ints describe the
    slots. Returns ``(states, checksums[S, max_steps, 2])``, zeros where
    nothing was absorbed."""
    n = np.asarray(n)
    device = rings.frames.device
    S = n.shape[0]
    checksums = torch.zeros((S, max_steps, 2), dtype=torch.int64, device=device)
    act = np.flatnonzero(n > 0)
    if act.size == 0:
        return states, checksums
    first, branch = np.asarray(first, np.int64), np.asarray(branch, np.int64)
    depth, F = rings.depth, prev_rings.depth
    for t in range(int(n[act].max())):
        sel = act[n[act] > t]
        f = first[sel] + t
        si, bi = _index(sel, device), _index(branch[sel], device)
        src, dst = _index(f % F, device), _index(f % depth, device)

        def put(m, p):
            signed_view(m)[si, dst] = signed_view(p)[si, bi, src]

        tree_map(put, rings.states, prev_rings.states)
        rings.frames[si, dst] = torch.as_tensor(f.astype(np.int32), device=device)
        lanes = prev_rings.checksums[si, bi, src]
        rings.checksums[si, dst] = lanes
        checksums[si, t] = lanes
    end = first[act] + n[act]
    in_ring = end < np.asarray(anchor, np.int64)[act] + np.asarray(total, np.int64)[act]
    rows, final = act[in_ring], act[~in_ring]
    if rows.size:
        ri, rb = _index(rows, device), _index(branch[rows], device)
        rr = _index(end[in_ring] % F, device)
        tree_map(lambda x, p: signed_view(x).index_put_(
            (ri,), signed_view(p)[ri, rb, rr]), states, prev_rings.states)
    if final.size:
        fi, fb = _index(final, device), _index(branch[final], device)
        tree_map(lambda x, p: signed_view(x).index_put_(
            (fi,), signed_view(p)[fi, fb]), states, prev_states)
    return states, checksums


class BatchedTickExecutor:
    """The fused tick over a leading ``[S]`` slot axis, plus the admit
    write. Every :class:`BatchedSessionCore` of one model family (and
    every stagger group of a :class:`~bevy_ggrs_tpu_torch.serve.server.
    MatchServer`) should share one instance."""

    def __init__(
        self,
        schedule: Schedule,
        num_slots: int,
        burst_frames: int,
        num_branches: int,
        spec_frames: int,
    ):
        self.schedule = schedule
        self.num_slots = int(num_slots)
        self.burst_frames = int(burst_frames)
        self.num_branches = int(num_branches)
        self.spec_frames = int(spec_frames)
        self.calls = 0  # batched ticks run
        # The last tick's burst steps in which some slot saved (each one
        # checksum launch) and advanced (each one [S] schedule step); the
        # rollout adds F of each.
        self.last_save_steps = 0
        self.last_adv_steps = 0
        self._shapes = set()  # the (structure, device) keys ticks ran at
        self._spec_status = {}  # (players, device) -> the rollout's status
        self._slot_ids = {}  # device -> arange(S): admission's slot index
        # Cost-observatory hook: when armed, the NEXT tick records its peak
        # device bytes into utils.build_cache under this name.
        self._cost_name: Optional[str] = None
        self._captured_name: Optional[str] = None

    def enable_cost_capture(self, name: str) -> None:
        self._cost_name = str(name)

    def cost(self) -> dict:
        """The captured cost record for this executor ({} until a tick ran
        with capture armed, or without a GPU)."""
        if self._captured_name is None:
            return {}
        return build_cache.executable_costs().get(self._captured_name, {})

    def admit(self, rings: SnapshotRing, states: WorldState, slot: int,
              new_ring: SnapshotRing, new_state: WorldState):
        """Write a singleton (ring, state) into slot row ``slot`` of the
        stacked trees, in place: ``index_copy_`` with the slot index a
        device tensor, so no admission prepares anything per slot. The
        written rows are copies; the caller's ring and state stay its
        own."""
        device = rings.frames.device
        ids = self._slot_ids.get(device)
        if ids is None:
            ids = self._slot_ids[device] = torch.arange(self.num_slots, device=device)
        idx = ids[int(slot):int(slot) + 1]

        def write(big, row):
            signed_view(big).index_copy_(0, idx, signed_view(row.to(device))[None])

        tree_map(write, rings.states, new_ring.states)
        write(rings.frames, new_ring.frames)
        write(rings.checksums, new_ring.checksums)
        tree_map(write, states, new_state)
        return rings, states

    def cache_size(self) -> int:
        """How many distinct world structures (and devices) the tick has run
        at: 1 after warmup, and it must STAY 1 through any amount of match
        churn (the JAX package's compiled-variant count)."""
        return len(self._shapes)

    def run(
        self,
        rings, states, prev_rings, prev_states,
        branch, absorb_first, absorb_n, prev_anchor, prev_total,
        do_load, load_frame, start_frame,
        bits, status, save_mask, adv_mask,
        spec_from_live, spec_anchor, branch_bits,
    ):
        """One batched tick. Scalar args are host ``[S]`` arrays, tensors
        host ``[S, ...]`` arrays; ``rings``/``states`` are the stacked
        device trees (updated in place), ``prev_rings``/``prev_states``
        the previous rollout's (None before the first). Returns ``(rings,
        states, absorb_cs, burst_cs, spec_rings, spec_states, spec_cs)``,
        nothing read back."""
        args = (rings, states, prev_rings, prev_states, branch, absorb_first, absorb_n,
                prev_anchor, prev_total, do_load, load_frame, start_frame, bits, status,
                save_mask, adv_mask, spec_from_live, spec_anchor, branch_bits)
        sig = []
        tree_map(lambda x: sig.append((tuple(x.shape), x.dtype)), states)
        bb = np.asarray(branch_bits)
        key = (tuple(sig), str(states.device), bb.shape, bb.dtype)
        # A tick structure this process has not run yet is one shape
        # preparation in utils.build_cache, timed over its first tick.
        first = (contextlib.nullcontext() if key in _TICK_SHAPES else build_cache.timed(
            "shape", f"serve tick S={self.num_slots} B={self.num_branches} "
                     f"F={self.spec_frames} {states.device}"))
        with first:
            if self._cost_name is not None:
                name, self._cost_name = self._cost_name, None
                self._captured_name = name
                out = build_cache.priced_call(name, self._run, *args)
            else:
                out = self._run(*args)
        _TICK_SHAPES.add(key)
        self._shapes.add(key)
        return out

    def _run(self, rings, states, prev_rings, prev_states, branch, absorb_first,
             absorb_n, prev_anchor, prev_total, do_load, load_frame, start_frame,
             bits, status, save_mask, adv_mask, spec_from_live, spec_anchor,
             branch_bits):
        S, B, F = self.num_slots, self.num_branches, self.spec_frames
        bb = np.ascontiguousarray(np.asarray(branch_bits))
        if bb.shape[:3] != (S, B, F):
            raise ValueError(f"branch_bits {bb.shape[:3]} != ({S}, {B}, {F})")
        device = states.device
        self.calls += 1
        # Phase 1: absorb each hit's precomputed frames.
        if np.any(np.asarray(absorb_n) > 0):
            states, absorb_cs = absorb_slots(
                rings, states, prev_rings, prev_states, branch, absorb_first,
                absorb_n, prev_anchor, prev_total, self.burst_frames)
        else:
            absorb_cs = torch.zeros((S, self.burst_frames, 2), dtype=torch.int64,
                                    device=device)
        # Phase 2: the serial burst of every slot (rollback resimulation, a
        # partial hit's unmatched tail, or the steady advance).
        do_load = np.asarray(do_load, bool)
        loads = np.flatnonzero(do_load)
        if loads.size:
            li = _index(loads, device)
            rows = _index(np.mod(np.asarray(load_frame, np.int64)[loads], rings.depth), device)
            tree_map(lambda x, r: signed_view(x).index_put_((li,), signed_view(r)[li, rows]),
                     states, rings.states)
        self.last_save_steps = int(np.asarray(save_mask, bool).any(axis=0).sum())
        self.last_adv_steps = int(np.asarray(adv_mask, bool).any(axis=0).sum())
        frame0 = np.where(do_load, load_frame, start_frame)
        rings, states, burst_cs = rollout_burst_slots(
            self.schedule, rings, states, frame0,
            torch.as_tensor(np.ascontiguousarray(bits), device=device),
            torch.as_tensor(np.ascontiguousarray(status, np.int32), device=device),
            save_mask, adv_mask)
        # Phase 3: each slot's anchor: the live state when the anchor is
        # the new frame, else its ring's row of the (older) anchor frame.
        from_live = np.asarray(spec_from_live, bool)
        if from_live.all():
            anchor = states
        else:
            anchor = select_slots(torch.as_tensor(from_live, device=device), states,
                                  ring_load_slots(rings, spec_anchor))
        # Phase 4: every slot's B branches as one [S·B] world, F frames.
        SB = S * B
        world = tree_map(lambda x: x[:, None].expand((S, B) + tuple(x.shape[1:]))
                         .reshape((SB,) + tuple(x.shape[1:])), anchor)
        spec_rings = branch_rings(tree_map(lambda x: x[0], anchor), SB, F)
        P = bb.shape[3]
        key = (P, device)
        spec_status = self._spec_status.get(key)
        if spec_status is None:
            spec_status = self._spec_status[key] = torch.full(
                (F, P), PREDICTED, dtype=torch.int32, device=device)
        ones = np.ones((SB, F), dtype=bool)
        spec_rings, spec_states, spec_cs = rollout_burst_slots(
            self.schedule, spec_rings, world,
            np.repeat(np.asarray(spec_anchor, np.int64), B),
            torch.as_tensor(bb.reshape((SB,) + bb.shape[2:]), device=device),
            spec_status[None].expand(SB, F, P), ones, ones)
        spec_rings = SnapshotRing(
            states=tree_map(lambda x: x.reshape((S, B) + tuple(x.shape[1:])), spec_rings.states),
            frames=spec_rings.frames.view(S, B, F),
            checksums=spec_rings.checksums.view(S, B, F, 2))
        spec_states = tree_map(lambda x: x.reshape((S, B) + tuple(x.shape[1:])), spec_states)
        return (rings, states, absorb_cs, burst_cs, spec_rings, spec_states,
                spec_cs.view(S, B, F, 2))


class _SlotSpecShim:
    """Adapter exposing exactly the attributes the singleton runner's
    branch-tree methods read, so they can run UNBOUND against a per-slot
    input log. Any drift between batched and singleton trees is therefore
    impossible short of editing the singleton itself."""

    _structured_bits = SpeculativeRollbackRunner._structured_bits
    _candidate_values = SpeculativeRollbackRunner._candidate_values
    _extrapolate_base = SpeculativeRollbackRunner._extrapolate_base
    _history_fingerprint = SpeculativeRollbackRunner._history_fingerprint
    _known_inputs = SpeculativeRollbackRunner._known_inputs

    def __init__(
        self, input_spec, num_players, num_branches, spec_frames,
        branch_values, input_log,
    ):
        self.input_spec = input_spec
        self.num_players = num_players
        self.num_branches = num_branches
        self.spec_frames = spec_frames
        self._branch_values = branch_values
        self._input_log = input_log


class _Slot:
    """Host-side record of one batch slot: match identity, frame counter,
    per-slot input log / native builder, and the metadata of the pending
    rollout living in row ``index`` of the core's prev buffers."""

    __slots__ = (
        "index", "active", "frame", "spec_on", "native", "input_log",
        "shim", "res_anchor", "res_bits", "res_from_live",
    )

    def __init__(self, index: int):
        self.index = index
        self.active = False
        self.frame = 0
        self.spec_on = True
        self.native = None
        self.input_log: dict = {}
        self.shim: Optional[_SlotSpecShim] = None
        self.res_anchor: Optional[int] = None
        self.res_bits: Optional[np.ndarray] = None
        self.res_from_live = True


class BatchedSessionCore:
    """S fixed-capacity match slots over stacked device state, advanced by
    one :class:`BatchedTickExecutor` dispatch per tick round.

    The per-slot request protocol matches the singleton runner's canonical
    tick: each slot submits one ``[Load?, (Save, Advance)*]`` segment per
    round with saves labeled contiguously (the session layer produces
    exactly this shape). ``RestoreGameState`` and non-standard bursts
    raise a typed :class:`~bevy_ggrs_tpu_torch.serve.faults.SlotFault` naming
    the offending slot — BEFORE any slot's host or device state is touched
    (every segment of every slot is validated ahead of the apply loop), so
    the server can drop the faulted slot, re-tick the rest, and drain the
    match to a singleton recovery lane via :meth:`extract`.

    Determinism-per-slot: every slot's committed trajectory is computed by
    the same batched tick regardless of what other slots are doing
    (phase gates are per-slot; lanes never interact), so a slot's state
    stream is bitwise-reproducible by a serial replay of its own inputs —
    the guarantee docs/serving.md specifies and
    tests/test_batched_sessions.py asserts.
    """

    def __init__(
        self,
        schedule: Schedule,
        initial_state: WorldState,
        max_prediction: int,
        num_players: int,
        input_spec,
        num_slots: int,
        num_branches: int = 8,
        spec_frames: Optional[int] = None,
        branch_values=None,
        metrics=None,
        tracer=None,
        executor: Optional[BatchedTickExecutor] = None,
        report_checksums: bool = True,
        timeseries=None,
        ledger=None,
        predictor=None,
        device=None,
    ):
        """``device`` is where the slots live (default ``cuda``, raising
        when there is no GPU); ``initial_state`` is moved there."""
        from bevy_ggrs_tpu_torch.obs.ledger import null_ledger
        from bevy_ggrs_tpu_torch.obs.timeseries import null_timeseries
        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.timeseries = (
            timeseries if timeseries is not None else null_timeseries
        )
        # Per-rollback causal accounting (obs/ledger.py). A MatchServer
        # passes a scoped view so entries carry fleet-unique flat slot
        # ids; entries here label the local match_slot.
        self.ledger = ledger if ledger is not None else null_ledger
        # Host-work decomposition arms only when someone is listening —
        # the clock reads would otherwise tax the per-slot loop for
        # nothing (the telemetry-off determinism guard stays exact).
        self._measure_host = (
            self.metrics is not null_metrics or self.timeseries.enabled
        )
        self.schedule = schedule
        self.num_players = int(num_players)
        self.input_spec = input_spec
        self.max_prediction = int(max_prediction)
        self.num_slots = int(num_slots)
        self.spec_frames = int(spec_frames or max_prediction)
        self.num_branches = int(num_branches)
        self.report_checksums = bool(report_checksums)
        if branch_values is not None:
            self._branch_values = list(branch_values)
        elif getattr(input_spec, "values", None):
            self._branch_values = list(input_spec.values)
        else:
            self._branch_values = list(range(16))
        # Ring/burst sizing mirrors RollbackRunner: depth = max_prediction
        # + 1 slack, burst padded to max_prediction + 2.
        self.ring_depth = self.max_prediction + 1
        self.burst_frames = self.max_prediction + 2
        if executor is not None:
            if executor.num_slots != self.num_slots:
                raise ValueError(
                    f"shared executor has {executor.num_slots} slots, core "
                    f"wants {self.num_slots}"
                )
            self._exec = executor
        else:
            self._exec = BatchedTickExecutor(
                schedule, self.num_slots, self.burst_frames,
                self.num_branches, self.spec_frames,
            )
        S, B, F = self.num_slots, self.num_branches, self.spec_frames
        self.device = resolve_device(device)
        self._template = tree_map(lambda x: x.to(self.device), initial_state)
        bcast = lambda prefix: tree_map(
            lambda x: x.reshape((1,) * len(prefix) + tuple(x.shape))
            .expand(prefix + tuple(x.shape)).contiguous(),
            self._template,
        )
        self.states = bcast((S,))
        self.rings = SnapshotRing(
            states=bcast((S, self.ring_depth)),
            frames=torch.full((S, self.ring_depth), -1, dtype=torch.int32,
                              device=self.device),
            checksums=torch.zeros((S, self.ring_depth, 2), dtype=torch.int64,
                                  device=self.device),
        )
        # Previous rollout buffers, replaced every tick (None until the
        # first): a slot's absorb phase only reads its row when that slot
        # has pending-rollout metadata.
        self.prev_states = None
        self.prev_rings = None
        self.slots = [_Slot(i) for i in range(S)]
        self._pending_reports: List[Tuple[object, List[tuple]]] = []
        zero = input_spec.zeros_np(self.num_players)
        self._zero = np.asarray(zero)
        self._zero_bb = np.zeros(
            (B, F) + self._zero.shape, self._zero.dtype
        )
        # Shared all-unknown (known, mask) for sessionless slots: the
        # builders only read these, and allocating them per slot per tick
        # was a measured chunk of the S=256 host budget.
        self._known0 = np.broadcast_to(
            self._zero, (F,) + self._zero.shape
        ).copy()
        self._mask0 = np.zeros((F, self.num_players), dtype=bool)
        # Learned input predictor (predict/): one BOUND predictor shared
        # by every slot (weights are per-deployment, not per-match), with
        # a batched ranker so ONE batched integer forward ranks candidates
        # for all predictor-eligible slots per dispatch. ``predictor=
        # None`` consults GGRS_PREDICTOR; binding falls back to None (and
        # the heuristic ranking) when the weights don't fit this input
        # geometry — exactly the singleton runner's resolution.
        shape = tuple(getattr(input_spec, "shape", ()) or ())
        n_field = int(np.prod(shape, dtype=np.int64)) if shape else 1
        self._predictor = resolve_predictor(
            predictor, self._branch_values, self._zero.dtype, n_field,
        )
        self._ranker = (
            BatchedRanker(self._predictor, self.spec_frames, device=self.device)
            if self._predictor is not None else None
        )
        # Native batched data plane (native/spec.NativeBatchPlane): the
        # whole per-slot host loop — as-used log appends, in-flight tree
        # matches, predictor window gather, branch-tree builds and no-op
        # tree re-use — consolidated into TWO C calls per dispatch.
        # ``GGRS_NO_NATIVE=1`` / unsupported dtypes keep the per-slot
        # path (bitwise identical, tests/test_native_batch.py).
        self._plane = native_spec.make_batch_plane(
            self.input_spec, self.num_players, S, B, F,
            self.burst_frames, self._predictor,
        )
        self.native_batch_calls = 0
        self.native_batch_ms_total = 0.0
        # Optional AttributionProbe (obs/attribution.py): when a bench
        # attaches one, the executor call is timed as a nested
        # device_wait (which synchronizes the card at its end), so device
        # execution is not billed as host work in the probe's enclosing
        # host window.
        self.attribution = None
        # Aggregate counters (per-slot views go through labeled metrics).
        self.ticks_total = 0
        self.device_dispatches_total = 0
        self.spec_hits = 0
        self.spec_partial_hits = 0
        self.spec_misses = 0
        self.rollbacks_total = 0
        self.rollback_frames_total = 0
        self.rollback_frames_recovered_total = 0
        # Last dispatch's measured host-work split (docs/serving.md
        # "Front door"): the known per-slot Python-loop budget, decomposed
        # so the ROADMAP's native-argument-assembly item has a baseline.
        self.last_branch_build_ms = 0.0
        self.last_arg_assembly_ms = 0.0
        self.last_predictor_rank_ms = 0.0
        self.predictor_rank_ms_total = 0.0
        self.predictor_rank_dispatches = 0

    # -- lifecycle ------------------------------------------------------

    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def free_slots(self) -> List[int]:
        return [s.index for s in self.slots if not s.active]

    def warmup(self) -> None:
        """Run the batched tick, the admit write and the digest passes once
        before serving (the kernels built, every layout prepared) —
        from here on, match churn must not build or prepare anything (the
        acceptance contract checked against ``compile_counters()``)."""
        self._dispatch({})
        # Identity write: a copy of row 0 written back onto it runs the
        # admit path without disturbing any occupant.
        self.rings, self.states = self._exec.admit(
            self.rings, self.states, 0, self.slot_ring(0), self.slot_state(0)
        )
        if self._ranker is not None:
            self._ranker.warmup(self.num_slots, self.num_players)
        from bevy_ggrs_tpu_torch import integrity

        # SDC attestation digests (integrity.attest/repair_slot) must not
        # prepare anything on the serving path either.
        integrity.warm(self.rings, states=self.states)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def admit(
        self,
        initial_state: Optional[WorldState] = None,
        slot: Optional[int] = None,
        spec_on: bool = True,
        ticket: Optional[SlotTicket] = None,
        template: Optional[tuple] = None,
    ) -> int:
        """Place a match into a free slot and return the slot number.

        Fresh admission writes ``ring_init(state)`` + ``state`` on device
        with ``index_copy_`` (the slot index a device tensor). Passing
        ``ticket`` instead READMITS a drained match mid-trajectory: the
        ticket's whole ring and live state go through the SAME admit write
        (identical shapes — singleton rings share the ``max_prediction +
        1`` depth — so nothing new is prepared), the frame counter resumes
        where the ticket left off,
        and the fresh per-slot input log / native builder is seeded from
        the ticket's log tail so the next speculation round builds from
        the same history a singleton would."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free match slots")
            slot = free[0]
        s = self.slots[slot]
        if s.active:
            raise RuntimeError(f"slot {slot} is occupied")
        if ticket is not None:
            depth = int(ticket.ring.frames.shape[0])
            if depth != self.ring_depth:
                raise ValueError(
                    f"ticket ring depth {depth} != core depth "
                    f"{self.ring_depth} (mismatched max_prediction)"
                )
            new_ring = ticket.ring
            state = ticket.state
        elif template is not None and initial_state is None:
            # Pre-warmed admission (MatchServer's slot template pool): a
            # codec-round-tripped (ring, state) pair built once at
            # warmup. Bitwise identical to the cold path below — the
            # codec decode reproduces the template flat-byte exact, and
            # ring_init is deterministic — so template-admitted and
            # cold-admitted matches are indistinguishable
            # (tests/test_native_batch.py pins this).
            new_ring, state = template
        else:
            state = (
                self._template if initial_state is None
                else tree_map(lambda x: x.to(self.device), initial_state)
            )
            new_ring = ring_init(state, self.ring_depth)
        self.rings, self.states = self._exec.admit(
            self.rings, self.states, slot, new_ring, state,
        )
        s.active = True
        s.frame = 0 if ticket is None else int(ticket.frame)
        s.spec_on = bool(spec_on if ticket is None else ticket.spec_on)
        s.res_anchor = None
        s.res_bits = None
        s.res_from_live = True
        s.native = native_spec.make_spec_builder(
            self.input_spec, self.num_players, self.num_branches,
            self.spec_frames, self._branch_values,
        )
        s.input_log = (
            native_spec.MirroredLog(s.native) if s.native is not None else {}
        )
        if self._plane is not None:
            self._plane.set_builder(slot, s.native)
        if ticket is not None and ticket.input_log:
            # MirroredLog.update forwards into the native builder's C++
            # mirror, so readmitted slots rank/fingerprint from the same
            # history either way.
            s.input_log.update(ticket.input_log)
        s.shim = _SlotSpecShim(
            self.input_spec, self.num_players, self.num_branches,
            self.spec_frames, self._branch_values, s.input_log,
        )
        if self._predictor is not None:
            # The borrowed _structured_bits picks this up via getattr;
            # per-dispatch seeds land in _seed_memo (see _dispatch).
            s.shim._predictor = self._predictor
        self.metrics.count(
            "matches_admitted" if ticket is None else "matches_readmitted"
        )
        return slot

    def retire(self, slot: int) -> None:
        """Free a slot. Host-only: the device rows become dead weight until
        readmission overwrites them — retirement never dispatches, so churn
        cost is O(1) bookkeeping."""
        s = self.slots[slot]
        if not s.active:
            return
        # Reports already queued for this slot's session must survive the
        # retire (they carry their own session refs) — flush now.
        self.flush_reports()
        if self._plane is not None:
            self._plane.set_builder(slot, None)
            self._plane.set_res(slot, None)
            self._plane.set_qs(slot, None)
        s.active = False
        s.native = None
        s.input_log = {}
        s.shim = None
        s.res_anchor = None
        s.res_bits = None
        self.metrics.count("matches_retired")

    def slot_state(self, slot: int) -> WorldState:
        """A copy of one slot's live state on the device (e.g. for handing
        a match back to a singleton runner, or for parity checks): later
        ticks never change it."""
        return tree_map(lambda x: x[slot].clone(), self.states)

    def slot_ring(self, slot: int) -> SnapshotRing:
        """A copy of one slot's ring (rows, frames, digests)."""
        r = self.rings
        return SnapshotRing(states=tree_map(lambda x: x[slot].clone(), r.states),
                            frames=r.frames[slot].clone(),
                            checksums=r.checksums[slot].clone())

    def extract(self, slot: int) -> SlotTicket:
        """Drain a slot: copy its full trajectory state into a
        :class:`SlotTicket` (copies: later ticks never change them) and
        retire the slot. The ticket seeds a
        singleton recovery runner (``faults.adopt_ticket``) and later
        readmits via ``admit(ticket=...)``, bitwise-continuous."""
        s = self.slots[slot]
        if not s.active:
            raise RuntimeError(f"slot {slot} is not active")
        ticket = SlotTicket(
            frame=int(s.frame),
            state=self.slot_state(slot),
            ring=self.slot_ring(slot),
            input_log=dict(s.input_log),
            spec_on=bool(s.spec_on),
        )
        self.retire(slot)
        return ticket

    # -- ticking --------------------------------------------------------

    def _validate_segment(
        self, slot: int, frame: int, load_frame: Optional[int], steps
    ) -> int:
        """Canonical-shape check for one segment, BEFORE anything mutates:
        raises :class:`SlotFault` instead of half-applying a round.
        Returns the frame the slot would reach."""
        start = frame if load_frame is None else load_frame
        if not steps or any(
            st.adv is None or st.save_frame != start + t
            for t, st in enumerate(steps)
        ):
            raise SlotFault(slot, "non_canonical_burst", frame)
        if len(steps) > self.burst_frames:
            raise SlotFault(slot, "burst_overflow", frame)
        return start + len(steps)

    def tick(self, work: Dict[int, tuple]) -> None:
        """Advance every slot named in ``work`` — ``{slot: (requests,
        confirmed_frame, session)}`` (``confirmed_frame=None`` means fully
        confirmed; ``session`` may be None) — in as few batched dispatches
        as the deepest request list needs (one per Load-delimited segment;
        the session layer emits single-segment lists, so normally one).

        Fault atomicity: every slot's every segment (all rounds) is
        validated up front, so a :class:`SlotFault` escaping this method
        guarantees NO slot's state — host or device — changed. The caller
        may drop the named slot from ``work`` and call again."""
        self.ticks_total += 1
        self.flush_reports()
        per_slot: Dict[int, List[tuple]] = {}
        rounds = 1
        for slot, (requests, confirmed, session) in work.items():
            if not self.slots[slot].active:
                raise RuntimeError(f"slot {slot} is not active")
            frame = self.slots[slot].frame
            try:
                segs = RollbackRunner._segment(None, requests)
            except TypeError as e:
                reason = (
                    "restore_request"
                    if any(isinstance(r, RestoreGameState) for r in requests)
                    else "unsupported_request"
                )
                raise SlotFault(slot, reason, frame, cause=e) from e
            for load, steps in segs:
                frame = self._validate_segment(slot, frame, load, steps)
            per_slot[slot] = [
                (load, steps, confirmed, session) for load, steps in segs
            ]
            rounds = max(rounds, len(segs))
        for r in range(rounds):
            batch = {
                slot: segs[r] for slot, segs in per_slot.items()
                if r < len(segs)
            }
            with self.tracer.span("serve_dispatch", round=r):
                self._dispatch(batch)

    def flush_reports(self) -> None:
        """Deliver deferred checksum reports (the only device->host sync
        in the serving loop, off the producing dispatch's critical path)."""
        if not self._pending_reports:
            return
        pending, self._pending_reports = self._pending_reports, []
        with self.metrics.timer("checksum_sync"):
            host = [(arr.cpu().numpy(), rows) for arr, rows in pending]
        for cs_host, rows in host:
            for slot, t, frame, session in rows:
                session.report_checksum(frame, combine64(cs_host[slot, t]))

    def _build_branches(self, s: _Slot, anchor: int, end: int, session,
                        seed=None):
        """The next rollout's branch tensor for one slot — the singleton
        builder, verbatim (native when available, else the borrowed
        structured tree). ``seed`` is this slot's slice of the batched
        predictor ranking (None when the predictor is off)."""
        if s.native is not None:
            if seed is not None:
                s.native.seed(anchor, seed)
            qs_ptr = s.native.qset_ptr(session)
            if qs_ptr is not None:
                known = known_mask = None
            elif session is None:
                known, known_mask = self._known0, self._mask0
            else:
                known, known_mask = s.shim._known_inputs(anchor, session)
            bits, _sig = s.native.build(
                anchor, qs_ptr, known, known_mask, False, None
            )
            return bits
        last = s.input_log.get(anchor - 1)
        if last is None:
            last = self._zero
        if session is None:
            known, known_mask = self._known0, self._mask0
        else:
            known, known_mask = s.shim._known_inputs(anchor, session)
        if getattr(s.shim, "_predictor", None) is not None:
            # Fresh per-call memo: a stale one (same anchor, pre-burst
            # window) must never leak into this build.
            s.shim._seed_memo = (anchor, seed) if seed is not None else None
        return s.shim._structured_bits(
            np.asarray(last), known, known_mask, anchor
        )

    def _dispatch(self, batch: Dict[int, tuple]) -> None:
        """One batched tick: slots in ``batch`` run their segment,
        every other slot no-ops (and, if it has a pending rollout, replays
        it bitwise so the wholesale prev-buffer swap preserves it).

        Routes to the native batch plane when it loaded (ONE C call for
        the per-slot host work, :meth:`_dispatch_native`) or the per-slot
        Python loop (:meth:`_dispatch_python`) — bitwise identical paths,
        property-tested in tests/test_native_batch.py.

        Atomic on fault: segments are re-validated in a pre-pass (direct
        callers may bypass :meth:`tick`), so a raise can only happen before
        the first input-log write or device dispatch — a sibling slot's
        next-tick output is bitwise unaffected by another slot faulting."""
        if self._plane is not None:
            return self._dispatch_native(batch)
        return self._dispatch_python(batch)

    def _dispatch_python(self, batch: Dict[int, tuple]) -> None:
        """The per-slot host loop (the ``GGRS_NO_NATIVE=1`` reference
        path): log writes, branch matches, window gather and tree builds
        all run per slot in Python."""
        S, B, F, MF = (
            self.num_slots, self.num_branches, self.spec_frames,
            self.burst_frames,
        )
        P = self.num_players
        for i, (load_frame, steps, _confirmed, _session) in batch.items():
            self._validate_segment(i, self.slots[i].frame, load_frame, steps)
        i32 = lambda: np.zeros(S, np.int32)
        branch_a, absorb_first_a, absorb_n_a = i32(), i32(), i32()
        prev_anchor_a, prev_total_a = i32(), i32()
        load_frame_a, start_frame_a, spec_anchor_a = i32(), i32(), i32()
        do_load_a = np.zeros(S, bool)
        from_live_a = np.ones(S, bool)
        save_mask_a = np.zeros((S, MF), bool)
        adv_mask_a = np.zeros((S, MF), bool)
        bits_a = np.zeros((S, MF) + self._zero.shape, self._zero.dtype)
        status_a = np.zeros((S, MF, P), np.int32)
        bb_a = np.zeros((S, B, F) + self._zero.shape, self._zero.dtype)
        # post[slot] -> state updates applied after the dispatch succeeds
        post: Dict[int, tuple] = {}
        reports: List[tuple] = []

        measure = self._measure_host
        t_loop = time.perf_counter() if measure else 0.0
        # Span-stack marker for the sampling profiler: everything in the
        # per-slot loop folds under serve_arg_assembly unless a nested
        # marker (branch build / predictor rank) claims it — mirroring
        # exactly how arg_ms is computed below. Armed only alongside the
        # clock reads so the telemetry-off path stays untouched.
        tok_loop = push_span("serve_arg_assembly") if measure else None
        bb_ms = 0.0
        rank_ms = 0.0
        # Pass 1 — as-used log writes + anchor geometry for every batched
        # slot, hoisted ahead of the build loop so the batched predictor
        # ranking sees all post-write windows in ONE batched call.
        geom: Dict[int, tuple] = {}
        for i, (load_frame, steps, confirmed, _session) in batch.items():
            s = self.slots[i]
            start = s.frame if load_frame is None else load_frame
            end = start + len(steps)
            anchor = end if confirmed is None else confirmed + 1
            # As-used log BEFORE match/build (forward-fill reads anchor-1,
            # which this very burst may advance).
            for t, st in enumerate(steps):
                s.input_log[start + t] = np.asarray(st.adv.bits)
            spec_active = (
                s.spec_on and anchor <= end and anchor > end - self.ring_depth
            )
            geom[i] = (start, end, anchor, spec_active)
        seeds: Dict[int, object] = {}
        if self._ranker is not None:
            eligible = [i for i in batch if geom[i][3]]
            if eligible:
                t_rank = time.perf_counter()
                tok_rank = (
                    push_span("serve_predictor_rank") if measure else None
                )
                W = self._predictor.weights.window
                wins = np.full((S, W, P), -1, dtype=np.int32)
                anchors = np.zeros(S, dtype=np.int32)
                for i in eligible:
                    anchors[i] = geom[i][2]
                    wins[i] = self._predictor.window_indices(
                        self.slots[i].input_log, geom[i][2], P
                    )
                traj_idx, order = self._ranker.rank(wins, anchors)
                for i in eligible:
                    seeds[i] = self._predictor.render_seed(
                        traj_idx[i], order[i]
                    )
                if tok_rank is not None:
                    pop_span(tok_rank)
                rank_ms = (time.perf_counter() - t_rank) * 1000.0
                self.last_predictor_rank_ms = rank_ms
                self.predictor_rank_ms_total += rank_ms
                self.predictor_rank_dispatches += 1
                self.metrics.observe("predictor_rank_ms", rank_ms)
                self.timeseries.observe("predictor_rank_ms", rank_ms)
        for s in self.slots:
            i = s.index
            if i not in batch:
                # No-op lane: every phase gated off; replay the pending
                # rollout (if any) so the prev-buffer swap keeps it valid.
                start_frame_a[i] = s.frame
                if s.res_anchor is not None:
                    spec_anchor_a[i] = s.res_anchor
                    from_live_a[i] = s.res_from_live
                    bb_a[i] = s.res_bits
                else:
                    spec_anchor_a[i] = s.frame
                continue
            requests_seg = batch[i]
            load_frame, steps, confirmed, session = requests_seg
            start, end, anchor, spec_active = geom[i]
            n_steps = len(steps)
            # Branch-commit decision (host-side, zero device syncs).
            absorb_branch, n_commit = 0, 0
            missed = False
            blame_player = blame_frame = None
            if (
                load_frame is not None
                and s.res_anchor is not None
                and load_frame >= s.res_anchor
            ):
                steps_arr = np.stack(
                    [np.asarray(st.adv.bits) for st in steps]
                )
                matched = None
                if s.native is not None:
                    matched = s.native.match(
                        s.res_bits, s.res_anchor, load_frame, steps_arr, F
                    )
                else:
                    needed = []
                    complete = True
                    for f in range(s.res_anchor, load_frame):
                        got = s.input_log.get(f)
                        if got is None:
                            complete = False
                            break
                        needed.append(got)
                    if complete:
                        needed.extend(steps_arr)
                        matched = match_branch(
                            s.res_bits, np.stack(needed)[:F]
                        )
                if matched is not None:
                    br, depth = matched
                    nc = min(depth - (load_frame - s.res_anchor), n_steps)
                    if nc > 0:
                        absorb_branch, n_commit = int(br), int(nc)
                    else:
                        missed = True
                        self.spec_misses += 1
                        self.metrics.count("spec_misses")
                        self.metrics.count(
                            "spec_misses", labels={"match_slot": i}
                        )
                    if self.ledger.enabled:
                        # Blame: first corrected input diverging from the
                        # branch-0 prediction rows (pure NumPy on the
                        # host-resident branch tensor).
                        pre = load_frame - s.res_anchor
                        k = min(n_steps, F - pre)
                        if k > 0:
                            div = blame_divergence(
                                np.asarray(s.res_bits)[0][pre:pre + k],
                                steps_arr[:k],
                            )
                            if div is not None:
                                blame_player = div[1]
                                blame_frame = load_frame + div[0]
            # The next rollout. Speculation is active only when the anchor
            # lies inside the post-burst ring window (precomputed in pass
            # 1); otherwise the lane still computes a (discarded) rollout
            # from the live frontier.
            if spec_active:
                if measure:
                    t_bb = time.perf_counter()
                    tok_bb = push_span("serve_branch_build")
                    bb = self._build_branches(
                        s, anchor, end, session, seeds.get(i)
                    )
                    pop_span(tok_bb)
                    bb_ms += (time.perf_counter() - t_bb) * 1000.0
                else:
                    bb = self._build_branches(
                        s, anchor, end, session, seeds.get(i)
                    )
                spec_anchor, from_live = anchor, (anchor == end)
            else:
                bb = self._zero_bb
                spec_anchor, from_live = end, True
            # Burst assembly: after a partial commit only the unmatched
            # tail resimulates, absorb having positioned the state.
            tail = steps[n_commit:]
            if n_commit > 0:
                burst_load, burst_start = None, load_frame + n_commit
            else:
                burst_load, burst_start = load_frame, start
            branch_a[i] = absorb_branch
            absorb_first_a[i] = load_frame if load_frame is not None else 0
            absorb_n_a[i] = n_commit
            prev_anchor_a[i] = s.res_anchor or 0
            prev_total_a[i] = F if s.res_anchor is not None else 0
            do_load_a[i] = burst_load is not None
            load_frame_a[i] = burst_load if burst_load is not None else 0
            start_frame_a[i] = burst_start
            n_tail = len(tail)
            save_mask_a[i, :n_tail] = True
            adv_mask_a[i, :n_tail] = True
            for t, st in enumerate(tail):
                bits_a[i, t] = np.asarray(st.adv.bits)
                status_a[i, t] = np.asarray(st.adv.status, np.int32)
            spec_anchor_a[i] = spec_anchor
            from_live_a[i] = from_live
            bb_a[i] = bb
            # bb is per-call fresh from both builders, so storing it for
            # the replay/match path needs no defensive copy.
            post[i] = (
                end, spec_active, anchor if spec_active else None,
                bb if spec_active else None,
                from_live, load_frame, n_commit, n_steps, burst_start,
                n_tail, session, missed, blame_player, blame_frame,
            )

        if tok_loop is not None:
            pop_span(tok_loop)
        if measure:
            # Everything in the loop that is not the branch build is
            # argument assembly (log writes, match, per-slot array fills).
            loop_ms = (time.perf_counter() - t_loop) * 1000.0
            arg_ms = max(0.0, loop_ms - bb_ms - rank_ms)
            self.last_branch_build_ms = bb_ms
            self.last_arg_assembly_ms = arg_ms
            self.metrics.observe("serve_branch_build", bb_ms)
            self.metrics.observe("serve_arg_assembly", arg_ms)
            self.timeseries.observe("serve_branch_build_ms", bb_ms)
            self.timeseries.observe("serve_arg_assembly_ms", arg_ms)

        self._finish_dispatch(
            (branch_a, absorb_first_a, absorb_n_a, prev_anchor_a,
             prev_total_a, do_load_a, load_frame_a, start_frame_a,
             bits_a, status_a, save_mask_a, adv_mask_a,
             from_live_a, spec_anchor_a, bb_a),
            post, reports,
        )

    def _finish_dispatch(
        self, tick_args: tuple, post: Dict[int, tuple],
        reports: List[tuple],
    ) -> None:
        """The device dispatch + post-dispatch bookkeeping shared by both
        host paths (per-slot Python loop and native batch plane): run the
        batched tick, then apply frame counters, rollout metadata,
        hit/miss counters, ledger entries and deferred checksum rows."""
        branch_a = tick_args[0]
        self.device_dispatches_total += 1
        dev = (
            self.attribution.device_wait()
            if self.attribution is not None
            else contextlib.nullcontext()
        )
        with self.metrics.timer("serve_dispatch"), dev:
            (
                self.rings, self.states, absorb_cs, burst_cs,
                self.prev_rings, self.prev_states, _spec_cs,
            ) = self._exec.run(
                self.rings, self.states, self.prev_rings, self.prev_states,
                *tick_args,
            )

        for i, (
            end, spec_active, res_anchor, res_bits, from_live, load_frame,
            n_commit, n_steps, burst_start, n_tail, session, missed,
            blame_player, blame_frame,
        ) in post.items():
            s = self.slots[i]
            s.frame = end
            if spec_active:
                s.res_anchor, s.res_bits = res_anchor, res_bits
                s.res_from_live = from_live
                # A fresh rollout dispatched for this slot: B×F
                # speculative device frames. (No-op lane replays are NOT
                # charged — they are an artifact of the wholesale
                # prev-buffer swap, not new speculative intent.)
                self.ledger.record_rollout(
                    self.num_branches * self.spec_frames, slot=i
                )
            else:
                s.res_anchor, s.res_bits = None, None
            lab = {"match_slot": i}
            self.metrics.count("frames_advanced", n_steps)
            self.metrics.count("frames_advanced", n_steps, labels=lab)
            if load_frame is not None:
                self.rollbacks_total += 1
                self.metrics.count("rollbacks")
                self.metrics.count("rollbacks", labels=lab)
                self.metrics.observe("rollback_depth", n_steps)
                outcome = (
                    ("full" if n_commit == n_steps else "partial")
                    if n_commit > 0
                    else ("miss" if missed else "unmatched")
                )
                self.ledger.record(
                    outcome, depth=n_steps, frames_recovered=n_commit,
                    frames_resimulated=n_steps - n_commit,
                    branch=branch_a[i] if n_commit > 0 else None,
                    rank=branch_a[i] if n_commit > 0 else None,
                    blame_player=blame_player, blame_frame=blame_frame,
                    slot=i, load_frame=load_frame,
                )
                if n_commit > 0:
                    self.rollback_frames_recovered_total += n_commit
                    self.metrics.count("rollback_frames_recovered", n_commit)
                    if n_commit == n_steps:
                        self.spec_hits += 1
                        self.metrics.count("spec_hits")
                        self.metrics.count("spec_hits", labels=lab)
                    else:
                        self.spec_partial_hits += 1
                        self.metrics.count("spec_partial_hits")
                        self.rollback_frames_total += n_tail
                        self.metrics.count("rollback_frames", n_tail)
                else:
                    self.rollback_frames_total += n_steps
                    self.metrics.count("rollback_frames", n_steps)
            if session is not None and self.report_checksums:
                wants = getattr(session, "wants_checksum", None)
                rows_a = [
                    (i, t, load_frame + t) for t in range(n_commit)
                    if wants is None or wants(load_frame + t)
                ]
                rows_b = [
                    (i, t, burst_start + t) for t in range(n_tail)
                    if wants is None or wants(burst_start + t)
                ]
                if rows_a:
                    reports.append(
                        (absorb_cs, [r + (session,) for r in rows_a])
                    )
                if rows_b:
                    reports.append(
                        (burst_cs, [r + (session,) for r in rows_b])
                    )
            self._gc_log(s)
        self._pending_reports.extend(reports)

    def _dispatch_native(self, batch: Dict[int, tuple]) -> None:
        """One batched tick with the per-slot host loop consolidated
        into the two batch-plane calls: ``ggrs_batch_stage`` lands every
        slot's as-used log rows, in-flight tree match and predictor
        window gather in ONE C call before the commit decisions, and
        ``ggrs_batch_build`` runs every seeded tree build plus the no-op
        lanes' tree re-use copies straight into the tick's argument
        buffer. Bitwise identical to :meth:`_dispatch_python`
        (the C side loops over the same per-slot primitives)."""
        plane = self._plane
        S, B, F, MF = (
            self.num_slots, self.num_branches, self.spec_frames,
            self.burst_frames,
        )
        P = self.num_players
        for i, (load_frame, steps, _confirmed, _session) in batch.items():
            self._validate_segment(i, self.slots[i].frame, load_frame, steps)
        i32 = lambda: np.zeros(S, np.int32)
        branch_a, absorb_first_a, absorb_n_a = i32(), i32(), i32()
        prev_anchor_a, prev_total_a = i32(), i32()
        load_frame_a, start_frame_a, spec_anchor_a = i32(), i32(), i32()
        do_load_a = np.zeros(S, bool)
        from_live_a = np.ones(S, bool)
        save_mask_a = np.zeros((S, MF), bool)
        adv_mask_a = np.zeros((S, MF), bool)
        bits_a = np.zeros((S, MF) + self._zero.shape, self._zero.dtype)
        status_a = np.zeros((S, MF, P), np.int32)
        # Fresh per dispatch (NOT a reused plane buffer): the previous
        # dispatch's rows live on as the slots' in-flight trees
        # (res_bits views) until the post pass replaces them.
        bb_a = np.zeros((S, B, F) + self._zero.shape, self._zero.dtype)
        post: Dict[int, tuple] = {}
        reports: List[tuple] = []

        measure = self._measure_host
        t_loop = time.perf_counter() if measure else 0.0
        tok_loop = push_span("serve_arg_assembly") if measure else None
        bb_ms = 0.0
        rank_ms = 0.0
        nb_ms = 0.0
        plane.reset_masks()
        # Pass 1 — SoA staging for ggrs_batch_stage: step bits/status,
        # anchor geometry, match inputs, window-gather requests. The
        # Python-side dict update bypasses MirroredLog's per-row ctypes
        # forward — the stage call lands the same rows in the native
        # mirror (in per-slot log -> match -> gather order, mirroring
        # the Python pass structure).
        geom: Dict[int, tuple] = {}
        for i, (load_frame, steps, confirmed, _session) in batch.items():
            s = self.slots[i]
            start = s.frame if load_frame is None else load_frame
            end = start + len(steps)
            anchor = end if confirmed is None else confirmed + 1
            plane.log_mask[i] = 1
            plane.starts[i] = start
            plane.n_steps[i] = len(steps)
            for t, st in enumerate(steps):
                arr = np.asarray(st.adv.bits)
                dict.__setitem__(s.input_log, start + t, arr)
                plane.steps[i, t] = arr
                plane.status[i, t] = np.asarray(st.adv.status, np.int32)
            if (
                load_frame is not None
                and s.res_anchor is not None
                and load_frame >= s.res_anchor
            ):
                plane.match_mask[i] = 1
                plane.res_anchors[i] = s.res_anchor
                plane.load_frames[i] = load_frame
                plane.set_res(i, s.res_bits)
            spec_active = (
                s.spec_on and anchor <= end and anchor > end - self.ring_depth
            )
            if self._ranker is not None and spec_active:
                plane.win_mask[i] = 1
                plane.win_anchors[i] = anchor
            geom[i] = (start, end, anchor, spec_active)
        with self.tracer.span("serve_native_batch", call="stage"):
            t_nb = time.perf_counter() if measure else 0.0
            tok_nb = push_span("serve_native_batch") if measure else None
            plane.stage(F)
            if tok_nb is not None:
                pop_span(tok_nb)
            if measure:
                nb_ms += (time.perf_counter() - t_nb) * 1000.0
        self.native_batch_calls += 1
        self.metrics.count("native_batch_calls")
        if self._ranker is not None:
            eligible = [i for i in batch if geom[i][3]]
            if eligible:
                t_rank = time.perf_counter()
                tok_rank = (
                    push_span("serve_predictor_rank") if measure else None
                )
                anchors = np.zeros(S, dtype=np.int32)
                el = np.asarray(eligible, dtype=np.intp)
                anchors[el] = plane.win_anchors[el]
                # Stale non-eligible window rows are fine: the ranker is
                # a lane-independent batched forward, and only the
                # eligible rows' outputs are consumed.
                traj_idx, order = self._ranker.rank(plane.wins, anchors)
                # render_seed vectorized over the eligible rows — the
                # same universe gather + dtype cast per slot; the shared
                # all-ones valid plane lives in the batch plane.
                uni = self._predictor.universe
                plane.seed_traj[el] = uni[traj_idx[el]]
                plane.seed_cand[el] = uni[order[el]]
                plane.seed_mask[el] = 1
                if tok_rank is not None:
                    pop_span(tok_rank)
                rank_ms = (time.perf_counter() - t_rank) * 1000.0
                self.last_predictor_rank_ms = rank_ms
                self.predictor_rank_ms_total += rank_ms
                self.predictor_rank_dispatches += 1
                self.metrics.observe("predictor_rank_ms", rank_ms)
                self.timeseries.observe("predictor_rank_ms", rank_ms)
        # Pass 2 — commit decisions from the staged match results, then
        # build-call staging (anchors, known inputs, no-op copies) and
        # the per-slot scalar fills for the tick's arguments.
        dirty_known: List[int] = []
        for s in self.slots:
            i = s.index
            if i not in batch:
                start_frame_a[i] = s.frame
                if s.res_anchor is not None:
                    spec_anchor_a[i] = s.res_anchor
                    from_live_a[i] = s.res_from_live
                    plane.copy_mask[i] = 1
                    plane.set_res(i, s.res_bits)
                else:
                    spec_anchor_a[i] = s.frame
                continue
            load_frame, steps, confirmed, session = batch[i]
            start, end, anchor, spec_active = geom[i]
            n_steps = len(steps)
            absorb_branch, n_commit = 0, 0
            missed = False
            blame_player = blame_frame = None
            if plane.match_mask[i]:
                br = int(plane.out_branch[i])
                if br >= 0:  # -1 = as-used log gap (the Python no-match)
                    depth = int(plane.out_depth[i])
                    nc = min(depth - (load_frame - s.res_anchor), n_steps)
                    if nc > 0:
                        absorb_branch, n_commit = br, int(nc)
                    else:
                        missed = True
                        self.spec_misses += 1
                        self.metrics.count("spec_misses")
                        self.metrics.count(
                            "spec_misses", labels={"match_slot": i}
                        )
                    if self.ledger.enabled:
                        pre = load_frame - s.res_anchor
                        k = min(n_steps, F - pre)
                        if k > 0:
                            div = blame_divergence(
                                np.asarray(s.res_bits)[0][pre:pre + k],
                                plane.steps[i, :k],
                            )
                            if div is not None:
                                blame_player = div[1]
                                blame_frame = load_frame + div[0]
            if spec_active:
                plane.build_mask[i] = 1
                plane.anchors[i] = anchor
                qs_ptr = (
                    s.native.qset_ptr(session) if session is not None
                    else None
                )
                plane.set_qs(i, qs_ptr)
                if qs_ptr is None and session is not None and (
                    getattr(session, "confirmed_span", None) is not None
                    or getattr(session, "confirmed_input", None) is not None
                ):
                    # Sessions with a confirmed-inputs surface but no
                    # native queue set: the Python bulk query fills this
                    # slot's known rows (re-zeroed after the build).
                    known, kmask = s.shim._known_inputs(anchor, session)
                    plane.known[i] = known
                    plane.kmask[i] = kmask
                    dirty_known.append(i)
                spec_anchor, from_live = anchor, (anchor == end)
            else:
                spec_anchor, from_live = end, True
            if n_commit > 0:
                burst_load, burst_start = None, load_frame + n_commit
            else:
                burst_load, burst_start = load_frame, start
            branch_a[i] = absorb_branch
            absorb_first_a[i] = load_frame if load_frame is not None else 0
            absorb_n_a[i] = n_commit
            prev_anchor_a[i] = s.res_anchor or 0
            prev_total_a[i] = F if s.res_anchor is not None else 0
            do_load_a[i] = burst_load is not None
            load_frame_a[i] = burst_load if burst_load is not None else 0
            start_frame_a[i] = burst_start
            n_tail = n_steps - n_commit
            save_mask_a[i, :n_tail] = True
            adv_mask_a[i, :n_tail] = True
            if n_tail:
                bits_a[i, :n_tail] = plane.steps[i, n_commit:n_steps]
                status_a[i, :n_tail] = plane.status[i, n_commit:n_steps]
            spec_anchor_a[i] = spec_anchor
            from_live_a[i] = from_live
            # The slot's next in-flight tree is its bb_a row, written by
            # the build call below — the view is stored now, the bytes
            # land before the device dispatch reads them.
            post[i] = (
                end, spec_active, anchor if spec_active else None,
                bb_a[i] if spec_active else None,
                from_live, load_frame, n_commit, n_steps, burst_start,
                n_tail, session, missed, blame_player, blame_frame,
            )
        with self.tracer.span("serve_native_batch", call="build"):
            t_bb = time.perf_counter() if measure else 0.0
            tok_bb = push_span("serve_branch_build") if measure else None
            plane.build(bb_a)
            if tok_bb is not None:
                pop_span(tok_bb)
            if measure:
                bb_ms = (time.perf_counter() - t_bb) * 1000.0
                nb_ms += bb_ms
        self.native_batch_calls += 1
        self.metrics.count("native_batch_calls")
        for i in dirty_known:
            plane.known[i] = 0
            plane.kmask[i] = 0

        if tok_loop is not None:
            pop_span(tok_loop)
        if measure:
            # branch_build is the build call's real measured wall time;
            # everything else in the loop (SoA staging, the stage call,
            # commit decisions, scalar fills) is argument assembly.
            loop_ms = (time.perf_counter() - t_loop) * 1000.0
            arg_ms = max(0.0, loop_ms - bb_ms - rank_ms)
            self.last_branch_build_ms = bb_ms
            self.last_arg_assembly_ms = arg_ms
            self.native_batch_ms_total += nb_ms
            self.metrics.observe("serve_branch_build", bb_ms)
            self.metrics.observe("serve_arg_assembly", arg_ms)
            self.metrics.observe("native_batch_ms", nb_ms)
            self.timeseries.observe("serve_branch_build_ms", bb_ms)
            self.timeseries.observe("serve_arg_assembly_ms", arg_ms)
            self.timeseries.observe("native_batch_ms", nb_ms)

        self._finish_dispatch(
            (branch_a, absorb_first_a, absorb_n_a, prev_anchor_a,
             prev_total_a, do_load_a, load_frame_a, start_frame_a,
             bits_a, status_a, save_mask_a, adv_mask_a,
             from_live_a, spec_anchor_a, bb_a),
            post, reports,
        )

    def _gc_log(self, s: _Slot) -> None:
        horizon = s.frame - self.ring_depth - 64
        for f in [f for f in s.input_log if f < horizon]:
            del s.input_log[f]

    # -- SDC attestation + repair (bevy_ggrs_tpu_torch.integrity) -------------

    def attest(self) -> Dict[int, List[int]]:
        """Attest every active slot's ring rows in ONE digest pass (one
        checksum launch) over the ``[S, depth]`` axes (amortized over the batch exactly like
        the checksum stream). Returns ``{slot: sorted corrupt frames}`` —
        empty when every occupied row still hashes to its save-time
        digest."""
        from bevy_ggrs_tpu_torch import integrity

        mask = integrity.attest_ring(self.rings)  # [S, depth] host bools
        out: Dict[int, List[int]] = {}
        if not mask.any():
            return out
        frames_h = self.rings.frames.cpu().numpy()
        for s in self.slots:
            if not s.active:
                continue  # dead rows: stale until readmission overwrites
            rows = np.flatnonzero(mask[s.index])
            if rows.size:
                bad = sorted(int(f) for f in frames_h[s.index][rows])
                out[s.index] = bad
                self.metrics.count("sdc_detected", len(bad))
                self.metrics.count(
                    "sdc_detected", len(bad), labels={"match_slot": s.index}
                )
        return out

    def repair_slot(self, slot: int, corrupt: List[int],
                    session=None) -> dict:
        """Self-heal one slot's corrupt ring rows by rollback
        resimulation: one canonical burst (Load deepest-clean base, then
        (Save, Advance) per frame from the slot's as-used input log)
        through the ordinary batched dispatch — every occupied row sits
        within ``ring_depth`` of the live frame, so the whole span fits one
        burst and the repair costs exactly one batched tick that prepares nothing.
        Sibling slots ride the no-op lane, bitwise untouched. Statuses
        resimulate as zeros: committed states are functions of the input
        BITS alone (the batched/singleton parity contract), so the rewrite
        is bitwise. Raises :class:`~bevy_ggrs_tpu_torch.integrity.StateFault`
        when no clean base exists or the log has gaps — the caller
        escalates (MatchServer drains the slot to a recovery lane /
        checkpoint)."""
        from bevy_ggrs_tpu_torch import integrity

        s = self.slots[slot]
        if not s.active:
            raise RuntimeError(f"slot {slot} is not active")
        corrupt = sorted(int(f) for f in corrupt)
        frames_h = self.rings.frames[slot].cpu().numpy()
        cset = set(corrupt)

        def _fail(detail: str):
            self.metrics.count("sdc_unrepairable")
            raise integrity.StateFault("sdc", corrupt, slot=slot,
                                       detail=detail)

        if corrupt[-1] >= s.frame:
            _fail(f"corrupt row at frame {corrupt[-1]} >= live frame "
                  f"{s.frame} — resimulation cannot reach it")
        clean_below = sorted(
            int(f) for f in frames_h[frames_h >= 0]
            if int(f) < corrupt[0] and int(f) not in cset
        )
        if not clean_below:
            _fail("no digest-clean snapshot below the corrupt rows")
        base = clean_below[-1]
        steps = []
        for f in range(base, s.frame):
            bits = s.input_log.get(f)
            if bits is None:
                _fail(f"as-used input log does not cover frame {f}")
            steps.append(_Step(
                save_frame=f,
                adv=AdvanceFrame(bits, np.zeros(self.num_players, np.int32)),
            ))
        row = corrupt[0] % self.ring_depth
        before = integrity.host_row(self.rings, row, slot=slot)
        pre_live = integrity._state_digest(self.states)[slot].cpu().numpy()
        # Pending branches were rolled out from pre-repair buffers; drop
        # them so the dispatch skips branch-match and rolls fresh ones.
        s.res_anchor, s.res_bits = None, None
        with self.metrics.timer("sdc_repair"), self.tracer.span(
            "sdc_repair", slot=slot, frames=len(steps)
        ):
            self._dispatch({slot: (base, steps, None, session)})
        post_live = integrity._state_digest(self.states)[slot].cpu().numpy()
        after = integrity.host_row(self.rings, row, slot=slot)
        post_mask = integrity.attest_ring(self.rings)[slot]
        report = {
            "slot": slot,
            "corrupt_frames": corrupt,
            "repaired": len(corrupt),
            "repair_frames": len(steps),
            "bitwise": bool(
                (pre_live == post_live).all() and not post_mask.any()
            ),
            "first_corrupt_field": integrity.first_corrupt_field(
                before, after
            ),
        }
        self.metrics.count("sdc_repaired", len(corrupt))
        if report["bitwise"]:
            self.metrics.count("sdc_repaired_bitwise", len(corrupt))
        self.metrics.observe("sdc_repair_frames", len(steps))
        return report
