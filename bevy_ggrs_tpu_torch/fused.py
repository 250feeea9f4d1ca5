"""The P2P tick with speculation: commit-absorb, serial burst, next rollout.

Counterpart of ``bevy_ggrs_tpu/fused.py``. A speculating tick has three
phases, data-dependent in one direction:

    absorb (the matched branch's precomputed frames -> the session's ring
    and state)
      -> serial burst (the rollback's unmatched tail, or the steady advance)
        -> next speculative rollout (anchored on the post-burst frontier)

The JAX package compiles them into one program dispatched once a tick,
every phase select-gated by traced flags. PyTorch runs eagerly: the
:class:`FusedTickExecutor` runs the phases in the same order on one
stream, and skips a phase whose flag is off, which gives the same bits
(the gated phases of the JAX program leave the ring and state as they
are). One call of :meth:`FusedTickExecutor.run` is one tick; ``calls``
counts them. Capturing the tick as one CUDA graph is later work (ROADMAP.md).

The runner dispatches this same executor from ``speculate()`` and from the
warmup attestation (absorb and burst off), so the rollout whose states
commit is the rollout that was attested.

The session's ring is written in place, and each rollout writes rings of
its own (``state.branch_rings``), which the next rollout never reuses:
the previous rollout's ``SpecResult`` stays readable after the next one is
dispatched in the same tick.

On a device mesh the phases keep the layouts of the separate executors
(``parallel/sharding.py``'s :class:`MeshLayout`): the burst runs on this
rank's entity rows, the rollout on its block of the branches, and the
absorb takes the matched branch from the rank that owns it.

``session_axis=S`` (``GGRS_SESSION_AXIS``) is a conformance mode: the
tick's arguments are broadcast to S identical slots, the slot-batched tick
that serving runs (``serve/batch.py``'s :class:`BatchedTickExecutor`,
``[S·B]`` rollout worlds, slot-major) runs them, and slot 0 comes back
out, so every singleton suite checks the batched path bitwise. It is
exclusive with a mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.parallel.sharding import MeshLayout
from bevy_ggrs_tpu_torch.parallel.speculate import rollout_branches
from bevy_ggrs_tpu_torch.rollout import rollout_burst
from bevy_ggrs_tpu_torch.schedule import PREDICTED, Schedule
from bevy_ggrs_tpu_torch.state import (
    SnapshotRing,
    WorldState,
    broadcast_branches,
    ring_load,
    tree_map,
)


def absorb_branch_frames(
    main_ring: SnapshotRing,
    spec_ring: SnapshotRing,  # the matched branch's ring (no branch axis)
    spec_states: WorldState,  # the matched branch's final state
    first_frame: int,  # first replayed frame (the Load target)
    n_frames: int,  # how many (save, advance) steps were replayed
    anchor: int,  # the rollout's start frame
    total_spec: int,  # frames the rollout simulated in total
    max_steps: int,
) -> Tuple[SnapshotRing, Optional[WorldState], torch.Tensor]:
    """Copy frames ``first_frame .. first_frame + n_frames - 1`` (rows,
    frames and stored digests) from the branch ring into the main ring, in
    place, and return ``(main_ring, state at the end, checksums[max_steps,
    2])``. The state after the last replayed frame is the branch ring's
    next row (the state entering frame f is saved at f), or the rollout's
    final state when the replay consumed the whole rollout; it is a copy.
    ``n_frames == 0`` leaves the ring untouched and returns no state."""
    checksums = torch.zeros((max_steps, 2), dtype=torch.int64,
                            device=main_ring.frames.device)
    for t in range(int(n_frames)):
        f = int(first_frame) + t
        src, dst = f % spec_ring.depth, f % main_ring.depth
        tree_map(lambda m, s: m[dst].copy_(s[src]), main_ring.states, spec_ring.states)
        main_ring.frames[dst] = f
        main_ring.checksums[dst].copy_(spec_ring.checksums[src])
        checksums[t].copy_(spec_ring.checksums[src])
    if n_frames <= 0:
        return main_ring, None, checksums
    end = int(first_frame) + int(n_frames)  # the frame entered after the replay
    if end < int(anchor) + int(total_spec):
        state = ring_load(spec_ring, end)
    else:
        state = tree_map(torch.clone, spec_states)
    return main_ring, state, checksums


class FusedTickExecutor:
    """The whole speculating tick, bound to one schedule and shape.

    ``burst_frames`` pads the serial phase's checksums (the serial
    executor's ``max_frames``); ``num_branches`` and ``spec_frames`` shape
    the rollout phase. ``mesh``, ``branch_axis``, ``entity_axis`` and
    ``state_template`` lay the phases out as the serial and speculative
    executors do (``layout``: a session's shared one instead);
    ``session_axis`` > 0 runs the conformance mode (module docstring)."""

    def __init__(self, schedule: Schedule, burst_frames: int, num_branches: int,
                 spec_frames: int, mesh=None, branch_axis: str = "branch",
                 entity_axis: Optional[str] = None,
                 state_template: Optional[WorldState] = None, session_axis: int = 0,
                 layout: Optional[MeshLayout] = None):
        self.burst_frames = int(burst_frames)
        self.num_branches = int(num_branches)
        self.spec_frames = int(spec_frames)
        self.session_axis = int(session_axis)
        if layout is not None:
            mesh = layout.mesh
        if self.session_axis > 0 and mesh is not None:
            raise ValueError(
                "session_axis (GGRS_SESSION_AXIS) and mesh sharding are "
                "mutually exclusive: the session axis batches the whole "
                "tick, which would replicate the entity-sharded layout per "
                "slot. Unset one."
            )
        self.layout = layout if layout is not None else MeshLayout(
            schedule, num_branches, mesh, branch_axis, entity_axis, state_template)
        self.schedule = self.layout.schedule
        self.calls = 0  # ticks run (run and commit_absorb)
        self._status = {}  # (players, device) -> the rollout's PREDICTED status
        self._batched = None  # the session-axis mode's slot-batched tick

    def _absorb(self, ring, prev_rings, prev_states, branch, first, n, anchor, total):
        if int(n) <= 0:
            return absorb_branch_frames(ring, None, None, first, 0, anchor, total,
                                        self.burst_frames)
        b = int(branch)
        if self.layout.branch is not None:
            # The matched branch from the rank that owns it.
            spec_ring, spec_state = self.layout.select((prev_rings, prev_states), b)
        else:
            # Views of the matched branch: absorb only reads them.
            spec_ring = SnapshotRing(states=tree_map(lambda x: x[b], prev_rings.states),
                                     frames=prev_rings.frames[b],
                                     checksums=prev_rings.checksums[b])
            spec_state = tree_map(lambda x: x[b], prev_states)
        return absorb_branch_frames(ring, spec_ring, spec_state, first, n, anchor,
                                    total, self.burst_frames)

    def commit_absorb(self, ring: SnapshotRing, prev_rings, prev_states, branch: int,
                      first_frame: int, n_frames: int, prev_anchor: int,
                      prev_total: int):
        """The absorb phase alone (a full speculation hit: copies, no
        schedule). Returns ``(ring, state, checksums[burst_frames, 2])``."""
        self.calls += 1
        if self.session_axis > 0:
            return self._session_absorb(ring, prev_rings, prev_states, branch,
                                        first_frame, n_frames, prev_anchor, prev_total)
        return self._absorb(ring, prev_rings, prev_states, branch, first_frame,
                            n_frames, prev_anchor, prev_total)

    def run(
        self,
        ring: SnapshotRing,
        state: WorldState,
        prev_rings,
        prev_states,
        branch: int,
        absorb_first: int,
        absorb_n: int,
        prev_anchor: int,
        prev_total: int,
        load_frame: Optional[int],
        start_frame: int,
        bits,
        status,
        n_burst: int,
        spec_anchor: int,
        spec_from_live: bool,
        branch_bits,
    ):
        """One tick. ``bits``/``status`` are host ``[n_burst, P, ...]``
        arrays (the burst's (save, advance) steps, in the standard
        pairing); ``branch_bits [B, F, P, ...]`` is the next rollout's input
        tensor (host). Returns ``(ring, state, absorb_cs, burst_cs,
        spec_rings, spec_states, spec_cs)``, nothing read back."""
        if n_burst > self.burst_frames:
            raise ValueError(f"burst of {n_burst} frames exceeds {self.burst_frames}")
        bb = np.ascontiguousarray(np.asarray(branch_bits))
        if bb.shape[:2] != (self.num_branches, self.spec_frames):
            raise ValueError(f"branch_bits {bb.shape[:2]} != "
                             f"({self.num_branches}, {self.spec_frames})")
        self.calls += 1
        if self.session_axis > 0:
            return self._session_run(ring, state, prev_rings, prev_states, branch,
                                     absorb_first, absorb_n, prev_anchor, prev_total,
                                     load_frame, start_frame, bits, status, n_burst,
                                     spec_anchor, spec_from_live, bb)
        return self._run(ring, state, prev_rings, prev_states, branch, absorb_first,
                         absorb_n, prev_anchor, prev_total, load_frame, start_frame,
                         bits, status, n_burst, spec_anchor, spec_from_live, bb)

    def _run(self, ring, state, prev_rings, prev_states, branch, absorb_first, absorb_n,
             prev_anchor, prev_total, load_frame, start_frame, bits, status, n_burst,
             spec_anchor, spec_from_live, bb):
        device = state.device
        # Phase 1: absorb the matched branch's precomputed frames.
        if absorb_n > 0:
            ring, state, absorb_cs = self._absorb(ring, prev_rings, prev_states, branch,
                                                  absorb_first, absorb_n, prev_anchor,
                                                  prev_total)
        else:
            absorb_cs = torch.zeros((self.burst_frames, 2), dtype=torch.int64,
                                    device=device)
        # Phase 2: the serial burst (rollback resimulation, the unmatched
        # tail after a partial absorb, or the steady advance).
        if load_frame is not None:
            state = ring_load(ring, load_frame)
            frame0 = int(load_frame)
        else:
            frame0 = int(start_frame)
        burst_cs = torch.zeros((self.burst_frames, 2), dtype=torch.int64, device=device)
        if n_burst:
            mask = np.zeros(self.burst_frames, dtype=bool)
            mask[:n_burst] = True
            pad = self.burst_frames - n_burst
            bits_h = np.asarray(bits)
            bits_h = np.concatenate([bits_h, np.zeros((pad,) + bits_h.shape[1:], bits_h.dtype)])
            status_h = np.asarray(status, np.int32)
            status_h = np.concatenate([status_h, np.zeros((pad,) + status_h.shape[1:],
                                                          np.int32)])
            ring, state, burst_cs = rollout_burst(
                self.schedule, ring, state, frame0,
                torch.as_tensor(bits_h, device=device),
                torch.as_tensor(status_h, device=device), mask, mask, self.layout.entity)
        # Phase 3: the next rollout, anchored on the post-burst frontier:
        # the live state when the anchor is the new frame, else the ring's
        # snapshot of the (older) anchor frame.
        anchor_state = state if spec_from_live else ring_load(ring, spec_anchor)
        key = (bb.shape[2], device)
        spec_status = self._status.get(key)
        if spec_status is None:
            spec_status = self._status[key] = torch.full(
                (self.spec_frames, bb.shape[2]), PREDICTED, dtype=torch.int32,
                device=device)
        spec_rings, spec_states, spec_cs = rollout_branches(
            self.schedule, anchor_state, int(spec_anchor),
            torch.as_tensor(np.ascontiguousarray(self.layout.local_bits(bb)), device=device),
            spec_status, self.spec_frames, self.layout.entity)
        return ring, state, absorb_cs, burst_cs, spec_rings, spec_states, spec_cs

    # ------------------------------------------------------------------
    # The session-axis conformance mode

    def _slots(self):
        if self._batched is None:
            from bevy_ggrs_tpu_torch.serve.batch import BatchedTickExecutor

            self._batched = BatchedTickExecutor(self.schedule, self.session_axis,
                                                self.burst_frames, self.num_branches,
                                                self.spec_frames)
        return self._batched

    def _stack_ring(self, ring: SnapshotRing) -> SnapshotRing:
        """S copies of a singleton ring as a ``[S, depth]`` stack."""
        S = self.session_axis
        return SnapshotRing(states=broadcast_branches(ring.states, S),
                            frames=ring.frames[None].expand(S, -1).contiguous(),
                            checksums=ring.checksums[None].expand(S, -1, -1).contiguous())

    def _slot_views(self, prev_rings, prev_states):
        """A singleton's previous rollout as S identical slots (views:
        the slot-batched absorb only reads them)."""
        S = self.session_axis
        if prev_rings is None:
            return None, None

        def rep(x):
            return x[None].expand((S,) + tuple(x.shape))

        return (SnapshotRing(states=tree_map(rep, prev_rings.states),
                             frames=rep(prev_rings.frames),
                             checksums=rep(prev_rings.checksums)),
                tree_map(rep, prev_states))

    @staticmethod
    def _slot0_ring(rings: SnapshotRing) -> SnapshotRing:
        return SnapshotRing(states=tree_map(lambda x: x[0].clone(), rings.states),
                            frames=rings.frames[0].clone(),
                            checksums=rings.checksums[0].clone())

    def _session_absorb(self, ring, prev_rings, prev_states, branch, first, n, anchor,
                        total):
        from bevy_ggrs_tpu_torch.serve.batch import absorb_slots

        S = self.session_axis
        rings = self._stack_ring(ring)
        prev_r, prev_s = self._slot_views(prev_rings, prev_states)
        states = broadcast_branches(tree_map(lambda x: x[int(branch)], prev_states), S)
        full = lambda v: np.full(S, int(v), np.int64)  # noqa: E731
        states, cs = absorb_slots(rings, states, prev_r, prev_s, full(branch), full(first),
                                  full(n), full(anchor), full(total), self.burst_frames)
        state = tree_map(lambda x: x[0].clone(), states) if int(n) > 0 else None
        return self._slot0_ring(rings), state, cs[0]

    def _session_run(self, ring, state, prev_rings, prev_states, branch, absorb_first,
                     absorb_n, prev_anchor, prev_total, load_frame, start_frame, bits,
                     status, n_burst, spec_anchor, spec_from_live, bb):
        """One tick through the slot-batched executor on S copies of its
        arguments; slot 0's results."""
        S, T = self.session_axis, self.burst_frames
        full = lambda v, dt=np.int64: np.full(S, v, dt)  # noqa: E731
        prev_r, prev_s = self._slot_views(prev_rings, prev_states)
        bits_h = np.asarray(bits)
        status_h = np.asarray(status, np.int32)
        pad = T - int(n_burst)
        bits_h = np.concatenate([bits_h, np.zeros((pad,) + bits_h.shape[1:], bits_h.dtype)])
        status_h = np.concatenate([status_h, np.zeros((pad,) + status_h.shape[1:],
                                                      np.int32)])
        mask = np.zeros(T, bool)
        mask[:int(n_burst)] = True
        out = self._slots().run(
            self._stack_ring(ring), broadcast_branches(state, S), prev_r, prev_s,
            full(branch), full(absorb_first), full(absorb_n), full(prev_anchor),
            full(prev_total), full(load_frame is not None, bool),
            full(0 if load_frame is None else load_frame), full(start_frame),
            np.broadcast_to(bits_h[None], (S,) + bits_h.shape),
            np.broadcast_to(status_h[None], (S,) + status_h.shape),
            np.broadcast_to(mask, (S, T)), np.broadcast_to(mask, (S, T)),
            full(spec_from_live, bool), full(spec_anchor),
            np.broadcast_to(bb[None], (S,) + bb.shape))
        rings, states, absorb_cs, burst_cs, spec_rings, spec_states, spec_cs = out
        return (self._slot0_ring(rings), tree_map(lambda x: x[0].clone(), states),
                absorb_cs[0], burst_cs[0], self._slot0_ring(spec_rings),
                tree_map(lambda x: x[0].clone(), spec_states), spec_cs[0])
