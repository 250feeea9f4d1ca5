"""Rollback/resimulation bursts.

Counterpart of ``bevy_ggrs_tpu/rollout.py``. A burst is a list of
(save?, advance?) steps: step ``t`` saves the current state as frame
``start_frame + (frames advanced so far)`` when ``save_mask[t]``, then
advances it with that frame's inputs when ``adv_mask[t]``. Saving comes
before advancing, so a save is always labelled with the current frame;
the two masks are separate so a spectator can advance without saving.

The JAX package scans a burst padded to ``max_frames`` so every burst hits
one compiled executable. PyTorch runs eagerly, so the masks stay on the
host and steps with neither flag set are skipped; ``checksums`` still
comes back shaped ``[max_frames, 2]`` with zeros where nothing was saved.

The serving tier runs the burst over a ``[S]`` world of match slots
(:func:`rollout_burst_slots`), where JAX vmaps the masked scan over the
slot axis: each slot starts at its own frame and has masks of its own, so
each step's save of all S slots is one launch of the checksum kernel
with a frame and a keep flag a slot, and each step advances the ``[S]``
world once, a slot whose advance is off keeping its state (JAX's
``jnp.where``). The speculative rollout
(``parallel/speculate.py::rollout_branches``), run eagerly or captured as
a CUDA graph, is the same burst over a ``[B]`` world of branches with
every mask on: both run the one loop :func:`_slot_steps`, writing each
step's lanes straight into ``checksums[:, t]``.
:func:`ring_load_slots` loads each slot's own row of a ``[S, depth]``
stack of rings.

A tracer (``obs/trace.py``; default the shared no-op one) passed to
:meth:`RolloutExecutor.run`, :func:`rollout_burst` or the batched loop
records where the burst's host time goes: ``burst_setup`` (the load and
the uploads of the inputs), one ``burst_save`` a save and one
``burst_step`` a step of the schedule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.obs.trace import null_tracer
from bevy_ggrs_tpu_torch.schedule import PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import (
    SnapshotRing,
    WorldState,
    checksum_impl,
    ring_load,
    ring_save,
    signed_view,
    tree_map,
)


def select_slots(keep: torch.Tensor, new: WorldState, old: WorldState) -> WorldState:
    """Per slot of a ``[S]`` world, ``new`` where ``keep`` (``bool[S]``, on
    the world's device) is set, else ``old``: a fresh world."""

    def sel(n, o):
        mask = keep.reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(mask, signed_view(n), signed_view(o)).view(n.dtype)

    return tree_map(sel, new, old)


def ring_load_slots(rings: SnapshotRing, frames) -> WorldState:
    """Per slot ``s`` of a ``[S, depth]`` stack of rings, the state ring
    ``s`` saved for ``frames[s]`` (host ints): one index gather into a
    fresh ``[S]`` world, never a view of the rings."""
    S, depth = tuple(rings.frames.shape)
    device = rings.frames.device
    rows = torch.as_tensor(np.mod(np.asarray(frames, np.int64), depth), device=device)
    slots = torch.arange(S, device=device)
    return tree_map(lambda r: signed_view(r)[slots, rows].view(r.dtype), rings.states)


def rollout_burst(
    schedule: Schedule,
    ring: SnapshotRing,
    state: WorldState,
    start_frame: int,
    bits: torch.Tensor,  # [T, num_players, *input_shape]
    status: torch.Tensor,  # int32[T, num_players]
    save_mask: np.ndarray,  # bool[T], host
    adv_mask: np.ndarray,  # bool[T], host
    shard=None,  # an EntityShard: ring and state are its row blocks
    tracer=null_tracer,
) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
    """Run the ``T`` steps of one world; returns ``(ring, state,
    checksums[T, 2])`` with ``checksums[t]`` the checksum saved at step
    ``t`` (0 where ``save_mask[t]`` is False). The ring is updated in
    place. With ``shard`` the saves store the whole world's lanes
    (:meth:`~bevy_ggrs_tpu_torch.parallel.sharding.EntityShard.save`).
    ``tracer`` gets a ``burst_save`` span a save and a ``burst_step`` span
    a step."""
    checksums = torch.zeros((len(save_mask), 2), dtype=torch.int64, device=state.device)
    frame = int(start_frame)
    for t, (save, adv) in enumerate(zip(save_mask, adv_mask)):
        if save:
            with tracer.span("burst_save"):
                if shard is None:
                    ring, _ = ring_save(ring, state, frame, out=checksums[t])
                else:
                    shard.save(ring, state, frame, out=checksums[t])
        if adv:
            with tracer.span("burst_step"):
                state = schedule(state, PlayerInputs(bits=bits[t], status=status[t]))
            frame += 1
    return ring, state, checksums


def _slot_steps(schedule: Schedule, rings: SnapshotRing, states: WorldState,
                frames: torch.Tensor, bits: torch.Tensor, status: torch.Tensor,
                save_mask: np.ndarray, adv_mask: np.ndarray,
                keep: Optional[torch.Tensor] = None, advance: Optional[torch.Tensor] = None,
                shard=None, tracer=null_tracer) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
    """The loop of every batched burst: ``T`` steps of a ``[S]`` world
    (match slots, or the branches of a speculative rollout) into a ``[S,
    depth]`` stack of rings. Step ``t`` saves every slot whose
    ``save_mask[s, t]`` is set (host ``bool[S, T]``) at ``frames[t]``
    (``int32[T, S]`` on the world's device), one launch, and then steps
    the ``[S]`` world once if any slot's ``adv_mask[s, t]`` is set; the
    host masks only skip a step or take its all-on form. Where some slots
    are off, ``keep[t]`` and ``advance[t]`` (``bool[T, S]`` on the
    device) mask them: a slot not saved writes nothing and gets lanes 0, a
    slot not advanced keeps its state. ``bits[:, t]`` and ``status[:, t]``
    are step ``t``'s inputs. With a checksum function installed the save
    copies the rows and takes that function's digests; with ``shard``
    (every save on) the saves store the whole world's lanes. Returns
    ``(rings, states, checksums[S, T, 2])``; the rings are updated in
    place. ``tracer`` gets a ``burst_save`` span a save and a
    ``burst_step`` span a step."""
    from bevy_ggrs_tpu_torch.ops import checksum as ck

    S, T = save_mask.shape
    checksums = torch.zeros((S, T, 2), dtype=torch.int64, device=states.device)
    digest = checksum_impl()
    for t in range(T):
        if save_mask[:, t].any():
            with tracer.span("burst_save"):
                kept = None if save_mask[:, t].all() else keep[t]
                if shard is not None:
                    shard.save(rings, states, frames=frames[t], out=checksums[:, t])
                elif digest is None:
                    ck.world_checksum(states, "save", ring=rings, frames=frames[t], keep=kept,
                                      out=checksums[:, t])
                else:
                    ck.save_slots_plain(rings, states, frames[t], kept, checksums[:, t], digest)
        if adv_mask[:, t].any():
            with tracer.span("burst_step"):
                new = schedule(states, PlayerInputs(bits=bits[:, t], status=status[:, t]))
                states = new if adv_mask[:, t].all() else select_slots(advance[t], new, states)
    return rings, states, checksums


def rollout_burst_slots(
    schedule: Schedule,
    rings: SnapshotRing,  # a [S, depth] stack of rings
    states: WorldState,  # a [S] world
    start_frames: np.ndarray,  # int[S], host: each slot's first frame
    bits: torch.Tensor,  # [S, T, num_players, *input_shape]
    status: torch.Tensor,  # int32[S, T, num_players]
    save_mask: np.ndarray,  # bool[S, T], host
    adv_mask: np.ndarray,  # bool[S, T], host
) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
    """The burst of every slot of a ``[S]`` world at once: slot ``s``
    runs its own steps from ``start_frames[s]`` with its own masks, the
    semantics of ``S`` separate :func:`rollout_burst` calls. Step ``t``
    makes at most one save launch (every slot that saves, each at its own
    frame; the others masked) and one ``[S]`` schedule step (a slot whose
    advance is off keeps its state). Returns ``(rings, states,
    checksums[S, T, 2])``, zeros where a slot did not save; the rings are
    updated in place. With a checksum function installed
    (``state.set_checksum_impl``), each step's save copies the slots'
    rows and takes that function's digests."""
    save_mask = np.asarray(save_mask, bool)
    adv_mask = np.asarray(adv_mask, bool)
    device = states.device
    adv = adv_mask.astype(np.int64)
    # The frame each slot is at when step t runs (before it advances).
    at = np.asarray(start_frames, np.int64)[:, None] + np.cumsum(adv, axis=1) - adv
    frames = torch.as_tensor(np.ascontiguousarray(at.T).astype(np.int32), device=device)
    keep = torch.as_tensor(np.ascontiguousarray(save_mask.T), device=device)
    advance = torch.as_tensor(np.ascontiguousarray(adv_mask.T), device=device)
    return _slot_steps(schedule, rings, states, frames, bits, status, save_mask, adv_mask,
                       keep, advance)


class RolloutExecutor:
    """Request-burst executor bound to one schedule. The session drivers
    turn each request list into at most one :meth:`run` per
    ``advance_frame``. ``max_frames`` should be ``max_prediction + 2`` so
    the deepest rollback (load + full-window resimulation + the new frame)
    fits one call.

    With ``mesh`` and ``state_template`` (the whole world), or a shared
    ``layout`` (:class:`~bevy_ggrs_tpu_torch.parallel.sharding.MeshLayout`),
    the world's entity axis is split over the mesh's entity axis for
    every call: the state and ring a caller passes are this rank's row blocks
    (:func:`bevy_ggrs_tpu_torch.parallel.sharding.shard_world`) and stay
    so for the whole session; systems that couple entities see the whole
    world through the gather rule
    (:func:`~bevy_ggrs_tpu_torch.parallel.sharding.shard_schedule`), and
    the saved lanes are the whole world's. Integer state and the checksum
    match the unsharded run bitwise; a float system matches when its
    per-row arithmetic does not depend on the row count (box_game's does
    not; boids' sharded flock keeps the whole world's launch shapes)."""

    def __init__(self, schedule: Schedule, max_frames: int, mesh=None,
                 entity_axis: str = "entity", state_template=None, layout=None):
        from bevy_ggrs_tpu_torch.parallel.sharding import MeshLayout

        self.max_frames = int(max_frames)
        if layout is None:
            layout = MeshLayout(schedule, 1, mesh, branch_axis=None,
                                entity_axis=entity_axis, state_template=state_template)
        self.layout = layout
        self.shard = layout.entity
        self.schedule = layout.schedule

    def run(
        self,
        ring: SnapshotRing,
        state: WorldState,
        start_frame: int,
        bits,
        status,
        n_frames: int,
        load_frame: Optional[int] = None,
        save_mask=None,
        adv_mask=None,
        tracer=null_tracer,
    ) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
        """Run a host-assembled burst of ``n_frames`` steps.

        ``bits``/``status`` are host arrays shaped ``[n_frames, players,
        ...]``; ``load_frame=None`` means no rollback (steps start at
        ``start_frame``), else the burst starts from the state saved for
        ``load_frame``. ``save_mask``/``adv_mask`` default to all True (the
        standard (save, advance) pairing). ``tracer`` gets a ``burst_setup``
        span (the load and the two uploads) and :func:`rollout_burst`'s."""
        if n_frames > self.max_frames:
            raise ValueError(
                f"burst of {n_frames} frames exceeds max_frames={self.max_frames}"
            )
        valid = np.arange(self.max_frames) < n_frames

        def mask(m):
            if m is None:
                return valid
            out = np.zeros(self.max_frames, bool)
            out[:n_frames] = np.asarray(m, bool)[:n_frames]
            return out

        device = state.device
        with tracer.span("burst_setup"):
            if load_frame is not None:
                state = ring_load(ring, load_frame)
                start_frame = load_frame
            bits = torch.tensor(np.asarray(bits), device=device)
            status = torch.tensor(np.asarray(status, np.int32), device=device)
        return rollout_burst(self.schedule, ring, state, start_frame, bits, status,
                             mask(save_mask), mask(adv_mask), self.shard, tracer)


def advance_n(
    schedule: Schedule,
    state: WorldState,
    bits: torch.Tensor,
    status: Optional[torch.Tensor] = None,
) -> WorldState:
    """Plain N-frame advance (no ring, no checksums) over the leading
    frame axis of ``bits``."""
    if status is None:
        status = torch.zeros(bits.shape[:2], dtype=torch.int32, device=bits.device)
    for b, s in zip(bits, status):
        state = schedule(state, PlayerInputs(bits=b, status=s))
    return state
