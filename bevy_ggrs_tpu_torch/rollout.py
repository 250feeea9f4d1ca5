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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.schedule import PlayerInputs, Schedule
from bevy_ggrs_tpu_torch.state import SnapshotRing, WorldState, ring_load, ring_save


def rollout_burst(
    schedule: Schedule,
    ring: SnapshotRing,
    state: WorldState,
    start_frame: int,
    bits: torch.Tensor,  # [T, num_players, *input_shape], on state's device
    status: torch.Tensor,  # int32[T, num_players]
    save_mask: np.ndarray,  # bool[T], host
    adv_mask: np.ndarray,  # bool[T], host
) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
    """Run the ``T`` steps; returns ``(ring, state, checksums[T, 2])`` with
    ``checksums[t]`` the checksum saved at step ``t`` (0 where
    ``save_mask[t]`` is False). The ring is updated in place."""
    checksums = torch.zeros((len(save_mask), 2), dtype=torch.int64,
                            device=state.device)
    frame = int(start_frame)
    for t, (save, adv) in enumerate(zip(save_mask, adv_mask)):
        if save:
            ring, _ = ring_save(ring, state, frame, out=checksums[t])
        if adv:
            state = schedule(state, PlayerInputs(bits=bits[t], status=status[t]))
            frame += 1
    return ring, state, checksums


class RolloutExecutor:
    """Request-burst executor bound to one schedule. The session drivers
    turn each request list into at most one :meth:`run` per
    ``advance_frame``. ``max_frames`` should be ``max_prediction + 2`` so
    the deepest rollback (load + full-window resimulation + the new frame)
    fits one call."""

    def __init__(self, schedule: Schedule, max_frames: int):
        self.schedule = schedule
        self.max_frames = int(max_frames)

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
    ) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
        """Run a host-assembled burst of ``n_frames`` steps.

        ``bits``/``status`` are host arrays shaped ``[n_frames, players,
        ...]``; ``load_frame=None`` means no rollback (steps start at
        ``start_frame``), else the burst starts from the state saved for
        ``load_frame``. ``save_mask``/``adv_mask`` default to all True (the
        standard (save, advance) pairing)."""
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
        if load_frame is not None:
            state = ring_load(ring, load_frame)
            start_frame = load_frame
        bits = torch.tensor(np.asarray(bits), device=device)
        status = torch.tensor(np.asarray(status, np.int32), device=device)
        ring, state, checksums = rollout_burst(
            self.schedule, ring, state, start_frame, bits, status,
            mask(save_mask), mask(adv_mask),
        )
        return ring, state, checksums


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
