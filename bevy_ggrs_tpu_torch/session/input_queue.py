"""Per-player input history with repeat-last-input prediction.

The ggrs-internal input queue, rebuilt: confirmed inputs arrive in frame
order (from the local input system after input delay, or from the network);
queries for frames beyond the confirmed horizon return a *prediction* —
repeat the last confirmed input (the GGPO/ggrs policy the survey documents in
§2.2 "Behavioral spec"). The session layer compares predictions it handed out
against later-arriving confirmed inputs to find the first incorrect frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bevy_ggrs_tpu_torch.session.common import InvalidRequest, NULL_FRAME

# Disconnect-frame sentinel meaning "this player never disconnected": the
# P2P session passes it for connected players, and :meth:`PyQueueSet.gather`
# marks a player DISCONNECTED from ``frame >= disc_frames[h]``, which it
# never is. The value is INT32_MAX, as in the JAX package's native core.
NEVER_DISCONNECTED = 2**31 - 1


class InputQueue:
    def __init__(self, zero_input: np.ndarray, delay: int = 0):
        self._zero = np.asarray(zero_input).copy()
        self.delay = int(delay)
        self._inputs: Dict[int, np.ndarray] = {}
        self._last_confirmed = NULL_FRAME
        self._last_input = self._zero  # prediction source; survives discard

    @property
    def last_confirmed_frame(self) -> int:
        return self._last_confirmed

    @property
    def last_input(self) -> np.ndarray:
        """The repeat-last prediction source (for checkpointing)."""
        return self._last_input.copy()

    def add_input(self, frame: int, bits) -> Optional[int]:
        """Record the confirmed input for ``frame``. Out-of-order or
        duplicate frames ≤ last confirmed are ignored (network redundancy:
        peers resend spans of recent inputs). Gaps are an error — the wire
        protocol delivers contiguous spans. Returns the frame actually
        recorded, or None if it was stale."""
        frame = int(frame)
        if frame <= self._last_confirmed:
            return None
        if frame != self._last_confirmed + 1:
            raise InvalidRequest(
                f"non-contiguous input: got frame {frame}, expected "
                f"{self._last_confirmed + 1}"
            )
        arr = np.asarray(bits, dtype=self._zero.dtype).reshape(self._zero.shape)
        self._inputs[frame] = arr
        self._last_confirmed = frame
        self._last_input = arr
        return frame

    def add_local_input(self, frame: int, bits) -> int:
        """Record a local input issued at ``frame``, which takes effect at
        ``frame + delay`` (input delay, `SessionBuilder::with_input_delay`
        used at `box_game_p2p.rs:37`). Frames in the delay gap are filled
        with the zero input."""
        target = int(frame) + self.delay
        while self._last_confirmed < target - 1:
            self.add_input(self._last_confirmed + 1, self._zero)
        self.add_input(target, bits)
        return target

    def confirmed(self, frame: int) -> Optional[np.ndarray]:
        return self._inputs.get(int(frame))

    def confirmed_span(self, lo: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Confirmed inputs for frames ``lo .. lo+n-1`` as
        ``(values[n, *shape], mask[n])``; unconfirmed slots are zeros with
        mask False. Bulk form of :meth:`confirmed` (same contract as the
        native queue's one-FFI-call span — the speculative runner queries
        this once per player per tick instead of once per frame)."""
        values = np.zeros((n,) + self._zero.shape, dtype=self._zero.dtype)
        mask = np.zeros(n, dtype=bool)
        lo = int(lo)
        for i in range(n):
            got = self._inputs.get(lo + i)
            if got is not None:
                values[i] = got
                mask[i] = True
        return values, mask

    def input(self, frame: int) -> Tuple[np.ndarray, bool]:
        """Input to use for ``frame``: ``(bits, is_confirmed)``. Unconfirmed
        frames predict by repeating the last confirmed input (zero input if
        nothing confirmed yet)."""
        frame = int(frame)
        if frame <= self._last_confirmed:
            got = self._inputs.get(frame)
            if got is None:
                # Discarded history — protocol never asks for frames behind
                # the discard horizon.
                raise InvalidRequest(f"input for frame {frame} was discarded")
            return got, True
        if self._last_confirmed == NULL_FRAME:
            return self._zero.copy(), False
        return self._last_input, False

    def discard_before(self, frame: int) -> None:
        """Drop history older than ``frame`` (already-confirmed and outside
        the rollback window) to bound memory."""
        for f in [f for f in self._inputs if f < frame]:
            del self._inputs[f]

    def reset(self, next_frame: int, last_input=None) -> None:
        """Checkpoint-restore support: forget all history and make
        ``next_frame`` the next contiguous frame :meth:`add_input` accepts.
        The prediction source resets to ``last_input`` when given (restored
        repeat-last value for players whose history fell outside the
        checkpoint window), else to zero (the restorer replays the
        in-window inputs afterwards, which re-derives it)."""
        self._inputs.clear()
        self._last_confirmed = int(next_frame) - 1
        self._last_input = (
            self._zero if last_input is None
            else np.asarray(last_input, dtype=self._zero.dtype).reshape(
                self._zero.shape)
        )


class PyQueueSet:
    """One :class:`InputQueue` per player, gathered frame by frame."""

    def __init__(self, zero: np.ndarray, delays: Sequence[int]):
        zero = np.asarray(zero)
        self._zero = zero
        self._num_players = len(delays)
        self.queues = [InputQueue(zero, int(d)) for d in delays]

    def discard_before(self, frame: int) -> None:
        for q in self.queues:
            q.discard_before(frame)

    def min_confirmed(self, connected=None) -> int:
        frames = [
            q.last_confirmed_frame
            for h, q in enumerate(self.queues)
            if connected is None or connected[h]
        ]
        return min(frames) if frames else NULL_FRAME

    def gather(
        self, frame: int, disc_frames: Optional[Sequence[int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        from bevy_ggrs_tpu_torch.schedule import CONFIRMED, DISCONNECTED, PREDICTED

        P = self._num_players
        bits = np.empty((P,) + self._zero.shape, self._zero.dtype)
        status = np.empty((P,), np.int32)
        for h, q in enumerate(self.queues):
            b, is_confirmed = q.input(frame)
            bits[h] = b
            if disc_frames is not None and frame >= disc_frames[h]:
                status[h] = DISCONNECTED
            else:
                status[h] = CONFIRMED if is_confirmed else PREDICTED
        return bits, status


class PyTracker:
    """The misprediction tracker: the inputs each advanced frame used, and
    the first frame whose used input a later confirmed input contradicts
    (the rollback target)."""

    def __init__(self, num_players: int, zero: np.ndarray):
        from bevy_ggrs_tpu_torch.schedule import CONFIRMED

        self._P = int(num_players)
        self._confirmed = CONFIRMED
        self._used = {}
        self._first_incorrect = NULL_FRAME

    def record_used(self, frame: int, bits: np.ndarray, status: np.ndarray) -> None:
        self._used[int(frame)] = (np.array(bits, copy=True), np.array(status, copy=True))

    def note_confirmed(self, handle: int, frame: int, bits) -> None:
        used = self._used.get(int(frame))
        if used is None:
            return
        used_bits, used_status = used
        if used_status[handle] != self._confirmed and not np.array_equal(
            used_bits[handle], np.asarray(bits, dtype=used_bits.dtype)
        ):
            if self._first_incorrect == NULL_FRAME or frame < self._first_incorrect:
                self._first_incorrect = int(frame)

    @property
    def first_incorrect(self) -> int:
        return self._first_incorrect

    def clear_first_incorrect(self) -> None:
        self._first_incorrect = NULL_FRAME

    def get_used(self, frame: int):
        return self._used.get(int(frame))

    def discard_before(self, frame: int) -> None:
        for f in [f for f in self._used if f < frame]:
            del self._used[f]


# The session builds its queues and its tracker through these factories.
# They return the Python classes: the native data plane is not ported yet
# (ROADMAP.md, port queue item 3).


def make_queue_set(zero: np.ndarray, delays: Sequence[int]) -> PyQueueSet:
    return PyQueueSet(np.asarray(zero), delays)


def make_tracker(num_players: int, zero: np.ndarray) -> PyTracker:
    return PyTracker(num_players, np.asarray(zero))
