"""Shared session vocabulary: states, errors, events.

Analog of the ggrs crate's public error/event/state types as consumed by the
reference (`/root/reference/src/ggrs_stage.rs:202,244` gates on
``SessionState::Running``; ``:205,251`` matches ``GGRSError::
PredictionThreshold``; events pumped at `examples/box_game/box_game_p2p.rs:
107-111`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

NULL_FRAME = -1


class SessionState(enum.Enum):
    """`SessionState` analog: sessions start Synchronizing and only advance
    once Running (`ggrs_stage.rs:202,244`)."""

    SYNCHRONIZING = "synchronizing"
    RUNNING = "running"


class GGRSError(Exception):
    """Base session error."""


class PredictionThreshold(GGRSError):
    """Too far ahead of the last confirmed input — the caller must skip this
    frame and retry later (back-pressure; `ggrs_stage.rs:251-253` logs and
    skips, spectators wait for the host `:205-207`)."""


class NotSynchronized(GGRSError):
    """Session is still synchronizing with remotes (or spectator has no host
    data yet)."""


class InvalidRequest(GGRSError):
    """API misuse: wrong handle, wrong input count, duplicate add_input."""


class MismatchedChecksum(GGRSError):
    """SyncTest: a resimulated frame produced a different checksum than the
    original simulation — determinism is broken (desync)."""

    def __init__(self, frame: int, original: int, resimulated: int):
        super().__init__(
            f"desync at frame {frame}: original checksum {original:#018x}, "
            f"resimulated {resimulated:#018x}"
        )
        self.frame = frame
        self.original = original
        self.resimulated = resimulated


class EventKind(enum.Enum):
    """Session events the app can pump, mirroring ggrs's event enum as
    printed by the reference examples (`box_game_p2p.rs:107-111`)."""

    SYNCHRONIZING = "synchronizing"  # progress: (count, total)
    SYNCHRONIZED = "synchronized"
    DISCONNECTED = "disconnected"
    NETWORK_INTERRUPTED = "network_interrupted"  # disconnect_timeout imminent
    NETWORK_RESUMED = "network_resumed"
    WAIT_RECOMMENDATION = "wait_recommendation"  # skip frames to let peers catch up
    DESYNC_DETECTED = "desync_detected"
    # Extension over ggrs's enum: a peer keeps sending datagrams with our
    # magic but a different protocol version — without this, mixed-version
    # peers hang in SYNCHRONIZING forever with no operator-visible signal.
    VERSION_MISMATCH = "version_mismatch"  # data: (peer_version, count)
    # Extension: the peer speaks our protocol version but advertises a
    # different 64-bit session-config digest in the sync handshake (v4:
    # the learned input-predictor weight hash, 0 = off). The handshake is
    # refused — the peer stays SYNCHRONIZING, never RUNNING — because
    # playing on with silently different prediction configs is an
    # operational lie even though confirmed-input determinism would hold.
    # data: (local_digest, peer_digest, count)
    CONFIG_MISMATCH = "config_mismatch"
    # Extension: speculation-safety attestation failed at warmup — the
    # vmapped rollout and serial burst disagreed bitwise for this model, so
    # speculative recovery was auto-disabled (serial path stays correct).
    SPECULATION_DISABLED = "speculation_disabled"  # data: attestation detail
    # Extension: attestation PASSED but the scanned all-branch proxy layer
    # self-disqualified (it disagreed with the rollout while the real
    # serial executable agreed) — effective full-coverage assurance then
    # rests on the real-executable layer plus the adjudicated branches,
    # which is weaker than the headline "scanned_branches" suggests.
    # data: attestation detail incl. effective coverage; run with
    # GGRS_ATTEST_EXHAUSTIVE=1 to restore full real-executable coverage.
    ATTESTATION_DEGRADED = "attestation_degraded"
    # Extensions for the self-healing supervisor (docs/chaos.md): ggrs stops
    # at DESYNC_DETECTED / DISCONNECTED; these report the repair lifecycle.
    PLAYER_REJOINED = "player_rejoined"  # data: {"handle": h}
    QUARANTINED = "quarantined"  # local peer lost the checksum vote
    RECOVERED = "recovered"  # quarantine healed via state transfer
    # Silent-data-corruption attestation (bevy_ggrs_tpu_torch.integrity): a ring
    # row's recomputed digest disagreed with its save-time digest. data:
    # {"reason": "sdc", "frames": [...], "repaired": bool, "bitwise": bool,
    # "field": first corrupt field or None}. repaired+bitwise incidents are
    # informational (the repair landed bitwise — no quarantine); repaired
    # False means the supervisor escalated to a donor transfer.
    STATE_FAULT = "state_fault"


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    kind: EventKind
    addr: Optional[Any] = None  # peer address, where applicable
    data: Optional[Any] = None  # kind-specific payload


@dataclasses.dataclass
class NetworkStats:
    """Per-remote-player stats (`network_stats(handle)` consumed at
    `box_game_p2p.rs:113-129`)."""

    ping_ms: float = 0.0
    send_queue_len: int = 0
    kbps_sent: float = 0.0
    local_frames_behind: int = 0
    remote_frames_behind: int = 0


# ---------------------------------------------------------------------------
# Checkpoint span (de)serialization, shared by every session flavor
# ---------------------------------------------------------------------------


def serialize_spans(queues, lo: int) -> dict:
    """JSON-encode each queue's surviving confirmed span from ``lo`` up."""
    import numpy as np

    out = {}
    for h, q in enumerate(queues):
        per = {}
        for f in range(lo, q.last_confirmed_frame + 1):
            got = q.confirmed(f)
            if got is not None:
                per[str(f)] = np.asarray(got).tolist()
        out[str(h)] = per
    return out


def restore_spans(queues, inputs_sd: dict, default_start: int, dtype, shape,
                  meta: Optional[dict] = None, on_confirmed=None) -> None:
    """Inverse of :func:`serialize_spans`: reset each queue and replay its
    span through the exact-frame path (no re-applied delay). ``meta``
    optionally carries per-queue ``{"last_confirmed", "last_input"}`` so a
    queue with NO surviving span (player dead long before the checkpoint)
    keeps its confirmed frontier and frozen repeat-last prediction.
    ``on_confirmed(h, frame, bits)`` fires per restored input (the P2P
    session re-notes them against used records to re-derive pending
    rollbacks)."""
    import numpy as np

    for h, q in enumerate(queues):
        per = (inputs_sd or {}).get(str(h), {})
        m = (meta or {}).get(str(h), {})
        frames = sorted(int(f) for f in per)
        last = m.get("last_input")
        if last is not None:
            last = np.asarray(last, dtype=dtype).reshape(shape)
        if frames:
            q.reset(frames[0], last)
            for f in frames:
                arr = np.asarray(per[str(f)], dtype=dtype).reshape(shape)
                q.add_input(f, arr)
                if on_confirmed is not None:
                    on_confirmed(h, f, arr)
        else:
            q.reset(int(m.get("last_confirmed", default_start - 1)) + 1, last)
