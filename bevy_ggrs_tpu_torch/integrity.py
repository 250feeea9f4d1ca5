"""Silent-data-corruption integrity: attestation, forensics, fault injection.

Counterpart of ``bevy_ggrs_tpu/integrity.py``.

- **Attestation** (:func:`attest_ring`): recompute every occupied ring
  row's two-lane digest and compare it with the digest ``ring_save``
  stored. The recompute is one checksum-kernel launch over the ring's
  ``[depth]`` row axis (``[S, depth]`` rings flatten to the same batch
  axis). A mismatch means the row's bytes changed after they were saved.
- **Repair** is rollback's job: the runner restores the deepest clean
  snapshot and resimulates from its input log
  (``RollbackRunner.attest_and_repair``). This module supplies the
  detection mask, the typed fault and the forensics.
- **Forensics** (:func:`host_row` / :func:`first_corrupt_field`): name the
  first registered field whose bytes differ between a corrupt row and its
  repaired replacement, in NumPy on host copies.
- **Fault injection** (:func:`flip_ring_bit` / :func:`flip_file_bit`):
  ring flips land only in words the checksum covers, so every injection
  is detectable.

A checksum function installed with
:func:`bevy_ggrs_tpu_torch.state.set_checksum_impl` is the digest of
every reader here, as it is of every save.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops.checksum import guard_plain, world_checksum
from bevy_ggrs_tpu_torch.state import (
    SnapshotRing,
    WorldState,
    active_checksum,
    checksum_impl,
    to_numpy,
    tree_leaves,
)


class StateFault(RuntimeError):
    """Corruption was detected and could not be repaired locally (no clean
    snapshot below the corrupt rows, or the input log no longer covers the
    resimulation span)."""

    def __init__(self, reason: str, frames=(), slot: Optional[int] = None,
                 detail: str = ""):
        self.reason = str(reason)
        self.frames = tuple(int(f) for f in frames)
        self.slot = slot
        self.detail = detail
        at = f" slot={slot}" if slot is not None else ""
        why = f" — {detail}" if detail else ""
        super().__init__(
            f"StateFault({self.reason}){at}: frames={list(self.frames)}{why}"
        )


def _state_digest(state: WorldState, shard=None) -> torch.Tensor:
    """Digest of one live world state, or of the serving tier's ``[S]``
    stacked states (the bitwise-repair witness): one launch. ``shard``
    (an ``EntityShard``, here and below): ``state`` is its row block, and
    the digest is the whole world's."""
    return active_checksum(state) if shard is None else shard.checksum(state)


def ring_digests(ring: SnapshotRing, shard=None) -> torch.Tensor:
    """Recomputed per-row digests, shaped like ``ring.checksums``: one
    kernel launch over every row (a ``[depth]`` ring or ``[S, depth]``
    rings)."""
    return _state_digest(ring.states, shard)


def attest_ring(ring: SnapshotRing, shard=None) -> np.ndarray:
    """Attestation mask shaped like ``ring.frames``: True where an occupied
    row's recomputed digest disagrees with the digest stored at save time
    (corruption in the states or in the stored digest — either way the
    row can no longer be trusted as a rollback base)."""
    digests = ring_digests(ring, shard).cpu().numpy()
    frames = ring.frames.cpu().numpy()
    stored = ring.checksums.cpu().numpy()
    return (frames >= 0) & np.any(digests != stored, axis=-1)


def verify_row(ring: SnapshotRing, frame: int, shard=None) -> bool:
    """Restore-path guard (singleton rings): does ``frame``'s row still
    hash to its save-time digest? A non-resident frame returns True — a
    load of a rotated-out frame is a protocol bug, not corruption. One
    launch of the checksum kernel in its guard mode, which hashes the row
    in place and compares it on the device, and one 4-byte read (on an
    entity shard: the row's lanes summed over the group, then compared)."""
    if shard is not None:
        return shard.guard(ring, frame)
    fn = checksum_impl()
    if fn is not None:
        return bool(guard_plain(ring, frame, digest=fn).item())
    return bool(world_checksum(None, "guard", ring=ring, frame=frame).item())


def warm(ring: SnapshotRing, state=None, states=None, shard=None) -> None:
    """Run every digest pass this ring and state (or ``[S]`` states) will
    need once, so the kernel is built and each world structure's layout
    cached before the session goes live: attestation and repair then
    prepare nothing on the serving path (``utils.build_cache``)."""
    ring_digests(ring, shard)  # the guard reads the same layout as this pass
    for live in (state, states):
        if live is not None:
            _state_digest(live, shard)


# ---------------------------------------------------------------------------
# Forensics: name the first corrupt field
# ---------------------------------------------------------------------------


def host_row(ring: SnapshotRing, row: int, slot: Optional[int] = None):
    """Host copy of one ring row's registered fields, keyed in canonical
    order (rollback_id, alive, then present/component pairs, then resource
    leaves)."""
    idx = (row,) if slot is None else (slot, row)
    st = ring.states
    out = {
        "rollback_id": to_numpy(st.rollback_id)[idx],
        "alive": to_numpy(st.alive)[idx],
    }
    for name in sorted(st.components):
        out[f"present/{name}"] = to_numpy(st.present[name])[idx]
        out[f"component/{name}"] = to_numpy(st.components[name])[idx]
    for name in sorted(st.resources):
        for j, leaf in enumerate(tree_leaves(st.resources[name])):
            out[f"resource/{name}/{j}"] = to_numpy(leaf)[idx]
    return out


def first_corrupt_field(before: dict, after: dict) -> Optional[str]:
    """First field (canonical :func:`host_row` order) whose bytes differ
    between the corrupt row and its repaired replacement."""
    for name, arr in before.items():
        if not np.array_equal(arr, after.get(name)):
            return name
    return None


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


def flip_ring_bit(ring: SnapshotRing, row: int, rng,
                  slot: Optional[int] = None):
    """Flip one random bit inside ring row ``row`` (batch slot ``slot``
    for stacked rings), restricted to words the checksum covers: a
    non-bool component of a live, present entity, the rollback_id of a
    live entity, or (empty world) an alive bit. Returns ``(ring, info)``
    with the injected field named."""
    idx = (row,) if slot is None else (slot, row)
    st = ring.states
    device = st.device
    alive = to_numpy(st.alive)[idx]
    live = np.flatnonzero(alive)
    comp_names = []
    for name in sorted(st.components):
        if st.components[name].dtype == torch.bool:
            continue
        pres = to_numpy(st.present[name])[idx]
        if np.flatnonzero(pres & alive).size:
            comp_names.append(name)
    if live.size and comp_names and float(rng.random_sample()) < 0.5:
        name = comp_names[int(rng.randint(0, len(comp_names)))]
        pres = to_numpy(st.present[name])[idx]
        slots_ = np.flatnonzero(pres & alive)
        k = int(slots_[int(rng.randint(0, slots_.size))])
        full = to_numpy(st.components[name])
        row_bytes = full[idx].reshape(full[idx].shape[0], -1)[k].view(np.uint8)
        b = int(rng.randint(0, row_bytes.size * 8))
        row_bytes[b // 8] ^= np.uint8(1 << (b % 8))
        new = st.replace(components={
            **st.components, name: torch.from_numpy(full).to(device)})
        info = {"field": f"component/{name}", "entity": k, "bit": b}
    elif live.size:
        k = int(live[int(rng.randint(0, live.size))])
        full = to_numpy(st.rollback_id)
        bit = int(rng.randint(0, 32))
        full.view(np.uint32)[idx + (k,)] ^= np.uint32(1 << bit)
        new = st.replace(rollback_id=torch.from_numpy(full).to(device))
        info = {"field": "rollback_id", "entity": k, "bit": bit}
    else:
        k = int(rng.randint(0, alive.shape[0]))
        full = to_numpy(st.alive)
        full[idx + (k,)] = ~full[idx + (k,)]
        new = st.replace(alive=torch.from_numpy(full).to(device))
        info = {"field": "alive", "entity": k, "bit": 0}
    if slot is not None:
        info["slot"] = int(slot)
    info["row"] = int(row)
    return ring.replace(states=new), info


def flip_file_bit(path: str, rng) -> Optional[dict]:
    """Flip one random bit in a file on disk (checkpoint-corruption fault).
    Returns the injection record, or None when the file is empty or
    absent."""
    try:
        with open(path, "rb") as f:
            data = bytearray(f.read())
    except OSError:
        return None
    if not data:
        return None
    b = int(rng.randint(0, len(data) * 8))
    data[b // 8] ^= 1 << (b % 8)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return {"path": str(path), "bit": b}
