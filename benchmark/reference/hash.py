"""The world checksum, written again in NumPy from its definition.

A 64-bit checksum carried as two 32-bit lanes ``[lo, hi]``: per live slot
a murmur3 chain (one lane seeded with ``SEED``, the other with ``SEED ^
HI_TWEAK``) over the slot's rollback id, then, per component in sorted
name order, its presence bit and its presence-masked 32-bit words; each
chain is finalised (fmix32) and the lanes wrap-sum over the live slots.
Every resource adds a constant term and one finalised hash per 32-bit
word, seeded by the resource's name and the word's position. All sums
wrap at 2**32.

A world here is the dict that ``benchmark.harness.world_to_host`` makes:
``alive``, ``rollback_id``, ``present`` and ``components`` by name, and
``resources`` by name, all NumPy arrays.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593
SEED = 0x9747B28C
HI_TWEAK = 0x9E3779B9


def _mul32(x: np.ndarray, c: int) -> np.ndarray:
    return (x * np.uint64(c)) & np.uint64(M32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) & np.uint64(M32)) | (x >> np.uint64(32 - r))


def _mix(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    k = _mul32(_rotl(_mul32(w, C1), 15), C2)
    h = h ^ k
    return (_mul32(_rotl(h, 13), 5) + np.uint64(0xE6546B64)) & np.uint64(M32)


def _fmix(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(16))
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> np.uint64(13))
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> np.uint64(16))


def words(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` (``n`` rows) as ``uint64[n, words]`` holding 32-bit words:
    bools as 0/1, 1- and 2-byte types zero-extended from their bits, 4-byte
    types as their bits, 8-byte types as two words, low first."""
    a = np.ascontiguousarray(a).reshape(n, -1)
    if a.dtype == np.bool_:
        return a.astype(np.uint64)
    if a.dtype.itemsize in (1, 2):
        return a.view(f"u{a.dtype.itemsize}").astype(np.uint64)
    return a.view(np.uint32).astype(np.uint64)


def _name_seed(name: str) -> int:
    seed = 0
    for b in name.encode():
        seed = (seed * 31 + b) & M32
    return seed


def lanes(world: dict) -> np.ndarray:
    """``uint64[2]``: the ``[lo, hi]`` lanes of one world."""
    alive = np.asarray(world["alive"], bool)
    n = alive.shape[0]
    h = np.empty((2, n), np.uint64)
    h[0] = SEED
    h[1] = SEED ^ HI_TWEAK
    chain = [words(world["rollback_id"], n)]
    for name in sorted(world["components"]):
        pres = np.asarray(world["present"][name], bool)
        chain.append(pres.astype(np.uint64)[:, None])
        chain.append(np.where(pres[:, None], words(world["components"][name], n), 0))
    for block in chain:
        for i in range(block.shape[1]):
            h = _mix(h, block[:, i][None, :])
    total = (np.where(alive[None, :], _fmix(h), 0).sum(axis=1, dtype=np.uint64)
             & np.uint64(M32))
    for name in sorted(world["resources"]):
        ns = _name_seed(name)
        seeds = np.array([SEED ^ ns, (SEED ^ HI_TWEAK) ^ ns], np.uint64)
        total = total + _fmix(seeds)
        w = words(np.asarray(world["resources"][name]), 1)[0]
        pos = _mul32(np.arange(w.shape[0], dtype=np.uint64), HI_TWEAK)
        hh = _fmix(_mix(seeds[:, None] ^ pos[None, :], w[None, :]))
        total = (total + hh.sum(axis=1, dtype=np.uint64)) & np.uint64(M32)
    return total & np.uint64(M32)
