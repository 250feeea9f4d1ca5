"""Exact delta codec for the confirmed-state broadcast stream.

Counterpart of ``bevy_ggrs_tpu/relay/delta.py``: the same layout, so for
equal worlds (both packages' ``to_host`` give the same dict of arrays) the
flat bytes, deltas and digests equal the JAX package's.

Confirmed frames are bitwise-stable across peers (the whole desync-detection
design depends on it), so consecutive confirmed states can be diffed as raw
bytes with zero tolerance: the stream is ``keyframe + XOR/RLE deltas`` and a
spectator reconstructs every confirmed frame *bitwise-identical* to the
authoritative state — no quantization, no "visually close enough".

Two layers:

- :class:`StateCodec` — a fixed, deterministic flat-byte layout for one
  world template (leaf paths sorted, shapes/dtypes pinned at construction).
  ``npz``-style compression (utils/persistence.py) is deliberately NOT used
  here: compressed sizes shift with content, which destroys the byte
  alignment XOR depends on. The flat layout keeps byte i of frame F and
  byte i of frame F+1 referring to the same tensor element, which is what
  makes the XOR sparse (SoA tensors: most entities don't change most
  fields every frame).
- :func:`delta_encode` / :func:`delta_apply` — XOR the two equal-length
  buffers, then run-length encode the zero gaps as ``(skip varint,
  literal-length varint, literal XOR bytes)`` tokens. Zero gaps shorter
  than :data:`_MIN_GAP` are folded into the surrounding literal (a 2-byte
  token boundary costs more than carrying 3 zero bytes). ``delta_apply``
  is strict: any truncation, overrun, trailing garbage, or (when the
  caller passes ``expect_crc``) checksum mismatch raises ``ValueError`` —
  a corrupted delta must never silently produce a plausible state.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "StateCodec",
    "delta_encode",
    "delta_apply",
    "payload_digest",
]

# Zero runs shorter than this ride inside a literal instead of splitting it.
_MIN_GAP = 4


def payload_digest(data: bytes) -> int:
    """64-bit integrity digest of a full state payload: two independent
    crc32 lanes (different seeds) packed into one u64. Guards against
    transport corruption — not an adversarial MAC (docs/protocol.md §7)."""
    lo = zlib.crc32(data) & 0xFFFFFFFF
    hi = zlib.crc32(data, 0x9E3779B9) & 0xFFFFFFFF
    return (hi << 32) | lo


# ---------------------------------------------------------------------------
# Flat state layout
# ---------------------------------------------------------------------------


def _walk(tree: Any, path: Tuple[str, ...], out: List) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], path + (key,), out)
    else:
        arr = np.asarray(tree)
        out.append((path, arr.shape, arr.dtype))


class StateCodec:
    """Deterministic ``WorldState`` ⇄ flat bytes for one world template.

    Layout = every leaf of the host tree (``state.to_host`` output) in
    sorted-path order, raw little-endian bytes, concatenated. Shapes and
    dtypes are pinned at construction; encoding a state of a different
    template raises (the stream would silently desynchronize otherwise).
    """

    def __init__(self, template_host: Dict[str, Any]):
        leaves: List = []
        _walk(template_host, (), leaves)
        self._leaves = leaves  # [(path, shape, dtype)]
        self._counts = [int(np.prod(sh, dtype=np.int64)) for _, sh, _ in leaves]
        self._sizes = [
            int(np.dtype(dt).itemsize) * cnt
            for (_, _, dt), cnt in zip(leaves, self._counts)
        ]
        self.size = sum(self._sizes)

    @classmethod
    def for_state(cls, state) -> "StateCodec":
        from bevy_ggrs_tpu_torch.state import to_host

        return cls(to_host(state))

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _lookup(tree: Dict[str, Any], path: Tuple[str, ...]):
        node = tree
        for key in path:
            node = node[key]
        return node

    def encode(self, state_or_host) -> bytes:
        """Flat bytes of a ``WorldState`` (or an already-host tree)."""
        if isinstance(state_or_host, dict):
            host = state_or_host
        else:
            from bevy_ggrs_tpu_torch.state import to_host

            host = to_host(state_or_host)
        parts = []
        for (path, shape, dtype), size in zip(self._leaves, self._sizes):
            arr = np.asarray(self._lookup(host, path))
            if arr.shape != shape or arr.dtype != dtype:
                raise ValueError(
                    f"state leaf {'/'.join(path)} is {arr.dtype}{arr.shape}, "
                    f"codec template pinned {dtype}{shape}"
                )
            b = np.ascontiguousarray(arr).tobytes()
            assert len(b) == size
            parts.append(b)
        return b"".join(parts)

    def decode(self, data: bytes) -> Dict[str, Any]:
        """Flat bytes → nested host tree (plain numpy arrays)."""
        if len(data) != self.size:
            raise ValueError(
                f"payload is {len(data)} bytes, codec template needs {self.size}"
            )
        out: Dict[str, Any] = {}
        off = 0
        for (path, shape, dtype), count, size in zip(
            self._leaves, self._counts, self._sizes
        ):
            arr = np.frombuffer(
                data, dtype=dtype, count=count, offset=off
            ).reshape(shape)
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = arr
            off += size
        return out

    def decode_state(self, data: bytes):
        """Flat bytes → a :class:`~bevy_ggrs_tpu_torch.state.WorldState` of
        CPU tensors (for checksumming / feeding back into the rollback
        domain); a bfloat16 leaf comes back as its ``uint16`` bit patterns,
        as ``to_host`` gives it."""
        import torch

        from bevy_ggrs_tpu_torch.state import WorldState, tree_map

        return tree_map(lambda a: torch.from_numpy(np.array(a)),
                        WorldState(**self.decode(data)))


# ---------------------------------------------------------------------------
# XOR + RLE delta
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated delta: varint runs past the payload")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("corrupt delta: varint overflow")


def delta_encode(prev: bytes, cur: bytes) -> bytes:
    """XOR+RLE delta turning ``prev`` into ``cur`` (equal lengths required;
    the state layout is fixed). Identical buffers encode to ``b""``."""
    if len(prev) != len(cur):
        raise ValueError(
            f"delta base is {len(prev)} bytes, target {len(cur)}; the flat "
            "state layout is fixed — mismatched sizes mean mixed templates"
        )
    x = np.frombuffer(prev, dtype=np.uint8) ^ np.frombuffer(cur, dtype=np.uint8)
    nz = np.flatnonzero(x)
    if nz.size == 0:
        return b""
    # Segment boundaries: split only where the zero gap pays for a token.
    breaks = np.flatnonzero(np.diff(nz) > _MIN_GAP)
    starts = nz[np.concatenate(([0], breaks + 1))]
    ends = nz[np.concatenate((breaks, [nz.size - 1]))] + 1
    parts = []
    pos = 0
    xb = x.tobytes()
    for s, e in zip(starts.tolist(), ends.tolist()):
        parts.append(_varint(s - pos))
        parts.append(_varint(e - s))
        parts.append(xb[s:e])
        pos = e
    return b"".join(parts)


def delta_apply(
    prev: bytes, delta: bytes, expect_crc: Optional[int] = None
) -> bytes:
    """Reconstruct the target buffer from ``prev`` and a
    :func:`delta_encode` payload. Strict: raises ``ValueError`` on any
    truncated/corrupt token stream, on tokens running past the buffer, and
    on ``expect_crc`` mismatch (crc32 of the reconstructed buffer — pass
    the wire message's ``crc`` so a bit-flipped literal is caught even
    when the token structure still parses)."""
    out = bytearray(prev)
    n = len(out)
    pos = 0
    cursor = 0
    while pos < len(delta):
        skip, pos = _read_varint(delta, pos)
        lit, pos = _read_varint(delta, pos)
        cursor += skip
        if lit == 0:
            raise ValueError("corrupt delta: empty literal token")
        if cursor + lit > n:
            raise ValueError("corrupt delta: token runs past the state buffer")
        if pos + lit > len(delta):
            raise ValueError("truncated delta: literal bytes missing")
        chunk = np.frombuffer(delta, dtype=np.uint8, count=lit, offset=pos)
        seg = np.frombuffer(out, dtype=np.uint8, count=lit, offset=cursor)
        out[cursor : cursor + lit] = (seg ^ chunk).tobytes()
        cursor += lit
        pos += lit
    result = bytes(out)
    if expect_crc is not None and zlib.crc32(result) & 0xFFFFFFFF != (
        expect_crc & 0xFFFFFFFF
    ):
        raise ValueError("corrupt delta: reconstructed state fails its crc")
    return result
