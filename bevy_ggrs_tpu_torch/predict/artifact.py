"""Versioned, content-hashed predictor weight artifacts.

Counterpart of ``bevy_ggrs_tpu/predict/artifact.py``, copied: the same
bytes, the same hash. ``default_weights.ggrspred`` beside this file is a
byte-for-byte copy of the JAX package's committed artifact, so a port
peer and a JAX peer with the default predictor advertise the same
handshake digest.

The weights are **session config**: two peers whose predictor artifacts
differ build different branch trees, and while that alone cannot desync
a session (speculation never touches the wire), it silently destroys the
shared-fate economics the fleet tier budgets around. So the artifact is
treated exactly like the protocol version — a canonical byte string
whose 64-bit content hash is folded into the sync handshake, where a
mismatch is a typed refusal (``EventKind.CONFIG_MISMATCH``), never a
desync.

Canonicality rules:

- fixed little-endian header (magic, format version, weight version,
  geometry) followed by the raw weight bytes in a fixed order
  (``w1, b1, w2, b2``), each C-contiguous little-endian;
- **no container metadata** — deliberately not ``.npz``, whose zip
  timestamps would make byte-identical weights hash differently across
  saves;
- ``content_hash`` = first 8 bytes (big-endian) of SHA-256 over the
  whole canonical byte string, so it is stable across process restarts
  and platforms.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

MAGIC = b"GGRSPRED"

#: Byte-layout version. Bump when the header or array order changes;
#: readers refuse unknown versions instead of guessing.
FORMAT_VERSION = 1

#: magic, format_version, weight_version, window, value_slots,
#: phase_mod, hidden, shift
_HEADER = struct.Struct("<8sIIIIIII")

#: The committed default artifact (the JAX package's trainer,
#: ``bevy_ggrs_tpu/predict/train.py``, regenerates it deterministically).
DEFAULT_ARTIFACT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "default_weights.ggrspred"
)


@dataclass(frozen=True)
class PredictorWeights:
    """Quantized two-layer MLP over a window of recent input values.

    Geometry: input = ``window`` one-hot blocks of ``value_slots`` (one
    per recent frame, oldest first; missing/out-of-universe frames are
    the all-zero block) + a ``phase_mod`` one-hot of the target frame's
    phase. Hidden activation is the integer clipped ReLU
    ``min(max(acc, 0) >> shift, 127)``; logits are raw int32.
    """

    weight_version: int
    window: int
    value_slots: int
    phase_mod: int
    hidden: int
    shift: int
    w1: np.ndarray  # int8 [in_dim, hidden]
    b1: np.ndarray  # int32 [hidden]
    w2: np.ndarray  # int8 [hidden, value_slots]
    b2: np.ndarray  # int32 [value_slots]

    @property
    def in_dim(self) -> int:
        return self.window * self.value_slots + self.phase_mod

    def _check(self) -> None:
        if self.w1.dtype != np.int8 or self.w1.shape != (
            self.in_dim, self.hidden,
        ):
            raise ValueError(f"bad w1 {self.w1.dtype} {self.w1.shape}")
        if self.b1.dtype != np.int32 or self.b1.shape != (self.hidden,):
            raise ValueError(f"bad b1 {self.b1.dtype} {self.b1.shape}")
        if self.w2.dtype != np.int8 or self.w2.shape != (
            self.hidden, self.value_slots,
        ):
            raise ValueError(f"bad w2 {self.w2.dtype} {self.w2.shape}")
        if self.b2.dtype != np.int32 or self.b2.shape != (
            self.value_slots,
        ):
            raise ValueError(f"bad b2 {self.b2.dtype} {self.b2.shape}")

    def to_bytes(self) -> bytes:
        """The canonical byte string. Same weights -> same bytes, on any
        platform, forever (within a format version)."""
        self._check()
        parts = [_HEADER.pack(
            MAGIC, FORMAT_VERSION, self.weight_version, self.window,
            self.value_slots, self.phase_mod, self.hidden, self.shift,
        )]
        for arr in (self.w1, self.b1, self.w2, self.b2):
            # '<' forces little-endian on big-endian hosts; C order.
            parts.append(np.ascontiguousarray(
                arr, dtype=arr.dtype.newbyteorder("<")
            ).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PredictorWeights":
        if len(data) < _HEADER.size:
            raise ValueError("predictor artifact truncated")
        (magic, fmt, wver, window, slots, phase_mod, hidden,
         shift) = _HEADER.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError("not a GGRSPRED artifact")
        if fmt != FORMAT_VERSION:
            raise ValueError(
                f"unsupported predictor format {fmt} "
                f"(reader speaks {FORMAT_VERSION})"
            )
        in_dim = window * slots + phase_mod
        off = _HEADER.size
        out = []
        for shape, dt in (
            ((in_dim, hidden), np.int8), ((hidden,), np.int32),
            ((hidden, slots), np.int8), ((slots,), np.int32),
        ):
            n = int(np.prod(shape)) * np.dtype(dt).itemsize
            if off + n > len(data):
                raise ValueError("predictor artifact truncated")
            arr = np.frombuffer(
                data, dtype=np.dtype(dt).newbyteorder("<"),
                count=int(np.prod(shape)), offset=off,
            ).astype(dt).reshape(shape)
            out.append(arr)
            off += n
        if off != len(data):
            raise ValueError("predictor artifact has trailing bytes")
        w = cls(wver, window, slots, phase_mod, hidden, shift, *out)
        w._check()
        return w

    @property
    def content_hash(self) -> int:
        """u64: first 8 bytes (big-endian) of SHA-256 over the canonical
        bytes. This is the value carried in the wire handshake."""
        return int.from_bytes(
            hashlib.sha256(self.to_bytes()).digest()[:8], "big"
        )


def save_artifact(weights: PredictorWeights, path: str) -> int:
    data = weights.to_bytes()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return weights.content_hash


def load_artifact(path: str) -> PredictorWeights:
    with open(path, "rb") as f:
        return PredictorWeights.from_bytes(f.read())


_DEFAULT_CACHE: Optional[PredictorWeights] = None


def load_default() -> PredictorWeights:
    """The committed default artifact (process-cached; the artifact is
    immutable within a checkout)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = load_artifact(DEFAULT_ARTIFACT)
    return _DEFAULT_CACHE
