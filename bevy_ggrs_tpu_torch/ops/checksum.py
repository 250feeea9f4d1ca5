"""The world checksum through the hand-written CUDA kernel.

Counterpart of ``bevy_ggrs_tpu/ops/checksum.py``. PyTorch assembles the
``[B, W, capacity]`` word matrix (bit views and presence masking), the
kernel (``csrc/checksum.cu``) runs every slot's W-word hash chain in
registers and wrapping-sums the live slots into ``[B, 2]`` lanes, and the
plain resource hash is added outside. Integer operations only, in the
same order as :func:`bevy_ggrs_tpu_torch.state.checksum`, so the two agree
bitwise, and with the JAX package too.

The leading batch axis ``B`` carries ring rows: a ring's digests are one
launch (see :mod:`bevy_ggrs_tpu_torch.integrity`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from bevy_ggrs_tpu_torch import state as state_lib
from bevy_ggrs_tpu_torch.ops import _build
from bevy_ggrs_tpu_torch.state import WorldState

_M32 = state_lib._M32


def _word_matrix(state: WorldState) -> torch.Tensor:
    """``int32[B, W, capacity]``: the u32 word rows in the order
    :func:`~bevy_ggrs_tpu_torch.state.checksum` mixes them (rollback id,
    then per sorted component its presence bit and its presence-masked
    words), for a world with any leading axes, flattened to ``B``."""
    cap = state.capacity
    nlead = state.alive.dim()  # leading axes and the entity axis
    B = math.prod(state.alive.shape[:-1])

    def rows(arr):
        words = state_lib._to_u32_words(arr, nlead)
        return words.reshape(B, cap, words.shape[-1]).transpose(1, 2)

    out = [rows(state.rollback_id)]
    for name in sorted(state.components):
        pres = state.present[name].reshape(B, 1, cap)
        out.append(pres.to(torch.int32))
        out.append(torch.where(pres, rows(state.components[name]), 0))
    return torch.cat(out, dim=1).contiguous()


def _entity_hash_sum_plain(words: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ``int32[B, 2]``."""
    w = state_lib._u32(words)
    B, W, cap = w.shape
    h = torch.empty((B, 2, cap), dtype=torch.int64, device=w.device)
    h[:, 0] = state_lib._SEED
    h[:, 1] = state_lib._SEED ^ state_lib._HI_TWEAK
    for i in range(W):
        h = state_lib._mix_one(h, w[:, i : i + 1, :])
    h = torch.where(alive[:, None, :] != 0, state_lib._fmix(h), 0)
    lanes = h.sum(dim=2) & _M32
    return torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def entity_hash_sum(words: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Per batch row, the alive-masked wrapping sum of every slot's two
    murmur3 lanes: ``int32[B, W, cap]`` words and ``uint8[B, cap]`` alive
    flags give ``int32[B, 2]`` (u32 bit patterns of the lo/hi lanes).

    Counterpart of ``bevy_ggrs_tpu.ops.checksum._entity_hash_sum``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (``csrc/checksum.cu``) on the current stream, and anything it cannot
    take raises."""
    if words.dim() != 3 or words.dtype != torch.int32:
        raise ValueError(f"words must be int32[B, W, cap], got "
                         f"{words.dtype}{list(words.shape)}")
    B, W, cap = words.shape
    if alive.dtype != torch.uint8 or tuple(alive.shape) != (B, cap):
        raise ValueError(f"alive must be uint8[{B}, {cap}], got "
                         f"{alive.dtype}{list(alive.shape)}")
    if words.device != alive.device:
        raise ValueError("words and alive lie on different devices")
    if words.device.type == "cpu":
        return _entity_hash_sum_plain(words, alive)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if not (words.is_contiguous() and alive.is_contiguous()):
        raise ValueError("words and alive must be contiguous")
    if not (0 < B < 65536 and 0 < W and 0 < cap):
        raise ValueError(f"unsupported shape B={B} W={W} cap={cap}")
    out = torch.zeros((B, 2), dtype=torch.int32, device=words.device)
    fn = _build.function("checksum", "ggrs_entity_hash_sum", _ARGTYPES)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(words.data_ptr(), alive.data_ptr(), out.data_ptr(),
                 B, W, cap, stream)
    _build.check(err, "entity_hash_sum")
    entity_hash_sum.launches += 1
    return out


entity_hash_sum.launches = 0


def checksum(state: WorldState) -> torch.Tensor:
    """The world checksum as ``int64[*lead, 2]`` lanes through the kernel,
    bitwise equal to :func:`bevy_ggrs_tpu_torch.state.checksum` for a single
    world (``lead`` empty) and computed row by row for a stacked one."""
    lead = tuple(state.alive.shape[:-1])
    B = math.prod(lead)
    alive = state.alive.reshape(B, state.capacity).contiguous().view(torch.uint8)
    lanes = entity_hash_sum(_word_matrix(state), alive).to(torch.int64) & _M32
    res = state_lib._resources_checksum(state.resources, state.device, lead)
    return ((lanes + res.reshape(B, 2)) & _M32).reshape(lead + (2,))
