"""The world checksum, the ring save and the restore guard through one
hand-written CUDA kernel.

Counterpart of ``bevy_ggrs_tpu/ops/checksum.py``. The kernel
(``csrc/checksum.cu``) reads the world's own tensors: a parameter struct
passed by value lists the world's parts in the order the hash mixes them
(rollback id; per sorted component its presence row and its words; the
alive row; the resource leaves), each with its pointer, its bytes a world
row and how its elements become u32 words. Bit views, presence masking,
the resource hash and the lanes' final mask all happen in registers, so a
checksum, a save and a guard are one launch each. Integer operations
only, in the order of :func:`bevy_ggrs_tpu_torch.state.checksum`, so the
kernel agrees with it bitwise, and with the JAX package too.

The layout (every field of the struct but the pointers) is built once per
world structure and cached; a call fills in the ``data_ptr()``s. Three
modes share the kernel and the C entry (:func:`world_checksum`):

- ``checksum``: ``int64[*lead, 2]`` lanes of a world with any leading
  axes (ring rows, ``[S, depth]`` stacks), flattened to the grid's batch
  axis;
- ``save``: also copies every part's bytes into ring row
  ``frame % depth`` and writes ``ring.frames`` and ``ring.checksums`` there;
  a ``[B]`` world saves into a ``[B, depth]`` stack of rings, world ``b``
  into ring ``b``, in the same one launch, each at the host's frame or,
  with ``frames`` (the speculative rollout's and the serving tier's
  slots), at a frame of its own;
- ``guard``: hashes a ring row in place and compares it with the digest
  and frame stored at save time, giving one ``int32`` (1 clean or not
  resident, 0 corrupt).

A CPU world takes the plain version of each mode (the word matrix, the
plain hash and ``tree_map`` copies), which nothing on the card's path uses.

The guard and the ring load are not batched over branches: the fused
tick's absorb (``fused.absorb_branch_frames``) copies a branch's saved
rows into the session's ring together with the digests the batched save
stored, so the guard covers absorbed rows as it covers serial ones.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bevy_ggrs_tpu_torch import state as state_lib
from bevy_ggrs_tpu_torch.ops import _build
from bevy_ggrs_tpu_torch.state import SnapshotRing, WorldState, tree_leaves, tree_map

_M32 = state_lib._M32

MAX_PARTS = 256  # parts the kernel's parameter struct holds at most
MAX_THREADS = 1024  # threads of a block at most (csrc/checksum.cu kMaxThreads)
UNROLL = 4  # slots a thread walks at once (kUnroll)
MAX_CLUSTER = 8  # blocks a world row is spread over at most

# A part's role in the walk (csrc/checksum.cu Role).
WORDS, PRESENCE, COMPONENT, ALIVE, RESOURCE = range(5)
MODES = {"checksum": 0, "save": 1, "guard": 2}


# ---------------------------------------------------------------------------
# Plain versions (the CPU path)
# ---------------------------------------------------------------------------


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
    """Per batch row, the alive-masked wrapping sum of every slot's two
    murmur3 lanes: ``int32[B, W, cap]`` words and ``[B, cap]`` alive flags
    give ``int64[B, 2]`` values in ``[0, 2**32)``."""
    w = state_lib._u32(words)
    B, W, cap = w.shape
    h = torch.empty((B, 2, cap), dtype=torch.int64, device=w.device)
    h[:, 0] = state_lib._SEED
    h[:, 1] = state_lib._SEED ^ state_lib._HI_TWEAK
    for i in range(W):
        h = state_lib._mix_one(h, w[:, i : i + 1, :])
    h = torch.where(alive[:, None, :] != 0, state_lib._fmix(h), 0)
    return h.sum(dim=2) & _M32


def checksum_plain(state: WorldState, resources: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the ``checksum`` mode on any device:
    ``int64[*lead, 2]``, each world row equal to
    :func:`bevy_ggrs_tpu_torch.state.checksum` of that row. With
    ``resources`` off the resources and their constant term are left out
    (the lanes of an entity shard on every rank of its group but one)."""
    lead = tuple(state.alive.shape[:-1])
    B = math.prod(lead)
    alive = state.alive.reshape(B, state.capacity)
    lanes = _entity_hash_sum_plain(_word_matrix(state), alive)
    if not resources:
        return lanes.reshape(lead + (2,))
    res = state_lib._resources_checksum(state.resources, state.device, lead)
    return ((lanes + res.reshape(B, 2)) & _M32).reshape(lead + (2,))


def save_plain(ring: SnapshotRing, state: WorldState, frame: int,
               out: Optional[torch.Tensor] = None, resources: bool = True,
               digest: Optional[Callable[[WorldState], torch.Tensor]] = None) -> torch.Tensor:
    """Plain version of the ``save`` mode: the checksum, a ``copy_`` per
    leaf into ring row ``frame % depth`` (of every ring of a ``[B,
    depth]`` stack, for a ``[B]`` world), the row's frame and digest, and
    ``out`` when given. Returns the lanes as a tensor of their own.
    ``digest`` (default :func:`checksum_plain`) computes the lanes: the
    save of an installed checksum function
    (:func:`bevy_ggrs_tpu_torch.state.set_checksum_impl`)."""
    lead = tuple(state.alive.shape[:-1])
    if lead != tuple(ring.frames.shape[:-1]):
        raise ValueError("save takes a world of the ring's structure, leading axes and device")
    row = (slice(None),) * len(lead) + (int(frame) % ring.depth,)
    cs = checksum_plain(state, resources) if digest is None else digest(state)
    tree_map(lambda r, s: r[row].copy_(s), ring.states, state)
    ring.frames[row] = int(frame)
    ring.checksums[row] = cs
    if out is not None:
        out.copy_(cs)
    return cs


def save_slots_plain(ring: SnapshotRing, state: WorldState, frames: torch.Tensor,
                     keep: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None,
                     digest: Optional[Callable[[WorldState], torch.Tensor]] = None,
                     resources: bool = True) -> torch.Tensor:
    """Plain version of the ``save`` mode over ``[S]`` slots with a frame
    each: what :func:`save_plain` of world ``s`` into ring ``s`` as
    ``frames[s]`` does, for every slot with ``keep[s]`` set (all when
    ``keep`` is None), in batched writes; a slot whose keep is off writes
    nothing and gets lanes 0. Returns ``int64[S, 2]``, also written to
    ``out`` when given. ``digest`` and ``resources`` as in
    :func:`save_plain`."""
    S = int(frames.shape[0])
    if tuple(state.alive.shape[:-1]) != (S,) or tuple(ring.frames.shape[:-1]) != (S,):
        raise ValueError("a slot save takes an [S] world, [S, depth] rings and int32[S] frames")
    # Row s: the checksum of world s alone.
    lanes = checksum_plain(state, resources) if digest is None else digest(state)
    slots = torch.arange(S, device=state.device)
    if keep is not None:
        slots = slots[keep]
        lanes = torch.where(keep[:, None], lanes, 0)
    rows = torch.remainder(frames.to(torch.int64)[slots], ring.depth)

    def put(r, x):
        state_lib.signed_view(r)[slots, rows] = state_lib.signed_view(x)[slots]

    tree_map(put, ring.states, state)
    ring.frames[slots, rows] = frames[slots]
    ring.checksums[slots, rows] = lanes[slots]
    if out is not None:
        out.copy_(lanes)
    return lanes


def guard_plain(ring: SnapshotRing, frame: int,
                digest: Optional[Callable[[WorldState], torch.Tensor]] = None) -> torch.Tensor:
    """Plain version of the ``guard`` mode: ``int32[1]``, 1 when ring row
    ``frame % depth`` does not hold ``frame`` or still hashes to its
    save-time digest, 0 when it is corrupt. ``digest`` as in
    :func:`save_plain`."""
    row = int(frame) % ring.depth
    ok = int(ring.frames[row]) != int(frame) or torch.equal(
        (digest or checksum_plain)(tree_map(lambda x: x[row], ring.states)),
        ring.checksums[row])
    return torch.tensor([int(ok)], dtype=torch.int32, device=ring.frames.device)


# ---------------------------------------------------------------------------
# The layout: the parameter struct without its pointers
# ---------------------------------------------------------------------------


class _Part(ctypes.Structure):
    """One part of the world (csrc/checksum.cu ``Part``)."""

    _fields_ = [
        ("src", ctypes.c_void_p),  # the first world row's first byte
        ("dst", ctypes.c_void_p),  # save: the ring row's first byte
        ("row_bytes", ctypes.c_longlong),  # bytes of one world row
        ("words", ctypes.c_int),  # u32 words a slot (a row for a resource)
        ("word_bytes", ctypes.c_int),  # 1, 2 or 4: bytes read for a word
        ("role", ctypes.c_int),
        ("is_bool", ctypes.c_int),
        ("seed_lo", ctypes.c_uint32),  # resource: lane seeds xor name seed
        ("seed_hi", ctypes.c_uint32),
        ("base", ctypes.c_int),  # resource: position of its first word
        ("first", ctypes.c_int),  # resource: index among all resource words
    ]


class _Header(ctypes.Structure):
    """Everything but the parts (csrc/checksum.cu ``Header``)."""

    _fields_ = [
        ("lanes", ctypes.c_void_p),  # checksum and save: int64[B, 2]
        ("lanes_ring", ctypes.c_void_p),  # save: ring 0's checksums[slot]
        ("lanes_out", ctypes.c_void_p),  # save: the caller's out, or null
        ("frame_out", ctypes.c_void_p),  # save: ring 0's frames[slot]
        ("expect", ctypes.c_void_p),  # guard: ring.checksums[row]
        ("frames_row", ctypes.c_void_p),  # guard: ring.frames[row]
        ("flag", ctypes.c_void_p),  # guard: int32[1]
        ("n_parts", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("frame", ctypes.c_int),
        ("resource_words", ctypes.c_int),
        ("alive_part", ctypes.c_int),
        ("first_resource", ctypes.c_int),
        ("const_lo", ctypes.c_uint32),
        ("const_hi", ctypes.c_uint32),
        # save: steps from ring 0's row to ring b's in a [B, depth] stack
        ("dst_rows", ctypes.c_longlong),
        ("lanes_ring_stride", ctypes.c_longlong),
        ("frame_stride", ctypes.c_longlong),
        ("lanes_out_stride", ctypes.c_longlong),
        # save over [S] slots: int32[S] frames and bool[S] keep, on the card
        ("world_frames", ctypes.c_void_p),
        ("keep", ctypes.c_void_p),
        ("depth", ctypes.c_int),
    ]


@dataclasses.dataclass(frozen=True)
class PartSpec:
    """A part as the kernel reads it."""

    name: str  # "rollback_id", "present/<c>", "component/<c>", "alive", "resource/<r>/<j>"
    role: int
    words: int  # u32 words a slot; a world row for a resource leaf
    word_bytes: int  # 1, 2 or 4
    is_bool: bool
    row_bytes: int
    seeds: Tuple[int, int] = (0, 0)
    base: int = 0
    first: int = 0


@dataclasses.dataclass(frozen=True)
class Layout:
    """A world structure's parts, resource constants and launch shape,
    with the kernel's part array and header prefilled but for pointers."""

    parts: Tuple[PartSpec, ...]
    keep: Tuple[int, ...]  # the entries (see _entries) that are parts
    capacity: int
    lead: Tuple[int, ...]
    constants: Tuple[Tuple[str, int, int], ...]  # per resource: its fmix'd seeds
    const: Tuple[int, int]  # their wrapping sum
    resource_words: int
    cluster: int
    threads: int
    parts_bytes: bytes
    header_bytes: bytes
    part_array: type


def _entries(state: WorldState):
    """``(name, role, tensor)`` of every tensor in mixing order."""
    out = [("rollback_id", WORDS, state.rollback_id)]
    for name in sorted(state.components):
        out.append((f"present/{name}", PRESENCE, state.present[name]))
        out.append((f"component/{name}", COMPONENT, state.components[name]))
    out.append(("alive", ALIVE, state.alive))
    for name in sorted(state.resources):
        for j, leaf in enumerate(tree_leaves(state.resources[name])):
            out.append((f"resource/{name}/{j}", RESOURCE, leaf))
    return out


def _key(state: WorldState, entries) -> tuple:
    return (tuple((n, t.dtype, t.shape, t.device) for n, _, t in entries),
            tuple(sorted(state.resources)))


def launch_shape(capacity: int) -> Tuple[int, int]:
    """``(P, threads)``: a world row runs on a cluster of ``P`` blocks of
    ``threads``. The walk is bound by each SM's issue rate, so a row is
    spread over more SMs first: P doubles, up to 8, while a block would
    take more than 128 slots; then each block gets a thread a slot (a
    whole number of warps) up to 1,024 threads, beyond which a thread
    walks up to ``UNROLL`` slots at once."""
    P = 1
    while P < MAX_CLUSTER and P * 128 < capacity:
        P *= 2
    per_block = -(-capacity // P)
    return P, min(MAX_THREADS, -(-per_block // 32) * 32)


def block_slots(capacity: int, P: int, rank: int) -> range:
    """The contiguous slots block ``rank`` of a row's cluster walks."""
    return range(rank * capacity // P, (rank + 1) * capacity // P)


def thread_slots(capacity: int, P: int, threads: int, rank: int, tid: int):
    """The slots thread ``tid`` of block ``rank`` hashes, in the kernel's
    order: chunks of ``threads * UNROLL`` slots, ``UNROLL`` at once."""
    block = block_slots(capacity, P, rank)
    for c in range(block.start, block.stop, threads * UNROLL):
        for j in range(UNROLL):
            s = c + j * threads + tid
            if s < block.stop:
                yield s


def _build_layout(state: WorldState, entries) -> Layout:
    alive = state.alive
    lead = tuple(alive.shape[:-1])
    nlead = len(lead)
    cap = alive.shape[-1]
    if not 0 < cap < 1 << 30:
        raise ValueError(f"unsupported capacity {cap}")
    parts, keep = [], []
    resource_words = 0
    base: Dict[str, int] = {}
    for i, (name, role, t) in enumerate(entries):
        size = t.element_size()
        if size not in (1, 2, 4, 8):
            raise ValueError(f"{name}: {t.dtype} has no u32 word form")
        if role in (PRESENCE, ALIVE) and t.dtype != torch.bool:
            raise ValueError(f"{name} must be bool, got {t.dtype}")
        if role == RESOURCE:
            if tuple(t.shape[:nlead]) != lead:
                raise ValueError(f"{name}: shape {list(t.shape)} does not lead with {list(lead)}")
            elems = math.prod(t.shape[nlead:])
        else:
            if tuple(t.shape[: nlead + 1]) != lead + (cap,):
                raise ValueError(f"{name}: shape {list(t.shape)} does not lead with "
                                 f"{list(lead + (cap,))}")
            elems = math.prod(t.shape[nlead + 1:])
        words = elems * (size // 4 if size > 4 else 1)
        row_bytes = elems * size * (1 if role == RESOURCE else cap)
        if words == 0:
            continue
        spec = dict(name=name, role=role, words=words, word_bytes=min(size, 4),
                    is_bool=t.dtype == torch.bool, row_bytes=row_bytes)
        if role == RESOURCE:
            resource = name.split("/")[1]
            ns = state_lib._name_seed(resource)
            spec.update(seeds=(state_lib._SEED ^ ns, state_lib._SEED ^ state_lib._HI_TWEAK ^ ns),
                        base=base.get(resource, 0), first=resource_words)
            base[resource] = spec["base"] + words
            resource_words += words
        parts.append(PartSpec(**spec))
        keep.append(i)
    if len(parts) > MAX_PARTS:
        raise ValueError(f"the world has {len(parts)} checksum parts, over the "
                         f"kernel's limit of {MAX_PARTS}")
    constants = []
    for name in sorted(state.resources):
        ns = state_lib._name_seed(name)
        constants.append((name, state_lib._fmix(state_lib._SEED ^ ns),
                          state_lib._fmix(state_lib._SEED ^ state_lib._HI_TWEAK ^ ns)))
    const = (sum(c[1] for c in constants) & _M32, sum(c[2] for c in constants) & _M32)
    P, threads = launch_shape(cap)
    array_type = _Part * len(parts)
    array = array_type()
    for a, p in zip(array, parts):
        a.row_bytes, a.words, a.word_bytes = p.row_bytes, p.words, p.word_bytes
        a.role, a.is_bool = p.role, int(p.is_bool)
        a.seed_lo, a.seed_hi = p.seeds
        a.base, a.first = p.base, p.first
    roles = [p.role for p in parts]
    header = _Header(n_parts=len(parts), cap=cap, resource_words=resource_words,
                     alive_part=roles.index(ALIVE),
                     first_resource=roles.index(RESOURCE) if RESOURCE in roles else len(parts),
                     const_lo=const[0], const_hi=const[1])
    return Layout(tuple(parts), tuple(keep), cap, lead, tuple(constants), const,
                  resource_words, P, threads, bytes(array), bytes(header), array_type)


_layouts: Dict[tuple, Layout] = {}


def _prepared(state: WorldState) -> Tuple[Layout, List[torch.Tensor]]:
    """``state``'s cached layout and its tensors in part order."""
    entries = _entries(state)
    key = _key(state, entries)
    found = _layouts.get(key)
    if found is None:
        from bevy_ggrs_tpu_torch.utils import build_cache

        with build_cache.timed("layout"):
            found = _layouts[key] = _build_layout(state, entries)
    return found, [entries[i][2] for i in found.keep]


def layout(state: WorldState) -> Layout:
    """The cached layout of ``state``'s structure (names, dtypes, shapes,
    resource trees, capacity, leading shape and device); raises for a
    world the kernel cannot take, such as one over :data:`MAX_PARTS`."""
    return _prepared(state)[0]


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _slot_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are contiguous in slot-major order, else
    a contiguous copy (counted in ``world_checksum.copies``)."""
    if t.is_contiguous():
        return t
    world_checksum.copies += 1
    return t.contiguous()


_ring_pairs = set()  # (id(state layout), id(ring layout)) found to match


def _ring_prepared(ring: SnapshotRing) -> Tuple[Layout, List[torch.Tensor]]:
    """The layout and tensors of a ring (``frames`` ``int32[depth]``) or
    of a ``[B, depth]`` stack of rings, with its frames and digests
    checked."""
    if ring.frames.dim() not in (1, 2) or ring.frames.dtype != torch.int32:
        raise ValueError(f"ring.frames must be int32[depth] or int32[B, depth], got "
                         f"{ring.frames.dtype}{list(ring.frames.shape)}")
    lead = tuple(ring.frames.shape)
    if ring.checksums.dtype != torch.int64 or tuple(ring.checksums.shape) != lead + (2,):
        raise ValueError(f"ring.checksums must be int64{list(lead + (2,))}")
    if not (ring.frames.is_contiguous() and ring.checksums.is_contiguous()):
        raise ValueError("ring.frames and ring.checksums must be contiguous")
    lay, rows = _prepared(ring.states)
    if lay.lead != lead:
        raise ValueError(f"ring rows lead with {list(lay.lead)}, not {list(lead)}")
    if not all(r.is_contiguous() for r in rows):
        raise ValueError("the ring's tensors must be contiguous")
    return lay, rows


def _drop_resources(header: _Header) -> None:
    """The launch's resource role off: no resource word is hashed and no
    constant term added (the parts stay, so a save still copies them)."""
    header.resource_words = 0
    header.const_lo = header.const_hi = 0


def _launch(lay: Layout, parts, header, B: int, device: torch.device) -> None:
    if not 0 < B * lay.cluster < 1 << 31:
        raise ValueError(f"unsupported batch of {B} world rows")
    fn = _build.function("checksum", "ggrs_world_checksum", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.addressof(header), ctypes.addressof(parts), B, lay.cluster,
                 lay.threads, stream)
    _build.check(err, "world_checksum")
    world_checksum.launches += 1


def world_checksum(state: Optional[WorldState], mode: str = "checksum", *,
                   ring: Optional[SnapshotRing] = None, frame: int = 0,
                   out: Optional[torch.Tensor] = None,
                   frames: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None,
                   resources: bool = True) -> torch.Tensor:
    """One launch of the checksum kernel in ``mode``:

    - ``"checksum"``: ``int64[*lead, 2]`` lanes of ``state``;
    - ``"save"``: ``state`` saved as ``frame`` into ring row ``frame %
      depth`` (bytes, frame, digest) and its lanes, also written to ``out``
      when given; returns the lanes as a tensor of their own. A single
      world takes a ring and gives ``int64[2]``; a ``[B]`` world takes a
      ``[B, depth]`` stack, saves world ``b`` into ring ``b`` and gives
      ``int64[B, 2]`` (``out`` may then be a view whose rows are strided,
      such as ``checksums[:, t]`` of a ``[B, F, 2]`` tensor);
      With ``frames`` (``int32[S]``, on the world's device) the ``[S]``
      world's slots save at frames of their own: world ``s`` into row
      ``frames[s] mod depth`` (floor mod) of ring ``s``, the row computed
      in the kernel; ``keep`` (``bool[S]``, or None for every slot) skips
      a slot whole: no copy, no frame, no digest, lanes 0 (the JAX
      package's ``_masked_ring_save``). One launch for all S slots;
    - ``"guard"``: ``int32[1]``, 1 when ring row ``frame % depth`` does not
      hold ``frame`` or hashes to its stored digest, 0 when corrupt
      (``state`` is None; a single ring only).

    A CPU world takes the plain version of the mode; a CUDA world launches
    the kernel (``csrc/checksum.cu``) on the current stream; any other
    device, or a world the kernel cannot take, raises.

    ``resources=False`` leaves the resource words and their constant term
    out of the lanes (the launch's resource word count and constants are
    0; the save still copies the resources): an entity shard's lanes
    carry the replicated resources on one rank only
    (:meth:`bevy_ggrs_tpu_torch.parallel.sharding.EntityShard.checksum`)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    wants = {"checksum": (True, False), "save": (True, True), "guard": (False, True)}[mode]
    if (state is not None, ring is not None) != wants:
        raise ValueError(f"mode {mode!r} takes {'a state' * wants[0]}"
                         f"{' and ' * all(wants)}{'a ring' * wants[1]}")
    if mode == "guard" and ring.frames.dim() != 1:
        raise ValueError("the guard takes a single ring, not a stack of rings")
    if (frames is not None or keep is not None) and mode != "save":
        raise ValueError("frames and keep belong to the save mode")
    if keep is not None and frames is None:
        raise ValueError("a keep-mask needs per-slot frames")
    device = (state if state is not None else ring.states).alive.device
    if frames is not None:
        S = tuple(state.alive.shape[:-1])
        if len(S) != 1 or frames.dtype != torch.int32 or tuple(frames.shape) != S \
                or frames.device != device:
            raise ValueError(f"frames must be int32{list(S)} on {device} for an [S] world")
        if keep is not None and (keep.dtype != torch.bool or tuple(keep.shape) != S
                                 or keep.device != device):
            raise ValueError(f"keep must be bool{list(S)} on {device}")
    if device.type == "cpu":
        if frames is not None:
            return save_slots_plain(ring, state, frames, keep, out, resources=resources)
        if mode == "checksum":
            return checksum_plain(state, resources)
        if mode == "save":
            return save_plain(ring, state, frame, out, resources)
        return guard_plain(ring, frame)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not -(1 << 31) <= int(frame) < 1 << 31:
        raise ValueError(f"frame {frame} does not fit the ring's int32 frames")
    if mode == "checksum":
        lay, tensors = _prepared(state)
        tensors = [_slot_major(t) for t in tensors]  # held until the launch
        B = math.prod(lay.lead)
        lanes = torch.empty(lay.lead + (2,), dtype=torch.int64, device=device)
        if B == 0:
            return lanes
        parts = lay.part_array.from_buffer_copy(lay.parts_bytes)
        for p, t in zip(parts, tensors):
            p.src = t.data_ptr()
        header = _Header.from_buffer_copy(lay.header_bytes)
        header.lanes = lanes.data_ptr()
        if not resources:
            _drop_resources(header)
        _launch(lay, parts, header, B, device)
        return lanes
    lay, rows = _ring_prepared(ring)
    branches = lay.lead[:-1]  # () for a single ring, (B,) for a stack
    row = int(frame) % ring.depth
    parts = lay.part_array.from_buffer_copy(lay.parts_bytes)
    header = _Header.from_buffer_copy(lay.header_bytes)
    header.mode = MODES[mode]
    header.frame = int(frame)
    if not resources:
        _drop_resources(header)
    if mode == "save":
        slay, tensors = _prepared(state)
        if (id(slay), id(lay)) not in _ring_pairs:
            if slay.lead != branches or slay.parts != lay.parts or state.device != device:
                raise ValueError("save takes a world of the ring's structure, leading "
                                 "axes and device")
            _ring_pairs.add((id(slay), id(lay)))
        tensors = [_slot_major(t) for t in tensors]  # held until the launch
        if frames is not None:
            # The kernel finds each slot's row from its frame.
            row = 0
            frames_c, keep_c = _slot_major(frames), None
            header.world_frames = frames_c.data_ptr()
            if keep is not None:
                keep_c = _slot_major(keep)
                header.keep = keep_c.data_ptr()
            header.depth = ring.depth
        for p, t, r, spec in zip(parts, tensors, rows, lay.parts):
            p.src = t.data_ptr()
            p.dst = r.data_ptr() + row * spec.row_bytes
        lanes = torch.empty(branches + (2,), dtype=torch.int64, device=device)
        header.lanes = lanes.data_ptr()
        header.lanes_ring = ring.checksums.data_ptr() + row * 16
        header.frame_out = ring.frames.data_ptr() + row * 4
        header.dst_rows = header.frame_stride = ring.depth
        header.lanes_ring_stride = 2 * ring.depth
        if out is not None:
            if out.dtype != torch.int64 or tuple(out.shape) != branches + (2,) \
                    or out.stride(-1) != 1 or out.device != device:
                raise ValueError(f"out must be int64{list(branches + (2,))} on {device} "
                                 "with contiguous lanes")
            header.lanes_out = out.data_ptr()
            header.lanes_out_stride = out.stride(0) if branches else 0
        _launch(lay, parts, header, math.prod(branches), device)
        return lanes
    for p, r, spec in zip(parts, rows, lay.parts):
        p.src = r.data_ptr() + row * spec.row_bytes
    flag = torch.empty((1,), dtype=torch.int32, device=device)
    header.expect = ring.checksums.data_ptr() + row * 16
    header.frames_row = ring.frames.data_ptr() + row * 4
    header.flag = flag.data_ptr()
    _launch(lay, parts, header, 1, device)
    return flag


world_checksum.launches = 0
world_checksum.copies = 0


def checksum(state: WorldState) -> torch.Tensor:
    """The world checksum as ``int64[*lead, 2]`` lanes, bitwise equal to
    :func:`bevy_ggrs_tpu_torch.state.checksum` for a single world (``lead``
    empty) and computed row by row for a stacked one: one launch."""
    return world_checksum(state, "checksum")
