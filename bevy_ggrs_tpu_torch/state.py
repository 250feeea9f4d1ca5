"""Rollback world state as device-resident SoA tensors (PyTorch).

The PyTorch counterpart of ``bevy_ggrs_tpu/state.py``. The registered slice
of the world is a structure of arrays kept on one device:

- ``components[name]``: ``[capacity, *shape]`` tensor per registered type
- ``present[name]``:    ``bool[capacity]`` — does this entity have it?
- ``alive``:            ``bool[capacity]`` — entity exists
- ``rollback_id``:      ``int32[capacity]`` — identity that survives
  despawn/respawn across rollbacks
- ``resources[name]``:  a tree (dicts, lists, tuples) of tensors

"Save" writes one row of a stacked ring (:class:`SnapshotRing`), "load"
copies one row out, and the checksum is the same two-lane murmur3 wrapping
sum as the JAX package's, bit for bit.

torch's ``uint32`` stores, copies and views, and has ``*``, ``^`` and
``sum``, but no ``+``, shifts, comparisons or ``where`` on the CPU; so the
checksum carries each 32-bit lane in ``int64`` masked to 32 bits, and a
``uint32`` leaf (``frame_count``) is updated through an ``int32`` view of
the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Host allocators own ``0 .. DEVICE_ID_BASE-1``; device-resident allocators
# mint upward from ``DEVICE_ID_BASE``, so the two can never collide.
DEVICE_ID_BASE = 1 << 20


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a GPU and without an explicit device this raises; the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype holding the same values as torch ``dtype``."""
    return torch.empty((), dtype=dtype).numpy().dtype


# JAX runs with 64-bit types disabled, so a Python or numpy 64-bit value
# becomes its 32-bit counterpart there; resources follow the same rule so
# the two packages hash the same words.
_CANONICAL = {
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.float64): np.float32,
}


def _canonical_array(value) -> np.ndarray:
    a = np.array(value)
    return a.astype(_CANONICAL.get(a.dtype, a.dtype))


# ---------------------------------------------------------------------------
# Trees of tensors (resources, and WorldState as a whole)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of identical structure. Dicts map
    by key, lists and tuples by position; ``None`` is an empty tree;
    anything else is a leaf."""
    if isinstance(tree, WorldState):
        return WorldState(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(WorldState)
        })
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in JAX's flattening order: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


# ---------------------------------------------------------------------------
# Type registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComponentDef:
    """A registered rollback component type."""

    name: str
    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    default: Any = 0


@dataclasses.dataclass(frozen=True)
class ResourceDef:
    """A registered rollback resource; ``initial`` is a tree of numpy
    values or scalars whose structure is the schema."""

    name: str
    initial: Any = None

    def prototype(self) -> Any:
        # Copying: the caller may still own the arrays in ``initial``.
        return tree_map(_canonical_array, self.initial)


class TypeRegistry:
    """The component and resource types that make up rollback state."""

    def __init__(self) -> None:
        self.components: Dict[str, ComponentDef] = {}
        self.resources: Dict[str, ResourceDef] = {}

    def register_component(
        self,
        name: str,
        shape: Tuple[int, ...] = (),
        dtype: torch.dtype = torch.float32,
        default: Any = 0,
    ) -> "TypeRegistry":
        if name in self.components:
            raise ValueError(f"component {name!r} registered twice")
        self.components[name] = ComponentDef(name, tuple(shape), dtype, default)
        return self

    def register_resource(self, name: str, initial: Any) -> "TypeRegistry":
        if name in self.resources:
            raise ValueError(f"resource {name!r} registered twice")
        self.resources[name] = ResourceDef(name, initial)
        return self


# ---------------------------------------------------------------------------
# World state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorldState:
    """The registered slice of the world. Every tensor but the resources
    has the entity axis last among its leading axes (``[capacity, ...]``
    for a world, ``[depth, capacity, ...]`` inside a ring). A free slot has
    ``alive=False`` and ``rollback_id=-1``."""

    alive: torch.Tensor
    rollback_id: torch.Tensor
    components: Dict[str, torch.Tensor]
    present: Dict[str, torch.Tensor]
    resources: Dict[str, Any]

    @property
    def capacity(self) -> int:
        return self.alive.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.alive.device

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)


def init_state(registry: TypeRegistry, capacity: int, device=None) -> WorldState:
    """An empty world with ``capacity`` entity slots."""
    device = resolve_device(device)
    return WorldState(
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        rollback_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        components={
            n: torch.full((capacity,) + d.shape, d.default, dtype=d.dtype,
                          device=device)
            for n, d in registry.components.items()
        },
        present={
            n: torch.zeros((capacity,), dtype=torch.bool, device=device)
            for n in registry.components
        },
        resources={
            n: tree_map(lambda a: torch.tensor(a, device=device), d.prototype())
            for n, d in registry.resources.items()
        },
    )


class HostWorld:
    """Mutable host-side staging area for building the initial world; call
    :meth:`commit` to get the device-resident :class:`WorldState`.
    ``device`` is where :meth:`commit` puts it unless told otherwise."""

    def __init__(self, registry: TypeRegistry, capacity: int, device=None):
        self.registry = registry
        self.capacity = capacity
        self.device = device
        self._alive = np.zeros((capacity,), dtype=bool)
        self._rollback_id = np.full((capacity,), -1, dtype=np.int32)
        self._components = {
            n: np.full((capacity,) + d.shape, d.default, dtype=np_dtype(d.dtype))
            for n, d in registry.components.items()
        }
        self._present = {n: np.zeros((capacity,), dtype=bool) for n in registry.components}
        self._resources = {n: d.prototype() for n, d in registry.resources.items()}

    def spawn(self, components: Dict[str, Any], rollback_id: int) -> int:
        """Spawn an entity with the given components; returns its slot.
        ``rollback_id`` must be unique among live entities."""
        if rollback_id in self._rollback_id[self._alive]:
            raise ValueError(f"duplicate rollback_id {rollback_id}")
        for name in components:
            if name not in self._components:
                raise KeyError(f"component {name!r} not registered")
        free = np.flatnonzero(~self._alive)
        if free.size == 0:
            raise RuntimeError(f"world capacity {self.capacity} exhausted")
        slot = int(free[0])
        self._alive[slot] = True
        self._rollback_id[slot] = rollback_id
        for name, value in components.items():
            self._components[name][slot] = np.asarray(
                value, dtype=self._components[name].dtype
            )
            self._present[name][slot] = True
        return slot

    def despawn(self, slot: int) -> None:
        self._alive[slot] = False
        self._rollback_id[slot] = -1
        for name in self._present:
            self._present[name][slot] = False

    def set_resource(self, name: str, value: Any) -> None:
        if name not in self._resources:
            raise KeyError(f"resource {name!r} not registered")
        self._resources[name] = tree_map(
            lambda p, v: np.array(v, dtype=p.dtype), self._resources[name], value
        )

    def commit(self, device=None) -> WorldState:
        """The staged world as tensors on ``device`` (default: the world's
        own device, else ``cuda``). Copies, so later edits to this staging
        world never reach a committed state: ``torch.from_numpy`` alone
        would share the buffers."""
        device = resolve_device(device if device is not None else self.device)
        return WorldState(
            alive=torch.tensor(self._alive, device=device),
            rollback_id=torch.tensor(self._rollback_id, device=device),
            components={n: torch.tensor(a, device=device)
                        for n, a in self._components.items()},
            present={n: torch.tensor(a, device=device)
                     for n, a in self._present.items()},
            resources=tree_map(lambda a: torch.tensor(a, device=device),
                               self._resources),
        )


def to_host(state: WorldState) -> Dict[str, Any]:
    """Host copy of a world state as numpy arrays, in the dict layout and
    dtypes of ``bevy_ggrs_tpu.state.to_host``. The arrays are copies, never
    views of a CPU state's memory."""
    host = tree_map(lambda t: t.cpu().numpy().copy(), state)
    return {f.name: getattr(host, f.name) for f in dataclasses.fields(WorldState)}


def from_host(registry: TypeRegistry, host: Dict[str, Any], device=None) -> WorldState:
    """The inverse of :func:`to_host`: build a :class:`WorldState` on
    ``device`` from the numpy dict layout that both packages' ``to_host``
    return, checked against ``registry``."""
    device = resolve_device(device)
    if set(host["components"]) != set(registry.components):
        raise KeyError(
            f"components {sorted(host['components'])} do not match the "
            f"registry's {sorted(registry.components)}"
        )
    if set(host["resources"]) != set(registry.resources):
        raise KeyError(
            f"resources {sorted(host['resources'])} do not match the "
            f"registry's {sorted(registry.resources)}"
        )

    def tensor(a, dtype=None):
        t = torch.tensor(np.asarray(a), device=device)
        return t if dtype is None else t.to(dtype)

    return WorldState(
        alive=tensor(host["alive"], torch.bool),
        rollback_id=tensor(host["rollback_id"], torch.int32),
        components={n: tensor(host["components"][n], d.dtype)
                    for n, d in registry.components.items()},
        present={n: tensor(host["present"][n], torch.bool)
                 for n in registry.components},
        resources={n: tree_map(tensor, host["resources"][n])
                   for n in registry.resources},
    )


# ---------------------------------------------------------------------------
# Checksum (plain PyTorch; lanes are int64 holding 32-bit values)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 0x9747B28C
# Seed separating the hi lane's murmur stream from the lo lane's: the
# exchanged checksum is 64 bits, carried as two independent 32-bit streams
# over the same words.
_HI_TWEAK = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` without int64
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _to_u32_words(arr: torch.Tensor, nlead: int) -> torch.Tensor:
    """``arr[*lead, *rest]`` as ``int32[*lead, n_words]`` holding the u32
    words JAX's ``_to_u32_words`` makes: bool as 0/1, narrower types
    zero-extended from their bit pattern, 64-bit types split low word
    first."""
    lead = tuple(arr.shape[:nlead])
    n = math.prod(arr.shape[nlead:])
    if arr.dtype == torch.bool:
        words = arr.to(torch.int32)
    elif arr.element_size() == 1:
        words = arr.view(torch.uint8).to(torch.int32)
    elif arr.element_size() == 2:
        words = arr.view(torch.int16).to(torch.int32) & 0xFFFF
    elif arr.element_size() == 4:
        words = arr.view(torch.int32)
    else:
        words = arr.contiguous().view(torch.int32)
        n *= arr.element_size() // 4
    return words.reshape(lead + (n,))


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in ``[0, 2**32)``."""
    return words.to(torch.int64) & _M32


def _mix_one(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    k = _mul32(w, _C1)
    k = _mul32(_rotl(k, 15), _C2)
    h = h ^ k
    return (_mul32(_rotl(h, 13), 5) + 0xE6546B64) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix_words(h: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Mix ``words[cap, n]`` column by column into ``h[2, cap]``."""
    for i in range(words.shape[1]):
        h = _mix_one(h, words[:, i])
    return h


def _seed_rows(cap: int, device) -> torch.Tensor:
    """``[2, cap]`` lane seeds (lane 0 = lo, lane 1 = hi)."""
    seeds = torch.tensor([_SEED, _SEED ^ _HI_TWEAK], dtype=torch.int64,
                         device=device)
    return seeds[:, None].expand(2, cap)


def combine64(cs) -> int:
    """Fold a two-lane checksum (``[lo, hi]``, as int64 values, int32 bit
    patterns or uint32) into the one Python int sessions compare."""
    if isinstance(cs, torch.Tensor):
        cs = cs.cpu().numpy()
    a = np.asarray(cs).astype(np.int64).reshape(-1) & _M32
    return int(a[0]) | (int(a[1]) << 32)


def _slot_words(state: WorldState):
    """Per-part ``(name, [words[cap, n], ...])`` in mixing order: the
    rollback id, then per sorted component its presence bit and its
    presence-masked words."""
    cap = state.capacity
    parts = [("rollback_id", [_u32(_to_u32_words(state.rollback_id, 1))])]
    for name in sorted(state.components):
        pres = state.present[name]
        words = _u32(_to_u32_words(state.components[name], 1))
        words = torch.where(pres[:, None], words, 0)
        parts.append((f"component/{name}",
                      [pres.to(torch.int64).reshape(cap, 1), words]))
    return parts


def _live_sum(state: WorldState, h: torch.Tensor) -> torch.Tensor:
    h = _fmix(h)
    return torch.where(state.alive[None, :], h, 0).sum(dim=1) & _M32


def checksum(state: WorldState) -> torch.Tensor:
    """Order-insensitive 64-bit checksum of one world as ``int64[2]``
    lanes ``[lo, hi]``, bitwise equal to ``bevy_ggrs_tpu.state.checksum``.

    Per slot a murmur3 chain over the rollback id and every present
    component's words; slot hashes wrapping-sum over live slots, and the
    resource hash is added. The checksum kernel
    (:func:`bevy_ggrs_tpu_torch.ops.checksum.world_checksum`) computes the
    same bits."""
    h = _seed_rows(state.capacity, state.device)
    for _, words in _slot_words(state):
        for w in words:
            h = _mix_words(h, w)
    return (_live_sum(state, h) + _resources_checksum(state.resources,
                                                      state.device)) & _M32


def _name_seed(name: str) -> int:
    seed = 0
    for b in name.encode():
        seed = (seed * 31 + b) & _M32
    return seed


def _resources_checksum(resources: Dict[str, Any], device,
                        lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Position-keyed resource hash as ``int64[*lead, 2]``; every leaf
    carries the ``lead`` axes first (a ring's ``[depth]``).

    Every word hashes independently, seeded by (resource name, word
    position), and the hashes wrapping-sum. Each registered resource also
    adds a constant term, so a resource with zero words still counts."""
    B = math.prod(lead)
    total = torch.zeros((B, 2), dtype=torch.int64, device=device)
    for name in sorted(resources):
        ns = _name_seed(name)
        seeds = torch.tensor([_SEED ^ ns, (_SEED ^ _HI_TWEAK) ^ ns],
                             dtype=torch.int64, device=device)
        total = total + _fmix(seeds)
        base = 0
        for leaf in tree_leaves(resources[name]):
            words = _u32(_to_u32_words(leaf, len(lead))).reshape(B, -1)
            n = words.shape[1]
            pos = _mul32(torch.arange(base, base + n, dtype=torch.int64,
                                      device=device), _HI_TWEAK)
            h = seeds[:, None] ^ pos[None, :]  # [2, n]
            h = _fmix(_mix_one(h[None], words[:, None, :]))  # [B, 2, n]
            total = total + h.sum(dim=2)
            base += n
    return (total & _M32).reshape(lead + (2,))


def checksum_breakdown(state: WorldState) -> Dict[str, int]:
    """Per-part checksums for desync diagnosis: which registered component
    or resource holds different bits. Host-side tool."""
    h0 = _seed_rows(state.capacity, state.device)
    out: Dict[str, int] = {}
    for name, words in _slot_words(state):
        h = h0
        for w in words:
            h = _mix_words(h, w)
        out[name] = combine64(_live_sum(state, h))
        if name == "rollback_id":
            alive = state.alive.to(torch.int64).reshape(-1, 1)
            out["alive"] = combine64(_live_sum(state, _mix_words(h0, alive)))
    for name in sorted(state.resources):
        out[f"resource/{name}"] = combine64(
            _resources_checksum({name: state.resources[name]}, state.device)
        )
    return out


# ---------------------------------------------------------------------------
# Snapshot ring
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SnapshotRing:
    """Device-resident ring of world states, indexed ``frame % depth``."""

    states: WorldState  # every tensor gains a leading [depth] axis
    frames: torch.Tensor  # int32[depth], -1 = empty
    checksums: torch.Tensor  # int64[depth, 2]: [lo, hi] 32-bit lanes

    @property
    def depth(self) -> int:
        return self.frames.shape[-1]

    def replace(self, **changes) -> "SnapshotRing":
        return dataclasses.replace(self, **changes)


def ring_init(state: WorldState, depth: int) -> SnapshotRing:
    """A ring of ``depth`` copies of ``state`` with every row marked empty.
    Each row is its own memory (``clone`` after ``expand``), so a save into
    one row never writes the others."""
    return SnapshotRing(
        states=tree_map(lambda x: x[None].expand((depth,) + x.shape).clone(),
                        state),
        frames=torch.full((depth,), -1, dtype=torch.int32, device=state.device),
        checksums=torch.zeros((depth, 2), dtype=torch.int64, device=state.device),
    )


def ring_save(
    ring: SnapshotRing, state: WorldState, frame: int,
    out: Optional[torch.Tensor] = None,
) -> Tuple[SnapshotRing, torch.Tensor]:
    """Save ``state`` as frame ``frame``; returns ``(ring, checksum)``,
    the checksum a tensor of its own (never a view of ``ring.checksums``,
    which a later save into the same row rewrites), also written to
    ``out`` (``int64[2]``) when given.

    Updates ``ring`` in place and returns it: no caller keeps an older
    ring. ``state`` must not share memory with the ring. For a CUDA state
    this is one launch of the checksum kernel in its save mode
    (:func:`bevy_ggrs_tpu_torch.ops.checksum.world_checksum`): the bytes,
    the frame and the digest of the row in one pass; a CPU state takes its
    plain version."""
    from bevy_ggrs_tpu_torch.ops.checksum import world_checksum

    return ring, world_checksum(state, "save", ring=ring, frame=frame, out=out)


def ring_load(ring: SnapshotRing, frame: int) -> WorldState:
    """A copy of the state saved for ``frame``; the caller must know it is
    resident. A copy and not a view, so later saves into that row never
    reach the loaded state."""
    slot = int(frame) % ring.depth
    return tree_map(lambda r: r[slot].clone(), ring.states)


def ring_frame_at(ring: SnapshotRing, frame: int) -> int:
    """Host-side: which frame currently occupies ``frame``'s slot."""
    return int(ring.frames[frame % ring.depth])
