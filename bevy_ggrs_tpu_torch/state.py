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
sum as the JAX package's, bit for bit. The speculative rollout's worlds
carry a leading ``[B]`` branch axis, and its rings are a ``[B, depth]``
stack (:func:`branch_rings`), saved all at once, one launch a frame
(``rollout.py``'s batched loop; :func:`ring_save` takes such a stack too).

Rings are written in place, where the JAX package's are values: a caller
that needs an older ring beside a newer one clones it
(:func:`clone_ring`), and every read of one branch or one row
(:func:`select_branch`, :func:`ring_load`) returns a copy.

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
    """The numpy dtype of ``dtype``'s host arrays: the one holding the same
    values, except for bfloat16, which numpy lacks and which the host holds
    as its 16-bit patterns in ``uint16`` (see :func:`host_array`)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_array(value, dtype: torch.dtype) -> np.ndarray:
    """``value`` as a host array of ``dtype`` (:func:`np_dtype`). A
    bfloat16 value is rounded to nearest even from float32, as JAX's
    bfloat16 does, and kept as its bit pattern."""
    if dtype == torch.bfloat16:
        bf = torch.from_numpy(np.array(value, dtype=np.float32)).to(torch.bfloat16)
        return bf.view(torch.int16).numpy().view(np.uint16)
    return np.array(value, dtype=np_dtype(dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor's memory); a
    bfloat16 tensor comes back as its bit patterns in ``uint16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a host array (copied). For
    bfloat16, a 2-byte array that is not float16 holds bit patterns (this
    package's ``uint16`` or JAX's own bfloat16); any other array holds
    values."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2 or a.dtype == np.float16:
            a = host_array(a, dtype)
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device).to(dtype)


# JAX runs with 64-bit types disabled, so a Python or numpy 64-bit value
# becomes its 32-bit counterpart there; resources and components follow the
# same rule so the two packages hold and hash the same words.
_CANONICAL = {
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.float64): np.float32,
}
_CANONICAL_TORCH = {
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.float64: torch.float32,
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

    def prototype(self, capacity: int, device=None) -> torch.Tensor:
        """``[capacity, *shape]`` of ``default`` on ``device`` (default
        ``cuda``, raising when there is no GPU)."""
        return torch.full((capacity,) + tuple(self.shape), self.default, dtype=self.dtype,
                          device=resolve_device(device))


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
        """Register a component; a 64-bit ``dtype`` is held as its 32-bit
        counterpart, as in JAX (64-bit types off)."""
        if name in self.components:
            raise ValueError(f"component {name!r} registered twice")
        dtype = _CANONICAL_TORCH.get(dtype, dtype)
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

    def num_alive(self) -> torch.Tensor:
        """The live slots, an ``int32`` scalar on the world's device."""
        return self.alive.sum(dtype=torch.int32)

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)


def init_state(registry: TypeRegistry, capacity: int, device=None) -> WorldState:
    """An empty world with ``capacity`` entity slots."""
    device = resolve_device(device)
    return WorldState(
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        rollback_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        components={n: d.prototype(capacity, device) for n, d in registry.components.items()},
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
            n: np.full((capacity,) + d.shape, host_array(d.default, d.dtype))
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
            self._components[name][slot] = host_array(
                value, self.registry.components[name].dtype
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
            components={n: from_numpy(a, self.registry.components[n].dtype, device)
                        for n, a in self._components.items()},
            present={n: torch.tensor(a, device=device)
                     for n, a in self._present.items()},
            resources=tree_map(lambda a: torch.tensor(a, device=device),
                               self._resources),
        )


def to_host(state: WorldState) -> Dict[str, Any]:
    """Host copy of a world state as numpy arrays, in the dict layout and
    dtypes of ``bevy_ggrs_tpu.state.to_host``; a bfloat16 component comes
    back as its bit patterns in ``uint16`` (JAX's bfloat16 array viewed as
    ``uint16`` holds the same). The arrays are copies, never views of a CPU
    state's memory."""
    host = tree_map(to_numpy, state)
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

    return WorldState(
        alive=from_numpy(host["alive"], torch.bool, device),
        rollback_id=from_numpy(host["rollback_id"], torch.int32, device),
        components={n: from_numpy(host["components"][n], d.dtype, device)
                    for n, d in registry.components.items()},
        present={n: from_numpy(host["present"][n], torch.bool, device)
                 for n in registry.components},
        resources={n: tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                               host["resources"][n])
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
# The checksum hook
# ---------------------------------------------------------------------------

# A checksum function the user installed (set_checksum_impl); None is the
# port's own route: the checksum kernel on the card, its plain version on
# the CPU.
_checksum_impl: list = [None]


def set_checksum_impl(fn: Optional[Callable[[WorldState], torch.Tensor]]) -> None:
    """Install ``fn`` as the digest of every save (:func:`ring_save`, the
    serving tier's slot saves, an entity shard's) and of every integrity
    reader (``bevy_ggrs_tpu_torch.integrity``); None restores the port's
    own route. ``fn`` takes a world, or a stack of worlds (leading axes
    before the entity axis), and returns its ``int64[*lead, 2]`` lanes on
    the world's device, as :func:`bevy_ggrs_tpu_torch.ops.checksum.checksum`
    does. It stays in force until the next call: nothing installs or
    removes one on its own."""
    _checksum_impl[0] = fn


def checksum_impl() -> Optional[Callable[[WorldState], torch.Tensor]]:
    """The installed checksum function, or None for the port's own route."""
    return _checksum_impl[0]


def active_checksum(state: WorldState) -> torch.Tensor:
    """``state``'s lanes through the installed function, or, with none
    installed, through :func:`bevy_ggrs_tpu_torch.ops.checksum.checksum`
    (one kernel launch on the card)."""
    fn = _checksum_impl[0]
    if fn is not None:
        return fn(state)
    from bevy_ggrs_tpu_torch.ops.checksum import checksum as kernel_checksum

    return kernel_checksum(state)


# ---------------------------------------------------------------------------
# Snapshot ring
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SnapshotRing:
    """Device-resident ring of world states, indexed ``frame % depth``;
    or a ``[B, depth]`` stack of rings, one per speculative branch."""

    states: WorldState  # every tensor gains a leading [depth] (or [B, depth]) axis
    frames: torch.Tensor  # int32[depth] (or [B, depth]), -1 = empty
    checksums: torch.Tensor  # int64[depth, 2] (or [B, depth, 2]): [lo, hi] 32-bit lanes

    @property
    def depth(self) -> int:
        return self.frames.shape[-1]

    def replace(self, **changes) -> "SnapshotRing":
        return dataclasses.replace(self, **changes)


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for an unsigned type wider than a byte the same
    bits as its signed type: PyTorch's ``where`` and index reads and writes
    do not take those types on every device."""
    to = _SIGNED.get(t.dtype)
    return t if to is None else t.view(to)


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


def branch_rings(state: WorldState, num_branches: int, depth: int) -> SnapshotRing:
    """A ``[num_branches, depth]`` stack of empty rings for worlds shaped
    like ``state`` (a single world): frames -1 and digests 0. The rows'
    memory is allocated and not filled: only saved rows (frames >= 0) are
    ever read, and the speculative rollout saves every row of its rings
    before anything reads them."""
    lead = (int(num_branches), int(depth))
    return SnapshotRing(
        states=tree_map(lambda x: torch.empty(lead + x.shape, dtype=x.dtype,
                                              device=x.device), state),
        frames=torch.full(lead, -1, dtype=torch.int32, device=state.device),
        checksums=torch.zeros(lead + (2,), dtype=torch.int64, device=state.device),
    )


def broadcast_branches(state: WorldState, num_branches: int) -> WorldState:
    """``num_branches`` copies of a single world as one ``[B]`` world, each
    branch its own contiguous memory."""
    return tree_map(lambda x: x[None].expand((int(num_branches),) + x.shape).contiguous(),
                    state)


def select_branch(tree, branch: int):
    """Branch ``branch`` of a ``[B]`` world or of a ``[B, depth]`` stack of
    rings, as a copy: later saves into the stack never reach it."""
    b = int(branch)
    if isinstance(tree, SnapshotRing):
        return SnapshotRing(states=tree_map(lambda x: x[b].clone(), tree.states),
                            frames=tree.frames[b].clone(),
                            checksums=tree.checksums[b].clone())
    return tree_map(lambda x: x[b].clone(), tree)


def clone_ring(ring: SnapshotRing) -> SnapshotRing:
    """A copy of ``ring`` in memory of its own."""
    return SnapshotRing(states=tree_map(torch.clone, ring.states),
                        frames=ring.frames.clone(), checksums=ring.checksums.clone())


def ring_save(
    ring: SnapshotRing, state: WorldState, frame: int,
    out: Optional[torch.Tensor] = None,
) -> Tuple[SnapshotRing, torch.Tensor]:
    """Save ``state`` as frame ``frame``; returns ``(ring, checksum)``,
    the checksum a tensor of its own (never a view of ``ring.checksums``,
    which a later save into the same row rewrites), also written to
    ``out`` (``int64[2]``) when given. A ``[B]`` world saves into a ``[B,
    depth]`` stack of rings, branch ``b`` into ring ``b``, and its checksum
    and ``out`` are ``int64[B, 2]``.

    Updates ``ring`` in place and returns it: no caller keeps an older
    ring. ``state`` must not share memory with the ring. For a CUDA state
    this is one launch of the checksum kernel in its save mode, whatever
    the number of branches
    (:func:`bevy_ggrs_tpu_torch.ops.checksum.world_checksum`): the bytes,
    the frame and the digest of the row in one pass; a CPU state takes its
    plain version. With a checksum function installed
    (:func:`set_checksum_impl`) the row's digest is that function's, and
    the bytes are copied by ``copy_``."""
    from bevy_ggrs_tpu_torch.ops.checksum import save_plain, world_checksum

    fn = _checksum_impl[0]
    if fn is not None:
        return ring, save_plain(ring, state, frame, out, digest=fn)
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
