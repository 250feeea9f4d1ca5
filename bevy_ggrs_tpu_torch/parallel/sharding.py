"""Device-mesh sharding over ``torch.distributed``.

Counterpart of ``bevy_ggrs_tpu/parallel/sharding.py``. The JAX package lays
global arrays over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here the program runs SPMD, one process per device: a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with dims named
``(branch, entity)``, every rank holds its own shard as plain local
tensors, and the collectives are explicit calls of this module.

Two mesh axes, as in the JAX package:

- ``"branch"``: the speculative rollout's branches split across ranks
  (each rank rolls out its contiguous block; :class:`BranchShard`); a
  commit broadcasts the chosen branch from the rank that owns it;
- ``"entity"``: a world's entity (capacity) axis split across ranks
  (:class:`EntityShard`); every tensor with a leading entity axis keeps
  this rank's contiguous row block, and resources replicate.

Under entity sharding the checksum's per-slot lanes are exact partial sums
(a slot's hash reads only its own words), so each rank hashes its rows,
one rank of the entity group also hashes the replicated resources, and
the lanes sum over the group (:func:`sum_lanes`, a wrapping sum, exact in
any order). The executors that hold an :class:`EntityShard` save, guard
and hash through it (:meth:`EntityShard.save`, :meth:`EntityShard.guard`,
:meth:`EntityShard.checksum`): rings always store the whole world's
lanes.

A session decides its layout once (:class:`MeshLayout`: its
:class:`BranchShard`, its :class:`EntityShard` and the schedule for its
rows), and its serial, speculative and fused executors share it.

A system that couples entities sees the whole world through GSPMD's own
behaviour around an operation it cannot partition: gather the world, run
the system, keep this rank's rows (:func:`shard_schedule`). A system
marked :func:`entity_local` (its rows only read their own row, or it does
its own collectives, as boids' sharded flock does) runs on the shard as
it is.

Every collective moves bytes: a leaf is sent as ``t.contiguous().view(
torch.uint8)``, so ``uint32``/``uint16``/``bool`` leaves cross gloo (which
refuses those dtypes) and NCCL unchanged, and all leaves of one call go in
one packed buffer. The gloo backend stages CUDA tensors through host
buffers (chosen by backend, never after a failure); NCCL takes them on the
card. ``COLLECTIVES`` counts the calls issued.

JAX's ``shard_map_compat`` is an API shim over ``jax.shard_map`` and its
older spelling: the port's sharded bodies are plain per-rank code, so it
has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from bevy_ggrs_tpu_torch.ops.checksum import save_plain, save_slots_plain, world_checksum
from bevy_ggrs_tpu_torch.state import SnapshotRing, WorldState, checksum_impl, tree_map

_M32 = 0xFFFFFFFF

# Collective calls issued in this process, by kind.
COLLECTIVES = {"all_gather": 0, "broadcast": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# ---------------------------------------------------------------------------
# Groups and meshes
# ---------------------------------------------------------------------------


def default_device_type() -> str:
    """``"cuda"``, the device a mesh or group runs on unless the caller
    names another. Without a GPU this raises: a mesh on the CPU is asked
    for by name (``device_type="cpu"``), never chosen on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to build a "
            "mesh or process group on the CPU"
        )
    return "cuda"


def ensure_process_group(device_type: Optional[str] = None) -> None:
    """A world-size-1 process group from a ``HashStore`` when none is
    initialized: NCCL on ``cuda`` (the default, raising without a GPU),
    gloo on ``cpu``."""
    if dist.is_initialized():
        return
    device_type = device_type or default_device_type()
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def branch_mesh(
    devices: Optional[Sequence[int]] = None,
    entity_shards: int = 1,
    branch_axis: str = "branch",
    entity_axis: str = "entity",
    device_type: Optional[str] = None,
):
    """A ``[branch, entity]`` ``DeviceMesh`` over the default group's ranks
    (``devices``: the global ranks in mesh order; default all of them).

    ``entity_shards`` ranks along the entity axis, the rest along the
    branch axis. Every rank of the default group calls this, as
    ``torch.distributed`` requires of any new group. Without an
    initialized group this makes a world-size-1 one on ``device_type``
    (:func:`ensure_process_group`: ``cuda`` unless ``"cpu"`` is named)."""
    ensure_process_group(device_type)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    if n % entity_shards:
        raise ValueError(f"{n} devices not divisible by entity_shards={entity_shards}")
    from torch.distributed.device_mesh import DeviceMesh

    # The mesh's own device type only names where its collectives run:
    # "cuda" for NCCL; gloo meshes are "cpu" even when the worlds live on
    # the card (their collectives stage through the host).
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(n // entity_shards, entity_shards)
    return DeviceMesh(mesh_type, layout, mesh_dim_names=(branch_axis, entity_axis))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_rank(mesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


def mesh_key(mesh) -> Optional[tuple]:
    """What a verdict about a mesh's programs depends on: axis names,
    shape and backend (None without a mesh)."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    return (names, tuple(axis_size(mesh, a) for a in names), dist.get_backend())


# ---------------------------------------------------------------------------
# Layout descriptors: the JAX package's PartitionSpec and NamedSharding
# names, kept as parity API for code written against it. The port's own
# paths do not read them: its executors share one MeshLayout (below).
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: per leading axis of a leaf, the mesh axis it is
    split over, or None (replicated). ``P()`` replicates the leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: P


def branch_pspec(mesh, branch_axis: str = "branch") -> NamedSharding:
    return NamedSharding(mesh, P(branch_axis))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _map(fn, tree):
    """``tree_map`` that also walks a :class:`SnapshotRing`, and tuples
    and lists holding one."""
    if isinstance(tree, SnapshotRing):
        return SnapshotRing(states=_map(fn, tree.states), frames=fn(tree.frames),
                            checksums=fn(tree.checksums))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return tree_map(fn, tree)


def _block(n: int, parts: int, index: int, what: str) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{what}={n} not divisible by {parts} shards")
    per = n // parts
    return index * per, per


def shard_branch_axis(tree, mesh, branch_axis: str = "branch"):
    """This rank's contiguous block of every leaf's leading (branch) axis:
    branch-stacked trees (``states[B]``, rings ``[B, ...]``, bits ``[B, F,
    ...]``). The block of a leaf is a copy."""
    size, index = axis_size(mesh, branch_axis), axis_rank(mesh, branch_axis)

    def take(x):
        start, per = _block(int(x.shape[0]), size, index, "branches")
        block = x[start:start + per]
        return block.clone() if isinstance(block, torch.Tensor) else block.copy()

    return _map(take, tree)


def world_pspecs(state: WorldState, entity_axis: Optional[str] = None) -> WorldState:
    """The spec tree of a world: every leaf with a leading ``capacity``
    axis splits over ``entity_axis`` (or replicates when None), and the
    resources replicate."""
    cap = state.capacity

    def spec(x):
        if entity_axis is not None and x.dim() >= 1 and x.shape[0] == cap:
            return P(entity_axis)
        return P()

    return state.replace(
        alive=spec(state.alive), rollback_id=spec(state.rollback_id),
        components={n: spec(t) for n, t in state.components.items()},
        present={n: spec(t) for n, t in state.present.items()},
        resources=tree_map(lambda x: P(), state.resources))


def _spec_map(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, WorldState):
        return WorldState(**{f.name: _spec_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(WorldState)})
    if isinstance(tree, SnapshotRing):
        return SnapshotRing(states=_spec_map(fn, tree.states),
                            frames=_spec_map(fn, tree.frames),
                            checksums=_spec_map(fn, tree.checksums))
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_map(fn, v) for v in tree]
    return tree


def prepend_axes(specs_tree, *axes):
    """Prefix every spec in the tree with ``axes`` (a leading ring-depth
    ``None`` or a ``"branch"`` batch axis)."""
    return _spec_map(lambda s: P(*axes, *s), specs_tree)


def to_named(specs_tree, mesh):
    return _spec_map(lambda s: NamedSharding(mesh, s), specs_tree)


def shard_world(state: WorldState, mesh, entity_axis: str = "entity") -> WorldState:
    """This rank's shard of a whole world: the contiguous row block of
    every leaf with a leading entity axis (copies), the resources as they
    are."""
    return EntityShard(mesh, entity_axis, state.capacity).own(state)


def world_and_ring_shardings(state_template: WorldState, mesh, entity_axis: str,
                             prefix: tuple = ()):
    """The (world, snapshot-ring) layout pair: world leaves split on
    ``entity_axis``, ring leaves gain a replicated depth axis, and
    ``prefix`` names leading batch axes (``(branch_axis,)`` for the
    speculative executor)."""
    sspec = world_pspecs(state_template, entity_axis)
    state_s = to_named(prepend_axes(sspec, *prefix), mesh)
    ring_s = SnapshotRing(
        states=to_named(prepend_axes(sspec, *prefix, None), mesh),
        frames=NamedSharding(mesh, P(*prefix)),
        checksums=NamedSharding(mesh, P(*prefix)),
    )
    return state_s, ring_s


# ---------------------------------------------------------------------------
# Collectives: packed byte views
# ---------------------------------------------------------------------------


def _staged(group) -> bool:
    """gloo collectives run on host buffers."""
    return dist.get_backend(group) == "gloo"


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    return torch.cat(flat) if len(flat) > 1 else flat[0].clone()


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


def _to_wire(buf: torch.Tensor, group) -> torch.Tensor:
    return buf.cpu() if buf.is_cuda and _staged(group) else buf


def all_gather_rows(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                    group) -> List[torch.Tensor]:
    """Each tensor's blocks from every rank of ``group``, concatenated in
    group-rank order along its ``dims`` entry (a tiled all-gather): one
    collective for all tensors. Every rank's blocks have the same shapes."""
    size = dist.get_world_size(group)
    moved = [t.movedim(d, 0) for t, d in zip(tensors, dims)]
    buf = _to_wire(_pack(moved), group)
    parts = [torch.empty_like(buf) for _ in range(size)]
    # The list form: torch 2.13 deprecates all_gather_into_tensor, and
    # older releases lack its successor.
    dist.all_gather(parts, buf, group=group)
    COLLECTIVES["all_gather"] += 1
    device = tensors[0].device
    blocks = [_unpack(p.to(device), moved) for p in parts]
    return [torch.cat([b[i] for b in blocks], dim=0).movedim(0, d).contiguous()
            for i, d in enumerate(dims)]


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int, group) -> List[torch.Tensor]:
    """The tensors of group rank ``src`` on every rank of ``group`` (the
    others pass tensors of the same shapes and dtypes, whose values are
    ignored): one collective. Returns fresh tensors."""
    buf = _to_wire(_pack(tensors), group)
    dist.broadcast(buf, src=dist.get_global_rank(group, int(src)), group=group)
    COLLECTIVES["broadcast"] += 1
    return _unpack(buf.to(tensors[0].device), tensors)


def sum_lanes(lanes: torch.Tensor, group) -> torch.Tensor:
    """The wrapping sum of checksum lanes (``int64`` values in ``[0,
    2**32)``) over ``group``: an ``int64`` all-reduce, masked to 32 bits.
    Exact in any order; a fresh tensor on ``lanes``' device."""
    wire = _to_wire(lanes.contiguous().clone(), group)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return wire.to(lanes.device) & _M32


# ---------------------------------------------------------------------------
# Entity and branch shards
# ---------------------------------------------------------------------------


def _entity_leaves(state: WorldState):
    """The leaves that carry the entity axis, in a fixed order."""
    leaves = [state.alive, state.rollback_id]
    for n in sorted(state.components):
        leaves.append(state.components[n])
        leaves.append(state.present[n])
    return leaves


def _with_entity_leaves(state: WorldState, leaves) -> WorldState:
    it = iter(leaves)
    alive, rid = next(it), next(it)
    comps, pres = {}, {}
    for n in sorted(state.components):
        comps[n] = next(it)
        pres[n] = next(it)
    return state.replace(alive=alive, rollback_id=rid, components=comps, present=pres)


class EntityShard:
    """This rank's row block of a world's entity axis over ``mesh``'s
    ``entity_axis``, and the group it shares the world with."""

    def __init__(self, mesh, entity_axis: str, capacity: int):
        self.mesh = mesh
        self.axis = entity_axis
        self.group = mesh.get_group(entity_axis)
        self.size = axis_size(mesh, entity_axis)
        self.rank = axis_rank(mesh, entity_axis)
        self.capacity = int(capacity)
        self.start, self.rows = _block(self.capacity, self.size, self.rank, "capacity")

    @property
    def hashes_resources(self) -> bool:
        """The one rank of the group whose checksum lanes carry the
        replicated resources' hash."""
        return self.rank == 0

    def own(self, state: WorldState) -> WorldState:
        """This rank's rows of a whole world (any leading axes before the
        entity axis), copies; the resources as they are."""
        d = state.alive.dim() - 1
        if state.alive.shape[d] != self.capacity:
            raise ValueError(f"a world of capacity {state.alive.shape[d]} is not this "
                             f"shard's {self.capacity}")
        return _with_entity_leaves(
            state, [t.narrow(d, self.start, self.rows).contiguous()
                    for t in _entity_leaves(state)])

    def whole(self, state: WorldState) -> WorldState:
        """The whole world from every rank's shard: one all-gather."""
        d = state.alive.dim() - 1
        leaves = _entity_leaves(state)
        return _with_entity_leaves(state, all_gather_rows(leaves, [d] * len(leaves),
                                                          self.group))

    def sum_lanes(self, lanes: torch.Tensor) -> torch.Tensor:
        return sum_lanes(lanes, self.group)

    def checksum(self, state: WorldState) -> torch.Tensor:
        """The whole world's lanes from this rank's rows (any leading
        axes): one checksum launch, the resources hashed on one rank
        only, and a sum over the group. An installed checksum function
        (``state.set_checksum_impl``) reads the gathered whole world."""
        fn = checksum_impl()
        if fn is not None:
            return fn(self.whole(state))
        return self.sum_lanes(world_checksum(state, resources=self.hashes_resources))

    def save(self, ring: SnapshotRing, state: WorldState, frame: int = 0,
             out: Optional[torch.Tensor] = None,
             frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``ring_save`` of this rank's rows: one save launch, then the
        row's digest (and ``out``) rewritten with the whole world's lanes,
        which it returns. With ``frames`` (``int32[S]`` on the world's
        device, as :func:`~bevy_ggrs_tpu_torch.ops.checksum.world_checksum`
        takes them) slot ``s`` of a ``[S]`` world saves into row
        ``frames[s] mod depth`` of ring ``s`` instead of row ``frame %
        depth``. With a checksum function installed, the rows are copied
        and the digest is the function's of the whole world."""
        fn = checksum_impl()
        if fn is None:
            lanes = self.sum_lanes(world_checksum(state, "save", ring=ring, frame=frame,
                                                  frames=frames,
                                                  resources=self.hashes_resources))
        else:
            lanes = fn(self.whole(state))
            if frames is None:
                save_plain(ring, state, frame, digest=lambda _: lanes)
            else:
                save_slots_plain(ring, state, frames, digest=lambda _: lanes)
        if frames is None:
            at = (slice(None),) * (ring.frames.dim() - 1) + (int(frame) % ring.depth,)
        else:
            at = (torch.arange(len(frames), device=frames.device),
                  torch.remainder(frames.to(torch.int64), ring.depth))
        ring.checksums[at] = lanes
        if out is not None:
            out.copy_(lanes)
        return lanes

    def guard(self, ring: SnapshotRing, frame: int) -> bool:
        """The restore guard of a single ring of row blocks: True when row
        ``frame % depth`` does not hold ``frame`` or its rows hash, over
        the group, to the stored whole-world digest."""
        row = int(frame) % ring.depth
        lanes = self.checksum(tree_map(lambda x: x[row], ring.states))
        return int(ring.frames[row]) != int(frame) or torch.equal(lanes, ring.checksums[row])

    def own_ring(self, ring: SnapshotRing) -> SnapshotRing:
        """This rank's rows of a whole world's ring (frames and digests,
        the whole world's, as they are)."""
        return SnapshotRing(states=self.own(ring.states), frames=ring.frames.clone(),
                            checksums=ring.checksums.clone())

    def whole_ring(self, ring: SnapshotRing) -> SnapshotRing:
        """The whole world's ring from every rank's rows: one all-gather."""
        return SnapshotRing(states=self.whole(ring.states), frames=ring.frames.clone(),
                            checksums=ring.checksums.clone())


class BranchShard:
    """This rank's contiguous block of ``num_branches`` over ``mesh``'s
    ``branch_axis``."""

    def __init__(self, mesh, branch_axis: str, num_branches: int):
        self.mesh = mesh
        self.axis = branch_axis
        self.group = mesh.get_group(branch_axis)
        self.size = axis_size(mesh, branch_axis)
        self.rank = axis_rank(mesh, branch_axis)
        self.num_branches = int(num_branches)
        self.start, self.per = _block(self.num_branches, self.size, self.rank,
                                      "num_branches")

    @property
    def stop(self) -> int:
        return self.start + self.per

    def owner(self, branch: int) -> Tuple[int, int]:
        """``(group rank, local index)`` of global branch ``branch``."""
        b = int(branch)
        if not 0 <= b < self.num_branches:
            raise IndexError(f"branch {b} of {self.num_branches}")
        return b // self.per, b % self.per

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int) -> List[torch.Tensor]:
        return broadcast_tensors(tensors, src, self.group)

    def gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's block of ``tensor`` along axis 0, in branch order."""
        return all_gather_rows([tensor], [0], self.group)[0]


def select_owned(shard: Optional[BranchShard], tree, branch: int):
    """Global branch ``branch`` of a branch-blocked tree (a ``[B]`` world,
    a ``[B, depth]`` stack of rings, or a SnapshotRing of them) on every
    rank: copies, broadcast from the rank that owns it."""
    if shard is None:
        return _map(lambda x: x[int(branch)].clone(), tree)
    src, local = shard.owner(branch)
    leaves: list = []
    _map(lambda x: leaves.append(x[local]), tree)
    got = iter(shard.broadcast(leaves, src))
    return _map(lambda x: next(got), tree)


# ---------------------------------------------------------------------------
# Systems on an entity shard
# ---------------------------------------------------------------------------


def entity_local(system):
    """Mark ``system`` as entity-local: under entity sharding it runs on
    this rank's rows as it is (its rows read only their own row and the
    replicated resources, or it does its own collectives)."""
    system.entity_local = True
    return system


def gathered(system, shard: EntityShard):
    """``system`` on a sharded world through the whole world: gather it,
    run the system, keep this rank's rows (and the resources it wrote,
    the same on every rank)."""

    def run(state, inputs):
        return shard.own(system(shard.whole(state), inputs))

    run.entity_local = True
    return run


def shard_schedule(schedule, shard: Optional[EntityShard]):
    """``schedule`` for ``shard``'s row blocks: entity-local systems as
    they are, every other one through :func:`gathered`."""
    from bevy_ggrs_tpu_torch.schedule import Schedule

    if shard is None:
        return schedule
    systems = getattr(schedule, "systems", None)
    if systems is None:
        return schedule if getattr(schedule, "entity_local", False) else gathered(schedule, shard)
    return Schedule([s if getattr(s, "entity_local", False) else gathered(s, shard)
                     for s in systems])


class MeshLayout:
    """A session's layout on a device mesh, decided once and shared by
    its executors (serial, speculative and fused): this rank's block of
    ``num_branches`` over ``branch_axis`` (None: every branch here, or no
    branch split when ``branch_axis`` is None), its rows of each world's
    entity axis over ``entity_axis`` (None: whole worlds; needs the whole
    ``state_template``), and ``schedule`` for those rows
    (:func:`shard_schedule`). Without a mesh it is the identity layout."""

    def __init__(self, schedule, num_branches: int = 1, mesh=None,
                 branch_axis: Optional[str] = "branch", entity_axis: Optional[str] = None,
                 state_template: Optional[WorldState] = None):
        self.mesh = mesh
        self.branch = self.entity = None
        if mesh is not None:
            if branch_axis is not None:
                self.branch = BranchShard(mesh, branch_axis, num_branches)
            if entity_axis is not None:
                if state_template is None:
                    raise ValueError("entity_axis sharding needs a state_template")
                self.entity = EntityShard(mesh, entity_axis, state_template.capacity)
        self.schedule = shard_schedule(schedule, self.entity)
        self.num_branches = int(num_branches)

    @property
    def first_branch(self) -> int:
        return 0 if self.branch is None else self.branch.start

    def local_bits(self, bits):
        """This rank's block of a host ``[B, ...]`` branch tensor (every
        rank builds the same tensor); a tensor that already is the block
        passes as it is."""
        if self.branch is None or bits.shape[0] == self.branch.per != self.num_branches:
            return bits
        return bits[self.branch.start:self.branch.stop]

    def local_world(self, state: WorldState) -> WorldState:
        """This rank's rows of a whole world; a row block passes."""
        if self.entity is None or state.capacity != self.entity.capacity:
            return state
        return self.entity.own(state)

    def whole_world(self, state: WorldState) -> WorldState:
        """The whole world from this rank's rows (a collective on an
        entity-sharded mesh)."""
        return state if self.entity is None else self.entity.whole(state)

    def select(self, tree, branch: int):
        """Global branch ``branch`` of a branch-blocked tree on every rank
        (a broadcast from its owner on a branch-sharded mesh)."""
        return select_owned(self.branch, tree, branch)

    def all_checksums(self, checksums: torch.Tensor) -> torch.Tensor:
        """Every branch's ``[B, F, 2]`` lanes from this rank's block."""
        return checksums if self.branch is None else self.branch.gather(checksums)
