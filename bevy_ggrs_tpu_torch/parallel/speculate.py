"""Speculative branch batching: the serial replay loop, turned into a batch axis.

Counterpart of ``bevy_ggrs_tpu/parallel/speculate.py``. The reference
predicts remote inputs with one hypothesis, repeat-last-input, and pays a
serial replay when it is wrong. Here B candidate input futures roll forward
at once over a leading ``[B]`` branch axis of the world, and when the real
inputs arrive the branch whose prefix matches is selected: recovery from a
misprediction becomes a copy, not a resimulation.

1. :func:`enumerate_branches`: the candidate input tensor ``bits[B, F, P,
   ...]``. Branch 0 is the reference's own policy (repeat the last input).
2. :class:`SpeculativeExecutor`: every branch rolls forward F frames from
   the same start state (:func:`rollout_branches`, the batched burst loop
   of ``rollout.py`` over the ``[B]`` world), each frame's save of all B
   branches one launch of the checksum kernel at a frame a branch taken
   from the device, giving per-branch rings and per-branch checksum
   streams.
3. :func:`match_branch`: host-side longest-prefix match of the confirmed
   inputs against the branch tensor.
4. :meth:`SpeculativeExecutor.commit`: a copy of the matched branch's
   ring and state; :func:`merge_rings` overlays a branch ring's saved rows
   onto the session's ring.

The JAX package's samplers draw from ``jax.random``; the port's draw from a
``torch.Generator``, with the same structure (branch 0 repeat-last) and
reproducible from its seed, and cannot be bitwise JAX's draws.

With a device mesh (``mesh=``, ``parallel/sharding.py``) the branches split
over the mesh's branch axis: each rank rolls out its contiguous block (no
collective), and a commit broadcasts the chosen branch from the rank that
owns it over the branch group. With ``entity_axis`` too, each world's
entity axis splits over that axis as in the serial executor.

On a CUDA world with no mesh and no checksum function installed
(:func:`graph_path`), :meth:`SpeculativeExecutor.run` captures its rollout
once as a CUDA graph (:class:`RolloutGraph`) per :func:`rollout_key` and
replays it on every later call with that key: the same kernels, launched
by one ``cudaGraphLaunch`` instead of one Python dispatch each, with the
inputs copied into static buffers without a synchronize. Every other
rollout runs :func:`rollout_branches` eagerly. The graph captures that
same function, so a rollout has one body, captured or run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch import ops
from bevy_ggrs_tpu_torch.native import spec as native_spec
from bevy_ggrs_tpu_torch.obs.trace import null_tracer
from bevy_ggrs_tpu_torch.rollout import _slot_steps
from bevy_ggrs_tpu_torch.schedule import PREDICTED, Schedule
from bevy_ggrs_tpu_torch.state import (
    SnapshotRing,
    WorldState,
    branch_rings,
    broadcast_branches,
    checksum_impl,
    clone_ring,
    select_branch,
    tree_map,
)

# A branch sampler maps (generator, last_bits[P, ...], B, F) -> bits[B, F,
# P, ...]: the Monte Carlo input tree.
BranchSampler = Callable[[torch.Generator, torch.Tensor, int, int], torch.Tensor]


def repeat_last_sampler(generator, last_bits, num_branches: int, num_frames: int):
    """Every branch repeats the last input: the degenerate tree (all
    branches identical; the reference's prediction)."""
    del generator
    last_bits = torch.as_tensor(last_bits)
    return last_bits[None, None].expand(
        (num_branches, num_frames) + tuple(last_bits.shape)).clone()


def bitmask_sampler(num_bits: int = 4, keep_prob: float = 0.5) -> BranchSampler:
    """Monte Carlo tree over ``u8``-bitmask inputs (box_game-style).

    Per branch, frame and player: with ``keep_prob`` keep the previous
    frame's input, else draw a uniform mask over the low ``num_bits`` bits.
    Branch 0 is pinned to repeat-last, so the tree always contains the
    reference's prediction. Draws come from the caller's generator."""

    def sample(generator, last_bits, num_branches: int, num_frames: int):
        last_bits = torch.as_tensor(last_bits)
        shape = (num_branches, num_frames) + tuple(last_bits.shape)
        keep = torch.rand(shape, generator=generator) < keep_prob
        rand = torch.randint(0, 1 << num_bits, shape, generator=generator,
                             dtype=torch.int32).to(last_bits.dtype)
        cur = last_bits.expand((num_branches,) + tuple(last_bits.shape))
        frames = []
        for t in range(num_frames):
            cur = torch.where(keep[:, t], cur, rand[:, t])
            frames.append(cur)
        bits = torch.stack(frames, dim=1)
        bits[0] = last_bits
        return bits

    return sample


def enumerate_branches(
    generator,
    last_bits,
    num_branches: int,
    num_frames: int,
    sampler: Optional[BranchSampler] = None,
) -> torch.Tensor:
    """Candidate input tensor ``[B, F, P, ...]`` on the host; branch 0 is
    repeat-last."""
    last_bits = torch.as_tensor(np.asarray(last_bits))
    if sampler is None:
        sampler = repeat_last_sampler
    return sampler(generator, last_bits, num_branches, num_frames)


def match_branch(branch_bits, confirmed_bits) -> Tuple[int, int]:
    """Longest-prefix match: which branch predicted the confirmed inputs?

    ``branch_bits[B, F, P, ...]`` against ``confirmed_bits[K, P, ...]``
    (K <= F confirmed frames). Returns ``(branch, depth)``: the branch
    agreeing with the most leading confirmed frames, and how many agree.
    Ties break toward branch 0 (the repeat-last baseline).

    Byte-comparable (integer or bool) tensors take the native prefix
    matcher (one ctypes call, no ``[B, K, ...]`` comparison tensor); other
    dtypes, or ``GGRS_NO_NATIVE=1``, keep the NumPy body. Both are bitwise
    equal (``tests/test_torch_native_spec.py``), as in the JAX package."""
    bb = np.asarray(branch_bits)
    cb = np.asarray(confirmed_bits)
    k = cb.shape[0]
    if k == 0:
        return 0, 0
    got = native_spec.match_prefix(bb, cb)
    if got is not None:
        return got
    return _match_branch_numpy(bb, cb, k)


def _match_branch_numpy(bb: np.ndarray, cb: np.ndarray, k: int) -> Tuple[int, int]:
    eq = bb[:, :k].reshape(bb.shape[0], k, -1) == cb.reshape(1, k, -1)
    frame_ok = eq.all(axis=2)  # [B, K]
    # Depth of agreement = leading run of True per branch.
    depth = np.where(frame_ok.all(axis=1), k, frame_ok.argmin(axis=1))
    best = int(depth.argmax())  # argmax ties break low: branch 0
    return best, int(depth[best])


@dataclasses.dataclass
class SpecResult:
    """One speculative rollout: B branches × F frames from one start state.

    ``rings`` is a ``[B, F]`` stack of rings and ``states`` a ``[B]``
    world; ``checksums[B, F, 2]`` is the per-branch stream of saved-frame
    lanes; ``branch_bits`` (host) is the input tensor that produced it;
    ``start_frame`` labels the first saved frame. Every rollout owns its
    tensors: a later rollout never writes them."""

    rings: SnapshotRing
    states: WorldState
    checksums: torch.Tensor
    branch_bits: Any
    start_frame: int
    num_frames: int
    # On a branch-sharded mesh: the global index of this rank's first
    # branch (``rings``, ``states`` and ``checksums`` hold its block).
    first_branch: int = 0


def _check_start(start_frame: int, num_frames: int) -> None:
    """Refuse a host start frame whose ``num_frames`` frames leave int32."""
    if not -(1 << 31) <= int(start_frame) <= (1 << 31) - num_frames:
        raise ValueError(f"frames from {start_frame} do not fit the ring's int32 frames")


def rollout_branches(schedule: Schedule, state: WorldState, start_frame: int,
                     branch_bits, status, depth: int, shard=None,
                     tracer=null_tracer) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
    """Every branch of ``branch_bits[B, F, ...]`` from the single world
    ``state``: fresh ``[B, depth]`` rings, then (save, advance) × F, the
    semantics of F serial SaveGameState/AdvanceFrame pairs per branch.
    Returns ``(rings, states[B], checksums[B, F, 2])``. ``start_frame`` is
    a host int, range-checked here, or an ``int32[1]`` tensor on
    ``state``'s device (a :class:`RolloutGraph`'s). ``branch_bits`` and
    ``status`` are tensors on ``state``'s device or host arrays, uploaded
    here. The steps run ``rollout.py``'s batched loop with every mask on:
    each frame's save of all B branches takes the branches' frames from a
    device tensor. ``shard`` (an ``EntityShard``): ``state`` is its row
    block, and the saved lanes are the whole world's. ``tracer`` gets a
    ``burst_setup`` span (the uploads, the rings, the broadcast and the
    frames) and the burst's."""
    B, F = int(branch_bits.shape[0]), int(branch_bits.shape[1])
    if not torch.is_tensor(start_frame):
        _check_start(start_frame, F)
    device = state.device
    with tracer.span("burst_setup"):
        branch_bits = torch.as_tensor(branch_bits, device=device)
        status = torch.as_tensor(status, device=device)
        rings = branch_rings(state, B, depth)
        states = broadcast_branches(state, B)
        frames = torch.arange(F, dtype=torch.int32, device=device) + start_frame
        frames = frames[:, None].expand(F, B).contiguous()
    ones = np.ones((B, F), dtype=bool)
    return _slot_steps(schedule, rings, states, frames, branch_bits,
                       status[None].expand((B,) + tuple(status.shape)), ones, ones,
                       shard=shard, tracer=tracer)


def graph_path(device: torch.device, layout) -> bool:
    """Whether :meth:`SpeculativeExecutor.run` replays its rollout as a
    CUDA graph: a world on a CUDA device, a layout with neither a branch
    nor an entity mesh, and no checksum function installed
    (``state.set_checksum_impl``). Read at every call."""
    return (device.type == "cuda" and layout.branch is None and layout.entity is None
            and checksum_impl() is None)


def _structure(tree):
    """A hashable description of a tree's containers and of each tensor's
    dtype and shape."""
    if isinstance(tree, WorldState):
        return tuple((f.name, _structure(getattr(tree, f.name)))
                     for f in dataclasses.fields(WorldState))
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_structure(t) for t in tree)
    if tree is None:
        return None
    return (tree.dtype, tuple(tree.shape))


def rollout_key(schedule: Schedule, state: WorldState, bits: np.ndarray,
                status: np.ndarray, depth: int) -> tuple:
    """What one captured rollout is fixed to: B and F, the ring depth, the
    world's structure (component names, dtypes and shapes, resources), its
    device, the schedule, and the inputs' dtype and shapes. The start
    frame, the start world's values and the tree's values are inputs of
    the graph, not part of its key."""
    return (int(bits.shape[0]), int(bits.shape[1]), int(depth), _structure(state),
            str(state.device), schedule, bits.dtype.str, tuple(bits.shape[2:]),
            tuple(status.shape))


def _capture(body: Callable[[], Any]):
    """``body()`` captured as a CUDA graph: ``(graph, the outputs it
    writes at every replay)``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out


STAGES = 4  # pinned staging buffers of a RolloutGraph, each reused after its copy ran


class RolloutGraph:
    """One rollout of a :func:`rollout_key` captured as a CUDA graph.

    The graph reads static device buffers: the start world, and one byte
    buffer holding the start frame, the status and the branch tree. It
    holds :func:`rollout_branches` itself, run on those buffers:
    :func:`~bevy_ggrs_tpu_torch.state.branch_rings`,
    :func:`~bevy_ggrs_tpu_torch.state.broadcast_branches` of the start
    world, the frames from the start frame's buffer, then F × (one save of
    all B branches, one ``[B]`` schedule step). Each save takes its frames
    from a device tensor (the checksum kernel's per-slot frames), so one
    capture serves every start frame. The graph keeps the systems the
    schedule held at capture: one added later runs only in eager
    rollouts.

    :meth:`capture` runs the rollout once eagerly from its inputs (which
    loads every kernel and fills the step's caches before the capture,
    where a host upload would fail), captures the graph, and returns the
    eager run as the first result. :meth:`replay` copies
    its inputs in with no synchronize: the tree, status and frame through
    one of :data:`STAGES` pinned buffers, each reused only after the event
    of its last copy, the start world device to device. It then replays
    the graph and copies the outputs into tensors of their own, so every
    result owns its memory. A replay adds to each kernel wrapper's
    ``launches`` the launches the graph holds; the capture adds none."""

    def __init__(self, schedule: Schedule, state: WorldState, bits: np.ndarray,
                 status: np.ndarray, depth: int):
        device = state.device
        self.start = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device),
                              state)
        # One byte buffer: the start frame, the status, the tree; each part
        # 8-byte aligned so that it views as its own dtype.
        at, nbytes = [], 0
        for a in (np.zeros(1, np.int32), status, bits):
            at.append((nbytes, a))
            nbytes += -(-a.nbytes // 8) * 8

        def parts(buf, view):
            return tuple(view(buf[o:o + a.nbytes], a) for o, a in at)

        self._inputs = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.frame0, self.status, self.bits = parts(
            self._inputs, lambda b, a: b.view(torch.from_numpy(a).dtype).view(a.shape))
        pin = device.type == "cuda"
        self._stages = []
        for _ in range(STAGES):
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
            views = parts(host.numpy(), lambda b, a: b.view(a.dtype).reshape(a.shape))
            self._stages.append((host, views, torch.cuda.Event() if pin else None))
        self._turn = 0

        captured = Schedule(schedule.systems)  # a replay runs these systems

        def body():  # reads only the static buffers
            return rollout_branches(captured, self.start, self.frame0, self.bits,
                                    self.status, depth)

        self._body = body
        self.graph = self._out = None
        self.launches: Dict[str, int] = {}

    def capture(self, state: WorldState, start_frame: int, bits: np.ndarray,
                status: np.ndarray) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
        """The rollout of ``bits`` from ``state`` at ``start_frame``, run
        eagerly, in memory of its own; then the graph, captured from the
        same buffers."""
        self._load(state, start_frame, bits, status)
        first = _owned(*self._body())
        before = ops.launch_counts()
        self.graph, self._out = _capture(self._body)
        self.launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ops.add_launches({k: -v for k, v in self.launches.items()})
        return first

    def _load(self, state: WorldState, start_frame: int, bits: np.ndarray,
              status: np.ndarray) -> None:
        _check_start(start_frame, bits.shape[1])
        host, (frame0, st, tree), done = self._stages[self._turn]
        self._turn = (self._turn + 1) % len(self._stages)
        if done is not None:
            done.synchronize()  # the copy that last read this buffer has run
        frame0[0] = start_frame
        np.copyto(st, status)
        np.copyto(tree, bits)
        self._inputs.copy_(host, non_blocking=True)
        if done is not None:
            done.record()
        tree_map(lambda d, s: d.copy_(s), self.start, state)

    def replay(self, state: WorldState, start_frame: int, bits: np.ndarray,
               status: np.ndarray) -> Tuple[SnapshotRing, WorldState, torch.Tensor]:
        """The rollout of ``bits`` from ``state`` at ``start_frame``:
        ``(rings, states, checksums)`` in memory of their own."""
        self._load(state, start_frame, bits, status)
        self.graph.replay()
        ops.add_launches(self.launches)
        return _owned(*self._out)


def _owned(rings: SnapshotRing, states: WorldState, checksums: torch.Tensor):
    """Copies of a rollout's outputs: the graph's are rewritten at every
    replay, and at B = 1 a leaf no step writes is the start buffer itself."""
    return clone_ring(rings), tree_map(torch.clone, states), checksums.clone()


class SpeculativeExecutor:
    """B-branch × F-frame rollout bound to one schedule and shape.

    With ``mesh`` alone the branches split over its ``branch_axis``; with
    ``entity_axis`` (and a ``state_template``, the whole world) each
    world's entity axis splits too; ``layout`` passes a session's shared
    :class:`~bevy_ggrs_tpu_torch.parallel.sharding.MeshLayout` instead.
    Every rank runs :meth:`run` with the same full branch tensor and the
    same start state (whole, or its rows), and :meth:`commit` on every
    rank gives the same committed branch.

    Where :func:`graph_path` holds, :meth:`run` captures a
    :class:`RolloutGraph` on its first call for a :func:`rollout_key`
    (``graph_captures``, span ``spec_graph_capture``) and replays it on
    every later call with that key (``graph_replays``, span
    ``spec_graph_replay``). Elsewhere it runs :func:`rollout_branches`
    (``eager_runs``), and ``tracer`` gets a ``spec_branch_dispatch`` span
    a call, holding the burst's ``burst_setup``, ``burst_save`` and
    ``burst_step`` spans. Both run one body, :func:`rollout_branches`,
    captured or eagerly. A replay keeps the schedule's systems as they
    were at its key's capture (the key holds the schedule by identity):
    a system added to the schedule afterwards (``Schedule.add_system``)
    runs in eager rollouts at once but in no replay, as the JAX package's
    executor, jitted once, keeps its first trace."""

    def __init__(self, schedule: Schedule, num_branches: int, max_frames: int,
                 mesh=None, branch_axis: str = "branch", entity_axis: Optional[str] = None,
                 state_template: Optional[WorldState] = None, tracer=None, layout=None):
        from bevy_ggrs_tpu_torch.parallel.sharding import MeshLayout

        if layout is None:
            layout = MeshLayout(schedule, num_branches, mesh, branch_axis, entity_axis,
                                state_template)
        self.layout = layout
        self.schedule = self.layout.schedule
        self.num_branches = int(num_branches)
        self.max_frames = int(max_frames)
        self.tracer = tracer if tracer is not None else null_tracer
        self._graphs: Dict[tuple, RolloutGraph] = {}
        self.graph_captures = 0
        self.graph_replays = 0
        self.eager_runs = 0

    def run(self, state: WorldState, start_frame: int, branch_bits,
            status=None) -> SpecResult:
        """Roll all branches forward from ``state`` at ``start_frame``.
        ``branch_bits[B, F, P, ...]`` (see :func:`enumerate_branches`);
        ``status[F, P]`` defaults to all PREDICTED (speculative frames are
        unconfirmed)."""
        host_bits = np.ascontiguousarray(np.asarray(branch_bits))
        b, f = host_bits.shape[0], host_bits.shape[1]
        local = self.layout.local_bits(host_bits)
        if b not in (self.num_branches, local.shape[0]) or f != self.max_frames:
            raise ValueError(f"branch_bits [{b}, {f}, ...] != configured "
                             f"[{self.num_branches}, {self.max_frames}, ...]")
        state = self.layout.local_world(state)
        if status is None:
            status = np.full((f, host_bits.shape[2]), PREDICTED, dtype=np.int32)
        local = np.ascontiguousarray(local)
        status = np.ascontiguousarray(np.asarray(status, np.int32))
        start_frame = int(start_frame)
        if graph_path(state.device, self.layout):
            key = rollout_key(self.schedule, state, local, status, self.max_frames)
            graph = self._graphs.get(key)
            if graph is None:
                with self.tracer.span("spec_graph_capture", branches=b, frames=f):
                    graph = RolloutGraph(self.schedule, state, local, status, self.max_frames)
                    rings, states, checksums = graph.capture(state, start_frame, local,
                                                             status)
                self._graphs[key] = graph
                self.graph_captures += 1
            else:
                with self.tracer.span("spec_graph_replay", branches=b, frames=f):
                    rings, states, checksums = graph.replay(state, start_frame, local,
                                                            status)
                self.graph_replays += 1
        else:
            with self.tracer.span("spec_branch_dispatch", branches=b, frames=f):
                rings, states, checksums = rollout_branches(
                    self.schedule, state, start_frame, local, status, self.max_frames,
                    self.layout.entity, self.tracer)
            self.eager_runs += 1
        return SpecResult(rings=rings, states=states, checksums=checksums,
                          branch_bits=host_bits, start_frame=start_frame,
                          num_frames=f, first_branch=self.layout.first_branch)

    def commit(self, result: SpecResult, branch: int):
        """Copies of branch ``branch``'s ring and state (on a
        branch-sharded mesh, broadcast on every rank from the rank that
        owns the branch)."""
        with self.tracer.span("spec_branch_commit"):
            if self.layout.branch is None:
                return select_branch(result.rings, branch), select_branch(result.states, branch)
            return self.layout.select((result.rings, result.states), branch)


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def merge_rings(main: SnapshotRing, spec: SnapshotRing) -> SnapshotRing:
    """Overlay the saved rows of ``spec`` (a committed speculative ring)
    onto the session's ring ``main``, in place, and return ``main``: rows
    ``spec`` saved (``frames >= 0``) win; the others keep ``main``'s
    history. The rings must share their depth."""
    if main.depth != spec.depth:
        raise ValueError(f"ring depth mismatch: {main.depth} != {spec.depth}")
    take = spec.frames >= 0

    def sel(m, s):
        mask = take.reshape((-1,) + (1,) * (s.dim() - 1))
        # torch's unsigned 32-bit type has no ``where``: select its bits.
        bits = _SIGNED.get(m.dtype)
        if bits is not None:
            m, s = m.view(bits), s.view(bits)
        m.copy_(torch.where(mask, s, m))

    tree_map(sel, main.states, spec.states)
    main.frames.copy_(torch.where(take, spec.frames, main.frames))
    main.checksums.copy_(torch.where(take[:, None], spec.checksums, main.checksums))
    return main
