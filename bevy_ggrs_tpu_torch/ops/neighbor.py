"""Deterministic spatial-binning neighbour grid: O(N·k) pair interactions.

Counterpart of ``bevy_ggrs_tpu/ops/neighbor.py``. Entities are binned into
a fixed-shape grid of ``G × G`` cells and interact only with the nine
cells around their own, so a frame costs ``N·(9K + S)`` pairs instead of
``N²``, with every shape fixed by the :class:`GridConfig`.

Binning is integer work and bitwise equal to the JAX package's:

- cell id = ``(floor(y/s) mod G)·G + (floor(x/s) mod G)``, the scale taken
  as the float32 ``1/s`` and the modulo a floor modulo, as ``jnp``'s ``%``;
- entities are ordered by a stable argsort of their cell id (ties by
  entity index), then ranked in their cell by ``searchsorted``; rank < K
  takes slot ``(cell, rank)``, rank ≥ K spills, in the same order, to a
  spill row of S entries that every cell sees; past that they are dropped
  and counted;
- inactive entities bin to the sentinel cell C and reach neither slots
  nor spill.

JAX's ``.at[idx].set(..., mode="drop")`` becomes a write into a buffer one
row longer, whose sentinel row is sliced off: only sentinel writes repeat
an index, and they land in the discarded row. Nothing here reads a value
back to the host, so a frame on the card never waits for it.

The per-cell compute goes through the hand-written cell kernel
(:func:`bevy_ggrs_tpu_torch.ops.cell_gather.cell_slot_forces`) with
``impl="pallas"``, and through its plain version on any device with
``impl="xla"``. The spill pass and the scatter back to entity order are
plain PyTorch, as JAX computes them in XLA outside any kernel. Grid and
dense forces are allclose, not bitwise: the sums run in another order.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops.cell_gather import (
    cell_slot_forces,
    cell_slot_forces_plain,
)
from bevy_ggrs_tpu_torch.ops.pairwise import check_no_branch_axis

# Grid mode pays a sort and gathers per frame; below this entity count the
# dense paths win outright (mode="auto" crossover).
GRID_AUTO_THRESHOLD = 2048

_VALID_MODES = ("dense", "grid", "auto")

# Process-wide default, consulted below the GGRS_FORCE_MODE override and
# above the by-N auto rule whenever a schedule was built without a mode.
_session_default_mode: Optional[str] = None


def set_default_interaction_mode(mode: Optional[str]) -> None:
    """Install the process-wide default ``interact`` mode (``None`` clears
    it)."""
    global _session_default_mode
    if mode is not None and mode not in _VALID_MODES:
        raise ValueError(f"mode must be one of {_VALID_MODES}, got {mode!r}")
    _session_default_mode = mode


def resolve_mode(mode: Optional[str], n: int) -> str:
    """Resolve a requested interaction mode to ``"dense"`` or ``"grid"``.

    Precedence: an explicit ``"dense"``/``"grid"`` always wins; the
    ``GGRS_FORCE_MODE`` environment variable overrides ``None`` and
    ``"auto"``; then the default of :func:`set_default_interaction_mode`;
    then ``"auto"`` picks grid at ``n >= GRID_AUTO_THRESHOLD``, while
    ``None`` keeps dense."""
    if mode not in _VALID_MODES and mode is not None:
        raise ValueError(f"mode must be one of {_VALID_MODES}, got {mode!r}")
    if mode in ("dense", "grid"):
        return mode
    env = os.environ.get("GGRS_FORCE_MODE", "").strip().lower()
    if env in ("dense", "grid"):
        return env
    if _session_default_mode in ("dense", "grid"):
        return _session_default_mode
    if mode == "auto" or _session_default_mode == "auto":
        return "grid" if n >= GRID_AUTO_THRESHOLD else "dense"
    return "dense"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Fixed shape of the neighbour grid."""

    cell_size: float      # s: cell edge, at least the interaction radius
    grid_dim: int         # G: cells per axis (>= 4), C = G*G cells
    cell_capacity: int    # K: slots per cell; rank >= K spills
    spill_capacity: int   # S: spill rows shared by all cells

    def __post_init__(self):
        if self.grid_dim < 4:
            raise ValueError("grid_dim must be >= 4 (nine neighbor offsets "
                             "must stay distinct mod G)")
        if self.cell_capacity < 1 or self.spill_capacity < 1:
            raise ValueError("cell_capacity and spill_capacity must be >= 1")

    @property
    def num_cells(self) -> int:
        return self.grid_dim * self.grid_dim

    @property
    def cols(self) -> int:
        """Candidate columns per cell: 9 neighbour cells + the spill row."""
        return 9 * self.cell_capacity + self.spill_capacity

    @property
    def padded_cols(self) -> int:
        """``cols`` rounded up to 128 with sentinel entries, as in JAX."""
        return _round_up(self.cols, 128)


def default_grid_config(n: int, radius: float,
                        world_half: float) -> GridConfig:
    """The grid for an ``n``-entity world of extent ±``world_half``: cell
    edge = ``radius``; G the power of two covering the span, in [4, 64]; K
    twice the uniform mean occupancy, a multiple of 8 in [16, 512]; S =
    ``n`` clamped to [64, 512], so worlds with ``n <= K + S`` never drop."""
    span = 2.0 * float(world_half)
    g = min(max(_next_pow2(int(np.ceil(span / float(radius)))), 4), 64)
    mean_occ = max(1, int(np.ceil(n / float(g * g))))
    k = min(max(_round_up(2 * mean_occ, 8), 16), 512)
    s = max(64, min(n, 512))
    return GridConfig(cell_size=float(radius), grid_dim=g,
                      cell_capacity=k, spill_capacity=s)


@functools.lru_cache(maxsize=None)
def neighbor_table(grid_dim: int) -> np.ndarray:
    """``int32[C, 9]``: the nine neighbour cells (self included) of every
    cell, wrapped modulo G."""
    g = grid_dim
    cy, cx = np.divmod(np.arange(g * g, dtype=np.int64), g)
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    tbl = np.stack(
        [((cy + dy) % g) * g + ((cx + dx) % g) for dy, dx in offs], axis=1
    )
    return tbl.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _neighbor_table_on(grid_dim: int, device: str) -> torch.Tensor:
    return torch.from_numpy(neighbor_table(grid_dim)).long().to(device)


class NeighborGrid(NamedTuple):
    """Binning result. ``slots``/``spill`` hold entity indices with N as
    the empty sentinel."""

    slots: torch.Tensor      # int32[C, K], N = empty
    spill: torch.Tensor      # int32[S], N = empty
    cell_of: torch.Tensor    # int32[N] cell id; C for inactive
    occupancy: torch.Tensor  # int32[C] true per-cell count (with overflow)
    n_spilled: torch.Tensor  # int32[] entities past K (spilled or dropped)
    n_dropped: torch.Tensor  # int32[] entities past K + S (lost)


def bin_entities(pos: torch.Tensor, active: torch.Tensor,
                 config: GridConfig) -> NeighborGrid:
    """Stable sort-based binning (see the module docstring)."""
    n = pos.shape[0]
    device = pos.device
    g, c = config.grid_dim, config.num_cells
    k, s = config.cell_capacity, config.spill_capacity
    active_b = active.to(torch.bool)

    inv = float(np.float32(1.0 / config.cell_size))
    ix = torch.floor(pos[:, 0].to(torch.float32) * inv).to(torch.int32) % g
    iy = torch.floor(pos[:, 1].to(torch.float32) * inv).to(torch.int32) % g
    cell_of = torch.where(active_b, iy * g + ix, c).to(torch.int32)

    # Stable order: by cell, ties by entity index.
    order = torch.argsort(cell_of, stable=True)
    order32 = order.to(torch.int32)
    sorted_cell = cell_of[order]
    run_start = torch.searchsorted(sorted_cell, sorted_cell, side="left")
    rank = torch.arange(n, dtype=torch.int32, device=device) - run_start.to(torch.int32)

    in_cell = sorted_cell < c
    slotted = in_cell & (rank < k)
    slot_idx = torch.where(slotted, sorted_cell * k + rank, c * k).long()
    slots = torch.full((c * k + 1,), n, dtype=torch.int32, device=device)
    slots[slot_idx] = order32
    slots = slots[:c * k].reshape(c, k)

    over = in_cell & (rank >= k)
    spill_rank = torch.cumsum(over.to(torch.int32), 0).to(torch.int32) - 1
    spill_idx = torch.where(over & (spill_rank < s), spill_rank, s).long()
    spill = torch.full((s + 1,), n, dtype=torch.int32, device=device)
    spill[spill_idx] = order32
    spill = spill[:s]

    cells = torch.arange(c, dtype=torch.int32, device=device)
    occupancy = (
        torch.searchsorted(sorted_cell, cells + 1, side="left")
        - torch.searchsorted(sorted_cell, cells, side="left")
    ).to(torch.int32)
    n_spilled = over.sum(dtype=torch.int32)
    n_dropped = torch.clamp(n_spilled - s, min=0)
    return NeighborGrid(slots, spill, cell_of, occupancy, n_spilled,
                        n_dropped)


# ---------------------------------------------------------------------------
# The model-facing pair-interaction API
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PairKernel:
    """A pairwise interaction, factored so one definition drives the dense
    path, the plain grid path and the cell kernel.

    ``accumulate(dx, dy, d2, row, col)`` returns ``n_terms`` per-pair
    tensors that are summed over the candidates; every term carries its own
    masks (sentinel candidates arrive with active 0 and zero positions).
    ``combine(sums, row)`` turns the sums into ``out_dim`` outputs and
    multiplies by ``row["active"]``. ``row``/``col`` map ``"px"``, ``"py"``,
    ``"active"`` and the declared features to broadcastable tensors;
    ``radius`` bounds the interaction, and grid cells are at least this
    wide.

    ``name`` and ``params`` tie the interaction to its instantiation of the
    cell kernel (``csrc/cell_gather.cu``): the instantiation's name and the
    floats it reads, in its order. A pair kernel without one runs the
    plain grid path only; the cell kernel refuses it."""

    radius: float
    out_dim: int
    n_terms: int
    accumulate: Callable
    combine: Callable
    row_feats: Tuple[str, ...] = ()
    col_feats: Tuple[str, ...] = ()
    name: str = ""
    params: Tuple[float, ...] = ()

    @property
    def row_names(self) -> Tuple[str, ...]:
        return ("px", "py", "active") + tuple(self.row_feats)

    @property
    def col_names(self) -> Tuple[str, ...]:
        return ("px", "py", "active") + tuple(self.col_feats)


def _entity_arrays(pos, active_f, feats) -> Dict[str, torch.Tensor]:
    base = {
        "px": pos[:, 0].to(torch.float32),
        "py": pos[:, 1].to(torch.float32),
        "active": active_f,
    }
    for name, v in (feats or {}).items():
        base[name] = v.to(torch.float32)
    return base


def build_grid_tables(pos, active, config: GridConfig,
                      feats: Optional[Dict[str, torch.Tensor]] = None):
    """Bin, then assemble what every grid consumer gathers from: the
    binning result, the ``[C, padded_cols]`` candidate table (the nine
    neighbour cells' slots and the spill row, sentinel-padded) and the
    per-entity arrays with one extra row N of zeros, so that every
    sentinel gather lands on an inactive entry."""
    n = pos.shape[0]
    active_f = active.to(torch.float32)
    grid = bin_entities(pos, active, config)
    c, k, s = config.num_cells, config.cell_capacity, config.spill_capacity
    tbl = _neighbor_table_on(config.grid_dim, str(pos.device))  # [C, 9]
    parts = [grid.slots[tbl].reshape(c, 9 * k), grid.spill[None, :].expand(c, s)]
    pad = config.padded_cols - config.cols
    if pad:
        parts.append(torch.full((c, pad), n, dtype=torch.int32, device=pos.device))
    cand = torch.cat(parts, dim=1)
    padded = {
        name: torch.cat([v, v.new_zeros(1)])
        for name, v in _entity_arrays(pos, active_f, feats).items()
    }
    return grid, cand, padded


def slot_forces(kernel: PairKernel, slots, cand, padded,
                impl: str = "xla") -> torch.Tensor:
    """``[Cb, K, out_dim]`` interaction outputs for a block of cells.
    ``impl="pallas"`` names the JAX package's cell kernel, whose
    counterpart here is the CUDA cell kernel; ``impl="xla"`` runs its plain
    version on any device. Sentinel rows compute values that their
    active 0 zeroes and the scatter drops."""
    rowvals = {name: padded[name][slots] for name in kernel.row_names}
    colvals = {name: padded[name][cand] for name in kernel.col_names}
    if impl == "pallas":
        outs = cell_slot_forces(kernel, rowvals, colvals)
    elif impl == "xla":
        outs = cell_slot_forces_plain(kernel, rowvals, colvals)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return torch.stack(outs, dim=-1)


def _pair_outputs(kernel: PairKernel, rowvals, col) -> torch.Tensor:
    """Rows ``[R]`` against broadcast columns ``[1, N]``: summed terms,
    then the combine, as ``[R, out_dim]``."""
    row = {k2: v[:, None] for k2, v in rowvals.items()}
    dx = row["px"] - col["px"]
    dy = row["py"] - col["py"]
    d2 = dx * dx + dy * dy
    terms = kernel.accumulate(dx, dy, d2, row, col)
    sums = tuple(t.sum(dim=1) for t in terms)
    return torch.stack(kernel.combine(sums, rowvals), dim=-1)


def spill_forces(kernel: PairKernel, spill, padded) -> torch.Tensor:
    """``[S, out_dim]``: spilled entities against every entity, a dense
    ``[S, N]`` pass, so an overflow costs time, never values."""
    rowvals = {name: padded[name][spill] for name in kernel.row_names}
    col = {name: padded[name][None, :] for name in kernel.col_names}
    return _pair_outputs(kernel, rowvals, col)


def scatter_forces(n: int, slots, spill, slot_f, spill_f) -> torch.Tensor:
    """Per-slot and per-spill outputs back to entity order. Sentinel
    indices (N) land in a discarded extra row; untouched rows (inactive or
    dropped entities) stay exactly 0."""
    out_dim = slot_f.shape[-1]
    out = slot_f.new_zeros((n + 1, out_dim))
    out[slots.reshape(-1).long()] = slot_f.reshape(-1, out_dim)
    out[spill.long()] = spill_f
    return out[:n]


def _interact_dense(pos, active_f, kernel: PairKernel, feats) -> torch.Tensor:
    arrays = _entity_arrays(pos, active_f, feats)
    rowvals = {name: arrays[name] for name in kernel.row_names}
    col = {name: arrays[name][None, :] for name in kernel.col_names}
    return _pair_outputs(kernel, rowvals, col)


def interact(pos, active, kernel: PairKernel,
             feats: Optional[Dict[str, torch.Tensor]] = None, *,
             mode: Optional[str] = None, config: Optional[GridConfig] = None,
             impl: str = "xla", world_half: Optional[float] = None,
             return_grid: bool = False):
    """Evaluate a pairwise interaction over all entities.

    ``pos`` ``[N, 2]``, ``active`` ``[N]`` (bool or 0/1 float), ``feats``
    maps feature names to ``[N]`` tensors. ``mode`` resolves through
    :func:`resolve_mode`; grid mode needs a :class:`GridConfig` or
    ``world_half`` to derive one, and ``impl`` picks the per-cell compute
    (:func:`slot_forces`). Returns ``[N, out_dim]``; with
    ``return_grid=True``, ``(forces, NeighborGrid or None)``. ``pos`` with
    a leading branch axis raises ``NotImplementedError``."""
    check_no_branch_axis("pos", pos, 2)
    n = pos.shape[0]
    active_f = active.to(torch.float32)
    m = resolve_mode(mode, n)
    if m == "dense":
        out = _interact_dense(pos, active_f, kernel, feats)
        return (out, None) if return_grid else out
    if config is None:
        if world_half is None:
            raise ValueError("grid mode needs config= or world_half=")
        config = default_grid_config(n, kernel.radius, world_half)
    if config.cell_size < kernel.radius:
        raise ValueError(
            f"cell_size {config.cell_size} < interaction radius "
            f"{kernel.radius}: the 9-cell neighborhood would miss pairs"
        )
    grid, cand, padded = build_grid_tables(pos, active_f, config, feats)
    slot_f = slot_forces(kernel, grid.slots, cand, padded, impl=impl)
    spill_f = spill_forces(kernel, grid.spill, padded)
    out = scatter_forces(n, grid.slots, grid.spill, slot_f, spill_f)
    return (out, grid) if return_grid else out


def grid_stats(pos, active, config: GridConfig) -> dict:
    """Host-side summary of one binning: occupancy, slot utilisation, and
    the spill and drop counts that say whether K and S were big enough.
    Reads the result back to the host."""
    pos = torch.as_tensor(pos)
    active = torch.as_tensor(active)
    grid = bin_entities(pos, active, config)
    occ = grid.occupancy.cpu().numpy()
    n = int(active.to(torch.bool).sum())
    spilled = int(grid.n_spilled)
    return {
        "grid_dim": config.grid_dim,
        "cell_capacity": config.cell_capacity,
        "spill_capacity": config.spill_capacity,
        "padded_cols": config.padded_cols,
        "occupancy_mean": round(float(occ.mean()), 2),
        "occupancy_p99": int(np.percentile(occ, 99)),
        "occupancy_max": int(occ.max()),
        "slot_utilization": round(
            (n - spilled) / float(config.num_cells * config.cell_capacity), 4
        ),
        "spilled": spilled,
        "spill_rate": round(spilled / n, 6) if n else 0.0,
        "dropped": int(grid.n_dropped),
    }
