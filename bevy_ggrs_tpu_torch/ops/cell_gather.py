"""Grid-mode per-cell interactions through the hand-written CUDA kernel.

Counterpart of ``bevy_ggrs_tpu/ops/cell_gather.py``'s
``cell_slot_forces_pallas``: each cell's K slot rows against the M
candidates gathered for it, the ``PairKernel``'s ``n_terms`` sums over the
candidates, then its combine. The kernel is ``csrc/cell_gather.cu``, a
template with one instantiation per pair kernel, found through the
``PairKernel``'s ``name``; :func:`cell_slot_forces_plain` is its plain
PyTorch version, taken for CPU tensors and by ``neighbor.slot_forces``'s
``impl="xla"`` on any device.

The kernel walks only the live pairs: a pair kernel's instantiation may
skip inactive rows and candidates whose terms are all ±0 (boids' does).
It sums each row's candidates in one order fixed by the inputs without
atomics, so it is bitwise equal to itself from launch to launch; against
its plain version and the JAX paths it is allclose (another summation
order, and CUDA's ``rsqrtf``).

Tables may carry a leading branch axis, ``[B, C, K]`` rows and ``[B, C,
M]`` candidates (boids under speculation), with outputs ``[B, C, K]``.
The kernel takes them stacked feature first, ``[5, B, C, K]`` and ``[5,
B, C, M]`` (what ``torch.stack`` of the per-feature tables gives, so a
branch is just C more cells), as one launch with the branch in
``blockIdx.y``; each branch's outputs are bitwise its unbatched launch's.
The plain version takes a branch at a time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from bevy_ggrs_tpu_torch.ops import _build

# Pair elements ([cells, K, M]) per chunk of the plain version: at the
# boids-32,768 grid a whole [C, K, M] intermediate is 184.5 M floats, and
# the terms hold about fifteen of them. Chunks of cells give the same
# values, since every cell's sums are its own.
_PLAIN_CHUNK_PAIRS = 1 << 22

# Cell-kernel instantiations: PairKernel name -> C symbol, and the row and
# column feature order it reads.
_INSTANTIATIONS = {
    "flock": ("ggrs_cell_slot_forces_flock",
              ("px", "py", "active", "vx", "vy"),
              ("px", "py", "active", "vx", "vy")),
}


def cell_slot_forces_plain(kernel, rowvals: Dict[str, torch.Tensor],
                           colvals: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the cell kernel: ``out_dim`` tensors
    ``[C, K]`` from ``rowvals`` (``[C, K]`` per row name) and ``colvals``
    (``[C, M]`` per column name), the pair terms broadcast over
    ``[cells, K, M]`` for a chunk of cells at a time. Tables with a leading
    branch axis take a branch at a time, outputs ``[B, C, K]``."""
    if rowvals["px"].dim() == 3:
        per = [cell_slot_forces_plain(kernel, {n: v[b] for n, v in rowvals.items()},
                                      {n: v[b] for n, v in colvals.items()})
               for b in range(rowvals["px"].shape[0])]
        return tuple(torch.stack(outs) for outs in zip(*per))
    c, k = rowvals["px"].shape
    m = colvals["px"].shape[1]
    step = max(1, _PLAIN_CHUNK_PAIRS // max(1, k * m))
    outs = []
    for c0 in range(0, c, step):
        rv = {name: rowvals[name][c0:c0 + step].to(torch.float32)
              for name in kernel.row_names}
        row = {name: v[:, :, None] for name, v in rv.items()}
        col = {name: colvals[name][c0:c0 + step, None, :].to(torch.float32)
               for name in kernel.col_names}
        dx = row["px"] - col["px"]
        dy = row["py"] - col["py"]
        d2 = dx * dx + dy * dy
        terms = kernel.accumulate(dx, dy, d2, row, col)
        sums = tuple(t.sum(dim=2) for t in terms)
        outs.append(kernel.combine(sums, rv))
    return tuple(torch.cat(parts) for parts in zip(*outs))


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def cell_slot_forces(kernel, rowvals: Dict[str, torch.Tensor],
                     colvals: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    """Per-cell interaction outputs, ``out_dim`` tensors ``[C, K]`` (``[B,
    C, K]`` for tables with a leading branch axis), for a
    :class:`~bevy_ggrs_tpu_torch.ops.neighbor.PairKernel`.

    A CPU tensor takes :func:`cell_slot_forces_plain`; a CUDA tensor
    launches the pair kernel's instantiation of ``csrc/cell_gather.cu``
    once on the current stream, over every branch, and a pair kernel
    without one, or anything else the kernel cannot take, raises."""
    px = rowvals["px"]
    if px.dim() not in (2, 3):
        raise ValueError(f"row px must be [C, K] or [B, C, K], got {list(px.shape)}")
    lead = tuple(px.shape[:-2])
    c, k = px.shape[-2:]
    m = colvals["px"].shape[-1]
    device = px.device
    arrays = ([(f"row {n}", rowvals[n], lead + (c, k)) for n in kernel.row_names]
              + [(f"col {n}", colvals[n], lead + (c, m)) for n in kernel.col_names])
    for name, t, shape in arrays:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
    if device.type == "cpu":
        return cell_slot_forces_plain(kernel, rowvals, colvals)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    inst = _INSTANTIATIONS.get(kernel.name)
    if inst is None:
        raise ValueError(f"the cell kernel has no instantiation for pair "
                         f"kernel {kernel.name!r}")
    symbol, row_names, col_names = inst
    if (kernel.row_names, kernel.col_names) != (row_names, col_names):
        raise ValueError(f"pair kernel {kernel.name!r} does not read the "
                         f"features of its instantiation")
    b = lead[0] if lead else 1
    if min(b, c, k, m) == 0:
        raise ValueError(f"empty grid B={b} C={c} K={k} M={m}")
    rows = torch.stack([rowvals[n] for n in row_names])  # [5, (B,) C, K]
    cols = torch.stack([colvals[n] for n in col_names])  # [5, (B,) C, M]
    out = torch.empty((kernel.out_dim,) + lead + (c, k), dtype=torch.float32,
                      device=device)
    fn = _build.function("cell_gather", symbol, _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), out.data_ptr(), b, c, k, m,
                 *kernel.params, stream)
    _build.check(err, "cell_slot_forces")
    cell_slot_forces.launches += 1
    return tuple(out)


cell_slot_forces.launches = 0
