"""PyTorch port, the designs of the cell kernel and the general tensor-core
kernel, checked where the CPU can check them: float32 numpy emulations of
what ``csrc/cell_gather.cu`` and ``csrc/pairwise_mxu.cu`` compute, held
against the port's plain versions and the JAX package, and the
tensor-core kernel's launch shape.

- The cell kernel walks only the live candidates of each tile, in order.
  Every ``FlockPair`` term carries ``row.active * col.active`` and the sums
  start at +0, so an inactive candidate adds +0 or -0 and leaves every sum's
  bits unchanged: the compacted walk is bitwise the full walk.
- The kernel's own order (each live row's compacted list cut into S
  contiguous ranges per tile, the S partial sums added in ascending order)
  is another order of the same f32 terms: ``atol=1e-5`` against the plain
  version and JAX, the JAX suite's grid tolerance.
- The tensor-core kernel builds its bf16 hi/lo features itself, with
  round-to-nearest-even conversions; they are bitwise the wrapper's
  ``_lane_feats`` and JAX's.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops import cell_gather as jcg
from bevy_ggrs_tpu.ops import pairwise as jpw
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import pairwise as tpw

CELL_ATOL = 1e-5
F32 = np.float32
KERNEL = tboids.FLOCK_PAIR_KERNEL
NR2, SR2, WS, WA, WC = (F32(p) for p in KERNEL.params)

# --- the cell kernel's walk, emulated in float32


def cell_inputs(seed, active_share, k=24, m=300):
    """One cell: ``k`` slot rows and ``m`` candidates, every feature
    ``[1, n]`` float32. Candidates spread over twice the neighbour radius
    around the rows, so some lie beyond it on either side (negative dx and
    positive); a share ``active_share`` of them, and 3/4 of the rows, are
    live, the inactive ones inside the list, not only at its tail."""
    rng = np.random.RandomState(seed)

    def feats(n, share):
        active = (rng.rand(n) < share).astype(F32)
        return {"px": rng.uniform(-2, 2, n).astype(F32),
                "py": rng.uniform(-2, 2, n).astype(F32),
                "active": active,
                "vx": rng.uniform(-0.05, 0.05, n).astype(F32),
                "vy": rng.uniform(-0.05, 0.05, n).astype(F32)}

    rows, cols = feats(k, 0.75), feats(m, active_share)
    cols["px"][:4] = rows["px"][:4]  # self pairs: d2 = 0 < 1e-10
    cols["py"][:4] = rows["py"][:4]
    return rows, cols


def accumulate(acc, row, col, j):
    """``FlockPair::accumulate`` for candidate ``j`` against every row, one
    float32 rounding per operation, in the kernel's order."""
    dx = row["px"] - col["px"][j]
    dy = row["py"] - col["py"][j]
    d2 = dx * dx + dy * dy
    both = row["active"] * col["active"][j]
    is_self = (d2 < F32(1e-10)).astype(F32)
    neigh = both * (d2 < NR2).astype(F32) * (F32(1) - is_self)
    inv_d = F32(1) / np.sqrt(np.maximum(d2, F32(1e-12)))
    close = neigh * (d2 < SR2).astype(F32)
    w = inv_d * close
    for t, term in enumerate((neigh, dx * w, dy * w, col["vx"][j] * neigh,
                              col["vy"][j] * neigh, col["px"][j] * neigh,
                              col["py"][j] * neigh)):
        acc[t] += term


def walk(row, col, order):
    acc = np.zeros((7, row["px"].size), F32)
    for j in order:
        accumulate(acc, row, col, j)
    return acc


def _constant(name):
    """An ``int`` constant of ``csrc/cell_gather.cu``, so that the emulation
    follows the kernel's source."""
    src = (pathlib.Path(tcg.__file__).parent.parent / "csrc" / "cell_gather.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


THREADS, TILE = _constant("kThreads"), _constant("kTile")


def kernel_walk(row, col, tile=TILE, threads=THREADS):
    """The kernel's order for one chunk of rows: S = threads // W threads
    walk each live row, W the live rows rounded up to a warp; split s
    walks the s-th contiguous range of each tile's compacted candidates;
    the S partials are added in ascending s. Rows the kernel skips get
    zeros."""
    live = np.flatnonzero(row["active"] != 0)
    acc = np.zeros((7, row["px"].size), F32)
    if live.size == 0:  # the chunk walks nothing
        return acc
    sub = {name: v[live] for name, v in row.items()}
    splits = threads // (-(-live.size // 32) * 32)
    parts = np.zeros((splits, 7, live.size), F32)
    m = col["px"].size
    for base in range(0, m, tile):
        kept = [base + j for j in range(min(tile, m - base)) if col["active"][base + j] != 0]
        n = len(kept)
        for s in range(splits):
            for j in kept[n * s // splits:n * (s + 1) // splits]:
                accumulate(parts[s], sub, col, j)
    acc[:, live] = parts[0]
    for s in range(1, splits):
        acc[:, live] += parts[s]
    return acc


def combine(acc, row):
    """``FlockPair::combine``; a row the kernel skips writes zero."""
    n_safe = np.maximum(acc[0], F32(1))
    has = (acc[0] > 0).astype(F32)
    fx = (WS * acc[1] + WA * (acc[3] / n_safe - row["vx"]) * has
          + WC * (acc[5] / n_safe - row["px"]) * has)
    fy = (WS * acc[2] + WA * (acc[4] / n_safe - row["vy"]) * has
          + WC * (acc[6] / n_safe - row["py"]) * has)
    live = row["active"] != 0
    return np.where(live, fx * row["active"], F32(0)), np.where(live, fy * row["active"], F32(0))


SHARES = [0.0, 0.1, 0.5, 1.0]


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compacted_walk_is_bitwise_the_full_walk(seed, share):
    row, col = cell_inputs(seed, share)
    full = walk(row, col, range(col["px"].size))
    compacted = walk(row, col, np.flatnonzero(col["active"] != 0))
    assert np.array_equal(full.view(np.uint32), compacted.view(np.uint32))
    # The inputs reach the cases that matter: -0 terms from candidates
    # beyond the radius with negative dx, and live neighbours.
    dx = row["px"][:, None] - col["px"][None, :]
    d2 = dx * dx + (row["py"][:, None] - col["py"][None, :]) ** 2
    assert ((dx < 0) & (d2 >= NR2)).any()
    if share > 0:
        assert full[0].max() > 0


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_matches_the_plain_version(seed, share):
    row, col = cell_inputs(seed, share)
    got = combine(kernel_walk(row, col, tile=128), row)
    rowvals = {n: torch.from_numpy(v[None, :]) for n, v in row.items()}
    colvals = {n: torch.from_numpy(v[None, :]) for n, v in col.items()}
    want = tcg.cell_slot_forces_plain(KERNEL, rowvals, colvals)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w[0].numpy(), rtol=0, atol=CELL_ATOL)
    # The emulation's sequential combine agrees too.
    seq = combine(walk(row, col, range(col["px"].size)), row)
    for g, w in zip(seq, want):
        np.testing.assert_allclose(g, w[0].numpy(), rtol=0, atol=CELL_ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_order_matches_jax(seed):
    row, col = cell_inputs(seed, 0.5)
    got = combine(kernel_walk(row, col, tile=128), row)
    want = jcg.cell_slot_forces_pallas(
        jboids.FLOCK_PAIR_KERNEL,
        {n: jnp.asarray(v[None, :]) for n, v in row.items()},
        {n: jnp.asarray(v[None, :]) for n, v in col.items()}, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w)[0], rtol=0, atol=CELL_ATOL)


def test_a_cell_without_live_candidates_or_rows_gives_zeros():
    row, col = cell_inputs(5, 0.0)
    assert all((f == 0).all() for f in combine(kernel_walk(row, col, tile=128), row))
    row, col = cell_inputs(5, 0.5)
    row["active"][:] = 0
    assert all((f == 0).all() for f in combine(kernel_walk(row, col, tile=128), row))


# --- the tensor-core kernel's features, built in the kernel


def bf16_rn(x):
    """float32 -> the float32 value of its bf16 rounding to nearest even,
    as ``__float2bfloat16_rn`` rounds a finite value."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(F32)


def kernel_features(pos, vel, active):
    """``build_features`` of ``csrc/pair_mxu.cuh`` for every column:
    float32 ``[10, N]`` and ``[6, N]`` holding the bf16 values."""
    a = active.astype(F32)
    x = np.stack([a, a * pos[:, 0], a * pos[:, 1], a * vel[:, 0], a * vel[:, 1]])
    hi = bf16_rn(x)
    lo = bf16_rn(x - hi)
    return np.concatenate([hi, lo]), np.concatenate([hi[:3], lo[:3]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_in_kernel_features_are_bitwise_the_lane_feats(seed):
    rng = np.random.RandomState(seed)
    n = 257
    pos = rng.uniform(-40, 40, size=(n, 2)).astype(F32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(F32)
    active = (rng.rand(n) < 0.8).astype(F32)
    feat, sep = kernel_features(pos, vel, active)
    tfeat, tsep = tpw._lane_feats(*(torch.from_numpy(c.copy()) for c in (
        pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], active)))
    jfeat, jsep = jpw._lane_feats(*(jnp.asarray(c)[None, :] for c in (
        pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], active)))
    for mine, port, ref in ((feat, tfeat, jfeat), (sep, tsep, jsep)):
        port = port.to(torch.float32).numpy()
        ref = np.asarray(ref, F32)
        assert np.array_equal(mine.view(np.uint32), port.view(np.uint32))
        assert np.array_equal(mine.view(np.uint32), ref.view(np.uint32))


# --- the tensor-core kernel's launch shape

SHAPES = [(1, 1), (1, 1024), (65, 1000), (1024, 64), (1024, 65), (1024, 1024),
          (1024, 4100), (4096, 4096), (32768, 32768)]


@pytest.mark.parametrize("r,n", SHAPES)
def test_mxu2_launch_shape_covers_every_column_tile_once(r, n):
    p, row_blocks = tpw.mxu2_launch_shape(r, n)
    tiles = -(-n // tpw.MXU_TILE)
    assert p in (1, 2, 4, 8) and p <= tiles
    assert row_blocks == -(-r // tpw.MXU_TILE)  # the 64-row blocks P is weighed for
    ranges = tpw.mxu2_tile_ranges(n, p)
    assert len(ranges) == p
    walked = [t for start, end in ranges for t in range(start, end)]
    assert walked == list(range(tiles))  # once each, ascending across ranks
    assert all(end > start for start, end in ranges)
    if p < 8 and 2 * p <= tiles:  # a bigger cluster was declined: SMs full
        assert row_blocks * p >= 132


def test_mxu2_launch_shape_at_the_main_path():
    assert tpw.mxu2_launch_shape(1024, 1024) == (8, 16)  # 8 ranks of 2 tiles each
    assert tpw.mxu2_tile_ranges(1024, 8)[0] == (0, 2)
