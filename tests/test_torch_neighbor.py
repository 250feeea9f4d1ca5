"""PyTorch port, the neighbour grid: binning bitwise equal to the JAX
package's (dtype and value, through overflow, drop and inactive
entities), the grid configuration field by field, mode resolution with
the JAX package's precedence cases, and grid forces within ``atol=1e-5``
of the JAX grid (its ``xla`` path and its Pallas cell kernel in interpret
mode), the JAX suite's own grid tolerance (tests/test_neighbor.py): the
same f32 terms, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.ops import neighbor as jnb
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.ops import cell_gather as tcg
from bevy_ggrs_tpu_torch.ops import neighbor as tnb

GRID_ATOL = 1e-5
BIN_FIELDS = ("slots", "spill", "cell_of", "occupancy", "n_spilled", "n_dropped")


@pytest.fixture(autouse=True)
def _clear_defaults():
    yield
    jnb.set_default_interaction_mode(None)
    tnb.set_default_interaction_mode(None)


def rand_world(n, seed=0, spread=8.0):
    """The JAX suite's world (tests/test_neighbor.py): an eighth of the
    entities inactive."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-spread, spread, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[rng.choice(n, size=n // 8, replace=False)] = False
    return pos, vel, active


def clustered(n, seed, half=0.45):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-half, half, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, size=(n, 2)).astype(np.float32)
    return pos, vel, np.ones(n, bool)


def configs(cfg):
    """The same configuration in both packages."""
    fields = (cfg.cell_size, cfg.grid_dim, cfg.cell_capacity, cfg.spill_capacity)
    return jnb.GridConfig(*fields), tnb.GridConfig(*fields)


def assert_binning_bitwise(pos, active, cfg):
    jcfg, tcfg = configs(cfg)
    j = jnb.bin_entities(jnp.asarray(pos), jnp.asarray(active), jcfg)
    t = tnb.bin_entities(torch.from_numpy(pos), torch.from_numpy(active), tcfg)
    for name in BIN_FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    return t


BINNING_CASES = {
    "uniform": lambda: (*rand_world(700, seed=3)[::2], tboids.grid_config(700)),
    "beyond_world_bounds": lambda: (
        np.random.RandomState(9).uniform(-60, 60, size=(900, 2)).astype(np.float32),
        np.random.RandomState(10).rand(900) > 0.2, tboids.grid_config(900)),
    "float_active": lambda: (rand_world(300, seed=7)[0],
                             rand_world(300, seed=7)[2].astype(np.float32),
                             tboids.grid_config(300)),
}


@pytest.mark.parametrize("case", sorted(BINNING_CASES))
def test_binning_is_bitwise_jax(case):
    pos, active, cfg = BINNING_CASES[case]()
    assert_binning_bitwise(pos, active, cfg)


def test_binning_bitwise_under_overflow_and_drop():
    pos, _, active = clustered(64, seed=5, half=0.4)
    cfg = tnb.GridConfig(cell_size=1.0, grid_dim=4, cell_capacity=4, spill_capacity=8)
    t = assert_binning_bitwise(pos, active, cfg)
    assert int(t.n_spilled) > 8 and int(t.n_dropped) > 0


def test_inactive_entities_reach_neither_slots_nor_spill():
    pos, _, active = rand_world(300, seed=7)
    cfg = tboids.grid_config(300)
    g = assert_binning_bitwise(pos, active, cfg)
    slots, spill = g.slots.numpy(), g.spill.numpy()
    members = set(slots[slots < 300].tolist()) | set(spill[spill < 300].tolist())
    assert members == set(np.where(active)[0].tolist())
    assert np.all(g.cell_of.numpy()[~active] == cfg.num_cells)


@pytest.mark.parametrize("n", [8, 300, 1024, 1500, 4096, 32768, 65536, 200000])
def test_default_grid_config_field_by_field(n):
    j, t = jboids.grid_config(n), tboids.grid_config(n)
    for field in ("cell_size", "grid_dim", "cell_capacity", "spill_capacity",
                  "num_cells", "cols", "padded_cols"):
        assert getattr(t, field) == getattr(j, field), field
    np.testing.assert_array_equal(tnb.neighbor_table(t.grid_dim),
                                  jnb.neighbor_table(j.grid_dim))


def test_boids_32768_grid_shape():
    cfg = tboids.grid_config(32768)
    assert (cfg.grid_dim, cfg.num_cells, cfg.cell_capacity,
            cfg.spill_capacity, cfg.padded_cols) == (16, 256, 256, 512, 2816)
    with pytest.raises(ValueError):
        tnb.GridConfig(cell_size=1.0, grid_dim=2, cell_capacity=4, spill_capacity=4)
    with pytest.raises(ValueError):
        tnb.GridConfig(cell_size=1.0, grid_dim=4, cell_capacity=0, spill_capacity=4)


def test_grid_stats_equal_jax():
    pos, _, active = rand_world(500)
    cfg = tboids.grid_config(500)
    got = tnb.grid_stats(torch.from_numpy(pos), torch.from_numpy(active), cfg)
    assert got == jnb.grid_stats(pos, active, jboids.grid_config(500))
    assert got["dropped"] == 0


# --- mode resolution: the cases of tests/test_neighbor.py::TestModeResolution


def test_explicit_mode_always_wins(monkeypatch):
    monkeypatch.setenv("GGRS_FORCE_MODE", "grid")
    assert tnb.resolve_mode("dense", 10**6) == "dense"
    monkeypatch.setenv("GGRS_FORCE_MODE", "dense")
    assert tnb.resolve_mode("grid", 4) == "grid"


def test_env_overrides_auto_and_default(monkeypatch):
    monkeypatch.setenv("GGRS_FORCE_MODE", "grid")
    assert tnb.resolve_mode(None, 4) == "grid"
    assert tnb.resolve_mode("auto", 4) == "grid"
    monkeypatch.delenv("GGRS_FORCE_MODE")
    assert tnb.resolve_mode(None, 10**6) == "dense"


def test_auto_threshold(monkeypatch):
    monkeypatch.delenv("GGRS_FORCE_MODE", raising=False)
    t = tnb.GRID_AUTO_THRESHOLD
    assert t == jnb.GRID_AUTO_THRESHOLD
    assert tnb.resolve_mode("auto", t - 1) == "dense"
    assert tnb.resolve_mode("auto", t) == "grid"


def test_process_default_mode(monkeypatch):
    monkeypatch.delenv("GGRS_FORCE_MODE", raising=False)
    tnb.set_default_interaction_mode("grid")
    assert tnb.resolve_mode(None, 4) == "grid"
    monkeypatch.setenv("GGRS_FORCE_MODE", "dense")  # env outranks it
    assert tnb.resolve_mode(None, 4) == "dense"
    tnb.set_default_interaction_mode(None)
    monkeypatch.delenv("GGRS_FORCE_MODE")
    assert tnb.resolve_mode(None, 4) == "dense"
    tnb.set_default_interaction_mode("auto")
    assert tnb.resolve_mode(None, tnb.GRID_AUTO_THRESHOLD) == "grid"


def test_invalid_mode_rejected():
    with pytest.raises(ValueError):
        tnb.resolve_mode("sparse", 4)
    with pytest.raises(ValueError):
        tnb.set_default_interaction_mode("sparse")


# --- interact: grid forces against JAX


def jax_interact(pos, vel, active, **kw):
    return jnb.interact(
        jnp.asarray(pos), jnp.asarray(active), jboids.FLOCK_PAIR_KERNEL,
        {"vx": jnp.asarray(vel[:, 0]), "vy": jnp.asarray(vel[:, 1])}, **kw)


def torch_interact(pos, vel, active, **kw):
    return tnb.interact(
        torch.from_numpy(pos), torch.from_numpy(active),
        tboids.FLOCK_PAIR_KERNEL,
        {"vx": torch.from_numpy(vel[:, 0].copy()),
         "vy": torch.from_numpy(vel[:, 1].copy())}, **kw)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_grid_forces_match_jax(impl):
    pos, vel, active = rand_world(1000, seed=2)
    jcfg, tcfg = jboids.grid_config(1000), tboids.grid_config(1000)
    want = jax_interact(pos, vel, active, mode="grid", config=jcfg, impl=impl)
    got, g = torch_interact(pos, vel, active, mode="grid", config=tcfg,
                            impl=impl, return_grid=True)
    assert int(g.n_dropped) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GRID_ATOL)
    np.testing.assert_array_equal(got.numpy()[~active], 0.0)
    dense = jax_interact(pos, vel, active, mode="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), rtol=0, atol=GRID_ATOL)


def test_dense_interact_matches_jax():
    pos, vel, active = rand_world(400, seed=1)
    want = jax_interact(pos, vel, active, mode="dense")
    got, g = torch_interact(pos, vel, active, mode="dense", return_grid=True)
    assert g is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_spill_fallback_matches_jax():
    """Overflowed cells fall back to the dense [S, N] pass."""
    pos, vel, active = clustered(48, seed=11)
    cfg = tnb.GridConfig(cell_size=1.0, grid_dim=4, cell_capacity=4, spill_capacity=48)
    jcfg, tcfg = configs(cfg)
    got, g = torch_interact(pos, vel, active, mode="grid", config=tcfg,
                            return_grid=True)
    assert int(g.n_spilled) > 0 and int(g.n_dropped) == 0
    want = jax_interact(pos, vel, active, mode="grid", config=jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GRID_ATOL)


def test_dropped_entities_get_zero_force_as_in_jax():
    pos, vel, active = clustered(48, seed=13)
    cfg = tnb.GridConfig(cell_size=1.0, grid_dim=4, cell_capacity=4, spill_capacity=4)
    jcfg, tcfg = configs(cfg)
    got, g = torch_interact(pos, vel, active, mode="grid", config=tcfg,
                            impl="pallas", return_grid=True)
    assert int(g.n_dropped) > 0
    placed = set(g.slots.numpy().ravel().tolist()) | set(g.spill.numpy().tolist())
    dropped = sorted(set(range(48)) - placed)
    assert len(dropped) == int(g.n_dropped)
    np.testing.assert_array_equal(got.numpy()[dropped], 0.0)
    want = jax_interact(pos, vel, active, mode="grid", config=jcfg, impl="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GRID_ATOL)


def test_cell_size_below_radius_rejected():
    pos, vel, active = rand_world(64)
    cfg = tnb.GridConfig(cell_size=0.5, grid_dim=16, cell_capacity=8, spill_capacity=8)
    with pytest.raises(ValueError, match="radius"):
        torch_interact(pos, vel, active, mode="grid", config=cfg)


def test_world_half_derives_the_config():
    pos, vel, active = rand_world(500, seed=4)
    a = torch_interact(pos, vel, active, mode="grid", world_half=8.0)
    b = torch_interact(pos, vel, active, mode="grid", config=tboids.grid_config(500))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="world_half"):
        torch_interact(pos, vel, active, mode="grid")


def test_plain_cell_forces_do_not_depend_on_the_chunking(monkeypatch):
    """The plain version walks the cells in chunks; every cell's sums are
    its own, so any chunking gives the same bits."""
    pos, vel, active = rand_world(1000, seed=8)
    cfg = tboids.grid_config(1000)
    grid, cand, padded = tnb.build_grid_tables(
        torch.from_numpy(pos), torch.from_numpy(active), cfg,
        {"vx": torch.from_numpy(vel[:, 0].copy()), "vy": torch.from_numpy(vel[:, 1].copy())})
    kernel = tboids.FLOCK_PAIR_KERNEL
    rowvals = {n: padded[n][grid.slots] for n in kernel.row_names}
    colvals = {n: padded[n][cand] for n in kernel.col_names}
    whole = tcg.cell_slot_forces_plain(kernel, rowvals, colvals)
    monkeypatch.setattr(tcg, "_PLAIN_CHUNK_PAIRS", 3 * cfg.cell_capacity * cfg.padded_cols)
    chunked = tcg.cell_slot_forces_plain(kernel, rowvals, colvals)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


def test_cell_wrapper_takes_the_plain_version_on_cpu():
    pos, vel, active = rand_world(200, seed=6)
    before = tcg.cell_slot_forces.launches
    a = torch_interact(pos, vel, active, mode="grid",
                       config=tboids.grid_config(200), impl="pallas")
    b = torch_interact(pos, vel, active, mode="grid",
                       config=tboids.grid_config(200), impl="xla")
    assert torch.equal(a, b)
    assert tcg.cell_slot_forces.launches == before
    with pytest.raises(ValueError, match="impl"):
        torch_interact(pos, vel, active, mode="grid",
                       config=tboids.grid_config(200), impl="mosaic")
