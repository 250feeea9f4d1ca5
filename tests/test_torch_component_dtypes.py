"""PyTorch port, component dtypes that JAX narrows or numpy lacks.

JAX runs with 64-bit types off, so a component registered as int64, uint64
or float64 is held (and hashed) as its 32-bit counterpart; the port's
registry narrows the same way. bfloat16 has no numpy dtype without
``ml_dtypes``: the port stages and exports it as its 16-bit patterns in
``uint16``, which is what JAX's bfloat16 array viewed as ``uint16`` holds.
Checksums, ``to_host`` bytes and the carry across the packages
(``from_host``) are held bitwise against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.schedule import InputSpec, Schedule

# (JAX dtype, port dtype, the port's held dtype, values spawned)
CASES = {
    "int64": (jnp.int64, torch.int64, torch.int32, [7, -3]),
    "uint64": (jnp.uint64, torch.uint64, torch.uint32, [7, 4_000_000_000]),
    "float64": (jnp.float64, torch.float64, torch.float32, [1.5, -2.1]),
    # 1.00390625 is a tie between two bfloat16 values (round to even);
    # -3.14159 and 1e-3 round inexactly.
    "bfloat16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16,
                 [1.00390625, -3.14159, 1e-3]),
}


def host_bits(a: np.ndarray) -> np.ndarray:
    """JAX's bfloat16 host array as the bit patterns the port exports."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def worlds(case, shape=()):
    jdt, tdt, _, vals = CASES[case]
    jreg = js.TypeRegistry().register_component("n", shape=shape, dtype=jdt)
    treg = ts.TypeRegistry().register_component("n", shape=shape, dtype=tdt)
    jw, tw = js.HostWorld(jreg, 8), ts.HostWorld(treg, 8, device="cpu")
    for rid, v in enumerate(vals):
        value = np.full(shape, v).tolist() if shape else v
        jw.spawn({"n": value}, rid)
        tw.spawn({"n": value}, rid)
    return jreg, treg, jw.commit(), tw.commit()


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_holds_what_jax_holds(case):
    _, treg, jst, tst = worlds(case)
    assert treg.components["n"].dtype == CASES[case][2]
    assert tst.components["n"].dtype == CASES[case][2]
    jh, th = js.to_host(jst), ts.to_host(tst)
    assert host_bits(jh["components"]["n"]).dtype == th["components"]["n"].dtype
    np.testing.assert_array_equal(host_bits(jh["components"]["n"]), th["components"]["n"])


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_checksum_bitwise_against_jax(case, shape):
    _, _, jst, tst = worlds(case, shape)
    assert ts.combine64(ts.checksum(tst)) == js.combine64(js.checksum(jst))
    assert ts.checksum_breakdown(tst) == js.checksum_breakdown(jst)


@pytest.mark.parametrize("case", sorted(CASES))
def test_carry_across_packages(case):
    """A JAX world's ``to_host`` becomes a port world with JAX's checksum,
    and the port's ``to_host`` round-trips through ``from_host``."""
    _, treg, jst, tst = worlds(case)
    want = js.combine64(js.checksum(jst))
    from_jax = ts.from_host(treg, js.to_host(jst), device="cpu")
    assert from_jax.components["n"].dtype == CASES[case][2]
    assert ts.combine64(ts.checksum(from_jax)) == want
    again = ts.from_host(treg, ts.to_host(tst), device="cpu")
    assert ts.combine64(ts.checksum(again)) == want


def test_bfloat16_values_round_to_nearest_even_as_jax():
    vals = np.array([1.00390625, 1.01171875, -3.14159, 1e-3, 65504.0, 3e38],
                    dtype=np.float32)
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(ts.host_array(vals, torch.bfloat16), want)
    assert ts.np_dtype(torch.bfloat16) == np.uint16


def test_float_values_for_bfloat16_from_host():
    """``from_host`` given values (not bit patterns) rounds them."""
    treg = ts.TypeRegistry().register_component("n", dtype=torch.bfloat16)
    host = ts.to_host(ts.init_state(treg, 4, device="cpu"))
    host["components"]["n"] = np.array([1.00390625, -2.0, 0.0, 0.5], np.float32)
    got = ts.from_host(treg, host, device="cpu").components["n"]
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [1.0, -2.0, 0.0, 0.5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_spawn_matches_a_staged_spawn(case):
    """A live spawn into the runner's state holds the same bits as the
    staging world's spawn (and so as JAX's)."""
    jdt, tdt, held, vals = CASES[case]
    treg = ts.TypeRegistry().register_component("n", dtype=tdt)
    runner = RollbackRunner(Schedule(), ts.HostWorld(treg, 8, device="cpu").commit(),
                            max_prediction=2, num_players=1, input_spec=InputSpec(),
                            device="cpu")
    for rid, v in enumerate(vals):
        runner.spawn({"n": v}, rid)
    _, _, jst, _ = worlds(case)
    assert runner.state.components["n"].dtype == held
    assert ts.combine64(ts.checksum(runner.state)) == js.combine64(js.checksum(jst))
    np.testing.assert_array_equal(runner.world()["components"]["n"],
                                  host_bits(js.to_host(jst)["components"]["n"]))
