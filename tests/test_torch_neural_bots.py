"""PyTorch port, neural_bots: an int8 MLP policy inside the rollback domain.

The exact primitives (``ops/exact.py``): ``tanh_f32`` is bitwise
``jnp.tanh`` on about a million float32 values, edges included;
``sqrt_f32`` is bitwise ``jnp.sqrt`` wherever XLA:CPU does not flush a
subnormal; ``int_matmul`` equals numpy's int32 product (where torch's own
int8 product wraps). The policy's weights are bitwise JAX's; the policy
system and 300-frame trajectories are bitwise the JAX step run op by op
(unjitted) and allclose the jitted one, which XLA:CPU contracts into FMAs;
the ``[B]`` step is bitwise per branch; a SyncTest stream is bitwise the
unjitted JAX checksums; the runner attests speculation safe. Speculating
peers are in ``test_torch_models_p2p.py``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import neural_bots as jn
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import SessionType
from bevy_ggrs_tpu_torch.models import neural_bots as tn
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.ops import exact
from bevy_ggrs_tpu_torch.session import SyncTestSession
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner
from tests.test_torch_projectiles import assert_bitwise, record_reports, t_inputs

PLAYERS = 2


def bits_table(seed, frames, players=PLAYERS):
    return np.random.RandomState(seed).randint(0, 16, size=(frames, players)).astype(np.uint8)


# ---------------------------------------------------------------------------
# The exact primitives
# ---------------------------------------------------------------------------


def test_tanh_f32_bitwise_jnp_tanh():
    x = chip_smoke.exact_inputs(chip_smoke.EXACT_VALUES)
    assert x.size == 1 << 20
    want = np.asarray(jnp.tanh(jnp.asarray(x)))
    got = exact.tanh_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(x)
    assert nan.sum() > 100  # random bit patterns and the explicit NaN
    assert np.isnan(got[nan]).all() and np.isnan(want[nan]).all()
    assert got[~nan].view(np.int32).tolist() == want[~nan].view(np.int32).tolist()
    # torch's own tanh does not give these bits.
    assert (torch.tanh(torch.from_numpy(x[~nan])).numpy() != want[~nan]).sum() > 1000
    # The edges: +-0 keep their sign, tiny values pass through, the clamp.
    edge = np.array([0.0, -0.0, 1e-5, -3e-4, np.inf, -np.inf, 9.0], np.float32)
    out = exact.tanh_f32(torch.from_numpy(edge)).numpy()
    assert out[:4].tobytes() == edge[:4].tobytes()
    assert out[4:].tolist() == [1.0, -1.0, 1.0]


def exact_fma(a: float, b: float, c: float) -> np.float32:
    """``a * b + c`` rounded once to float32, to nearest, ties to even,
    from exact rational arithmetic."""
    exact_sum = Fraction(a) * Fraction(b) + Fraction(c)
    guess = np.float32(float(exact_sum))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]

    def key(v):
        return (abs(Fraction(float(v)) - exact_sum), int(np.float32(v).view(np.int32)) & 1)

    return min(cands, key=key)


def test_fused_multiply_add_rounds_once():
    """``round_sum_f32`` of an exact float64 product (a fused multiply-add)
    against exact rational arithmetic on random operands and
    on products placed at half an ulp of the addend, where a float64 sum
    rounded again to float32 could land on the wrong side of a midpoint."""
    rng = np.random.RandomState(0)
    n = 4000
    c = (rng.uniform(-4, 4, n) * 2.0 ** rng.randint(-20, 20, n)).astype(np.float32)
    a = rng.uniform(0.5, 2, n).astype(np.float32)
    half_ulp = (np.abs(np.nextafter(c, np.float32(np.inf)) - c) / 2).astype(np.float64)
    b = (half_ulp * rng.choice([-1, 1], n) / a * (1 + rng.uniform(-1e-7, 1e-7, n)))
    b = b.astype(np.float32)
    a = np.concatenate([a, rng.standard_normal(n).astype(np.float32)])
    b = np.concatenate([b, rng.standard_normal(n).astype(np.float32)])
    c = np.concatenate([c, rng.standard_normal(n).astype(np.float32)])
    prod = torch.from_numpy(a).double() * torch.from_numpy(b).double()
    got = exact.round_sum_f32(prod, torch.from_numpy(c).double()).numpy()
    want = np.array([exact_fma(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)],
                    np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


def test_sqrt_f32_bitwise_jnp_sqrt_on_normal_values():
    x = np.abs(chip_smoke.exact_inputs(chip_smoke.EXACT_VALUES))
    x = x[np.isfinite(x) & ((x == 0) | (x >= np.finfo(np.float32).tiny))]
    want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    got = exact.sqrt_f32(torch.from_numpy(x)).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


@pytest.mark.parametrize("sa,sb", [
    ((512, 8), (8, 32)), ((512, 32), (32, 4)), ((512, 512), (512, 4)),
    ((4, 64, 8), (4, 8, 256)), ((64, 8, 396), (396, 32)), ((3, 1040), (1040, 2)),
])
def test_int_matmul_equals_numpy_int32(sa, sb):
    rng = np.random.RandomState(sum(sa) + sum(sb))
    a = rng.randint(-127, 128, sa).astype(np.int8)
    b = rng.randint(-127, 128, sb).astype(np.int8)
    got = exact.int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = np.matmul(a.astype(np.int32), b.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    if sa == (512, 8):  # torch's int8 product wraps around
        wrapped = torch.matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert wrapped.dtype == torch.int8 and not np.array_equal(wrapped.numpy(), want)


def test_int_matmul_refuses_a_depth_that_could_round():
    a = torch.zeros((2, 1041), dtype=torch.int8)
    with pytest.raises(ValueError, match="1041"):
        exact.int_matmul(a, torch.zeros((1041, 2), dtype=torch.int8))
    assert exact.MAX_K == 1040


# ---------------------------------------------------------------------------
# The model against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [32, 256, 512])
@pytest.mark.parametrize("seed", [0, 3])
def test_policy_params_bitwise(seed, hidden):
    a, b = tn.make_policy_params(seed, hidden), jn.make_policy_params(seed, hidden)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_make_world_equals_jax():
    assert_bitwise(ts.to_host(tn.make_world(64, PLAYERS, device="cpu").commit()),
                   js.to_host(jn.make_world(64, PLAYERS).commit()))


def eager_worlds(bots, hidden, frames, seed=1):
    """The JAX world stepped op by op, the port's, and the jitted JAX
    one, after ``frames`` random frames."""
    jw = jn.make_world(bots, PLAYERS, hidden=hidden).commit()
    tw = tn.make_world(bots, PLAYERS, hidden=hidden, device="cpu").commit()
    jit_w = jw
    jstep, tstep, jitted = jn.make_schedule(), tn.make_schedule(), jax.jit(jn.make_schedule())
    for bits in bits_table(seed, frames):
        jw, tw = jstep(jw, make_inputs(bits)), tstep(tw, t_inputs(bits))
        jit_w = jitted(jit_w, make_inputs(bits))
    return jw, tw, jit_w


@pytest.mark.parametrize("hidden", [32, 256, 512])
def test_policy_system_bitwise_unjitted_jax(hidden):
    jw, tw, _ = eager_worlds(512, hidden, 3)
    assert_bitwise(ts.to_host(tw), js.to_host(jw))
    for bits in bits_table(5, 3):
        jw = jn.policy_system(jw, make_inputs(bits))
        tw = tn.policy_system(tw, t_inputs(bits))
        assert_bitwise(ts.to_host(tw), js.to_host(jw))


def test_trajectory_300_frames_bitwise_unjitted_allclose_jitted():
    jw, tw, jit_w = eager_worlds(64, 32, 300)
    assert_bitwise(ts.to_host(tw), js.to_host(jw))
    got = ts.to_host(tw)["components"]
    for name in ("position", "velocity"):
        jitted = np.asarray(jit_w.components[name])
        np.testing.assert_allclose(got[name], jitted, atol=1e-5, rtol=0)
    # The jitted step's contracted FMAs differ in the last bits.
    assert not np.array_equal(got["velocity"], np.asarray(jit_w.components["velocity"]))


@pytest.mark.parametrize("hidden", [32, 512])
def test_branch_step_bitwise_per_branch(hidden):
    """A ``[B]`` world with a per-branch policy (the products ``[B, cap,
    8] x [B, 8, H]``) steps bitwise as B serial steps."""
    B = 3
    starts = [tn.make_world(48, PLAYERS, seed=b, hidden=hidden, device="cpu").commit()
              for b in range(B)]
    rng = np.random.RandomState(7)
    starts = [s.replace(resources={**s.resources, "policy": {
        k: torch.from_numpy(v) for k, v in tn.make_policy_params(b, hidden).items()}})
        for b, s in enumerate(starts)]
    batched = ts.tree_map(lambda *xs: torch.stack(xs), *starts)
    step = tn.make_schedule()
    singles = list(starts)
    for _ in range(6):
        bits = rng.randint(0, 16, size=(B, PLAYERS)).astype(np.uint8)
        batched = step(batched, t_inputs(bits))
        singles = [step(s, t_inputs(bits[b])) for b, s in enumerate(singles)]
    for b in range(B):
        assert_bitwise(ts.to_host(ts.select_branch(batched, b)), ts.to_host(singles[b]))


def test_synctest_stream_bitwise_unjitted_jax_checksums():
    """A port SyncTest (check distance 7) of chip_smoke's neural_bots app:
    every checksum it reports for frame f equals JAX's checksum of the
    world after f unjitted steps of the same script."""
    frames, bots = 48, 64
    app = chip_smoke.model_app("cpu", "neural_bots", bots=bots)
    session = SyncTestSession(PLAYERS, tn.INPUT_SPEC, check_distance=7)
    log = record_reports(session)
    app.insert_session(session, SessionType.SYNC_TEST)
    app.run_for(frames + 1, dt=1.01 / 60.0)
    assert app.frame == frames and len(log) > 8 * (frames - 7)
    keys = chip_smoke.BOT_KEYS
    jw = jn.make_world(bots, PLAYERS).commit()
    step = jn.make_schedule()
    want = {}
    for f in range(frames + 1):
        want[f] = js.combine64(js.checksum(jw))
        bits = np.array([keys[(f // 3 + h) % 4] for h in range(PLAYERS)], np.uint8)
        jw = step(jw, make_inputs(bits))
    assert all(cs == want[f] for f, cs in log)
    assert {f for f, _ in log} == set(range(frames))


def test_checksum_walks_the_policy_dict_in_jax_order():
    """The dict resource ``policy`` (int8 and float32 leaves) hashes as
    JAX's flatten order (sorted keys) does: the port's checksum, its
    kernel's plain version and the JAX package's agree."""
    for hidden in (32, 512):
        jw = jn.make_world(64, PLAYERS, hidden=hidden).commit()
        tw = tn.make_world(64, PLAYERS, hidden=hidden, device="cpu").commit()
        want = js.combine64(js.checksum(jw))
        assert ts.combine64(ts.checksum(tw)) == want
        assert ts.combine64(tck.checksum_plain(tw)) == want


def test_attestation_safe():
    runner = TSpecRunner(tn.make_schedule(), tn.make_world(64, PLAYERS, device="cpu").commit(),
                         max_prediction=8, num_players=PLAYERS, input_spec=tn.INPUT_SPEC,
                         num_branches=8, device="cpu")
    runner.warmup()
    rep = runner.attestation
    assert rep.ok and runner.speculation_enabled
    assert rep.real_checked == 16 and rep.scanned_branches == 8
