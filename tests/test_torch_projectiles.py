"""PyTorch port, projectiles: entities spawned and despawned inside the step.

Each system and 300-frame trajectories with spawns, hits and despawns are
bitwise the JAX package's step, jitted and run op by op, in dense and in
grid mode; the ``[B]`` step is bitwise B serial steps; a SyncTest stream
is bitwise JAX's; the runner attests speculation safe; a rollback across a
spawn restores the same ids (and the -1 ids of despawned slots). The
sessions (a JAX peer and a port peer speculating) are in
``test_torch_models_p2p.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.app import GGRSPlugin as JaxPlugin
from bevy_ggrs_tpu.app import SessionType as JaxSessionType
from bevy_ggrs_tpu.models import projectiles as jp
from bevy_ggrs_tpu.schedule import make_inputs
from bevy_ggrs_tpu.session import SyncTestSession as JaxSyncTest
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.app import SessionType
from bevy_ggrs_tpu_torch.models import projectiles as tp
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.schedule import PlayerInputs
from bevy_ggrs_tpu_torch.session import SyncTestSession
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner

PLAYERS, CAP = 4, 64


def random_bits(seed, frames, players=PLAYERS):
    """5-bit inputs: movement and FIRE."""
    return np.random.RandomState(seed).randint(0, 32, size=(frames, players)).astype(np.uint8)


def t_inputs(bits):
    bits = torch.from_numpy(np.ascontiguousarray(bits))
    return PlayerInputs(bits, torch.zeros(bits.shape, dtype=torch.int32))


def leaves(host: dict):
    """``(path, array)`` of a ``to_host`` dict, dict keys sorted."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        else:
            out.append((path, np.asarray(x)))

    walk(host, "")
    return out


def assert_bitwise(a: dict, b: dict, where="") -> None:
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, path)
        assert x.tobytes() == y.tobytes(), (where, path)


@functools.lru_cache(maxsize=None)
def worlds_after(frames, seed=1, mode=None):
    """The JAX (jitted) and port worlds after ``frames`` random frames
    (cached: the steps are functional, nothing writes these worlds)."""
    jw = jp.make_world(PLAYERS, CAP).commit()
    tw = tp.make_world(PLAYERS, CAP, device="cpu").commit()
    jstep = jax.jit(jp.make_schedule(mode=mode))
    tstep = tp.make_schedule(mode=mode)
    for bits in random_bits(seed, frames):
        jw = jstep(jw, make_inputs(bits))
        tw = tstep(tw, t_inputs(bits))
    return jw, tw


def test_make_world_and_registry_equal_jax():
    assert_bitwise(ts.to_host(tp.make_world(PLAYERS, CAP, device="cpu").commit()),
                   js.to_host(jp.make_world(PLAYERS, CAP).commit()))
    assert tp.INPUT_SPEC.values == tuple(range(32))


SYSTEMS = ("move_turret_system", "fire_system", "projectile_system", "cooldown_system",
           "increase_frame_system")


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("system,mode", [(name, "dense") for name in SYSTEMS]
                         + [("projectile_system", "grid")])
def test_each_system_bitwise_jax(system, mode, jit):
    """Each system alone, from a world with live projectiles, under FIRE
    presses, equals JAX's; the hit test in both of its modes (the other
    systems take no mode)."""
    jw, tw = worlds_after(40, seed=2)
    assert_bitwise(ts.to_host(tw), js.to_host(jw))
    jfn, tfn = getattr(jp, system), getattr(tp, system)
    if system == "projectile_system":
        jfn = (lambda f: lambda s, i: f(s, i, mode=mode))(jfn)
        tfn = (lambda f: lambda s, i: f(s, i, mode=mode))(tfn)
    if jit:
        jfn = jax.jit(jfn)
    for bits in random_bits(3, 6):
        bits[0] |= tp.INPUT_FIRE
        jw, tw = jfn(jw, make_inputs(bits)), tfn(tw, t_inputs(bits))
        assert_bitwise(ts.to_host(tw), js.to_host(jw), system)


@pytest.mark.parametrize("mode", ["dense", "grid"])
@pytest.mark.parametrize("jit,frames", [(True, 300), (False, 80)], ids=["jit", "eager"])
def test_trajectory_bitwise_jax(jit, frames, mode):
    """Spawns, hits and despawns over a trajectory: bitwise the jitted and
    the op-by-op JAX step at every tenth frame and the last."""
    jw = jp.make_world(PLAYERS, CAP).commit()
    tw = tp.make_world(PLAYERS, CAP, device="cpu").commit()
    jstep = jp.make_schedule(mode=mode)
    jstep = jax.jit(jstep) if jit else jstep
    tstep = tp.make_schedule(mode=mode)
    despawned = 0
    for f, bits in enumerate(random_bits(1, frames)):
        jw, tw = jstep(jw, make_inputs(bits)), tstep(tw, t_inputs(bits))
        if f % 10 == 9 or f == frames - 1:
            assert_bitwise(ts.to_host(tw), js.to_host(jw), f)
        despawned += int(((tw.rollback_id == -1) & ~tw.alive).sum())
    host = ts.to_host(tw)
    minted = int(host["resources"]["next_rollback_id"]) - ts.DEVICE_ID_BASE
    assert minted > 20 and despawned > 0
    if jit:
        assert host["resources"]["score"].sum() > 0


@pytest.mark.parametrize("mode", ["dense", "grid"])
def test_branch_step_bitwise_serial(mode):
    """A ``[B]`` world (branches from different worlds, each its own
    inputs) steps bitwise as B serial steps, spawns and despawns
    included; dense mode's batched hit test is one pass."""
    B = 4
    starts = [worlds_after(20 + 7 * b, seed=10 + b)[1] for b in range(B)]
    batched = ts.tree_map(lambda *xs: torch.stack(xs), *starts)
    step = tp.make_schedule(mode=mode)
    singles = list(starts)
    rng = np.random.RandomState(9)
    for _ in range(30 if mode == "dense" else 12):
        bits = rng.randint(0, 32, size=(B, PLAYERS)).astype(np.uint8)
        batched = step(batched, t_inputs(bits))
        singles = [step(s, t_inputs(bits[b])) for b, s in enumerate(singles)]
        for b in range(B):
            assert_bitwise(ts.to_host(ts.select_branch(batched, b)), ts.to_host(singles[b]))


def jax_projectiles_app():
    """The JAX package's projectiles app with chip_smoke's key script."""
    keys = chip_smoke.PROJECTILE_KEYS
    reg = jp.make_registry()

    def script(handle, app):
        return np.uint8(keys[(app.session.current_frame // 3 + handle) % len(keys)])

    plugin = JaxPlugin(jp.INPUT_SPEC).with_input_system(script)
    for d in reg.components.values():
        plugin.register_rollback_component(d.name, shape=d.shape, dtype=d.dtype,
                                           default=d.default)
    for d in reg.resources.values():
        plugin.register_rollback_resource(d.name, d.initial)
    return (plugin.with_rollback_schedule(jp.make_schedule())
            .with_num_players(PLAYERS).with_max_prediction_window(8)
            .with_world_capacity(CAP)
            .with_setup_system(lambda world, app: tp.spawn_turrets(world, PLAYERS))
            .build())


def record_reports(session):
    log = []
    report = session.report_checksum

    def logged(frame, cs):
        log.append((frame, cs))
        report(frame, cs)

    session.report_checksum = logged
    return log


def test_synctest_stream_bitwise_jax():
    """The same SyncTest (check distance 7, FIRE in the script) through
    each package's ``GGRSPlugin``: the same checksum reports."""
    frames = 80
    logs = []
    for app, session, stype in (
        (jax_projectiles_app(), JaxSyncTest(PLAYERS, jp.INPUT_SPEC, check_distance=7),
         JaxSessionType.SYNC_TEST),
        (chip_smoke.model_app("cpu", "projectiles"),
         SyncTestSession(PLAYERS, tp.INPUT_SPEC, check_distance=7), SessionType.SYNC_TEST),
    ):
        logs.append(record_reports(session))
        app.insert_session(session, stype)
        app.run_for(frames + 1, dt=1.01 / 60.0)
        assert app.frame == frames
    assert len(logs[1]) > 8 * (frames - 7) and logs[1] == logs[0]
    minted = int(app.world()["resources"]["next_rollback_id"]) - ts.DEVICE_ID_BASE
    assert minted > 0


def test_attestation_safe():
    runner = TSpecRunner(tp.make_schedule(), worlds_after(30)[1], max_prediction=8,
                         num_players=PLAYERS, input_spec=tp.INPUT_SPEC, num_branches=8,
                         device="cpu")
    runner.warmup()
    rep = runner.attestation
    assert rep.ok and runner.speculation_enabled
    assert rep.real_checked == 16 and rep.scanned_branches == 8 and rep.structured_checked


def test_rollback_across_a_spawn_restores_the_same_ids():
    """Save, fire, roll back, fire again: the same slot and id; roll back
    and do not fire: no spawn, the allocator unrewound. Despawned slots'
    -1 ids and device-minted ids survive the ring."""
    _, tw = worlds_after(60, seed=4)
    ring = ts.ring_init(tw, 4)
    ts.ring_save(ring, tw, 0)
    step = tp.make_schedule()
    fire = np.full(PLAYERS, tp.INPUT_FIRE, np.uint8)
    first = step(ts.ring_load(ring, 0), t_inputs(fire))
    again = step(ts.ring_load(ring, 0), t_inputs(fire))
    assert_bitwise(ts.to_host(first), ts.to_host(again))
    before = int(tw.resources["next_rollback_id"])
    spawned = int(first.resources["next_rollback_id"]) - before
    assert spawned > 0
    new = set(first.rollback_id[first.alive].tolist()) - set(tw.rollback_id[tw.alive].tolist())
    assert new == set(range(before, before + spawned))
    quiet = step(ts.ring_load(ring, 0), t_inputs(np.zeros(PLAYERS, np.uint8)))
    assert int(quiet.resources["next_rollback_id"]) == before
    assert set(quiet.rollback_id[quiet.alive].tolist()) <= set(tw.rollback_id[tw.alive].tolist())
    # The ring round trip keeps -1 ids and ids at or above DEVICE_ID_BASE.
    ts.ring_save(ring, first, 1)
    back = ts.ring_load(ring, 1)
    assert_bitwise(ts.to_host(back), ts.to_host(first))
    assert (back.rollback_id == -1).any() and (back.rollback_id >= ts.DEVICE_ID_BASE).any()
    assert integrity.verify_row(ring, 1)
    assert torch.equal(tck.checksum(back), ts.checksum(first))


def test_attestation_memo_keys_both_models(monkeypatch):
    """The verdict memo keys these models (a PairKernel constant and an
    lru_cache'd helper fingerprint by their contents), so the peers of one
    process attest once."""
    from bevy_ggrs_tpu_torch import spec_runner as tsr
    from bevy_ggrs_tpu_torch.models import neural_bots as tn

    monkeypatch.setattr(tsr, "_ATTEST_MEMO", {})
    keys = []
    for mod, players, world in (
            (tp, PLAYERS, lambda: tp.make_world(PLAYERS, CAP, device="cpu").commit()),
            (tn, 2, lambda: tn.make_world(16, 2, device="cpu").commit())):
        runners = [TSpecRunner(mod.make_schedule(), world(), max_prediction=8,
                               num_players=players, input_spec=mod.INPUT_SPEC, num_branches=4,
                               device="cpu")
                   for _ in range(2)]
        for r in runners:
            r.warmup()
        assert runners[0].attestation.ok and runners[1].attestation == runners[0].attestation
        # The memo spares the second runner the attestation's two rollouts.
        assert runners[1].spec_rollouts_total == runners[0].spec_rollouts_total - 2
        keys.append(tsr._attestation_key(runners[0]))
    assert None not in keys and keys[0] != keys[1]


@pytest.mark.parametrize("branches", [0, 4])
def test_dense_hits_equal_interact(branches):
    """The one-pass dense hit test is bitwise the dense ``interact`` of the
    port and of the JAX package, each branch its own call."""
    from bevy_ggrs_tpu.ops import neighbor as jnb
    from bevy_ggrs_tpu_torch.ops import neighbor as tnb

    rng = np.random.RandomState(11 + branches)
    shape = (max(branches, 1), CAP)
    # A crowded box a few hit radii wide, so rows meet several columns.
    pos = rng.uniform(-1.0, 1.0, shape + (2,)).astype(np.float32)
    alive = rng.random_sample(shape) < 0.8
    kind = rng.randint(0, 2, shape)
    owner = np.where(kind == tp.KIND_TURRET, rng.randint(0, PLAYERS, shape),
                     rng.randint(-1, PLAYERS, shape)).astype(np.float32)
    feats = {"owner": owner,
             "is_proj": (alive & (kind == tp.KIND_PROJECTILE)).astype(np.float32),
             "is_turret": (alive & (kind == tp.KIND_TURRET) & (owner >= 0)).astype(np.float32)}
    pick = (lambda x: x) if branches else (lambda x: x[0])
    got = tp._hits_dense(torch.from_numpy(pick(pos)),
                         {k: torch.from_numpy(pick(v)) for k, v in feats.items()}).numpy()
    got = got if branches else got[None]
    assert got.shape == shape + (1,) and got.sum() > 0
    for b in range(shape[0]):
        mine = tnb.interact(torch.from_numpy(pos[b]), torch.from_numpy(alive[b]),
                            tp.HIT_PAIR_KERNEL,
                            feats={k: torch.from_numpy(v[b]) for k, v in feats.items()},
                            mode="dense").numpy()
        ref = np.asarray(jnb.interact(pos[b], alive[b], jp.HIT_PAIR_KERNEL,
                                      feats={k: v[b] for k, v in feats.items()},
                                      mode="dense"))
        assert np.array_equal(got[b], mine) and np.array_equal(got[b], ref)
