"""The port's checkpoints against the JAX package's, on the CPU, bitwise.

For box_game, boids-64, projectiles (capacity 16) and neural_bots (16
bots) built in both packages from one numpy seed: the path lists equal
JAX's ``keystr`` paths, ``dumps_checkpoint`` and ``dumps_runner`` write
equal bytes, and each package loads the other's bytes leaf for leaf. The
template and v1 errors read as JAX's; a bfloat16 leaf is saved in JAX's
bytes and refused by both. Then the cases of ``tests/test_persistence.py``
on the port: round trips, crash recovery bitwise (with input delay too),
the rolling manager, an empty directory.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import integrity as jintegrity
from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import boids as jboids
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.models import neural_bots as jbots
from bevy_ggrs_tpu.models import projectiles as jproj
from bevy_ggrs_tpu.runner import RollbackRunner as JRunner
from bevy_ggrs_tpu.session import SyncTestSession as JSyncTest
from bevy_ggrs_tpu.utils import persistence as JP
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import boids as tboids
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.models import neural_bots as tbots
from bevy_ggrs_tpu_torch.models import projectiles as tproj
from bevy_ggrs_tpu_torch.runner import RollbackRunner
from bevy_ggrs_tpu_torch.session import SyncTestSession
from bevy_ggrs_tpu_torch.utils import persistence as P

MODELS = {
    "box_game": (lambda: jbox.make_world(2), lambda: tbox.make_world(2, device="cpu"),
                 jbox, tbox),
    "boids64": (lambda: jboids.make_world(64, 2), lambda: tboids.make_world(64, 2, device="cpu"),
                jboids, tboids),
    "projectiles16": (lambda: jproj.make_world(2, capacity=16),
                      lambda: tproj.make_world(2, capacity=16, device="cpu"), jproj, tproj),
    "neural_bots16": (lambda: jbots.make_world(16, 2),
                      lambda: tbots.make_world(16, 2, device="cpu"), jbots, tbots),
}
DEPTH = 5


def noisy_hosts(host: dict, frames: int, seed: int):
    """``frames`` host worlds: ``host`` with every component and resource
    leaf changed by a seeded draw (floats moved, integers offset)."""
    rng = np.random.RandomState(seed)

    def moved(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return a.copy()
        if a.dtype.kind == "f":
            return (a + rng.standard_normal(a.shape).astype(a.dtype)).astype(a.dtype)
        return (a + rng.randint(0, 5, size=a.shape)).astype(a.dtype)

    out = []
    for _ in range(frames):
        h = dict(host)
        h["components"] = {n: moved(a) for n, a in host["components"].items()}
        h["resources"] = jax.tree_util.tree_map(moved, host["resources"])
        out.append(h)
    return out


def jax_world(host: dict) -> js.WorldState:
    return js.WorldState(
        alive=jnp.asarray(host["alive"]), rollback_id=jnp.asarray(host["rollback_id"]),
        components={n: jnp.asarray(a) for n, a in host["components"].items()},
        present={n: jnp.asarray(a) for n, a in host["present"].items()},
        resources=jax.tree_util.tree_map(jnp.asarray, host["resources"]))


def twin_runners(model: str, frames: int = 7):
    """A JAX runner and a port runner holding the same world and ring: each
    package's world from its own ``make_world`` (equal hosts), then
    ``frames`` seeded worlds saved into both rings."""
    jmake, tmake, jmod, tmod = MODELS[model]
    jw, tw = jmake().commit(), tmake().commit()
    host = js.to_host(jw)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(ts.to_host(tw))))
    jr = JRunner(jmod.make_schedule(), jw, max_prediction=DEPTH - 1, num_players=2,
                 input_spec=jmod.INPUT_SPEC)
    tr = RollbackRunner(tmod.make_schedule(), tw, max_prediction=DEPTH - 1, num_players=2,
                        input_spec=tmod.INPUT_SPEC, device="cpu")
    for f, h in enumerate(noisy_hosts(host, frames, seed=frames)):
        jr.ring, _ = js.ring_save(jr.ring, jax_world(h), f)
        ts.ring_save(tr.ring, from_host_like(tw, h), f)
        jr.state, tr.state = jax_world(h), from_host_like(tw, h)
    jr.frame = tr.frame = frames
    jr.rollbacks_total = tr.rollbacks_total = 3
    jr.rollback_frames_total = tr.rollback_frames_total = 11
    return jr, tr


def from_host_like(template: ts.WorldState, host: dict) -> ts.WorldState:
    """A port world from a host dict, each component in the template's
    dtype (the registry's)."""
    return ts.WorldState(
        alive=torch.from_numpy(np.array(host["alive"])),
        rollback_id=torch.from_numpy(np.array(host["rollback_id"])),
        components={n: ts.from_numpy(host["components"][n], t.dtype, "cpu")
                    for n, t in template.components.items()},
        present={n: torch.from_numpy(np.array(host["present"][n])) for n in template.present},
        resources=ts.tree_map(lambda a: torch.from_numpy(np.array(a)), host["resources"]))


def jax_paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_leaves(tree):
    return [leaf.value for leaf in P._flatten(tree)]


def same_leaves(jtree, ttree) -> bool:
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
    tl = [ts.to_numpy(x) for x in port_leaves(ttree)]
    # The port's ring lanes are int64 holding JAX's uint32 values.
    return len(jl) == len(tl) and all(
        a.shape == b.shape and a.tobytes() == b.astype(a.dtype).tobytes()
        for a, b in zip(jl, tl))


@pytest.mark.parametrize("model", list(MODELS))
def test_paths_equal_jax(model):
    jr, tr = twin_runners(model, frames=1)
    jtree, ttree = {"state": jr.state, "ring": jr.ring}, {"state": tr.state, "ring": tr.ring}
    assert [leaf.path for leaf in P._flatten(ttree)] == jax_paths(jtree)
    with np.load(io.BytesIO(P.dumps_checkpoint(ttree))) as npz:
        assert json.loads(bytes(npz[P._HEADER_KEY]).decode())["paths"] == jax_paths(jtree)


@pytest.mark.parametrize("model", list(MODELS))
def test_bytes_equal_jax(model):
    jr, tr = twin_runners(model)
    meta = {"note": model, "n": [1, 2]}
    jtree, ttree = {"state": jr.state, "ring": jr.ring}, {"state": tr.state, "ring": tr.ring}
    assert P.dumps_checkpoint(ttree, meta) == JP.dumps_checkpoint(jtree, meta)
    assert P.dumps_runner(tr, meta) == JP.dumps_runner(jr, meta)
    # The ring transfer's payload: one loaded row and its frame.
    assert P.dumps_checkpoint({"state": ts.ring_load(tr.ring, 5)}, {"frame": 5}) == \
        JP.dumps_checkpoint({"state": js.ring_load(jr.ring, 5)}, {"frame": 5})


@pytest.mark.parametrize("model", list(MODELS))
def test_each_package_loads_the_others_bytes(model):
    jr, tr = twin_runners(model)
    jbytes, tbytes = JP.dumps_runner(jr, {"k": 1}), P.dumps_runner(tr, {"k": 1})
    _, tfresh = twin_runners(model, frames=1)
    jfresh, _ = twin_runners(model, frames=1)
    meta = P.loads_runner(jbytes, tfresh)
    assert meta["k"] == 1 and tfresh.frame == jr.frame
    assert (tfresh.rollbacks_total, tfresh.rollback_frames_total) == (3, 11)
    assert same_leaves({"state": jr.state, "ring": jr.ring},
                       {"state": tfresh.state, "ring": tfresh.ring})
    assert tfresh.ring.checksums.dtype == torch.int64
    # Fresh tensors, not views of one another or of the decoded arrays.
    ptrs = [t.data_ptr() for t in port_leaves({"s": tfresh.state, "r": tfresh.ring})]
    assert len(set(ptrs)) == len(ptrs)
    JP.loads_runner(tbytes, jfresh)
    assert same_leaves({"state": jfresh.state, "ring": jfresh.ring},
                       {"state": tr.state, "ring": tr.ring})
    assert P.dumps_runner(tfresh, {"k": 1}) == jbytes
    # Both checksums agree on the loaded worlds.
    assert ts.combine64(ts.checksum(tfresh.state)) == js.combine64(js.checksum(jr.state))


def error_of(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_template_mismatch_errors_match_jax(tmp_path):
    tw = tbox.make_world(2, device="cpu").commit()
    jw = jbox.make_world(2).commit()
    p = str(tmp_path / "w.npz")
    P.save_checkpoint(p, tw)
    other_t = tbox.make_world(2, capacity=32, device="cpu").commit()
    other_j = jbox.make_world(2, capacity=32).commit()
    got = error_of(lambda: P.load_checkpoint(p, other_t))
    assert "template" in got
    assert got == error_of(lambda: JP.load_checkpoint(p, other_j))
    got = error_of(lambda: P.load_checkpoint(p, {"x": np.zeros(3)}))
    assert "does not match template" in got
    assert got == error_of(lambda: JP.load_checkpoint(p, {"x": np.zeros(3)}))
    # A ring template against a world's file names the missing and extra
    # paths as JAX does.
    got = error_of(lambda: P.load_checkpoint(p, ts.ring_init(tw, 3)))
    assert got == error_of(lambda: JP.load_checkpoint(p, js.ring_init(jw, 3)))
    # The other package's bytes validate against a template of this one.
    assert P.load_checkpoint(p, tw)[0].capacity == 16
    JP.load_checkpoint(p, jw)


def rewrite_as_v1(path):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    header = json.loads(bytes(arrays[P._HEADER_KEY]).decode())
    header["version"] = 1
    arrays[P._HEADER_KEY] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def test_v1_checks_match_jax(tmp_path):
    path = str(tmp_path / "old.npz")
    P.save_checkpoint(path, {"ring": {"checksums": np.zeros((5,), np.uint32)}})
    rewrite_as_v1(path)
    new = {"ring": {"checksums": np.zeros((5, 2), np.uint32)}}
    got = error_of(lambda: P.load_checkpoint(path, new))
    assert "predates 64-bit checksums" in got
    assert got == error_of(lambda: JP.load_checkpoint(path, new))
    # A v1 file of the current layout loads (ring lanes included).
    tw = tbox.make_world(2, device="cpu").commit()
    ring = ts.ring_init(tw, 4)
    ts.ring_save(ring, tw, 2)
    mid = str(tmp_path / "mid.npz")
    P.save_checkpoint(mid, ring)
    rewrite_as_v1(mid)
    loaded, _ = P.load_checkpoint(mid, ts.ring_init(tw, 4))
    assert torch.equal(loaded.checksums, ring.checksums)
    tree = {"ring": {"checksums": np.arange(10, dtype=np.uint32).reshape(5, 2)}}
    P.save_checkpoint(mid, tree)
    rewrite_as_v1(mid)
    got, _ = P.load_checkpoint(mid, tree)
    assert np.array_equal(got["ring"]["checksums"].numpy(), tree["ring"]["checksums"])
    # Another version fails its gate, as in JAX.
    header = {"version": 7, "paths": [], "metadata": {}}
    bad = str(tmp_path / "v7.npz")
    np.savez_compressed(bad, **{P._HEADER_KEY: np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)})
    assert error_of(lambda: P.load_checkpoint(bad, {})) == \
        error_of(lambda: JP.load_checkpoint(bad, {}))


def test_bfloat16_bytes_equal_and_both_refuse():
    rng = np.random.RandomState(4)
    values = rng.standard_normal((6, 3)).astype(np.float32)
    jtree = {"w": jnp.asarray(values, dtype=jnp.bfloat16), "n": jnp.arange(3)}
    ttree = {"w": torch.from_numpy(values).to(torch.bfloat16), "n": torch.arange(3, dtype=torch.int32)}
    tbytes = P.dumps_checkpoint(ttree)
    assert tbytes == JP.dumps_checkpoint(jtree)
    msg = error_of(lambda: P.loads_checkpoint(tbytes, ttree))
    assert msg == "checkpoint leaf ['w']: |V2[6, 3] != template bfloat16[6, 3]"
    assert msg == error_of(lambda: JP.loads_checkpoint(tbytes, jtree))


# ---------------------------------------------------------------------------
# tests/test_persistence.py on the port
# ---------------------------------------------------------------------------


def test_world_state_round_trip_bitwise(tmp_path):
    state = tbox.make_world(2, device="cpu").commit()
    p = str(tmp_path / "w.npz")
    P.save_checkpoint(p, state, {"note": "hello"})
    restored, meta = P.load_checkpoint(p, tbox.make_world(2, device="cpu").commit())
    assert meta == {"note": "hello"}
    assert ts.combine64(ts.checksum(restored)) == ts.combine64(ts.checksum(state))


def test_ring_round_trip(tmp_path):
    state = tbox.make_world(2, device="cpu").commit()
    ring = ts.ring_init(state, 4)
    ring, cs = ts.ring_save(ring, state, 2)
    p = str(tmp_path / "r.npz")
    P.save_checkpoint(p, ring)
    restored, _ = P.load_checkpoint(p, ts.ring_init(state, 4))
    assert int(restored.frames[2]) == 2
    assert ts.combine64(restored.checksums[2]) == ts.combine64(cs)


def make_pair(pkg="torch", num_players=2, check_distance=3, max_prediction=8, input_delay=0):
    if pkg == "jax":
        session = JSyncTest(num_players, jbox.INPUT_SPEC, check_distance=check_distance,
                            max_prediction=max_prediction, input_delay=input_delay)
        runner = JRunner(jbox.make_schedule(), jbox.make_world(num_players).commit(),
                         max_prediction=max_prediction, num_players=num_players,
                         input_spec=jbox.INPUT_SPEC)
        return session, runner
    session = SyncTestSession(num_players, tbox.INPUT_SPEC, check_distance=check_distance,
                              max_prediction=max_prediction, input_delay=input_delay)
    runner = RollbackRunner(tbox.make_schedule(), tbox.make_world(num_players, device="cpu").commit(),
                            max_prediction=max_prediction, num_players=num_players,
                            input_spec=tbox.INPUT_SPEC, device="cpu")
    return session, runner


def drive(session, runner, frames, seed_base=0, collect=None):
    for i in range(frames):
        for h in range(session.num_players):
            session.add_local_input(h, np.uint8((seed_base + i + h) % 16))
        runner.handle_requests(session.advance_frame(), session)
        if collect is not None:
            collect.append(ts.combine64(ts.checksum(runner.state)))


def test_synctest_runner_bytes_equal_jax():
    """The session's ``state_dict`` rides in the metadata: after the same
    frames a port SyncTest and a JAX one dump equal bytes."""
    (js_, jr), (tsn, tr) = make_pair("jax"), make_pair()
    for i in range(12):
        for h in range(2):
            js_.add_local_input(h, np.uint8((i + h) % 16))
            tsn.add_local_input(h, np.uint8((i + h) % 16))
        jr.handle_requests(js_.advance_frame(), js_)
        tr.handle_requests(tsn.advance_frame(), tsn)
    assert tsn.state_dict() == js_.state_dict()
    assert P.dumps_runner(tr, {"who": "test"}, session=tsn) == \
        JP.dumps_runner(jr, {"who": "test"}, session=js_)


@pytest.mark.parametrize("input_delay", [0, 2])
def test_crash_recovery_resumes_bitwise(tmp_path, input_delay):
    """Run B checkpoints at frame 12, crashes, and resumes in a fresh
    session and runner from the file; its checksum stream equals run D's,
    which never stopped (with input delay, the in-flight delayed inputs
    beyond ``current_frame`` are replayed, not gap-filled)."""
    sess_b, run_b = make_pair(input_delay=input_delay)
    trace_b = []
    drive(sess_b, run_b, 12, collect=trace_b)
    p = str(tmp_path / "crash.npz")
    P.save_runner(p, run_b, {"who": "test"}, session=sess_b)
    sess_c, run_c = make_pair(input_delay=input_delay)
    meta = P.restore_runner(p, run_c, session=sess_c)
    assert meta["who"] == "test"
    assert run_c.frame == run_b.frame
    assert sess_c.current_frame == sess_b.current_frame
    drive(sess_c, run_c, 18, seed_base=12, collect=trace_b)
    sess_d, run_d = make_pair(input_delay=input_delay)
    trace_d = []
    drive(sess_d, run_d, 12, collect=trace_d)
    drive(sess_d, run_d, 18, seed_base=12, collect=trace_d)
    assert trace_b == trace_d


def test_restore_is_all_or_nothing(tmp_path):
    """A checkpoint without session state leaves runner and session as they
    were."""
    sess, run = make_pair()
    drive(sess, run, 5)
    p = str(tmp_path / "nosession.npz")
    P.save_runner(p, run)
    sess2, run2 = make_pair()
    before = ts.combine64(ts.checksum(run2.state))
    with pytest.raises(ValueError, match="no session state"):
        P.restore_runner(p, run2, session=sess2)
    assert run2.frame == 0 and sess2.current_frame == 0
    assert ts.combine64(ts.checksum(run2.state)) == before


def test_manager_rolls_and_restores(tmp_path):
    mgr = P.CheckpointManager(str(tmp_path / "ckpts"), interval=5, keep=2)
    session, runner = make_pair()
    saved = []
    for _ in range(20):
        for h in range(2):
            session.add_local_input(h, np.uint8(runner.frame % 16))
        runner.handle_requests(session.advance_frame(), session)
        path = mgr.maybe_save(runner, session=session)
        if path:
            saved.append(path)
    assert len(saved) == 4
    assert sorted(x[0] for x in mgr._checkpoints()) == [15, 20]
    fresh_sess, fresh = make_pair()
    meta = mgr.restore_latest(fresh, session=fresh_sess)
    assert meta is not None and fresh.frame == 20
    assert fresh_sess.current_frame == session.current_frame
    assert ts.combine64(ts.checksum(fresh.state)) == ts.combine64(ts.checksum(runner.state))
    with pytest.raises(ValueError, match="positive"):
        P.CheckpointManager(str(tmp_path / "x"), interval=0)


def test_manager_restore_empty_dir(tmp_path):
    mgr = P.CheckpointManager(str(tmp_path / "none"), interval=5)
    _, runner = make_pair()
    assert mgr.restore_latest(runner) is None


def test_file_flip_is_jax_integrity_flip(tmp_path):
    """The port's ``flip_file_bit`` flips the same bit as JAX's for a seed."""
    data = bytes(range(256)) * 4
    a, b = tmp_path / "a", tmp_path / "b"
    for p in (a, b):
        p.write_bytes(data)
    assert integrity.flip_file_bit(str(a), np.random.RandomState(9))["bit"] == \
        jintegrity.flip_file_bit(str(b), np.random.RandomState(9))["bit"]
    assert a.read_bytes() == b.read_bytes() != data


def test_a_damaged_file_is_a_value_error(tmp_path):
    """Where the zip reader raises its own errors through JAX's loader (a
    byte flipped in compressed data fails the member's CRC), the port's
    loader raises ValueError naming the file, the error its manager skips."""
    tw = tbox.make_world(2, device="cpu").commit()
    good = str(tmp_path / "w.npz")
    P.save_checkpoint(good, tw)
    blob = open(good, "rb").read()
    for offset in range(60, len(blob)):
        bad = bytearray(blob)
        bad[offset] ^= 0xFF
        path = str(tmp_path / "bad.npz")
        with open(path, "wb") as f:
            f.write(bytes(bad))
        try:
            JP.load_checkpoint(path, jbox.make_world(2).commit())
        except (ValueError, KeyError):
            continue
        except Exception as e:  # the zip reader's own
            jax_error = type(e).__name__
            break
    assert jax_error in ("BadZipFile", "error")
    with pytest.raises(ValueError, match="is damaged"):
        P.load_checkpoint(path, tw)
    with pytest.raises(FileNotFoundError):
        P.load_checkpoint(str(tmp_path / "missing.npz"), tw)
