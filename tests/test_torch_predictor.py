"""PyTorch port, the learned input predictor (``predict/``) and the replay
harness (``obs/ledger.py``).

The artifact's bytes, its content hash and the default file's SHA-256
equal the JAX package's; ``GGRS_PREDICTOR`` resolves as there; the host
seed and the batched ranker are bitwise JAX's and the host rollout;
builder digests are the weights' hash, matching digests synchronize and
mismatched ones are refused with a typed ``CONFIG_MISMATCH`` event;
predictor-seeded trees are bitwise JAX's on the native and the Python
builder; the port's replay scores equal JAX's. Sessions with the
predictor are in ``test_torch_predictor_sessions.py``.
"""

import hashlib
import os

import numpy as np
import pytest

import chip_smoke
from bevy_ggrs_tpu import predict as jpred
from bevy_ggrs_tpu.obs import ledger as jledger
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.predict.batch import BatchedRanker as JRanker
from bevy_ggrs_tpu.spec_runner import SpeculativeRollbackRunner as JSpecRunner
from bevy_ggrs_tpu_torch import predict as tpred
from bevy_ggrs_tpu_torch import spec_runner as tsr
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.native import spec as native_spec
from bevy_ggrs_tpu_torch.obs import ledger as tledger
from bevy_ggrs_tpu_torch.ops import checksum as tck
from bevy_ggrs_tpu_torch.predict.batch import BatchedRanker
from bevy_ggrs_tpu_torch.schedule import InputSpec
from bevy_ggrs_tpu_torch.session import EventKind, PlayerType, SessionBuilder, SessionState
from bevy_ggrs_tpu_torch.spec_runner import SpeculativeRollbackRunner as TSpecRunner
from bevy_ggrs_tpu_torch.transport import LoopbackNetwork
from tests.test_torch_models_p2p import key_table

UNIVERSE = list(range(16))
DEFAULT_SHA256 = "183bedc625ff24ba680a215715ca8bfa2a73d30af23e6c7dcf889e51db271bbc"
FPS_DT = 1.0 / 60.0


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------


def test_default_artifact_is_the_jax_packages_file():
    with open(tpred.DEFAULT_ARTIFACT, "rb") as f:
        port_bytes = f.read()
    with open(jpred.DEFAULT_ARTIFACT, "rb") as f:
        jax_bytes = f.read()
    assert port_bytes == jax_bytes and len(port_bytes) == 13988
    assert hashlib.sha256(port_bytes).hexdigest() == DEFAULT_SHA256
    assert os.path.dirname(tpred.DEFAULT_ARTIFACT).endswith("bevy_ggrs_tpu_torch/predict")
    w = tpred.load_default()
    assert (port_bytes[:8], w.window, w.value_slots, w.phase_mod, w.hidden, w.shift) == (
        b"GGRSPRED", 12, 32, 12, 32, 0)
    assert w.to_bytes() == port_bytes == jpred.load_default().to_bytes()
    assert w.content_hash == jpred.load_default().content_hash
    assert w.content_hash == int.from_bytes(hashlib.sha256(port_bytes).digest()[:8], "big")


def test_artifact_round_trip_and_refusals(tmp_path):
    w = tpred.load_default()
    w1 = np.array(w.w1, copy=True)
    w1[0, 0] = np.int8(int(w1[0, 0]) ^ 1)
    other = tpred.PredictorWeights(w.weight_version, w.window, w.value_slots, w.phase_mod,
                                   w.hidden, w.shift, w1, w.b1, w.w2, w.b2)
    path = str(tmp_path / "p.ggrspred")
    assert tpred.save_artifact(other, path) == other.content_hash != w.content_hash
    assert tpred.load_artifact(path).to_bytes() == other.to_bytes()
    jother = jpred.PredictorWeights(w.weight_version, w.window, w.value_slots, w.phase_mod,
                                    w.hidden, w.shift, w1, w.b1, w.w2, w.b2)
    assert jother.to_bytes() == other.to_bytes()
    data = w.to_bytes()
    for bad, match in ((b"XXXXXXXX" + data[8:], "not a GGRSPRED"),
                       (data[:-4], "truncated"), (data + b"\x00", "trailing")):
        with pytest.raises(ValueError, match=match):
            tpred.PredictorWeights.from_bytes(bad)


def test_resolve_config_env_semantics(monkeypatch):
    monkeypatch.delenv("GGRS_PREDICTOR", raising=False)
    assert tpred.resolve_predictor_config(None) is None
    for off in ("0", "off", "false"):
        monkeypatch.setenv("GGRS_PREDICTOR", off)
        assert tpred.resolve_predictor_config(None) is None
    digest = tpred.load_default().content_hash
    for on in ("1", "on", "true", "default", tpred.DEFAULT_ARTIFACT):
        monkeypatch.setenv("GGRS_PREDICTOR", on)
        ip = tpred.resolve_predictor_config(None)
        assert isinstance(ip, tpred.InputPredictor) and ip.content_hash == digest
    assert tpred.resolve_predictor_config(False) is None
    for given in (True, "default", tpred.load_default(), tpred.InputPredictor(
            tpred.load_default())):
        assert tpred.resolve_predictor_config(given).content_hash == digest
    bound = tpred.resolve_predictor(True, UNIVERSE, np.uint8)
    assert tpred.resolve_predictor_config(bound) is bound
    with pytest.raises(TypeError):
        tpred.resolve_predictor_config(3.14)


def test_bind_applies_only_to_narrow_scalar_universes():
    """The reference's rule, not a fallback: a universe wider than the 32
    trained value slots, or a vector payload, binds to None (the tree
    keeps its heuristic ranking)."""
    ip = tpred.InputPredictor(tpred.load_default())
    assert ip.bind(list(range(32)), np.uint8) is not None
    assert ip.bind(list(range(33)), np.uint8) is None
    assert ip.bind(UNIVERSE, np.uint8, n_field=2) is None
    assert ip.bind([], np.uint8) is None
    runner = TSpecRunner(tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
                         max_prediction=8, num_players=2, input_spec=tbox.INPUT_SPEC,
                         num_branches=4, branch_values=list(range(40)), predictor=True,
                         device="cpu", attest=False)
    assert runner._predictor is None


# ---------------------------------------------------------------------------
# Seeds and ranking against the JAX package
# ---------------------------------------------------------------------------


def random_log(rng, players, frames):
    keys = [1, 8, 2, 0]
    log = {}
    for f in range(frames):
        row = np.array([keys[(f // 3 + h) % 4] for h in range(players)], np.uint8)
        if rng.rand() < 0.15:
            row = rng.randint(0, 16, size=players).astype(np.uint8)
        if rng.rand() > 0.1:  # gaps
            log[f] = row
    return log


@pytest.mark.parametrize("players", [1, 2, 8])
def test_host_seed_bitwise_jax(players):
    tb = tpred.InputPredictor(tpred.load_default()).bind(UNIVERSE, np.uint8)
    jb = jpred.InputPredictor(jpred.load_default()).bind(UNIVERSE, np.uint8)
    rng = np.random.RandomState(players)
    for trial in range(10):
        log = random_log(rng, players, int(rng.randint(0, 40)))
        anchor = max(log, default=0) + int(rng.randint(0, 3))
        frames = int(rng.choice([4, 8, 12]))
        a, b = tb.seed(log, anchor, frames, players), jb.seed(log, anchor, frames, players)
        assert a.fold_bytes() == b.fold_bytes()
        assert a.traj.dtype == b.traj.dtype and a.cand.shape == b.cand.shape


@pytest.mark.parametrize("players,frames", [(2, 8), (8, 12)])
def test_cpu_batched_ranker_bitwise_jax_and_host(players, frames):
    tb = tpred.InputPredictor(tpred.load_default()).bind(UNIVERSE, np.uint8)
    jb = jpred.InputPredictor(jpred.load_default()).bind(UNIVERSE, np.uint8)
    win, anchors = chip_smoke.ranker_windows(tb, 16, players, seed=frames)
    traj, order = BatchedRanker(tb, frames, device="cpu").rank(win, anchors)
    jtraj, jorder = JRanker(jb, frames).rank(win, anchors)
    assert traj.dtype == np.int32 and order.dtype == np.int32
    assert np.array_equal(traj, jtraj) and np.array_equal(order, jorder)
    chip_smoke.check_ranker("cpu", slots=16)  # the host rollout, slot by slot


# ---------------------------------------------------------------------------
# The handshake digest
# ---------------------------------------------------------------------------


def test_builder_digests_equal_jax(monkeypatch):
    from bevy_ggrs_tpu.session import SessionBuilder as JBuilder

    monkeypatch.delenv("GGRS_PREDICTOR", raising=False)
    digest = tpred.load_default().content_hash
    for predictor, want in ((None, 0), (False, 0), (True, digest), ("default", digest),
                            (tpred.DEFAULT_ARTIFACT, digest)):
        port = SessionBuilder(tbox.INPUT_SPEC).with_input_predictor(predictor)
        jax_b = JBuilder(jbox.INPUT_SPEC).with_input_predictor(predictor)
        assert port._config_digest() == jax_b._config_digest() == want
    monkeypatch.setenv("GGRS_PREDICTOR", "1")
    assert SessionBuilder(tbox.INPUT_SPEC)._config_digest() == digest
    with pytest.raises((TypeError, OSError, ValueError)):
        SessionBuilder(tbox.INPUT_SPEC).with_input_predictor("/nonexistent/weights.ggrspred")


def start_pair(predictors):
    network = LoopbackNetwork()
    sessions = []
    for me, predictor in enumerate(predictors):
        b = (SessionBuilder(tbox.INPUT_SPEC).with_num_players(2)
             .with_max_prediction_window(8).with_input_predictor(predictor))
        for h in range(2):
            b.add_player(PlayerType.local() if h == me else PlayerType.remote(("peer", h)), h)
        sessions.append(b.start_p2p_session(network.socket(("peer", me)),
                                            clock=lambda: network.now))
    events = []
    for _ in range(120):
        network.advance(FPS_DT)
        for s in sessions:
            s.poll_remote_clients()
            events.extend(s.events())
    return sessions, events


@pytest.mark.parametrize("predictors,synchronize", [
    ((True, True), True), ((False, False), True), ((True, False), False),
])
def test_digests_synchronize_or_refuse(predictors, synchronize, monkeypatch):
    monkeypatch.delenv("GGRS_PREDICTOR", raising=False)
    sessions, events = start_pair(predictors)
    running = [s.current_state() == SessionState.RUNNING for s in sessions]
    assert running == [synchronize] * 2
    mismatches = [e for e in events if e.kind == EventKind.CONFIG_MISMATCH]
    assert not any(e.kind == EventKind.DESYNC_DETECTED for e in events)
    if synchronize:
        assert not mismatches
    else:
        assert mismatches
        for e in mismatches:
            assert {e.data["local_digest"], e.data["peer_digest"]} == {
                0, tpred.load_default().content_hash}


# ---------------------------------------------------------------------------
# Predictor-seeded trees
# ---------------------------------------------------------------------------


class _Bag:
    """A runner's tree methods, unbound, on a bare host object (the replay
    harness's borrow)."""

    def __init__(self, runner_cls, spec, players, branches, frames):
        self.input_spec = spec
        self.num_players = players
        self.num_branches = branches
        self.spec_frames = frames
        self._branch_values = list(UNIVERSE)
        self._input_log = {}
        for name in ("_candidate_values", "_extrapolate_base", "_structured_bits",
                     "_history_fingerprint"):
            setattr(self, name, getattr(runner_cls, name).__get__(self))


def test_seeded_trees_bitwise_jax_native_and_python():
    """Random logs, known prefixes and geometries: the port's Python tree
    and its native builder, both seeded by the port's predictor, equal
    the JAX package's seeded Python tree; the seed changes the native
    dedup signature, and branch 0 stays the forward fill."""
    from bevy_ggrs_tpu.schedule import InputSpec as JInputSpec

    rng = np.random.RandomState(7)
    tb = tpred.InputPredictor(tpred.load_default()).bind(UNIVERSE, np.uint8)
    jb = jpred.InputPredictor(jpred.load_default()).bind(UNIVERSE, np.uint8)
    for trial in range(12):
        players = int(rng.choice([2, 4]))
        frames = int(rng.choice([4, 8]))
        branches = int(rng.choice([8, 64]))
        tspec = InputSpec(shape=(), values=tuple(UNIVERSE))
        jspec = JInputSpec(shape=(), dtype=np.uint8, values=tuple(UNIVERSE))
        tbag = _Bag(TSpecRunner, tspec, players, branches, frames)
        jbag = _Bag(JSpecRunner, jspec, players, branches, frames)
        nat = native_spec.make_spec_builder(tspec, players, branches, frames, UNIVERSE)
        assert nat is not None
        log = random_log(rng, players, int(rng.randint(0, 24)))
        for f, row in log.items():
            tbag._input_log[f] = jbag._input_log[f] = row
            nat.log_set(f, row)
        anchor = max(log, default=-1) + 1
        last = log.get(anchor - 1, np.zeros(players, np.uint8))
        known = np.zeros((frames, players), np.uint8)
        mask = np.zeros((frames, players), bool)
        for p in range(players):
            k = rng.randint(0, frames)
            mask[:k, p] = True
            known[:k, p] = rng.randint(0, 16, size=k)
        _, sig_off = nat.build(anchor, None, known, mask, False, None)
        tbag._predictor, jbag._predictor = tb, jb
        t_on = tbag._structured_bits(last, known, mask, anchor)
        j_on = jbag._structured_bits(last, known, mask, anchor)
        nat.seed(anchor, tb.seed(tbag._input_log, anchor, frames, players))
        n_on, sig_on = nat.build(anchor, None, known, mask, False, None)
        assert np.array_equal(t_on, j_on) and np.array_equal(n_on, j_on)
        if log:
            assert sig_on != sig_off
        del tbag._predictor
        t_off = tbag._structured_bits(last, known, mask, anchor)
        assert np.array_equal(t_on[0], t_off[0])


@pytest.mark.parametrize("python", [False, True], ids=["native", "GGRS_NO_NATIVE"])
def test_runner_trees_with_the_predictor_equal_jax(python, monkeypatch):
    """A live port runner with the default predictor, native or under
    ``GGRS_NO_NATIVE=1``: its next tree equals the JAX runner's seeded
    tree for the same log, and the attestation key folds the weights."""
    if python:
        monkeypatch.setenv("GGRS_NO_NATIVE", "1")
    monkeypatch.setattr(tsr, "_ATTEST_MEMO", {})
    runner = TSpecRunner(tbox.make_schedule(), tbox.make_world(2, device="cpu").commit(),
                         max_prediction=8, num_players=2, input_spec=tbox.INPUT_SPEC,
                         num_branches=16, predictor="default", device="cpu", attest=False)
    assert (runner._native is None) == python
    jrunner = JSpecRunner(jbox.make_schedule(), jbox.make_world(2).commit(), max_prediction=8,
                          num_players=2, input_spec=jbox.INPUT_SPEC, num_branches=16,
                          predictor="default", attest=False)
    table = key_table([1, 8, 2, 0], 40)
    for f in range(30):
        runner._input_log[f] = table[f]
        jrunner._input_log[f] = table[f]
    bits, sig = runner._next_tree(30, 31, None, allow_skip=False)
    known = np.zeros((8, 2), np.uint8)
    mask = np.zeros((8, 2), bool)
    want = jrunner._structured_bits(table[29], known, mask, 30)
    assert np.array_equal(bits, want)
    assert runner.predictor_rank_builds == 1
    assert tsr._attestation_key(runner)[-1] == tpred.load_default().content_hash


# ---------------------------------------------------------------------------
# The replay harness
# ---------------------------------------------------------------------------


def test_policy_registry_has_learned():
    assert tledger.POLICIES == tuple(jledger.POLICIES) == ("current", "repeat_last", "learned")
    assert set(tledger._replay_configs()) == set(jledger._replay_configs())


@pytest.mark.parametrize("config", ["box_game", "boids", "projectiles", "neural_bots",
                                    "box_game_8p_B1024"])
def test_replay_config_equals_jax(config):
    frames = 120 if config == "box_game_8p_B1024" else 240
    cfg_t, cfg_j = tledger._replay_configs()[config], jledger._replay_configs()[config]
    assert {k: v for k, v in cfg_t.items() if k != "input_spec"} == {
        k: v for k, v in cfg_j.items() if k != "input_spec"}
    got = tledger.replay_config(config, cfg_t, frames)
    want = jledger.replay_config(config, cfg_j, frames)
    assert got == want
    assert got["learned"]["full_hits"] > got["repeat_last"]["full_hits"]


def test_replay_command_line(tmp_path):
    out = tmp_path / "baseline.json"
    assert tledger.main(["replay", "--frames", "30", "--configs", "neural_bots",
                         "--out", str(out)]) == 0
    import json

    table = json.loads(out.read_text())
    assert table["generated_by"] == "python -m bevy_ggrs_tpu_torch.obs.ledger replay"
    assert set(table["configs"]["neural_bots"]["policies"]) == set(tledger.POLICIES)
