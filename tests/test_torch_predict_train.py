"""PyTorch port, the predictor's offline trainer
(``bevy_ggrs_tpu_torch/predict/train.py``) against the JAX package's
(``bevy_ggrs_tpu/predict/train.py``), both numpy: at a small step count the
dataset, the float parameters, the quantized ``PredictorWeights`` bytes and
the replay scores are bitwise equal; the command line writes an artifact
that loads, and refuses to overwrite the shipped one unless asked.

About 7 s on one core.
"""

import numpy as np
import pytest

from bevy_ggrs_tpu.predict import train as jtrain
from bevy_ggrs_tpu_torch.predict import artifact as tartifact
from bevy_ggrs_tpu_torch.predict import train as ttrain

STEPS = 12


@pytest.fixture(scope="module")
def trained():
    out = {}
    for name, mod in (("jax", jtrain), ("port", ttrain)):
        win, phase, y = mod.build_dataset()
        x = mod._one_hot_features(win, phase)
        params, acc = mod.train_float(x, y, steps=STEPS, seed=0)
        out[name] = dict(data=(win, phase, y, x), params=params, acc=acc,
                         weights=mod.quantize(params))
    return out


def test_dataset_and_float_parameters_are_bitwise_jax(trained):
    jax_run, port = trained["jax"], trained["port"]
    for a, b in zip(jax_run["data"], port["data"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(port["params"]) == 4
    for a, b in zip(jax_run["params"], port["params"]):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    assert port["acc"] == jax_run["acc"]


def test_quantized_weights_and_scores_are_bitwise_jax(trained):
    jw, tw = trained["jax"]["weights"], trained["port"]["weights"]
    assert tw.to_bytes() == jw.to_bytes()
    assert tw.content_hash == jw.content_hash
    assert ttrain.score_quantized(tw, frames=60) == jtrain.score_quantized(jw, frames=60)


def test_the_command_line_writes_an_artifact(tmp_path, capsys):
    out = tmp_path / "weights.ggrspred"
    assert ttrain.main(["--out", str(out), "--steps", "1"]) == 0
    loaded = tartifact.load_artifact(str(out))
    assert f"content_hash: 0x{loaded.content_hash:016x}" in capsys.readouterr().out


def test_the_shipped_artifact_is_kept_unless_asked():
    shipped = open(tartifact.DEFAULT_ARTIFACT, "rb").read()
    with pytest.raises(SystemExit):
        ttrain.main(["--out", tartifact.DEFAULT_ARTIFACT, "--steps", "1"])
    assert open(tartifact.DEFAULT_ARTIFACT, "rb").read() == shipped
