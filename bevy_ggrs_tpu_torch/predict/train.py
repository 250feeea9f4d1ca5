"""Offline trainer for the default input-prediction artifact, on the port.

``python -m bevy_ggrs_tpu_torch.predict.train --out PATH`` writes an
artifact of the format of ``predict/default_weights.ggrspred``
**deterministically** (fixed seed,
fixed sample order, full-batch Adam) from the same canonical input
scripts the counterfactual replay harness scores against
(``obs/ledger.py _replay_configs``: the live paced pairs' key cycles
``keys[(frame // 3 + handle) % len(keys)]``).

Training is plain-numpy float32 — no new dependencies, seconds of CPU —
with the quantization constraint built in: hidden activations are
trained with a hard clip at ``127/64`` and weights are clamped to the
int8 range at scale 64 after every step, so the exported integer model
(``w_q = round(64 w)``, shift 0) is a faithful round-off of the float
one. The trainer then **re-scores the quantized integer model** with the
exact autoregressive rollout the live path uses and prints per-config
full-hit rates — what ships is measured, not the float proxy.

Float reproducibility across platforms is NOT required: the artifact is
committed, and its canonical bytes / content hash are what the
determinism contract covers (``predict/artifact.py``). The trainer needs
numpy only. ``--out`` is required, and the shipped artifact is replaced
only when ``--out`` names it and ``--replace-default`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

from bevy_ggrs_tpu_torch.predict.artifact import (
    DEFAULT_ARTIFACT,
    PredictorWeights,
    save_artifact,
)
from bevy_ggrs_tpu_torch.predict.model import InputPredictor

WINDOW = 12          # one full script period: disambiguates every cycle
VALUE_SLOTS = 32     # max universe width (projectiles uses all 32)
PHASE_MOD = 12
HIDDEN = 32
SHIFT = 0
_QW = 64.0           # int8 weight scale
_CAP = 127.0 / _QW   # trained activation clip == integer clip at 127


def _script_streams() -> List[Tuple[str, List[int], List[int], int, int]]:
    """(config, universe, per-frame values, players, spec_frames) per
    replay config, one stream per cycle phase offset."""
    from bevy_ggrs_tpu_torch.obs.ledger import _replay_configs

    out = []
    for name, cfg in _replay_configs().items():
        uni = list(cfg["input_spec"].values)
        out.append((name, uni, list(cfg["keys"]), int(cfg["players"]),
                    int(cfg["spec_frames"])))
    return out


def build_dataset(frames: int = 264):
    """One sample per (config, cycle offset, frame>=1): the truncated
    window of preceding universe indices (-1 = not yet logged), the
    target frame's phase, and the true next index. Cold-start windows
    are trained on deliberately — early replay anchors see them."""
    xs_win: List[List[int]] = []
    xs_phase: List[int] = []
    ys: List[int] = []
    for _name, uni, keys, _p, _f in _script_streams():
        index = {v: i for i, v in enumerate(uni)}
        for h in range(len(keys)):
            idxs = [
                index[keys[((f // 3) + h) % len(keys)]]
                for f in range(frames)
            ]
            for f in range(1, frames):
                lo = max(0, f - WINDOW)
                win = [-1] * (WINDOW - (f - lo)) + idxs[lo:f]
                xs_win.append(win)
                xs_phase.append(f % PHASE_MOD)
                ys.append(idxs[f])
    return (np.asarray(xs_win, dtype=np.int32),
            np.asarray(xs_phase, dtype=np.int32),
            np.asarray(ys, dtype=np.int32))


def _one_hot_features(win: np.ndarray, phase: np.ndarray) -> np.ndarray:
    n = win.shape[0]
    in_dim = WINDOW * VALUE_SLOTS + PHASE_MOD
    x = np.zeros((n, in_dim), dtype=np.float32)
    rows = np.arange(n)
    for w in range(WINDOW):
        ok = win[:, w] >= 0
        x[rows[ok], w * VALUE_SLOTS + win[ok, w]] = 1.0
    x[rows, WINDOW * VALUE_SLOTS + phase] = 1.0
    return x


def train_float(x: np.ndarray, y: np.ndarray, steps: int,
                seed: int = 0, lr: float = 0.02):
    """Full-batch Adam on softmax CE with the quantization constraints
    (activation clip at 127/64, weights clamped to int8 range / 64)."""
    rng = np.random.RandomState(seed)
    n, in_dim = x.shape
    w1 = rng.normal(0.0, 0.08, (in_dim, HIDDEN)).astype(np.float32)
    b1 = np.zeros(HIDDEN, dtype=np.float32)
    w2 = rng.normal(0.0, 0.08, (HIDDEN, VALUE_SLOTS)).astype(np.float32)
    b2 = np.zeros(VALUE_SLOTS, dtype=np.float32)
    params = [w1, b1, w2, b2]
    m = [np.zeros_like(p) for p in params]
    v = [np.zeros_like(p) for p in params]
    onehot = np.zeros((n, VALUE_SLOTS), dtype=np.float32)
    onehot[np.arange(n), y] = 1.0
    for step in range(1, steps + 1):
        z1 = x @ params[0] + params[1]
        h = np.clip(z1, 0.0, _CAP)
        logits = h @ params[2] + params[3]
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        p = e / e.sum(axis=1, keepdims=True)
        dlogits = (p - onehot) / n
        grads = [None] * 4
        grads[2] = h.T @ dlogits
        grads[3] = dlogits.sum(axis=0)
        dh = dlogits @ params[2].T
        dz1 = dh * ((z1 > 0.0) & (z1 < _CAP))
        grads[0] = x.T @ dz1
        grads[1] = dz1.sum(axis=0)
        for i in range(4):
            m[i] = 0.9 * m[i] + 0.1 * grads[i]
            v[i] = 0.999 * v[i] + 0.001 * grads[i] ** 2
            mh = m[i] / (1.0 - 0.9 ** step)
            vh = v[i] / (1.0 - 0.999 ** step)
            params[i] = params[i] - lr * mh / (np.sqrt(vh) + 1e-8)
        # Keep weights representable in int8 at scale 64.
        np.clip(params[0], -_CAP, _CAP, out=params[0])
        np.clip(params[2], -_CAP, _CAP, out=params[2])
    z1 = x @ params[0] + params[1]
    h = np.clip(z1, 0.0, _CAP)
    acc = float(np.mean(
        np.argmax(h @ params[2] + params[3], axis=1) == y
    ))
    return params, acc


def quantize(params) -> PredictorWeights:
    w1, b1, w2, b2 = params
    return PredictorWeights(
        weight_version=1, window=WINDOW, value_slots=VALUE_SLOTS,
        phase_mod=PHASE_MOD, hidden=HIDDEN, shift=SHIFT,
        w1=np.clip(np.round(w1 * _QW), -127, 127).astype(np.int8),
        b1=np.round(b1 * _QW).astype(np.int32),
        w2=np.clip(np.round(w2 * _QW), -127, 127).astype(np.int8),
        b2=np.round(b2 * _QW * _QW).astype(np.int32),
    )


def score_quantized(weights: PredictorWeights,
                    frames: int = 240) -> Dict[str, float]:
    """Full-hit rate of the shipped integer model per replay config,
    using the exact autoregressive rollout the live path runs: anchor a
    sees the true log for frames < a and must predict all P players for
    all spec_frames frames."""
    pred = InputPredictor(weights)
    out: Dict[str, float] = {}
    for name, uni, keys, players, spec_frames in _script_streams():
        bound = pred.bind(uni, np.uint8)
        assert bound is not None
        truth = np.empty((frames, players), dtype=np.uint8)
        for f in range(frames):
            for h in range(players):
                truth[f, h] = keys[((f // 3) + h) % len(keys)]
        log = {f: truth[f] for f in range(frames)}
        hits = anchors = 0
        for a in range(1, max(2, frames - spec_frames)):
            seed = bound.seed(log, a, spec_frames, players)
            anchors += 1
            hits += int(np.array_equal(seed.traj, truth[a:a + spec_frames]))
        out[name] = hits / max(1, anchors)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="artifact path to write")
    ap.add_argument("--replace-default", action="store_true",
                    help="allow --out to name the shipped default artifact")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shipped = os.path.realpath(DEFAULT_ARTIFACT)
    if os.path.realpath(args.out) == shipped and not args.replace_default:
        ap.error(f"--out names the shipped artifact {DEFAULT_ARTIFACT}; "
                 "pass --replace-default to overwrite it")

    win, phase, y = build_dataset()
    x = _one_hot_features(win, phase)
    print(f"dataset: {x.shape[0]} samples, in_dim={x.shape[1]}")
    params, float_acc = train_float(x, y, steps=args.steps,
                                    seed=args.seed)
    weights = quantize(params)
    print(f"float train accuracy: {float_acc:.4f}")
    scores = score_quantized(weights)
    for name, rate in scores.items():
        print(f"quantized full-hit {name}: {rate:.4f}")
    h = save_artifact(weights, args.out)
    print(f"wrote {args.out}")
    print(f"content_hash: 0x{h:016x}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
