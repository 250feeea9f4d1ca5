"""Integer-only predictor forward + branch-tree seeding.

Counterpart of ``bevy_ggrs_tpu/predict/model.py`` (host NumPy, as there).
The whole forward is exact integer arithmetic — one-hot int8 features,
int8 weights, int32 accumulation (`x @ w` with int32 operands on host,
``ops.exact.int_matmul`` in the batched path), an integer clipped ReLU,
int32 logits — so the numpy host path here and the batched torch path in
``predict/batch.py`` produce **bitwise identical** outputs on every
device. That exactness is what lets predictor-seeded
trees keep the native/Python builder parity contract.

A ``BoundPredictor`` (weights bound to one session's input universe)
turns a MirroredLog window into a :class:`PredictorSeed`:

- ``traj``  — the F-step autoregressive argmax trajectory (the
  predictor's effective base; the builder re-pins confirmed inputs over
  it and keeps branch 0 repeat-last);
- ``cand``/``valid`` — the full universe ranked by the first-step
  logits (stable sort, ties to the lower index), replacing the
  recency/toggle heuristic rows in rank-major branch enumeration.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bevy_ggrs_tpu_torch.predict.artifact import (
    PredictorWeights,
    load_artifact,
    load_default,
)
from bevy_ggrs_tpu_torch.state import np_dtype

#: Sentinel logits mask for slots beyond the bound universe. Chosen so
#: its negation still fits int32 (ranking sorts on ``-logits``).
_NEG = np.int32(-(2 ** 31) + 1)


@dataclass(frozen=True)
class PredictorSeed:
    """One anchor's seed for the branch-tree builder (host arrays).

    ``traj`` is ``[F, P]`` in the session's input dtype (the raw
    predicted trajectory — the builder re-pins confirmed inputs).
    ``cand``/``valid`` are ``[P, 1, R]`` candidate values per player
    (n_field is always 1 where the predictor applies), best first.
    """

    traj: np.ndarray
    cand: np.ndarray
    valid: np.ndarray
    content_hash: int

    def fold_bytes(self) -> bytes:
        """Canonical bytes for signature folding (dedup safety)."""
        return (
            self.content_hash.to_bytes(8, "little")
            + self.traj.tobytes()
            + self.cand.tobytes()
            + self.valid.tobytes()
        )


class InputPredictor:
    """Weights + the numpy integer forward, universe-agnostic."""

    def __init__(self, weights: PredictorWeights):
        self.weights = weights
        # int32 operand copies: numpy promotes int8 @ int8 to int8 with
        # wraparound; widening first keeps the accumulation exact (the
        # batched path gets the same from ops.exact.int_matmul).
        self._w1 = weights.w1.astype(np.int32)
        self._b1 = weights.b1
        self._w2 = weights.w2.astype(np.int32)
        self._b2 = weights.b2

    @property
    def content_hash(self) -> int:
        return self.weights.content_hash

    def forward(self, x: np.ndarray) -> np.ndarray:
        """``[N, in_dim]`` 0/1 features -> ``[N, value_slots]`` int32
        logits. Exact integer program; no floats anywhere."""
        w = self.weights
        acc = x.astype(np.int32) @ self._w1 + self._b1
        h = np.minimum(np.right_shift(np.maximum(acc, 0), w.shift), 127)
        return h @ self._w2 + self._b2

    def bind(self, universe: Sequence[int], dtype,
             n_field: int = 1) -> Optional["BoundPredictor"]:
        """Bind to one session's input universe, or ``None`` when the
        predictor does not apply (multi-field payloads or universes
        wider than the trained value slots fall back to the heuristic
        ranker)."""
        uni = [int(v) for v in universe]
        if n_field != 1 or not uni or len(uni) > self.weights.value_slots:
            return None
        return BoundPredictor(self, uni, dtype)


class BoundPredictor:
    """An :class:`InputPredictor` bound to one input universe/dtype."""

    def __init__(self, predictor: InputPredictor,
                 universe: Sequence[int], dtype):
        self.predictor = predictor
        self.weights = predictor.weights
        self.universe = np.asarray(list(universe), dtype=np.int64)
        if isinstance(dtype, torch.dtype):
            self.dtype = np_dtype(dtype)
        else:
            self.dtype = np.dtype(dtype)
        self._index: Dict[int, int] = {
            int(v): i for i, v in enumerate(universe)
        }

    @property
    def content_hash(self) -> int:
        return self.predictor.content_hash

    # -- feature extraction -------------------------------------------
    def window_indices(self, input_log, anchor: int,
                       num_players: int) -> np.ndarray:
        """``[window, P]`` int32 universe indices for the frames
        ``anchor-window .. anchor-1`` (oldest first); ``-1`` marks a
        missing frame or an out-of-universe value. Pure function of the
        log contents — identical on every peer with the same confirmed
        history."""
        W = self.weights.window
        out = np.full((W, num_players), -1, dtype=np.int32)
        for w in range(W):
            frame = anchor - W + w
            row = input_log.get(frame) if frame >= 0 else None
            if row is None:
                continue
            vals = np.asarray(row).reshape(num_players)
            for h in range(num_players):
                out[w, h] = self._index.get(int(vals[h]), -1)
        return out

    def _features(self, win: np.ndarray, phase: int) -> np.ndarray:
        """``[P, in_dim]`` 0/1 int8 features from a ``[W, P]`` index
        window + target-frame phase."""
        w = self.weights
        P = win.shape[1]
        x = np.zeros((P, w.in_dim), dtype=np.int8)
        for wi in range(w.window):
            idx = win[wi]
            ok = idx >= 0
            x[np.flatnonzero(ok), wi * w.value_slots + idx[ok]] = 1
        x[:, w.window * w.value_slots + phase] = 1
        return x

    # -- rollout ------------------------------------------------------
    def rollout(self, win: np.ndarray, anchor: int, frames: int):
        """Autoregressive argmax rollout: ``([F, P]`` trajectory
        indices, ``[P, value_slots]`` first-step logits masked to the
        bound universe). Ties break to the lower index (numpy argmax
        first-max; the batched torch path matches)."""
        w = self.weights
        V = len(self.universe)
        P = win.shape[1]
        win = win.copy()
        traj = np.empty((frames, P), dtype=np.int32)
        slot_ok = np.arange(w.value_slots) < V
        first_logits = None
        for t in range(frames):
            phase = (anchor + t) % w.phase_mod
            logits = self.predictor.forward(self._features(win, phase))
            logits = np.where(slot_ok[None, :], logits, _NEG)
            if t == 0:
                first_logits = logits
            nxt = np.argmax(logits, axis=1).astype(np.int32)
            traj[t] = nxt
            win = np.concatenate([win[1:], nxt[None, :]])
        return traj, first_logits

    def render_seed(self, traj_idx: np.ndarray,
                    order: np.ndarray) -> PredictorSeed:
        """:class:`PredictorSeed` from rollout outputs — ``traj_idx``
        ``[F, P]`` universe indices and ``order`` ``[P, V]`` ranked
        universe indices. Shared by the host path (:meth:`seed`) and the
        batched ranker (``predict/batch.py``), so both render bitwise
        identically."""
        P = traj_idx.shape[1]
        V = len(self.universe)
        traj = self.universe[traj_idx].astype(self.dtype)
        cand = self.universe[order].astype(self.dtype)
        cand = np.ascontiguousarray(cand.reshape(P, 1, V))
        valid = np.ones((P, 1, V), dtype=bool)
        return PredictorSeed(
            traj=np.ascontiguousarray(traj),
            cand=cand, valid=valid,
            content_hash=self.content_hash,
        )

    def seed(self, input_log, anchor: int, frames: int,
             num_players: int) -> PredictorSeed:
        """The branch-tree seed for one anchor. Deterministic in
        ``(log window, anchor, frames, num_players)`` — no clocks, no
        RNG — so every peer computes the identical seed."""
        win = self.window_indices(input_log, anchor, num_players)
        traj_idx, logits = self.rollout(win, anchor, frames)
        # Rank the whole universe by first-step logits, best first;
        # stable sort on -logits => ties to the lower slot index.
        V = len(self.universe)
        order = np.argsort(
            -logits[:, :V], axis=1, kind="stable"
        ).astype(np.int32)
        return self.render_seed(traj_idx, order)


def resolve_predictor_config(predictor):
    """Flag/env/path resolution WITHOUT universe binding: the configured
    :class:`InputPredictor` (or :class:`BoundPredictor`, passed through),
    or ``None`` when prediction is off.

    ``predictor`` may be: ``None`` (consult ``GGRS_PREDICTOR`` — unset/
    ``0``/``off`` means no predictor, ``1``/``on``/``default`` means the
    committed default artifact, anything else is an artifact path),
    ``False`` (force off, ignoring the env), ``True``/``"default"``
    (the committed artifact), an artifact path, a
    :class:`PredictorWeights`, an :class:`InputPredictor`, or an
    already-bound :class:`BoundPredictor`.

    This is also the wire-handshake digest source: the session config
    digest is the resolved predictor's ``content_hash`` (0 when off),
    independent of whether the weights end up binding to a particular
    model's input geometry."""
    if predictor is None:
        env = os.environ.get("GGRS_PREDICTOR", "").strip()
        if not env or env.lower() in ("0", "off", "false"):
            return None
        predictor = (
            "default" if env.lower() in ("1", "on", "true", "default")
            else env
        )
    if predictor is False:
        return None
    if isinstance(predictor, (BoundPredictor, InputPredictor)):
        return predictor
    if isinstance(predictor, PredictorWeights):
        return InputPredictor(predictor)
    if predictor is True or predictor == "default":
        return InputPredictor(load_default())
    if isinstance(predictor, str):
        return InputPredictor(load_artifact(predictor))
    raise TypeError(
        f"predictor must be None/bool/'default'/path/weights, "
        f"got {type(predictor).__name__}"
    )


def resolve_predictor(predictor, universe, dtype,
                      n_field: int = 1) -> Optional[BoundPredictor]:
    """Uniform predictor resolution for every consumer (singleton
    runner, batched serve core, replay harness): config resolution via
    :func:`resolve_predictor_config`, then binding to one session's
    input universe.

    Returns the bound predictor, or ``None`` when off or when the
    weights don't apply to this input geometry (the caller falls back
    to the heuristic ranker)."""
    ip = resolve_predictor_config(predictor)
    if ip is None:
        return None
    if isinstance(ip, BoundPredictor):
        return ip
    return ip.bind(universe, dtype, n_field)
