"""Learned input prediction: a tiny per-player input-transition MLP that
seeds candidate ranking in the speculative branch-tree builder.

Counterpart of ``bevy_ggrs_tpu/predict/`` (the trainer, ``train.py``, is
not ported). Its consumers: the replay harness (``obs/ledger.py``, policy
``learned``), the speculative runner through
``SessionBuilder.with_input_predictor`` and ``with_speculation(...,
predictor=)``, whose weights' content hash is the handshake's config
digest, and :class:`~bevy_ggrs_tpu_torch.predict.batch.BatchedRanker`,
the batched ranking on a device. Everything here is integer-only, so the
host forward and the batched one give the same bits.
"""

from bevy_ggrs_tpu_torch.predict.artifact import (
    DEFAULT_ARTIFACT,
    FORMAT_VERSION,
    PredictorWeights,
    load_artifact,
    load_default,
    save_artifact,
)
from bevy_ggrs_tpu_torch.predict.model import (
    BoundPredictor,
    InputPredictor,
    PredictorSeed,
    resolve_predictor,
    resolve_predictor_config,
)

__all__ = [
    "DEFAULT_ARTIFACT",
    "FORMAT_VERSION",
    "PredictorWeights",
    "load_artifact",
    "load_default",
    "save_artifact",
    "BoundPredictor",
    "InputPredictor",
    "PredictorSeed",
    "resolve_predictor",
    "resolve_predictor_config",
]
