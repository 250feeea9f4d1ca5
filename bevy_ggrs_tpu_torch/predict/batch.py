"""Batched predictor ranking across the session axis, on a device.

Counterpart of ``bevy_ggrs_tpu/predict/batch.py``, where one jitted
integer forward ranks candidates for all S slots per dispatch. Here the
same program runs as torch operations on the ranker's device: the host
gathers each slot's ``[W, P]`` window of universe indices, and one call
runs the F-step autoregressive rollout and the first-step ranking for
every slot at once (F pairs of products, none per slot).

Bitwise contract: the same exact integer program as the host path in
``predict/model.py`` (int8 operands, int32 sums through
:func:`bevy_ggrs_tpu_torch.ops.exact.int_matmul`, the same clip and
shift, ``argmax`` taking the first maximum and a stable ``argsort``), so
``rank(...)`` equals the per-slot ``BoundPredictor.rollout`` element for
element on the CPU and on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.ops.exact import int_matmul
from bevy_ggrs_tpu_torch.predict.model import _NEG, BoundPredictor
from bevy_ggrs_tpu_torch.state import resolve_device


class BatchedRanker:
    """A :class:`BoundPredictor` for whole-batch ranking on ``device``
    (default ``cuda``, raising when there is no GPU).

    ``rank(windows[S, W, P], anchors[S])`` returns ``(traj_idx[S, F, P],
    order[S, P, V])`` as host numpy int32; the per-slot seeds then render
    exactly as the singleton path's (``BoundPredictor.render_seed``).
    """

    def __init__(self, bound: BoundPredictor, frames: int, device=None):
        w = bound.weights
        self.bound = bound
        self.frames = int(frames)
        self.device = resolve_device(device)
        dev = self.device
        self._w1 = torch.from_numpy(w.w1.copy()).to(dev)
        self._b1 = torch.from_numpy(w.b1.copy()).to(dev)
        self._w2 = torch.from_numpy(w.w2.copy()).to(dev)
        self._b2 = torch.from_numpy(w.b2.copy()).to(dev)
        self._slots = torch.arange(w.value_slots, dtype=torch.int32, device=dev)
        self._phases = torch.arange(w.phase_mod, dtype=torch.int32, device=dev)
        self._slot_ok = self._slots < len(bound.universe)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, P, in]`` int8 -> ``[S, P, SLOTS]`` int32 logits."""
        acc = int_matmul(x, self._w1) + self._b1
        h = torch.clamp(torch.clamp(acc, min=0) >> self.bound.weights.shift, max=127)
        return int_matmul(h.to(torch.int8), self._w2) + self._b2

    def rank(self, windows: np.ndarray,
             anchors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        w = self.bound.weights
        dev = self.device
        win = torch.from_numpy(np.ascontiguousarray(windows, dtype=np.int32)).to(dev)
        anchors = torch.from_numpy(np.ascontiguousarray(anchors, dtype=np.int32)).to(dev)
        S, W, P = win.shape
        V = len(self.bound.universe)
        trajs = []
        first = None
        for t in range(self.frames):
            phase = (anchors + t) % w.phase_mod  # [S]
            oh = (win[..., None] == self._slots).to(torch.int8)  # [S, W, P, SLOTS]
            feat = oh.permute(0, 2, 1, 3).reshape(S, P, W * w.value_slots)
            ph = (self._phases[None, :] == phase[:, None]).to(torch.int8)  # [S, PM]
            x = torch.cat([feat, ph[:, None, :].expand(S, P, w.phase_mod)], dim=-1)
            logits = torch.where(self._slot_ok, self._forward(x), int(_NEG))
            if t == 0:
                first = logits
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)  # the first maximum
            trajs.append(nxt)
            win = torch.cat([win[:, 1:, :], nxt[:, None, :]], dim=1)
        traj = torch.stack(trajs, dim=1)  # [S, F, P]
        order = torch.argsort(-first[..., :V], dim=-1, stable=True).to(torch.int32)
        return traj.cpu().numpy(), order.cpu().numpy()

    def warmup(self, num_slots: int, num_players: int) -> None:
        """One call at the serving shape, outside the serve loop."""
        self.rank(np.full((num_slots, self.bound.weights.window, num_players), -1,
                          dtype=np.int32),
                  np.ones(num_slots, dtype=np.int32))
