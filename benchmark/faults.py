"""Faults planted under the timed path, which the comparison must catch.

Each breaks the program where it produces its answer, so that the rest of
a run (the window, the saves, the checksums, the comparison) goes on as
in a sound run:

- ``unchanged``: the flock step returns its state unchanged;
- ``half_batch``: half of the batch left out: the second half of the
  branches (or, in a single world, of the boids) keeps its state;
- ``altered_answer``: one boid's position altered where the step
  produces it;
- ``one_tile``: the dense force kernel gets one tile of rows wrong: the
  forces of one block of ``min(64, N // 16)`` boids (64 is a tile of the
  tensor-core kernels; under a tenth of the boids in every cell) come out
  at half their size, and the step integrates them as it would sound ones.

``python3 benchmark/calibrate.py --fault <name>`` reads a fault on the card
at a cell's own size; ``benchmark/tests`` plants each on the CPU.
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_batch", "altered_answer", "one_tile")


def _unchanged(boids):
    return lambda state, inputs: state


def _half_batch(boids):
    real = boids.flock_system_mxu

    def step(state, inputs):
        new = real(state, inputs)
        lead = state.alive.dim() > 1
        half = (state.alive.shape[0] if lead else state.capacity) // 2

        def keep(n, o):
            n = n.clone()
            n[half:] = o[half:]
            return n

        comps = {k: keep(new.components[k], state.components[k]) for k in new.components}
        return new.replace(components=comps)

    return step


def _altered_answer(boids):
    real = boids.flock_system_mxu

    def step(state, inputs):
        new = real(state, inputs)
        pos = new.components["position"].clone()
        pos[..., 3, 0] += 0.5
        return new.replace(components={**new.components, "position": pos})

    return step


def tile_rows(n: int) -> slice:
    """The boids whose forces ``one_tile`` gets wrong in an ``n``-boid world."""
    rows = max(1, min(64, n // 16))
    return slice(n // 2, n // 2 + rows)


class _OneTile:
    """A force kernel's wrapper with one tile of rows wrong; its name and
    launch count are the real wrapper's, which it calls."""

    def __init__(self, real):
        self.real = real
        self.__name__ = real.__name__

    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:  # the real wrapper counts through its global name
        self.real.launches = n

    def __call__(self, pos, *args, **kwargs):
        out = self.real(pos, *args, **kwargs).clone()
        out[..., tile_rows(pos.shape[-2]), :] *= 0.5
        return out


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place, restored on leaving."""
    from bevy_ggrs_tpu_torch.models import boids
    from bevy_ggrs_tpu_torch.ops import pairwise

    if name == "one_tile":
        swaps = [(pairwise, k) for k in ("pairwise_force_square_mxu_tri",
                                         "pairwise_force_rows_mxu2")]
        new = [_OneTile(getattr(m, k)) for m, k in swaps]
    else:
        swaps = [(boids._DENSE_SYSTEMS, "mxu")]
        new = [{"unchanged": _unchanged, "half_batch": _half_batch,
                "altered_answer": _altered_answer}[name](boids)]
    old = [m[k] if isinstance(m, dict) else getattr(m, k) for m, k in swaps]

    def put(values):
        for (m, k), v in zip(swaps, values):
            if isinstance(m, dict):
                m[k] = v
            else:
                setattr(m, k, v)

    put(new)
    try:
        yield
    finally:
        put(old)
