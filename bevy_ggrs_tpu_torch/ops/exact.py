"""Exact primitives with the same bits on the CPU and on the card.

The JAX package computes these outside any Pallas kernel, as XLA
operations whose bits the port must reproduce:

- :func:`int_matmul`: int8 x int8 products accumulated exactly in int32
  (``jnp.matmul(..., preferred_element_type=jnp.int32)``), the neural_bots
  policy's and the input predictor's products. torch's ``matmul`` of two
  int8 CPU tensors returns int8 and wraps around, and CUDA has no integer
  matmul in PyTorch, so the CPU widens both operands to int32 and the card
  multiplies them as float32: every product and partial sum is an integer
  of magnitude below 2**24, exact in float32 (and in TF32, whose 10-bit
  mantissa holds any |x| <= 127) whatever order the library sums in.
- :func:`tanh_f32`: XLA:CPU's float32 ``tanh``, the rational
  approximation Eigen also uses (clamp, odd numerator and even denominator
  in ``x**2`` by Horner steps with fused multiply-adds, a division, and
  ``x`` itself below 0.0004). JAX's ``jnp.tanh`` on the CPU gives these
  bits; torch's ``tanh`` does not.
- :func:`sqrt_f32`: the correctly rounded float32 root, taken in float64
  and rounded once; torch's vectorised float32 ``sqrt`` on the CPU is an
  ulp off for some inputs.

Each is a chain of IEEE operations that torch rounds the same way on
either device (float64 included), so a CUDA tensor and a CPU tensor with
the same values give the same bits. Nothing here moves work between
devices.
"""

from __future__ import annotations

import functools

import torch

# K * 127 * 127 must stay below 2**24 for a float32 sum of int8 products
# to be exact: K <= 1,040.
MAX_K = (1 << 24) // (127 * 127)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 (or 0/1) operands with exact int32 accumulation,
    over any leading batch axes that broadcast. Returns int32 on the
    operands' device."""
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    k = a.shape[-1]
    if k != b.shape[-2]:
        raise ValueError(f"inner sizes {k} and {b.shape[-2]} differ")
    if k * 127 * 127 >= 1 << 24:
        raise ValueError(f"K = {k} > {MAX_K}: a float32 sum of int8 products could round")
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(torch.int32)


# XLA:CPU's fast tanh (xla/service/llvm_ir/math_ops.cc EmitFastTanh, after
# Eigen's generic_fast_tanh_float), its coefficients as float32 values.
_CLAMP = 7.99881172180175781
_TINY = 0.0004
_ALPHA = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
          5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
          4.89352455891786e-03)  # alpha13 .. alpha1
_BETA = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
         4.89352518554385e-03)  # beta6 .. beta0


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


_ALPHA32 = tuple(_f32(c) for c in _ALPHA)
_BETA32 = tuple(_f32(c) for c in _BETA)


def round_sum_f32(p: torch.Tensor, c) -> torch.Tensor:
    """The float32 value nearest the exact sum ``p + c`` of float64 ``p``
    and ``c``: the float64 sum rounded to odd (TwoSum gives its error; an
    inexact sum is truncated toward zero and its last bit set), and a
    float64 rounded to odd rounds to float32 correctly: no double
    rounding. With ``p`` the exact float64 product of two float32 values,
    this is their fused multiply-add with ``c``."""
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    bits = s.view(torch.int64)
    # |s| past the exact sum (the error's sign opposite s's): one step
    # toward zero, then the odd bit.
    toward_zero = bits - ((err < 0) != (s < 0)).to(torch.int64)
    bits = torch.where(err.abs() > 0, toward_zero | 1, bits)
    return bits.view(torch.float64).float()


@functools.lru_cache(maxsize=None)
def _joint_coefficients(device: torch.device) -> torch.Tensor:
    """``[4, 2]`` float64: the numerator's and the denominator's first
    coefficients, then their next three, side by side."""
    rows = [(_ALPHA32[k], _BETA32[k]) for k in range(4)]
    return torch.tensor(rows, dtype=torch.float64, device=device)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``tanh`` with XLA:CPU's bits (see the module docstring).
    NaN gives NaN. The denominator's three Horner steps run beside the
    numerator's first three, as one ``[2, ...]`` tensor."""
    x = x.to(torch.float32)
    xc = x.clamp(-_CLAMP, _CLAMP)
    x2 = (xc * xc).double()
    coef = _joint_coefficients(x.device).view((4, 2) + (1,) * x.dim())
    pq = coef[0] * torch.ones_like(x2)
    for k in range(1, 4):
        pq = round_sum_f32(x2 * pq, coef[k]).double()
    p, q = pq[0], pq[1].float()
    for c in _ALPHA32[4:]:
        p = round_sum_f32(x2 * p, c).double()
    p = xc * p.float()
    return torch.where(x.abs() < _f32(_TINY), x, p / q)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x``: the
    float64 root rounded once to float32. XLA:CPU flushes subnormal inputs
    to zero and this does not; no model here roots a subnormal."""
    return torch.sqrt(x.double()).float()

