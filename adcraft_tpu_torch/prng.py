"""Explicit counter-based PRNG: threefry2x32, reproducing ``jax.random``.

Keys are ``(..., 2)`` int64 tensors holding two uint32 words, passed
explicitly as JAX passes keys; there is no global generator. A key with
leading axes is a batch of keys, and every sampler returns
``(*key_batch, *shape)`` -- the batched form of ``jax.vmap`` over keys.

Bit layouts follow JAX 0.9 with ``jax_threefry_partitionable=True``
(``jax/_src/prng.py``: ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_randint``, ``_normal_real``).
Every draw is bitwise equal to ``jax.random`` except ``normal``: it is
``sqrt(2) * erfinv(u)`` with XLA's float32 ``erf_inv`` polynomial ported
to plain tensor ops, and differs from JAX's in the last ulps for about 5%
of draws (``log1p`` ulps and XLA's FMA contraction; at most 2.4e-7
relative, tests/test_torch_prng.py).

uint32 words live in int64 tensors and are masked back to 32 bits after
every add and shift, since torch has no full uint32 arithmetic.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on broadcast tensors.

    All four inputs are int64 tensors (or ints) of uint32 values; the two
    output words broadcast over all of them.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2**32)``.

    JAX without x64 narrows the seed to int32 first, so seeds outside
    [-2**31, 2**32) have no JAX counterpart and are refused.
    """
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [-2**31, 2**32)")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _words(key: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key's two words, with ``ndim`` trailing unit axes to broadcast."""
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(
            f"key must be an int64 (..., 2) tensor, got {key.dtype} {tuple(key.shape)}"
        )
    pad = (1,) * ndim
    k0 = key[..., 0].reshape(key.shape[:-1] + pad)
    k1 = key[..., 1].reshape(key.shape[:-1] + pad)
    return k0, k1


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    k0, k1 = _words(key, 1)
    count = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, 0, count)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar uint32 ``data``."""
    k0, k1 = _words(key, 0)
    y0, y1 = threefry2x32(k0, k1, 0, int(data) & MASK32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 words as int64, ``(..., *shape)``."""
    shape = _shape(shape)
    k0, k1 = _words(key, len(shape))
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    y0, y1 = threefry2x32(k0, k1, count >> 32, count & MASK32)
    return y0 ^ y1


def uniform(
    key: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as a mantissa."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # bounds and span rounded to float32 as JAX computes them; Python
    # scalars keep the op free of host-to-device copies
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 results and scalar int bounds.

    Two words per value, combined modulo the span with JAX's multiplier
    (the same small bias as JAX).
    """
    minval, maxval = int(minval), int(maxval)
    i32 = np.iinfo(np.int32)
    if not (i32.min <= minval <= i32.max and i32.min <= maxval <= i32.max):
        raise ValueError("randint bounds must lie in the int32 range")
    k_hi, k_lo = split(key).unbind(-2)
    higher = random_bits(k_hi, shape)
    lower = random_bits(k_lo, shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    # JAX squares 2**16 % span in uint32, so for spans above 2**16 the
    # square wraps to 0 and the higher word drops out
    multiplier = (((2**16 % span) ** 2) & MASK32) % span
    # the product can pass 2**63 and wrap; only its low 32 bits are kept,
    # as in JAX's uint32 multiply
    offset = (((higher % span) * multiplier) & MASK32) + lower % span
    offset = (offset & MASK32) % span
    return (minval + offset).to(torch.int32)


# XLA's float32 erf_inv: Giles' single-precision polynomials in
# w = -log1p(-x^2), one for w < 5 and one for the tails
_ERFINV_W_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_W_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's algorithm in plain f32 ops.

    ``torch.erfinv`` is not used: on the CPU it is not reproducible from
    one process to the next (some runs take a path up to 6.6e-5 relative
    off XLA's). This agrees with XLA's ``erf_inv`` to 2e-7 relative; the
    rest is ``log1p`` ulps and XLA contracting ``c + p*w`` into FMAs.
    """
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i):
        return torch.where(lt, _ERFINV_W_LT5[i], _ERFINV_W_GE5[i])

    p = coefficient(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = coefficient(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``.

    ``u`` is bitwise JAX's; ``erfinv`` is XLA's algorithm, within 2.4e-7
    relative of JAX's draw (module docstring).
    """
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)).item() * erfinv(u)
