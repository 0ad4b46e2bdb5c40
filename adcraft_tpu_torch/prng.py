"""Explicit counter-based PRNG: threefry2x32, reproducing ``jax.random``.

Keys are ``(..., 2)`` int64 tensors holding two uint32 words, passed
explicitly as JAX passes keys; there is no global generator. A key with
leading axes is a batch of keys, and every sampler returns
``(*key_batch, *shape)`` -- the batched form of ``jax.vmap`` over keys.

Bit layouts follow JAX 0.9 with ``jax_threefry_partitionable=True``
(``jax/_src/prng.py``: ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_randint``, ``_normal_real``).
Every draw is bitwise equal to ``jax.random``: ``normal`` is ``sqrt(2) *
erf_inv(u)`` on XLA's own ``log1p`` and ``erf_inv`` (``xla_math``).

uint32 words live in int64 tensors, since torch has no full uint32
arithmetic. ``split``, ``fold_in``, ``random_bits`` and ``normal`` take their words
from ``prng_kernel.threefry_words``: the CUDA kernel for CUDA keys, the
plain ``prng_kernel.threefry2x32`` for CPU keys. ``normal``'s float
transform runs in the same launch (its normal mode); the other float and
integer transforms on top of the words are tensor ops.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from adcraft_tpu_torch import prng_kernel, xla_math
from adcraft_tpu_torch.prng_kernel import MASK32

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(0, seed mod 2**32)``.

    JAX without x64 narrows the seed to int32 first, so seeds outside
    [-2**31, 2**32) have no JAX counterpart and are refused.
    """
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [-2**31, 2**32)")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _key_rows(key: torch.Tensor) -> torch.Tensor:
    """The key batch as ``(N, 2)`` rows, a view wherever the strides allow."""
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(
            f"key must be an int64 (..., 2) tensor, got {key.dtype} {tuple(key.shape)}"
        )
    return key.reshape(-1, 2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    words = prng_kernel.threefry_words(_key_rows(key), num, prng_kernel.PAIR)
    return words.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar uint32 ``data``."""
    words = prng_kernel.threefry_words(
        _key_rows(key), 1, prng_kernel.PAIR, base=int(data) & MASK32
    )
    return words.reshape(key.shape)


def random_bits(key: torch.Tensor, shape: Shape, bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: uint words as int64, ``(..., *shape)``.

    ``bit_width`` 32 or 16. A 16-bit draw is the low half of the 32-bit
    word at the same counter, which is what JAX 0.9 computes under
    partitionable threefry (``lax.convert_element_type`` of ``bits1 ^
    bits2``): it does not pack two 16-bit draws into one word.
    """
    shape = _shape(shape)
    words = prng_kernel.threefry_words(
        _key_rows(key), math.prod(shape), prng_kernel.XOR, bit_width=bit_width
    )
    return words.reshape(key.shape[:-1] + shape)


def uniform(
    key: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as a mantissa."""
    return prng_kernel.uniform_from_words(random_bits(key, shape), minval, maxval)


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


def uniform_open(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal``'s uniform on [nextafter(-1, 0), 1)."""
    return uniform(key, shape, prng_kernel.NORMAL_LO, 1.0)


def normal_erfinv(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``erf_inv(u)`` of ``jax.random.normal``'s uniform: the normal is this
    times ``xla_math.SQRT2``, a product that jitted XLA folds into a
    constant factor of the draw's scale where there is one, so callers
    apply it."""
    return xla_math.erfinv(uniform_open(key, shape))


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32, ``sqrt(2) * erf_inv(u)``: on CUDA
    keys one ``threefry_words`` launch in normal mode."""
    shape = _shape(shape)
    draws = prng_kernel.threefry_words(_key_rows(key), math.prod(shape), prng_kernel.NORMAL)
    return draws.reshape(key.shape[:-1] + shape)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``(..., 2)`` keys -> ``(..., n)``
    int64 permutations of ``arange(n)``. JAX's ``_shuffle``: ``ceil(3 ln n /
    ln(2**32 - 1))`` rounds (1 up to n = 1625, 2 above), each a ``split``
    and a stable sort of ``arange``'s current order by 32-bit words."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape: Shape) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32 for scalar bounds:
    ``sqrt(2) erf_inv(u)`` of a uniform on [erf(lower / sqrt(2)),
    erf(upper / sqrt(2))), on XLA's ``erf`` and ``erf_inv``, clipped to
    the open interval (the bounds' float32 neighbours inside it)."""
    lo, hi = np.float32(lower), np.float32(upper)
    # jitted XLA divides by the constant sqrt(2) as a product with its
    # float32 reciprocal; the erfs of the two bounds are scalars
    bounds = torch.tensor([lo, hi], dtype=torch.float32) * np.float32(1.0 / np.float32(np.sqrt(2)))
    a, b = (np.float32(x) for x in xla_math.erf(bounds))
    # the uniform's scale and shift are one fused multiply-add there
    floats = prng_kernel.uniform_from_words(random_bits(key, shape), 0.0, 1.0)
    u = torch.clamp(xla_math.fma32(floats, float(b - a), float(a)), min=float(a))
    out = xla_math.erfinv(u) * xla_math.SQRT2
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))


def choice_p(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)`` of one index per key: ``key`` is
    ``(..., 2)`` and ``p`` ``(..., n)`` float32 weights. ``r = cumsum(p)[-1]
    * (1 - uniform)`` on the cumulative sum in XLA's scan order, then the
    first index whose cumulative weight reaches ``r`` (a left
    ``searchsorted``), int32 ``(...)``."""
    p_cuml = xla_math.cumsum(p, dim=-1)
    r = p_cuml[..., -1] * (1.0 - uniform(key, ()))
    return torch.searchsorted(p_cuml.contiguous(), r.unsqueeze(-1)).squeeze(-1).to(torch.int32)
