"""threefry2x32 words: the plain block function and two CUDA kernels.

``threefry2x32`` is the Threefry-2x32 block function (20 rounds) in plain
tensor ops on uint32 values held in int64 tensors; ``prng`` builds the
``jax.random`` key tree on it. Two kernels compute its words on the card
(``csrc/prng_kernels.cu``), each beside its plain version here:

* ``threefry_words`` (plain: ``threefry_words_reference``): for ``(N,
  2)`` keys and ``n`` counters, either both words ``(y0, y1)`` at counter
  ``(0, base + i)`` (mode ``"pair"``: ``split``, ``fold_in``), or the word
  ``y0 ^ y1`` at counter ``(i >> 32, i mod 2**32)``, masked to
  ``bit_width`` bits (mode ``"xor"``: ``random_bits``), or that 32-bit
  word's ``jax.random.normal`` float32 draw (mode ``"normal"``:
  ``prng.normal``, ``normal_from_words``). Replaces the TPU PRNG probes
  ``kernel`` and ``kernel2`` (``scripts/probe_prng.py:21``, ``:56``) and
  carries every draw of the env step.
* ``threefry_rate`` (plain: ``threefry_rate_reference``): the throughput
  probe, replacing ``kernel3`` (``scripts/probe_prng.py:88``).

Each wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors: on a CUDA tensor it launches or raises.
``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from adcraft_tpu_torch import xla_math
from adcraft_tpu_torch.cuda_build import CudaLibrary

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
PAIR, XOR, NORMAL = "pair", "xor", "normal"
BIT_WIDTHS = (16, 32)
# jax.random.normal's uniform is on [nextafter(-1, 0), 1)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

# the rate probe's shapes (scripts/probe_prng.py:87-117): per program, REPS
# draws of (RATE_DRAWS, RATE_ROWS, RATE_COLS) words folded into one block
RATE_DRAWS, RATE_ROWS, RATE_COLS = 47, 64, 100
_MAX_PROGRAMS = 65535  # the kernel's grid y


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


def _check_mode(mode: str, base: int, bit_width: int) -> None:
    if mode == PAIR:
        if bit_width != 32:
            raise ValueError("pair mode writes whole 32-bit words")
        if not 0 <= base <= MASK32:
            raise ValueError(f"base {base} is not a uint32")
    elif mode in (XOR, NORMAL):
        if base != 0:
            raise ValueError(f"{mode} mode counts from 0")
        if bit_width not in (BIT_WIDTHS if mode == XOR else (32,)):
            raise ValueError(f"bit_width {bit_width} not allowed in {mode} mode")
    else:
        raise ValueError(f"mode must be {PAIR!r}, {XOR!r} or {NORMAL!r}, got {mode!r}")


def uniform_from_words(words: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform``'s float32 of 32-bit words: the top 23 bits as a
    mantissa, scaled to [minval, maxval)."""
    floats = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # bounds and span rounded to float32 as JAX computes them; Python
    # scalars keep the op free of host-to-device copies
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def normal_from_words(words: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s float32 draw of 32-bit words, ``sqrt(2)
    erf_inv(u)`` on XLA's ``erf_inv``: equal to the JAX package's draw."""
    return xla_math.erfinv(uniform_from_words(words, NORMAL_LO, 1.0)) * xla_math.SQRT2


def threefry_words_reference(
    keys: torch.Tensor, n: int, mode: str, base: int = 0, bit_width: int = 32
) -> torch.Tensor:
    """Plain version of ``threefry_words``: ``(N, n, 2)`` or ``(N, n)`` int64,
    or ``(N, n)`` float32 in normal mode."""
    _check_mode(mode, base, bit_width)
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    if mode == PAIR:
        y0, y1 = threefry2x32(k0, k1, 0, (count + base) & MASK32)
        return torch.stack([y0, y1], dim=-1)
    y0, y1 = threefry2x32(k0, k1, count >> 32, count & MASK32)
    word = y0 ^ y1
    if mode == NORMAL:
        return normal_from_words(word)
    return word if bit_width == 32 else word & ((1 << bit_width) - 1)


def bind_launchers(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of the launchers that every version of
    ``csrc/prng_kernels.cu`` exports."""
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.threefry_words_launch.argtypes = [p, ll, ll, ll, i, u, u, p, i, p]
    lib.threefry_words_launch.restype = i
    lib.threefry_normal_launch.argtypes = [p, ll, ll, ll, p, i, p]
    lib.threefry_normal_launch.restype = i
    lib.threefry_rate_launch.argtypes = [p, i, i, i, p, i, p]
    lib.threefry_rate_launch.restype = i


def _bind(lib: ctypes.CDLL) -> None:
    bind_launchers(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.xla_math_probe_launch.argtypes = [i, p, p, p, p, ll, ll, i, p]
    lib.xla_math_probe_launch.restype = i


library = CudaLibrary("prng_kernels", _bind)


class ThreefryWords:
    """The ``threefry_words`` kernel's wrapper; ``launches`` counts launches.
    ``cuda_library`` may be another tree's build (such as the parent
    commit's, to time two versions in turns)."""

    def __init__(self, cuda_library: CudaLibrary = library):
        self.launches = 0
        self.library = cuda_library

    def __call__(
        self, keys: torch.Tensor, n: int, mode: str, base: int = 0, bit_width: int = 32
    ) -> torch.Tensor:
        """Words of ``(N, 2)`` int64 ``keys`` at ``n`` counters.

        The two words of a key must be adjacent (stride 1); rows may have
        any stride, so column slices of a key batch need no copy.
        """
        _check_mode(mode, base, bit_width)
        if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"keys: want int64 (N, 2), got {keys.dtype} {tuple(keys.shape)}")
        if keys.stride(1) != 1:
            raise ValueError("keys: the two words of a key must be adjacent (stride 1)")
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        device = keys.device
        if device.type == "cpu":
            return threefry_words_reference(keys, n, mode, base, bit_width)
        if device.type != "cuda":
            raise ValueError(f"threefry_words: no implementation for {device.type} tensors")
        N = keys.shape[0]
        out = torch.empty((N, n, 2) if mode == PAIR else (N, n),
                          dtype=torch.float32 if mode == NORMAL else torch.int64, device=device)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(device).cuda_stream
        if mode == NORMAL:
            err = self.library.get().threefry_normal_launch(
                keys.data_ptr(), keys.stride(0), N, n, out.data_ptr(), device.index, stream)
        else:
            err = self.library.get().threefry_words_launch(
                keys.data_ptr(), keys.stride(0), N, n, int(mode == PAIR), base,
                (1 << bit_width) - 1, out.data_ptr(), device.index, stream)
        self.library.check(err, "threefry_words")
        self.launches += 1
        return out


threefry_words = ThreefryWords()


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0, pairwise (``torch`` has no xor reduction)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = x[:half] ^ x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if x.shape[0] % 2 else folded
    return x[0]


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 with the same bits."""
    return ((words ^ 0x80000000) - 0x80000000).to(torch.int32)


def threefry_rate_reference(
    seed: torch.Tensor, program_ids: Sequence[int], reps: int
) -> torch.Tensor:
    """Plain version of ``threefry_rate`` for the given programs only.

    Block ``p`` of the result is the xor of the words ``threefry(key =
    (seed, p), counter = (j, c))`` over ``j < reps * RATE_DRAWS``, at
    ``c = row * RATE_COLS + col``; ``(len(program_ids), RATE_ROWS,
    RATE_COLS)`` int32. One program at a time, so memory stays at a few
    ``(reps * RATE_DRAWS, RATE_ROWS * RATE_COLS)`` tensors.
    """
    device = seed.device
    k0 = seed.reshape(()).to(torch.int64) & MASK32
    j = torch.arange(reps * RATE_DRAWS, dtype=torch.int64, device=device).view(-1, 1)
    c = torch.arange(RATE_ROWS * RATE_COLS, dtype=torch.int64, device=device).view(1, -1)
    blocks = []
    for p in program_ids:
        y0, y1 = threefry2x32(k0, int(p) & MASK32, j, c)
        blocks.append(_to_int32(_xor_fold(y0 ^ y1)).view(RATE_ROWS, RATE_COLS))
    return torch.stack(blocks)


class ThreefryRate:
    """The ``threefry_rate`` kernel's wrapper; ``launches`` counts launches."""

    def __init__(self):
        self.launches = 0
        self.library = library

    @staticmethod
    def words(programs: int, reps: int) -> int:
        """Words the kernel draws (and folds into its result)."""
        return programs * reps * RATE_DRAWS * RATE_ROWS * RATE_COLS

    def __call__(self, seed: torch.Tensor, programs: int, reps: int) -> torch.Tensor:
        """``(programs, RATE_ROWS, RATE_COLS)`` int32 blocks for int32 ``(1,)`` ``seed``.

        Block ``p`` is program ``p``'s (``threefry_rate_reference``). The TPU
        kernel wrote every program into one output block in grid order;
        here each program has its own block, and the TPU result is the
        last one.
        """
        if seed.dtype != torch.int32 or tuple(seed.shape) != (1,):
            raise ValueError(f"seed: want int32 (1,), got {seed.dtype} {tuple(seed.shape)}")
        if not 1 <= programs <= _MAX_PROGRAMS or reps < 1:
            raise ValueError(f"programs in [1, {_MAX_PROGRAMS}] and reps >= 1, got "
                             f"{programs}, {reps}")
        device = seed.device
        if device.type == "cpu":
            return threefry_rate_reference(seed, range(programs), reps)
        if device.type != "cuda":
            raise ValueError(f"threefry_rate: no implementation for {device.type} tensors")
        out = torch.empty((programs, RATE_ROWS, RATE_COLS), dtype=torch.int32, device=device)
        err = self.library.get().threefry_rate_launch(
            seed.data_ptr(), programs, reps * RATE_DRAWS, RATE_ROWS * RATE_COLS,
            out.data_ptr(), device.index, torch.cuda.current_stream(device).cuda_stream,
        )
        self.library.check(err, "threefry_rate")
        self.launches += 1
        return out


threefry_rate = ThreefryRate()


# xla_math_probe's functions: xla_math.fma32, expm1, pow, tanh,
# distributions.laplace_cdf and xla_math.cumsum and cumprod along the last axis
XLA_MATH_OPS = ("fma32", "expm1", "pow", "tanh", "laplace_cdf", "cumsum", "cumprod")


def xla_math_on_card(op: str, a: torch.Tensor, b=None, c=None) -> torch.Tensor:
    """``csrc/xla_math.cuh``'s device function ``op`` on CUDA float32
    tensors, to hold it to its plain ``xla_math`` version: elementwise on
    ``a`` (and ``b``, ``c``), or, for the scans, along the last axis of a
    2-D ``a``. Raises for CPU tensors: it has no plain fallback."""
    if a.device.type != "cuda":
        raise ValueError("xla_math_on_card: CUDA tensors only")
    args = [x.contiguous() if x is not None else None for x in (a, b, c)]
    out = torch.empty_like(args[0])
    rows, n = (a.shape[0], a.shape[1]) if op in ("cumsum", "cumprod") else (1, a.numel())
    ptr = [x.data_ptr() if x is not None else None for x in args]
    err = library.get().xla_math_probe_launch(XLA_MATH_OPS.index(op), *ptr, out.data_ptr(), n,
                                              rows, a.device.index,
                                              torch.cuda.current_stream(a.device).cuda_stream)
    library.check(err, "xla_math_probe")
    return out
