"""Probe of the port's in-kernel RNG: bit health, distinct streams, words/s.

Counterpart of ``scripts/probe_prng.py``, which probes the TPU's hardware
PRNG through three Pallas kernels. The hardware bits have no GPU twin, so
this probes what the port draws inside its kernels instead: threefry2x32
words, keyed explicitly and advanced by a counter.

* ``draw(seed)``: (32, 128) words, 4 blocks of (8, 128), block ``b``
  under key ``(seed, b)`` (the TPU kernel seeds per (seed, program id));
  one ``threefry_words`` launch.
* ``draw2(seed)``: two (8, 128) blocks from the key ``(seed, 0)`` at
  successive counters (the TPU kernel draws twice from one seed); one
  launch.
* ``draw3(seed)``: (64, 100) int32, the throughput probe: program ``p``
  of ``PROGRAMS`` folds ``REPS`` draws of (47, 64, 100) words under key
  ``(seed, p)`` into one block by xor, and the result is the last
  program's block, as on the TPU's sequential grid; one ``threefry_rate``
  launch. The TPU kernel kept only ``[0]`` of each draw but counted every
  word in its rate; here every counted word is folded in.

Each has a plain version (``*_plain``) built on the plain
``prng_kernel.threefry2x32``.

The JAX probe cannot run on a CPU: it draws the TPU's bits when it is
imported, and the Pallas interpreter stubs ``prng_random_bits`` to zeros.
What stands under this probe, the threefry words, is held to
``jax.random`` bit for bit by tests/test_torch_prng.py.

Run on the card (default) or on the CPU::

    python3 -m adcraft_tpu_torch.probe_prng [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import List, Tuple

import torch

from adcraft_tpu_torch import prng_kernel as pk
from adcraft_tpu_torch.config import resolve_device

BLOCK = (8, 128)
BLOCKS = 4
PROGRAMS, REPS = 24, 16
WORD_MEAN = 2.0**31 - 0.5  # mean of a uniform uint32


def _keys(seed: int, programs, device) -> torch.Tensor:
    return torch.tensor(
        [[seed & pk.MASK32, p] for p in programs], dtype=torch.int64, device=resolve_device(device)
    )


def _seed(seed: int, device) -> torch.Tensor:
    return torch.tensor([seed], dtype=torch.int32, device=resolve_device(device))


def draw(seed: int, device=None, words=pk.threefry_words) -> torch.Tensor:
    """(32, 128) uint32 words as int64: block ``b`` under key ``(seed, b)``."""
    n = math.prod(BLOCK)
    out = words(_keys(seed, range(BLOCKS), device), n, pk.XOR)
    return out.reshape(BLOCKS * BLOCK[0], BLOCK[1])


def draw_plain(seed: int, device=None) -> torch.Tensor:
    return draw(seed, device, pk.threefry_words_reference)


def draw2(seed: int, device=None, words=pk.threefry_words) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (8, 128) blocks under key ``(seed, 0)``, the second at the
    counters after the first."""
    n = math.prod(BLOCK)
    out = words(_keys(seed, [0], device), 2 * n, pk.XOR)[0]
    return out[:n].reshape(BLOCK), out[n:].reshape(BLOCK)


def draw2_plain(seed: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return draw2(seed, device, pk.threefry_words_reference)


def draw3(seed: int, device=None) -> torch.Tensor:
    """(64, 100) int32: the last program's xor of its ``REPS * 47`` draws."""
    return pk.threefry_rate(_seed(seed, device), PROGRAMS, REPS)[PROGRAMS - 1]


def draw3_plain(seed: int, device=None) -> torch.Tensor:
    return pk.threefry_rate_reference(_seed(seed, device), [PROGRAMS - 1], REPS)[0]


def health(words: torch.Tensor) -> dict:
    """The JAX probe's statistics of a block of uint32 words."""
    w = words.to(torch.int64).flatten() & pk.MASK32  # int32 words read as uint32
    return {
        "n": w.numel(),
        "mean": w.double().mean().item(),
        "odd": (w & 1).double().mean().item(),
        "zeros": (w == 0).double().mean().item(),
        "unique": torch.unique(w).numel(),
    }


def health_failures(
    words: torch.Tensor, max_se: float = 5.0, max_collisions: int = 2
) -> List[str]:
    """What fails the bit-health criteria, within ``max_se`` standard errors
    of a uniform uint32 stream for this many words: mean ``2**31 - 0.5``
    (SE ``2**32 / sqrt(12 n)``), odd fraction 0.5 (SE ``0.5 / sqrt(n)``),
    and at most ``max_collisions`` repeated words."""
    h = health(words)
    n = h["n"]
    failures = []
    z_mean = (h["mean"] - WORD_MEAN) / (2.0**32 / math.sqrt(12 * n))
    z_odd = (h["odd"] - 0.5) / (0.5 / math.sqrt(n))
    if not abs(z_mean) < max_se:
        failures.append(f"mean {h['mean']:.4e} is {z_mean:+.2f} SE off {WORD_MEAN:.4e}")
    if not abs(z_odd) < max_se:
        failures.append(f"odd fraction {h['odd']:.4f} is {z_odd:+.2f} SE off 0.5")
    if n - h["unique"] > max_collisions:
        failures.append(f"{n - h['unique']} repeated words of {n}")
    return failures


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", help="torch device (default: the card)")
    device = resolve_device(parser.parse_args(argv).device)

    for seed in (1, 2):
        bits = draw(seed, device)
        h = health(bits)
        print(f"seed={seed}: mean={h['mean']:.3e} (want ~2.1e9) odd-frac={h['odd']:.3f} "
              f"zeros={h['zeros']:.4f} unique={h['unique']}/{h['n']}", flush=True)
        blocks = bits.reshape(BLOCKS, *BLOCK)
        print(f"  block0==block1 (different key): {torch.equal(blocks[0], blocks[1])}",
              flush=True)

    a, b = draw2(5, device)
    print(f"two calls identical: {torch.equal(a, b)} (a mean {a.double().mean().item():.3e}, "
          f"b mean {b.double().mean().item():.3e})", flush=True)

    draw3(1, device).cpu()  # build and warm up
    _synchronize(device)
    t0 = time.perf_counter()
    for seed in range(2, 7):
        draw3(seed, device).cpu()
    dt = (time.perf_counter() - t0) / 5
    words = pk.ThreefryRate.words(PROGRAMS, REPS)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"prng rate: {dt * 1e3:.2f} ms for {words / 1e6:.1f}M words "
          f"-> {words / dt / 1e9:.2f} G words/s ({name})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
