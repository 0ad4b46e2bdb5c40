"""The port's PRNG probe (adcraft_tpu_torch.probe_prng) on the CPU.

The JAX probe (scripts/probe_prng.py) cannot run on a CPU: it draws the
TPU's hardware bits when it is imported, and the Pallas interpreter stubs
``prng_random_bits`` to zeros (tests/test_pallas.py). So these tests hold
the port's probe to what it stands on, the threefry words of ``jax.random``:
each block of ``draw`` and ``draw2`` is ``jax.random.bits`` of the key
``(seed, block)``, and ``draw3`` is the xor of the JAX threefry words at the
probe's counters. They also hold its plain versions to the JAX probe's
shapes and health criteria. Tolerance: words bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry2x32_p

from adcraft_tpu_torch import prng_kernel as pk
from adcraft_tpu_torch import probe_prng as probe


def jax_bits(seed, block, n):
    key = jnp.array([seed & 0xFFFFFFFF, block], dtype=jnp.uint32)
    return np.asarray(jax.random.bits(key, (n,))).astype(np.int64)


@pytest.mark.parametrize("seed", [1, 2, 5, 12345, -3])
def test_draw_is_jax_bits_per_block(seed):
    bits = probe.draw(seed, "cpu")
    assert bits.shape == (32, 128) and bits.dtype == torch.int64
    torch.testing.assert_close(bits, probe.draw_plain(seed, "cpu"), rtol=0, atol=0)
    blocks = bits.reshape(probe.BLOCKS, -1).numpy()
    for b in range(probe.BLOCKS):
        np.testing.assert_array_equal(blocks[b], jax_bits(seed, b, 1024))
    assert probe.health_failures(bits) == []
    assert not np.array_equal(blocks[0], blocks[1])
    h = probe.health(bits)
    assert h["n"] == 4096 and h["zeros"] < 0.01


@pytest.mark.parametrize("seed", [5, 6])
def test_draw2_advances_the_counter(seed):
    a, b = probe.draw2(seed, "cpu")
    assert a.shape == b.shape == (8, 128)
    assert not torch.equal(a, b)
    both = torch.cat([a.flatten(), b.flatten()]).numpy()
    np.testing.assert_array_equal(both, jax_bits(seed, 0, 2048))
    for x, y in zip((a, b), probe.draw2_plain(seed, "cpu")):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert probe.health_failures(torch.stack([a, b])) == []


def test_draw3_is_the_xor_of_jax_words():
    seed = 1
    got = probe.draw3_plain(seed, "cpu")
    assert got.shape == (pk.RATE_ROWS, pk.RATE_COLS) and got.dtype == torch.int32
    j, c = np.meshgrid(np.arange(probe.REPS * pk.RATE_DRAWS, dtype=np.uint32),
                       np.arange(pk.RATE_ROWS * pk.RATE_COLS, dtype=np.uint32), indexing="ij")
    y0, y1 = threefry2x32_p.bind(jnp.uint32(seed), jnp.uint32(probe.PROGRAMS - 1),
                                 jnp.asarray(j), jnp.asarray(c))
    want = np.bitwise_xor.reduce(np.asarray(y0) ^ np.asarray(y1), axis=0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32).ravel(), want)
    assert probe.health_failures(got) == []


def test_health_failures_flag_bad_streams():
    assert probe.health_failures(torch.zeros(4096, dtype=torch.int64)) != []
    even = probe.draw(1, "cpu") & ~1
    assert any("odd" in f for f in probe.health_failures(even))
    repeated = probe.draw(1, "cpu").flatten()[:8].repeat(512)
    assert any("repeated" in f for f in probe.health_failures(repeated))


def test_main_prints_the_probe_lines(monkeypatch, capsys):
    monkeypatch.setattr(probe, "PROGRAMS", 2)
    monkeypatch.setattr(probe, "REPS", 1)
    assert probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for text in ("seed=1: mean=", "seed=2: mean=", "block0==block1 (different key): False",
                 "two calls identical: False", "prng rate:", "G words/s (cpu)"):
        assert text in out


def test_probe_defaults_to_the_card():
    """No device named means the card; without one it fails as torch does."""
    if torch.cuda.is_available():
        assert probe.draw(1).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            probe.draw(1)
