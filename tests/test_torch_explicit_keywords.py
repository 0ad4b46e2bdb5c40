"""Explicit keyword sampling in the port against the JAX package on the
CPU: ``jax.random.beta`` and ``loggamma`` alone, ``sample_explicit_keywords``
field by field for a batch of keys at K = 7 and 100, and the numpy twin
``sample_explicit_keywords_numpy`` on the same ``np.random.Generator``
stream.

Tolerance: none; every field is compared for exact equality (float32,
bool).
"""

import jax
import numpy as np
import pytest
import torch

from adcraft_tpu import keywords as jk
from adcraft_tpu_torch import distributions as td
from adcraft_tpu_torch import keywords as tk


def torch_keys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("a,b", [(2.0, 5.0), (5.0, 2.0), (5.0, 5.0), (0.5, 1.5)])
def test_beta_draws(a, b):
    """``jax.random.beta`` through its log-gamma draws (Marsaglia and
    Tsang's two rejection loops; the alpha < 1 boost for (0.5, 1.5))."""
    keys = jax.random.split(jax.random.PRNGKey(8), 12)
    want = jax.jit(jax.vmap(lambda k: jax.random.beta(k, a, b, (100,))))(keys)
    np.testing.assert_array_equal(td.beta(torch_keys(keys), a, b, (100,)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("alpha", [2.0, 5.0, 0.3])
def test_loggamma_draws(alpha):
    keys = jax.random.split(jax.random.PRNGKey(2), 10)
    want = jax.jit(jax.vmap(lambda k: jax.random.loggamma(k, alpha, (50,))))(keys)
    np.testing.assert_array_equal(td.loggamma(torch_keys(keys), alpha, (50,)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("seed, K", [(0, 7), (1, 7), (2, 100)])
def test_sample_explicit_keywords(seed, K):
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    want = jax.jit(jax.vmap(lambda k: jk.sample_explicit_keywords(k, K)))(keys)
    got = tk.sample_explicit_keywords(torch_keys(keys), K)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the reference's ranges: volumes 14..29, impression threshold 0.05
    assert got.vol_mean.min() >= 14 and got.vol_mean.max() <= 29
    assert (got.imp_thresh == np.float32(0.05)).all()


def test_sample_explicit_keywords_with_mask_and_one_key():
    mask = np.array([True, False, True, False, False])
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda k: jk.sample_explicit_keywords(k, 5, mask))(key)
    got = tk.sample_explicit_keywords(torch_keys(key), 5, mask)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_explicit_keywords_numpy(seed):
    want = jk.sample_explicit_keywords_numpy(np.random.default_rng(seed), 9)
    got = tk.sample_explicit_keywords_numpy(np.random.default_rng(seed), 9, device="cpu")
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
