"""The port's keyword sampler, volume split and drift against JAX's.

Tolerances: integer-valued fields (volumes, splits) exact. Float keyword
fields: bitwise equal to the JAX functions run op by op, and within rtol
1e-6 of them under ``jax.jit``, where XLA contracts ``a + b*c`` (the
quantile interpolation, the volume drift) into a fused multiply-add that
rounds once (1 float32 ulp).
"""

import jax
import numpy as np
import pytest
import torch

from adcraft_tpu import keywords as jkw
from adcraft_tpu import quantiles as jq
from adcraft_tpu import step as jstep
from adcraft_tpu.config import EnvConfig as JEnvConfig
from adcraft_tpu_torch import keywords as tkw
from adcraft_tpu_torch import prng
from adcraft_tpu_torch import quantiles as tq
from adcraft_tpu_torch import step as tstep
from adcraft_tpu_torch.config import EnvConfig
from adcraft_tpu_torch.convert import keyword_state_from_numpy, keyword_state_to_numpy

NUM_KEYS = 32
INTEGER_FIELDS = ("vol_mean", "vol_std", "vol_drift_ref", "max_bidders", "participation_rate")


def multi_bucket(module):
    """A three-bucket table (one bucket excluded by count) in either package."""
    rng = np.random.default_rng(1)
    triples, counts = {}, {}
    for p in jq.ALL_PARAMS:
        base = np.sort(rng.uniform(0.05, 1.0, size=(3, 3)), axis=1)
        triples[p] = base * (300.0 if p == "vol" else 1.0)
        counts[p] = np.array([3, 0, 5])
    return module.QuantileTable(triples, counts)


TABLES = {
    "simple_128_0.8": (jq.simple_experiment_table(128, 0.8), tq.simple_experiment_table(128, 0.8)),
    "simple_16_0.1": (jq.simple_experiment_table(16, 0.1), tq.simple_experiment_table(16, 0.1)),
    "multi_bucket": (multi_bucket(jq), multi_bucket(tq)),
}


def jax_keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), NUM_KEYS)


def as_torch(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def compare(jax_state, torch_state, exact_floats):
    t = keyword_state_to_numpy(torch_state)
    for name in jkw.KeywordState._fields:
        a, b = np.asarray(getattr(jax_state, name)), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if exact_floats or name in INTEGER_FIELDS or a.dtype == bool:
            np.testing.assert_array_equal(b, a, name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize(
    "table, no_vol_prob",
    [("simple_128_0.8", 0.0), ("simple_16_0.1", 0.3), ("multi_bucket", 0.3)],
)
def test_sample_implicit_keywords(table, no_vol_prob):
    jtable, ttable = TABLES[table]
    keys = jax_keys(len(table))
    mask = np.arange(6) % 2 == 0

    def sample(k):
        return jkw.sample_implicit_keywords(k, 6, jtable, no_vol_prob, mask)

    got = tkw.sample_implicit_keywords(as_torch(keys), 6, ttable, no_vol_prob, mask)
    compare(jax.vmap(sample)(keys), got, exact_floats=True)
    compare(jax.jit(jax.vmap(sample))(keys), got, exact_floats=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_volume(seed):
    cfg_kw = {"max_volume": 576, "timesteps_per_day": 24} if seed else {"timesteps_per_day": 5}
    vol = np.random.default_rng(seed).integers(0, 577, size=(NUM_KEYS, 7)).astype(np.int32)
    want = np.asarray(jstep.split_volume(JEnvConfig(**cfg_kw), vol))
    got = tstep.split_volume(EnvConfig(**cfg_kw), torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_keywords(seed):
    jcfg, cfg = JEnvConfig(), EnvConfig()
    keys = jax_keys(seed)
    mask = np.random.default_rng(seed).random((NUM_KEYS, 6)) < 0.7
    kw = jax.vmap(lambda k, mk: jkw.sample_implicit_keywords(
        k, 6, jq.simple_experiment_table(128, 0.8), 0.0, mk))(keys, mask)
    # push some ctr/cvr to the clip bounds
    kw = kw._replace(bctr=kw.bctr.at[:, 0].set(1.0), sctr=kw.sctr.at[:, 1].set(0.0))
    upd = jax.random.split(jax.random.PRNGKey(100 + seed), NUM_KEYS)

    def drift(k, s):
        return jstep.update_keywords(jcfg, k, s)

    got = tstep.update_keywords(cfg, as_torch(upd), keyword_state_from_numpy(kw))
    compare(jax.vmap(drift)(upd, kw), got, exact_floats=True)
    compare(jax.jit(jax.vmap(drift))(upd, kw), got, exact_floats=False)
    assert not np.array_equal(keyword_state_to_numpy(got).bctr, np.asarray(kw.bctr))


def test_sample_from_quantiles_uses_only_counted_buckets():
    table = multi_bucket(tq)
    vals = tq.sample_from_quantiles(prng.PRNGKey(3), 2000, table.param_triples("bctr"))
    tri = table.triples["bctr"]
    inside = [(vals >= lo) & (vals <= hi) for lo, hi in tri[[0, 2]][:, [0, 2]]]
    assert bool((inside[0] | inside[1]).all())
    assert bool(inside[0].any() and inside[1].any())
