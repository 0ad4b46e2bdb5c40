"""CUDA day kernel tests: they need the card and skip without one.

This file imports torch and the port only, so that it runs on a machine
without JAX (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the kernel equals its plain PyTorch version exactly.
"""

import pytest
import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, simple_experiment_table
from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch import prng
from adcraft_tpu_torch.step import split_volume


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def random_inputs(cfg, E, K, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    vol = torch.randint(0, cfg.max_volume + 1, (E, K), generator=gen, dtype=torch.int32)
    u = torch.rand((6, E, K), generator=gen)
    params = torch.stack([
        torch.round(50 + 100 * u[0]), 0.3 + 0.7 * u[1], 0.01 + 0.3 * u[2], u[3], u[4],
        0.3 + 1.2 * u[5], torch.full_like(u[0], 0.15), torch.zeros_like(u[0]),
    ])
    return params.contiguous().to(dev), split_volume(cfg, vol).contiguous().to(dev)


# (K, max_volume): the slice's lane count, and a shared-memory footprint
# above the 48 KB default (K * m ints)
@pytest.mark.cuda
@pytest.mark.parametrize("K, max_volume", [(16, 576), (300, 576), (7, 30)])
def test_cuda_kernel_matches_reference(cuda, K, max_volume):
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=max_volume)
    m = cfg.max_clicks_per_cell
    E = 96
    params, n_auc = random_inputs(cfg, E, K, K, cuda)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    for budget in (10**8, 200 * K, 0):
        b = torch.full((E,), budget, dtype=torch.int32, device=cuda)
        before = dk.day_kernel.launches
        got = dk.day_kernel(params, n_auc, b, seed, m)
        torch.cuda.synchronize()
        assert dk.day_kernel.launches == before + 1
        want = dk.simulate_day_reference(params, n_auc, b, seed, m)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert got[0].sum() > 0


@pytest.mark.cuda
def test_env_step_launches_the_kernel(cuda):
    cfg = EnvConfig(num_keywords=8, kind=KeywordKind.IMPLICIT, max_volume=96,
                    timesteps_per_day=6, day_kernel="pallas")
    env = VectorBiddingEnv(cfg, 32, simple_experiment_table(64, 0.5), device=cuda)
    state, _ = env.reset(prng.PRNGKey(0))
    before = dk.day_kernel.launches
    for _ in range(2):
        state, ts = env.step(state, torch.full((32, 8), 1.0, device=cuda))
    torch.cuda.synchronize()
    assert dk.day_kernel.launches == before + 2
    assert ts.outcomes.impressions.is_cuda and (state.day == 2).all()
    with pytest.raises(ValueError, match="counter uniforms"):
        dk.day_kernel(*random_inputs(cfg, 4, 8, 0, cuda),
                      torch.ones(4, dtype=torch.int32, device=cuda),
                      torch.ones(1, dtype=torch.int32, device=cuda), 4,
                      uniform=lambda draw, t: None)
