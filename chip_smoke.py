#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adcraft_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name, and power limit as nvidia-smi reports it;
2. build the CUDA day kernel from adcraft_tpu_torch/csrc;
3. kernel vs its plain PyTorch version on the card at the slice's full
   width (4096 envs x 100 keywords x 24 sub-timesteps x 47 lanes), same
   inputs and seed, budgets unbound / binding / zero: every output
   exactly equal;
4. the kernel's random numbers: impressions, clicks given impressions
   and conversions given clicks against their analytic expectations,
   within 6 binomial standard errors;
5. the slice: VectorBiddingEnv(day_kernel="pallas") on the card, reset
   and 5 steps at bids $1.00 through the kernel (launch count 5,
   gate_converged all true, invariants), then the same 5 steps through
   the plain version (equal outcomes), with env-steps/s for both.

The line before the last is a JSON object with the kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Without
a CUDA device, or outside the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

E, K, T = 4096, 100, 24
MEAN_VOLUME, CVR = 128, 0.8
MAX_VOLUME = 576
BID = 1.00
SEED = 12345
STEPS = 5
DEVICE = "cuda:0"
MAX_SE = 6.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def day_kernel_replaced(dk, fn):
    """Route the env's day through ``fn`` instead of the kernel wrapper."""
    kernel = dk.day_kernel
    dk.day_kernel = fn
    try:
        yield
    finally:
        dk.day_kernel = kernel


def laplace_cdf(x, loc, scale):
    import torch

    z = (x - loc) / scale
    return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))


def check_moments(params, n_auc, m, out) -> None:
    """Impressions, clicks | impressions, conversions | clicks vs analytic."""
    import torch

    p = params.double()
    bid_c, loc, scale, bctr, sctr = p[0], p[1], p[2], p[3], p[4]
    lanes = n_auc.clamp(0, m).sum(0).double()
    a = (bid_c - 0.5) / 100.0
    p_win = (laplace_cdf(a, loc, scale) - laplace_cdf(-a, loc, scale)).clamp(0.0, 1.0)
    imp, clicks, convs = (x.double() for x in (out[0], out[1], out[3]))
    for name, observed, trials, prob in (
        ("impressions", imp, lanes, p_win),
        ("clicks | impressions", clicks, imp, bctr),
        ("conversions | clicks", convs, clicks, sctr),
    ):
        mean = (trials * prob).sum().item()
        se = math.sqrt((trials * prob * (1.0 - prob)).sum().item())
        z = (observed.sum().item() - mean) / se
        print(f"  {name}: observed {observed.sum().item():.0f} expected {mean:.1f} z {z:+.2f}")
        if not abs(z) < MAX_SE:
            fail(f"RNG moments: {name} is {z:+.2f} standard errors off")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this script runs on the card only)", flush=True)
        return 1
    try:
        from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
        from adcraft_tpu_torch import day_kernel as dk
        from adcraft_tpu_torch import distributions as dist
        from adcraft_tpu_torch import prng
        from adcraft_tpu_torch.quantiles import simple_experiment_table
    except ImportError as exc:
        print(f"FAIL: run from the repository root ({exc})", flush=True)
        return 1

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)
    dev = torch.device(DEVICE)

    # 2. build
    dk.day_kernel.library.get()
    print(f"build: {dk.day_kernel.library.build_seconds:.1f} s")
    for line in dk.day_kernel.library.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain at full width, three budget regimes
    cfg = EnvConfig(
        num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME, day_kernel="pallas"
    )
    m = cfg.max_clicks_per_cell
    table = simple_experiment_table(MEAN_VOLUME, CVR)
    env = VectorBiddingEnv(cfg, E, table, device=dev)
    state0, _ = env.reset(prng.PRNGKey(0))
    k_day = prng.split(prng.PRNGKey(1), E).to(dev)
    volumes = torch.clamp(
        dist.nonneg_int_normal(k_day, state0.kw.vol_mean, state0.kw.vol_std), max=MAX_VOLUME
    )
    bids = torch.full((E, K), BID, device=dev)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    names = ("impressions", "clicks", "cost_cents", "conversions", "revenue_cents",
             "eligible_volume", "gate_converged")
    max_err = 0
    ms = plain_ms = None
    for label, budget in (("unbound", 1e6), ("binding", 1000.0), ("zero", 0.0)):
        params, n_auc, budget_c = dk.day_kernel_inputs(
            cfg, state0.kw, bids, torch.full((E,), budget, device=dev), volumes
        )
        got = dk.day_kernel(params, n_auc, budget_c, seed, m)
        torch.cuda.synchronize()
        want = dk.simulate_day_reference(params, n_auc, budget_c, seed, m)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            diff = (g != w).sum().item()
            err = (g.long() - w.long()).abs().max().item()
            max_err = max(max_err, err)
            if diff:
                fail(f"kernel vs plain ({label}): {name} differs in {diff} cells (max {err})")
        if not (got[6] == 1).all():
            fail(f"{label}: gate_converged is not all true")
        imp, clicks, cost_c = (x.sum().item() for x in got[:3])
        spent = got[2].sum(1)
        print(f"kernel == plain ({label}, budget ${budget:g}): imps {imp} clicks {clicks} "
              f"cost ${cost_c / 100:.2f}; per-env spend max ${spent.max().item() / 100:.2f}")
        if (spent > budget_c).any():
            fail(f"{label}: an env spent more than its budget")
        if label == "unbound":
            check_moments(params, n_auc, m, got)
        if label == "binding":
            ms = cuda_ms(lambda: dk.day_kernel(params, n_auc, budget_c, seed, m), reps=20)
            plain_ms = cuda_ms(
                lambda: dk.simulate_day_reference(params, n_auc, budget_c, seed, m), reps=2
            )
            print(f"day at {E}x{K}x{T}x{m}, ${budget:g} budget: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.1f} ms ({card})")

    # 5. the slice through the kernel, counts zeroed just before; the env
    # drops the kernel's gate_converged flag, so keep it on the way out
    kernel = dk.day_kernel
    flags = []

    def kernel_keeping_flags(*args, **kwargs):
        out = kernel(*args, **kwargs)
        flags.append(out[-1])
        return out

    bid_steps = torch.full((E, K), BID, device=dev)
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    state = state0
    kernel_steps = []
    with day_kernel_replaced(dk, kernel_keeping_flags):
        for _ in range(STEPS):
            state, ts = env.step(state, bid_steps)
            kernel_steps.append(ts)
        torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = kernel.launches
    if launches != STEPS:
        fail(f"day kernel launched {launches} times in {STEPS} steps")
    if len(flags) != STEPS or not all(bool((f == 1).all()) for f in flags):
        fail("gate_converged is not all true in the slice")
    kernel_state = state

    for i, ts in enumerate(kernel_steps):
        o = ts.outcomes
        if not ((o.buyside_clicks <= o.impressions).all() and (o.impressions <= o.volume).all()
                and (o.sellside_conversions <= o.buyside_clicks).all()):
            fail(f"step {i}: clicks <= imps <= volume, convs <= clicks violated")
        if (o.cost.sum(1) > cfg.budget + 1e-3).any():
            fail(f"step {i}: an env spent more than the ${cfg.budget:g} budget")
        if not torch.isfinite(ts.reward).all():
            fail(f"step {i}: non-finite reward")
    if not (kernel_state.day == STEPS).all():
        fail("days_passed != 5")
    if not (kernel_steps[-1].obs["days_passed"] == STEPS).all():
        fail("obs days_passed != 5")

    t0 = time.perf_counter()
    with day_kernel_replaced(dk, dk.simulate_day_reference):
        state = state0
        for i in range(STEPS):
            state, ts = env.step(state, bid_steps)
            for f in ts.outcomes._fields:
                if not torch.equal(getattr(ts.outcomes, f), getattr(kernel_steps[i].outcomes, f)):
                    fail(f"slice step {i}: {f} differs between kernel and plain")
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    k_rate = STEPS * E / kernel_s
    p_rate = STEPS * E / plain_s
    imps = sum(ts.outcomes.impressions.sum().item() for ts in kernel_steps)
    print(f"slice: {STEPS} steps x {E} envs x {K} keywords, {imps} impressions; "
          f"kernel {k_rate:.1f} env-steps/s ({kernel_s:.3f} s), "
          f"plain {p_rate:.1f} env-steps/s ({plain_s:.3f} s) ({card})")

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "day_kernel",
        "route": "cuda",
        "source": "adcraft_tpu_torch/csrc/day_kernel.cu",
        "replaces": "adcraft_tpu/pallas_kernels.py:92",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
