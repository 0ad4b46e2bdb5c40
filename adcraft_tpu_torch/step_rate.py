"""env-steps/s of ``VectorBiddingEnv.step`` on the card, and its device share.

The slice's configuration: 100 keywords (implicit single-competitor ones
from ``simple_experiment_table(128, 0.8)``, or explicit ones on the
``explicit`` route), ``max_volume=576``, budget $1000, bids $1.00. For each
env count:

* rate: reset, 3 warm-up steps, then 5 runs of 10 steps, each timed on
  the host clock and ended by ``torch.cuda.synchronize()``; median and
  range of the 5 env-steps/s;
* launches: each kernel's launches per step (the wrappers' counts);
* trace: one window of 10 steps under ``torch.profiler``: CUDA device
  events (kernels, copies) per step, device busy time per step (union of
  their intervals), and the idle share ``1 - busy / step time``, with the
  step time of the unprofiled runs.

Five day-step routes: ``pallas`` is ``day_kernel="pallas"`` (the CUDA
day kernel), ``xla`` is ``day_kernel="xla"`` with bench.py's knobs (the
two agg_day kernels), ``lanes`` is the JAX package's default knobs with
implicit keywords (the three lanes_day kernels), ``explicit`` is bench.py's
``dense_explicit`` regime (``bench.py:210-216``: the ``xla`` route's knobs
with 100 explicit keywords from ``sample_explicit_keywords`` and the
default rust cost model, on agg_cells_gate's explicit mode and
agg_outcomes), ``explicit_lanes`` is ``EnvConfig``'s own defaults (the
lanes knobs with explicit keywords and the rust cost model, on
lanes_counts' explicit instance, lanes_gate_float and lanes_outcomes'
float mode), ``pool`` is bench.py's ``dense_pool`` regime
(``bench.py:220-233``: the ``xla`` route's knobs with the binomial pool, on
agg_cells_gate's pool instance and agg_outcomes) and ``pool_lanes`` the
lanes knobs with the binomial pool (lanes_counts' pool instance,
lanes_gate_float's pool mode, lanes_outcomes' float mode); on both pool
routes every keyword has the reference's default pool, 30 bidders at
participation 0.6 (``pool_keywords``; the table's keywords have one).
``--routes`` picks them; each env count runs them
in turns in one process, forward then backward (pallas, xla, xla,
pallas by default). With ``--parent-csrc DIR``, each lanes route asked
for (``lanes``, ``explicit_lanes``, ``pool_lanes``) also runs, in its
own turn after the route's, on the lanes_day kernels built from DIR
(another tree's ``adcraft_tpu_torch/csrc``, such as the parent
commit's), to time two versions of those kernels in turns.

    python3 -m adcraft_tpu_torch.step_rate [--envs 1024 4096 8192]
        [--routes pallas xla lanes explicit explicit_lanes pool pool_lanes]
        [--parent-csrc DIR]
        [--json PATH]

It runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, agg_day, lanes_day, prng
from adcraft_tpu_torch import day_kernel as dk
from adcraft_tpu_torch import prng_kernel as pk
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel
from adcraft_tpu_torch.quantiles import simple_experiment_table

K, MAX_VOLUME, BID = 100, 576, 1.00
WARMUP, RUNS, STEPS = 3, 5, 10
POOL = {"competitor_model": CompetitorModel.BINOMIAL_POOL}
ROUTE_KNOBS = {"pallas": {"day_kernel": "pallas"}, "xla": BENCH_XLA_KNOBS, "lanes": {},
               "explicit": BENCH_XLA_KNOBS, "explicit_lanes": {},
               "pool": dict(BENCH_XLA_KNOBS, **POOL), "pool_lanes": POOL}
EXPLICIT_ROUTES = ("explicit", "explicit_lanes")
POOL_ROUTES = ("pool", "pool_lanes")
# the reference's default ImplicitKeyword pool (adcraft_tpu/keywords.py:104-105)
POOL_MAX_BIDDERS, POOL_PARTICIPATION = 30.0, 0.6
# competitors that bid Laplace(-0.3, 0.1): most pools' maximum bid is below
# zero, so clicks cost negative amounts and budgets grow within a day
SIGNED_LOC, SIGNED_SCALE = -0.3, 0.1
LANES_ROUTES = ("lanes", "explicit_lanes", "pool_lanes")
LANES_KERNELS = ("lanes_counts", "lanes_gate", "lanes_gate_float", "lanes_outcomes")
KERNELS = {"day_kernel": dk.day_kernel, "threefry_words": pk.threefry_words,
           "agg_cells_gate": agg_day.agg_cells_gate, "agg_outcomes": agg_day.agg_outcomes}


def counted_kernels() -> dict:
    """The kernels whose launches a step counts, the lanes day's as the step
    calls them."""
    return dict(KERNELS, **{name: getattr(lanes_day, name) for name in LANES_KERNELS})


def pool_keywords(kw, signed: bool = False):
    """``kw`` with the reference's default bidder pool (30 bidders at
    participation 0.6) for every keyword and, with ``signed``, competitors
    bidding Laplace(-0.3, 0.1)."""
    kw = kw._replace(max_bidders=torch.full_like(kw.max_bidders, POOL_MAX_BIDDERS),
                     participation_rate=torch.full_like(kw.participation_rate, POOL_PARTICIPATION))
    if signed:
        kw = kw._replace(bid_loc=torch.full_like(kw.bid_loc, SIGNED_LOC),
                         bid_scale=torch.full_like(kw.bid_scale, SIGNED_SCALE))
    return kw


def route_config(route: str) -> EnvConfig:
    kind = KeywordKind.EXPLICIT if route in EXPLICIT_ROUTES else KeywordKind.IMPLICIT
    return EnvConfig(num_keywords=K, kind=kind, max_volume=MAX_VOLUME, **ROUTE_KNOBS[route])


def busy_ms(events) -> float:
    """Length of the union of the events' device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


@contextlib.contextmanager
def lanes_kernels(kernels):
    """Route the lanes day through ``kernels`` (name -> wrapper), if given."""
    if kernels is None:
        yield
        return
    own = {name: getattr(lanes_day, name) for name in LANES_KERNELS}
    for name in LANES_KERNELS:
        setattr(lanes_day, name, kernels[name])
    try:
        yield
    finally:
        for name, kernel in own.items():
            setattr(lanes_day, name, kernel)


def measure(num_envs: int, route: str, device: torch.device, kernels=None) -> dict:
    with lanes_kernels(kernels):
        return _measure(num_envs, route, device)


def _measure(num_envs: int, route: str, device: torch.device) -> dict:
    env = VectorBiddingEnv(route_config(route), num_envs, simple_experiment_table(128, 0.8),
                           device=device)
    bids = torch.full((num_envs, K), BID, device=device)
    state, _ = env.reset(prng.PRNGKey(0))
    if route in POOL_ROUTES:
        state = state._replace(kw=pool_keywords(state.kw))
    for _ in range(WARMUP):
        state, _ = env.step(state, bids)
    torch.cuda.synchronize(device)
    for kernel in counted_kernels().values():
        kernel.launches = 0
    rates = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = env.step(state, bids)
        torch.cuda.synchronize(device)
        rates.append(STEPS * num_envs / (time.perf_counter() - t0))
    launches = {name: k.launches / (RUNS * STEPS) for name, k in counted_kernels().items()
                if k.launches}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            state, _ = env.step(state, bids)
        torch.cuda.synchronize(device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    median = statistics.median(rates)
    step_ms = num_envs / median * 1e3
    busy = busy_ms(events) / STEPS
    return {
        "route": route, "envs": num_envs, "env_steps_per_s": median,
        "min": min(rates), "max": max(rates), "rates": rates, "step_ms": step_ms,
        "launches_per_step": launches,
        "cuda_events_per_step": len(events) / STEPS, "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / step_ms,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, nargs="+", default=[1024, 4096, 8192])
    parser.add_argument("--routes", nargs="+", choices=sorted(ROUTE_KNOBS),
                        default=["pallas", "xla"])
    parser.add_argument("--parent-csrc", type=Path,
                        help="also time the lanes routes on the kernels built from this "
                             "csrc directory")
    parser.add_argument("--json", type=Path, help="also write the results here")
    args = parser.parse_args(argv)
    parent = None
    if args.parent_csrc is not None:
        if not set(LANES_ROUTES) & set(args.routes):
            parser.error(f"--parent-csrc times the lanes routes {LANES_ROUTES}: ask for one")
        parent = lanes_day.kernels_built_from(args.parent_csrc)
    # (route, tree): each lanes route on the parent's kernels too, after its own
    turns = [(route, tree) for route in args.routes
             for tree in (("this", "parent") if parent is not None and route in LANES_ROUTES
                          else ("this",))]
    if not torch.cuda.is_available():
        raise SystemExit("step_rate runs on the card only: no CUDA device")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    results = []
    for num_envs in args.envs:
        for route, tree in turns + turns[::-1]:
            r = measure(num_envs, route, device, parent if tree == "parent" else None)
            r["tree"] = tree
            results.append(r)
            label = route if tree == "this" else f"{route} (parent)"
            print(f"{num_envs} envs, {label}: {r['env_steps_per_s']:.1f} env-steps/s "
                  f"[{r['min']:.1f}, {r['max']:.1f}], step {r['step_ms']:.3f} ms; "
                  f"launches/step {r['launches_per_step']}; "
                  f"{r['cuda_events_per_step']:.1f} CUDA events/step, device busy "
                  f"{r['device_busy_ms_per_step']:.3f} ms/step, idle "
                  f"{100 * r['device_idle_share']:.1f}% ({card})", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
