#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adcraft_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name, and power limit as nvidia-smi reports it;
2. build the CUDA libraries from adcraft_tpu_torch/csrc, one nvcc per
   build, all at once (the day kernel; the threefry kernels; the XLA day
   step's kernels, and those again with -DAGG_STAGE_CLOCKS; the lanes
   day's kernels, and those again with -DLANES_STAGE_CLOCKS; with
   --parent-csrc, another tree's lanes day, agg day and threefry kernels
   too);
3. day kernel vs its plain PyTorch version on the card at the slice's full
   width (4096 envs x 100 keywords x 24 sub-timesteps x 47 lanes), same
   inputs and seed, budgets unbound / binding / zero: every output
   exactly equal, and equal again with one sub-timestep per chunk; the
   kernel timed at the unbound and the binding budget, beside its bound,
   its occupancy (blocks per SM) and ptxas' registers, shared memory and
   spills;
4. the day kernel's random numbers: impressions, clicks given impressions
   and conversions given clicks against their analytic expectations,
   within 6 binomial standard errors;
5. the slice: VectorBiddingEnv(day_kernel="pallas") on the card, reset
   and 5 steps at bids $1.00 through the day kernel (launch count 5,
   gate_converged all true, invariants), then the same 5 steps through
   the plain day (equal outcomes), with env-steps/s for both;
6. threefry_words vs the plain threefry2x32 on the card, bit for bit:
   split of 4096 keys into 4, fold_in, random_bits at (4096, 100) and
   (4096, 3, 100) in 32 and 16 bits, keys with strided rows, more than
   2**24 words, and the normal mode (jax.random.normal's draws) at (4096,
   100) and on strided rows; prng.normal on the card equals the CPU's;
7. the PRNG probe (adcraft_tpu_torch.probe_prng): draw, draw2 and draw3
   equal their plain versions bit for bit at the JAX probe's shapes, the
   threefry_rate blocks of all 24 programs too; bit health within 5
   standard errors; words/s beside its bound;
8. the slice with the RNG on the kernel: 5 steps, then the same 5 steps
   with prng's kernel swapped for the plain function; every TimeStep
   field and the state key equal; exactly 6 threefry_words launches per
   step; CUDA device events per step for both routes (torch.profiler);
   threefry_words timed at one word per launch (the launch floor);
9. the XLA day step (day_kernel="xla", bench.py's knobs) on its two
   kernels at 4096 envs x 100 keywords x 24 sub-timesteps, budgets unbound
   / $1000 / zero: agg_cells_gate equal to its plain version on every
   simulated cell, on n_sim and (bit for bit) on the day's constants, with
   its chunk of sub-timesteps chosen by the wrapper and forced to 1 (and,
   at $1000, every chunk size that fits, each timed); agg_outcomes equal
   to its plain version in both revenue modes (rev_sampling "sum" and
   "day"); both kernels timed at unbound and $1000 beside their bounds
   and their plain versions, agg_outcomes in both modes in turns;
   agg_cells_gate's chunk, shared memory, blocks per SM and ptxas
   registers and spills, and each stage's SM clocks per block from its
   -DAGG_STAGE_CLOCKS build; agg_outcomes' shared memory and blocks per
   SM and, from the same build, its SM clocks per stage in both modes;
   then the slice, VectorBiddingEnv(day_kernel="xla") reset, 5 steps
   and rollout(5) from the same state at bids $1.00 and the $1000 budget,
   counts zeroed just before: one launch of each kernel per day, 4
   threefry_words launches per step, invariants, and every output equal
   to the same days through the plain versions; CUDA device events per
   step; the same slice again under experiments/train_rl.py's fast knobs
   (rev_sampling="day"), with its own counts; and the budget's cast on
   both routes: one day at $inf and $1e8 equal to the day at $1e6, one at
   -$3e7 with no click accepted, each equal to its plain day;
10. the lanes day (the JAX package's default knobs: cost, conversion and
   revenue lanes, jax.random.binomial) on its three kernels at 4096 envs
   x 100 keywords x 24 sub-timesteps, unbound and $1000: lanes_counts,
   lanes_gate and lanes_outcomes each equal to their plain version bit
   for bit (every simulated cell, n_sim, the day sums), timed beside
   their bounds and plain versions, with ptxas' registers and spills,
   blocks per SM and lanes_gate's shared memory; from the
   -DLANES_STAGE_CLOCKS build (equal outputs too), lanes_gate's cells
   (whole, passive, decided alone, lane-resolved), windows (cut by the
   buffer), lanes per simulated cell and SM clocks per stage, and
   lanes_counts' passes per call and SM clocks in each loop, and
   lanes_outcomes' flag and revenue lanes (each what the plain version
   needs), draw steps (partial ones at most one per warp and ring) and SM
   clocks per stage, its erf_inv steps by log1p branch; lanes_outcomes'
   conversions (F2F) per revenue lane from its SASS; with --parent-csrc DIR, the lanes day built from
   DIR (the parent commit's adcraft_tpu_torch/csrc), the cells where its
   outputs differ from this one's counted (a tree whose float arithmetic
   differs, as F4's single rounding and F5's XLA math do, draws otherwise),
   and each kernel timed in turns with it (parent, this, this, parent);
   lanes_counts alone on a
   grid of (n, p) pairs on both sides of the binomial's algorithm switch
   at 1024 envs: equal to its plain version, and its impressions' mean
   and variance within 6 standard errors of the Binomial's; the
   inversion sampler and 16-bit lanes at 1024 envs, each equal to its
   plain version (and lanes_outcomes to the parent's; with --parent-csrc
   the inversion sampler's lanes_counts also against the parent's, its
   differing counts counted, timed in turns); the three kernels
   at K = 2100 keywords and 3 envs, past lanes_outcomes' old limit, equal
   to their plain versions; then the slice, 5 steps, rollout(5) and 4 days of
   autoreset_step at max_days 3 (every episode ends and restarts), counts
   zeroed just before: one launch of each kernel per day, and the first 2
   steps, their keys and the autoreset states equal to the same days
   through the plain versions (the other steps equal to the rollout's);
   CUDA device events, device busy time and idle share per step;
11. explicit keywords on the XLA day step (bench.py's dense_explicit
   regime: its knobs with kind=EXPLICIT) at 4096 envs x 100 keywords x 24
   sub-timesteps, for the rust and the python cost model, at $1000, at
   a tight budget ($10 and $2) and unbound ($1e6): agg_cells_gate's explicit mode equal to its plain version
   on every simulated cell, on n_sim and (bit for bit) on the day's
   constants, with the chunk chosen and forced to 1, and agg_outcomes on
   its tables in both revenue modes; the mode timed beside its bound
   (threefry words and the normal lanes' erf_inv float work this run's
   cells need) and its plain version, its ptxas registers and spills;
   then the slice per cost model: reset, 2 steps, rollout(2) and one
   autoreset_step(reset_kw=True) day that ends every episode (max_days
   3), counts zeroed just before: one launch of each kernel per day, and
   outcomes and keys equal to the same days through the plain versions;
   last, both explicit instances through adcraft_tpu_torch.kernel_turns:
   blocks per SM, SM clocks per stage and by part (the prologue's cost
   moments and ladder, stage A's counts and costs), the cells with clicks
   and impressions, with phantom clicks and resolved by lanes, and the
   time by chunk;
12. explicit keywords on the lanes day (EnvConfig's defaults: kind,
   cost model and sampling knobs), for the rust model (float32 dollars on
   lanes_gate_float, lanes_outcomes' float mode) and the python model
   (cents on lanes_gate's python instance), at 4096 envs x 100 keywords x
   24 sub-timesteps (m0 = 47) and at EnvConfig's own lanes (4096 envs x 10
   keywords, m0 = 65), at $1000, a tight budget ($10, $2) and $0, and
   for the rust model at a budget its first sub-timestep's spends reach
   exactly (days break after their first sub-timestep at the last two):
   lanes_counts' explicit instance, the gate and lanes_outcomes each equal
   to their plain version bit for bit (every simulated cell, for
   lanes_gate_float every cell it walks, -1 where not simulated; n_sim,
   the float spends, the day sums), timed at full width beside their
   bounds and plain versions, with ptxas' registers and spills and blocks
   per SM; on every rust day lanes_gate_float's -DLANES_STAGE_CLOCKS
   build (equal outputs): its walked cells by kind (not simulated, no
   click, first lane over the budget, whole, partial, deep; they add up
   to the cells walked), runs by ballot, redrawn cells, windows, lanes,
   broken days and SM clocks per stage; with --parent-csrc its outputs
   equal to the parent's bit for bit and its time in turns with it; the
   rust model also at K = 300 keywords and 256 envs (past element 256 of
   XLA's scan of a sub-timestep's spends), untimed, at $1000 and the
   "prefix" budget; then
   the slice per cost model: reset, 5 steps, rollout(5) and
   4 autoreset_step(reset_kw=True) days at max_days 3 (every episode ends
   and draws fresh keywords), counts zeroed just before: one launch of
   each kernel per day, the first 2 steps' outcomes and keys and the
   autoreset days equal to the plain versions (the other steps equal to
   the rollout's);
   CUDA device events, device busy time and idle share per step; last,
   lanes_counts' explicit instance through adcraft_tpu_torch.kernel_turns:
   its SM clocks per call at t = 0 and t >= 1 (the flat warps' too) from
   the clocked build, and with --parent-csrc its time in turns with DIR's
   build and the outputs where the two differ;
13. the paper's experiment (adcraft_tpu_torch.experiments): the harness
   at the dense config's full width (100 keywords, m0 = 47; env seeds
   5-8 x agent seeds 0-3, 16 episodes), for the zero-margin and the
   interpolation agent: 2 days through the kernels, counts zeroed just
   before (one launch of each lanes kernel a day; threefry_words'
   launches a day), equal to the same days through the plain versions of
   the lanes kernels and threefry_words (profits, ideal profits, env and
   agent states, keys), then the full 60 days through the kernels with
   AKNCP and NCP and harness days/s; two corners of the sweep, vol 1024 /
   cvr 1.0 (max_volume 4160, m0 = 196) and vol 1 / cvr 0.01, 2 days each
   against the plain versions; the Gymnasium adapter's two
   configurations (explicit rust keywords at max_volume 128, implicit ones
   from simple_experiment_table(128, 0.8)) at one env, 5 days through
   env.env_step against the plain versions; and timing.time_episode for
   the three reference timing configs (64 episodes x 100 keywords x 60
   days), s/episode and episodes/s;
14. the RL trainers (adcraft_tpu_torch.agents) at train_rl's defaults
   (the dense config: 128 envs x 100 keywords, max_volume 576, the fast
   knobs, so the agg kernels and threefry_words; 16 rollout days, 4
   epochs x 4 minibatches, [32, 32]): one PPO train step through the
   kernels, counts zeroed just before (one launch of each agg kernel per
   env day), equal bit for bit to the same step through the plain
   versions of the agg kernels and threefry_words (transitions,
   advantages, parameters, Adam state, env state, key, metrics); 5 train
   steps timed (train steps/s, training env-steps/s, launches per train
   step) and one under torch.profiler (device events, busy and idle);
   2 steps of the lanes route (--exact-env); A2C [256, 256], 10 steps;
   TD3 [400, 300] (buffer 100,000, batch 256) through its warm-up, one
   step equal to the plain versions', then 10 more; evaluate (16 envs x
   60 days, AKNCP and NCP); JAX's learning proof (tests/test_ppo.py:59's
   configuration and assertions, 150 steps); train_rl's CLI, --steps 3
   --checkpoint --out then --restore --steps 1, whose step equals the
   uninterrupted 4th; multi_train over a PPO and a TD3 learner; entry()'s
   forward on the card within rtol 1e-5 of the CPU's;
15. the binomial pool (competitor_model=BINOMIAL_POOL, every keyword 30
   bidders at participation 0.6): agg_cells_gate's pool instance on
   bench.py's dense_pool knobs, lanes_counts' pool instance and
   lanes_gate_float's pool mode on the sampling defaults, at 4096 envs x
   100 keywords x 24 sub-timesteps, unbound and $1000: each equal to its
   plain version bit for bit (every simulated cell, n_sim, the pool's
   day constants; lanes_outcomes' float mode on the gate's output), timed
   beside its bound and plain version, with ptxas' registers and spills,
   blocks per SM and shared memory; a slice of 256 envs x 2 days held to
   the plain versions at $1000 and $2 on the default keywords and on
   competitors bidding Laplace(-0.3, 0.1), F(bid) on the env's rounded
   bids on day 1, its partial cells, deep resolutions and negative-spend
   cells counted (it fails if the signed-cost slice spent nothing
   negative); then each route's slice through the env: 2 steps,
   rollout(2) and an autoreset day that ends every episode, counts zeroed
   just before, one launch of each kernel per day, the agg route's step 0
   equal to the plain versions', envs whose day drew a -inf click cost
   counted (the JAX package's quirk at a 32-bit uniform of 0), CUDA device
   events, device busy time and idle share per step; last, the three
   redesigned pool instances (lanes_counts', agg_cells_gate's,
   lanes_gate_float's) through adcraft_tpu_torch.kernel_turns: blocks per
   SM, SM clocks per stage and per binomial call from the clocked builds,
   the gate's cells by kind, the agg instance's time by chunk, and with
   --parent-csrc their times in turns with DIR's build ($1000 and unbound)
   and the outputs where the two differ.
With --parent-csrc DIR, then, agg_cells_gate's three instances,
agg_outcomes (both revenue modes) and threefry_words at full width in
turns with DIR's build, with the count of outputs where the trees differ
(agg_cells_gate's imp, acc, spend and n_sim must not).

The line before the last is a JSON object with each kernel's launches on
its path, error, times and bound; the last line is {"ok": true, "device":
{...}}. Without a CUDA device, or outside the repository, it exits 1 and
prints no result. Each of phases 3-8, 9, 10, 11, 12, 13, 14 and 15 prints
its wall time.

    python3 chip_smoke.py [--parent-csrc DIR]
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

E, K, T = 4096, 100, 24
MEAN_VOLUME, CVR = 128, 0.8
MAX_VOLUME = 576
BID = 1.00
SEED = 12345
STEPS = 5
DEVICE = "cuda:0"
MAX_SE = 6.0
BACKLOG_CYCLES = 20_000_000  # SM clock cycles the spin kernel holds the stream
PROBE_SE = 5.0
# Hopper, per SM and clock: 64 lanes of the integer ALU pipe, 64 of the
# FMA-heavy pipe (which also runs IMAD), 128 thread-instructions issued (4
# schedulers x 32); HBM3 at 3.35 TB/s (NVIDIA H100 SXM data sheet, 700 W)
INT32_LANES_PER_SM = 64
FP32_LANES_PER_SM = 128
DISPATCH_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12
# a threefry2x32 word as written in csrc/threefry.cuh: 20 x (add, rotate,
# xor), 12 key-injection adds, the final xor; used only if SASS is unreadable
THREEFRY_OPS_SOURCE = 73


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi(query: str, *fmt: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, timeout=60, check=False,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call.

    A spin kernel ahead of the first event lets the host enqueue the calls
    before the card reaches them, so calls of a few microseconds are timed
    back to back on the card and not at the pace of the host.
    """
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(BACKLOG_CYCLES)
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


@contextlib.contextmanager
def words_replaced(pk, fn):
    """Route prng's threefry words through ``fn`` instead of the kernel wrapper."""
    kernel = pk.threefry_words
    pk.threefry_words = fn
    try:
        yield
    finally:
        pk.threefry_words = kernel


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):", re.MULTILINE)


def sass_ops_per_word(library_path: Path, kernel: str):
    """Instructions per threefry word in ``kernel``'s innermost loop, from
    ``cuobjdump -sass``: the smallest loop (a backward branch) holding a
    whole threefry body (at least 12 funnel shifts), branches and NOPs not
    counted. Returns (ops, opcode histogram) or None if SASS is unreadable.
    """
    from adcraft_tpu_torch.cuda_build import find_nvcc

    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(library_path)],
                          capture_output=True, text=True, timeout=120, check=False)
    if proc.returncode != 0:
        return None
    for section in proc.stdout.split("Function : ")[1:]:
        if kernel not in section.splitlines()[0]:
            continue
        labels, insns = {}, []
        for line in section.splitlines():
            label = _SASS_LABEL.match(line)
            if label:
                labels[label.group(1)] = None
            found = _SASS_INSN.search(line)
            if found:
                addr = int(found.group(1), 16)
                for name, at in labels.items():
                    if at is None:
                        labels[name] = addr
                insns.append((addr, found.group(2), found.group(3)))
        loops = []
        for addr, op, args in insns:
            if op.split(".")[0] != "BRA":
                continue
            target = re.search(r"0x([0-9a-f]+)", args)
            name = re.search(r"(\.L_x_\d+)", args)
            start = int(target.group(1), 16) if target else labels.get(name and name.group(1))
            if start is not None and start <= addr:
                loops.append((start, addr))
        best = None
        for lo, hi in loops:
            ops = [op.split(".")[0] for a, op, _ in insns
                   if lo <= a <= hi and op.split(".")[0] not in ("BRA", "NOP")]
            if ops.count("SHF") >= 12 and (best is None or len(ops) < len(best)):
                best = ops
        if best:
            return len(best), dict(collections.Counter(best).most_common())
    return None


def sass_ops(library_path: Path, kernel: str):
    """``kernel``'s SASS instructions as (opcode, operands) pairs, from
    ``cuobjdump -sass`` (the first function whose name holds ``kernel``),
    or None if SASS is unreadable."""
    from adcraft_tpu_torch.cuda_build import find_nvcc

    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(library_path)],
                          capture_output=True, text=True, timeout=120, check=False)
    if proc.returncode != 0:
        return None
    for section in proc.stdout.split("Function : ")[1:]:
        if kernel in section.splitlines()[0]:
            return [(found.group(2), found.group(3)) for found in map(_SASS_INSN.search,
                                                                         section.splitlines())
                    if found]
    return None


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


# float instructions of one normal-mode draw, counted from csrc/xla_math.cuh
# (fused multiply-adds once): the uniform 3, log1p's rational function 17
# (or its log about as many), erf_inv's polynomial 10, the sqrt(2) product
NORMAL_OPS = 31
WORD_OUT_BYTES = {"pair": 16, "xor": 8, "normal": 4}


def threefry_words_bound(calls, ops_per_word: float, int_ops_per_s: float,
                         fp_ops_per_s: float):
    """(bound_ms, bound_by) for a list of threefry_words calls
    ``(N, n, mode)``: each key read once (16 bytes), each output written
    once (an int64 word, two in pair mode, a float32 in normal mode), one
    threefry block per (key, counter) on the integer pipes and a normal's
    float work (NORMAL_OPS) beside them."""
    blocks = sum(N * n for N, n, _ in calls)
    normals = sum(N * n for N, n, mode in calls if mode == "normal")
    nbytes = sum(16 * N + WORD_OUT_BYTES[mode] * N * n for N, n, mode in calls)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = max(blocks * ops_per_word / int_ops_per_s, normals * NORMAL_OPS / fp_ops_per_s) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def bound(nbytes: float, ops: float, ops_per_s: float):
    """The larger of the byte time and the operation time, in ms."""
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def device_busy(run, steps: int):
    """(CUDA device events per step, device-busy ms per step, wall ms per
    step) of ``run`` under torch.profiler; busy is the union of the device
    events' intervals (``step_rate.busy_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adcraft_tpu_torch.step_rate import busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(device) / steps, busy_ms(device) / steps, wall_ms / steps


XLA_BUDGET = 1000.0
WALK_OPS = 7  # float instructions per level of the inverse-CDF walk
THREEFRY_WORDS_PER_STEP_XLA = 4  # split 3, split 2, the volume normal, the drift uniform
# key blocks agg_cells_gate needs per (env, simulated sub-timestep): kt,
# k_auc, k_imp, k_click, k_cost, k_sfull
CELL_KEY_BLOCKS = 6
# ... and per (env, sub-timestep) with a partial cell: k_lanes, k_lite
PARTIAL_KEY_BLOCKS = 2
# agg_outcomes' stages, as its build with -DAGG_STAGE_CLOCKS counts them
# (agg_cells_gate's: agg_day.STAGES)
OUT_STAGES = ("prologue and keys", "cell tiles", "full-queue draws", "tail and writes")


def stage_clocked(ad):
    """A wrapper of agg_cells_gate built with -DAGG_STAGE_CLOCKS: the same
    kernel, whose thread 0 also adds up its SM clocks in each stage."""
    return ad.AggCellsGate("agg_cells_gate (stage clocks)", ad.clocks_library())


def read_stage_clocks(clocked, device_index: int, stages):
    """The stage clocks of ``clocked``'s kernel summed since the last read,
    then the block count."""
    from adcraft_tpu_torch.agg_day import read_clocks

    return read_clocks(clocked.library, clocked.name.split()[0] + "_stage_clocks",
                       len(stages) + 1, device_index)


@contextlib.contextmanager
def agg_plain(ad):
    """Route the XLA day step through the plain versions of its kernels."""
    kernels = (ad.agg_cells_gate, ad.agg_outcomes)
    ad.agg_cells_gate, ad.agg_outcomes = ad.agg_cells_gate_reference, ad.agg_outcomes_reference
    try:
        yield
    finally:
        ad.agg_cells_gate, ad.agg_outcomes = kernels


def kernel_ptxas(build_log: str, kernel: str) -> str:
    """ptxas' registers, stack and spills for one kernel of a build log."""
    lines, current = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif current is not None and kernel in current and (
                "registers" in line or "spill" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(lines)


def once_ms(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def walk_levels(x, n):
    """Levels an inverse-CDF walk needs at least for the draws ``x`` of
    Binomial(``n``, p): the count it stops at, on the smaller tail; none
    where ``n`` is 0, whose count needs no draw."""
    return ((x.minimum(n - x) + 1) * (n > 0)).double().sum()


def agg_conversions(ad, dist, params, k_cells, acc, lanes):
    """Per-cell conversion counts (E, T, K), drawn as the plain post-gate
    phase draws them (only to count the work they need)."""
    import torch

    return torch.stack([
        dist.binomial_inv(ad.t_keys(k_cells, t).k_conv, acc[:, t], params[ad.SCTR],
                          lanes.m(t), lanes.bits)
        for t in range(lanes.T)], 1)


def xla_phase(torch, dev, card, table, ops_per_word, int_ops_per_s, fp_ops_per_s, sms, ptxas,
              clocked):
    """Phase 9: the XLA day step's kernels against their plain versions at
    full width, then the slice through them. Returns their JSON entries."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, FAST_XLA_KNOBS
    from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME,
                    budget=XLA_BUDGET, **BENCH_XLA_KNOBS)
    lanes = xla_lanes(cfg)
    L, m0, m1 = lanes.L, lanes.m0, lanes.m1
    env = VectorBiddingEnv(cfg, E, table, device=dev)
    state0, _ = env.reset(prng.PRNGKey(4))
    kw = state0.kw
    bids = torch.full((E, K), BID, device=dev)
    k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(5, dev), E)).unbind(-2)
    volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std), max=MAX_VOLUME)
    n_auc = split_volume(cfg, volume)
    n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
    params = ad.pack_params(kw, bids)
    cells_n = E * T * K
    cell = torch.arange(T * K, device=dev).view(1, T, K)
    n0, n1 = n_auc01[0], n_auc01[1]
    n_t = torch.stack([n0] + [n1] * (T - 1), 1)  # (E, T, K) auctions per cell
    max_err = {"agg_cells_gate": 0, "agg_outcomes": 0}
    fused = ad.agg_cells_gate

    chunk_t = fused.default_chunk_t(K, lanes, dev)
    blocks_per_sm = fused.occupancy(chunk_t, K, lanes, dev)
    smem = fused.smem_bytes(chunk_t, K, lanes)
    print(f"agg_cells_gate: {chunk_t} sub-timesteps per chunk, {smem} B of shared memory per "
          f"block, {blocks_per_sm} blocks per SM ({-(-E // (blocks_per_sm * sms))} waves at {E} "
          f"envs); ptxas {'; '.join(ptxas)}")
    out_blocks, out_smem = ad.agg_outcomes.occupancy(K, lanes, dev)
    out_ptxas = kernel_ptxas(ad.library.build_log, "agg_outcomes_kernel")
    print(f"agg_outcomes: {out_smem} B of shared memory per block, {out_blocks} blocks per SM "
          f"({-(-E // (out_blocks * sms))} waves at {E} envs); ptxas {out_ptxas}")

    def compare(name, pairs, label):
        """Integer outputs exactly; their error goes to max_err."""
        for what, g, w in pairs:
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{name} vs plain ({label}): {what} is {g.dtype} {tuple(g.shape)}, plain "
                     f"{w.dtype} {tuple(w.shape)}")
            err = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                fail(f"{name} vs plain ({label}): {what} differs, max error {err}")

    def compare_cells(out, want, sim, label):
        compare("agg_cells_gate", [("n_sim", out[3], want[3])] + [
            (what, out[i][sim], want[i][sim]) for i, what in enumerate(("imp", "acc", "spend"))],
            label)

    # the plain sampling phase's tables, to count the work of the bounds
    with words_replaced(pk, pk.threefry_words_reference):
        imp_p, ncl_p, sfull_p, _ = ad.agg_cells_reference(params, n_auc01, k_cells, lanes)
    ladder_steps = torch.log2(n1.clamp(max=m1).double() + 1).ceil() * (n1 > 0)

    timed, sweep = {}, []
    for label, budget in (("unbound", 1e6), ("binding", XLA_BUDGET), ("zero", 0.0)):
        budget_c = budget_cents(torch.full((E,), budget, device=dev))

        def gate_call(chunk=None):
            return fused(params, n_auc01, k_cells, budget_c, lanes, chunk_t=chunk)

        got = fused(params, n_auc01, k_cells, budget_c, lanes, keep_constants=True)
        one = gate_call(1)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want, gate_plain_ms = once_ms(lambda: ad.agg_cells_gate_reference(
                params, n_auc01, k_cells, budget_c, lanes, keep_constants=True))
        n_sim = want[3]
        sim = cell < n_sim.view(E, 1, 1)
        compare_cells(got, want, sim, f"{label}, chunk_t {chunk_t}")
        compare_cells(one, want, sim, f"{label}, chunk_t 1")
        consts_err = 0.0
        for i, (g, w) in enumerate(zip(got[4], want[4])):
            consts_err = max(consts_err, (g.double() - w.double()).abs().max().item())
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                fail(f"agg_cells_gate vs plain ({label}): constant {i} differs in its bits, "
                     f"max error {consts_err:.3g}")
        imp, acc, spend = got[:3]

        def out_call(mode="sum"):
            return ad.agg_outcomes(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes, mode)

        # both revenue modes against their plain versions; "day" shares
        # every sum but the revenue with "sum"
        out_plain_ms = {}
        for mode in ad.REV_SAMPLING:
            got_out = out_call(mode)
            torch.cuda.synchronize()
            with words_replaced(pk, pk.threefry_words_reference):
                out_want, out_plain_ms[mode] = once_ms(lambda: ad.agg_outcomes_reference(
                    params, k_cells, *want[:4], n_auc01, lanes, mode))
            compare("agg_outcomes", [(f"day sum {i}", g, w) for i, (g, w) in
                                     enumerate(zip(got_out, out_want))], f"{label}, {mode}")
            if mode == "sum":
                out = got_out
            elif not all(torch.equal(got_out[i], out[i]) for i in (0, 1, 2, 3, 5)):
                fail(f"agg_outcomes ({label}): the day mode changed a sum other than revenue")
        spent = out[2].sum(1)
        if (spent > budget_c.clamp(min=0)).any():
            fail(f"agg day ({label}): an env spent more than its budget")
        if not ((out[1] <= out[0]).all() and (out[3] <= out[1]).all()):
            fail(f"agg day ({label}): clicks <= imps, convs <= clicks violated")
        print(f"agg_cells_gate, agg_outcomes == plain ({label}, ${budget:g}), chunk_t {chunk_t} "
              f"and 1: simulated cells {sim.sum().item()} of {cells_n}, imps "
              f"{out[0].sum().item()} clicks {out[1].sum().item()} cost "
              f"${out[2].sum().item() / 100:.2f} convs {out[3].sum().item()} revenue "
              f"${out[4].sum().item() / 100:.2f} (day mode ${got_out[4].sum().item() / 100:.2f})"
              f"; constants bit-equal (max float error {consts_err:.3g})")
        if label == "zero":
            continue
        gate_ms = cuda_ms(gate_call, reps=20)
        # the two modes in turns: sum, day, day, sum
        turns = [(mode, cuda_ms(lambda mode=mode: out_call(mode), reps=20))
                 for mode in ("sum", "day", "day", "sum")]
        out_ms = {mode: sum(ms for m, ms in turns if m == mode) / 2 for mode in ad.REV_SAMPLING}
        # where a block's time goes: thread 0's SM clocks between barriers,
        # from the stage-clocked build at the same chunk
        def clocked_call():
            return clocked(params, n_auc01, k_cells, budget_c, lanes, chunk_t=chunk_t)

        read_stage_clocks(clocked, dev.index, ad.STAGES)
        compare_cells(clocked_call(), want, sim, f"{label}, stage clocks")
        counts = read_stage_clocks(clocked, dev.index, ad.STAGES)
        per_block = [c / counts[-1] for c in counts[:-1]]
        clocked_ms = cuda_ms(clocked_call, reps=20)
        print(f"  agg_cells_gate stage clocks per block ({label}, -DAGG_STAGE_CLOCKS): "
              + ", ".join(f"{name} {c:.0f} ({100 * c / sum(per_block):.1f}%)"
                          for name, c in zip(ad.STAGES, per_block))
              + f"; {clocked_ms:.4f} ms in that build ({card})")
        clocked_out = ad.AggOutcomes("agg_outcomes (stage clocks)", clocked.library)
        for mode in ad.REV_SAMPLING:
            def clocked_out_call(mode=mode):
                return clocked_out(params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes, mode)

            read_stage_clocks(clocked_out, dev.index, OUT_STAGES)
            compare("agg_outcomes", [(f"day sum {i}", g, w) for i, (g, w) in
                                     enumerate(zip(clocked_out_call(), out_call(mode)))],
                    f"{label}, {mode}, stage clocks")
            counts = read_stage_clocks(clocked_out, dev.index, OUT_STAGES)
            per_block = [c / counts[-1] for c in counts[:-1]]
            print(f"  agg_outcomes stage clocks per block ({label}, {mode}, -DAGG_STAGE_CLOCKS): "
                  + ", ".join(f"{name} {c:.0f} ({100 * c / sum(per_block):.1f}%)"
                              for name, c in zip(OUT_STAGES, per_block))
                  + f"; {cuda_ms(clocked_out_call, reps=20):.4f} ms in that build ({card})")
        # agg_cells_gate, per simulated cell: an impression word where it
        # has auctions, a click word where it has impressions, a spend
        # normal where it has clicks; the key blocks of each (env, t) with a
        # simulated cell. The gate's words: of each partial cell (simulated,
        # not full) the lanes up to the first one over the budget or its
        # last click (the first of them also says whether it accepts
        # nothing), the first L from k_lite, the rest from its column key
        # fold_in(k_rest, k); k_lanes and k_lite once per (env, t) with a
        # partial cell, k_rest once per (env, t) with a cell that reaches a
        # deep lane. A full cell reads no lane. Float: the levels the walks
        # need (at least the smaller tail of each count) and the t >= 1
        # ladder's bisection over its min(n1, m1) + 1 levels. Bytes: the
        # four parameter rows, the counts, keys and budgets in; imp, acc and
        # spend of the simulated cells and n_sim out.
        flat = want[2].view(E, T * K).long()  # 0 past the break
        b_before = budget_c.view(E, 1).long() - (torch.cumsum(flat, 1) - flat)
        simf = sim.view(E, T * K)
        partial = simf & (sfull_p.view(E, T * K).long() > b_before)
        accf, nclf = want[1].view(E, T * K), ncl_p.view(E, T * K)
        m_cell = torch.where(cell.view(1, T * K) < K, m0, m1)
        looked = torch.minimum(torch.minimum(accf + 1, nclf), m_cell) * partial
        lite_words = looked.clamp(max=L).sum().item()
        deep_cells = (looked - L).clamp(min=0)
        has_deep = deep_cells > 0
        deep = deep_cells.sum().item()
        n_deep_cells = has_deep.sum().item()
        t_partial = partial.view(E, T, K).any(2).sum().item()
        t_rest = has_deep.view(E, T, K).any(2).sum().item()
        gate_words = lite_words + deep + n_deep_cells + PARTIAL_KEY_BLOCKS * t_partial + t_rest
        key_blocks = CELL_KEY_BLOCKS * sim.any(2).sum().item()
        cell_words = (((n_t > 0) & sim).sum() + ((imp_p > 0) & sim).sum()
                      + ((ncl_p > 0) & sim).sum())
        words = cell_words.item() + key_blocks + gate_words
        gate_fp = (WALK_OPS * (walk_levels(imp_p[:, 0] * sim[:, 0], n0 * sim[:, 0])
                               + walk_levels(ncl_p * sim, imp_p * sim))
                   + (ladder_steps * sim[:, 1:].sum(1)).sum()).item()
        gate_bytes = 4 * (4 * E * K + 2 * E * K + E) + 16 * E + 12 * simf.sum().item() + 4 * E
        gate_bound = max(bound(gate_bytes, words * ops_per_word, int_ops_per_s),
                         bound(gate_bytes, gate_fp, fp_ops_per_s))
        # outcomes: a conversion word for each simulated cell with accepted
        # clicks; the key blocks kt and k_conv per (env, t) with such a cell;
        # "sum": a revenue normal for each cell with conversions and k_rev per
        # (env, t) with one; "day": a revenue normal for each (env, k) with
        # conversions and the day key's two blocks per env. Float: the
        # levels the conversion walks need. Bytes: imp, acc and spend of the
        # simulated cells, the three parameter rows, the counts, n_sim and
        # keys in, the six day sums out. The kernel's shared tables (1/j,
        # the walk's constants) are not work saved from the function.
        live = simf & (accf > 0)
        with words_replaced(pk, pk.threefry_words_reference):
            nconv = agg_conversions(ad, dist, params, k_cells, want[1], lanes).view(E, T * K)
        nconv = nconv * live
        converted = nconv > 0
        t_live = live.view(E, T, K).any(2)
        t_conv = converted.view(E, T, K).any(2)
        conv_words = (live.sum() + 2 * t_live.sum()).item()
        rev_words = {"sum": (converted.sum() + t_conv.sum()).item(),
                     "day": ((out[3] > 0).sum() + 2 * E).item()}
        out_fp = WALK_OPS * walk_levels(nconv, accf * live).item()
        out_bytes = (12 * simf.sum().item() + 4 * (3 * E * K + 2 * E * K + E) + 16 * E
                     + 24 * E * K)
        out_bound = {mode: max(bound(out_bytes, (conv_words + rev_words[mode]) * ops_per_word,
                                     int_ops_per_s),
                               bound(out_bytes, out_fp, fp_ops_per_s))
                     for mode in ad.REV_SAMPLING}
        out_words = {mode: conv_words + rev_words[mode] for mode in ad.REV_SAMPLING}
        timed[label] = {"agg_cells_gate": (gate_ms, gate_plain_ms, gate_bound)}
        for mode in ad.REV_SAMPLING:
            timed[label]["agg_outcomes" if mode == "sum" else "agg_outcomes (day)"] = (
                out_ms[mode], out_plain_ms[mode], out_bound[mode])
        print(f"  agg_cells_gate ({label}): {partial.sum().item()} partial cells, "
              f"{n_deep_cells} reach {deep} deep lanes; kernel {gate_ms:.4f} ms, plain "
              f"{gate_plain_ms:.1f} ms; {words} threefry words ({key_blocks} key blocks, "
              f"{gate_words} for partial cells' lanes, {lite_words} of them lite), "
              f"{gate_fp:.4g} float ops, {gate_bytes / 1e6:.1f} MB; "
              f"bound {gate_bound[0]:.4f} ms ({gate_bound[1]}), "
              f"{100 * gate_bound[0] / gate_ms:.1f}% of it reached ({card})")
        for mode in ad.REV_SAMPLING:
            print(f"  agg_outcomes ({label}, rev_sampling {mode!r}): kernel {out_ms[mode]:.4f} "
                  f"ms ({', '.join(f'{ms:.4f}' for m, ms in turns if m == mode)}), plain "
                  f"{out_plain_ms[mode]:.1f} ms; {out_bytes / 1e6:.1f} MB, "
                  f"{int(live.sum())} cells with clicks, {out_words[mode]} words, {out_fp:.4g} "
                  f"float ops; bound {out_bound[mode][0]:.4f} ms ({out_bound[mode][1]}), "
                  f"{100 * out_bound[mode][0] / out_ms[mode]:.1f}% of it reached ({card})")
        if label == "binding":
            # the chunk's trade: every chunk size that fits, outputs equal
            for c in range(1, T + 1):
                occupancy = fused.occupancy(c, K, lanes, dev)
                if occupancy == 0:
                    break
                compare_cells(gate_call(c), want, sim, f"{label}, chunk_t {c}")
                c_ms = cuda_ms(lambda c=c: gate_call(c), reps=10)
                sweep.append(f"{c}: {c_ms:.4f} ms ({occupancy}/SM)")
            print(f"  agg_cells_gate by chunk_t ({label}): " + ", ".join(sweep) + f" ({card})")

    def run_slice(slice_env, label):
        """Reset, 5 steps and rollout(5) from the same state, counts zeroed
        just before and read just after; then the same days through the
        plain versions. Returns the agg kernels' launches."""
        kernels = {"agg_cells_gate": ad.agg_cells_gate, "agg_outcomes": ad.agg_outcomes}
        state_a, _ = slice_env.reset(prng.PRNGKey(6))
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        pk.threefry_words.launches = 0
        t0 = time.perf_counter()
        state = state_a
        steps = []
        for _ in range(STEPS):
            state, ts = slice_env.step(state, bids)
            steps.append(ts)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        end_step = state
        end_roll, roll = slice_env.rollout(state_a, bids, STEPS)
        torch.cuda.synchronize()
        launches = {name: kernel.launches for name, kernel in kernels.items()}
        words_launches = pk.threefry_words.launches
        if any(n != 2 * STEPS for n in launches.values()):
            fail(f"{label} slice launches {launches}, want {2 * STEPS} of each "
                 f"({STEPS} steps and rollout({STEPS}))")
        if words_launches != 2 * STEPS * THREEFRY_WORDS_PER_STEP_XLA:
            fail(f"{label} slice: {words_launches} threefry_words launches in {2 * STEPS} days, "
                 f"want {THREEFRY_WORDS_PER_STEP_XLA} per day")
        for i, ts in enumerate(steps):
            o = ts.outcomes
            if not ((o.buyside_clicks <= o.impressions).all()
                    and (o.impressions <= o.volume).all()
                    and (o.sellside_conversions <= o.buyside_clicks).all()
                    and (o.revenue >= 0.01 * o.sellside_conversions - 1e-3).all()):
                fail(f"{label} step {i}: clicks <= imps <= volume, convs <= clicks, revenue >= "
                     f"$0.01 per conversion violated")
            if (o.cost.sum(1) > XLA_BUDGET + 1e-3).any():
                fail(f"{label} step {i}: an env spent more than the ${XLA_BUDGET:g} budget")
            if not torch.isfinite(ts.reward).all():
                fail(f"{label} step {i}: non-finite reward")
            for f in o._fields:
                if not torch.equal(getattr(o, f), getattr(roll.outcomes, f)[i]):
                    fail(f"{label} rollout day {i}: {f} differs from step {i}")
            if not torch.equal(ts.reward, roll.reward[i]):
                fail(f"{label} rollout day {i}: reward differs from step {i}")
        if not (torch.equal(end_step.key, end_roll.key) and (end_step.day == STEPS).all()):
            fail(f"{label} rollout: the final state differs from the steps'")
        if steps[-1].outcomes.sellside_conversions.sum().item() <= 0:
            fail(f"{label} slice: no conversions")

        t0 = time.perf_counter()
        with agg_plain(ad), words_replaced(pk, pk.threefry_words_reference):
            state = state_a
            for i in range(STEPS):
                state, ts = slice_env.step(state, bids)
                want = steps[i]
                pairs = [("reward", ts.reward, want.reward)]
                pairs += [("obs." + f, ts.obs[f], want.obs[f]) for f in want.obs]
                pairs += [("outcomes." + f, getattr(ts.outcomes, f), getattr(want.outcomes, f))
                          for f in want.outcomes._fields]
                for name, x, y in pairs:
                    if not torch.equal(x, y):
                        fail(f"{label} slice step {i}: {name} differs between kernels and plain")
            torch.cuda.synchronize()
            if not torch.equal(state.key, end_step.key):
                fail(f"{label} slice: the state key differs between kernels and plain")
        plain_s = time.perf_counter() - t0

        def run_steps():
            st = state_a
            for _ in range(STEPS):
                st, _ts = slice_env.step(st, bids)

        events = device_busy(run_steps, STEPS)[0]
        imps = sum(ts.outcomes.impressions.sum().item() for ts in steps)
        cost = sum(ts.outcomes.cost.sum().item() for ts in steps)
        revenue = sum(ts.outcomes.revenue.sum().item() for ts in steps)
        print(f"{label} slice: {STEPS} steps and rollout({STEPS}) x {E} envs x {K} keywords, "
              f"bids ${BID:.2f}, budget ${XLA_BUDGET:g}: {imps} impressions, ${cost:.2f} spent, "
              f"${revenue:.2f} revenue; launches {launches}, threefry_words "
              f"{words_launches / (2 * STEPS):g} per step; kernels {STEPS * E / step_s:.1f} "
              f"env-steps/s ({step_s:.3f} s), plain {STEPS * E / plain_s:.1f} env-steps/s; CUDA "
              f"device events per step {events:.1f} ({card})")
        return launches

    # the slices: bench.py's knobs (the main path), then train_rl.py's fast
    # knobs (rev_sampling="day"), each with its own counts
    launches = run_slice(env, "XLA")
    fast_cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME,
                         budget=XLA_BUDGET, **FAST_XLA_KNOBS)
    run_slice(VectorBiddingEnv(fast_cfg, E, table, device=dev), "XLA day-revenue")
    print(f"agg_cells_gate summary: chunk_t {chunk_t}, {blocks_per_sm} blocks per SM, {smem} B "
          f"shared memory per block; "
          + "; ".join(f"{label} {t['agg_cells_gate'][0]:.4f} ms, bound "
                      f"{t['agg_cells_gate'][2][0]:.4f} ms ({t['agg_cells_gate'][2][1]}), "
                      f"{100 * t['agg_cells_gate'][2][0] / t['agg_cells_gate'][0]:.1f}% of bound"
                      for label, t in timed.items()) + f" ({card})")
    print(f"agg_outcomes summary: {out_blocks} blocks per SM, {out_smem} B shared memory per "
          f"block, ptxas {out_ptxas}; " + "; ".join(
              f"{label} {mode} {t[name][0]:.4f} ms, plain {t[name][1]:.1f} ms, bound "
              f"{t[name][2][0]:.4f} ms ({t[name][2][1]}), {100 * t[name][2][0] / t[name][0]:.1f}% "
              f"of bound" for label, t in timed.items()
              for mode, name in (("sum", "agg_outcomes"), ("day", "agg_outcomes (day)")))
          + f" ({card})")

    ms = timed["binding"]
    replaces = {
        "agg_cells_gate": "adcraft_tpu/step.py:858-926 (_cell_tables, agg implicit-single "
                          "branch), :740 (_gate_keywords_scan_agg) and :1087 (_resolve_cell); "
                          "the XLA step has no TPU kernel",
        "agg_outcomes": "adcraft_tpu/step.py:1392 (post-gate phase to :1500; no TPU kernel)",
    }
    return [
        {
            "name": name,
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/agg_day.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms[name][0],
            "plain_ms": ms[name][1],
            "bound_ms": ms[name][2][0],
            "bound_by": ms[name][2][1],
            "library_ms": None,
        }
        for name in ("agg_cells_gate", "agg_outcomes")
    ]


# $1000, a tight budget per cost model (a rust click costs $2.20-4.40, so
# $10 lets a few clicks through and then resolves lanes; a python one about
# half the bid), and one no day reaches
EXPLICIT_BUDGETS = {"RUST_QUIRK": (("$1000", XLA_BUDGET), ("tight", 10.0), ("unbound", 1e6)),
                    "PYTHON": (("$1000", XLA_BUDGET), ("tight", 2.0), ("unbound", 1e6))}
EXPLICIT_STEPS = 2
EXPLICIT_MAX_DAYS = EXPLICIT_STEPS + 1  # the slice's autoreset day ends every episode
# float instructions counted from csrc/xla_math.cuh (fused multiply-adds
# once): one explicit lane cost (the normal's uniform 3, log1p's rational
# function 17 or its log about as many, erf_inv's polynomial 10, the cost
# model 9); per (env, keyword) the threshold sigmoid (its exp 15, 10 more)
# and the rust moments (two ndtr of about 30 and two pdf of about 17 with
# the clipped normal's 25 products and sums); per cent cell of the python
# moments below the bid (an ndtr and 10 more; the cells from the bid on
# add 0)
EXPLICIT_LANE_OPS = 39
SIGMOID_OPS = 25
RUST_MOMENT_OPS = 120
PYTHON_CELL_OPS = 40


def explicit_phase(torch, dev, card, ops_per_word, int_ops_per_s, fp_ops_per_s):
    """Phase 11: agg_cells_gate's explicit mode against its plain version
    at full width for both cost models, timed beside its bound; then each
    model's slice through the kernels and the plain versions. Returns the
    mode's JSON entries, one per cost model."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel
    from adcraft_tpu_torch.step import agg_model, budget_cents, split_volume, xla_lanes

    fused = ad.agg_cells_gate
    bids = torch.full((E, K), BID, device=dev)
    cell = torch.arange(T * K, device=dev).view(1, T, K)
    entries = []
    for model_name, instance in (("RUST_QUIRK", "ILi1E"), ("PYTHON", "ILi2E")):
        cfg = EnvConfig(num_keywords=K, kind=KeywordKind.EXPLICIT,
                        cost_model=getattr(CostModel, model_name), max_volume=MAX_VOLUME,
                        budget=XLA_BUDGET, max_days=EXPLICIT_MAX_DAYS, **BENCH_XLA_KNOBS)
        model, lanes = agg_model(cfg), xla_lanes(cfg)
        scale = ad.AGG_SCALE[model]
        L, m0, m1 = lanes.L, lanes.m0, lanes.m1
        name = f"agg_cells_gate (explicit, {model_name.lower()})"
        env = VectorBiddingEnv(cfg, E, device=dev)
        state0, _ = env.reset(prng.PRNGKey(14))
        kw = state0.kw
        k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(15, dev), E)).unbind(-2)
        volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                             max=MAX_VOLUME)
        n_auc = split_volume(cfg, volume)
        n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
        n0, n1 = n_auc01[0], n_auc01[1]
        params = ad.pack_params(kw, bids)
        chunk_t = fused.default_chunk_t(K, lanes, dev, model)
        blocks = fused.occupancy(chunk_t, K, lanes, dev, model)
        print(f"{name}: ptxas {kernel_ptxas(ad.library.build_log, instance)}; chunk_t "
              f"{chunk_t}, {blocks} blocks per SM")
        with words_replaced(pk, pk.threefry_words_reference):
            imp_p, ncl_p, sfull_p, _ = ad.agg_cells_reference(params, n_auc01, k_cells, lanes,
                                                              model=model)
        ladder_steps = torch.log2(n1.clamp(max=m1).double() + 1).ceil() * (n1 > 0)
        max_err, timed = 0, {}
        for label, budget in EXPLICIT_BUDGETS[model_name]:
            budget_c = budget_cents(torch.full((E,), budget, device=dev), scale)

            def gate_call(chunk=None):
                return fused(params, n_auc01, k_cells, budget_c, lanes, chunk_t=chunk,
                             model=model)

            got = fused(params, n_auc01, k_cells, budget_c, lanes, keep_constants=True,
                        model=model)
            one = gate_call(1)
            torch.cuda.synchronize()
            with words_replaced(pk, pk.threefry_words_reference):
                want, plain_ms = once_ms(lambda: ad.agg_cells_gate_reference(
                    params, n_auc01, k_cells, budget_c, lanes, True, model))
            n_sim = want[3]
            sim = cell < n_sim.view(E, 1, 1)
            for out, chunk in ((got, chunk_t), (one, 1)):
                pairs = [("n_sim", out[3], n_sim)] + [
                    (what, out[i][sim], want[i][sim])
                    for i, what in enumerate(("imp", "acc", "spend"))]
                for what, g, w in pairs:
                    err = (g.long() - w.long()).abs().max().item() if g.numel() else 0
                    max_err = max(max_err, err)
                    if err:
                        fail(f"{name} vs plain ({label}, chunk_t {chunk}): {what} differs, "
                             f"max error {err}")
            for i, (g, w) in enumerate(zip(got[4], want[4])):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    fail(f"{name} vs plain ({label}): constant {i} differs in its bits")
            imp, acc, spend = want[:3]
            for mode in ad.REV_SAMPLING:
                out = ad.agg_outcomes(params, k_cells, *got[:4], n_auc01, lanes, mode)
                with words_replaced(pk, pk.threefry_words_reference):
                    out_want = ad.agg_outcomes_reference(params, k_cells, *want[:4], n_auc01,
                                                         lanes, mode)
                if not all(torch.equal(g, w) for g, w in zip(out, out_want)):
                    fail(f"agg_outcomes on {name}'s tables ({label}, {mode}) differs from plain")
            if (out[2].sum(1) > budget_c.clamp(min=0)).any():
                fail(f"{name} ({label}): an env spent more than its budget")
            phantom = sim & (imp == 0) & (acc > 0)
            gate_ms = cuda_ms(gate_call, reps=20)
            # the work this run's cells need, as phase 9 counts it: per
            # simulated cell an impression word where it has auctions, a
            # click word (every explicit cell has a candidate), a spend
            # normal where it has clicks and impressions (a phantom cell
            # spends nothing); the key blocks of each (env, t) with a
            # simulated cell; of each partial cell the lanes up to the
            # first over the budget or its last click, lite then deep, with
            # the keys they need. Float: the walks' levels, the ladder's
            # bisection, and each needed lane's normal and cost
            # (EXPLICIT_LANE_OPS), and each (env, keyword)'s sigmoid and
            # moments. Bytes: five parameter rows, counts, keys and budgets
            # in; imp, acc and spend of the simulated cells and n_sim out.
            flat = spend.view(E, T * K).long()
            b_before = budget_c.view(E, 1).long() - (torch.cumsum(flat, 1) - flat)
            simf = sim.view(E, T * K)
            partial = simf & (sfull_p.view(E, T * K).long() > b_before)
            accf, nclf = acc.view(E, T * K), ncl_p.view(E, T * K)
            m_cell = torch.where(cell.view(1, T * K) < K, m0, m1)
            looked = torch.minimum(torch.minimum(accf + 1, nclf), m_cell) * partial
            lite_words = looked.clamp(max=L).sum().item()
            deep_cells = (looked - L).clamp(min=0)
            deep = deep_cells.sum().item()
            n_deep_cells = (deep_cells > 0).sum().item()
            t_partial = partial.view(E, T, K).any(2).sum().item()
            t_rest = (deep_cells > 0).view(E, T, K).any(2).sum().item()
            n_t = torch.stack([n0] + [n1] * (T - 1), 1)
            cand = imp_p.clamp(min=1)
            cell_words = (((n_t > 0) & sim).sum() + sim.sum()
                          + ((ncl_p > 0) & (imp_p > 0) & sim).sum()).item()
            key_blocks = CELL_KEY_BLOCKS * sim.any(2).sum().item()
            words = (cell_words + key_blocks + lite_words + deep + n_deep_cells
                     + PARTIAL_KEY_BLOCKS * t_partial + t_rest)
            fp = (WALK_OPS * (walk_levels(imp_p[:, 0] * sim[:, 0], n0 * sim[:, 0])
                              + walk_levels(ncl_p * sim, cand * sim))
                  + (ladder_steps * sim[:, 1:].sum(1)).sum()).item()
            if model == ad.EXPLICIT_RUST:
                moment_ops = RUST_MOMENT_OPS * E * K
            else:
                grid = cfg.agg_cost_grid
                edges = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) * 0.01
                cells = torch.searchsorted(edges, params[ad.BID].reshape(-1)).sum().item()
                moment_ops = PYTHON_CELL_OPS * cells
            fp += EXPLICIT_LANE_OPS * (lite_words + deep) + SIGMOID_OPS * E * K + moment_ops
            nbytes = 4 * (5 * E * K + 2 * E * K + E) + 16 * E + 12 * simf.sum().item() + 4 * E
            gate_bound = max(bound(nbytes, words * ops_per_word, int_ops_per_s),
                             bound(nbytes, fp, fp_ops_per_s))
            timed[label] = (gate_ms, plain_ms, gate_bound)
            print(f"  {name} == plain ({label}, ${budget:g} = {int(budget_c[0])} units): "
                  f"simulated cells {sim.sum().item()} of {E * T * K}, {phantom.sum().item()} "
                  f"with phantom clicks, {partial.sum().item()} partial, {n_deep_cells} reach "
                  f"{deep} deep lanes; accepted clicks {acc[sim].sum().item()}, spend "
                  f"${spend[sim].sum().item() / scale:.2f}; agg_outcomes == plain in both "
                  f"modes; kernel {gate_ms:.4f} ms, plain {plain_ms:.1f} ms; {words} words, "
                  f"{fp:.4g} float ops, {nbytes / 1e6:.1f} MB; bound {gate_bound[0]:.4f} ms "
                  f"({gate_bound[1]}), {100 * gate_bound[0] / gate_ms:.1f}% of it reached "
                  f"({card})", flush=True)

        # the slice: counts zeroed just before, read just after
        kernels = {"agg_cells_gate": ad.agg_cells_gate, "agg_outcomes": ad.agg_outcomes}
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        state = state0
        steps = []
        for _ in range(EXPLICIT_STEPS):
            state, ts = env.step(state, bids)
            steps.append(ts)
        end_roll, roll = env.rollout(state0, bids, EXPLICIT_STEPS)
        reset_state, reset_ts = env.autoreset_step(state, bids, reset_kw=True)
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        days = 2 * EXPLICIT_STEPS + 1
        if any(n != days for n in launches.values()):
            fail(f"{name} slice launches {launches}, want {days} of each")
        if not (torch.equal(end_roll.key, state.key) and bool(reset_ts.terminated.all())
                and bool((reset_state.day == 0).all())):
            fail(f"{name} slice: rollout or autoreset state wrong")
        if torch.equal(reset_state.kw.vol_mean, state.kw.vol_mean):
            fail(f"{name} slice: autoreset(reset_kw=True) kept the keywords")
        for i, ts in enumerate(steps):
            o = ts.outcomes
            if not ((o.sellside_conversions <= o.buyside_clicks).all()
                    and torch.isfinite(ts.reward).all()
                    and (o.cost.sum(1) <= XLA_BUDGET + 1e-3).all()):
                fail(f"{name} slice step {i}: invariants violated")
            for f in o._fields:
                if not torch.equal(getattr(o, f), getattr(roll.outcomes, f)[i]):
                    fail(f"{name} rollout day {i}: {f} differs from step {i}")
        with agg_plain(ad), words_replaced(pk, pk.threefry_words_reference):
            plain = state0
            for i in range(EXPLICIT_STEPS):
                plain, ts = env.step(plain, bids)
                for f in ts.outcomes._fields:
                    if not torch.equal(getattr(ts.outcomes, f), getattr(steps[i].outcomes, f)):
                        fail(f"{name} slice step {i}: {f} differs between kernels and plain")
            plain_reset, plain_ts = env.autoreset_step(plain, bids, reset_kw=True)
        for a, b in zip(torch.utils._pytree.tree_leaves((plain_reset, plain_ts)),
                        torch.utils._pytree.tree_leaves((reset_state, reset_ts))):
            if not torch.equal(a, b):
                fail(f"{name} slice: the autoreset day differs between kernels and plain")
        o = [ts.outcomes for ts in steps]
        print(f"{name} slice: {EXPLICIT_STEPS} steps, rollout({EXPLICIT_STEPS}) and an autoreset "
              f"day x {E} envs "
              f"x {K} keywords, bids ${BID:.2f}, budget ${XLA_BUDGET:g}: "
              f"{sum(x.impressions.sum().item() for x in o)} impressions, "
              f"{sum(x.buyside_clicks.sum().item() for x in o)} clicks, "
              f"${sum(x.cost.sum().item() for x in o):.2f} spent; launches {launches}; "
              f"{days * E / slice_s:.1f} env-days/s; outcomes, keys and the reset state "
              f"equal to the plain versions' ({card})", flush=True)
        ms = timed["$1000"]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/agg_day.cu",
            "replaces": "adcraft_tpu/step.py:858-926 (_cell_tables, agg explicit branch), "
                        ":740 (_gate_keywords_scan_agg) and :1087 (_resolve_cell); the XLA "
                        "step has no TPU kernel",
            "launches": launches["agg_cells_gate"],
            "max_abs_err": max_err,
            "ms": ms[0],
            "plain_ms": ms[1],
            "bound_ms": ms[2][0],
            "bound_by": ms[2][1],
            "library_ms": None,
        })
    return entries


CAST_BUDGETS = (1e6, math.inf, 1e8, -3e7)  # unbound, two "unlimited" ones, INT32_MIN cents


def budget_cast_phase(torch, dev, card, table, pallas_env):
    """The budget's cents cast as XLA casts, on the card: one day on each
    route at $1e6 (which cannot bind at bids of $1.00), ``inf`` and $1e8
    (which must equal it) and -$3e7 (which accepts no click), each equal to
    the same day through the plain versions."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import day_kernel as dk
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS

    xla_cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME,
                        **BENCH_XLA_KNOBS)
    routes = (("pallas", pallas_env, lambda: day_kernel_replaced(dk, dk.simulate_day_reference)),
              ("xla", VectorBiddingEnv(xla_cfg, E, table, device=dev), lambda: agg_plain(ad)))
    bids = torch.full((E, K), BID, device=dev)
    for route, env, plain in routes:
        state, _ = env.reset(prng.PRNGKey(7))
        days = {}
        for budget in CAST_BUDGETS:
            budget_e = torch.full((E,), budget, device=dev)
            days[budget] = env.step(state, bids, budget_e)[1].outcomes
            with plain():
                want = env.step(state, bids, budget_e)[1].outcomes
            for f in want._fields:
                if not torch.equal(getattr(days[budget], f), getattr(want, f)):
                    fail(f"budget cast ({route}, ${budget:g}): {f} differs between kernel and "
                         f"plain")
        for budget in (math.inf, 1e8):
            for f in days[1e6]._fields:
                if not torch.equal(getattr(days[budget], f), getattr(days[1e6], f)):
                    fail(f"budget cast ({route}): the day at ${budget:g} differs from $1e6 in {f}")
        broke = days[-3e7]
        if broke.buyside_clicks.sum().item() != 0 or broke.cost.sum().item() != 0:
            fail(f"budget cast ({route}): the day at -$3e7 accepted clicks")
        print(f"budget cast ({route}): days at $inf and $1e8 == $1e6 "
              f"({days[1e6].buyside_clicks.sum().item()} clicks, "
              f"${days[1e6].cost.sum().item():.2f}); -$3e7 accepts 0 clicks; each == plain "
              f"({card})")


LANES_BUDGET = 1000.0
AUTORESET_DAYS = 3  # max_days of the autoreset run, which steps one more day
# the lanes slices' steps held to the plain versions in phases 10 and 12
# (the rest to the rollout's days): a plain lanes day takes 8-17 s at full
# width, and the script must end within 1200 s on slow hosts
PLAIN_STEPS = 2
LANES_VARIANT_ENVS = 1024
WIDE_K, WIDE_ENVS = 2100, 3  # past lanes_outcomes' old limit of 48 KB of keyword tables
PARENT_OUTCOMES_MAX_K = 2032  # that limit at T = 24: a parent tree may refuse more keywords
# float instructions per element and pass of binomial.cuh's loops (XLA's log
# with its fused multiply-adds, the divisions, the Stirling terms),
# per cost lane (the truncated Laplace inverse CDF in cents) and per revenue
# lane (XLA's erf_inv and log1p), as written; used only for the bounds
INVERSION_PASS_FP = 40
BTRS_PASS_FP = 200
COST_LANE_FP = 30
REVENUE_LANE_FP = 80
# key blocks: lanes_counts per (env, t) kt, k_auc, k_imp, k_click and per
# pass of a loop 2 (inversion) or 3 (BTRS); lanes_gate per simulated (env,
# t) kt, k_auc, k_cost; lanes_outcomes per (env, t) with a simulated cell
# kt, k_conv, k_rev
COUNTS_KEY_BLOCKS, GATE_KEY_BLOCKS, OUTCOME_KEY_BLOCKS = 4, 3, 3


def lanes_stats_build(ld):
    """The three lanes kernels built with -DLANES_STAGE_CLOCKS: the same
    kernels, whose warps also count their stages' clocks, cells, passes,
    lanes and draw steps."""
    library = ld.stats_library()
    return {"lanes_counts": ld.LanesCounts("lanes_counts (stats)", library),
            "lanes_gate": ld.LanesGate("lanes_gate (stats)", library),
            "lanes_gate_float": ld.LanesGateFloat("lanes_gate_float (stats)", library),
            "lanes_outcomes": ld.LanesOutcomes("lanes_outcomes (stats)", library)}


def read_lanes_stats(library, device_index: int) -> dict:
    """The counters summed since the last read, by name; zeroes them."""
    from adcraft_tpu_torch.lanes_day import read_stats

    return read_stats(library, device_index)


@contextlib.contextmanager
def lanes_plain(ld):
    """Route the lanes day through the plain versions of its kernels."""
    names = ("lanes_counts", "lanes_gate", "lanes_gate_float", "lanes_outcomes")
    kernels = [getattr(ld, n) for n in names]
    for n in names:
        setattr(ld, n, getattr(ld, n + "_reference"))
    try:
        yield
    finally:
        for n, kernel in zip(names, kernels):
            setattr(ld, n, kernel)


def inversion_passes(n, p, draws):
    """The exact binomial's inversion words per element and passes per call
    (row), and which elements take it: an element of count c > 0 whose
    q-space draw is s needs at least max(s, 1) words (s steps, or the one
    step past c that gives s = 0; its walk draws one more unless its sum
    lands on c, which the draw does not tell), one of count 0 none; a call
    runs the most of its elements' words in passes."""
    import torch

    q = torch.where(p < 0.5, p, 1.0 - p)
    inv = n.float() * q <= 10.0
    c = torch.floor(n.float())
    s = torch.where(p < 0.5, draws, n - draws).float()
    words = torch.where(inv & (c > 0), s.clamp(min=1.0), torch.zeros_like(s))
    return words, words.amax(-1), inv


def counts_work(calls, K: int):
    """(threefry words, float instructions) of lanes_counts' binomial calls
    ``calls`` [(n, p, draws), ...] of K elements each: each inversion
    element's words and its key blocks (two a pass), and where a call has
    a BTRS element, K elements' two words and the pass's three key blocks
    a pass (one pass counted: at least one)."""
    words = fp = 0.0
    for n, p, x in calls:
        inv_words, passes, inv = inversion_passes(n, p, x)
        btrs = (~inv).any(-1).float()
        words += (inv_words.sum(-1) + 2 * passes + btrs * (2 * K + 3)).sum().item()
        fp += (inv_words.sum(-1) * INVERSION_PASS_FP + btrs * K * BTRS_PASS_FP).sum().item()
    return words, fp


def lanes_counters(stats_kernels, lanes, params, n_auc01, k_cells, imp, ncl, budget_c, gate,
                   sim, out, label):
    """One day through the -DLANES_STAGE_CLOCKS build (its outputs equal to
    ``ncl``, ``gate`` and ``out``); prints the gate walk's cells, windows
    and stage clocks, the binomial loops' passes and clocks, and the
    outcome lanes, draw steps and stage clocks of lanes_outcomes."""
    import torch

    counts, gate_k = stats_kernels["lanes_counts"], stats_kernels["lanes_gate"]
    index = params.device.index or 0
    read_lanes_stats(counts.library, index)  # zero the counters
    _, ncl_s = counts(params, n_auc01, k_cells, lanes)
    g = gate_k(params, k_cells, ncl, budget_c, lanes)
    o = stats_kernels["lanes_outcomes"](params, k_cells, imp, gate[0], gate[1], gate[2], n_auc01,
                                        lanes)
    st = read_lanes_stats(counts.library, index)
    if not (torch.equal(ncl_s, ncl) and torch.equal(g[2], gate[2])
            and all(torch.equal(a[sim], b[sim]) for a, b in zip(g[:2], gate[:2]))
            and all(torch.equal(a, b) for a, b in zip(o, out))):
        fail(f"lanes day ({label}): the -DLANES_STAGE_CLOCKS build's outputs differ")
    flag_lanes = (gate[0].clamp(min=0) * sim).sum().item()
    convs = out[3].long().sum().item()
    owarps = st["outcomes warps"]
    if st["flag lanes"] != flag_lanes or st["revenue lanes"] != convs:
        fail(f"lanes_outcomes ({label}): {st['flag lanes']} flag and {st['revenue lanes']} revenue "
             f"lanes drawn, want {flag_lanes} and {convs}")
    if (st["partial flag steps"] > owarps or st["partial revenue steps"] > owarps
            or st["partial erf steps"] > 2 * owarps):
        fail(f"lanes_outcomes ({label}): more partial steps than warps' final drains")
    print(f"  lanes_outcomes lanes ({label}): {owarps} warps; {st['flag lanes']} flag lanes in "
          f"{st['flag steps']} steps ({st['partial flag steps']} partial), {st['revenue lanes']} "
          f"revenue lanes in {st['revenue steps']} draw steps ({st['partial revenue steps']} "
          f"partial) and {st['erf steps']} erf_inv steps ({st['erf log steps']} on log1p's log "
          f"branch, {st['partial erf steps']} partial); SM clocks per warp: prologue "
          f"{st['outcomes prologue clocks'] / owarps:.0f}, tiles and cheap sums "
          f"{st['outcomes tile clocks'] / owarps:.0f}, flag draws "
          f"{st['flag step clocks'] / owarps:.0f}, revenue draws "
          f"{st['revenue step clocks'] / owarps:.0f}, erf_inv steps "
          f"{st['erf step clocks'] / owarps:.0f}, barrier and write-out "
          f"{st['outcomes write clocks'] / owarps:.0f}; per step: flag "
          f"{st['flag step clocks'] / max(st['flag steps'], 1):.0f}, revenue draw "
          f"{st['revenue step clocks'] / max(st['revenue steps'], 1):.0f}, erf_inv "
          f"{st['erf step clocks'] / max(st['erf steps'], 1):.0f}")
    warps, cells = st["gate warps"], st["simulated cells"]
    alone = st["alone whole"] + st["alone passive"] + st["lane-resolved"] + st["redrawn"]
    print(f"  lanes_gate walk ({label}): {cells} simulated cells: {st['whole']} whole and "
          f"{st['passive']} passive in runs, {alone} decided alone ({st['alone whole']} whole, "
          f"{st['alone passive']} passive, {st['lane-resolved']} lane-resolved, "
          f"{st['redrawn']} walked after a skip), {st['deep cells']} deep; {st['windows']} "
          f"windows, {st['cut windows']} cut by the buffer, {st['skipped']} cells' lanes after "
          f"the first skipped; {st['cost lanes']} cost lanes drawn in windows, "
          f"{st['cost lanes'] / cells:.3f} per simulated cell; SM clocks per warp: keys "
          f"{st['gate keys clocks'] / warps:.0f}, stage A "
          f"{st['gate stage A clocks'] / warps:.0f}, stage B "
          f"{st['gate stage B clocks'] / warps:.0f}")
    calls = st["calls"]
    inv_calls, btrs_calls = max(st["inversion calls"], 1), max(st["BTRS calls"], 1)
    print(f"  lanes_counts loops ({label}): {calls} calls; inversion in {st['inversion calls']}, "
          f"{st['inversion passes'] / inv_calls:.2f} passes per call (most "
          f"{st['inversion max']}); BTRS in {st['BTRS calls']}, "
          f"{st['BTRS passes'] / btrs_calls:.2f} passes per call (most {st['BTRS max']}); SM "
          f"clocks per warp (two calls): inversion {2 * st['inversion clocks'] / calls:.0f}, "
          f"BTRS {2 * st['BTRS clocks'] / calls:.0f}, all {2 * st['counts clocks'] / calls:.0f}")


def lanes_phase(torch, dev, card, table, ops_per_word, int_ops_per_s, fp_ops_per_s, sms,
                stats_kernels, parent):
    """Phase 10: the lanes day (the JAX package's default knobs) on its three
    kernels against their plain versions at full width, its counters from
    ``stats_kernels``, the parent's kernels (``parent``, or None) in turns,
    the binomial alone, the 1024-env variants, then the slice through them.
    Returns their JSON entries."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import lanes_day as ld
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.auction import implicit_single_win_prob
    from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes

    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME,
                    budget=LANES_BUDGET)
    lanes = xla_lanes(cfg)
    kernels = {"lanes_counts": ld.lanes_counts, "lanes_gate": ld.lanes_gate,
               "lanes_outcomes": ld.lanes_outcomes}
    max_err = dict.fromkeys(kernels, 0)
    log = ld.library.build_log
    for R in range(1, 5):
        print(f"lanes_counts<{R}>: ptxas {kernel_ptxas(log, f'lanes_counts_kernelILi{R}ELb0E')}")
    print(f"lanes_gate: ptxas {kernel_ptxas(log, 'lanes_gate_kernelILb0E')}")
    for tables, where in (("1", "shared"), ("0", "device")):
        print(f"lanes_outcomes (keyword tables in {where} memory): ptxas "
              f"{kernel_ptxas(log, f'lanes_outcomes_kernelILb{tables}E')}")
    occ = ld.occupancy(K, lanes, dev)
    print(f"lanes_counts: {occ['counts_blocks']} blocks of 4 warps per SM at K = {K}; lanes_gate: "
          f"{occ['gate_blocks']} blocks of 4 warps per SM, {occ['gate_smem']} B shared memory per "
          f"block; lanes_outcomes: {occ['outcomes_blocks']} blocks of 4 warps per SM, "
          f"{occ['outcomes_smem']} B shared memory per block (keyword tables in "
          f"{'shared' if occ['outcomes_tables_in_smem'] else 'device'} memory)")
    # the float conversions of a revenue lane's erf_inv (fma32's, which
    # were float64 before it became __fmaf_rn): the kernel's F2F over its
    # inlined erf_inv steps, one per compare of
    # erf_inv's w with -5 (each step runs one branch of log1p)
    sass = sass_ops(ld.library.path, "lanes_outcomes_kernelILb1E")
    if sass is None:
        print("lanes_outcomes SASS: not readable")
    else:
        copies = sum(op.startswith("FSETP") and re.search(r",\s*-5(\.0*)?\s*,", args) is not None
                     for op, args in sass)
        ops = collections.Counter(op.split(".")[0] for op, _ in sass)
        f2f = collections.Counter(op for op, _ in sass if op.startswith("F2F"))
        warp = {op: ops[op] for op in ("SHFL", "VOTE", "REDUX", "WARPSYNC", "BSSY", "ATOMS")}
        print(f"lanes_outcomes SASS: {len(sass)} instructions, {copies} inlined erf_inv steps; per "
              f"revenue lane {ops['F2F'] / max(copies, 1):g} F2F {dict(f2f)}, "
              f"{ops['DFMA'] / max(copies, 1):g} DFMA, {ops['MUFU'] / max(copies, 1):g} MUFU; "
              f"warp intrinsics and their convergence code {warp}")

    def compare(name, pairs, label):
        for what, g, w in pairs:
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{name} vs plain ({label}): {what} is {g.dtype} {tuple(g.shape)}, plain "
                     f"{w.dtype} {tuple(w.shape)}")
            err = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                fail(f"{name} vs plain ({label}): {what} differs, max error {err}")

    def parent_differs(name, pairs, label):
        """Prints how many of the parent's outputs differ from this tree's:
        none where the two trees compute the same, some where this tree's
        float arithmetic changed (F4's single rounding, F5's XLA math)."""
        counts = {what: (g != w).sum().item() for what, g, w in pairs}
        print(f"  {name} ({label}): the parent's outputs differ from this tree's in "
              + ", ".join(f"{n} of {what}" for what, n in counts.items()))

    def day_inputs(envs, seed, lanes_cfg):
        state, _ = VectorBiddingEnv(lanes_cfg, envs, table, device=dev).reset(
            prng.PRNGKey(seed))
        k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(seed + 1, dev), envs)).unbind(-2)
        kw = state.kw
        volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                             max=MAX_VOLUME)
        n_auc = split_volume(lanes_cfg, volume)
        n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
        params = ad.pack_params(kw, torch.full((envs, lanes_cfg.num_keywords), BID, device=dev))
        return params, n_auc01, k_cells

    def check_day(params, n_auc01, k_cells, budget_c, lanes_, sampler, label):
        """The three kernels against their plain versions on one day, and
        lanes_outcomes against the parent's where it takes the day's K;
        returns the kernels' outputs, the plain ones and the plain times."""
        envs, nk = params.shape[1:]
        got_counts = ld.lanes_counts(params, n_auc01, k_cells, lanes_, sampler)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want_counts, counts_ms = once_ms(lambda: ld.lanes_counts_reference(
                params, n_auc01, k_cells, lanes_, sampler))
        compare("lanes_counts", zip(("imp", "ncl"), got_counts, want_counts), label)
        imp, ncl = got_counts
        got_gate = ld.lanes_gate(params, k_cells, ncl, budget_c, lanes_)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want_gate, gate_ms = once_ms(lambda: ld.lanes_gate_reference(
                params, k_cells, ncl, budget_c, lanes_))
        n_sim = want_gate[2]
        sim = torch.arange(lanes_.T * nk, device=dev).view(1, lanes_.T, nk) < n_sim.view(-1, 1, 1)
        compare("lanes_gate", [("n_sim", got_gate[2], n_sim)] + [
            (what, g[sim], w[sim]) for what, g, w in zip(("acc", "spend"), got_gate, want_gate)],
            label)
        acc, spend = want_gate[:2]
        acc, spend = acc * sim, spend * sim
        got_out = ld.lanes_outcomes(params, k_cells, imp, got_gate[0], got_gate[1], n_sim,
                                    n_auc01, lanes_)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want_out, out_ms = once_ms(lambda: ld.lanes_outcomes_reference(
                params, k_cells, imp, acc, spend, n_sim, n_auc01, lanes_))
        compare("lanes_outcomes", [(f"day sum {i}", g, w) for i, (g, w) in
                                   enumerate(zip(got_out, want_out))], label)
        if parent is not None and sampler == "inversion":
            # the walk's pmf0 is XLA's powf (F7), so counts may differ from
            # the parent's where a CDF lies within an ulp of its uniform
            this_counts = lambda: ld.lanes_counts(params, n_auc01, k_cells, lanes_, sampler)  # noqa: E731
            parent_counts = lambda: parent["lanes_counts"](  # noqa: E731
                params, n_auc01, k_cells, lanes_, sampler)
            parent_differs("lanes_counts", zip(("imp", "ncl"), parent_counts(), got_counts),
                           label)
            turns = [cuda_ms(c, reps=10) for c in (parent_counts, this_counts, this_counts,
                                                    parent_counts)]
            print(f"  lanes_counts ({label}) in turns with the parent's: parent {turns[0]:.4f} / "
                  f"{turns[3]:.4f} ms, this {turns[1]:.4f} / {turns[2]:.4f} ms ({card})")
        if parent is not None:
            try:
                pout = parent["lanes_outcomes"](params, k_cells, imp, got_gate[0], got_gate[1],
                                                n_sim, n_auc01, lanes_)
            except RuntimeError as exc:
                if nk <= PARENT_OUTCOMES_MAX_K:
                    raise
                print(f"  the parent's lanes_outcomes refuses K = {nk} ({label}): {exc}")
            else:
                parent_differs("lanes_outcomes", [(f"day sum {i}", g, w) for i, (g, w) in
                                                  enumerate(zip(pout, got_out))], label)
        if (got_out[2].sum(1) > budget_c.clamp(min=0)).any():
            fail(f"lanes day ({label}): an env spent more than its budget")
        if not ((got_out[1] <= got_out[0]).all() and (got_out[3] <= got_out[1]).all()):
            fail(f"lanes day ({label}): clicks <= imps, convs <= clicks violated")
        print(f"lanes_counts, lanes_gate, lanes_outcomes == plain ({label}, {envs} envs): "
              f"simulated cells {sim.sum().item()} of {sim.numel()}, "
              f"imps {got_out[0].sum().item()} clicks {got_out[1].sum().item()} cost "
              f"${got_out[2].sum().item() / 100:.2f} convs {got_out[3].sum().item()} revenue "
              f"${got_out[4].sum().item() / 100:.2f}")
        return (imp, ncl, got_gate, n_sim, sim, got_out,
                {"lanes_counts": counts_ms, "lanes_gate": gate_ms, "lanes_outcomes": out_ms})

    # the three kernels against their plain versions at full width, timed
    params, n_auc01, k_cells = day_inputs(E, 20, cfg)
    p_win = implicit_single_win_prob(params[ad.BID], params[ad.LOC], params[ad.SCALE])
    n_t = torch.stack([n_auc01[0]] + [n_auc01[1]] * (T - 1), 1)  # (E, T, K)
    timed = {}
    for label, budget in (("unbound", 1e6), ("binding", LANES_BUDGET)):
        budget_c = budget_cents(torch.full((E,), budget, device=dev))
        imp, ncl, gate, n_sim, sim, out, plain_ms = check_day(
            params, n_auc01, k_cells, budget_c, lanes, "exact", label)
        calls = {
            "lanes_counts": lambda: ld.lanes_counts(params, n_auc01, k_cells, lanes),
            "lanes_gate": lambda: ld.lanes_gate(params, k_cells, ncl, budget_c, lanes),
            "lanes_outcomes": lambda: ld.lanes_outcomes(params, k_cells, imp, gate[0], gate[1],
                                                        n_sim, n_auc01, lanes),
        }
        # lanes_counts: per call of K keywords, each inversion element's
        # words, BTRS's K elements at least one pass, and their key blocks
        counts_words, counts_fp = counts_work(
            ((n_t, p_win[:, None, :].expand(E, T, K), imp),
             (imp, params[ad.BCTR][:, None, :].expand(E, T, K), ncl)), K)
        counts_words += COUNTS_KEY_BLOCKS * E * T
        counts_bytes = 4 * (4 * E * K + 2 * E * K) + 16 * E + 8 * E * T * K
        # lanes_gate: each simulated cell's cost lanes up to the first over
        # the budget or its last click; its key blocks per simulated (env, t)
        acc = gate[0] * sim
        looked = (torch.minimum(acc + 1, ncl) * sim).sum().item()
        gate_words = looked + GATE_KEY_BLOCKS * sim.any(2).sum().item()
        gate_bytes = 4 * (3 * E * K + E * T * K + E) + 16 * E + 8 * sim.sum().item() + 4 * E
        # lanes_outcomes: a flag word per accepted click, a revenue word per
        # conversion, its key blocks per (env, t) with a simulated cell
        convs = out[3].sum().item()
        out_words = acc.sum().item() + convs + OUTCOME_KEY_BLOCKS * sim.any(2).sum().item()
        out_bytes = 12 * sim.sum().item() + 4 * (3 * E * K + 2 * E * K + E) + 16 * E + 24 * E * K
        work = {
            "lanes_counts": (counts_bytes, counts_words, counts_fp),
            "lanes_gate": (gate_bytes, gate_words, COST_LANE_FP * looked),
            "lanes_outcomes": (out_bytes, out_words, REVENUE_LANE_FP * convs),
        }
        timed[label] = {}
        for name, call in calls.items():
            nbytes, words, fp = work[name]
            kbound = max(bound(nbytes, words * ops_per_word, int_ops_per_s),
                         bound(nbytes, fp, fp_ops_per_s))
            ms = cuda_ms(call, reps=10)
            timed[label][name] = (ms, plain_ms[name], kbound)
            print(f"  {name} ({label}): kernel {ms:.4f} ms, plain {plain_ms[name]:.1f} ms; "
                  f"{words:.0f} threefry words, {fp:.4g} float ops, {nbytes / 1e6:.1f} MB; bound "
                  f"{kbound[0]:.4f} ms ({kbound[1]}), {100 * kbound[0] / ms:.1f}% of it reached "
                  f"({card})")
        lanes_counters(stats_kernels, lanes, params, n_auc01, k_cells, imp, ncl, budget_c, gate,
                       sim, out, label)
        if parent is not None:
            pcalls = {
                "lanes_counts": lambda: parent["lanes_counts"](params, n_auc01, k_cells, lanes),
                "lanes_gate": lambda: parent["lanes_gate"](params, k_cells, ncl, budget_c, lanes),
                "lanes_outcomes": lambda: parent["lanes_outcomes"](
                    params, k_cells, imp, gate[0], gate[1], n_sim, n_auc01, lanes),
            }
            pcounts, pgate, pout = (pcalls[name]() for name in kernels)
            parent_differs("lanes_counts", zip(("imp", "ncl"), pcounts, (imp, ncl)), label)
            parent_differs("lanes_gate", [("n_sim", pgate[2], n_sim)] + [
                (what, g[sim], w[sim]) for what, g, w in zip(("acc", "spend"), pgate, gate)],
                label)
            parent_differs("lanes_outcomes", [(f"day sum {i}", g, w) for i, (g, w) in
                                              enumerate(zip(pout, out))], label)
            for name, call in calls.items():
                turns = [cuda_ms(c, reps=10) for c in (pcalls[name], call, call, pcalls[name])]
                kb = timed[label][name][2][0]
                print(f"  {name} ({label}) in turns with the parent's: parent "
                      f"{turns[0]:.4f} / {turns[3]:.4f} ms ({100 * kb / turns[0]:.1f}% / "
                      f"{100 * kb / turns[3]:.1f}% of the bound), this {turns[1]:.4f} / "
                      f"{turns[2]:.4f} ms ({100 * kb / turns[1]:.1f}% / "
                      f"{100 * kb / turns[2]:.1f}%) ({card})")

    # the binomial alone: lanes_counts on a grid of (n, p), one pair per
    # keyword, n the same at every sub-timestep; p is the win probability
    # of loc 0 and the scale that gives the pair's p (p = 0 at a bid of
    # $0.005, p = 1 at a vanishing scale)
    envs = LANES_VARIANT_ENVS
    n_grid = torch.tensor([0, 1, 5, 19, 20, 21, 30, 47, 100, 300, 600] * 10, device=dev)[:K]
    p_grid = torch.tensor([0.0, 0.5, 1.0, 0.02, 0.3, 0.45, 0.55, 0.7, 0.98, 0.1], device=dev)
    p_grid = p_grid.repeat_interleave(11)[:K]
    bid = torch.where(p_grid == 0.0, 0.005, 1.0)
    y0 = bid - 0.005
    scale = torch.where(p_grid >= 1.0, 1e-30,
                        torch.where(p_grid == 0.0, 1.0, -y0 / torch.log1p(-p_grid)))
    gparams = torch.zeros((ad.NUM_PARAMS, envs, K), device=dev)
    gparams[ad.BID], gparams[ad.SCALE], gparams[ad.BCTR] = bid, scale, 0.5
    gparams[ad.LOC] = 0.0
    gn = n_grid.to(torch.int32).expand(2, envs, K).contiguous()
    gkeys = prng.split(prng.PRNGKey(31, dev), envs)
    got = ld.lanes_counts(gparams, gn, gkeys, lanes)
    torch.cuda.synchronize()
    with words_replaced(pk, pk.threefry_words_reference):
        want = ld.lanes_counts_reference(gparams, gn, gkeys, lanes)
    compare("lanes_counts", zip(("grid imp", "grid ncl"), got, want), "binomial grid")
    gp = implicit_single_win_prob(gparams[ad.BID], gparams[ad.LOC], gparams[ad.SCALE])[0].double()
    nd = n_grid.double()
    x = got[0].double()  # (envs, T, K)
    samples = envs * T
    mean, var = x.mean((0, 1)), x.var((0, 1))
    want_mean, want_var = nd * gp, nd * gp * (1 - gp)
    mu4 = want_var * (1 + 3 * (nd - 2) * gp * (1 - gp))
    se_mean = (want_var / samples).sqrt()
    # the sample variance's variance: mu4 / N - sigma^4 (N - 3) / (N (N - 1))
    se_var = (mu4 / samples - want_var ** 2 * (samples - 3) / (samples * (samples - 1))).sqrt()
    z_mean = ((mean - want_mean).abs() / se_mean.clamp(min=1e-12))
    z_var = ((var - want_var).abs() / se_var.clamp(min=1e-12))
    degenerate = want_var == 0
    if not torch.equal(mean[degenerate], want_mean[degenerate]):
        fail("binomial grid: a degenerate pair (n = 0, p = 0 or p = 1) drew off its value")
    worst = max(z_mean[~degenerate].max().item(), z_var[~degenerate].max().item())
    if worst > MAX_SE:
        fail(f"binomial grid: mean or variance {worst:.2f} standard errors off")
    inv_pairs = (nd * torch.minimum(gp, 1 - gp) <= 10).sum().item()
    print(f"binomial grid ({envs} envs x {T} sub-timesteps per pair, {K} pairs, {inv_pairs} on "
          f"the inversion side, n up to {int(nd.max())}): == plain; mean and variance within "
          f"{worst:.2f} standard errors (limit {MAX_SE:g})")

    # the 1024-env variants: the inversion sampler and 16-bit lanes
    for knobs in ({"binomial_sampler": "inversion"}, {"lane_bits": 16}):
        vcfg = cfg.replace(**knobs)
        vparams, vn, vkeys = day_inputs(envs, 40, vcfg)
        check_day(vparams, vn, vkeys, budget_cents(torch.full((envs,), LANES_BUDGET, device=dev)),
                  xla_lanes(vcfg), vcfg.binomial_sampler, f"variant {knobs}")
    # more keywords than lanes_outcomes' shared tables took before (48 KB)
    wcfg = cfg.replace(num_keywords=WIDE_K)
    wlanes = xla_lanes(wcfg)
    wparams, wn, wkeys = day_inputs(WIDE_ENVS, 50, wcfg)
    wocc = ld.occupancy(WIDE_K, wlanes, dev)
    check_day(wparams, wn, wkeys, budget_cents(torch.full((WIDE_ENVS,), 1e6, device=dev)), wlanes,
              "exact", f"K = {WIDE_K}")
    print(f"  lanes_outcomes at K = {WIDE_K}: {wocc['outcomes_smem']} B shared memory per block "
          f"(tables in {'shared' if wocc['outcomes_tables_in_smem'] else 'device'} memory), "
          f"{wocc['outcomes_blocks']} blocks per SM")

    # the slice: 5 steps, rollout(5) and an autoreset run whose episodes end
    # (max_days 3, 4 days), counts zeroed just before and read just after;
    # then the first PLAIN_STEPS steps and the autoreset days through the
    # plain versions
    env = VectorBiddingEnv(cfg, E, table, device=dev)
    reset_env = VectorBiddingEnv(cfg.replace(max_days=AUTORESET_DAYS), E, table, device=dev)
    state_a, _ = env.reset(prng.PRNGKey(21))
    state_r, _ = reset_env.reset(prng.PRNGKey(22))
    bids = torch.full((E, K), BID, device=dev)
    torch.cuda.synchronize()
    for kernel in kernels.values():
        kernel.launches = 0
    pk.threefry_words.launches = 0
    t0 = time.perf_counter()
    state, steps, states = state_a, [], []
    for _ in range(STEPS):
        state, ts = env.step(state, bids)
        steps.append(ts)
        states.append(state)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    end_step = state
    end_roll, roll = env.rollout(state_a, bids, STEPS)
    state, resets = state_r, []
    for _ in range(AUTORESET_DAYS + 1):
        state, ts = reset_env.autoreset_step(state, bids)
        resets.append((state, ts))
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    words_launches = pk.threefry_words.launches
    days = 2 * STEPS + AUTORESET_DAYS + 1
    if any(n != days for n in launches.values()):
        fail(f"lanes slice launches {launches}, want {days} of each")
    if words_launches == 0:
        fail("lanes slice: no threefry_words launch")
    for i, ts in enumerate(steps):
        o = ts.outcomes
        if not ((o.buyside_clicks <= o.impressions).all() and (o.impressions <= o.volume).all()
                and (o.sellside_conversions <= o.buyside_clicks).all()
                and (o.revenue >= 0.01 * o.sellside_conversions - 1e-3).all()):
            fail(f"lanes step {i}: clicks <= imps <= volume, convs <= clicks, revenue >= $0.01 "
                 f"per conversion violated")
        if (o.cost.sum(1) > LANES_BUDGET + 1e-3).any():
            fail(f"lanes step {i}: an env spent more than the ${LANES_BUDGET:g} budget")
        if not torch.isfinite(ts.reward).all():
            fail(f"lanes step {i}: non-finite reward")
        for f in o._fields:
            if not torch.equal(getattr(o, f), getattr(roll.outcomes, f)[i]):
                fail(f"lanes rollout day {i}: {f} differs from step {i}")
    if not (torch.equal(end_step.key, end_roll.key) and (end_step.day == STEPS).all()):
        fail("lanes rollout: the final state differs from the steps'")
    if steps[-1].outcomes.sellside_conversions.sum().item() <= 0:
        fail("lanes slice: no conversions")
    ended = resets[AUTORESET_DAYS - 1]
    if not (ended[1].terminated.all() and (ended[0].day == 0).all()
            and (resets[-1][0].day == 1).all()):
        fail("lanes autoreset: the episodes did not end and restart at max_days")

    t0 = time.perf_counter()
    with lanes_plain(ld), words_replaced(pk, pk.threefry_words_reference):
        state = state_a
        for i in range(PLAIN_STEPS):
            state, ts = env.step(state, bids)
            want = steps[i]
            pairs = [("reward", ts.reward, want.reward)]
            pairs += [("obs." + f, ts.obs[f], want.obs[f]) for f in want.obs]
            pairs += [("outcomes." + f, getattr(ts.outcomes, f), getattr(want.outcomes, f))
                      for f in want.outcomes._fields]
            for name, a, b in pairs:
                if not torch.equal(a, b):
                    fail(f"lanes slice step {i}: {name} differs between kernels and plain")
        if not torch.equal(state.key, states[PLAIN_STEPS - 1].key):
            fail("lanes slice: the state key differs between kernels and plain")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        state = state_r
        for i, (want_state, want_ts) in enumerate(resets):
            state, ts = reset_env.autoreset_step(state, bids)
            for f in want_ts.outcomes._fields:
                if not torch.equal(getattr(ts.outcomes, f), getattr(want_ts.outcomes, f)):
                    fail(f"lanes autoreset day {i}: outcomes.{f} differs between kernels and plain")
            for f in ("day", "cumulative_profit", "budget", "key"):
                if not torch.equal(getattr(state, f), getattr(want_state, f)):
                    fail(f"lanes autoreset day {i}: state {f} differs between kernels and plain")
            for f, a in zip(state.kw._fields, state.kw):
                if not torch.equal(a, getattr(want_state.kw, f)):
                    fail(f"lanes autoreset day {i}: kw.{f} differs between kernels and plain")

    def run_steps():
        st = state_a
        for _ in range(STEPS):
            st, _ts = env.step(st, bids)

    events, busy_ms, wall_ms = device_busy(run_steps, STEPS)
    imps = sum(ts.outcomes.impressions.sum().item() for ts in steps)
    cost = sum(ts.outcomes.cost.sum().item() for ts in steps)
    print(f"lanes slice: {STEPS} steps, rollout({STEPS}) and {AUTORESET_DAYS + 1} autoreset days "
          f"(max_days {AUTORESET_DAYS}) x {E} envs x {K} keywords, bids ${BID:.2f}, budget "
          f"${LANES_BUDGET:g}: {imps} impressions, ${cost:.2f} spent; launches {launches}, "
          f"threefry_words {words_launches / days:g} per day; == plain (the first {PLAIN_STEPS} "
          f"steps, keys, autoreset states); kernels {STEPS * E / step_s:.1f} env-steps/s "
          f"({step_s:.3f} s), plain {PLAIN_STEPS * E / plain_s:.1f} env-steps/s; per step "
          f"under the profiler: {events:.1f} CUDA "
          f"device events, device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% ({card})")

    ms = timed["binding"]
    replaces = {
        "lanes_counts": "adcraft_tpu/step.py:926-951 (_cell_tables' lanes impressions and clicks, "
                        "auction.py:126 and distributions.py:84; no TPU kernel)",
        "lanes_gate": "adcraft_tpu/step.py:115 (_gate_keywords; cost lanes of auction.py:126; no "
                      "TPU kernel)",
        "lanes_outcomes": "adcraft_tpu/step.py:953-988 and :1400-1502 (lanes conversions, revenue "
                          "and day sums; no TPU kernel)",
    }
    return [
        {
            "name": name,
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/lanes_day.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms[name][0],
            "plain_ms": ms[name][1],
            "bound_ms": ms[name][2][0],
            "bound_by": ms[name][2][1],
            "library_ms": None,
        }
        for name in kernels
    ]


# "prefix": each env's budget the scan of its first sub-timestep's unbound
# spends reaches exactly at cell PREFIX_CELL (a later cell's B - spend is 0);
# at it and at $0 days break after their first sub-timestep
EXPLICIT_LANES_BUDGETS = {"RUST_QUIRK": (("$1000", XLA_BUDGET), ("tight", 10.0), ("$0", 0.0),
                                         ("prefix", None)),
                          "PYTHON": (("$1000", XLA_BUDGET), ("tight", 2.0), ("$0", 0.0))}
PREFIX_CELL = 19  # past the spends' first block of 16 (K - 3 where K is smaller)
# lanes_gate_float past element 256 of a sub-timestep, where a zero spend at
# a 16-block's start may move XLA's scan: K = 300 at a few hundred envs; its
# "prefix" budget reached in the block from element 288
WIDE_FLOAT_K, WIDE_FLOAT_ENVS, WIDE_PREFIX_CELL = 300, 256, 293
WIDE_FLOAT_BUDGETS = ("$1000", "prefix")
# EnvConfig's own lane counts: max_volume 1024 at T = 24 gives m0 = 65 (past
# the kernels' 32-lane windows) and m1 = 42; its 10 keywords
DEFAULT_SHAPE = {"max_volume": 1024, "num_keywords": 10}
# float instructions per scan step of a cost lane's prefix (the float gate)
SCAN_OPS = 6


def explicit_lanes_kind(name: str) -> str:
    """The work and launch count a phase 12 kernel name goes by: its gate,
    lanes_outcomes (either mode) or lanes_counts' explicit instance."""
    if "gate" in name:
        return "gate"
    return "lanes_outcomes" if name.startswith("lanes_outcomes") else name


def explicit_lanes_phase(torch, dev, card, ops_per_word, int_ops_per_s, fp_ops_per_s,
                         stats_kernels, parent):
    """Phase 12: explicit keywords on the lanes route (EnvConfig's defaults),
    both cost models: lanes_counts' explicit instance, lanes_gate's python
    instance or lanes_gate_float, and lanes_outcomes (float mode for the
    rust model) against their plain versions at full width, at
    EnvConfig's own lane counts and (rust, untimed) at K = 300, timed
    beside their bounds; lanes_gate_float's counters from the
    -DLANES_STAGE_CLOCKS build on every rust day and, with ``parent``, its
    outputs equal to the parent tree's and its time in turns with it; then
    each model's slice through the kernels and the plain versions. Returns
    the JSON entries of the new kernels and instances."""
    from adcraft_tpu_torch import EnvConfig, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import kernel_turns
    from adcraft_tpu_torch import lanes_day as ld
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch import xla_math
    from adcraft_tpu_torch.config import CostModel
    from adcraft_tpu_torch.step import agg_model, budget_cents, split_volume, xla_lanes

    log = ld.library.build_log
    print(f"lanes_counts (explicit): ptxas "
          f"{kernel_ptxas(log, 'lanes_counts_explicit_kernelILi4E')}")
    print(f"lanes_gate (python): ptxas {kernel_ptxas(log, 'lanes_gate_kernelILb1E')}")
    print(f"lanes_gate_float: ptxas {kernel_ptxas(log, 'lanes_gate_float_kernel')}")
    entries, max_err = {}, collections.defaultdict(int)

    def compare(name, pairs, label):
        for what, g, w in pairs:
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{name} vs plain ({label}): {what} is {g.dtype} {tuple(g.shape)}, plain "
                     f"{w.dtype} {tuple(w.shape)}")
            if g.dtype == torch.float32:  # bit for bit
                g, w = g.view(torch.int32), w.view(torch.int32)
            err = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                fail(f"{name} vs plain ({label}): {what} differs, max error {err}")

    def inputs(cfg, envs, seed):
        env = VectorBiddingEnv(cfg, envs, device=dev)
        state, _ = env.reset(prng.PRNGKey(seed))
        k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(seed + 1, dev), envs)).unbind(-2)
        volume = torch.clamp(dist.nonneg_int_normal(k_vol, state.kw.vol_mean, state.kw.vol_std),
                             max=cfg.max_volume)
        n_auc = split_volume(cfg, volume)
        n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
        bids = torch.full((envs, cfg.num_keywords), BID, device=dev)
        return env, state, ad.pack_params(state.kw, bids), n_auc01, k_cells

    def check_counts(cfg, params, n_auc01, k_cells, label):
        """lanes_counts' explicit instance against its plain version (the
        counts do not depend on the budget): its outputs and plain time."""
        model, lanes = agg_model(cfg), xla_lanes(cfg)
        counts = ld.lanes_counts(params, n_auc01, k_cells, lanes, "exact", model)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want, counts_ms = once_ms(lambda: ld.lanes_counts_reference(
                params, n_auc01, k_cells, lanes, "exact", model))
        compare("lanes_counts (explicit)", zip(("imp", "ncl"), counts, want), label)
        return counts, counts_ms

    def check_day(cfg, params, n_auc01, k_cells, counts, budget, label):
        """The gate and lanes_outcomes on ``counts`` against their plain
        versions on one day: the outputs, the plain times, and the calls
        that time the kernels."""
        model, lanes = agg_model(cfg), xla_lanes(cfg)
        rust = model == ad.EXPLICIT_RUST
        envs, nk = params.shape[1:]
        gate_name = "lanes_gate_float" if rust else "lanes_gate (python)"
        out_name = "lanes_outcomes (float)" if rust else "lanes_outcomes"
        (imp, ncl), counts_ms = counts
        if rust:
            if budget is None:
                unbound = ld.lanes_gate_float_reference(
                    params, k_cells, ncl, imp, torch.full((envs,), 1e9, device=dev), lanes)[1]
                prefix_cell = min(PREFIX_CELL, nk - 3) if nk <= 256 else WIDE_PREFIX_CELL
                budget_g = xla_math.cumsum(unbound[:, 0], 1)[:, prefix_cell]
                budget_g = budget_g.contiguous()
            else:
                budget_g = torch.full((envs,), budget, device=dev)
            gate_call = lambda: ld.lanes_gate_float(params, k_cells, ncl, imp, budget_g, lanes)  # noqa: E731
            plain_gate = lambda: ld.lanes_gate_float_reference(  # noqa: E731
                params, k_cells, ncl, imp, budget_g, lanes)
        else:
            budget_g = budget_cents(torch.full((envs,), budget, device=dev))
            gate_call = lambda: ld.lanes_gate(params, k_cells, ncl, budget_g, lanes, model, imp)  # noqa: E731
            plain_gate = lambda: ld.lanes_gate_reference(  # noqa: E731
                params, k_cells, ncl, budget_g, lanes, model, imp)
        gate = gate_call()
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want_gate, gate_ms = once_ms(plain_gate)
        n_sim = want_gate[2]
        cell = torch.arange(lanes.T * nk, device=dev).view(1, lanes.T, nk)
        sim = cell < n_sim.view(-1, 1, 1)
        # lanes_gate_float writes the whole sub-timesteps it walks: the -1
        # of the cells after a stop too
        walked = cell < ((n_sim + nk - 1) // nk * nk).view(-1, 1, 1) if rust else sim
        pairs = [("n_sim", gate[2], n_sim)] + [
            (what, g[walked], w[walked]) for what, g, w in zip(("acc", "spend"), gate, want_gate)]
        compare(gate_name, pairs, label)
        parent_gate = None
        if rust:
            clocked = stats_kernels["lanes_gate_float"]
            kernel_turns.float_gate_counters(
                label, lambda: clocked(params, k_cells, ncl, imp, budget_g, lanes), clocked, gate,
                lanes, dev)
            if parent is not None:
                parent_gate = lambda: parent["lanes_gate_float"](  # noqa: E731
                    params, k_cells, ncl, imp, budget_g, lanes)
                # the walk is redesigned, its arithmetic is not: the parent's
                # outputs equal this tree's bit for bit
                pgate = parent_gate()
                compare(gate_name, [("parent's n_sim", pgate[2], gate[2])] + [
                    (f"parent's {what}", g[walked], w[walked])
                    for what, g, w in zip(("acc", "spend"), pgate, gate)], label)
        if budget in (0.0, None):
            broke = (n_sim <= nk).sum().item()
            unsimulated = (gate[0][walked] == -1).sum().item()
            marked = f"; {unsimulated} walked cells not simulated (-1)" if rust else ""
            print(f"  {gate_name} ({label}): {broke} of {envs} days break after the first "
                  f"sub-timestep{marked}")
            if broke == 0 or (rust and unsimulated == 0):
                fail(f"{gate_name} ({label}): no day broke or no walked cell was left unsimulated")
        out_call = lambda: ld.lanes_outcomes(params, k_cells, imp, gate[0], gate[1], n_sim,  # noqa: E731
                                             n_auc01, lanes)
        out = out_call()
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want_out, out_ms = once_ms(lambda: ld.lanes_outcomes_reference(
                params, k_cells, imp, *want_gate[:3], n_auc01, lanes))
        compare(out_name, [(f"day sum {i}", g, w) for i, (g, w) in enumerate(zip(out, want_out))],
                label)
        spent = out[2].sum(1) if rust else out[2].sum(1) / 100.0
        if (spent > (budget_g if rust else budget_g / 100.0) + 1e-3).any():
            fail(f"explicit lanes day ({label}): an env spent more than its budget")
        phantom = (sim & (imp == 0) & (gate[0] > 0)).sum().item()
        simulated = sim & (gate[0] >= 0)
        print(f"  lanes_counts (explicit), {gate_name}, {out_name} == plain ({label}, {envs} envs "
              f"x {nk} keywords, m0 {lanes.m0}): simulated cells {simulated.sum().item()} of "
              f"{sim.numel()}, {phantom} with phantom clicks; imps {out[0].sum().item()} clicks "
              f"{out[1].sum().item()} cost ${spent.sum().item():.2f} convs "
              f"{out[3].sum().item()} revenue ${out[4].sum().item() / 100:.2f}", flush=True)
        calls = {"lanes_counts (explicit)": lambda: ld.lanes_counts(params, n_auc01, k_cells, lanes,
                                                                    "exact", model),
                 gate_name: gate_call, out_name: out_call}
        plain = {"lanes_counts (explicit)": counts_ms, gate_name: gate_ms, out_name: out_ms}
        return imp, ncl, gate, sim & (gate[0] >= 0), out, calls, plain, parent_gate

    timed = {}
    for model_name in ("RUST_QUIRK", "PYTHON"):
        cost_model = getattr(CostModel, model_name)
        cfg = EnvConfig(num_keywords=K, max_volume=MAX_VOLUME, cost_model=cost_model,
                        budget=XLA_BUDGET, max_days=AUTORESET_DAYS)
        model, lanes = agg_model(cfg), xla_lanes(cfg)
        occ = ld.occupancy(K, lanes, dev, model)
        print(f"explicit lanes, {model_name.lower()} model: lanes_counts {occ['counts_blocks']} "
              f"blocks per SM; gate {occ['gate_blocks']} blocks per SM, {occ['gate_smem']} B "
              f"shared memory; lanes_outcomes {occ['outcomes_blocks']} blocks per SM")
        env, state0, params, n_auc01, k_cells = inputs(cfg, E, 60)
        rate = dist.threshold_sigmoid(params[ad.BID], params[ad.IMP_THRESH],
                                      params[ad.IMP_INTERCEPT], params[ad.IMP_SLOPE])
        n_t = torch.stack([n_auc01[0]] + [n_auc01[1]] * (T - 1), 1)
        counts = check_counts(cfg, params, n_auc01, k_cells, model_name)
        for label, budget in EXPLICIT_LANES_BUDGETS[model_name]:
            imp, ncl, gate, sim, out, calls, plain, parent_gate = check_day(
                cfg, params, n_auc01, k_cells, counts, budget, f"{model_name} {label}")
            if budget in (0.0, None):  # checked only: the days break at once
                continue
            # the work this run's data needs, as phase 10 counts it: the
            # binomial's words and loop passes over the (impressions and
            # clicks') calls, clicks over max(impressions, 1) candidates;
            # each simulated cell's cost lanes up to the first over the
            # budget or its last click, a normal and a cost each (and a scan
            # step for the float gate); a flag word per accepted click and a
            # revenue word per conversion
            counts_words, counts_fp = counts_work(
                ((n_t, rate[:, None, :].expand(E, T, K), imp),
                 (imp.clamp(min=1), params[ad.BCTR][:, None, :].expand(E, T, K), ncl)), K)
            counts_words += COUNTS_KEY_BLOCKS * E * T
            acc = gate[0].clamp(min=0) * sim
            looked = (torch.minimum(acc + 1, ncl) * sim).sum().item()
            lane_fp = EXPLICIT_LANE_OPS + (SCAN_OPS if model == ad.EXPLICIT_RUST else 0)
            convs = out[3].sum().item()
            keys = sim.any(2).sum().item()
            work = {
                "lanes_counts (explicit)": (4 * (6 * E * K + 2 * E * K) + 16 * E + 8 * E * T * K,
                                            counts_words, counts_fp),
                "gate": (4 * (E * K + 2 * E * T * K + E) + 16 * E + 8 * sim.sum().item() + 8 * E,
                         looked + GATE_KEY_BLOCKS * keys, lane_fp * looked),
                "lanes_outcomes": (12 * sim.sum().item() + 4 * (3 * E * K + 2 * E * K + E)
                                   + 16 * E + 24 * E * K,
                                   acc.sum().item() + convs + OUTCOME_KEY_BLOCKS * keys,
                                   REVENUE_LANE_FP * convs),
            }
            for name, call in calls.items():
                nbytes, words, fp = work[explicit_lanes_kind(name)]
                kbound = max(bound(nbytes, words * ops_per_word, int_ops_per_s),
                             bound(nbytes, fp, fp_ops_per_s))
                ms = cuda_ms(call, reps=10)
                timed[(name, label)] = (ms, plain[name], kbound)
                print(f"  {name} ({model_name} {label}): kernel {ms:.4f} ms, plain "
                      f"{plain[name]:.1f} ms; {words:.0f} threefry words, {fp:.4g} float ops, "
                      f"{nbytes / 1e6:.1f} MB; bound {kbound[0]:.4f} ms ({kbound[1]}), "
                      f"{100 * kbound[0] / ms:.1f}% of it reached ({card})", flush=True)
                if name == "lanes_gate_float" and parent_gate is not None:
                    turns = [cuda_ms(c, reps=10) for c in (parent_gate, call, call, parent_gate)]
                    print(f"  {name} ({model_name} {label}) in turns with the parent's: parent "
                          f"{turns[0]:.4f} / {turns[3]:.4f} ms ({100 * kbound[0] / turns[0]:.1f}% "
                          f"/ {100 * kbound[0] / turns[3]:.1f}% of the bound), this "
                          f"{turns[1]:.4f} / {turns[2]:.4f} ms ({100 * kbound[0] / turns[1]:.1f}% "
                          f"/ {100 * kbound[0] / turns[2]:.1f}%) ({card})", flush=True)
        # EnvConfig's own lane counts (m0 = 65) at both budgets
        dcfg = cfg.replace(**DEFAULT_SHAPE)
        _, _, dparams, dn, dkeys = inputs(dcfg, E, 70)
        dcounts = check_counts(dcfg, dparams, dn, dkeys, f"{model_name}, m0 65")
        for label, budget in EXPLICIT_LANES_BUDGETS[model_name]:
            check_day(dcfg, dparams, dn, dkeys, dcounts, budget, f"{model_name} {label}, m0 65")
        if model == ad.EXPLICIT_RUST:  # past XLA's scan boundary at element 256, untimed
            wcfg = cfg.replace(num_keywords=WIDE_FLOAT_K)
            _, _, wparams, wn, wkeys = inputs(wcfg, WIDE_FLOAT_ENVS, 75)
            wcounts = check_counts(wcfg, wparams, wn, wkeys, f"{model_name}, K {WIDE_FLOAT_K}")
            for label, budget in EXPLICIT_LANES_BUDGETS[model_name]:
                if label in WIDE_FLOAT_BUDGETS:
                    check_day(wcfg, wparams, wn, wkeys, wcounts, budget,
                              f"{model_name} {label}, K {WIDE_FLOAT_K}")

        # the slice: counts zeroed just before, read just after (the
        # episodes end on the third autoreset day)
        n_steps, reset_days = STEPS, AUTORESET_DAYS + 1
        gate_kernel = ld.lanes_gate_float if model == ad.EXPLICIT_RUST else ld.lanes_gate
        kernels = {"lanes_counts (explicit)": ld.lanes_counts, "gate": gate_kernel,
                   "lanes_outcomes": ld.lanes_outcomes}
        bids = torch.full((E, K), BID, device=dev)
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        state, steps, states = state0, [], []
        for _ in range(n_steps):
            state, ts = env.step(state, bids)
            steps.append(ts)
            states.append(state)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        end_roll, roll = env.rollout(state0, bids, n_steps)
        state_r, resets = state0, []
        for _ in range(reset_days):
            state_r, ts = env.autoreset_step(state_r, bids, reset_kw=True)
            resets.append((state_r, ts))
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        days = 2 * n_steps + reset_days
        if any(n != days for n in launches.values()):
            fail(f"explicit lanes slice ({model_name}): launches {launches}, want {days} of each")
        for i, ts in enumerate(steps):
            o = ts.outcomes
            if not ((o.sellside_conversions <= o.buyside_clicks).all()
                    and torch.isfinite(ts.reward).all()
                    and (o.cost.sum(1) <= XLA_BUDGET + 1e-3).all()):
                fail(f"explicit lanes step {i} ({model_name}): invariants violated")
            for f in o._fields:
                if not torch.equal(getattr(o, f), getattr(roll.outcomes, f)[i]):
                    fail(f"explicit lanes rollout day {i} ({model_name}): {f} differs from the "
                         f"step's")
        if not torch.equal(end_roll.key, state.key):
            fail(f"explicit lanes rollout ({model_name}): the final key differs from the steps'")
        ended = resets[AUTORESET_DAYS - 1]
        if not (ended[1].terminated.all() and (ended[0].day == 0).all()):
            fail(f"explicit lanes autoreset ({model_name}): the episodes did not end at max_days")
        with lanes_plain(ld), words_replaced(pk, pk.threefry_words_reference):
            plain_state = state0
            for i in range(PLAIN_STEPS):
                plain_state, ts = env.step(plain_state, bids)
                for f in ts.outcomes._fields:
                    if not torch.equal(getattr(ts.outcomes, f), getattr(steps[i].outcomes, f)):
                        fail(f"explicit lanes step {i} ({model_name}): {f} differs between the "
                             f"kernels and plain")
            if not torch.equal(plain_state.key, states[PLAIN_STEPS - 1].key):
                fail(f"explicit lanes ({model_name}): the key differs between kernels and plain")
            plain_r = state0
            for i, (want_state, want_ts) in enumerate(resets):
                plain_r, ts = env.autoreset_step(plain_r, bids, reset_kw=True)
                for a, b in zip(torch.utils._pytree.tree_leaves((plain_r, ts)),
                                torch.utils._pytree.tree_leaves((want_state, want_ts))):
                    if not torch.equal(a, b):
                        fail(f"explicit lanes autoreset day {i} ({model_name}): differs between "
                             f"the kernels and plain")

        def run_steps():
            st = state0
            for _ in range(n_steps):
                st, _ts = env.step(st, bids)

        events, busy, wall = device_busy(run_steps, n_steps)
        o = [ts.outcomes for ts in steps]
        print(f"explicit lanes slice ({model_name}): {n_steps} steps, rollout({n_steps}) and "
              f"{reset_days} autoreset days (max_days {AUTORESET_DAYS}, fresh keywords) x "
              f"{E} envs x {K} keywords, bids ${BID:.2f}, budget ${XLA_BUDGET:g}: "
              f"{sum(x.impressions.sum().item() for x in o)} impressions, "
              f"{sum(x.buyside_clicks.sum().item() for x in o)} clicks, "
              f"${sum(x.cost.sum().item() for x in o):.2f} spent; launches {launches}; "
              f"{n_steps * E / step_s:.1f} env-steps/s; == plain (the first {PLAIN_STEPS} steps, "
              f"keys, autoreset days); "
              f"per step under the profiler: {events:.1f} CUDA device events, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms, idle {100 * (1 - busy / wall):.1f}% ({card})",
              flush=True)
        gate_name = "lanes_gate_float" if model == ad.EXPLICIT_RUST else "lanes_gate (python)"
        out_name = "lanes_outcomes (float)" if model == ad.EXPLICIT_RUST else None
        names = [gate_name] + ([out_name] if out_name else [])
        if model == ad.EXPLICIT_RUST:
            names.insert(0, "lanes_counts (explicit)")
        for name in names:
            entries[name] = (launches[explicit_lanes_kind(name)], timed[(name, "$1000")])
    replaces = {
        "lanes_counts (explicit)": "adcraft_tpu/auction.py:209 (explicit_auction's impressions) "
                                   "and step.py:934 (the clicks over max(impressions, 1)); no "
                                   "TPU kernel",
        "lanes_gate (python)": "adcraft_tpu/step.py:115 (_gate_keywords in cents; "
                               "distributions.py:340 generic_cost lanes); no TPU kernel",
        "lanes_gate_float": "adcraft_tpu/step.py:152 (_gate_keywords_jacobi in float32; "
                            "distributions.py:325 cost_create lanes); no TPU kernel",
        "lanes_outcomes (float)": "adcraft_tpu/step.py:953-988 and :1400-1502 with float32 spends "
                                  "(the day's cost sum); no TPU kernel",
    }
    return [
        {
            "name": name,
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/lanes_day.cu",
            "replaces": replaces[name],
            "launches": launches_n,
            "max_abs_err": max_err[name],
            "ms": t[0],
            "plain_ms": t[1],
            "bound_ms": t[2][0],
            "bound_by": t[2][1],
            "library_ms": None,
        }
        for name, (launches_n, t) in entries.items()
    ]


# ---- phase 15: the binomial pool on both routes ----

POOL_BUDGETS = (("unbound", 1e9), ("$1000", XLA_BUDGET), ("tight", 2.0))
POOL_CHECK_ENVS, POOL_CHECK_DAYS = 256, 2
POOL_STEPS = 2
POOL_MAX_DAYS = POOL_STEPS + 1  # the slice's autoreset day ends every episode
# float instructions as written, used only for the bounds: a cell's moments
# (two 48-node chains of a fused multiply-add and two products a node, then
# k mu, the variance and sigma), a pool lane (XLA's powf on its float64
# tables, the product and clip, XLA's log, the fused loc + scale l), one
# moment row of the prologue (a node's product, clip and log), a level of a
# ladder (the factor's division and product, two XLA scan steps), and the
# win probability's powf
POOL_MOMENT_OPS = 48 * 3 + 12
POOL_LANE_OPS = 70
POOL_ROW_OPS = 30
LADDER_LEVEL_OPS = 12
POW_OPS = 40
# key blocks agg_cells_gate's pool instance needs per (env, simulated
# sub-timestep): kt, k_auc, k_bidders, k_imp, k_click, k_cost, k_sfull; the
# lanes route's lanes_counts per (env, t) kt, k_auc, k_bidders, k_imp, k_click
POOL_CELL_KEY_BLOCKS, POOL_COUNTS_KEY_BLOCKS = 7, 5


def pool_phase(torch, dev, card, table, ops_per_word, int_ops_per_s, fp_ops_per_s):
    """Phase 15: the binomial pool (competitor_model=BINOMIAL_POOL, 30
    bidders at participation 0.6) on both routes: agg_cells_gate's pool
    instance (bench.py's dense_pool knobs), lanes_counts' pool instance and
    lanes_gate_float's pool mode (the sampling defaults), each against its
    plain version bit for bit at full width and on a 256-env slice of days
    on the default and the signed-cost keywords, timed unbound and at $1000
    beside its bound; then each route's slice through the env. Returns the
    three instances' JSON entries."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import lanes_day as ld
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CompetitorModel
    from adcraft_tpu_torch.step import budget_cents, split_volume, xla_lanes
    from adcraft_tpu_torch.step_rate import pool_keywords

    t_start = time.perf_counter()
    agg_name, counts_name, gate_name = ("agg_cells_gate (pool)", "lanes_counts (pool)",
                                        "lanes_gate_float (pool)")
    print(f"{agg_name}: ptxas {kernel_ptxas(ad.library.build_log, 'agg_cells_gate_kernelILi3E')}")
    print(f"{counts_name}: ptxas "
          f"{kernel_ptxas(ld.library.build_log, 'lanes_counts_kernelILi4ELi2E')}; its bidders' "
          f"kernel {kernel_ptxas(ld.library.build_log, 'lanes_bidders_kernel')}")
    print(f"{gate_name}: ptxas "
          f"{kernel_ptxas(ld.library.build_log, 'lanes_gate_float_kernelILb1E')}")
    max_err = collections.defaultdict(int)

    def compare(name, pairs, label):
        for what, g, w in pairs:
            if g.dtype == torch.float32:  # bit for bit
                g, w = g.view(torch.int32), w.view(torch.int32)
            err = (g.long() - w.long()).abs().max().item() if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                fail(f"{name} vs plain ({label}): {what} differs, max error {err}")

    def day_inputs(cfg, kw, envs, seed):
        k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(seed, dev), envs)).unbind(-2)
        volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                             max=cfg.max_volume)
        n_auc = split_volume(cfg, volume)
        bids = torch.full((envs, K), BID, device=dev)
        return ad.pack_params(kw, bids), torch.stack([n_auc[0], n_auc[1]]).contiguous(), k_cells

    def agg_day_check(cfg, params, n_auc01, k_cells, budget, label, cent_bids=False):
        """agg_cells_gate's pool instance against its plain version on one
        day: its outputs on every simulated cell, n_sim and the day's
        constants; returns the plain cells and gate, the plain time and the
        counts of partial, deep and negative-spend cells."""
        lanes = xla_lanes(cfg)
        envs = params.shape[1]
        budget_c = budget_cents(torch.full((envs,), budget, device=dev), 1000.0)
        got = ad.agg_cells_gate(params, n_auc01, k_cells, budget_c, lanes, True, model=ad.POOL,
                                cent_bids=cent_bids)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            cells, cells_ms = once_ms(lambda: ad.agg_cells_reference(
                params, n_auc01, k_cells, lanes, True, ad.POOL, cent_bids=cent_bids))
            imp, ncl, s_full, lite, kb, consts = cells
            (acc, spend, n_sim), gate_ms = once_ms(lambda: ad.agg_gate_reference(
                params, k_cells, s_full, ncl, lite, budget_c, lanes, ad.POOL, kb))
        plain_ms = cells_ms + gate_ms
        sim = torch.arange(T * K, device=dev).view(1, T, K) < n_sim.view(-1, 1, 1)
        compare(agg_name, [("n_sim", got[3], n_sim)] + [
            (what, g[sim], w[sim]) for what, g, w in zip(("imp", "acc", "spend"), got, (imp, acc,
                                                                                       spend))] +
                [(f"constant {i}", g, w) for i, (g, w) in enumerate(zip(got[4], consts))], label)
        flat = spend.view(envs, T * K).long()
        b_before = budget_c.view(envs, 1).long() - (torch.cumsum(flat, 1) - flat)
        simf = sim.view(envs, T * K)
        partial = simf & (s_full.view(envs, T * K).long() > b_before)
        m_cell = torch.where(torch.arange(T * K, device=dev).view(1, -1) < K, lanes.m0, lanes.m1)
        looked = torch.minimum(torch.minimum(acc.view(envs, -1) + 1, ncl.view(envs, -1)),
                               m_cell) * partial
        counts = {"partial": partial.sum().item(), "deep": (looked > lanes.L).sum().item(),
                  "negative": (sim & (spend < 0)).sum().item(), "simulated": sim.sum().item()}
        return (imp, ncl, kb, acc, spend, sim, partial, looked), plain_ms, counts

    def lanes_day_check(cfg, params, n_auc01, k_cells, counts, budget, label, cent_bids=False):
        """lanes_gate_float's pool mode (and lanes_outcomes' float mode on
        its output) against the plain versions on one day; returns the
        gate's plain outputs, its plain time and the cell counts."""
        lanes = xla_lanes(cfg)
        envs = params.shape[1]
        imp, ncl, kb = counts
        b = torch.full((envs,), budget, device=dev)
        gate = ld.lanes_gate_float(params, k_cells, ncl, imp, b, lanes, kb, cent_bids)
        torch.cuda.synchronize()
        with words_replaced(pk, pk.threefry_words_reference):
            want, plain_ms = once_ms(lambda: ld.lanes_gate_float_reference(
                params, k_cells, ncl, imp, b, lanes, kb, cent_bids))
        n_sim = want[2]
        cell = torch.arange(T * K, device=dev).view(1, T, K)
        walked = cell < ((n_sim + K - 1) // K * K).view(-1, 1, 1)
        compare(gate_name, [("n_sim", gate[2], n_sim)] + [
            (what, g[walked], w[walked]) for what, g, w in zip(("acc", "spend"), gate, want)],
                label)
        out = ld.lanes_outcomes(params, k_cells, imp, gate[0], gate[1], n_sim, n_auc01, lanes)
        with words_replaced(pk, pk.threefry_words_reference):
            want_out = ld.lanes_outcomes_reference(params, k_cells, imp, *want[:3], n_auc01, lanes)
        compare("lanes_outcomes (float)", [(f"day sum {i}", g, w)
                                           for i, (g, w) in enumerate(zip(out, want_out))], label)
        acc, spend = want[0], want[1]
        sim = (cell < n_sim.view(-1, 1, 1)) & (acc >= 0)
        partial = sim & (acc > 0) & (acc < ncl)
        stats = {"partial": partial.sum().item(), "deep": 0,
                 "negative": (sim & (spend < 0)).sum().item(), "simulated": sim.sum().item()}
        return (acc, spend, sim), plain_ms, stats

    entries, timed = {}, {}
    for route in ("agg", "lanes"):
        knobs = BENCH_XLA_KNOBS if route == "agg" else {}
        cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT,
                        competitor_model=CompetitorModel.BINOMIAL_POOL, max_volume=MAX_VOLUME,
                        budget=XLA_BUDGET, max_days=POOL_MAX_DAYS, **knobs)
        lanes = xla_lanes(cfg)
        env = VectorBiddingEnv(cfg, E, table, device=dev)
        state0, _ = env.reset(prng.PRNGKey(80))
        state0 = state0._replace(kw=pool_keywords(state0.kw))
        if route == "agg":
            chunk_t = ad.agg_cells_gate.default_chunk_t(K, lanes, dev, ad.POOL)
            print(f"{agg_name}: chunk_t {chunk_t}, "
                  f"{ad.agg_cells_gate.smem_bytes(chunk_t, K, lanes, ad.POOL)} B shared memory, "
                  f"{ad.agg_cells_gate.occupancy(chunk_t, K, lanes, dev, ad.POOL)} blocks per SM")
        else:
            occ = ld.occupancy(K, lanes, dev, ad.POOL)
            print(f"{counts_name}: {occ['counts_blocks']} blocks per SM, its bidders' kernel "
                  f"{occ['bidders_blocks']}; {gate_name}: "
                  f"{occ['gate_blocks']} blocks per SM, {occ['gate_smem']} B shared memory")

        # the slice of days: 256 envs, default and signed-cost keywords,
        # kernels against plain bit for bit at each budget; on day 1 F(bid)
        # as the env computes it from its rounded bids (cent_bids)
        totals = collections.defaultdict(int)
        for signed in (False, True):
            kw = pool_keywords(state0.kw, signed)
            kw = kw._replace(**{f: getattr(kw, f)[:POOL_CHECK_ENVS] for f in kw._fields})
            for day in range(POOL_CHECK_DAYS):
                params, n_auc01, k_cells = day_inputs(cfg, kw, POOL_CHECK_ENVS, 90 + day)
                keyset = "signed" if signed else "default"
                cent = day == 1
                if route == "lanes":
                    # the counts' plain version is the slowest (its lockstep
                    # loops, a launch per operation): held to it on one day
                    # of each keyword set, the gates on the kernel's counts
                    want = ld.lanes_counts(params, n_auc01, k_cells, lanes, "exact", ad.POOL, cent)
                    if day == int(signed):  # default keywords on day 0, signed on day 1
                        with words_replaced(pk, pk.threefry_words_reference):
                            plain = ld.lanes_counts_reference(params, n_auc01, k_cells, lanes,
                                                              "exact", ad.POOL, cent)
                        compare(counts_name, zip(("imp", "ncl", "bidders"), want, plain),
                                f"{keyset} day {day}")
                for label, budget in POOL_BUDGETS[1:]:
                    tag = f"{keyset} day {day} {label}"
                    if route == "agg":
                        _, _, c = agg_day_check(cfg, params, n_auc01, k_cells, budget, tag, cent)
                    else:
                        _, _, c = lanes_day_check(cfg, params, n_auc01, k_cells, want, budget, tag,
                                                  cent)
                    for key, v in c.items():
                        totals[(keyset, key)] += v
        print(f"pool ({route}) == plain on {POOL_CHECK_ENVS} envs x {K} keywords x "
              f"{POOL_CHECK_DAYS} days at $1000 and ${POOL_BUDGETS[2][1]:g} "
              f"({time.perf_counter() - t_start:.1f} s into the phase): "
              + "; ".join(f"{keyset}: {totals[(keyset, 'simulated')]} simulated cells, "
                          f"{totals[(keyset, 'partial')]} partial, {totals[(keyset, 'deep')]} "
                          f"deep resolutions, {totals[(keyset, 'negative')]} with negative spend"
                          for keyset in ("default", "signed")), flush=True)
        if totals[("signed", "negative")] == 0:
            fail(f"pool ({route}): the signed-cost slice spent nothing negative")
        if totals[("default", "partial")] + totals[("signed", "partial")] == 0:
            fail(f"pool ({route}): no partial cell at the tight budget")

        # full width (4096 envs), default keywords: kernels against plain
        # and timed, unbound and at $1000, beside the bound this run's
        # cells need
        params, n_auc01, k_cells = day_inputs(cfg, state0.kw, E, 95)
        n_t = torch.stack([n_auc01[0]] + [n_auc01[1]] * (T - 1), 1)
        if route == "lanes":
            counts = ld.lanes_counts(params, n_auc01, k_cells, lanes, "exact", ad.POOL)
            torch.cuda.synchronize()
            with words_replaced(pk, pk.threefry_words_reference):
                want, counts_plain = once_ms(lambda: ld.lanes_counts_reference(
                    params, n_auc01, k_cells, lanes, "exact", ad.POOL))
            compare(counts_name, zip(("imp", "ncl", "bidders"), counts, want), "full width")
            imp, ncl, kb = want
            f_bid = dist.laplace_cdf(params[ad.BID], params[ad.LOC], params[ad.SCALE])
            p_win = torch.where(kb > 0, f_bid[:, None].pow(kb.clamp(min=1).float()), 1.0)
            words, fp = counts_work(
                ((params[ad.MAX_BIDDERS][:, None].expand(E, T, K),
                  params[ad.PARTICIPATION][:, None].expand(E, T, K), kb),
                 (n_t, p_win, imp),
                 (imp, params[ad.BCTR][:, None].expand(E, T, K), ncl)), K)
            words += POOL_COUNTS_KEY_BLOCKS * E * T
            fp += POW_OPS * E * T * K
            nbytes = 4 * (7 * E * K + 2 * E * K) + 16 * E + 12 * E * T * K
            kbound = max(bound(nbytes, words * ops_per_word, int_ops_per_s),
                         bound(nbytes, fp, fp_ops_per_s))
            ms = cuda_ms(lambda: ld.lanes_counts(params, n_auc01, k_cells, lanes, "exact",
                                                 ad.POOL), reps=10)
            for label, _ in POOL_BUDGETS[:2]:
                timed[(counts_name, label)] = (ms, counts_plain, kbound)
            print(f"  {counts_name}: kernel {ms:.4f} ms, plain {counts_plain:.1f} ms; "
                  f"{words:.0f} threefry words, {fp:.4g} float ops, {nbytes / 1e6:.1f} MB; bound "
                  f"{kbound[0]:.4f} ms ({kbound[1]}), {100 * kbound[0] / ms:.1f}% of it reached "
                  f"({card})", flush=True)
        for label, budget in POOL_BUDGETS[:2]:
            if route == "agg":
                (imp, ncl, kb, acc, spend, sim, partial, looked), plain_ms, c = agg_day_check(
                    cfg, params, n_auc01, k_cells, budget, f"full width {label}")
                budget_c = budget_cents(torch.full((E,), budget, device=dev), 1000.0)
                call = lambda b=budget_c: ad.agg_cells_gate(  # noqa: E731
                    params, n_auc01, k_cells, b, lanes, model=ad.POOL)
                name = agg_name
                # per simulated cell: the bidder and impression words where
                # it has auctions, a click word where it has impressions,
                # the spend normal where it has clicks and bidders, L lite
                # lanes where it has clicks; the keys; the partial cells'
                # lanes past the lite ones. Float: the walks' levels, a
                # ladder bisection and a powf where there are auctions, the
                # moments where there are clicks and bidders, each lane's
                # law; the prologue's moment rows and bidder ladder
                has_n = (n_t > 0) & sim
                clicks = (ncl > 0) & sim
                deep = (looked - lanes.L).clamp(min=0).sum().item()
                words = (2 * has_n.sum() + ((imp > 0) & sim).sum() + (clicks & (kb > 0)).sum()
                         + lanes.L * clicks.sum()).item() + deep
                words += POOL_CELL_KEY_BLOCKS * sim.any(2).sum().item()
                words += PARTIAL_KEY_BLOCKS * partial.view(E, T, K).any(2).sum().item()
                fp = (WALK_OPS * (walk_levels(imp * sim, n_t * sim) + walk_levels(ncl * sim,
                                                                                imp * sim))
                      + (POW_OPS + 5) * has_n.sum() + POOL_MOMENT_OPS * (clicks & (kb > 0)).sum()
                      + NORMAL_OPS * clicks.sum() + POOL_LANE_OPS * lanes.L * clicks.sum()).item()
                fp += POOL_LANE_OPS * deep + E * K * (48 * POOL_ROW_OPS
                                                     + lanes.kmax * LADDER_LEVEL_OPS)
                nbytes = 4 * (7 * E * K + 2 * E * K + E) + 16 * E + 12 * sim.sum().item() + 4 * E
            else:
                (acc, spend, sim), plain_ms, c = lanes_day_check(
                    cfg, params, n_auc01, k_cells, want, budget, f"full width {label}")
                b = torch.full((E,), budget, device=dev)
                call = lambda b=b: ld.lanes_gate_float(  # noqa: E731
                    params, k_cells, ncl, imp, b, lanes, kb)
                name = gate_name
                # each simulated cell's lanes up to the first prefix over
                # its budget or its last click: a 32-bit word, the pool law
                # and a scan step each; the keys of each walked (env, t)
                looked = (torch.minimum(acc.clamp(min=0) + 1, ncl) * sim).sum().item()
                words = looked + GATE_KEY_BLOCKS * sim.any(2).sum().item()
                fp = (POOL_LANE_OPS + SCAN_OPS) * looked
                nbytes = (4 * (3 * E * K + 2 * E * T * K + E) + 16 * E + 8 * sim.sum().item()
                          + 4 * E)
            kbound = max(bound(nbytes, words * ops_per_word, int_ops_per_s),
                         bound(nbytes, fp, fp_ops_per_s))
            ms = cuda_ms(call, reps=10)
            timed[(name, label)] = (ms, plain_ms, kbound)
            print(f"  {name} ({label}): {c['simulated']} simulated cells, {c['partial']} partial, "
                  f"{c['negative']} with negative spend; kernel {ms:.4f} ms, plain {plain_ms:.1f} "
                  f"ms; {words:.0f} threefry words, {fp:.4g} float ops, {nbytes / 1e6:.1f} MB; "
                  f"bound {kbound[0]:.4f} ms ({kbound[1]}), {100 * kbound[0] / ms:.1f}% of it "
                  f"reached ({card})", flush=True)

        # the slice through the env: counts zeroed just before, read just after
        kernels = ({agg_name: ad.agg_cells_gate, "agg_outcomes": ad.agg_outcomes}
                   if route == "agg" else
                   {counts_name: ld.lanes_counts, gate_name: ld.lanes_gate_float,
                    "lanes_outcomes (float)": ld.lanes_outcomes})
        bids = torch.full((E, K), BID, device=dev)
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        state, steps = state0, []
        for _ in range(POOL_STEPS):
            state, ts = env.step(state, bids)
            steps.append(ts)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        end_roll, roll = env.rollout(state0, bids, POOL_STEPS)
        reset_state, reset_ts = env.autoreset_step(state, bids)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        days = 2 * POOL_STEPS + 1
        if any(n != days for n in launches.values()):
            fail(f"pool ({route}) slice: launches {launches}, want {days} of each")
        if not (torch.equal(end_roll.key, state.key) and bool(reset_ts.terminated.all())
                and bool((reset_state.day == 0).all())):
            fail(f"pool ({route}) slice: rollout or autoreset state wrong")
        infinite = []
        for i, ts in enumerate(steps):
            o = ts.outcomes
            # a 32-bit cost uniform of exactly 0 (one lane in 2**23) costs
            # -inf where k >= 3, as in the JAX package (ROADMAP.md section
            # 3): such an env's day costs -inf and its reward is +inf;
            # every other env's reward is finite
            minus_inf = (o.cost == float("-inf")).any(1)
            infinite.append(minus_inf.sum().item())
            if not ((o.sellside_conversions <= o.buyside_clicks).all()
                    and torch.isfinite(ts.reward[~minus_inf]).all()
                    and (ts.reward[minus_inf] == float("inf")).all()
                    and (o.cost.sum(1) <= XLA_BUDGET + 1e-3).all()):
                fail(f"pool ({route}) slice step {i}: invariants violated")
            for f in o._fields:
                if not torch.equal(getattr(o, f), getattr(roll.outcomes, f)[i]):
                    fail(f"pool ({route}) rollout day {i}: {f} differs from step {i}")
        if route == "agg":  # (the lanes day's plain counts take 12 s at this width)
            with agg_plain(ad), words_replaced(pk, pk.threefry_words_reference):
                _, plain_ts = env.step(state0, bids)
            for f in plain_ts.outcomes._fields:
                if not torch.equal(getattr(plain_ts.outcomes, f), getattr(steps[0].outcomes, f)):
                    fail(f"pool ({route}) slice step 0: {f} differs between the kernels and plain")

        def run_steps():
            st = state0
            for _ in range(POOL_STEPS):
                st, _ts = env.step(st, bids)

        events, busy, wall = device_busy(run_steps, POOL_STEPS)
        o = [ts.outcomes for ts in steps]
        print(f"pool ({route}) slice: {POOL_STEPS} steps, rollout({POOL_STEPS}) and an autoreset "
              f"day x {E} envs x {K} keywords, bids ${BID:.2f}, budget ${XLA_BUDGET:g}: "
              f"{sum(x.impressions.sum().item() for x in o)} impressions, "
              f"{sum(x.buyside_clicks.sum().item() for x in o)} clicks, "
              f"${sum(x.cost.sum().item() for x in o):.2f} spent; envs with a -inf click cost "
              f"per step {infinite}; launches {launches}; "
              f"{POOL_STEPS * E / step_s:.1f} env-steps/s; "
              f"{'step 0 == plain ' if route == 'agg' else ''}"
              f"({time.perf_counter() - t_start:.1f} s into the phase); per step under the "
              f"profiler: {events:.1f} CUDA device events, device busy {busy:.3f} ms of "
              f"{wall:.3f} ms, idle {100 * (1 - busy / wall):.1f}% ({card})", flush=True)
        for name in ((agg_name,) if route == "agg" else (counts_name, gate_name)):
            entries[name] = (launches[name], timed[(name, "$1000")], timed[(name, "unbound")])
    replaces = {
        agg_name: "adcraft_tpu/step.py:806-860 (_cell_tables' pool branch), :740 "
                  "(_gate_keywords_scan_agg) and :1087 (_resolve_cell's pool lanes); no TPU "
                  "kernel",
        counts_name: "adcraft_tpu/auction.py:164 (implicit_pool_auction's bidders and "
                     "impressions) and step.py:934 (the clicks); no TPU kernel",
        gate_name: "adcraft_tpu/step.py:152 (_gate_keywords_jacobi in float32; auction.py:187-197 "
                   "the pool's cost lanes); no TPU kernel",
    }
    for name, (n, t, unbound) in entries.items():
        print(f"{name}: $1000 {t[0]:.4f} ms, unbound {unbound[0]:.4f} ms; {n} launches in the "
              f"slice ({card})")
    print(f"phase 15 wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    return [
        {
            "name": name,
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/" + ("agg_day.cu" if name == agg_name
                                                   else "lanes_day.cu"),
            "replaces": replaces[name],
            "launches": n,
            "max_abs_err": max_err[name],
            "ms": t[0],
            "plain_ms": t[1],
            "bound_ms": t[2][0],
            "bound_by": t[2][1],
            "library_ms": None,
        }
        for name, (n, t, _unbound) in entries.items()
    ]


def parent_builds(parent_csrc, cuda_build):
    """The parent tree's agg_day and prng_kernels libraries (their
    launchers only), to time this tree's kernels in turns with them."""
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import prng_kernel as pk

    words = cuda_build.CudaLibrary("prng_kernels", pk.bind_launchers, csrc=parent_csrc)
    return dict(ad.kernels_built_from(parent_csrc), threefry_words=pk.ThreefryWords(words))


def parent_turns_phase(torch, dev, card, table, parent):
    """With --parent-csrc: the agg route's kernels (agg_cells_gate's three
    instances, agg_outcomes) and threefry_words at full width, each timed
    in turns with the parent tree's build on the same inputs (parent,
    this, this, parent), with the count of outputs where the two trees
    differ (F4's single rounding and F5's XLA math change draws)."""
    from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv
    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import distributions as dist
    from adcraft_tpu_torch import prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel
    from adcraft_tpu_torch.step import agg_model, budget_cents, split_volume, xla_lanes

    def turns(name, this, other, label):
        ms = [cuda_ms(c, reps=20) for c in (other, this, this, other)]
        print(f"  {name} ({label}) in turns with the parent's: parent {ms[0]:.4f} / {ms[3]:.4f} "
              f"ms, this {ms[1]:.4f} / {ms[2]:.4f} ms ({card})", flush=True)

    bids = torch.full((E, K), BID, device=dev)
    cell = torch.arange(T * K, device=dev).view(1, T, K)
    for kind, model_name in ((KeywordKind.IMPLICIT, None), (KeywordKind.EXPLICIT, "RUST_QUIRK"),
                             (KeywordKind.EXPLICIT, "PYTHON")):
        extra = {} if model_name is None else {"cost_model": getattr(CostModel, model_name)}
        cfg = EnvConfig(num_keywords=K, kind=kind, max_volume=MAX_VOLUME, budget=XLA_BUDGET,
                        **BENCH_XLA_KNOBS, **extra)
        model, lanes = agg_model(cfg), xla_lanes(cfg)
        state, _ = VectorBiddingEnv(cfg, E, table, device=dev).reset(prng.PRNGKey(80))
        k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(81, dev), E)).unbind(-2)
        volume = torch.clamp(dist.nonneg_int_normal(k_vol, state.kw.vol_mean, state.kw.vol_std),
                             max=MAX_VOLUME)
        n_auc = split_volume(cfg, volume)
        n_auc01 = torch.stack([n_auc[0], n_auc[1]]).contiguous()
        params = ad.pack_params(state.kw, bids)
        budget_c = budget_cents(torch.full((E,), XLA_BUDGET, device=dev), ad.AGG_SCALE[model])
        name = "agg_cells_gate" + ("" if model_name is None else f" (explicit, "
                                                                f"{model_name.lower()})")

        def gate(kernel):
            return lambda: kernel(params, n_auc01, k_cells, budget_c, lanes, model=model)

        got, other = gate(ad.agg_cells_gate)(), gate(parent["agg_cells_gate"])()
        sim = cell < got[3].view(E, 1, 1)
        differ = {"n_sim": (got[3] != other[3]).sum().item()}
        differ.update({what: ((g != w) & sim).sum().item()
                       for what, g, w in zip(("imp", "acc", "spend"), got, other)})
        print(f"  {name} ($1000): the parent's outputs differ from this tree's in "
              f"{differ['n_sim']} n_sim of {E} and in {differ['imp']} imp, {differ['acc']} acc "
              f"and {differ['spend']} spend of {sim.sum().item()} simulated cells")
        if any(differ.values()):
            fail(f"{name}: outputs differ from the parent's build {differ}")
        turns(name, gate(ad.agg_cells_gate), gate(parent["agg_cells_gate"]), "$1000")
        if model_name is None:
            def outcomes(kernel, mode):
                return lambda: kernel(params, k_cells, *got[:4], n_auc01, lanes, mode)

            for mode in ("sum", "day"):
                a = outcomes(ad.agg_outcomes, mode)()
                b = outcomes(parent["agg_outcomes"], mode)()
                print(f"  agg_outcomes ($1000, {mode}): the parent's day sums differ from this "
                      f"tree's in {sum((x != y).sum().item() for x, y in zip(a, b))} of "
                      f"{6 * E * K}")
                turns("agg_outcomes", outcomes(ad.agg_outcomes, mode),
                      outcomes(parent["agg_outcomes"], mode), f"$1000, {mode}")
    keys = prng.split(prng.PRNGKey(82, dev), E)
    for mode in ("normal", "xor"):
        def words(kernel):
            return lambda: kernel(keys, K, mode)

        differ = (words(pk.threefry_words)() != words(parent["threefry_words"])()).sum().item()
        print(f"  threefry_words ({mode}, {E} keys x {K}): the parent's words differ from this "
              f"tree's in {differ} of {E * K}")
        turns("threefry_words", words(pk.threefry_words), words(parent["threefry_words"]),
              f"{mode}, {E} x {K}")


# 13. the paper's experiment: run_sparsity_experiments' seeds, 4 x 4 episodes
EXP_ENV_SEEDS = (5, 6, 7, 8)
EXP_AGENT_SEEDS = (0, 1, 2, 3)
EXP_AGENTS = ("zero_margin", "interpolation")
EXP_PLAIN_DAYS = 2  # harness days held to the plain versions
# the sweep's two corners: (mean volume, cvr); at (1024, 1.0) max_volume
# 4160 gives m0 = 196 cost lanes, past lanes_gate's 32-lane windows
SWEEP_CORNERS = ((1024.0, 1.0), (1.0, 0.01))
CORNER_DAYS = 2
GYM_DAYS = 5
GYM_SEED = 7


def state_leaves(torch, out):
    """The harness run's final env state, agent state and agent keys, then
    its profits and ideal profits, as a list of tensors."""
    leaves = torch.utils._pytree.tree_leaves((out["env_state"], out["agent_state"],
                                             out["agent_keys"]))
    return leaves + [torch.from_numpy(out["kw_profits"]), torch.from_numpy(out["ideal_profits"])]


def harness_turn(torch, ld, pk, harness, names, label, cfg, table, agent, days, dev):
    """``days`` of the harness through the kernels (counts zeroed just
    before, read just after), then through the plain versions of the lanes
    kernels and of threefry_words; fails unless every profit, ideal
    profit, state and key is equal. Returns (kernel run, launches, kernel
    s, plain s)."""
    kernels = {n: getattr(ld, n) for n in names}
    torch.cuda.synchronize()
    for kernel in kernels.values():
        kernel.launches = 0
    pk.threefry_words.launches = 0
    t0 = time.perf_counter()
    got = harness.run_episode_batch(cfg, table, EXP_ENV_SEEDS, EXP_AGENT_SEEDS, num_days=days,
                                    agent=agent, device=dev, return_state=True)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    launches["threefry_words"] = pk.threefry_words.launches
    if any(launches[n] != days for n in names) or launches["threefry_words"] == 0:
        fail(f"{label}: launches {launches} in {days} days, want {days} of each lanes kernel")
    # threefry_words per day: the launches of a one-day run (the keywords'
    # and the state's set-up and a day) taken from this run's
    pk.threefry_words.launches = 0
    harness.run_episode_batch(cfg, table, EXP_ENV_SEEDS, EXP_AGENT_SEEDS, num_days=1,
                              agent=agent, device=dev)
    launches["threefry_words per day"] = (launches["threefry_words"]
                                          - pk.threefry_words.launches) / (days - 1)
    t0 = time.perf_counter()
    with lanes_plain(ld), words_replaced(pk, pk.threefry_words_reference):
        want = harness.run_episode_batch(cfg, table, EXP_ENV_SEEDS, EXP_AGENT_SEEDS,
                                         num_days=days, agent=agent, device=dev,
                                         return_state=True)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(state_leaves(torch, got), state_leaves(torch, want))):
        if not torch.equal(a.cpu(), b.cpu()):
            fail(f"{label}: output {i} (state, keys, profits) differs between kernels and plain")
    return got, launches, kernel_s, plain_s


def gym_days(torch, env, prng, cfg, kw, dev, rng):
    """``GYM_DAYS`` days of one env as BiddingSimulation runs them: its
    reset's key drawn from its generator, then float64 actions, each day
    through ``env.env_step``; returns the outcomes and the final state."""
    import numpy as np

    key = prng.PRNGKey(int(rng.integers(0, 2**31 - 1)), device=dev)
    state, _ = env.env_reset(cfg, key, kw=kw)
    days = []
    for _ in range(GYM_DAYS):
        bids = rng.uniform(0.05, 2.5, cfg.num_keywords)
        budget = float(np.round(rng.uniform(50.0, 1000.0), 2))
        state, ts = env.env_step(cfg, state, bids, budget)
        days.append(ts)
    return torch.utils._pytree.tree_leaves((days, state))


def experiment_phase(torch, dev, card):
    """Phase 13: the sparsity experiment (harness, metrics, both baseline
    agents), the gym's two configurations and the timing experiment."""
    import numpy as np

    from adcraft_tpu_torch import env, keywords, metrics, prng
    from adcraft_tpu_torch import lanes_day as ld
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.config import CompetitorModel, EnvConfig, KeywordKind
    from adcraft_tpu_torch.experiments import harness, timing
    from adcraft_tpu_torch.experiments.configs import ENV_CONFIGS, experiment_table
    from adcraft_tpu_torch.quantiles import simple_experiment_table

    implicit_names = ("lanes_counts", "lanes_gate", "lanes_outcomes")
    B = len(EXP_ENV_SEEDS) * len(EXP_AGENT_SEEDS)

    def sweep_config(vol, days):
        # run_sparsity_experiments' EnvConfig for a cell
        return EnvConfig(num_keywords=100, max_days=days, kind=KeywordKind.IMPLICIT,
                         max_volume=int(max(32, 4 * vol + 64)))

    # the dense config at full width: kernels vs plain, then 60 days
    dense = ENV_CONFIGS["dense"]
    cfg = sweep_config(dense["keyword_config"]["mean_volume"], dense["max_days"])
    table = experiment_table(dense)
    for agent in EXP_AGENTS:
        label = f"harness (dense, {agent})"
        got, launches, kernel_s, plain_s = harness_turn(
            torch, ld, pk, harness, implicit_names, label, cfg, table, agent, EXP_PLAIN_DAYS, dev)
        print(f"{label}: {B} episodes x {cfg.num_keywords} keywords, m0 "
              f"{cfg.max_clicks_per_cell}, {EXP_PLAIN_DAYS} days == plain (profits, ideal "
              f"profits, env and agent states, keys); launches {launches}; kernels "
              f"{EXP_PLAIN_DAYS / kernel_s:.2f} harness days/s ({kernel_s:.3f} s), plain "
              f"{EXP_PLAIN_DAYS / plain_s:.3f} harness days/s ({plain_s:.3f} s) ({card})")
        if not (got["kw_profits"] != 0).any():
            fail(f"{label}: no profit or loss in {EXP_PLAIN_DAYS} days")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = harness.run_episode_batch(cfg, table, EXP_ENV_SEEDS, EXP_AGENT_SEEDS, agent=agent,
                                        device=dev)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        profits = torch.from_numpy(out["kw_profits"])
        ideal = torch.from_numpy(out["ideal_profits"])
        if profits.shape != (B, cfg.max_days, cfg.num_keywords) or not (
                torch.isfinite(profits).all() and torch.isfinite(ideal).all()):
            fail(f"{label}: {cfg.max_days}-day profits not finite or of the wrong shape")
        if not (profits[:, :EXP_PLAIN_DAYS] == torch.from_numpy(got["kw_profits"])).all():
            fail(f"{label}: the {cfg.max_days}-day run's first days differ from the short run's")
        akncp = metrics.compute_AKNCP(profits, ideal)
        ncp = metrics.compute_NCP(profits, ideal)
        print(f"{label}: {cfg.max_days} days through the kernels in {full_s:.3f} s "
              f"({cfg.max_days / full_s:.2f} harness days/s, {B / full_s:.3f} episodes/s); "
              f"AKNCP {akncp.mean().item():.4f} (episodes {akncp.min().item():.4f} to "
              f"{akncp.max().item():.4f}), NCP {ncp.mean().item():.4f} (episodes "
              f"{ncp.min().item():.4f} to {ncp.max().item():.4f}); ideal profit "
              f"${ideal.sum().item() / B:.2f} per episode ({card})")

    # the sweep's corners, the interpolation agent (its first days bid
    # across the grid, so that the budget binds)
    for vol, cvr in SWEEP_CORNERS:
        ccfg = sweep_config(vol, CORNER_DAYS)
        label = f"harness corner (vol {vol:g}, cvr {cvr:g})"
        got, launches, kernel_s, plain_s = harness_turn(
            torch, ld, pk, harness, implicit_names, label, ccfg, simple_experiment_table(vol, cvr),
            "interpolation", CORNER_DAYS, dev)
        profits = got["kw_profits"]
        print(f"{label}: max_volume {ccfg.max_volume}, m0 {ccfg.max_clicks_per_cell}, "
              f"{CORNER_DAYS} days == plain; launches {launches}; profit "
              f"${profits.sum() / B:.2f} per episode; kernels {kernel_s:.3f} s, plain "
              f"{plain_s:.3f} s ({card})")

    # the gym's two configurations (BiddingSimulation's EnvConfig) at one
    # env, each day through env.env_step
    gym = {
        "explicit (rust)": (EnvConfig(num_keywords=10, kind=KeywordKind.EXPLICIT,
                                      competitor_model=CompetitorModel.SINGLE_ABS_CENTS,
                                      max_volume=128),
                            ("lanes_counts", "lanes_gate_float", "lanes_outcomes")),
        "implicit (128, 0.8)": (EnvConfig(num_keywords=10, kind=KeywordKind.IMPLICIT,
                                          competitor_model=CompetitorModel.SINGLE_ABS_CENTS,
                                          max_volume=576),
                                implicit_names),
    }
    for label, (gcfg, names) in gym.items():
        def keywords_of(rng):
            if gcfg.kind is KeywordKind.EXPLICIT:
                return keywords.sample_explicit_keywords_numpy(rng, 10, device=dev)
            return keywords.sample_implicit_keywords_numpy(
                rng, 10, simple_experiment_table(128, 0.8), device=dev)

        kernels = {n: getattr(ld, n) for n in names}
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        rng = np.random.default_rng(GYM_SEED)
        got = gym_days(torch, env, prng, gcfg, keywords_of(rng), dev, rng)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        if any(n != GYM_DAYS for n in launches.values()):
            fail(f"gym {label}: launches {launches} in {GYM_DAYS} days")
        with lanes_plain(ld), words_replaced(pk, pk.threefry_words_reference):
            rng = np.random.default_rng(GYM_SEED)
            want = gym_days(torch, env, prng, gcfg, keywords_of(rng), dev, rng)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                fail(f"gym {label}: output {i} differs between kernels and plain")
        print(f"gym {label}: 1 env x 10 keywords, max_volume {gcfg.max_volume}, {GYM_DAYS} days "
              f"through env.env_step == plain; launches {launches}")

    # the timing experiment's three reference configs
    for vol, cvr, ns in timing.REFERENCE_CONFIGS:
        r = timing.time_episode(vol, cvr, non_stationary=ns, device=dev)
        print(f"timing (vol {vol}, cvr {cvr}, {'non-stationary' if ns else 'stationary'}): "
              f"{r['episodes']} episodes x 100 keywords x 60 days in {r['total_s']:.3f} s: "
              f"{r['s_per_episode']:.5f} s/episode, {r['episodes_per_s']:.2f} episodes/s "
              f"({card})")


# 14. the RL trainers at train_rl.py's defaults: the dense config (100
# keywords, max_volume 576), 128 envs, the fast knobs (the agg day route),
# 16 rollout days, 4 epochs x 4 minibatches, [32, 32]
TRAIN_TIMED_STEPS = 5
A2C_STEPS = 10
TD3_STEPS = 10  # past the warm-up
EVAL_ENVS = 16
# JAX's test_ppo_actually_learns (tests/test_ppo.py:59) and its assertions
LEARN_STEPS, LEARN_EARLY, LEARN_MARGIN = 150, 20, 0.25


def tree_leaves(torch, tree):
    return torch.utils._pytree.tree_leaves(tree)


def assert_trees_equal(torch, got, want, label):
    """Fails unless the two trees' tensors and numbers are equal bit for bit."""
    a, b = tree_leaves(torch, got), tree_leaves(torch, want)
    if len(a) != len(b):
        fail(f"{label}: {len(a)} leaves against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        same = (x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
                if isinstance(x, torch.Tensor) else x == y)
        if not same:
            fail(f"{label}: leaf {i} differs between the kernels and the plain versions")


def counted(torch, kernels, run):
    """``run()`` with every wrapper's count zeroed just before and read just
    after: (its result, launches by name)."""
    torch.cuda.synchronize()
    for kernel in kernels.values():
        kernel.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: kernel.launches for name, kernel in kernels.items()}


def ppo_parts(trainer, state):
    """One PPO train step in its parts: the rollout, its advantages and the
    update."""
    env_state, last_obs, key, traj = trainer.rollout(state)
    advs = trainer._gae(traj, trainer.value_apply(state.params["value"], last_obs))
    new_state, metrics = trainer.update(state, env_state, last_obs, key, traj)
    return traj, advs, new_state, metrics


def training_phase(torch, dev, card):
    """Phase 14: PPO at train_rl's defaults through the kernels against the
    plain versions and timed; the lanes route; A2C; TD3 past its warm-up
    (one step against the plain versions); evaluate; JAX's learning proof;
    checkpoint and restore through train_rl's CLI; multi_train; entry()."""
    import tempfile

    import numpy as np

    from adcraft_tpu_torch import agg_day as ad
    from adcraft_tpu_torch import multi_agent, prng
    from adcraft_tpu_torch import prng_kernel as pk
    from adcraft_tpu_torch.agents.a2c import A2CConfig, A2CTrainer
    from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from adcraft_tpu_torch.agents.td3 import TD3Config, TD3Trainer
    from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
    from adcraft_tpu_torch.entry import entry
    from adcraft_tpu_torch.experiments import train_rl
    from adcraft_tpu_torch.quantiles import simple_experiment_table

    kernels = {"agg_cells_gate": ad.agg_cells_gate, "agg_outcomes": ad.agg_outcomes,
               "threefry_words": pk.threefry_words}
    trainer = train_rl.build(train_rl.parser().parse_args([]))
    cfg, E, pcfg = trainer.env_cfg, trainer.num_envs, trainer.cfg
    env_steps = pcfg.rollout_days * E
    print(f"PPO at train_rl's defaults: {E} envs x {cfg.num_keywords} keywords, max_volume "
          f"{cfg.max_volume} (m0 {cfg.max_clicks_per_cell}), {pcfg.rollout_days} rollout days, "
          f"{pcfg.num_epochs} epochs x {pcfg.num_minibatches} minibatches, hidden "
          f"{list(pcfg.hidden)}; TF32 matmuls "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}")
    state = trainer.init(prng.PRNGKey(0))

    # one train step through the kernels and through the plain versions
    t0 = time.perf_counter()
    got, launches = counted(torch, kernels, lambda: ppo_parts(trainer, state))
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with agg_plain(ad), words_replaced(pk, pk.threefry_words_reference):
        want = ppo_parts(trainer, state)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert_trees_equal(torch, got, want, "PPO train step")
    if launches["agg_cells_gate"] != pcfg.rollout_days or launches["agg_outcomes"] != \
            pcfg.rollout_days or launches["threefry_words"] == 0:
        fail(f"PPO train step: launches {launches}, want {pcfg.rollout_days} of each agg kernel")
    traj, _, new_state, metrics = got
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(torch, (traj, metrics))):
        fail("PPO train step: non-finite transitions or metrics")
    print(f"PPO train step == plain (transitions, advantages, parameters, Adam state, env "
          f"state, key, metrics); launches per train step {launches}; kernels {kernel_s:.3f} s "
          f"(first step), plain {plain_s:.3f} s; loss {float(metrics['loss']):.4f}, mean "
          f"reward {float(metrics['mean_reward']):.4f} ({card})")

    # timing: TRAIN_TIMED_STEPS steps through the kernels, then one profiled
    def steps(n):
        s = new_state
        for _ in range(n):
            s, m = trainer.train_step(s)
        return s, m

    steps(1)
    t0 = time.perf_counter()
    (_, m), launches = counted(torch, kernels, lambda: steps(TRAIN_TIMED_STEPS))
    wall = time.perf_counter() - t0
    events, busy, prof_wall = device_busy(lambda: steps(1), 1)
    per_step = {n: v / TRAIN_TIMED_STEPS for n, v in launches.items()}
    step_ms = wall / TRAIN_TIMED_STEPS * 1e3
    print(f"PPO timing: {TRAIN_TIMED_STEPS} train steps in {wall:.3f} s: "
          f"{TRAIN_TIMED_STEPS / wall:.3f} train steps/s, {TRAIN_TIMED_STEPS * env_steps / wall:.1f} "
          f"training env-steps/s; launches per train step {per_step}; one profiled step: "
          f"{events:.0f} CUDA device events, device busy {busy:.3f} ms of {prof_wall:.3f} ms "
          f"under the profiler (idle {100 * (1 - busy / prof_wall):.1f}%), of the timed "
          f"steps' {step_ms:.3f} ms (idle {100 * (1 - busy / step_ms):.1f}%); mean reward "
          f"{m['mean_reward']:.4f} ({card})")

    # the lanes route (--exact-env)
    exact = train_rl.build(train_rl.parser().parse_args(["--exact-env"]))
    t0 = time.perf_counter()
    _, m = exact.train(exact.init(prng.PRNGKey(0)), 2)
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"--exact-env: non-finite metrics {m}")
    print(f"PPO --exact-env (the lanes day): 2 train steps in {time.perf_counter() - t0:.3f} s; "
          f"loss {m['loss']:.4f}, mean reward {m['mean_reward']:.4f}")

    # A2C, [256, 256]
    a2c = A2CTrainer(cfg, E, A2CConfig(), table=trainer.table)
    a_state = a2c.init(prng.PRNGKey(1))
    t0 = time.perf_counter()
    _, m = a2c.train(a_state, A2C_STEPS)
    a2c_s = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"A2C: non-finite metrics {m}")
    print(f"A2C [256, 256]: {A2C_STEPS} train steps in {a2c_s:.3f} s "
          f"({A2C_STEPS / a2c_s:.3f} steps/s); loss {m['loss']:.4f}, mean reward "
          f"{m['mean_reward']:.4f} ({card})")

    # TD3, [400, 300], buffer 100,000, batch 256: through its warm-up, one
    # step against the plain versions, then TD3_STEPS more
    tcfg = TD3Config()
    td3 = TD3Trainer(cfg, E, tcfg, table=trainer.table)
    warm = -(-tcfg.warmup_steps // E)
    t_state, _ = td3.train(td3.init(prng.PRNGKey(2)), warm)
    tkernels = {n: kernels[n] for n in ("agg_cells_gate", "agg_outcomes")}
    got, launches = counted(torch, tkernels, lambda: td3.train_step(t_state))
    with agg_plain(ad), words_replaced(pk, pk.threefry_words_reference):
        want = td3.train_step(t_state)
    assert_trees_equal(torch, got, want, "TD3 train step")
    if any(v != 1 for v in launches.values()):
        fail(f"TD3 train step: launches {launches}, want 1 of each agg kernel")
    t0 = time.perf_counter()
    t_state, m = td3.train(got[0], TD3_STEPS)
    td3_s = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in m.values()) or t_state.buffer.size != (
            warm + 1 + TD3_STEPS) * E:
        fail(f"TD3: metrics {m}, buffer {t_state.buffer.size}")
    print(f"TD3 [400, 300]: {warm} warm-up steps, step {warm + 1} == plain (parameters, "
          f"targets, Adam states, buffer, env state, key, metrics); {TD3_STEPS} more in "
          f"{td3_s:.3f} s ({TD3_STEPS / td3_s:.3f} steps/s); critic loss "
          f"{m['critic_loss']:.4f}, actor loss {m['actor_loss']:.4f}, buffer "
          f"{m['buffer_size']:.0f} ({card})")

    # evaluate: 16 envs x 60 greedy days
    t0 = time.perf_counter()
    ev = train_rl.evaluate(trainer, new_state.params, prng.PRNGKey(999), num_envs=EVAL_ENVS)
    if not all(np.isfinite(v) for v in ev.values()):
        fail(f"evaluate: {ev}")
    print(f"evaluate: {EVAL_ENVS} envs x {cfg.max_days} days in {time.perf_counter() - t0:.3f} "
          f"s: AKNCP {ev['AKNCP']:.4f}, NCP {ev['NCP']:.4f}, episode return "
          f"{ev['episode_return']:.2f} ({card})")

    # the learning proof: JAX's test_ppo_actually_learns, its assertions
    lcfg = EnvConfig(num_keywords=4, kind=KeywordKind.IMPLICIT, max_volume=64, max_days=100000,
                     budget=50.0, **FAST_XLA_KNOBS)
    learner = PPOTrainer(lcfg, 64, PPOConfig(lr=3e-4, rollout_days=8, hidden=(32, 32)),
                         table=simple_experiment_table(32, 0.8))
    l_state = learner.init(prng.PRNGKey(0))
    rewards = []
    t0 = time.perf_counter()
    for _ in range(LEARN_STEPS):
        l_state, m = learner.train_step(l_state)
        rewards.append(m["mean_reward"])
    r = torch.stack(rewards).cpu().numpy().astype(np.float64)
    learn_s = time.perf_counter() - t0
    early, late = r[:LEARN_EARLY].mean(), r[-LEARN_EARLY:].mean()
    slope = np.polyfit(np.arange(len(r)), r, 1)[0]
    print(f"learning proof (4 keywords, 64 envs, budget $50, lr 3e-4, 8 rollout days, "
          f"{LEARN_STEPS} steps, PRNGKey(0)) in {learn_s:.3f} s: early {early:.4f}, late "
          f"{late:.4f} (needs > early + {LEARN_MARGIN}), slope {slope:.6f} (needs > 0)")
    if not (np.isfinite(r).all() and late > early + LEARN_MARGIN and slope > 0.0):
        fail("the learning proof failed")

    # checkpoint and restore through the CLI; the uninterrupted run in process
    with tempfile.TemporaryDirectory() as tmp:
        ck, out = os.path.join(tmp, "ck"), os.path.join(tmp, "run.json")

        def cli(*args):
            proc = subprocess.run([sys.executable, "-m", "adcraft_tpu_torch.experiments.train_rl",
                                   *args], capture_output=True, text=True, timeout=600,
                                  check=False)
            if proc.returncode != 0:
                fail(f"train_rl {' '.join(args)}: {proc.stderr[-2000:]}")
            return [json.loads(line) for line in proc.stdout.splitlines()]

        t0 = time.perf_counter()
        first = cli("--steps", "3", "--checkpoint", ck, "--out", out)
        resumed = cli("--restore", ck, "--steps", "1")
        cli_s = time.perf_counter() - t0
        artifact = json.load(open(out))
    s4, m4 = trainer.train(trainer.init(prng.PRNGKey(0)), 3)
    s4, m4 = trainer.train(s4, 1)
    line = {k: v for k, v in resumed[-1].items() if k != "step"}
    if resumed[0] != {"restored": ck} or line != m4:
        fail(f"restored run {resumed[-1]} != the uninterrupted 4th step {m4}")
    if artifact["backend"]["name"] != torch.cuda.get_device_name(0) or first[-1] != {
            "checkpoint": ck}:
        fail(f"train_rl --out: backend {artifact['backend']}, last line {first[-1]}")
    print(f"train_rl --steps 3 --checkpoint --out, then --restore --steps 1: the restored step "
          f"== the uninterrupted 4th (loss {m4['loss']:.6f}); {cli_s:.1f} s for the two runs; "
          f"artifact: final AKNCP {artifact['final']['AKNCP']:.4f}, NCP "
          f"{artifact['final']['NCP']:.4f}, zero-margin AKNCP "
          f"{artifact['baseline_zero_margin']['AKNCP']:.4f}, backend {artifact['backend']}")

    # multi_train over a PPO and a TD3 learner
    trainers, states = multi_agent.make_multi_trainers(cfg, 2, table=trainer.table,
                                                       algo_cfgs=["ppo", "td3"])
    res = multi_agent.multi_train(trainers, states, epochs=2)
    reward_mean = res["sampler_results"]["policy_reward_mean"]
    if not all(np.isfinite(v) for v in reward_mean.values()):
        fail(f"multi_train: {reward_mean}")
    print(f"multi_train (PPO, TD3 at 8 envs, 2 epochs): policy_reward_mean {reward_mean}")

    # the flagship forward on the card against the CPU's
    forward, (params, obs) = entry()
    cpu_forward, (cpu_params, cpu_obs) = entry("cpu")
    assert_trees_equal(torch, tree_leaves(torch, cpu_params),
                       [x.cpu() for x in tree_leaves(torch, params)], "entry() parameters")
    for name, a, b in zip(("mean", "log_std", "value"), forward(params, obs),
                          cpu_forward(cpu_params, cpu_obs)):
        if not torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-6):
            fail(f"entry(): the card's {name} differs from the CPU's beyond rtol 1e-5")
    print("entry(): policy and value forward at 100 keywords x 256 on the card within rtol "
          "1e-5 of the CPU's; parameters equal")


def phase_done(name: str, t0: float) -> float:
    """Prints a phase's wall time since ``t0``; returns now."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s", flush=True)
    return now


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    parent_csrc = None
    if args[:1] == ["--parent-csrc"] and len(args) == 2:
        parent_csrc = Path(args[1])
    elif args:
        print("usage: python3 chip_smoke.py [--parent-csrc DIR]", flush=True)
        return 2
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
        from adcraft_tpu_torch import agg_day as ad
        from adcraft_tpu_torch import cuda_build
        from adcraft_tpu_torch import day_kernel as dk
        from adcraft_tpu_torch import distributions as dist
        from adcraft_tpu_torch import kernel_turns
        from adcraft_tpu_torch import lanes_day as ld
        from adcraft_tpu_torch import prng
        from adcraft_tpu_torch import prng_kernel as pk
        from adcraft_tpu_torch import probe_prng as probe
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm", "nounits"))
    int_ops_per_s = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    fp_ops_per_s = sms * FP32_LANES_PER_SM * clock_mhz * 1e6
    print(f"INT32 peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x {clock_mhz:g} MHz = "
          f"{int_ops_per_s / 1e12:.3f} T ops/s; FP32 {sms} x {FP32_LANES_PER_SM} lanes = "
          f"{fp_ops_per_s / 1e12:.3f} T instructions/s; HBM {HBM_BYTES_PER_S / 1e12:g} TB/s")

    # 2. build, one nvcc per source, all started together
    clocked = stage_clocked(ad)
    lanes_stats = lanes_stats_build(ld)
    parent = None if parent_csrc is None else ld.kernels_built_from(parent_csrc)
    parent_other = None
    libraries = (dk.day_kernel.library, pk.library, ad.library, clocked.library, ld.library,
                 lanes_stats["lanes_gate"].library)
    if parent is not None:
        parent_other = parent_builds(parent_csrc, cuda_build)
        libraries += (parent["lanes_gate"].library, parent_other["agg_cells_gate"].library,
                      parent_other["threefry_words"].library)
    t0 = time.perf_counter()
    cuda_build.build_all(libraries)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(libraries)} libraries")
    ptxas = {}
    for lib in libraries:
        print(f"  {' '.join((os.path.relpath(lib.source),) + lib.flags)}: "
              f"{lib.build_seconds:.1f} s")
        ptxas[lib] = [line.strip() for line in lib.build_log.splitlines()
                      if "registers" in line or "smem" in line or "spill" in line]
        for line in ptxas[lib]:
            print(f"    ptxas: {line}")
    # a word's integer instructions split over two 64-lane pipes (IMAD on the
    # FMA pipe, the rest on the ALU pipe) under a 128-wide issue limit; the
    # busiest of the three, in INT32-lane clocks, bounds the time per word
    sass = sass_ops_per_word(pk.library.path, "threefry_rate_kernel")
    if sass is None:
        total, imad = THREEFRY_OPS_SOURCE, 0
        print(f"threefry ops per word: SASS not readable, {total} from the source")
    else:
        total, histogram = sass
        imad = histogram.get("IMAD", 0)
        print(f"threefry ops per word (SASS, threefry_rate_kernel inner loop): {total} "
              f"{histogram}")
    ops_per_word = max(total - imad, imad, total * INT32_LANES_PER_SM / DISPATCH_PER_SM)
    print(f"  bound per word: {ops_per_word:g} INT32-lane clocks ({total - imad} ALU-pipe, "
          f"{imad} FMA-pipe, {total} issued)")
    rates = (ops_per_word, int_ops_per_s, fp_ops_per_s)
    table = simple_experiment_table(MEAN_VOLUME, CVR)
    t_phase = time.perf_counter()

    # 3. kernel vs plain at full width, three budget regimes
    cfg = EnvConfig(
        num_keywords=K, kind=KeywordKind.IMPLICIT, max_volume=MAX_VOLUME, day_kernel="pallas"
    )
    m = cfg.max_clicks_per_cell
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
    chunk_t = dk.day_kernel.default_chunk_t(K, T, m, dev)
    blocks_per_sm = dk.day_kernel.occupancy(chunk_t, K, m, dev)
    smem = dk.day_kernel.smem_bytes(chunk_t, K, m)
    print(f"day kernel: {chunk_t} sub-timesteps per chunk, {smem} B of shared memory per "
          f"block, {blocks_per_sm} blocks per SM ({-(-E // (blocks_per_sm * sms))} waves at "
          f"{E} envs)")
    timed = {}  # label -> (ms, plain_ms, (bound_ms, bound_by))
    for label, budget in (("unbound", 1e6), ("binding", 1000.0), ("zero", 0.0)):
        params, n_auc, budget_c = dk.day_kernel_inputs(
            cfg, state0.kw, bids, torch.full((E,), budget, device=dev), volumes
        )
        got = dk.day_kernel(params, n_auc, budget_c, seed, m)
        torch.cuda.synchronize()
        draws = torch.zeros(dk.NUM_DRAWS, dtype=torch.int64, device=dev)
        want = dk.simulate_day_reference(params, n_auc, budget_c, seed, m, draw_counts=draws)
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
        one = dk.day_kernel(params, n_auc, budget_c, seed, m, chunk_t=1)
        for name, g, w in zip(names, one, got):
            if not torch.equal(g, w):
                fail(f"{label}: {name} differs between chunks of 1 and {chunk_t} sub-timesteps")
        if label == "unbound":
            check_moments(params, n_auc, m, got)
        if label in ("unbound", "binding"):
            ms = cuda_ms(lambda: dk.day_kernel(params, n_auc, budget_c, seed, m), reps=20)
            plain_ms = cuda_ms(
                lambda: dk.simulate_day_reference(params, n_auc, budget_c, seed, m), reps=2
            )
            # each input read once, each output written once; one threefry
            # word per draw the day needs
            day_bytes = 4 * (params.numel() + n_auc.numel() + budget_c.numel() + 1
                             + 6 * E * K + E)
            day_words = draws.sum().item()
            day_bound = bound(day_bytes, day_words * ops_per_word, int_ops_per_s)
            timed[label] = (ms, plain_ms, day_bound)
            # the chunk's trade (barriers and gate walks against the draws
            # wasted after a break and the blocks per SM): every chunk size
            # that fits, outputs equal
            sweep = []
            for c in range(1, T + 1):
                occupancy = dk.day_kernel.occupancy(c, K, m, dev)
                if occupancy == 0:
                    break
                out = dk.day_kernel(params, n_auc, budget_c, seed, m, chunk_t=c)
                if not all(torch.equal(g, w) for g, w in zip(out, got)):
                    fail(f"{label}: outputs differ at chunk_t {c}")
                c_ms = cuda_ms(lambda c=c: dk.day_kernel(params, n_auc, budget_c, seed, m,
                                                         chunk_t=c), reps=10)
                sweep.append(f"{c}: {c_ms:.4f} ms ({occupancy}/SM)")
            print(f"  by chunk_t ({label}): " + ", ".join(sweep))
            print(f"day at {E}x{K}x{T}x{m}, ${budget:g} budget: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.1f} ms; {day_words} threefry words "
                  f"{draws.tolist()}, {day_bytes / 1e6:.1f} MB; bound {day_bound[0]:.4f} ms "
                  f"({day_bound[1]}), {100 * day_bound[0] / ms:.1f}% of it reached ({card})")
    ms, plain_ms, day_bound = timed["binding"]

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
    if kernel.launches != STEPS:
        fail(f"day kernel launched {kernel.launches} times in {STEPS} steps")
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

    # 6. threefry_words == the plain threefry2x32, bit for bit
    keys = prng.split(prng.PRNGKey(7, dev), E)
    strided = prng.split(keys, 3)[:, 1]  # rows 6 words apart
    cases = (
        (f"split {E} keys into 4", keys, 4, pk.PAIR, 0, 32),
        ("fold_in", keys, 1, pk.PAIR, 0xDEADBEEF, 32),
        (f"random_bits ({E}, 100)", keys, 100, pk.XOR, 0, 32),
        (f"random_bits ({E}, 3, 100)", keys, 300, pk.XOR, 0, 32),
        (f"random_bits ({E}, 100) 16-bit", keys, 100, pk.XOR, 0, 16),
        (f"random_bits ({E}, 3, 100) 16-bit", keys, 300, pk.XOR, 0, 16),
        ("random_bits, strided key rows", strided, 100, pk.XOR, 0, 32),
        (f"random_bits, {E} x 4097 words (> 2**24 at 4096 keys)", keys, 4097, pk.XOR, 0, 32),
        (f"normal ({E}, 100)", keys, 100, pk.NORMAL, 0, 32),
        ("normal, strided key rows", strided, 100, pk.NORMAL, 0, 32),
    )
    words_err = 0
    for label, k, n, mode, base, width in cases:
        got = pk.threefry_words(k, n, mode, base, width)
        want = pk.threefry_words_reference(k, n, mode, base, width)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        words_err = max(words_err, err)
        if got.shape != want.shape or err:
            fail(f"threefry_words vs plain ({label}): max error {err}")
        print(f"threefry_words == plain: {label}, {got.numel()} words")
    if not torch.equal(prng.random_bits(keys, (3, 100), 16).cpu(),
                       prng.random_bits(keys.cpu(), (3, 100), 16)):
        fail("prng.random_bits on the card differs from the CPU")
    if not torch.equal(prng.normal(keys, (3, 100)).cpu(), prng.normal(keys.cpu(), (3, 100))):
        fail("prng.normal on the card differs from the CPU")

    # 7. the probe: its path with the counts zeroed just before
    pk.threefry_words.launches = pk.threefry_rate.launches = 0
    probe_bits = {s: probe.draw(s, dev) for s in (1, 2)}
    a, b = probe.draw2(5, dev)
    r3 = probe.draw3(1, dev)
    torch.cuda.synchronize()
    probe_launches = (pk.threefry_words.launches, pk.threefry_rate.launches)
    if probe_launches != (3, 1):
        fail(f"probe launches (threefry_words, threefry_rate) {probe_launches}, want (3, 1)")
    rate_err = 0
    for label, got, want in (
        ("draw(1)", probe_bits[1], probe.draw_plain(1, dev)),
        ("draw(2)", probe_bits[2], probe.draw_plain(2, dev)),
        ("draw2(5)", torch.stack([a, b]), torch.stack(probe.draw2_plain(5, dev))),
        ("draw3(1)", r3, probe.draw3_plain(1, dev)),
    ):
        err = (got.long() - want.long()).abs().max().item()
        if got.shape != want.shape or err:
            fail(f"probe {label}: kernel vs plain max error {err}")
        if label == "draw3(1)":
            rate_err = err
    seed1 = torch.tensor([1], dtype=torch.int32, device=dev)
    blocks = pk.threefry_rate(seed1, probe.PROGRAMS, probe.REPS)
    want = pk.threefry_rate_reference(seed1, range(probe.PROGRAMS), probe.REPS)
    rate_err = max(rate_err, (blocks.long() - want.long()).abs().max().item())
    if rate_err:
        fail(f"threefry_rate vs plain: max error {rate_err} over {probe.PROGRAMS} programs")
    print(f"probe kernels == plain: draw, draw2, draw3, and all {probe.PROGRAMS} "
          f"threefry_rate blocks")
    for s_, bits in probe_bits.items():
        h = probe.health(bits)
        problems = probe.health_failures(bits, PROBE_SE)
        print(f"seed={s_}: mean={h['mean']:.4e} odd-frac={h['odd']:.4f} zeros={h['zeros']:.4f} "
              f"unique={h['unique']}/{h['n']}")
        if problems:
            fail(f"probe seed {s_}: " + "; ".join(problems))
        quarters = bits.reshape(probe.BLOCKS, -1)
        if torch.equal(quarters[0], quarters[1]):
            fail(f"probe seed {s_}: block0 == block1")
    if torch.equal(a, b):
        fail("draw2: the two draws are identical")
    rate_ms = cuda_ms(lambda: pk.threefry_rate(seed1, probe.PROGRAMS, probe.REPS), reps=20)
    rate_plain_ms = cuda_ms(
        lambda: pk.threefry_rate_reference(seed1, range(probe.PROGRAMS), probe.REPS), reps=2
    )
    rate_words = pk.ThreefryRate.words(probe.PROGRAMS, probe.REPS)
    rate_bytes = 4 + 4 * probe.PROGRAMS * pk.RATE_ROWS * pk.RATE_COLS
    rate_bound = bound(rate_bytes, rate_words * ops_per_word, int_ops_per_s)
    print(f"prng rate: {rate_ms:.3f} ms for {rate_words / 1e6:.1f}M words -> "
          f"{rate_words / rate_ms / 1e6:.2f} G words/s; bound {rate_bound[0]:.4f} ms "
          f"({rate_bound[1]}) = {rate_words / rate_bound[0] / 1e6:.2f} G words/s; "
          f"plain {rate_plain_ms:.1f} ms ({card})")

    # 8. the slice with the RNG on the kernel, counts zeroed just before;
    # the threefry calls' shapes are noted on the way (no device work)
    state8, _ = env.reset(prng.PRNGKey(3))
    calls = []
    kernel_words = pk.threefry_words

    def words_noting_shapes(keys, n, mode, base=0, bit_width=32):
        calls.append((keys.shape[0], keys.stride(0), n, mode, base, bit_width))
        return kernel_words(keys, n, mode, base, bit_width)

    torch.cuda.synchronize()
    dk.day_kernel.launches = pk.threefry_words.launches = pk.threefry_rate.launches = 0
    t0 = time.perf_counter()
    state = state8
    rng_steps = []
    with words_replaced(pk, words_noting_shapes):
        for _ in range(STEPS):
            state, ts = env.step(state, bid_steps)
            rng_steps.append(ts)
        torch.cuda.synchronize()
    rng_kernel_s = time.perf_counter() - t0
    launches = {"day_kernel": dk.day_kernel.launches,
                "threefry_words": pk.threefry_words.launches}
    if launches != {"day_kernel": STEPS, "threefry_words": 6 * STEPS}:
        fail(f"slice launches {launches}, want {STEPS} day kernels and {6 * STEPS} threefry")
    kernel_rng_state = state

    t0 = time.perf_counter()
    with words_replaced(pk, pk.threefry_words_reference):
        state = state8
        for i in range(STEPS):
            state, ts = env.step(state, bid_steps)
            want = rng_steps[i]
            pairs = [("reward", ts.reward, want.reward),
                     ("terminated", ts.terminated, want.terminated),
                     ("truncated", ts.truncated, want.truncated)]
            pairs += [("obs." + f, ts.obs[f], want.obs[f]) for f in want.obs]
            pairs += [("outcomes." + f, getattr(ts.outcomes, f), getattr(want.outcomes, f))
                      for f in want.outcomes._fields]
            for name, x, y in pairs:
                if not torch.equal(x, y):
                    fail(f"slice step {i}: {name} differs between kernel and plain RNG")
        torch.cuda.synchronize()
    rng_plain_s = time.perf_counter() - t0
    if not torch.equal(state.key, kernel_rng_state.key):
        fail("slice: the state key differs between kernel and plain RNG")
    if pk.threefry_words.launches != 6 * STEPS:
        fail("the plain RNG route launched the threefry kernel")

    def run_steps():
        st = state8
        for _ in range(STEPS):
            st, _ts = env.step(st, bid_steps)

    events_kernel = device_busy(run_steps, STEPS)[0]
    with words_replaced(pk, pk.threefry_words_reference):
        events_plain = device_busy(run_steps, STEPS)[0]
    print(f"slice RNG: kernel {STEPS * E / rng_kernel_s:.1f} env-steps/s, plain "
          f"{STEPS * E / rng_plain_s:.1f} env-steps/s ({STEPS} steps after reset); "
          f"threefry_words {launches['threefry_words'] / STEPS:g} launches per step; CUDA "
          f"device events per step: kernel RNG {events_kernel:.1f}, plain RNG "
          f"{events_plain:.1f} ({card})")

    # the step's threefry calls, each timed at its own shapes with fresh keys
    step_calls = calls[: len(calls) // STEPS]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def call_keys(N, stride):
        words = torch.randint(0, 2**32, (N, stride), generator=gen, dtype=torch.int64, device=dev)
        return words[:, :2]

    replay = [(call_keys(N, max(stride, 2)), n, mode, base, width)
              for N, stride, n, mode, base, width in step_calls]
    words_ms = sum(cuda_ms(lambda c=c: pk.threefry_words(*c), reps=50) for c in replay)
    words_plain_ms = sum(cuda_ms(lambda c=c: pk.threefry_words_reference(*c), reps=5)
                         for c in replay)
    words_bound = threefry_words_bound(
        [(N, n, mode) for N, _s, n, mode, _b, _w in step_calls], ops_per_word, int_ops_per_s,
        fp_ops_per_s)
    print(f"threefry_words per step: {len(step_calls)} calls "
          f"{[(N, n, mode) for N, _s, n, mode, _b, _w in step_calls]}: kernel {words_ms:.4f} ms, "
          f"plain {words_plain_ms:.3f} ms, bound {words_bound[0]:.5f} ms ({words_bound[1]}) "
          f"({card})")
    # the device's floor for one launch: one word
    one_key = call_keys(1, 2)
    floor_ms = cuda_ms(lambda: pk.threefry_words(one_key, 1, pk.XOR), reps=200)
    floored = words_bound[0] + len(step_calls) * floor_ms
    print(f"threefry_words launch floor: {floor_ms:.5f} ms for one word; bound with "
          f"{len(step_calls)} floors {floored:.5f} ms; the kernel's {words_ms:.4f} ms is "
          f"{100 * floored / words_ms:.1f}% of it "
          f"({'at least' if 2 * floored >= words_ms else 'under'} half) ({card})")

    t_phase = phase_done("3-8", t_phase)

    # 9. the XLA day step
    route_kernels = xla_phase(torch, dev, card, table, *rates, sms, ptxas[ad.library], clocked)
    budget_cast_phase(torch, dev, card, table, env)
    t_phase = phase_done("9", t_phase)
    # 10. the lanes day (the JAX package's default knobs)
    route_kernels += lanes_phase(torch, dev, card, table, *rates, sms, lanes_stats, parent)
    t_phase = phase_done("10", t_phase)
    # 11. explicit keywords on the XLA day step
    route_kernels += explicit_phase(torch, dev, card, *rates)
    # their stage clocks by part, cells by kind and time by chunk
    kernel_turns.report(kernel_turns.EXPLICIT_INSTANCES, {"agg_cells_gate": ad.agg_cells_gate},
                        {"agg_cells_gate": clocked}, None, card, dev)
    t_phase = phase_done("11", t_phase)
    # 12. explicit keywords on the lanes day (EnvConfig's defaults); then
    # lanes_counts' explicit instance's stage clocks at t = 0 and t >= 1
    # and, with --parent-csrc, its time in turns with the parent's
    route_kernels += explicit_lanes_phase(torch, dev, card, *rates, lanes_stats, parent)
    kernel_turns.report(("lanes_counts (explicit)",), {"lanes_counts": ld.lanes_counts},
                        {"lanes_counts": lanes_stats["lanes_counts"]},
                        None if parent is None else {"lanes_counts": parent["lanes_counts"]},
                        card, dev)
    t_phase = phase_done("12", t_phase)
    # 13. the sparsity experiment, the gym's configurations and the timing
    experiment_phase(torch, dev, card)
    t_phase = phase_done("13", t_phase)
    # 14. the RL trainers, train_rl, checkpoints, multi-agent training, entry
    training_phase(torch, dev, card)
    t_phase = phase_done("14", t_phase)
    # 15. the binomial pool on both routes; the pool instances' stage clocks
    # and, with --parent-csrc, their times in turns with the parent's
    route_kernels += pool_phase(torch, dev, card, table, *rates)
    kernel_turns.report(
        kernel_turns.POOL_INSTANCES,
        {"lanes_counts": ld.lanes_counts, "lanes_gate_float": ld.lanes_gate_float,
         "agg_cells_gate": ad.agg_cells_gate},
        {"lanes_counts": lanes_stats["lanes_counts"],
         "lanes_gate_float": lanes_stats["lanes_gate_float"], "agg_cells_gate": clocked},
        None if parent is None else {"lanes_counts": parent["lanes_counts"],
                                     "lanes_gate_float": parent["lanes_gate_float"],
                                     "agg_cells_gate": parent_other["agg_cells_gate"]},
        card, dev)
    t_phase = phase_done("15", t_phase)
    if parent_other is not None:
        print("the agg route's kernels and threefry_words in turns with the parent tree's:")
        parent_turns_phase(torch, dev, card, table, parent_other)
        phase_done("parent turns", t_phase)

    if "jax" in sys.modules:
        fail("jax was imported")
    print(f"day kernel summary: chunk_t {chunk_t}, {blocks_per_sm} blocks per SM, {smem} B "
          f"shared memory per block; ptxas {'; '.join(ptxas[dk.day_kernel.library])}; "
          + "; ".join(f"{label} {t[0]:.4f} ms, bound {t[2][0]:.4f} ms ({t[2][1]}), "
                      f"{100 * t[2][0] / t[0]:.1f}% of bound" for label, t in timed.items())
          + f" ({card})")
    print(json.dumps({"kernels": [
        {
            "name": "day_kernel",
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/day_kernel.cu",
            "replaces": "adcraft_tpu/pallas_kernels.py:92",
            "launches": launches["day_kernel"],
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": day_bound[0],
            "bound_by": day_bound[1],
            "library_ms": None,
        },
        {
            "name": "threefry_words",
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/prng_kernels.cu",
            "replaces": "scripts/probe_prng.py:21 and scripts/probe_prng.py:56",
            "launches": launches["threefry_words"],
            "max_abs_err": words_err,
            "ms": words_ms,
            "plain_ms": words_plain_ms,
            "bound_ms": words_bound[0],
            "bound_by": words_bound[1],
            "library_ms": None,
        },
        {
            "name": "threefry_rate",
            "route": "cuda",
            "source": "adcraft_tpu_torch/csrc/prng_kernels.cu",
            "replaces": "scripts/probe_prng.py:88",
            "launches": probe_launches[1],
            "max_abs_err": rate_err,
            "ms": rate_ms,
            "plain_ms": rate_plain_ms,
            "bound_ms": rate_bound[0],
            "bound_by": rate_bound[1],
            "library_ms": None,
        },
    ] + route_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
