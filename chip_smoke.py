#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adcraft_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name, and power limit as nvidia-smi reports it;
2. build the CUDA libraries from adcraft_tpu_torch/csrc, one nvcc per
   source, all at once (the day kernel; the threefry kernels);
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
   (4096, 3, 100) in 32 and 16 bits, keys with strided rows, and more than
   2**24 words;
7. the PRNG probe (adcraft_tpu_torch.probe_prng): draw, draw2 and draw3
   equal their plain versions bit for bit at the JAX probe's shapes, the
   threefry_rate blocks of all 24 programs too; bit health within 5
   standard errors; words/s beside its bound;
8. the slice with the RNG on the kernel: 5 steps, then the same 5 steps
   with prng's kernel swapped for the plain function; every TimeStep
   field and the state key equal; exactly 6 threefry_words launches per
   step; CUDA device events per step for both routes (torch.profiler).

The line before the last is a JSON object with each kernel's launches on
its path, error, times and bound; the last line is {"ok": true, "device":
{...}}. Without a CUDA device, or outside the repository, it exits 1 and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
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


def threefry_words_bound(calls, ops_per_word: float, int_ops_per_s: float):
    """(bound_ms, bound_by) for a list of threefry_words calls
    ``(N, n, mode)``: each key read once (16 bytes), each output word
    written once (8 bytes, two in pair mode), one threefry block per (key,
    counter)."""
    blocks = sum(N * n for N, n, _ in calls)
    nbytes = sum(16 * N + 8 * N * n * (2 if mode == "pair" else 1) for N, n, mode in calls)
    return bound(nbytes, blocks * ops_per_word, int_ops_per_s)


def bound(nbytes: float, ops: float, ops_per_s: float):
    """The larger of the byte time and the operation time, in ms."""
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def cuda_events_per_step(run, steps: int) -> float:
    """CUDA device events (kernels and copies) per step under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) / steps


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
        from adcraft_tpu_torch import cuda_build
        from adcraft_tpu_torch import day_kernel as dk
        from adcraft_tpu_torch import distributions as dist
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
    print(f"INT32 peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x {clock_mhz:g} MHz = "
          f"{int_ops_per_s / 1e12:.3f} T ops/s; HBM {HBM_BYTES_PER_S / 1e12:g} TB/s")

    # 2. build, one nvcc per source, all started together
    libraries = (dk.day_kernel.library, pk.library)
    t0 = time.perf_counter()
    cuda_build.build_all(libraries)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(libraries)} libraries")
    ptxas = {}
    for lib in libraries:
        print(f"  {lib.source.name}: {lib.build_seconds:.1f} s")
        ptxas[lib.name] = [line.strip() for line in lib.build_log.splitlines()
                           if "registers" in line or "smem" in line or "spill" in line]
        for line in ptxas[lib.name]:
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

    events_kernel = cuda_events_per_step(run_steps, STEPS)
    with words_replaced(pk, pk.threefry_words_reference):
        events_plain = cuda_events_per_step(run_steps, STEPS)
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
        [(N, n, mode) for N, _s, n, mode, _b, _w in step_calls], ops_per_word, int_ops_per_s
    )
    print(f"threefry_words per step: {len(step_calls)} calls "
          f"{[(N, n, mode) for N, _s, n, mode, _b, _w in step_calls]}: kernel {words_ms:.4f} ms, "
          f"plain {words_plain_ms:.3f} ms, bound {words_bound[0]:.5f} ms ({words_bound[1]}) "
          f"({card})")

    if "jax" in sys.modules:
        fail("jax was imported")
    print(f"day kernel summary: chunk_t {chunk_t}, {blocks_per_sm} blocks per SM, {smem} B "
          f"shared memory per block; ptxas {'; '.join(ptxas[dk.day_kernel.library.name])}; "
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
