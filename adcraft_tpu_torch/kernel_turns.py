"""lanes_counts' and agg_cells_gate's instances on the card: each timed in
turns with another tree's build of the same kernel, with its stage clocks.

At the slice's size (4096 envs x 100 keywords x 24 sub-timesteps, bids
$1.00, ``max_volume=576``, so m0 = 47 cost lanes at t = 0), on one day's
inputs from the env's own keywords (``simple_experiment_table(128,
0.8)``; explicit ones from ``sample_explicit_keywords``; the pool's 30
bidders at participation 0.6, ``step_rate.pool_keywords``):

* ``lanes_counts``: its implicit, explicit and pool instances (the
  sampling defaults, ``binomial_sampler="exact"``);
* ``agg_cells_gate``: its implicit, explicit (rust and python) and pool
  instances (bench.py's agg knobs) at $1000, the pool's also unbound.

For each instance: ptxas' registers and spills, resident blocks per SM
(and ``agg_cells_gate``'s chunk and shared memory); its time (CUDA events,
10 calls after a warm-up) and, with ``--parent-csrc DIR`` (another tree's
``adcraft_tpu_torch/csrc``, such as the parent commit's), the count of
outputs where DIR's build differs from this tree's and both times in
turns (parent, this, this, parent); then its stage clocks from this tree's
second builds (``-DLANES_STAGE_CLOCKS``: per warp each binomial call's SM
clocks and its loops' passes; ``-DAGG_STAGE_CLOCKS``: per block each
stage's, and the pool's stage A by part).

    python3 -m adcraft_tpu_torch.kernel_turns [--parent-csrc DIR]
        [--instances NAME ...]

It runs on the card only. ``chip_smoke.py`` calls ``report`` for the pool
instances in its phase 15.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from adcraft_tpu_torch import EnvConfig, KeywordKind, VectorBiddingEnv, cuda_build, prng
from adcraft_tpu_torch import agg_day as ad
from adcraft_tpu_torch import distributions as dist
from adcraft_tpu_torch import lanes_day as ld
from adcraft_tpu_torch.config import BENCH_XLA_KNOBS, CostModel
from adcraft_tpu_torch.quantiles import simple_experiment_table
from adcraft_tpu_torch.step import agg_model, budget_cents, split_volume, xla_lanes
from adcraft_tpu_torch.step_rate import BID, K, MAX_VOLUME, POOL, pool_keywords

E = 4096
BUDGET, UNBOUND = 1000.0, 1e9
REPS = 10
BACKLOG_CYCLES = 20_000_000  # SM clock cycles the spin kernel holds the stream
# instance -> (kernel, the configuration's knobs, budgets timed)
INSTANCES = {
    "lanes_counts": ("lanes_counts", {}, ()),
    "lanes_counts (explicit)": ("lanes_counts", {"kind": KeywordKind.EXPLICIT}, ()),
    "lanes_counts (pool)": ("lanes_counts", POOL, ()),
    "agg_cells_gate": ("agg_cells_gate", BENCH_XLA_KNOBS, (BUDGET,)),
    "agg_cells_gate (explicit, rust)": ("agg_cells_gate", dict(
        BENCH_XLA_KNOBS, kind=KeywordKind.EXPLICIT, cost_model=CostModel.RUST_QUIRK), (BUDGET,)),
    "agg_cells_gate (explicit, python)": ("agg_cells_gate", dict(
        BENCH_XLA_KNOBS, kind=KeywordKind.EXPLICIT, cost_model=CostModel.PYTHON), (BUDGET,)),
    "agg_cells_gate (pool)": ("agg_cells_gate", dict(BENCH_XLA_KNOBS, **POOL),
                              (BUDGET, UNBOUND)),
}
POOL_INSTANCES = ("lanes_counts (pool)", "agg_cells_gate (pool)")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call on the card, after one warm-up call; a
    spin kernel ahead of the first event lets the host enqueue the calls."""
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


def ptxas_lines(build_log: str, stem: str) -> list:
    """ptxas' registers, stack and spills of each kernel whose mangled name
    contains ``stem``, one line per template instance."""
    out, current, parts = [], None, []
    for line in build_log.splitlines() + ["Compiling entry function ''"]:
        if "Compiling entry function" in line:
            if current is not None and parts:
                out.append(f"{current}: {'; '.join(parts)}")
            name = line.split("'")[1] if "'" in line else line
            current, parts = (name if stem in name else None), []
        elif current is not None and ("registers" in line or "spill" in line):
            parts.append(line.replace("ptxas info    :", "").strip())
    return out


def day_inputs(cfg: EnvConfig, kw, seed: int, device):
    """One day's (params, n_auc01, k_cells) for ``E`` envs with keywords ``kw``."""
    k_vol, k_cells = prng.split(prng.split(prng.PRNGKey(seed, device), E)).unbind(-2)
    volume = torch.clamp(dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std),
                         max=cfg.max_volume)
    n_auc = split_volume(cfg, volume)
    params = ad.pack_params(kw, torch.full((E, K), BID, device=device))
    return params, torch.stack([n_auc[0], n_auc[1]]).contiguous(), k_cells


def instance_inputs(name: str, device):
    """(cfg, lanes, model, params, n_auc01, k_cells) of an instance's day."""
    _, knobs, _ = INSTANCES[name]
    knobs = dict(knobs)
    kind = knobs.pop("kind", KeywordKind.IMPLICIT)
    cfg = EnvConfig(num_keywords=K, kind=kind, max_volume=MAX_VOLUME, budget=BUDGET, **knobs)
    state, _ = VectorBiddingEnv(cfg, E, simple_experiment_table(128, 0.8),
                                device=device).reset(prng.PRNGKey(80))
    kw = pool_keywords(state.kw) if name in POOL_INSTANCES else state.kw
    return (cfg, xla_lanes(cfg), agg_model(cfg)) + day_inputs(cfg, kw, 95, device)


def report(names, kernels: dict, stats: dict, parent: dict = None, card: str = "",
           device=None) -> dict:
    """Prints each named instance's ptxas, occupancy, time (in turns with
    ``parent``'s wrappers where given, with the outputs where they differ)
    and stage clocks; ``kernels``, ``stats`` and ``parent`` map
    "lanes_counts" and "agg_cells_gate" to wrappers of this tree's build,
    its clocked build and the other tree's. Returns {(instance, budget):
    [ms of the turns]} (parent, this, this, parent; this alone without a
    parent). ``device`` defaults to the current CUDA device."""
    dev = device or torch.device("cuda", torch.cuda.current_device())
    times = {}
    for name in names:
        kernel_name, _, budgets = INSTANCES[name]
        _, lanes, model, params, n_auc01, k_cells = instance_inputs(name, dev)
        this, clocked = kernels[kernel_name], stats[kernel_name]
        other = None if parent is None else parent[kernel_name]
        if kernel_name == "lanes_counts":
            occ = ld.occupancy(K, lanes, dev, model)
            print(f"{name}: {occ['counts_blocks']} blocks of 4 warps per SM"
                  + (f"; its bidders' kernel {occ['bidders_blocks']} blocks of 4 warps per SM"
                     if occ["bidders_blocks"] else ""))

            def call(kernel):
                return lambda: kernel(params, n_auc01, k_cells, lanes, "exact", model)

            runs = [(None, call)]
        else:
            chunk_t = this.default_chunk_t(K, lanes, dev, model)
            print(f"{name}: chunk_t {chunk_t}, {this.smem_bytes(chunk_t, K, lanes, model)} B "
                  f"shared memory, {this.occupancy(chunk_t, K, lanes, dev, model)} blocks per SM")

            def gate(budget):
                budget_c = budget_cents(torch.full((E,), budget, device=dev), ad.AGG_SCALE[model])
                return lambda kernel: lambda: kernel(params, n_auc01, k_cells, budget_c, lanes,
                                                     model=model)

            runs = [(budget, gate(budget)) for budget in budgets]
        for budget, call in runs:
            label = name if budget is None else f"{name} (${budget:g})"
            got = call(this)()
            if other is not None:
                want = call(other)()
                if kernel_name == "lanes_counts":
                    differ = sum((g != w).sum().item() for g, w in zip(got, want))
                    total = sum(g.numel() for g in got)
                else:
                    sim = (torch.arange(lanes.T * K, device=dev).view(1, lanes.T, K)
                           < got[3].view(-1, 1, 1))
                    differ = (got[3] != want[3]).sum().item() + sum(
                        ((g != w) & sim).sum().item() for g, w in zip(got[:3], want[:3]))
                    total = E + 3 * sim.sum().item()
                print(f"  {label}: the parent's outputs differ from this tree's in {differ} of "
                      f"{total}")
                ms = [cuda_ms(c) for c in (call(other), call(this), call(this), call(other))]
                print(f"  {label} in turns with the parent's: parent {ms[0]:.4f} / {ms[3]:.4f} "
                      f"ms, this {ms[1]:.4f} / {ms[2]:.4f} ms ({card})", flush=True)
            else:
                ms = [cuda_ms(call(this))]
                print(f"  {label}: {ms[0]:.4f} ms ({card})", flush=True)
            times[(name, budget)] = ms
            clock_report(kernel_name, label, call(clocked), clocked, got, lanes, dev)
            if name == "agg_cells_gate (pool)" and budget == BUDGET:
                # how the time follows the resident blocks: every chunk that fits
                budget_c = budget_cents(torch.full((E,), budget, device=dev), ad.AGG_SCALE[model])
                sweep = []
                for chunk_t in range(1, lanes.T + 1):
                    blocks = this.occupancy(chunk_t, K, lanes, dev, model)
                    if blocks == 0:
                        break
                    ms_c = cuda_ms(lambda c=chunk_t: this(params, n_auc01, k_cells, budget_c, lanes,
                                                          model=model, chunk_t=c))
                    sweep.append(f"{chunk_t}: {blocks}, {ms_c:.4f}")
                print(f"  {label} by chunk_t (blocks per SM, ms): " + "; ".join(sweep))
    return times


def clock_report(kernel_name, label, run, clocked, want, lanes, dev) -> None:
    """One call of the clocked build (its outputs equal to ``want``), and
    its counters per warp (lanes_counts) or per block (agg_cells_gate)."""
    index = dev.index or 0
    if kernel_name == "lanes_counts":
        ld.read_stats(clocked.library, index)  # zero the counters
        got = run()
        st = ld.read_stats(clocked.library, index)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{label}: the -DLANES_STAGE_CLOCKS build's outputs differ")
        calls = E * lanes.T  # (env, t) calls, one warp each but the bidders' (one lane)
        print(f"  {label} SM clocks per call of lane 0 (a warp per (env, t)): all "
              f"{st['counts clocks'] / calls:.0f}"
              + "".join(f"; {call}' call {st[f'{call} clocks'] / calls:.0f} (BTRS "
                        f"{st[f'{call} BTRS clocks'] / calls:.0f}), inversion passes "
                        f"{st[f'{call} inversion passes'] / calls:.2f}, BTRS passes "
                        f"{st[f'{call} BTRS passes'] / calls:.2f}"
                        for call in ld.CALLS if st[f"{call} clocks"]))
        return
    n = len(ad.STAGES) + 1
    ad.read_clocks(clocked.library, "agg_cells_gate_stage_clocks", n, index)
    ad.read_clocks(clocked.library, "agg_cells_gate_pool_clocks", len(ad.POOL_PARTS), index)
    got = run()
    stages = ad.read_clocks(clocked.library, "agg_cells_gate_stage_clocks", n, index)
    parts = ad.read_clocks(clocked.library, "agg_cells_gate_pool_clocks", len(ad.POOL_PARTS),
                           index)
    sim = torch.arange(lanes.T * K, device=dev).view(1, lanes.T, K) < got[3].view(-1, 1, 1)
    if not (torch.equal(got[3], want[3])
            and all(torch.equal(g[sim], w[sim]) for g, w in zip(got[:3], want[:3]))):
        raise SystemExit(f"{label}: the -DAGG_STAGE_CLOCKS build's outputs differ")
    blocks = max(stages[-1], 1)
    line = ", ".join(f"{s} {c / blocks:.0f}" for s, c in zip(ad.STAGES, stages))
    if any(parts):
        line += "; stage A's pool cells, thread 0: " + ", ".join(
            f"{p} {c / blocks:.0f}" for p, c in zip(ad.POOL_PARTS, parts))
    print(f"  {label} SM clocks per block (thread 0): {line}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent-csrc", type=Path,
                        help="time each instance in turns with its build from this csrc directory")
    parser.add_argument("--instances", nargs="+", choices=list(INSTANCES),
                        default=list(INSTANCES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns runs on the card only: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    stats = {"lanes_counts": ld.LanesCounts("lanes_counts (stats)", ld.stats_library()),
             "agg_cells_gate": ad.AggCellsGate("agg_cells_gate (stage clocks)",
                                               ad.clocks_library())}
    kernels = {"lanes_counts": ld.lanes_counts, "agg_cells_gate": ad.agg_cells_gate}
    parent = None
    if args.parent_csrc is not None:
        parent = {"lanes_counts": ld.kernels_built_from(args.parent_csrc)["lanes_counts"],
                  "agg_cells_gate": ad.AggCellsGate(
                      "agg_cells_gate (parent)",
                      cuda_build.CudaLibrary("agg_day", ad.bind, csrc=args.parent_csrc))}
    libraries = {k.library for k in list(kernels.values()) + list(stats.values())
                 + list((parent or {}).values())}
    cuda_build.build_all(libraries)
    for lib, stem in ((ld.library, "lanes_counts"), (ld.library, "lanes_bidders"),
                      (ad.library, "agg_cells_gate")):
        for line in ptxas_lines(lib.build_log, stem):
            print(f"ptxas {line}")
    report(args.instances, kernels, stats, parent, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
