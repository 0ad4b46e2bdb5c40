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
  instances (bench.py's agg knobs) at $1000, the pool's also unbound;
* ``lanes_gate_float``: its rust mode (``EnvConfig()``'s explicit
  keywords) and its pool mode, at $1000 and unbound, on the counts that
  ``lanes_counts`` draws for the same day's inputs (the pool's with the
  env's cent bids).

For each instance: ptxas' registers and spills (and ``agg_cells_gate``'s
SASS: instructions, calls, local-memory traffic), resident blocks per SM
(and ``agg_cells_gate``'s chunk and shared memory); its time (CUDA events,
10 calls after a warm-up) and, with ``--parent-csrc DIR`` (another tree's
``adcraft_tpu_torch/csrc``, such as the parent commit's), the count of
outputs where DIR's build differs from this tree's and both times in
turns (parent, this, this, parent); then its stage clocks from this tree's
second builds (``-DLANES_STAGE_CLOCKS``: per warp each binomial call's SM
clocks and its loops' passes; ``-DAGG_STAGE_CLOCKS``: per block each
stage's, the pool's stage A by part, the other models' prologue and stage
A by part, and the cells with clicks and impressions (the pool's: with
clicks and bidders), with phantom clicks and resolved by lanes;
``lanes_counts``' also apart at t = 0 and t >= 1, with its calls that ran
BTRS, its inversion words and slot steps and its warps' prologue;
``lanes_gate_float``'s per warp by stage, with its cells by kind). The
explicit and pool instances of ``agg_cells_gate`` are also timed at every
chunk of sub-timesteps that fits ($1000).

    python3 -m adcraft_tpu_torch.kernel_turns [--parent-csrc DIR]
        [--instances NAME ...]

It runs on the card only. ``chip_smoke.py`` calls ``report`` for the
explicit instances of ``agg_cells_gate`` in its phase 11, for
``lanes_counts (explicit)`` in its phase 12 and for the pool instances in
its phase 15.
"""

from __future__ import annotations

import argparse
import re
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
SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;")
SASS_OPS = ("CALL", "LDL", "STL", "BSSY", "BAR", "MUFU", "DADD", "DMUL", "DFMA")
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
    "lanes_gate_float": ("lanes_gate_float", {"kind": KeywordKind.EXPLICIT}, (BUDGET, UNBOUND)),
    "lanes_gate_float (pool)": ("lanes_gate_float", POOL, (BUDGET, UNBOUND)),
}
POOL_INSTANCES = ("lanes_counts (pool)", "agg_cells_gate (pool)", "lanes_gate_float (pool)")
EXPLICIT_INSTANCES = ("agg_cells_gate (explicit, rust)", "agg_cells_gate (explicit, python)")
# lanes_gate_float's cells by kind in its counters; they add up to the cells walked
FLOAT_KINDS = ("float dead", "float no click", "float over", "float whole", "float partial",
               "float deep")
# the instances timed at every chunk that fits ($1000)
SWEPT = EXPLICIT_INSTANCES + ("agg_cells_gate (pool)",)


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


def sass_counts(library_path, stem: str) -> list:
    """For each kernel of the library whose mangled name contains ``stem``:
    its SASS instructions (``cuobjdump -sass``) and those of ``SASS_OPS``
    among them (calls, local-memory traffic, divergence points, barriers,
    special-function and float64 instructions), one line per instance."""
    cuobjdump = Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(library_path)], capture_output=True,
                          text=True, timeout=300, check=False)
    out = []
    for section in proc.stdout.split("Function : ")[1:]:
        name = section.splitlines()[0].strip()
        if stem not in name:
            continue
        ops = [m.group(1).split(".")[0] for m in SASS_INSN.finditer(section)]
        counts = ", ".join(f"{op} {ops.count(op)}" for op in SASS_OPS)
        out.append(f"{name}: {len(ops)} instructions; {counts}")
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


def walked_cells(n_sim, lanes, nk: int):
    """(E, T, K) bool: the cells of the sub-timesteps ``lanes_gate_float``
    walks (up to that of cell ``n_sim - 1``), all of which it writes."""
    cell = torch.arange(lanes.T * nk, device=n_sim.device).view(1, lanes.T, nk)
    return cell < ((n_sim + nk - 1) // nk * nk).view(-1, 1, 1)


def report(names, kernels: dict, stats: dict, parent: dict = None, card: str = "",
           device=None) -> dict:
    """Prints each named instance's ptxas, occupancy, time (in turns with
    ``parent``'s wrappers where given, with the outputs where they differ)
    and stage clocks; ``kernels``, ``stats`` and ``parent`` map the
    instances' kernels ("lanes_counts", "agg_cells_gate",
    "lanes_gate_float") to wrappers of this tree's build, its clocked build
    and the other tree's. Returns {(instance, budget): [ms of the turns]}
    (parent, this, this, parent; this alone without a parent). ``device``
    defaults to the current CUDA device."""
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
        elif kernel_name == "lanes_gate_float":
            pool = model == ad.POOL
            occ = ld.occupancy(K, lanes, dev, model)
            print(f"{name}: {occ['gate_blocks']} blocks of 4 warps per SM, {occ['gate_smem']} B "
                  f"shared memory")
            counts = ld.lanes_counts(params, n_auc01, k_cells, lanes, "exact", model, pool)
            imp, ncl, bidders = counts[0], counts[1], counts[2] if pool else None

            def gate(budget):
                b = torch.full((E,), budget, device=dev)
                return lambda kernel: lambda: kernel(params, k_cells, ncl, imp, b, lanes, bidders,
                                                     cent_bids=pool)

            runs = [(budget, gate(budget)) for budget in budgets]
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
                elif kernel_name == "lanes_gate_float":  # bit for bit on the cells it walks
                    walked = walked_cells(got[2], lanes, K)
                    differ = (got[2] != want[2]).sum().item() + sum(
                        ((g.view(torch.int32) != w.view(torch.int32)) & walked).sum().item()
                        for g, w in zip(got[:2], want[:2]))
                    total = E + 2 * walked.sum().item()
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
            clock_report(kernel_name, label, call(clocked), clocked, got, lanes, dev, model)
            if name in SWEPT and budget == BUDGET:
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


def counts_line(st: dict, calls: int, at: str) -> str:
    """lanes_counts' counters per (env, t) call of the calls ``at`` names
    ("" all, " at t = 0"; or, given the differences, t >= 1)."""
    return (f"all {st['counts clocks' + at] / calls:.0f}, prologue "
            f"{st['counts prologue clocks' + at] / calls:.0f}"
            + "".join(f"; {call}' call {st[f'{call} clocks{at}'] / calls:.0f} (BTRS in "
                      f"{st[f'{call} BTRS calls{at}']} calls, "
                      f"{st[f'{call} BTRS clocks{at}'] / calls:.0f} clocks, "
                      f"{st[f'{call} BTRS passes{at}'] / calls:.3f} passes; inversion "
                      f"{st[f'{call} inversion passes{at}'] / calls:.3f} passes, "
                      f"{st[f'{call} inversion words{at}'] / calls:.2f} words in "
                      f"{st[f'{call} inversion steps{at}'] / calls:.2f} slot steps)"
                      for call in ld.CALLS if st[f"{call} clocks{at}"]))


def float_gate_counters(label: str, run, clocked, want, lanes, dev) -> None:
    """One day of ``lanes_gate_float`` through its -DLANES_STAGE_CLOCKS
    build ``clocked`` (``run``; its outputs equal to ``want`` on every cell
    it walks): prints its cells by kind (which add up to the cells walked,
    the -1 ones "dead"), windows, lanes, runs by ballot, redrawn cells,
    broken days and SM clocks per stage."""
    index = dev.index or 0
    ld.read_stats(clocked.library, index)  # zero the counters
    got = run()
    st = ld.read_stats(clocked.library, index)
    envs, _, nk = want[0].shape
    walked = walked_cells(want[2], lanes, nk)
    if not (torch.equal(got[2], want[2])
            and all(torch.equal(a[walked], b[walked]) for a, b in zip(got[:2], want[:2]))):
        raise SystemExit(f"lanes_gate_float ({label}): the -DLANES_STAGE_CLOCKS build's outputs "
                         f"differ")
    n_walked = walked.sum().item()
    dead = (want[0][walked] == -1).sum().item()
    if (sum(st[k] for k in FLOAT_KINDS) != n_walked or st["float dead"] != dead
            or st["float warps"] != envs):
        raise SystemExit(f"lanes_gate_float ({label}): counters {[st[k] for k in FLOAT_KINDS]} "
                         f"over {st['float warps']} warps, want {n_walked} walked cells ({dead} "
                         f"dead) over {envs}")
    warps = st["float warps"]
    print(f"  lanes_gate_float walk ({label}): {n_walked} walked cells: "
          + ", ".join(f"{st[k]} {k[6:]}" for k in FLOAT_KINDS)
          + f"; {st['float runs']} runs by ballot, {st['float redrawn']} cells "
          f"redrawn; {st['float windows']} windows, {st['float lanes']} lanes after the first "
          f"({st['float lanes'] / max(n_walked - dead, 1):.3f} per simulated cell); "
          f"{st['float broken']} of {envs} days broken; SM clocks per warp: stage A "
          f"{st['float stage A clocks'] / warps:.0f}, stage B "
          f"{st['float stage B clocks'] / warps:.0f}; per walked cell "
          f"{(st['float stage A clocks'] + st['float stage B clocks']) / n_walked:.1f}",
          flush=True)


def clock_report(kernel_name, label, run, clocked, want, lanes, dev, model) -> None:
    """One call of the clocked build (its outputs equal to ``want``), and
    its counters per warp (lanes_counts, at t = 0 and t >= 1;
    lanes_gate_float) or per block (agg_cells_gate, the cost model
    ``model``'s parts and its cells by kind)."""
    index = dev.index or 0
    if kernel_name == "lanes_gate_float":
        float_gate_counters(label, run, clocked, want, lanes, dev)
        return
    if kernel_name == "lanes_counts":
        ld.read_stats(clocked.library, index)  # zero the counters
        got = run()
        st = ld.read_stats(clocked.library, index)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{label}: the -DLANES_STAGE_CLOCKS build's outputs differ")
        # (env, t) calls, one warp each but the bidders' (one lane); t >= 1's
        # counters are all calls' less t = 0's
        later = {f"{name} at t >= 1": st[name] - st[f"{name} at t = 0"] for name in st
                 if f"{name} at t = 0" in st}
        print(f"  {label} SM clocks per call of lane 0 (a warp per (env, t)): "
              + counts_line(st, E * lanes.T, ""))
        print(f"  {label} at t = 0 ({E} calls): " + counts_line(st, E, " at t = 0"))
        print(f"  {label} at t >= 1 ({E * (lanes.T - 1)} calls): "
              + counts_line(later, E * (lanes.T - 1), " at t >= 1"), flush=True)
        if st["counts flat warps"]:  # the explicit instance's warps that drew t >= 1 flat
            print(f"  {label}: {st['counts flat warps']} warps drew their env's t >= 1 calls "
                  f"flat, {st['counts flat clocks'] / st['counts flat warps']:.0f} SM clocks "
                  f"each", flush=True)
        return
    readers = (("agg_cells_gate_stage_clocks", len(ad.STAGES) + 1),
               ("agg_cells_gate_part_clocks", len(ad.PARTS)),
               ("agg_cells_gate_cell_counts", len(ad.CELL_KINDS)))
    for reader, n in readers:  # zero the counters
        ad.read_clocks(clocked.library, reader, n, index)
    got = run()
    stages, parts, cells = (ad.read_clocks(clocked.library, reader, n, index)
                            for reader, n in readers)
    sim = torch.arange(lanes.T * K, device=dev).view(1, lanes.T, K) < got[3].view(-1, 1, 1)
    if not (torch.equal(got[3], want[3])
            and all(torch.equal(g[sim], w[sim]) for g, w in zip(got[:3], want[:3]))):
        raise SystemExit(f"{label}: the -DAGG_STAGE_CLOCKS build's outputs differ")
    blocks = max(stages[-1], 1)
    line = ", ".join(f"{s} {c / blocks:.0f}" for s, c in zip(ad.STAGES, stages))
    line += "; by part: " + ", ".join(f"{p} {c / blocks:.0f}" for p, c in zip(
        ad.POOL_PARTS if model == ad.POOL else ad.PARTS, parts))
    print(f"  {label} SM clocks per block (thread 0): {line}", flush=True)
    print(f"  {label} cells: {sim.sum().item()} simulated of {E * lanes.T * K}; sampled "
          + ", ".join(f"{c} {kind}" for kind, c in zip(ad.CELL_KINDS, cells)), flush=True)


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
    lanes_stats = ld.stats_library()
    stats = {"lanes_counts": ld.LanesCounts("lanes_counts (stats)", lanes_stats),
             "lanes_gate_float": ld.LanesGateFloat("lanes_gate_float (stats)", lanes_stats),
             "agg_cells_gate": ad.AggCellsGate("agg_cells_gate (stage clocks)",
                                               ad.clocks_library())}
    kernels = {"lanes_counts": ld.lanes_counts, "lanes_gate_float": ld.lanes_gate_float,
               "agg_cells_gate": ad.agg_cells_gate}
    parent = None
    if args.parent_csrc is not None:
        lanes_parent = ld.kernels_built_from(args.parent_csrc)  # one build for both
        parent = {"lanes_counts": lanes_parent["lanes_counts"],
                  "lanes_gate_float": lanes_parent["lanes_gate_float"],
                  "agg_cells_gate": ad.kernels_built_from(args.parent_csrc)["agg_cells_gate"]}
    used = {INSTANCES[name][0] for name in args.instances}
    libraries = {d[k].library for d in (kernels, stats, parent or {}) for k in used if k in d}
    cuda_build.build_all(libraries)
    # ptxas of every kernel; the SASS counts of those the instances use
    for kernel_name, lib, stems in (
            ("lanes_counts", ld.library, ("lanes_counts", "lanes_bidders")),
            ("lanes_gate_float", ld.library, ("lanes_gate_float",)),
            ("agg_cells_gate", ad.library, ("agg_cells_gate",))):
        for stem in stems:
            for line in ptxas_lines(lib.build_log, stem):
                print(f"ptxas {line}")
            if kernel_name not in used:
                continue
            for line in sass_counts(lib.path, stem):
                print(f"sass {line}")
            if parent is not None:
                for line in sass_counts(parent[kernel_name].library.path, stem):
                    print(f"sass (parent) {line}")
    report(args.instances, kernels, stats, parent, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
