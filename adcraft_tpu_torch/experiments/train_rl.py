"""PPO training CLI with periodic AKNCP/NCP evaluation.

Counterpart of ``adcraft_tpu/experiments/train_rl.py:31-235``, which
replaces the reference's RL training notebook
(adcraft/RL/train_agent.ipynb: RLlib PPO/A2C/TD3 on FlatArrayAuction
with periodic AKNCP/NCP eval and checkpoint save/restore). Trains on the
card unless ``--device`` names another.

Usage:
    python3 -m adcraft_tpu_torch.experiments.train_rl --config dense --steps 50 \\
        --num-envs 256 --checkpoint ckpt/ppo
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from adcraft_tpu_torch import metrics as M
from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.agents.networks import flatten_obs
from adcraft_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu_torch.config import FAST_XLA_KNOBS, EnvConfig, KeywordKind
from adcraft_tpu_torch.distributions import recip
from adcraft_tpu_torch.env import env_reset, vector_env_step_xla
from adcraft_tpu_torch.experiments.configs import ENV_CONFIGS, experiment_table
from adcraft_tpu_torch.experiments.harness import BID_GRID
from adcraft_tpu_torch.keywords import sample_implicit_keywords


def _mean(x: torch.Tensor) -> float:
    """``jnp.mean`` of a vector under jit: its sum times the float32
    reciprocal of its length."""
    return float(x.sum() * recip(x.shape[0]))


def evaluate(trainer: PPOTrainer, params, key: torch.Tensor, num_envs: int = 16,
             eval_days: int = None) -> Dict:
    """Greedy-policy rollout + AKNCP/NCP against the oracle curves.

    Mirrors the notebook's run_agent_for_max_days + compute_AKNCP/NCP eval
    loop (train_agent.ipynb cell 8), for ``num_envs`` keys of ``key`` at
    once: each key's keywords from itself, its env from ``fold_in(k, 1)``,
    its oracle curves from ``fold_in(k, 2)``; then ``max_days`` greedy
    days (the policy's mean, no noise). ``eval_days`` overrides the
    episode length (training on never-resetting episodes, the stationary
    mode, still scores the reference's standard 60-day episodes).
    """
    cfg = trainer.env_cfg
    if eval_days is not None:
        cfg = cfg.replace(max_days=eval_days)
    keys = prng.split(key.to(trainer.device), num_envs)
    kw = sample_implicit_keywords(keys, cfg.num_keywords, trainer.table)
    state, obs = env_reset(cfg, prng.fold_in(keys, 1), kw=kw)
    grid = torch.as_tensor(BID_GRID, device=trainer.device)
    win, cpc = M.implicit_kw_bid_curves(kw, grid, prng.fold_in(keys, 2))
    ideal, _, _ = M.max_expected_bid_profits(kw.vol_mean, kw.bctr, kw.sctr, kw.rev_mean, cpc, win)
    obs_flat = flatten_obs(obs)
    profits, rewards = [], []
    for _ in range(cfg.max_days):
        mean, _ = trainer.policy_apply(params["policy"], obs_flat)
        bids, budget = trainer.policy.squash(mean)  # greedy (no noise)
        state, ts = vector_env_step_xla(cfg, state, bids, budget, xla_sums=True)
        obs_flat = flatten_obs(ts.obs)
        profits.append(ts.outcomes.profit)
        rewards.append(ts.reward)
    profits = torch.stack(profits, 1)  # (E, T, K)
    ideal_t = ideal[:, None, :].expand(profits.shape)
    akncp = M.compute_AKNCP(profits, ideal_t)
    ncp = M.compute_NCP(profits, ideal_t)
    ret = xla_math.sum(torch.stack(rewards, 1), -1)
    return {"AKNCP": _mean(akncp), "NCP": _mean(ncp), "episode_return": _mean(ret)}


def build(args) -> PPOTrainer:
    """The trainer that ``main`` runs for parsed ``args``."""
    env_config = ENV_CONFIGS[args.config]
    kc = env_config["keyword_config"]
    k = args.num_keywords or env_config["num_keywords"]
    cfg = EnvConfig(
        num_keywords=k,
        max_days=1_000_000 if args.stationary_train else env_config["max_days"],
        kind=KeywordKind.IMPLICIT,
        max_volume=int(max(32, 4 * kc["mean_volume"] + 64)),
        **({} if args.exact_env else FAST_XLA_KNOBS),
    )
    return PPOTrainer(cfg, args.num_envs, PPOConfig(lr=args.lr, rollout_days=args.rollout_days),
                      table=experiment_table(env_config), device=args.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="dense", choices=sorted(ENV_CONFIGS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--num-envs", type=int, default=128)
    ap.add_argument("--num-keywords", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--restore",
        default=None,
        help="checkpoint path to resume training from (the notebook's "
        "Algorithm.from_checkpoint path, train_agent.ipynb cells 12/14); "
        "restores the FULL TrainState (params, optimizer, env batch, key)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=PPOConfig.lr)
    ap.add_argument("--rollout-days", type=int, default=PPOConfig.rollout_days)
    ap.add_argument(
        "--out",
        default=None,
        help="write the full training curve + a NaiveZeroMargin baseline "
        "comparison to this JSON file (the committed artifact of "
        "train_agent.ipynb cells 8/12/14's saved outputs)",
    )
    ap.add_argument(
        "--stationary-train",
        action="store_true",
        help="train on never-resetting episodes (each env's keyword set "
        "is a fixed learning target: removes the keyword-resample "
        "non-stationarity of short auto-reset episodes); evaluation "
        "still scores standard max_days episodes",
    )
    ap.add_argument(
        "--exact-env",
        action="store_true",
        help="use the JAX package's default sampling modes (the lanes day) "
        "instead of the fast modes (agg costs, count conversions, "
        "aggregate revenue)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    trainer = build(args)
    eval_days = ENV_CONFIGS[args.config]["max_days"]
    device = trainer.device
    state = trainer.init(prng.PRNGKey(args.seed))
    untrained_eval = None
    if args.out:
        # the init-policy score: the floor against which the trained
        # policy's eval numbers are read
        untrained_eval = evaluate(trainer, state.params, prng.PRNGKey(999), num_envs=32,
                                  eval_days=eval_days)
        print(json.dumps({"untrained": untrained_eval}), flush=True)
    if args.restore:
        from adcraft_tpu_torch.checkpoint import restore_checkpoint

        state = restore_checkpoint(args.restore, state)
        print(json.dumps({"restored": args.restore}), flush=True)
    curve = []
    for step in range(args.steps):
        state, metrics = trainer.train(state, 1)
        line = {"step": step, **metrics}
        if (step + 1) % args.eval_every == 0:
            line.update(evaluate(trainer, state.params, prng.PRNGKey(1000 + step),
                                 eval_days=eval_days))
        curve.append(line)
        print(json.dumps(line), flush=True)

    if args.out:
        # the trained policy vs the NaiveZeroMargin baseline on the SAME
        # metric protocol: the repo analogue of train_agent.ipynb's saved
        # cell outputs (trained-agent AKNCP/NCP vs the heatmap baseline
        # agent)
        from adcraft_tpu_torch.experiments.harness import run_episode_batch

        final_eval = evaluate(trainer, state.params, prng.PRNGKey(999), num_envs=32,
                              eval_days=eval_days)
        zm = run_episode_batch(trainer.env_cfg.replace(max_days=eval_days), trainer.table,
                               env_seeds=(5, 6, 7, 8), agent_seeds=(0, 1), num_days=eval_days,
                               device=device)
        ideal = zm["ideal_profits"]
        zm_akncp = float(np.mean(M.compute_AKNCP(zm["kw_profits"], ideal).numpy()))
        zm_ncp = float(np.mean(M.compute_NCP(zm["kw_profits"], ideal).numpy()))
        artifact = {
            "config": args.config,
            "num_envs": args.num_envs,
            "num_keywords": trainer.env_cfg.num_keywords,
            "steps": args.steps,
            "lr": args.lr,
            "rollout_days": args.rollout_days,
            "seed": args.seed,
            "curve": curve,
            "untrained": untrained_eval,
            "final": final_eval,
            "baseline_zero_margin": {"AKNCP": zm_akncp, "NCP": zm_ncp},
            "backend": {"device": str(device),
                        "name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu")},
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(json.dumps({"out": args.out, "final": final_eval,
                          "baseline_zero_margin": artifact["baseline_zero_margin"]}), flush=True)

    if args.checkpoint:
        from adcraft_tpu_torch.checkpoint import save_checkpoint

        # the full TrainState (params, optimizer state, env batch, PRNG
        # key) so --restore continues training exactly where it stopped
        save_checkpoint(args.checkpoint, state)
        print(json.dumps({"checkpoint": args.checkpoint}), flush=True)


if __name__ == "__main__":
    main()
