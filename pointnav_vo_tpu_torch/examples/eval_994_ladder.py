"""The 994-episode quality ladder on one card (counterpart of
``examples/eval_994_ladder.py``): the trained policy under VO, the GPS
oracle, the greedy controller, and the policy under rnd-mode VO.

    python -m pointnav_vo_tpu_torch.examples.eval_994_ladder \\
        --vo-cache vo994.pt --policy-cache pol994.pt --out EVAL_994_LADDER_torch.json
    python -m pointnav_vo_tpu_torch.examples.eval_994_ladder --episodes 16 --rnd-episodes 8 \\
        --envs 8 --pairs 256 --eval-pairs 64 --epochs 1 --gps-updates 2 --tune-updates 2 \\
        --train-envs 4 --num-steps 16                                     # smoke size

The reference's headline claim is that VO-supplied goals nearly match GPS
goals.  The rows share the episode set, the env seeds, the VO and policy
weights and the caps:

- ``policy_vo``: the trained ``PointNavActorCritic`` (bf16 compute) on
  goals dead-reckoned through the trained det VO (the deployment
  condition);
- ``oracle_gps``: the same policy on the ground-truth goal (the quality
  bound: VO drift apart from the controller's limits); no VO, so no
  ``bin_counts`` launch;
- ``greedy_vo``: the goal-greedy controller (``eval_994.GreedyGoalPolicy``)
  on the same VO, the shape of ``eval_994.py``;
- ``policy_vo_rnd`` (``--rnd-episodes``, 0 skips it): the policy under the
  rnd-mode dropout ensemble (10 passes, ``vo_pred_std``).

Pipeline: the three VO experts at 341x192 in bf16 (``eval_994.train_experts``
on the JAX package's scripted HDF5 entries held in memory; ``--vo-cache``),
the policy GPS-trained on depth and goal only (``--policy-cache``), then
fine-tuned with the VO in the loop (TRAIN.md stage 4), then each row over a
fresh shm env farm of ``--envs`` forked workers (seed 777).  Each row checks
that the evaluator counted exactly its episode count of distinct episodes
and, on the card, that ``bin_counts`` launched exactly once per loop step
plus once (none for ``oracle_gps``).

Resuming: policy training writes ``<policy-cache>.part`` (``torch.save`` of
the trainer's ``checkpoint_state``, the stage, the update, the reward trend
and the time so far) every 10 updates and when the GPS stage ends, and a
relaunch continues from it; a stage whose start equals its target runs no
update.  Finished rows go to ``<out>.rows.json``.  ``--watchdog`` seconds
without progress exit the process with code 3 (after dumping every
thread's stack), for an outer loop to relaunch and resume.  The record, with
the fields of the JAX package's ``EVAL_994_LADDER.json`` and the card's name
and power limit in place of its host caveat, goes to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.examples.eval_994 import (
    REFERENCE_EVAL_MIN,
    CountedSteps,
    GreedyGoalPolicy,
    card_line,
    train_experts,
)
from pointnav_vo_tpu_torch.examples.train_rl_scripted import DepthGoalEnvs, mean_reward
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pointnav_vo_tpu_torch.io.weights import policy_state_dict_from_container
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv
from pointnav_vo_tpu_torch.ops import topdown_kernels
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

TARGET_MIN = 30.0  # the north star: the policy_vo row's wall clock
PART_EVERY = 10  # updates between .part checkpoints
SEED = 0

# -- the stall watchdog --------------------------------------------------------

_HB = [time.monotonic()]


def beat() -> None:
    """Mark progress."""
    _HB[0] = time.monotonic()


def start_watchdog(stale_s: float) -> None:
    """Exit the process with code 3 once ``stale_s`` seconds pass without a
    :func:`beat` (0 disables), checked every ``min(30, stale_s)`` seconds:
    a stalled run cannot recover in process, and the caches, the ``.part``
    file and the row journal make the relaunch resume."""
    if stale_s <= 0:
        return

    def watch():
        while True:
            time.sleep(min(30.0, stale_s))
            idle = time.monotonic() - _HB[0]
            if idle > stale_s:
                print(f"\nWATCHDOG: no progress for {idle:.0f}s (limit {stale_s}); "
                      "exiting 3 for the retry loop", flush=True)
                faulthandler.dump_traceback()
                sys.stdout.flush()
                os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


# -- the VO experts --------------------------------------------------------------


def make_icfg(env_cfg: EnvConfig, **kw) -> VOInferenceConfig:
    return VOInferenceConfig(vis_size_w=env_cfg.image_w, vis_size_h=env_cfg.image_h,
                             precision="bf16", **kw)


def train_vo(args, env_cfg: EnvConfig, device):
    """The three experts' state dicts ([forward, left, right]) and the
    training's seconds, from ``--vo-cache`` where it exists, else trained
    (and cached there where it is given)."""
    if args.vo_cache and os.path.isfile(args.vo_cache):
        c = load_checkpoint(args.vo_cache)
        print(f"loaded trained VO experts from {args.vo_cache}", flush=True)
        return c["experts"], c["t_vo"]
    t0 = time.perf_counter()
    print(f"training the VO experts on {args.pairs}+{args.eval_pairs} pairs at "
          f"{env_cfg.image_w}x{env_cfg.image_h} ...", flush=True)
    experts, _record = train_experts(make_icfg(env_cfg), env_cfg, args.pairs, args.eval_pairs,
                                     args.epochs, args.batch, device,
                                     log=lambda m: print(m, flush=True))
    states = [{k: v.detach().cpu() for k, v in m.state_dict().items()} for m in experts]
    t_vo = time.perf_counter() - t0
    if args.vo_cache:
        save_checkpoint(args.vo_cache, {"experts": states, "t_vo": t_vo})
        print(f"cached VO experts to {args.vo_cache}", flush=True)
    return states, t_vo


def make_ensemble(icfg: VOInferenceConfig, states, device) -> VOEnsemble:
    """A fresh ensemble holding the experts' state dicts."""
    experts = []
    for sd in states:
        m = icfg.make_model()
        m.load_state_dict(sd, strict=True)
        experts.append(m)
    return VOEnsemble(icfg, experts=experts, device=device)


# -- the policy ------------------------------------------------------------------


def make_policy(env_cfg: EnvConfig) -> PointNavActorCritic:
    return PointNavActorCritic(image_size=(env_cfg.image_h, env_cfg.image_w),
                               compute_dtype=torch.bfloat16)


def save_part(path: str, stage: str, update: int, trainer: DDPPOTrainer,
              reward_trend: List[Dict], t_accum: float) -> None:
    """Write the mid-training checkpoint atomically."""
    save_checkpoint(path, {"stage": stage, "update": update,
                           "trainer": trainer.checkpoint_state(),
                           "reward_trend": reward_trend, "t_accum": t_accum})


def restore_part(trainer: DDPPOTrainer, ck: Dict) -> None:
    trainer.load_checkpoint_state(ck["trainer"], SEED)


def train_stage(stage: str, trainer: DDPPOTrainer, n_updates: int, start: int,
                reward_trend: List[Dict], part: Optional[str], t_prev: float,
                t0: float) -> None:
    """Updates ``start + 1`` to ``n_updates`` (none where ``start`` has
    reached it), the reward trend every 10 and ``part`` written every
    PART_EVERY."""
    tag = "gps" if stage == "gps" else "tune"
    for update in range(start + 1, n_updates + 1):
        trainer.collect_rollout()
        trainer.update_agent()
        beat()
        if update % 10 == 0 or update == 1:
            r = mean_reward(trainer)
            reward_trend.append({"update": update, "stage": stage, "mean_ep_reward": r})
            print(f"  [{tag} {update:3d}] mean_ep_reward {r:7.3f}", flush=True)
        if part and update % PART_EVERY == 0:
            save_part(part, stage, update, trainer, reward_trend,
                      t_prev + time.perf_counter() - t0)


def _policy_state(trainer: DDPPOTrainer) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}


def training_configs(num_steps: int, env_cfg: EnvConfig) -> Tuple[PPOConfig, EnvConfig]:
    """Both stages' PPO config and their training envs' config."""
    pcfg = PPOConfig(num_steps=num_steps, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4,
                     entropy_coef=0.01, use_normalized_advantage=True)
    # shorter training episodes: more of them end in a rollout
    train_cfg = EnvConfig(image_h=env_cfg.image_h, image_w=env_cfg.image_w,
                          max_episode_steps=60,
                          actuation_noise_multiplier=env_cfg.actuation_noise_multiplier,
                          room_radius_range=(3.0, 5.0))
    return pcfg, train_cfg


def train_policy(args, env_cfg: EnvConfig, ensemble: VOEnsemble, device):
    """GPS-train the policy at full width on depth and goal, then fine-tune
    it with the VO in the loop; returns (its state dict, seconds, reward
    trend).  ``--policy-cache`` is read where it exists, written at the end;
    its ``.part`` file is written every PART_EVERY updates and when the GPS
    stage ends, and resumed from."""
    if args.policy_cache and os.path.isfile(args.policy_cache):
        c = load_checkpoint(args.policy_cache)
        print(f"loaded trained policy from {args.policy_cache}", flush=True)
        return c["state_dict"], c["t_policy"], c["reward_trend"]
    part = (args.policy_cache + ".part") if args.policy_cache else None
    ck = None
    if part and os.path.isfile(part):
        ck = load_checkpoint(part)
        print(f"resuming policy training: stage={ck['stage']} update={ck['update']} "
              f"from {part}", flush=True)

    h, w = env_cfg.image_h, env_cfg.image_w
    pcfg, train_cfg = training_configs(args.num_steps, env_cfg)
    t0 = time.perf_counter()
    t_prev = ck["t_accum"] if ck else 0.0
    reward_trend = list(ck["reward_trend"]) if ck else []

    if ck and ck["stage"] in ("gps_done", "tune_vo"):
        state = policy_state_dict_from_container(ck["trainer"])
    else:
        envs = DepthGoalEnvs(make_scripted_vector_env(train_cfg, args.train_envs, seed=0))
        trainer = DDPPOTrainer(model=make_policy(env_cfg), ppo_cfg=pcfg, envs=envs,
                               device=device, total_updates=args.gps_updates)
        start = 0
        if ck and ck["stage"] == "gps":
            restore_part(trainer, ck)
            start = ck["update"]
        print(f"\nGPS-training the policy: {args.gps_updates} updates x {args.num_steps} steps "
              f"x {args.train_envs} envs at {w}x{h} (from update {start}) ...", flush=True)
        train_stage("gps", trainer, args.gps_updates, start, reward_trend, part, t_prev, t0)
        state = _policy_state(trainer)
        if part:
            save_part(part, "gps_done", 0, trainer, reward_trend,
                      t_prev + time.perf_counter() - t0)
        envs.close()

    if args.tune_updates > 0:
        # the VO in the loop: the policy trains on the goals deployment feeds it
        envs2 = make_scripted_vector_env(train_cfg, args.train_envs, seed=100)
        tuner = DDPPOTrainer(model=make_policy(env_cfg), ppo_cfg=pcfg, envs=envs2,
                             device=device, state_dict=state, vo_ensemble=ensemble,
                             generator=torch.Generator(device=device).manual_seed(1),
                             total_updates=args.tune_updates)
        start = 0
        if ck and ck["stage"] == "tune_vo":
            restore_part(tuner, ck)
            start = ck["update"]
        print(f"\nVO-tuning the policy: {args.tune_updates} updates (from update {start}) ...",
              flush=True)
        train_stage("tune_vo", tuner, args.tune_updates, start, reward_trend, part, t_prev, t0)
        state = _policy_state(tuner)
        envs2.close()

    t_policy = t_prev + time.perf_counter() - t0
    if args.policy_cache:
        save_checkpoint(args.policy_cache, {"state_dict": state, "t_policy": t_policy,
                                            "reward_trend": reward_trend})
        print(f"cached trained policy to {args.policy_cache}", flush=True)
        if part and os.path.isfile(part):
            os.remove(part)
    return state, t_policy, reward_trend


# -- the rows --------------------------------------------------------------------


def run_row(name: str, *, model, ensemble: Optional[VOEnsemble], env_cfg: EnvConfig,
            envs_n: int, episodes: int, device, rng_seed: int = 3,
            env_seed: int = 777) -> Dict:
    """One ladder row over a fresh shm env farm (the same seeds every row):
    its wall clock, aggregates, per-episode percentiles, loop steps,
    distinct episodes and ``bin_counts`` launches, each count checked."""
    dev = resolve_device(device)
    envs = ShmVectorEnv(env_cfg, envs_n, seed=env_seed)
    try:
        counted = CountedSteps(envs)
        ev = Evaluator(model=model, envs=counted, vo_ensemble=ensemble, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(rng_seed))
        t0 = time.perf_counter()

        def progress(k, _result):
            beat()
            if k % 100 == 0 or k == episodes:
                el = time.perf_counter() - t0
                print(f"  [{name}] {k}/{episodes} | {el / 60:.1f} min | "
                      f"proj {el / k * episodes / 60:.1f} min", flush=True)

        print(f"\n[{name}] evaluating {episodes} episodes over {envs_n} shm envs ...",
              flush=True)
        topdown_kernels.reset_launch_counts()
        agg = ev.run(episodes, log_fn=progress)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_min = (time.perf_counter() - t0) / 60
    finally:
        envs.close()
    launches = topdown_kernels.launch_counts["bin_counts"]
    distinct = len(set(ev.episode_keys))
    row = {"wall_clock_min": wall_min, "metrics": {k: float(v) for k, v in agg.items()},
           "loop_steps": counted.calls, "distinct_episodes": distinct,
           "bin_counts_launches": launches if dev.type == "cuda" else None}
    for field in ("vo_pred_std_mean", "drift_mean", "steps"):
        vals = np.asarray([getattr(r, field) for r in ev.results], np.float64)
        vals = vals[np.isfinite(vals)]
        if vals.size:
            row[f"{field}_pcts"] = {p: float(np.percentile(vals, p)) for p in (5, 25, 50, 75, 95)}
    if agg["episodes"] != episodes or len(ev.results) != episodes or distinct != episodes:
        raise AssertionError(f"[{name}] expected {episodes} distinct episodes: the evaluator "
                             f"counted {agg['episodes']} ({distinct} distinct keys)")
    want = 0 if ensemble is None else counted.calls + 1
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"[{name}] bin_counts launched {launches} times over "
                             f"{counted.calls} loop steps; expected {want}")
    print(f"[{name}] {wall_min:.2f} min | success {agg['success']:.3f} | softspl "
          f"{agg['softspl']:.3f} | spl {agg['spl']:.3f} | dist {agg['distance_to_goal']:.3f}",
          flush=True)
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=994)
    ap.add_argument("--rnd-episodes", type=int, default=256,
                    help="episodes for the rnd-mode row (0 skips it)")
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--pairs", type=int, default=6000)
    ap.add_argument("--eval-pairs", type=int, default=384)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--gps-updates", type=int, default=150)
    ap.add_argument("--tune-updates", type=int, default=40)
    ap.add_argument("--train-envs", type=int, default=16)
    ap.add_argument("--num-steps", type=int, default=64)
    ap.add_argument("--max-episode-steps", type=int, default=120)
    ap.add_argument("--skip-greedy", action="store_true")
    ap.add_argument("--vo-cache", default=None)
    ap.add_argument("--policy-cache", default=None)
    ap.add_argument("--out", default="EVAL_994_LADDER_torch.json")
    ap.add_argument("--watchdog", type=int, default=1200,
                    help="exit(3) after this many seconds without progress (0 disables); "
                         "an outer retry loop resumes from the caches and the journal")
    ap.add_argument("--device", default=None, help="default: the card")
    return ap


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    faulthandler.register(signal.SIGUSR1)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the port's parity convention; bf16 is untouched
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env_cfg = EnvConfig(max_episode_steps=args.max_episode_steps, actuation_noise_multiplier=0.5)
    h, w = env_cfg.image_h, env_cfg.image_w
    icfg = make_icfg(env_cfg)

    vo_states, t_vo = train_vo(args, env_cfg, dev)
    # armed after the VO stage, which may hold the host a long while
    start_watchdog(args.watchdog)
    beat()
    state, t_policy, reward_trend = train_policy(args, env_cfg,
                                                 make_ensemble(icfg, vo_states, dev), dev)
    policy = make_policy(env_cfg)
    policy.load_state_dict(state, strict=True)

    journal = args.out + ".rows.json"
    rows: Dict[str, Dict] = {}
    if os.path.isfile(journal):
        with open(journal) as f:
            rows = json.load(f)
        print(f"journal: {sorted(rows)} rows already done", flush=True)

    def do_row(name, **kw):
        if name in rows:
            return
        beat()
        rows[name] = run_row(name, env_cfg=env_cfg, envs_n=args.envs, device=dev, **kw)
        with open(journal + ".tmp", "w") as f:
            json.dump(rows, f)
        os.replace(journal + ".tmp", journal)

    # the deployment condition first: it measures cold, as the reference's run
    do_row("policy_vo", model=policy, ensemble=make_ensemble(icfg, vo_states, dev),
           episodes=args.episodes)
    do_row("oracle_gps", model=policy, ensemble=None, episodes=args.episodes)
    if not args.skip_greedy:
        do_row("greedy_vo", model=GreedyGoalPolicy(env_cfg.turn_angle_deg,
                                                   env_cfg.success_distance),
               ensemble=make_ensemble(icfg, vo_states, dev), episodes=args.episodes)
    if args.rnd_episodes > 0:
        do_row("policy_vo_rnd", model=policy,
               ensemble=make_ensemble(dataclasses.replace(icfg, mode="rnd", rnd_mode_n=10),
                                      vo_states, dev),
               episodes=args.rnd_episodes)

    pv, og = rows["policy_vo"]["metrics"], rows["oracle_gps"]["metrics"]
    out = {
        "protocol": ("exact-episode-set quality ladder; rows share episode set (env farm seed "
                     f"777), VO weights, policy weights, {args.max_episode_steps}-step cap, "
                     f"actuation noise 0.5, scripted world, {w}x{h}"),
        "episodes": args.episodes,
        "envs": args.envs,
        "resolution": [h, w],
        "policy": ("PointNavActorCritic resnet18+LSTMx2 (bf16 compute), GPS-trained "
                   f"{args.gps_updates} updates then VO-tuned {args.tune_updates} (TRAIN.md "
                   "stages; rl_tune_with_vo pipeline)"),
        "vo": f"3 trained experts, {args.pairs} pairs x {args.epochs} epochs, bf16",
        "train_cost_s": {"vo": t_vo, "policy": t_policy},
        "reward_trend": reward_trend,
        "rows": rows,
        "gps_vs_vo_gap": {k: float(og[k] - pv[k]) for k in ("success", "softspl", "spl")},
        "north_star": {
            "policy_vo_wall_clock_min": rows["policy_vo"]["wall_clock_min"],
            "target_min": TARGET_MIN,
            "vs_reference_min": REFERENCE_EVAL_MIN,
            "speedup_vs_reference": REFERENCE_EVAL_MIN / rows["policy_vo"]["wall_clock_min"],
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "torch": torch.__version__,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    if os.path.isfile(journal):
        os.remove(journal)
    print(f"\nwrote {args.out}")
    print(f"north star: policy_vo {rows['policy_vo']['wall_clock_min']:.2f} min (target "
          f"{TARGET_MIN:.0f}) | GPS-vs-VO success gap {out['gps_vs_vo_gap']['success']:+.3f}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
