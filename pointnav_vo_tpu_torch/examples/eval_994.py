"""The 994-episode protocol on one card (counterpart of ``examples/eval_994.py``).

    python -m pointnav_vo_tpu_torch.examples.eval_994 --out EVAL_994_torch.json
    python -m pointnav_vo_tpu_torch.examples.eval_994 --episodes 64 --pairs 1000 \\
        --epochs 1 --out smoke.json                                   # smoke size
    python -m pointnav_vo_tpu_torch.examples.eval_994 --backend sync --out sync.json

Phase 1 trains the three VO experts at full width (341x192) on scripted
frame pairs held in memory (:func:`scripted_pairs`; no HDF5): the
oracle goal follower's pairs under actuation noise 0.5, the forward stage
on its forward pairs, then the joint turn stage (inverse loss over twins)
on its turns, ``--epochs`` epochs each at batch 128, in ``--precision``.
Its cost is reported apart from the eval's.

Phase 2 runs one ``Evaluator.run(--episodes)`` over ``--envs`` scripted
envs, by default on the shm env farm (``native/shm_env.py``: one forked
worker process per env, seed 777), with ``--backend sync`` in this process,
with det VO through the fused step in ``--precision`` with a
``--cache-dtype`` feature cache, a goal-greedy policy that acts on the
dead-reckoned goal only (:class:`GreedyGoalPolicy`) and a 120-step cap.
``PNVO_EVAL_ASYNC=1`` overlaps the envs' simulation with the evaluator's
host work.  It checks that the evaluator counted exactly ``--episodes``
distinct episodes, that each env finished at least its budget and, on the
card, that ``bin_counts`` launched exactly once per loop step plus once
for the first frame.  The record, with the fields of ``EVAL_994.json``
and the backend, goes to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, resolve_device
from pointnav_vo_tpu_torch.ops import topdown_kernels
from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.eval import Evaluator, episode_budgets
from pointnav_vo_tpu_torch.vo.dataset import MemoryFramePairs, iter_rollout_entries
from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

REFERENCE_EVAL_MIN = 4.5 * 60  # the reference's 994 episodes (its README)
LOGIT_SCALE = 100.0


class GreedyGoalPolicy(nn.Module):
    """Navigates by the VO-propagated polar goal only: STOP inside the
    success distance, a turn toward the goal while its bearing is over half
    a turn, else forward.  Its logits are one-hot x 100, so the mode action
    is the rule's."""

    num_packed_hidden = 1
    hidden_size = 1

    def __init__(self, turn_angle_deg: float = 30.0, success_distance: float = 0.36):
        super().__init__()
        self.turn_angle_deg = turn_angle_deg
        self.success_distance = success_distance

    def initial_hidden(self, num_envs: int, device=None) -> torch.Tensor:
        return torch.zeros(1, num_envs, 1, device=device)

    def forward(self, observations, hidden, prev_actions, masks):
        goal = observations["pointgoal_with_gps_compass"]
        rho, bearing = goal[:, 0], -goal[:, 1]
        half = float(np.radians(self.turn_angle_deg) / 2)
        turn = torch.where(bearing < 0, TURN_LEFT, TURN_RIGHT)
        action = torch.where(rho < self.success_distance, 0,
                             torch.where(bearing.abs() > half, turn, MOVE_FORWARD))
        logits = nn.functional.one_hot(action, 4).float() * LOGIT_SCALE
        return logits, goal.new_zeros((goal.shape[0], 1)), hidden


def scripted_pairs(n: int, env_cfg: EnvConfig, seed: int) -> MemoryFramePairs:
    """The oracle follower's ``n`` frame pairs of the scripted world, held in
    memory: the entries the JAX package's ``generate_scripted_dataset(path,
    n, env_cfg, seed=seed)`` writes, as its reader reads them (the card's
    machine has no ``h5py``)."""
    return MemoryFramePairs.from_rollout(iter_rollout_entries(n, env_cfg=env_cfg, seed=seed),
                                         env_cfg.image_h, env_cfg.image_w)


def train_experts(icfg: VOInferenceConfig, env_cfg: EnvConfig, pairs: int, eval_pairs: int,
                  epochs: int, batch: int, device, log=print) -> Tuple[list, Dict]:
    """The forward expert and the joint left/right experts, trained on the
    oracle follower's pairs (seed 0; the eval pairs' seed 99999, none where
    ``eval_pairs`` is 0); returns ([forward, left, right], record)."""
    t0 = time.perf_counter()
    train = scripted_pairs(pairs, env_cfg, seed=0)
    evalset = scripted_pairs(eval_pairs, env_cfg, seed=99_999) if eval_pairs else None
    t_data = time.perf_counter() - t0
    log(f"{len(train)} + {eval_pairs} frame pairs at {env_cfg.image_w}x{env_cfg.image_h} "
        f"in {t_data:.1f} s")

    train_icfg = dataclasses.replace(icfg, cache_dtype="native")  # training packs no cache
    stages = {
        "forward": (VOTrainConfig(batch_size=batch, epochs=epochs, action_type=MOVE_FORWARD,
                                  lr=2.5e-4), (MOVE_FORWARD,), False),
        "joint": (VOTrainConfig(batch_size=batch, epochs=epochs,
                                action_type=(TURN_LEFT, TURN_RIGHT),
                                geo_invariance_types=("inverse_joint_train",), lr=1.5e-4),
                  (TURN_LEFT, TURN_RIGHT), True),
    }
    t0 = time.perf_counter()
    experts, record = [], {"dataset_gen_s": t_data, "pairs": pairs, "epochs": epochs}
    for name, (tcfg, actions, twins) in stages.items():
        engine = VORegressionEngine(
            train_icfg, tcfg, train.subset(actions, twins),
            evalset.subset(actions, twins) if evalset else None, device=device)
        losses = [engine.train_epoch()["mean_total_loss"] for _ in range(epochs)]
        record[f"{name}_epoch_losses"] = losses
        msg = (f"[{name}] {engine.train_reader.num_samples()} train samples, epoch losses "
               + " ".join(f"{x:.5f}" for x in losses))
        if evalset:
            final = engine.evaluate()
            record[f"{name}_eval"] = {k: float(v) for k, v in final.items()}
            msg += (f"; eval abs (dx, dz, dyaw) = ({final['abs_diff_dx']:.4f}, "
                    f"{final['abs_diff_dz']:.4f}, {final['abs_diff_dyaw']:.4f})")
        log(msg)
        experts.extend(engine.experts)
    record["train_s"] = time.perf_counter() - t0
    return experts, record


BACKENDS = {"shm": "shm process workers (scripted world)",
            "sync": "sync scripted envs in one process"}


class CountedSteps:
    """A vector env whose loop steps (``step``, or ``step_async`` then
    ``step_wait``) are counted, with each env's finished episodes."""

    def __init__(self, envs):
        self.envs = envs
        self.num_envs = envs.num_envs
        self.calls = 0
        self.finished = np.zeros(envs.num_envs, np.int64)

    def reset(self):
        return self.envs.reset()

    def number_of_episodes(self):
        return self.envs.number_of_episodes()

    def _count(self, out):
        self.calls += 1
        self.finished += out[2]
        return out

    def step(self, actions):
        return self._count(self.envs.step(actions))

    def step_async(self, actions):
        self.envs.step_async(actions)

    def step_wait(self):
        return self._count(self.envs.step_wait())


def make_envs(env_cfg: EnvConfig, n_envs: int, backend: str):
    if backend == "shm":
        return ShmVectorEnv(env_cfg, n_envs, seed=777)
    if backend != "sync":
        raise ValueError(f"unknown backend {backend!r} (shm | sync)")
    return make_scripted_vector_env(env_cfg, n_envs, seed=777)


def run_protocol(ensemble: VOEnsemble, env_cfg: EnvConfig, episodes: int, n_envs: int,
                 device, backend: str = "shm", log=None) -> Dict:
    """One ``Evaluator.run(episodes)`` with the greedy policy over the
    ``backend``'s envs (``log`` sees the progress); checks the distinct
    episodes and, on the card, the launch count."""
    dev = resolve_device(device)
    envs = make_envs(env_cfg, n_envs, backend)
    try:
        budgets, _ = episode_budgets(episodes, n_envs, envs.number_of_episodes())
        counted = CountedSteps(envs)
        policy = GreedyGoalPolicy(env_cfg.turn_angle_deg, env_cfg.success_distance)
        ev = Evaluator(model=policy, envs=counted, vo_ensemble=ensemble, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))

        def progress(k, _result):
            if log and (k % 50 == 0 or k == episodes):
                el = time.perf_counter() - t0
                log(f"  {k}/{episodes} episodes | {el / 60:.2f} min | projected "
                    f"{el / k * episodes / 60:.2f} min")

        topdown_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        agg = ev.run(episodes, log_fn=progress)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
    finally:
        envs.close()
    launches = topdown_kernels.launch_counts["bin_counts"]
    distinct = len(set(ev.episode_keys))
    out = {"metrics": {k: float(v) for k, v in agg.items()}, "wall_s": wall_s,
           "loop_steps": counted.calls, "distinct_episodes": distinct,
           "bin_counts_launches": launches if dev.type == "cuda" else None}
    if (agg["episodes"] != episodes or len(ev.results) != episodes or distinct != episodes
            or (counted.finished < np.asarray(budgets)).any()):
        raise AssertionError(f"expected {episodes} distinct episodes: the evaluator counted "
                             f"{agg['episodes']} ({distinct} distinct keys); the envs "
                             f"finished {counted.finished.tolist()} against budgets {budgets}")
    if dev.type == "cuda" and launches != counted.calls + 1:
        raise AssertionError(f"bin_counts launched {launches} times over {counted.calls} "
                             "loop steps; expected steps + 1")
    return out


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=994)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--pairs", type=int, default=6000)
    ap.add_argument("--eval-pairs", type=int, default=384)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-episode-steps", type=int, default=120)
    ap.add_argument("--precision", choices=("fp32", "bf16"), default="bf16")
    ap.add_argument("--cache-dtype", choices=("native", "int8"), default="native")
    ap.add_argument("--backend", choices=sorted(BACKENDS), default="shm",
                    help="shm: one worker process per env (default); sync: in this process")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", required=True, help="the JSON record's path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":  # fp32 parity convention of the port; bf16 is untouched
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env_cfg = EnvConfig(max_episode_steps=args.max_episode_steps, actuation_noise_multiplier=0.5)
    icfg = VOInferenceConfig(vis_size_w=env_cfg.image_w, vis_size_h=env_cfg.image_h,
                             precision=args.precision, cache_dtype=args.cache_dtype)

    experts, train_record = train_experts(icfg, env_cfg, args.pairs, args.eval_pairs,
                                          args.epochs, args.batch, dev,
                                          log=lambda m: print(m, flush=True))
    ensemble = VOEnsemble(icfg, experts=experts, device=dev)
    overlap = os.environ.get("PNVO_EVAL_ASYNC", "0") == "1"
    print(f"evaluating {args.episodes} episodes over {args.envs} scripted envs "
          f"({BACKENDS[args.backend]}{', async overlap' if overlap else ''}) at "
          f"{env_cfg.image_w}x{env_cfg.image_h}, det VO in {args.precision}, "
          f"{args.cache_dtype} cache ...", flush=True)
    run = run_protocol(ensemble, env_cfg, args.episodes, args.envs, dev, args.backend,
                       log=lambda m: print(m, flush=True))
    agg = run["metrics"]
    out = {
        "protocol": "exact-episode-set (per-env budgets, distinct keys)",
        "env_step_protocol": "async overlap" if overlap else "synchronous",
        "episodes": args.episodes,
        "envs": args.envs,
        "backend": BACKENDS[args.backend],
        "host_cpus": os.cpu_count(),
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "resolution": [env_cfg.image_h, env_cfg.image_w],
        "max_episode_steps": args.max_episode_steps,
        "vo": f"det, fused step, 3 trained experts, {args.precision}",
        "precision": args.precision,
        "cache_dtype": args.cache_dtype,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
        "torch": torch.__version__,
        "eval_wall_clock_min": run["wall_s"] / 60,
        "vs_reference_min": REFERENCE_EVAL_MIN,
        "speedup_vs_reference": REFERENCE_EVAL_MIN / (run["wall_s"] / 60),
        "metrics": agg,
        "mean_episode_steps": agg["total_env_steps"] / args.episodes,
        "loop_steps": run["loop_steps"],
        "distinct_episodes": run["distinct_episodes"],
        "bin_counts_launches": run["bin_counts_launches"],
        "vo_train": train_record,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wall-clock {run['wall_s'] / 60:.2f} min for {args.episodes} episodes, "
          f"{run['loop_steps']} loop steps, {int(agg['total_env_steps'])} env steps, "
          f"bin_counts launches {run['bin_counts_launches']}")
    print(f"success {agg['success']:.3f} | spl {agg['spl']:.3f} | softspl "
          f"{agg['softspl']:.3f} | vo_l2 {agg.get('vo_l2_mean', float('nan')):.4f}")
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
