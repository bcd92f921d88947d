"""The eval step's pipeline at Challenge scale on one card (counterpart of
``examples/full_eval_benchmark.py``).

    python -m pointnav_vo_tpu_torch.examples.full_eval_benchmark [--envs 32] [--steps 200]
        [--device cpu]

The reference's headline cost is the 994-episode Gibson-val evaluation:
about 4.5 h on its GPU (a GTX 1080 Ti; its README), spent in batch-1 VO
preprocessing and forwards and in serial simulator steps.  This script
runs what the eval loop runs each step, at 341x192, batched over N
scripted envs:

1. the policy (ResNet18 + 2-layer LSTM actor-critic on depth, bf16
   compute) acts deterministically;
2. the envs step on the host with the greedy goal rule;
3. the new frame ships as uint8 rgb and float16 depth (habitat's dtypes;
   the previous frame's features stay cached on the device);
4. VO: ``VOEnsemble.step`` (the new frame's features, ``bin_counts``
   once, and each sample's own expert, bf16);
5. the goal is dead-reckoned (``propagate_goal``) through the ground-truth
   deltas, so the constant weights do not steer the episodes.

Every weight is 0.01 (the JAX script's ``zeros_like_shapes``).  Each
phase's host time (``act``, ``vo``, ``env``, ``ship``) is taken around
work that ends in a synchronize.  Then the chained step: :data:`CHAIN`
steps of act, VO and ``propagate_goal`` on the VO deltas launched back to
back with no host read between them, timed by CUDA events with one
synchronize at the end (the JAX script's chained jit).  It gives the
device-bound projection for 994 episodes x 250 steps, and its share over
``torch.cuda.device_count()`` cards (the evaluator shards episodes over
ranks, ``Evaluator(group=...)``).  On the CPU the chained time is not
measured.  ``bin_counts`` launches exactly once for the first frame, once
a loop step and :data:`CHAIN` times a chained call; on the card the count
is checked.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic, mode_action
from pointnav_vo_tpu_torch.ops import geometry as geo
from pointnav_vo_tpu_torch.ops import topdown_kernels
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.trainer import GOAL_KEY, propagate_goal
from pointnav_vo_tpu_torch.vo.ensemble import (VOEnsemble, VOInferenceConfig,
                                               frame_features_packed)

REFERENCE_EVAL_HOURS = 4.5
REFERENCE_STEPS_PER_EP = 250
EPISODES = 994
CHAIN = 8  # steps of one chained call
CONSTANT = 0.01  # every weight, as the JAX script's zeros_like_shapes


def constant_weights_(module: torch.nn.Module, value: float = CONSTANT) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to ``value``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.fill_(value)
    return module


def ship(obs: Dict[str, np.ndarray], device) -> tuple:
    """Host to device in habitat's dtypes: uint8 rgb, float16 depth."""
    return (torch.from_numpy(obs["rgb"].astype(np.uint8)).to(device),
            torch.from_numpy(obs["depth"].astype(np.float16)).to(device))


def greedy_actions(goal_polar: np.ndarray, env_cfg: EnvConfig) -> np.ndarray:
    """STOP inside the success radius, else turn toward the goal when it is
    off by more than half a turn, else forward."""
    half_turn = np.radians(env_cfg.turn_angle_deg) / 2
    bearing = -goal_polar[:, 1]
    return np.where(goal_polar[:, 0] < env_cfg.success_distance, 0,
                    np.where(np.abs(bearing) > half_turn, np.where(bearing < 0, 2, 3), 1)
                    ).astype(np.int32)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def eval_loop(envs, env_cfg: EnvConfig, ensemble: VOEnsemble, policy, steps: int, device,
              trace: Optional[List[dict]] = None) -> dict:
    """``steps`` eval steps over ``envs``; each step's host copies of the
    policy's logits, the env actions, the VO deltas and the goal go to
    ``trace`` where it is given (after the step's timing).  Returns the
    phase times, the finished episodes and the state the chained step
    starts from."""
    n = envs.num_envs
    obs = envs.reset()
    rgb, depth = ship(obs, device)
    goal_polar = torch.from_numpy(obs[GOAL_KEY]).to(device)
    hidden = policy.initial_hidden(n, device)
    prev_actions = torch.zeros((n, 1), dtype=torch.long, device=device)
    masks = torch.zeros((n, 1), device=device)
    goal_cart = geo.pointgoal_polar2cartesian(goal_polar)
    feats = frame_features_packed(rgb, depth, ensemble.cfg)
    timing = {"act": 0.0, "vo": 0.0, "env": 0.0, "ship": 0.0}
    episodes_done = 0
    actions = np.zeros(n, np.int32)
    t_all = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        # f16 depth goes straight in: the encoder casts it to its compute dtype
        logits, _value, hidden = policy({"depth": depth, GOAL_KEY: goal_polar}, hidden,
                                        prev_actions, masks)
        pol_action = mode_action(logits)
        _sync(device)
        timing["act"] += time.perf_counter() - t0

        goal = goal_polar.cpu().numpy()
        actions = greedy_actions(goal, env_cfg)
        t0 = time.perf_counter()
        new_obs, _rewards, dones, infos = envs.step(actions)
        timing["env"] += time.perf_counter() - t0
        episodes_done += int(dones.sum())

        t0 = time.perf_counter()
        new_rgb, new_depth = ship(new_obs, device)
        _sync(device)
        timing["ship"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        delta, _std, feats = ensemble.step(feats, new_rgb, new_depth, actions)
        gt = torch.from_numpy(np.stack([i["gt_delta"] for i in infos])).to(device)
        reset = torch.from_numpy(dones.astype(np.float32)).to(device)[:, None]
        sensor = torch.from_numpy(new_obs[GOAL_KEY]).to(device)
        goal_cart, goal_polar = propagate_goal(goal_cart, gt, reset, sensor)
        _sync(device)
        timing["vo"] += time.perf_counter() - t0

        if trace is not None:
            trace.append({"logits": logits.float().cpu().numpy(),
                          "policy_action": pol_action.cpu().numpy()[:, 0],
                          "actions": actions.copy(), "delta": delta.cpu().numpy(),
                          "goal_polar": goal_polar.cpu().numpy(), "dones": dones.copy()})
        rgb, depth = new_rgb, new_depth
        prev_actions = torch.from_numpy(actions.astype(np.int64)).to(device)[:, None]
        masks = torch.from_numpy(1.0 - dones.astype(np.float32)).to(device)[:, None]
    return {"timing": timing, "wall_s": time.perf_counter() - t_all,
            "episodes_done": episodes_done,
            "state": (feats, rgb, depth, goal_polar, goal_cart, hidden, prev_actions, masks),
            "actions": actions}


@torch.no_grad()
def chained_step(ensemble: VOEnsemble, policy, state, actions_np, chain: int = CHAIN):
    """``chain`` steps of act, VO on the held frame and ``propagate_goal``
    on the VO deltas, launched back to back with no host read; the experts'
    rows come from the host actions ``actions_np`` (the JAX script's
    static buckets).  Returns the accumulator sum(delta) + sum(action)
    over the steps, a device scalar."""
    feats, rgb, depth, goal_polar, goal_cart, hidden, prev_a, masks = state
    acc = torch.zeros((), dtype=torch.float32, device=rgb.device)
    for _ in range(chain):
        logits, _value, hidden = policy({"depth": depth, GOAL_KEY: goal_polar}, hidden,
                                        prev_a, masks)
        a = mode_action(logits)
        delta, _std, feats = ensemble.step(feats, rgb, depth, actions_np)
        goal_cart, goal_polar = propagate_goal(goal_cart, delta, masks * 0.0, goal_polar)
        acc = acc + delta.sum() + a.float().sum()
    return acc


def time_chained(ensemble, policy, state, actions_np, device, chain: int = CHAIN):
    """A warm-up chained call, then one timed by CUDA events with one
    synchronize at the end: (accumulator, ms a step or None on the CPU,
    chained calls made)."""
    acc = chained_step(ensemble, policy, state, actions_np, chain)
    if device.type != "cuda":
        return float(acc), None, 1
    _sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    acc = chained_step(ensemble, policy, state, actions_np, chain)
    end.record()
    torch.cuda.synchronize(device)
    return float(acc), start.elapsed_time(end) / chain, 2


def run(ensemble: VOEnsemble, policy, envs, env_cfg: EnvConfig, steps: int, device,
        trace: Optional[List[dict]] = None) -> dict:
    """The loop, then the chained step; the record the script prints.  On
    the card ``bin_counts`` must launch exactly ``1 + steps + CHAIN x
    chained calls`` times."""
    before = topdown_kernels.launch_counts["bin_counts"]
    loop = eval_loop(envs, env_cfg, ensemble, policy, steps, device, trace)
    acc, chain_ms, calls = time_chained(ensemble, policy, loop["state"], loop["actions"],
                                        device)
    expected = 1 + steps + CHAIN * calls
    launches = None
    if device.type == "cuda":
        launches = topdown_kernels.launch_counts["bin_counts"] - before
        if launches != expected:
            raise AssertionError(f"bin_counts launched {launches} times; expected "
                                 f"1 + {steps} steps + {CHAIN} x {calls} chained = {expected}")
    n = envs.num_envs
    return {"envs": n, "steps": steps, "env_steps": steps * n, "wall_s": loop["wall_s"],
            "episodes_done": loop["episodes_done"],
            "per_step_ms": {k: v / steps * 1e3 for k, v in loop["timing"].items()},
            "chain_acc": acc, "chain_ms": chain_ms, "chained_calls": calls,
            "bin_counts_launches": launches, "expected_launches": expected}


def build(n_envs: int, device, env_cfg: Optional[EnvConfig] = None):
    """The script's configuration: full-width scripted envs (Challenge
    noise on, seed 0), three bf16 experts and the bf16 policy, every
    weight :data:`CONSTANT`."""
    env_cfg = env_cfg or EnvConfig()
    envs = make_scripted_vector_env(env_cfg, n_envs, seed=0)
    vo_cfg = VOInferenceConfig(precision="bf16", vis_size_h=env_cfg.image_h,
                               vis_size_w=env_cfg.image_w)
    ensemble = VOEnsemble(vo_cfg, experts=[constant_weights_(vo_cfg.make_model())
                                           for _ in range(3)], device=device)
    policy = constant_weights_(PointNavActorCritic(
        image_size=(env_cfg.image_h, env_cfg.image_w), compute_dtype=torch.bfloat16))
    return envs, env_cfg, ensemble, policy.to(device).eval()


def report(rec: dict, cards: int) -> List[str]:
    """The JAX script's lines; the last one projects over ``cards`` cards."""
    n, p = rec["envs"], rec["per_step_ms"]
    total = EPISODES * REFERENCE_STEPS_PER_EP
    ref_min = REFERENCE_EVAL_HOURS * 60
    e2e_min = total / (rec["env_steps"] / rec["wall_s"]) / 60
    lines = [f"envs={n} steps={rec['steps']} (= {rec['env_steps']} env-steps), wall "
             f"{rec['wall_s']:.1f}s, {rec['episodes_done']} episodes finished",
             f"per-batched-step (loop, host clock, synchronized): act {p['act']:.1f} ms | "
             f"vo+goal {p['vo']:.1f} ms | ship {p['ship']:.1f} ms | env(host) {p['env']:.1f} ms"]
    if rec["chain_ms"] is None:
        lines += ["device-only fused step (chained, one sync): not measured (CPU run)",
                  f"994-episode projections: device-bound not measured; end-to-end on this "
                  f"host {e2e_min:.1f} min"]
        return lines
    dev_min = total / n * rec["chain_ms"] / 1e3 / 60
    lines += [f"device-only fused step (chained, one sync): {rec['chain_ms']:.1f} ms at {n} envs",
              f"994-episode projections: device-bound {dev_min:.1f} min "
              f"({ref_min / dev_min:.1f}x vs the reference's 270 min on its GPU); end-to-end "
              f"on this host {e2e_min:.1f} min",
              f"projection over {cards} card(s) (episodes sharded over ranks, a projection): "
              f"{dev_min / cards:.1f} min device-bound "
              f"({ref_min / (dev_min / cards):.0f}x vs the reference's GPU)"]
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    envs, env_cfg, ensemble, policy = build(args.envs, device)
    try:
        rec = run(ensemble, policy, envs, env_cfg, args.steps, device)
    finally:
        envs.close()
    for line in report(rec, torch.cuda.device_count() if device.type == "cuda" else 1):
        print(line)
    return rec


if __name__ == "__main__":
    main()
