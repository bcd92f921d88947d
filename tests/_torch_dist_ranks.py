"""Rank functions of tests/test_torch_port_dist.py.

They run in processes spawned by ``pointnav_vo_tpu_torch.parallel.dist.
spawn``, which import this module by name: it imports torch and the port
only, so a rank starts without JAX.  Inputs arrive as numpy arrays; each
function returns every rank's results to rank 0 as numpy arrays.
"""

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar
from pointnav_vo_tpu_torch.parallel.dist import shard_slice
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl import ppo as tppo
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.rl.rollout import RolloutStorage
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig


def _np(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def rollout_block(d, block):
    """The env block ``block`` of a numpy rollout dict (hidden states carry
    the env axis third)."""
    out = {}
    for k, v in d.items():
        if k == "observations":
            out[k] = {o: a[:, block] for o, a in v.items()}
        else:
            out[k] = v[:, :, block] if k == "hidden_states" else v[:, block]
    return out


def storage(d):
    return RolloutStorage(**{
        k: ({o: torch.from_numpy(a.copy()) for o, a in v.items()} if k == "observations"
            else torch.from_numpy(v.copy())) for k, v in d.items()})


def ppo_run(group, policy_kw, state_dict, cfg_kw, rollout, order, device="cpu"):
    """One PPO update of a fresh policy on ``rollout`` (this rank's block of
    it in a group) in ``order``, on ``device``: (parameters, stats)."""
    policy = PointNavActorCritic(**policy_kw)
    policy.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    policy.to(device)
    cfg = tppo.PPOConfig(**cfg_kw)
    if group is not None:
        n = rollout["actions"].shape[1]
        rollout = rollout_block(rollout, shard_slice(n, group.rank, group.world))
    opt = tppo.make_optimizer(policy.parameters(), cfg, group=group)
    stats = tppo.ppo_update(policy, cfg, opt, storage(rollout).to(device),
                            order=torch.from_numpy(order))
    return _np(dict(policy.named_parameters())), {k: float(v) for k, v in stats.items()}


def vo_step(group, icfg_kw, tcfg_kw, state_dicts, batch):
    """One VO train step on the global ``batch``: (metrics, experts' state
    dicts, experts' gradients)."""
    engine = tengine.VORegressionEngine(
        VOInferenceConfig(**icfg_kw), tengine.VOTrainConfig(**tcfg_kw), device="cpu",
        state_dicts=[{k: torch.from_numpy(v) for k, v in sd.items()} for sd in state_dicts],
        group=group)
    metrics = engine.train_step(FramePairBatch(**batch))
    return (_np(metrics), [_np(m.state_dict()) for m in engine.experts],
            [_np({k: p.grad for k, p in m.named_parameters()}) for m in engine.experts])


def collectives(group, data):
    """The advantage statistic, the whitening update, one PPO update and
    one VO train step, each on this rank's block of the same global
    inputs; rank 0 returns every rank's results."""
    out = {}
    adv = data["adv"]
    block = shard_slice(adv.shape[1], group.rank, group.world)
    out["mean_var"] = [float(v) for v in tppo.distributed_mean_and_var(
        torch.from_numpy(adv[:, block]), group)]

    rmv = RunningMeanAndVar(data["rmv_x"].shape[1])
    for k in ("_mean", "_var", "_count"):
        getattr(rmv, k).copy_(torch.from_numpy(data["rmv_init"][k]))
    rmv.group = group
    block = shard_slice(data["rmv_x"].shape[0], group.rank, group.world)
    rmv(torch.from_numpy(data["rmv_x"][block]), update_stats=True,
        stats_mask=torch.from_numpy(data["rmv_mask"][block]))
    out["rmv"] = _np(dict(rmv.named_buffers()))

    out["ppo"] = ppo_run(group, data["policy_kw"], data["policy"], data["ppo_cfg"],
                         data["rollout"], data["orders"][group.rank])
    out["vo"] = vo_step(group, data["vo_icfg"], data["vo_tcfg"], data["vo_experts"],
                        data["vo_batch"])
    return group.all_gather_object(out)


class Greedy(nn.Module):
    """Torch twin of tests/test_eval.py::GreedyGoalPolicy: turn toward the
    VO-propagated goal, else forward, STOP when close."""

    def __init__(self, turn_angle_deg=30.0, success_distance=0.36):
        super().__init__()
        self.half = math.radians(turn_angle_deg) / 2
        self.success_distance = success_distance

    def initial_hidden(self, num_envs, device=None):
        return torch.zeros(1, num_envs, 1, device=device)

    def forward(self, observations, hidden, prev_actions, masks):
        goal = observations["pointgoal_with_gps_compass"]
        rho, bearing = goal[:, 0], -goal[:, 1]
        turn = torch.where(bearing < 0, 2, 3)
        action = torch.where(rho < self.success_distance, 0,
                             torch.where(bearing.abs() > self.half, turn, 1))
        logits = torch.nn.functional.one_hot(action, 4).float() * 100.0
        return logits, torch.zeros(goal.shape[0], 1), hidden


def evaluate(group, case, device="cpu"):
    """``Evaluator.run`` with the greedy policy over this rank's block of
    ``case["n_envs"]`` scripted envs (the first ``case["one_episode_envs"]``
    of them holding one episode each), on ``device``: (aggregates,
    per-episode records, episode keys)."""
    cfg = tenvs.EnvConfig(**case["env_kw"])
    n, seed = case["n_envs"], case["seed"]
    block = range(n) if group is None else range(n)[shard_slice(n, group.rank, group.world)]
    envs = tenvs.make_scripted_vector_env(cfg, len(block), seed=seed + block.start)
    for env, i in zip(envs.envs, block):
        if i < case["one_episode_envs"]:
            env.number_of_episodes = 1
    ens = VOEnsemble(VOInferenceConfig(**case["icfg"]),
                     [{k: torch.from_numpy(v) for k, v in sd.items()}
                      for sd in case["experts"]], device=device)
    ev = Evaluator(model=Greedy(cfg.turn_angle_deg, cfg.success_distance), envs=envs,
                   vo_ensemble=ens, device=device, group=group)
    agg = ev.run(case["episodes"])
    return agg, [dataclasses.asdict(r) for r in ev.results], ev.episode_keys


def evaluate_cases(group, cases):
    return [evaluate(group, c) for c in cases]


def cards(group, data):
    """Ranks on cards of their own (NCCL): the group's collectives, one PPO
    update and the eval on this rank's blocks, and on rank 0 the same
    update and eval as one rank; rank 0 returns every rank's results.
    TF32 is off, as in the repo's other parity runs on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    mean = torch.arange(4.0, device=dev) + group.rank
    group.all_reduce_([mean], "mean")
    torch.manual_seed(group.rank)  # a different start on every rank
    linear = nn.Linear(3, 2).to(dev)
    group.broadcast_module(linear)
    out = {"backend": group.backend, "device": str(dev), "mean": mean.cpu().tolist(),
           "linear": _np(linear.state_dict()), "objects": group.all_gather_object(group.rank),
           "broadcast": group.broadcast_object(group.rank), "any": group.any(group.rank == 1)}
    ppo = (data["policy_kw"], data["policy"], data["ppo_cfg"], data["rollout"])
    out["ppo"] = ppo_run(group, *ppo, data["orders"][group.rank], device=dev)
    out["eval"] = evaluate(group, data["eval"], device=dev)
    if group.rank == 0:
        out["ppo_one"] = ppo_run(None, *ppo, data["union"], device=dev)
        out["eval_one"] = evaluate(None, data["eval"], device=dev)
    return group.all_gather_object(out)


def fail_on_rank_1(group):
    """Rank 1 raises while rank 0 waits in a collective."""
    if group.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    group.all_gather_object(np.zeros(3))
