"""Clipped PPO (counterpart of ``rl/ppo.py``), one process.

- :func:`make_optimizer`: clip by global norm as optax does it (``g / norm *
  max_norm`` where the norm exceeds ``max_norm``), then Adam with ``eps``;
  the linear lr decay counts every minibatch step, as
  ``optax.linear_schedule`` inside the optimizer chain does.
- :func:`ppo_loss`: the clipped surrogate, the (clipped) value loss and the
  entropy bonus of one minibatch, split out so its gradients can be taken
  on their own.
- :func:`ppo_update`: ``ppo_epoch`` passes over the rollout in
  ``num_mini_batch`` minibatches of whole envs (each env's full ``[T]``
  sequence, its recurrent state from slot 0), in a given order of env
  indices or one drawn from a ``torch.Generator``.

Across processes (``torch.distributed``) is not ported yet:
:func:`distributed_mean_and_var` is the one-process statistic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from pointnav_vo_tpu_torch.models.policy import action_log_prob, entropy
from pointnav_vo_tpu_torch.rl.rollout import RolloutStorage

EPS_PPO = 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Mirrors RL.PPO of configs/rl/ddppo_pointnav.yaml."""

    clip_param: float = 0.2
    ppo_epoch: int = 1
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 2.5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.2
    num_steps: int = 128
    use_gae: bool = True
    gamma: float = 0.99
    tau: float = 0.95
    use_clipped_value_loss: bool = True
    use_normalized_advantage: bool = False
    use_linear_lr_decay: bool = False
    use_linear_clip_decay: bool = False
    hidden_size: int = 512
    reward_window_size: int = 50


class PPOOptimizer:
    """Clip by global norm, then Adam; :meth:`step` applies one minibatch's
    gradients (a parameter without one takes zeros, as optax would)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: PPOConfig,
                 total_updates: Optional[int] = None):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.decay_steps = total_updates if cfg.use_linear_lr_decay and total_updates else None
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, eps=cfg.eps)
        self.count = 0  # optimizer steps taken: the lr schedule's clock

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def lr_at(self, count: int) -> float:
        if self.decay_steps is None:
            return self.cfg.lr
        return self.cfg.lr * (1.0 - min(count, self.decay_steps) / self.decay_steps)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        max_norm = self.cfg.max_grad_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(norm < max_norm, g, g / norm * max_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: PPOConfig,
                   total_updates: Optional[int] = None) -> PPOOptimizer:
    """Clip-by-global-norm -> Adam, with the optional linear lr decay over
    ``total_updates`` optimizer steps."""
    return PPOOptimizer(params, cfg, total_updates)


def distributed_mean_and_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance over all elements (one process), from the sum and
    the sum of squares as the JAX package's all-device form."""
    s = x.sum()
    sq = (x * x).sum()
    # a device tensor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which the CPU does not
    n = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
    mean = s / n
    return mean, sq / n - mean * mean


MiniBatch = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def gather_env_slice(rollouts: RolloutStorage, idx: torch.Tensor,
                     keys: Optional[Sequence[str]] = None):
    """The env columns ``idx`` of every ``[.., N, ..]`` rollout tensor over
    the first T steps: (observations of ``keys`` (all where None), the
    recurrent state at slot 0 ``[L, n_mb, H]``, actions, prev_actions,
    value_preds, returns, masks, action_log_probs)."""
    t = rollouts.num_steps
    keys = list(rollouts.observations) if keys is None else keys
    return (
        {k: rollouts.observations[k][:t][:, idx] for k in keys},
        rollouts.hidden_states[0][:, idx],
        rollouts.actions[:, idx],
        rollouts.prev_actions[:t][:, idx],
        rollouts.value_preds[:t][:, idx],
        rollouts.returns[:t][:, idx],
        rollouts.masks[:t][:, idx],
        rollouts.action_log_probs[:, idx],
    )


def ppo_loss(model, cfg: PPOConfig, minibatch: MiniBatch, clip):
    """Total loss and (value_loss, action_loss, entropy) of one minibatch:
    :func:`gather_env_slice` plus the advantages ``[T, n_mb, 1]``."""
    obs, h0, actions, prev_actions, old_values, returns, masks, old_logp, adv = minibatch
    logits, values, _ = model(obs, h0, prev_actions, masks)
    tn = logits.shape[0]
    logp = action_log_prob(logits, actions.reshape(tn, 1))
    ent = entropy(logits).mean()

    ratio = torch.exp(logp - old_logp.reshape(tn, 1))
    adv_f = adv.reshape(tn, 1)
    surr1 = ratio * adv_f
    surr2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv_f
    action_loss = -torch.minimum(surr1, surr2).mean()

    ret_f = returns.reshape(tn, 1)
    if cfg.use_clipped_value_loss:
        old_v = old_values.reshape(tn, 1)
        v_clip = old_v + torch.clamp(values - old_v, -clip, clip)
        value_loss = 0.5 * torch.maximum((values - ret_f) ** 2, (v_clip - ret_f) ** 2).mean()
    else:
        value_loss = 0.5 * ((ret_f - values) ** 2).mean()

    total = value_loss * cfg.value_loss_coef + action_loss - ent * cfg.entropy_coef
    return total, (value_loss, action_loss, ent)


def minibatch_order(cfg: PPOConfig, num_envs: int, generator: torch.Generator) -> torch.Tensor:
    """``[ppo_epoch, num_mini_batch, n_per_mb]`` env indices: one random
    permutation of the envs an epoch, cut into minibatches."""
    n_per_mb = num_envs // cfg.num_mini_batch
    perms = [torch.randperm(num_envs, generator=generator, device=generator.device)
             for _ in range(cfg.ppo_epoch)]
    return torch.stack([p[: n_per_mb * cfg.num_mini_batch].reshape(cfg.num_mini_batch, n_per_mb)
                        for p in perms])


def ppo_update(model, cfg: PPOConfig, optimizer: PPOOptimizer, rollouts: RolloutStorage,
               order: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               clip_param: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One full PPO update of ``model`` in place, which it leaves in
    training mode (cuDNN's LSTM backward runs only there; the policy has no
    layer that trains differently).  ``order`` (``[ppo_epoch,
    num_mini_batch, n_per_mb]`` env indices) or ``generator`` gives the
    minibatches.  Returns {value_loss, action_loss, dist_entropy}, each the
    mean over the minibatches, as device scalars."""
    model.train()
    clip = cfg.clip_param if clip_param is None else clip_param
    n_envs = rollouts.num_envs
    if n_envs // cfg.num_mini_batch <= 0:
        raise ValueError(f"{n_envs} envs cannot fill {cfg.num_mini_batch} minibatches")
    advantages = rollouts.returns[:-1] - rollouts.value_preds[:-1]
    if cfg.use_normalized_advantage:
        mean, var = distributed_mean_and_var(advantages)
        advantages = (advantages - mean) / (torch.sqrt(var) + EPS_PPO)
    if order is None:
        if generator is None:
            raise ValueError("ppo_update needs a minibatch order or a generator")
        order = minibatch_order(cfg, n_envs, generator)
    order = torch.as_tensor(order, device=advantages.device)
    expected = (cfg.ppo_epoch, cfg.num_mini_batch, n_envs // cfg.num_mini_batch)
    if tuple(order.shape) != expected:
        raise ValueError(f"minibatch order of shape {tuple(order.shape)}, expected {expected}")

    stats = torch.zeros(3, device=advantages.device)
    for epoch in order:
        for idx in epoch:
            mb = gather_env_slice(rollouts, idx, model.observation_keys) + (advantages[:, idx],)
            optimizer.zero_grad()
            total, terms = ppo_loss(model, cfg, mb, clip)
            total.backward()
            optimizer.step()
            stats += torch.stack([x.detach() for x in terms]).to(stats.dtype)
    stats /= cfg.ppo_epoch * cfg.num_mini_batch
    return {"value_loss": stats[0], "action_loss": stats[1], "dist_entropy": stats[2]}
