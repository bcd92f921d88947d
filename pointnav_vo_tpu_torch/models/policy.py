"""Navigation actor-critic (counterpart of ``models/policy.py``), the deployed
``resnet_rnn_policy``: a depth GroupNorm ResNet (ResNet18 deployed, any of
``resnet.BACKBONES``) behind a 2x2 avg-pool, the goal encoded as
``[rho, cos(-phi), sin(-phi)] -> Linear(32)``, a 32-d previous-action
embedding with the +1 shift and done-masking, an LSTM (2 layers deployed,
``num_recurrent_layers``), a categorical action head and a linear critic.

Module names follow the reference state dict (without the ``actor_critic.``
prefix): ``net.visual_encoder``, ``net.visual_fc.1``, ``net.tgt_embeding``,
``net.prev_action_embedding``, ``net.state_encoder.rnn``,
``action_distribution.linear`` and ``critic.fc``.  Depth input only (the
deployed policy's; rgb policies, which also whiten their input, are not
ported yet).  One step takes ``[N, ...]`` inputs; the PPO update's sequence
form takes ``[T, N, ...]``, runs the encoder on all ``T*N`` frames at once
and the LSTM over time.  The modules follow their parameters' dtype
(float32, or float64 for a reference run).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointnav_vo_tpu_torch.common import N_ACTS
from pointnav_vo_tpu_torch.models import resnet as resnet_lib
from pointnav_vo_tpu_torch.models.rnn import RNNStateEncoder
from pointnav_vo_tpu_torch.models.vo_cnn import compression_channels

PREV_ACTION_EMBED_DIM = 32
GOAL_EMBED_DIM = 32
NUM_RECURRENT_LAYERS = 2  # the deployed policy's


class PolicyResNetEncoder(nn.Module):
    """Visual trunk: avg-pool/2 (floor) -> backbone -> compression."""

    def __init__(self, image_size: Tuple[int, int] = (192, 341), baseplanes: int = 32,
                 backbone: str = "resnet18"):
        super().__init__()
        h, w = image_size
        fh, fw = math.ceil((h // 2) / 32), math.ceil((w // 2) / 32)
        self.output_shape = (compression_channels(fh, fw), fh, fw)
        self.backbone = resnet_lib.BACKBONES[backbone](1, base_planes=baseplanes,
                                                       ngroups=baseplanes // 2)
        ch = self.output_shape[0]
        self.compression = nn.Sequential(
            nn.Conv2d(self.backbone.final_channels, ch, 3, padding=1, bias=False),
            resnet_lib.group_norm(1, ch),
            nn.ReLU(True),
        )

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        """depth ``[N, H, W, 1]`` -> ``[N, C, fh, fw]``."""
        x = depth.to(self.compression[0].weight.dtype).permute(0, 3, 1, 2)
        return self.compression(self.backbone(F.avg_pool2d(x, 2)))


class _Net(nn.Module):
    def __init__(self, image_size, hidden_size, baseplanes, backbone, num_recurrent_layers):
        super().__init__()
        self.visual_encoder = PolicyResNetEncoder(image_size, baseplanes, backbone)
        flat = math.prod(self.visual_encoder.output_shape)
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Linear(flat, hidden_size),
                                       nn.ReLU(True))
        self.tgt_embeding = nn.Linear(3, GOAL_EMBED_DIM)
        self.prev_action_embedding = nn.Embedding(N_ACTS + 1, PREV_ACTION_EMBED_DIM)
        self.state_encoder = RNNStateEncoder(
            hidden_size + GOAL_EMBED_DIM + PREV_ACTION_EMBED_DIM, hidden_size,
            num_recurrent_layers)


class _CategoricalHead(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.linear = nn.Linear(hidden_size, N_ACTS)


class _CriticHead(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.fc = nn.Linear(hidden_size, 1)


class PointNavActorCritic(nn.Module):
    """Returns (logits ``[B, 4]``, value ``[B, 1]``, hidden'), B = N for one
    step and T*N for a sequence."""

    # the observations the forward reads
    observation_keys = ("depth", "pointgoal_with_gps_compass")

    def __init__(self, image_size: Tuple[int, int] = (192, 341), hidden_size: int = 512,
                 baseplanes: int = 32, backbone: str = "resnet18",
                 num_recurrent_layers: int = NUM_RECURRENT_LAYERS):
        super().__init__()
        self.hidden_size = hidden_size
        self.net = _Net(image_size, hidden_size, baseplanes, backbone, num_recurrent_layers)
        self.action_distribution = _CategoricalHead(hidden_size)
        self.critic = _CriticHead(hidden_size)

    @property
    def num_packed_hidden(self) -> int:
        return self.net.state_encoder.num_recurrent_layers

    def initial_hidden(self, num_envs: int, device=None) -> torch.Tensor:
        return torch.zeros(self.num_packed_hidden, num_envs, self.hidden_size,
                           device=device)

    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: torch.Tensor, masks: torch.Tensor):
        """observations: ``depth`` ``[N, H, W, 1]`` and
        ``pointgoal_with_gps_compass`` ``[N, 2]``; hidden ``[2L, N, H]``;
        prev_actions ``[N, 1]`` int; masks ``[N, 1]`` float.  Or a sequence:
        each with a leading time axis, ``[T, N, ...]``."""
        net = self.net
        seq = prev_actions.dim() == 3
        if seq:
            t, n = prev_actions.shape[:2]
            observations = {k: observations[k].reshape((t * n,) + observations[k].shape[2:])
                            for k in self.observation_keys}
            prev_actions, masks = prev_actions.reshape(t * n, 1), masks.reshape(t * n, 1)
        vis = net.visual_fc(net.visual_encoder(observations["depth"]))
        goal = observations["pointgoal_with_gps_compass"].to(vis.dtype)
        goal3 = torch.stack([goal[:, 0], torch.cos(-goal[:, 1]),
                             torch.sin(-goal[:, 1])], dim=-1)
        # +1 shift so action "none" (episode start, masked to 0) has its own row
        prev_idx = ((prev_actions.float() + 1.0) * masks.float()).long()
        x = torch.cat([vis, net.tgt_embeding(goal3),
                       net.prev_action_embedding(prev_idx[:, 0])], dim=-1)
        if seq:
            x, hidden = net.state_encoder(x.reshape(t, n, -1), hidden.to(x.dtype),
                                          masks.reshape(t, n, 1).to(x.dtype))
            x = x.reshape(t * n, -1)
        else:
            x, hidden = net.state_encoder(x, hidden.to(x.dtype), masks.to(x.dtype))
        logits = self.action_distribution.linear(x)
        value = self.critic.fc(x)
        return logits, value, hidden


def sample_action(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One action ``[N, 1]`` drawn from each row's categorical distribution
    (``generator`` on the logits' device), by the Gumbel-max trick as
    ``jax.random.categorical`` draws: ``argmax(logits - log E)``, E ~ Exp(1).
    Not ``torch.multinomial``, whose input check reads a value back to the
    host and so stalls the eval loop on every step."""
    e = torch.empty(logits.shape, device=logits.device).exponential_(generator=generator)
    gumbel = -torch.log(e.clamp_min(torch.finfo(torch.float32).tiny))
    return torch.argmax(logits.float() + gumbel, dim=-1, keepdim=True)


def mode_action(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1, keepdim=True)


def action_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return torch.gather(F.log_softmax(logits, dim=-1), -1, actions.long())


def entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)
