"""Reference-shaped torch modules built from a clone of the reference
repository: the oracle of ``tools/verify_reference_ckpts.py``.

The reference's standalone torch modules (its GroupNorm ResNet, RNN state
encoder and running mean-and-var, the only ones importable without
habitat) are loaded from the clone's files and wired into wrappers whose
state-dict keys are the published checkpoints'.  Nothing is loaded when
this module is imported: :func:`load_reference` reads the clone.
"""

from __future__ import annotations

import importlib.util
import math
import os
import sys
import types
from typing import Optional

import torch
from torch import nn

_FILES = {"resnet": "model_utils/visual_encoders/resnet.py",
          "rnn": "model_utils/rnns/rnn_state_encoder.py",
          "rmv": "model_utils/running_mean_and_var.py"}


def load_reference(reference_root: str) -> Optional[types.SimpleNamespace]:
    """The clone's ``resnet``, ``rnn`` and ``rmv`` modules, or None where
    ``reference_root`` holds no ``pointnav_vo`` package."""
    pkg = os.path.join(reference_root, "pointnav_vo")
    if not os.path.isdir(pkg):
        return None
    mods = {}
    for key, rel in _FILES.items():
        name = f"_pointnav_vo_reference_{key}"
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, rel))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        mods[key] = mod
    return types.SimpleNamespace(**mods)


def _compression(backbone, fh: int, fw: int, flat_size: int = 2048):
    nch = int(round(flat_size / (fw * fh)))
    return nn.Sequential(nn.Conv2d(backbone.final_channels, nch, 3, padding=1, bias=False),
                         nn.GroupNorm(1, nch), nn.ReLU(True)), (nch, fh, fw)


class ReferenceVOEncoder(nn.Module):
    """Keys ``running_mean_and_var``, ``backbone``, ``compression.{0,1}``;
    the input is the observation dict with each key's two frames
    concatenated on the channel axis (rgb in 0-255)."""

    def __init__(self, ref, obs_space, obs_size_wh, baseplanes=32, backbone="resnet18",
                 dd_channels=10):
        super().__init__()
        self.obs_space = obs_space
        c = ((6 if "rgb" in obs_space else 0) + (2 if "depth" in obs_space else 0)
             + (2 * dd_channels if "discretized_depth" in obs_space else 0)
             + (2 if "top_down_view" in obs_space else 0))
        self.running_mean_and_var = ref.rmv.RunningMeanAndVar(c)
        self.backbone = getattr(ref.resnet, backbone)(c, baseplanes, baseplanes // 2)
        w, h = obs_size_wh
        self.compression, self.output_shape = _compression(
            self.backbone, math.ceil(h / 32), math.ceil(w / 32))

    def forward(self, obs):
        prev, cur = [], []
        for key, norm in (("rgb", 255.0), ("depth", 1.0), ("discretized_depth", 1.0),
                          ("top_down_view", 1.0)):
            if key in self.obs_space:
                x = obs[key].permute(0, 3, 1, 2) / norm
                half = x.shape[1] // 2
                prev.append(x[:, :half])
                cur.append(x[:, half:])
        x = self.running_mean_and_var(torch.cat(prev + cur, dim=1))
        return self.compression(self.backbone(x))


class ReferenceVOModel(nn.Module):
    def __init__(self, ref, obs_space, obs_size_wh, hidden=512, out_dim=3, **kw):
        super().__init__()
        self.visual_encoder = ReferenceVOEncoder(ref, obs_space, obs_size_wh, **kw)
        flat = math.prod(self.visual_encoder.output_shape)
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Dropout(0.2), nn.Linear(flat, hidden),
                                       nn.ReLU(True))
        self.output_head = nn.Sequential(nn.Dropout(0.2), nn.Linear(hidden, out_dim))

    def forward(self, obs):
        return self.output_head(self.visual_fc(self.visual_encoder(obs)))


class ReferencePolicyEncoder(nn.Module):
    """The reference's depth ResNet policy encoder (2x2 average pool, then
    the backbone and the compression)."""

    def __init__(self, ref, image_size_hw, baseplanes=32, backbone="resnet18"):
        super().__init__()
        self.backbone = getattr(ref.resnet, backbone)(1, baseplanes, baseplanes // 2)
        h, w = image_size_hw
        self.compression, self.output_shape = _compression(
            self.backbone, math.ceil((h // 2) / 32), math.ceil((w // 2) / 32))

    def forward(self, obs):
        x = torch.nn.functional.avg_pool2d(obs["depth"].permute(0, 3, 1, 2), 2)
        return self.compression(self.backbone(x))


class ReferencePolicyNet(nn.Module):
    def __init__(self, ref, image_size_hw, n_actions=4, hidden=512):
        super().__init__()
        self.prev_action_embedding = nn.Embedding(n_actions + 1, 32)
        self.tgt_embeding = nn.Linear(3, 32)
        self.visual_encoder = ReferencePolicyEncoder(ref, image_size_hw)
        flat = math.prod(self.visual_encoder.output_shape)
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Linear(flat, hidden), nn.ReLU(True))
        self.state_encoder = ref.rnn.RNNStateEncoder(hidden + 64, hidden, num_layers=2,
                                                     rnn_type="LSTM")

    def forward(self, obs, hidden, prev_actions, masks):
        goal = obs["pointgoal_with_gps_compass"]
        goal3 = torch.stack([goal[:, 0], torch.cos(-goal[:, 1]), torch.sin(-goal[:, 1])], -1)
        prev = self.prev_action_embedding(
            ((prev_actions.float() + 1) * masks).long().squeeze(-1))
        x = torch.cat([self.visual_fc(self.visual_encoder(obs)), self.tgt_embeding(goal3),
                       prev], dim=1)
        return self.state_encoder(x, hidden, masks)


class _Linear(nn.Module):
    def __init__(self, name, n_in, n_out):
        super().__init__()
        setattr(self, name, nn.Linear(n_in, n_out))
        self._name = name

    def forward(self, x):
        return getattr(self, self._name)(x)


class ReferenceActorCritic(nn.Module):
    """Keys ``net.*``, ``action_distribution.linear``, ``critic.fc``;
    returns (logits, value, hidden')."""

    def __init__(self, ref, image_size_hw, n_actions=4, hidden=512):
        super().__init__()
        self.net = ReferencePolicyNet(ref, image_size_hw, n_actions, hidden)
        self.action_distribution = _Linear("linear", hidden, n_actions)
        self.critic = _Linear("fc", hidden, 1)

    def forward(self, obs, hidden, prev_actions, masks):
        feat, hidden = self.net(obs, hidden, prev_actions, masks)
        return self.action_distribution(feat), self.critic(feat), hidden
