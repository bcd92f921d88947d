"""Navigation actor-critics (counterpart of ``models/policy.py``).

- :class:`PointNavActorCritic`, the deployed ``resnet_rnn_policy``: a
  GroupNorm ResNet (ResNet18 deployed, any of ``resnet.BACKBONES``) over
  the ``vis_types`` inputs (rgb, scaled by 1/255, then depth, in that order
  whatever the config's) behind a 2x2 avg-pool and, with
  ``normalize_visual_inputs`` (the rgb policies), a
  :class:`RunningMeanAndVar` whitening; the goal encoded as ``[rho,
  cos(-phi), sin(-phi)] -> Linear(32)``; a 32-d previous-action embedding
  with the +1 shift and done-masking; an LSTM or GRU (``rnn_type``, 2
  layers deployed); a categorical action head and a linear critic.
- :class:`PointNavBaselineActorCritic`, the SimpleCNN + GRU baseline
  (``pointnav_baseline_policy``): three VALID convs and a Linear over rgb
  and depth, then a one-layer GRU over ``[vis, rho, phi]``.

Module names follow the reference state dict (without the ``actor_critic.``
prefix): ``net.visual_encoder`` (``.running_mean_and_var`` for the
whitening buffers; the baseline's ``.cnn`` Sequential), ``net.visual_fc.1``,
``net.tgt_embeding``, ``net.prev_action_embedding``,
``net.state_encoder.rnn``, ``action_distribution.linear`` and ``critic.fc``.
One step takes ``[N, ...]`` inputs; the PPO update's sequence form takes
``[T, N, ...]``, runs the encoder on all ``T*N`` frames at once and the RNN
over time.  ``update_stats`` folds the frames into the whitening buffers
before they normalise them (rollout collection); otherwise the buffers are
read as they stand.

``compute_dtype`` is the JAX modules' ``dtype``.  With ``torch.bfloat16``
the inputs are cast (rgb scaled by 1/255 after the cast), the whitening
keeps its statistics in float32 and emits bfloat16, and the convs,
GroupNorms (statistics in float32, ``models/resnet.py``), ``visual_fc``,
``tgt_embeding`` (the goal cast before its cos and sin), the
previous-action embedding and the two heads run in bfloat16 over float32
parameters.  The RNN does not: JAX's multiplies the bfloat16 features by
float32 weights, which promotes, so it runs in float32 on bfloat16-rounded
inputs and its hidden state stays float32.  Logits and value come out in
float32.  ``None`` computes in the parameters' dtype (float32, or float64
for a reference run) and returns in it.

In bfloat16 the policy's linears and biased convs add the bias to the
rounded product (:class:`Dense`, :class:`Conv`) and its 2x2 pool sums in
XLA's order (:func:`avg_pool_2x2`), as JAX computes them; the VO models'
single rounding (``resnet.Linear``, ``resnet.Conv2d``) and ``F.avg_pool2d``
in their place miss ``tests/test_torch_port_policy_bf16.py`` on the CPU
(64x64): the baseline's value 5.22e-3 relative L2 in one step (bound
5e-3) and its hidden 1.79e-3 in the sequence form (1e-3), the rgb-d
policy's sequence hidden 1.11e-3 (1e-3), and one whitening variance
2.45e-5 off relatively (rtol 1e-5).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointnav_vo_tpu_torch.common import N_ACTS
from pointnav_vo_tpu_torch.models import resnet as resnet_lib
from pointnav_vo_tpu_torch.models.rnn import RNNStateEncoder
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar
from pointnav_vo_tpu_torch.models.vo_cnn import compression_channels

PREV_ACTION_EMBED_DIM = 32
GOAL_EMBED_DIM = 32
GOAL_POLAR_DIM = 2
NUM_RECURRENT_LAYERS = 2  # the deployed policy's
GOAL_KEY = "pointgoal_with_gps_compass"
VIS_ORDER = ("rgb", "depth")  # the input channels' order, whatever the config's


def _vis_types(vis_types: Sequence[str]) -> Tuple[str, ...]:
    unknown = set(vis_types) - set(VIS_ORDER)
    if unknown or not vis_types:
        raise ValueError(f"visual types {list(vis_types)} (a subset of {list(VIS_ORDER)})")
    return tuple(t for t in VIS_ORDER if t in vis_types)


def _channels(vis_types: Sequence[str]) -> int:
    return (3 if "rgb" in vis_types else 0) + (1 if "depth" in vis_types else 0)


def visual_input(observations: Dict[str, torch.Tensor], vis_types: Sequence[str],
                 dtype: torch.dtype) -> torch.Tensor:
    """The ``vis_types`` frames as one ``[N, C, H, W]`` tensor in ``dtype``:
    rgb (uint8 or float) cast, then scaled by 1/255, ahead of depth."""
    parts = []
    if "rgb" in vis_types:
        parts.append(observations["rgb"].to(dtype) / 255.0)
    if "depth" in vis_types:
        parts.append(observations["depth"].to(dtype))
    return torch.cat(parts, dim=-1).permute(0, 3, 1, 2)


class Dense(resnet_lib.Linear):
    """A linear layer as flax's ``Dense(dtype=...)`` computes it: in the
    input's dtype, and in one other than the parameters' the bias added to
    the rounded product (``F.linear`` would round once)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class Conv(resnet_lib.Conv2d):
    """A conv with a bias as flax's ``Conv(dtype=...)`` computes it: the
    bias added to the rounded convolution in a dtype other than the
    parameters'."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y + self.bias.to(x.dtype)[:, None, None]


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, odd edges dropped.  In bfloat16 it sums
    each window in row-major order, rounding after each add, then divides
    by 4, as XLA's ``reduce_window`` does for flax's ``avg_pool``
    (``F.avg_pool2d`` sums in float32 and rounds once: a quarter of the
    outputs then differ by an ulp)."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, 2)
    x = x[..., : x.shape[-2] // 2 * 2, : x.shape[-1] // 2 * 2]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    return (s + x[..., 1::2, 1::2]) / 4


class PolicyResNetEncoder(nn.Module):
    """Visual trunk: avg-pool/2 (floor) -> (whitening) -> backbone ->
    compression."""

    def __init__(self, image_size: Tuple[int, int] = (192, 341), baseplanes: int = 32,
                 backbone: str = "resnet18", vis_types: Sequence[str] = ("depth",),
                 normalize_visual_inputs: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.vis_types = _vis_types(vis_types)
        in_ch = _channels(self.vis_types)
        h, w = image_size
        fh, fw = math.ceil((h // 2) / 32), math.ceil((w // 2) / 32)
        self.output_shape = (compression_channels(fh, fw), fh, fw)
        self.running_mean_and_var = (RunningMeanAndVar(in_ch) if normalize_visual_inputs
                                     else None)
        self.backbone = resnet_lib.BACKBONES[backbone](in_ch, base_planes=baseplanes,
                                                       ngroups=baseplanes // 2)
        ch = self.output_shape[0]
        self.compression = nn.Sequential(
            resnet_lib.Conv2d(self.backbone.final_channels, ch, 3, padding=1, bias=False),
            resnet_lib.group_norm(1, ch),
            nn.ReLU(True),
        )

    def forward(self, observations: Dict[str, torch.Tensor],
                update_stats: bool = False) -> torch.Tensor:
        """``rgb`` ``[N, H, W, 3]`` and/or ``depth`` ``[N, H, W, 1]`` ->
        ``[N, C, fh, fw]`` in the compute dtype."""
        dtype = self.compute_dtype or self.compression[0].weight.dtype
        x = avg_pool_2x2(visual_input(observations, self.vis_types, dtype))
        if self.running_mean_and_var is not None:
            x = self.running_mean_and_var(x, update_stats=update_stats, dtype=dtype)
        return self.compression(self.backbone(x))


class _Net(nn.Module):
    def __init__(self, image_size, hidden_size, baseplanes, backbone, num_recurrent_layers,
                 vis_types, rnn_type, normalize_visual_inputs, compute_dtype):
        super().__init__()
        self.visual_encoder = PolicyResNetEncoder(image_size, baseplanes, backbone, vis_types,
                                                  normalize_visual_inputs, compute_dtype)
        flat = math.prod(self.visual_encoder.output_shape)
        self.visual_fc = nn.Sequential(nn.Flatten(), Dense(flat, hidden_size), nn.ReLU(True))
        self.tgt_embeding = Dense(3, GOAL_EMBED_DIM)
        self.prev_action_embedding = nn.Embedding(N_ACTS + 1, PREV_ACTION_EMBED_DIM)
        self.state_encoder = RNNStateEncoder(
            hidden_size + GOAL_EMBED_DIM + PREV_ACTION_EMBED_DIM, hidden_size,
            num_recurrent_layers, rnn_type)


class _CategoricalHead(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.linear = Dense(hidden_size, N_ACTS)


class _CriticHead(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.fc = Dense(hidden_size, 1)


class _ActorCritic(nn.Module):
    """What both policies share: the heads, the recurrent state's shape and
    the sequence handling around ``_features``."""

    def __init__(self, net: nn.Module, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.net = net
        self.observation_keys = net.visual_encoder.vis_types + (GOAL_KEY,)
        self.action_distribution = _CategoricalHead(hidden_size)
        self.critic = _CriticHead(hidden_size)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return self.net.visual_encoder.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.net.visual_encoder.compute_dtype = dtype

    @property
    def num_packed_hidden(self) -> int:
        return self.net.state_encoder.num_recurrent_layers

    def initial_hidden(self, num_envs: int, device=None) -> torch.Tensor:
        return torch.zeros(self.num_packed_hidden, num_envs, self.hidden_size,
                           device=device)

    def forward(self, observations: Dict[str, torch.Tensor], hidden: torch.Tensor,
                prev_actions: torch.Tensor, masks: torch.Tensor, update_stats: bool = False):
        """observations: those of ``observation_keys``, ``[N, ...]``
        (``pointgoal_with_gps_compass`` ``[N, 2]``); hidden
        ``[num_packed_hidden, N, H]``; prev_actions ``[N, 1]`` int; masks
        ``[N, 1]`` float.  Or a sequence: each with a leading time axis,
        ``[T, N, ...]``."""
        seq = prev_actions.dim() == 3
        if seq:
            t, n = prev_actions.shape[:2]
            observations = {k: observations[k].reshape((t * n,) + observations[k].shape[2:])
                            for k in self.observation_keys}
            prev_actions, masks = prev_actions.reshape(t * n, 1), masks.reshape(t * n, 1)
        x = self._features(observations, prev_actions, masks, update_stats)
        dtype = x.dtype
        encoder = self.net.state_encoder
        rnn_dtype = encoder.rnn.weight_ih_l0.dtype  # float32 under bfloat16 compute
        x, hidden, masks = x.to(rnn_dtype), hidden.to(rnn_dtype), masks.to(rnn_dtype)
        if seq:
            x, hidden = encoder(x.reshape(t, n, -1), hidden, masks.reshape(t, n, 1))
            x = x.reshape(t * n, -1)
        else:
            x, hidden = encoder(x, hidden, masks)
        x = x.to(dtype)
        out = torch.promote_types(dtype, torch.float32)
        return self.action_distribution.linear(x).to(out), self.critic.fc(x).to(out), hidden


class PointNavActorCritic(_ActorCritic):
    """Returns (logits ``[B, 4]``, value ``[B, 1]``, hidden'), B = N for one
    step and T*N for a sequence.  ``observation_keys`` are the observations
    the forward reads."""

    def __init__(self, image_size: Tuple[int, int] = (192, 341), hidden_size: int = 512,
                 baseplanes: int = 32, backbone: str = "resnet18",
                 num_recurrent_layers: int = NUM_RECURRENT_LAYERS,
                 vis_types: Sequence[str] = ("depth",), rnn_type: str = "LSTM",
                 normalize_visual_inputs: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(_Net(image_size, hidden_size, baseplanes, backbone,
                              num_recurrent_layers, vis_types, rnn_type,
                              normalize_visual_inputs, compute_dtype), hidden_size)

    def _features(self, observations, prev_actions, masks, update_stats):
        net = self.net
        vis = net.visual_fc(net.visual_encoder(observations, update_stats))
        goal = observations[GOAL_KEY].to(vis.dtype)
        goal3 = torch.stack([goal[:, 0], torch.cos(-goal[:, 1]),
                             torch.sin(-goal[:, 1])], dim=-1)
        # +1 shift so action "none" (episode start, masked to 0) has its own row
        prev_idx = ((prev_actions.float() + 1.0) * masks.float()).long()
        embed = F.embedding(prev_idx[:, 0], net.prev_action_embedding.weight.to(vis.dtype))
        return torch.cat([vis, net.tgt_embeding(goal3), embed], dim=-1)


class SimpleCNNEncoder(nn.Module):
    """The baseline's encoder: VALID convs 8/4, 4/2 and 3/1 to 32, 64 and 32
    channels (ReLU after the first two), a CHW flatten, a Linear and a
    ReLU, as the reference's ``cnn`` Sequential."""

    def __init__(self, image_size: Tuple[int, int] = (192, 341),
                 vis_types: Sequence[str] = ("rgb", "depth"), output_size: int = 512,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.vis_types = _vis_types(vis_types)
        h, w = image_size
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = (h - k) // s + 1, (w - k) // s + 1
        self.cnn = nn.Sequential(
            Conv(_channels(self.vis_types), 32, 8, stride=4), nn.ReLU(True),
            Conv(32, 64, 4, stride=2), nn.ReLU(True),
            Conv(64, 32, 3, stride=1),
            nn.Flatten(), Dense(32 * h * w, output_size), nn.ReLU(True))

    def forward(self, observations: Dict[str, torch.Tensor]) -> torch.Tensor:
        dtype = self.compute_dtype or self.cnn[0].weight.dtype
        return self.cnn(visual_input(observations, self.vis_types, dtype))


class _BaselineNet(nn.Module):
    def __init__(self, image_size, hidden_size, vis_types, compute_dtype):
        super().__init__()
        self.visual_encoder = SimpleCNNEncoder(image_size, vis_types, hidden_size,
                                               compute_dtype)
        self.state_encoder = RNNStateEncoder(hidden_size + GOAL_POLAR_DIM, hidden_size, 1,
                                             "GRU")


class PointNavBaselineActorCritic(_ActorCritic):
    """SimpleCNN + one-layer GRU over ``[vis, rho, phi]`` (no previous-action
    embedding); packed hidden ``[1, N, H]``.  ``update_stats`` is taken and
    ignored: the baseline has no whitening."""

    def __init__(self, image_size: Tuple[int, int] = (192, 341), hidden_size: int = 512,
                 vis_types: Sequence[str] = ("rgb", "depth"),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(_BaselineNet(image_size, hidden_size, vis_types, compute_dtype),
                         hidden_size)

    def _features(self, observations, prev_actions, masks, update_stats):
        vis = self.net.visual_encoder(observations)
        return torch.cat([vis, observations[GOAL_KEY].to(vis.dtype)], dim=-1)


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
