"""Visual-odometry CNN family (counterpart of ``models/vo_cnn.py``):
whitening -> GroupNorm ResNet backbone (any of ``resnet.BACKBONES``) over
the channel-stacked observation pair -> 3x3 compression conv to ~2048 flat
features -> dropout/linear trunk -> SE(2) delta head.  :class:`VOCNN` is
the per-action expert; :class:`VOCNNActEmbed` is the unified model, whose
trunk also reads a 32-d embedding of the action id.

Dropout acts before the hidden linear (``visual_fc`` or
``hidden_generator``) and before ``output_head`` when the caller gives keep
masks or a ``torch.Generator`` to draw them from (:func:`draw_dropout_masks`),
and only then: ``.train()`` does not switch it on.  The masks are explicit
so that a run on the card and one on the CPU can share them.  The
act-embed model's first mask covers the whole trunk input, features and
embedding (``flat + 32`` wide), as the JAX module's dropout does.

The encoder takes the PACKED stem input ``[B, H, W, C]`` (NHWC, as the JAX
package's public layout): per frame rgb/255, depth, discretized depth and
top-down view, the previous frame's blocks first (see
``vo/ensemble.py::pack_frame_features``).  The features are flattened in
CHW order, as the reference's checkpoints expect.

``compute_dtype`` is the JAX modules' ``dtype``: with ``torch.bfloat16`` the
whitening runs in float32 and emits bfloat16, the convs, GroupNorm outputs,
SE gates, embedding, dropout and linear layers run in bfloat16 over float32
parameters, and the delta comes out in float32.  ``None`` computes in the
parameters' dtype (float32, or float64 for a reference run).

:func:`make_vo_model` builds every variant of the JAX package's
``VO_MODEL_NAMES`` by name, checking its observation space as JAX does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointnav_vo_tpu_torch.common import DELTA_DIM, N_ACTS
from pointnav_vo_tpu_torch.models import resnet as resnet_lib
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar

# per-pair channel counts
RGB_PAIR_CHANNEL = 6
DEPTH_PAIR_CHANNEL = 2
TOP_DOWN_VIEW_PAIR_CHANNEL = 2
BASEPLANES = 32
EMBED_DIM = 32  # the act-embed model's action embedding
AFTER_COMPRESSION_FLAT_SIZE = 2048
DROPOUT_P = 0.2  # the trunk's dropout (VO.MODEL.dropout_p)


def compression_channels(fh: int, fw: int) -> int:
    """round(2048 / (fh * fw)) channels for an fh x fw compressed map."""
    return int(round(AFTER_COMPRESSION_FLAT_SIZE / (fh * fw)))


class VOEncoder(nn.Module):
    """Observation-pair encoder: whitening -> backbone -> compression conv."""

    def __init__(self, observation_space: Sequence[str], observation_size: Tuple[int, int],
                 discretized_depth_channels: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 backbone: str = "resnet18", baseplanes: int = BASEPLANES):
        super().__init__()
        self.compute_dtype = compute_dtype
        obs = tuple(observation_space)
        c = 0
        c += RGB_PAIR_CHANNEL if "rgb" in obs else 0
        c += DEPTH_PAIR_CHANNEL if "depth" in obs else 0
        c += 2 * discretized_depth_channels if "discretized_depth" in obs else 0
        c += TOP_DOWN_VIEW_PAIR_CHANNEL if "top_down_view" in obs else 0
        if c == 0:
            raise ValueError("visual odometry must not be blind")
        self.input_channels = c
        w, h = observation_size
        fh, fw = math.ceil(h / 32), math.ceil(w / 32)
        self.output_shape = (compression_channels(fh, fw), fh, fw)
        self.running_mean_and_var = RunningMeanAndVar(c)
        self.backbone = resnet_lib.BACKBONES[backbone](c, base_planes=baseplanes,
                                                       ngroups=baseplanes // 2)
        ch = self.output_shape[0]
        self.compression = nn.Sequential(
            resnet_lib.Conv2d(self.backbone.final_channels, ch, 3, padding=1, bias=False),
            resnet_lib.group_norm(1, ch),
            nn.ReLU(True),
        )

    def forward(self, packed: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """packed: ``[B, H, W, input_channels]`` -> ``[B, C, fh, fw]``."""
        if packed.shape[-1] != self.input_channels:
            raise ValueError(f"packed stem input has {packed.shape[-1]} channels, "
                             f"expected {self.input_channels}")
        rmv = self.running_mean_and_var
        dtype = self.compute_dtype or rmv._mean.dtype
        x = rmv(packed.permute(0, 3, 1, 2), update_stats, stats_mask, dtype=dtype)
        return self.compression(self.backbone(x))


DropoutMasks = Tuple[torch.Tensor, torch.Tensor]


class _VOModel(nn.Module):
    """What the two VO models share: the encoder, the compute dtype and the
    dropout trunk over ``hidden_layer`` and ``output_head.1``."""

    def __init__(self, observation_space, observation_size, hidden_size: int,
                 discretized_depth_channels: int, dropout_p: float,
                 compute_dtype: Optional[torch.dtype], backbone: str, baseplanes: int):
        super().__init__()
        self.dropout_p = dropout_p
        self.visual_encoder = VOEncoder(observation_space, observation_size,
                                        discretized_depth_channels, compute_dtype,
                                        backbone, baseplanes)
        self.flat_size = math.prod(self.visual_encoder.output_shape)
        self.hidden_size = hidden_size

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return self.visual_encoder.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.visual_encoder.compute_dtype = dtype

    @property
    def trunk_width(self) -> int:
        """Width of the trunk's input, and of its first dropout mask."""
        return self.flat_size

    def hidden_layer(self) -> nn.Linear:
        raise NotImplementedError

    def trunk(self, feats: torch.Tensor, masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Trunk input ``[n, trunk_width]`` -> delta ``[..., n, 3]``.
        ``masks`` (keep masks ``[..., n, trunk_width]`` and ``[..., n,
        hidden]``) switch the dropout on; a leading pass axis ``[k, n, ...]``
        runs the k passes as one batched product, each pass computed alike,
        so equal masks give equal passes.  It computes in the features'
        dtype (the masks scale in it, as flax's dropout does) and returns at
        least float32."""
        fc, head = self.hidden_layer(), self.output_head[1]
        if masks is None:
            out = _linear(head, torch.relu(_linear(fc, feats)))
        else:
            keep = 1.0 - self.dropout_p
            x = torch.relu(_linear(fc, feats * (masks[0].to(feats.dtype) / keep)))
            out = _linear(head, x * (masks[1].to(feats.dtype) / keep))
        return out.to(torch.promote_types(out.dtype, torch.float32))

    def _masks(self, batch: int, generator: Optional[torch.Generator],
               masks: Optional[DropoutMasks]) -> Optional[DropoutMasks]:
        if masks is None and generator is not None:
            masks = draw_dropout_masks(generator, (batch,), self.trunk_width,
                                       self.hidden_size, self.dropout_p)
        return masks


class VOCNN(_VOModel):
    """Encoder + dropout/linear trunk + delta-pose head.

    Keys: ``visual_encoder.*``, ``visual_fc.2`` (Flatten, Dropout, Linear,
    ReLU) and ``output_head.1`` (Dropout, Linear).  The Dropout entries hold
    the key positions only; :meth:`trunk` applies the keep masks itself."""

    def __init__(self, observation_space, observation_size, hidden_size: int = 512,
                 discretized_depth_channels: int = 0, dropout_p: float = DROPOUT_P,
                 compute_dtype: Optional[torch.dtype] = None, backbone: str = "resnet18",
                 baseplanes: int = BASEPLANES):
        super().__init__(observation_space, observation_size, hidden_size,
                         discretized_depth_channels, dropout_p, compute_dtype, backbone,
                         baseplanes)
        self.visual_fc = nn.Sequential(
            nn.Flatten(), nn.Dropout(dropout_p), nn.Linear(self.flat_size, hidden_size),
            nn.ReLU(True))
        self.output_head = nn.Sequential(nn.Dropout(dropout_p),
                                         nn.Linear(hidden_size, DELTA_DIM))

    def hidden_layer(self) -> nn.Linear:
        return self.visual_fc[2]

    def forward(self, packed: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Delta ``[B, 3]`` of packed pairs.  Dropout is on where ``masks``
        are given, or drawn from ``generator``; off otherwise."""
        feats = self.visual_encoder(packed, update_stats, stats_mask).flatten(1)
        return self.trunk(feats, self._masks(feats.shape[0], generator, masks))


class VOCNNActEmbed(_VOModel):
    """The unified model: the features, concatenated with a 32-d embedding
    of each row's action id, through the dropout/linear trunk.

    Keys: ``visual_encoder.*``, ``action_embedding`` (``N_ACTS + 1`` rows),
    ``hidden_generator.1`` (Dropout, Linear, ReLU) and ``output_head.1``
    (Dropout, Linear)."""

    def __init__(self, observation_space, observation_size, hidden_size: int = 512,
                 discretized_depth_channels: int = 0, dropout_p: float = DROPOUT_P,
                 compute_dtype: Optional[torch.dtype] = None, backbone: str = "resnet18",
                 baseplanes: int = BASEPLANES):
        super().__init__(observation_space, observation_size, hidden_size,
                         discretized_depth_channels, dropout_p, compute_dtype, backbone,
                         baseplanes)
        self.action_embedding = nn.Embedding(N_ACTS + 1, EMBED_DIM)
        self.hidden_generator = nn.Sequential(
            nn.Dropout(dropout_p), nn.Linear(self.flat_size + EMBED_DIM, hidden_size),
            nn.ReLU(True))
        self.output_head = nn.Sequential(nn.Dropout(dropout_p),
                                         nn.Linear(hidden_size, DELTA_DIM))

    @property
    def trunk_width(self) -> int:
        return self.flat_size + EMBED_DIM

    def hidden_layer(self) -> nn.Linear:
        return self.hidden_generator[1]

    def forward(self, packed: torch.Tensor, actions: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Delta ``[B, 3]`` of packed pairs and their action ids ``[B]``."""
        feats = self.visual_encoder(packed, update_stats, stats_mask).flatten(1)
        embed = self.action_embedding.weight.to(feats.dtype).index_select(
            0, actions.reshape(-1).long())
        x = torch.cat([feats, embed], dim=-1)
        return self.trunk(x, self._masks(x.shape[0], generator, masks))


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in ``x``'s dtype; for ``[k, n, d]`` input a batched
    product over k (a plain ``layer`` folds k into the rows of one GEMM,
    whose rows may round apart)."""
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    if x.dim() == 2:
        return F.linear(x, w, b)
    k, n = x.shape[:2]
    return torch.baddbmm(b.expand(k, n, -1), x, w.t().expand(k, -1, -1))


def draw_dropout_masks(generator: torch.Generator, lead: Tuple[int, ...], flat: int,
                       hidden: int, p: float) -> DropoutMasks:
    """Keep masks (True: kept) ``[*lead, flat]`` and ``[*lead, hidden]`` on
    the generator's device: uniform draws below ``1 - p``, as
    ``jax.random.bernoulli`` keeps."""
    dev = generator.device

    def draw(width):
        return torch.rand(*lead, width, generator=generator, device=dev) < 1.0 - p

    return draw(flat), draw(hidden)


# The JAX package's variants: the observation keys each needs and refuses,
# a base-width multiplier, a fixed backbone, and the act-embed model.
_NO_DD_TD = ("discretized_depth", "top_down_view")
_VARIANTS = {
    "vo_cnn": dict(requires=("rgb", "depth"), forbids=_NO_DD_TD),
    "vo_cnn_rgb": dict(requires=("rgb",), forbids=("depth",) + _NO_DD_TD),
    "vo_cnn_wider": dict(requires=("rgb", "depth"), forbids=_NO_DD_TD, baseplanes_mult=2),
    "vo_cnn_deeper": dict(requires=("rgb", "depth"), forbids=_NO_DD_TD, backbone="resnet101"),
    "vo_cnn_rgb_d_dd": dict(requires=("rgb", "depth", "discretized_depth"),
                            forbids=("top_down_view",)),
    "vo_cnn_rgb_d_top_down": dict(requires=("rgb", "depth", "top_down_view"),
                                  forbids=("discretized_depth",)),
    "vo_cnn_rgb_dd_top_down": dict(requires=("rgb", "discretized_depth", "top_down_view"),
                                   forbids=("depth",)),
    "vo_cnn_d_dd_top_down": dict(requires=("depth", "discretized_depth", "top_down_view"),
                                 forbids=("rgb",)),
    "vo_cnn_rgb_d_dd_top_down": dict(
        requires=("rgb", "depth", "discretized_depth", "top_down_view"), forbids=()),
    # the reference's legacy alias of the model above
    "vo_cnn_discretize_depth_top_down": dict(
        requires=("rgb", "depth", "discretized_depth", "top_down_view"), forbids=()),
    "vo_cnn_act_embed": dict(requires=("rgb", "depth"), forbids=_NO_DD_TD, act_embed=True),
    "vo_cnn_wider_act_embed": dict(requires=("rgb", "depth"), forbids=_NO_DD_TD,
                                   act_embed=True, baseplanes_mult=2),
}
VO_MODEL_NAMES = tuple(_VARIANTS)


def make_vo_model(name: str, *, observation_space: Sequence[str],
                  observation_size: Tuple[int, int], hidden_size: int = 512,
                  backbone: str = "resnet18", baseplanes: int = BASEPLANES,
                  discretized_depth_channels: int = 10,
                  dropout_p: float = DROPOUT_P,
                  compute_dtype: Optional[torch.dtype] = None) -> _VOModel:
    """Build a registered VO variant by its reference name.  The variant may
    fix the backbone (``vo_cnn_deeper``: ResNet-101) and scale
    ``baseplanes`` (the wider ones: 2x)."""
    if name not in _VARIANTS:
        raise ValueError(f"unknown VO variant {name!r}; have {VO_MODEL_NAMES}")
    spec = _VARIANTS[name]
    obs = tuple(observation_space)
    for k in spec["requires"]:
        if k not in obs:
            raise ValueError(f"{name} requires {k!r} in observation_space, got {obs}")
    for k in spec["forbids"]:
        if k in obs:
            raise ValueError(f"{name} forbids {k!r} in observation_space, got {obs}")
    cls = VOCNNActEmbed if spec.get("act_embed") else VOCNN
    return cls(obs, tuple(observation_size), hidden_size,
               discretized_depth_channels=(discretized_depth_channels
                                           if "discretized_depth" in obs else 0),
               dropout_p=dropout_p, compute_dtype=compute_dtype,
               backbone=spec.get("backbone", backbone),
               baseplanes=baseplanes * spec.get("baseplanes_mult", 1))
