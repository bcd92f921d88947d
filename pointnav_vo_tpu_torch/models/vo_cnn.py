"""Visual-odometry CNN (counterpart of ``models/vo_cnn.py``): whitening ->
GroupNorm ResNet18 over the channel-stacked observation pair -> 3x3
compression conv to ~2048 flat features -> dropout/linear trunk -> SE(2)
delta head.

Dropout acts before ``visual_fc`` and before ``output_head`` when the caller
gives keep masks or a ``torch.Generator`` to draw them from
(:func:`draw_dropout_masks`), and only then: ``.train()`` does not switch it
on.  The masks are explicit so that a run on the card and one on the CPU
can share them.

The encoder takes the PACKED stem input ``[B, H, W, C]`` (NHWC, as the JAX
package's public layout): per frame rgb/255, depth, discretized depth and
top-down view, the previous frame's blocks first (see
``vo/ensemble.py::pack_frame_features``).  The features are flattened in
CHW order, as the reference's checkpoints expect.

Only the deployed variant ``vo_cnn_rgb_d_dd_top_down`` is built here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pointnav_vo_tpu_torch.common import DELTA_DIM
from pointnav_vo_tpu_torch.models import resnet as resnet_lib
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar

# per-pair channel counts
RGB_PAIR_CHANNEL = 6
DEPTH_PAIR_CHANNEL = 2
TOP_DOWN_VIEW_PAIR_CHANNEL = 2
BASEPLANES = 32
AFTER_COMPRESSION_FLAT_SIZE = 2048
DROPOUT_P = 0.2  # the trunk's dropout (VO.MODEL.dropout_p)


def compression_channels(fh: int, fw: int) -> int:
    """round(2048 / (fh * fw)) channels for an fh x fw compressed map."""
    return int(round(AFTER_COMPRESSION_FLAT_SIZE / (fh * fw)))


class VOEncoder(nn.Module):
    """Observation-pair encoder: whitening -> backbone -> compression conv."""

    def __init__(self, observation_space: Sequence[str], observation_size: Tuple[int, int],
                 discretized_depth_channels: int = 0):
        super().__init__()
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
        self.backbone = resnet_lib.resnet18(c, base_planes=BASEPLANES,
                                            ngroups=BASEPLANES // 2)
        ch = self.output_shape[0]
        self.compression = nn.Sequential(
            nn.Conv2d(self.backbone.final_channels, ch, 3, padding=1, bias=False),
            resnet_lib.group_norm(1, ch),
            nn.ReLU(True),
        )

    def forward(self, packed: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """packed: ``[B, H, W, input_channels]`` -> ``[B, C, fh, fw]``."""
        if packed.shape[-1] != self.input_channels:
            raise ValueError(f"packed stem input has {packed.shape[-1]} channels, "
                             f"expected {self.input_channels}")
        # the module's own dtype: float32, or float64 for a reference run
        x = packed.to(self.running_mean_and_var._mean.dtype).permute(0, 3, 1, 2)
        x = self.running_mean_and_var(x, update_stats, stats_mask)
        return self.compression(self.backbone(x))


DropoutMasks = Tuple[torch.Tensor, torch.Tensor]


class VOCNN(nn.Module):
    """Encoder + dropout/linear trunk + delta-pose head.

    Keys: ``visual_encoder.*``, ``visual_fc.2`` (Flatten, Dropout, Linear,
    ReLU) and ``output_head.1`` (Dropout, Linear).  The Dropout entries hold
    the key positions only; :meth:`trunk` applies the keep masks itself."""

    def __init__(self, observation_space, observation_size, hidden_size: int = 512,
                 discretized_depth_channels: int = 0, dropout_p: float = DROPOUT_P):
        super().__init__()
        self.dropout_p = dropout_p
        self.visual_encoder = VOEncoder(observation_space, observation_size,
                                        discretized_depth_channels)
        self.flat_size = math.prod(self.visual_encoder.output_shape)
        self.hidden_size = hidden_size
        self.visual_fc = nn.Sequential(
            nn.Flatten(), nn.Dropout(dropout_p), nn.Linear(self.flat_size, hidden_size),
            nn.ReLU(True))
        self.output_head = nn.Sequential(nn.Dropout(dropout_p),
                                         nn.Linear(hidden_size, DELTA_DIM))

    def trunk(self, feats: torch.Tensor, masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Flat features ``[n, flat]`` -> delta ``[..., n, 3]``.  ``masks``
        (keep masks ``[..., n, flat]`` and ``[..., n, hidden]``) switch the
        dropout on; a leading pass axis ``[k, n, ...]`` runs the k passes as
        one batched product, each pass computed alike, so equal masks give
        equal passes."""
        fc, head = self.visual_fc[2], self.output_head[1]
        if masks is None:
            return head(torch.relu(fc(feats)))
        keep = 1.0 - self.dropout_p
        x = torch.relu(_linear(fc, feats * (masks[0].float() / keep)))
        return _linear(head, x * (masks[1].float() / keep))

    def forward(self, packed: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        """Delta ``[B, 3]`` of packed pairs.  Dropout is on where ``masks``
        are given, or drawn from ``generator``; off otherwise."""
        feats = self.visual_encoder(packed, update_stats, stats_mask).flatten(1)
        if masks is None and generator is not None:
            masks = draw_dropout_masks(generator, (feats.shape[0],), self.flat_size,
                                       self.hidden_size, self.dropout_p)
        return self.trunk(feats, masks)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``; for ``[k, n, d]`` input a batched product over k (a
    plain ``layer`` folds k into the rows of one GEMM, whose rows may round
    apart)."""
    if x.dim() == 2:
        return layer(x)
    k, n = x.shape[:2]
    return torch.baddbmm(layer.bias.expand(k, n, -1), x, layer.weight.t().expand(k, -1, -1))


def draw_dropout_masks(generator: torch.Generator, lead: Tuple[int, ...], flat: int,
                       hidden: int, p: float) -> DropoutMasks:
    """Keep masks (True: kept) ``[*lead, flat]`` and ``[*lead, hidden]`` on
    the generator's device: uniform draws below ``1 - p``, as
    ``jax.random.bernoulli`` keeps."""
    dev = generator.device

    def draw(width):
        return torch.rand(*lead, width, generator=generator, device=dev) < 1.0 - p

    return draw(flat), draw(hidden)


_VARIANTS = {
    "vo_cnn_rgb_d_dd_top_down": ("rgb", "depth", "discretized_depth", "top_down_view"),
}
VO_MODEL_NAMES = tuple(_VARIANTS)


def make_vo_model(name: str, *, observation_space: Sequence[str],
                  observation_size: Tuple[int, int], hidden_size: int = 512,
                  discretized_depth_channels: int = 10,
                  dropout_p: float = DROPOUT_P) -> VOCNN:
    """Build a registered VO variant by its reference name."""
    if name not in _VARIANTS:
        raise ValueError(f"VO variant {name!r} is not ported; have {tuple(_VARIANTS)}")
    obs = tuple(observation_space)
    if set(obs) != set(_VARIANTS[name]):
        raise ValueError(f"{name} needs observation_space {_VARIANTS[name]}, got {obs}")
    return VOCNN(obs, tuple(observation_size), hidden_size,
                 discretized_depth_channels=discretized_depth_channels, dropout_p=dropout_p)
