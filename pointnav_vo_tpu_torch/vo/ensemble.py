"""Action-conditioned VO ensemble, det mode (counterpart of
``vo/ensemble.py``).

Three experts (forward, left, right; :data:`common.VO_EXPERT_ACTIONS`)
regress the SE(2) delta between two frames.  Each frame's features are
computed once (:func:`frame_features_packed`) and the previous frame's are
reused on the next step.  In det mode every sample runs only its own
expert: the host groups the rows by action, and each non-empty group is
gathered with ``index_select``, run, and written back with ``index_copy_``.
GroupNorm is per sample, so grouping does not change any result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import VO_EXPERT_ACTIONS, resolve_device
from pointnav_vo_tpu_torch.models.vo_cnn import VOCNN, make_vo_model
from pointnav_vo_tpu_torch.ops.depth import discretize_depth
from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, top_down_view_batch


@dataclasses.dataclass(frozen=True)
class VOInferenceConfig:
    """Static configuration of the det fp32 VO inference path."""

    model_name: str = "vo_cnn_rgb_d_dd_top_down"
    observation_space: Tuple[str, ...] = ("rgb", "depth", "discretized_depth",
                                          "top_down_view")
    vis_size_w: int = 341
    vis_size_h: int = 192
    hidden_size: int = 512
    discretized_depth_channels: int = 10
    min_depth: float = 0.1
    max_depth: float = 10.0
    hfov: float = 70.0  # consumed as "radians": the reference's quirk

    @property
    def topdown_params(self) -> TopDownParams:
        return TopDownParams(min_depth=self.min_depth, max_depth=self.max_depth,
                             vis_size_h=self.vis_size_h, vis_size_w=self.vis_size_w,
                             hfov_rad=self.hfov)

    def make_model(self) -> VOCNN:
        return make_vo_model(
            self.model_name,
            observation_space=self.observation_space,
            observation_size=(self.vis_size_w, self.vis_size_h),
            hidden_size=self.hidden_size,
            discretized_depth_channels=self.discretized_depth_channels,
        )


def frame_features(rgb: torch.Tensor, depth: torch.Tensor,
                   cfg: VOInferenceConfig) -> Dict[str, torch.Tensor]:
    """Per-frame channels: rgb ``[B,H,W,3]``, depth ``[B,H,W,1]``,
    discretized_depth ``[B,H,W,dd]``, top_down_view ``[B,H,W,1]``."""
    rgb = rgb.float()
    depth = depth.float()
    feats: Dict[str, torch.Tensor] = {}
    if "rgb" in cfg.observation_space:
        feats["rgb"] = rgb
    if "depth" in cfg.observation_space:
        feats["depth"] = depth
    if "discretized_depth" in cfg.observation_space:
        feats["discretized_depth"] = discretize_depth(
            depth[..., 0], cfg.discretized_depth_channels)
    if "top_down_view" in cfg.observation_space:
        feats["top_down_view"] = top_down_view_batch(
            depth[..., 0], cfg.topdown_params)[..., None]
    return feats


# stem channel order of the VO encoder: per frame rgb/255, depth,
# discretized_depth, top_down_view; the stem input is concat(prev, cur)
_PACK_ORDER = ("rgb", "depth", "discretized_depth", "top_down_view")


def pack_frame_features(feats: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One ``[B, H, W, C]`` block in stem channel order, rgb scaled by 1/255
    (a true division: a device tensor, not a host scalar, see
    ``ops/topdown.py::pixel_bins``)."""
    parts = []
    for k in _PACK_ORDER:
        if k in feats:
            v = feats[k].float()
            if k == "rgb":
                v = v / v.new_tensor(255.0)
            parts.append(v)
    return torch.cat(parts, dim=-1)


def frame_features_packed(rgb: torch.Tensor, depth: torch.Tensor,
                          cfg: VOInferenceConfig) -> torch.Tensor:
    """Per-frame packed stem block: ``cat(prev_pack, cur_pack)`` is the
    encoder's stem input."""
    return pack_frame_features(frame_features(rgb, depth, cfg))


def expert_rows(actions_np) -> list:
    """Per expert, the host row indices of the samples it runs.  STOP and
    any id outside 1..3 clip into the nearest expert (STOP -> forward)."""
    acts = np.asarray(actions_np).astype(np.int64).reshape(-1)
    expert_idx = np.clip(acts - 1, 0, len(VO_EXPERT_ACTIONS) - 1)
    return [np.nonzero(expert_idx == e)[0] for e in range(len(VO_EXPERT_ACTIONS))]


class VOEnsemble:
    """Three VO experts with a det own-expert forward."""

    def __init__(self, cfg: VOInferenceConfig,
                 state_dicts: Sequence[Mapping[str, torch.Tensor]] = None,
                 device=None, experts: Sequence[VOCNN] = None):
        """Pass ``state_dicts`` (one per expert, in VO_EXPERT_ACTIONS order;
        loaded with ``strict=True``) or ready ``experts`` modules."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if experts is None:
            if state_dicts is None or len(state_dicts) != len(VO_EXPERT_ACTIONS):
                raise ValueError("need one state dict per expert")
            experts = []
            for sd in state_dicts:
                m = cfg.make_model()
                m.load_state_dict(sd, strict=True)
                experts.append(m)
        self.experts = [m.to(self.device).eval() for m in experts]

    @torch.no_grad()
    def predict_packed(self, obs_pairs: torch.Tensor, actions_np) -> torch.Tensor:
        """Det delta ``[B, 3]`` of packed pairs ``[B, H, W, 2C]``; each sample
        runs the expert of its host action."""
        out = torch.zeros((obs_pairs.shape[0], 3), dtype=torch.float32,
                          device=obs_pairs.device)
        for expert, rows in zip(self.experts, expert_rows(actions_np)):
            if rows.size == 0:
                continue
            idx = torch.from_numpy(rows).to(obs_pairs.device)
            out.index_copy_(0, idx, expert(obs_pairs.index_select(0, idx)).float())
        return out

    @torch.no_grad()
    def predict_step_cached(self, prev_feats: torch.Tensor, cur_rgb: torch.Tensor,
                            cur_depth: torch.Tensor, actions_np):
        """Steady-state det step: features of the new frame only, paired with
        the cached previous ones.  Returns (delta ``[B, 3]``, cur_feats);
        feed ``cur_feats`` back on the next call."""
        cur_feats = frame_features_packed(cur_rgb, cur_depth, self.cfg)
        obs = torch.cat([prev_feats, cur_feats], dim=-1)
        return self.predict_packed(obs, actions_np), cur_feats
