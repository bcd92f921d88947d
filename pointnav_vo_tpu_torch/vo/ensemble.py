"""Action-conditioned VO ensemble (counterpart of ``vo/ensemble.py``).

Three experts (forward, left, right; :data:`common.VO_EXPERT_ACTIONS`)
regress the SE(2) delta between two frames.  Each frame's features are
computed once (:func:`frame_features_packed`) and the previous frame's are
reused on the next step.  Every sample runs only its own expert: the host
groups the rows by action, and each non-empty group is gathered with
``index_select``, run, and written back with ``index_copy_``.  GroupNorm is
per sample, so grouping does not change any result.

Two modes, as in the JAX package: ``det`` gives one delta per sample;
``rnd`` gives the mean and the population std over ``rnd_mode_n`` dropout
passes.  Dropout sits on the FC trunk only, so rnd mode runs each expert's
encoder once and its trunk once for all passes.  The whitening statistics
stay frozen in both modes.

Two precisions, as ``VOInferenceConfig.dtype`` there: ``precision="bf16"``
emits the features and runs the experts in bfloat16 (parameters, whitening
statistics and the deltas stay float32).  ``cache_dtype="int8"`` stores the
packed features as int8 (every channel lies in [0, 1]; scale 127, rounded
and clipped), and each expert's rows are dequantized into the compute dtype
after the selection.  The selection is ``index_select`` in every dtype.

The pair functions (:func:`preprocess_obs_pairs` and the twin-expanding
:func:`preprocess_obs_pairs_twins`, each with a ``_packed`` form) assemble
the training batches of ``vo/engine.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import VO_EXPERT_ACTIONS, resolve_device
from pointnav_vo_tpu_torch.models.vo_cnn import (
    DROPOUT_P,
    VOCNN,
    DropoutMasks,
    VOCNNActEmbed,
    draw_dropout_masks,
    make_vo_model,
)
from pointnav_vo_tpu_torch.ops.depth import discretize_depth
from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, top_down_view_batch
from pointnav_vo_tpu_torch.ops.transforms import TRANSFORMS, apply_obs_transform


@dataclasses.dataclass(frozen=True)
class VOInferenceConfig:
    """Static configuration of the VO inference path."""

    model_name: str = "vo_cnn_rgb_d_dd_top_down"
    observation_space: Tuple[str, ...] = ("rgb", "depth", "discretized_depth",
                                          "top_down_view")
    vis_size_w: int = 341
    vis_size_h: int = 192
    hidden_size: int = 512
    backbone: str = "resnet18"
    discretized_depth_channels: int = 10
    # VO.OBS_TRANSFORM: "none" | "resize" | "resize_crop" | "resize_nearest"
    obs_transform: str = "none"
    min_depth: float = 0.1
    max_depth: float = 10.0
    hfov: float = 70.0  # consumed as "radians": the reference's quirk
    dropout_p: float = DROPOUT_P
    mode: str = "det"  # "det" | "rnd"
    rnd_mode_n: int = 10
    # a string, not a torch.dtype: the config is stored in checkpoints
    precision: str = "fp32"  # "fp32" | "bf16"
    cache_dtype: str = "native"  # "native" (the compute dtype) | "int8"

    def __post_init__(self):
        if self.mode not in ("det", "rnd"):
            raise ValueError(f"mode must be 'det' or 'rnd', got {self.mode!r}")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16', got {self.precision!r}")
        if self.cache_dtype not in ("native", "int8"):
            raise ValueError(f"cache_dtype must be 'native' or 'int8', got {self.cache_dtype!r}")
        if self.obs_transform not in TRANSFORMS:
            raise ValueError(f"obs_transform must be one of {TRANSFORMS}, "
                             f"got {self.obs_transform!r}")

    @property
    def dtype(self) -> torch.dtype:
        """The features' and the experts' compute dtype."""
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    @property
    def model_dtype(self) -> Optional[torch.dtype]:
        """``VOCNN.compute_dtype``: bfloat16, or None (the parameters' own
        dtype: float32, or float64 for a reference run)."""
        return torch.bfloat16 if self.precision == "bf16" else None

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
            backbone=self.backbone,
            discretized_depth_channels=self.discretized_depth_channels,
            dropout_p=self.dropout_p,
            compute_dtype=self.model_dtype,
        )


def frame_features(rgb: torch.Tensor, depth: torch.Tensor,
                   cfg: VOInferenceConfig) -> Dict[str, torch.Tensor]:
    """Per-frame channels: rgb ``[B,H,W,3]``, depth ``[B,H,W,1]``,
    discretized_depth ``[B,H,W,dd]``, top_down_view ``[B,H,W,1]``; computed
    in float32 (the top-down counts binned, then normalised), emitted in
    the compute dtype.  ``cfg.obs_transform`` resizes the stacked rgb and
    depth first, so every feature is derived from the resized depth."""
    rgb = rgb.float()
    depth = depth.float()
    if cfg.obs_transform != "none":
        stacked = apply_obs_transform(torch.cat([rgb, depth], dim=-1), cfg.obs_transform,
                                      (cfg.vis_size_w, cfg.vis_size_h))
        rgb, depth = stacked[..., :3], stacked[..., 3:]
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
    return {k: v.to(cfg.dtype) for k, v in feats.items()}


# stem channel order of the VO encoder: per frame rgb/255, depth,
# discretized_depth, top_down_view; the stem input is concat(prev, cur)
_PACK_ORDER = ("rgb", "depth", "discretized_depth", "top_down_view")


def pack_frame_features(feats: Mapping[str, torch.Tensor],
                        cfg: VOInferenceConfig) -> torch.Tensor:
    """One ``[B, H, W, C]`` block in stem channel order in the compute
    dtype, rgb scaled by 1/255 in it (a true division: a device tensor, not
    a host scalar, see ``ops/topdown.py::pixel_bins``); with
    ``cache_dtype="int8"``, ``clip(round(x * 127), 0, 127)`` as int8."""
    parts = []
    for k in _PACK_ORDER:
        if k in feats:
            v = feats[k].to(cfg.dtype)
            if k == "rgb":
                v = v / v.new_tensor(255.0)
            parts.append(v)
    pack = torch.cat(parts, dim=-1)
    if cfg.cache_dtype == "int8":
        pack = torch.clamp(torch.round(pack.float() * 127.0), 0, 127).to(torch.int8)
    return pack


def dequantize_rows(rows: torch.Tensor, cfg: VOInferenceConfig) -> torch.Tensor:
    """Selected rows of a packed cache as the experts' input: an int8 cache
    times 1/127, both in the compute dtype; any other cache as it is."""
    if rows.dtype != torch.int8:
        return rows
    # a 0-dim host tensor: a scalar operand, no upload
    return rows.to(cfg.dtype) * torch.tensor(1.0 / 127.0, dtype=cfg.dtype)


def frame_features_packed(rgb: torch.Tensor, depth: torch.Tensor,
                          cfg: VOInferenceConfig) -> torch.Tensor:
    """Per-frame packed stem block: ``cat(prev_pack, cur_pack)`` is the
    encoder's stem input."""
    return pack_frame_features(frame_features(rgb, depth, cfg), cfg)


def pair_from_features(prev_feats: Mapping[str, torch.Tensor],
                       cur_feats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The (prev, cur) channel-concatenated pair of each feature."""
    return {k: torch.cat([prev_feats[k], cur_feats[k]], dim=-1) for k in prev_feats}


def _twin_expand(primary: torch.Tensor, swapped: torch.Tensor) -> torch.Tensor:
    """Interleave: row 2k is ``primary[k]``, row 2k+1 is ``swapped[k]``."""
    return torch.stack([primary, swapped], dim=1).reshape(
        (primary.shape[0] * 2,) + tuple(primary.shape[1:]))


def preprocess_obs_pairs(prev_rgb, prev_depth, cur_rgb, cur_depth,
                         cfg: VOInferenceConfig) -> Dict[str, torch.Tensor]:
    """Per-key pair channels: rgb ``[B,H,W,6]``, depth ``[B,H,W,2]``,
    discretized_depth ``[B,H,W,2*dd]``, top_down_view ``[B,H,W,2]``."""
    return pair_from_features(frame_features(prev_rgb, prev_depth, cfg),
                              frame_features(cur_rgb, cur_depth, cfg))


def preprocess_obs_pairs_packed(prev_rgb, prev_depth, cur_rgb, cur_depth,
                                cfg: VOInferenceConfig) -> torch.Tensor:
    """The encoder's packed stem input ``[B, H, W, 2C]`` of frame pairs."""
    return torch.cat([frame_features_packed(prev_rgb, prev_depth, cfg),
                      frame_features_packed(cur_rgb, cur_depth, cfg)], dim=-1)


def preprocess_obs_pairs_twins(prev_rgb, prev_depth, cur_rgb, cur_depth,
                               cfg: VOInferenceConfig) -> Dict[str, torch.Tensor]:
    """Twin expansion of E entries into 2E samples, each frame's features
    computed once: sample 2k pairs (prev[k], cur[k]), sample 2k+1 the
    swapped (cur[k], prev[k])."""
    fp = frame_features(prev_rgb, prev_depth, cfg)
    fc = frame_features(cur_rgb, cur_depth, cfg)
    return {k: _twin_expand(torch.cat([fp[k], fc[k]], dim=-1),
                            torch.cat([fc[k], fp[k]], dim=-1)) for k in fp}


def preprocess_obs_pairs_twins_packed(prev_rgb, prev_depth, cur_rgb, cur_depth,
                                      cfg: VOInferenceConfig) -> torch.Tensor:
    """:func:`preprocess_obs_pairs_twins` as the packed stem block."""
    fp = frame_features_packed(prev_rgb, prev_depth, cfg)
    fc = frame_features_packed(cur_rgb, cur_depth, cfg)
    return _twin_expand(torch.cat([fp, fc], dim=-1), torch.cat([fc, fp], dim=-1))


def check_compute_dtype(experts: Sequence[VOCNN], cfg: VOInferenceConfig) -> None:
    """Refuse modules whose ``compute_dtype`` is not ``cfg.model_dtype``:
    the caller decides an expert's precision when it builds the module
    (``cfg.make_model()``), and nothing changes it afterwards."""
    for m in experts:
        if m.compute_dtype != cfg.model_dtype:
            raise ValueError(f"an expert computes in {m.compute_dtype}, the config's "
                             f"precision {cfg.precision!r} needs {cfg.model_dtype}")


def expert_rows(actions_np) -> list:
    """Per expert, the host row indices of the samples it runs.  STOP and
    any id outside 1..3 clip into the nearest expert (STOP -> forward)."""
    acts = np.asarray(actions_np).astype(np.int64).reshape(-1)
    expert_idx = np.clip(acts - 1, 0, len(VO_EXPERT_ACTIONS) - 1)
    return [np.nonzero(expert_idx == e)[0] for e in range(len(VO_EXPERT_ACTIONS))]


def pass_mean_std(samples: torch.Tensor):
    """Mean and population std over the pass axis of ``[k, ...]``, both
    taken about the first pass: equal passes give that pass and a std of
    exactly 0 (a plain mean of k equal floats may round off the value)."""
    first = samples[0]
    mean = first + (samples - first).mean(0)
    return mean, (samples - mean).square().mean(0).sqrt()


class VOEnsemble:
    """Three VO experts with an own-expert forward, det or rnd."""

    def __init__(self, cfg: VOInferenceConfig,
                 state_dicts: Sequence[Mapping[str, torch.Tensor]] = None,
                 device=None, experts: Sequence[VOCNN] = None):
        """Pass ``state_dicts`` (one per expert, in VO_EXPERT_ACTIONS order;
        loaded with ``strict=True``) or ready ``experts`` modules built for
        ``cfg``'s precision (:func:`check_compute_dtype`).  An act-embed
        variant is refused: the ensemble runs one expert per action and
        passes no action ids, as the JAX ensemble does."""
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
        if any(isinstance(m, VOCNNActEmbed) for m in experts):
            raise ValueError(f"VOEnsemble runs per-action experts; the act-embed variant "
                             f"{cfg.model_name!r} cannot be one")
        check_compute_dtype(experts, cfg)
        self.experts = [m.to(self.device).eval() for m in experts]

    @classmethod
    def from_torch_checkpoints(cls, cfg: VOInferenceConfig, ckpt_paths: Mapping[str, str],
                               device=None) -> "VOEnsemble":
        """The experts of ``{"forward": path, "left": path, "right": path}``
        reference ``.pth`` files (the ``all_pretrained_ckpt`` layout of
        ``configs/rl/ddppo_pointnav.yaml``)."""
        from pointnav_vo_tpu_torch.common import ACT_NAME2IDX
        from pointnav_vo_tpu_torch.io.weights import load_vo_checkpoint

        return cls(cfg, [load_vo_checkpoint(ckpt_paths[name], ACT_NAME2IDX[name])
                         for name in ("forward", "left", "right")], device=device)

    @torch.no_grad()
    def predict_packed(self, obs_pairs: torch.Tensor, actions_np) -> torch.Tensor:
        """Det delta ``[B, 3]`` (float32) of packed pairs ``[B, H, W, 2C]``;
        each sample runs the expert of its host action."""
        out = torch.zeros((obs_pairs.shape[0], 3), dtype=torch.float32,
                          device=obs_pairs.device)
        for expert, rows in zip(self.experts, expert_rows(actions_np)):
            if rows.size == 0:
                continue
            idx = torch.from_numpy(rows).to(obs_pairs.device)
            sub = dequantize_rows(obs_pairs.index_select(0, idx), self.cfg)
            out.index_copy_(0, idx, expert(sub).float())
        return out

    def draw_masks(self, generator: torch.Generator, batch: int) -> DropoutMasks:
        """The keep masks of one rnd call, ``[rnd_mode_n, batch, flat]`` and
        ``[rnd_mode_n, batch, hidden]``, in batch row order."""
        m = self.experts[0]
        return draw_dropout_masks(generator, (self.cfg.rnd_mode_n, batch), m.flat_size,
                                  m.hidden_size, self.cfg.dropout_p)

    @torch.no_grad()
    def predict_rnd_packed(self, obs_pairs: torch.Tensor, actions_np,
                           generator: Optional[torch.Generator] = None,
                           masks: Optional[DropoutMasks] = None):
        """rnd mode: (mean, std) ``[B, 3]`` over ``rnd_mode_n`` dropout passes
        of each sample's own expert, std the population std.  The keep masks
        are ``masks`` (see :meth:`draw_masks`) or drawn from ``generator``.
        Each expert's encoder runs once; its trunk runs all passes at once."""
        batch = obs_pairs.shape[0]
        if masks is None:
            if generator is None:
                raise ValueError("rnd mode needs dropout masks or a generator")
            masks = self.draw_masks(generator, batch)
        k = self.cfg.rnd_mode_n
        samples = torch.zeros((k, batch, 3), dtype=torch.float32, device=obs_pairs.device)
        for expert, rows in zip(self.experts, expert_rows(actions_np)):
            if rows.size == 0:
                continue
            idx = torch.from_numpy(rows).to(obs_pairs.device)
            sub = dequantize_rows(obs_pairs.index_select(0, idx), self.cfg)
            feats = expert.visual_encoder(sub).flatten(1)
            own = (masks[0].index_select(1, idx), masks[1].index_select(1, idx))
            samples.index_copy_(1, idx, expert.trunk(feats, own).float())
        return pass_mean_std(samples)

    def predict(self, obs_pairs: torch.Tensor, actions_np,
                generator: Optional[torch.Generator] = None):
        """(delta, std) ``[B, 3]`` of packed pairs ``[B, H, W, 2C]``, each
        sample through the expert of its host action: det mode's std is
        zero; rnd mode draws its keep masks from ``generator``."""
        if self.cfg.mode == "det":
            delta = self.predict_packed(obs_pairs, actions_np)
            return delta, torch.zeros_like(delta)
        return self.predict_rnd_packed(obs_pairs, actions_np, generator)

    @torch.no_grad()
    def compute_local_delta_states_from_vo(self, prev_rgb, prev_depth, cur_rgb, cur_depth,
                                           actions_np, generator=None):
        """The reference's public API batched over the envs, both frames'
        features computed here (the unfused eval path: two ``bin_counts``
        launches).  Returns (delta, std, ``{"ego_top_down_view": [B, H, W,
        2]}``), the view None where the config has no top-down channel."""
        prev = frame_features(prev_rgb, prev_depth, self.cfg)
        cur = frame_features(cur_rgb, cur_depth, self.cfg)
        obs = torch.cat([pack_frame_features(prev, self.cfg),
                         pack_frame_features(cur, self.cfg)], dim=-1)
        delta, std = self.predict(obs, actions_np, generator)
        tdv = (torch.cat([prev["top_down_view"], cur["top_down_view"]], dim=-1)
               if "top_down_view" in prev else None)
        return delta, std, {"ego_top_down_view": tdv}

    @torch.no_grad()
    def predict_step_cached(self, prev_feats: torch.Tensor, cur_rgb: torch.Tensor,
                            cur_depth: torch.Tensor, actions_np):
        """Steady-state det step: features of the new frame only, paired with
        the cached previous ones.  Returns (delta ``[B, 3]``, cur_feats);
        feed ``cur_feats`` (in the cache's dtype) back on the next call."""
        if self.cfg.mode != "det":
            raise ValueError("predict_step_cached is the det step; rnd mode runs "
                             "predict_rnd_packed")
        cur_feats = frame_features_packed(cur_rgb, cur_depth, self.cfg)
        obs = torch.cat([prev_feats, cur_feats], dim=-1)
        return self.predict_packed(obs, actions_np), cur_feats
