"""Classical (non-learned) VO backend (counterpart of ``vo/classical.py``),
``VO.VO_TYPE: CLASSICAL``: the paper's baseline beside the learned VO.

ORB keypoints matched between the previous and the current rgb frame are
unprojected through their depth maps to 3D camera-frame point sets; the
relative pose is the least-squares rigid transform between them (3D-3D, so
no essential-matrix scale ambiguity).  Where matching fails (a textureless
view, too few matches) or the alignment's mean residual exceeds
``max_residual``, the estimate falls back to the commanded action's nominal
motion.

Detection, matching and unprojection are data-dependent host work per env
(``cv2``, imported inside the functions), as in the JAX package.  The
alignment is not: :class:`ClassicalVO` pads every env's matched point sets
to the largest count, uploads them once, and solves all envs as one batched
weighted Kabsch on the device (``ops.classical_vo.rigid_transform_3d``);
the residual gate and the prior fallback are ``torch.where``, so the
choice between the match and the prior is the JAX backend's, env for env.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import (
    MOVE_FORWARD,
    N_ACTS,
    TURN_LEFT,
    TURN_RIGHT,
    resolve_device,
)
from pointnav_vo_tpu_torch.ops.classical_vo import rigid_transform_3d


def unproject_depth(pix: np.ndarray, depth_norm: np.ndarray, hfov_deg: float,
                    min_depth: float, max_depth: float) -> np.ndarray:
    """Pinhole unprojection of pixel coords ``[N, 2]`` (x, y) through a
    normalized depth map ``[H, W]`` in [0, 1] (meters = min + v * (max -
    min)), square pixels.  Returns ``[3, N]`` camera-frame points: x right,
    y up, z backward (the camera looks along -z, habitat's convention)."""
    h, w = depth_norm.shape
    fx = (w / 2.0) / np.tan(np.radians(hfov_deg) / 2.0)
    xs = pix[:, 0].astype(np.int64).clip(0, w - 1)
    ys = pix[:, 1].astype(np.int64).clip(0, h - 1)
    z = min_depth + depth_norm[ys, xs] * (max_depth - min_depth)
    x = (pix[:, 0] - w / 2.0) / fx * z
    y = (pix[:, 1] - h / 2.0) / fx * z
    return np.stack([x, -y, -z], axis=0)


def delta_from_matches(pts_prev, pts_cur) -> torch.Tensor:
    """``[dx, dz, dyaw]`` of the current camera pose in the previous
    camera's frame from matched 3D point sets (``[..., 3, N]`` each, the
    same physical points): world-fixed points satisfy ``p_prev = R p_cur +
    t``, so one Kabsch solve gives the pose and dyaw reads off R's
    y-rotation.  Returns ``[..., 3]`` float32 on the inputs' device."""
    pts_prev = torch.as_tensor(pts_prev, dtype=torch.float32)
    pts_cur = torch.as_tensor(pts_cur, dtype=torch.float32, device=pts_prev.device)
    r, t = rigid_transform_3d(pts_cur, pts_prev)
    return torch.stack([t[..., 0], t[..., 2], torch.atan2(r[..., 0, 2], r[..., 0, 0])], -1)


def action_prior(action: int, forward_step: float = 0.25,
                 turn_angle_deg: float = 30.0) -> np.ndarray:
    """Nominal motion of the commanded action: the fallback estimate (and
    the trivial dead-reckoning baseline); zeros for STOP."""
    if action == MOVE_FORWARD:
        return np.asarray([0.0, -forward_step, 0.0], np.float32)
    if action == TURN_LEFT:
        return np.asarray([0.0, 0.0, np.radians(turn_angle_deg)], np.float32)
    if action == TURN_RIGHT:
        return np.asarray([0.0, 0.0, -np.radians(turn_angle_deg)], np.float32)
    return np.zeros(3, np.float32)


def _match_orb(prev_rgb: np.ndarray, cur_rgb: np.ndarray, n_features: int, ratio: float):
    """ORB keypoints of both frames matched by Lowe's ratio test: the
    matched pixel coords ``([K, 2], [K, 2])`` float64, or None under 8
    keypoints or 8 matches."""
    import cv2

    orb = cv2.ORB_create(nfeatures=n_features)
    g0 = cv2.cvtColor(prev_rgb.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    g1 = cv2.cvtColor(cur_rgb.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    k0, d0 = orb.detectAndCompute(g0, None)
    k1, d1 = orb.detectAndCompute(g1, None)
    if d0 is None or d1 is None or len(k0) < 8 or len(k1) < 8:
        return None
    matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
    knn = matcher.knnMatch(d0, d1, k=2)
    good = [m for pair in knn if len(pair) == 2
            for m, n in [pair] if m.distance < ratio * n.distance]
    if len(good) < 8:
        return None
    p0 = np.asarray([k0[m.queryIdx].pt for m in good], np.float64)
    p1 = np.asarray([k1[m.trainIdx].pt for m in good], np.float64)
    return p0, p1


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ClassicalVO:
    """The classical ``vo_fn(prev_obs, new_obs, actions, infos) -> (delta
    [N, 3], std [N, 3])`` of the Evaluator's and the trainer's hook, both on
    ``device`` (``None``: the card).  ``std`` is the per-axis mean absolute
    alignment residual, 0 where the prior was used.

    A call is :meth:`match` (host) then :meth:`solve` (device).  The
    counters ``env_steps`` and ``matched`` (host ints), ``accepted`` (a
    device count, read without a sync until asked) and ``host_s`` (seconds
    of host matching) add up over calls."""

    def __init__(self, hfov_deg: float = 70.0, min_depth: float = 0.1,
                 max_depth: float = 10.0, forward_step: float = 0.25,
                 turn_angle_deg: float = 30.0, n_features: int = 500, ratio: float = 0.75,
                 max_residual: float = 0.25, device=None):
        self.device = resolve_device(device)
        self.hfov_deg, self.min_depth, self.max_depth = hfov_deg, min_depth, max_depth
        self.n_features, self.ratio, self.max_residual = n_features, ratio, max_residual
        self.prior_table = torch.as_tensor(
            np.stack([action_prior(a, forward_step, turn_angle_deg) for a in range(N_ACTS)]),
            device=self.device)
        self.env_steps = 0
        self.matched = 0
        self.accepted = torch.zeros((), dtype=torch.int64, device=self.device)
        self.host_s = 0.0

    def match(self, prev_obs: Dict, new_obs: Dict) -> Optional[np.ndarray]:
        """Host work: each env's ORB matches unprojected through both depth
        maps, packed ``[N, 7, K]`` float32 (rows 0-2 the previous frame's
        points, 3-5 the current frame's, 6 the weights: 1 for a matched
        point, 0 for padding), K the largest match count; None where no env
        matched."""
        t0 = time.perf_counter()
        prev_rgb, cur_rgb = _host(prev_obs["rgb"]), _host(new_obs["rgb"])
        prev_depth = _host(prev_obs["depth"])[..., 0]
        cur_depth = _host(new_obs["depth"])[..., 0]
        n = prev_rgb.shape[0]
        sets: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for i in range(n):
            m = _match_orb(prev_rgb[i], cur_rgb[i], self.n_features, self.ratio)
            if m is not None:
                p0, p1 = m
                m = (unproject_depth(p0, prev_depth[i], self.hfov_deg, self.min_depth,
                                     self.max_depth),
                     unproject_depth(p1, cur_depth[i], self.hfov_deg, self.min_depth,
                                     self.max_depth))
            sets.append(m)
        self.env_steps += n
        k = max((s[0].shape[1] for s in sets if s is not None), default=0)
        packed = None
        if k:
            packed = np.zeros((n, 7, k), np.float32)
            for i, s in enumerate(sets):
                if s is not None:
                    c = s[0].shape[1]
                    packed[i, 0:3, :c] = s[0]
                    packed[i, 3:6, :c] = s[1]
                    packed[i, 6, :c] = 1.0
                    self.matched += 1
        self.host_s += time.perf_counter() - t0
        return packed

    def solve(self, packed: Optional[np.ndarray], actions) -> Tuple[torch.Tensor, ...]:
        """Device work: the batched weighted Kabsch of :meth:`match`'s
        packed sets, the residual gate and the prior fallback.  Returns
        (delta ``[N, 3]``, std ``[N, 3]``, accepted ``[N]`` bool)."""
        acts = torch.as_tensor(np.asarray(actions, np.int64).reshape(-1), device=self.device)
        prior = self.prior_table[acts]
        if packed is None:
            none = torch.zeros(acts.shape[0], dtype=torch.bool, device=self.device)
            return prior, torch.zeros_like(prior), none
        p = torch.from_numpy(packed).to(self.device)
        pts_prev, pts_cur, w = p[:, 0:3], p[:, 3:6], p[:, 6]
        r, t = rigid_transform_3d(pts_cur, pts_prev, w)
        cand = torch.stack([t[:, 0], t[:, 2], torch.atan2(r[:, 0, 2], r[:, 0, 0])], dim=-1)
        resid = r @ pts_cur + t[..., None] - pts_prev  # [N, 3, K]
        count = w.sum(dim=-1)
        per_count = torch.clamp(count, min=1.0)
        mean_resid = (torch.linalg.norm(resid, dim=1) * w).sum(dim=-1) / per_count
        std = (resid.abs() * w[:, None, :]).sum(dim=-1) / per_count[:, None]
        accepted = ((count > 0) & (mean_resid <= self.max_residual)
                    & torch.isfinite(cand).all(dim=-1))
        keep = accepted[:, None]
        return (torch.where(keep, cand, prior), torch.where(keep, std, torch.zeros_like(std)),
                accepted)

    def __call__(self, prev_obs: Dict, new_obs: Dict, actions, infos=None):
        delta, std, accepted = self.solve(self.match(prev_obs, new_obs), actions)
        self.accepted += accepted.sum()
        return delta, std


def make_classical_vo_fn(hfov_deg: float = 70.0, min_depth: float = 0.1,
                         max_depth: float = 10.0, forward_step: float = 0.25,
                         turn_angle_deg: float = 30.0, n_features: int = 500,
                         ratio: float = 0.75, max_residual: float = 0.25,
                         device=None) -> ClassicalVO:
    """The classical vo_fn for the Evaluator's and the trainer's ``vo_fn``
    hook.  ``max_residual``: the mean 3D alignment residual (meters) above
    which a match set is unreliable and the action prior is used instead."""
    return ClassicalVO(hfov_deg, min_depth, max_depth, forward_step, turn_angle_deg,
                       n_features, ratio, max_residual, device)
