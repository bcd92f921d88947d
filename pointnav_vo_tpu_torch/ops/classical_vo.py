"""Classical-VO geometry (counterpart of ``ops/classical_vo.py``): the Kabsch
alignment, relative transforms and the essential-matrix pose.

:func:`rigid_transform_3d` solves any number of point-set pairs at once
(leading batch dims), each optionally with per-point weights, so point sets
of different sizes solve as one call on the device when padded to the
largest with weight 0.  The essential-matrix pose runs OpenCV's RANSAC on
the host, as the JAX package's does; ``cv2`` is imported inside it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.ops.rotation import matrix_to_euler_angles


def rigid_transform_3d(a: torch.Tensor, b: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares rigid transform R, t with b ~ R @ a + t (Kabsch).

    a, b: ``[..., 3, N]`` point sets; ``weights`` ``[..., N]`` weigh each
    point in the means and the cross-covariance (0 leaves a padded point
    out; a set with no weight solves as if its points were all at 0).
    Reflections are corrected by flipping the last singular direction.
    Returns R ``[..., 3, 3]`` and t ``[..., 3]``.
    """
    if weights is None:
        ca = a.mean(dim=-1, keepdim=True)
        cb = b.mean(dim=-1, keepdim=True)
        h = (a - ca) @ (b - cb).transpose(-1, -2)
    else:
        w = weights.to(a.dtype)[..., None, :]
        count = torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
        ca = (a * w).sum(dim=-1, keepdim=True) / count
        cb = (b * w).sum(dim=-1, keepdim=True) / count
        h = ((a - ca) * w) @ (b - cb).transpose(-1, -2)
    u, _s, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    r = (v * flip[..., None, :]) @ ut
    t = -r @ ca + cb
    return r, t[..., 0]


def get_relative_transform(transform1: torch.Tensor, transform2: torch.Tensor):
    """Relative transform between two ``[3|4, 4]`` poses: ``[R_12 | t_12] =
    [R1^-1 R2 | R1^-1 (t2 - t1)]``, with its XYZ Euler angles.  Returns
    (euler ``[3]``, t ``[3]``, R ``[3, 3]``)."""
    r1, t1 = transform1[:3, :3], transform1[:3, 3]
    r2, t2 = transform2[:3, :3], transform2[:3, 3]
    rel_r = r1.T @ r2
    rel_t = r1.T @ (t2 - t1)
    return matrix_to_euler_angles(rel_r, "XYZ"), rel_t, rel_r


def validate_rot_mat(r: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Whether ``r`` ``[3, 3]`` is orthonormal with determinant 1 (a bool
    tensor)."""
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    ortho = torch.linalg.norm(eye - r.T @ r) < eps
    posdet = torch.abs(torch.linalg.det(r) - 1.0) < eps
    return ortho & posdet


def estimate_pose_by_essential_mat(kpts0, kpts1, intrinsics, thresh: float = 1.0,
                                   conf: float = 0.99999) -> Optional[list]:
    """RANSAC essential-matrix pose from keypoint matches ``[N, 2]`` each,
    on the host with ``cv2``: None under 5 matches or without a solution,
    else the ``(inliers, R, t, mask)`` of every decomposition tied for the
    most inliers."""
    if kpts0.shape[0] < 5:
        return None
    import cv2

    k0 = np.asarray(kpts0, np.float32)
    k1 = np.asarray(kpts1, np.float32)
    intr = np.asarray(intrinsics, np.float64)
    e, mask = cv2.findEssentialMat(k0, k1, intr, threshold=thresh, prob=conf,
                                   method=cv2.RANSAC)
    if e is None:
        return None
    best = []
    best_inliers = 0
    for chunk in np.split(e, e.shape[0] // 3):
        n, r, t, m = cv2.recoverPose(chunk, k0, k1, intr, mask=mask.copy())
        if n > best_inliers:
            best_inliers = n
            best = [(n, r, t[:, 0], m)]
        elif n == best_inliers:
            best.append((n, r, t[:, 0], m))
    return best


def rel_pose_coord_to_camera_change(r_cur_rel_prev: torch.Tensor,
                                    t_cur_rel_prev: torch.Tensor):
    """A change of coordinate basis -> the camera's motion: (R^T, -R^T t)
    with t as a ``[3, 1]`` column."""
    r = r_cur_rel_prev.T
    t = -r @ t_cur_rel_prev.reshape(3, 1)
    return r, t
