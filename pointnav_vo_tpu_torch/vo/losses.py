"""VO regression losses (counterpart of ``vo/losses.py``): the per-delta
weighted MSE with its diagnostics, and the geometric-invariance inverse
loss that ties a frame pair's prediction to its swapped twin's.

- :func:`compute_loss_weights`: the fixed branch broadcasts the multipliers;
  the other branch weighs each delta type against its own noise-free value
  (the intended semantics; the reference plugs ``dxs`` into all three).
- :func:`weighted_mse_with_diagnostics`: the sum over dx/dz/dyaw of the
  weighted mean squared error, with the abs/relative diagnostics over the
  rows that ``dz_regress_mask`` keeps.
- :func:`geo_invariance_inverse_loss`: rotations must invert
  (``(dyaw_f + dyaw_b)^2``) and positions satisfy ``p_b = -R(dyaw_b) p_f``
  in the left-handed top-down frame; dz is free for MOVE_FORWARD.

Every function takes an optional ``valid`` mask, so padded batches reduce
like unpadded ones.  The diagnostics take ``sqrt`` of a detached
difference: detached before the root, so a zero difference sends no NaN
into the gradient.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from pointnav_vo_tpu_torch.common import EPSILON, MOVE_FORWARD, NO_NOISE_DELTAS
from pointnav_vo_tpu_torch.utils.logging import device_const

DELTA_NAMES = ("dx", "dz", "dyaw")


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim=None) -> torch.Tensor:
    if mask is None:
        return x.mean() if dim is None else x.mean(dim)
    num = (x * mask).sum() if dim is None else (x * mask).sum(dim)
    den = mask.sum() if dim is None else mask.sum(dim)
    return num / torch.clamp(den, min=1.0)


def compute_loss_weights(actions: torch.Tensor, gt_deltas: torch.Tensor,
                         multiplier: Mapping[str, float], fixed: bool = True) -> torch.Tensor:
    """``[B, 3]`` per-sample per-delta loss weights."""
    mult = device_const([multiplier[k] for k in DELTA_NAMES], gt_deltas.device)
    if fixed:
        return mult.expand(gt_deltas.shape)
    table = device_const([NO_NOISE_DELTAS.get(a, [0.0, 0.0, 0.0]) for a in range(4)],
                         gt_deltas.device)
    no_noise = table[actions.long()]
    return torch.exp(mult * torch.abs(no_noise - gt_deltas))


def weighted_mse_with_diagnostics(
    pred: torch.Tensor, gt: torch.Tensor, weights: torch.Tensor,
    dz_regress_mask: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss (a scalar) and diagnostics (each ``[3]``, dx/dz/dyaw) of
    ``pred``, ``gt``, ``weights`` ``[B, 3]``; ``dz_regress_mask`` and
    ``valid`` are ``[B]`` or None.  The loss divides by the valid-row count
    (dz rows that the mask drops still count, as in the reference)."""
    diffs = (gt - pred) ** 2
    col_mask = torch.ones_like(diffs)
    if dz_regress_mask is not None:
        col_mask = torch.stack([col_mask[:, 0], dz_regress_mask.float(), col_mask[:, 2]], -1)
    if valid is not None:
        col_mask = col_mask * valid[:, None]
        denom = torch.clamp((valid[:, None] * torch.ones_like(diffs)).sum(0), min=1.0)
    else:
        denom = device_const(max(float(diffs.shape[0]), 1.0), diffs.device)
    loss = ((diffs * weights * col_mask).sum(0) / denom).sum()

    abs_diff = _masked_mean(torch.sqrt(diffs.detach()), col_mask, dim=0)
    target_mag = _masked_mean(torch.abs(gt), col_mask, dim=0) + EPSILON
    return loss, {"abs_diff": abs_diff, "target_magnitude": target_mag,
                  "relative_diff": abs_diff / target_mag}


def geo_invariance_inverse_loss(
    pred_cur_rel_to_prev: torch.Tensor, pred_prev_rel_to_cur: torch.Tensor,
    actions: torch.Tensor, valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse-consistency loss over ``[P, 3]`` prediction pairs (a frame
    pair and its swapped twin); ``actions`` ``[P]`` are the primaries'.
    Returns (loss, abs_diff_rot ``[]``, abs_diff_pos ``[2]``)."""
    fwd, bwd = pred_cur_rel_to_prev, pred_prev_rel_to_cur
    rot_diffs = (fwd[:, 2] + bwd[:, 2]) ** 2
    loss_rot = _masked_mean(rot_diffs, valid)
    abs_rot = _masked_mean(torch.sqrt(rot_diffs.detach()), valid)

    # left-handed 2D rotation by the twin's yaw (habitat: -z is forward)
    cy, sy = torch.cos(bwd[:, 2]), torch.sin(bwd[:, 2])
    pred_pos_bwd = torch.stack([cy * fwd[:, 0] + sy * fwd[:, 1],
                                -sy * fwd[:, 0] + cy * fwd[:, 1]], -1)
    pos_diffs = (bwd[:, :2] + pred_pos_bwd) ** 2
    dz_on = torch.where(actions.long() == MOVE_FORWARD, 0.0, 1.0).to(pos_diffs.dtype)
    pos_diffs = pos_diffs * torch.stack([torch.ones_like(cy), dz_on], -1)
    vmask2 = None if valid is None else valid[:, None] * torch.ones_like(pos_diffs)
    loss_pos = _masked_mean(pos_diffs, vmask2)
    abs_pos = _masked_mean(torch.sqrt(pos_diffs.detach()),
                           None if valid is None else valid[:, None], dim=0)
    return loss_rot + loss_pos, abs_rot, abs_pos
