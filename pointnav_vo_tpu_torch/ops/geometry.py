"""SE(2)/quaternion geometry for VO dead-reckoning (counterpart of
``ops/geometry.py``), batched over leading dims.

Conventions (Habitat's): quaternions ``[..., 4]`` in [x, y, z, w] order;
positions ``[..., 3]`` with -z forward and +y up; a local SE(2) delta is
``[..., 3]`` = [dx, dz, dyaw] with dyaw a rotation about +y.
"""

from __future__ import annotations

import math

import torch

from pointnav_vo_tpu_torch.utils.logging import device_const


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * device_const((-1.0, -1.0, -1.0, 1.0), q.device, q.dtype)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a (possibly non-unit) quaternion."""
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    return quat_conjugate(q) / torch.clamp(sq, min=1e-30)


def quat_rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (Rodrigues form with two cross products)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    xyz, v = torch.broadcast_tensors(xyz, v)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_from_yaw(dyaw: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation of ``dyaw`` radians about +y."""
    half = 0.5 * dyaw
    z = torch.zeros_like(dyaw)
    return torch.stack([z, torch.sin(half), z, torch.cos(half)], dim=-1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw as ``2 * atan2(q_y, q_w)``, how the reference's dataset derives
    the regression target."""
    return 2.0 * torch.atan2(q[..., 1], q[..., 3])


def agent_state_target2ref(ref_rot: torch.Tensor, ref_pos: torch.Tensor,
                           tgt_rot: torch.Tensor, tgt_pos: torch.Tensor):
    """The target agent state in the reference agent's local frame:
    delta_rot = ref_rot^-1 * tgt_rot, delta_pos = ref_rot^-1 . (tgt_pos - ref_pos)."""
    inv_ref = quat_inverse(ref_rot)
    return (quat_multiply(inv_ref, tgt_rot),
            quat_rotate_vector(inv_ref, tgt_pos - ref_pos))


def delta_state_from_poses(ref_rot: torch.Tensor, ref_pos: torch.Tensor,
                           tgt_rot: torch.Tensor, tgt_pos: torch.Tensor) -> torch.Tensor:
    """The [dx, dz, dyaw] regression target from two global poses: the
    target in the reference's frame, its (x, z) and its yaw."""
    delta_rot, delta_pos = agent_state_target2ref(ref_rot, ref_pos, tgt_rot, tgt_pos)
    return torch.stack([delta_pos[..., 0], delta_pos[..., 2], yaw_from_quat(delta_rot)],
                       dim=-1)


def compute_global_state(prev_rot: torch.Tensor, prev_pos: torch.Tensor,
                         delta: torch.Tensor):
    """Integrate a local [dx, dz, dyaw] delta into a global pose:
    v2 = v1 + q1 . [dx, 0, dz];  q2 = q1 * quat_from_yaw(dyaw)."""
    dx, dz, dyaw = delta.unbind(-1)
    local_pos = torch.stack([dx, torch.zeros_like(dx), dz], dim=-1)
    cur_pos = prev_pos + quat_rotate_vector(prev_rot, local_pos)
    cur_rot = quat_multiply(prev_rot, quat_from_yaw(dyaw))
    return cur_rot, cur_pos


def cartesian_to_polar(x: torch.Tensor, y: torch.Tensor):
    """(rho, phi) with phi = atan2(y, x), Habitat's convention."""
    return torch.sqrt(x * x + y * y), torch.atan2(y, x)


def compute_goal_pos(prev_goal: torch.Tensor, delta: torch.Tensor) -> dict:
    """Propagate an agent-local cartesian point-goal through an SE(2) delta:
    g' = q_dyaw^-1 . (g - [dx, 0, dz]); polar = [rho, -phi] with
    (rho, phi) = cartesian_to_polar(-g'_z, g'_x)."""
    dx, dz, dyaw = delta.unbind(-1)
    local_pos = torch.stack([dx, torch.zeros_like(dx), dz], dim=-1)
    cur_goal = quat_rotate_vector(quat_inverse(quat_from_yaw(dyaw)),
                                  prev_goal - local_pos)
    rho, phi = cartesian_to_polar(-cur_goal[..., 2], cur_goal[..., 0])
    return {"cartesian": cur_goal, "polar": torch.stack([rho, -phi], dim=-1)}


def pointgoal_polar2cartesian(polar: torch.Tensor) -> torch.Tensor:
    """Invert the [rho, -phi] point-goal encoding to agent-local cartesian."""
    rho = polar[..., 0]
    phi = -polar[..., 1]
    x = rho * torch.sin(phi)
    z = -rho * torch.cos(phi)
    return torch.stack([x, torch.zeros_like(x), z], dim=-1)


def get_polar_angle(rot: torch.Tensor) -> torch.Tensor:
    """The agent's heading in map coordinates: the polar angle of its
    forward axis (-z) minus pi/2."""
    heading = quat_rotate_vector(quat_inverse(rot),
                                 device_const((0.0, 0.0, -1.0), rot.device, rot.dtype))
    _, phi = cartesian_to_polar(-heading[..., 2], heading[..., 0])
    return phi - math.pi / 2.0
