"""Goal propagation and pose dead-reckoning through a local [dx, dz, dyaw]
delta (Habitat's frame: -z forward, +y up, quaternions [x, y, z, w])."""

from __future__ import annotations

import torch


def qmul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def qrot(q, v):
    """Rotate v by unit q: R(q) v written out."""
    x, y, z, w = q.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([
        (1 - 2 * (y * y + z * z)) * vx + 2 * (x * y - z * w) * vy + 2 * (x * z + y * w) * vz,
        2 * (x * y + z * w) * vx + (1 - 2 * (x * x + z * z)) * vy + 2 * (y * z - x * w) * vz,
        2 * (x * z - y * w) * vx + 2 * (y * z + x * w) * vy + (1 - 2 * (x * x + y * y)) * vz,
    ], -1)


def yaw_quat(dyaw):
    z = torch.zeros_like(dyaw)
    return torch.stack([z, torch.sin(dyaw / 2), z, torch.cos(dyaw / 2)], -1)


def polar_to_cart(polar):
    """[rho, -phi] -> agent-local [x, 0, z]."""
    rho, phi = polar[..., 0], -polar[..., 1]
    x = rho * torch.sin(phi)
    return torch.stack([x, torch.zeros_like(x), -rho * torch.cos(phi)], -1)


def propagate_goal(goal_cart, delta, reset, sensor_polar):
    """The goal in the new frame: rotate ``goal - [dx, 0, dz]`` by -dyaw;
    re-seeded from the sensor where ``reset`` [N, 1] is set.  Returns
    (cartesian, polar [rho, -phi])."""
    dx, dz, dyaw = delta.unbind(-1)
    moved = goal_cart - torch.stack([dx, torch.zeros_like(dx), dz], -1)
    new = qrot(yaw_quat(-dyaw), moved)
    new = torch.where(reset > 0, polar_to_cart(sensor_polar), new)
    x, y = -new[..., 2], new[..., 0]
    return new, torch.stack([torch.sqrt(x * x + y * y), -torch.atan2(y, x)], -1)


def integrate_pose(rot, pos, delta, reset, seed_rot, seed_pos):
    dx, dz, dyaw = delta.unbind(-1)
    new_pos = pos + qrot(rot, torch.stack([dx, torch.zeros_like(dx), dz], -1))
    new_rot = qmul(rot, yaw_quat(dyaw))
    return (torch.where(reset > 0, seed_rot, new_rot), torch.where(reset > 0, seed_pos, new_pos))
