"""Rotation representation conversions (counterpart of ``ops/rotation.py``):
quaternions, matrices, Euler angles in any convention, axis-angle and the
6d representation, batched over leading dims.  Quaternions are
**[x, y, z, w]**, the package-wide habitat convention.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (xyzw) -> [..., 3, 3]."""
    x, y, z, w = torch.unbind(q, -1)
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp(n, min=1e-30)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (xyzw), Shepperd's method: all four candidate
    quaternions, the numerically dominant one chosen per element."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    # candidate i has its component i dominant: [..., case, xyzw]
    cand = torch.stack([
        torch.stack([tx, m10 + m01, m02 + m20, m21 - m12], -1),
        torch.stack([m10 + m01, ty, m21 + m12, m02 - m20], -1),
        torch.stack([m02 + m20, m21 + m12, tz, m10 - m01], -1),
        torch.stack([m21 - m12, m02 - m20, m10 - m01, tw], -1),
    ], dim=-2)
    mags = torch.stack([tx, ty, tz, tw], -1)
    case = torch.argmax(mags, dim=-1, keepdim=True)
    denom = 2.0 * torch.sqrt(torch.clamp(torch.gather(mags, -1, case), min=1e-30))
    idx = case[..., None].expand(case.shape + (4,))
    q = torch.gather(cand, -2, idx)[..., 0, :] / denom
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


_AXIS_IDX = {"X": 0, "Y": 1, "Z": 2}


def _axis_angle_matrix(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == "Y":
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """[..., 3] -> [..., 3, 3]: R = R(c0, e0) @ R(c1, e1) @ R(c2, e2)."""
    ms = [_axis_angle_matrix(c, euler[..., i]) for i, c in enumerate(convention)]
    return ms[0] @ ms[1] @ ms[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    """An outer Euler angle from one row or column of the matrix."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(m: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """[..., 3, 3] -> [..., 3], the inverse of :func:`euler_angles_to_matrix`."""
    i0, i2 = _AXIS_IDX[convention[0]], _AXIS_IDX[convention[2]]
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if (i0 - i2) in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(m[..., i0, i2] * sign, -1, 1))
    else:
        central = torch.acos(torch.clamp(m[..., i0, i0], -1, 1))
    o0 = _angle_from_tan(convention[0], convention[1], m[..., i2], False, tait_bryan)
    o2 = _angle_from_tan(convention[2], convention[1], m[..., i0, :], True, tait_bryan)
    return torch.stack([o0, central, o2], dim=-1)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] rotation vector -> [..., 4] xyzw."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angle
    sinc = torch.where(angle < 1e-6, 0.5 - angle * angle / 48.0,
                       torch.sin(half) / torch.clamp(angle, min=1e-30))
    return torch.cat([axis_angle * sinc, torch.cos(half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyzw -> [..., 3] rotation vector."""
    xyz, w = q[..., :3], q[..., 3:4]
    n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n, torch.abs(w))
    sign = torch.sign(w)
    scale = torch.where(n < 1e-12, 2.0 * sign, sign * angle / torch.clamp(n, min=1e-30))
    return xyz * scale


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two rows."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt on the two rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)
