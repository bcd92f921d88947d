"""Shared constants (counterpart of ``pointnav_vo_tpu/common.py``), the
host quaternion helpers and the device rule of the port's entry points."""

import numpy as np
import torch

EPSILON = 1e-8

# Habitat discrete actions
STOP = 0
MOVE_FORWARD = 1
TURN_LEFT = 2
TURN_RIGHT = 3
N_ACTS = 4
UNIFIED = -1  # the VO expert trained on every action (action_type -1)

# checkpoint names of the VO experts (config ``all_pretrained_ckpt``)
ACT_NAME2IDX = {"forward": MOVE_FORWARD, "left": TURN_LEFT, "right": TURN_RIGHT,
                "all": UNIFIED}

# order of the VO expert list (vo/ensemble.py): action -> expert slot
VO_EXPERT_ACTIONS = (MOVE_FORWARD, TURN_LEFT, TURN_RIGHT)

# VO training samples: a frame pair as recorded, or its swapped twin
CUR_REL_TO_PREV = 0
PREV_REL_TO_CUR = 1

# noise-free action deltas [dx, dz, dyaw] (the reference's table: 10 deg turns)
NO_NOISE_DELTAS = {
    MOVE_FORWARD: [0.0, -0.25, 0.0],
    TURN_LEFT: [0.0, 0.0, float(np.radians(10))],
    TURN_RIGHT: [0.0, 0.0, float(-np.radians(10))],
}

DELTA_DIM = 3  # [dx, dz, dyaw]


# -- numpy quaternions, [x, y, z, w] -----------------------------------------


def quat_inverse(q: np.ndarray) -> np.ndarray:
    return q * np.asarray([-1, -1, -1, 1.0]) / np.sum(q * q, -1, keepdims=True)


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = np.moveaxis(a, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def quat_canonical(q: np.ndarray) -> np.ndarray:
    """The w >= 0 representative of the double cover, so one step's delta yaw
    lands in [-pi, pi]."""
    return q * np.where(q[..., 3:4] < 0, -1.0, 1.0)


def resolve_device(device=None):
    """``None`` means the card; a missing card is an error, never a quiet
    fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
