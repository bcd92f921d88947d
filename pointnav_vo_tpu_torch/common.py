"""Shared constants (counterpart of ``pointnav_vo_tpu/common.py``) and the
device rule of the port's entry points."""

import torch

# Habitat discrete actions
STOP = 0
MOVE_FORWARD = 1
TURN_LEFT = 2
TURN_RIGHT = 3
N_ACTS = 4

# order of the VO expert list (vo/ensemble.py): action -> expert slot
VO_EXPERT_ACTIONS = (MOVE_FORWARD, TURN_LEFT, TURN_RIGHT)

DELTA_DIM = 3  # [dx, dz, dyaw]


def resolve_device(device=None):
    """``None`` means the card; a missing card is an error, never a quiet
    fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
