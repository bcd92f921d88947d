"""A frozen copy of the scripted PointNav world: the dynamics and the
greedy goal rule on the host (numpy), the renderer batched over frames on
the device (torch).

The agent lives in a circular room of radius 3-8 m with a stripe texture
keyed by the wall angle.  Forward steps are 0.25 m, turns 30 degrees, with
Gaussian actuation noise (multiplier 0.5); a move that would come within
0.2 m of the wall is blocked.  Depth is the ray's distance to the wall,
foreshortened away from the horizon, with 1 % multiplicative noise,
normalised over [0.1, 10] m; rgb carries Gaussian noise of 2.55 levels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3
HFOV_DEG = 70.0
MIN_DEPTH, MAX_DEPTH = 0.1, 10.0
FORWARD_STEP = 0.25
TURN_DEG = 30.0
SUCCESS_DISTANCE = 0.36
MAX_EPISODE_STEPS = 500
ACTUATION_NOISE = 0.5
RGB_NOISE = 0.1
DEPTH_NOISE = 1.0
ROOM_RADIUS = (3.0, 8.0)


def polar_goal(pos, yaw, goal) -> np.ndarray:
    """Habitat's pointgoal_with_gps_compass: [rho, -phi]."""
    rel = goal - pos
    ca, sa = math.cos(-yaw), math.sin(-yaw)
    lx = ca * rel[0] + sa * rel[1]
    lz = -sa * rel[0] + ca * rel[1]
    return np.asarray([math.hypot(lx, lz), -math.atan2(lx, -lz)], np.float32)


@dataclasses.dataclass
class Frame:
    """What the renderer needs of one frame, and the pose it was taken at."""

    pos: np.ndarray
    yaw: float
    radius: float
    freq: float
    phase: float


class Walker:
    """One scripted agent: episodes drawn from its own ``default_rng``."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.reset()

    def reset(self) -> None:
        r = self.rng
        self.radius = float(r.uniform(*ROOM_RADIUS))
        self.freq = float(r.uniform(3, 9))
        self.phase = float(r.uniform(0, 2 * np.pi))
        rmax = self.radius - 0.5
        self.pos = r.uniform(-rmax / 2, rmax / 2, size=2)
        self.yaw = float(r.uniform(-np.pi, np.pi))
        while True:
            goal = r.uniform(-rmax, rmax, size=2)
            if np.linalg.norm(goal) < rmax and 1.0 < np.linalg.norm(goal - self.pos) < 2 * rmax:
                break
        self.goal = goal
        self.steps = 0

    def frame(self) -> Frame:
        return Frame(self.pos.copy(), self.yaw, self.radius, self.freq, self.phase)

    def sensor(self) -> np.ndarray:
        return polar_goal(self.pos, self.yaw, self.goal)

    def global_pose(self):
        """(position [x, 0, z], quaternion [x, y, z, w] of the yaw about +y)."""
        return (np.asarray([self.pos[0], 0.0, self.pos[1]]),
                np.asarray([0.0, math.sin(self.yaw / 2), 0.0, math.cos(self.yaw / 2)]))

    def greedy(self) -> int:
        """Turn toward the goal until roughly facing it, else forward; STOP
        within the success distance."""
        if np.linalg.norm(self.goal - self.pos) < SUCCESS_DISTANCE:
            return STOP
        bearing = -self.sensor()[1]
        if abs(bearing) > math.radians(TURN_DEG) / 2:
            return LEFT if bearing < 0 else RIGHT
        return FORWARD

    def step(self, action: int) -> bool:
        """Apply ``action``; True where the episode is over."""
        self.steps += 1
        if action == STOP:
            return True
        r, m = self.rng, ACTUATION_NOISE
        if action == FORWARD:
            dx, dz = r.normal(0, 0.01) * m, -FORWARD_STEP + r.normal(0, 0.02) * m
            dyaw = r.normal(0, math.radians(1.0)) * m
        else:
            dx, dz = r.normal(0, 0.005) * m, r.normal(0, 0.005) * m
            sign = 1.0 if action == LEFT else -1.0
            dyaw = sign * math.radians(TURN_DEG) + r.normal(0, math.radians(1.5)) * m
        ca, sa = math.cos(self.yaw), math.sin(self.yaw)
        new = self.pos + np.asarray([ca * dx + sa * dz, -sa * dx + ca * dz])
        if np.linalg.norm(new) > self.radius - 0.2:
            new = self.pos
        self.pos = new
        self.yaw = float(self.yaw + dyaw)
        return self.steps >= MAX_EPISODE_STEPS


@torch.no_grad()
def render(frames: List[Frame], h: int, w: int, generator: torch.Generator,
           chunk: int = 256) -> Dict[str, torch.Tensor]:
    """rgb ``[F, h, w, 3]`` uint8 and depth ``[F, h, w, 1]`` float32 on the
    generator's device, ``chunk`` frames at a time."""
    dev = generator.device
    half = math.radians(HFOV_DEG) / 2.0
    f = (w / 2.0) / math.tan(half)
    cols = torch.atan2(torch.arange(w, device=dev, dtype=torch.float64) + 0.5 - w / 2.0,
                       torch.tensor(f, dtype=torch.float64, device=dev))
    rows = (torch.arange(h, device=dev, dtype=torch.float64) + 0.5) / h - 0.5
    vert = (1.0 / (1.0 + 2.0 * rows.abs())).float()
    rgbs, depths = [], []
    for s in range(0, len(frames), chunk):
        part = frames[s:s + chunk]
        p = torch.tensor(np.stack([fr.pos for fr in part]), dtype=torch.float64, device=dev)
        prm = torch.tensor([[fr.yaw, fr.radius, fr.freq, fr.phase] for fr in part],
                           dtype=torch.float64, device=dev)
        ang = prm[:, :1] + cols[None]  # [n, w]
        d = torch.stack([-torch.sin(ang), -torch.cos(ang)], -1)
        b = 2 * (d * p[:, None, :]).sum(-1)
        c = (p * p).sum(-1, keepdim=True) - prm[:, 1:2] ** 2
        t = torch.clamp((-b + torch.sqrt(torch.clamp(b * b - 4 * c, min=0.0))) / 2.0,
                        min=MIN_DEPTH).float()
        n = len(part)
        depth = t[:, None, :] * vert[None, :, None]
        depth = depth + torch.randn(depth.shape, generator=generator, device=dev) * 0.01 * (
            depth * DEPTH_NOISE)
        depth = torch.clamp((depth - MIN_DEPTH) / (MAX_DEPTH - MIN_DEPTH), 0.0, 1.0)
        depths.append(depth[..., None])
        freq, phase = prm[:, 2:3], prm[:, 3:4]
        col = torch.stack([(torch.sin(freq * ang + phase) + 1) / 2,
                           (torch.sin(2.3 * freq * ang) + 1) / 2,
                           torch.clamp(t.double() / MAX_DEPTH, 0, 1)], -1).float()  # [n, w, 3]
        rgb = col[:, None] * (0.4 + 0.6 * vert)[None, :, None, None] * 255.0
        rgb = rgb + torch.randn((n, h, w, 3), generator=generator, device=dev) * (
            RGB_NOISE * 255.0 * 0.1)
        rgbs.append(torch.clamp(rgb, 0, 255).to(torch.uint8))
    return {"rgb": torch.cat(rgbs), "depth": torch.cat(depths)}
