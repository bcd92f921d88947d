"""Trajectory maps, eval videos and ranked error images, host numpy
(counterpart of ``vis/maps.py``).

The scripted world is a circular room, so its map renders analytically
(:func:`draw_top_down_map`); :class:`TrajectoryMapRenderer` rebuilds a map
of either world from the per-step ``agent_pos``/``agent_yaw``/``goal_world``
stream, and :func:`compose_map_frame` sets it beside the rgb frame, the
reference's eval video layout.  The two writers import ``cv2`` inside.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

AGENT_COLOR = (40, 80, 220)
GOAL_COLOR = (30, 180, 60)
PATH_COLOR = (220, 120, 40)
WALL_COLOR = (60, 60, 60)
UNEXPLORED_COLOR = (92, 92, 92)
EXPLORED_COLOR = (222, 222, 222)


def _draw_segments(img: np.ndarray, pts: Sequence[Tuple[int, int]]) -> None:
    """Paint the path through ``pts`` (pixel x, y) in PATH_COLOR, two
    samples a pixel of each segment's longer side, inside the image."""
    size = img.shape[0]
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        n = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in np.linspace(0, 1, 2 * n + 1):
            x = int(round(x0 + t * (x1 - x0)))
            y = int(round(y0 + t * (y1 - y0)))
            if 0 <= x < size and 0 <= y < size:
                img[y, x] = PATH_COLOR


def draw_top_down_map(trajectory: Sequence[Tuple[float, float]], goal: Tuple[float, float],
                      room_radius: float, size: int = 256) -> np.ndarray:
    """A trajectory in the circular scripted world as an RGB image: the
    wall ring, the path, the goal disk and the agent disk."""
    img = np.full((size, size, 3), 255, np.uint8)
    scale = (size / 2 - 4) / room_radius
    c = size // 2

    def to_px(p):
        return int(c + p[0] * scale), int(c + p[1] * scale)

    yy, xx = np.mgrid[0:size, 0:size]
    rr = np.sqrt((xx - c) ** 2 + (yy - c) ** 2)
    img[np.abs(rr - room_radius * scale) < 1.5] = WALL_COLOR
    _draw_segments(img, [to_px(p) for p in trajectory])
    for p, color, r in ((goal, GOAL_COLOR, 4), (trajectory[-1], AGENT_COLOR, 3)):
        x, y = to_px(p)
        img[(xx - x) ** 2 + (yy - y) ** 2 <= r * r] = color
    return img


class TrajectoryMapRenderer:
    """Incremental top-down map of one episode for eval videos, from the
    pose stream both worlds report.  Bounds are fixed at the episode's
    start from the (start, goal) box plus ``margin``; the fog of war is
    revealed one disk of ``fog_radius`` metres a step."""

    def __init__(self, start, goal, size: int = 256, fog_radius: float = 1.5,
                 margin: float = 2.0):
        self.size = size
        s = np.asarray([start[0], start[-1]], np.float64)
        g = np.asarray([goal[0], goal[-1]], np.float64)
        lo = np.minimum(s, g) - margin
        hi = np.maximum(s, g) + margin
        self.center = (lo + hi) / 2
        extent = float(max(hi[0] - lo[0], hi[1] - lo[1]))
        self.scale = (size - 8) / max(extent, 1e-6)
        self.fog = np.zeros((size, size), bool)
        self._fog_px = max(2, int(round(fog_radius * self.scale)))
        self.traj_px: List[Tuple[int, int]] = []
        self.goal_px = self._to_px(g)
        self.yaw = 0.0

    def _to_px(self, p) -> Tuple[int, int]:
        c = self.size // 2
        x = int(round(c + (p[0] - self.center[0]) * self.scale))
        y = int(round(c + (p[1] - self.center[1]) * self.scale))
        return (int(np.clip(x, 0, self.size - 1)), int(np.clip(y, 0, self.size - 1)))

    def add(self, pos, yaw: float) -> None:
        """Record one step: world position ``[x, (y,) z]`` and yaw about +y."""
        px = self._to_px(np.asarray([pos[0], pos[-1]], np.float64))
        self.traj_px.append(px)
        self.yaw = float(yaw)
        r = self._fog_px
        x, y = px
        x0, x1 = max(0, x - r), min(self.size, x + r + 1)
        y0, y1 = max(0, y - r), min(self.size, y + r + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        self.fog[y0:y1, x0:x1] |= (xx - x) ** 2 + (yy - y) ** 2 <= r * r

    def render(self) -> np.ndarray:
        size = self.size
        img = np.empty((size, size, 3), np.uint8)
        img[...] = UNEXPLORED_COLOR
        img[self.fog] = EXPLORED_COLOR
        pts = self.traj_px
        _draw_segments(img, pts)
        yy, xx = np.mgrid[0:size, 0:size]
        gx, gy = self.goal_px
        img[(xx - gx) ** 2 + (yy - gy) ** 2 <= 16] = GOAL_COLOR
        if pts:
            # the agent as a triangle pointing along its heading: forward is
            # -z, so the world heading is (-sin yaw, -cos yaw)
            ax, ay = pts[-1]
            hx, hz = -np.sin(self.yaw), -np.cos(self.yaw)
            tri = np.stack([np.asarray([ax + 6 * hx, ay + 6 * hz]),
                            np.asarray([ax - 3 * hx - 3 * hz, ay - 3 * hz + 3 * hx]),
                            np.asarray([ax - 3 * hx + 3 * hz, ay - 3 * hz - 3 * hx])])
            x0 = int(max(0, tri[:, 0].min() - 1))
            x1 = int(min(size, tri[:, 0].max() + 2))
            y0 = int(max(0, tri[:, 1].min() - 1))
            y1 = int(min(size, tri[:, 1].max() + 2))
            if x1 > x0 and y1 > y0:
                wy, wx = np.mgrid[y0:y1, x0:x1]

                def edge(a, b):
                    return (b[0] - a[0]) * (wy - a[1]) - (b[1] - a[1]) * (wx - a[0])

                e0, e1, e2 = edge(tri[0], tri[1]), edge(tri[1], tri[2]), edge(tri[2], tri[0])
                inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                          | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
                img[y0:y1, x0:x1][inside] = AGENT_COLOR
        return img


def compose_map_frame(rgb: np.ndarray, map_img: np.ndarray) -> np.ndarray:
    """``[rgb | 2-pixel white gap | map]``, the map nearest-neighbour
    resized to the rgb's height."""
    h = rgb.shape[0]
    idx = (np.arange(h) * map_img.shape[0]) // h
    resized = map_img[idx][:, (np.arange(h) * map_img.shape[1]) // h]
    sep = np.full((h, 2, 3), 255, np.uint8)
    return np.concatenate([rgb.astype(np.uint8), sep, resized], axis=1)


def generate_video(frames: List[np.ndarray], video_dir: Optional[str], video_name: str,
                   fps: int = 10, tb_writer=None, tb_step: int = 0) -> Optional[str]:
    """Write ``frames`` (RGB) as ``video_dir/video_name.mp4`` with ``cv2``
    and/or to TensorBoard; no ``video_dir`` means TensorBoard only.
    Returns the file's path or None."""
    path = None
    if video_dir:
        import cv2

        os.makedirs(video_dir, exist_ok=True)
        path = os.path.join(video_dir, f"{video_name}.mp4")
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        try:
            for f in frames:
                writer.write(np.ascontiguousarray(f[..., ::-1].astype(np.uint8)))
        finally:
            writer.release()
    if tb_writer is not None:
        tb_writer.add_video_from_np_images(f"video/{video_name}", tb_step,
                                           [f.astype(np.uint8) for f in frames], fps=fps)
    return path


def save_ranked_error_images(records: List[dict], out_dir: str, top_k: int = 20,
                             key: str = "vo_l2") -> List[str]:
    """The worst ``top_k`` records by ``key`` as PNGs (``[prev_rgb |
    cur_rgb]``) and a ``manifest.json`` of their scalar fields; returns
    the PNG paths, worst first."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    ranked = sorted(records, key=lambda r: -r[key])[:top_k]
    paths, manifest = [], []
    for rank, rec in enumerate(ranked):
        img = np.concatenate([rec["prev_rgb"], rec["cur_rgb"]], axis=1)
        p = os.path.join(out_dir, f"rank{rank:03d}_{key}{rec[key]:.4f}.png")
        if not cv2.imwrite(p, img[..., ::-1].astype(np.uint8)):
            raise OSError(f"cv2 could not write {p}")
        paths.append(p)
        manifest.append({k: float(v) if np.isscalar(v) else None
                         for k, v in rec.items() if k not in ("prev_rgb", "cur_rgb")}
                        | {key: float(rec[key]), "path": p})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return paths
