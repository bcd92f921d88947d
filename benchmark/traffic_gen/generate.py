"""The general generator: a traffic file's parameters and ``--seed`` in,
the cell's inputs out.  Every seed gives the same sizes; only the scenes,
poses and the order of actions differ.

Traffic keys read here:

- ``envs``, ``bank_steps``: the closed-loop bank, ``bank_steps`` frames of
  each of ``envs`` agents, cycled; each agent's first frame starts an
  episode and each agent starts at a seeded offset into its trajectory;
- ``batch_size``, ``host_batches``, ``actions``, ``twins``, ``walkers``:
  frame-pair batches, ``host_batches`` of them, of consecutive frames whose
  action is one of ``actions`` (each entry also gives its swapped twin
  where ``twins``), collected over ``walkers`` agents;
- ``explore_p``, ``explore_actions``: the agents follow the greedy goal
  rule, or with probability ``explore_p`` take one of ``explore_actions``
  at random.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.traffic_gen import world


def _walkers(seed: int, n: int) -> List[world.Walker]:
    seqs = np.random.SeedSequence(int(seed)).spawn(n)
    return [world.Walker(s.generate_state(2, np.uint64)[0].item()) for s in seqs]


def _policy(rng: np.random.Generator, walker: world.Walker, traffic: Mapping) -> int:
    if traffic.get("explore_p", 0.0) > 0 and rng.uniform() < traffic["explore_p"]:
        return int(rng.choice(traffic["explore_actions"]))
    return walker.greedy()


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def eval_bank(traffic: Mapping, seed: int, h: int, w: int, device) -> Dict[str, np.ndarray]:
    """Step-major host arrays of a closed-loop bank: ``rgb`` ``[T, N, h, w, 3]``
    uint8, ``depth`` ``[T, N, h, w, 1]`` float32 (habitat's dtypes), and
    ``small`` ``[T, N, 4]`` float32 = (episode start, goal sensor rho and
    -phi, the action that led into the frame).  Slot ``s`` holds each
    agent's frame ``(s + offset) mod T``; ``first`` is slot 0 with every
    episode starting (the loop's first step)."""
    n, t_len = traffic["envs"], traffic["bank_steps"]
    rng = np.random.default_rng([int(seed), 1])
    trajs = []
    for walker in _walkers(seed, n):
        frames, small = [walker.frame()], [[1.0, *walker.sensor(), 0.0]]
        for _ in range(t_len - 1):
            a = _policy(rng, walker, traffic)
            over = walker.step(a)
            start = a == world.STOP or over
            if start:
                walker.reset()
            frames.append(walker.frame())
            small.append([float(start), *walker.sensor(), float(a)])
        trajs.append((frames, np.asarray(small, np.float32)))
    offsets = rng.integers(0, t_len, size=n)
    order = [trajs[e][0][(s + offsets[e]) % t_len] for s in range(t_len) for e in range(n)]
    img = world.render(order, h, w, _generator(seed, device))
    small = np.stack([np.stack([trajs[e][1][(s + offsets[e]) % t_len] for e in range(n)])
                      for s in range(t_len)])
    first = small[0].copy()
    first[:, 0] = 1.0
    return {"rgb": img["rgb"].view(t_len, n, h, w, 3).cpu().numpy(),
            "depth": img["depth"].view(t_len, n, h, w, 1).cpu().numpy(),
            "small": small, "first": first}


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.asarray([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                       w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _qrot(q, v):
    u, s = q[:3], q[3]
    return 2 * np.dot(u, v) * u + (s * s - np.dot(u, u)) * v + 2 * s * np.cross(u, v)


def local_delta(ref_pos, ref_rot, tgt_pos, tgt_rot) -> np.ndarray:
    """[dx, dz, dyaw] of the target pose in the reference pose's frame."""
    inv = ref_rot * np.asarray([-1.0, -1.0, -1.0, 1.0])
    d_pos = _qrot(inv, tgt_pos - ref_pos)
    d_rot = _qmul(inv, tgt_rot)
    if d_rot[3] < 0:
        d_rot = -d_rot
    return np.asarray([d_pos[0], d_pos[2], 2.0 * math.atan2(d_rot[1], d_rot[3])], np.float32)


def frame_pairs(traffic: Mapping, seed: int, h: int, w: int, device) -> List[Dict[str, np.ndarray]]:
    """``host_batches`` batches of consecutive frame pairs, each a dict of
    host arrays: ``prev_rgb``/``cur_rgb`` uint8 ``[E, h, w, 3]``,
    ``prev_depth``/``cur_depth`` float16 ``[E, h, w, 1]`` (E entries: the
    batch, or half of it with twins), and per sample ``actions``,
    ``gt_delta`` ``[B, 3]`` and ``data_types`` (0: as recorded, 1: the
    swapped twin, whose action is the opposite turn)."""
    twins = bool(traffic.get("twins", False))
    batch = traffic["batch_size"]
    per = batch // 2 if twins else batch
    need = per * traffic["host_batches"]
    keep_actions = set(traffic["actions"])
    rng = np.random.default_rng([int(seed), 2])
    walkers = _walkers(seed, traffic.get("walkers", 16))
    frames: List[world.Frame] = []
    cur_idx = []
    for wk in walkers:
        frames.append(wk.frame())
        cur_idx.append(len(frames) - 1)
    entries = []
    while len(entries) < need:
        for i, wk in enumerate(walkers):
            if len(entries) >= need:
                break
            a = _policy(rng, wk, traffic)
            if a == world.STOP:
                wk.reset()
                frames.append(wk.frame())
                cur_idx[i] = len(frames) - 1
                continue
            p0, r0 = wk.global_pose()
            over = wk.step(a)
            p1, r1 = wk.global_pose()
            frames.append(wk.frame())
            prev, cur_idx[i] = cur_idx[i], len(frames) - 1
            if a in keep_actions:
                entries.append((prev, cur_idx[i], a, local_delta(p0, r0, p1, r1),
                                local_delta(p1, r1, p0, r0)))
            if over:
                wk.reset()
                frames.append(wk.frame())
                cur_idx[i] = len(frames) - 1
    used = sorted({e[0] for e in entries} | {e[1] for e in entries})
    where = {f: k for k, f in enumerate(used)}
    img = world.render([frames[f] for f in used], h, w, _generator(seed, device))
    rgb = img["rgb"].cpu().numpy()
    depth = img["depth"].to(torch.float16).cpu().numpy()
    out = []
    for b in range(traffic["host_batches"]):
        part = entries[b * per:(b + 1) * per]
        pi = np.asarray([where[e[0]] for e in part])
        ci = np.asarray([where[e[1]] for e in part])
        if twins:
            flip = {world.LEFT: world.RIGHT, world.RIGHT: world.LEFT}
            acts = np.asarray([x for e in part for x in (e[2], flip[e[2]])], np.int32)
            gt = np.stack([x for e in part for x in (e[3], e[4])])
            dts = np.tile(np.asarray([0, 1], np.int32), per)
        else:
            acts = np.asarray([e[2] for e in part], np.int32)
            gt = np.stack([e[3] for e in part])
            dts = np.zeros(per, np.int32)
        out.append({"prev_rgb": rgb[pi], "cur_rgb": rgb[ci], "prev_depth": depth[pi],
                    "cur_depth": depth[ci], "actions": acts, "gt_delta": gt.astype(np.float32),
                    "data_types": dts, "twins": twins})
    return out
