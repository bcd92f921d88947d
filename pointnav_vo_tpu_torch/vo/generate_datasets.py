"""Dataset-generation CLI with the reference's argument surface
(counterpart of ``vo/generate_datasets.py``).

Scene lists of the Gibson v1 and v2 splits, the ``act_type`` save filter,
the Bernoulli ``rnd_p`` keep probability, one size and name a split, the
Resizer / ResizeCenterCropper observation transforms and ``{name}_{N}.h5``
output names, over the pluggable generator
(:func:`pointnav_vo_tpu_torch.vo.dataset.generate_dataset`):

- ``--backend habitat`` rolls habitat envs behind
  :class:`~pointnav_vo_tpu_torch.rl.envs.HabitatNavEnv` with habitat's
  ShortestPathFollower; ``--backend scripted`` (``auto`` picks it where
  habitat is missing) the scripted world and the oracle follower, in the
  same schema;
- ``--workers N`` forks N writers, ``{name}_{N}.w{i}.h5`` each, which read
  as one dataset;
- ``--device cuda|cpu`` is the observation transform's device (the card
  where not given; a missing card is an error).  With ``--workers`` above
  1 a forked child of its own makes that check, so the parent never
  initialises CUDA and its forked writers can still use the card.

The reference TRAIN.md command::

    python -m pointnav_vo_tpu_torch.vo.generate_datasets \\
        --train_scene_dir dataset/habitat_datasets/pointnav/gibson/v2/train/content \\
        --val_scene_dir dataset/habitat_datasets/pointnav/gibson/v2/val/content \\
        --save_dir dataset/vo_dataset \\
        --data_version v2 --vis_size_w 341 --vis_size_h 192 \\
        --obs_transform none --act_type -1 --rnd_p 1.0 \\
        --N_list 1000000 50000 --name_list train val
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import multiprocessing as mp
import os
from typing import List, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device


def scene_list_v2(content_dir: str) -> List[str]:
    """Scene names of a v2 split's ``content/*.json.gz`` directory."""
    files = glob.glob(os.path.join(content_dir, "*.json.gz"))
    return sorted(os.path.basename(f).split(".")[0] for f in files)


def scene_list_v1(val_json_gz: str) -> List[str]:
    """Scene names of a v1 monolithic ``val.json.gz`` episode file."""
    with gzip.open(val_json_gz, "rt") as f:
        episodes = json.loads(f.read())["episodes"]
    out: List[str] = []
    for ep in episodes:
        name = os.path.basename(ep["scene_id"]).split(".")[0]
        if name not in out:
            out.append(name)
    return sorted(out)


def _check_card(device: torch.device, conn) -> None:
    """:func:`resolve_device` in a forked child: sends its error, or ''."""
    try:
        resolve_device(device)
        conn.send("")
    except RuntimeError as e:
        conn.send(str(e))
    conn.close()


def transform_device(name: str, workers: int = 1) -> torch.device:
    """``--device`` as a device; a missing card raises.  Where ``workers``
    writers are to be forked, the check runs in a forked child: any CUDA
    query here (``torch.cuda.is_available`` asks the CUDA runtime) would
    leave the writers unable to use the card."""
    device = torch.device(name)
    if device.type != "cuda" or workers <= 1:
        return resolve_device(device)
    ctx = mp.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_check_card, args=(device, send))
    proc.start()
    send.close()
    try:
        err = recv.recv()
    except EOFError:
        err = "the card check's process died"
    proc.join()
    if err:
        raise RuntimeError(err)
    return device


def make_obs_transform(kind: str, vis_w: int, vis_h: int, device="cuda"):
    """``f(image_hwc) -> image_hwc`` on numpy: the reference's Resizer or
    ResizeCenterCropper (``ops/transforms.py::apply_obs_transform``) run on
    ``device`` in the image's dtype; None for ``none``."""
    if kind in (None, "none"):
        return None
    from pointnav_vo_tpu_torch.ops.transforms import apply_obs_transform

    def tf(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        return apply_obs_transform(x, kind, (vis_w, vis_h)).cpu().numpy()

    return tf


def habitat_spf_follower(env):
    """ShortestPathFollower over the HabitatNavEnv adapter, the reference's
    data-collection policy; 0 (STOP) ends the episode."""
    from habitat.tasks.nav.shortest_path_follower import ShortestPathFollower

    hab = env._env
    sim = getattr(hab, "sim", None) or getattr(hab, "_sim")
    goal_radius = None
    if getattr(hab, "episodes", None):
        goal_radius = hab.episodes[0].goals[0].radius
    if goal_radius is None:
        goal_radius = env.cfg.forward_step
    follower = ShortestPathFollower(sim, goal_radius, False)

    def f(env, obs):
        goal = env._env.current_episode.goals[0].position
        action = follower.get_next_action(goal)
        return 0 if action is None else int(action)

    return f


def _resolve_spec(spec: str):
    """A ``module:callable`` spec's callable."""
    import importlib

    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)


def _env_cfg_from_task(task, vis_w: int, vis_h: int, native_size: bool):
    """The generator's EnvConfig from a task config.  With ``native_size``
    (``--obs_transform none``) the env renders at the vis size, as the
    reference's challenge yaml does."""
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig

    sim = task.SIMULATOR
    return EnvConfig(
        image_h=vis_h if native_size else sim.DEPTH_SENSOR.HEIGHT,
        image_w=vis_w if native_size else sim.DEPTH_SENSOR.WIDTH,
        hfov_deg=sim.DEPTH_SENSOR.HFOV,
        min_depth=sim.DEPTH_SENSOR.MIN_DEPTH,
        max_depth=sim.DEPTH_SENSOR.MAX_DEPTH,
        forward_step=sim.get("FORWARD_STEP_SIZE", 0.25),
        turn_angle_deg=sim.TURN_ANGLE,
        max_episode_steps=task.ENVIRONMENT.MAX_EPISODE_STEPS,
        success_distance=task.TASK.SUCCESS_DISTANCE,
        actuation_noise_multiplier=sim.NOISE_MODEL.NOISE_MULTIPLIER,
        rgb_noise_intensity=sim.RGB_SENSOR.NOISE_MODEL_KWARGS.intensity_constant,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate VO frame-pair HDF5 datasets "
                    "(reference generate_datasets.py CLI surface)")
    p.add_argument("--config_f", type=str, default=None,
                   help="task config yaml (defaults to the bundled "
                        "Challenge-2020 task config)")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--act_type", type=int, default=-1,
                   help="-1 saves all actions; 1/2/3 saves only that action")
    p.add_argument("--rnd_p", type=float, default=1.0,
                   help="Bernoulli keep probability per step pair")
    p.add_argument("--N_list", nargs="+", type=int, required=True)
    p.add_argument("--name_list", nargs="+", type=str, required=True,
                   choices=["train", "val"])
    p.add_argument("--data_version", type=str, default="v2", choices=["v1", "v2"])
    p.add_argument("--train_scene_dir", type=str, default=None)
    p.add_argument("--val_scene_dir", type=str, default=None)
    p.add_argument("--vis_size_w", type=int, default=341)
    p.add_argument("--vis_size_h", type=int, default=192)
    p.add_argument("--obs_transform", type=str, default="none",
                   choices=["none", "resize", "resize_crop"])
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "scripted", "habitat"])
    p.add_argument("--workers", type=int, default=1,
                   help=">1 fans generation over processes, one shard file "
                        "each ({name}_{N}.w{i}.h5)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--follower", type=str, default=None,
                   help="module:callable follower factory override")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="the observation transform's device (default: the card)")
    return p


def generate_split(name: str, n: int, args, task, scenes: Optional[List[str]]) -> List[str]:
    """One split; returns the files written."""
    from pointnav_vo_tpu_torch.vo.dataset import generate_dataset, generate_dataset_parallel

    backend = args.backend
    if backend == "auto":
        try:
            import habitat  # noqa: F401
            backend = "habitat"
        except ImportError:
            backend = "scripted"

    env_cfg = _env_cfg_from_task(task, args.vis_size_w, args.vis_size_h,
                                 native_size=args.obs_transform == "none")
    # main checked the device; a forked writer initialises the card itself
    obs_tf = make_obs_transform(args.obs_transform, args.vis_size_w, args.vis_size_h,
                                torch.device(args.device))
    valid = None if args.act_type == -1 else (args.act_type,)

    env_factory = follower_factory = factory_kwargs = None
    if backend == "habitat":
        from pointnav_vo_tpu_torch.rl.envs import HabitatNavEnv, split_scenes

        task_dict = task.to_dict()
        task_dict.setdefault("DATASET", {})["SPLIT"] = name
        if args.obs_transform == "none":
            # render at the save size (the challenge yaml's own sensors);
            # resize and resize_crop keep config_f's sensors and transform
            for sensor in ("RGB_SENSOR", "DEPTH_SENSOR"):
                task_dict["SIMULATOR"][sensor]["WIDTH"] = args.vis_size_w
                task_dict["SIMULATOR"][sensor]["HEIGHT"] = args.vis_size_h
        env_factory = HabitatNavEnv
        follower_factory = habitat_spf_follower
        n_workers = max(1, args.workers)
        splits = split_scenes(scenes, n_workers) if scenes else [None] * n_workers
        factory_kwargs = [{"task_config": task_dict, "content_scenes": splits[i]}
                          for i in range(n_workers)]
    if args.follower:
        follower_factory = _resolve_spec(args.follower)

    out = os.path.join(args.save_dir, f"{name}_{n}.h5")
    if args.workers > 1:
        return generate_dataset_parallel(
            out[:-len(".h5")], n, args.workers, env_factory=env_factory,
            follower_factory=follower_factory, env_cfg=env_cfg, rnd_p=args.rnd_p,
            seed=args.seed, valid_actions=valid, obs_transform=obs_tf,
            factory_kwargs=factory_kwargs)

    ef = env_factory
    if ef is not None:
        ef = lambda cfg, seed: env_factory(cfg, seed=seed, **factory_kwargs[0])  # noqa: E731
    generate_dataset(out, n, env_factory=ef, follower_factory=follower_factory,
                     env_cfg=env_cfg, rnd_p=args.rnd_p, seed=args.seed, valid_actions=valid,
                     obs_transform=obs_tf)
    return [out]


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if len(args.N_list) != len(args.name_list):
        raise SystemExit("--N_list and --name_list must pair up")
    transform_device(args.device, args.workers)

    from pointnav_vo_tpu_torch.config.defaults import get_task_config

    task = get_task_config(args.config_f)
    os.makedirs(args.save_dir, exist_ok=True)
    for name, n in zip(args.name_list, args.N_list):
        scenes: Optional[List[str]] = None
        if name == "train" and args.train_scene_dir:
            scenes = scene_list_v2(args.train_scene_dir)
        elif name == "val" and args.val_scene_dir:
            scenes = (scene_list_v2(args.val_scene_dir) if args.data_version == "v2"
                      else scene_list_v1(args.val_scene_dir))
        if scenes is not None:
            print(f"{name}: {len(scenes)} scenes")
        paths = generate_split(name, n, args, task, scenes)
        print(f"{name}: wrote {n} entries -> {paths}")


if __name__ == "__main__":
    main()
