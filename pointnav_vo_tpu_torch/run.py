"""Experiment driver (counterpart of ``run.py``): config assembly, seeding,
engine dispatch.

    python -m pointnav_vo_tpu_torch.run --task-type {rl,vo} --run-type {train,eval} \\
        [--exp-config configs/...yaml] [--noise 0|1] [--log-root DIR] \\
        [--device cuda|cpu] [--n-devices W] [KEY VALUE ...]

- trailing ``KEY VALUE`` pairs override the config;
- ``--noise 0`` switches VO to the noise-free dataset paths;
- the run's identity names its log directory;
- ``random``, numpy and torch are seeded with ``SEED``;
- on eval, the engine name comes from inside the checkpoint where it has
  one;
- ``--device`` (default: the card) is the device every engine runs on;
- ``--n-devices W`` above 1 runs data-parallel over W ranks, one process
  each (``parallel/dist.py``): a process started as one of W ranks (under
  SLURM, or ``torchrun``'s ``RANK``/``WORLD_SIZE``) joins their group;
  otherwise :func:`main` spawns the W ranks on this host and returns rank
  0's result where it is data (an eval's metrics; a train run's state is
  on disk).  A bare ``--device cuda`` spreads the ranks over the host's
  cards.  A rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import datetime
import os
import random

import numpy as np
import torch

import pointnav_vo_tpu_torch.engines  # noqa: F401  populates the registry
from pointnav_vo_tpu_torch.config.defaults import get_rl_config, get_vo_config
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.parallel import dist
from pointnav_vo_tpu_torch.utils import registry
from pointnav_vo_tpu_torch.utils.logging import get_logger, update_config_log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PointNav-VO experiment driver (PyTorch)")
    p.add_argument("--task-type", choices=("rl", "vo"), required=True)
    p.add_argument("--run-type", choices=("train", "eval"), required=True)
    p.add_argument("--exp-config", type=str, default=None)
    p.add_argument("--noise", type=int, default=1)
    p.add_argument("--log-root", type=str, default="train_log")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks of a data-parallel run, one process each")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of every engine (default: the card)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="trailing KEY VALUE config overrides")
    return p


def _log_dir_name(args, config) -> str:
    """The run's identity in its directory name."""
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    bits = [args.task_type, args.run_type, f"seed{config.SEED}"]
    if args.task_type == "vo":
        t = config.VO.TRAIN
        bits += [config.VO.MODEL.name, f"act{t.action_type}", f"bs{t.batch_size}",
                 f"lr{t.lr}"]
        if config.VO.GEOMETRY.invariance_types:
            bits.append("geo_inv")
    else:
        bits += [config.RL.Policy.name, f"envs{config.NUM_PROCESSES}",
                 f"lr{config.RL.PPO.lr}"]
        if config.RL.TUNE_WITH_VO:
            bits.append("tune_vo")
    bits.append("noisy" if args.noise else "no_noise")
    bits.append(stamp)
    return os.path.join(args.log_root, "-".join(str(b) for b in bits))


def run_exp(args, group=None):
    """Build the config and run the engine, as one rank of ``group``
    (a ``parallel.dist.Group``) where it is given; returns what the
    engine's ``train``/``eval`` returns."""
    logger = get_logger()
    paths = [args.exp_config] if args.exp_config else []
    opts = args.opts or []

    if args.task_type == "vo":
        config = get_vo_config(paths, opts)
        if not args.noise:
            # the noisy/clean dataset switch
            config.VO.DATASET.TRAIN_WITH_NOISE = config.VO.DATASET.get("TRAIN", "")
            config.VO.DATASET.EVAL_WITH_NOISE = config.VO.DATASET.get("EVAL", "")
    else:
        config = get_rl_config(paths, opts)

    log_dir = _log_dir_name(args, config)
    if group is not None:  # one directory, named by rank 0's clock
        log_dir = group.broadcast_object(log_dir)
    config = update_config_log(config, args.run_type, log_dir)

    random.seed(config.SEED)
    np.random.seed(config.SEED)
    torch.manual_seed(config.SEED)

    engine_name = config.ENGINE_NAME
    if args.run_type == "eval" and config.EVAL.EVAL_WITH_CKPT:
        ckpt = config.EVAL.EVAL_CKPT_PATH
        if ckpt and os.path.isfile(ckpt):
            engine_name = load_checkpoint(ckpt).get("engine_name", engine_name)

    logger.info(f"engine: {engine_name}; log dir: {config.LOG_DIR}")
    device = args.device if group is None else group.device
    if args.task_type == "vo":
        engine = registry.get_vo_engine(engine_name)(config, args.run_type, device=device,
                                                     group=group)
    else:
        engine = registry.get_trainer(engine_name)(config, args.run_type,
                                                   noisy=bool(args.noise), device=device,
                                                   group=group)
    return engine.train() if args.run_type == "train" else engine.eval()


def _spawned_run(group, args):
    out = run_exp(args, group)
    return out if isinstance(out, dict) else None


def main(argv=None):
    args = build_parser().parse_args(argv)
    world = args.n_devices or 1
    if world == 1:
        return run_exp(args)
    group = dist.init_distributed(args.device)
    if group is None:
        return dist.spawn(_spawned_run, world, args.device, args)
    try:
        if group.world != world:
            raise ValueError(f"--n-devices {world}, but the process was started as one of "
                             f"{group.world} ranks")
        return run_exp(args, group)
    finally:
        group.close()


if __name__ == "__main__":
    main()
