"""Experiment driver (counterpart of ``run.py``): config assembly, seeding,
engine dispatch.

    python -m pointnav_vo_tpu_torch.run --task-type {rl,vo} --run-type {train,eval} \\
        [--exp-config configs/...yaml] [--noise 0|1] [--log-root DIR] \\
        [--device cuda|cpu] [KEY VALUE ...]

- trailing ``KEY VALUE`` pairs override the config;
- ``--noise 0`` switches VO to the noise-free dataset paths;
- the run's identity names its log directory;
- ``random``, numpy and torch are seeded with ``SEED``;
- on eval, the engine name comes from inside the checkpoint where it has
  one;
- ``--device`` (default: the card) is the device every engine runs on;
  ``--n-devices`` above 1 is not ported yet.
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
from pointnav_vo_tpu_torch.engines import not_ported
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
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
                   help="devices for data-parallel training (only 1 is ported)")
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


def run_exp(args):
    """Build the config and run the engine; returns what the engine's
    ``train``/``eval`` returns."""
    if args.n_devices and args.n_devices > 1:
        raise not_ported(f"--n-devices {args.n_devices} (training across devices)", "10")
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

    config = update_config_log(config, args.run_type, _log_dir_name(args, config))

    random.seed(config.SEED)
    np.random.seed(config.SEED)
    torch.manual_seed(config.SEED)

    engine_name = config.ENGINE_NAME
    if args.run_type == "eval" and config.EVAL.EVAL_WITH_CKPT:
        ckpt = config.EVAL.EVAL_CKPT_PATH
        if ckpt and os.path.isfile(ckpt):
            engine_name = load_checkpoint(ckpt).get("engine_name", engine_name)

    logger.info(f"engine: {engine_name}; log dir: {config.LOG_DIR}")
    if args.task_type == "vo":
        engine = registry.get_vo_engine(engine_name)(config, args.run_type, device=args.device)
    else:
        engine = registry.get_trainer(engine_name)(config, args.run_type,
                                                   noisy=bool(args.noise), device=args.device)
    return engine.train() if args.run_type == "train" else engine.eval()


def main(argv=None):
    return run_exp(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
