"""Launcher: formats and execs the experiment command (counterpart of
``launch.py``).

    python -m pointnav_vo_tpu_torch.launch --task-type rl --run-type train \\
        [--exp-config configs/...yaml] [--noise 0|1] [--n-devices W] [--log-root DIR] \\
        [KEY VALUE ...]

Prints and execs ``python -m pointnav_vo_tpu_torch.run`` with the same
arguments, the task's stock config where ``--exp-config`` is not given.
``--n-devices W`` above 1 runs W ranks, one process each: the run command
spawns them on this host or joins the group a launcher such as ``srun``
or ``torchrun`` started (``parallel/dist.py``).  Trailing arguments,
``--device`` among them, pass through.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

DEFAULT_CONFIGS = {
    "rl": "configs/rl/ddppo_pointnav.yaml",
    "vo": "configs/vo/vo_pointnav.yaml",
}


def command(argv: Optional[List[str]] = None) -> List[str]:
    """The run command's argv for the launcher's arguments."""
    p = argparse.ArgumentParser(description="PointNav-VO launcher (PyTorch)")
    p.add_argument("--task-type", choices=("rl", "vo"), required=True)
    p.add_argument("--run-type", choices=("train", "eval"), required=True)
    p.add_argument("--noise", type=int, default=1)
    p.add_argument("--exp-config", default=None)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--log-root", default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = [sys.executable, "-m", "pointnav_vo_tpu_torch.run",
           "--task-type", args.task_type,
           "--run-type", args.run_type,
           "--noise", str(args.noise),
           "--exp-config", args.exp_config or DEFAULT_CONFIGS[args.task_type]]
    if args.n_devices:
        cmd += ["--n-devices", str(args.n_devices)]
    if args.log_root:
        cmd += ["--log-root", args.log_root]
    return cmd + args.opts


def main(argv: Optional[List[str]] = None) -> None:
    cmd = command(argv)
    print(" ".join(cmd), flush=True)
    os.execv(sys.executable, cmd)


if __name__ == "__main__":
    main()
