"""Preemption lifecycle (counterpart of ``utils/preemption.py``).

SIGINT/SIGTERM/SIGUSR2 request a clean exit and SIGUSR1 a requeue.  The
training loops poll :func:`should_exit` before each update or epoch, save
the full interrupted state through ``io/checkpoint.py`` (an atomic write)
and call ``scontrol requeue`` under SLURM.  The state goes to
``$POINTNAV_VO_INTERRUPTED_DIR`` (default ``~/.interrupted_states``), one
file per SLURM job.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
from typing import Any, Dict, Optional

EXIT = threading.Event()
REQUEUE = threading.Event()

INTERRUPTED_STATE_DIR = os.environ.get(
    "POINTNAV_VO_INTERRUPTED_DIR", os.path.expanduser("~/.interrupted_states"))


def _clean_exit(signum, frame):
    EXIT.set()


def _requeue(signum, frame):
    EXIT.set()
    REQUEUE.set()


def install_signal_handlers() -> None:
    signal.signal(signal.SIGINT, _clean_exit)
    signal.signal(signal.SIGTERM, _clean_exit)
    if hasattr(signal, "SIGUSR2"):
        signal.signal(signal.SIGUSR2, _clean_exit)
    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _requeue)


def should_exit() -> bool:
    return EXIT.is_set()


def interrupted_state_path() -> str:
    job = os.environ.get("SLURM_JOB_ID", "local")
    return os.path.join(INTERRUPTED_STATE_DIR, f"{job}.pth")


def save_interrupted_state(state: Dict[str, Any]) -> str:
    from pointnav_vo_tpu_torch.io.checkpoint import save_checkpoint

    path = interrupted_state_path()
    save_checkpoint(path, state)
    return path


def load_interrupted_state() -> Optional[Dict[str, Any]]:
    from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint

    path = interrupted_state_path()
    if not os.path.isfile(path):
        return None
    return load_checkpoint(path)


def requeue_job() -> None:
    """``scontrol requeue`` under SLURM after a requeue signal; a no-op
    otherwise."""
    if not REQUEUE.is_set():
        return
    job = os.environ.get("SLURM_JOB_ID")
    if job and os.environ.get("SLURM_PROCID", "0") == "0":
        subprocess.run(["scontrol", "requeue", job], check=False)


def reset_for_tests() -> None:
    EXIT.clear()
    REQUEUE.clear()
