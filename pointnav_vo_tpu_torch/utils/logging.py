"""Observability (counterpart of ``utils/logging.py``): the logger, the
null-object TensorBoard writer, the append-merge info-dict store, the
phase timer, a ``torch.profiler`` trace scope and the run directories.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np

_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def get_logger(name: str = "pointnav_vo_tpu_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    """The package logger, printing to stderr and, where ``log_file`` is
    given, to that file too (one handler per file)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
    if log_file:
        path = os.path.abspath(log_file)
        if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger


class TensorboardWriter:
    """Null-object TB writer: no log dir, or no ``tensorboardX``, and every
    call is a no-op."""

    def __init__(self, log_dir: Optional[str], flush_secs: int = 30):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            os.makedirs(log_dir, exist_ok=True)
            self.writer = SummaryWriter(log_dir, flush_secs=flush_secs)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        if self.writer:
            self.writer.close()

    def __getattr__(self, item):
        if self.writer:
            return getattr(self.writer, item)
        return lambda *a, **k: None

    def add_video_from_np_images(self, name, step, images, fps=10):
        if not self.writer:
            return
        frames = np.stack(images)[None].transpose(0, 1, 4, 2, 3)
        self.writer.add_video(name, frames, global_step=step, fps=fps)


def save_info_dict(info: Dict[str, Any], path: str) -> None:
    """Append-merge pickle store: repeated calls extend list-valued keys."""
    merged = info
    if os.path.isfile(path):
        with open(path, "rb") as f:
            merged = pickle.load(f)
        for k, v in info.items():
            if k in merged and isinstance(merged[k], list):
                merged[k].extend(v if isinstance(v, list) else [v])
            else:
                merged[k] = v
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(merged, f)


def append_jsonl(record: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")


class Timing(dict):
    """Accumulating phase timer: ``with timing.span('env'): ...``"""

    @contextlib.contextmanager
    def span(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[key] = self.get(key, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` scope over the host and the card, written as a
    Chrome trace under ``log_dir`` (no ``log_dir``: no trace)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def update_config_log(config, run_type: str, log_dir: str):
    """Create the LOG/INFO/CKPT/TB/VIDEO dirs and point the config at them;
    the config comes back frozen."""
    config.defrost()
    config.LOG_DIR = log_dir
    config.LOG_FILE = os.path.join(log_dir, f"{run_type}.log")
    config.INFO_DIR = os.path.join(log_dir, "infos")
    config.CHECKPOINT_FOLDER = os.path.join(log_dir, "checkpoints")
    config.TENSORBOARD_DIR = os.path.join(log_dir, "tb")
    config.VIDEO_DIR = os.path.join(log_dir, "videos")
    for d in (config.LOG_DIR, config.INFO_DIR, config.CHECKPOINT_FOLDER,
              config.TENSORBOARD_DIR, config.VIDEO_DIR):
        os.makedirs(d, exist_ok=True)
    config.freeze()
    return config
