"""Observability (counterpart of ``utils/logging.py``): the logger, the
null-object TensorBoard writer, the append-merge info-dict store, the
tracer (:class:`Timing`, its process-wide instance :data:`TRACER` and the
counted uploads :func:`h2d`, :func:`h2d_async` and :func:`device_const`), a
``torch.profiler`` trace scope and the run directories.
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
import torch
import torch.autograd.profiler as _autograd_profiler

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


_now = time.perf_counter_ns


class _Span:
    """One span of a :class:`Timing`: a class with ``__slots__`` rather
    than a generator, as the hot paths open some 25 to 60 spans a step."""

    __slots__ = ("timing", "name", "agg", "t0", "rf")

    def __init__(self, timing: "Timing", name: str):
        self.timing = timing
        self.name = name

    def __enter__(self):
        agg = self.timing
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            if agg.profiled is not None:
                agg = agg.profiled
        else:
            self.rf = None
        self.agg = agg
        agg.open.append(self.name)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _now() - self.t0
        agg, name = self.agg, self.name
        agg.open.pop()
        a = agg.aggs.get(name)
        if a is None:  # [count, total ns, the spans open around it]
            a = agg.aggs[name] = [0, 0, set()]
        a[0] += 1
        a[1] += dt
        a[2].add(agg.open[-1] if agg.open else None)
        agg[name] = a[1] * 1e-9
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


class Timing(dict):
    """A set of named aggregates: ``with timing.span(name): ...`` and
    ``timing.count(name, n)``.

    The dict maps each span's name to its total seconds; ``aggs`` holds its
    count, total nanoseconds (``time.perf_counter_ns``) and parents (the
    names of the spans open around it, None at the top), and ``counters``
    the counts: one entry a name, whatever the number of spans.  Spans
    nest within one thread.

    While a ``torch.profiler`` records, a span also opens
    ``record_function(name)``, which puts it in the profiler's trace on the
    device's clock; where ``profiled`` is a Timing, such spans aggregate
    there instead, as the profiler slows the host.  Counters count in every
    mode: a launch or a sync is one whoever watches.
    """

    def __init__(self, *args, profiled: Optional["Timing"] = None, **kw):
        super().__init__(*args, **kw)
        self.aggs: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.open: list = []
        self.profiled = profiled

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def reset(self) -> None:
        """Clear the spans and zero the counters in place (their keys, and
        the dict itself, stay: callers hold it, as
        ``ops/topdown_kernels.py::launch_counts``)."""
        self.clear()
        self.aggs.clear()
        for k in self.counters:
            self.counters[k] = 0
        if self.profiled is not None:
            self.profiled.reset()

    def snapshot(self) -> Dict[str, Any]:
        """The aggregates as plain data: ``spans`` (each name's ``count``,
        ``total_ns`` and sorted ``parents``), ``counters``, and
        ``profiled``, the spans taken while a profiler recorded, where they
        are kept apart."""
        out: Dict[str, Any] = {
            "spans": {k: {"count": c, "total_ns": ns, "parents": sorted(p, key=str)}
                      for k, (c, ns, p) in self.aggs.items()},
            "counters": dict(self.counters)}
        if self.profiled is not None:
            out["profiled"] = self.profiled.snapshot()["spans"]
        return out


# the hot paths' tracer: the eval step and the VO train step record their
# layers here, and ``ops/topdown_kernels.py`` its launches
TRACER = Timing(profiled=Timing())


def h2d(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype).to(device)`` (a numpy array is
    shared, not copied, on the host): a blocking copy from pageable host
    memory, which on the card waits for the work queued before it.  Counted
    under ``host_syncs`` and ``h2d_bytes`` on every device, and timed as the
    span ``sync.h2d``.

    The hot paths' only blocking upload is the first upload of each
    constant (:func:`device_const`); the eval step's expert row indices
    (``vo/ensemble.py``) and the train step's batch and buckets go through
    :func:`h2d_async`."""
    t = torch.as_tensor(a, dtype=dtype)
    TRACER.count("host_syncs")
    TRACER.count("h2d_bytes", t.nbytes)
    with TRACER.span("sync.h2d"):
        return t.to(device)


def h2d_async(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` on ``device`` without a host sync: on the card a copy into
    pinned host memory, then a copy queued on the current stream
    (``non_blocking``).  The caching host allocator records an event on the
    stream and reuses the pinned block only after the copy has run, so the
    caller may overwrite ``a`` as soon as this returns.  Elsewhere (and for
    an empty array, which copies nothing) as :func:`h2d`.  Counted under
    ``h2d_async`` and ``h2d_async_bytes``, not ``host_syncs``."""
    t = torch.as_tensor(a, dtype=dtype)
    TRACER.count("h2d_async")
    TRACER.count("h2d_async_bytes", t.nbytes)
    if torch.device(device).type == "cuda" and t.numel():
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# device_const's cache: (shape, float64 bytes, device, dtype) -> tensor
_CONSTS: Dict[tuple, torch.Tensor] = {}


def device_const(value, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` (a number or a nested sequence of numbers) as a ``dtype``
    tensor on ``device``, uploaded once by :func:`h2d` and cached for the
    life of the process, so a step's constants make no host sync; a hit is
    counted under ``const_hits``.  The key is the value's float64
    bits (``-0.0`` is not ``0.0``), its shape, the device (``cuda`` is the
    current card's index) and the dtype.  A cached tensor is shared by
    every caller: never write to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    arr = np.asarray(value, np.float64)
    key = (arr.shape, arr.tobytes(), dev, dtype)
    t = _CONSTS.get(key)
    if t is not None:
        TRACER.count("const_hits")
        return t
    t = _CONSTS[key] = h2d(arr, dev, dtype)
    return t


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` scope over the host and the card, written as a
    Chrome trace under ``log_dir`` (no ``log_dir``: no trace), with
    :data:`TRACER`'s snapshot as ``spans.json`` beside it."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(TRACER.snapshot(), f, indent=1)


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
