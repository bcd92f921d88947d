"""What every cell shares: the device check, the host-clock spans, the
measured window with its traced sub-window, the reading of the profiler's
trace, the per-layer metric readers, and the result line."""

from __future__ import annotations

import contextlib
import ctypes
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnav_vo_tpu")


class Fail(SystemExit):
    """Exit with a message on standard error and no result line."""

    def __init__(self, msg: str, code: int = 2):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)
        super().__init__(code)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Ctx:
    """One run: its cell, configuration and traffic, and what the run
    recorded for the per-layer metrics (spans by name in seconds, counters,
    the trace's summary)."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device=None):
        cells = {c["name"]: c for c in bench["workloads"]}
        if workload not in cells:
            raise Fail(f"no workload {workload!r} in BENCHMARK.json")
        self.bench, self.cell = bench, cells[workload]
        confs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT.parent / confs[self.cell["config"]]["file"])
        self.traffic = load_json(ROOT / "traffic" / f"{self.cell['traffic']}.json")
        limits = ROOT / "limits" / f"{workload}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.t_start = self._last_mark = t_start
        self.device = device
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.trace_summary: Optional[dict] = None
        self.extra: Dict[str, object] = {}

    def mark(self, phase: str) -> None:
        """The set-up's seconds since the last mark (or the process start),
        under ``phase``: printed on standard error for the record."""
        now = time.perf_counter()
        self.extra.setdefault("setup_phases", {})[phase] = now - self._last_mark
        self._last_mark = now

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def sync(ctx: Ctx) -> None:
    if ctx.device is not None and ctx.device.type == "cuda":
        import torch

        torch.cuda.synchronize(ctx.device)


class Window:
    """The measured window: ``running()`` is True until ``seconds`` have
    passed since it opened.  With tracing on, ``torch.profiler`` records
    the last ``profile_s`` of it (``profiling`` is True for those steps);
    each step's host spans are then ``record_function`` ranges as well."""

    def __init__(self, ctx: Ctx, profile_s: float):
        self.ctx = ctx
        self.profile_s = min(profile_s, ctx.seconds / 2) if ctx.trace else 0.0
        # the set-up's objects out of the collector's way: the window's
        # collections then scan only what the steps allocate
        gc.collect()
        gc.freeze()
        self.host = HostProbe(ctx)
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - ctx.t_start
        self.end = self.t0 + ctx.seconds
        self.prof = None
        self.prof_t = [0.0, 0.0]
        self.t_close = None

    @property
    def profiling(self) -> bool:
        return self.prof is not None

    def running(self) -> bool:
        now = time.perf_counter()
        if now >= self.end:
            self.close()
            return False
        if self.ctx.trace and self.prof is None and now >= self.end - self.profile_s \
                and self.prof_t[0] == 0.0:
            import torch

            sync(self.ctx)
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.prof_t[0] = time.perf_counter()
        return True

    def close(self) -> None:
        sync(self.ctx)
        if self.t_close is None:
            self.t_close = time.perf_counter()
            self.host.close()
        if self.prof is not None:
            self.prof_t[1] = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.ctx.trace_summary = read_trace(self.prof, self.prof_t[1] - self.prof_t[0])
            self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span of the step, kept outside the traced part (the
        profiler slows the host); a ``record_function`` range inside it."""
        if self.prof is None:
            with self.ctx.span(name):
                yield
        else:
            import torch

            with torch.profiler.record_function(name):
                yield

    @property
    def seconds(self) -> float:
        return (self.t_close or time.perf_counter()) - self.t0

    @property
    def untraced_s(self) -> float:
        """Wall seconds of the window before the traced sub-window."""
        return (self.prof_t[0] or self.t_close or time.perf_counter()) - self.t0


def host_speed_ms() -> float:
    """The best of three timings of a fixed pure-Python loop: the host's
    single-thread speed, for comparing runs."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def card_clocks(ctx: Ctx) -> Optional[dict]:
    """The card's SM and memory clocks (MHz), power draw and limit (W),
    temperature (C) and throttle reasons, through NVML; None without it."""
    if ctx.device is None or ctx.device.type != "cuda":
        return None
    try:
        import torch

        nv = ctypes.CDLL("libnvidia-ml.so.1")
        if nv.nvmlInit_v2() != 0:
            return None
        p = torch.cuda.get_device_properties(ctx.device)
        bus = f"{p.pci_domain_id:08x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0".encode()
        h = ctypes.c_void_p()
        if nv.nvmlDeviceGetHandleByPciBusId_v2(bus, ctypes.byref(h)) != 0:
            return None
        u = [ctypes.c_uint() for _ in range(5)]
        reasons = ctypes.c_ulonglong()
        nv.nvmlDeviceGetClockInfo(h, 1, ctypes.byref(u[0]))
        nv.nvmlDeviceGetClockInfo(h, 2, ctypes.byref(u[1]))
        nv.nvmlDeviceGetPowerUsage(h, ctypes.byref(u[2]))
        nv.nvmlDeviceGetEnforcedPowerLimit(h, ctypes.byref(u[3]))
        nv.nvmlDeviceGetTemperature(h, 0, ctypes.byref(u[4]))
        nv.nvmlDeviceGetCurrentClocksThrottleReasons(h, ctypes.byref(reasons))
        return {"sm_mhz": u[0].value, "mem_mhz": u[1].value, "power_w": u[2].value / 1e3,
                "limit_w": u[3].value / 1e3, "temp_c": u[4].value,
                "throttle": hex(reasons.value)}
    except (OSError, AttributeError):
        return None


class HostProbe:
    """What the host and the card did over the window, for the record on
    standard error (``host``): the host's single-thread speed before and
    after, the main thread's CPU share, the collector's passes, the
    process's threads, and the card's clocks at the open and the close."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.rec: Dict[str, object] = {"speed_ms_before": host_speed_ms(),
                                       "clocks_open": card_clocks(ctx)}
        self.gc = [g["collections"] for g in gc.get_stats()]
        self.cpu = time.thread_time()
        self.t0 = time.perf_counter()

    def close(self) -> None:
        wall = time.perf_counter() - self.t0
        cpu = time.thread_time() - self.cpu
        with open("/proc/self/status") as f:
            threads = next((int(x.split()[1]) for x in f if x.startswith("Threads:")), -1)
        self.rec.update(
            clocks_close=card_clocks(self.ctx), main_thread_cpu_share=cpu / wall if wall else 0.0,
            gc_passes=[g["collections"] - c for g, c in zip(gc.get_stats(), self.gc)],
            threads=threads, speed_ms_after=host_speed_ms())
        self.ctx.extra["host"] = self.rec


def _merge(iv: List[List[float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, wall_s: float) -> dict:
    """The profiled window's device summary from its chrome trace: the union
    of kernel, copy and set intervals (busy seconds), seconds by kernel name,
    and the idle gaps between device intervals, each labelled by the
    innermost benchmark span the host was in."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev, host = [], []
    by_name: Dict[str, float] = {}
    count_by_name: Dict[str, int] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append([float(e["ts"]), float(e["ts"]) + float(e["dur"])])
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
            count_by_name[e["name"]] = count_by_name.get(e["name"], 0) + 1
        elif cat == "user_annotation":
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "outside the spans"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    return {"busy_s": busy, "window_s": wall_s, "by_name": by_name,
            "count_by_name": count_by_name, "gaps": gaps,
            "n_device_events": len(dev)}


def _load_reader(name: str) -> Callable:
    """``metrics/<name>.py``, or else the reader of the metric's family,
    ``metrics/<name up to its first dot>.py``: one quantity split by the
    end-to-end metric it moves (``mfu.eval``, ``mfu.vo_train``) is read
    alike in each cell."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(ctx: Ctx, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json.
    A per-layer metric with no ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves."""
    name = ctx.cell["name"]
    e2e = [m for m in ctx.bench["end_to_end"] if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in ctx.bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def per_layer_values(ctx: Ctx) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(ctx, "per_layer"):
        v = _load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def median_ms(values: List[float]) -> Optional[float]:
    return float(np.median(values)) * 1e3 if values else None


def device_info(torch, chips: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def breakdown(summary: dict) -> dict:
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def judge(ctx: Ctx, readings: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit (``limits/<cell>.json``); a
    number without a limit, or one that is not finite, fails."""
    out = {}
    for k, v in readings.items():
        lim = ctx.limits.get(k)
        ok = lim is not None and math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out
