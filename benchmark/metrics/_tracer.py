"""What the program's own tracer (``pointnav_vo_tpu_torch/utils/logging.py::
TRACER``) recorded over the window, which each entry resets with the launch
counts at the window's start.  The spans taken while the profiler recorded
are kept apart there and left out here; counters count in every step, so a
count a step divides by every step.  A program without the tracer gives
None."""

from typing import NamedTuple, Optional

# each entry's top-level span: one a step
TOP = {"eval_step": "eval_step", "vo_train": "vo_train.step"}


class Window(NamedTuple):
    spans: dict  # name -> {"count", "total_ns", "parent"}, outside the profiler
    counters: dict
    top: str
    steps: int  # the top-level span's count outside the profiler
    all_steps: int  # and with the profiled steps

    def ms_per_step(self, name: str) -> float:
        return self.spans.get(name, {}).get("total_ns", 0) / self.steps * 1e-6


def window(ctx) -> Optional[Window]:
    try:
        from pointnav_vo_tpu_torch.utils.logging import TRACER
    except ImportError:
        return None
    snap = TRACER.snapshot()
    top = TOP[ctx.traffic["entry"]]
    steps = snap["spans"].get(top, {}).get("count", 0)
    if not steps:
        return None
    profiled = snap.get("profiled", {}).get(top, {}).get("count", 0)
    return Window(snap["spans"], snap["counters"], top, steps, steps + profiled)


def idle_pct(ctx, labels) -> Optional[float]:
    """Idle gaps of the traced window labelled with one of the program's
    spans ``labels``, as a share of the window; None without the tracer or
    without device events to read."""
    t = ctx.trace_summary
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0 or window(ctx) is None:
        return None
    return 100.0 * sum(t["gaps"].get(k, 0.0) for k in labels) / t["window_s"]
