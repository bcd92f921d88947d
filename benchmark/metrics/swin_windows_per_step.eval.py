"""Shifted-window attention windows a step: the program's ``swin_windows``
counter (``models/swin.py::WindowAttention``, one count a window attended)
over every step of the window, the traced ones too.  None where the
program has no such counter."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or "swin_windows" not in w.counters:
        return None
    return w.counters["swin_windows"] / w.all_steps
