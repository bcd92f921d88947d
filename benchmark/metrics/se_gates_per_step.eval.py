"""Squeeze-excitation gates applied a step: the program's ``se_gates``
counter (``models/resnet.py::SEModule``) over every step of the window, the
traced ones too.  None where the program has no such counter."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or "se_gates" not in w.counters:
        return None
    return w.counters["se_gates"] / w.all_steps
