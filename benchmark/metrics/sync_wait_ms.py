"""Mean host time a step inside the program's ``sync.h2d`` spans: the
blocking uploads, which on the card wait for the work queued before them,
outside the traced steps.  Reads ``sync_wait_ms.eval`` and
``sync_wait_ms.vo_train`` alike."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    return None if w is None else w.ms_per_step("sync.h2d")
