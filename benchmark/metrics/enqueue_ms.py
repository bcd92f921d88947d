"""Mean host time a step inside the program's top-level span (``eval_step``
in ``rl/eval.py::fused_vo_act_step``, ``vo_train.step`` in
``VORegressionEngine.train_step``) outside its ``sync.h2d`` spans: the
enqueue of the step's work, outside the traced steps.  Reads
``enqueue_ms.eval`` and ``enqueue_ms.vo_train`` alike."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    return None if w is None else w.ms_per_step(w.top) - w.ms_per_step("sync.h2d")
