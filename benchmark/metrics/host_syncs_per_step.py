"""Blocking host-to-device copies a step, each a stream sync on the card:
the program's ``host_syncs`` counter (``utils/logging.py::h2d``) over the
window's steps.  Reads ``host_syncs_per_step.eval`` (the experts' row
indices in ``VOEnsemble.predict_packed``) and ``host_syncs_per_step.vo_train``
(the batch and its buckets in ``VORegressionEngine._to_device``) alike;
both count the constants the features, the geometry and the loss upload."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None:
        return None
    return w.counters.get("host_syncs", 0) / w.all_steps
