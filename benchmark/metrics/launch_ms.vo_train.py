"""Median host time inside ``vo/engine.py::VORegressionEngine.train_step``
(the batch's pageable upload, the enqueue of forward, loss, backward and
Adam), outside the traced steps."""

from benchmark.harness import median_ms


def read(ctx):
    return median_ms(ctx.spans.get("train_step", []))
