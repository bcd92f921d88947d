"""Share of the traced window in which the card idled while the host was in
the train step's upload: the spans ``vo_train.upload`` (the batch and its
expert buckets) and ``sync.h2d`` (each blocking copy)."""

from benchmark.metrics import _tracer


def read(ctx):
    return _tracer.idle_pct(ctx, ("vo_train.upload", "sync.h2d"))
