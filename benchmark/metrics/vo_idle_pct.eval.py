"""Share of the traced window in which the card idled while the host was in
the VO's spans: ``vo.predict`` (the row selection), ``vo.expert`` (an
expert's rows, forward and scatter) or ``sync.h2d`` (its row upload)."""

from benchmark.metrics import _tracer


def read(ctx):
    return _tracer.idle_pct(ctx, ("vo.predict", "vo.expert", "sync.h2d"))
