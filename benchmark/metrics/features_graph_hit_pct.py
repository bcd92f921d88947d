"""Share of the window's VO frame-feature calls that replayed a CUDA graph:
the program's ``features_graph_replays`` over those plus
``features_graph_eager`` (``vo/ensemble.py::frame_features_packed``), over
every step of the window, the traced ones too.  Reads
``features_graph_hit_pct.eval`` (the new frame's features in the eval step)
and ``features_graph_hit_pct.vo_train`` (both frames' features in the
train step) alike.  None where the program has no such counters, or made
no such call."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or not {"features_graph_replays", "features_graph_eager"} & set(w.counters):
        return None
    replays = w.counters.get("features_graph_replays", 0)
    calls = replays + w.counters.get("features_graph_eager", 0)
    return 100.0 * replays / calls if calls else None
