"""Share of the window's VO expert calls that replayed a CUDA graph: the
program's ``vo_graph_replays`` over those plus ``vo_graph_eager``
(``vo/ensemble.py::ExpertGraphs``), over every step of the window, the
traced ones too.  None where the program has no such counters, or made no
such call."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or not {"vo_graph_replays", "vo_graph_eager"} & set(w.counters):
        return None
    replays = w.counters.get("vo_graph_replays", 0)
    calls = replays + w.counters.get("vo_graph_eager", 0)
    return 100.0 * replays / calls if calls else None
