"""Share of the window's single-step policy calls whose visual encoder
replayed a CUDA graph: the program's ``policy_graph_replays`` over those
plus ``policy_graph_eager`` (``models/feature_graphs.py``), over every step
of the window, the traced ones too.  None where the program has no such
counters, or made no such call."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or not {"policy_graph_replays", "policy_graph_eager"} & set(w.counters):
        return None
    replays = w.counters.get("policy_graph_replays", 0)
    calls = replays + w.counters.get("policy_graph_eager", 0)
    return 100.0 * replays / calls if calls else None
