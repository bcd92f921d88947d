"""``vo_graph_hit_pct.eval``, the reader of the program's VO graph
counters: nothing without them, 100.0 where every expert call replays, and
on a tiny eval32 cell on the CPU, where every expert call runs eagerly, 0.0
over the window (the counters reset with it)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.entries import eval_step
from benchmark.tests._tiny import tiny_ctx

NAME = "vo_graph_hit_pct.eval"


def _ctx():
    return SimpleNamespace(traffic={"entry": "eval_step"}, trace_summary=None)


def _steps(tracer, counts, steps=3):
    for _ in range(steps):
        with tracer.span("eval_step"):
            for name, n in counts.items():
                tracer.count(name, n)


def test_no_counters_no_reading(monkeypatch):
    from pointnav_vo_tpu_torch.utils import logging as tlog

    monkeypatch.setattr(tlog, "TRACER", tlog.Timing(profiled=tlog.Timing()))
    _steps(tlog.TRACER, {"policy_graph_replays": 1})
    assert harness._load_reader(NAME)(_ctx()) is None
    monkeypatch.delattr(tlog, "TRACER")
    assert harness._load_reader(NAME)(_ctx()) is None


def test_every_expert_call_replayed_reads_100(monkeypatch):
    from pointnav_vo_tpu_torch.utils import logging as tlog

    monkeypatch.setattr(tlog, "TRACER", tlog.Timing(profiled=tlog.Timing()))
    tlog.TRACER.count("vo_graph_captures", 30)  # set-up's, before the window
    tlog.TRACER.reset()
    _steps(tlog.TRACER, {"vo_graph_replays": 3})
    assert harness._load_reader(NAME)(_ctx()) == 100.0


@pytest.mark.parametrize("cell", ["pnvo-rn18.eval32", "pnvo-sext101.eval32"])
def test_a_cpu_window_runs_every_expert_call_eagerly(cell):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = tiny_ctx(cell, seconds=1.0)
        res = eval_step.run(ctx)
    finally:
        torch.set_num_threads(n)
    assert res["attempted"] > 0
    assert harness._load_reader(NAME)(ctx) == 0.0
