"""The per-layer metrics that read the program's own tracer: on each tiny
cell, with the last part of the window traced, every reader of a span or a
counter returns a finite number, the tracer's top-level span counts
exactly the harness's untraced steps (its reset and its profiled steps
line up with the window), the device-trace readers share out the gaps
labelled with the program's spans, and a program without the tracer
gives no reading and no error."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.entries import eval_step, vo_train
from benchmark.traffic_gen import generate
from benchmark.tests._tiny import bench, tiny_ctx

CELLS = {  # cell -> (entry, the harness's span, the program's top-level span)
    "pnvo-rn18.eval32": (eval_step, "fused_vo_act_step", "eval_step"),
    "pnvo-rn18.vo_train_joint": (vo_train, "train_step", "vo_train.step"),
    "pnvo-rn50.vo_train_fwd": (vo_train, "train_step", "vo_train.step"),
}
DEVICE_GAPS = {  # cell -> the labels its device-trace reader adds up
    "pnvo-rn18.eval32": ("vo_idle_pct.eval", ("vo.predict", "vo.expert", "sync.h2d")),
    "pnvo-rn18.vo_train_joint": ("upload_idle_pct.vo_train", ("vo_train.upload", "sync.h2d")),
    "pnvo-rn50.vo_train_fwd": ("upload_idle_pct.vo_train", ("vo_train.upload", "sync.h2d")),
}


NEW = ("host_syncs_per_step", "sync_wait_ms", "enqueue_ms", "vo_idle_pct",
       "upload_idle_pct")


def _new_metrics(cell):
    return [m["name"] for m in bench()["per_layer"]
            if cell in m.get("workloads", []) and m["name"].split(".")[0] in NEW]


@pytest.fixture(scope="module", params=list(CELLS))
def traced_run(request):
    cell = request.param
    entry = CELLS[cell][0]
    # one thread, as the harness runs: several test workers' thread pools
    # oversubscribe the cores and stretch a tiny step past the window
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = tiny_ctx(cell, seconds=6.0)
        ctx.trace = True
        ctx.traffic["profile_seconds"] = 3.0
        res = entry.run(ctx)
    finally:
        torch.set_num_threads(n)
    from pointnav_vo_tpu_torch.utils.logging import TRACER

    return cell, ctx, res, TRACER.snapshot()


def test_the_tracer_counts_the_harness_window(traced_run):
    cell, ctx, res, snap = traced_run
    _entry, harness_span, top = CELLS[cell]
    untraced = len(ctx.spans[harness_span])
    assert untraced > 0 and snap["spans"][top]["count"] == untraced
    assert snap["profiled"][top]["count"] == res["attempted"] - untraced > 0


def test_span_and_counter_readers_give_finite_numbers(traced_run):
    cell, ctx, res, _snap = traced_run
    values = {n.split(".")[0]: harness._load_reader(n)(ctx) for n in _new_metrics(cell)
              if not n.split(".")[0].endswith("idle_pct")}
    assert set(values) == {"host_syncs_per_step", "sync_wait_ms", "enqueue_ms"}
    for name, v in values.items():
        assert v is not None and math.isfinite(v) and v >= 0, (name, v)
    syncs = values["host_syncs_per_step"]
    if cell.endswith("eval32"):
        assert syncs == _experts_with_rows_per_step(ctx, res["attempted"])
    else:  # the batch and its buckets go from pinned memory, the constants are cached
        assert syncs == 0


def _experts_with_rows_per_step(ctx, steps):
    """A warmed eval step's blocking uploads: the row indices of each expert
    that the step's actions give rows (STOP runs the forward expert), over
    every window step, the traced ones too (step ``k`` runs bank slot
    ``k mod T``); the constants were cached in set-up."""
    small = generate.eval_bank(ctx.traffic, ctx.seed, ctx.config["vo"]["vis_size_h"],
                               ctx.config["vo"]["vis_size_w"], ctx.device)["small"]
    per_slot = [len(set(np.clip(small[s, :, 3].astype(int) - 1, 0, 2).tolist()))
                for s in range(small.shape[0])]
    return sum(per_slot[k % len(per_slot)] for k in range(steps)) / steps


def test_device_trace_readers_add_the_program_labels(traced_run):
    """The CPU's trace has no device events, so the reader gives nothing
    there; a summary with device time and labelled gaps gives their share."""
    cell, ctx, _res, _snap = traced_run
    name, labels = DEVICE_GAPS[cell]
    assert name in _new_metrics(cell)
    reader = harness._load_reader(name)
    assert ctx.trace_summary is not None and reader(ctx) is None
    ctx.trace_summary = dict(ctx.trace_summary, busy_s=1.0, window_s=2.0,
                             gaps={**{k: 0.1 for k in labels}, "outside the spans": 0.5})
    assert reader(ctx) == pytest.approx(100.0 * 0.1 * len(labels) / 2.0)


def test_a_program_without_the_tracer_gives_no_reading(traced_run, monkeypatch):
    from pointnav_vo_tpu_torch.utils import logging as tlog

    cell, ctx, _res, _snap = traced_run
    monkeypatch.delattr(tlog, "TRACER")
    ctx.trace_summary = dict(ctx.trace_summary, busy_s=1.0, window_s=2.0)
    names = _new_metrics(cell)
    assert len(names) == 4
    for name in names:
        assert harness._load_reader(name)(ctx) is None, name
