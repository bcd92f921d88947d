"""Median host time inside ``rl/eval.py::fused_vo_act_step``: enqueueing
the step's kernels (and any sync the program makes inside), outside the
traced steps."""

from benchmark.harness import median_ms


def read(ctx):
    return median_ms(ctx.spans.get("fused_vo_act_step", []))
