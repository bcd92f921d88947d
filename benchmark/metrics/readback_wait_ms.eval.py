"""Median host time from the fused step's return to the actions on the
host: the wait for the device to finish the step, outside the traced
steps."""

from benchmark.harness import median_ms


def read(ctx):
    return median_ms(ctx.spans.get("readback", []))
