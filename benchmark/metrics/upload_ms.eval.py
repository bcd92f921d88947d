"""Median host time of a loop step's upload of the frames and the small
block (pageable host memory to the card), outside the traced steps."""

from benchmark.harness import median_ms


def read(ctx):
    return median_ms(ctx.spans.get("upload", []))
