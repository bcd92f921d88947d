"""The whole step's analytic FLOPs (``benchmark/flops.py``) over its mean
host-clock time in the untraced part of the window, as a share of the
card's float32 peak (the configurations run float32 with TF32 off).
Reads ``mfu.eval`` and ``mfu.vo_train`` alike."""

from benchmark.peaks import peak


def read(ctx):
    p = peak(ctx.extra.get("device_kind", ""), "fp32_flops")
    s = ctx.counters.get("mean_step_s")
    if p is None or not s or s != s:
        return None
    return 100.0 * ctx.counters["step_flops"] / s / p
