"""Share of the traced sub-window in which no kernel, copy or memset ran on
the card: 100 x (1 - union of device intervals / traced wall).  Reads
``device_idle_pct.eval`` and ``device_idle_pct.vo_train`` alike."""


def read(ctx):
    t = ctx.trace_summary
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
