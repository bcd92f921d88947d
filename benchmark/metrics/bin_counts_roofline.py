"""``ops/topdown_kernels.py::bin_counts`` (``csrc/bin_counts.cu``) against
its memory bound: the bytes these inputs need (a keep byte per candidate
point, 8 B per kept point's bins, 4 B per output cell) at the card's HBM
peak, over the kernel's mean device time a launch in the trace."""

from benchmark.peaks import peak


def read(ctx):
    t = ctx.trace_summary
    bw = peak(ctx.extra.get("device_kind", ""), "hbm_bytes_s")
    if not t or bw is None:
        return None
    names = [k for k in t["by_name"] if "bin_counts" in k]
    launches = sum(t["count_by_name"][k] for k in names)
    if not launches:
        return None
    per_launch = sum(t["by_name"][k] for k in names) / launches
    return 100.0 * (ctx.counters["bin_counts_bytes"] / bw) / per_launch
