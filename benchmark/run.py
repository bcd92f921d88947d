"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number beside its limit,
which also end standard error.  With no card, fewer cards than the cell
asks for, or JAX loaded once the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness  # noqa: E402


def _cache_dirs(root: Path) -> None:
    """The program's build and kernel caches at fixed paths in the checkout
    (its own nvcc builds go to ``build/kernels`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "benchmark_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        raise harness.Fail("run from the root of a checkout: no BENCHMARK.json here")
    bench = harness.load_json(root / "BENCHMARK.json")
    _cache_dirs(root)

    import torch

    ctx = harness.Ctx(bench, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise harness.Fail(f"needs {chips} CUDA card(s), found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    ctx.device = torch.device("cuda", 0)
    ctx.extra["device_kind"] = torch.cuda.get_device_name(0)
    torch.cuda.set_device(0)
    precision = ctx.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = precision["tf32"]
    torch.backends.cudnn.allow_tf32 = precision["tf32"]
    # one process with few threads: the host's work is the step's enqueue,
    # on the main thread
    torch.set_num_threads(1)

    entry = importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}")
    res = entry.run(ctx)

    bad = harness.forbidden_modules()
    if bad:
        raise harness.Fail(f"modules of JAX or the JAX package were loaded: {bad}", 3)
    if args.trace:
        metrics = harness.per_layer_values(ctx)
    else:
        wanted = {m["name"]: m["unit"] for m in harness.cell_metrics(ctx, "end_to_end")}
        missing = sorted(set(wanted) - set(res["end_to_end"]))
        if missing:
            raise harness.Fail(f"the entry did not measure {missing}", 4)
        metrics = {k: {"value": float(res["end_to_end"][k]), "unit": u}
                   for k, u in wanted.items()}
    checks = res["checks"]
    print("setup phases (s): " + json.dumps(ctx.extra.get("setup_phases", {})), file=sys.stderr)
    print("counters: " + json.dumps(ctx.counters), file=sys.stderr)
    print("host: " + json.dumps(ctx.extra.get("host", {})), file=sys.stderr)
    out = {"correct": all(c["ok"] for c in checks.values()) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": res["device"]}
    if args.trace and ctx.trace_summary is not None:
        out["device"]["busy_s"] = ctx.trace_summary["busy_s"]
        out["device"]["window_s"] = ctx.trace_summary["window_s"]
        out["breakdown"] = harness.breakdown(ctx.trace_summary)
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
