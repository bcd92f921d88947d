"""The readings the limits of ``limits/<cell>.json`` are set from, in one
process on the card: the program's compared numbers over a dozen seeds or
more, and the control's (the program's own bf16 path in place of the
configured float32) over three or more, each at the cell's own sizes with
a short window.

    python3 -m benchmark.readings --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9 \
        [--seconds 3] [--out FILE]

``--fault NAME --fault-seeds ...`` runs the program with a fault of
``faults.py`` planted.  Prints one JSON line a run: ``{"seed", "kind",
"readings"}``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import time
from pathlib import Path

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", help="a fault of benchmark/faults.py for --fault-seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise harness.Fail("needs a CUDA card")
    bench = harness.load_json(Path.cwd() / "BENCHMARK.json")
    lines = []
    from benchmark import faults

    planted = {**faults.EVAL, **faults.TRAIN}.get(args.fault)
    for kind, seeds in (("sound", args.seeds), ("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            ctx = harness.Ctx(bench, args.workload, seed, args.seconds, False,
                              time.perf_counter(), torch.device("cuda", 0))
            torch.backends.cuda.matmul.allow_tf32 = ctx.config["precision"]["tf32"]
            torch.backends.cudnn.allow_tf32 = ctx.config["precision"]["tf32"]
            entry = importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}")
            res = entry.run(ctx, bf16=kind == "control",
                             fault=planted if kind == "fault" else None)
            line = {"seed": seed, "kind": kind if kind != "fault" else args.fault,
                    "readings": {k: c["value"] for k, c in res["checks"].items()},
                    "steps": res["attempted"], "extra": ctx.extra}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del res, ctx
            gc.collect()
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
