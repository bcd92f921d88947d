"""A cell at a size the CPU holds: the real harness, entries, traffic
generator and reference, with the configuration's frames cut to 64x96,
the hidden widths to 32 and the traffic to a few envs and batches."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
TINY_VO = {"vis_size_w": 96, "vis_size_h": 64, "hidden_size": 32}
TINY_POLICY = {"hidden_size": 32}
TINY_TRAFFIC = {"eval_step": {"envs": 4, "bank_steps": 4, "samples": 2,
                              "profile_seconds": 0.0},
                "vo_train": {"batch_size": 8, "host_batches": 4, "walkers": 4,
                             "profile_seconds": 0.0}}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_ctx(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             limits=None) -> harness.Ctx:
    ctx = harness.Ctx(bench(), workload, seed, seconds, False, time.perf_counter(),
                      torch.device("cpu"))
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["vo"].update(TINY_VO)
    ctx.config["policy"].update(TINY_POLICY)
    ctx.traffic = dict(ctx.traffic, **TINY_TRAFFIC[ctx.traffic["entry"]])
    if limits is not None:
        ctx.limits = limits
    return ctx
