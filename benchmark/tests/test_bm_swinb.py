"""``pnvo-swinb.eval32`` at a size the CPU holds (64x96, the hidden widths
32, every stage, block and width of Swin-B), with the cell's own limits:
the sound run comes out correct and the port's experts are the backbone
file's Swin-B, counting their windows; the control (the program's bf16
path) and the half-batch fault come out not correct.  The step's FLOPs at
the published 341x192 are pinned."""

import json
import math

import pytest
import torch

from benchmark import faults, flops
from benchmark.entries import common, eval_step
from benchmark.reference.backbones import swin_b as ref_swin
from benchmark.tests._tiny import ROOT, tiny_ctx

CELL = "pnvo-swinb.eval32"
# flops.eval_step_flops at 32 envs and 341x192: 2 x 32 x (one Swin-B
# expert's 23,447,452,160 multiply-adds, its attention matmuls left out,
# + the ResNet18 + LSTM-512 policy's 161,502,304)
STEP_FLOPS = 1_510_973_085_696


def _ok(res):
    return all(c["ok"] for c in res["checks"].values())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def _windows(h, w):
    """Windows one frame pair attends: each block's ``ceil(H/7) x ceil(W/7)``
    over the stages' maps."""
    h, w = math.ceil(h / 4), math.ceil(w / 4)
    total = 0
    for depth in ref_swin.DEPTHS:
        total += depth * math.ceil(h / 7) * math.ceil(w / 7)
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return total


def test_sound_run_is_correct_on_the_port_swin_b(monkeypatch):
    from pointnav_vo_tpu_torch.models.swin import SwinTransformer
    from pointnav_vo_tpu_torch.utils.logging import TRACER

    built = []
    expert = common.port_vo_expert
    monkeypatch.setattr(common, "port_vo_expert",
                        lambda *a, **k: built.append(expert(*a, **k)) or built[-1])
    TRACER.reset()
    ctx = tiny_ctx(CELL)
    res = eval_step.run(ctx)
    assert _ok(res), res["checks"]
    assert res["attempted"] > 0 and res["end_to_end"]["eval_env_steps_per_s"] > 0
    assert len(built) == 3
    for m in built:
        backbone = m.visual_encoder.backbone
        assert isinstance(backbone, SwinTransformer)
        assert [len(s.blocks) for s in backbone.layers] == list(ref_swin.DEPTHS)
    assert ctx.counters["step_flops"] == flops.eval_step_flops(ctx.config, ctx.traffic["envs"])
    # every env's pair through one expert, every step of the window
    steps = TRACER.snapshot()["spans"]["eval_step"]["count"]
    assert TRACER.counters["swin_windows"] == steps * ctx.traffic["envs"] * _windows(64, 96)


@pytest.mark.parametrize("kind", ["control", "half_left_out"])
def test_control_and_fault_are_not_correct(kind):
    if kind == "control":
        res = eval_step.run(tiny_ctx(CELL), bf16=True)
    else:
        res = eval_step.run(tiny_ctx(CELL), fault=faults.half_left_out)
    assert not _ok(res), res["checks"]


def test_step_flops_at_the_published_size():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "pnvo-swinb.json").read_text())
    assert flops.eval_step_flops(cfg, 32) == STEP_FLOPS
    # the count from the published plan: 23.45 G a pair in an expert, 99.3 %
    # of the step's 1,511.0 GFLOP
    expert = flops.vo_expert_macs(cfg["vo"])["conv_linear"]
    assert round(expert / 1e9, 2) == 23.45 and round(STEP_FLOPS / 1e9, 1) == 1511.0
    assert round(2 * 32 * expert / STEP_FLOPS, 3) == 0.993
    assert _windows(192, 341) == 386
