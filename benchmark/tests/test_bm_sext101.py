"""``pnvo-sext101.eval32`` at a size the CPU holds (64x96, the LSTM 32
wide, every layer of the SE-ResNeXt101 at base 32), with the cell's own
limits: the sound run comes out correct and the port's policy is the
backbone's file's; the control (the program's bf16 path) and the
half-batch fault come out not correct."""

import pytest
import torch

from benchmark import faults, flops
from benchmark.entries import common, eval_step
from benchmark.tests._tiny import tiny_ctx

CELL = "pnvo-sext101.eval32"


def _ok(res):
    return all(c["ok"] for c in res["checks"].values())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct_on_the_port_se_resnext101(monkeypatch):
    built = []
    port_policy = common.port_policy
    monkeypatch.setattr(common, "port_policy",
                        lambda *a, **k: built.append(port_policy(*a, **k)) or built[-1])
    ctx = tiny_ctx(CELL)
    res = eval_step.run(ctx)
    assert _ok(res), res["checks"]
    assert res["attempted"] > 0 and res["end_to_end"]["eval_env_steps_per_s"] > 0
    backbone = built[0].net.visual_encoder.backbone
    assert [len(backbone.layer1), len(backbone.layer3)] == [3, 23]
    assert backbone.layer1[0].convs[3].groups == 16 and backbone.layer1[0].se is not None
    assert ctx.counters["step_flops"] == flops.eval_step_flops(ctx.config, ctx.traffic["envs"])


@pytest.mark.parametrize("kind", ["control", "half_left_out"])
def test_control_and_fault_are_not_correct(kind):
    if kind == "control":
        res = eval_step.run(tiny_ctx(CELL), bf16=True)
    else:
        res = eval_step.run(tiny_ctx(CELL), fault=faults.half_left_out)
    assert not _ok(res), res["checks"]
