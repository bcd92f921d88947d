"""Each cell's run at a size the CPU holds, with the cell's own limits:
sound runs come out correct; the control (the program's own bf16 path in
place of float32) and each fault the cell can have, planted under the
timed path, come out not correct."""

import pytest
import torch

from benchmark import faults
from benchmark.entries import eval_step, vo_train
from benchmark.tests._tiny import tiny_ctx

EVAL = "pnvo-rn18.eval32"
TRAIN = ["pnvo-rn18.vo_train_joint", "pnvo-rn50.vo_train_fwd"]


def _ok(res):
    return all(c["ok"] for c in res["checks"].values())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def test_eval_sound_run_is_correct():
    res = eval_step.run(tiny_ctx(EVAL))
    assert _ok(res), res["checks"]
    assert res["attempted"] > 0 and res["end_to_end"]["eval_env_steps_per_s"] > 0


@pytest.mark.parametrize("cell", TRAIN)
def test_vo_train_sound_run_is_correct(cell):
    res = vo_train.run(tiny_ctx(cell))
    assert _ok(res), res["checks"]
    assert res["end_to_end"]["vo_train_pairs_per_s"] > 0


@pytest.mark.parametrize("cell", [EVAL] + TRAIN)
def test_the_control_is_not_correct(cell):
    entry = eval_step if cell == EVAL else vo_train
    assert not _ok(entry.run(tiny_ctx(cell), bf16=True))


@pytest.mark.parametrize("fault", sorted(faults.EVAL))
def test_eval_faults_are_not_correct(fault):
    assert not _ok(eval_step.run(tiny_ctx(EVAL), fault=faults.EVAL[fault]))


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_vo_train_faults_are_not_correct(cell, fault):
    assert not _ok(vo_train.run(tiny_ctx(cell), fault=faults.TRAIN[fault]))
