"""DD-PPO's SE-ResNeXt101 + 2-layer LSTM-1024 policy on the port (CPU,
float32, seeded weights), against the benchmark's plain reference: the
backbone against ``benchmark/reference/backbones/se_resneXt101.py``, the
whole policy over three steps against ``benchmark/reference/nets.Policy``;
one ``fused_vo_act_step`` with it records the policy's three spans and
counts 33 SE gates (a ResNet18 policy: the same spans, no gate); the
benchmark's readers of those spans and that counter give nothing where
the tracer lacks them.

No JAX here: the reference is the benchmark's plain PyTorch.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import nets
from benchmark.reference.backbones import se_resneXt101 as ref_sext
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models import resnet
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils.logging import TRACER, Timing
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOEnsemble,
    VOInferenceConfig,
    frame_features_packed,
)

H, W, N = 64, 96, 3
BASE, HIDDEN, LAYERS = 32, 1024, 2
# float32 on the CPU: the same ops in the same order on both sides, but
# the port's LSTM is torch's fused cell and the reference's is written out
# by gates, so their sums round apart (about 1e-7 relative)
RTOL = 1e-5
SE_GATES = sum(ref_sext.LAYERS)  # one gate a block: 33
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_tracer():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


# ------------------------------------------------------------- the backbone


def test_backbone_matches_the_reference_and_loads_both_ways():
    ref = ref_sext.build(1, BASE)
    port = resnet.se_resneXt101(1, base_planes=BASE, ngroups=BASE // 2)
    sd = weights.seeded_state_dict(ref, 2**31 + 101, CPU, False)
    ref.load_state_dict(sd, strict=True)
    port.load_state_dict(sd, strict=True)
    # and back: the port's own state dict loads into the reference
    ref2 = ref_sext.build(1, BASE)
    ref2.load_state_dict(port.state_dict(), strict=True)
    assert port.final_channels == ref.final_channels == 1024
    x = torch.rand(2, 1, H, W, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out_p, out_r, out_r2 = port(x), ref(x), ref2(x)
    assert out_p.shape == out_r.shape == (2, 1024, 2, 3)
    assert _rel(out_p, out_r) < RTOL and torch.equal(out_r, out_r2)
    # the plan the reference copies: grouped 3x3 in each stage's first block
    # only, SE on every block, a downsample in each stage's first block
    for stage in range(1, 5):
        blocks = getattr(port, f"layer{stage}")
        assert [b.convs[3].groups for b in blocks] == [BASE // 2] + [1] * (len(blocks) - 1)
        assert all(b.se is not None for b in blocks)
        assert [b.downsample is not None for b in blocks] == [True] + [False] * (len(blocks) - 1)


# --------------------------------------------------------------- the policy


@pytest.fixture(scope="module")
def policies():
    """The port's policy and the reference's on one seeded state dict."""
    ref = nets.Policy(H, W, "se_resneXt101", HIDDEN, LAYERS).eval()
    sd = weights.seeded_state_dict(ref, 2**31 + 7, CPU, False)
    ref.load_state_dict(sd, strict=True)
    port = PointNavActorCritic(image_size=(H, W), hidden_size=HIDDEN,
                               backbone="se_resneXt101", num_recurrent_layers=LAYERS,
                               vis_types=("depth",), rnn_type="LSTM").eval()
    port.load_state_dict(sd, strict=True)
    return port, ref


def _steps(seed=0, steps=3):
    """Each step's depth, goal (rho, phi), previous action and mask; env 1
    starts a new episode at the second step."""
    rng = np.random.default_rng(seed)
    for t in range(steps):
        mask = np.ones((N, 1), np.float32)
        mask[1, 0] = 0.0 if t == 1 else 1.0
        yield (torch.from_numpy(rng.uniform(0, 1, (N, H, W, 1)).astype(np.float32)),
               torch.from_numpy(np.stack([rng.uniform(0.5, 5, N), rng.uniform(-3, 3, N)],
                                         -1).astype(np.float32)),
               torch.from_numpy(rng.integers(0, 4, (N, 1))),
               torch.from_numpy(mask))


def _run(port, ref):
    """Three steps on both sides, each carrying its own state; the worst
    relative gaps of logits, value and LSTM state."""
    hp = port.initial_hidden(N)
    hr = torch.zeros(2 * LAYERS, N, HIDDEN)
    worst = {"logits": 0.0, "value": 0.0, "hidden": 0.0}
    with torch.no_grad():
        for depth, polar, prev, mask in _steps():
            obs = {"depth": depth, "pointgoal_with_gps_compass": polar}
            lp, vp, hp = port(obs, hp, prev, mask)
            lr, vr, hr = ref(depth, polar, hr, prev, mask)
            for k, a, b in (("logits", lp, lr), ("value", vp, vr), ("hidden", hp, hr)):
                worst[k] = max(worst[k], _rel(a, b))
    return worst


def test_policy_matches_the_reference_over_three_steps_with_a_reset(policies):
    port, ref = policies
    worst = _run(port, ref)
    assert all(v < RTOL for v in worst.values()), worst


def test_a_perturbed_se_gate_weight_is_caught(policies):
    port, ref = policies
    w = port.net.visual_encoder.backbone.layer3[11].se.excite[2].weight
    keep = w.detach().clone()
    with torch.no_grad():
        w[7, 3] += 1.0
    try:
        worst = _run(port, ref)
    finally:
        with torch.no_grad():
            w.copy_(keep)
    assert max(worst.values()) > 10 * RTOL, worst


# ------------------------------------------------- the eval step's tracing


def _one_eval_step(policy):
    """One warmed ``fused_vo_act_step`` at 64x96 with three tiny ResNet18
    experts and ``policy``, run with the tracer reset."""
    g = torch.Generator().manual_seed(0)
    cfg = VOInferenceConfig(vis_size_w=W, vis_size_h=H, hidden_size=32)
    vo = VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                    device=CPU)
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    rgb = t(rng.integers(0, 256, (2, N, H, W, 3)).astype(np.uint8))
    depth = t(rng.uniform(0, 1, (2, N, H, W, 1)).astype(np.float32))
    prev = frame_features_packed(rgb[0], depth[0], cfg)
    reset = t(np.zeros((N, 1), np.float32))
    sensor = t(np.stack([rng.uniform(0.5, 5, N), rng.uniform(-3, 3, N)], -1)
               .astype(np.float32))
    goal = t(rng.normal(size=(N, 3)).astype(np.float32))
    seed_rot = t(np.tile(np.asarray([0, 0, 0, 1], np.float32), (N, 1)))
    seed_pos = t(np.zeros((N, 3), np.float32))
    acts = np.asarray([1, 2, 3], np.int32)

    def step():
        return fused_vo_act_step(policy, vo, prev, rgb[1], depth[1], acts, goal, reset,
                                 sensor, policy.initial_hidden(N),
                                 t(acts.astype(np.int64)[:, None]), 1.0 - reset, seed_rot,
                                 seed_pos, seed_rot, seed_pos)

    step()  # warm-up: the constants' first uploads
    tk.reset_launch_counts()
    step()
    return TRACER.snapshot()


POLICY_SPANS = ("policy.encoder", "policy.rnn", "policy.heads")


def _rn18_policy():
    return seeded_init_(PointNavActorCritic(image_size=(H, W), hidden_size=32, baseplanes=8),
                        torch.Generator().manual_seed(1)).eval()


@pytest.mark.parametrize("backbone", ["se_resneXt101", "resnet18"])
def test_eval_step_records_policy_spans_and_counts_se_gates(backbone, policies):
    policy = policies[0] if backbone == "se_resneXt101" else _rn18_policy()
    snap = _one_eval_step(policy)
    for name in POLICY_SPANS:
        assert snap["spans"][name]["count"] == 1 and snap["spans"][name]["parents"] == ["policy"]
    assert snap["spans"]["policy"]["total_ns"] >= sum(
        snap["spans"][n]["total_ns"] for n in POLICY_SPANS)
    assert snap["counters"].get("se_gates", 0) == (SE_GATES if backbone != "resnet18" else 0)


# ----------------------------------------------------- the benchmark's readers


READERS = ("policy_idle_pct.eval", "policy_encoder_ms.eval", "se_gates_per_step.eval")


def _ctx():
    return SimpleNamespace(traffic={"entry": "eval_step"}, trace_summary={
        "busy_s": 1.0, "window_s": 2.0,
        "gaps": {"policy": 0.1, "policy.encoder": 0.2, "policy.rnn": 0.05,
                 "policy.heads": 0.05, "vo.expert": 0.4}})


def test_readers_give_nothing_without_their_span_or_counter(monkeypatch):
    monkeypatch.setattr(tlog, "TRACER", Timing(profiled=Timing()))
    with tlog.TRACER.span("eval_step"):
        with tlog.TRACER.span("policy"):
            pass
    ctx = _ctx()
    for name in READERS:
        assert harness._load_reader(name)(ctx) is None, name


def test_readers_read_the_policy_spans_and_the_gate_counter(monkeypatch):
    monkeypatch.setattr(tlog, "TRACER", Timing(profiled=Timing()))
    for _ in range(2):
        with tlog.TRACER.span("eval_step"):
            with tlog.TRACER.span("policy"):
                with tlog.TRACER.span("policy.encoder"):
                    tlog.TRACER.count("se_gates", SE_GATES)
    ctx = _ctx()
    got = {name: harness._load_reader(name)(ctx) for name in READERS}
    assert got["policy_idle_pct.eval"] == pytest.approx(100.0 * 0.4 / 2.0)
    assert math.isfinite(got["policy_encoder_ms.eval"]) and got["policy_encoder_ms.eval"] > 0
    assert got["se_gates_per_step.eval"] == SE_GATES
