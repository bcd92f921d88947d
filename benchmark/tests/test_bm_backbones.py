"""A configuration brings a backbone beyond ``nets.PLANS`` as one file
under ``benchmark/reference/backbones/``: the existing configurations keep
their templates and counts; every backbone file's analytic count agrees
with forward hooks, and its module loads the port's weights and agrees
with the port; a backbone file put in place by a test alone (ResNet-101)
runs the eval entry correct and its fault caught; an unknown name fails at
set-up, naming the file it looked for."""

import hashlib
import json
import re
import sys

import pytest
import torch

from benchmark import faults, flops, weights
from benchmark.entries import common, eval_step
from benchmark.reference import backbones, nets
from benchmark.tests import _backbone_resnet101
from benchmark.tests._tiny import ROOT, tiny_ctx
from benchmark.tests.test_bm_flops import _hooked_macs

FIXTURE = "resnet101"
# the templates' state dicts before the lookup existed: the number of keys
# and the sha256 of their "key shape" lines in order (the seeded weights
# follow that order); the eval step's FLOPs at 32 envs and a VO train
# step's at 128 rows
PINNED = {
    "pnvo-rn18": {"vo": (70, "d0ab98a8737166b2eae95f3425dae4961851f25dc8fe925a1bcdec79a5764beb"),
                  "policy": (80, "441fa53cc1a2ecd3fd59db4623e7596fe46ce82d8c6fc875a2df402e7e447a26"),
                  "flops": (96_239_294_464, 1_030_837_764_096)},
    "pnvo-rn50": {"vo": (169, "34cb4eec7b2ace85213a9691eb0ffbae678af08c50978f2ee4a313f332f34ca0"),
                  "policy": (179, "3fae06bdd6c2a4003327e56311ed1331ee74d1ebedb8cb3f3b820d7e4898a01f"),
                  "flops": (158_953_412_608, 1_624_237_277_184)},
}


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.fixture
def fixture_file(monkeypatch):
    monkeypatch.setitem(sys.modules, f"{backbones.__name__}.{FIXTURE}", _backbone_resnet101)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(PINNED))
@pytest.mark.parametrize("kind", ["vo", "policy"])
def test_existing_templates_keep_keys_order_and_shapes(config, kind):
    cfg = _config(config)
    template = common.vo_template(cfg) if kind == "vo" else common.policy_template(cfg)
    sd = template.state_dict()
    lines = "\n".join(f"{k} {tuple(v.shape)}" for k, v in sd.items())
    assert (len(sd), hashlib.sha256(lines.encode()).hexdigest()) == PINNED[config][kind]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_existing_step_flops_are_unchanged(config):
    cfg = _config(config)
    assert (flops.eval_step_flops(cfg, 32), flops.vo_train_step_flops(cfg, 128)) == \
        PINNED[config]["flops"]


def test_the_package_lists_its_backbone_files(fixture_file):
    files = sorted(p.stem for p in backbones.HERE.glob("*.py") if not p.stem.startswith("_"))
    assert backbones.names() == files and not set(files) & set(nets.PLANS)
    # a module put in place of a file is found, not listed
    assert FIXTURE not in files and backbones.lookup(FIXTURE) is _backbone_resnet101


@pytest.mark.parametrize("name", backbones.names() + [FIXTURE])
def test_backbone_macs_match_hooks(name, fixture_file):
    mod = backbones.lookup(name)
    cin, h, w, base = 1, 70, 101, 32
    m = mod.build(cin, base)
    x = torch.rand(1, cin, h, w)
    macs, ch, oh, ow = mod.macs(cin, h, w, base)
    assert _hooked_macs(m, x) == macs
    with torch.no_grad():
        assert tuple(m(x).shape) == (1, ch, oh, ow) and m.final_channels == ch


@pytest.mark.parametrize("name", backbones.names() + [FIXTURE])
def test_backbone_counts_reach_the_vo_expert_and_policy(name, fixture_file):
    """The factory in ``nets`` and the count in ``flops`` take the file's
    backbone alike, through the VO expert and the policy."""
    vo = {"visual_type": ["rgb", "depth", "discretized_depth", "top_down_view"],
          "discretized_depth_channels": 10, "vis_size_h": 70, "vis_size_w": 101,
          "hidden_size": 64, "visual_backbone": name}
    cin = flops.vo_input_channels(vo)
    expert = nets.VOCNN(cin, 70, 101, name, 64)
    assert _hooked_macs(expert, torch.rand(1, 70, 101, cin)) == \
        flops.vo_expert_macs(vo)["conv_linear"]
    policy = nets.Policy(70, 101, name, 64, 2)
    args = (torch.rand(1, 70, 101, 1), torch.rand(1, 2), torch.zeros(4, 1, 64),
            torch.zeros(1, 1, dtype=torch.long), torch.ones(1, 1))
    cfg = {"visual_backbone": name, "hidden_size": 64, "num_recurrent_layers": 2}
    assert _hooked_macs(policy, *args) == flops.policy_macs(cfg, 70, 101)["conv_linear"]


@pytest.mark.parametrize("name", backbones.names() + [FIXTURE])
def test_backbone_loads_the_port_weights_and_agrees(name, fixture_file):
    from pointnav_vo_tpu_torch.models import resnet

    base = 8
    with torch.device("meta"):
        template = backbones.lookup(name).build(3, base)
    sd = weights.seeded_state_dict(template, 2**31 + 5, torch.device("cpu"), False)
    ref = backbones.lookup(name).build(3, base)
    port = resnet.BACKBONES[name](3, base_planes=base, ngroups=base // 2)
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    x = torch.rand(2, 3, 64, 96)
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x))


def _ok(res):
    return all(c["ok"] for c in res["checks"].values())


def _fixture_ctx():
    ctx = tiny_ctx("pnvo-rn18.eval32")
    ctx.config["policy"]["visual_backbone"] = FIXTURE
    return ctx


def test_eval_entry_is_correct_on_a_backbone_from_its_file(fixture_file, monkeypatch):
    built = []
    port_policy = common.port_policy
    monkeypatch.setattr(common, "port_policy",
                        lambda *a, **k: built.append(port_policy(*a, **k)) or built[-1])
    ctx = _fixture_ctx()
    res = eval_step.run(ctx)
    assert _ok(res), res["checks"]
    # the port ran its own ResNet-101, and the step's count holds it
    assert len(built[0].net.visual_encoder.backbone.layer3) == 23
    n = ctx.traffic["envs"]
    assert ctx.counters["step_flops"] == flops.eval_step_flops(ctx.config, n)
    rn18 = dict(ctx.config, policy=dict(ctx.config["policy"], visual_backbone="resnet18"))
    assert ctx.counters["step_flops"] > flops.eval_step_flops(rn18, n)


def test_eval_entry_catches_a_fault_on_a_backbone_from_its_file(fixture_file):
    assert not _ok(eval_step.run(_fixture_ctx(), fault=faults.half_left_out))


@pytest.mark.parametrize("group", ["vo", "policy"])
def test_unknown_backbone_fails_at_set_up_naming_its_file(group):
    ctx = tiny_ctx("pnvo-rn18.eval32")
    ctx.config[group]["visual_backbone"] = "resnet152"
    wanted = re.escape("benchmark/reference/backbones/resnet152.py")
    with pytest.raises(FileNotFoundError, match=wanted):
        eval_step.run(ctx)
    with pytest.raises(FileNotFoundError, match=wanted):
        flops.eval_step_flops(ctx.config, 32)
