"""``benchmark/flops.py`` against the multiply-adds that forward hooks count
on the reference's conv and linear layers, at a small input."""

import math

import pytest
import torch
from torch import nn

from benchmark import flops
from benchmark.reference import nets

VO = {"visual_type": ["rgb", "depth", "discretized_depth", "top_down_view"],
      "discretized_depth_channels": 10, "vis_size_h": 70, "vis_size_w": 101, "hidden_size": 64}


def _hooked_macs(module, *inputs, call=None):
    count = [0]

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            count[0] += out.numel() // out.shape[0] * math.prod(m.weight.shape[1:])
        elif isinstance(m, nn.Linear):
            count[0] += out.numel() // out.shape[0] * m.in_features
    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, (nn.Conv2d, nn.Linear))]
    with torch.no_grad():
        (call or module)(*inputs)
    for h in hs:
        h.remove()
    return count[0]


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_vo_expert_count_matches_hooks(backbone):
    cfg = dict(VO, visual_backbone=backbone)
    cin = flops.vo_input_channels(cfg)
    m = nets.VOCNN(cin, cfg["vis_size_h"], cfg["vis_size_w"], backbone, cfg["hidden_size"])
    x = torch.rand(1, cfg["vis_size_h"], cfg["vis_size_w"], cin)
    assert _hooked_macs(m, x) == flops.vo_expert_macs(cfg)["conv_linear"]


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_policy_count_matches_hooks(backbone):
    h, w, hid = 70, 101, 64
    cfg = {"visual_backbone": backbone, "hidden_size": hid, "num_recurrent_layers": 2}
    m = nets.Policy(h, w, backbone, hid, 2)
    for p in m.parameters():
        nn.init.normal_(p, std=0.05)
    args = (torch.rand(1, h, w, 1), torch.rand(1, 2), torch.zeros(4, 1, hid),
            torch.zeros(1, 1, dtype=torch.long), torch.ones(1, 1))
    macs = flops.policy_macs(cfg, h, w)
    # the embedding is a lookup: no multiply-add; the LSTM is counted apart
    assert _hooked_macs(m, *args) == macs["conv_linear"]
    din = hid + 64
    assert macs["lstm"] == 4 * hid * (din + hid) + 4 * hid * (hid + hid)


def test_step_flops_at_the_published_sizes():
    rn18 = {"vo": dict(VO, visual_backbone="resnet18", vis_size_h=192, vis_size_w=341,
                       hidden_size=512),
            "policy": {"visual_backbone": "resnet18", "hidden_size": 512,
                       "num_recurrent_layers": 2}}
    assert flops.eval_step_flops(rn18, 32) == 96_239_294_464
    assert flops.vo_train_step_flops(rn18, 128) == 1_030_837_764_096
