"""Analytic multiply-adds of the models the cells run, from each
configuration's published architecture alone (never from the measured
program's modules), so the count stays put whatever implements a step.

Counted: every conv and linear layer (the GroupNorm ResNet's basic or
bottleneck blocks and downsamples, the 3x3 compression conv, the VO FC
trunk, the policy's encoder on 2x2-pooled depth, its goal and output
layers) and the LSTM's gate products.  Left out: GroupNorm, whitening,
pooling, activations, the feature pipeline and every other elementwise op
(a few percent of the step's arithmetic).  One multiply-add is 2 FLOPs.

``resnet_macs`` counts the two plans of ``PLANS`` here; for any other
backbone it asks the ``macs`` of ``benchmark/reference/backbones/<name>.py``,
which is analytic too: written from the published plan, a grouped conv
counting ``cin / groups`` input channels an output and an SE gate its two
linears.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

from benchmark.reference import backbones

PLANS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}
EXPANSION = {"basic": 1, "bottleneck": 4}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(cin, cout, k, s, p, h, w) -> Tuple[int, int, int]:
    oh, ow = _out(h, k, s, p), _out(w, k, s, p)
    return cout * oh * ow * cin * k * k, oh, ow


def resnet_macs(name: str, cin: int, h: int, w: int, base: int = 32) -> Tuple[int, int, int, int]:
    """(multiply-adds, channels, height, width) of the GroupNorm ResNet's
    output on a ``cin x h x w`` input; a backbone outside ``PLANS`` from
    its file under ``benchmark/reference/backbones/``."""
    if name not in PLANS:
        return backbones.lookup(name).macs(cin, h, w, base)
    kind, layers = PLANS[name]
    macs, h, w = _conv(cin, base, 7, 2, 3, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool
    inp = base
    for stage, n in enumerate(layers):
        planes = base * 2 ** stage
        out = planes * EXPANSION[kind]
        for j in range(n):
            s = (1 if stage == 0 else 2) if j == 0 else 1
            if j == 0 and (s != 1 or inp != out):
                m, _, _ = _conv(inp, out, 1, s, 0, h, w)
                macs += m
            if kind == "basic":
                m1, oh, ow = _conv(inp, planes, 3, s, 1, h, w)
                m2, _, _ = _conv(planes, planes, 3, 1, 1, oh, ow)
                macs += m1 + m2
            else:
                m1, _, _ = _conv(inp, planes, 1, 1, 0, h, w)
                m2, oh, ow = _conv(planes, planes, 3, s, 1, h, w)
                m3, _, _ = _conv(planes, out, 1, 1, 0, oh, ow)
                macs += m1 + m2 + m3
            h, w, inp = oh, ow, out
    return macs, inp, h, w


def _compressed(name: str, cin: int, h: int, w: int) -> Tuple[int, int]:
    """(multiply-adds of backbone + compression conv, flat feature size)."""
    macs, c, oh, ow = resnet_macs(name, cin, h, w)
    ch = int(round(2048 / (math.ceil(h / 32) * math.ceil(w / 32))))
    m, oh, ow = _conv(c, ch, 3, 1, 1, oh, ow)
    return macs + m, ch * oh * ow


def vo_input_channels(cfg: Mapping) -> int:
    """Channels of the packed frame pair: rgb 3, depth 1, discretized depth
    ``dd`` and the top-down view 1, per frame."""
    per = {"rgb": 3, "depth": 1, "discretized_depth": cfg["discretized_depth_channels"],
           "top_down_view": 1}
    return 2 * sum(per[k] for k in cfg["visual_type"])


def vo_expert_macs(cfg: Mapping) -> Dict[str, int]:
    """One VO expert's forward on one frame pair (``cfg``: the configuration
    file's ``vo`` group)."""
    conv, flat = _compressed(cfg["visual_backbone"], vo_input_channels(cfg),
                             cfg["vis_size_h"], cfg["vis_size_w"])
    hid = cfg["hidden_size"]
    return {"conv_linear": conv + flat * hid + hid * 3, "lstm": 0}


def policy_macs(cfg: Mapping, h: int, w: int) -> Dict[str, int]:
    """One policy step of one env (``cfg``: the ``policy`` group) on depth."""
    conv, flat = _compressed(cfg["visual_backbone"], 1, h // 2, w // 2)
    hid = cfg["hidden_size"]
    lin = flat * hid + 3 * 32 + hid * 4 + hid
    din = hid + 32 + 32
    lstm = sum(4 * hid * ((din if k == 0 else hid) + hid)
               for k in range(cfg["num_recurrent_layers"]))
    return {"conv_linear": conv + lin, "lstm": lstm}


def total(macs: Mapping[str, int]) -> int:
    return sum(macs.values())


def eval_step_flops(cfg: Mapping, envs: int) -> int:
    """One closed-loop eval step: each env's own VO expert on its frame
    pair, then the policy's step."""
    vo = cfg["vo"]
    per = total(vo_expert_macs(vo)) + total(policy_macs(cfg["policy"], vo["vis_size_h"],
                                                          vo["vis_size_w"]))
    return 2 * envs * per


def vo_train_step_flops(cfg: Mapping, rows: int) -> int:
    """One VO train step: forward and backward (3x the forward) over the
    rows forwarded."""
    return 3 * 2 * rows * total(vo_expert_macs(cfg["vo"]))
