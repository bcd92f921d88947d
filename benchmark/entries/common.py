"""Building the measured program and the reference from one configuration
file, with the same seeded weights."""

from __future__ import annotations

import torch

from benchmark.flops import vo_input_channels
from benchmark.reference import nets


def vo_template(cfg: dict) -> nets.VOCNN:
    vo = cfg["vo"]
    with torch.device("meta"):
        return nets.VOCNN(vo_input_channels(vo), vo["vis_size_h"], vo["vis_size_w"],
                          vo["visual_backbone"], vo["hidden_size"], vo["dropout_p"])


def policy_template(cfg: dict) -> nets.Policy:
    p, vo = cfg["policy"], cfg["vo"]
    with torch.device("meta"):
        return nets.Policy(vo["vis_size_h"], vo["vis_size_w"], p["visual_backbone"],
                           p["hidden_size"], p["num_recurrent_layers"])


def reference_module(template, sd, device):
    """A reference module built as ``template`` was, holding ``sd``."""
    with torch.device(device):
        m = type(template)(*template.args)
    m.load_state_dict({k: v.clone() for k, v in sd.items()})
    return m


def port_vo_config(cfg: dict, bf16: bool):
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    vo = cfg["vo"]
    return VOInferenceConfig(
        model_name=vo["name"], observation_space=tuple(vo["visual_type"]),
        vis_size_w=vo["vis_size_w"], vis_size_h=vo["vis_size_h"],
        hidden_size=vo["hidden_size"], backbone=vo["visual_backbone"],
        discretized_depth_channels=vo["discretized_depth_channels"],
        dropout_p=vo["dropout_p"], mode="det", precision="bf16" if bf16 else "fp32")


def port_vo_expert(icfg, sd, device):
    with torch.device(device):
        m = icfg.make_model()
    m.load_state_dict(sd)
    return m


def port_policy(cfg: dict, sd, device, bf16: bool):
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic

    p, vo = cfg["policy"], cfg["vo"]
    with torch.device(device):
        m = PointNavActorCritic(
            image_size=(vo["vis_size_h"], vo["vis_size_w"]), hidden_size=p["hidden_size"],
            backbone=p["visual_backbone"], num_recurrent_layers=p["num_recurrent_layers"],
            vis_types=tuple(p["visual_types"]), rnn_type=p["rnn_backbone"],
            compute_dtype=torch.bfloat16 if bf16 else None)
    m.load_state_dict(sd)
    return m.eval()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
