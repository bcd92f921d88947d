"""Carry weights across: flax variable trees (nested dicts of numpy arrays)
-> state dicts of the port's modules, with the reference's key names, and
back for the VO expert and the policy.

The port's own copy of the key mapping of ``io/torch_export.py``: conv
HWIO -> OIHW, dense ``(in, out)`` -> ``(out, in)``, GroupNorm ``scale`` ->
``weight``, RunningMeanAndVar ``(C,)`` stats -> ``(1, C, 1, 1)`` buffers;
the LSTM matrices are stored in torch's layout already and pass through.

:func:`vo_state_dicts_from_stacked` reads the JAX training engine's stacked
expert tree (a leading expert axis); :func:`vo_variables_from_state_dict`,
:func:`stacked_vo_variables` and :func:`policy_variables_from_state_dict`
go the other way.  A gradient tree has the parameters' structure, so
``{name: p.grad}`` maps back the same way.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


_KIND = {"conv": _conv, "dense": _dense, "plain": lambda v: v}

# position inside a block's ``convs`` Sequential (conv, gn, relu, conv, gn)
_CONVS_IDX = {"conv1": "0", "gn1": "1", "conv2": "3", "gn2": "4"}


def _wb(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]


def _linear(key: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    return f"{key}.{_wb(leaf)}", (_dense(v) if leaf == "kernel" else v)


def _backbone_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax path under ``backbone`` -> (key suffix, kind)."""
    name, leaf = path[0], path[-1]
    if name == "conv1":
        return "conv1.0.weight", "conv"
    if name == "gn1":
        return f"conv1.1.{_wb(leaf)}", "plain"
    layer, block = name.rsplit("_", 1)  # layer<L>_<B> -> layer<L>.<B>
    base = f"{layer}.{block}"
    sub = path[1]
    if sub in _CONVS_IDX:
        kind = "conv" if sub.startswith("conv") else "plain"
        return f"{base}.convs.{_CONVS_IDX[sub]}.{_wb(leaf)}", kind
    if sub == "down_conv":
        return f"{base}.downsample.0.weight", "conv"
    if sub == "down_gn":
        return f"{base}.downsample.1.{_wb(leaf)}", "plain"
    raise KeyError(f"unrecognized backbone path: {'.'.join(path)}")


def _encoder_entry(rest: Tuple[str, ...], v: np.ndarray, prefix: str):
    leaf = rest[-1]
    if rest[0] == "backbone":
        key, kind = _backbone_key(rest[1:])
        return f"{prefix}backbone.{key}", _KIND[kind](v)
    if rest[0] == "compression_conv":
        return f"{prefix}compression.0.weight", _conv(v)
    if rest[0] == "compression_gn":
        return f"{prefix}compression.1.{_wb(leaf)}", v
    raise KeyError(f"unrecognized visual_encoder path: {'.'.join(rest)}")


def _rmv_entries(stats: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    rmv = stats["visual_encoder"]["rmv"]
    key = f"{prefix}running_mean_and_var."
    return {
        key + "_mean": np.asarray(rmv["mean"], np.float32).reshape(1, -1, 1, 1),
        key + "_var": np.asarray(rmv["var"], np.float32).reshape(1, -1, 1, 1),
        key + "_count": np.asarray(rmv["count"], np.float32).reshape(()),
    }


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def vo_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VOCNN`` variables -> state dict of :class:`models.vo_cnn.VOCNN`."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(variables.get("params", {})):
        head, leaf = path[0], path[-1]
        if head == "visual_encoder":
            key, val = _encoder_entry(path[1:], v, "visual_encoder.")
        elif head == "visual_fc":  # Sequential(Flatten, Dropout, Linear, ReLU)
            key, val = _linear("visual_fc.2", leaf, v)
        elif head == "output_head":  # Sequential(Dropout, Linear)
            key, val = _linear("output_head.1", leaf, v)
        else:
            raise KeyError(f"unrecognized VO param: {'.'.join(path)}")
        sd[key] = val
    sd.update(_rmv_entries(variables["batch_stats"], "visual_encoder."))
    return _to_torch(sd)


def _backbone_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """Inverse of :func:`_backbone_key`: torch key under ``backbone.`` ->
    (flax path, kind)."""
    parts = key.split(".")
    leaf = parts[-1]
    gn_leaf = "scale" if leaf == "weight" else "bias"
    if parts[0] == "conv1":
        return (("conv1", "kernel"), "conv") if parts[1] == "0" else (("gn1", gn_leaf), "plain")
    block = f"{parts[0]}_{parts[1]}"
    if parts[2] == "convs":
        sub = {v: k for k, v in _CONVS_IDX.items()}[parts[3]]
        if sub.startswith("conv"):
            return (block, sub, "kernel"), "conv"
        return (block, sub, gn_leaf), "plain"
    if parts[2] == "downsample":
        if parts[3] == "0":
            return (block, "down_conv", "kernel"), "conv"
        return (block, "down_gn", gn_leaf), "plain"
    raise KeyError(f"unrecognized backbone key: {key}")


def _encoder_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """Inverse of :func:`_encoder_entry`: torch key under ``visual_encoder.``
    -> (flax path under ``visual_encoder``, kind)."""
    leaf = key.rsplit(".", 1)[-1]
    if key.startswith("backbone."):
        path, kind = _backbone_path(key[len("backbone."):])
        return ("backbone",) + path, kind
    if key == "compression.0.weight":
        return ("compression_conv", "kernel"), "conv"
    if key.startswith("compression.1."):
        return ("compression_gn", "scale" if leaf == "weight" else "bias"), "plain"
    raise KeyError(f"unrecognized visual_encoder key: {key}")


def _dense_path(name: str, leaf: str) -> Tuple[Tuple[str, ...], str]:
    """A linear layer's ``weight``/``bias`` -> flax ``kernel``/``bias``."""
    if leaf == "weight":
        return (name, "kernel"), "dense"
    return (name, "bias"), "plain"


def _vo_param_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """Torch parameter key of :class:`models.vo_cnn.VOCNN` -> (flax path
    under ``params``, kind)."""
    leaf = key.rsplit(".", 1)[-1]
    if key.startswith("visual_encoder."):
        path, kind = _encoder_path(key[len("visual_encoder."):])
        return ("visual_encoder",) + path, kind
    if key.startswith("visual_fc.2."):
        return _dense_path("visual_fc", leaf)
    if key.startswith("output_head.1."):
        return _dense_path("output_head", leaf)
    raise KeyError(f"unrecognized VO key: {key}")


_KIND_INV = {"conv": lambda w: np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
             "dense": np.transpose, "plain": lambda v: v}


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def vo_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """State dict (or ``{name: grad}``) of :class:`models.vo_cnn.VOCNN` ->
    flax ``{"params": ..., "batch_stats": ...}`` of numpy arrays (no
    ``batch_stats`` when ``sd`` holds no whitening buffers)."""
    out: Dict[str, Dict] = {"params": {}}
    rmv = "visual_encoder.running_mean_and_var."
    for key, v in sd.items():
        a = v.detach().cpu().numpy().astype(np.float32)
        if key.startswith(rmv):
            name = {"_mean": "mean", "_var": "var", "_count": "count"}[key[len(rmv):]]
            _set(out.setdefault("batch_stats", {}), ("visual_encoder", "rmv", name),
                 a.reshape(-1) if name != "count" else a.reshape(()))
            continue
        path, kind = _vo_param_path(key)
        _set(out["params"], path, _KIND_INV[kind](a))
    return out


def stacked_vo_variables(trees: List[Mapping[str, Any]]) -> Dict:
    """Per-expert trees -> one tree with a leading expert axis."""

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([np.asarray(n) for n in nodes])

    return stack(trees)


def vo_state_dicts_from_stacked(stacked: Mapping[str, Any]) -> List[Dict[str, torch.Tensor]]:
    """The JAX training engine's stacked expert variables (leading expert
    axis, ``batch_stats`` with ``count``) -> one state dict per expert."""
    n = len(next(iter(_flatten(stacked["params"])))[1])
    return [vo_state_dict_from_jax(v) for v in split_expert_variables(stacked, n)]


def policy_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``PointNavActorCritic`` variables (the depth policy, which has no
    whitening statistics) -> state dict of
    :class:`models.policy.PointNavActorCritic`."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(variables.get("params", {})):
        head, leaf = path[0], path[-1]
        if head == "prev_action_embedding":
            key, val = "net.prev_action_embedding.weight", v
        elif head == "tgt_embeding":
            key, val = _linear("net.tgt_embeding", leaf, v)
        elif head == "visual_encoder":
            key, val = _encoder_entry(path[1:], v, "net.visual_encoder.")
        elif head == "visual_fc":  # Sequential(Flatten, Linear, ReLU)
            key, val = _linear("net.visual_fc.1", leaf, v)
        elif head == "state_encoder":  # w_ih_l0 -> rnn.weight_ih_l0
            nm = path[1].replace("w_", "weight_").replace("b_", "bias_")
            key, val = f"net.state_encoder.rnn.{nm}", v
        elif head == "action_head":
            key, val = _linear("action_distribution.linear", leaf, v)
        elif head == "critic":
            key, val = _linear("critic.fc", leaf, v)
        else:
            raise KeyError(f"unrecognized policy param: {'.'.join(path)}")
        sd[key] = val
    return _to_torch(sd)


# torch module prefix of each dense layer of the policy -> flax name
_POLICY_DENSE = {"net.tgt_embeding.": "tgt_embeding", "net.visual_fc.1.": "visual_fc",
                 "action_distribution.linear.": "action_head", "critic.fc.": "critic"}


def _policy_param_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """Torch parameter key of :class:`models.policy.PointNavActorCritic` ->
    (flax path under ``params``, kind)."""
    leaf = key.rsplit(".", 1)[-1]
    if key == "net.prev_action_embedding.weight":
        return ("prev_action_embedding", "embedding"), "plain"
    if key.startswith("net.visual_encoder."):
        path, kind = _encoder_path(key[len("net.visual_encoder."):])
        return ("visual_encoder",) + path, kind
    if key.startswith("net.state_encoder.rnn."):  # rnn.weight_ih_l0 -> w_ih_l0
        name = leaf.replace("weight_", "w_").replace("bias_", "b_")
        return ("state_encoder", name), "plain"
    for prefix, name in _POLICY_DENSE.items():
        if key.startswith(prefix):
            return _dense_path(name, leaf)
    raise KeyError(f"unrecognized policy key: {key}")


def policy_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """State dict (or ``{name: grad}``) of
    :class:`models.policy.PointNavActorCritic` -> flax ``{"params": ...}``
    of numpy arrays: the inverse of :func:`policy_state_dict_from_jax`."""
    out: Dict[str, Dict] = {"params": {}}
    for key, v in sd.items():
        path, kind = _policy_param_path(key)
        _set(out["params"], path, _KIND_INV[kind](v.detach().cpu().numpy().astype(np.float32)))
    return out


def split_expert_variables(stacked: Mapping[str, Any], n_experts: int = 3) -> List[Dict]:
    """Slice a stacked ``[n_experts, ...]`` expert tree into one tree each."""

    def take(tree, i):
        return {k: (take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
                for k, v in tree.items()}

    return [take(stacked, i) for i in range(n_experts)]


def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` (a CPU generator; build the
    module on the CPU, then move it): fan-in-scaled normal convs and linears,
    unit GroupNorm, identity whitening, torch's uniform range for the LSTM."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(m.weight.shape[1:])
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, nn.LSTM):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, RunningMeanAndVar):
                m._mean.zero_()
                m._var.fill_(1.0)
    return module
