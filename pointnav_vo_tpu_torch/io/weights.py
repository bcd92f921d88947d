"""Carry weights across: flax variable trees (nested dicts of numpy arrays)
-> state dicts of the port's modules, with the reference's key names, and
back for the VO expert and the policy.

The port's own copy of the key mapping of ``io/torch_export.py``: conv
HWIO -> OIHW, dense ``(in, out)`` -> ``(out, in)``, GroupNorm ``scale`` ->
``weight``, RunningMeanAndVar ``(C,)`` stats -> ``(1, C, 1, 1)`` buffers;
the LSTM and GRU matrices are stored in torch's layout already and pass
through.
It covers every backbone (a bottleneck's ``conv3``/``gn3`` at ``convs.6``
and ``convs.7``, the SE gate's ``fc1``/``fc2`` at ``se.excite.0`` and
``se.excite.2``; a grouped kernel ``[kh, kw, I/g, O]`` takes the same
transpose to torch's ``[O, I/g, kh, kw]``) and the act-embed model
(``action_embedding``, ``hidden_generator.1``).  For the policies it
carries the rgb policies' whitening buffers (``batch_stats/visual_encoder/
rmv`` <-> ``net.visual_encoder.running_mean_and_var._mean/_var/_count``)
and defines the SimpleCNN baseline's keys, which the JAX package's ``.pth``
exporter lacks: ``visual_encoder/conv{1,2,3}`` and ``fc`` <->
``net.visual_encoder.cnn.{0,2,4,6}``, the reference SimpleCNN's
``Sequential`` layout.

:func:`vo_state_dicts_from_stacked` reads the JAX training engine's stacked
expert tree (a leading expert axis); :func:`vo_variables_from_state_dict`,
:func:`stacked_vo_variables` and :func:`policy_variables_from_state_dict`
go the other way.  A gradient tree has the parameters' structure, so
``{name: p.grad}`` maps back the same way.

:func:`load_vo_checkpoint` and :func:`load_policy_checkpoint` read the
reference's ``.pth`` containers (and the port's own RL checkpoints, which
use the same one): the port's modules carry the reference's key names, so
loading is unwrapping the container and stripping the ``actor_critic.``
prefix, then ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar

POLICY_PREFIX = "actor_critic."


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

# position inside a block's ``convs`` Sequential (conv, gn, relu triplets;
# a bottleneck has a third conv and GroupNorm)
_CONVS_IDX = {"conv1": "0", "gn1": "1", "conv2": "3", "gn2": "4", "conv3": "6", "gn3": "7"}
# position inside an SE gate's ``excite`` Sequential (Linear, ReLU, Linear)
_SE_IDX = {"fc1": "0", "fc2": "2"}
# position inside the SimpleCNN baseline's ``cnn`` Sequential (conv, ReLU,
# conv, ReLU, conv, Flatten, Linear, ReLU)
_SIMPLE_CNN_IDX = {"conv1": "0", "conv2": "2", "conv3": "4", "fc": "6"}
_RMV_NAMES = {"_mean": "mean", "_var": "var", "_count": "count"}


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
    if sub == "se":
        kind = "dense" if leaf == "kernel" else "plain"
        return f"{base}.se.excite.{_SE_IDX[path[2]]}.{_wb(leaf)}", kind
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


def _simple_cnn_entry(rest: Tuple[str, ...], v: np.ndarray) -> Tuple[str, np.ndarray]:
    """The baseline's ``visual_encoder/<conv1|conv2|conv3|fc>/<leaf>``."""
    name, leaf = rest[0], rest[-1]
    key = f"net.visual_encoder.cnn.{_SIMPLE_CNN_IDX[name]}.{_wb(leaf)}"
    if leaf != "kernel":
        return key, v
    return key, (_dense(v) if name == "fc" else _conv(v))


def _set_rmv(out: Dict, name: str, a: np.ndarray) -> None:
    """A whitening buffer (``_mean``, ``_var`` or ``_count``) into
    ``batch_stats/visual_encoder/rmv``."""
    name = _RMV_NAMES[name]
    _set(out.setdefault("batch_stats", {}), ("visual_encoder", "rmv", name),
         a.reshape(-1) if name != "count" else a.reshape(()))


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def vo_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VOCNN`` or ``VOCNNActEmbed`` variables -> state dict of
    :class:`models.vo_cnn.VOCNN` or :class:`models.vo_cnn.VOCNNActEmbed`."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(variables.get("params", {})):
        head, leaf = path[0], path[-1]
        if head == "visual_encoder":
            key, val = _encoder_entry(path[1:], v, "visual_encoder.")
        elif head == "visual_fc":  # Sequential(Flatten, Dropout, Linear, ReLU)
            key, val = _linear("visual_fc.2", leaf, v)
        elif head == "hidden_generator":  # Sequential(Dropout, Linear, ReLU)
            key, val = _linear("hidden_generator.1", leaf, v)
        elif head == "output_head":  # Sequential(Dropout, Linear)
            key, val = _linear("output_head.1", leaf, v)
        elif head == "action_embedding":
            key, val = "action_embedding.weight", v
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
    if parts[2] == "se":  # se.excite.<i>.weight
        fc = {v: k for k, v in _SE_IDX.items()}[parts[4]]
        return (block, "se", fc, "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "plain")
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
    """Torch parameter key of :class:`models.vo_cnn.VOCNN` or
    :class:`models.vo_cnn.VOCNNActEmbed` -> (flax path under ``params``,
    kind)."""
    leaf = key.rsplit(".", 1)[-1]
    if key.startswith("visual_encoder."):
        path, kind = _encoder_path(key[len("visual_encoder."):])
        return ("visual_encoder",) + path, kind
    if key.startswith("visual_fc.2."):
        return _dense_path("visual_fc", leaf)
    if key.startswith("hidden_generator.1."):
        return _dense_path("hidden_generator", leaf)
    if key.startswith("output_head.1."):
        return _dense_path("output_head", leaf)
    if key == "action_embedding.weight":
        return ("action_embedding", "embedding"), "plain"
    raise KeyError(f"unrecognized VO key: {key}")


_KIND_INV = {"conv": lambda w: np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
             "dense": np.transpose, "plain": lambda v: v}


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def vo_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """State dict (or ``{name: grad}``) of either VO model ->
    flax ``{"params": ..., "batch_stats": ...}`` of numpy arrays (no
    ``batch_stats`` when ``sd`` holds no whitening buffers)."""
    out: Dict[str, Dict] = {"params": {}}
    rmv = "visual_encoder.running_mean_and_var."
    for key, v in sd.items():
        a = v.detach().cpu().numpy().astype(np.float32)
        if key.startswith(rmv):
            _set_rmv(out, key[len(rmv):], a)
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
    """Flax ``PointNavActorCritic`` or ``PointNavBaselineActorCritic``
    variables (with the rgb policies' ``batch_stats`` where present) ->
    state dict of the port's module of the same name."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(variables.get("params", {})):
        head, leaf = path[0], path[-1]
        if head == "prev_action_embedding":
            key, val = "net.prev_action_embedding.weight", v
        elif head == "tgt_embeding":
            key, val = _linear("net.tgt_embeding", leaf, v)
        elif head == "visual_encoder" and path[1] in _SIMPLE_CNN_IDX:
            key, val = _simple_cnn_entry(path[1:], v)
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
    if variables.get("batch_stats"):
        sd.update(_rmv_entries(variables["batch_stats"], "net.visual_encoder."))
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
    if key.startswith("net.visual_encoder.cnn."):  # the baseline's SimpleCNN
        idx = key.split(".")[3]
        name = {v: k for k, v in _SIMPLE_CNN_IDX.items()}[idx]
        if leaf == "bias":
            return ("visual_encoder", name, "bias"), "plain"
        return ("visual_encoder", name, "kernel"), "dense" if name == "fc" else "conv"
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
    """State dict (or ``{name: grad}``) of either policy -> flax
    ``{"params": ...}`` (and ``batch_stats`` where ``sd`` holds whitening
    buffers) of numpy arrays: the inverse of
    :func:`policy_state_dict_from_jax`."""
    out: Dict[str, Dict] = {"params": {}}
    rmv = "net.visual_encoder.running_mean_and_var."
    for key, v in sd.items():
        a = v.detach().cpu().numpy().astype(np.float32)
        if key.startswith(rmv):
            _set_rmv(out, key[len(rmv):], a)
            continue
        path, kind = _policy_param_path(key)
        _set(out["params"], path, _KIND_INV[kind](a))
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
    unit GroupNorm, identity whitening, torch's uniform range for the LSTM
    and the GRU."""
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
            elif isinstance(m, (nn.LSTM, nn.GRU)):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, RunningMeanAndVar):
                m._mean.zero_()
                m._var.fill_(1.0)
    return module


def vo_state_dict_from_container(ckpt: Mapping[str, Any],
                                 act_idx: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One VO expert's state dict out of a reference VO checkpoint:
    ``{"model_states": {act_idx: sd}}`` (per action), ``{"model_state":
    sd}`` or a bare state dict; or out of the port's own VO training
    checkpoint (``experts`` in its ``action_type`` order)."""
    if "model_state" in ckpt:
        sd = ckpt["model_state"]
    elif "model_states" in ckpt:
        if act_idx is None:
            raise ValueError("a per-action VO checkpoint needs act_idx")
        sd = ckpt["model_states"][act_idx]
    elif "experts" in ckpt:
        acts = ckpt["train_config"]["action_type"]
        acts = list(acts) if isinstance(acts, (list, tuple)) else [acts]
        if act_idx is None and len(acts) == 1:
            act_idx = acts[0]
        if act_idx not in acts:
            raise ValueError(f"the checkpoint's experts are for actions {acts}, "
                             f"not act_idx {act_idx}")
        sd = ckpt["experts"][acts.index(act_idx)]
    else:
        sd = ckpt
    return dict(sd)


def load_vo_checkpoint(path: str, act_idx: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The state dict of a VO model (any backbone, or the act-embed
    model) in a reference VO
    ``.pth`` (see :func:`vo_state_dict_from_container`)."""
    return vo_state_dict_from_container(load_checkpoint(path), act_idx)


def policy_state_dict_from_container(ckpt: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The actor-critic's state dict out of an RL checkpoint: the
    ``state_dict`` entry (or a bare state dict), ``actor_critic.`` prefix
    stripped where present."""
    sd = ckpt.get("state_dict", ckpt)
    return {(k[len(POLICY_PREFIX):] if k.startswith(POLICY_PREFIX) else k): v
            for k, v in sd.items()}


def load_policy_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of either policy in a reference RL ``.pth`` or one of
    the port's RL checkpoints."""
    return policy_state_dict_from_container(load_checkpoint(path))
