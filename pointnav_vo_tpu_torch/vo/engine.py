"""VO supervised training and eval engine (counterpart of ``vo/engine.py``).

One :class:`~pointnav_vo_tpu_torch.models.vo_cnn.VOCNN` expert per trained
action: the forward stage trains one (``action_type: 1``), the joint turn
stage two (``action_type: [2, 3]``) tied by the geometric-invariance
inverse loss (``geo_invariance_types: ["inverse_joint_train"]``).
``action_type: -1`` trains one unified expert that owns every row: the
act-embed model (``VOCNNActEmbed``, which reads each row's action id) or a
plain ``VOCNN``.  Each train step, on the device:

1. frame features of every frame in the batch, once each (depth
   discretisation and the top-down projection through ``bin_counts``; a
   twin-packed joint batch ships each entry's frames once and expands them
   into (primary, swapped) sample pairs);
2. each expert runs only its own rows (``index_select``, forward, an
   out-of-place ``index_copy``), its whitening statistics updated from
   those rows; GroupNorm is per sample, so this equals the JAX package's
   all-experts forward with per-expert masks;
3. the regression loss per (expert action, data type) group, the joint
   inverse loss over adjacent twins (a malformed pair is masked out and
   counted), and the same inverse loss on the ground-truth deltas as a
   check (``debug_geo/*``, about 0);
4. one Adam step over the parameters of all experts (AdamW when
   ``weight_decay > 0``): the same elementwise update as optax.

An expert with no rows in a batch still takes its Adam step (its momentum
moves it), as in JAX: the gradients are zeroed, never set to None.

Diagnostics: ``log_grad`` adds ``grad/global_norm`` and one
``grad/{top}_norm`` for each top-level module (the JAX parameter tree's top
names, every expert together) to each step's metrics, taken after the
group's all-reduce; :meth:`VORegressionEngine.grad_snapshot` is the
per-parameter gradient of one fixed batch, for histograms.  ``debug``
raises ``FloatingPointError`` on a non-finite loss, metric or gradient
before the update, and runs the backward under
``torch.autograd.detect_anomaly`` (in one process: in a group the check
after the all-reduce makes every rank raise together), scoped to the step.

Data-parallel over a ``parallel.dist.Group`` (the JAX engine's mesh):
``batch_size`` stays the batch of a host, whose ranks each train on their
contiguous block of it (a twin-packed batch whose entries do not split
evenly is unpacked first), with buckets local to the block, dropout masks
from the rank's own generator, the whitening statistics summed over the
ranks and the gradients and metrics averaged over them.  ``evaluate``
stays unsharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import (
    CUR_REL_TO_PREV,
    PREV_REL_TO_CUR,
    TURN_LEFT,
    TURN_RIGHT,
    resolve_device,
)
from pointnav_vo_tpu_torch.io.checkpoint import (
    AsyncCheckpointWriter,
    generator_states,
    load_checkpoint,
    restore_generators,
    rng_state_bundle,
    save_checkpoint,
)
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models.running_mean_var import set_stats_group
from pointnav_vo_tpu_torch.models.vo_cnn import VOCNN, VOCNNActEmbed
from pointnav_vo_tpu_torch.parallel.dist import rank_seed, shard_slice
from pointnav_vo_tpu_torch.vo import losses as losses_lib
from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch, PrefetchingLoader, unpack_twins
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOInferenceConfig,
    check_compute_dtype,
    preprocess_obs_pairs,
    preprocess_obs_pairs_packed,
    preprocess_obs_pairs_twins_packed,
)


@dataclasses.dataclass(frozen=True)
class VOTrainConfig:
    """VO.TRAIN and VO.GEOMETRY of ``configs/vo/vo_pointnav.yaml``."""

    lr: float = 2.5e-4
    eps: float = 1e-8
    weight_decay: float = 0.0
    batch_size: int = 128
    epochs: int = 150
    loss_weight_fixed: bool = True
    loss_weight_multiplier: Tuple[Tuple[str, float], ...] = (
        ("dx", 1.0), ("dz", 1.0), ("dyaw", 1.0))
    action_type: Any = 1  # -1 | 1 | 2 | 3 | (2, 3)
    geo_invariance_types: Tuple[str, ...] = ()
    loss_inv_weight: float = 1.0
    log_interval: int = 10
    seed: int = 0
    debug: int = 0  # VO.debug: the NaN check
    log_grad: bool = False  # VO.TRAIN.log_grad: gradient norms and histograms

    def __post_init__(self):
        actions = self.expert_actions
        if self.joint:
            # the inverse loss pairs adjacent (primary, swapped) twins: every
            # sample needs a twin, and no pair may straddle two batches
            if self.batch_size % 2:
                raise ValueError("inverse_joint_train needs an even batch_size: "
                                 f"pairs must not straddle batches (got {self.batch_size})")
            if set(actions) != {TURN_LEFT, TURN_RIGHT}:
                raise ValueError("inverse_joint_train is defined for action_type [2, 3], "
                                 f"got {self.action_type!r}")

    @property
    def multiplier_dict(self) -> Dict[str, float]:
        return dict(self.loss_weight_multiplier)

    @property
    def joint(self) -> bool:
        return "inverse_joint_train" in self.geo_invariance_types

    @property
    def expert_actions(self) -> Tuple[int, ...]:
        if isinstance(self.action_type, (tuple, list)):
            if set(self.action_type) != {TURN_LEFT, TURN_RIGHT}:
                raise ValueError(f"a list action_type must be [2, 3], got {self.action_type!r}")
            return (TURN_LEFT, TURN_RIGHT)
        return (self.action_type,)


def batch_to_device(batch: FramePairBatch, device) -> Dict[str, torch.Tensor]:
    """A host batch as device tensors.  rgb ships as uint8 and depth in its
    stored dtype; the features upcast on the device (exactly).  A
    twin-packed batch ships its ``[B/2]`` entry pixels as ``entry_*``."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {
        "actions": t(batch.actions.astype(np.int64)),
        "gt_delta": t(batch.gt_delta.astype(np.float32)),
        "data_types": t(batch.data_types.astype(np.int64)),
        "dz_mask": t(batch.dz_regress_mask.astype(np.float32)),
        "valid": torch.ones(batch.actions.shape[0], device=device),
    }
    prefix = "entry_" if batch.twins_packed else ""
    for k in ("prev_rgb", "cur_rgb", "prev_depth", "cur_depth"):
        out[prefix + k] = t(getattr(batch, k))
    return out


_PIXELS = ("prev_rgb", "cur_rgb", "prev_depth", "cur_depth")


def shard_frame_pairs(batch: FramePairBatch, rank: int, world: int) -> FramePairBatch:
    """Rank ``rank``'s contiguous block of a host batch (``P(DATA_AXIS)``
    on every array): samples ``[r B/W, (r+1) B/W)``, and of a twin-packed
    batch the entries that expand into them, unpacked first where the
    entries do not split evenly over the ranks."""
    b = batch.actions.shape[0]
    if batch.twins_packed and (b // 2) % world:
        batch = unpack_twins(batch)
    rows = shard_slice(b, rank, world)
    entries = shard_slice(b // 2, rank, world) if batch.twins_packed else rows
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[entries if f.name in _PIXELS else rows]
        for f in dataclasses.fields(batch) if f.name != "twins_packed"})


def obs_pairs_from_batch(arrs: Mapping[str, torch.Tensor],
                         icfg: VOInferenceConfig) -> torch.Tensor:
    """The packed stem input ``[B, H, W, 2C]`` of a device batch: the
    twin expansion for an ``entry_*`` batch, plain pairs otherwise."""
    if "entry_prev_rgb" in arrs:
        return preprocess_obs_pairs_twins_packed(
            arrs["entry_prev_rgb"], arrs["entry_prev_depth"],
            arrs["entry_cur_rgb"], arrs["entry_cur_depth"], icfg)
    return preprocess_obs_pairs_packed(arrs["prev_rgb"], arrs["prev_depth"],
                                       arrs["cur_rgb"], arrs["cur_depth"], icfg)


def pad_batch(arrs: Mapping[str, torch.Tensor], target: int) -> Dict[str, torch.Tensor]:
    """Zero-pad a short (final) batch to ``target`` rows; ``valid`` masks
    the pads.  Twin-packed ``entry_*`` arrays carry ``target // 2`` rows."""
    b = arrs["actions"].shape[0]
    if b == target:
        return dict(arrs)
    out = {}
    for k, v in arrs.items():
        rows = (target // 2 if k.startswith("entry_") else target) - v.shape[0]
        out[k] = torch.cat([v, v.new_zeros((rows,) + tuple(v.shape[1:]))])
    out["valid"][b:] = 0.0
    return out


def attach_expert_buckets(arrs: Mapping[str, torch.Tensor], actions_np,
                          expert_actions: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Per expert j, ``bucket_idx_j`` (the rows it runs) and ``bucket_own_j``
    (1.0 where the row's action is the expert's: those rows feed its
    whitening statistics).  A row runs the first expert whose action it
    has, the first expert where it has none; a unified expert (action -1)
    owns every row.  In the joint stage each expert gets exactly its B/2
    twins."""
    acts = np.asarray(actions_np).astype(np.int64).reshape(-1)
    ea = np.asarray(expert_actions, np.int64)
    match = (acts[:, None] == ea[None, :]) | (ea[None, :] == -1)
    owner = np.argmax(match, axis=1)
    dev = arrs["actions"].device
    out = dict(arrs)
    for j in range(len(ea)):
        rows = np.flatnonzero(owner == j)
        out[f"bucket_idx_{j}"] = torch.from_numpy(rows).to(dev)
        out[f"bucket_own_{j}"] = torch.from_numpy(match[rows, j].astype(np.float32)).to(dev)
    return out


def apply_vo_model(model, obs: torch.Tensor, actions: torch.Tensor, **kw) -> torch.Tensor:
    """``model``'s forward on packed pairs: the act-embed model also
    takes the rows' action ids."""
    if isinstance(model, VOCNNActEmbed):
        return model(obs, actions, **kw)
    return model(obs, **kw)


def forward_experts(experts: Sequence[VOCNN], obs: torch.Tensor,
                    arrs: Mapping[str, torch.Tensor], update_stats: bool,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each expert on its own rows (see :func:`attach_expert_buckets`);
    returns the deltas ``[B, 3]`` in the experts' dtype.  With ``update_stats`` each expert's
    whitening statistics take its owned valid rows; an expert with no rows
    merges an empty batch, as the JAX package's masked forward does.
    Dropout is on where ``generator`` is given."""
    out = obs.new_zeros((obs.shape[0], 3), dtype=experts[0].output_head[1].weight.dtype)
    for j, expert in enumerate(experts):
        idx = arrs[f"bucket_idx_{j}"]
        own = arrs[f"bucket_own_{j}"] * arrs["valid"].index_select(0, idx)
        if idx.numel() == 0:
            if update_stats:
                rmv = expert.visual_encoder.running_mean_and_var
                rmv(obs.new_zeros((0, obs.shape[-1], 1, 1)), True, own)
            continue
        pred = apply_vo_model(expert, obs.index_select(0, idx),
                              arrs["actions"].index_select(0, idx),
                              update_stats=update_stats, stats_mask=own, generator=generator)
        out = out.index_copy(0, idx, pred.to(out.dtype))
    return out


def vo_loss(preds: torch.Tensor, arrs: Mapping[str, torch.Tensor],
            tcfg: VOTrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training objective of a batch's predictions: (total, metrics)."""
    actions, gt, valid = arrs["actions"], arrs["gt_delta"], arrs["valid"]
    data_types = arrs["data_types"]
    weights = losses_lib.compute_loss_weights(actions, gt, tcfg.multiplier_dict,
                                              tcfg.loss_weight_fixed)
    metrics: Dict[str, torch.Tensor] = {}
    total = preds.new_zeros(())
    # the reference sums the group means of each (expert action, data type)
    dts = ((CUR_REL_TO_PREV, PREV_REL_TO_CUR) if tcfg.geo_invariance_types
           else (CUR_REL_TO_PREV,))
    for act in tcfg.expert_actions:
        for dt in dts:
            g_mask = valid * (data_types == dt)
            if act != -1:
                g_mask = g_mask * (actions == act)
            loss_g, diag = losses_lib.weighted_mse_with_diagnostics(
                preds, gt, weights, arrs["dz_mask"], g_mask)
            total = total + torch.where(g_mask.sum() > 0, loss_g, 0.0)
            metrics[f"abs_diff/act{act}_dt{dt}"] = diag["abs_diff"]
            metrics[f"relative_diff/act{act}_dt{dt}"] = diag["relative_diff"]

    if tcfg.joint:
        pair_act = actions.reshape(-1, 2)[:, 0]
        # only adjacent (primary, swapped) rows pair up: a malformed pair is
        # masked out of the loss and counted
        dt = data_types.reshape(-1, 2)
        pair_ok = ((dt[:, 0] == CUR_REL_TO_PREV) & (dt[:, 1] == PREV_REL_TO_CUR)).float()
        v2 = valid.reshape(-1, 2)
        pair_valid = v2[:, 0] * v2[:, 1] * pair_ok
        metrics["geo/malformed_pairs"] = ((1.0 - pair_ok) * v2[:, 0]).sum()
        pair_pred = preds.reshape(-1, 2, 3)
        geo_loss, abs_rot, abs_pos = losses_lib.geo_invariance_inverse_loss(
            pair_pred[:, 0], pair_pred[:, 1], pair_act, pair_valid)
        total = total + tcfg.loss_inv_weight * geo_loss
        metrics["geo/abs_diff_rot"] = abs_rot
        metrics["geo/abs_diff_pos"] = abs_pos
        # the reference's train_debug check: the ground truth is invariant
        pair_gt = gt.reshape(-1, 2, 3)
        _, dbg_rot, dbg_pos = losses_lib.geo_invariance_inverse_loss(
            pair_gt[:, 0], pair_gt[:, 1], pair_act, pair_valid)
        metrics["debug_geo/abs_diff_rot"] = dbg_rot
        metrics["debug_geo/abs_diff_pos"] = dbg_pos

    metrics["total_loss"] = total.detach()
    return total, {k: v.detach() for k, v in metrics.items()}


def grad_norms(experts: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """``grad/global_norm`` and ``grad/{top}_norm`` of the experts'
    ``.grad``: each top-level module's norm over every expert together, as
    the JAX engine's stacked tree gives it.  The port's top-level module
    names are the JAX tree's (``visual_encoder``, ``visual_fc``,
    ``output_head``, and the act-embed model's ``action_embedding`` and
    ``hidden_generator``)."""
    sq: Dict[str, List[torch.Tensor]] = {}
    for m in experts:
        for name, p in m.named_parameters():
            sq.setdefault(name.split(".", 1)[0], []).append(p.grad.pow(2).sum())
    tops = {top: torch.stack(v).sum() for top, v in sq.items()}
    out = {f"grad/{top}_norm": v.sqrt() for top, v in tops.items()}
    out["grad/global_norm"] = torch.stack(list(tops.values())).sum().sqrt()
    return out


def _raise_if_nonfinite(what: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """``FloatingPointError`` naming the non-finite entries (one host read)."""
    flat = torch.cat([v.detach().reshape(-1).float() for v in tensors.values()])
    if not bool(torch.isfinite(flat).all()):
        bad = sorted(k for k, v in tensors.items() if not bool(torch.isfinite(v).all()))
        raise FloatingPointError(f"VO.debug: non-finite {what} in the train step: {bad}")


@contextlib.contextmanager
def _anomaly_mode():
    """``torch.autograd.detect_anomaly`` for one backward, without its
    warning that the mode is on."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Anomaly Detection has been enabled")
        with torch.autograd.detect_anomaly():
            yield


class VORegressionEngine:
    """Train/eval engine.  ``device=None`` means the card.  Pass ``experts``
    (modules) or ``state_dicts`` (one per trained action, in
    ``tcfg.expert_actions`` order), or neither for weights drawn from
    ``tcfg.seed``.  The experts compute in ``icfg``'s precision; their
    parameters, gradients and Adam state stay in the parameters' dtype.
    ``group`` (a ``parallel.dist.Group``) makes it one rank of a
    data-parallel run: rank 0's weights are broadcast at the start."""

    def __init__(self, icfg: VOInferenceConfig, tcfg: VOTrainConfig,
                 train_reader=None, eval_reader=None, device=None,
                 experts: Optional[Sequence[VOCNN]] = None,
                 state_dicts: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
                 group=None):
        self.group = group
        if group is not None:
            # the inverse loss pairs adjacent rows: no pair may straddle two ranks
            rows = (2 if tcfg.joint else 1) * group.local_world
            if tcfg.batch_size % rows:
                raise ValueError(f"batch_size {tcfg.batch_size} does not split into "
                                 f"{group.local_world} equal blocks of whole pairs")
        self.icfg = icfg
        self.tcfg = tcfg
        self.train_reader = train_reader
        self.eval_reader = eval_reader
        self.device = resolve_device(device)
        n_experts = len(tcfg.expert_actions)
        if experts is None:
            g = torch.Generator().manual_seed(tcfg.seed)
            experts = [seeded_init_(icfg.make_model(), g) for _ in range(n_experts)]
            if state_dicts is not None:
                if len(state_dicts) != n_experts:
                    raise ValueError(f"need {n_experts} state dicts, got {len(state_dicts)}")
                for m, sd in zip(experts, state_dicts):
                    m.load_state_dict(sd, strict=True)
        if len(experts) != n_experts:
            raise ValueError(f"need {n_experts} experts for action_type "
                             f"{tcfg.action_type!r}, got {len(experts)}")
        check_compute_dtype(experts, icfg)
        self.experts: List[VOCNN] = [m.to(self.device) for m in experts]
        for m in self.experts:
            if group is not None:
                group.broadcast_module(m)
            set_stats_group(m, group)
        params = [p for m in self.experts for p in m.parameters()]
        for p in params:  # zero, never None: every expert steps every time
            p.grad = torch.zeros_like(p)
        if tcfg.weight_decay > 0:
            self.opt = torch.optim.AdamW(params, lr=tcfg.lr, eps=tcfg.eps,
                                         weight_decay=tcfg.weight_decay)
        else:
            self.opt = torch.optim.Adam(params, lr=tcfg.lr, eps=tcfg.eps)
        # the dropout masks' generator, on the device
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(tcfg.seed, group))
        self.epoch = 0
        self._snap_batch: Optional[FramePairBatch] = None

    def _to_device(self, batch: FramePairBatch, pad_to: Optional[int] = None):
        arrs = batch_to_device(batch, self.device)
        actions = batch.actions
        if pad_to is not None:
            arrs = pad_batch(arrs, pad_to)
            actions = np.pad(actions, (0, pad_to - actions.shape[0]))
        return attach_expert_buckets(arrs, actions, self.tcfg.expert_actions)

    def train_step(self, batch: FramePairBatch) -> Dict[str, torch.Tensor]:
        """One update on a host batch (the whole host's batch in a group:
        the rank trains on its block); the metrics stay on the device.  The
        step's gradients stay in the parameters' ``.grad`` until the next.
        Under ``debug`` a raise leaves the whitening statistics as they
        were, as the JAX engine's functional step leaves its variables."""
        if self.group is not None:
            batch = shard_frame_pairs(batch, self.group.local_rank, self.group.local_world)
        arrs = self._to_device(batch)
        self.opt.zero_grad(set_to_none=False)
        if not self.tcfg.debug:
            metrics = self._gradients(arrs)
        else:
            buffers = [b for m in self.experts for b in m.buffers()]
            saved = [b.clone() for b in buffers]
            try:
                metrics = self._gradients(arrs)
            except (FloatingPointError, RuntimeError):
                with torch.no_grad():
                    for b, v in zip(buffers, saved):
                        b.copy_(v)
                raise
        self.opt.step()
        return metrics

    def _gradients(self, arrs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step up to the update: forward (the whitening statistics
        merge the batch), loss, backward and the group's all-reduce, with
        the diagnostics; returns the metrics."""
        obs = obs_pairs_from_batch(arrs, self.icfg)
        gen = self.generator if self.icfg.dropout_p > 0 else None
        preds = forward_experts(self.experts, obs, arrs, True, gen)
        total, metrics = vo_loss(preds, arrs, self.tcfg)
        debug = bool(self.tcfg.debug)
        if debug and self.group is None:
            # before the backward, as jax_debug_nans stops at the forward's NaN
            _raise_if_nonfinite("loss or metrics", metrics)
            with _anomaly_mode():
                total.backward()
        else:
            total.backward()
        if self.group is not None:
            params = [p for m in self.experts for p in m.parameters()]
            self.group.all_reduce_([p.grad for p in params], "mean")
            self.group.all_reduce_(list(metrics.values()), "mean")
        if self.tcfg.log_grad or debug:
            norms = grad_norms(self.experts)
            if debug:  # after the all-reduce: every rank of a group raises together
                _raise_if_nonfinite("loss, metrics or gradients", {**metrics, **norms})
            if self.tcfg.log_grad:
                metrics.update(norms)
        return metrics

    def train_epoch(self) -> Dict[str, float]:
        if self.train_reader is None:
            raise ValueError("train_epoch needs a train_reader")
        rng_np = np.random.default_rng(self.tcfg.seed * 1000 + self.epoch)
        agg: Dict[str, float] = {}
        n_batches = n_samples = 0
        t0 = time.perf_counter()
        loader = PrefetchingLoader(lambda: self.train_reader.iter_batches(
            self.tcfg.batch_size, rng=rng_np, drop_last=True))
        # the epoch loss sums on the device; the host reads metrics only
        # every log_interval steps, and the sum once at the end
        loss_acc = None
        for batch in loader:
            metrics = self.train_step(batch)
            n_batches += 1
            n_samples += batch.actions.shape[0]
            loss_acc = metrics["total_loss"] if loss_acc is None else loss_acc + metrics["total_loss"]
            if n_batches % self.tcfg.log_interval == 0:
                agg.update({k: float(v.float().mean()) for k, v in metrics.items()})
        agg["mean_total_loss"] = float(loss_acc) / n_batches if loss_acc is not None else 0.0
        agg["epoch_time_s"] = time.perf_counter() - t0
        agg["frame_pairs_per_s"] = n_samples / max(agg["epoch_time_s"], 1e-9)
        self.epoch += 1
        return agg

    @torch.no_grad()
    def eval_step(self, arrs: Mapping[str, torch.Tensor]):
        """(preds ``[B, 3]``, masked abs diffs ``[B, 3]``) of a device batch
        with buckets; the whitening statistics stay frozen."""
        preds = forward_experts(self.experts, obs_pairs_from_batch(arrs, self.icfg),
                                arrs, False)
        return preds, torch.abs(arrs["gt_delta"] - preds) * arrs["valid"][:, None]

    def evaluate(self, save_pred_path: Optional[str] = None) -> Dict[str, float]:
        if self.eval_reader is None:
            raise ValueError("evaluate needs an eval_reader")
        sums, mags, count = np.zeros(3), np.zeros(3), 0.0
        per_action: Dict[int, np.ndarray] = {}
        per_action_count: Dict[int, float] = {}
        dump = {"gt": [], "pred": [], "action": [], "chunk": [], "entry": []}
        for batch in self.eval_reader.iter_batches(self.tcfg.batch_size, rng=None):
            b = batch.actions.shape[0]
            preds, diffs = self.eval_step(self._to_device(batch, self.tcfg.batch_size))
            d = diffs[:b].cpu().numpy().astype(np.float64)
            sums += d.sum(0)
            mags += np.abs(batch.gt_delta).sum(0)
            count += b
            for act in np.unique(batch.actions):
                sel = batch.actions == act
                per_action[int(act)] = per_action.get(int(act), np.zeros(3)) + d[sel].sum(0)
                per_action_count[int(act)] = per_action_count.get(int(act), 0.0) + float(sel.sum())
            if save_pred_path:
                dump["gt"].append(batch.gt_delta)
                dump["pred"].append(preds[:b].cpu().numpy())
                dump["action"].append(batch.actions)
                dump["chunk"].append(batch.chunk_idx)
                dump["entry"].append(batch.entry_idx)

        out = {}
        for i, name in enumerate(("dx", "dz", "dyaw")):
            out[f"abs_diff_{name}"] = sums[i] / max(count, 1)
            out[f"target_{name}_magnitude"] = mags[i] / max(count, 1)
            out[f"relative_diff_{name}"] = sums[i] / max(mags[i], 1e-8)
        for act, v in per_action.items():
            for i, name in enumerate(("dx", "dz", "dyaw")):
                out[f"act{act}/abs_diff_{name}"] = v[i] / max(per_action_count[act], 1)
        out["eval_samples"] = count
        # a silently short epoch is a data bug, not a rounding detail
        expected = self.eval_reader.num_samples()
        if count != expected:
            raise RuntimeError(f"VO eval consumed {int(count)} samples but the dataset "
                               f"yields {expected}: reader/loader mismatch")
        if save_pred_path:
            with open(save_pred_path, "wb") as f:
                pickle.dump({k: np.concatenate(v) if v else np.zeros(0)
                             for k, v in dump.items()}, f)
        return out

    def checkpoint_state(self) -> Dict:
        """Resumable state: the experts, the optimizer, the dropout
        generator (every rank's in a group: every rank calls this), the
        epoch, both configs and the host RNG states."""
        return {
            "epoch": self.epoch,
            "train_config": dataclasses.asdict(self.tcfg),
            "inference_config": dataclasses.asdict(self.icfg),
            "experts": [m.state_dict() for m in self.experts],
            "optimizer": self.opt.state_dict(),
            **generator_states(self.generator, self.group),
            "host_rng": rng_state_bundle(),
        }

    def save_ckpt(self, path: str, extra: Optional[Mapping[str, Any]] = None,
                  writer: Optional[AsyncCheckpointWriter] = None) -> None:
        """:meth:`checkpoint_state` and ``extra`` (the run's metadata) in
        ``torch.save`` form, written atomically; through ``writer`` the
        write overlaps the next epoch's compute.  In a group every rank
        calls it and rank 0 writes."""
        state = {**self.checkpoint_state(), **(extra or {})}
        if self.group is not None and not self.group.is_main:
            return
        if writer is not None:
            writer.save(path, state)
        else:
            save_checkpoint(path, state)

    def load_experts(self, path: str) -> Dict:
        """The experts (weights and whitening statistics) of a checkpoint,
        as eval needs them: the optimizer and the generator stay as they
        are."""
        state = load_checkpoint(path)
        for m, sd in zip(self.experts, state["experts"], strict=True):
            m.load_state_dict(sd, strict=True)
        return state

    def load_ckpt(self, path: str) -> Dict:
        """Resume from :meth:`checkpoint_state` on any device type; a
        generator state saved on another type seeds the generator afresh
        from ``tcfg.seed`` (``io.checkpoint.restore_generators``: a rank of
        a group takes its own rank's state)."""
        state = self.load_experts(path)
        self.opt.load_state_dict(state["optimizer"])
        restore_generators(self.generator, state, self.tcfg.seed, self.group)
        self.epoch = state["epoch"]
        return state

    def _snapshot_batch(self) -> FramePairBatch:
        """One fixed train batch, the first of an epoch shuffled by
        ``default_rng(0)``: drawn once, held on the host, and shared by
        :meth:`grad_snapshot` and :meth:`obs_snapshot`."""
        if self._snap_batch is None:
            if self.train_reader is None:
                raise ValueError("the snapshots need a train_reader")
            with contextlib.closing(self.train_reader.iter_batches(
                    self.tcfg.batch_size, rng=np.random.default_rng(0), drop_last=True)) as it:
                self._snap_batch = next(it)
        return self._snap_batch

    def grad_snapshot(self) -> Dict[str, np.ndarray]:
        """The loss's gradient on the snapshot batch, with no update: one
        array a parameter name, stacked over the experts (the JAX engine's
        leading expert axis), for the gradient histograms.  The forward
        normalises as the train step does, with the batch merged into the
        whitening statistics, which are restored after; dropout draws from
        a generator seeded ``tcfg.seed``.  The parameters, ``.grad``, the
        optimizer, the statistics and the engine's generator stay as they
        are; in a group the statistics are not summed over the ranks (rank
        0 alone calls it)."""
        arrs = self._to_device(self._snapshot_batch())
        params = [p for m in self.experts for p in m.parameters()]
        buffers = [b for m in self.experts for b in m.buffers()]
        saved = [b.clone() for b in buffers]
        gen = (torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
               if self.icfg.dropout_p > 0 else None)
        for m in self.experts:
            set_stats_group(m, None)
        try:
            preds = forward_experts(self.experts, obs_pairs_from_batch(arrs, self.icfg), arrs,
                                    True, gen)
            total, _ = vo_loss(preds, arrs, self.tcfg)
            grads = torch.autograd.grad(total, params, allow_unused=True)
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)
            for m in self.experts:
                set_stats_group(m, self.group)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        names = [n for n, _ in self.experts[0].named_parameters()]
        return {name: torch.stack(grads[i::len(names)]).cpu().numpy()
                for i, name in enumerate(names)}

    def obs_snapshot(self) -> Dict[str, np.ndarray]:
        """The first train sample's pair channels (rgb ``[H, W, 6]`` in
        0-255, depth and top_down_view ``[H, W, 2]``, ...) of the snapshot
        batch, for the per-epoch TensorBoard image dumps."""
        batch = self._snapshot_batch()
        frames = [torch.from_numpy(np.ascontiguousarray(getattr(batch, k)[:1])).to(self.device)
                  for k in ("prev_rgb", "prev_depth", "cur_rgb", "cur_depth")]
        return {k: v[0].float().cpu().numpy() for k, v in
                preprocess_obs_pairs(*frames, self.icfg).items()}

    def train(self, ckpt_dir: Optional[str] = None, eval_every: int = 1,
              log_fn=None) -> list:
        history = []
        while self.epoch < self.tcfg.epochs:
            stats = self.train_epoch()
            if self.eval_reader is not None and self.epoch % eval_every == 0:
                stats.update({f"eval/{k}": v for k, v in self.evaluate().items()})
            if ckpt_dir:
                self.save_ckpt(os.path.join(ckpt_dir, f"ckpt_epoch_{self.epoch}.pt"))
            if log_fn:
                log_fn(self.epoch, stats)
            history.append(stats)
        return history
