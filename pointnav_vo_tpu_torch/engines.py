"""Config-driven engine adapters (counterpart of ``engines.py``): the
registry-visible trainer objects behind ``run.py``.

They bridge the yacs-style config trees (``config/defaults.py``) onto the
library (``vo/engine.py``, ``rl/trainer.py``, ``rl/eval.py``):

- ``vo_cnn_regression_geo_invariance_engine``: supervised VO training and
  eval with per-epoch checkpoints, resume, and the eval config read back
  out of the checkpoint;
- ``efficient_ddppo`` / ``ppo``: PPO training over the vector envs of
  ``ENV_BACKEND`` (scripted in process, the scripted shm farm, or habitat
  workers) with optional VO in the loop, checkpoints every
  ``CHECKPOINT_INTERVAL`` updates, resume, preemption, and the
  checkpoint-sweep eval driver with its videos and ranked images; the eval
  dead-reckons through the VO ensemble, or through the classical backend
  (``vo/classical.py``) with ``VO.VO_TYPE: CLASSICAL``, which training
  leaves out, as the JAX package's does.

Every engine runs on ``device`` (``None``: the card), or as one rank of a
data-parallel ``group`` (``parallel/dist.py``): the RL engines then step
the rank's block of the envs, the VO engine trains on the rank's block of
each batch from its host's shard of the train set, rank 0 alone writes
checkpoints, TensorBoard, info files and the log file, every rank loads a
resume checkpoint, and the preemption flag is agreed over the ranks, so
all of them stop at the same update.  RL checkpoints are
the reference's ``.pth`` container (``state_dict`` with the
``actor_critic.`` prefix) plus ``optimizer``, the generator's state and the
run's metadata (``full_config``, ``engine_name``, ``update``,
``count_steps``), so published ``.pth`` files and the port's own load
through one path.  A config option the port has not ported raises
``NotImplementedError`` naming its ROADMAP item; none runs without its
feature.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import ACT_NAME2IDX, resolve_device
from pointnav_vo_tpu_torch.io.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    rng_state_bundle,
)
from pointnav_vo_tpu_torch.io.weights import (
    load_vo_checkpoint,
    policy_state_dict_from_container,
    seeded_init_,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic, PointNavBaselineActorCritic
from pointnav_vo_tpu_torch.models.vo_cnn import VO_MODEL_NAMES, make_vo_model
from pointnav_vo_tpu_torch.parallel.dist import rank_seed, shard_slice
from pointnav_vo_tpu_torch.rl.envs import (
    env_config_from_task,
    make_habitat_vector_env,
    make_scripted_vector_env,
)
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.utils import preemption, registry
from pointnav_vo_tpu_torch.utils.config import Config
from pointnav_vo_tpu_torch.utils.logging import (
    TensorboardWriter,
    append_jsonl,
    get_logger,
    save_info_dict,
)
from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig


def _agreed_exit(group) -> bool:
    """The preemption flag, agreed over ``group``'s ranks where it is given,
    so all of them stop at the same update."""
    flag = preemption.should_exit()
    return flag if group is None else group.any(flag)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of an option the port does not have yet."""
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP.md, queue 1 item {item})")


# ---------------------------------------------------------------------------
# policies / envs registration
# ---------------------------------------------------------------------------


def _sensor_size(config: Config):
    depth = config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR
    return depth.HEIGHT, depth.WIDTH


@registry.register_policy(name="resnet_rnn_policy")
def make_resnet_rnn_policy(config: Config):
    """``RL.Policy``: the ``visual_types`` inputs (rgb policies whiten
    theirs), ``visual_backbone`` (any of ``resnet.BACKBONES``), and an
    ``rnn_backbone`` (LSTM or GRU) of ``num_recurrent_layers`` layers."""
    pol = config.RL.Policy
    return PointNavActorCritic(image_size=_sensor_size(config),
                               hidden_size=config.RL.PPO.hidden_size,
                               backbone=pol.visual_backbone,
                               num_recurrent_layers=pol.num_recurrent_layers,
                               vis_types=tuple(pol.visual_types), rnn_type=pol.rnn_backbone,
                               normalize_visual_inputs="rgb" in pol.visual_types)


@registry.register_policy(name="pointnav_baseline_policy")
def make_baseline_policy(config: Config):
    """The SimpleCNN + GRU baseline over rgb and depth."""
    return PointNavBaselineActorCritic(image_size=_sensor_size(config),
                                       hidden_size=config.RL.PPO.hidden_size)


@registry.register_env(name="NavRLEnv")
def make_nav_rl_env(config: Config, num_envs: int, seed: int = 0, noisy: bool = True,
                    group=None):
    """PointNav vector env configured from the task tree.  ``ENV_BACKEND``
    selects the fan-out: "sync" loops scripted envs in process, "shm"
    forks scripted process workers over the shared-memory rings, "habitat"
    forks habitat-sim workers.  In a ``group`` it builds the rank's
    contiguous block of the ``num_envs`` envs, env i seeded ``seed + i``
    as in one process; ``num_envs`` must split evenly over the ranks."""
    backend = config.get("ENV_BACKEND", "sync")
    block = slice(None)
    if group is not None:
        block = shard_slice(num_envs, group.rank, group.world)
    if backend == "habitat":
        return make_habitat_vector_env(config, num_envs, seed=seed, noisy=noisy, block=block)
    env_cfg = env_config_from_task(config, noisy=noisy, seed=seed)
    envs = range(num_envs)[block]
    if backend == "shm":
        from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv

        return ShmVectorEnv(env_cfg, len(envs), seed=seed + envs.start)
    if backend != "sync":
        raise ValueError(f"unknown ENV_BACKEND {backend!r} (sync | shm | habitat)")
    return make_scripted_vector_env(env_cfg, len(envs), seed=seed + envs.start)


# ---------------------------------------------------------------------------
# VO engine adapter
# ---------------------------------------------------------------------------


def vo_inference_config_from(config: Config, model_node: Config,
                             precision: str = "fp32") -> VOInferenceConfig:
    """The model node's inference config; its ``precision`` key, else
    ``precision`` ("fp32" or "bf16"), sets the compute dtype.  Any variant
    of ``VO_MODEL_NAMES`` (``name``) on any backbone (``visual_backbone``),
    with ``VO.OBS_TRANSFORM`` resizing the frames first."""
    sim = config.TASK_CONFIG.SIMULATOR
    precision = model_node.get("precision", precision)
    return VOInferenceConfig(
        model_name=model_node.name,
        observation_space=tuple(model_node.visual_type),
        vis_size_w=config.VO.VIS_SIZE_W,
        vis_size_h=config.VO.VIS_SIZE_H,
        hidden_size=model_node.hidden_size,
        backbone=model_node.visual_backbone,
        discretized_depth_channels=model_node.discretized_depth_channels,
        dropout_p=model_node.dropout_p,
        obs_transform=config.VO.get("OBS_TRANSFORM", "none"),
        min_depth=sim.DEPTH_SENSOR.MIN_DEPTH,
        max_depth=sim.DEPTH_SENSOR.MAX_DEPTH,
        hfov=sim.DEPTH_SENSOR.HFOV,  # degrees consumed as radians: the reference's quirk
        mode=model_node.get("mode", "det"),
        rnd_mode_n=model_node.get("rnd_mode_n", 10),
        precision=precision,
    )


def _frame_pair_reader(path, vo: Config, act_type, geo_types, shard_index=0, num_shards=1):
    """The HDF5 frame-pair reader (``h5py`` is imported inside it), over
    chunk shard ``shard_index`` of ``num_shards``."""
    from pointnav_vo_tpu_torch.vo.dataset import FramePairReader

    if not path:
        return None
    return FramePairReader(path, vis_size_w=vo.VIS_SIZE_W, vis_size_h=vo.VIS_SIZE_H,
                           act_type=act_type, geo_invariance_types=geo_types,
                           partial_data_n_splits=vo.DATASET.PARTIAL_DATA_N_SPLITS,
                           shard_index=shard_index, num_shards=num_shards)


@registry.register_vo_engine(name="vo_cnn_regression_geo_invariance_engine")
class VOGeoInvarianceEngine:
    """Config-facing wrapper around :class:`vo.engine.VORegressionEngine`.
    In a ``group`` the train set is sharded by host (a JAX process is a
    host), and eval stays unsharded: in training rank 0 alone evaluates."""

    def __init__(self, config: Config, run_type: str = "train", device=None, group=None):
        self.device = resolve_device(device)
        self.group = group
        self.logger = get_logger(log_file=config.get("LOG_FILE") if self.is_main else None)
        # eval and resume read the config back out of the checkpoint
        resume_state = None
        if run_type == "train" and config.RESUME_TRAIN:
            resume_state = load_checkpoint(config.RESUME_STATE_FILE)
            stored = Config(resume_state["full_config"])
            stored.RESUME_TRAIN = True
            stored.RESUME_STATE_FILE = config.RESUME_STATE_FILE
            stored.VO.TRAIN.epochs = config.VO.TRAIN.epochs
            config = stored
        eval_ckpt = None
        if "eval" in run_type and config.EVAL.EVAL_WITH_CKPT:
            eval_ckpt = config.EVAL.EVAL_CKPT_PATH
            stored = Config(load_checkpoint(eval_ckpt)["full_config"])
            stored.RESUME_TRAIN = False
            stored.EVAL = config.EVAL
            stored.VO.EVAL = config.VO.EVAL
            stored.VO.DATASET = config.VO.DATASET
            config = stored

        self.config = config
        self.run_type = run_type
        vo = config.VO
        if vo.get("debug", 0):
            raise not_ported("VO.debug (the NaN check)", "9")
        if vo.TRAIN.get("log_grad", False):
            raise not_ported("VO.TRAIN.log_grad (gradient histograms)", "9")
        if int(vo.TRAIN.get("decode_workers", 0)) > 0:
            raise not_ported("VO.TRAIN.decode_workers > 0 (process-parallel decode)", "9")
        act_type = vo.TRAIN.action_type
        if isinstance(act_type, list):
            act_type = tuple(act_type)
        geo_types = tuple(vo.GEOMETRY.invariance_types)

        # VO.MODEL.precision, else VO.TRAIN.precision: "bf16" runs the
        # experts in bfloat16 over float32 parameters and Adam state
        self.icfg = vo_inference_config_from(config, vo.MODEL,
                                             precision=vo.TRAIN.get("precision", "fp32"))
        self.tcfg = VOTrainConfig(
            lr=vo.TRAIN.lr,
            eps=vo.TRAIN.eps,
            weight_decay=vo.TRAIN.weight_decay,
            batch_size=vo.TRAIN.batch_size,
            epochs=vo.TRAIN.epochs,
            loss_weight_fixed=vo.TRAIN.loss_weight_fixed,
            loss_weight_multiplier=tuple(vo.TRAIN.loss_weight_multiplier.items()),
            action_type=act_type,
            geo_invariance_types=geo_types,
            loss_inv_weight=vo.GEOMETRY.loss_inv_weight,
            log_interval=config.LOG_INTERVAL,
            seed=config.SEED,
        )
        train_path = vo.DATASET.get("TRAIN_WITH_NOISE") or vo.DATASET.get("TRAIN")
        eval_path = vo.DATASET.get("EVAL_WITH_NOISE") or vo.DATASET.get("EVAL")
        state_dicts = None
        if vo.MODEL.pretrained and vo.MODEL.pretrained_ckpt:
            state_dicts = [
                load_vo_checkpoint(vo.MODEL.pretrained_ckpt[name], ACT_NAME2IDX[name])
                for name in ("forward", "left", "right") if name in vo.MODEL.pretrained_ckpt]
        shard = (0, 1) if group is None else (group.node, group.nodes)
        self.engine = VORegressionEngine(
            self.icfg, self.tcfg,
            train_reader=(_frame_pair_reader(train_path, vo, act_type, geo_types, *shard)
                          if run_type == "train" else None),
            eval_reader=_frame_pair_reader(eval_path, vo, act_type, geo_types),
            device=self.device, state_dicts=state_dicts, group=group)
        if resume_state is not None:
            self.engine.load_ckpt(config.RESUME_STATE_FILE)
        if eval_ckpt is not None:
            self.engine.load_experts(eval_ckpt)

    @property
    def is_main(self) -> bool:
        return self.group is None or self.group.is_main

    def _save_ckpt(self, epoch: int, writer=None) -> None:
        path = os.path.join(self.config.CHECKPOINT_FOLDER, f"ckpt_epoch_{epoch}.pth")
        self.engine.save_ckpt(path, extra={"full_config": self.config.to_dict(),
                                           "engine_name": self.config.ENGINE_NAME},
                              writer=writer)

    def _log_images(self, tb, epoch: int) -> None:
        """First-sample preprocessed channels of the previous and current
        frames."""
        obs0 = self.engine.obs_snapshot()
        if "rgb" in obs0:
            tb.add_image("prev_obs/rgb", obs0["rgb"][..., :3] / 255.0, epoch, dataformats="HWC")
            tb.add_image("cur_obs/rgb", obs0["rgb"][..., 3:] / 255.0, epoch, dataformats="HWC")
        for key in ("depth", "top_down_view"):
            if key in obs0:
                tb.add_image(f"prev_obs/{key}", obs0[key][..., 0], epoch, dataformats="HW")
                tb.add_image(f"cur_obs/{key}", obs0[key][..., 1], epoch, dataformats="HW")

    def train(self):
        preemption.install_signal_handlers()
        cfg = self.config
        # epoch checkpoints serialize and hit disk under the next epoch's
        # compute; the writer's close (or drain) makes them durable
        with AsyncCheckpointWriter() as ckpt_writer, \
                TensorboardWriter(cfg.get("TENSORBOARD_DIR") if self.is_main else None) as tb:
            while self.engine.epoch < self.tcfg.epochs:
                if _agreed_exit(self.group):
                    # an earlier periodic write's failure must not block the
                    # interrupted state's save and the requeue
                    err = ckpt_writer.drain_quietly()
                    if err is not None:
                        self.logger.error(f"earlier async checkpoint write failed: {err!r}")
                    self.engine.save_ckpt(preemption.interrupted_state_path(),
                                          extra={"full_config": cfg.to_dict(),
                                                 "engine_name": cfg.ENGINE_NAME})
                    preemption.requeue_job()
                    self.logger.info("preempted: interrupted state saved")
                    return
                stats = self.engine.train_epoch()
                epoch = self.engine.epoch
                # every rank: the ranks' generator states are gathered; rank 0 writes
                self._save_ckpt(epoch, writer=ckpt_writer)
                if not self.is_main:
                    continue
                if self.engine.eval_reader is not None:
                    stats.update({f"eval_{k}": v for k, v in self.engine.evaluate().items()})
                for k, v in stats.items():
                    if np.isscalar(v):
                        tb.add_scalar(f"train/{k}", float(v), epoch)
                if tb.writer is not None and cfg.VO.TRAIN.get("log_imgs", True):
                    self._log_images(tb, epoch)
                scalars = {k: v for k, v in stats.items() if np.isscalar(v)}
                append_jsonl({"epoch": epoch, **scalars},
                             os.path.join(cfg.INFO_DIR, "train_infos.jsonl"))
                save_info_dict({k: [v] for k, v in scalars.items()},
                               os.path.join(cfg.INFO_DIR, "train_regression_info.p"))
                self.logger.info(f"epoch {epoch}: loss={stats['mean_total_loss']:.5f} "
                                 f"fps={stats['frame_pairs_per_s']:.1f}")
        return self.engine

    def eval(self):
        save = None
        if self.config.VO.EVAL.save_pred:
            save = os.path.join(self.config.INFO_DIR, "delta_gt_pred.p")
        metrics = self.engine.evaluate(save_pred_path=save if self.is_main else None)
        if self.is_main:
            save_info_dict({k: [v] for k, v in metrics.items()},
                           os.path.join(self.config.INFO_DIR, "eval_regression_info.p"))
        self.logger.info(f"VO eval: {metrics}")
        return metrics


# ---------------------------------------------------------------------------
# RL trainer adapters
# ---------------------------------------------------------------------------


def _uses_classical_vo(config: Config) -> bool:
    return (config.VO.get("USE_VO_MODEL", False)
            and config.VO.get("VO_TYPE", "REGRESS") == "CLASSICAL")


def _build_classical_vo_fn(config: Config, device):
    """The vo_fn of ``VO.VO_TYPE: CLASSICAL``: ORB matches on the host,
    the alignment batched on ``device``, under the task's depth sensor and
    actuation."""
    from pointnav_vo_tpu_torch.vo.classical import make_classical_vo_fn

    sim = config.TASK_CONFIG.SIMULATOR
    return make_classical_vo_fn(hfov_deg=sim.DEPTH_SENSOR.HFOV,
                                min_depth=sim.DEPTH_SENSOR.MIN_DEPTH,
                                max_depth=sim.DEPTH_SENSOR.MAX_DEPTH,
                                forward_step=sim.get("FORWARD_STEP_SIZE", 0.25),
                                turn_angle_deg=sim.TURN_ANGLE, device=device)


def _build_vo_ensemble(config: Config, device) -> Optional[VOEnsemble]:
    """The VO ensemble of ``VO.REGRESS_MODEL``: the three experts of the
    configured ``.pth`` files, or seeded random experts where none are
    configured; ``None`` without ``VO.USE_VO_MODEL``, and for any
    ``VO.VO_TYPE`` but ``REGRESS`` (the classical backend rides the
    ``vo_fn`` hook instead)."""
    vo = config.VO
    if not vo.get("USE_VO_MODEL", False) or vo.get("VO_TYPE", "REGRESS") != "REGRESS":
        return None
    node = vo.REGRESS_MODEL
    icfg = vo_inference_config_from(config, node)
    if node.pretrained and node.all_pretrained_ckpt:
        return VOEnsemble.from_torch_checkpoints(
            icfg, node.all_pretrained_ckpt[node.pretrained_type], device=device)
    g = torch.Generator().manual_seed(config.SEED)
    return VOEnsemble(icfg, experts=[seeded_init_(icfg.make_model(), g) for _ in range(3)],
                      device=device)


def _checkpoint_name(interval: int, update: int, count_steps: int) -> str:
    return f"ckpt_{update // interval}.update_{update}.frames_{count_steps}.pth"


class _BaseRLEngine:
    group = None  # a parallel.dist.Group where the engine is one rank of a run

    def __init__(self, config: Config, run_type: str = "train", noisy: bool = True,
                 device=None, group=None):
        self.config = config
        self.run_type = run_type
        self.noisy = noisy
        self.device = resolve_device(device)
        self.group = group
        self.logger = get_logger(log_file=config.get("LOG_FILE") if self.is_main else None)
        self.model = registry.get_policy(config.RL.Policy.name)(config)
        ppo = config.RL.PPO
        self.ppo_cfg = PPOConfig(
            clip_param=ppo.clip_param,
            ppo_epoch=ppo.ppo_epoch,
            num_mini_batch=ppo.num_mini_batch,
            value_loss_coef=ppo.value_loss_coef,
            entropy_coef=ppo.entropy_coef,
            lr=ppo.lr,
            eps=ppo.eps,
            max_grad_norm=ppo.max_grad_norm,
            num_steps=ppo.num_steps,
            use_gae=ppo.use_gae,
            gamma=ppo.gamma,
            tau=ppo.tau,
            use_clipped_value_loss=ppo.get("use_clipped_value_loss", True),
            use_normalized_advantage=ppo.use_normalized_advantage,
            use_linear_lr_decay=ppo.use_linear_lr_decay,
            use_linear_clip_decay=ppo.get("use_linear_clip_decay", False),
            hidden_size=ppo.hidden_size,
            reward_window_size=ppo.reward_window_size,
        )

    @property
    def is_main(self) -> bool:
        return self.group is None or self.group.is_main

    def _make_envs(self):
        return registry.get_env(self.config.ENV_NAME)(
            self.config, self.config.NUM_PROCESSES, seed=self.config.SEED, noisy=self.noisy,
            group=self.group)

    # -- training -------------------------------------------------------------

    def train(self):
        envs = self._make_envs()
        try:
            return self._train_with_envs(self.config, envs)
        finally:
            envs.close()

    def _state(self, trainer, update: int) -> Dict:
        cfg = self.config
        return {**trainer.checkpoint_state(), "full_config": cfg.to_dict(),
                "engine_name": cfg.ENGINE_NAME, "update": update,
                "count_steps": trainer.count_steps, "host_rng": rng_state_bundle()}

    def _train_with_envs(self, cfg, envs):
        vo = _build_vo_ensemble(cfg, self.device) if cfg.RL.TUNE_WITH_VO else None
        trainer = DDPPOTrainer(
            model=self.model, ppo_cfg=self.ppo_cfg, envs=envs, device=self.device,
            init_generator=torch.Generator().manual_seed(cfg.SEED),
            generator=torch.Generator(device=self.device).manual_seed(
                rank_seed(cfg.SEED, self.group)),
            vo_ensemble=vo, total_updates=cfg.NUM_UPDATES, group=self.group)
        start_update = 0
        if cfg.RESUME_TRAIN and os.path.isfile(cfg.RESUME_STATE_FILE):
            # a periodic checkpoint or an interrupted state: restart at the
            # update it stores
            state = load_checkpoint(cfg.RESUME_STATE_FILE)
            trainer.load_checkpoint_state(state, seed=cfg.SEED)
            start_update = int(state["update"])
            trainer.update_idx = start_update
            self.logger.info(f"resumed from {cfg.RESUME_STATE_FILE} @ update {start_update}, "
                             f"{trainer.count_steps} env steps")
        self.start_update = start_update
        preemption.install_signal_handlers()
        with AsyncCheckpointWriter() as ckpt_writer, \
                TensorboardWriter(cfg.get("TENSORBOARD_DIR") if self.is_main else None) as tb:
            for update in range(start_update, cfg.NUM_UPDATES):
                if _agreed_exit(self.group):
                    err = ckpt_writer.drain_quietly()
                    if err is not None:
                        self.logger.error(f"earlier async checkpoint write failed: {err!r}")
                    state = self._state(trainer, update)  # every rank: a gather
                    if self.is_main:
                        preemption.save_interrupted_state(state)
                    preemption.requeue_job()
                    self.logger.info("preempted: interrupted state saved")
                    return trainer
                trainer.collect_rollout()
                stats = trainer.update_agent()
                if update % cfg.LOG_INTERVAL == 0 and self.is_main:
                    for k, v in stats.items():
                        tb.add_scalar(f"train/{k}", float(v), update)
                    tb.add_scalar("Simulation/FPS", trainer.count_steps
                                  / max(sum(trainer.timing.values()), 1e-9), update)
                    self.logger.info(f"update {update}: {stats} timing={trainer.timing}")
                if update % cfg.CHECKPOINT_INTERVAL == 0:
                    path = os.path.join(cfg.CHECKPOINT_FOLDER, _checkpoint_name(
                        cfg.CHECKPOINT_INTERVAL, update, trainer.count_steps))
                    state = self._state(trainer, update)  # every rank: a gather
                    if self.is_main:
                        ckpt_writer.save(path, state)
        return trainer

    # -- evaluation -----------------------------------------------------------

    def eval(self, ckpt_path: Optional[str] = None, num_episodes: Optional[int] = None):
        """One checkpoint, or a sweep over a checkpoint folder: with
        ``EVAL.WAIT_FOR_CKPTS`` > 0 it keeps polling for checkpoints a live
        trainer has yet to write, up to ``EVAL.CKPT_STALE_TIMEOUT_S`` with
        no new file.  In a group rank 0's listing and its decision to give
        up are every rank's."""
        cfg = self.config
        ckpt_path = ckpt_path or cfg.EVAL.EVAL_CKPT_PATH
        if not (ckpt_path and os.path.isdir(ckpt_path)):
            return self._eval_checkpoint(ckpt_path, num_episodes)
        results = {}
        target = int(cfg.EVAL.get("WAIT_FOR_CKPTS", 0) or 0)
        poll_s = float(cfg.EVAL.get("CKPT_POLL_INTERVAL_S", 2.0))
        stale_timeout_s = float(cfg.EVAL.get("CKPT_STALE_TIMEOUT_S", 3600.0))
        last_progress_t = time.monotonic()
        # f -> (mtime, size, attempts): a file that keeps failing while its
        # bytes stay put is corrupt, not mid-write; give up on it after a
        # few stable retries or the poll loop spins forever
        fail_state: Dict[str, tuple] = {}
        abandoned: set = set()
        while True:
            # only checkpoints: a leftover .tmp of an interrupted save or a
            # stray log must not abort the sweep
            files = sorted((f for f in os.listdir(ckpt_path)
                            if f.startswith("ckpt") and f.endswith((".pkl", ".pth"))
                            and f not in results and f not in abandoned),
                           key=lambda f: os.path.getmtime(os.path.join(ckpt_path, f)))
            if self.group is not None:
                files = self.group.broadcast_object(files)
            for f in files:
                p = os.path.join(ckpt_path, f)
                try:
                    results[f] = self._eval_checkpoint(p, num_episodes)
                    fail_state.pop(f, None)
                except (OSError, pickle.UnpicklingError, EOFError) as e:
                    # unreadable now, possibly mid-write: retry next poll
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue  # deleted between listdir and stat
                    sig = (st.st_mtime, st.st_size)
                    prev = fail_state.get(f)
                    attempts = prev[2] + 1 if prev and prev[:2] == sig else 1
                    fail_state[f] = (*sig, attempts)
                    if attempts >= 3:
                        abandoned.add(f)
                        self.logger.error(f"abandoning unreadable checkpoint {p} after "
                                          f"{attempts} retries with stable mtime/size: {e}")
                    else:
                        self.logger.warning(f"skipping unreadable checkpoint {p} "
                                            f"(retry {attempts}): {e}")
            # abandoned files count toward the exit condition, so one
            # corrupt checkpoint cannot stall the companion eval
            done_count = len(results) + len(abandoned)
            if done_count >= target or target <= 0:
                break
            # any unevaluated file, even one that failed, counts as progress
            if files:
                last_progress_t = time.monotonic()
            stale = (not files and stale_timeout_s > 0
                     and time.monotonic() - last_progress_t > stale_timeout_s)
            if self.group is not None:
                stale = self.group.broadcast_object(stale)
            if stale:
                self.logger.error(
                    f"giving up on checkpoint folder {ckpt_path}: no new checkpoints for "
                    f"{stale_timeout_s:.0f}s with {done_count}/{target} evaluated — is the "
                    "training job alive? (EVAL.CKPT_STALE_TIMEOUT_S; 0 disables)")
                break
            time.sleep(poll_s)
        return results

    def _merged_eval_config(self, ckpt_path: Optional[str]) -> Config:
        """The reference's merge priority ``eval_opts > ckpt_opts > eval_cfg
        > ckpt_cfg``: the checkpoint's stored config, the live eval config
        over it, the checkpoint's stored CLI opts, then the live run's;
        never eval on the train split.  A checkpoint with no stored config
        (a published ``.pth``) evaluates under the live config."""
        cfg = self.config
        if not (ckpt_path and os.path.isfile(ckpt_path)):
            return cfg
        state = load_checkpoint(ckpt_path)
        if "full_config" not in state:
            return cfg
        merged = Config(state["full_config"])                   # ckpt_cfg
        ckpt_opts = list(merged.get("CMD_TRAILING_OPTS", []) or [])
        merged.merge_from_dict(cfg.to_dict())                   # eval_cfg
        try:
            merged.merge_from_list(ckpt_opts)                   # ckpt_opts
        except (KeyError, ValueError):
            pass  # stored opts name keys that are gone: skipped, as the reference does
        merged.merge_from_list(list(cfg.get("CMD_TRAILING_OPTS", []) or []))
        if merged.TASK_CONFIG.DATASET.SPLIT == "train":
            merged.TASK_CONFIG.DATASET.SPLIT = "val"
        return merged

    def _eval_checkpoint(self, ckpt_path: Optional[str], num_episodes: Optional[int] = None):
        cfg = self._merged_eval_config(ckpt_path)
        envs = self._make_envs()
        try:
            return self._eval_ckpt_with_envs(cfg, ckpt_path, num_episodes, envs)
        finally:
            envs.close()

    def _eval_ckpt_with_envs(self, cfg, ckpt_path, num_episodes, envs):
        # None without VO.USE_VO_MODEL: the policy reads the GPS sensor
        vo = _build_vo_ensemble(cfg, self.device)
        if ckpt_path and os.path.isfile(ckpt_path):
            sd = policy_state_dict_from_container(load_checkpoint(ckpt_path))
            self.model.load_state_dict(sd, strict=True)
        else:
            seeded_init_(self.model, torch.Generator().manual_seed(cfg.SEED))
        vo_fn = _build_classical_vo_fn(cfg, self.device) if _uses_classical_vo(cfg) else None
        evaluator = Evaluator(model=self.model, envs=envs, vo_ensemble=vo, vo_fn=vo_fn,
                              device=self.device, deterministic=True,
                              generator=torch.Generator(device=self.device).manual_seed(
                                  rank_seed(cfg.SEED, self.group)), group=self.group)
        n = num_episodes or (cfg.EVAL.TEST_EPISODE_COUNT
                             if cfg.EVAL.TEST_EPISODE_COUNT > 0 else 100)
        video_episodes = 3 if "disk" in cfg.get("VIDEO_OPTION", []) else 0
        ranked_dir = (os.path.join(cfg.INFO_DIR, "ranked_imgs")
                      if cfg.EVAL.get("SAVE_RANKED_IMGS") else None)
        t0 = time.perf_counter()
        metrics = evaluator.run(n, video_dir=cfg.get("VIDEO_DIR") if video_episodes else None,
                                video_episodes=video_episodes, ranked_img_dir=ranked_dir,
                                rank_top_k=cfg.EVAL.get("RANK_TOP_K", 20))
        metrics["wall_clock_s"] = time.perf_counter() - t0
        if not self.is_main:
            return metrics
        save_info_dict({k: [v] for k, v in metrics.items()},
                       os.path.join(cfg.INFO_DIR, "eval_infos.p"))
        # per-episode results next to the aggregates, one file a checkpoint
        stem = os.path.splitext(os.path.basename(ckpt_path))[0] if ckpt_path else "eval"
        with open(os.path.join(cfg.INFO_DIR, f"{stem}.infos.p"), "wb") as f:
            pickle.dump([dataclasses.asdict(r) for r in evaluator.results], f)
        self.logger.info(f"eval: {metrics}")
        return metrics


@registry.register_trainer(name="efficient_ddppo")
class EfficientDDPPOEngine(_BaseRLEngine):
    pass


@registry.register_trainer(name="ppo")
class PPOEngine(_BaseRLEngine):
    pass


# every VO variant, through the registry like the reference
for _name in VO_MODEL_NAMES:
    registry.register_vo_model(name=_name)(functools.partial(make_vo_model, _name))
