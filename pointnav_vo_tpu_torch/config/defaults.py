"""Default config trees (counterpart of ``config/defaults.py``), key for
key: the same layout as the reference's three yacs trees.

- task tree       (the navigation-relevant subset of the Habitat task config)
- RL experiment   (reference ``config/rl_config/default.py``)
- VO experiment   (reference ``config/vo_config/default.py``, mostly
  populated from YAML)

Experiment configs embed the task tree under ``TASK_CONFIG`` like the
reference, and eval reads config back out of checkpoints (``engines.py``).
Some keys select features the port has not ported yet; ``engines.py``
raises for those rather than run without them.
"""

from __future__ import annotations

from typing import List, Optional

from pointnav_vo_tpu_torch.utils.config import Config


def get_task_config(path: Optional[str] = None, opts: Optional[list] = None) -> Config:
    c = Config({
        "SEED": 1,
        "ENVIRONMENT": {"MAX_EPISODE_STEPS": 500},
        "SIMULATOR": {
            "TURN_ANGLE": 30,
            "FORWARD_STEP_SIZE": 0.25,
            "AGENT_0": {"SENSORS": ["RGB_SENSOR", "DEPTH_SENSOR"], "HEIGHT": 0.88,
                        "RADIUS": 0.18},
            "HABITAT_SIM_V0": {"GPU_DEVICE_ID": 0, "ALLOW_SLIDING": False},
            "RGB_SENSOR": {
                "WIDTH": 341, "HEIGHT": 192, "HFOV": 70,
                "NOISE_MODEL": "GaussianNoiseModel",
                "NOISE_MODEL_KWARGS": {"intensity_constant": 0.1},
            },
            "DEPTH_SENSOR": {
                "WIDTH": 341, "HEIGHT": 192, "HFOV": 70,
                "MIN_DEPTH": 0.1, "MAX_DEPTH": 10.0,
                "NOISE_MODEL": "RedwoodDepthNoiseModel",
            },
            "ACTION_SPACE_CONFIG": "pyrobotnoisy",
            "NOISE_MODEL": {"ROBOT": "LoCoBot", "CONTROLLER": "Proportional",
                            "NOISE_MULTIPLIER": 0.5},
        },
        "TASK": {
            "TYPE": "Nav-v0",
            "SUCCESS_DISTANCE": 0.36,
            "SENSORS": ["POINTGOAL_WITH_GPS_COMPASS_SENSOR"],
            "GOAL_SENSOR_UUID": "pointgoal_with_gps_compass",
            "MEASUREMENTS": ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "SOFT_SPL"],
            "SUCCESS": {"SUCCESS_DISTANCE": 0.36},
        },
        "DATASET": {
            "TYPE": "PointNav-v1",
            "SPLIT": "train",
            "SCENES_DIR": "dataset/Gibson",
            "DATA_PATH": "dataset/habitat_datasets/pointnav/gibson/v2/{split}/{split}.json.gz",
        },
    })
    if path:
        c.merge_from_file(path)
    if opts:
        c.merge_from_list(opts)
    return c


def _log_nodes(prefix: str = "train_log") -> dict:
    return {
        "LOG_DIR": prefix,
        "LOG_FILE": f"{prefix}/train.log",
        "INFO_DIR": f"{prefix}/infos",
        "CHECKPOINT_FOLDER": f"{prefix}/checkpoints",
        "TENSORBOARD_DIR": f"{prefix}/tb",
        "VIDEO_OPTION": [],
        "VIDEO_DIR": f"{prefix}/videos",
        "LOG_INTERVAL": 10,
        "CHECKPOINT_INTERVAL": 50,
    }


def get_rl_config(paths: Optional[List[str]] = None, opts: Optional[list] = None) -> Config:
    c = Config({
        "BASE_TASK_CONFIG_PATH": "",
        "ENGINE_NAME": "efficient_ddppo",
        "ENV_NAME": "NavRLEnv",
        # raw trailing KEY VALUE CLI overrides; stored into checkpoints so
        # eval can replay them (priority eval_opts > ckpt_opts > eval_cfg >
        # ckpt_cfg, engines.py::_merged_eval_config)
        "CMD_TRAILING_OPTS": [],
        # env fan-out backend: "sync" (in-process serial loop), "shm"
        # (forked scripted workers over the shared-memory rings), "habitat"
        # (shm workers each hosting a habitat-sim instance)
        "ENV_BACKEND": "sync",
        "SENSORS": ["DEPTH_SENSOR", "RGB_SENSOR"],
        "NUM_UPDATES": 10000,
        "NUM_PROCESSES": 2,
        "SEED": 1,
        **_log_nodes(),
        "RESUME_TRAIN": False,
        "RESUME_STATE_FILE": "resume_train_ckpt.pkl",
        "EVAL": {
            "SPLIT": "val",
            "TEST_EPISODE_COUNT": -1,
            "EVAL_WITH_CKPT": True,
            "EVAL_CKPT_PATH": "",
            "SAVE_RANKED_IMGS": False,
            "RANK_TOP_K": 1,
            # eval-during-training: >0 keeps polling EVAL_CKPT_PATH until
            # that many checkpoints have been evaluated; 0 = one-shot mtime
            # sweep of whatever exists now
            "WAIT_FOR_CKPTS": 0,
            "CKPT_POLL_INTERVAL_S": 2.0,
            # give up polling after this long with no new checkpoints: a
            # dead trainer must not hang the companion eval forever
            # (0 = wait indefinitely)
            "CKPT_STALE_TIMEOUT_S": 3600.0,
        },
        "RL": {
            "SUCCESS_REWARD": 2.5,
            "SLACK_REWARD": -0.01,
            "REWARD_MEASURE": "distance_to_goal",
            "SUCCESS_MEASURE": "success",
            "OBS_TRANSFORM": "none",
            "VIS_SIZE_W": 341,
            "VIS_SIZE_H": 192,
            "TUNE_WITH_VO": False,
            "Policy": {
                "name": "resnet_rnn_policy",
                "visual_backbone": "resnet18",
                "rnn_backbone": "LSTM",
                "num_recurrent_layers": 2,
                "visual_types": ["depth"],
            },
            "PPO": {
                "clip_param": 0.2,
                "ppo_epoch": 1,
                "num_mini_batch": 2,
                "value_loss_coef": 0.5,
                "entropy_coef": 0.01,
                "lr": 2.5e-4,
                "eps": 1e-5,
                "max_grad_norm": 0.2,
                "num_steps": 128,
                "use_gae": True,
                "gamma": 0.99,
                "tau": 0.95,
                "use_linear_clip_decay": False,
                "use_linear_lr_decay": False,
                "reward_window_size": 50,
                "use_normalized_advantage": False,
                "hidden_size": 512,
                "use_clipped_value_loss": True,
            },
            "DDPPO": {
                # kept for config parity (the values of the JAX package's
                # tree); one process reads none of them
                "sync_frac": 0.6,
                "distrib_backend": "XLA",
                "pretrained": False,
                "pretrained_weights": "",
                "pretrained_encoder": False,
                "train_encoder": True,
                "reset_critic": False,
            },
        },
        "VO": {
            "USE_VO_MODEL": False,
            "VO_TYPE": "REGRESS",
            "OBS_TRANSFORM": "none",
            "VIS_SIZE_W": 341,
            "VIS_SIZE_H": 192,
            "REGRESS_MODEL": {
                "name": "vo_cnn_rgb_d_dd_top_down",
                "visual_backbone": "resnet18",
                "hidden_size": 512,
                "visual_type": ["rgb", "depth", "discretized_depth", "top_down_view"],
                "dropout_p": 0.2,
                "discretize_depth": "hard",
                "discretized_depth_channels": 10,
                "regress_type": "sep_act",
                "mode": "det",
                "rnd_mode_n": 10,
                "pretrained": False,
                "pretrained_type": "rgb_d_dd_top_down_inv_joint",
                "all_pretrained_ckpt": {},
            },
        },
        "TASK_CONFIG": get_task_config().to_dict(),
    })
    for p in paths or []:
        c.merge_from_file(p)
    if c.BASE_TASK_CONFIG_PATH:
        c.TASK_CONFIG = get_task_config(c.BASE_TASK_CONFIG_PATH)
    if opts:
        c.merge_from_list(opts)
        c.CMD_TRAILING_OPTS = [str(o) for o in opts]
    return c


def get_vo_config(paths: Optional[List[str]] = None, opts: Optional[list] = None) -> Config:
    c = Config({
        "BASE_TASK_CONFIG_PATH": "",
        "ENGINE_NAME": "vo_cnn_regression_geo_invariance_engine",
        "CMD_TRAILING_OPTS": [],
        "SEED": 1,
        **_log_nodes(),
        "RESUME_TRAIN": False,
        "RESUME_STATE_FILE": "resume_train_ckpt.pkl",
        "EVAL": {"EVAL_WITH_CKPT": True, "EVAL_CKPT_PATH": ""},
        "VO": {
            "debug": 0,
            "VO_TYPE": "REGRESS",
            "VIS_SIZE_W": 341,
            "VIS_SIZE_H": 192,
            "TRAIN": {
                "lr": 2.5e-4,
                # "bf16": mixed precision (bfloat16 activations and convs,
                # float32 parameters and Adam state); "fp32" matches the
                # reference numerics
                "precision": "fp32",
                "weight_decay": 0.0,
                "scheduler": "none",
                "eps": 1e-8,
                "batch_size": 128,
                "epochs": 150,
                "loss_weight_fixed": True,
                "loss_weight_multiplier": {"dx": 1.0, "dz": 1.0, "dyaw": 1.0},
                "log_grad": False,
                "log_grad_interval": 200,
                "optim": "adam",
                "collision": "-1",
                "action_type": 1,
                # > 0: that many HDF5 decode worker processes (not ported yet)
                "decode_workers": 0,
            },
            "EVAL": {
                "save_pred": True,
                "rank_pred": False,
                "rank_top_k": 20,
                "eval_acts": ["no_specify"],
            },
            "MODEL": {
                "name": "vo_cnn_rgb_d_dd_top_down",
                "visual_backbone": "resnet18",
                "hidden_size": 512,
                "visual_type": ["rgb", "depth", "discretized_depth", "top_down_view"],
                "discretize_depth": "hard",
                "discretized_depth_channels": 10,
                "top_down_center_crop": True,
                "dropout_p": 0.2,
                "pretrained": False,
                "pretrained_ckpt": {},
            },
            "REGRESSION": {"delta_types": ["dx", "dz", "dyaw"]},
            "GEOMETRY": {"loss_inv_weight": 1.0, "invariance_types": []},
            "DATASET": {
                "TRAIN_WITH_NOISE": "",
                "EVAL_WITH_NOISE": "",
                "TRAIN": "",
                "EVAL": "",
                "PARTIAL_DATA_N_SPLITS": 1,
            },
        },
        "TASK_CONFIG": get_task_config().to_dict(),
    })
    for p in paths or []:
        c.merge_from_file(p)
    if c.BASE_TASK_CONFIG_PATH:
        c.TASK_CONFIG = get_task_config(c.BASE_TASK_CONFIG_PATH)
    if opts:
        c.merge_from_list(opts)
        c.CMD_TRAILING_OPTS = [str(o) for o in opts]
    return c
