from pointnav_vo_tpu_torch.config.defaults import get_rl_config, get_task_config, get_vo_config  # noqa: F401
