"""Port parity, the driver layer: config trees, registry, checkpoints,
preemption, reference ``.pth`` loading, the engines and the CLI of
pointnav_vo_tpu_torch against the JAX package (CPU, 32x32 sensors).

The JAX runs (an RL eval through its CLI, the JAX engine's ``.pth`` eval
of a port checkpoint, a VO train and eval through its CLI) happen once
each, in module-scoped fixtures."""

import dataclasses
import glob
import json
import logging
import os
import pickle
import random
import re
import signal
import struct
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fake_habitat
from pointnav_vo_tpu import run as jrun
from pointnav_vo_tpu.io.checkpoint import save_checkpoint as j_save_checkpoint
from pointnav_vo_tpu.config.defaults import get_rl_config as j_rl_config
from pointnav_vo_tpu.config.defaults import get_vo_config as j_vo_config
from pointnav_vo_tpu.io import torch_import as jimport
from pointnav_vo_tpu.io.torch_export import save_policy_checkpoint_torch, save_vo_checkpoint_torch
from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.policy import PointNavBaselineActorCritic as JBaseline
from pointnav_vo_tpu.rl.envs import EnvConfig as JEnvConfig
from pointnav_vo_tpu.rl.envs import env_config_from_task as j_env_config_from_task
from pointnav_vo_tpu.utils import logging as jlog
from pointnav_vo_tpu.utils import registry as jregistry
from pointnav_vo_tpu.vo.dataset import generate_scripted_dataset
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg

from pointnav_vo_tpu_torch import engines as tengines
from pointnav_vo_tpu_torch import run as trun
from pointnav_vo_tpu_torch.config.defaults import get_rl_config, get_vo_config
from pointnav_vo_tpu_torch.io.checkpoint import (
    AsyncCheckpointWriter,
    UnreadableCheckpointError,
    generator_state,
    latest_checkpoint,
    load_checkpoint,
    restore_generator,
    restore_rng_state,
    rng_state_bundle,
    save_checkpoint,
)
from pointnav_vo_tpu_torch.io.weights import (
    POLICY_PREFIX,
    _vo_param_path,
    load_policy_checkpoint,
    load_vo_checkpoint,
    policy_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.rl.envs import env_config_from_task
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils import preemption, registry
from pointnav_vo_tpu_torch.utils.config import Config
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

from _utils import fast_init

import pointnav_vo_tpu.engines  # noqa: E402,F401  (populates the JAX registry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL_YAML = os.path.join(REPO, "configs/rl/ddppo_pointnav.yaml")
VO_YAML = os.path.join(REPO, "configs/vo/vo_pointnav.yaml")
S = 32  # sensor and VO input size
HIDDEN = 32
RTOL, ATOL = 1e-4, 1e-5  # fp32 forwards (tests/test_torch_port_models.py)
EPISODES = 4
BASELINE_S = 64  # the baseline's sensors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _restore_signal_handlers():
    """The train runs install the preemption handlers: put the runner's
    back afterwards."""
    sigs = (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1, signal.SIGUSR2)
    old = {s: signal.getsignal(s) for s in sigs}
    yield
    for s, h in old.items():
        signal.signal(s, h)
    preemption.reset_for_tests()


# ---------------------------------------------------------------- config


_OVERRIDES = {
    "rl": ["RL.PPO.lr", "1.0e-3", "NUM_PROCESSES", "4", "RL.TUNE_WITH_VO", "False",
           "VO.REGRESS_MODEL.mode", "rnd", "EVAL.EVAL_CKPT_PATH", "a/b.pth",
           "RL.Policy.visual_types", "[depth, rgb]", "TASK_CONFIG.SIMULATOR.TURN_ANGLE", "10"],
    "vo": ["VO.TRAIN.lr", "1.5e-4", "VO.TRAIN.action_type", "[2, 3]",
           "VO.GEOMETRY.invariance_types", "[inverse_joint_train]", "SEED", "7",
           "VO.MODEL.pretrained_ckpt", "{forward: a.pth}", "VO.DATASET.EVAL", "x.h5"],
}


@pytest.mark.parametrize("which", ["rl", "vo"])
@pytest.mark.parametrize("with_opts", [False, True])
def test_config_trees_match_jax(which, with_opts):
    port, jax_ = ((get_rl_config, j_rl_config) if which == "rl"
                  else (get_vo_config, j_vo_config))
    path = RL_YAML if which == "rl" else VO_YAML
    opts = _OVERRIDES[which] if with_opts else None
    assert port().to_dict() == jax_().to_dict()
    assert port([path], opts).to_dict() == jax_([path], opts).to_dict()


def test_config_freeze_defrost_and_new_key_warning():
    c = get_rl_config([RL_YAML])
    assert c.ENGINE_NAME == "efficient_ddppo" and c.RL.PPO.lr == 1.0e-4
    assert c.VO.REGRESS_MODEL.all_pretrained_ckpt.rgb_d_dd_top_down_inv_joint.forward.endswith(
        "act_forward.pth")
    c.freeze()
    with pytest.raises(AttributeError, match="frozen"):
        c.SEED = 2
    with pytest.raises(AttributeError, match="frozen"):
        c.RL.PPO.lr = 2.0
    c.defrost()
    c.merge_from_list(["RL.PPO.lr", "1.0e-3", "RL.TUNE_WITH_VO", "False",
                       "RL.Policy.visual_types", "[depth, rgb]", "ENGINE_NAME", "ppo"])
    assert c.RL.PPO.lr == 1e-3 and c.RL.TUNE_WITH_VO is False
    assert c.RL.Policy.visual_types == ["depth", "rgb"] and c.ENGINE_NAME == "ppo"
    with pytest.warns(UserWarning, match="NEW key 'RL.PPO.lrr'"):
        c.merge_from_list(["RL.PPO.lrr", "1"])
    with pytest.raises(ValueError, match="alternate"):
        c.merge_from_list(["SEED"])
    assert c.clone().to_dict() == c.to_dict() and isinstance(c.clone().RL, Config)


def test_registry_names_match_jax():
    for ns in ("trainer", "env", "policy", "vo_engine", "vo_model"):
        assert registry.names(ns) == jregistry.names(ns), ns
    assert len(registry.names("vo_model")) == 12


@pytest.mark.parametrize("noisy", [True, False])
def test_env_config_from_task_matches_jax(noisy):
    opts = ["TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", "48",
            "TASK_CONFIG.SIMULATOR.TURN_ANGLE", "10",
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "77"]
    got = dataclasses.asdict(env_config_from_task(get_rl_config([RL_YAML], opts), noisy=noisy))
    want = dataclasses.asdict(j_env_config_from_task(j_rl_config([RL_YAML], opts), noisy=noisy))
    assert got == {k: want[k] for k in got}
    assert (got["image_h"], got["turn_angle_deg"], got["max_episode_steps"]) == (48, 10, 77)
    assert (got["actuation_noise_multiplier"] > 0) == noisy


# ---------------------------------------------------------------- weights


def _jax_policy(jpol=None, size=S, seed=3):
    """A JAX policy (the depth LSTM policy by default) and its variables at
    ``size``; the rgb policies' whitening buffers as if 100 frames were
    seen."""
    jpol = jpol or JPolicy(image_size=(S, S), hidden_size=HIDDEN)
    obs = {"depth": jnp.zeros((1, size, size, 1)), "rgb": jnp.zeros((1, size, size, 3)),
           "pointgoal_with_gps_compass": jnp.zeros((1, 2))}
    variables = fast_init(jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1)), seed=seed)
    variables = jax.tree.map(np.asarray, variables)
    # a policy that mostly moves: STOP disfavoured, the rest left to the net
    variables["params"]["action_head"]["bias"] = np.asarray([-2.0, 0.3, 0.0, 0.0], np.float32)
    if "batch_stats" in variables:
        variables["batch_stats"]["visual_encoder"]["rmv"] = {
            "mean": (np.asarray([120.0, 125.0, 130.0, 0.4]) / [255, 255, 255, 1]).astype(
                np.float32),
            "var": np.asarray([0.06, 0.05, 0.04, 0.03], np.float32),
            "count": np.asarray(100.0, np.float32)}
    return jpol, variables


def _jax_experts(**kw):
    jcfg = JCfg(vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN, **kw)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, S, S, 6)), "depth": jnp.zeros((1, S, S, 2)),
             "discretized_depth": jnp.zeros((1, S, S, 20)),
             "top_down_view": jnp.zeros((1, S, S, 2))}
    return model, [jax.tree.map(np.asarray, fast_init(model, dummy, train=False, seed=10 + i))
                   for i in range(3)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX-initialised policy and experts written as reference ``.pth``
    files by the JAX exporter."""
    d = tmp_path_factory.mktemp("weights")
    jpol, pvars = _jax_policy()
    vmodel, experts = _jax_experts()
    paths = {"policy": str(d / "rl_policy.pth"), "forward": str(d / "act_forward.pth"),
             "left_right": str(d / "act_left_right_inv_joint.pth"),
             "single": str(d / "model_state.pth")}
    save_policy_checkpoint_torch(paths["policy"], pvars)
    save_vo_checkpoint_torch(paths["forward"], {1: experts[0]})
    save_vo_checkpoint_torch(paths["left_right"], {2: experts[1], 3: experts[2]})
    save_vo_checkpoint_torch(paths["single"], experts[1])
    # the GRU and the rgb-d whitening policy through the JAX exporter
    for name, module in (("gru", JPolicy(image_size=(S, S), hidden_size=HIDDEN,
                                         rnn_type="GRU")),
                         ("rgbd", JPolicy(image_size=(S, S), hidden_size=HIDDEN,
                                          vis_types=("rgb", "depth"),
                                          normalize_visual_inputs=True))):
        paths[name] = str(d / f"rl_{name}.pth")
        save_policy_checkpoint_torch(paths[name], _jax_policy(module, seed=5)[1])
    # the baseline (its VALID convs need 36 pixels) has no key in the JAX
    # exporter: each CLI gets its own format, both from the same variables
    _, bvars = _jax_policy(JBaseline(hidden_size=HIDDEN), size=BASELINE_S, seed=6)
    paths["baseline_jax"] = str(d / "rl_baseline.pkl")
    j_save_checkpoint(paths["baseline_jax"], {"params": bvars["params"]})
    paths["baseline_port"] = str(d / "rl_baseline.pth")
    save_checkpoint(paths["baseline_port"], {"state_dict": {
        POLICY_PREFIX + k: v for k, v in policy_state_dict_from_jax(bvars).items()}})
    return {"paths": paths, "jpol": jpol, "vmodel": vmodel}


def test_reference_vo_pth_loads_and_matches_jax(weights):
    """Both containers: per-action ``model_states`` and ``model_state``."""
    p = weights["paths"]
    tcfg = VOInferenceConfig(vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN)
    packed = np.random.default_rng(0).uniform(0, 1, (3, S, S, 30)).astype(np.float32)
    for path, act in ((p["forward"], 1), (p["left_right"], 2), (p["left_right"], 3),
                      (p["single"], None)):
        want = np.asarray(weights["vmodel"].apply(jimport.load_vo_checkpoint(path, act),
                                                  jnp.asarray(packed), train=False))
        tm = tcfg.make_model()
        tm.load_state_dict(load_vo_checkpoint(path, act), strict=True)
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(packed)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{path} {act}")
    with pytest.raises(ValueError, match="act_idx"):
        load_vo_checkpoint(p["forward"])
    ens = VOEnsemble.from_torch_checkpoints(
        tcfg, {"forward": p["forward"], "left": p["left_right"], "right": p["left_right"]},
        device="cpu")
    for m, act in zip(ens.experts, (1, 2, 3)):
        sd = load_vo_checkpoint(p["forward" if act == 1 else "left_right"], act)
        have = m.state_dict()
        assert all(torch.equal(have[k].flatten(), v.flatten()) for k, v in sd.items())


def test_reference_policy_pth_loads_and_matches_jax(weights):
    path = weights["paths"]["policy"]
    jpol = weights["jpol"]
    rng = np.random.default_rng(1)
    n = 3
    obs = {"depth": rng.uniform(0, 1, (n, S, S, 1)).astype(np.float32),
           "pointgoal_with_gps_compass": rng.normal(size=(n, 2)).astype(np.float32)}
    hidden = rng.normal(size=(4, n, HIDDEN)).astype(np.float32)
    prev = np.asarray([[0], [2], [3]])
    masks = np.asarray([[0.0], [1.0], [1.0]], np.float32)
    jv = jimport.load_policy_checkpoint(path)
    want = jpol.apply({"params": jv["params"]}, {k: jnp.asarray(v) for k, v in obs.items()},
                      jnp.asarray(hidden), jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
    tm = TPolicy(image_size=(S, S), hidden_size=HIDDEN)
    tm.load_state_dict(load_policy_checkpoint(path), strict=True)
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(v) for k, v in obs.items()},
                        torch.from_numpy(hidden), torch.from_numpy(prev), torch.from_numpy(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- RL CLI


def _rl_opts(paths, ckpt, extra=()):
    experts = (f"{{rgb_d_dd_top_down_inv_joint: {{forward: {paths['forward']}, "
               f"left: {paths['left_right']}, right: {paths['left_right']}}}}}")
    return [
        "NUM_PROCESSES", "2", "SEED", "3",
        "RL.PPO.hidden_size", str(HIDDEN), "RL.PPO.num_steps", "4",
        "VO.USE_VO_MODEL", "True", "VO.VIS_SIZE_W", str(S), "VO.VIS_SIZE_H", str(S),
        "VO.REGRESS_MODEL.hidden_size", str(HIDDEN),
        "VO.REGRESS_MODEL.pretrained", "True",
        "VO.REGRESS_MODEL.all_pretrained_ckpt", experts,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(S),
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(S),
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(S),
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(S),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "12",
        "EVAL.TEST_EPISODE_COUNT", str(EPISODES), "EVAL.EVAL_CKPT_PATH", ckpt,
        "CHECKPOINT_INTERVAL", "1", "LOG_INTERVAL", "1", *extra]


def _cli(main, root, task, run_type, opts, port=False):
    """One run of a CLI: the RL runs in noise-free envs, the VO runs on the
    noisy dataset keys."""
    dev = ["--device", "cpu"] if port else []
    return main(["--task-type", task, "--run-type", run_type, "--exp-config",
                 RL_YAML if task == "rl" else VO_YAML, "--log-root", str(root),
                 "--noise", "0" if task == "rl" else "1", *dev] + opts)


def _last_run(root, prefix):
    return sorted(glob.glob(os.path.join(str(root), prefix + "*")))[-1]


def _eval_outputs(run_dir, stem):
    with open(os.path.join(run_dir, "infos", "eval_infos.p"), "rb") as f:
        agg = {k: v[-1] for k, v in pickle.load(f).items()}
    with open(os.path.join(run_dir, "infos", f"{stem}.infos.p"), "rb") as f:
        episodes = pickle.load(f)
    return agg, episodes


def _assert_eval_matches(got, want, vo=True):
    """``test_evaluator_run_matches_jax``'s rules: exact counts, success
    and spl; rtol 1e-4 on the float metrics (the VO ones too where a VO
    ran); equal per-episode steps."""
    (gagg, geps), (wagg, weps) = got, want
    assert set(gagg) == set(wagg)
    for key in ("episodes", "success", "spl", "total_env_steps", "stuck_dx", "stuck_dz",
                "stuck_both"):
        assert gagg[key] == wagg[key], key
    for key in (("vo_l2_mean", "global_drift_mean") if vo else ()) + (
            "softspl", "distance_to_goal", "reward"):
        np.testing.assert_allclose(gagg[key], wagg[key], rtol=1e-4, err_msg=key)
    assert [e["steps"] for e in geps] == [e["steps"] for e in weps]
    assert [e["success"] for e in geps] == [e["success"] for e in weps]


@pytest.fixture(scope="module")
def rl_eval_runs(weights, tmp_path_factory):
    """The same published-format policy and experts through both CLIs."""
    root = tmp_path_factory.mktemp("rl_eval")
    opts = _rl_opts(weights["paths"], weights["paths"]["policy"])
    _cli(jrun.main, root / "jax", "rl", "eval", opts)
    metrics = _cli(trun.main, root / "port", "rl", "eval", opts, port=True)
    return (_eval_outputs(_last_run(root / "port", "rl-eval"), "rl_policy"),
            _eval_outputs(_last_run(root / "jax", "rl-eval"), "rl_policy"), metrics)


def test_rl_eval_cli_matches_jax(rl_eval_runs):
    got, want, metrics = rl_eval_runs
    _assert_eval_matches(got, want)
    assert got[0]["episodes"] == EPISODES and metrics["episodes"] == EPISODES
    # the episodes really navigated: more steps than one per episode
    assert got[0]["total_env_steps"] > 2 * EPISODES


@pytest.fixture(scope="module")
def rl_train_run(weights, tmp_path_factory, request):
    """Two updates of 4 steps over 2 envs through the port's CLI, with the
    pretrained experts in the loop and a checkpoint every update."""
    root = tmp_path_factory.mktemp("rl_train")
    opts = _rl_opts(weights["paths"], "", ("NUM_UPDATES", "2", "RL.TUNE_WITH_VO", "True"))
    trainer = _cli(trun.main, root, "rl", "train", opts, port=True)
    ckpt_dir = os.path.join(_last_run(root, "rl-train"), "checkpoints")
    return {"root": root, "opts": opts, "trainer": trainer, "ckpt_dir": ckpt_dir}


def test_rl_train_cli_writes_checkpoints_under_jax_names(rl_train_run):
    names = sorted(os.listdir(rl_train_run["ckpt_dir"]))
    assert names == ["ckpt_0.update_0.frames_8.pth", "ckpt_1.update_1.frames_16.pth"]
    pattern = re.compile(r"ckpt_(\d+)\.update_(\d+)\.frames_(\d+)\.pth")
    state = load_checkpoint(os.path.join(rl_train_run["ckpt_dir"], names[-1]))
    assert [tuple(map(int, pattern.fullmatch(n).groups())) for n in names] == [(0, 0, 8),
                                                                               (1, 1, 16)]
    assert state["update"] == 1 and state["count_steps"] == 16
    assert state["engine_name"] == "efficient_ddppo"
    assert state["full_config"]["RL"]["PPO"]["hidden_size"] == HIDDEN
    assert all(k.startswith("actor_critic.") for k in state["state_dict"])
    assert rl_train_run["trainer"].update_idx == 2


def test_jax_pth_eval_of_port_checkpoint_matches_port_eval(rl_train_run, tmp_path):
    """The JAX engine's ``.pth`` eval path reads the port's checkpoint and
    scores it as the port's eval does.  The checkpoint's STOP logit is
    lowered first (a port checkpoint still), so its episodes move."""
    state = load_checkpoint(os.path.join(rl_train_run["ckpt_dir"],
                                         "ckpt_1.update_1.frames_16.pth"))
    state["state_dict"]["actor_critic.action_distribution.linear.bias"] = torch.tensor(
        [-2.0, 0.3, 0.0, 0.0])
    ckpt = str(tmp_path / "ckpt_1.update_1.frames_16.pth")
    save_checkpoint(ckpt, state)
    opts = rl_train_run["opts"] + ["EVAL.EVAL_CKPT_PATH", ckpt]
    _cli(jrun.main, tmp_path / "jax", "rl", "eval", opts)
    _cli(trun.main, tmp_path / "port", "rl", "eval", opts, port=True)
    stem = "ckpt_1.update_1.frames_16"
    got = _eval_outputs(_last_run(tmp_path / "port", "rl-eval"), stem)
    _assert_eval_matches(got, _eval_outputs(_last_run(tmp_path / "jax", "rl-eval"), stem))
    assert got[0]["total_env_steps"] > 2 * EPISODES


def test_rl_resume_continues_at_saved_update(rl_train_run, tmp_path):
    ckpt = os.path.join(rl_train_run["ckpt_dir"], "ckpt_1.update_1.frames_16.pth")
    opts = rl_train_run["opts"] + ["NUM_UPDATES", "3", "RESUME_TRAIN", "True",
                                   "RESUME_STATE_FILE", ckpt]
    saved = load_checkpoint(ckpt)
    trainer = _cli(trun.main, tmp_path, "rl", "train", opts, port=True)
    # starts at the stored update (1), as the JAX engine does, and runs to 3
    assert trainer.update_idx == 3
    assert trainer.count_steps == saved["count_steps"] + 2 * 8
    assert trainer.optimizer.count == saved["optimizer"]["count"] + 2 * 2
    names = sorted(os.listdir(os.path.join(_last_run(tmp_path, "rl-train"), "checkpoints")))
    assert names == ["ckpt_1.update_1.frames_24.pth", "ckpt_2.update_2.frames_32.pth"]


def _cuda_generator_state(path, out, bare=False):
    """``path`` with its generator entry replaced by a 16-byte state of a
    CUDA generator (one saved on the card), written to ``out``."""
    state = load_checkpoint(path)
    cuda_state = torch.zeros(16, dtype=torch.uint8)
    state["generator"] = cuda_state if bare else {"device": "cuda", "state": cuda_state}
    save_checkpoint(str(out), state)
    return str(out)


def test_restore_generator_across_device_types(caplog):
    """A CPU generator does not take a CUDA generator's 16-byte state: it is
    seeded afresh from the given seed instead, with one log line."""
    with pytest.raises(RuntimeError):
        torch.Generator().set_state(torch.zeros(16, dtype=torch.uint8))
    fresh = torch.Generator().manual_seed(9)
    for saved in ({"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)},
                  torch.zeros(16, dtype=torch.uint8)):
        g = torch.Generator().manual_seed(1)
        torch.rand(3, generator=g)
        with caplog.at_level(logging.WARNING):
            assert not restore_generator(g, saved, seed=9)
        assert torch.equal(g.get_state(), fresh.get_state())
    assert sum("seeded afresh from 9" in r.getMessage() for r in caplog.records) == 2
    g = torch.Generator().manual_seed(4)
    saved = generator_state(g)
    want = torch.rand(5, generator=g)
    assert restore_generator(g, saved, seed=9) and torch.equal(torch.rand(5, generator=g), want)


def test_rl_resume_across_device_types(rl_train_run, tmp_path):
    """A checkpoint whose generator state came from the card resumes on the
    CPU at its stored update and env steps."""
    src = os.path.join(rl_train_run["ckpt_dir"], "ckpt_1.update_1.frames_16.pth")
    ckpt = _cuda_generator_state(src, tmp_path / "card.pth")
    opts = rl_train_run["opts"] + ["NUM_UPDATES", "2", "RESUME_TRAIN", "True",
                                   "RESUME_STATE_FILE", ckpt]
    trainer = _cli(trun.main, tmp_path, "rl", "train", opts, port=True)
    assert trainer.update_idx == 2 and trainer.count_steps == 16 + 8
    names = os.listdir(os.path.join(_last_run(tmp_path, "rl-train"), "checkpoints"))
    assert names == ["ckpt_1.update_1.frames_24.pth"]


def test_rl_preemption_saves_interrupted_state_and_returns(rl_train_run, tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(preemption, "INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    preemption.reset_for_tests()
    preemption.EXIT.set()
    try:
        trainer = _cli(trun.main, tmp_path, "rl", "train", rl_train_run["opts"], port=True)
    finally:
        preemption.reset_for_tests()
    state = load_checkpoint(preemption.interrupted_state_path())
    assert trainer.update_idx == 0 and trainer.count_steps == 0
    assert state["update"] == 0 and state["count_steps"] == 0
    assert os.listdir(os.path.join(_last_run(tmp_path, "rl-train"), "checkpoints")) == []
    # and it resumes from there
    opts = rl_train_run["opts"] + ["NUM_UPDATES", "1", "RESUME_TRAIN", "True",
                                   "RESUME_STATE_FILE", preemption.interrupted_state_path()]
    assert _cli(trun.main, tmp_path / "resumed", "rl", "train", opts,
                port=True).update_idx == 1


# ---------------------------------------------------------------- the eval's options


_BASELINE_SENSORS = [x for s in ("DEPTH", "RGB") for side in ("HEIGHT", "WIDTH")
                     for x in (f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{side}", str(BASELINE_S))]
# name -> (the options, the policy checkpoint: one key of the weights'
# paths, or a "<key>_" whose "_jax" and "_port" files each CLI gets)
_RL_OPTIONS = {
    "video": (["VIDEO_OPTION", "[disk]"], "policy"),
    "ranked_images": (["EVAL.SAVE_RANKED_IMGS", "True", "EVAL.RANK_TOP_K", "3"], "policy"),
    "gps_only_eval": (["VO.USE_VO_MODEL", "False"], "policy"),
    "shm_backend": (["ENV_BACKEND", "shm"], "policy"),
    "habitat_backend": (["ENV_BACKEND", "habitat"], "policy"),  # tests/fake_habitat.py
    "classical_vo": (["VO.VO_TYPE", "CLASSICAL"], "policy"),
    "gru": (["RL.Policy.rnn_backbone", "GRU"], "gru"),
    "rgbd_policy": (["RL.Policy.visual_types", "[rgb, depth]"], "rgbd"),
    # GPS-only: the VO experts are sized for the other cases' 32x32 frames
    "baseline_policy": (["RL.Policy.name", "pointnav_baseline_policy",
                         "VO.USE_VO_MODEL", "False", *_BASELINE_SENSORS], "baseline_"),
}


@pytest.mark.parametrize("name", sorted(_RL_OPTIONS))
def test_rl_eval_option_matches_jax(name, weights, tmp_path, monkeypatch):
    """Each option through both CLIs on the same exported weights: the same
    metrics, and the same videos or ranked images on disk."""
    if name == "habitat_backend":
        monkeypatch.setitem(sys.modules, "habitat", fake_habitat)
    extra, key = _RL_OPTIONS[name]
    paths = weights["paths"]
    ckpt = {side: paths[key + side if key.endswith("_") else key] for side in ("jax", "port")}
    _cli(jrun.main, tmp_path / "jax", "rl", "eval", _rl_opts(paths, ckpt["jax"]) + extra)
    metrics = _cli(trun.main, tmp_path / "port", "rl", "eval",
                   _rl_opts(paths, ckpt["port"]) + extra, port=True)
    runs = {side: _last_run(tmp_path / side, "rl-eval") for side in ("port", "jax")}
    got, want = (_eval_outputs(runs[side], os.path.splitext(os.path.basename(ckpt[side]))[0])
                 for side in ("port", "jax"))
    _assert_eval_matches(got, want, vo=name not in ("gps_only_eval", "baseline_policy"))
    assert metrics["episodes"] == EPISODES and got[0]["total_env_steps"] > 2 * EPISODES
    if name == "gps_only_eval":
        assert "vo_l2_mean" not in got[0] and got[0]["time_act_s"] > 0
    if name in ("video", "ranked_images"):
        sub = "videos" if name == "video" else os.path.join("infos", "ranked_imgs")
        files = {side: sorted(os.listdir(os.path.join(runs[side], sub))) for side in runs}
        assert files["port"] and len(files["port"]) == len(files["jax"])
        if name == "video":
            assert files["port"] == files["jax"]
            assert all(os.path.getsize(os.path.join(runs["port"], sub, f)) > 0
                       for f in files["port"])
        else:
            assert len(files["port"]) == 3 + 1  # the top 3 and the manifest


def test_rl_train_and_resume_rgbd_policy_carries_whitening(weights, tmp_path):
    """``RL.Policy.visual_types [rgb, depth]`` through the port's train CLI:
    the checkpoint carries the whitening buffers, advanced by every frame of
    the rollout (2 envs x 4 steps) and read by the JAX package's ``.pth``
    loader; the resumed run restores them and advances them again over the
    two updates it runs (it restarts at the stored update, 0)."""
    rmv = POLICY_PREFIX + "net.visual_encoder.running_mean_and_var."
    opts = _rl_opts(weights["paths"], "", ("NUM_UPDATES", "1", "RL.TUNE_WITH_VO", "True",
                                           "RL.Policy.visual_types", "[rgb, depth]"))
    _cli(trun.main, tmp_path / "a", "rl", "train", opts, port=True)
    ckpt = os.path.join(_last_run(tmp_path / "a", "rl-train"), "checkpoints",
                        "ckpt_0.update_0.frames_8.pth")
    sd = load_checkpoint(ckpt)["state_dict"]
    assert float(sd[rmv + "_count"]) == 8.0
    assert sd[rmv + "_mean"].shape == (1, 4, 1, 1) and bool((sd[rmv + "_var"] > 0).all())
    stats = jimport.load_policy_checkpoint(ckpt)["batch_stats"]["visual_encoder"]["rmv"]
    np.testing.assert_array_equal(stats["mean"], sd[rmv + "_mean"].numpy().reshape(-1))
    np.testing.assert_array_equal(stats["count"], sd[rmv + "_count"].numpy())
    resumed = _cli(trun.main, tmp_path / "b", "rl", "train",
                   opts + ["NUM_UPDATES", "2", "RESUME_TRAIN", "True", "RESUME_STATE_FILE",
                           ckpt], port=True)
    buffers = resumed.model.net.visual_encoder.running_mean_and_var
    assert resumed.update_idx == 2 and float(buffers._count) == 8.0 + 2 * 8
    assert not torch.equal(buffers._mean.cpu(), sd[rmv + "_mean"])


def test_rl_train_update_over_shm_equals_sync(weights, tmp_path):
    """One CLI update over ``ENV_BACKEND shm`` (2 scripted process workers,
    VO in the loop) writes the checkpoint the in-process envs write."""
    opts = _rl_opts(weights["paths"], "", ("NUM_UPDATES", "1", "RL.TUNE_WITH_VO", "True"))
    states = {}
    for backend in ("sync", "shm"):
        trainer = _cli(trun.main, tmp_path / backend, "rl", "train",
                       opts + ["ENV_BACKEND", backend], port=True)
        assert trainer.update_idx == 1 and trainer.count_steps == 8
        states[backend] = load_checkpoint(os.path.join(
            _last_run(tmp_path / backend, "rl-train"), "checkpoints",
            "ckpt_0.update_0.frames_8.pth"))["state_dict"]
    assert states["shm"].keys() == states["sync"].keys()
    for k, v in states["sync"].items():
        assert torch.equal(states["shm"][k], v), k


# ---------------------------------------------------------------- VO CLI


def _vo_train_eval(root, data, model_opts):
    """One epoch from the same ``.pth`` expert, then eval from the
    checkpoint, through both CLIs."""
    train_opts = [
        "VO.VIS_SIZE_W", str(S), "VO.VIS_SIZE_H", str(S), "VO.MODEL.hidden_size", str(HIDDEN),
        "VO.MODEL.dropout_p", "0.0", "VO.MODEL.pretrained", "True",
        "VO.TRAIN.batch_size", "8", "VO.TRAIN.epochs", "1",
        "VO.DATASET.TRAIN_WITH_NOISE", data, "VO.DATASET.EVAL_WITH_NOISE", data,
        "LOG_INTERVAL", "1", *model_opts]
    out = {}
    for name, main, port, ext in (("jax", jrun.main, False, "pkl"),
                                  ("port", trun.main, True, "pth")):
        _cli(main, root / name, "vo", "train", train_opts, port=port)
        run_dir = _last_run(root / name, "vo-train")
        with open(os.path.join(run_dir, "infos", "train_infos.jsonl")) as f:
            train_stats = f.read().splitlines()
        ckpt = os.path.join(run_dir, "checkpoints", f"ckpt_epoch_1.{ext}")
        # the live eval config holds only the checkpoint and the data: the
        # model's size (32, not the default 512) comes from the checkpoint
        metrics = _cli(main, root / name, "vo", "eval",
                       ["EVAL.EVAL_CKPT_PATH", ckpt, "VO.DATASET.EVAL_WITH_NOISE", data],
                       port=port)
        # the JAX driver returns nothing: read its record, which lands in
        # the INFO_DIR of the config stored in the checkpoint (the train run's)
        with open(os.path.join(run_dir, "infos", "eval_regression_info.p"), "rb") as f:
            record = {k: v[-1] for k, v in pickle.load(f).items()}
        if metrics is None:
            metrics = record
        assert record == metrics
        out[name] = {"train": json.loads(train_stats[-1]), "eval": metrics, "ckpt": ckpt}
    return out


@pytest.fixture(scope="module")
def vo_data(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("vo_data") / "pairs.h5")
    generate_scripted_dataset(data, 40, env_cfg=JEnvConfig(image_h=S, image_w=S,
                                                           max_episode_steps=40), seed=0)
    return data


@pytest.fixture(scope="module")
def vo_runs(weights, vo_data, tmp_path_factory):
    """The forward stage from the same ``.pth`` expert, both CLIs."""
    return _vo_train_eval(tmp_path_factory.mktemp("vo"), vo_data, [
        "VO.MODEL.pretrained_ckpt", f"{{forward: {weights['paths']['forward']}}}",
        "VO.TRAIN.action_type", "1"])


VO_RTOL = 1e-4  # fp32 conv and GroupNorm sums in another order, one epoch of Adam


def test_vo_cli_epoch_loss_matches_jax(vo_runs):
    got, want = vo_runs["port"]["train"], vo_runs["jax"]["train"]
    assert got["epoch"] == want["epoch"] == 1
    np.testing.assert_allclose(got["mean_total_loss"], want["mean_total_loss"], rtol=VO_RTOL)
    for k in ("eval_abs_diff_dx", "eval_abs_diff_dz", "eval_abs_diff_dyaw"):
        np.testing.assert_allclose(got[k], want[k], rtol=VO_RTOL, err_msg=k)


def test_vo_cli_eval_from_checkpoint_matches_jax(vo_runs):
    got, want = vo_runs["port"]["eval"], vo_runs["jax"]["eval"]
    assert got["eval_samples"] == want["eval_samples"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=VO_RTOL, err_msg=k)
    state = load_checkpoint(vo_runs["port"]["ckpt"])
    assert state["engine_name"] == "vo_cnn_regression_geo_invariance_engine"
    assert state["full_config"]["VO"]["MODEL"]["hidden_size"] == HIDDEN and state["epoch"] == 1


@pytest.mark.parametrize("bare", [False, True])
def test_vo_resume_across_device_types(vo_runs, tmp_path, bare):
    """The VO checkpoint with a card's generator state (beside its device
    type, or bare) resumes on the CPU at its stored epoch."""
    ckpt = _cuda_generator_state(vo_runs["port"]["ckpt"], tmp_path / "ckpt_epoch_1.pth", bare)
    engine = _cli(trun.main, tmp_path, "vo", "train",
                  ["RESUME_TRAIN", "True", "RESUME_STATE_FILE", ckpt, "VO.TRAIN.epochs", "2"],
                  port=True)
    assert engine.epoch == 2
    assert int(engine.opt.state_dict()["state"][0]["step"]) == 2 * int(
        load_checkpoint(ckpt)["optimizer"]["state"][0]["step"])


def test_vo_eval_across_device_types(vo_runs, tmp_path):
    """Eval from that checkpoint loads the experts only: the same metrics as
    eval from the untouched file."""
    ckpt = _cuda_generator_state(vo_runs["port"]["ckpt"], tmp_path / "ckpt_epoch_1.pth")
    data = load_checkpoint(ckpt)["full_config"]["VO"]["DATASET"]["EVAL_WITH_NOISE"]
    metrics = _cli(trun.main, tmp_path, "vo", "eval",
                   ["EVAL.EVAL_CKPT_PATH", ckpt, "VO.DATASET.EVAL_WITH_NOISE", data], port=True)
    assert metrics == vo_runs["port"]["eval"]


def test_port_vo_checkpoint_loads_as_an_expert(vo_runs):
    """The port's own VO training checkpoint feeds the VO loader (and so
    ``all_pretrained_ckpt``): the expert of its ``action_type``."""
    ckpt = vo_runs["port"]["ckpt"]
    want = load_checkpoint(ckpt)["experts"][0]
    for act_idx in (None, 1):
        sd = load_vo_checkpoint(ckpt, act_idx)
        assert sd.keys() == want.keys() and all(torch.equal(sd[k], v) for k, v in want.items())
    with pytest.raises(ValueError, match=r"actions \[1\]"):
        load_vo_checkpoint(ckpt, 2)
    model = VOInferenceConfig(vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN).make_model()
    model.load_state_dict(load_vo_checkpoint(ckpt, 1), strict=True)


# ---------------------------------------------------------------- VO diagnostics


def _tb_histograms(run_dir):
    """``{tag: [(step, HistogramProto), ...]}`` of a run's TensorBoard event
    files, read with tensorboardX's protobufs (TFRecord framing: length,
    its checksum, the event, its checksum; the checksums are skipped)."""
    from tensorboardX.proto import event_pb2

    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "tb", "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                if v.HasField("histo"):
                    out.setdefault(v.tag, []).append((event.step, v.histo))
    return out


@pytest.fixture(scope="module")
def vo_diag_runs(weights, vo_data, tmp_path_factory):
    """The forward stage from the same ``.pth`` expert with 2 decode
    workers and the gradient diagnostics, both CLIs."""
    root = tmp_path_factory.mktemp("vo_diag")
    runs = _vo_train_eval(root, vo_data, [
        "VO.MODEL.pretrained_ckpt", f"{{forward: {weights['paths']['forward']}}}",
        "VO.TRAIN.action_type", "1", "VO.TRAIN.decode_workers", "2",
        "VO.TRAIN.log_grad", "True"])
    for name, run in runs.items():
        run["tb"] = _tb_histograms(_last_run(root / name, "vo-train"))
    return runs


_GRAD_NORMS = {"grad/global_norm", "grad/visual_encoder_norm", "grad/visual_fc_norm",
               "grad/output_head_norm"}


def test_vo_cli_decode_workers_and_log_grad_match_jax(vo_diag_runs):
    """The epoch's stream from the two decode workers, the last logged
    gradient norms, and eval, within the VO CLI's tolerance."""
    got, want = vo_diag_runs["port"]["train"], vo_diag_runs["jax"]["train"]
    assert {k for k in want if k.startswith("grad/")} == _GRAD_NORMS
    assert {k for k in got if k.startswith("grad/")} == _GRAD_NORMS
    assert got["epoch"] == want["epoch"] == 1
    for k in sorted(_GRAD_NORMS) + ["mean_total_loss", "eval_abs_diff_dx", "eval_abs_diff_dz",
                                    "eval_abs_diff_dyaw"]:
        np.testing.assert_allclose(got[k], want[k], rtol=VO_RTOL, err_msg=k)
        assert got[k] > 0, k


def test_vo_cli_log_grad_writes_a_histogram_a_parameter(vo_diag_runs):
    """One ``grad/{name}`` histogram a parameter in the epoch, each of
    JAX's parameter's values: the same count and L2 norm (rtol 1e-3, the
    gradient tolerance of the VO training tests)."""
    got, want = vo_diag_runs["port"]["tb"], vo_diag_runs["jax"]["tb"]
    sd = load_checkpoint(vo_diag_runs["port"]["ckpt"])["experts"][0]
    names = [k for k in sd if ".running_mean_and_var." not in k]
    assert sorted(got) == sorted(f"grad/{n}" for n in names)
    assert len(want) == len(got)
    for n in names:
        (step, h), = got[f"grad/{n}"]
        (jstep, jh), = want["grad/" + "/".join(_vo_param_path(n)[0])]
        assert step == jstep == 1 and h.num == jh.num == sd[n].numel(), n
        np.testing.assert_allclose(np.sqrt(h.sum_squares), np.sqrt(jh.sum_squares), rtol=1e-3,
                                   atol=1e-9, err_msg=n)
        assert h.sum_squares > 0, n


# ---------------------------------------------------------------- the zoo


@pytest.fixture(scope="module")
def zoo_weights(tmp_path_factory):
    """JAX-initialised ResNet-50 experts and a unified act-embed model,
    written as reference ``.pth`` files by the JAX exporter."""
    d = tmp_path_factory.mktemp("zoo_weights")
    _, experts = _jax_experts(backbone="resnet50")
    paths = {"forward": str(d / "act_forward_r50.pth"),
             "left_right": str(d / "act_left_right_r50.pth"),
             "act_embed": str(d / "act_embed.pth")}
    save_vo_checkpoint_torch(paths["forward"], {1: experts[0]})
    save_vo_checkpoint_torch(paths["left_right"], {2: experts[1], 3: experts[2]})
    model = JCfg(model_name="vo_cnn_act_embed", observation_space=("rgb", "depth"),
                 vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN).make_model()
    dummy = {"rgb": jnp.zeros((1, S, S, 6)), "depth": jnp.zeros((1, S, S, 2))}
    save_vo_checkpoint_torch(paths["act_embed"], jax.tree.map(np.asarray, fast_init(
        model, dummy, jnp.zeros((1,), jnp.int32), train=False, seed=20)))
    return paths


def test_rl_eval_cli_on_a_zoo_backbone_with_obs_transform_matches_jax(weights, zoo_weights,
                                                                        tmp_path):
    """ResNet-50 experts behind ``VO.OBS_TRANSFORM resize``: 48x48 sensors,
    resized to the experts' 32x32, through both CLIs on the same ``.pth``
    files."""
    paths = dict(weights["paths"], forward=zoo_weights["forward"],
                 left_right=zoo_weights["left_right"])
    sensors = [f"TASK_CONFIG.SIMULATOR.{sensor}_SENSOR.{side}" for sensor in ("DEPTH", "RGB")
               for side in ("HEIGHT", "WIDTH")]
    opts = _rl_opts(paths, weights["paths"]["policy"]) + [
        "VO.REGRESS_MODEL.visual_backbone", "resnet50", "VO.OBS_TRANSFORM", "resize",
        *[x for key in sensors for x in (key, "48")]]
    _cli(jrun.main, tmp_path / "jax", "rl", "eval", opts)
    metrics = _cli(trun.main, tmp_path / "port", "rl", "eval", opts, port=True)
    got, want = (_eval_outputs(_last_run(tmp_path / side, "rl-eval"), "rl_policy")
                 for side in ("port", "jax"))
    _assert_eval_matches(got, want)
    assert metrics["episodes"] == EPISODES and got[0]["total_env_steps"] > 2 * EPISODES


@pytest.fixture(scope="module")
def vo_act_embed_runs(zoo_weights, vo_data, tmp_path_factory):
    """The unified act-embed model (``action_type -1``, rgb and depth) from
    the same ``.pth``, both CLIs."""
    return _vo_train_eval(tmp_path_factory.mktemp("vo_act_embed"), vo_data, [
        "VO.MODEL.name", "vo_cnn_act_embed", "VO.MODEL.visual_type", "[rgb, depth]",
        "VO.MODEL.pretrained_ckpt", f"{{forward: {zoo_weights['act_embed']}}}",
        "VO.TRAIN.action_type", "-1"])


def test_vo_cli_act_embed_unified_matches_jax(vo_act_embed_runs):
    got, want = vo_act_embed_runs["port"], vo_act_embed_runs["jax"]
    np.testing.assert_allclose(got["train"]["mean_total_loss"], want["train"]["mean_total_loss"],
                               rtol=VO_RTOL)
    assert got["eval"]["eval_samples"] == want["eval"]["eval_samples"]
    assert {k for k in want["eval"] if k.startswith("act")} == {
        f"act{a}/abs_diff_{d}" for a in (1, 2, 3) for d in ("dx", "dz", "dyaw")}
    for k in want["eval"]:
        np.testing.assert_allclose(got["eval"][k], want["eval"][k], rtol=VO_RTOL, err_msg=k)
    state = load_checkpoint(got["ckpt"])
    assert state["train_config"]["action_type"] == -1
    assert "action_embedding.weight" in state["experts"][0]


# ---------------------------------------------------------------- sweep


def _poll_engine(opts):
    eng = object.__new__(tengines._BaseRLEngine)
    eng.config = get_rl_config(opts=opts)
    eng.logger = logging.getLogger("test_poll")
    return eng


def test_eval_waits_for_checkpoints(tmp_path):
    """WAIT_FOR_CKPTS > 0: the sweep polls the folder until that many
    checkpoints are evaluated, picking up files written after it starts,
    in mtime order."""
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    (ckpt_dir / "ckpt_0.pth").write_bytes(b"placeholder")
    eng = _poll_engine(["EVAL.EVAL_CKPT_PATH", str(ckpt_dir), "EVAL.WAIT_FOR_CKPTS", "3",
                        "EVAL.CKPT_POLL_INTERVAL_S", "0.05"])
    evaluated = []
    eng._eval_checkpoint = lambda p, n=None: evaluated.append(p) or {"ok": 1.0}

    def trainer_writes():
        time.sleep(0.15)
        (ckpt_dir / "ckpt_1.pth").write_bytes(b"placeholder")
        (ckpt_dir / "ckpt_1.pth.tmp").write_bytes(b"half")  # an unfinished save
        time.sleep(0.15)
        (ckpt_dir / "ckpt_2.pth").write_bytes(b"placeholder")

    t = threading.Thread(target=trainer_writes)
    t.start()
    results = eng.eval()
    t.join(timeout=10)
    assert not t.is_alive()
    assert sorted(results) == ["ckpt_0.pth", "ckpt_1.pth", "ckpt_2.pth"]
    assert [os.path.basename(p) for p in evaluated] == ["ckpt_0.pth", "ckpt_1.pth",
                                                        "ckpt_2.pth"]


def test_eval_polling_abandons_corrupt_checkpoint(tmp_path):
    """A file that never loads, with stable mtime and size, is retried and
    then abandoned after 3 attempts; it counts toward WAIT_FOR_CKPTS."""
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    save_checkpoint(str(ckpt_dir / "ckpt_0.pth"), {"update": 0})
    (ckpt_dir / "ckpt_1.pth").write_bytes(b"corrupt-forever")
    eng = _poll_engine(["EVAL.EVAL_CKPT_PATH", str(ckpt_dir), "EVAL.WAIT_FOR_CKPTS", "2",
                        "EVAL.CKPT_POLL_INTERVAL_S", "0.01"])
    attempts = []

    def fake_eval(p, n=None):
        attempts.append(os.path.basename(p))
        return load_checkpoint(p)  # the real loader's error on the corrupt file

    eng._eval_checkpoint = fake_eval
    results = eng.eval()
    assert sorted(results) == ["ckpt_0.pth"]
    assert attempts.count("ckpt_1.pth") == 3
    with pytest.raises(UnreadableCheckpointError):
        load_checkpoint(str(ckpt_dir / "ckpt_1.pth"))


def test_eval_polling_gives_up_when_the_trainer_is_gone(tmp_path):
    """No new checkpoint for CKPT_STALE_TIMEOUT_S: the sweep returns what it
    has.  As in the JAX engine, any unevaluated file (even one that keeps
    failing) counts as progress and refreshes the guard; only an empty
    listing lets it expire."""
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    (ckpt_dir / "ckpt_0.pth").write_bytes(b"placeholder")
    eng = _poll_engine(["EVAL.EVAL_CKPT_PATH", str(ckpt_dir), "EVAL.WAIT_FOR_CKPTS", "5",
                        "EVAL.CKPT_POLL_INTERVAL_S", "0.02",
                        "EVAL.CKPT_STALE_TIMEOUT_S", "0.2"])
    eng._eval_checkpoint = lambda p, n=None: {"ok": 1.0}
    t0 = time.monotonic()
    results = eng.eval()
    assert sorted(results) == ["ckpt_0.pth"]
    assert 0.2 <= time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------- merge


def _merge_ckpt(tmp_path, cfg, name="ckpt_0.pth"):
    path = str(tmp_path / name)
    save_checkpoint(path, {"state_dict": {}, "full_config": cfg.to_dict()})
    return path


def _eval_engine(cfg):
    return tengines.EfficientDDPPOEngine(cfg, run_type="eval", device="cpu")


def test_four_level_merge_priority(tmp_path):
    train_cfg = get_rl_config(opts=["RL.PPO.entropy_coef", "0.05", "RL.PPO.lr", "0.001"])
    train_cfg.NUM_UPDATES = 777  # ckpt_cfg only
    ckpt = _merge_ckpt(tmp_path, train_cfg)
    eval_cfg = get_rl_config(opts=["RL.PPO.lr", "0.002"])
    merged = _eval_engine(eval_cfg)._merged_eval_config(ckpt)
    assert merged.RL.PPO.lr == 0.002                        # eval_opts > ckpt_opts
    assert merged.RL.PPO.entropy_coef == 0.05               # ckpt_opts > eval_cfg
    assert merged.NUM_UPDATES == eval_cfg.NUM_UPDATES != 777  # eval_cfg > ckpt_cfg


def test_merge_never_evals_on_train_split(tmp_path):
    train_cfg = get_rl_config()
    train_cfg.TASK_CONFIG.DATASET.SPLIT = "train"
    ckpt = _merge_ckpt(tmp_path, train_cfg)
    eval_cfg = get_rl_config()
    eval_cfg.TASK_CONFIG.DATASET.SPLIT = "train"
    assert _eval_engine(eval_cfg)._merged_eval_config(ckpt).TASK_CONFIG.DATASET.SPLIT == "val"


def test_merge_without_stored_config_returns_live(tmp_path):
    path = str(tmp_path / "ckpt_1.pth")
    save_checkpoint(path, {"state_dict": {}})
    eval_cfg = get_rl_config()
    assert _eval_engine(eval_cfg)._merged_eval_config(path) is eval_cfg


def test_outdated_ckpt_opts_are_skipped(tmp_path):
    train_cfg = get_rl_config()
    train_cfg.CMD_TRAILING_OPTS = ["SOME.REMOVED.KEY", "1"]
    ckpt = _merge_ckpt(tmp_path, train_cfg)
    merged = _eval_engine(get_rl_config(opts=["RL.PPO.lr", "0.003"]))._merged_eval_config(ckpt)
    assert merged.RL.PPO.lr == 0.003


# ---------------------------------------------------------------- async writer


def _state(seed: int):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
                       "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))},
            "step": seed, "rng": np.random.get_state()}


def test_async_save_matches_sync(tmp_path):
    state = _state(0)
    save_checkpoint(str(tmp_path / "sync.pth"), {**state, "epoch": 3})
    w = AsyncCheckpointWriter()
    w.save(str(tmp_path / "async.pth"), {**state, "epoch": 3})
    w.close()
    a, b = load_checkpoint(str(tmp_path / "sync.pth")), load_checkpoint(str(tmp_path / "async.pth"))
    assert a["epoch"] == b["epoch"] == 3 and a["step"] == b["step"] == 0
    assert torch.equal(a["params"]["w"], b["params"]["w"])
    np.testing.assert_array_equal(a["rng"][1], b["rng"][1])


def test_wait_means_durable_and_fifo(tmp_path):
    w = AsyncCheckpointWriter()
    paths = [str(tmp_path / f"ckpt_{i}.pth") for i in range(4)]
    for i, p in enumerate(paths):
        w.save(p, {**_state(i), "i": i})
    w.wait()
    for i, p in enumerate(paths):
        assert os.path.isfile(p) and not os.path.exists(p + ".tmp")
        state = load_checkpoint(p)
        assert state["i"] == i and state["step"] == i
    w.close()


def test_snapshot_taken_at_save_time(tmp_path):
    """The caller may rebind its values right after save()."""
    w = AsyncCheckpointWriter()
    state = {"x": torch.arange(4, dtype=torch.float32)}
    w.save(str(tmp_path / "snap.pth"), state)
    state["x"] = torch.zeros(4)
    w.close()
    assert torch.equal(load_checkpoint(str(tmp_path / "snap.pth"))["x"],
                       torch.arange(4, dtype=torch.float32))


def test_parameter_updated_in_place_after_save_does_not_change_the_file(tmp_path):
    """The engines' pattern: save, then the next optimizer step writes the
    same parameter storage in place while the writer thread serializes."""
    w = AsyncCheckpointWriter()
    p = torch.nn.Parameter(torch.arange(16, dtype=torch.float32) + 1.0)
    opt = torch.optim.SGD([p], lr=1.0)
    w.save(str(tmp_path / "inplace.pth"), {"p": p, "opt": opt.state_dict()})
    p.grad = torch.full_like(p, 7.0)
    opt.step()
    with torch.no_grad():
        p.mul_(0.0)
    w.close()
    assert torch.equal(load_checkpoint(str(tmp_path / "inplace.pth"))["p"],
                       torch.arange(16, dtype=torch.float32) + 1.0)


def test_context_manager_drains_on_exception(tmp_path):
    p = str(tmp_path / "ckpt_last.pth")
    with pytest.raises(ValueError, match="boom"):
        with AsyncCheckpointWriter() as w:
            w.save(p, {**_state(5), "i": 5})
            raise ValueError("boom")
    assert load_checkpoint(p)["i"] == 5


def test_drain_quietly_returns_error(tmp_path):
    w = AsyncCheckpointWriter()
    bad_dir = tmp_path / "not_a_dir"
    bad_dir.write_text("file, not directory")
    w.save(str(bad_dir / "ckpt.pth"), _state(0))
    assert isinstance(w.drain_quietly(), Exception)
    w.close()  # the error was consumed: close() does not raise it again


def test_write_error_surfaces(tmp_path):
    w = AsyncCheckpointWriter()
    bad_dir = tmp_path / "not_a_dir"
    bad_dir.write_text("file, not directory")
    w.save(str(bad_dir / "ckpt.pth"), _state(0))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()
    ok = str(tmp_path / "ok.pth")
    w.save(ok, _state(1))  # the writer stays usable
    w.close()
    assert os.path.isfile(ok)


def test_rng_bundle_round_trip(tmp_path):
    """The bundle restores Python's, numpy's and torch's CPU generators,
    also after a trip through a checkpoint file."""
    path = str(tmp_path / "rng.pth")
    save_checkpoint(path, {"host_rng": rng_state_bundle()})
    bundle = rng_state_bundle()

    def draw():
        return random.random(), np.random.rand(3), torch.rand(3)

    first = draw()
    for b in (bundle, load_checkpoint(path)["host_rng"]):
        restore_rng_state(b)
        a, n, t = draw()
        assert a == first[0] and np.array_equal(n, first[1]) and torch.equal(t, first[2])


def test_latest_checkpoint_matches_jax(tmp_path):
    from pointnav_vo_tpu.io.checkpoint import latest_checkpoint as j_latest_checkpoint

    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for i, name in enumerate(["ckpt_2.pth", "ckpt_10.pth", "ckpt_1.pth", "other.pth"]):
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_1.pth")
    assert j_latest_checkpoint(str(tmp_path)) == latest_checkpoint(str(tmp_path))


# ---------------------------------------------------------------- logging


def test_info_store_and_jsonl_match_jax(tmp_path):
    for mod, d in ((tlog, tmp_path / "port"), (jlog, tmp_path / "jax")):
        for i in range(3):
            mod.save_info_dict({"loss": [float(i)], "epoch": i}, str(d / "info.p"))
            mod.append_jsonl({"epoch": i, "loss": np.float32(i) / 2}, str(d / "infos.jsonl"))
    with open(tmp_path / "port" / "info.p", "rb") as f, open(tmp_path / "jax" / "info.p",
                                                            "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert got == want == {"loss": [0.0, 1.0, 2.0], "epoch": 2}
    assert ((tmp_path / "port" / "infos.jsonl").read_text()
            == (tmp_path / "jax" / "infos.jsonl").read_text())


def test_timing_accumulates_spans():
    timing = tlog.Timing()
    for _ in range(2):
        with timing.span("env"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with timing.span("act"):
            raise ValueError
    assert set(timing) == {"env", "act"} and timing["env"] >= 0.02


def test_tensorboard_writer_is_a_null_object(tmp_path, monkeypatch):
    """No log dir, or no ``tensorboardX`` (as on the card's machine): every
    call is a no-op and nothing is written."""
    with tlog.TensorboardWriter(None) as tb:
        assert tb.writer is None
        tb.add_scalar("x", 1.0, 0)
        tb.add_image("img", np.zeros((4, 4)), 0, dataformats="HW")
        tb.add_video_from_np_images("v", 0, [np.zeros((4, 4, 3), np.uint8)])
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises
    with tlog.TensorboardWriter(str(tmp_path / "tb")) as tb:
        assert tb.writer is None
        tb.add_scalar("x", 1.0, 0)
    assert not (tmp_path / "tb").exists()


def test_trace_writes_a_profiler_trace(tmp_path):
    with tlog.trace(None):
        torch.ones(4).add_(1)
    with tlog.trace(str(tmp_path / "trace")):
        torch.ones(4).add_(1)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_update_config_log_matches_jax(tmp_path):
    got = tlog.update_config_log(get_rl_config(), "eval", str(tmp_path / "run"))
    want = jlog.update_config_log(j_rl_config(), "eval", str(tmp_path / "run"))
    assert got.to_dict() == want.to_dict()
    assert got.LOG_FILE == str(tmp_path / "run" / "eval.log")
    assert all(os.path.isdir(got[k]) for k in ("INFO_DIR", "CHECKPOINT_FOLDER",
                                                 "TENSORBOARD_DIR", "VIDEO_DIR"))
    with pytest.raises(AttributeError, match="frozen"):
        got.SEED = 1


# ---------------------------------------------------------------- preemption


def test_preemption_flags_and_state(tmp_path, monkeypatch):
    monkeypatch.setattr(preemption, "INTERRUPTED_STATE_DIR", str(tmp_path))
    preemption.reset_for_tests()
    old = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1,
                                            signal.SIGUSR2)}
    try:
        preemption.install_signal_handlers()
        assert not preemption.should_exit()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert preemption.should_exit() and preemption.REQUEUE.is_set()
        path = preemption.save_interrupted_state({"x": torch.ones(3), "update": 7})
        assert os.path.isfile(path) and path.startswith(str(tmp_path))
        state = preemption.load_interrupted_state()
        assert torch.equal(state["x"], torch.ones(3)) and state["update"] == 7
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        preemption.reset_for_tests()
