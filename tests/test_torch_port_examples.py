"""Port parity, the pipeline drivers of ``pointnav_vo_tpu_torch/examples/``
and the launcher against the JAX package's ``examples/`` and ``launch.py``
(CPU, small sizes; the JAX drivers' functions run in process, never their
pipelines whole).

- the frame pairs the port's drivers train on (``iter_rollout_entries`` into
  ``MemoryFramePairs.from_rollout``, no ``h5py``) against the arrays of the
  JAX package's ``generate_scripted_dataset(seed=0)`` file read with
  ``h5py``: every entry bit for bit, every batch as the HDF5 reader yields
  it;
- the ladder's ``run_row`` against JAX's on the same farm seeds and
  JAX-exported float32 weights (policy 64x64, base 8, hidden 32; VO hidden
  32): metrics rtol 1e-4 (the evaluator's own tests' bound for float32
  sums in other orders), the episode set exact;
- the ladder's ``.part`` round trip, the idempotent stage, a relaunch after
  the GPS stage equal to an uninterrupted run, and the watchdog's exit 3;
- ``rl_tune_with_vo`` end to end at a tiny size, every key of the JAX
  record ``RL_TUNE_VO.json``;
- ``vis_trajectory``'s replayed paths against JAX's, from ground-truth
  deltas (exact) and through the same VO weights (rtol 1e-4);
- ``eval_habitat``'s preflight against JAX's over ``tests/fake_habitat.py``:
  the same checks in the same order, the same messages, the same parameter
  counts;
- the launcher's command against JAX's.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.io.torch_export import save_policy_checkpoint_torch, save_vo_checkpoint_torch
from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import stack_expert_variables

from pointnav_vo_tpu_torch import launch as tlaunch
from pointnav_vo_tpu_torch.examples import eval_994 as t994
from pointnav_vo_tpu_torch.examples import eval_994_ladder as tladder
from pointnav_vo_tpu_torch.examples import eval_habitat as thabitat
from pointnav_vo_tpu_torch.examples import rl_tune_with_vo as ttune
from pointnav_vo_tpu_torch.examples import vis_trajectory as tvis
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    seeded_init_,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

import fake_habitat
from _utils import fast_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 32
GOAL = "pointgoal_with_gps_compass"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the pairs


PAIRS_ENV = dict(image_h=24, image_w=32, max_episode_steps=30, actuation_noise_multiplier=0.5)


@pytest.fixture(scope="module")
def jax_pairs_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pairs") / "train.h5")
    jdataset.generate_scripted_dataset(path, 300, env_cfg=jenvs.EnvConfig(**PAIRS_ENV), seed=0)
    return path


def test_rollout_entries_equal_the_jax_file(jax_pairs_file):
    """Every array of every entry, bit for bit, in the file's order (two
    chunks of 256)."""
    import h5py

    got = list(tdataset.iter_rollout_entries(300, env_cfg=tenvs.EnvConfig(**PAIRS_ENV), seed=0))
    with h5py.File(jax_pairs_file, "r") as f:
        keys = sorted(f.keys(), key=lambda k: int(k.split("_")[-1]))
        want = {k: np.concatenate([f[c][k][()] for c in keys]) for k in f[keys[0]]}
    assert len(got) == 300 and set(got[0]) == set(want)
    for k, w in want.items():
        g = np.stack([e[k] for e in got])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("stage", ["forward", "joint"])
def test_memory_pairs_batch_as_the_jax_file_reads(jax_pairs_file, stage):
    """``eval_994.scripted_pairs`` (the drivers' pairs) batch as the HDF5
    reader yields the JAX file: frames, actions, twins and targets equal."""
    actions, twins, kw = {"forward": ((1,), False, dict(act_type=1)),
                          "joint": ((2, 3), True, dict(act_type=(2, 3), geo_invariance_types=(
                              "inverse_joint_train",)))}[stage]
    mem = t994.scripted_pairs(300, tenvs.EnvConfig(**PAIRS_ENV), seed=0).subset(actions, twins)
    reader = tdataset.FramePairReader(jax_pairs_file, PAIRS_ENV["image_w"], PAIRS_ENV["image_h"],
                                      **kw)
    assert mem.num_samples() == reader.num_samples() > 0
    n = 0
    for got, want in zip(mem.iter_batches(16), reader.iter_batches(16), strict=True):
        assert got.twins_packed == want.twins_packed
        for f in ("prev_rgb", "cur_rgb", "prev_depth", "cur_depth", "actions", "data_types",
                  "gt_delta"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        n += len(got.actions)
    assert n == reader.num_samples()


# ---------------------------------------------------------------- the ladder


ROW_SIZE = 64  # the ResNet policy's last stage needs a 2x2 map (test_torch_port_policy_bf16.py)
ROW_ENV = dict(image_h=ROW_SIZE, image_w=ROW_SIZE, max_episode_steps=10,
               actuation_noise_multiplier=0.5)


@pytest.fixture(scope="module")
def jax_ladder():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        return _load(os.path.join(REPO, "examples", "eval_994_ladder.py"), "jax_eval_994_ladder")
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))


@pytest.fixture(scope="module")
def row_models():
    """A float32 policy and three experts in both packages, the same
    weights."""
    jpol = JPolicy(image_size=(ROW_SIZE, ROW_SIZE), hidden_size=HIDDEN, baseplanes=8)
    obs = {"depth": jnp.zeros((1, ROW_SIZE, ROW_SIZE, 1)), GOAL: jnp.zeros((1, 2))}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
        seed=3))
    pvars["params"]["action_head"]["bias"] = np.asarray([-2.0, 0.3, 0.0, 0.0], np.float32)
    tpol = TPolicy(image_size=(ROW_SIZE, ROW_SIZE), hidden_size=HIDDEN, baseplanes=8)
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    jcfg = JCfg(vis_size_w=ROW_SIZE, vis_size_h=ROW_SIZE, hidden_size=HIDDEN)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, ROW_SIZE, ROW_SIZE, 6)),
             "depth": jnp.zeros((1, ROW_SIZE, ROW_SIZE, 2)),
             "discretized_depth": jnp.zeros((1, ROW_SIZE, ROW_SIZE, 20)),
             "top_down_view": jnp.zeros((1, ROW_SIZE, ROW_SIZE, 2))}
    stacked = stack_expert_variables([fast_init(model, dummy, train=False, seed=10 + i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    tcfg = TCfg(vis_size_w=ROW_SIZE, vis_size_h=ROW_SIZE, hidden_size=HIDDEN)
    return jpol, pvars, tpol, jcfg, stacked, tcfg, sds


@pytest.mark.parametrize("row", ["policy_vo", "oracle_gps"])
def test_ladder_run_row_matches_jax(jax_ladder, row_models, row):
    """One row over a fresh 2-worker farm in each package, 4 episodes: the
    metrics rtol 1e-4, the step percentiles equal, the port's counts
    checked by its run_row."""
    jpol, pvars, tpol, jcfg, stacked, tcfg, sds = row_models
    vo = row == "policy_vo"
    want = jax_ladder.run_row(row, model=jpol, variables=pvars,
                              ensemble=JEnsemble(jcfg, stacked) if vo else None,
                              env_cfg=jenvs.EnvConfig(**ROW_ENV), envs_n=2, episodes=4)
    got = tladder.run_row(row, model=tpol, ensemble=TEnsemble(tcfg, sds, device="cpu") if vo
                          else None, env_cfg=tenvs.EnvConfig(**ROW_ENV), envs_n=2, episodes=4,
                          device="cpu")
    assert got["distinct_episodes"] == 4 and got["bin_counts_launches"] is None
    assert set(got["metrics"]) >= set(want["metrics"]) - {"time_env_s", "time_device_s",
                                                           "time_transfer_s"}
    for k, w in want["metrics"].items():
        if k.startswith("time_"):
            continue
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["steps_pcts"] == want["steps_pcts"]
    assert ("drift_mean_pcts" in got) == ("drift_mean_pcts" in want) == vo


def _tiny_trainer(init_seed=0):
    cfg = tenvs.EnvConfig(image_h=ROW_SIZE, image_w=ROW_SIZE, max_episode_steps=12,
                          actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                          depth_noise_multiplier=0.0)
    policy = TPolicy(image_size=(ROW_SIZE, ROW_SIZE), hidden_size=HIDDEN, baseplanes=8,
                     num_recurrent_layers=1)
    pcfg = PPOConfig(num_steps=4, num_mini_batch=1, ppo_epoch=1, lr=2.5e-4, hidden_size=HIDDEN)
    return DDPPOTrainer(model=policy, ppo_cfg=pcfg, device="cpu", total_updates=6,
                        envs=tenvs.make_scripted_vector_env(cfg, 2, seed=7),
                        init_generator=torch.Generator().manual_seed(init_seed),
                        generator=torch.Generator().manual_seed(init_seed))


def test_ladder_part_round_trip(tmp_path):
    """A trainer restored from a ``.part`` checkpoint carries the saved
    parameters, Adam state, generator state and counters bit for bit."""
    part = str(tmp_path / "pol.pt.part")
    tr = _tiny_trainer()
    trend = []
    tladder.train_stage("gps", tr, 2, 0, trend, None, 0.0, 0.0)
    tladder.save_part(part, "gps", 2, tr, trend, 12.5)
    tr2 = _tiny_trainer(init_seed=99)  # another init on purpose
    ck = load_checkpoint(part)
    assert ck["stage"] == "gps" and ck["update"] == 2
    assert ck["t_accum"] == 12.5 and ck["reward_trend"] == trend
    tladder.restore_part(tr2, ck)
    for (k, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 2
    for i, s in sa["adam"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(s[k]), torch.as_tensor(sb["adam"]["state"][i][k]))
    assert torch.equal(tr.generator.get_state(), tr2.generator.get_state())
    assert (tr2.update_idx, tr2.count_steps) == (tr.update_idx, tr.count_steps) == (2, 16)


def test_ladder_completed_stage_is_a_no_op():
    """start == n_updates: a relaunch after the stage finished trains no
    further."""
    tr = _tiny_trainer()
    tladder.train_stage("gps", tr, 1, 0, [], None, 0.0, 0.0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tladder.train_stage("gps", tr, 1, 1, [], None, 0.0, 0.0)
    assert all(torch.equal(before[k], v) for k, v in tr.model.state_dict().items())
    assert tr.update_idx == 1


def test_ladder_relaunch_after_the_gps_stage_equals_one_run(tmp_path, monkeypatch):
    """``train_policy`` stopped in the tune stage leaves a ``gps_done``
    ``.part``; the relaunch skips the GPS stage and ends on the parameters
    of an uninterrupted run (bf16 policy, VO in the loop, the CPU)."""
    env_cfg = tenvs.EnvConfig(image_h=ROW_SIZE, image_w=ROW_SIZE, actuation_noise_multiplier=0.5)
    g = torch.Generator().manual_seed(0)
    vcfg = TCfg(vis_size_w=ROW_SIZE, vis_size_h=ROW_SIZE, hidden_size=HIDDEN)
    ensemble = TEnsemble(vcfg, experts=[seeded_init_(vcfg.make_model(), g) for _ in range(3)],
                         device="cpu")

    def args(cache):
        return tladder.build_parser().parse_args([
            "--gps-updates", "1", "--tune-updates", "1", "--train-envs", "2", "--num-steps",
            "3", "--policy-cache", str(tmp_path / cache), "--device", "cpu"])

    whole, _t, trend = tladder.train_policy(args("whole.pt"), env_cfg, ensemble, "cpu")
    assert [r["stage"] for r in trend] == ["gps", "tune_vo"]
    assert not os.path.exists(tmp_path / "whole.pt.part")

    real = tladder.train_stage

    class Stop(Exception):
        pass

    def stop_in_tune(stage, *a, **kw):
        if stage == "tune_vo":
            raise Stop
        return real(stage, *a, **kw)

    monkeypatch.setattr(tladder, "train_stage", stop_in_tune)
    with pytest.raises(Stop):
        tladder.train_policy(args("cut.pt"), env_cfg, ensemble, "cpu")
    assert load_checkpoint(str(tmp_path / "cut.pt.part"))["stage"] == "gps_done"
    ran = []

    def counted(stage, *a, **kw):
        ran.append(stage)
        return real(stage, *a, **kw)

    monkeypatch.setattr(tladder, "train_stage", counted)
    resumed, _t, trend2 = tladder.train_policy(args("cut.pt"), env_cfg, ensemble, "cpu")
    assert ran == ["tune_vo"] and trend2 == trend
    assert set(resumed) == set(whole)
    for k, v in whole.items():
        assert torch.equal(resumed[k], v), k
    assert not os.path.exists(tmp_path / "cut.pt.part")
    cached = load_checkpoint(str(tmp_path / "cut.pt"))  # a third launch reads the cache
    assert all(torch.equal(cached["state_dict"][k], v) for k, v in whole.items())


def test_ladder_watchdog_exits_3_on_stall():
    code = ("import time\n"
            "from pointnav_vo_tpu_torch.examples.eval_994_ladder import start_watchdog, beat\n"
            "beat(); start_watchdog(1)\n"
            "time.sleep(60)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 3, out.stdout + out.stderr
    assert "WATCHDOG" in out.stdout


# ---------------------------------------------------------------- rl_tune_with_vo


def test_rl_tune_pipeline_writes_every_key_of_the_jax_record(tmp_path):
    out = str(tmp_path / "tune.json")
    rec = ttune.main(["--device", "cpu", "--pairs", "300", "--epochs", "1", "--size", "64",
                      "--gps-updates", "1", "--tune-updates", "1", "--episodes", "2",
                      "--envs", "2", "--out", out])
    with open(os.path.join(REPO, "RL_TUNE_VO.json")) as f:
        want = json.load(f)
    with open(out) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(rec))
    assert set(want) <= set(got), set(want) - set(got)
    for row in ("gps_oracle", "no_tune", "tune_vo"):
        assert got[row]["episodes"] == 2
        for k in ("success", "softspl", "spl", "distance_to_goal", "total_env_steps"):
            assert np.isfinite(got[row][k]), (row, k)
    assert got["vo_train"]["forward_epoch_losses"][0] > 0  # one batch of 128 trained
    assert set(got["gps_vs_vo_gap_after_tune"]) == {"success", "softspl", "spl"}
    assert got["device"] == "cpu" and got["card"] is None


# ---------------------------------------------------------------- vis_trajectory


VIS_SIZE = 32


@pytest.fixture(scope="module")
def jax_vis():
    return _load(os.path.join(REPO, "examples", "vis_trajectory.py"), "jax_vis_trajectory")


@pytest.mark.parametrize("episode", [0, 3])
def test_vis_trajectory_paths_match_jax(jax_vis, episode):
    """The replayed episode's ground-truth path, goal and steps equal JAX's,
    and the path dead-reckoned from the ground-truth deltas too."""
    jcfg = jenvs.EnvConfig(image_h=VIS_SIZE, image_w=VIS_SIZE)
    tcfg = tenvs.EnvConfig(image_h=VIS_SIZE, image_w=VIS_SIZE)
    want = jax_vis.run_episode(jenvs.ScriptedPointNavEnv(jcfg, seed=0), episode,
                               jdataset.oracle_goal_follower(30.0, jcfg.success_distance))
    got = tvis.run_episode(tenvs.ScriptedPointNavEnv(tcfg, seed=0), episode,
                           tdataset.oracle_goal_follower(30.0, tcfg.success_distance))
    assert got[4] == want[4] > 0 and got[3] == want[3]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_vis_trajectory_through_the_vo_matches_jax(jax_vis, tmp_path):
    """Dead-reckoned through the same three experts: the path within rtol
    1e-4 of JAX's; ``main`` from a port checkpoint writes each episode's
    image and the record; a one-stage checkpoint is refused."""
    jcfg = JCfg(vis_size_w=VIS_SIZE, vis_size_h=VIS_SIZE, hidden_size=HIDDEN)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, VIS_SIZE, VIS_SIZE, 6)),
             "depth": jnp.zeros((1, VIS_SIZE, VIS_SIZE, 2)),
             "discretized_depth": jnp.zeros((1, VIS_SIZE, VIS_SIZE, 20)),
             "top_down_view": jnp.zeros((1, VIS_SIZE, VIS_SIZE, 2))}
    stacked = stack_expert_variables([fast_init(model, dummy, train=False, seed=20 + i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    tcfg = TCfg(vis_size_w=VIS_SIZE, vis_size_h=VIS_SIZE, hidden_size=HIDDEN)
    ckpt = str(tmp_path / "vo.pt")
    save_checkpoint(ckpt, {"experts": sds, "inference_config": dataclasses.asdict(tcfg)})
    env_j = jenvs.EnvConfig(image_h=VIS_SIZE, image_w=VIS_SIZE)
    want = jax_vis.run_episode(jenvs.ScriptedPointNavEnv(env_j, seed=0), 1,
                               jdataset.oracle_goal_follower(30.0, env_j.success_distance),
                               JEnsemble(jcfg, stacked))
    env_t = tenvs.EnvConfig(image_h=VIS_SIZE, image_w=VIS_SIZE)
    got = tvis.run_episode(tenvs.ScriptedPointNavEnv(env_t, seed=0), 1,
                           tdataset.oracle_goal_follower(30.0, env_t.success_distance),
                           tvis.load_vo(ckpt, VIS_SIZE, "cpu"))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    assert not np.allclose(np.asarray(got[1]), np.asarray(got[0]))  # the VO's own path

    out = str(tmp_path / "vis")
    rec = tvis.main(["--episodes", "0", "1", "--size", str(VIS_SIZE), "--out", out,
                     "--vo-ckpt", ckpt, "--device", "cpu"])
    with open(os.path.join(out, "trajectories.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    for ep in ("0", "1"):
        r = rec["episodes"][ep]
        assert os.path.isfile(r["image"]) and np.isfinite(r["drift_m"]) and r["steps"] > 0
    np.testing.assert_allclose(np.asarray(rec["episodes"]["1"]["vo_path"]), np.asarray(got[1]))
    save_checkpoint(str(tmp_path / "one.pt"), {"experts": sds[:1]})
    with pytest.raises(SystemExit, match="1 expert"):
        tvis.load_vo(str(tmp_path / "one.pt"), VIS_SIZE, "cpu")


# ---------------------------------------------------------------- eval_habitat


@pytest.fixture(scope="module")
def habitat_layout(tmp_path_factory):
    """pretrained_ckpts/ and dataset/ in the reference's layout: ``.pth``
    files written by the JAX exporter (the policy at full width, the
    experts at 32x32)."""
    root = tmp_path_factory.mktemp("habitat_layout")
    ck = root / "pretrained_ckpts"
    ck.mkdir()
    jpol = JPolicy()
    obs = {"depth": jnp.zeros((1, 192, 341, 1)), GOAL: jnp.zeros((1, 2))}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1))))
    save_policy_checkpoint_torch(str(ck / "rl_tune_vo.pth"), pvars)
    jcfg = JCfg(vis_size_w=32, vis_size_h=32)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, 32, 32, 6)), "depth": jnp.zeros((1, 32, 32, 2)),
             "discretized_depth": jnp.zeros((1, 32, 32, 20)),
             "top_down_view": jnp.zeros((1, 32, 32, 2))}
    experts = [jax.tree.map(np.asarray, fast_init(model, dummy, train=False, seed=i))
               for i in range(3)]
    save_vo_checkpoint_torch(str(ck / "act_forward.pth"), {1: experts[0]})
    save_vo_checkpoint_torch(str(ck / "act_left_right.pth"), {2: experts[1], 3: experts[2]})
    data = root / "dataset" / "habitat_datasets" / "pointnav/gibson/v2/val"
    data.mkdir(parents=True)
    (data / "val.json.gz").write_bytes(b"\x1f\x8b")
    (root / "dataset" / "Gibson").mkdir()
    return root


@pytest.fixture(scope="module")
def jax_habitat():
    return _load(os.path.join(REPO, "examples", "eval_habitat.py"), "jax_eval_habitat")


def _habitat_args(root, **over):
    d = dict(data_path=str(root / "dataset/habitat_datasets/pointnav/gibson/v2/"
                                  "{split}/{split}.json.gz"),
             split="val", scene_dir=str(root / "dataset" / "Gibson"),
             rl_ckpt=str(root / "pretrained_ckpts" / "rl_tune_vo.pth"),
             vo_forward_ckpt=str(root / "pretrained_ckpts" / "act_forward.pth"),
             vo_turn_ckpt=str(root / "pretrained_ckpts" / "act_left_right.pth"), device="cpu")
    d.update(over)
    return argparse.Namespace(**d)


@pytest.mark.parametrize("breaker", ["none", "habitat", "dataset", "scene_dir", "rl_ckpt",
                                     "vo_forward", "vo_turn"])
def test_eval_habitat_preflight_matches_jax(jax_habitat, habitat_layout, monkeypatch, breaker):
    """The same checks in the same order: a missing dependency stops both
    with the same message (naming its runbook step); a full layout passes
    both with the same dataset and the same parameter counts."""
    root = habitat_layout
    monkeypatch.setitem(sys.modules, "habitat", None if breaker == "habitat" else fake_habitat)
    over = {"dataset": dict(data_path=str(root / "nope/{split}.json.gz")),
            "scene_dir": dict(scene_dir=str(root / "no_scenes")),
            "rl_ckpt": dict(rl_ckpt=str(root / "nope.pth")),
            "vo_forward": dict(vo_forward_ckpt=str(root / "nope_fwd.pth")),
            "vo_turn": dict(vo_turn_ckpt=str(root / "nope_turn.pth"))}.get(breaker, {})
    args = _habitat_args(root, **over)
    if breaker != "none":
        with pytest.raises(SystemExit) as want:
            jax_habitat.preflight(args)
        with pytest.raises(SystemExit) as got:
            thabitat.preflight(args)
        assert str(got.value) == str(want.value) and "HABITAT_RUNBOOK" in str(got.value)
        return
    want = jax_habitat.preflight(args)
    got = thabitat.preflight(args)
    assert got["dataset"] == want["dataset"] and got["habitat"] == want["habitat"]
    assert got["rl_ckpt"] == want["rl_ckpt"] and got["rl_ckpt"]["params"] > 1_000_000
    assert got["vo_ckpts"] == want["vo_ckpts"]
    assert sorted(got["vo_ckpts"]) == ["forward[1]", "left_right[2]", "left_right[3]"]
    assert got["devices"] == ["cpu"]


def test_eval_habitat_config_and_no_tune(habitat_layout):
    """The eval's config: the habitat backend and the run's paths, as JAX's
    script sets them; ``--no-tune`` points at rl_no_tune.pth."""
    args = thabitat.build_parser().parse_args(["--episodes", "7", "--envs", "3", "--mode", "rnd",
                                               "--video", "--no-tune"])
    assert args.out == "EVAL_HABITAT_torch.json"
    cfg = thabitat.eval_config(args)
    assert cfg.ENV_BACKEND == "habitat" and cfg.NUM_PROCESSES == 3
    assert cfg.EVAL.TEST_EPISODE_COUNT == 7 and cfg.VO.REGRESS_MODEL.mode == "rnd"
    ck = cfg.VO.REGRESS_MODEL.all_pretrained_ckpt.rgb_d_dd_top_down_inv_joint
    assert (ck.forward, ck.left, ck.right) == (args.vo_forward_ckpt, args.vo_turn_ckpt,
                                               args.vo_turn_ckpt)
    assert cfg.TASK_CONFIG.DATASET.SCENES_DIR == args.scene_dir
    assert list(cfg.VIDEO_OPTION) == ["disk"]


# ---------------------------------------------------------------- the launcher


@pytest.mark.parametrize("argv", [
    ["--task-type", "rl", "--run-type", "train"],
    ["--task-type", "vo", "--run-type", "eval", "--noise", "0", "--log-root", "L",
     "VO.TRAIN.batch_size", "8"],
    ["--task-type", "rl", "--run-type", "eval", "--exp-config", "c.yaml", "--n-devices", "4",
     "NUM_PROCESSES", "8", "--device", "cpu"],
])
def test_launcher_command_matches_jax(argv, monkeypatch):
    jlaunch = _load(os.path.join(REPO, "launch.py"), "jax_launch")
    seen = []
    monkeypatch.setattr(jlaunch.os, "execv", lambda exe, cmd: seen.append(cmd))
    monkeypatch.setattr(sys, "argv", ["launch.py"] + argv)
    jlaunch.main()
    want = [("pointnav_vo_tpu_torch.run" if a == "pointnav_vo_tpu.run" else a)
            for a in seen[0]]
    assert tlaunch.command(argv) == want
    monkeypatch.setattr(tlaunch.os, "execv", lambda exe, cmd: seen.append((exe, cmd)))
    tlaunch.main(argv)
    assert seen[1] == (sys.executable, want)


# ---------------------------------------------------------------- imports


def test_drivers_import_no_jax_examples_tools_or_h5py():
    """The new drivers and the launcher pull in no jax, flax, JAX package,
    ``examples``/``tools`` module or ``h5py``, and neither do the pairs
    they train on."""
    mods = ["pointnav_vo_tpu_torch.launch"] + [
        f"pointnav_vo_tpu_torch.examples.{m}" for m in (
            "eval_994_ladder", "rl_tune_with_vo", "end_to_end_scripted", "train_rl_scripted",
            "train_vo_scripted", "vis_trajectory", "eval_habitat")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from pointnav_vo_tpu_torch.examples.eval_994 import scripted_pairs\n"
            "from pointnav_vo_tpu_torch.rl.envs import EnvConfig\n"
            "assert len(scripted_pairs(4, EnvConfig(image_h=8, image_w=8), 0)) == 4\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'pointnav_vo_tpu', 'examples', 'tools', 'h5py', 'eval_994', "
            "'eval_994_ladder'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
