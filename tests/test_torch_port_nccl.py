"""The data-parallel layer on NCCL: ranks on cards of their own.

Every test is marked ``cuda`` and needs two CUDA cards or more; it skips
where there are fewer (the gloo ranks on the CPU, held against the JAX
mesh, are ``tests/test_torch_port_dist.py``).  The file imports no JAX, so
a machine with the cards runs it as

    python -m pytest -m cuda --noconftest tests/test_torch_port_nccl.py -q

One spawn of one rank a card (a bare ``cuda`` device spreads them, so the
backend is NCCL) checks the group's collectives, one PPO update and the
eval on each rank's blocks, each against rank 0's one-rank run of the same
(parameters atol 1e-5, the loss terms rtol 1e-4 / atol 1e-6, the episode
set exactly, per-episode floats rtol 1e-4 / atol 1e-5), and parameters
bit-equal across ranks; then the RL train CLI at one rank a card.
"""

import glob
import os

import numpy as np
import pytest
import torch

from pointnav_vo_tpu_torch import kernels
from pointnav_vo_tpu_torch import run as trun
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.parallel import dist
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

import _torch_dist_ranks as ranks

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL = "pointgoal_with_gps_compass"
S = 32
HIDDEN = 32


@pytest.fixture(scope="module")
def world():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"{n} CUDA card(s): NCCL needs a card for each of two ranks or more")
    kernels.build()  # once, before the ranks load it
    return n


def _inputs(w):
    """A rollout over 2 envs a rank, a policy, each rank's minibatch order
    and their union in global env indices, and an eval case of 2 envs a
    rank (numpy, from seeds)."""
    t, n, h = 4, 2 * w, 16
    rng = np.random.default_rng(0)
    policy_kw = dict(image_size=(h, h), hidden_size=HIDDEN, baseplanes=8)
    policy = seeded_init_(PointNavActorCritic(**policy_kw), torch.Generator().manual_seed(1))
    f32 = np.float32
    rollout = dict(
        observations={"depth": rng.uniform(0, 1, (t + 1, n, h, h, 1)).astype(f32),
                      GOAL: rng.uniform(0, 1, (t + 1, n, 2)).astype(f32)},
        hidden_states=rng.normal(0, 0.5, (t + 1, 4, n, HIDDEN)).astype(f32),
        rewards=rng.normal(size=(t, n, 1)).astype(f32),
        value_preds=rng.normal(size=(t + 1, n, 1)).astype(f32),
        returns=np.zeros((t + 1, n, 1), f32),
        action_log_probs=np.log(rng.uniform(0.1, 0.9, (t, n, 1))).astype(f32),
        actions=rng.integers(0, 4, (t, n, 1)),
        prev_actions=rng.integers(0, 4, (t + 1, n, 1)),
        masks=(rng.uniform(size=(t + 1, n, 1)) > 0.2).astype(f32))
    st = ranks.storage(rollout).compute_returns(torch.from_numpy(rollout["value_preds"][t]),
                                                True, 0.99, 0.95)
    rollout["returns"] = st.returns.numpy()
    orders = [rng.permutation(2).reshape(1, 2, 1) for _ in range(w)]
    icfg = dict(vis_size_w=S, vis_size_h=S)
    g = torch.Generator().manual_seed(2)
    experts = [{k: v.numpy() for k, v in
                seeded_init_(VOInferenceConfig(**icfg).make_model(), g).state_dict().items()}
               for _ in range(3)]
    return dict(
        policy_kw=policy_kw, policy={k: v.numpy() for k, v in policy.state_dict().items()},
        ppo_cfg=dict(num_mini_batch=2, ppo_epoch=1, use_normalized_advantage=True,
                     num_steps=t, hidden_size=HIDDEN),
        rollout=rollout, orders=orders,
        union=np.concatenate([o + r * 2 for r, o in enumerate(orders)], axis=-1),
        eval=dict(seed=9, episodes=2 * w, one_episode_envs=0, n_envs=2 * w,
                  env_kw=dict(image_h=S, image_w=S, max_episode_steps=12,
                              actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                              depth_noise_multiplier=0.0),
                  icfg=icfg, experts=experts))


@pytest.fixture(scope="module")
def on_cards(world):
    return world, dist.spawn(ranks.cards, world, "cuda", _inputs(world))


def test_nccl_group_reduces_broadcasts_and_gathers(on_cards):
    w, got = on_cards
    want_mean = (np.arange(4.0) + (w - 1) / 2).tolist()
    for r, rank in enumerate(got):
        assert (rank["backend"], rank["device"]) == ("nccl", f"cuda:{r}")
        np.testing.assert_allclose(rank["mean"], want_mean, rtol=1e-6)
        for k, v in got[0]["linear"].items():
            assert np.array_equal(rank["linear"][k], v), k
        assert rank["objects"] == list(range(w)) and rank["broadcast"] == 0 and rank["any"]


def test_nccl_ppo_update_matches_one_rank(on_cards):
    _, got = on_cards
    params, stats = got[0]["ppo"]
    one_params, one_stats = got[0]["ppo_one"]
    for k, v in one_params.items():
        np.testing.assert_allclose(params[k], v, atol=1e-5, err_msg=k)
    for k, v in one_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    for rank in got[1:]:
        for k, v in params.items():
            assert np.array_equal(rank["ppo"][0][k], v), k


def test_nccl_eval_matches_one_rank(on_cards):
    _, got = on_cards
    agg, episodes, keys = got[0]["eval"]
    one_agg, one_episodes, one_keys = got[0]["eval_one"]
    assert keys == one_keys
    for g, w in zip(episodes, one_episodes, strict=True):
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
            else:
                assert g[k] == v, k
    for k in ("episodes", "success", "total_env_steps"):
        assert agg[k] == one_agg[k], k


def test_nccl_rl_train_cli(world, tmp_path):
    """The train CLI at one rank a card: 2 envs a rank, 2 updates, each
    checkpoint written once."""
    trun.main(["--task-type", "rl", "--run-type", "train", "--exp-config",
               os.path.join(REPO, "configs/rl/ddppo_pointnav.yaml"), "--log-root", str(tmp_path),
               "--device", "cuda", "--n-devices", str(world),
               "NUM_PROCESSES", str(2 * world), "NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1",
               "RL.PPO.num_steps", "4", "RL.PPO.hidden_size", str(HIDDEN),
               "VO.REGRESS_MODEL.pretrained", "False", "VO.REGRESS_MODEL.hidden_size",
               str(HIDDEN), "VO.VIS_SIZE_W", str(S), "VO.VIS_SIZE_H", str(S),
               "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(S),
               "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(S),
               "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(S),
               "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(S)])
    (run_dir,) = glob.glob(os.path.join(str(tmp_path), "rl-train-*"))
    steps = 4 * 2 * world
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        f"ckpt_0.update_0.frames_{steps}.pth", f"ckpt_1.update_1.frames_{2 * steps}.pth"]
