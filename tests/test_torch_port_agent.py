"""Port parity, the deployment agent: pointnav_vo_tpu_torch's
``PointNavVOAgent`` against the JAX package's on scripted episodes with the
same exported weights (CPU, 32x32 sensors), its STOP latch, the ``vo_fn``
hook, rnd mode, its ``bin_counts`` calls and the habitat import gate."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.deploy.challenge_agent import PointNavVOAgent as JAgent
from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import stack_expert_variables

from pointnav_vo_tpu_torch.deploy import challenge_agent as tagent
from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent as TAgent
from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.ops import topdown as ttopdown
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init
from test_torch_port_eval import TGreedy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, HIDDEN = 32, 32
GOAL = "pointgoal_with_gps_compass"
ENV_KW = dict(image_h=S, image_w=S, max_episode_steps=15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The same policy and three experts in both packages (the policy's
    STOP logit lowered so that episodes move)."""
    jpol = JPolicy(image_size=(S, S), hidden_size=HIDDEN)
    obs = {"depth": jnp.zeros((1, S, S, 1)), GOAL: jnp.zeros((1, 2))}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
        seed=5))
    pvars["params"]["action_head"]["bias"] = np.asarray([-2.0, 0.0, 0.0, 0.0], np.float32)
    jcfg = JCfg(vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN)
    vmodel = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, S, S, 6)), "depth": jnp.zeros((1, S, S, 2)),
             "discretized_depth": jnp.zeros((1, S, S, 20)),
             "top_down_view": jnp.zeros((1, S, S, 2))}
    stacked = stack_expert_variables([fast_init(vmodel, dummy, train=False, seed=20 + i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    return {"jpol": jpol, "pvars": pvars, "jens": JEnsemble(jcfg, stacked),
            "policy_sd": policy_state_dict_from_jax(pvars), "vo_sds": sds}


def _port_agent(models, mode="det", seed=0, dropout_p=0.2, deterministic=True):
    policy = TPolicy(image_size=(S, S), hidden_size=HIDDEN)
    policy.load_state_dict(models["policy_sd"], strict=True)
    cfg = TCfg(vis_size_w=S, vis_size_h=S, hidden_size=HIDDEN, mode=mode, dropout_p=dropout_p)
    return TAgent(policy_model=policy, vo_ensemble=TEnsemble(cfg, models["vo_sds"], device="cpu"),
                  goal_sensor=GOAL, deterministic=deterministic,
                  generator=torch.Generator().manual_seed(seed), device="cpu")


def _episodes(agent, n_episodes, seed=3):
    """Drive ``agent`` through scripted episodes; per episode the actions
    and the dead-reckoned goal after each act."""
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**ENV_KW), seed=seed)
    out = []
    for _ in range(n_episodes):
        obs, done, actions, goals = env.reset(), False, [], []
        agent.reset()
        while not done:
            a = agent.act(obs)["action"]
            actions.append(a)
            goals.append(agent.goal_cartesian)
            obs, _r, done, _info = env.step(a)
        out.append((actions, np.stack(goals)))
    return out


def test_agent_matches_jax_agent(models):
    """Det mode: the JAX agent, fed the same observations, takes the same
    actions, and the dead-reckoned goals agree after every step."""
    jagent = JAgent(policy_model=models["jpol"], policy_variables=models["pvars"],
                    vo_ensemble=models["jens"], goal_sensor=GOAL)
    agent = _port_agent(models)
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**ENV_KW), seed=3)
    steps = turns = 0
    for _ in range(3):
        obs, done = env.reset(), False
        agent.reset()
        jagent.reset()
        while not done:
            a = agent.act(obs)["action"]
            assert jagent.act(obs)["action"] == a, f"step {steps}"
            np.testing.assert_allclose(agent.goal_cartesian, np.asarray(jagent._goal_cart[0]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {steps}")
            steps += 1
            turns += a in (2, 3)
            obs, _r, done, _info = env.step(a)
    assert steps > 3 * 2 and turns > 0  # the episodes moved and turned


def test_stop_latch_and_bin_counts_per_episode(models, monkeypatch):
    """One ``bin_counts`` a step from the second on, one more on the first
    VO step for the previous frame; none once STOP has latched."""
    calls = []
    real = ttopdown.bin_counts
    monkeypatch.setattr(ttopdown, "bin_counts",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    agent = _port_agent(models)
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**ENV_KW), seed=4)
    for _ in range(2):
        obs, done, n_acts = env.reset(), False, 0
        agent.reset()
        calls.clear()
        while not done:
            a = agent.act(obs)["action"]
            n_acts += 1
            obs, _r, done, _info = env.step(a)
        assert len(calls) == (n_acts if n_acts > 1 else 0)
    # the latch: force a STOP, then every later act is STOP without work
    agent.reset()
    agent.act(env.reset())
    agent._stopped = True
    calls.clear()
    for _ in range(3):
        assert agent.act(env.step(1)[0])["action"] == 0
    assert calls == []


def test_policy_stop_latches(models):
    """A policy that emits STOP at its first step: the agent keeps
    answering STOP for the rest of the episode."""
    agent = _port_agent(models)
    with torch.no_grad():
        agent.model.action_distribution.linear.bias.copy_(torch.tensor([9.0, 0.0, 0.0, 0.0]))
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**ENV_KW), seed=1)
    obs = env.reset()
    assert agent.act(obs)["action"] == 0
    assert [agent.act(obs)["action"] for _ in range(3)] == [0, 0, 0]
    agent.reset()
    assert agent.goal_cartesian is None


def test_vo_fn_hook_with_ground_truth_reaches_every_goal():
    """Ground-truth deltas through the hook and the greedy goal policy:
    success in all 3 episodes, and STOP latches."""
    cfg = tenvs.EnvConfig(image_h=4, image_w=4, max_episode_steps=80,
                          actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                          depth_noise_multiplier=0.0)
    env = tenvs.ScriptedPointNavEnv(cfg, seed=0)
    last_gt = {"delta": np.zeros(3, np.float32)}

    def gt_vo(prev_rgb, prev_depth, rgb, depth, prev_action, observations):
        d = torch.from_numpy(np.asarray(last_gt["delta"], np.float32))[None]
        return d, torch.zeros_like(d)

    agent = TAgent(policy_model=TGreedy(cfg.turn_angle_deg, cfg.success_distance),
                   vo_fn=gt_vo, goal_sensor=GOAL, device="cpu")
    successes = 0
    for _ in range(3):
        obs, done, info = env.reset(), False, {}
        agent.reset()
        last_gt["delta"] = np.zeros(3, np.float32)
        while not done:
            out = agent.act(obs)
            obs, _r, done, info = env.step(out["action"])
            last_gt["delta"] = info["gt_delta"]
        successes += info["success"]
        assert out["action"] == 0 and agent.act(obs)["action"] == 0
    assert successes == 3


def test_rnd_mode_statistics(models):
    """rnd mode: at dropout 0 the mean of the passes is the det delta (up
    to the order of the trunk's sums), so the episode is the det agent's;
    with dropout the generator decides the draws (same seed, same episode;
    another seed, other goals)."""
    det = _episodes(_port_agent(models, "det"), 2)
    rnd0 = _episodes(_port_agent(models, "rnd", dropout_p=0.0), 2)
    for (da, dg), (ra, rg) in zip(det, rnd0):
        assert da == ra
        np.testing.assert_allclose(rg, dg, rtol=1e-6, atol=1e-6)
    a = _episodes(_port_agent(models, "rnd", seed=1), 2)
    b = _episodes(_port_agent(models, "rnd", seed=1), 2)
    c = _episodes(_port_agent(models, "rnd", seed=2), 2)
    for (aa, ag), (ba, bg) in zip(a, b):
        assert aa == ba
        np.testing.assert_array_equal(ag, bg)
    assert all(np.isfinite(g).all() for _, g in a + c)
    first = next(i for i, (acts, _) in enumerate(a) if len(acts) > 1)
    assert not np.array_equal(a[first][1][1], c[first][1][1]) or a[first][0] != c[first][0]


def test_agent_needs_vo_and_a_card_by_default(models):
    policy = TPolicy(image_size=(S, S), hidden_size=HIDDEN)
    with pytest.raises(ValueError, match="VO ensemble or a vo_fn"):
        TAgent(policy_model=policy, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TAgent(policy_model=policy, vo_fn=lambda *a: None)


def test_submit_to_challenge_imports_habitat_only_when_called(monkeypatch):
    code = ("import sys\n"
            "import pointnav_vo_tpu_torch.deploy.challenge_agent\n"
            "assert 'habitat' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    submitted = []

    class Challenge:
        def __init__(self, eval_remote):
            self.eval_remote = eval_remote

        def submit(self, agent):
            submitted.append((self.eval_remote, agent))

    monkeypatch.setitem(sys.modules, "habitat", types.SimpleNamespace(Challenge=Challenge))
    tagent.submit_to_challenge("agent", phase="remote")
    tagent.submit_to_challenge("agent")
    assert submitted == [(True, "agent"), (False, "agent")]
