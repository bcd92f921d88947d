"""Port parity, the det eval slice: scripted envs, the fused VO+act step
and a short exact-set Evaluator.run of pointnav_vo_tpu_torch against the
JAX package (CPU), plus the port's import and device rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.ops.geometry import pointgoal_polar2cartesian as j_polar2cart
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl.eval import Evaluator as JEvaluator
from pointnav_vo_tpu.rl.eval import episode_budgets as j_budgets
from pointnav_vo_tpu.rl.eval import fused_vo_act_step as j_fused
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import (
    bucket_expert_indices_static,
    stack_expert_variables,
)

from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.eval import Evaluator as TEvaluator
from pointnav_vo_tpu_torch.rl.eval import episode_budgets as t_budgets
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step as t_fused
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

from _torch_dist_ranks import Greedy as TGreedy
from _utils import fast_init
from test_eval import GreedyGoalPolicy as JGreedy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _ensembles(h, w, hidden=64):
    """The same three random experts in both packages."""
    jcfg = JCfg(vis_size_w=w, vis_size_h=h, hidden_size=hidden)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, h, w, 6)), "depth": jnp.zeros((1, h, w, 2)),
             "discretized_depth": jnp.zeros((1, h, w, 20)),
             "top_down_view": jnp.zeros((1, h, w, 2))}
    per = [fast_init(model, dummy, train=False, seed=i) for i in range(3)]
    stacked = stack_expert_variables(per)
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    tcfg = TCfg(vis_size_w=w, vis_size_h=h, hidden_size=hidden)
    return JEnsemble(jcfg, stacked), TEnsemble(tcfg, sds, device="cpu")


def _env_cfg(h, w, **kw):
    return dict(image_h=h, image_w=w, **kw)


def test_scripted_env_matches_jax():
    kw = _env_cfg(24, 40, max_episode_steps=7)
    je = jenvs.make_scripted_vector_env(jenvs.EnvConfig(**kw), 3, seed=2)
    te = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), 3, seed=2)
    jo, to = je.reset(), te.reset()
    rng = np.random.default_rng(0)
    for step in range(12):
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{k} @ {step}")
        acts = rng.integers(0, 4, 3)
        jo, jr, jd, ji = je.step(acts)
        to, tr, td, ti = te.step(acts)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
        for a, b in zip(ti, ji):
            for k in ("gt_delta", "agent_pos_episodic", "spl", "success",
                      "distance_to_goal", "episode_id"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["collisions"] == b["collisions"]


def test_episode_budgets_match_jax():
    for args in ((7, 3, None), (14, 8, [1, 1, 1] + [None] * 5), (9, 2, [3, 2])):
        assert t_budgets(*args) == j_budgets(*args)


def test_fused_vo_act_step_matches_jax():
    """One det step with the real actor-critic, every output compared."""
    h, w, n, hidden = 32, 48, 6, 32
    jens, tens = _ensembles(h, w)
    jpol = JPolicy(image_size=(h, w), hidden_size=hidden, baseplanes=8)
    rng = np.random.default_rng(11)
    prev_rgb, cur_rgb = (rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
                         for _ in range(2))
    prev_depth, cur_depth = (rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32)
                             for _ in range(2))
    actions = np.asarray([1, 1, 2, 3, 0, 1], np.int32)  # STOP runs the forward expert
    sensor = np.stack([rng.uniform(0.2, 5, n), rng.uniform(-np.pi, np.pi, n)],
                      -1).astype(np.float32)
    goal = np.array(j_polar2cart(jnp.asarray(sensor[::-1].copy())))
    reset = np.asarray([[0], [1], [0], [0], [1], [0]], np.float32)
    hid = rng.normal(size=(4, n, hidden)).astype(np.float32)
    masks = 1.0 - reset
    q = rng.normal(size=(n, 4))
    est_rot = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    est_pos = rng.normal(size=(n, 3)).astype(np.float32)
    seed_rot = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1))
    seed_pos = np.zeros((n, 3), np.float32)

    jobs = {"depth": jnp.asarray(cur_depth),
            "pointgoal_with_gps_compass": jnp.asarray(sensor)}
    pvars = fast_init(jpol, jobs, jnp.asarray(hid), jnp.asarray(actions[:, None]),
                      jnp.asarray(masks), seed=4)
    buckets, order = bucket_expert_indices_static(actions, n)
    J = jnp.asarray
    want = j_fused(
        jpol, jens.model, jens.cfg, pvars, jens.variables,
        J(prev_rgb), J(prev_depth), J(cur_rgb), J(cur_depth), J(actions), J(goal),
        J(reset), J(sensor), J(hid), J(actions[:, None]), J(masks),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), deterministic=True,
        bucket_idx=buckets, expert_ids=J(order), est_rot=J(est_rot), est_pos=J(est_pos),
        est_seed_rot=J(seed_rot), est_seed_pos=J(seed_pos))
    (j_goal, j_polar, j_delta, _std, j_value, j_action, j_logp, j_hid, j_feats,
     j_rot, j_pos) = [np.asarray(x) for x in want]

    tpol = TPolicy(image_size=(h, w), hidden_size=hidden, baseplanes=8)
    tpol.load_state_dict(policy_state_dict_from_jax(jax.tree.map(np.asarray, pvars)),
                         strict=True)
    T = torch.from_numpy
    prev_feats = frame_features_packed(T(prev_rgb), T(prev_depth), tens.cfg)
    got = t_fused(tpol.eval(), tens, prev_feats, T(cur_rgb), T(cur_depth), actions,
                  T(goal), T(reset), T(sensor), T(hid), T(actions[:, None]).long(),
                  T(masks), T(est_rot), T(est_pos), T(seed_rot), T(seed_pos))
    (t_goal, t_polar, t_delta, t_std, t_value, t_action, t_logp, t_hid, t_feats,
     t_rot, t_pos) = [x.numpy() for x in got]

    np.testing.assert_array_equal(t_action, j_action)
    assert not t_std.any()  # det mode
    np.testing.assert_allclose(t_feats, j_feats, rtol=0, atol=2.4e-7)
    for t, j, name in ((t_delta, j_delta, "delta"), (t_goal, j_goal, "goal"),
                       (t_polar, j_polar, "polar"), (t_value, j_value, "value"),
                       (t_logp, j_logp, "logp"), (t_hid, j_hid, "hidden"),
                       (t_rot, j_rot, "est_rot"), (t_pos, j_pos, "est_pos")):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


def test_evaluator_run_matches_jax():
    """3 envs, an exact set of 6 episodes, the greedy goal policy steering by
    the VO-propagated goal."""
    h = w = 32
    kw = _env_cfg(h, w, max_episode_steps=12, actuation_noise_multiplier=0.0,
                  rgb_noise_intensity=0.0, depth_noise_multiplier=0.0)
    jens, tens = _ensembles(h, w)
    cfg = jenvs.EnvConfig(**kw)
    jev = JEvaluator(model=JGreedy(turn_angle_deg=cfg.turn_angle_deg,
                                   success_distance=cfg.success_distance),
                     variables={"params": {}},
                     envs=jenvs.make_scripted_vector_env(cfg, 3, seed=7),
                     vo_ensemble=jens, rng=jax.random.PRNGKey(0), fused=True)
    want = jev.run(num_episodes=6)
    tev = TEvaluator(model=TGreedy(cfg.turn_angle_deg, cfg.success_distance),
                     envs=tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), 3, seed=7),
                     vo_ensemble=tens, device="cpu")
    got = tev.run(num_episodes=6)
    assert set(got) == set(want)
    for key in ("episodes", "success", "spl", "total_env_steps", "stuck_dx",
                "stuck_dz", "stuck_both"):
        assert got[key] == want[key], key
    for key in ("vo_l2_mean", "global_drift_mean", "softspl", "distance_to_goal"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert [r.steps for r in tev.results] == [r.steps for r in jev.results]


def test_evaluator_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    envs = tenvs.make_scripted_vector_env(tenvs.EnvConfig(image_h=8, image_w=8), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEvaluator(model=TGreedy(), envs=envs, vo_ensemble=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEnsemble(TCfg(), experts=[])


def test_port_imports_no_jax():
    """The port and chip_smoke.py pull in no jax, flax or pointnav_vo_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointnav_vo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pointnav_vo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
