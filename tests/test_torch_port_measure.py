"""Port parity: the measurement scripts ``examples/full_eval_benchmark.py``
and ``examples/profile_vo_step.py`` of ``pointnav_vo_tpu_torch`` against
the JAX package (CPU, small sizes).

- ``full_eval_benchmark.eval_loop`` and ``chained_step`` over 3 scripted
  envs at 64x64 (an episode cap of 2, so resets re-seed the goal), bf16
  experts and a bf16 policy from the same seeded weights, against the
  same loop composed from JAX's ``act_step``, ``VOEnsemble.
  predict_step_cached`` and ``propagate_goal`` (the JAX script is one
  ``main``) and its chained jit: the env actions and the finished episodes
  exact, the goals rtol 1e-5 (atol 1e-6), the logits each step within
  relative L2 5e-3 (the bf16 bound of ``test_torch_port_policy_bf16.py``;
  measured bit-equal), the chained accumulator within relative 5e-3
  (measured 5.9e-4); the bf16 deltas each step at most 1e-2 of the norm
  of JAX's float32 deltas from JAX's bf16 deltas (measured 4.3e-3 to
  6.3e-3; the 5e-3 of ``test_torch_port_precision.py``, measured there at
  2.5e-3 on other frames, does not hold here), and no farther from JAX's
  float32 deltas than 1.5x JAX's own bf16 deltas are (measured 0.37x to
  0.96x); the printed projection;
- ``profile_vo_step``'s stages at B=8: each stage's output is what the
  full step computes from it (the top-down view is the packed features'
  channel, the selected rows are the pair's rows, the forwards on them are
  ``predict_packed``'s deltas, bit for bit), and ``profile`` runs every
  stage;
- the new modules import no JAX.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.ops import geometry as jgeo
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl.trainer import act_step as jact_step
from pointnav_vo_tpu.rl.trainer import propagate_goal as jpropagate_goal
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import (_vo_step_cached, bucket_expert_indices_static,
                                         frame_features, stack_expert_variables)

from pointnav_vo_tpu_torch.examples import full_eval_benchmark as tfeb
from pointnav_vo_tpu_torch.examples import profile_vo_step as tprof
from pointnav_vo_tpu_torch.io.weights import (policy_state_dict_from_jax, seeded_init_,
                                              split_expert_variables, vo_state_dict_from_jax)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

from _utils import fast_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL = "pointgoal_with_gps_compass"
SIZE = 64  # the bf16 ResNet policy needs a 2x2 last map (test_torch_port_policy_bf16.py)
HIDDEN = 32
N_ENVS = 3
STEPS = 3
ENV = dict(image_h=SIZE, image_w=SIZE, max_episode_steps=2)
BF16_REL = 5e-3
BF16_DELTA_REL = 1e-2  # of JAX's float32 deltas' norm, see test_eval_loop_matches_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- full_eval_benchmark


@pytest.fixture(scope="module")
def models():
    """bf16 experts and a bf16 policy in both packages, the same seeded
    float32 weights."""
    jpol = JPolicy(image_size=(SIZE, SIZE), hidden_size=HIDDEN, baseplanes=8, dtype=jnp.bfloat16)
    obs = {"depth": jnp.zeros((1, SIZE, SIZE, 1)), GOAL: jnp.zeros((1, 2))}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
        seed=3))
    tpol = TPolicy(image_size=(SIZE, SIZE), hidden_size=HIDDEN, baseplanes=8,
                   compute_dtype=torch.bfloat16)
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    jcfg = JCfg(vis_size_w=SIZE, vis_size_h=SIZE, hidden_size=HIDDEN, dtype=jnp.bfloat16)
    dummy = {"rgb": jnp.zeros((1, SIZE, SIZE, 6)), "depth": jnp.zeros((1, SIZE, SIZE, 2)),
             "discretized_depth": jnp.zeros((1, SIZE, SIZE, 20)),
             "top_down_view": jnp.zeros((1, SIZE, SIZE, 2))}
    model = jcfg.make_model()
    stacked = stack_expert_variables([fast_init(model, dummy, train=False, seed=10 + i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    tcfg = TCfg(vis_size_w=SIZE, vis_size_h=SIZE, hidden_size=HIDDEN, precision="bf16")
    return (jpol, pvars, JEnsemble(jcfg, stacked),
            tpol.eval(), TEnsemble(tcfg, sds, device="cpu"))


def _jax_greedy(goal, env_cfg):
    # the JAX script's rule (examples/full_eval_benchmark.py:136-141)
    half_turn = np.radians(env_cfg.turn_angle_deg) / 2
    bearing = -goal[:, 1]
    return np.where(goal[:, 0] < env_cfg.success_distance, 0,
                    np.where(np.abs(bearing) > half_turn, np.where(bearing < 0, 2, 3), 1),
                    ).astype(np.int32)


@pytest.fixture(scope="module")
def jax_run(models):
    """The JAX script's loop and chained step, composed from its parts."""
    jpol, pvars, jens, _tpol, _tens = models
    env_cfg = jenvs.EnvConfig(**ENV)
    envs = jenvs.make_scripted_vector_env(env_cfg, N_ENVS, seed=0)

    def ship(o):
        return (jnp.asarray(o["rgb"].astype(np.uint8)), jnp.asarray(o["depth"].astype(np.float16)))

    obs = envs.reset()
    rgb, depth = ship(obs)
    goal_polar = jnp.asarray(obs[GOAL])
    hidden = jpol.initial_hidden(N_ENVS)
    prev = jnp.zeros((N_ENVS, 1), jnp.int32)
    masks = jnp.zeros((N_ENVS, 1))
    goal_cart = jgeo.pointgoal_polar2cartesian(goal_polar)
    feats = frame_features(rgb, depth, jens.cfg)
    # float32 experts on the same frames: the bf16 deltas' yardstick
    j32 = JEnsemble(dataclasses.replace(jens.cfg, dtype=jnp.float32), jens.variables)
    feats32 = frame_features(rgb, depth, j32.cfg)
    rng = jax.random.PRNGKey(0)
    trace, episodes = [], 0
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        pol_obs = {"depth": depth, GOAL: goal_polar}
        logits = np.asarray(jpol.apply(pvars, pol_obs, hidden, prev, masks)[0], np.float32)
        _v, pol_action, _lp, hidden = jact_step(jpol, pvars, pol_obs, hidden, prev, masks, sub,
                                                deterministic=True)
        actions = _jax_greedy(np.asarray(goal_polar), env_cfg)
        new_obs, _r, dones, infos = envs.step(actions)
        episodes += int(dones.sum())
        new_rgb, new_depth = ship(new_obs)
        delta, feats = jens.predict_step_cached(feats, new_rgb, new_depth, actions)
        delta32, feats32 = j32.predict_step_cached(feats32, new_rgb, new_depth, actions)
        gt = jnp.asarray(np.stack([i["gt_delta"] for i in infos]))
        reset = jnp.asarray(dones.astype(np.float32))[:, None]
        goal_cart, goal_polar = jpropagate_goal(goal_cart, gt, reset,
                                                jnp.asarray(new_obs[GOAL]))
        trace.append({"logits": logits, "policy_action": np.asarray(pol_action)[:, 0],
                      "actions": actions, "delta": np.asarray(delta, np.float32),
                      "delta32": np.asarray(delta32),
                      "goal_polar": np.asarray(goal_polar), "dones": dones})
        rgb, depth = new_rgb, new_depth
        prev = jnp.asarray(actions)[:, None]
        masks = jnp.asarray(1.0 - dones.astype(np.float32))[:, None]

    # examples/full_eval_benchmark.py:184-214
    buckets, order = bucket_expert_indices_static(actions, N_ENVS)
    order = jnp.asarray(order)
    barrier = jax.lax.optimization_barrier
    vo_model, vo_cfg = jens.cfg.make_model(), jens.cfg

    @jax.jit
    def chain(feats, rgb, depth, goal_polar, goal_cart, hidden, prev_a, masks, rng):
        acc = jnp.zeros((), jnp.float32)
        for _ in range(tfeb.CHAIN):
            rng, sub = jax.random.split(rng)
            _v, a, _lp, hidden = jact_step(jpol, pvars, {"depth": depth, GOAL: goal_polar},
                                           hidden, prev_a, masks, sub, deterministic=True)
            delta, feats = _vo_step_cached(vo_model, vo_cfg, jens.variables, feats,
                                           rgb.astype(jnp.float32), depth.astype(jnp.float32),
                                           buckets, order)
            goal_cart, goal_polar = jpropagate_goal(goal_cart, delta, masks * 0.0, goal_polar)
            acc = acc + jnp.sum(delta) + jnp.sum(a.astype(jnp.float32))
            (feats, rgb, depth, goal_polar, goal_cart, hidden, acc) = barrier(
                (feats, rgb, depth, goal_polar, goal_cart, hidden, acc))
        return acc

    acc = float(chain(feats, rgb, depth, goal_polar, goal_cart, hidden, prev, masks, rng))
    return trace, episodes, acc


@pytest.fixture(scope="module")
def torch_run(models):
    _jpol, _pvars, _jens, tpol, tens = models
    env_cfg = tenvs.EnvConfig(**ENV)
    envs = tenvs.make_scripted_vector_env(env_cfg, N_ENVS, seed=0)
    trace = []
    rec = tfeb.run(tens, tpol, envs, env_cfg, STEPS, torch.device("cpu"), trace)
    return trace, rec


def test_eval_loop_matches_jax(jax_run, torch_run):
    want, want_episodes, _acc = jax_run
    got, rec = torch_run
    assert len(got) == len(want) == STEPS
    assert rec["episodes_done"] == want_episodes > 0
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["actions"], w["actions"], err_msg=f"step {step}")
        np.testing.assert_array_equal(g["dones"], w["dones"], err_msg=f"step {step}")
        np.testing.assert_allclose(g["goal_polar"], w["goal_polar"], rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {step}")
        # two bf16 runs differ about as much as bf16 differs from float32
        # (XLA on the CPU keeps excess precision between a bf16 op and its
        # float32 consumer; test_torch_port_precision.py): measured 4.3e-3 to
        # 6.3e-3 of JAX's float32 deltas' norm apart, JAX's own bf16 3.7e-3
        # to 6.7e-3 and the port's 2.4e-3 to 6.4e-3 from float32
        scale = float(np.linalg.norm(w["delta32"]))
        assert float(np.linalg.norm(g["delta"] - w["delta"])) <= BF16_DELTA_REL * scale, step
        assert (np.linalg.norm(g["delta"] - w["delta32"])
                <= 1.5 * np.linalg.norm(w["delta"] - w["delta32"])), step
        assert _rel_l2(g["logits"], w["logits"]) <= BF16_REL, step  # measured 0 (bit-equal)


def test_chained_step_matches_jax(jax_run, torch_run):
    _trace, _episodes, want = jax_run
    _t, rec = torch_run
    assert abs(rec["chain_acc"] - want) <= BF16_REL * abs(want)
    # on the CPU nothing is timed or counted; the count the card must meet
    assert rec["chain_ms"] is None and rec["bin_counts_launches"] is None
    assert rec["chained_calls"] == 1
    assert rec["expected_launches"] == 1 + STEPS + tfeb.CHAIN


def test_report_projects_as_the_jax_script():
    """The JAX script's arithmetic: 994 x 250 steps over N envs at the
    chained ms; the last line over the card count."""
    rec = {"envs": 32, "steps": 200, "env_steps": 6400, "wall_s": 64.0, "episodes_done": 7,
           "per_step_ms": {"act": 1.0, "vo": 2.0, "env": 3.0, "ship": 4.0}, "chain_ms": 10.0}
    lines = tfeb.report(rec, 4)
    dev_min = 994 * 250 / 32 * 10.0 / 1e3 / 60
    assert lines[0] == "envs=32 steps=200 (= 6400 env-steps), wall 64.0s, 7 episodes finished"
    assert f"device-bound {dev_min:.1f} min" in lines[3]
    assert f"{270 / dev_min:.1f}x vs the reference's 270 min on its GPU" in lines[3]
    assert f"end-to-end on this host {994 * 250 / 100 / 60:.1f} min" in lines[3]
    assert lines[4].startswith("projection over 4 card(s)")
    assert f"{dev_min / 4:.1f} min device-bound" in lines[4]
    assert "not measured" in tfeb.report({**rec, "chain_ms": None}, 1)[2]


def test_constant_weights_as_zeros_like_shapes():
    m = tfeb.constant_weights_(TCfg(vis_size_w=SIZE, vis_size_h=SIZE,
                                    hidden_size=HIDDEN).make_model())
    assert all(bool((t == 0.01).all()) for t in m.state_dict().values())


# ---------------------------------------------------------------- profile_vo_step


B = 8
PH, PW = 48, 64


@pytest.fixture(scope="module")
def stage_setup():
    cfg = TCfg(vis_size_w=PW, vis_size_h=PH, hidden_size=HIDDEN, precision="bf16")
    g = torch.Generator().manual_seed(0)
    ens = TEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                    device="cpu")
    rgb, depth, actions = tprof.inputs(B, PH, PW)
    prev = tprof.inputs(B, PH, PW, seed=1)
    return cfg, ens, torch.from_numpy(rgb), torch.from_numpy(depth), actions, prev


def test_profile_inputs_are_the_jax_scripts():
    rgb, depth, actions = tprof.inputs(B, PH, PW)
    rng = np.random.default_rng(0)  # examples/profile_vo_step.py:60-64
    np.testing.assert_array_equal(rgb, np.asarray(jnp.asarray(
        rng.uniform(0, 255, (B, PH, PW, 3)), jnp.float32)))
    np.testing.assert_array_equal(depth, np.asarray(jnp.asarray(
        rng.uniform(0, 1, (B, PH, PW, 1)), jnp.float32)))
    np.testing.assert_array_equal(actions, np.where(rng.uniform(size=B) < 0.7, 1,
                                                    rng.integers(2, 4, B)).astype(np.int32))


def test_profile_stages_compose_the_full_step(stage_setup):
    cfg, ens, rgb, depth, actions, prev = stage_setup
    prev_feats = frame_features_packed(torch.from_numpy(prev[0]), torch.from_numpy(prev[1]), cfg)
    feats = frame_features_packed(rgb, depth, cfg)
    # stage 2: the top-down view (kernel route and plain) is the packed
    # features' last channel
    view = tprof.top_down_view_batch(depth[..., 0], cfg.topdown_params)
    assert torch.equal(tprof.top_down_plain(depth[..., 0], cfg), view)
    assert torch.equal(feats[..., -1], view.to(cfg.dtype))
    # stage 5 is the pair of stage 1's outputs through predict_packed
    pair = torch.cat([prev_feats, feats], dim=-1)
    full, cur = ens.predict_step_cached(prev_feats, rgb, depth, actions)
    want = ens.predict_packed(pair, actions)
    assert torch.equal(cur, feats) and torch.equal(full, want)
    # stages 3 and 4: each expert's rows, and its deltas on them
    subs = tprof.select_rows(pair, actions)
    rows = [r for r in tprof.expert_rows(actions) if r.size]
    assert len(subs) == len(rows) >= 2
    for sub, r, out in zip(subs, rows, tprof.expert_forwards(ens, subs, actions)):
        assert torch.equal(sub, pair[torch.from_numpy(r)])
        assert torch.equal(out, want[torch.from_numpy(r)])


def test_profile_runs_every_stage(capsys):
    rec = tprof.profile(B, 1, torch.device("cpu"), PH, PW)
    assert rec["topdown_equal"]
    stages = ("features", "topdown_kernel", "topdown_plain", "select", "forwards", "full")
    assert all(rec[s]["finite"] and rec[s]["device_ms"] is None for s in stages)
    out = capsys.readouterr().out
    assert out.count("not measured (CPU run") == len(stages)
    assert "FULL fused step (predict_step_cached)" in out


# ---------------------------------------------------------------- imports


def test_measure_and_tool_modules_import_no_jax():
    """The two scripts and the two tools pull in no jax, flax, JAX package,
    ``examples``/``tools`` module or ``h5py``."""
    mods = [f"pointnav_vo_tpu_torch.{m}" for m in (
        "examples.full_eval_benchmark", "examples.profile_vo_step",
        "tools.export_to_reference", "tools.verify_reference_ckpts", "tools.reference_oracle")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'pointnav_vo_tpu', 'examples', 'tools', 'h5py', '_torch_ref'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
