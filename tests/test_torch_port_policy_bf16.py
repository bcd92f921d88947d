"""Port parity, the policy's bfloat16 compute dtype: ``PointNavActorCritic``
(depth, and rgb-d with whitening) and ``PointNavBaselineActorCritic`` built
with ``compute_dtype=torch.bfloat16`` against the JAX modules built with
``dtype=jnp.bfloat16`` (CPU; base 8, hidden 32, 64x64 inputs;
JAX-exported weights).

64x64, not 32x32: at 32x32 the ResNet policy's last stage convolves a 1x1
map at stride 2, and there torch 2.13's CPU backend (oneDNN) returns a
bfloat16 weight gradient of garbage or NaN (``F.conv2d`` on a ``[n, C, 1,
1]`` bfloat16 input, 3x3 kernel, stride 2, padding 1: 3 of 3 draws at every
batch tried); a 2x2 map or stride 1 is sound.  The baseline's VALID convs
need 36 pixels anyway.

Both sides run the convs, GroupNorms, linears, the embedding and the heads
in bfloat16 over float32 parameters, the whitening statistics and the RNN
in float32, and round alike where an op is elementwise: the 2x2 pool sums
its window in bfloat16, a Dense's or Conv's bias is added to the rounded
product.  Convolutions and reductions still sum in other orders.
Tolerances, each measured on the CPU first:

- logits and value within relative L2 ``OUT_REL`` 5e-3 of JAX's (measured
  at most 3.4e-3), the hidden state within ``HIDDEN_REL`` 1e-3 (measured at
  most 8.5e-4), one step and the sequence form;
- whitening buffers after ``update_stats`` rtol 1e-5 (float32 on both
  sides);
- one PPO minibatch's gradients: all of them together within relative L2
  ``GRAD_REL`` 5e-2 of JAX's bf16 gradients (measured at most 8.9e-3).  Per
  tensor the two bf16 backwards differ about as much as either differs
  from float32: in the early convs and GroupNorms JAX's bf16 gradients are
  up to 29 % from its float32 ones, the port's up to 24 %, and the two
  sides up to 29 % apart.  So each tensor is held within ``GRAD_REL`` or
  ``GRAD_RATIO`` 2x the larger of the two sides' own bf16-to-float32
  distances, whichever is larger (measured at most 1.46x);
- the loss terms rtol 1e-2; after the update's four Adam steps every
  parameter within 2 lr a step of JAX's (a gradient that is zero up to
  bfloat16 rounding may flip its sign), and parameters and Adam moments
  float32.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.policy import PointNavBaselineActorCritic as JBaseline
from pointnav_vo_tpu.ops.geometry import pointgoal_polar2cartesian as j_polar2cart
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl import ppo as jppo
from pointnav_vo_tpu.rl import rollout as jrollout
from pointnav_vo_tpu.rl.eval import fused_vo_act_step as j_fused
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import bucket_expert_indices_static, stack_expert_variables

from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent
from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    policy_variables_from_state_dict,
    seeded_init_,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.models.policy import PointNavBaselineActorCritic as TBaseline
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl import ppo as tppo
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step as t_fused
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.vo import ensemble as tens_lib
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init
from test_torch_port_rl_train import (
    _jax_order,
    _jstorage,
    _leaves,
    _random_rollout,
    _record_first_grads,
    _storage_np,
    _tstorage,
)

HIDDEN = 32
BASE = 8
LR = 1e-3
GOAL = "pointgoal_with_gps_compass"
OUT_REL = 5e-3
HIDDEN_REL = 1e-3
GRAD_REL = 5e-2
GRAD_RATIO = 2.0
# name -> (the ResNet policy's kwargs in both packages, None for the
# baseline; input size)
POLICIES = {
    "depth": (dict(), 64),
    "rgbd": (dict(vis_types=("rgb", "depth"), normalize_visual_inputs=True), 64),
    "baseline": (None, 64),
}
STATS = ([0.45, 0.5, 0.55, 0.3], [0.07, 0.06, 0.05, 0.02], 40.0)  # rgb-d whitening


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _obs(size, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (n, size, size)
    return {"rgb": rng.uniform(0, 255, shape + (3,)).astype(np.float32),
            "depth": rng.uniform(0, 1, shape + (1,)).astype(np.float32),
            GOAL: np.stack([rng.uniform(0.5, 5, lead + (n,)),
                            rng.uniform(-np.pi, np.pi, lead + (n,))], -1).astype(np.float32)}


def _jax_module(name, dtype):
    kw, size = POLICIES[name]
    if kw is None:
        return JBaseline(hidden_size=HIDDEN, dtype=dtype)
    return JPolicy(image_size=(size, size), hidden_size=HIDDEN, baseplanes=BASE, dtype=dtype,
                   **kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX bf16 module, its variables, jitted apply, the port's bf16
    module with the same weights)."""
    kw, size = POLICIES[name]
    jpol = _jax_module(name, jnp.bfloat16)
    if kw is None:
        tpol = TBaseline(image_size=(size, size), hidden_size=HIDDEN,
                         compute_dtype=torch.bfloat16)
    else:
        tpol = TPolicy(image_size=(size, size), hidden_size=HIDDEN, baseplanes=BASE,
                       compute_dtype=torch.bfloat16, **kw)
    n = 4
    obs = {k: jnp.asarray(v) for k, v in _obs(size, n, 0).items()}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(n), jnp.zeros((n, 1), jnp.int32), jnp.zeros((n, 1)),
        seed=40))
    if "batch_stats" in pvars:
        mean, var, count = STATS
        pvars["batch_stats"] = {"visual_encoder": {"rmv": {
            "mean": np.asarray(mean, np.float32), "var": np.asarray(var, np.float32),
            "count": np.asarray(count, np.float32)}}}
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    return jpol, pvars, jax.jit(jpol.apply), tpol


def _inputs(jpol, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(0, 0.5, (jpol.num_packed_hidden, n, HIDDEN)).astype(np.float32)
    prev = rng.integers(0, 4, lead + (n, 1)).astype(np.int64)
    masks = (rng.uniform(size=lead + (n, 1)) > 0.3).astype(np.float32)
    return hidden, prev, masks


@pytest.mark.parametrize("form", ["step", "sequence"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_bf16_forward_matches_jax(name, form):
    """Logits and value within OUT_REL, hidden within HIDDEN_REL, one step
    ``[N, ...]`` and the PPO update's sequence form ``[T, N, ...]`` (T=5,
    masks that reset mid-sequence); logits, value and hidden come out in
    float32, as JAX's do."""
    jpol, pvars, japply, tpol = _case(name)
    n, size = 4, POLICIES[name][1]
    lead = () if form == "step" else (5,)
    obs = _obs(size, n, 1, lead)
    hidden, prev, masks = _inputs(jpol, n, 2, lead)
    want = japply(pvars, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hidden),
                  jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
    with torch.no_grad():
        got = tpol({k: _t(v) for k, v in obs.items()}, _t(hidden), _t(prev), _t(masks))
    for what, g, w, tol in zip(("logits", "value", "hidden"), got, want,
                               (OUT_REL, OUT_REL, HIDDEN_REL)):
        assert g.dtype == torch.float32, what
        assert np.asarray(w).dtype == np.float32, what
        assert _rel(g.numpy(), w) <= tol, (what, _rel(g.numpy(), w))


def test_bf16_rnn_runs_in_float32_on_bf16_rounded_inputs():
    """The LSTM sees float32 features that bfloat16 represents exactly and a
    float32 state; the heads see bfloat16."""
    jpol, _pvars, _japply, tpol = _case("depth")
    seen = {}

    def hook(name):
        def fn(_mod, args):
            seen[name] = args[0]
        return fn

    handles = [tpol.net.state_encoder.rnn.register_forward_pre_hook(hook("rnn")),
               tpol.action_distribution.linear.register_forward_pre_hook(hook("head"))]
    hidden, prev, masks = _inputs(jpol, 4, 3)
    try:
        with torch.no_grad():
            tpol({k: _t(v) for k, v in _obs(POLICIES["depth"][1], 4, 3).items()}, _t(hidden),
                 _t(prev), _t(masks))
    finally:
        for h in handles:
            h.remove()
    x = seen["rnn"]
    assert x.dtype == torch.float32
    assert torch.equal(x, x.to(torch.bfloat16).float())
    assert seen["head"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tpol.parameters())


def test_bf16_update_stats_matches_jax():
    """The rgb-d policy folding a batch into its whitening: the float32
    buffers within rtol 1e-5 of JAX's, the outputs as in one step."""
    jpol, pvars, _japply, tpol0 = _case("rgbd")
    tpol = copy.deepcopy(tpol0)
    obs = _obs(POLICIES["rgbd"][1], 4, 5)
    hidden, prev, masks = _inputs(jpol, 4, 6)
    (jl, jv, jh), mut = jax.jit(functools.partial(
        jpol.apply, update_stats=True, mutable=["batch_stats"]))(
        pvars, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hidden),
        jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
    with torch.no_grad():
        tl, tv, th = tpol({k: _t(v) for k, v in obs.items()}, _t(hidden), _t(prev), _t(masks),
                          update_stats=True)
    rmv = tpol.net.visual_encoder.running_mean_and_var
    want = mut["batch_stats"]["visual_encoder"]["rmv"]
    for buf, key in ((rmv._mean, "mean"), (rmv._var, "var"), (rmv._count, "count")):
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.reshape(-1).numpy(), np.asarray(want[key]).reshape(-1),
                                   rtol=1e-5, err_msg=key)
    assert _rel(tl.numpy(), jl) <= OUT_REL and _rel(tv.numpy(), jv) <= OUT_REL
    assert _rel(th.numpy(), jh) <= HIDDEN_REL


@functools.lru_cache(maxsize=None)
def _jax_update(name):
    """JAX's bf16 ppo_update (ppo_epoch 2, num_mini_batch 2) on one random
    rollout: (rollout as numpy, the first minibatch's gradients, the final
    params, the stats, the minibatch order, the first minibatch's
    gradients of the float32 module)."""
    jpol, pvars, _japply, _tpol = _case(name)
    size = POLICIES[name][1]
    t, n = 6, 4
    shapes = {"depth": (size, size, 1), GOAL: (2,)}
    if name != "depth":
        shapes["rgb"] = (size, size, 3)
    d = _random_rollout(t, n, shapes, seed=12, packed=jpol.num_packed_hidden)
    if "rgb" in d["observations"]:
        d["observations"]["rgb"] *= 255.0
    cfg = jppo.PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=LR, num_steps=t,
                         hidden_size=HIDDEN)
    js = jrollout.compute_returns(_jstorage(d), jnp.asarray(d["value_preds"][t]), True,
                                  0.99, 0.95)
    d = _storage_np(js)
    d["actions"], d["prev_actions"] = (d[k].astype(np.int64) for k in ("actions",
                                                                       "prev_actions"))
    rng = jax.random.PRNGKey(13)
    tx = optax.chain(_record_first_grads(), jppo.make_optimizer(cfg))
    extra = {k: v for k, v in pvars.items() if k != "params"}
    params, state, stats = jppo.ppo_update(jpol, cfg, tx, pvars["params"],
                                           tx.init(pvars["params"]), js, rng,
                                           extra_variables=extra or None)
    first = {"params": jax.tree.map(np.asarray, state[0][1])}
    cfg1 = jppo.PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=LR, num_steps=t,
                          hidden_size=HIDDEN)
    _p, state32, _s = jppo.ppo_update(_jax_module(name, jnp.float32), cfg1, tx,
                                      pvars["params"], tx.init(pvars["params"]), js, rng,
                                      extra_variables=extra or None)
    first32 = {"params": jax.tree.map(np.asarray, state32[0][1])}
    return (d, first, {"params": jax.tree.map(np.asarray, params)},
            {k: float(v) for k, v in stats.items()}, _jax_order(rng, cfg, n), first32)


def _port_first_grads(tpol, d, order, compute_dtype):
    """The port's gradients of the first minibatch's loss, by JAX's keys."""
    probe = copy.deepcopy(tpol)
    probe.compute_dtype = compute_dtype
    cfg = tppo.PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=LR, num_steps=6,
                         hidden_size=HIDDEN)
    ts = _tstorage(d)
    adv = ts.returns[:-1] - ts.value_preds[:-1]
    idx = torch.from_numpy(order)[0, 0]
    mb = tppo.gather_env_slice(ts, idx, probe.observation_keys) + (adv[:, idx],)
    total, _ = tppo.ppo_loss(probe, cfg, mb, cfg.clip_param)
    assert total.dtype == torch.float32
    total.backward()
    return dict(_leaves(policy_variables_from_state_dict(
        {k: p.grad for k, p in probe.named_parameters()})))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_bf16_ppo_update_matches_jax(name):
    """One minibatch's gradients against JAX's bf16 gradients: all together
    within GRAD_REL, each tensor within GRAD_REL or GRAD_RATIO x the larger
    of the two sides' own bf16-to-float32 distances; the whole update's loss
    terms within rtol 1e-2 and its parameters within 2 lr a step of JAX's;
    parameters and Adam moments float32 afterwards."""
    _jpol, _pvars, _japply, tpol0 = _case(name)
    d, first, jparams, jstats, order, first32 = _jax_update(name)
    tcfg = tppo.PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=LR, num_steps=6,
                          hidden_size=HIDDEN)
    got = _port_first_grads(tpol0, d, order, torch.bfloat16)
    got32 = _port_first_grads(tpol0, d, order, None)
    want, want32 = dict(_leaves(first)), dict(_leaves(first32))
    assert set(got) == set(want) == set(got32) == set(want32)
    keys = sorted(want)

    def cat(g):
        return np.concatenate([g[k].ravel() for k in keys])

    assert _rel(cat(got), cat(want)) <= GRAD_REL
    for k in keys:
        own = max(_rel(want[k], want32[k]), _rel(got[k], got32[k]))
        assert _rel(got[k], want[k]) <= max(GRAD_REL, GRAD_RATIO * own), (
            k, _rel(got[k], want[k]), own)

    ts = _tstorage(d)
    tpol = copy.deepcopy(tpol0)
    opt = tppo.make_optimizer(tpol.parameters(), tcfg)
    stats = tppo.ppo_update(tpol, tcfg, opt, ts, order=torch.from_numpy(order))
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), v, rtol=1e-2, atol=1e-5, err_msg=k)
    got = dict(_leaves(policy_variables_from_state_dict(tpol.state_dict())))
    for k, w in _leaves(jparams):
        assert float(np.abs(got[k] - w).max()) <= 2 * LR * 4, k
    assert all(p.dtype == torch.float32 for p in tpol.parameters())
    for s in opt.adam.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_fused_step_with_bf16_policy_matches_jax():
    """One det fused eval step, float32 VO and the bf16 policy, against
    JAX's: delta, goal and drift pose rtol 1e-4 (the VO is float32 on both
    sides), value and logp within OUT_REL, hidden within HIDDEN_REL, the
    actions equal."""
    n, size = 8, POLICIES["depth"][1]
    actions = np.asarray([1, 1, 2, 3, 1, 2, 0, 1], np.int32)
    env = jenvs.make_scripted_vector_env(jenvs.EnvConfig(image_h=size, image_w=size), n,
                                         seed=3)
    o0 = env.reset()
    o1 = env.step(np.where(actions == 0, 1, actions))[0]
    r0, d0 = o0["rgb"].astype(np.uint8), o0["depth"].astype(np.float32)
    r1, d1 = o1["rgb"].astype(np.uint8), o1["depth"].astype(np.float32)
    jcfg = JCfg(vis_size_w=size, vis_size_h=size, hidden_size=HIDDEN)
    vo_model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, size, size, 6)), "depth": jnp.zeros((1, size, size, 2)),
             "discretized_depth": jnp.zeros((1, size, size, 20)),
             "top_down_view": jnp.zeros((1, size, size, 2))}
    stacked = stack_expert_variables([fast_init(vo_model, dummy, train=False, seed=i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    jpol, pvars, _japply, tpol = _case("depth")
    rng = np.random.default_rng(11)
    sensor = o1[GOAL].astype(np.float32)
    goal = np.array(j_polar2cart(jnp.asarray(o0[GOAL])))
    reset = np.zeros((n, 1), np.float32)
    reset[3] = 1.0
    hid = rng.normal(size=(4, n, HIDDEN)).astype(np.float32)
    masks = 1.0 - reset
    est_rot = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1))
    est_pos = np.zeros((n, 3), np.float32)
    J = jnp.asarray
    buckets, order = bucket_expert_indices_static(actions, n)
    want = [np.asarray(x, np.float32) for x in j_fused(
        jpol, vo_model, jcfg, pvars, stacked, J(r0), J(d0), J(r1), J(d1), J(actions),
        J(goal), J(reset), J(sensor), J(hid), J(actions[:, None]), J(masks),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), deterministic=True, bucket_idx=buckets,
        expert_ids=J(order), est_rot=J(est_rot), est_pos=J(est_pos), est_seed_rot=J(est_rot),
        est_seed_pos=J(est_pos))]
    tcfg = TCfg(vis_size_w=size, vis_size_h=size, hidden_size=HIDDEN)
    T = torch.from_numpy
    got = t_fused(tpol, TEnsemble(tcfg, sds, device="cpu"),
                  tens_lib.frame_features_packed(T(r0), T(d0), tcfg), T(r1), T(d1), actions,
                  T(goal), T(reset), T(sensor), T(hid), T(actions[:, None]).long(), T(masks),
                  T(est_rot), T(est_pos), T(est_rot), T(est_pos))
    names = ("goal", "polar", "delta", "std", "value", "action", "logp", "hidden", "feats",
             "est_rot", "est_pos")
    got, want = dict(zip(names, got)), dict(zip(names, want))
    np.testing.assert_array_equal(got["action"].numpy(), want["action"])
    for k in ("goal", "polar", "delta", "est_rot", "est_pos"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert _rel(got["value"].numpy(), want["value"]) <= OUT_REL
    assert _rel(got["logp"].numpy(), want["logp"]) <= OUT_REL
    assert _rel(got["hidden"].numpy(), want["hidden"]) <= HIDDEN_REL
    assert got["value"].dtype == got["hidden"].dtype == torch.float32


def test_bf16_policy_in_the_trainer_evaluator_and_agent():
    """The bf16 policy where the port uses one: ``DDPPOTrainer`` with det VO
    in the loop (rollout storage and its hidden states float32, parameters
    and Adam moments float32 after the update, finite losses), an
    ``Evaluator.run`` over the scripted envs and a few acts of the agent."""
    size, n = POLICIES["depth"][1], 2
    env_cfg = tenvs.EnvConfig(image_h=size, image_w=size, max_episode_steps=8)
    vo_cfg = TCfg(vis_size_w=size, vis_size_h=size, hidden_size=HIDDEN)
    g = torch.Generator().manual_seed(0)
    vo = TEnsemble(vo_cfg, experts=[seeded_init_(vo_cfg.make_model(), g) for _ in range(3)],
                   device="cpu")
    policy = TPolicy(image_size=(size, size), hidden_size=HIDDEN, baseplanes=BASE,
                     compute_dtype=torch.bfloat16)
    cfg = tppo.PPOConfig(num_steps=4, num_mini_batch=2, hidden_size=HIDDEN)
    trainer = DDPPOTrainer(model=policy, ppo_cfg=cfg, device="cpu", vo_ensemble=vo,
                           envs=tenvs.make_scripted_vector_env(env_cfg, n, seed=0),
                           init_generator=g, generator=torch.Generator().manual_seed(1))
    stats = trainer.train(1)[0]
    assert all(np.isfinite(v) for k, v in stats.items() if k != "count_steps")
    r = trainer.rollouts
    assert r.hidden_states.dtype == torch.float32 and trainer.hidden.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in r.observations.values())
    assert all(p.dtype == torch.float32 for p in policy.parameters())
    for s in trainer.optimizer.adam.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    assert policy.compute_dtype == torch.bfloat16

    ev = Evaluator(model=policy, envs=tenvs.make_scripted_vector_env(env_cfg, n, seed=5),
                   vo_ensemble=vo, device="cpu", generator=torch.Generator().manual_seed(3))
    agg = ev.run(2)
    assert agg["episodes"] == 2 and np.isfinite(agg["spl"])

    agent = PointNavVOAgent(policy_model=policy, vo_ensemble=vo, device="cpu")
    env = tenvs.ScriptedPointNavEnv(env_cfg, seed=7)
    obs = env.reset()
    for _ in range(3):
        a = agent.act({"rgb": obs["rgb"], "depth": obs["depth"], "pointgoal": obs[GOAL]})
        assert a["action"] in range(4)
        obs = env.step(max(a["action"], 1))[0]
