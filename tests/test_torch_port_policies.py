"""Port parity, the policy family: the GRU, the rgb and rgb-d ResNet policies
with their whitening, the SimpleCNN + GRU baseline, the weight bridge's
keys for them, and ``DDPPOTrainer`` collecting and updating with them, of
pointnav_vo_tpu_torch against the JAX package (CPU; base 8, hidden 32,
32x32 inputs, 64x64 for the baseline, whose VALID convs need 36 pixels).

Tolerances (float32): the GRU's outputs, state and gradients rtol 1e-5,
atol 1e-6 (the LSTM's, tests/test_torch_port_rl_train.py); policy logits,
values and state rtol 1e-4, atol 1e-5; whitening buffers rtol 1e-5 (atol
1e-6 on the count-weighted mean and variance); the trainer's rollout and
update under test_torch_port_rl_train.py's rules: PPO loss terms rtol
1e-4, atol 1e-6, parameters after Adam within 1e-3 lr where the first
gradient is strong and within 2 lr a step everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.policy import PointNavBaselineActorCritic as JBaseline
from pointnav_vo_tpu.models.rnn import RNNStateEncoder as JRNN
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl import ppo as jppo
from pointnav_vo_tpu.rl import rollout as jrollout
from pointnav_vo_tpu.rl.trainer import act_step as j_act_step

from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    policy_variables_from_state_dict,
    seeded_init_,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.models.policy import PointNavBaselineActorCritic as TBaseline
from pointnav_vo_tpu_torch.models.rnn import RNNStateEncoder as TRNN
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl import ppo as tppo
from pointnav_vo_tpu_torch.rl import trainer as ttrainer

from _utils import fast_init
from test_torch_port_rl_train import (
    MASK_CASES,
    _assert_params_close,
    _env_kw,
    _jax_order,
    _jstorage,
    _leaves,
    _record_first_grads,
    _storage_np,
)

HIDDEN = 32
BASE = 8
LR = 1e-3
GOAL = "pointgoal_with_gps_compass"
TOL = dict(rtol=1e-4, atol=1e-5)
RNN_TOL = dict(rtol=1e-5, atol=1e-6)


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


# ------------------------------------------------------------ the GRU


def _rnn_name(k):
    return "rnn." + k.replace("w_", "weight_").replace("b_", "bias_")


@functools.lru_cache(maxsize=None)
def _gru_pair(layers, d=6, n=4):
    """The same GRU in both packages and JAX's jitted value and gradients
    of a weighted sum of the outputs and the final state (one step or a
    sequence, by the inputs' rank)."""
    jrnn = JRNN(input_size=d, hidden_size=HIDDEN, num_layers=layers, rnn_type="GRU")
    variables = jax.tree.map(np.asarray, fast_init(
        jrnn, jnp.zeros((n, d)), jnp.zeros((layers, n, HIDDEN)), jnp.ones((n, 1)),
        seed=20 + layers))
    trnn = TRNN(d, HIDDEN, layers, rnn_type="GRU")
    trnn.load_state_dict({_rnn_name(k): _t(v) for k, v in variables["params"].items()},
                         strict=True)

    def objective(params, x, h0, masks, w_out, w_hid):
        out, hid = jrnn.apply({"params": params}, x, h0, masks)
        return jnp.sum(out * w_out) + jnp.sum(hid * w_hid), (out, hid)

    fn = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True))
    return fn, variables["params"], trnn


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("case", ["one step", "reset mid-sequence",
                                  "different resets per env"])
def test_gru_matches_jax(layers, case):
    """Outputs, final state, and the gradients of a weighted sum of both
    with respect to the inputs, the initial state and the weights."""
    fn, params, trnn = _gru_pair(layers)
    assert trnn.num_recurrent_layers == layers
    rng = np.random.default_rng(layers)
    lead = (4,) if case == "one step" else (8, 4)
    x = rng.normal(size=lead + (6,)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (layers, 4, HIDDEN)).astype(np.float32)
    if case == "one step":
        masks = np.asarray([[1.0], [0.0], [1.0], [1.0]], np.float32)
    else:
        masks = MASK_CASES[case][..., None].astype(np.float32)
    w_out = rng.normal(size=lead + (HIDDEN,)).astype(np.float32)
    w_hid = rng.normal(size=h0.shape).astype(np.float32)
    (_, (jout, jhid)), (gp, gx, gh) = fn(params, *map(jnp.asarray, (x, h0, masks, w_out,
                                                                    w_hid)))
    tx, th = _t(x).requires_grad_(), _t(h0).requires_grad_()
    trnn.zero_grad()
    out, hid = trnn(tx, th, _t(masks))
    ((out * _t(w_out)).sum() + (hid * _t(w_hid)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **RNN_TOL)
    np.testing.assert_allclose(hid.detach().numpy(), np.asarray(jhid), **RNN_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **RNN_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **RNN_TOL)
    grads = dict(trnn.named_parameters())
    for k, g in gp.items():
        np.testing.assert_allclose(grads[_rnn_name(k)].grad.numpy(), np.asarray(g),
                                   err_msg=k, **RNN_TOL)


def test_rnn_rejects_other_cells():
    with pytest.raises(ValueError, match=r"LSTM \| GRU"):
        TRNN(4, 8, 1, rnn_type="RNN")


# ------------------------------------------------------------ the policies


# name -> (the ResNet policy's kwargs in both packages, None for the
# baseline; input size)
POLICIES = {
    "rgb": (dict(vis_types=("rgb",), normalize_visual_inputs=True), 32),
    "rgbd": (dict(vis_types=("rgb", "depth"), normalize_visual_inputs=True), 32),
    "depth_rgb": (dict(vis_types=("depth", "rgb"), normalize_visual_inputs=True), 32),
    "depth_gru": (dict(rnn_type="GRU"), 32),
    "baseline": (None, 64),
}
# whitening buffers of a policy that has seen frames: (mean, var, count)
STATS = {3: ([0.45, 0.5, 0.55], [0.07, 0.06, 0.05], 40.0),
         4: ([0.45, 0.5, 0.55, 0.3], [0.07, 0.06, 0.05, 0.02], 40.0)}


def _obs(size, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (n, size, size)
    return {"rgb": rng.uniform(0, 255, shape + (3,)).astype(np.float32),
            "depth": rng.uniform(0, 1, shape + (1,)).astype(np.float32),
            GOAL: rng.normal(size=lead + (n, 2)).astype(np.float32)}


def _modules(name, n=4, seed=30):
    """(JAX module, its variables, the port's module with the same weights;
    the whitening buffers set to STATS)."""
    kw, size = POLICIES[name]
    if kw is None:
        jpol = JBaseline(hidden_size=HIDDEN)
        tpol = TBaseline(image_size=(size, size), hidden_size=HIDDEN)
    else:
        jpol = JPolicy(image_size=(size, size), hidden_size=HIDDEN, baseplanes=BASE, **kw)
        tpol = TPolicy(image_size=(size, size), hidden_size=HIDDEN, baseplanes=BASE, **kw)
    obs = {k: jnp.asarray(v) for k, v in _obs(size, n, 0).items()}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(n), jnp.zeros((n, 1), jnp.int32), jnp.zeros((n, 1)),
        seed=seed))
    if "batch_stats" in pvars:
        mean, var, count = STATS[len(pvars["batch_stats"]["visual_encoder"]["rmv"]["mean"])]
        pvars["batch_stats"] = {"visual_encoder": {"rmv": {
            "mean": np.asarray(mean, np.float32), "var": np.asarray(var, np.float32),
            "count": np.asarray(count, np.float32)}}}
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    return jpol, pvars, tpol


@functools.lru_cache(maxsize=None)
def _policy_case(name):
    jpol, pvars, tpol = _modules(name)
    return jpol, pvars, tpol, jax.jit(jpol.apply)


def _step_inputs(jpol, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(0, 0.5, (jpol.num_packed_hidden, n, HIDDEN)).astype(np.float32)
    prev = rng.integers(0, 4, lead + (n, 1)).astype(np.int64)
    masks = (rng.uniform(size=lead + (n, 1)) > 0.3).astype(np.float32)
    return hidden, prev, masks


@pytest.mark.parametrize("form", ["step", "sequence"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_forward_matches_jax(name, form):
    """Logits, values and the recurrent state, one step ``[N, ...]`` and in
    the sequence form ``[T, N, ...]`` of the PPO update (T=5, masks that
    reset mid-sequence); rgb as float frames and, in one step, as the
    evaluator's uint8 upload."""
    jpol, pvars, tpol, japply = _policy_case(name)
    n, size = 4, POLICIES[name][1]
    lead = () if form == "step" else (5,)
    obs = _obs(size, n, 1, lead)
    hidden, prev, masks = _step_inputs(jpol, n, 2, lead)
    want = japply(pvars, {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hidden),
                  jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
    feeds = [{k: _t(v) for k, v in obs.items()}]
    if form == "step":
        feeds.append({**feeds[0], "rgb": _t(obs["rgb"].astype(np.uint8))})
    for i, feed in enumerate(feeds):
        if i:  # the uint8 frames: JAX's on the same bytes
            want = japply(pvars, {**{k: jnp.asarray(v) for k, v in obs.items()},
                                  "rgb": jnp.asarray(obs["rgb"].astype(np.uint8))},
                          jnp.asarray(hidden), jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
        with torch.no_grad():
            got = tpol(feed, _t(hidden), _t(prev), _t(masks))
        rows = n * (lead[0] if lead else 1)
        assert got[0].shape == (rows, 4) and got[2].shape == hidden.shape
        for what, g, w in zip(("logits", "value", "hidden"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)
    assert tpol.num_packed_hidden == jpol.num_packed_hidden
    vis = {"rgb": {"rgb"}, "depth_gru": {"depth"}}.get(name, {"rgb", "depth"})
    assert set(tpol.observation_keys) == vis | {GOAL}


@pytest.mark.parametrize("name", ["rgb", "rgbd"])
def test_update_stats_forwards_match_jax(name):
    """Three forwards that fold their frames into the whitening buffers (one
    step, then two of a 3-step sequence): the buffers equal JAX's
    ``batch_stats`` after each, and the outputs match."""
    jpol, pvars, tpol, _ = _policy_case(name)
    tpol = _modules(name)[2]  # fresh buffers: the cached module's stay put
    apply = jax.jit(functools.partial(jpol.apply, update_stats=True, mutable=["batch_stats"]))
    variables = dict(pvars)
    for i, lead in enumerate(((), (3,), (3,))):
        obs = _obs(32, 4, 10 + i, lead)
        hidden, prev, masks = _step_inputs(jpol, 4, 20 + i, lead)
        want, mut = apply(variables, {k: jnp.asarray(v) for k, v in obs.items()},
                          jnp.asarray(hidden), jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
        variables = {**variables, "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}
        with torch.no_grad():
            got = tpol({k: _t(v) for k, v in obs.items()}, _t(hidden), _t(prev), _t(masks),
                       update_stats=True)
        for what, g, w in zip(("logits", "value", "hidden"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)
        rmv = variables["batch_stats"]["visual_encoder"]["rmv"]
        buf = tpol.net.visual_encoder.running_mean_and_var
        np.testing.assert_allclose(float(buf._count), float(rmv["count"]), rtol=1e-5)
        np.testing.assert_allclose(buf._mean.numpy().reshape(-1), rmv["mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(buf._var.numpy().reshape(-1), rmv["var"], rtol=1e-5,
                                   atol=1e-6)
    # 40 to start, then 4 frames, then 12 and 12
    assert float(buf._count) == 40.0 + 4 + 12 + 12


def test_whitening_is_frozen_without_update_stats():
    _, _, tpol, _ = _policy_case("rgbd")
    before = {k: v.clone() for k, v in tpol.state_dict().items()}
    obs = _obs(32, 2, 3)
    hidden = torch.zeros(tpol.num_packed_hidden, 2, HIDDEN)
    tpol({k: _t(v) for k, v in obs.items()}, hidden, torch.zeros(2, 1, dtype=torch.long),
         torch.ones(2, 1))
    assert all(torch.equal(v, before[k]) for k, v in tpol.state_dict().items())


# ------------------------------------------------------------ the bridge


@pytest.mark.parametrize("name", ["rgbd", "depth_gru", "baseline"])
def test_bridge_round_trip(name):
    """JAX variables -> the port's state dict -> JAX variables, exactly:
    the GRU's ``state_encoder`` leaves, the whitening ``batch_stats`` and
    the baseline's ``visual_encoder/conv{1,2,3}`` and ``fc``."""
    _, pvars, tpol, _ = _policy_case(name)
    keys = set(tpol.state_dict())
    if name == "baseline":
        assert {f"net.visual_encoder.cnn.{i}.{leaf}" for i in (0, 2, 4, 6)
                for leaf in ("weight", "bias")} <= keys
        assert "net.state_encoder.rnn.weight_hh_l0" in keys
    if name == "rgbd":
        assert {f"net.visual_encoder.running_mean_and_var.{b}"
                for b in ("_mean", "_var", "_count")} <= keys
    back = policy_variables_from_state_dict(tpol.state_dict())
    got, want = dict(_leaves(back)), dict(_leaves(pvars))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    sd = policy_state_dict_from_jax(back)
    assert set(sd) == keys
    assert all(torch.equal(sd[k], v) for k, v in tpol.state_dict().items())


def test_seeded_init_covers_the_gru():
    pol = seeded_init_(TBaseline(image_size=(64, 64), hidden_size=HIDDEN),
                       torch.Generator().manual_seed(0))
    w = pol.net.state_encoder.rnn.weight_hh_l0
    assert 0 < float(w.detach().abs().max()) <= 1 / HIDDEN ** 0.5


# ------------------------------------------------------------ the trainer


def test_trainer_rollout_and_update_match_jax_rgbd():
    """DDPPOTrainer with the rgb-d whitening policy."""
    _trainer_vs_jax("rgbd")


def test_trainer_rollout_and_update_match_jax_baseline():
    """DDPPOTrainer with the SimpleCNN + GRU baseline."""
    _trainer_vs_jax("baseline")


def _trainer_vs_jax(name):
    """The port's trainer collects a rollout on the scripted envs (GPS
    goal) and updates in JAX's minibatch order (2 minibatches); the JAX
    package replays its sampled actions through its envs and its policy
    (``act_step_update_stats``'s forward where the policy whitens): the
    same observations, rewards and masks, values, log-probs and states, the
    whitening buffers after the rollout, and after JAX's ppo_update on the
    port's rollout (buffers frozen) the same loss terms and parameters."""
    size = POLICIES[name][1]
    t, n = 6, 4
    kw = dict(num_steps=t, num_mini_batch=2, ppo_epoch=1, lr=LR, hidden_size=HIDDEN)
    jcfg, tcfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    env_kw = _env_kw(size, cap=4)
    jpol, pvars, tpol = _modules(name, n)
    whitening = "batch_stats" in pvars
    trainer = ttrainer.DDPPOTrainer(
        model=tpol, ppo_cfg=tcfg, envs=tenvs.make_scripted_vector_env(
            tenvs.EnvConfig(**env_kw), n, seed=5),
        device="cpu", state_dict=policy_state_dict_from_jax(pvars),
        generator=torch.Generator().manual_seed(0))
    assert trainer.update_stats == whitening
    trainer.collect_rollout()
    roll = _storage_np(trainer.rollouts)
    assert 0 < roll["masks"][1:].sum() < t * n  # some episodes ended

    forward = jax.jit(functools.partial(jpol.apply, update_stats=True,
                                        mutable=["batch_stats"]) if whitening else jpol.apply)
    variables = dict(pvars)
    envs = jenvs.make_scripted_vector_env(jenvs.EnvConfig(**env_kw), n, seed=5)
    obs = envs.reset()
    hidden = jpol.initial_hidden(n)
    prev, masks = jnp.zeros((n, 1), jnp.int32), jnp.zeros((n, 1))
    for step in range(t):
        for k in ("rgb", "depth", GOAL):
            np.testing.assert_array_equal(roll["observations"][k][step], obs[k])
        out = forward(variables, {k: jnp.asarray(v) for k, v in obs.items()}, hidden, prev,
                      masks)
        if whitening:
            out, mut = out
            variables = {**variables, "batch_stats": mut["batch_stats"]}
        logits, value, hidden = out
        actions = roll["actions"][step, :, 0]
        logp = jax.nn.log_softmax(logits)[np.arange(n), actions]
        np.testing.assert_allclose(roll["value_preds"][step], value, err_msg=f"step {step}",
                                   **TOL)
        np.testing.assert_allclose(roll["action_log_probs"][step, :, 0], logp, **TOL)
        np.testing.assert_allclose(roll["hidden_states"][step + 1], hidden, **TOL)
        obs, rewards, dones, _ = envs.step(actions)
        np.testing.assert_array_equal(roll["rewards"][step, :, 0], rewards)
        np.testing.assert_array_equal(roll["masks"][step + 1, :, 0], 1.0 - dones)
        prev = jnp.asarray(actions[:, None], jnp.int32)
        masks = jnp.asarray(1.0 - dones, jnp.float32)[:, None]

    def buffers():
        return {k: v.clone() for k, v in trainer.model.state_dict().items()
                if "running_mean_and_var" in k}

    after_rollout = buffers()
    if whitening:
        back = policy_variables_from_state_dict(trainer.model.state_dict())["batch_stats"]
        for k, w in _leaves(jax.tree.map(np.asarray, variables["batch_stats"])):
            np.testing.assert_allclose(dict(_leaves(back))[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert float(after_rollout["net.visual_encoder.running_mean_and_var._count"]) == (
            40.0 + t * n)

    # JAX's returns and update on the port's rollout, the buffers frozen
    js = _jstorage(roll)
    extra = {k: v for k, v in variables.items() if k != "params"}
    next_value = j_act_step(jpol, variables, {k: v[t] for k, v in js.observations.items()},
                            js.hidden_states[t], js.prev_actions[t], js.masks[t],
                            jax.random.PRNGKey(0), deterministic=True)[0]
    js = jrollout.compute_returns(js, next_value, True, jcfg.gamma, jcfg.tau)
    rng = jax.random.PRNGKey(7)
    tx = optax.chain(_record_first_grads(), jppo.make_optimizer(jcfg))
    jparams, jstate, jstats = jppo.ppo_update(jpol, jcfg, tx, variables["params"],
                                              tx.init(variables["params"]), js, rng,
                                              extra_variables=extra or None)
    stats = trainer.update_agent(order=torch.from_numpy(_jax_order(rng, jcfg, n)))
    np.testing.assert_allclose(_storage_np(trainer.rollouts)["returns"][:t],
                               np.asarray(js.returns[:t]), **TOL)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    got = policy_variables_from_state_dict(trainer.model.state_dict())
    _assert_params_close({"params": got["params"]},
                         {"params": jax.tree.map(np.asarray, jparams)},
                         {"params": jax.tree.map(np.asarray, jstate[0][1])}, steps=2)
    assert all(torch.equal(v, after_rollout[k]) for k, v in buffers().items())


# ------------------------------------------------------------ eval and agent


@functools.lru_cache(maxsize=None)
def _rgbd_gru_models():
    """An rgb-d whitening policy with a 2-layer GRU (STOP disfavoured, so
    episodes move) and three det experts, the same in both packages."""
    from test_torch_port_rl_train import _ensembles

    jpol = JPolicy(image_size=(32, 32), hidden_size=HIDDEN, baseplanes=BASE,
                   vis_types=("rgb", "depth"), rnn_type="GRU", normalize_visual_inputs=True)
    obs = {k: jnp.asarray(v) for k, v in _obs(32, 1, 0).items()}
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
        seed=40))
    pvars["params"]["action_head"]["bias"] = np.asarray([-2.0, 0.3, 0.0, 0.0], np.float32)
    mean, var, count = STATS[4]
    pvars["batch_stats"] = {"visual_encoder": {"rmv": {
        "mean": np.asarray(mean, np.float32), "var": np.asarray(var, np.float32),
        "count": np.asarray(count, np.float32)}}}
    jens, tens = _ensembles(32)
    return jpol, pvars, jens, tens


def _tpolicy(pvars):
    tpol = TPolicy(image_size=(32, 32), hidden_size=HIDDEN, baseplanes=BASE,
                   vis_types=("rgb", "depth"), rnn_type="GRU", normalize_visual_inputs=True)
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    return tpol


@pytest.mark.parametrize("loop", ["fused", "unfused", "gps_only"])
def test_evaluator_loops_match_jax_rgbd_gru(loop):
    """The rgb-d GRU policy through each of the evaluator's loops (uint8 rgb
    uploads, the GRU's ``[L, N, H]`` state), against JAX's Evaluator under
    test_torch_port_envfarm.py's rules; the eval leaves the whitening
    buffers as they were."""
    from pointnav_vo_tpu.rl.eval import Evaluator as JEvaluator
    from pointnav_vo_tpu_torch.rl.eval import Evaluator as TEvaluator
    from test_torch_port_envfarm import _assert_matches_jax, _results

    jpol, pvars, jens, tens = _rgbd_gru_models()
    tpol = _tpolicy(pvars)
    before = {k: v.clone() for k, v in tpol.state_dict().items()}
    vo = loop != "gps_only"
    kw = dict(fused=loop == "fused") if vo else {}
    env_kw = _env_kw(32, cap=8)
    tev = TEvaluator(model=tpol, envs=tenvs.make_scripted_vector_env(
        tenvs.EnvConfig(**env_kw), 3, seed=9), vo_ensemble=tens if vo else None,
        device="cpu", **kw)
    jev = JEvaluator(model=jpol, variables=pvars, envs=jenvs.make_scripted_vector_env(
        jenvs.EnvConfig(**env_kw), 3, seed=9), vo_ensemble=jens if vo else None,
        rng=jax.random.PRNGKey(0), **kw)
    got = (tev.run(4), _results(tev))
    want = (jev.run(num_episodes=4), _results(jev))
    _assert_matches_jax(got, want, vo=vo)
    assert got[0]["total_env_steps"] > 8
    assert all(torch.equal(v, before[k]) for k, v in tpol.state_dict().items())


def test_agent_matches_jax_agent_rgbd_gru():
    """PointNavVOAgent with the rgb-d GRU policy, act by act against the
    JAX agent on the same observations: equal actions, goals within rtol
    1e-5, atol 1e-6 (test_torch_port_agent.py's)."""
    from pointnav_vo_tpu.deploy.challenge_agent import PointNavVOAgent as JAgent
    from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent as TAgent

    jpol, pvars, jens, tens = _rgbd_gru_models()
    jagent = JAgent(policy_model=jpol, policy_variables=pvars, vo_ensemble=jens,
                    goal_sensor=GOAL)
    agent = TAgent(policy_model=_tpolicy(pvars), vo_ensemble=tens, goal_sensor=GOAL,
                   device="cpu")
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**_env_kw(32, cap=10)), seed=3)
    steps = 0
    for _ in range(2):
        obs, done = env.reset(), False
        agent.reset()
        jagent.reset()
        while not done:
            a = agent.act(obs)["action"]
            assert jagent.act(obs)["action"] == a, f"step {steps}"
            np.testing.assert_allclose(agent.goal_cartesian, np.asarray(jagent._goal_cart[0]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {steps}")
            assert agent._hidden.shape == (2, 1, HIDDEN)
            steps += 1
            obs, _r, done, _ = env.step(a)
    assert steps > 4
