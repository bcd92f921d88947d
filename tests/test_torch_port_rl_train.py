"""Port parity, policy training: the rollout storage and its returns, the
LSTM's sequence form, the policy's sequence forward, the PPO optimizer,
loss and update, and ``DDPPOTrainer`` with VO in the loop, of
pointnav_vo_tpu_torch against the JAX package (CPU; the policy at base 8,
hidden 32, 32x32 or 64x64 input; T of 6-12, N of 4).

JAX and torch draw different random bits: the PPO update is compared on
JAX's own minibatch order (its ``jax.random.permutation`` draws, injected),
and the trainer's sampled actions are replayed through the JAX package.

Tolerances (float32; convolutions, GroupNorm and the LSTM sum in other
orders): storage and returns rtol 1e-6, atol 1e-6; LSTM outputs, state and
gradients rtol 1e-5, atol 1e-6; policy logits, values and state rtol 1e-4,
atol 1e-5; PPO loss terms rtol 1e-4, atol 1e-6; a minibatch's gradients
within 1e-3 of each tensor's max abs, plus 1e-7; parameters after Adam
within 1e-3 lr of JAX's where the first gradient exceeds 1e-3 of its
tensor's max, and within 2 lr a step everywhere (Adam moves a weight by
about lr sign(g) a step, and a gradient that is zero up to rounding may
flip); dead-reckoned goals rtol 1e-4, atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.rnn import RNNStateEncoder as JRNN
from pointnav_vo_tpu.ops.geometry import pointgoal_polar2cartesian as j_polar2cart
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl import ppo as jppo
from pointnav_vo_tpu.rl import rollout as jrollout
from pointnav_vo_tpu.rl.trainer import act_step as j_act_step
from pointnav_vo_tpu.rl.trainer import propagate_goal as j_propagate_goal
from pointnav_vo_tpu.vo import ensemble as jens_lib
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import stack_expert_variables

from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    policy_variables_from_state_dict,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.models.rnn import RNNStateEncoder as TRNN
from pointnav_vo_tpu_torch.models.rnn import mask_splits
from pointnav_vo_tpu_torch.ops import topdown as ttopdown
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl import ppo as tppo
from pointnav_vo_tpu_torch.rl import trainer as ttrainer
from pointnav_vo_tpu_torch.rl.rollout import RolloutStorage as TStorage
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init

HIDDEN = 32
BASE = 8
LR = 1e-3
GOAL = "pointgoal_with_gps_compass"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _policies(h, w, n=4, seed=4):
    """The same random policy in both packages: (flax module, its
    variables, a fresh port module holding the same weights)."""
    jpol = JPolicy(image_size=(h, w), hidden_size=HIDDEN, baseplanes=BASE)
    obs = {"depth": jnp.zeros((n, h, w, 1)), GOAL: jnp.zeros((n, 2))}
    pvars = fast_init(jpol, obs, jpol.initial_hidden(n), jnp.zeros((n, 1), jnp.int32),
                      jnp.zeros((n, 1)), seed=seed)
    pvars = jax.tree.map(np.asarray, pvars)
    tpol = TPolicy(image_size=(h, w), hidden_size=HIDDEN, baseplanes=BASE)
    tpol.load_state_dict(policy_state_dict_from_jax(pvars), strict=True)
    return jpol, pvars, tpol


def _random_rollout(t, n, obs_shapes, seed, hidden=HIDDEN, packed=4):
    """numpy contents of a filled rollout (returns left zero)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        observations={k: rng.uniform(0, 1, (t + 1, n) + s).astype(f32)
                      for k, s in obs_shapes.items()},
        hidden_states=rng.normal(0, 0.5, (t + 1, packed, n, hidden)).astype(f32),
        rewards=rng.normal(size=(t, n, 1)).astype(f32),
        value_preds=rng.normal(size=(t + 1, n, 1)).astype(f32),
        returns=np.zeros((t + 1, n, 1), f32),
        action_log_probs=np.log(rng.uniform(0.1, 0.9, (t, n, 1))).astype(f32),
        actions=rng.integers(0, 4, (t, n, 1)).astype(np.int64),
        prev_actions=rng.integers(0, 4, (t + 1, n, 1)).astype(np.int64),
        masks=(rng.uniform(size=(t + 1, n, 1)) > 0.2).astype(f32),
    )


def _jstorage(d):
    return jrollout.RolloutStorage(**{
        k: ({o: jnp.asarray(a) for o, a in v.items()} if k == "observations"
            else jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v))
        for k, v in d.items()})


def _tstorage(d):
    return TStorage(**{k: ({o: torch.from_numpy(a.copy()) for o, a in v.items()}
                           if k == "observations" else torch.from_numpy(v.copy()))
                       for k, v in d.items()})


def _storage_np(s):
    """Either package's storage -> numpy dict."""
    fields = ("observations", "hidden_states", "rewards", "value_preds", "returns",
              "action_log_probs", "actions", "prev_actions", "masks")
    out = {}
    for f in fields:
        v = getattr(s, f)
        out[f] = ({k: np.asarray(x) for k, x in v.items()} if f == "observations"
                  else np.asarray(v))
    return out


def _assert_storage_close(got, want, rtol=1e-6, atol=1e-6):
    for f, w in want.items():
        if f == "observations":
            assert set(got[f]) == set(w)
            for k in w:
                np.testing.assert_allclose(got[f][k], w[k], rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(got[f], w, rtol=rtol, atol=atol, err_msg=f)


# ------------------------------------------------------------ rollout storage


def test_insert_step_and_after_update_match_jax():
    t, n = 5, 4
    shapes = {"depth": (3, 3, 1), GOAL: (2,)}
    rng = np.random.default_rng(0)
    base = _random_rollout(t, n, shapes, seed=1)
    js, ts = _jstorage(base), _tstorage(base)
    for step in (0, 2, t - 1):
        obs = {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in shapes.items()}
        hid = rng.normal(size=(4, n, HIDDEN)).astype(np.float32)
        act = rng.integers(0, 4, (n, 1))
        logp, value, reward = (rng.normal(size=(n, 1)).astype(np.float32) for _ in range(3))
        masks = (rng.uniform(size=(n, 1)) > 0.5).astype(np.float32)
        js = jrollout.insert_step(js, jnp.asarray(step), {k: jnp.asarray(v) for k, v in obs.items()},
                                  jnp.asarray(hid), jnp.asarray(act, jnp.int32), jnp.asarray(logp),
                                  jnp.asarray(value), jnp.asarray(reward), jnp.asarray(masks))
        T = torch.from_numpy
        assert ts.insert_step(step, {k: T(v) for k, v in obs.items()}, T(hid), T(act),
                              T(logp), T(value), T(reward), T(masks)) is ts
        _assert_storage_close(_storage_np(ts), _storage_np(js), rtol=0, atol=0)
    js, ts = jrollout.after_update(js), ts.after_update()
    _assert_storage_close(_storage_np(ts), _storage_np(js), rtol=0, atol=0)
    np.testing.assert_array_equal(_storage_np(ts)["masks"][0], _storage_np(ts)["masks"][t])


@pytest.mark.parametrize("use_gae", [True, False])
def test_compute_returns_matches_jax(use_gae):
    t, n = 9, 4
    d = _random_rollout(t, n, {"x": (2,)}, seed=2)
    next_value = np.random.default_rng(3).normal(size=(n, 1)).astype(np.float32)
    want = jrollout.compute_returns(_jstorage(d), jnp.asarray(next_value), use_gae, 0.99, 0.95)
    got = _tstorage(d).compute_returns(torch.from_numpy(next_value), use_gae, 0.99, 0.95)
    _assert_storage_close(_storage_np(got), _storage_np(want))
    assert np.abs(_storage_np(got)["returns"][:t]).max() > 0


def test_storage_create_and_to():
    s = TStorage.create(6, 3, {"rgb": (4, 5, 3), GOAL: (2,)}, 4, HIDDEN)
    assert s.num_steps == 6 and s.num_envs == 3
    assert s.observations["rgb"].shape == (7, 3, 4, 5, 3)
    assert s.observations["rgb"].dtype == torch.float32
    assert s.hidden_states.shape == (7, 4, 3, HIDDEN)
    assert s.actions.dtype == torch.int64 and s.actions.shape == (6, 3, 1)
    s.rewards.fill_(0.25)
    d = s.to("cpu", torch.float64)
    assert d.rewards.dtype == torch.float64 and float(d.rewards.sum()) == 0.25 * 18
    assert d.actions.dtype == torch.int64 and d.prev_actions.dtype == torch.int64
    assert d.observations["rgb"].dtype == d.observations[GOAL].dtype == torch.float64


def test_gather_env_slice_matches_jax():
    t, n = 4, 5
    d = _random_rollout(t, n, {"depth": (2, 2, 1), GOAL: (2,)}, seed=5)
    idx = np.asarray([3, 0])
    want = jppo._gather_env_slice(_jstorage(d), jnp.asarray(idx))
    got = tppo.gather_env_slice(_tstorage(d), torch.from_numpy(idx))
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(want[0][k]))
    for g, w in zip(got[1:], want[1:], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert set(tppo.gather_env_slice(_tstorage(d), torch.from_numpy(idx), ["depth"])[0]) == {
        "depth"}


def test_distributed_mean_and_var_matches_jax():
    x = np.random.default_rng(6).normal(2.0, 3.0, (7, 5, 1)).astype(np.float32)
    want = jppo.distributed_mean_and_var(jnp.asarray(x), None)
    got = tppo.distributed_mean_and_var(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ------------------------------------------------------------ LSTM sequence


# [T, N] masks, T=8, N=4: a 0 resets that env's state before that step
MASK_CASES = {
    "no reset": np.ones((8, 4)),
    "reset at t=0": np.concatenate([np.zeros((1, 4)), np.ones((7, 4))]),
    "reset mid-sequence": np.where(np.arange(8)[:, None] == 5, 0.0, np.ones((8, 4))),
    "different resets per env": np.asarray(
        [[0, 1, 1, 0], [1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1],
         [1, 1, 0, 0], [0, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]], np.float64),
}


def _lstm_inputs(seed=7, t=8, n=4, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, n, d)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (4, n, HIDDEN)).astype(np.float32)
    w_out = rng.normal(size=(t, n, HIDDEN)).astype(np.float32)
    w_hid = rng.normal(size=(4, n, HIDDEN)).astype(np.float32)
    return x, h0, w_out, w_hid


@pytest.fixture(scope="module")
def lstm_pair():
    """The same 2-layer LSTM in both packages and JAX's jitted value and
    gradients of a weighted sum of the outputs and the final state."""
    d = 6
    jrnn = JRNN(input_size=d, hidden_size=HIDDEN, num_layers=2)
    x, h0, _, _ = _lstm_inputs()
    variables = jax.tree.map(np.asarray, fast_init(
        jrnn, jnp.asarray(x), jnp.asarray(h0), jnp.ones((8, 4, 1)), seed=8))
    trnn = TRNN(d, HIDDEN, 2)
    trnn.load_state_dict({f"rnn.{k.replace('w_', 'weight_').replace('b_', 'bias_')}":
                          torch.from_numpy(v.copy()) for k, v in variables["params"].items()},
                         strict=True)

    def objective(params, x, h0, masks, w_out, w_hid):
        out, hid = jrnn.apply({"params": params}, x, h0, masks)
        return jnp.sum(out * w_out) + jnp.sum(hid * w_hid), (out, hid)

    fn = jax.jit(jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True))
    return fn, variables["params"], trnn


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_lstm_sequence_matches_jax(lstm_pair, case):
    """Outputs, final state, and the gradients of a weighted sum of both
    with respect to the inputs, the initial state and the weights."""
    fn, params, trnn = lstm_pair
    x, h0, w_out, w_hid = _lstm_inputs()
    masks = MASK_CASES[case][..., None].astype(np.float32)
    (_, (jout, jhid)), (gp, gx, gh) = fn(params, jnp.asarray(x), jnp.asarray(h0),
                                         jnp.asarray(masks), jnp.asarray(w_out),
                                         jnp.asarray(w_hid))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    trnn.zero_grad()
    out, hid = trnn(tx, th, torch.from_numpy(masks))
    ((out * torch.from_numpy(w_out)).sum() + (hid * torch.from_numpy(w_hid)).sum()).backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(hid.detach().numpy(), np.asarray(jhid), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **tol)
    for k, g in gp.items():
        name = "rnn." + k.replace("w_", "weight_").replace("b_", "bias_")
        np.testing.assert_allclose(dict(trnn.named_parameters())[name].grad.numpy(),
                                   np.asarray(g), err_msg=k, **tol)


def test_lstm_sequence_equals_its_step_loop():
    """The chunked sequence form computes the per-step scan ``h_t =
    step(x_t, h_{t-1} * m_t)``, masks that are not 0 or 1 included."""
    torch.manual_seed(0)
    trnn = TRNN(6, HIDDEN, 2)
    x, h0, _, _ = _lstm_inputs(seed=9)
    masks = MASK_CASES["different resets per env"][..., None].astype(np.float32)
    masks[3, 2] = 0.5
    T = torch.from_numpy
    with torch.no_grad():
        out, hid = trnn(T(x), T(h0), T(masks))
        h = T(h0)
        steps = []
        for t in range(x.shape[0]):
            o, h = trnn(T(x[t]), h, T(masks[t]))
            steps.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(steps).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hid.numpy(), h.numpy(), rtol=1e-5, atol=1e-6)


def test_mask_splits():
    m = torch.from_numpy(MASK_CASES["different resets per env"][..., None])
    assert mask_splits(m) == [0, 2, 4, 5, 7]
    assert mask_splits(torch.ones(5, 3, 1)) == [0]
    assert mask_splits(torch.zeros(1, 3, 1)) == [0]


# ------------------------------------------------------------ policy sequence


def test_policy_sequence_forward_matches_jax():
    h = w = 64
    t, n = 6, 4
    jpol, pvars, tpol = _policies(h, w, n)
    d = _random_rollout(t, n, {"depth": (h, w, 1), GOAL: (2,)}, seed=10)
    obs = {k: v[:t] for k, v in d["observations"].items()}
    hid, prev, masks = d["hidden_states"][0], d["prev_actions"][:t], d["masks"][:t]
    jl, jv, jh = jax.jit(jpol.apply)(pvars, {k: jnp.asarray(v) for k, v in obs.items()},
                                     jnp.asarray(hid), jnp.asarray(prev.astype(np.int32)),
                                     jnp.asarray(masks))
    T = torch.from_numpy
    with torch.no_grad():
        tl, tv, th = tpol({k: T(v) for k, v in obs.items()}, T(hid), T(prev), T(masks))
    assert tl.shape == (t * n, 4) and tv.shape == (t * n, 1) and th.shape == hid.shape
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)


def test_policy_weights_round_trip():
    _, pvars, tpol = _policies(32, 32)
    back = policy_variables_from_state_dict(tpol.state_dict())
    got, want = dict(_leaves(back)), dict(_leaves(pvars))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ------------------------------------------------------------ PPO


def test_optimizer_matches_optax():
    """Clip by global norm, then Adam with eps and the linear lr decay, which
    counts every optimizer step; five steps, the norm above and below the
    clip."""
    cfg = dict(lr=1e-2, eps=1e-5, max_grad_norm=0.5, use_linear_lr_decay=True)
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jppo.make_optimizer(jppo.PPOConfig(**cfg), total_updates=4)
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = tppo.make_optimizer(tparams, tppo.PPOConfig(**cfg), total_updates=4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for step, scale in enumerate((3.0, 0.01, 1.0, 0.2, 2.0)):
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for p, k in zip(tparams, ("a", "b")):
            # a few ulp: torch's Adam and optax round the bias corrections apart
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=5e-7, err_msg=f"{k} after step {step}")
    assert opt.count == 5 and opt.lr_at(4) == 0.0 and opt.lr_at(1) == pytest.approx(7.5e-3)


def _record_first_grads():
    """An optax stage that passes updates through and keeps the first
    minibatch's raw gradients in its state."""

    def init(params):
        return (jnp.zeros([], jnp.int32), jax.tree.map(jnp.zeros_like, params))

    def update(updates, state, params=None):
        count, first = state
        first = jax.tree.map(lambda f, g: jnp.where(count == 0, g, f), first, updates)
        return updates, (count + 1, first)

    return optax.GradientTransformation(init, update)


def _jax_order(rng, cfg, n_envs):
    """The minibatch order JAX's ppo_update draws from ``rng``."""
    n_per_mb = n_envs // cfg.num_mini_batch
    out = []
    for _ in range(cfg.ppo_epoch):
        rng, sub = jax.random.split(rng)
        perm = np.asarray(jax.random.permutation(sub, n_envs))
        out.append(perm[: n_per_mb * cfg.num_mini_batch].reshape(cfg.num_mini_batch, n_per_mb))
    return np.stack(out)


def _assert_params_close(got_vars, want_vars, first_grads, steps, lr=LR):
    got, want = dict(_leaves(got_vars)), dict(_leaves(want_vars))
    grads = dict(_leaves(first_grads))
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert float(err.max()) <= 2 * lr * steps, (k, float(err.max()))
        g = np.abs(grads[k])
        strong = g > 1e-3 * g.max()
        assert float(err[strong].max(initial=0.0)) <= 1e-3 * lr, (k, float(err[strong].max()))


def _assert_grads_close(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert float(np.abs(got[k] - w).max()) <= 1e-3 * float(np.abs(w).max()) + 1e-7, k


@pytest.mark.parametrize("normalized_advantage", [False, True])
def test_ppo_update_matches_jax(normalized_advantage):
    """ppo_epoch 2, num_mini_batch 2 on one random rollout, from the same
    weights and in JAX's minibatch order: the loss terms, the first
    minibatch's gradients (JAX's, kept by an optax stage ahead of its
    optimizer) and the parameters after the four Adam steps."""
    h = w = 64
    t, n = 6, 4
    kw = dict(ppo_epoch=2, num_mini_batch=2, lr=LR, num_steps=t, hidden_size=HIDDEN,
              use_normalized_advantage=normalized_advantage)
    jcfg, tcfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    jpol, pvars, tpol = _policies(h, w, n)
    d = _random_rollout(t, n, {"depth": (h, w, 1), GOAL: (2,)}, seed=12)
    js = jrollout.compute_returns(_jstorage(d), jnp.asarray(d["value_preds"][t]), True,
                                  0.99, 0.95)
    d = _storage_np(js)
    d["actions"], d["prev_actions"] = (d[k].astype(np.int64) for k in ("actions",
                                                                       "prev_actions"))
    rng = jax.random.PRNGKey(13)
    tx = optax.chain(_record_first_grads(), jppo.make_optimizer(jcfg))
    jparams, jstate, jstats = jppo.ppo_update(jpol, jcfg, tx, pvars["params"],
                                              tx.init(pvars["params"]), js, rng)
    first_grads = {"params": jax.tree.map(np.asarray, jstate[0][1])}
    order = torch.from_numpy(_jax_order(rng, jcfg, n))

    # the first minibatch's loss gradients, from the start weights
    ts = _tstorage(d)
    adv = ts.returns[:-1] - ts.value_preds[:-1]
    if normalized_advantage:
        mean, var = tppo.distributed_mean_and_var(adv)
        adv = (adv - mean) / (var.sqrt() + tppo.EPS_PPO)
    probe = copy.deepcopy(tpol)
    idx = order[0, 0]
    mb = tppo.gather_env_slice(ts, idx, probe.observation_keys) + (adv[:, idx],)
    total, _ = tppo.ppo_loss(probe, tcfg, mb, tcfg.clip_param)
    total.backward()
    _assert_grads_close(
        policy_variables_from_state_dict({k: p.grad for k, p in probe.named_parameters()}),
        first_grads)

    opt = tppo.make_optimizer(tpol.parameters(), tcfg)
    stats = tppo.ppo_update(tpol, tcfg, opt, ts, order=order)
    assert opt.count == 4
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_params_close(policy_variables_from_state_dict(tpol.state_dict()),
                         {"params": jax.tree.map(np.asarray, jparams)}, first_grads, steps=4)


def test_ppo_update_checks_its_order():
    t, n = 3, 4
    _, _, tpol = _policies(32, 32, n)
    cfg = tppo.PPOConfig(num_steps=t, hidden_size=HIDDEN)
    ts = _tstorage(_random_rollout(t, n, {"depth": (32, 32, 1), GOAL: (2,)}, seed=14))
    opt = tppo.make_optimizer(tpol.parameters(), cfg)
    with pytest.raises(ValueError, match="order or a generator"):
        tppo.ppo_update(tpol, cfg, opt, ts)
    with pytest.raises(ValueError, match="shape"):
        tppo.ppo_update(tpol, cfg, opt, ts, order=torch.zeros(1, 2, 1, dtype=torch.long))
    with pytest.raises(ValueError, match="minibatches"):
        tppo.ppo_update(tpol, tppo.PPOConfig(num_mini_batch=5), opt, ts,
                        generator=torch.Generator())
    order = tppo.minibatch_order(tppo.PPOConfig(ppo_epoch=3, num_mini_batch=2), 5,
                                 torch.Generator().manual_seed(0))
    assert order.shape == (3, 2, 2)
    for epoch in order:
        assert len(set(epoch.flatten().tolist())) == 4  # distinct envs an epoch


# ------------------------------------------------------------ the trainer


def _env_kw(size, cap):
    return dict(image_h=size, image_w=size, max_episode_steps=cap,
                actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                depth_noise_multiplier=0.0)


def _ensembles(size, hidden=64):
    """The same three random det experts in both packages."""
    jcfg = JCfg(vis_size_w=size, vis_size_h=size, hidden_size=hidden)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, size, size, 6)), "depth": jnp.zeros((1, size, size, 2)),
             "discretized_depth": jnp.zeros((1, size, size, 20)),
             "top_down_view": jnp.zeros((1, size, size, 2))}
    stacked = stack_expert_variables(
        [fast_init(model, dummy, train=False, seed=i) for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    tcfg = TCfg(vis_size_w=size, vis_size_h=size, hidden_size=hidden)
    return JEnsemble(jcfg, stacked), TEnsemble(tcfg, sds, device="cpu")


def test_trainer_rollout_and_update_match_jax():
    """The port's DDPPOTrainer with det VO in the loop collects a rollout on
    the scripted envs; its sampled actions, replayed through the JAX
    package's envs, VOEnsemble.predict_step_cached and propagate_goal, give
    the stored observations, goals, rewards and masks, and the JAX policy
    gives the stored values, log-probs and states.  JAX's compute_returns
    and ppo_update (num_mini_batch 1) on that rollout from the same start
    weights give the port's updated parameters."""
    size, t, n = 32, 8, 4
    kw = dict(num_steps=t, num_mini_batch=1, ppo_epoch=1, lr=LR, hidden_size=HIDDEN)
    jcfg, tcfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    env_kw = _env_kw(size, cap=5)  # episodes end inside the rollout
    jens, tens = _ensembles(size)
    jpol, pvars, tpol = _policies(size, size, n)
    trainer = ttrainer.DDPPOTrainer(
        model=tpol, ppo_cfg=tcfg, envs=tenvs.make_scripted_vector_env(
            tenvs.EnvConfig(**env_kw), n, seed=7),
        device="cpu", state_dict=policy_state_dict_from_jax(pvars),
        generator=torch.Generator().manual_seed(0), vo_ensemble=tens)
    trainer.collect_rollout()
    roll = _storage_np(trainer.rollouts)
    assert 0 < roll["masks"][1:].sum() < t * n  # some episodes ended

    # replay the sampled actions through the JAX package
    envs = jenvs.make_scripted_vector_env(jenvs.EnvConfig(**env_kw), n, seed=7)
    obs = envs.reset()
    goal = j_polar2cart(jnp.asarray(obs[GOAL]))
    np.testing.assert_array_equal(roll["observations"]["depth"][0], obs["depth"])
    np.testing.assert_array_equal(roll["observations"][GOAL][0], obs[GOAL])
    feats = jens_lib.frame_features_packed(jnp.asarray(obs["rgb"]), jnp.asarray(obs["depth"]),
                                           jens.cfg)
    for step in range(t):
        actions = roll["actions"][step, :, 0]
        obs, rewards, dones, infos = envs.step(actions)
        for k in ("rgb", "depth"):
            np.testing.assert_array_equal(roll["observations"][k][step + 1], obs[k])
        np.testing.assert_array_equal(roll["rewards"][step, :, 0], rewards)
        np.testing.assert_array_equal(roll["masks"][step + 1, :, 0], 1.0 - dones)
        delta, feats = jens.predict_step_cached(feats, jnp.asarray(obs["rgb"]),
                                                jnp.asarray(obs["depth"]), actions)
        goal, polar = j_propagate_goal(goal, delta, jnp.asarray(dones, jnp.float32)[:, None],
                                       jnp.asarray(obs[GOAL]))
        np.testing.assert_allclose(roll["observations"][GOAL][step + 1], np.asarray(polar),
                                   rtol=1e-4, atol=1e-5, err_msg=f"goal at step {step}")

    # the JAX policy over the stored sequence: values, log-probs, states
    js = _jstorage(roll)
    seq_obs = {k: v[:t] for k, v in js.observations.items()}
    logits, values, hid = jax.jit(jpol.apply)(pvars, seq_obs, js.hidden_states[0],
                                              js.prev_actions[:t], js.masks[:t])
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(roll["value_preds"][:t].reshape(t * n, 1), values, **tol)
    logp = jax.nn.log_softmax(logits)[np.arange(t * n), roll["actions"].reshape(-1)]
    np.testing.assert_allclose(roll["action_log_probs"].reshape(-1), logp, **tol)
    np.testing.assert_allclose(roll["hidden_states"][t], hid, **tol)

    # JAX's returns and update on the port's rollout
    last_obs = {k: v[t] for k, v in js.observations.items()}
    next_value = j_act_step(jpol, pvars, last_obs, js.hidden_states[t],
                            js.prev_actions[t], js.masks[t], jax.random.PRNGKey(0),
                            deterministic=True)[0]
    js = jrollout.compute_returns(js, next_value, True, jcfg.gamma, jcfg.tau)
    tx = optax.chain(_record_first_grads(), jppo.make_optimizer(jcfg))
    jparams, jstate, jstats = jppo.ppo_update(jpol, jcfg, tx, pvars["params"],
                                              tx.init(pvars["params"]), js,
                                              jax.random.PRNGKey(1))
    stats = trainer.update_agent()
    np.testing.assert_allclose(_storage_np(trainer.rollouts)["returns"][:t],
                               np.asarray(js.returns[:t]), **tol)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_params_close(policy_variables_from_state_dict(trainer.model.state_dict()),
                         {"params": jax.tree.map(np.asarray, jparams)},
                         {"params": jax.tree.map(np.asarray, jstate[0][1])}, steps=1)
    # after_update carried the last slot to slot 0
    rolled = _storage_np(trainer.rollouts)
    np.testing.assert_array_equal(rolled["observations"][GOAL][0], roll["observations"][GOAL][t])


def _small_trainer(n, t, cap, size=16, **kw):
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in tppo.PPOConfig.__dataclass_fields__}
    cfg = tppo.PPOConfig(num_steps=t, num_mini_batch=min(2, n), hidden_size=16, **cfg_kw)
    envs = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**_env_kw(size, cap)), n, seed=1)
    return ttrainer.DDPPOTrainer(
        model=TPolicy(image_size=(size, size), hidden_size=16, baseplanes=BASE),
        ppo_cfg=cfg, envs=envs, device="cpu", init_generator=torch.Generator().manual_seed(3),
        generator=torch.Generator().manual_seed(4), **kw)


def test_training_goals_track_gt_under_perfect_vo():
    """Mirror of tests/test_tune_with_vo.py: a perfect VO (the env's
    ground-truth delta through the ``vo_fn`` hook) keeps the goal stored in
    the rollout, which the policy trains on, equal to the GPS sensor."""
    gps_trace = []

    def perfect_vo(prev_obs, new_obs, actions_np, infos):
        gps_trace.append(np.asarray(new_obs[GOAL]))
        return np.stack([i["gt_delta"] for i in infos])

    trainer = _small_trainer(3, 12, cap=9, vo_fn=perfect_vo)
    trainer.collect_rollout()
    stats = trainer.update_agent()
    assert all(np.isfinite(v) for v in stats.values())
    stored = trainer.rollouts.observations[GOAL].numpy()
    assert len(gps_trace) == 12
    for t, gps in enumerate(gps_trace):
        # slot 0 is the carried last slot after the update
        np.testing.assert_allclose(stored[t + 1] if t + 1 < 12 else stored[0], gps,
                                   atol=2e-2, err_msg=f"step {t}")


def test_trainer_counts_steps_reward_window_and_clip_decay(monkeypatch):
    n, t, updates, total = 2, 5, 3, 4
    clips = []
    real_update = ttrainer.ppo_update

    def recording_update(*args, clip_param=None, **kwargs):
        clips.append(clip_param)
        return real_update(*args, clip_param=clip_param, **kwargs)

    monkeypatch.setattr(ttrainer, "ppo_update", recording_update)
    trainer = _small_trainer(n, t, cap=3, use_linear_clip_decay=True, total_updates=total)
    rewards, dones = [], []
    step = trainer.envs.step

    def recording_step(actions):
        out = step(actions)
        rewards.append(out[1])
        dones.append(out[2])
        return out

    trainer.envs.step = recording_step
    history = trainer.train(updates)
    assert trainer.count_steps == updates * t * n
    assert [h["count_steps"] for h in history] == [t * n * (u + 1) for u in range(updates)]
    np.testing.assert_allclose(clips, [0.2 * (1 - u / total) for u in range(updates)])
    # the window holds each finished episode's summed reward, in order
    window, running = [], np.zeros(n)
    for r, d in zip(rewards, dones):
        running += r
        for i in np.nonzero(d)[0]:
            window.append(running[i])
            running[i] = 0.0
    assert len(window) >= 4  # episodes of at most 3 steps
    np.testing.assert_allclose(list(trainer.reward_window), window)
    np.testing.assert_allclose(history[-1]["mean_episode_reward"], np.mean(window))
    assert trainer.optimizer.count == updates * trainer.cfg.num_mini_batch
    assert set(trainer.timing) == {"env", "act", "vo", "update"}


@pytest.mark.parametrize("mode", ["det", "rnd"])
def test_trainer_vo_runs_bin_counts_once_a_step(monkeypatch, mode):
    """Each frame's VO features are built once: steps + 1 binnings over two
    updates, the first frame's included; the goals stay finite."""
    calls = []
    real = ttopdown.bin_counts

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ttopdown, "bin_counts", counting)
    size, n, t = 32, 2, 3
    vo = TEnsemble(TCfg(vis_size_w=size, vis_size_h=size, hidden_size=16, mode=mode,
                        rnd_mode_n=3), experts=[
        TCfg(vis_size_w=size, vis_size_h=size, hidden_size=16).make_model() for _ in range(3)],
        device="cpu")
    trainer = _small_trainer(n, t, cap=4, size=size, vo_ensemble=vo)
    history = trainer.train(2)
    assert calls == [n] * (2 * t + 1)
    assert np.isfinite(trainer.rollouts.observations[GOAL].numpy()).all()
    assert all(np.isfinite(v) for h in history for v in h.values())


def test_trainer_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    envs = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**_env_kw(16, 5)), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.DDPPOTrainer(model=TPolicy(image_size=(16, 16), hidden_size=16,
                                            baseplanes=BASE),
                              ppo_cfg=tppo.PPOConfig(num_steps=2), envs=envs)
