"""Port parity, rnd mode and action sampling: the VO ensemble's dropout
passes (mean and population std), the fused eval step and
``Evaluator.run`` in rnd mode, ``sample_action`` and ``entropy`` of
pointnav_vo_tpu_torch against the JAX package (CPU, small sizes).

JAX and torch draw different random bits, so rnd mode is held to JAX at
dropout 0 (mean equal to the det forward, std 0) and, with dropout on, to
a pass-by-pass loop over the same injected keep masks; sampling is held
to its distribution (a chi-square bound over 20,000 draws).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.policy import entropy as j_entropy
from pointnav_vo_tpu.ops.geometry import pointgoal_polar2cartesian as j_polar2cart
from pointnav_vo_tpu.rl.eval import fused_vo_act_step as j_fused
from pointnav_vo_tpu.vo import ensemble as jens_lib
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import stack_expert_variables

from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.models.policy import action_log_prob, entropy, sample_action
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.eval import Evaluator as TEvaluator
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step as t_fused
from pointnav_vo_tpu_torch.vo import ensemble as tens_lib
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init
from test_torch_port_eval import TGreedy

RTOL, ATOL = 1e-4, 1e-5  # fp32; conv/GroupNorm sums run in another order
H, W = 32, 48
HIDDEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _ensembles(mode="rnd", dropout_p=0.0, k=4, h=H, w=W):
    """The same three random experts in both packages."""
    kw = dict(vis_size_w=w, vis_size_h=h, hidden_size=HIDDEN, mode=mode,
              dropout_p=dropout_p, rnd_mode_n=k)
    jcfg = JCfg(**kw)
    model = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, h, w, 6)), "depth": jnp.zeros((1, h, w, 2)),
             "discretized_depth": jnp.zeros((1, h, w, 20)),
             "top_down_view": jnp.zeros((1, h, w, 2))}
    stacked = stack_expert_variables(
        [fast_init(model, dummy, train=False, seed=i) for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    return JEnsemble(jcfg, stacked), TEnsemble(TCfg(**kw), sds, device="cpu")


def _frames(n, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    rgb = [rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8) for _ in range(2)]
    depth = [rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32) for _ in range(2)]
    return rgb[0], depth[0], rgb[1], depth[1]


ACTIONS = np.asarray([1, 2, 3, 1, 0, 3, 1], np.int32)  # STOP runs the forward expert


@pytest.mark.parametrize("twins", [False, True])
def test_pair_assembly_matches_jax(twins):
    pr, pd, cr, cd = _frames(4, seed=1)
    jcfg, tcfg = JCfg(vis_size_w=W, vis_size_h=H), TCfg(vis_size_w=W, vis_size_h=H)
    jfn = jens_lib.preprocess_obs_pairs_twins if twins else jens_lib.preprocess_obs_pairs
    tfn = tens_lib.preprocess_obs_pairs_twins if twins else tens_lib.preprocess_obs_pairs
    jp = jens_lib.preprocess_obs_pairs_twins_packed if twins else jens_lib.preprocess_obs_pairs_packed
    tp = tens_lib.preprocess_obs_pairs_twins_packed if twins else tens_lib.preprocess_obs_pairs_packed
    want = jfn(*(jnp.asarray(a) for a in (pr, pd, cr, cd)), jcfg)
    got = tfn(*(torch.from_numpy(a) for a in (pr, pd, cr, cd)), tcfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == ((8 if twins else 4), H, W, want[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2.4e-7,
                                   err_msg=k)
    packed = tp(*(torch.from_numpy(a) for a in (pr, pd, cr, cd)), tcfg)
    np.testing.assert_allclose(packed.numpy(),
                               np.asarray(jp(*(jnp.asarray(a) for a in (pr, pd, cr, cd)), jcfg)),
                               rtol=0, atol=2.4e-7)


def test_rnd_at_dropout_zero_matches_jax():
    """Dropout 0: every pass is the det forward; JAX's rnd _predict mean
    equals the port's and both stds are exactly 0."""
    jens, tens = _ensembles(dropout_p=0.0)
    pr, pd, cr, cd = _frames(ACTIONS.size, seed=2)
    obs = jens_lib.preprocess_obs_pairs(*(jnp.asarray(a) for a in (pr, pd, cr, cd)), jens.cfg)
    jmean, jstd = jens.predict(obs, jnp.asarray(ACTIONS), jax.random.PRNGKey(0))
    tobs = tens_lib.preprocess_obs_pairs_packed(
        *(torch.from_numpy(a) for a in (pr, pd, cr, cd)), tens.cfg)
    mean, std = tens.predict_rnd_packed(tobs, ACTIONS, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=ATOL)
    assert float(np.abs(np.asarray(jstd)).max()) == 0.0
    # the passes are one batched product, each pass computed alike
    assert float(std.abs().max()) == 0.0
    np.testing.assert_allclose(mean.numpy(), tens.predict_packed(tobs, ACTIONS).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_rnd_passes_equal_a_pass_by_pass_loop():
    """Injected keep masks: the K passes at once equal K single passes of
    each sample's own expert; the std is the population std."""
    k = 5
    _, tens = _ensembles(dropout_p=0.3, k=k)
    pr, pd, cr, cd = _frames(ACTIONS.size, seed=3)
    obs = tens_lib.preprocess_obs_pairs_packed(
        *(torch.from_numpy(a) for a in (pr, pd, cr, cd)), tens.cfg)
    masks = tens.draw_masks(torch.Generator().manual_seed(4), ACTIONS.size)
    assert masks[0].shape[:2] == (k, ACTIONS.size) and masks[0].dtype == torch.bool
    assert 0.6 < float(masks[0].float().mean()) < 0.8  # keep 0.7
    mean, std = tens.predict_rnd_packed(obs, ACTIONS, masks=masks)
    loop = np.zeros((k, ACTIONS.size, 3), np.float32)
    with torch.no_grad():
        for p in range(k):
            for i, a in enumerate(ACTIONS):
                expert = tens.experts[min(max(int(a) - 1, 0), 2)]
                loop[p, i] = expert(obs[i:i + 1], masks=(masks[0][p, i:i + 1],
                                                         masks[1][p, i:i + 1]))[0].numpy()
    np.testing.assert_allclose(mean.numpy(), loop.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), loop.std(0), rtol=1e-4, atol=1e-6)
    assert not np.allclose(std.numpy(), loop.std(0, ddof=1), rtol=1e-3)
    assert float(std.min()) > 0.0


def test_rnd_masks_come_from_the_generator():
    _, tens = _ensembles(dropout_p=0.2, k=3)
    pr, pd, cr, cd = _frames(ACTIONS.size, seed=5)
    obs = tens_lib.preprocess_obs_pairs_packed(
        *(torch.from_numpy(a) for a in (pr, pd, cr, cd)), tens.cfg)

    def run(seed):
        return tens.predict_rnd_packed(obs, ACTIONS, torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="generator"):
        tens.predict_rnd_packed(obs, ACTIONS)


@pytest.mark.parametrize("mode", ["det", "rnd"])
def test_step_is_the_pair_primitive_on_the_cached_pair(mode):
    """``VOEnsemble.step`` is the mode's pair primitive on ``cat(prev,
    cur)``, bit for bit on the same masks; it returns the new frame's
    packed features, and det's std is exactly 0."""
    _, tens = _ensembles(mode=mode, dropout_p=0.3, k=3)
    pr, pd, cr, cd = (torch.from_numpy(a) for a in _frames(ACTIONS.size, seed=13))
    prev = tens_lib.frame_features_packed(pr, pd, tens.cfg)
    masks = tens.draw_masks(torch.Generator().manual_seed(14), ACTIONS.size)
    delta, std, cur = tens.step(prev, cr, cd, ACTIONS, masks=masks)
    assert torch.equal(cur, tens_lib.frame_features_packed(cr, cd, tens.cfg))
    pair = torch.cat([prev, cur], dim=-1)
    if mode == "det":
        want = (tens.predict_packed(pair, ACTIONS), torch.zeros(ACTIONS.size, 3))
    else:
        want = tens.predict_rnd_packed(pair, ACTIONS, masks=masks)
        assert float(std.min()) > 0.0
    assert torch.equal(delta, want[0]) and torch.equal(std, want[1])


def test_train_mode_applies_no_dropout_by_itself():
    """``.train()`` does not switch the trunk's Dropout entries on: only
    keep masks do, so no dropout is ever applied twice."""
    model = TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.5).make_model()
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (3, H, W, 30)).astype(np.float32))
    with torch.no_grad():
        det = model.eval()(x)
        assert torch.equal(model.train()(x), det)
        ones = (torch.ones(3, model.flat_size, dtype=torch.bool),
                torch.ones(3, model.hidden_size, dtype=torch.bool))
        scaled = model(x, masks=ones)
    assert not torch.allclose(scaled, det)  # kept units are scaled by 1 / (1 - p)


def test_fused_rnd_step_matches_jax_at_dropout_zero():
    """One rnd fused step with the real actor-critic (dropout 0, mode
    action); every output compared, std included."""
    n, hidden = ACTIONS.size, 32
    jens, tens = _ensembles(dropout_p=0.0, k=3)
    from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy

    jpol = JPolicy(image_size=(H, W), hidden_size=hidden, baseplanes=8)
    rng = np.random.default_rng(11)
    pr, pd, cr, cd = _frames(n, seed=12)
    sensor = np.stack([rng.uniform(0.2, 5, n), rng.uniform(-np.pi, np.pi, n)],
                      -1).astype(np.float32)
    goal = np.array(j_polar2cart(jnp.asarray(sensor[::-1].copy())))
    reset = (rng.uniform(size=(n, 1)) < 0.3).astype(np.float32)
    hid = rng.normal(size=(4, n, hidden)).astype(np.float32)
    masks = 1.0 - reset
    q = rng.normal(size=(n, 4))
    est_rot = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    est_pos = rng.normal(size=(n, 3)).astype(np.float32)
    seed_rot = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1))
    seed_pos = np.zeros((n, 3), np.float32)
    J = jnp.asarray
    pvars = fast_init(jpol, {"depth": J(cd), "pointgoal_with_gps_compass": J(sensor)},
                      J(hid), J(ACTIONS[:, None]), J(masks), seed=4)
    want = j_fused(jpol, jens.model, jens.cfg, pvars, jens.variables, J(pr), J(pd), J(cr),
                   J(cd), J(ACTIONS), J(goal), J(reset), J(sensor), J(hid),
                   J(ACTIONS[:, None]), J(masks), jax.random.PRNGKey(0),
                   jax.random.PRNGKey(1), deterministic=True, est_rot=J(est_rot),
                   est_pos=J(est_pos), est_seed_rot=J(seed_rot), est_seed_pos=J(seed_pos))
    want = [x if isinstance(x, dict) else np.asarray(x) for x in want]
    tpol = TPolicy(image_size=(H, W), hidden_size=hidden, baseplanes=8)
    tpol.load_state_dict(policy_state_dict_from_jax(jax.tree.map(np.asarray, pvars)),
                         strict=True)
    T = torch.from_numpy
    prev_feats = tens_lib.frame_features_packed(T(pr), T(pd), tens.cfg)
    got = t_fused(tpol.eval(), tens, prev_feats, T(cr), T(cd), ACTIONS, T(goal), T(reset),
                  T(sensor), T(hid), T(ACTIONS[:, None]).long(), T(masks), T(est_rot),
                  T(est_pos), T(seed_rot), T(seed_pos),
                  generator=torch.Generator().manual_seed(0))
    got = [x.numpy() for x in got]
    # JAX: (goal, polar, delta, std, value, action, logp, hidden, feats, rot, pos),
    # its rnd feats the per-key dict; the port's are packed
    names = ("goal", "polar", "delta", "std", "value", "action", "logp", "hidden",
             None, "est_rot", "est_pos")
    for name, g, w in zip(names, got, want):
        if name == "action":
            np.testing.assert_array_equal(g, w)
        elif name is not None:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def _run_evaluator(mode, dropout_p, deterministic=True, seed=0, policy=None):
    h = w = 32
    kw = dict(image_h=h, image_w=w, max_episode_steps=10, actuation_noise_multiplier=0.0,
              rgb_noise_intensity=0.0, depth_noise_multiplier=0.0)
    _, tens = _ensembles(mode=mode, dropout_p=dropout_p, k=4, h=h, w=w)
    cfg = tenvs.EnvConfig(**kw)
    ev = TEvaluator(model=policy or TGreedy(cfg.turn_angle_deg, cfg.success_distance),
                    envs=tenvs.make_scripted_vector_env(cfg, 3, seed=7), vo_ensemble=tens,
                    device="cpu", deterministic=deterministic,
                    generator=torch.Generator().manual_seed(seed))
    return ev.run(num_episodes=5), ev.results


def test_evaluator_rnd_reports_the_std():
    agg, results = _run_evaluator("rnd", 0.2)
    assert agg["episodes"] == 5 and len(results) == 5
    assert all(np.isfinite(v) for v in agg.values())
    assert agg["vo_pred_std_mean"] > 0.0
    assert all(r.vo_pred_std_mean > 0.0 for r in results)
    again, _ = _run_evaluator("rnd", 0.2)  # the same generator seed
    for k, v in agg.items():
        if not k.startswith("time_"):
            assert again[k] == v, k


def test_evaluator_rnd_at_dropout_zero_equals_det():
    rnd, rnd_results = _run_evaluator("rnd", 0.0)
    det, det_results = _run_evaluator("det", 0.0)
    assert det["vo_pred_std_mean"] == 0.0
    assert rnd["vo_pred_std_mean"] == 0.0
    for key in ("episodes", "success", "spl", "total_env_steps", "stuck_dx"):
        assert rnd[key] == det[key], key
    for key in ("vo_l2_mean", "global_drift_mean", "distance_to_goal"):
        np.testing.assert_allclose(rnd[key], det[key], rtol=1e-5, err_msg=key)
    assert [r.steps for r in rnd_results] == [r.steps for r in det_results]


def test_evaluator_samples_actions():
    """deterministic=False: a real actor-critic acts by draws from the
    evaluator's generator; the same seed repeats the run."""

    def policy():
        torch.manual_seed(0)
        return TPolicy(image_size=(32, 32), hidden_size=16, baseplanes=8)

    a, ra = _run_evaluator("det", 0.0, deterministic=False, seed=3, policy=policy())
    b, rb = _run_evaluator("det", 0.0, deterministic=False, seed=3, policy=policy())
    assert a["episodes"] == 5
    assert [r.steps for r in ra] == [r.steps for r in rb]
    assert a["vo_l2_mean"] == b["vo_l2_mean"]


def test_entropy_matches_jax():
    logits = np.random.default_rng(8).normal(0, 2, (9, 4)).astype(np.float32)
    logits[0] = [50.0, -50.0, 0.0, 0.0]  # near-one-hot rows stay finite
    np.testing.assert_allclose(entropy(torch.from_numpy(logits)).numpy(),
                               np.asarray(j_entropy(jnp.asarray(logits))), rtol=1e-6,
                               atol=1e-7)


def test_sample_action_follows_the_softmax():
    """20,000 draws from fixed logits: chi-square with 3 degrees of freedom
    under 16.27 (its 0.999 quantile), every action drawn, the log-probs of
    the draws equal log_softmax."""
    logits = torch.tensor([0.5, -1.0, 2.0, 0.1])
    n = 20_000
    draws = sample_action(torch.Generator().manual_seed(9), logits.expand(n, 4))
    assert draws.shape == (n, 1) and draws.dtype == torch.int64
    counts = torch.bincount(draws[:, 0], minlength=4).double()
    expected = torch.softmax(logits.double(), -1) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 16.27, (chi2, counts.tolist())
    assert bool((counts > 0).all())
    logp = action_log_prob(logits.expand(n, 4), draws)
    np.testing.assert_allclose(logp.numpy()[:, 0],
                               torch.log_softmax(logits, -1)[draws[:, 0]].numpy(), rtol=1e-6)
