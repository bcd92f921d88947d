"""Port parity, reduced precision: bf16 VO inference, the int8 feature cache
and bf16 mixed-precision VO training of pointnav_vo_tpu_torch against the
JAX package run with ``dtype=jnp.bfloat16`` and ``cache_dtype="int8"``
(CPU, 32x32 frames, JAX-exported weights), the paths that carry a feature
cache, the CLI's precision keys, the in-memory frame-pair reader and the
994-episode protocol's pieces.

Tolerances, each measured on this CPU first:

- packed features: ``torch.equal`` to JAX's in fp32+int8, bf16 and
  bf16+int8 (measured equal; only the fp32 pack's rgb/255 differs by 1 ulp,
  XLA multiplying by the reciprocal, tests/test_torch_port_rnd.py);
- bf16 deltas: relative L2 distance from JAX's bf16 deltas at most
  ``BF16_REL`` of the JAX fp32 deltas' norm (measured 2.5e-3 det, gate
  about twice that);
- bf16 train step: loss within 2e-2 relative of JAX's (measured 3e-5 and
  2e-4).  Gradients: the forward stage's within relative L2 5e-2 of JAX's
  per tensor (measured at most 1.5e-2).  The joint stage's inverse loss
  pairs twins whose gradients largely cancel, and XLA on the CPU keeps
  excess precision between a bf16 op and its float32 consumer (with
  ``--xla_allow_excess_precision=false`` the distance falls from 20 % to
  7 %), so per tensor the two bf16 runs differ about as much as bf16
  differs from float32 (10-24 %): there all the gradients together are
  held within relative L2 5e-2 (measured 3.4e-2), and each tensor within
  3x its own distance between the port's bf16 and float32 gradients
  (measured at most 2.35x).
"""

import copy
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.ops.geometry import pointgoal_polar2cartesian as j_polar2cart
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl.eval import fused_vo_act_step as j_fused
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import engine as jengine
from pointnav_vo_tpu.vo import ensemble as jens_lib
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import bucket_expert_indices_static, stack_expert_variables

from pointnav_vo_tpu_torch import run as trun
from pointnav_vo_tpu_torch.deploy.challenge_agent import PointNavVOAgent
from pointnav_vo_tpu_torch.examples import eval_994
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    seeded_init_,
    split_expert_variables,
    stacked_vo_variables,
    vo_state_dict_from_jax,
    vo_state_dicts_from_stacked,
    vo_variables_from_state_dict,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step as t_fused
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo import ensemble as tens_lib
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init
from test_eval import GreedyGoalPolicy as JGreedy
from test_torch_port_vo_train import _jax_experts, _leaves

H = W = 32
HIDDEN = 32
N = 8
ACTIONS = np.asarray([1, 1, 2, 3, 1, 2, 0, 1], np.int32)  # STOP runs the forward expert
BF16_REL = 5e-3  # bf16 deltas, port vs JAX, over the JAX fp32 deltas' norm (measured 2.5e-3)
PRECISIONS = [("fp32", "int8"), ("bf16", "native"), ("bf16", "int8")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(precision="fp32", cache_dtype="native", **kw):
    return JCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, cache_dtype=cache_dtype,
                dtype=jnp.bfloat16 if precision == "bf16" else jnp.float32, **kw)


def _tcfg(precision="fp32", cache_dtype="native", **kw):
    return TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, precision=precision,
                cache_dtype=cache_dtype, **kw)


@pytest.fixture(scope="module")
def experts():
    """Three random experts: the JAX stacked variables and their export."""
    model = _jcfg().make_model()
    dummy = {"rgb": jnp.zeros((1, H, W, 6)), "depth": jnp.zeros((1, H, W, 2)),
             "discretized_depth": jnp.zeros((1, H, W, 20)),
             "top_down_view": jnp.zeros((1, H, W, 2))}
    stacked = stack_expert_variables([fast_init(model, dummy, train=False, seed=i)
                                      for i in range(3)])
    sds = [vo_state_dict_from_jax(v)
           for v in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    return stacked, sds


@pytest.fixture(scope="module")
def frames():
    """Two consecutive observations of scripted envs (real depth for the
    top-down projection)."""
    env = jenvs.make_scripted_vector_env(jenvs.EnvConfig(image_h=H, image_w=W), N, seed=3)
    o0 = env.reset()
    o1 = env.step(np.where(ACTIONS == 0, 1, ACTIONS))[0]
    return o0, o1


def _rgb_depth(obs):
    return obs["rgb"].astype(np.uint8), obs["depth"].astype(np.float32)


# ---------------------------------------------------------------- features


@pytest.mark.parametrize("precision,cache_dtype", PRECISIONS)
def test_packed_features_equal_jax(frames, precision, cache_dtype):
    rgb, depth = _rgb_depth(frames[0])
    want = jens_lib.frame_features_packed(jnp.asarray(rgb), jnp.asarray(depth),
                                          _jcfg(precision, cache_dtype))
    got = tens_lib.frame_features_packed(torch.from_numpy(rgb), torch.from_numpy(depth),
                                         _tcfg(precision, cache_dtype))
    dtype = torch.int8 if cache_dtype == "int8" else (
        torch.bfloat16 if precision == "bf16" else torch.float32)
    assert got.dtype == dtype and got.shape == (N, H, W, 15)
    assert torch.equal(got.float(), torch.from_numpy(np.asarray(want.astype(jnp.float32))))


def test_int8_pack_rounds_and_clips():
    """round(x * 127), then clipped to [0, 127]: 0.5/127 rounds to even."""
    cfg = _tcfg(cache_dtype="int8")
    feats = {"depth": torch.tensor([[[[0.0], [0.5 / 127], [1.5 / 127], [1.0], [1.2], [-0.1]]]])}
    got = tens_lib.pack_frame_features(feats, cfg)
    assert got.dtype == torch.int8
    assert got.flatten().tolist() == [0, 0, 2, 127, 127, 0]
    deq = tens_lib.dequantize_rows(got, _tcfg("bf16", "int8"))
    assert deq.dtype == torch.bfloat16 and float(deq.flatten()[3]) == pytest.approx(1.0, abs=4e-3)


# ---------------------------------------------------------------- VO predict


def _jax_det(stacked, frames, precision, cache_dtype):
    (r0, d0), (r1, d1) = map(_rgb_depth, frames)
    cfg = _jcfg(precision, cache_dtype)
    ens = jens_lib.VOEnsemble(cfg, stacked)
    f0 = jens_lib.frame_features_packed(jnp.asarray(r0), jnp.asarray(d0), cfg)
    return np.asarray(ens.predict_step_cached(f0, jnp.asarray(r1), jnp.asarray(d1), ACTIONS)[0])


def _port_det(sds, frames, precision, cache_dtype):
    (r0, d0), (r1, d1) = map(_rgb_depth, frames)
    cfg = _tcfg(precision, cache_dtype)
    ens = TEnsemble(cfg, sds, device="cpu")
    f0 = tens_lib.frame_features_packed(torch.from_numpy(r0), torch.from_numpy(d0), cfg)
    delta, _std, f1 = ens.step(f0, torch.from_numpy(r1), torch.from_numpy(d1), ACTIONS)
    assert f1.dtype == f0.dtype  # the returned cache keeps the cache's dtype
    return delta.numpy()


@pytest.fixture(scope="module")
def jax_fp32_delta(experts, frames):
    return _jax_det(experts[0], frames, "fp32", "native")


@pytest.mark.parametrize("precision,cache_dtype", PRECISIONS)
def test_det_predict_matches_jax(experts, frames, jax_fp32_delta, precision, cache_dtype):
    want = _jax_det(experts[0], frames, precision, cache_dtype)
    got = _port_det(experts[1], frames, precision, cache_dtype)
    assert got.dtype == np.float32
    if precision == "fp32":  # tests/test_torch_port_models.py's fp32 tolerance
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    scale = float(np.linalg.norm(jax_fp32_delta))
    assert float(np.linalg.norm(got - want)) <= BF16_REL * scale
    # and bf16 is not fp32 in disguise
    assert float(np.abs(got - jax_fp32_delta).max()) > 0


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_rnd_predict_bf16_matches_jax(experts, frames, jax_fp32_delta, cache_dtype):
    """rnd mode at dropout 0 (JAX and torch draw different bits): the mean
    is the bf16 det forward in both, the std exactly 0.  JAX's rnd path
    keeps its per-key features unquantized, so the int8 case is held to
    JAX's native bf16 rnd mean."""
    stacked, sds = experts
    (r0, d0), (r1, d1) = map(_rgb_depth, frames)
    jcfg = _jcfg("bf16", mode="rnd", dropout_p=0.0, rnd_mode_n=3)
    obs = jens_lib.preprocess_obs_pairs(*(jnp.asarray(a) for a in (r0, d0, r1, d1)), jcfg)
    jmean, jstd = jens_lib.VOEnsemble(jcfg, stacked).predict(obs, jnp.asarray(ACTIONS),
                                                               jax.random.PRNGKey(0))
    tcfg = _tcfg("bf16", cache_dtype, mode="rnd", dropout_p=0.0, rnd_mode_n=3)
    tobs = tens_lib.preprocess_obs_pairs_packed(
        *(torch.from_numpy(a) for a in (r0, d0, r1, d1)), tcfg)
    assert tobs.dtype == (torch.int8 if cache_dtype == "int8" else torch.bfloat16)
    mean, std = TEnsemble(tcfg, sds, device="cpu").predict_rnd_packed(
        tobs, ACTIONS, torch.Generator().manual_seed(0))
    assert mean.dtype == std.dtype == torch.float32
    assert float(np.abs(np.asarray(jstd)).max()) == 0.0 and float(std.abs().max()) == 0.0
    scale = float(np.linalg.norm(jax_fp32_delta))
    assert float(np.linalg.norm(mean.numpy() - np.asarray(jmean))) <= BF16_REL * scale


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_experts_compute_in_the_config_precision(experts, precision):
    """Ready modules handed to the ensemble or the engine compute in the
    precision they were built for, and must be built for the config's: a
    module of the other precision is refused, so a bf16 request never runs
    float32 unnoticed, and back, and no config changes a caller's module."""
    cfg = _tcfg(precision)
    other = _tcfg("fp32" if precision == "bf16" else "bf16")
    train = tengine.VOTrainConfig(action_type=1)
    wrong = [other.make_model() for _ in range(3)]
    with pytest.raises(ValueError, match="precision"):
        TEnsemble(cfg, experts=wrong, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tengine.VORegressionEngine(cfg, train, device="cpu", experts=wrong[:1])
    assert all(m.compute_dtype == other.model_dtype for m in wrong)
    mods = [cfg.make_model() for _ in range(3)]
    for m, sd in zip(mods, experts[1]):
        m.load_state_dict(sd)
    ens = TEnsemble(cfg, experts=mods, device="cpu")
    assert all(m.compute_dtype == cfg.model_dtype for m in ens.experts)
    eng = tengine.VORegressionEngine(cfg, train, device="cpu", experts=[copy.deepcopy(mods[0])])
    feats = eng.experts[0].visual_encoder(torch.zeros(2, H, W, 30))
    assert feats.dtype == cfg.dtype


def _const_experts(cfg, value=0.01):
    """JAX's int8 test set-up: every weight 0.01."""
    experts = []
    for _ in range(3):
        m = cfg.make_model()
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(value)
        experts.append(m)
    return experts


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["det", "rnd"])
def test_int8_cache_deltas_near_native(precision, mode):
    """tests/test_vo_ensemble.py's bound: int8 within 0.05 of native."""
    rng = np.random.default_rng(0)
    rgb = [torch.from_numpy(rng.uniform(0, 255, (N, H, W, 3)).astype(np.float32))
           for _ in range(2)]
    depth = [torch.from_numpy(rng.uniform(0, 1, (N, H, W, 1)).astype(np.float32))
             for _ in range(2)]
    out = {}
    for cache_dtype in ("native", "int8"):
        cfg = _tcfg(precision, cache_dtype, mode=mode, dropout_p=0.2, rnd_mode_n=4)
        ens = TEnsemble(cfg, experts=_const_experts(cfg), device="cpu")
        f0 = tens_lib.frame_features_packed(rgb[0], depth[0], cfg)
        delta, _std, f1 = ens.step(f0, rgb[1], depth[1], ACTIONS,
                                   torch.Generator().manual_seed(1))
        assert f1.dtype == (torch.int8 if cache_dtype == "int8" else cfg.dtype)
        out[cache_dtype] = delta.numpy()
    assert np.isfinite(out["int8"]).all()
    assert float(np.abs(out["int8"] - out["native"]).max()) < 0.05


# ---------------------------------------------------------------- fused eval step


def test_fused_eval_step_bf16_matches_jax(experts, frames, jax_fp32_delta):
    """One bf16 det fused step with the real (fp32) actor-critic; the VO's
    delta within BF16_REL, the goal and polar from it within 1e-2, the
    policy's outputs within 1e-2 absolute; the actions equal (every fp32
    logit margin here exceeds the policy outputs' distance)."""
    stacked, sds = experts
    (r0, d0), (r1, d1) = map(_rgb_depth, frames)
    n, phid = N, 32
    rng = np.random.default_rng(11)
    sensor = frames[1]["pointgoal_with_gps_compass"].astype(np.float32)
    goal = np.array(j_polar2cart(jnp.asarray(frames[0]["pointgoal_with_gps_compass"])))
    reset = np.zeros((n, 1), np.float32)
    reset[3] = 1.0
    hid = rng.normal(size=(4, n, phid)).astype(np.float32)
    masks = 1.0 - reset
    est_rot = np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1))
    est_pos = np.zeros((n, 3), np.float32)
    jpol = JPolicy(image_size=(H, W), hidden_size=phid, baseplanes=8)
    J = jnp.asarray
    pvars = fast_init(jpol, {"depth": J(d1), "pointgoal_with_gps_compass": J(sensor)}, J(hid),
                      J(ACTIONS[:, None]), J(masks), seed=4)
    jcfg = _jcfg("bf16")
    buckets, order = bucket_expert_indices_static(ACTIONS, n)
    want = [np.asarray(x, np.float32) for x in j_fused(
        jpol, jcfg.make_model(), jcfg, pvars, stacked, J(r0), J(d0), J(r1), J(d1), J(ACTIONS),
        J(goal), J(reset), J(sensor), J(hid), J(ACTIONS[:, None]), J(masks),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), deterministic=True, bucket_idx=buckets,
        expert_ids=J(order), est_rot=J(est_rot), est_pos=J(est_pos), est_seed_rot=J(est_rot),
        est_seed_pos=J(est_pos))]

    tpol = TPolicy(image_size=(H, W), hidden_size=phid, baseplanes=8)
    tpol.load_state_dict(policy_state_dict_from_jax(jax.tree.map(np.asarray, pvars)),
                         strict=True)
    tcfg = _tcfg("bf16")
    T = torch.from_numpy
    prev_feats = tens_lib.frame_features_packed(T(r0), T(d0), tcfg)
    got = t_fused(tpol.eval(), TEnsemble(tcfg, sds, device="cpu"), prev_feats, T(r1), T(d1),
                  ACTIONS, T(goal), T(reset), T(sensor), T(hid), T(ACTIONS[:, None]).long(),
                  T(masks), T(est_rot), T(est_pos), T(est_rot), T(est_pos))
    names = ("goal", "polar", "delta", "std", "value", "action", "logp", "hidden", "feats",
             "est_rot", "est_pos")
    got = dict(zip(names, got))
    want = dict(zip(names, want))
    assert got["feats"].dtype == torch.bfloat16
    assert torch.equal(got["feats"].float(), T(want["feats"]))
    np.testing.assert_array_equal(got["action"].numpy(), want["action"])
    scale = float(np.linalg.norm(jax_fp32_delta))
    assert float(np.linalg.norm(got["delta"].numpy() - want["delta"])) <= BF16_REL * scale
    for k in ("goal", "polar", "value", "logp", "hidden", "est_rot", "est_pos"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-2, err_msg=k)
    assert got["delta"].dtype == got["goal"].dtype == torch.float32


# ---------------------------------------------------------------- training


TRAIN_H = TRAIN_W = 32
TRAIN_HIDDEN = 64  # test_torch_port_vo_train.py's experts
BATCH = 8
LR = 2.5e-4
STAGES = {"forward": (dict(action_type=1), dict(act_type=1)),
          "joint": (dict(action_type=(2, 3), geo_invariance_types=("inverse_joint_train",)),
                    dict(act_type=(2, 3), geo_invariance_types=("inverse_joint_train",)))}


@pytest.fixture(scope="module")
def pairs_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("precision") / "pairs.h5")
    env_cfg = jenvs.EnvConfig(image_h=TRAIN_H, image_w=TRAIN_W, max_episode_steps=60)
    jdataset.generate_scripted_dataset(path, 96, env_cfg=env_cfg, seed=0)
    return path


@pytest.fixture(scope="module", params=list(STAGES))
def bf16_step(request, pairs_path):
    """One bf16 train step of each side on the same batch and weights,
    then 4 more port steps on that batch."""
    stage = request.param
    tkw, rkw = STAGES[stage]
    jcfg = JCfg(vis_size_w=TRAIN_W, vis_size_h=TRAIN_H, hidden_size=TRAIN_HIDDEN,
                dropout_p=0.0, dtype=jnp.bfloat16)
    jt = jengine.VOTrainConfig(batch_size=BATCH, lr=LR, **tkw)
    jeng = jengine.VORegressionEngine(jcfg, jt, init_variables_per_expert=_jax_experts(
        len(jt.expert_actions)))
    teng = tengine.VORegressionEngine(
        TCfg(vis_size_w=TRAIN_W, vis_size_h=TRAIN_H, hidden_size=TRAIN_HIDDEN, dropout_p=0.0,
             precision="bf16"),
        tengine.VOTrainConfig(batch_size=BATCH, lr=LR, **tkw), device="cpu",
        state_dicts=vo_state_dicts_from_stacked(jax.tree.map(np.asarray, jeng.variables)))
    batch = next(jdataset.FramePairReader(pairs_path, TRAIN_W, TRAIN_H, **rkw).iter_batches(
        BATCH, rng=np.random.default_rng(11), drop_last=True))
    arrs = jengine._batch_to_device(batch)
    if stage == "joint":  # the JAX engine's bucketed joint path
        arrs = jengine.VORegressionEngine._attach_train_buckets(
            types.SimpleNamespace(mesh=None, tcfg=jeng.tcfg), arrs, batch)
    grad_fn = jengine.make_grad_fn(jeng.model, jeng.icfg, jeng.tcfg)
    step_fn = jengine.make_train_step(jeng.model, jeng.icfg, jeng.tcfg, jeng.tx)
    both = jax.jit(lambda v, o, b, r: (grad_fn(v, b, r), step_fn(v, o, b, r)))
    jgrads, (jvars, _, jmetrics) = both(jeng.variables, jeng.opt_state, arrs,
                                        jax.random.PRNGKey(0))
    tbatch = tdataset.FramePairBatch(**dataclasses.asdict(batch))

    def grads(engine):
        return stacked_vo_variables([vo_variables_from_state_dict(
            {k: p.grad.clone() for k, p in m.named_parameters()})["params"]
            for m in engine.experts])

    # the same step in float32: bf16's own distance
    fp32_experts = copy.deepcopy(teng.experts)
    for m in fp32_experts:
        m.compute_dtype = None
    fp32 = tengine.VORegressionEngine(dataclasses.replace(teng.icfg, precision="fp32"),
                                      teng.tcfg, device="cpu", experts=fp32_experts)
    fp32.train_step(tbatch)
    losses = [float(teng.train_step(tbatch)["total_loss"])]
    tgrads = grads(teng)
    for _ in range(4):
        losses.append(float(teng.train_step(tbatch)["total_loss"]))
    return dict(stage=stage, jloss=float(jmetrics["total_loss"]),
                jgrads=jax.tree.map(np.asarray, jgrads), jvars=jax.tree.map(np.asarray, jvars),
                losses=losses, tgrads=tgrads, fp32_grads=grads(fp32), engine=teng)


def test_bf16_train_step_loss_matches_jax(bf16_step):
    assert abs(bf16_step["losses"][0] - bf16_step["jloss"]) <= 2e-2 * abs(bf16_step["jloss"])


def _rel(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)


def test_bf16_train_step_gradients_match_jax(bf16_step):
    got = dict(_leaves(bf16_step["tgrads"]))
    want = dict(_leaves(bf16_step["jgrads"]))
    fp32 = dict(_leaves(bf16_step["fp32_grads"]))
    assert set(got) == set(want) == set(fp32)
    keys = sorted(want)
    flat = [np.concatenate([d[k].ravel() for k in keys]) for d in (got, want)]
    assert _rel(*flat) <= 5e-2
    for k in keys:
        assert got[k].dtype == np.float32, k
        if bf16_step["stage"] == "forward":
            assert _rel(got[k], want[k]) <= 5e-2, k
        else:
            assert _rel(got[k], want[k]) <= max(5e-2, 3 * _rel(got[k], fp32[k])), k


def test_bf16_training_keeps_fp32_state_and_learns(bf16_step):
    """Parameters, gradients and both Adam moments stay float32 (JAX's
    tests/test_vo_training.py asserts the same of its tree), and the fixed
    batch's loss falls over 4 steps."""
    eng = bf16_step["engine"]
    for m in eng.experts:
        for p in m.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
        for b in m.buffers():
            assert b.dtype == torch.float32
    states = list(eng.opt.state.values())
    assert states and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                          for s in states)
    losses = bf16_step["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(v.dtype == np.float32 for _, v in _leaves(bf16_step["jvars"]["params"]))


# ---------------------------------------------------------------- cache paths


def _seeded_ensemble(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return TEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                     device="cpu")


@pytest.mark.parametrize("precision,cache_dtype", PRECISIONS)
@pytest.mark.parametrize("mode", ["det", "rnd"])
def test_rollout_keeps_the_cache_dtype(precision, cache_dtype, mode):
    """The rollout's VO goal update carries its cache in the cache's dtype
    (no upcast) and equals the ensemble's own step on the same frames."""
    cfg = _tcfg(precision, cache_dtype, mode=mode, rnd_mode_n=2)
    ppo = PPOConfig(num_steps=3, hidden_size=16, num_mini_batch=1, ppo_epoch=1)
    envs = tenvs.make_scripted_vector_env(tenvs.EnvConfig(image_h=H, image_w=W), 2, seed=1)
    trainer = DDPPOTrainer(model=TPolicy(image_size=(H, W), hidden_size=16, baseplanes=8),
                           ppo_cfg=ppo, envs=envs, device="cpu",
                           vo_ensemble=_seeded_ensemble(cfg))
    trainer.collect_rollout()
    want = torch.int8 if cache_dtype == "int8" else cfg.dtype
    assert trainer._vo_feats.dtype == want
    assert torch.isfinite(trainer.rollouts.observations["pointgoal_with_gps_compass"]).all()


@pytest.mark.parametrize("precision,cache_dtype", PRECISIONS)
def test_agent_keeps_the_cache_dtype(precision, cache_dtype):
    cfg = _tcfg(precision, cache_dtype)
    policy = seeded_init_(TPolicy(image_size=(H, W), hidden_size=16, baseplanes=8),
                          torch.Generator().manual_seed(2))
    agent = PointNavVOAgent(policy_model=policy, vo_ensemble=_seeded_ensemble(cfg),
                            goal_sensor="pointgoal_with_gps_compass", device="cpu")
    env = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(image_h=H, image_w=W), seed=4)
    obs = env.reset()
    for _ in range(3):
        a = agent.act(obs)["action"]
        if a == 0:
            break
        obs = env.step(a)[0]
    assert agent._feats is None or agent._feats.dtype == (
        torch.int8 if cache_dtype == "int8" else cfg.dtype)
    assert np.isfinite(agent.goal_cartesian).all()


# ---------------------------------------------------------------- CLI


def _cli_opts(extra=()):
    return ["NUM_PROCESSES", "2", "SEED", "3", "RL.PPO.hidden_size", "16",
            "VO.USE_VO_MODEL", "True", "VO.VIS_SIZE_W", str(W), "VO.VIS_SIZE_H", str(H),
            "VO.REGRESS_MODEL.hidden_size", str(HIDDEN), "VO.REGRESS_MODEL.pretrained", "False",
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(H),
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(W),
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(H),
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(W),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8",
            "EVAL.TEST_EPISODE_COUNT", "2", "EVAL.EVAL_CKPT_PATH", "", *extra]


def test_rl_eval_cli_runs_bf16(tmp_path, monkeypatch):
    """``VO.REGRESS_MODEL.precision bf16`` through the port's CLI: the
    ensemble runs in bfloat16 and the eval counts its episodes."""
    seen = []
    real = tens_lib.frame_features_packed

    def spy(rgb, depth, cfg):
        out = real(rgb, depth, cfg)
        seen.append(out.dtype)
        return out

    from pointnav_vo_tpu_torch.rl import eval as teval
    monkeypatch.setattr(teval, "frame_features_packed", spy)
    metrics = trun.main(["--task-type", "rl", "--run-type", "eval", "--exp-config",
                         os.path.join(REPO, "configs/rl/ddppo_pointnav.yaml"), "--log-root",
                         str(tmp_path), "--noise", "0", "--device", "cpu"]
                        + _cli_opts(["VO.REGRESS_MODEL.precision", "bf16"]))
    assert metrics["episodes"] == 2 and np.isfinite(metrics["vo_l2_mean"])
    assert seen and set(seen) == {torch.bfloat16}


def test_vo_cli_bf16_train_eval_round_trip(pairs_path, tmp_path):
    """``VO.TRAIN.precision bf16``: one epoch through the CLI, then eval
    from its checkpoint gives the train run's eval metrics exactly; the
    checkpoint stores float32 experts and the bf16 inference config."""
    vo_yaml = os.path.join(REPO, "configs/vo/vo_pointnav.yaml")
    base = ["--task-type", "vo", "--exp-config", vo_yaml, "--log-root", str(tmp_path),
            "--noise", "1", "--device", "cpu"]
    trun.main(base + ["--run-type", "train", "VO.VIS_SIZE_W", str(TRAIN_W), "VO.VIS_SIZE_H",
                      str(TRAIN_H), "VO.MODEL.hidden_size", "16", "VO.TRAIN.batch_size", "8",
                      "VO.TRAIN.epochs", "1", "VO.TRAIN.action_type", "1",
                      "VO.TRAIN.precision", "bf16", "VO.DATASET.TRAIN_WITH_NOISE", pairs_path,
                      "VO.DATASET.EVAL_WITH_NOISE", pairs_path, "LOG_INTERVAL", "1"])
    run_dir = sorted(p for p in os.listdir(tmp_path) if p.startswith("vo-train"))[-1]
    ckpt = os.path.join(tmp_path, run_dir, "checkpoints", "ckpt_epoch_1.pth")
    state = load_checkpoint(ckpt)
    assert state["inference_config"]["precision"] == "bf16"
    assert all(v.dtype == torch.float32 for v in state["experts"][0].values()
               if v.is_floating_point())
    with open(os.path.join(tmp_path, run_dir, "infos", "train_infos.jsonl")) as f:
        train = json.loads(f.read().splitlines()[-1])
    assert np.isfinite(train["mean_total_loss"])
    metrics = trun.main(base + ["--run-type", "eval", "EVAL.EVAL_CKPT_PATH", ckpt,
                                "VO.DATASET.EVAL_WITH_NOISE", pairs_path])
    for k in ("abs_diff_dx", "abs_diff_dz", "abs_diff_dyaw"):
        assert metrics[k] == train[f"eval_{k}"], k


# ---------------------------------------------------------------- memory pairs


def test_memory_pairs_match_the_hdf5_reader(tmp_path):
    """The oracle follower's pairs held in memory batch as the JAX
    generator's HDF5 file reads: the same frames, actions and twins."""
    env_kw = dict(image_h=24, image_w=32, max_episode_steps=30,
                  actuation_noise_multiplier=0.5)
    path = str(tmp_path / "pairs.h5")
    jdataset.generate_scripted_dataset(path, 60, env_cfg=jenvs.EnvConfig(**env_kw), seed=5)
    cfg = tenvs.EnvConfig(**env_kw)
    mem = tdataset.MemoryFramePairs.scripted(
        60, tdataset.oracle_goal_follower(cfg.turn_angle_deg, cfg.success_distance), seed=5,
        env_cfg=cfg)
    assert len(mem) == 60
    for actions, twins, kw in (((1,), False, dict(act_type=1)),
                               ((2, 3), True, dict(act_type=(2, 3), geo_invariance_types=(
                                   "inverse_joint_train",)))):
        sub = mem.subset(actions, twins)
        reader = tdataset.FramePairReader(path, 32, 24, **kw)
        assert sub.num_samples() == reader.num_samples() > 0
        for got, want in zip(sub.iter_batches(8), reader.iter_batches(8), strict=True):
            assert got.twins_packed == want.twins_packed
            for f in ("prev_rgb", "cur_rgb", "prev_depth", "cur_depth", "actions",
                      "data_types"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            np.testing.assert_allclose(got.gt_delta, want.gt_delta, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- 994 protocol


def test_greedy_goal_policy_matches_jax():
    rng = np.random.default_rng(0)
    goal = np.stack([rng.uniform(0, 2, 64), rng.uniform(-np.pi, np.pi, 64)], -1)
    goal[:4, 0] = [0.1, 0.35, 0.37, 1.0]
    goal = goal.astype(np.float32)
    jp = JGreedy(turn_angle_deg=30.0, success_distance=0.36)
    jlogits, _, _ = jp.apply({"params": {}}, {"pointgoal_with_gps_compass": jnp.asarray(goal)},
                             jp.initial_hidden(64), None, None)
    tp = eval_994.GreedyGoalPolicy(30.0, 0.36)
    tlogits, value, hidden = tp({"pointgoal_with_gps_compass": torch.from_numpy(goal)},
                                tp.initial_hidden(64), None, None)
    np.testing.assert_array_equal(tlogits.numpy(), np.asarray(jlogits))
    assert value.shape == (64, 1) and hidden.shape == (1, 64, 1)


@pytest.mark.parametrize("precision,cache_dtype", [("bf16", "native"), ("bf16", "int8")])
def test_eval_994_protocol_at_a_smoke_size(precision, cache_dtype):
    """Experts trained in memory, then an exact set of distinct episodes."""
    env_cfg = tenvs.EnvConfig(image_h=H, image_w=W, max_episode_steps=12,
                              actuation_noise_multiplier=0.5)
    icfg = _tcfg(precision, cache_dtype)
    experts, record = eval_994.train_experts(icfg, env_cfg, pairs=48, eval_pairs=16, epochs=1,
                                             batch=8, device="cpu", log=lambda m: None)
    assert len(experts) == 3 and record["forward_eval"]["eval_samples"] > 0
    assert all(p.dtype == torch.float32 for m in experts for p in m.parameters())
    out = eval_994.run_protocol(TEnsemble(icfg, experts=experts, device="cpu"), env_cfg,
                                episodes=6, n_envs=4, device="cpu")
    assert out["distinct_episodes"] == 6 and out["metrics"]["episodes"] == 6
    assert out["loop_steps"] >= max(1, out["metrics"]["total_env_steps"] // 4)
    assert out["bin_counts_launches"] is None  # no kernel on the CPU
