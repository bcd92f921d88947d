"""Port parity, VO training: the losses, the whitening update, the HDF5
reader, one train step of each stage, ``evaluate`` and the checkpoints of
pointnav_vo_tpu_torch against the JAX package (CPU, 32x32 frames, batch 8,
dropout off where the two are compared).

The JAX train step is ``make_grad_fn`` and ``make_train_step`` compiled
together into one program, on the same batch and weights as the port's
``VORegressionEngine.train_step``.  Tolerances: loss and metrics rtol 1e-5
(atol 1e-7 for metrics that are about 0); each gradient within 1e-3 of the
tensor's max abs, plus 1e-6; the whitening statistics rtol 1e-5; the
parameters after Adam within 2 lr everywhere (Adam's first step moves a
weight by about lr sign(g), and a gradient that is zero up to rounding may
flip) and within 1e-6 where |g| exceeds 1e-3 of the tensor's max.
"""

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.running_mean_var import RunningMeanAndVar as JRMV
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import engine as jengine
from pointnav_vo_tpu.vo import losses as jlosses
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg

from pointnav_vo_tpu_torch.io.weights import (
    stacked_vo_variables,
    vo_state_dict_from_jax,
    vo_state_dicts_from_stacked,
    vo_variables_from_state_dict,
)
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar as TRMV
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo import losses as tlosses
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
HIDDEN = 64
BATCH = 8
LR = 2.5e-4
JOINT = dict(action_type=(2, 3), geo_invariance_types=("inverse_joint_train",))
STAGES = {"forward": dict(action_type=1), "joint": JOINT}
# train-step cases: (stage, the reader's filter); "mixed" feeds the forward
# expert every action, so rows it runs but does not own (turns, STOP) stay
# out of its whitening statistics and its loss
STEP_CASES = {
    "forward": ("forward", dict(act_type=1)),
    "forward, mixed actions": ("forward", dict(act_type=-1)),
    "joint": ("joint", dict(act_type=(2, 3), geo_invariance_types=("inverse_joint_train",))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vo_port") / "train.h5")
    env_cfg = jenvs.EnvConfig(image_h=H, image_w=W, max_episode_steps=60)
    assert jdataset.generate_scripted_dataset(path, 96, env_cfg=env_cfg, seed=0) == 96
    return path


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("fixed", [True, False])
def test_loss_weights_match_jax(fixed):
    rng = np.random.default_rng(1)
    acts = rng.integers(0, 4, 9).astype(np.int32)
    gt = rng.normal(0, 0.2, (9, 3)).astype(np.float32)
    mult = {"dx": 1.0, "dz": 2.0, "dyaw": 0.5}
    want = jlosses.compute_loss_weights(_j(acts), _j(gt), mult, fixed)
    got = tlosses.compute_loss_weights(_t(acts), _t(gt), mult, fixed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_mse_matches_jax(masked):
    rng = np.random.default_rng(2)
    pred, gt = (rng.normal(0, 0.2, (10, 3)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.5, 2, (10, 3)).astype(np.float32)
    dz = (rng.uniform(size=10) < 0.7).astype(np.float32) if masked else None
    valid = (rng.uniform(size=10) < 0.8).astype(np.float32) if masked else None
    wl, wd = jlosses.weighted_mse_with_diagnostics(
        _j(pred), _j(gt), _j(w), None if dz is None else _j(dz),
        None if valid is None else _j(valid))
    tl, td = tlosses.weighted_mse_with_diagnostics(
        _t(pred), _t(gt), _t(w), None if dz is None else _t(dz),
        None if valid is None else _t(valid))
    np.testing.assert_allclose(float(tl), float(wl), rtol=1e-6)
    assert set(td) == set(wd)
    for k in wd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(wd[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_geo_invariance_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    f, b = (rng.normal(0, 0.3, (7, 3)).astype(np.float32) for _ in range(2))
    acts = rng.integers(1, 4, 7).astype(np.int32)
    valid = (rng.uniform(size=7) < 0.7).astype(np.float32) if masked else None
    want = jlosses.geo_invariance_inverse_loss(_j(f), _j(b), _j(acts),
                                               None if valid is None else _j(valid))
    got = tlosses.geo_invariance_inverse_loss(_t(f), _t(b), _t(acts),
                                              None if valid is None else _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


def test_loss_gradient_finite_at_zero_difference():
    """sqrt of a zero difference: JAX stops the gradient, the port detaches
    before the root; both gradients are finite and equal."""
    rng = np.random.default_rng(4)
    gt = rng.normal(0, 0.2, (6, 3)).astype(np.float32)
    pred = gt.copy()
    pred[3:] += rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    twin = np.concatenate([-pred[:, :2], -pred[:, 2:]], -1)  # rot diff exactly 0
    w = np.ones((6, 3), np.float32)
    acts = np.full(6, 2, np.int32)

    def jax_total(p):
        loss, _ = jlosses.weighted_mse_with_diagnostics(p, _j(gt), _j(w))
        geo, _, _ = jlosses.geo_invariance_inverse_loss(p, _j(twin), _j(acts))
        return loss + geo

    want = np.asarray(jax.grad(jax_total)(_j(pred)))
    p = _t(pred).requires_grad_(True)
    loss, _ = tlosses.weighted_mse_with_diagnostics(p, _t(gt), _t(w))
    geo, rot, _ = tlosses.geo_invariance_inverse_loss(p, _t(twin), _t(acts))
    (loss + geo).backward()
    assert float(rot) == 0.0
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- whitening


def test_running_mean_var_update_matches_flax():
    """Two successive updates with a partial stats mask, then the output."""
    c = 5
    rng = np.random.default_rng(5)
    xs = [rng.normal(1.0, 2.0, (6, 4, 3, c)).astype(np.float32) for _ in range(2)]
    masks = [np.asarray([1, 0, 1, 1, 0, 1], np.float32), np.asarray([0, 1, 1, 0, 0, 1], np.float32)]
    jm = JRMV(c)
    variables = {"batch_stats": {"mean": jnp.zeros(c), "var": jnp.zeros(c),
                                 "count": jnp.zeros(())}}
    tm = TRMV(c)
    for x, m in zip(xs, masks):
        jy, mut = jm.apply(variables, _j(x), update_stats=True, stats_mask=_j(m),
                           mutable=["batch_stats"])
        variables = {"batch_stats": mut["batch_stats"]}
        ty = tm(_t(x).permute(0, 3, 1, 2), update_stats=True, stats_mask=_t(m))
        st = variables["batch_stats"]
        assert float(tm._count) == float(st["count"])
        np.testing.assert_allclose(tm._mean.reshape(-1).numpy(), np.asarray(st["mean"]), rtol=1e-5)
        np.testing.assert_allclose(tm._var.reshape(-1).numpy(), np.asarray(st["var"]), rtol=1e-5)
        np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------- reader


READER_CASES = {
    "forward": dict(act_type=1),
    "turns inverse-augmented": dict(act_type=(2, 3),
                                    geo_invariance_types=("inverse_data_augment_only",)),
    "left with its twins": dict(act_type=2, geo_invariance_types=("inverse_data_augment_only",)),
    "twin layout": dict(act_type=(2, 3), geo_invariance_types=("inverse_joint_train",)),
    "partial splits": dict(partial_data_n_splits=3),
}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_reader_matches_jax(dataset_path, case):
    kw = READER_CASES[case]
    jr = jdataset.FramePairReader(dataset_path, W, H, **kw)
    tr = tdataset.FramePairReader(dataset_path, W, H, **kw)
    assert len(tr) == len(jr)
    want = list(jr.iter_batches(BATCH, rng=np.random.default_rng(7)))
    got = list(tr.iter_batches(BATCH, rng=np.random.default_rng(7)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.twins_packed == w.twins_packed
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    if case == "twin layout":
        assert all(b.twins_packed for b in got[:-1])
    n = sum(b.actions.shape[0] for b in tr.iter_batches(BATCH, rng=None))
    assert n == tr.num_samples() == jr.num_samples()


def test_inverse_delta_and_env_poses_match_jax():
    kw = dict(image_h=16, image_w=16)
    je = jenvs.ScriptedPointNavEnv(jenvs.EnvConfig(**kw), seed=3)
    te = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**kw), seed=3)
    for a in (1, 2, 1, 3, 3):
        jp, tp = je.global_pose(), te.global_pose()
        je.step(a)
        te.step(a)
        jc, tc = je.global_pose(), te.global_pose()
        for x, y in zip(tp + tc, jp + jc):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(te.goal_position(), je.goal_position())
        np.testing.assert_array_equal(
            tdataset.inverse_delta_from_global(tp[1], tp[0], tc[1], tc[0]),
            jdataset.inverse_delta_from_global(jp[1], jp[0], jc[1], jc[0]))


# ---------------------------------------------------------------- train step


def _jax_experts(n, seed=0):
    """Random experts in the JAX layout with whitening statistics already
    accumulated (fast_init would draw a random count)."""
    model = JCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0).make_model()
    dummy = {"rgb": jnp.zeros((1, H, W, 6)), "depth": jnp.zeros((1, H, W, 2)),
             "discretized_depth": jnp.zeros((1, H, W, 20)),
             "top_down_view": jnp.zeros((1, H, W, 2))}
    rng = np.random.default_rng(100 + seed)
    per = []
    for i in range(n):
        v = fast_init(model, dummy, train=False, seed=seed + i)
        c = v["batch_stats"]["visual_encoder"]["rmv"]["mean"].shape[0]
        v["batch_stats"] = {"visual_encoder": {"rmv": {
            "mean": jnp.asarray(rng.uniform(0, 0.5, c), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.05, 0.3, c), jnp.float32),
            "count": jnp.asarray(40.0)}}}
        per.append(v)
    return per


def _engines(stage, reader_kw, dataset_path, batch_seed):
    icfg = JCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0)
    jt = jengine.VOTrainConfig(batch_size=BATCH, lr=LR, **STAGES[stage])
    per = _jax_experts(len(jt.expert_actions))
    jeng = jengine.VORegressionEngine(icfg, jt, init_variables_per_expert=per)
    teng = tengine.VORegressionEngine(
        TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0),
        tengine.VOTrainConfig(batch_size=BATCH, lr=LR, **STAGES[stage]), device="cpu",
        state_dicts=vo_state_dicts_from_stacked(jax.tree.map(np.asarray, jeng.variables)))
    reader = jdataset.FramePairReader(dataset_path, W, H, **reader_kw)
    batch = next(reader.iter_batches(BATCH, rng=np.random.default_rng(batch_seed),
                                     drop_last=True))
    return jeng, teng, batch


@pytest.fixture(scope="module", params=list(STEP_CASES))
def train_step_pair(request, dataset_path):
    """One train step of each side on the same batch and weights."""
    stage, kw = STEP_CASES[request.param]
    jeng, teng, batch = _engines(stage, kw, dataset_path, batch_seed=11)
    if stage == "joint":
        assert batch.twins_packed
    owned = np.isin(batch.actions, jeng.tcfg.expert_actions).sum() / len(jeng.tcfg.expert_actions)
    if request.param == "forward, mixed actions":
        assert 0 < owned < BATCH
    arrs = jengine._batch_to_device(batch)
    if stage == "joint":  # the JAX engine's bucketed joint path
        arrs = jengine.VORegressionEngine._attach_train_buckets(
            types.SimpleNamespace(mesh=None, tcfg=jeng.tcfg), arrs, batch)
        assert "bucket_idx_0" in arrs
    grad_fn = jengine.make_grad_fn(jeng.model, jeng.icfg, jeng.tcfg)
    step_fn = jengine.make_train_step(jeng.model, jeng.icfg, jeng.tcfg, jeng.tx)
    both = jax.jit(lambda v, o, b, r: (grad_fn(v, b, r), step_fn(v, o, b, r)))
    jgrads, (jvars, _, jmetrics) = both(jeng.variables, jeng.opt_state, arrs,
                                        jax.random.PRNGKey(0))
    tmetrics = teng.train_step(tdataset.FramePairBatch(**dataclasses.asdict(batch)))
    tgrads = [vo_variables_from_state_dict(
        {k: p.grad for k, p in m.named_parameters()})["params"] for m in teng.experts]
    tvars = stacked_vo_variables([vo_variables_from_state_dict(m.state_dict())
                                  for m in teng.experts])
    return dict(stage=stage, owned=owned, jgrads=jax.tree.map(np.asarray, jgrads),
                jvars=jax.tree.map(np.asarray, jvars),
                jmetrics={k: np.asarray(v) for k, v in jmetrics.items()},
                tgrads=stacked_vo_variables(tgrads), tvars=tvars,
                tmetrics={k: v.numpy() for k, v in tmetrics.items()})


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_train_step_loss_and_metrics_match_jax(train_step_pair):
    r = train_step_pair
    assert set(r["tmetrics"]) == set(r["jmetrics"])
    for k, want in r["jmetrics"].items():
        np.testing.assert_allclose(r["tmetrics"][k], want, rtol=1e-5, atol=1e-7, err_msg=k)
    if r["stage"] == "joint":
        assert r["tmetrics"]["geo/malformed_pairs"] == 0.0
        assert r["tmetrics"]["debug_geo/abs_diff_rot"] < 1e-5


def test_train_step_gradients_match_jax(train_step_pair):
    r = train_step_pair
    got, want = dict(_leaves(r["tgrads"])), dict(_leaves(r["jgrads"]))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        assert float(np.abs(g - w).max()) <= 1e-3 * float(np.abs(w).max()) + 1e-6, k


def test_train_step_whitening_stats_match_jax(train_step_pair):
    r = train_step_pair
    got = dict(_leaves(r["tvars"]["batch_stats"]))
    want = dict(_leaves(r["jvars"]["batch_stats"]))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=k)
    # each expert took the rows it owns: forward rows, or 4 twins each
    np.testing.assert_array_equal(want["visual_encoder/rmv/count"], 40.0 + r["owned"])


def test_train_step_adam_update_matches_jax(train_step_pair):
    r = train_step_pair
    got = dict(_leaves(r["tvars"]["params"]))
    want = dict(_leaves(r["jvars"]["params"]))
    grads = dict(_leaves(r["jgrads"]))
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert float(err.max()) <= 2 * LR, k
        g = np.abs(grads[k])
        strong = g > 1e-3 * g.max()
        assert float(err[strong].max(initial=0.0)) <= 1e-6, k


# ---------------------------------------------------------------- joint stage


def _port_engine(stage, dropout_p=0.0, seed=0):
    return tengine.VORegressionEngine(
        TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=dropout_p),
        tengine.VOTrainConfig(batch_size=BATCH, lr=LR, seed=seed, **STAGES[stage]),
        device="cpu")


def _grads(engine):
    return [p.grad.clone() for m in engine.experts for p in m.parameters()]


def test_twin_packed_batch_equals_unpacked(dataset_path):
    reader = tdataset.FramePairReader(dataset_path, W, H, act_type=(2, 3),
                                      geo_invariance_types=("inverse_joint_train",))
    batch = next(reader.iter_batches(BATCH, rng=np.random.default_rng(4), drop_last=True))
    assert batch.twins_packed
    flat = tdataset.unpack_twins(batch)
    assert not flat.twins_packed and flat.prev_rgb.shape[0] == BATCH
    a, b = _port_engine("joint"), _port_engine("joint")
    ma, mb = a.train_step(batch), b.train_step(flat)
    for k in ma:
        np.testing.assert_allclose(ma[k].numpy(), mb[k].numpy(), rtol=1e-6, err_msg=k)
    for ga, gb in zip(_grads(a), _grads(b)):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5, atol=1e-9)


def test_malformed_pairs_are_masked_and_counted():
    rng = np.random.default_rng(0)
    n = BATCH

    def batch(data_types):
        return tdataset.FramePairBatch(
            prev_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
            cur_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
            prev_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
            cur_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
            actions=np.tile([2, 3], n // 2).astype(np.int32),
            gt_delta=rng.normal(0, 0.1, (n, 3)).astype(np.float32),
            data_types=np.asarray(data_types, np.int32),
            dz_regress_mask=np.ones(n, np.float32),
            chunk_idx=np.zeros(n, np.int32), entry_idx=np.arange(n, dtype=np.int32))

    good = _port_engine("joint").train_step(batch(np.tile([0, 1], n // 2)))
    bad = _port_engine("joint").train_step(batch(np.zeros(n)))
    assert float(good["geo/malformed_pairs"]) == 0.0
    assert float(good["geo/abs_diff_rot"]) > 0.0
    assert float(bad["geo/malformed_pairs"]) == n // 2
    assert float(bad["geo/abs_diff_rot"]) == 0.0


def test_float64_engine_step_matches_float32(dataset_path):
    """Experts cast to float64 run the whole step in float64 (the reference
    of the card-vs-CPU check): at this size within 1e-5 of float32."""
    reader = tdataset.FramePairReader(dataset_path, W, H, act_type=(2, 3),
                                      geo_invariance_types=("inverse_joint_train",))
    batch = next(reader.iter_batches(BATCH, rng=np.random.default_rng(5), drop_last=True))
    base = _port_engine("joint").experts
    runs = []
    for dtype in (torch.float32, torch.float64):
        eng = tengine.VORegressionEngine(
            TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0),
            tengine.VOTrainConfig(batch_size=BATCH, lr=LR, **JOINT), device="cpu",
            experts=[m.to(dtype) for m in (copy.deepcopy(e) for e in base)])
        runs.append((eng.train_step(batch), eng))
    (m32, e32), (m64, e64) = runs
    assert m64["total_loss"].dtype == torch.float64
    np.testing.assert_allclose(float(m32["total_loss"]), float(m64["total_loss"]), rtol=1e-5)
    for p32, p64 in zip(_grads(e32), _grads(e64)):
        assert p64.dtype == torch.float64
        assert float((p32.double() - p64).norm()) <= 1e-5 * float(p64.norm()) + 1e-12
    stats = e64.experts[0].visual_encoder.running_mean_and_var
    assert stats._mean.dtype == torch.float64 and float(stats._count) == BATCH // 2


def test_joint_config_guards():
    with pytest.raises(ValueError, match="even"):
        tengine.VOTrainConfig(batch_size=15, **JOINT)
    with pytest.raises(ValueError, match="\\[2, 3\\]"):
        tengine.VOTrainConfig(batch_size=16, action_type=-1,
                              geo_invariance_types=("inverse_joint_train",))
    with pytest.raises(ValueError):
        tengine.VOTrainConfig(action_type=(1, 2))


# ---------------------------------------------------------------- evaluate


def test_evaluate_matches_jax(dataset_path, tmp_path):
    """Forward-stage evaluate over every act-1 sample (a short final batch
    goes through pad_batch), then the exact-count check."""
    jeng, teng, _ = _engines("forward", dict(act_type=1), dataset_path, batch_seed=0)
    jeng.eval_reader = jdataset.FramePairReader(dataset_path, W, H, act_type=1)
    teng.eval_reader = tdataset.FramePairReader(dataset_path, W, H, act_type=1)
    assert teng.eval_reader.num_samples() % BATCH  # a padded final batch
    want = jeng.evaluate(save_pred_path=str(tmp_path / "jax.p"))
    got = teng.evaluate(save_pred_path=str(tmp_path / "port.p"))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    with open(tmp_path / "jax.p", "rb") as f:
        jdump = pickle.load(f)
    with open(tmp_path / "port.p", "rb") as f:
        tdump = pickle.load(f)
    assert set(tdump) == set(jdump)
    for k in ("gt", "action", "chunk", "entry"):
        np.testing.assert_array_equal(tdump[k], jdump[k], err_msg=k)
    np.testing.assert_allclose(tdump["pred"], jdump["pred"], rtol=1e-4, atol=1e-5)

    class ShortReader:
        """A reader whose count disagrees with its batches."""

        def __init__(self, inner):
            self.inner = inner

        def iter_batches(self, *a, **kw):
            return self.inner.iter_batches(*a, **kw)

        def num_samples(self):
            return self.inner.num_samples() + 1

    teng.eval_reader = ShortReader(teng.eval_reader)
    with pytest.raises(RuntimeError, match="reader/loader mismatch"):
        teng.evaluate()


# ---------------------------------------------------------------- saving


def test_checkpoint_round_trip_gives_bit_equal_next_step(dataset_path, tmp_path):
    """With dropout on: the experts, Adam's moments and the dropout
    generator all come back."""
    reader = tdataset.FramePairReader(dataset_path, W, H, act_type=1)
    b1, b2 = list(reader.iter_batches(BATCH, rng=np.random.default_rng(3)))[:2]
    a = _port_engine("forward", dropout_p=0.2, seed=1)
    a.train_step(b1)
    a.epoch = 3
    path = str(tmp_path / "ckpt.pt")
    a.save_ckpt(path)
    b = _port_engine("forward", dropout_p=0.2, seed=2)
    assert b.load_ckpt(path)["epoch"] == 3 and b.epoch == 3
    ma, mb = a.train_step(b2), b.train_step(b2)
    assert float(ma["total_loss"]) == float(mb["total_loss"])
    for ta, tb in zip(a.experts[0].state_dict().values(), b.experts[0].state_dict().values()):
        assert torch.equal(ta, tb)


def test_train_runs_epochs_with_eval_and_checkpoints(dataset_path, tmp_path):
    """``train``: two epochs, each evaluated and saved; the last checkpoint
    resumes at epoch 2 with nothing left to train."""
    reader = tdataset.FramePairReader(dataset_path, W, H, act_type=1)

    def engine():
        return tengine.VORegressionEngine(
            TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN),
            tengine.VOTrainConfig(batch_size=BATCH, lr=LR, epochs=2, log_interval=1),
            reader, reader, device="cpu")

    eng = engine()
    logged = []
    history = eng.train(ckpt_dir=str(tmp_path), log_fn=lambda e, s: logged.append(e))
    assert logged == [1, 2] and len(history) == 2
    for stats in history:
        assert np.isfinite(stats["mean_total_loss"]) and stats["frame_pairs_per_s"] > 0
        assert stats["eval/eval_samples"] == reader.num_samples()
        assert "abs_diff/act1_dt0" in stats
    assert sorted(os.listdir(tmp_path)) == ["ckpt_epoch_1.pt", "ckpt_epoch_2.pt"]
    resumed = engine()
    resumed.load_ckpt(str(tmp_path / "ckpt_epoch_2.pt"))
    assert resumed.epoch == 2 and resumed.train() == []


def test_resolve_dataset_paths_matches_jax(tmp_path):
    for name in ("a.h5", "b.h5"):
        (tmp_path / name).write_bytes(b"")
    for spec in (str(tmp_path / "a.h5"), [str(tmp_path / "b.h5"), str(tmp_path / "a.h5")],
                 f"{tmp_path / 'a.h5'}, {tmp_path / 'b.h5'}", str(tmp_path / "*.h5")):
        assert tdataset.resolve_dataset_paths(spec) == jdataset.resolve_dataset_paths(spec)
    with pytest.raises(FileNotFoundError):
        tdataset.resolve_dataset_paths(str(tmp_path / "*.missing"))


def test_vo_weights_round_trip():
    """JAX tree -> state dict -> JAX tree is the identity."""
    per = _jax_experts(2)
    stacked = jax.tree.map(np.asarray, jax.tree.map(lambda *x: jnp.stack(x), *per))
    back = stacked_vo_variables([vo_variables_from_state_dict(sd)
                                 for sd in vo_state_dicts_from_stacked(stacked)])
    got, want = dict(_leaves(back)), dict(_leaves(stacked))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert set(vo_state_dict_from_jax(per[0])) == set(
        TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN).make_model().state_dict())


def test_training_modules_import_without_jax_or_h5py():
    """The engine, the losses and the reader import with no jax, no h5py
    and nothing of pointnav_vo_tpu."""
    code = (
        "import sys\n"
        "import pointnav_vo_tpu_torch.vo.engine, pointnav_vo_tpu_torch.vo.losses\n"
        "import pointnav_vo_tpu_torch.vo.dataset\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'h5py', 'pointnav_vo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
