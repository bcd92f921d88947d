"""Port parity, the VO training diagnostics: ``VO.TRAIN.log_grad`` (the
``grad/*`` norms of each step, ``grad_snapshot``) and ``VO.debug`` (the
NaN check) of pointnav_vo_tpu_torch's ``vo/engine.py`` against the JAX
package (CPU, 32x32 frames, batch 8, dropout off).

Tolerances, those of ``test_torch_port_vo_train.py``: each gradient within
1e-3 of its tensor's max abs, plus 1e-6; a norm within the L2 norm of that
bound over the tensors it covers (``|‖g‖ - ‖w‖| <= ‖g - w‖``); metrics rtol
1e-5.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import engine as jengine
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg

from pointnav_vo_tpu_torch import run as trun
from pointnav_vo_tpu_torch.io.weights import (
    stacked_vo_variables,
    vo_state_dicts_from_stacked,
    vo_variables_from_state_dict,
)
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from test_torch_port_driver import _tb_histograms
from test_torch_port_vo_train import BATCH, HIDDEN, LR, STAGES, H, W, _jax_experts, _leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = {"forward": dict(act_type=1),
           "joint": dict(act_type=(2, 3), geo_invariance_types=("inverse_joint_train",))}
JAX_TOPS = ("visual_encoder", "visual_fc", "output_head")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vo_diag") / "train.h5")
    env_cfg = jenvs.EnvConfig(image_h=H, image_w=W, max_episode_steps=60)
    jdataset.generate_scripted_dataset(path, 96, env_cfg=env_cfg, seed=0)
    return path


@pytest.fixture(autouse=True)
def _jax_debug_nans_reset():
    """The JAX engine's ``debug`` sets a process-wide flag: put it back
    after every test, so no later test runs JAX with NaN checking."""
    yield
    jax.config.update("jax_debug_nans", False)


def _port_engine(stage, dataset_path, state_dicts=None, **diag):
    """The port's engine with ``diag`` (``log_grad``/``debug``) and the
    stage's train reader; seeded experts where ``state_dicts`` is None."""
    return tengine.VORegressionEngine(
        TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0),
        tengine.VOTrainConfig(batch_size=BATCH, lr=LR, **STAGES[stage], **diag), device="cpu",
        train_reader=tdataset.FramePairReader(dataset_path, W, H, **READERS[stage]),
        state_dicts=state_dicts)


def _engines(stage, dataset_path, **diag):
    """A JAX engine and the port's from the same experts, both with
    ``diag`` and the stage's train reader."""
    icfg = JCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0)
    jt = jengine.VOTrainConfig(batch_size=BATCH, lr=LR, **STAGES[stage], **diag)
    per = _jax_experts(len(jt.expert_actions))
    jeng = jengine.VORegressionEngine(
        icfg, jt, init_variables_per_expert=per,
        train_reader=jdataset.FramePairReader(dataset_path, W, H, **READERS[stage]))
    teng = _port_engine(stage, dataset_path,
                        vo_state_dicts_from_stacked(jax.tree.map(np.asarray, jeng.variables)),
                        **diag)
    return jeng, teng


def _batch(dataset_path, stage, seed=11):
    reader = jdataset.FramePairReader(dataset_path, W, H, **READERS[stage])
    return next(reader.iter_batches(BATCH, rng=np.random.default_rng(seed), drop_last=True))


def _jax_step(jeng, batch):
    """The JAX engine's gradients and train step's metrics on ``batch``,
    compiled together, without donating the engine's buffers."""
    arrs = jengine._batch_to_device(batch)
    grad_fn = jengine.make_grad_fn(jeng.model, jeng.icfg, jeng.tcfg)
    step_fn = jengine.make_train_step(jeng.model, jeng.icfg, jeng.tcfg, jeng.tx)
    both = jax.jit(lambda v, o, b, r: (grad_fn(v, b, r), step_fn(v, o, b, r)[2]))
    grads, metrics = both(jeng.variables, jeng.opt_state, arrs, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, grads), {k: np.asarray(v) for k, v in metrics.items()}


def _norm_bound(leaves):
    """The L2 norm of the per-element gradient bound over ``leaves``."""
    return float(np.sqrt(sum(w.size * (1e-3 * float(np.abs(w).max()) + 1e-6) ** 2
                             for w in leaves)))


def _port_tree(snapshot):
    """A port snapshot (``{name: [E, ...]}``) as JAX's stacked tree."""
    n = len(next(iter(snapshot.values())))
    return stacked_vo_variables([
        vo_variables_from_state_dict({k: torch.from_numpy(v[e]) for k, v in snapshot.items()})
        ["params"] for e in range(n)])


def _assert_grads_close(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert float(np.abs(got[k] - w).max()) <= 1e-3 * float(np.abs(w).max()) + 1e-6, k


# ---------------------------------------------------------------- log_grad


@pytest.mark.parametrize("stage", list(STAGES))
def test_log_grad_norms_match_jax(stage, dataset_path):
    """One step of each stage: JAX's metric names, ``grad/*`` included,
    and each norm within the gradient tolerance."""
    jeng, teng = _engines(stage, dataset_path, log_grad=True)
    batch = _batch(dataset_path, stage)
    jgrads, jmetrics = _jax_step(jeng, batch)
    tmetrics = {k: v.numpy() for k, v in teng.train_step(
        tdataset.FramePairBatch(**vars(batch))).items()}
    assert set(tmetrics) == set(jmetrics)
    assert {k for k in jmetrics if k.startswith("grad/")} == (
        {"grad/global_norm"} | {f"grad/{t}_norm" for t in JAX_TOPS})
    for k, w in jmetrics.items():
        if k.startswith("grad/"):
            leaves = [v for _, v in _leaves(jgrads if k == "grad/global_norm"
                                            else jgrads[k[len("grad/"):-len("_norm")]])]
            assert abs(float(tmetrics[k]) - float(w)) <= _norm_bound(leaves), k
            assert float(w) > 0, k
        else:
            np.testing.assert_allclose(tmetrics[k], w, rtol=1e-5, atol=1e-7, err_msg=k)


def test_log_grad_leaves_the_update_alone(dataset_path):
    """The norms are read, never written: the step's parameters, Adam
    moments and other metrics equal a step without them."""
    batch = tdataset.FramePairBatch(**vars(_batch(dataset_path, "joint")))
    on = _port_engine("joint", dataset_path, log_grad=True)
    off = tengine.VORegressionEngine(on.icfg, tengine.VOTrainConfig(
        batch_size=BATCH, lr=LR, **STAGES["joint"]), device="cpu",
        experts=[copy.deepcopy(m) for m in on.experts])
    m_on, m_off = on.train_step(batch), off.train_step(batch)
    assert set(m_on) - set(m_off) == {"grad/global_norm"} | {f"grad/{t}_norm" for t in JAX_TOPS}
    for k, v in m_off.items():
        assert torch.equal(m_on[k], v), k
    for a, b in zip(on.experts, off.experts):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for sa, sb in zip(on.opt.state.values(), off.opt.state.values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_act_embed_norms_cover_its_top_level_names():
    """The unified act-embed model's ``grad/*`` names: JAX's top-level
    names of ``VOCNNActEmbed``, over both of its own modules."""
    icfg = TCfg(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0,
                model_name="vo_cnn_act_embed", observation_space=("rgb", "depth"))
    eng = tengine.VORegressionEngine(icfg, tengine.VOTrainConfig(
        batch_size=BATCH, action_type=-1, log_grad=True), device="cpu")
    for p in eng.experts[0].parameters():
        p.grad = torch.full_like(p, 0.5)
    norms = tengine.grad_norms(eng.experts)
    tops = ("visual_encoder", "action_embedding", "hidden_generator", "output_head")
    assert set(norms) == {"grad/global_norm"} | {f"grad/{t}_norm" for t in tops}
    sizes = {t: sum(p.numel() for n, p in eng.experts[0].named_parameters()
                    if n.split(".")[0] == t) for t in tops}
    for t in tops:
        np.testing.assert_allclose(float(norms[f"grad/{t}_norm"]), 0.5 * np.sqrt(sizes[t]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(norms["grad/global_norm"]),
                               0.5 * np.sqrt(sum(sizes.values())), rtol=1e-6)


@pytest.mark.parametrize("stage", list(STAGES))
def test_grad_snapshot_matches_jax(stage, dataset_path):
    """``grad_snapshot`` against JAX's (``make_grad_fn`` on the batch
    ``default_rng(0)`` draws), through the weights' key bridge; it leaves
    the engine as it was, and ``obs_snapshot`` reads the same batch."""
    jeng, teng = _engines(stage, dataset_path, log_grad=True)
    teng.train_step(next(teng.train_reader.iter_batches(BATCH, rng=np.random.default_rng(9))))
    jeng.variables = stacked_vo_variables([vo_variables_from_state_dict(m.state_dict())
                                           for m in teng.experts])
    before = [t.clone() for m in teng.experts for t in (*m.state_dict().values(),
                                                        *(p.grad for p in m.parameters()))]
    opt_before = copy.deepcopy(teng.opt.state_dict())
    gen_before = teng.generator.get_state()
    calls = []
    inner = teng.train_reader.iter_batches
    teng.train_reader.iter_batches = lambda *a, **k: calls.append(1) or inner(*a, **k)

    snap = teng.grad_snapshot()
    names = [n for n, _ in teng.experts[0].named_parameters()]
    assert list(snap) == names
    assert all(v.shape[0] == len(teng.experts) for v in snap.values())
    _assert_grads_close(_port_tree(snap), jax.tree.map(np.asarray, jeng.grad_snapshot()))
    again = teng.grad_snapshot()
    for k, v in snap.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    obs = teng.obs_snapshot()
    assert len(calls) == 1 and teng._snap_batch is not None
    jobs = jeng.obs_snapshot()
    assert set(obs) == set(jobs)
    for k in obs:
        np.testing.assert_allclose(obs[k], jobs[k], rtol=1e-5, atol=1e-5, err_msg=k)

    after = [t for m in teng.experts for t in (*m.state_dict().values(),
                                               *(p.grad for p in m.parameters()))]
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))
    opt_after = teng.opt.state_dict()
    for k, st in opt_before["state"].items():
        for name, v in st.items():
            assert torch.equal(opt_after["state"][k][name], v), (k, name)
    assert torch.equal(teng.generator.get_state(), gen_before)


# ---------------------------------------------------------------- debug


def _nan_batch(dataset_path):
    batch = _batch(dataset_path, "forward")
    batch.gt_delta = batch.gt_delta.copy()
    batch.gt_delta[3, 1] = np.nan
    return batch


def test_debug_raises_on_nan_target_like_jax(dataset_path):
    """A NaN in one ``gt_delta``: JAX's ``jax_debug_nans`` raises, and so
    does the port, before the update: parameters, whitening statistics
    and Adam's state stay as they were."""
    jeng, teng = _engines("forward", dataset_path, debug=1)
    assert jax.config.jax_debug_nans
    batch = _nan_batch(dataset_path)
    step = jax.jit(jengine.make_train_step(jeng.model, jeng.icfg, jeng.tcfg, jeng.tx))
    with pytest.raises(FloatingPointError):
        step(jeng.variables, jeng.opt_state, jengine._batch_to_device(batch),
             jax.random.PRNGKey(0))
    teng.train_step(tdataset.FramePairBatch(**vars(_batch(dataset_path, "forward", seed=2))))
    state = [t.clone() for m in teng.experts for t in m.state_dict().values()]
    opt = copy.deepcopy(teng.opt.state_dict())
    with pytest.raises(FloatingPointError, match=r"non-finite loss or metrics.*total_loss"):
        teng.train_step(tdataset.FramePairBatch(**vars(batch)))
    after = [t for m in teng.experts for t in m.state_dict().values()]
    assert all(torch.equal(a, b) for a, b in zip(after, state, strict=True))
    got = teng.opt.state_dict()
    for k, st in opt["state"].items():
        for name, v in st.items():
            assert torch.equal(got["state"][k][name], v), (k, name)
    assert not torch.is_anomaly_enabled()


def test_debug_catches_a_nan_born_in_the_backward(dataset_path, monkeypatch):
    """A finite loss whose backward makes a NaN (``sqrt`` at 0 times 0):
    the anomaly mode raises in the backward, naming the function; a NaN
    put into a gradient by a hook is caught by the check of the gradient
    norms.  Neither updates anything."""
    batch = tdataset.FramePairBatch(**vars(_batch(dataset_path, "forward")))
    teng = _port_engine("forward", dataset_path, debug=1)
    state = [t.clone() for t in teng.experts[0].state_dict().values()]
    loss = tengine.vo_loss

    def poisoned(preds, arrs, tcfg):
        total, metrics = loss(preds, arrs, tcfg)
        return total + torch.sqrt(preds.sum() * 0.0), metrics

    monkeypatch.setattr(tengine, "vo_loss", poisoned)
    with pytest.raises(RuntimeError, match="returned nan values"):
        teng.train_step(batch)
    monkeypatch.setattr(tengine, "vo_loss", loss)
    hook = teng.experts[0].output_head[1].weight.register_hook(lambda g: g * float("nan"))
    with pytest.raises(FloatingPointError, match="grad/output_head_norm"):
        teng.train_step(batch)
    hook.remove()
    assert all(torch.equal(a, b) for a, b in zip(teng.experts[0].state_dict().values(), state))
    assert not teng.opt.state and not torch.is_anomaly_enabled()


@pytest.mark.parametrize("log_grad", [False, True])
def test_debug_clean_step_equals_plain_step(dataset_path, log_grad):
    """On a finite batch ``debug`` changes nothing: the metrics and the
    updated parameters equal the step without it."""
    batch = tdataset.FramePairBatch(**vars(_batch(dataset_path, "joint")))
    on = _port_engine("joint", dataset_path, debug=1, log_grad=log_grad)
    off = tengine.VORegressionEngine(on.icfg, tengine.VOTrainConfig(
        batch_size=BATCH, lr=LR, log_grad=log_grad, **STAGES["joint"]), device="cpu",
        experts=[copy.deepcopy(m) for m in on.experts])
    m_on, m_off = on.train_step(batch), off.train_step(batch)
    assert set(m_on) == set(m_off)
    for k, v in m_off.items():
        assert torch.equal(m_on[k], v), k
    for a, b in zip(on.experts, off.experts):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k


# ---------------------------------------------------------------- the CLI


def test_vo_cli_log_grad_histograms_each_epoch(dataset_path, tmp_path):
    """Two epochs through the port's VO CLI with ``log_grad`` and
    ``VO.debug``: one ``grad/{name}`` histogram a parameter at each epoch,
    the epoch stats carrying the last logged norms."""
    opts = ["VO.VIS_SIZE_W", str(W), "VO.VIS_SIZE_H", str(H), "VO.MODEL.hidden_size",
            str(HIDDEN), "VO.MODEL.dropout_p", "0.0", "VO.MODEL.pretrained", "False",
            "VO.TRAIN.batch_size", str(BATCH), "VO.TRAIN.epochs", "2",
            "VO.TRAIN.action_type", "1", "VO.TRAIN.log_grad", "True", "VO.debug", "1",
            "VO.DATASET.TRAIN_WITH_NOISE", dataset_path, "VO.DATASET.EVAL_WITH_NOISE", dataset_path,
            "LOG_INTERVAL", "1"]
    engine = trun.main(["--task-type", "vo", "--run-type", "train", "--exp-config",
                        os.path.join(REPO, "configs/vo/vo_pointnav.yaml"), "--log-root",
                        str(tmp_path), "--noise", "1", "--device", "cpu"] + opts)
    assert engine.epoch == 2 and engine.tcfg.log_grad and engine.tcfg.debug == 1
    (run_dir,) = [p for p in tmp_path.iterdir() if p.name.startswith("vo-train")]
    hists = _tb_histograms(str(run_dir))
    names = [n for n, _ in engine.experts[0].named_parameters()]
    assert sorted(hists) == sorted(f"grad/{n}" for n in names)
    for n in names:
        assert [step for step, _ in hists[f"grad/{n}"]] == [1, 2], n
    with open(run_dir / "infos" / "train_infos.jsonl") as f:
        epochs = [json.loads(line) for line in f]
    assert [e["epoch"] for e in epochs] == [1, 2]
    for e in epochs:
        assert all(np.isfinite(e[f"grad/{t}_norm"]) and e[f"grad/{t}_norm"] > 0
                   for t in JAX_TOPS)
