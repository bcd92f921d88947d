"""Port parity: the pose-delta geometry of ``ops/geometry.py`` and the
checkpoint tools of ``pointnav_vo_tpu_torch/tools/`` against the JAX
package's ``ops/geometry.py`` and ``tools/`` (CPU).

- ``quat_conjugate``, ``yaw_from_quat``, ``agent_state_target2ref``,
  ``delta_state_from_poses`` and ``get_polar_angle`` on seeded random unit
  quaternions and positions, batch shapes ``()``, ``(7,)`` and ``(2, 5)``,
  rtol 1e-5 / atol 1e-6; ``delta_state_from_poses`` into
  ``compute_global_state`` gives back the target pose;
- ``export_to_reference.export`` against the JAX tool's ``export`` from the
  same seeded flax variables (a JAX native checkpoint there, a port
  checkpoint written by the port's engines here): the forward stage, the
  joint turn stage, the act-embed model (``action_type: -1``) and the
  policy; the two ``.pth`` files hold the same container keys, the same
  ``model_states`` indices and the same tensors bit for bit; the port's
  export read back by JAX's ``torch_import.load_vo_checkpoint`` and by the
  port's ``VOEnsemble.from_torch_checkpoints`` gives the original forward;
- ``verify_reference_ckpts`` against the JAX tool on the same ``.pth``
  files (written by JAX's ``save_*_checkpoint_torch`` from seeded
  weights, no reference clone): both ``PASS``, ``delta_sample0`` and
  ``logits_sample0`` within the tools' ``ATOL`` (5e-4), every report key
  alike; the missing-files ``SKIP``; the oracle path over a stand-in clone
  built from the port's own modules.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.io import checkpoint as jcheckpoint
from pointnav_vo_tpu.io import torch_import as jimport
from pointnav_vo_tpu.io.torch_export import save_policy_checkpoint_torch, save_vo_checkpoint_torch
from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.vo_cnn import make_vo_model as jmake_vo_model
from pointnav_vo_tpu.ops import geometry as jgeo

from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pointnav_vo_tpu_torch.io.weights import (
    POLICY_PREFIX,
    load_policy_checkpoint,
    policy_state_dict_from_jax,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.io.weights import load_vo_checkpoint as tload_vo_checkpoint
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.ops import geometry as tgeo
from pointnav_vo_tpu_torch.tools import export_to_reference as texport
from pointnav_vo_tpu_torch.tools import verify_reference_ckpts as tverify
from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

from _utils import fast_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL = "pointgoal_with_gps_compass"
SIZE = 32  # the export cases' frames
HIDDEN = 32


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- geometry


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _poses(shape, seed):
    rng = np.random.default_rng(seed)
    return (_unit_quats(rng, shape), rng.normal(size=shape + (3,)).astype(np.float32),
            _unit_quats(rng, shape), rng.normal(size=shape + (3,)).astype(np.float32))


def _close(got, want):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


SHAPES = [(), (7,), (2, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("fn", ["quat_conjugate", "yaw_from_quat", "get_polar_angle"])
def test_quaternion_function_matches_jax(fn, shape):
    q = _poses(shape, 0)[0]
    _close(getattr(tgeo, fn)(torch.from_numpy(q)), getattr(jgeo, fn)(jnp.asarray(q)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("fn", ["agent_state_target2ref", "delta_state_from_poses"])
def test_pose_delta_matches_jax(fn, shape):
    args = _poses(shape, 1)
    _close(getattr(tgeo, fn)(*map(torch.from_numpy, args)),
           getattr(jgeo, fn)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_delta_state_integrates_back_to_the_target(shape):
    """Yaw-only poses (the navigation setting): the target relative to the
    reference, integrated from the reference, is the target, in both
    packages alike."""
    rng = np.random.default_rng(2)
    yaw0, dyaw = rng.uniform(-np.pi, np.pi, shape), rng.uniform(-0.6, 0.6, shape)

    def yaw_quat(y):
        z = np.zeros_like(y)
        return np.stack([z, np.sin(y / 2), z, np.cos(y / 2)], -1).astype(np.float32)

    ref_rot, tgt_rot = yaw_quat(yaw0), yaw_quat(yaw0 + dyaw)
    ref_pos = rng.normal(size=shape + (3,)).astype(np.float32)
    tgt_pos = (ref_pos + rng.normal(scale=0.3, size=shape + (3,)) * [1.0, 0.0, 1.0]
               ).astype(np.float32)
    delta = tgeo.delta_state_from_poses(*map(torch.from_numpy,
                                             (ref_rot, ref_pos, tgt_rot, tgt_pos)))
    rot, pos = tgeo.compute_global_state(torch.from_numpy(ref_rot), torch.from_numpy(ref_pos),
                                         delta)
    np.testing.assert_allclose(pos.numpy(), tgt_pos, atol=1e-5)
    sign = np.sign(np.sum(rot.numpy() * tgt_rot, axis=-1, keepdims=True))
    np.testing.assert_allclose(rot.numpy(), sign * tgt_rot, atol=1e-5)
    np.testing.assert_allclose(delta[..., 2].numpy(), dyaw, atol=1e-5)
    jrot, jpos = jgeo.compute_global_state(
        jnp.asarray(ref_rot), jnp.asarray(ref_pos),
        jgeo.delta_state_from_poses(*map(jnp.asarray, (ref_rot, ref_pos, tgt_rot, tgt_pos))))
    _close([rot, pos], [jrot, jpos])


# ---------------------------------------------------------------- export


VO_OBS = ("rgb", "depth", "discretized_depth", "top_down_view")


PAIR_CHANNELS = {"rgb": 6, "depth": 2, "discretized_depth": 20, "top_down_view": 2}


def _vo_obs(obs_space, n, seed):
    rng = np.random.default_rng(seed)
    obs = {"rgb": rng.uniform(0, 255, (n, SIZE, SIZE, 6)).astype(np.float32),
           "depth": rng.uniform(0, 1, (n, SIZE, SIZE, 2)).astype(np.float32),
           "discretized_depth": rng.integers(0, 2, (n, SIZE, SIZE, 20)).astype(np.float32),
           "top_down_view": rng.uniform(0, 1, (n, SIZE, SIZE, 2)).astype(np.float32)}
    return {k: obs[k] for k in obs_space}


def _jax_vo(name):
    return jmake_vo_model(name, observation_space=_obs_space(name),
                          observation_size=(SIZE, SIZE), hidden_size=HIDDEN,
                          discretized_depth_channels=10)


def _obs_space(name):
    return ("rgb", "depth") if name == "vo_cnn_act_embed" else VO_OBS


def _jax_vo_forward(name, variables, obs, actions=None):
    extra = {} if actions is None else {"actions": jnp.asarray(actions)}
    return np.asarray(_jax_vo(name).apply(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        jax.tree.map(jnp.asarray, obs), train=False, **extra))


# action_type, the JAX model name, the experts
STAGES = {"forward": (1, "vo_cnn_rgb_d_dd_top_down", 1),
          "joint": ([2, 3], "vo_cnn_rgb_d_dd_top_down", 2),
          "act_embed": (-1, "vo_cnn_act_embed", 1)}


@pytest.fixture(scope="module")
def stage_vars():
    """Per stage: the seeded flax variables of its experts, stacked."""
    out = {}
    for i, (stage, (_act, name, n)) in enumerate(STAGES.items()):
        model = _jax_vo(name)
        extra = {} if name != "vo_cnn_act_embed" else {"actions": jnp.zeros((1,), jnp.int32)}
        dummy = {k: jnp.zeros((1, SIZE, SIZE, PAIR_CHANNELS[k])) for k in _obs_space(name)}
        trees = [fast_init(model, dummy, train=False, seed=20 + 3 * i + j, **extra)
                 for j in range(n)]
        # the JAX training engine's tree: the experts on a leading axis
        out[stage] = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)
    return out


def _port_vo_checkpoint(path, stage, stacked):
    """A port VO training checkpoint of the stage, written by the port's
    engine from the JAX variables."""
    act, name, n = STAGES[stage]
    icfg = VOInferenceConfig(model_name=name, observation_space=_obs_space(name),
                             vis_size_w=SIZE, vis_size_h=SIZE, hidden_size=HIDDEN)
    experts = []
    for v in split_expert_variables(stacked, n):
        m = icfg.make_model()
        m.load_state_dict(vo_state_dict_from_jax(v), strict=True)
        experts.append(m)
    tcfg = VOTrainConfig(batch_size=8, action_type=act)
    engine = VORegressionEngine(icfg, tcfg, device="cpu", experts=experts)
    engine.epoch = 3
    engine.save_ckpt(path)


def _tensors_equal(got, want, where):
    """The same keys, dtypes, shapes and values.  One shape differs by
    design: the whitening count, which the reference's module holds as a
    0-d buffer, as the port's export writes it; the JAX tool writes it 1-d
    (``np.ascontiguousarray`` returns at least one dimension), which
    ``load_state_dict`` also takes."""
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if k.endswith("running_mean_and_var._count"):
            assert g.shape == () and w.shape == (1,), f"{where}: {k}"
            w = w.reshape(())
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}: {k}"
        assert torch.equal(g, w), f"{where}: {k}"


@pytest.mark.parametrize("stage", list(STAGES))
def test_vo_export_matches_the_jax_tool(stage, stage_vars, tmp_path):
    jtool = _load(os.path.join(REPO, "tools", "export_to_reference.py"), "jax_export_tool")
    act, name, _n = STAGES[stage]
    native = str(tmp_path / "native.pkl")
    jcheckpoint.save_checkpoint(native, {"variables": stage_vars[stage]},
                                metadata={"epoch": 3, "train_config": {"action_type": act}})
    want_info = jtool.export(native, str(tmp_path / "jax.pth"), "vo")
    port = str(tmp_path / "port.pth")
    _port_vo_checkpoint(port, stage, stage_vars[stage])
    got_info = texport.export(port, str(tmp_path / "torch.pth"), "vo")
    assert {k: v for k, v in got_info.items() if k != "out"} == {
        k: v for k, v in want_info.items() if k != "out"}
    want = torch.load(str(tmp_path / "jax.pth"), weights_only=False)
    got = torch.load(str(tmp_path / "torch.pth"), weights_only=False)
    assert sorted(got) == sorted(want)
    assert got["epoch"] == want["epoch"] == 3
    if "model_states" in want:
        assert list(got["model_states"]) == list(want["model_states"])
        for a in want["model_states"]:
            _tensors_equal(got["model_states"][a], want["model_states"][a], f"model_states[{a}]")
    else:
        _tensors_equal(got["model_state"], want["model_state"], "model_state")


@pytest.mark.parametrize("stage", list(STAGES))
def test_vo_export_loads_back_to_the_original_forward(stage, stage_vars, tmp_path):
    """JAX's ``torch_import.load_vo_checkpoint`` of the port's export gives
    JAX's forward on the original variables (rtol 1e-4 / atol 1e-5), and
    so do the port's loaders."""
    act, name, n = STAGES[stage]
    port, out = str(tmp_path / "port.pth"), str(tmp_path / "ref.pth")
    _port_vo_checkpoint(port, stage, stage_vars[stage])
    texport.export(port, out, "vo")
    obs = _vo_obs(_obs_space(name), 3, 5)
    acts = [2, 1, 3] if act == -1 else None
    idx = [None] if act == -1 else ([act] if isinstance(act, int) else act)
    icfg = VOInferenceConfig(model_name=name, observation_space=_obs_space(name),
                             vis_size_w=SIZE, vis_size_h=SIZE, hidden_size=HIDDEN)
    packed = tverify._packed(obs, torch.device("cpu"))
    for j, a in enumerate(idx):
        want = _jax_vo_forward(name, split_expert_variables(stage_vars[stage], n)[j], obs, acts)
        got = _jax_vo_forward(name, jimport.load_vo_checkpoint(out, act_idx=a), obs, acts)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        m = icfg.make_model()
        m.load_state_dict(tload_vo_checkpoint(out, a), strict=True)
        with torch.no_grad():
            t = (m(packed) if acts is None else m(packed, torch.as_tensor(acts))).numpy()
        np.testing.assert_allclose(t, want, rtol=1e-4, atol=1e-5)


def test_exported_stages_load_as_an_ensemble(stage_vars, tmp_path):
    """The forward stage's and the joint stage's exports, named as the
    config's ``all_pretrained_ckpt``, load through
    ``VOEnsemble.from_torch_checkpoints``; its det deltas are each
    expert's forward from the original weights, bit for bit."""
    paths = {}
    for stage in ("forward", "joint"):
        port = str(tmp_path / f"{stage}.pth")
        _port_vo_checkpoint(port, stage, stage_vars[stage])
        paths[stage] = str(tmp_path / f"{stage}_ref.pth")
        texport.export(port, paths[stage], "vo")
    icfg = VOInferenceConfig(vis_size_w=SIZE, vis_size_h=SIZE, hidden_size=HIDDEN)
    ens = VOEnsemble.from_torch_checkpoints(
        icfg, {"forward": paths["forward"], "left": paths["joint"], "right": paths["joint"]},
        device="cpu")
    originals = (split_expert_variables(stage_vars["forward"], 1)
                 + split_expert_variables(stage_vars["joint"], 2))
    rng = np.random.default_rng(6)
    packed = torch.from_numpy(rng.uniform(0, 1, (6, SIZE, SIZE, 30)).astype(np.float32))
    actions = np.array([1, 2, 3, 3, 1, 2])
    got = ens.predict_packed(packed, actions)
    for e, v in enumerate(originals):
        m = icfg.make_model()
        m.load_state_dict(vo_state_dict_from_jax(v), strict=True)
        rows = np.nonzero(actions == e + 1)[0]
        with torch.no_grad():
            assert torch.equal(got[rows], m.eval()(packed[rows]))


@pytest.fixture(scope="module")
def policy_vars():
    jpol = JPolicy(image_size=(64, 64), hidden_size=HIDDEN, baseplanes=8)
    obs = {"depth": jnp.zeros((1, 64, 64, 1)), GOAL: jnp.zeros((1, 2))}
    return jax.tree.map(np.asarray, fast_init(
        jpol, obs, jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
        seed=7))


def test_policy_export_matches_the_jax_tool(policy_vars, tmp_path):
    """``--kind policy``: ``{"state_dict", "update"}`` and nothing else,
    the tensors bit-equal to the JAX tool's export of the same weights."""
    jtool = _load(os.path.join(REPO, "tools", "export_to_reference.py"), "jax_export_tool")
    native = str(tmp_path / "native.pkl")
    jcheckpoint.save_checkpoint(native, {"params": policy_vars["params"], "extra_variables": {}},
                                metadata={"update": 5})
    jtool.export(native, str(tmp_path / "jax.pth"), "policy")
    model = TPolicy(image_size=(64, 64), hidden_size=HIDDEN, baseplanes=8)
    model.load_state_dict(policy_state_dict_from_jax(policy_vars), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    model(*_policy_inputs(2))[0].sum().backward()
    opt.step()
    model.load_state_dict(policy_state_dict_from_jax(policy_vars), strict=True)
    port = str(tmp_path / "port.pth")
    # the CLI's RL checkpoint: the trainer's state beside the run's metadata
    save_checkpoint(port, {"state_dict": {POLICY_PREFIX + k: v
                                          for k, v in model.state_dict().items()},
                           "optimizer": opt.state_dict(),
                           "generator": {"device": "cpu", "state": torch.get_rng_state()},
                           "count_steps": 640, "update_idx": 5, "update": 5,
                           "full_config": {"SEED": 0}, "host_rng": {"np_random": None}})
    info = texport.export(port, str(tmp_path / "torch.pth"), "policy")
    assert info["update"] == 5
    want = torch.load(str(tmp_path / "jax.pth"), weights_only=False)
    got = torch.load(str(tmp_path / "torch.pth"), weights_only=False)
    assert sorted(got) == sorted(want) == ["state_dict", "update"]
    assert got["update"] == want["update"] == 5
    _tensors_equal(got["state_dict"], want["state_dict"], "state_dict")
    back = TPolicy(image_size=(64, 64), hidden_size=HIDDEN, baseplanes=8)
    back.load_state_dict(load_policy_checkpoint(str(tmp_path / "torch.pth")), strict=True)
    with torch.no_grad():
        for a, b in zip(back(*_policy_inputs(3)), model(*_policy_inputs(3))):
            assert torch.equal(a, b)


def _policy_inputs(n, size=64):
    rng = np.random.default_rng(8)
    obs = {"depth": torch.from_numpy(rng.uniform(0, 1, (n, size, size, 1)).astype(np.float32)),
           GOAL: torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))}
    return (obs, torch.from_numpy(rng.normal(size=(4, n, HIDDEN)).astype(np.float32)),
            torch.zeros((n, 1), dtype=torch.long), torch.ones((n, 1)))


def test_export_cli(stage_vars, tmp_path, capsys):
    port = str(tmp_path / "port.pth")
    _port_vo_checkpoint(port, "joint", stage_vars["joint"])
    texport.main([port, str(tmp_path / "out.pth"), "--kind", "vo"])
    assert "'actions': [2, 3]" in capsys.readouterr().out
    assert sorted(load_checkpoint(str(tmp_path / "out.pth"))["model_states"]) == [2, 3]


# ---------------------------------------------------------------- verify


FULL_W, FULL_H = 341, 192


@pytest.fixture(scope="module")
def jax_verify():
    return _load(os.path.join(REPO, "tools", "verify_reference_ckpts.py"), "jax_verify_tool")


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The three published files' containers, written by JAX's exporters
    from seeded full-width weights."""
    root = tmp_path_factory.mktemp("published")
    model = jmake_vo_model("vo_cnn_rgb_d_dd_top_down", observation_space=VO_OBS,
                           observation_size=(FULL_W, FULL_H), discretized_depth_channels=10)
    dummy = {k: jnp.zeros((1, FULL_H, FULL_W, c)) for k, c in PAIR_CHANNELS.items()}
    vo = {a: jax.tree.map(np.asarray, fast_init(model, dummy, train=False, seed=30 + a))
          for a in (1, 2, 3)}
    paths = {"act_forward": str(root / "act_forward.pth"),
             "act_left_right": str(root / "act_left_right_inv_joint.pth"),
             "rl_tune_vo": str(root / "rl_tune_vo.pth")}
    save_vo_checkpoint_torch(paths["act_forward"], {1: vo[1]})
    save_vo_checkpoint_torch(paths["act_left_right"], {2: vo[2], 3: vo[3]})
    jpol = JPolicy(image_size=(FULL_H, FULL_W))
    pvars = fast_init(jpol, {"depth": jnp.zeros((1, FULL_H, FULL_W, 1)), GOAL: jnp.zeros((1, 2))},
                      jpol.initial_hidden(1), jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1)),
                      seed=34)
    save_policy_checkpoint_torch(paths["rl_tune_vo"], jax.tree.map(np.asarray, pvars))
    return paths


def _argv(paths, root, report):
    return ["--act-forward", paths["act_forward"], "--act-left-right", paths["act_left_right"],
            "--rl-tune-vo", paths["rl_tune_vo"], "--reference-root", str(root / "no_clone"),
            "--report", report]


@pytest.fixture(scope="module")
def jax_report(jax_verify, published, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_verify")
    report = str(root / "report.json")
    argv = sys.argv
    sys.argv = ["verify_reference_ckpts.py"] + _argv(published, root, report)
    try:
        assert jax_verify.main() == 0
    finally:
        sys.argv = argv
    with open(report) as f:
        return json.load(f)


def _assert_reports_agree(got, want):
    assert sorted(got) == sorted(want) == ["atol", "files", "mode", "overall"]
    assert got["mode"] == want["mode"] and got["atol"] == want["atol"] == tverify.ATOL
    assert got["overall"] == want["overall"]
    assert sorted(got["files"]) == sorted(want["files"])
    for name, w in want["files"].items():
        g = got["files"][name]
        assert sorted(g) == sorted(w) and g["status"] == w["status"], name
        if "experts" in w:
            assert sorted(g["experts"]) == sorted(w["experts"]), name
            for e, rec in w["experts"].items():
                assert sorted(g["experts"][e]) == sorted(rec)
                np.testing.assert_allclose(g["experts"][e]["delta_sample0"], rec["delta_sample0"],
                                           rtol=0, atol=tverify.ATOL)
        if "logits_sample0" in w:
            np.testing.assert_allclose(g["logits_sample0"], w["logits_sample0"], rtol=0,
                                       atol=tverify.ATOL)


def test_verify_matches_the_jax_tool(jax_report, published, tmp_path):
    """No clone: both tools convert and forward every file, ``PASS``."""
    report = str(tmp_path / "report.json")
    assert tverify.main(_argv(published, tmp_path, report) + ["--device", "cpu"]) == 0
    with open(report) as f:
        got = json.load(f)
    assert jax_report["overall"] == "PASS" and set(
        v["status"] for v in jax_report["files"].values()) == {"PASS"}
    _assert_reports_agree(got, jax_report)


def test_verify_skips_missing_files_as_the_jax_tool(jax_verify, tmp_path):
    missing = {k: str(tmp_path / f"{k}.pth") for k in ("act_forward", "act_left_right",
                                                        "rl_tune_vo")}
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    argv = sys.argv
    sys.argv = ["verify_reference_ckpts.py"] + _argv(missing, tmp_path, want_path)
    try:
        assert jax_verify.main() == 0
    finally:
        sys.argv = argv
    assert tverify.main(_argv(missing, tmp_path, got_path) + ["--device", "cpu"]) == 0
    with open(want_path) as f, open(got_path) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and got["overall"] == "SKIP"


def _stand_in_clone(root):
    """A directory laid out as the reference's clone whose three module
    files re-export the port's own ResNet, RNN state encoder and
    whitening: the oracle path runs without the reference."""
    base = root / "pointnav_vo" / "model_utils"
    for rel, line in (
            ("visual_encoders/resnet.py", "from pointnav_vo_tpu_torch.models.resnet import resnet18"),
            ("rnns/rnn_state_encoder.py", "from pointnav_vo_tpu_torch.models.rnn import RNNStateEncoder"),
            ("running_mean_and_var.py",
             "from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar")):
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        (base / rel).write_text(line + "  # noqa: F401\n")
    return root


@pytest.mark.parametrize("mode", ["self-test", "published"])
def test_verify_oracle_path_over_a_stand_in_clone(mode, published, tmp_path):
    """With a clone at ``--reference-root``: every expert and the policy
    compared with the reference-shaped modules (``torch_match``), ``PASS``;
    ``--self-test`` writes its own files in both containers."""
    clone = _stand_in_clone(tmp_path / "clone")
    report = str(tmp_path / "report.json")
    argv = ["--reference-root", str(clone), "--report", report, "--device", "cpu"]
    argv += ["--self-test"] if mode == "self-test" else _argv(published, tmp_path, report)[:6]
    assert tverify.main(argv) == 0
    with open(report) as f:
        got = json.load(f)
    assert got["mode"] == mode and got["overall"] == "PASS"
    recs = [r for v in got["files"].values() for r in v.get("experts", {}).values()]
    recs += [v for v in got["files"].values() if "logits_sample0" in v]
    assert len(recs) == 4
    assert all(r["torch_match"] and r["torch_max_abs_diff"] < tverify.ATOL for r in recs)
