"""Port parity, the VO model zoo: the seven GroupNorm ResNet backbones, the
twelve VO variants (the act-embed model among them), the observation
transforms, the unified ``action_type: -1`` train step, bf16 on an
SE-ResNeXt, the weight bridge of bottleneck, SE, grouped and act-embed
keys, and the depth policy on ResNet-50 with 3 LSTM layers, each held
against the JAX package on the CPU (base width 8, so 4 GroupNorm groups
and a ResNeXt cardinality of 4; 32x32 frames; JAX weights carried across
by ``pointnav_vo_tpu_torch.io.weights``).

Tolerances: fp32 forwards rtol 1e-4 / atol 1e-5, as
``tests/test_torch_port_models.py`` (conv and GroupNorm sums in another
order); area resizes rtol 1e-6 / atol 1e-6 (a box sum against two
weighted matmuls); nearest resizes and crops exact; the train step as
``tests/test_torch_port_vo_train.py`` (loss and metrics rtol 1e-5, each
gradient within 1e-3 of its tensor's max abs plus 1e-6, whitening
statistics rtol 1e-5); bf16 by each side's distance from fp32 (see
``test_se_resnext50_bf16_forward_matches_jax``).  The JAX VO forwards run
eagerly (op by op: the 101-layer ones reuse the 50-layer ones' compiled
ops); the policy and the train step run jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.io.torch_export import save_vo_checkpoint_torch
from pointnav_vo_tpu.models import vo_cnn as jvo
from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.ops import transforms as jtr
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import engine as jengine
from pointnav_vo_tpu.vo import ensemble as jens_lib
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg

from pointnav_vo_tpu_torch.io.weights import (
    load_vo_checkpoint,
    policy_state_dict_from_jax,
    vo_state_dict_from_jax,
    vo_variables_from_state_dict,
)
from pointnav_vo_tpu_torch.models import resnet as tresnet
from pointnav_vo_tpu_torch.models import vo_cnn as tvo
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.ops import transforms as ttr
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo import ensemble as tens_lib
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble as TEnsemble
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init
from test_torch_port_vo_train import _leaves

H = W = 32
BASE = 8
HIDDEN = 16
N = 3
RTOL, ATOL = 1e-4, 1e-5
SHALLOW = ("resnet18", "resnet50", "resneXt50", "se_resnet50", "se_resneXt50")
DEEP = ("resnet101", "se_resneXt101")
PAPER = "vo_cnn_rgb_d_dd_top_down"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _healthy(variables, seed):
    """fast_init's draws, with GroupNorm scales near 1 and whitening
    statistics of a trained model, so the features carry signal through
    every block (fast_init scales every leaf by 0.05)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map_with_path(
        lambda path, v: (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if path[-1].key == "scale" else v, _np_tree(variables))
    if "batch_stats" in out:
        c = out["batch_stats"]["visual_encoder"]["rmv"]["mean"].shape[0]
        out["batch_stats"] = {"visual_encoder": {"rmv": {
            "mean": rng.uniform(0, 0.5, c).astype(np.float32),
            "var": rng.uniform(0.05, 0.3, c).astype(np.float32),
            "count": np.asarray(40.0, np.float32)}}}
    return out


def _spec(name):
    return tvo._VARIANTS[name]


def _kw(name, backbone="resnet18"):
    return dict(observation_space=_spec(name)["requires"], observation_size=(W, H),
                hidden_size=HIDDEN, backbone=backbone, baseplanes=BASE)


def _inputs(model, seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, H, W, model.visual_encoder.input_channels)).astype(np.float32)
    acts = rng.integers(0, 4, n).astype(np.int32)
    return x, acts


@functools.lru_cache(maxsize=None)
def _pair(name, backbone="resnet18", seed=0):
    """The JAX model, its variables and the port's model with them."""
    jm = jvo.make_vo_model(name, **_kw(name, backbone))
    tm = tvo.make_vo_model(name, **_kw(name, backbone))
    x, acts = _inputs(tm, seed, n=1)
    args = (jnp.asarray(x), jnp.asarray(acts)) if _spec(name).get("act_embed") else (
        jnp.asarray(x),)
    variables = _healthy(fast_init(jm, *args, train=False, seed=seed), seed)
    tm.load_state_dict(vo_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval()


def _forwards(name, backbone="resnet18", seed=0, jax_dtype=None, torch_dtype=None):
    """(JAX delta, port delta) on the same seeded packed pairs (and action
    ids for the act-embed model)."""
    jm, variables, tm = _pair(name, backbone)
    x, acts = _inputs(tm, seed + 1)
    act_embed = _spec(name).get("act_embed")
    if jax_dtype is not None:
        jm = jvo.make_vo_model(name, **_kw(name, backbone), dtype=jax_dtype)
    jargs = (jnp.asarray(x), jnp.asarray(acts)) if act_embed else (jnp.asarray(x),)
    # eager, op by op: each op rounds its bf16 output, as the port's do (a
    # jitted program keeps float32 inside its fusions)
    want = np.asarray(jm.apply(variables, *jargs, train=False))
    tm.compute_dtype = torch_dtype
    try:
        targs = ((torch.from_numpy(x), torch.from_numpy(acts)) if act_embed
                 else (torch.from_numpy(x),))
        with torch.no_grad():
            got = tm(*targs).numpy()
    finally:
        tm.compute_dtype = None
    return want, got


# ---------------------------------------------------------------- backbones


@pytest.mark.parametrize("backbone", SHALLOW + DEEP)
def test_backbone_forward_matches_jax(backbone):
    """Each backbone in the paper model's encoder (30 input channels)."""
    want, got = _forwards(PAPER, backbone)
    assert got.shape == (N, 3)
    # the rows differ: the encoder's features reach the delta
    assert np.ptp(want, axis=0).min() > 100 * ATOL
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backbone", DEEP)
def test_deep_backbone_parameter_shapes_match_jax(backbone):
    """The 101-layer trees key for key, shape for shape, through
    ``jax.eval_shape`` (nothing compiled) at the paper's base width 32."""
    kw = dict(_kw(PAPER, backbone), baseplanes=32)
    jm = jvo.make_vo_model(PAPER, **kw)
    with torch.device("meta"):  # shapes only, nothing allocated
        tm = tvo.make_vo_model(PAPER, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 30)), train=False))
    want = {k: tuple(v.shape) for k, v in vo_state_dict_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert tm.visual_encoder.backbone.final_channels == 1024


def test_resnext_layer_plan():
    """ResNeXt stages twice as wide, cardinality on each stage's first
    block only and on its 3x3 conv only, a downsample on stage 1's first
    block at stride 1, the SE gate's width, and 1024 final channels at base
    32 (ResNet-50's base * 8 * 4 as well)."""
    net = tresnet.se_resneXt50(30, base_planes=32, ngroups=16)
    assert net.final_channels == tresnet.resnet50(30).final_channels == 1024
    b0, b1 = net.layer1[0], net.layer1[1]
    assert b0.convs[3].groups == 16 and b1.convs[3].groups == 1
    assert b0.convs[0].groups == b0.convs[6].groups == 1
    assert b0.convs[3].weight.shape == (64, 64 // 16, 3, 3)
    assert b0.downsample is not None and b0.downsample[0].stride == (1, 1)
    assert b1.downsample is None
    assert b0.se.excite[0].weight.shape == (128 // 16, 128)
    assert net.layer4[0].convs[6].out_channels == 1024


# ---------------------------------------------------------------- variants


@pytest.mark.parametrize("name", jvo.VO_MODEL_NAMES)
def test_variant_forward_matches_jax(name):
    assert tvo.VO_MODEL_NAMES == jvo.VO_MODEL_NAMES
    want, got = _forwards(name)
    _, _, tm = _pair(name)
    assert isinstance(tm, tvo.VOCNNActEmbed) == bool(_spec(name).get("act_embed"))
    if name == "vo_cnn_deeper":
        assert tm.visual_encoder.backbone.layer3[22] is not None
    if "wider" in name:
        assert tm.visual_encoder.backbone.conv1[0].out_channels == 2 * BASE
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _wrong_spaces(name):
    """A space missing each required key and one with each forbidden key."""
    spec = _spec(name)
    req = spec["requires"]
    out = [tuple(k for k in req if k != drop) for drop in req]
    out += [req + (extra,) for extra in spec["forbids"]]
    return [o for o in out if o]


@pytest.mark.parametrize("name", jvo.VO_MODEL_NAMES)
def test_variant_rejects_what_jax_rejects(name):
    for obs in _wrong_spaces(name):
        with pytest.raises(AssertionError):
            jvo.make_vo_model(name, observation_space=obs, observation_size=(W, H))
        with pytest.raises(ValueError, match=name):
            tvo.make_vo_model(name, observation_space=obs, observation_size=(W, H))


def test_act_embed_dropout_masks_match_jax():
    """JAX's dropout (``train=True``) on the ``flat + 32`` trunk input and
    on the hidden layer, its keep masks read off its Dropout modules, then
    injected into the port's act-embed model: the same delta.  A dropped
    entry is zero in the output; where the input is zero already the mask
    does not matter and is taken as kept."""
    import flax.linen as nn

    jm, variables, tm = _pair("vo_cnn_act_embed")
    jm = jvo.make_vo_model("vo_cnn_act_embed", **_kw("vo_cnn_act_embed"), dropout_p=0.4)
    x, acts = _inputs(tm, 7)
    seen = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append((np.asarray(args[0]), np.asarray(out)))
        return out

    with nn.intercept_methods(record):
        want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(acts), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(3)}))
    masks = tuple(torch.from_numpy((o != 0) | (i == 0)) for i, o in seen)
    assert [m.shape for m in masks] == [(N, tm.flat_size + tvo.EMBED_DIM), (N, HIDDEN)]
    live = seen[0][0] != 0
    assert 0.3 < 1.0 - float(masks[0].numpy()[live].mean()) < 0.5  # p = 0.4 dropped
    tm.dropout_p = 0.4
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(acts), masks=masks).numpy()
            plain = tm(torch.from_numpy(x), torch.from_numpy(acts)).numpy()
    finally:
        tm.dropout_p = tvo.DROPOUT_P
    assert np.abs(plain - want).max() > 1e-3  # the masks moved the delta
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- transforms

# 37x53 frames to a 31x19 (W x H) target: every area bin uneven
KINDS = ("resize", "resize_crop", "resize_nearest")


@pytest.mark.parametrize("kind", KINDS)
def test_obs_transform_matches_jax(kind):
    img = np.random.default_rng(1).uniform(0, 255, (2, 37, 53, 4)).astype(np.float32)
    want = np.asarray(jtr.apply_obs_transform(jnp.asarray(img), kind, (31, 19)))
    got = ttr.apply_obs_transform(torch.from_numpy(img), kind, (31, 19)).numpy()
    assert got.shape == want.shape
    if kind == "resize_nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 255)


@pytest.mark.parametrize("out_hw", [(19, 31), (20, 13), (37, 53)])
def test_resize_area_and_nearest_match_jax(out_hw):
    img = np.random.default_rng(2).uniform(0, 1, (3, 37, 53, 2)).astype(np.float32)
    want = np.asarray(jtr.resize_area(jnp.asarray(img), out_hw))
    got = ttr.resize_area(torch.from_numpy(img), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ttr.resize_nearest(torch.from_numpy(img), out_hw).numpy(),
        np.asarray(jtr.resize_nearest(jnp.asarray(img), out_hw)))
    np.testing.assert_array_equal(
        ttr.center_crop(torch.from_numpy(img), (out_hw[1] - 3, out_hw[0] - 2)).numpy(),
        np.asarray(jtr.center_crop(jnp.asarray(img), (out_hw[1] - 3, out_hw[0] - 2))))


@functools.lru_cache(maxsize=None)
def _frames_40x60():
    """Scripted-env frames at 40x60: every transform gives 32x48 (H x W)."""
    env = jenvs.make_scripted_vector_env(jenvs.EnvConfig(image_h=40, image_w=60), N, seed=5)
    obs = env.step(np.asarray([1, 2, 1]))[0]
    return obs["rgb"].astype(np.uint8), obs["depth"].astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_frame_features_with_obs_transform_match_jax(kind):
    """Every feature from the resized frames: rgb, depth, the discretized
    depth and the top-down view (binned from the resized depth).  A depth
    rounded apart by the resize may move a point one bin or one depth
    channel at a boundary: at most 0.1 % of the cells may differ, as
    ``tests/test_torch_port_ops.py`` allows the top-down counts."""
    rgb, depth = _frames_40x60()
    kw = dict(vis_size_w=48, vis_size_h=32, obs_transform=kind)
    want = jens_lib.frame_features(jnp.asarray(rgb), jnp.asarray(depth), JCfg(**kw))
    got = tens_lib.frame_features(torch.from_numpy(rgb), torch.from_numpy(depth), TCfg(**kw))
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape == (N, 32, 48, g.shape[-1]), k
        if k in ("rgb", "depth"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * (255 if k == "rgb" else 1))
        else:
            assert (np.abs(g - w) > 1e-6).mean() <= 1e-3, k
    assert float(np.asarray(want["top_down_view"]).max()) == 1.0


@pytest.mark.parametrize("name", ["vo_cnn_d_dd_top_down", "vo_cnn_rgb_d_dd"])
def test_int8_pack_without_rgb_or_top_down_matches_jax(name):
    """The int8 feature cache of a variant without rgb, or without the
    top-down view: JAX's channels, in JAX's order, at JAX's scale."""
    rgb, depth = _frames_40x60()
    rgb, depth = np.ascontiguousarray(rgb[:, :H, :W]), np.ascontiguousarray(depth[:, :H, :W])
    obs = _spec(name)["requires"]
    kw = dict(model_name=name, observation_space=obs, vis_size_w=W, vis_size_h=H,
              cache_dtype="int8")
    want = np.asarray(jens_lib.frame_features_packed(jnp.asarray(rgb), jnp.asarray(depth),
                                                     JCfg(**kw)))
    got = tens_lib.frame_features_packed(torch.from_numpy(rgb), torch.from_numpy(depth),
                                         TCfg(**kw))
    channels = ((3 if "rgb" in obs else 0) + 1 + 10 + (1 if "top_down_view" in obs else 0))
    assert got.dtype == torch.int8 and got.shape == (N, H, W, channels)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ensemble_refuses_act_embed():
    cfg = TCfg(model_name="vo_cnn_act_embed", observation_space=("rgb", "depth"),
               vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN)
    with pytest.raises(ValueError, match="vo_cnn_act_embed"):
        TEnsemble(cfg, experts=[cfg.make_model() for _ in range(3)], device="cpu")


# ---------------------------------------------------------------- training


def _batch(n, seed):
    """A synthetic mixed-action batch (forward, both turns and STOP)."""
    rng = np.random.default_rng(seed)
    return dict(
        prev_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
        cur_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
        prev_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
        cur_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
        actions=np.asarray([1, 2, 3, 1, 0, 1, 3, 2][:n], np.int32),
        gt_delta=rng.normal(0, 0.2, (n, 3)).astype(np.float32),
        data_types=np.zeros(n, np.int32),
        dz_regress_mask=(rng.uniform(size=n) < 0.8).astype(np.float32),
        chunk_idx=np.zeros(n, np.int32), entry_idx=np.arange(n, dtype=np.int32))


@pytest.fixture(scope="module", params=["vo_cnn_act_embed", "vo_cnn"])
def unified_step(request):
    """One ``action_type: -1`` train step of each side from the same
    weights on the same batch (dropout off), for the act-embed model and
    for a plain VOCNN: JAX's loss, gradients and whitening update in one
    compiled program."""
    n, lr, name = 8, 2.5e-4, request.param
    obs = ("rgb", "depth")
    icfg = JCfg(model_name=name, observation_space=obs, vis_size_w=W, vis_size_h=H,
                hidden_size=HIDDEN, dropout_p=0.0)
    jt = jengine.VOTrainConfig(batch_size=n, lr=lr, action_type=-1)
    model = jvo.make_vo_model(name, **_kw(name), dropout_p=0.0)
    _, variables, _ = _pair(name)
    stacked = jax.tree.map(lambda v: jnp.asarray(v)[None], variables)
    batch = _batch(n, 9)
    arrs = jengine._batch_to_device(jdataset.FramePairBatch(**batch))
    loss_fn = jengine.make_loss_fn(model, icfg, jt)
    grads, (stats, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        stacked["params"], stacked["batch_stats"], arrs, jax.random.PRNGKey(0))
    expert = tvo.make_vo_model(name, **_kw(name), dropout_p=0.0)
    expert.load_state_dict(vo_state_dict_from_jax(variables), strict=True)
    teng = tengine.VORegressionEngine(
        TCfg(model_name=name, observation_space=obs, vis_size_w=W, vis_size_h=H,
             hidden_size=HIDDEN, dropout_p=0.0),
        tengine.VOTrainConfig(batch_size=n, lr=lr, action_type=-1), device="cpu",
        experts=[expert])
    tmetrics = teng.train_step(tdataset.FramePairBatch(**batch))
    (m,) = teng.experts
    return dict(jgrads=_np_tree(jax.tree.map(lambda g: g[0], grads)),
                jstats=_np_tree(jax.tree.map(lambda s: s[0], stats)),
                jmetrics={k: np.asarray(v) for k, v in metrics.items()},
                tgrads=vo_variables_from_state_dict(
                    {k: p.grad for k, p in m.named_parameters()})["params"],
                tstats=vo_variables_from_state_dict(m.state_dict())["batch_stats"],
                tmetrics={k: v.numpy() for k, v in tmetrics.items()}, model=m, name=name)


def test_unified_train_step_matches_jax(unified_step):
    r = unified_step
    act_embed = r["name"] == "vo_cnn_act_embed"
    assert isinstance(r["model"], tvo.VOCNNActEmbed) == act_embed
    assert set(r["tmetrics"]) == set(r["jmetrics"]) and "abs_diff/act-1_dt0" in r["tmetrics"]
    for k, want in r["jmetrics"].items():
        np.testing.assert_allclose(r["tmetrics"][k], want, rtol=1e-5, atol=1e-7, err_msg=k)
    got, want = dict(_leaves(r["tgrads"])), dict(_leaves(r["jgrads"]))
    assert set(got) == set(want)
    assert ("action_embedding/embedding" in got) == act_embed
    for k, w in want.items():
        tol = 1e-3 * np.abs(w).max() + 1e-6
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=k)
    # the unified expert owns every row: all 8 feed its whitening statistics
    js, ts = dict(_leaves(r["jstats"])), dict(_leaves(r["tstats"]))
    assert float(ts["visual_encoder/rmv/count"]) == float(js["visual_encoder/rmv/count"]) == 48.0
    for k in ("visual_encoder/rmv/mean", "visual_encoder/rmv/var"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------- bf16


def test_se_resnext50_bf16_forward_matches_jax():
    """bf16 against JAX's bf16, each side beside its fp32 forward.  Here the
    encoder carries real signal (GroupNorm scales near 1), so bf16's own
    rounding moves JAX's deltas 1.7 % of their norm (measured), past
    ``BF16_REL`` (5e-3, measured there on fast_init's 0.05-scaled
    GroupNorms): the gates are relative to JAX's own bf16 distance from
    fp32 (``d_jax``): the port's bf16 within 1.25 x ``d_jax`` of JAX's bf16
    (measured 0.94 x) and within 2 x ``d_jax`` of its own fp32 (measured
    0.55 x)."""
    want32, got32 = _forwards(PAPER, "se_resneXt50")
    want, got = _forwards(PAPER, "se_resneXt50", jax_dtype=jnp.bfloat16,
                          torch_dtype=torch.bfloat16)
    assert got.dtype == np.float32
    d_jax = float(np.linalg.norm(want - want32))
    assert 0 < d_jax < 0.05 * float(np.linalg.norm(want32))
    assert float(np.linalg.norm(got - want)) <= 1.25 * d_jax
    assert 0 < float(np.linalg.norm(got - got32)) <= 2 * d_jax


# ---------------------------------------------------------------- weights


@pytest.mark.parametrize("name,backbone", [(PAPER, "se_resneXt50"),
                                           ("vo_cnn_act_embed", "resnet18")])
def test_reference_pth_of_zoo_model_loads_and_round_trips(name, backbone, tmp_path):
    """JAX's exporter writes a reference ``model_state`` ``.pth``; the port
    loads it strict and gives JAX's forward; the state dict maps back to
    the JAX variables leaf for leaf."""
    jm, variables, _ = _pair(name, backbone)
    path = str(tmp_path / "model.pth")
    save_vo_checkpoint_torch(path, variables)
    tm = tvo.make_vo_model(name, **_kw(name, backbone))
    tm.load_state_dict(load_vo_checkpoint(path), strict=True)
    x, acts = _inputs(tm, 11)
    act_embed = _spec(name).get("act_embed")
    jargs = (jnp.asarray(x), jnp.asarray(acts)) if act_embed else (jnp.asarray(x),)
    targs = (torch.from_numpy(x), torch.from_numpy(acts)) if act_embed else (
        torch.from_numpy(x),)
    with torch.no_grad():
        got = tm.eval()(*targs).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, *jargs, train=False)),
                               rtol=RTOL, atol=ATOL)
    back = dict(_leaves(vo_variables_from_state_dict(tm.state_dict())))
    want = dict(_leaves(variables))
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    if backbone == "se_resneXt50":
        assert "visual_encoder.backbone.layer1.0.se.excite.2.weight" in tm.state_dict()
        assert tm.state_dict()["visual_encoder.backbone.layer1.0.convs.3.weight"].shape[1] == 4


# ---------------------------------------------------------------- the policy


def test_resnet50_policy_with_three_lstm_layers_matches_jax():
    n, h, w, hidden = 4, 32, 48, 32
    kw = dict(image_size=(h, w), hidden_size=hidden, baseplanes=BASE, backbone="resnet50",
              num_recurrent_layers=3)
    rng = np.random.default_rng(12)
    obs = {"depth": rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32),
           "pointgoal_with_gps_compass": np.stack(
               [rng.uniform(0.2, 5, n), rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)}
    hid = rng.normal(size=(6, n, hidden)).astype(np.float32)
    prev = rng.integers(0, 4, (n, 1)).astype(np.int32)
    masks = np.asarray([[1.0], [0.0], [1.0], [1.0]], np.float32)
    jm = JPolicy(**kw)
    jargs = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hid),
             jnp.asarray(prev), jnp.asarray(masks))
    variables = _healthy(fast_init(jm, *jargs, seed=6), 6)
    want = jax.jit(jm.apply)(variables, *jargs)
    tm = TPolicy(**kw)
    tm.load_state_dict(policy_state_dict_from_jax(variables), strict=True)
    assert tm.num_packed_hidden == 6
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(v) for k, v in obs.items()},
                        torch.from_numpy(hid), torch.from_numpy(prev).long(),
                        torch.from_numpy(masks))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL, atol=ATOL)
