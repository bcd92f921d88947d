"""Port parity, models: the VO expert and the actor-critic of
pointnav_vo_tpu_torch against the JAX package, with the JAX weights carried
across by pointnav_vo_tpu_torch.io.weights (CPU, small sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.vo_cnn import VO_MODEL_NAMES as J_VO_MODEL_NAMES
from pointnav_vo_tpu.models.vo_cnn import make_vo_model as j_make_vo_model
from pointnav_vo_tpu.models.policy import action_log_prob as j_logp
from pointnav_vo_tpu.models.policy import mode_action as j_mode
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg

from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    split_expert_variables,
    vo_state_dict_from_jax,
)
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic as TPolicy
from pointnav_vo_tpu_torch.models.policy import action_log_prob as t_logp
from pointnav_vo_tpu_torch.models.policy import mode_action as t_mode
from pointnav_vo_tpu_torch.models.vo_cnn import VO_MODEL_NAMES, make_vo_model
from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig as TCfg

from _utils import fast_init

RTOL, ATOL = 1e-4, 1e-5  # fp32; conv/GroupNorm sums run in another order


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _vo_pair(h, w, seed, hidden=64):
    jcfg = JCfg(vis_size_w=w, vis_size_h=h, hidden_size=hidden)
    jm = jcfg.make_model()
    dummy = {"rgb": jnp.zeros((1, h, w, 6)), "depth": jnp.zeros((1, h, w, 2)),
             "discretized_depth": jnp.zeros((1, h, w, 20)),
             "top_down_view": jnp.zeros((1, h, w, 2))}
    variables = fast_init(jm, dummy, train=False, seed=seed)
    tm = TCfg(vis_size_w=w, vis_size_h=h, hidden_size=hidden).make_model()
    tm.load_state_dict(vo_state_dict_from_jax(_np_tree(variables)), strict=True)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("h,w", [(32, 32), (32, 48)])
def test_vocnn_forward_matches_jax(h, w):
    jm, variables, tm = _vo_pair(h, w, seed=h + w)
    packed = np.random.default_rng(0).uniform(0, 1, (4, h, w, 30)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(packed), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(packed)).numpy()
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_split_expert_variables():
    stacked = {"params": {"a": {"kernel": np.arange(12.0).reshape(3, 2, 2)}},
               "batch_stats": {"m": np.arange(3.0)}}
    parts = split_expert_variables(stacked)
    assert len(parts) == 3
    np.testing.assert_array_equal(parts[2]["params"]["a"]["kernel"], [[8, 9], [10, 11]])
    assert parts[1]["batch_stats"]["m"] == 1.0


def _policy_inputs(n, h, w, hidden, seed):
    rng = np.random.default_rng(seed)
    obs = {"depth": rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32),
           "pointgoal_with_gps_compass": np.stack(
               [rng.uniform(0.2, 5, n), rng.uniform(-np.pi, np.pi, n)], -1
           ).astype(np.float32)}
    hid = rng.normal(size=(4, n, hidden)).astype(np.float32)
    prev = rng.integers(0, 4, (n, 1)).astype(np.int32)
    masks = (rng.uniform(size=(n, 1)) < 0.7).astype(np.float32)
    return obs, hid, prev, masks


@pytest.mark.parametrize("h,w", [(32, 48), (33, 49)])  # odd: the pool floors
def test_policy_step_matches_jax(h, w):
    n, hidden = 5, 32
    kw = dict(image_size=(h, w), hidden_size=hidden, baseplanes=8)
    jm = JPolicy(**kw)
    obs, hid, prev, masks = _policy_inputs(n, h, w, hidden, seed=h)
    jargs = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hid),
             jnp.asarray(prev), jnp.asarray(masks))
    variables = fast_init(jm, *jargs, seed=3)
    logits, value, new_hid = jm.apply(variables, *jargs)

    tm = TPolicy(**kw)
    tm.load_state_dict(policy_state_dict_from_jax(_np_tree(variables)), strict=True)
    with torch.no_grad():
        t_logits, t_value, t_hid = tm.eval()(
            {k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(hid),
            torch.from_numpy(prev).long(), torch.from_numpy(masks))
    for t, j in ((t_logits, logits), (t_value, value), (t_hid, new_hid)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    assert t_hid.shape == (4, n, hidden)


def test_mode_action_and_log_prob():
    logits = np.random.default_rng(5).normal(size=(7, 4)).astype(np.float32)
    logits[0] = 1.0  # ties: the first maximum wins in both
    ja = j_mode(jnp.asarray(logits))
    ta = t_mode(torch.from_numpy(logits))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(t_logp(torch.from_numpy(logits), ta).numpy(),
                               np.asarray(j_logp(jnp.asarray(logits), ja)),
                               rtol=1e-6, atol=1e-6)


def test_full_width_shapes():
    """341x192: 31 VO compression channels (2048 / (6 * 11)), 114 for the
    policy (2048 / (3 * 6) after the 2x2 pool)."""
    vo = TCfg().make_model()
    assert vo.visual_encoder.output_shape == (31, 6, 11)
    assert vo.visual_encoder.input_channels == 30
    assert TPolicy().net.visual_encoder.output_shape == (114, 3, 6)
    gn = [m for m in vo.modules() if isinstance(m, torch.nn.GroupNorm)]
    assert gn and all(m.eps == 1e-6 for m in gn)


def test_make_vo_model_rejects_unported_variants():
    """Every JAX variant is built; a name JAX does not register is refused,
    and so is an observation space that JAX's ``requires``/``forbids``
    checks refuse (here the paper model without the top-down view, and
    ``vo_cnn`` with it)."""
    assert VO_MODEL_NAMES == J_VO_MODEL_NAMES
    with pytest.raises(KeyError):
        j_make_vo_model("vo_cnn_unknown", observation_space=("rgb", "depth"),
                        observation_size=(32, 32))
    with pytest.raises(ValueError, match="unknown VO variant"):
        make_vo_model("vo_cnn_unknown", observation_space=("rgb", "depth"),
                      observation_size=(32, 32))
    for name, obs in (("vo_cnn_rgb_d_dd_top_down", ("rgb", "depth", "discretized_depth")),
                      ("vo_cnn", ("rgb", "depth", "top_down_view"))):
        with pytest.raises(AssertionError):
            j_make_vo_model(name, observation_space=obs, observation_size=(32, 32))
        with pytest.raises(ValueError, match=name):
            make_vo_model(name, observation_space=obs, observation_size=(32, 32))
