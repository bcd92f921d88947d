"""Port parity, observation ops and geometry: pointnav_vo_tpu_torch.ops vs
the JAX package on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointnav_vo_tpu.ops import depth as jdepth
from pointnav_vo_tpu.ops import geometry as jgeo
from pointnav_vo_tpu.ops import topdown as jtd
from pointnav_vo_tpu.rl.trainer import propagate_goal as j_propagate_goal

from pointnav_vo_tpu_torch.ops import depth as tdepth
from pointnav_vo_tpu_torch.ops import geometry as tgeo
from pointnav_vo_tpu_torch.ops import topdown as ttd
from pointnav_vo_tpu_torch.rl.trainer import propagate_goal as t_propagate_goal

# (H, W, rows_around_center): a band that covers the image, and one that
# must be cut out per image
PARAMS = [(64, 96, 50), (64, 96, 20), (48, 64, 50)]


def _params(h, w, rac):
    return (jtd.TopDownParams(vis_size_h=h, vis_size_w=w, rows_around_center=rac),
            ttd.TopDownParams(vis_size_h=h, vis_size_w=w, rows_around_center=rac))


def _depths(h, w, seed, n=6):
    """Random depths plus the edge cases: an all-zero image, a zero-bordered
    image, and one with exact 0/1 values."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    d[0] = 0.0
    d[1] = 0.0
    d[1, 5:h - 7, 3:w - 9] = rng.uniform(0, 1, (h - 12, w - 12))
    d[2, ::3] = 1.0
    d[2, 1::7] = 0.0
    d[3, : h // 3] = 0.0  # crop that starts a third of the way down
    return d


def _jax_bins(depth, jp):
    return [np.asarray(a) for a in
            jax.vmap(lambda x: jtd.pixel_bins(x, jp))(jnp.asarray(depth))]


def test_discretize_depth_exact():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 1, (3, 17, 23)).astype(np.float32)
    d[0, 0, :11] = np.arange(11, dtype=np.float32) / 10  # bin edges incl 1.0
    want = np.asarray(jdepth.discretize_depth(jnp.asarray(d), 10))
    got = tdepth.discretize_depth(torch.from_numpy(d), 10).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 10, 9] == 1.0  # d == 1.0 lands in the last bin


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 64, 96), (48, 64)])
def test_gaussian_blur_3x3_close(shape):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jdepth.gaussian_blur_3x3(jnp.asarray(x)))
    got = tdepth.gaussian_blur_3x3(torch.from_numpy(x)).numpy()
    # the taps are powers of two: only the sum order differs (a few ulp)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("h,w,rac", PARAMS)
def test_pixel_bins_exact_on_jax_blur(h, w, rac, monkeypatch):
    """Given the JAX-blurred band, the port's crop, band gather and
    floor/ceil pixelisation reproduce the JAX bins bit for bit."""
    jp, tp = _params(h, w, rac)
    depth = _depths(h, w, seed=h + rac)

    def jax_blur(x):
        return torch.from_numpy(np.array(jdepth.gaussian_blur_3x3(jnp.asarray(x.numpy()))))

    monkeypatch.setattr(ttd, "gaussian_blur_3x3", jax_blur)
    got = ttd.pixel_bins(torch.from_numpy(depth), tp)
    for g, w_ in zip(got, _jax_bins(depth, jp)):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert not got[2][0].any()  # the all-zero image keeps no point


@pytest.mark.parametrize("h,w,rac", PARAMS)
def test_top_down_end_to_end(h, w, rac):
    """With the port's own blur, a point may move one bin at a floor/ceil
    boundary: at most 0.1 % of the cells may differ.  The normalised view
    must agree to 1e-6 on every image whose max count agrees (one moved
    point can change the max and rescale a whole view)."""
    jp, tp = _params(h, w, rac)
    depth = _depths(h, w, seed=7 * h + rac)
    want = np.stack([np.asarray(jtd.top_down_counts(jnp.asarray(d), jp, impl="matmul"))
                     for d in depth])
    got = ttd.top_down_counts(torch.from_numpy(depth), tp).numpy()
    assert (got != want).mean() <= 1e-3
    assert not got[0].any() and not want[0].any()

    want_v = np.asarray(jtd.top_down_view_batch(jnp.asarray(depth), jp, impl="matmul"))
    got_v = ttd.top_down_view_batch(torch.from_numpy(depth), tp).numpy()
    same_max = want.max(axis=(1, 2)) == got.max(axis=(1, 2))
    assert same_max.sum() >= len(depth) - 1
    for i in np.nonzero(same_max)[0]:
        cells = got[i] == want[i]
        np.testing.assert_allclose(got_v[i][cells], want_v[i][cells], atol=1e-6)
    assert not got_v[0].any()  # all-zero image -> all-zero view
    assert got_v[1].max() == 1.0  # zero-bordered image is normalised


def test_top_down_params_hfov_quirk():
    jp = jtd.TopDownParams()
    tp = ttd.TopDownParams()
    assert tp.hfov_rad == 70.0  # degrees in a radians slot, on purpose
    assert tp.focal == jp.focal and tp.x_bound == jp.x_bound


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_geometry_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    q1, q2 = _quats(rng, n), _quats(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    delta = (rng.normal(size=(n, 3)) * [0.1, 0.25, 0.5]).astype(np.float32)
    goal = rng.normal(size=(n, 3)).astype(np.float32) * 3
    polar = np.stack([rng.uniform(0.1, 5, n), rng.uniform(-np.pi, np.pi, n)],
                     -1).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)

    close(tgeo.quat_multiply(T(q1), T(q2)), jgeo.quat_multiply(J(q1), J(q2)))
    close(tgeo.quat_inverse(T(q1)), jgeo.quat_inverse(J(q1)))
    close(tgeo.quat_rotate_vector(T(q1), T(v)), jgeo.quat_rotate_vector(J(q1), J(v)))
    close(tgeo.quat_from_yaw(T(delta[:, 2])), jgeo.quat_from_yaw(J(delta[:, 2])))
    for t, j in zip(tgeo.compute_global_state(T(q1), T(v), T(delta)),
                    jgeo.compute_global_state(J(q1), J(v), J(delta))):
        close(t, j)
    for t, j in zip(tgeo.cartesian_to_polar(T(v[:, 0]), T(v[:, 1])),
                    jgeo.cartesian_to_polar(J(v[:, 0]), J(v[:, 1]))):
        close(t, j)
    tg, jg = tgeo.compute_goal_pos(T(goal), T(delta)), jgeo.compute_goal_pos(J(goal), J(delta))
    close(tg["cartesian"], jg["cartesian"])
    close(tg["polar"], jg["polar"])
    close(tgeo.pointgoal_polar2cartesian(T(polar)), jgeo.pointgoal_polar2cartesian(J(polar)))


def test_propagate_goal_matches_jax():
    rng = np.random.default_rng(4)
    n = 32
    goal = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    delta = (rng.normal(size=(n, 3)) * [0.1, 0.25, 0.5]).astype(np.float32)
    reset = (rng.uniform(size=(n, 1)) < 0.3).astype(np.float32)
    sensor = np.stack([rng.uniform(0.1, 5, n), rng.uniform(-np.pi, np.pi, n)],
                      -1).astype(np.float32)
    want = j_propagate_goal(*(jnp.asarray(a) for a in (goal, delta, reset, sensor)))
    got = t_propagate_goal(*(torch.from_numpy(a) for a in (goal, delta, reset, sensor)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def _dead_reckon_np(goal, deltas):
    """``compute_goal_pos`` composed in numpy float64: g' = R_y(-dyaw) (g -
    [dx, 0, dz]) (``chip_smoke.py`` phase 15 (d) holds the card to it)."""
    g = np.asarray(goal, np.float64)
    for dx, dz, dyaw in np.asarray(deltas, np.float64):
        x, y, z = g[0] - dx, g[1], g[2] - dz
        c, s = np.cos(dyaw), np.sin(dyaw)
        g = np.asarray([c * x - s * z, y, s * x + c * z])
    return g


def test_propagate_goal_over_500_steps_matches_jax():
    """500 float32 oracle-sized deltas (0.25 m forward, 30 degree turns)
    with VO-sized noise composed one step at a time from a goal 20 m away:
    the port's final goal within 1e-4 m of JAX's and of numpy float64
    (measured: 2.5e-5 m from JAX, 8e-6 m from float64), its polar goal
    rtol 1e-5; the numpy composition equals the port's in float64."""
    rng = np.random.default_rng(0)
    table = np.asarray([[0, -0.25, 0], [0, 0, np.radians(30)], [0, 0, -np.radians(30)]])
    true = table[rng.choice(3, 500, p=[0.7, 0.15, 0.15])]
    deltas = (true + rng.normal(0, (0.01, 0.01, 0.0035), true.shape)).astype(np.float32)
    goal0 = np.asarray([[1.5, 0.0, -20.0]], np.float32)
    keep, sensor = np.zeros((1, 1), np.float32), np.zeros((1, 2), np.float32)
    jg, tg, t64 = jnp.asarray(goal0), torch.from_numpy(goal0), torch.from_numpy(goal0).double()
    for t in range(len(deltas)):
        d = deltas[t:t + 1]
        jg, jpolar = j_propagate_goal(jg, jnp.asarray(d), jnp.asarray(keep),
                                      jnp.asarray(sensor))
        tg, tpolar = t_propagate_goal(tg, torch.from_numpy(d), torch.from_numpy(keep),
                                      torch.from_numpy(sensor))
        t64, _ = t_propagate_goal(t64, torch.from_numpy(d).double(),
                                  torch.from_numpy(keep).double(),
                                  torch.from_numpy(sensor).double())
    ref = _dead_reckon_np(goal0[0], deltas)
    np.testing.assert_allclose(ref, t64[0].numpy(), rtol=0, atol=1e-9)
    assert tg.dtype == torch.float32
    assert np.linalg.norm(tg[0].numpy() - np.asarray(jg)[0]) <= 1e-4
    assert np.linalg.norm(tg[0].numpy() - ref) <= 1e-4
    assert np.linalg.norm(np.asarray(jg)[0] - ref) <= 1e-4
    np.testing.assert_allclose(tpolar.numpy(), np.asarray(jpolar), rtol=1e-5)
    assert np.linalg.norm(ref) > 10  # the goal stayed far: the test reads real drift
