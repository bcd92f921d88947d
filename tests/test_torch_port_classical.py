"""Port parity, the classical VO backend: ``ops/rotation.py``,
``ops/classical_vo.py`` and ``vo/classical.py`` of pointnav_vo_tpu_torch
against the JAX package (CPU).

Tolerances (float32): rotations rtol 1e-5, atol 1e-6 (atol 2e-5 on the
angles read back through arcsin or arccos near their poles, 1e-5 on 6d
re-orthogonalisation); the Kabsch solves, single and batched with weights,
env by env, rtol 1e-4, atol 1e-5; ``delta_from_matches`` within 1e-5 of
the known motions (the JAX test's bound); the classical vo_fn's deltas and
stds rtol 1e-4, atol 1e-5 against JAX's on the same frames, its choice
between the match and the action prior equal env for env; the host-side
functions (unprojection, the prior, the essential-matrix pose) exactly.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.common import MOVE_FORWARD, STOP, TURN_LEFT, TURN_RIGHT
from pointnav_vo_tpu.ops import classical_vo as jcvo
from pointnav_vo_tpu.ops import rotation as jrot
from pointnav_vo_tpu.vo import classical as jcls

from pointnav_vo_tpu_torch.ops import classical_vo as tcvo
from pointnav_vo_tpu_torch.ops import rotation as trot
from pointnav_vo_tpu_torch.vo import classical as tcls

KABSCH_TOL = dict(rtol=1e-4, atol=1e-5)
CONVENTIONS = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
               "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _quats(rng, lead):
    q = rng.normal(size=lead + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])


# ------------------------------------------------------------ rotations


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_conversions_match_jax(convention):
    """Both directions, batched over [4, 8]: angles inside each
    convention's principal range and the matrices of random rotations."""
    rng = np.random.default_rng(CONVENTIONS.index(convention))
    e = rng.uniform(-1.2, 1.2, (4, 8, 3)).astype(np.float32)
    if convention[0] == convention[2]:  # proper Euler: the middle angle in (0, pi)
        e[..., 1] = rng.uniform(0.2, 2.9, (4, 8))
    want = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(e), convention))
    got = trot.euler_angles_to_matrix(_t(e), convention).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    m = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(_quats(rng, (4, 8)))))
    want = np.asarray(jrot.matrix_to_euler_angles(jnp.asarray(m), convention))
    got = trot.matrix_to_euler_angles(_t(m), convention).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    back = trot.matrix_to_euler_angles(trot.euler_angles_to_matrix(_t(e), convention),
                                       convention).numpy()
    np.testing.assert_allclose(back, e, atol=2e-5)


@pytest.mark.parametrize("fn", ["quaternion_to_matrix", "matrix_to_quaternion",
                                "axis_angle_to_quaternion", "quaternion_to_axis_angle",
                                "matrix_to_rotation_6d", "rotation_6d_to_matrix"])
def test_rotation_function_matches_jax(fn):
    """Each conversion on a [3, 16] batch, small angles included."""
    rng = np.random.default_rng(5)
    q = _quats(rng, (3, 16))
    q[0, :4] = [[0, 0, 0, 1], [1, 0, 0, 0], [0, 0.6, 0, 0.8], [1e-7, 0, 0, 1]]
    m = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))
    aa = rng.normal(scale=0.8, size=(3, 16, 3)).astype(np.float32)
    aa[0, :2] = [[0, 0, 0], [1e-8, 0, 0]]
    inputs = {"quaternion_to_matrix": q, "matrix_to_quaternion": m,
              "axis_angle_to_quaternion": aa, "quaternion_to_axis_angle": q,
              "matrix_to_rotation_6d": m,
              "rotation_6d_to_matrix": rng.normal(size=(3, 16, 6)).astype(np.float32)}
    x = inputs[fn]
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(x)))
    got = getattr(trot, fn)(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 if "6d" in fn else 1e-6)


# ------------------------------------------------------------ Kabsch


def _matched_sets(rng, count, delta):
    """A known (dx, dz, dyaw) and ``count`` matched points: p_prev = R p_cur
    + t, in front of the camera (looking -z), with a little noise."""
    dx, dz, dyaw = delta
    pts_prev = rng.uniform(-2, 2, (3, count))
    pts_prev[2] -= 3.0
    r, t = _rot_y(dyaw), np.asarray([dx, 0.0, dz])
    pts_cur = r.T @ (pts_prev - t[:, None]) + rng.normal(0, 1e-3, (3, count))
    return pts_prev.astype(np.float32), pts_cur.astype(np.float32)


def test_rigid_transform_3d_matches_jax():
    rng = np.random.default_rng(0)
    for count in (3, 8, 40, 500):
        a = rng.normal(size=(3, count)).astype(np.float32)
        r0 = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(_quats(rng, ()))))
        b = (r0 @ a + rng.normal(size=(3, 1)) + rng.normal(0, 0.01, (3, count))).astype(
            np.float32)
        jr, jt = jcvo.rigid_transform_3d(jnp.asarray(a), jnp.asarray(b))
        tr, tt = tcvo.rigid_transform_3d(_t(a), _t(b))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **KABSCH_TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **KABSCH_TOL)
    # a reflection in the best fit is flipped to a rotation
    a = rng.normal(size=(3, 20)).astype(np.float32)
    r, _ = tcvo.rigid_transform_3d(_t(a), _t(a * np.asarray([[1], [1], [-1]], np.float32)))
    assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5


def test_batched_weighted_kabsch_matches_jax_env_by_env():
    """32 envs of 8-500 matched points each, padded to the largest count
    with weight 0 (garbage in the padding), one batched solve against
    JAX's solve of each env's own points; an env with no points solves
    finite."""
    rng = np.random.default_rng(1)
    counts = rng.integers(8, 501, 32)
    counts[:2] = (8, 500)
    k = int(counts.max())
    a = rng.normal(0, 50, (33, 3, k)).astype(np.float32)
    b = rng.normal(0, 50, (33, 3, k)).astype(np.float32)
    w = np.zeros((33, k), np.float32)
    want = []
    for i, c in enumerate(counts):
        delta = (rng.uniform(-0.1, 0.1), rng.uniform(-0.3, 0), rng.uniform(-0.6, 0.6))
        pts_prev, pts_cur = _matched_sets(rng, int(c), delta)
        a[i, :, :c], b[i, :, :c], w[i, :c] = pts_cur, pts_prev, 1.0
        want.append([np.asarray(x) for x in jcvo.rigid_transform_3d(jnp.asarray(pts_cur),
                                                                   jnp.asarray(pts_prev))])
    r, t = tcvo.rigid_transform_3d(_t(a), _t(b), _t(w))
    assert r.shape == (33, 3, 3) and t.shape == (33, 3)
    for i, (jr, jt) in enumerate(want):
        np.testing.assert_allclose(r[i].numpy(), jr, err_msg=f"env {i}", **KABSCH_TOL)
        np.testing.assert_allclose(t[i].numpy(), jt, err_msg=f"env {i}", **KABSCH_TOL)
    assert torch.isfinite(r[32]).all() and torch.isfinite(t[32]).all()


def test_relative_transform_and_validation_match_jax():
    rng = np.random.default_rng(2)
    poses = []
    for _ in range(2):
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(_quats(rng, ()))))
        p[:3, 3] = rng.normal(size=3)
        poses.append(p)
    want = jcvo.get_relative_transform(jnp.asarray(poses[0]), jnp.asarray(poses[1]))
    got = tcvo.get_relative_transform(_t(poses[0]), _t(poses[1]))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    for m in (poses[0][:3, :3], np.diag([1.0, 1.0, -1.0]), 1.01 * np.eye(3)):
        assert bool(tcvo.validate_rot_mat(_t(m), 1e-5)) == bool(
            jcvo.validate_rot_mat(jnp.asarray(m, jnp.float32), 1e-5))
    r, t = poses[1][:3, :3], poses[1][:3, 3]
    want = jcvo.rel_pose_coord_to_camera_change(jnp.asarray(r), jnp.asarray(t))
    got = tcvo.rel_pose_coord_to_camera_change(_t(r), _t(t))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)


def test_essential_mat_pose_matches_jax():
    """The same cv2 RANSAC calls on projected matches of a known motion:
    the same decompositions, and None under 5 matches."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (3, 60))
    pts[2] += 6.0
    k = np.asarray([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    r, t = _rot_y(0.1), np.asarray([0.3, 0.0, 0.1])
    cam1 = r @ pts + t[:, None]
    kp0 = (k @ (pts / pts[2]))[:2].T
    kp1 = (k @ (cam1 / cam1[2]))[:2].T
    want = jcvo.estimate_pose_by_essential_mat(kp0, kp1, k)
    got = tcvo.estimate_pose_by_essential_mat(kp0, kp1, k)
    assert want and len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g[0] == w_[0]
        for a, b in zip(g[1:], w_[1:]):
            np.testing.assert_array_equal(a, b)
    assert tcvo.estimate_pose_by_essential_mat(kp0[:4], kp1[:4], k) is None


# ------------------------------------------------------------ vo/classical.py


def test_unproject_depth_and_prior_match_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    pix = rng.uniform(-3, 70, (50, 2))
    np.testing.assert_array_equal(tcls.unproject_depth(pix, depth, 79.0, 0.1, 10.0),
                                  jcls.unproject_depth(pix, depth, 79.0, 0.1, 10.0))
    for a in (STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT):
        np.testing.assert_array_equal(tcls.action_prior(a, 0.2, 10.0),
                                      jcls.action_prior(a, 0.2, 10.0))


@pytest.mark.parametrize("delta", [
    (0.0, -0.25, 0.0),                  # forward step
    (0.0, 0.0, np.radians(30.0)),       # left turn
    (0.0, 0.0, -np.radians(30.0)),      # right turn
    (0.03, -0.22, np.radians(-4.0)),    # noisy mixed motion
])
def test_delta_from_matches_recovers_known_motion(delta):
    """JAX's test_classical_vo_backend.py motions, exact point sets."""
    rng = np.random.default_rng(0)
    pts_prev = rng.uniform(-2, 2, (3, 40))
    pts_prev[2] -= 3.0
    r, t = _rot_y(delta[2]), np.asarray([delta[0], 0.0, delta[1]])
    pts_cur = r.T @ (pts_prev - t[:, None])
    got = tcls.delta_from_matches(pts_prev, pts_cur)
    np.testing.assert_allclose(got.numpy(), delta, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jcls.delta_from_matches(pts_prev, pts_cur),
                               atol=1e-5)


def _texture(rng, h, w):
    """Smooth random colour texture with a margin of 32 pixels."""
    base = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    return cv2.resize(base, (w + 32, h + 32), interpolation=cv2.INTER_LINEAR)


def _frames(h=96, w=128):
    """Previous and current frames of 7 envs: a texture shifted 1-3 pixels
    over a flat wall (accepted), a blank view (no keypoints: the prior), a
    shifted texture over random depths (matched, gated out by the
    residual), an unrelated texture (too few matches), and a shift over a
    slanted wall."""
    rng = np.random.default_rng(6)
    n = 7
    prev = np.zeros((n, h, w, 3), np.float32)
    cur = np.zeros_like(prev)
    prev_d = np.full((n, h, w, 1), 0.3, np.float32)
    cur_d = prev_d.copy()
    for i, shift in enumerate((1, 2, 3, None, 2, None, 2)):
        if i == 3:
            continue
        big = _texture(rng, h, w)
        prev[i] = big[8:8 + h, 8:8 + w]
        if shift is None:
            cur[i] = _texture(rng, h, w)[8:8 + h, 8:8 + w]
        else:
            cur[i] = big[8:8 + h, 8 + shift:8 + shift + w]
    prev_d[4], cur_d[4] = (rng.uniform(0, 1, (h, w, 1)) for _ in range(2))
    slant = np.linspace(0.2, 0.4, w, dtype=np.float32)[None, :, None]
    prev_d[6] = slant
    cur_d[6] = np.roll(slant, -2, axis=1)
    return ({"rgb": prev, "depth": prev_d}, {"rgb": cur, "depth": cur_d},
            np.asarray([1, 2, 3, 1, 2, 3, 1]))


def test_classical_vo_fn_matches_jax():
    """The vo_fn on the same frames: deltas and stds within tolerance, the
    match accepted or replaced by the prior env for env as JAX's (whose
    std is 0 exactly where it fell back), the counters, and the prior
    where nothing matched at all; uint8 device-copy frames as the
    evaluator passes them give the same."""
    prev, cur, acts = _frames()
    kw = dict(hfov_deg=79.0, min_depth=0.1, max_depth=10.0, forward_step=0.25,
              turn_angle_deg=10.0)
    jd, js = (np.asarray(x) for x in jcls.make_classical_vo_fn(**kw)(prev, cur, acts, None))
    vo = tcls.make_classical_vo_fn(device="cpu", **kw)
    packed = vo.match(prev, cur)
    delta, std, accepted = vo.solve(packed, acts)
    np.testing.assert_allclose(delta.numpy(), jd, **KABSCH_TOL)
    np.testing.assert_allclose(std.numpy(), js, **KABSCH_TOL)
    jax_accepted = (js != 0).any(axis=1)
    np.testing.assert_array_equal(accepted.numpy(), jax_accepted)
    assert list(accepted.numpy()) == [True, True, True, False, False, False, True]
    assert vo.matched == 5 and vo.env_steps == 7 and packed.shape[:2] == (7, 7)

    vo_u8 = tcls.make_classical_vo_fn(device="cpu", **kw)
    u8 = [{"rgb": torch.from_numpy(o["rgb"].astype(np.uint8)),
           "depth": torch.from_numpy(o["depth"])} for o in (prev, cur)]
    d8, s8 = vo_u8(u8[0], u8[1], acts, [{}] * 7)
    np.testing.assert_array_equal(d8.numpy(), delta.numpy())
    np.testing.assert_array_equal(s8.numpy(), std.numpy())
    assert int(vo_u8.accepted) == 4 and vo_u8.host_s > 0

    blank = {"rgb": np.zeros((2, 32, 32, 3), np.float32),
             "depth": np.full((2, 32, 32, 1), 0.5, np.float32)}
    d0, s0 = vo_u8(blank, blank, np.asarray([[TURN_LEFT], [STOP]]), None)
    np.testing.assert_allclose(d0.numpy(), [[0, 0, np.radians(10.0)], [0, 0, 0]], atol=1e-7)
    assert not s0.any() and int(vo_u8.accepted) == 4
