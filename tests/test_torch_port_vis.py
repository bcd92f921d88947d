"""Port parity, eval videos and ranked error images: every function of
``vis/maps.py`` against the JAX package's (arrays ``np.array_equal``, the
ranked PNGs pixel-equal with equal manifests, an mp4 written), and
``Evaluator.run``'s video frames and ranked records against JAX's
evaluator on the same scripted envs and experts (CPU, 16x16 to 32x32)."""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl.eval import Evaluator as JEvaluator
from pointnav_vo_tpu.vis import maps as jmaps

from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.eval import Evaluator as TEvaluator
from pointnav_vo_tpu_torch.vis import maps as tmaps

from test_eval import GreedyGoalPolicy as JGreedy
from test_torch_port_eval import TGreedy, _ensembles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_draw_top_down_map_matches_jax():
    traj = [(0.0, 0.0), (0.5, 0.2), (1.0, 0.8), (2.9, -2.9), (4.0, 4.0)]  # the last off the map
    for size, radius in ((128, 3.0), (64, 5.5)):
        want = jmaps.draw_top_down_map(traj, goal=(1.2, 1.0), room_radius=radius, size=size)
        got = tmaps.draw_top_down_map(traj, goal=(1.2, 1.0), room_radius=radius, size=size)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got == tmaps.PATH_COLOR).all(-1).any()


def test_trajectory_renderer_and_compose_match_jax():
    rng = np.random.default_rng(0)
    j = jmaps.TrajectoryMapRenderer(start=[0.0, 0.0, 0.0], goal=[2.0, 0.0, 2.5], size=96)
    t = tmaps.TrajectoryMapRenderer(start=[0.0, 0.0, 0.0], goal=[2.0, 0.0, 2.5], size=96)
    pos = np.zeros(3)
    for i in range(12):
        pos = pos + [rng.normal(0.2, 0.3), 0.0, rng.normal(0.2, 0.3)]
        yaw = rng.uniform(-np.pi, np.pi)
        j.add(pos, yaw)
        t.add(pos, yaw)
        np.testing.assert_array_equal(t.fog, j.fog)
        np.testing.assert_array_equal(t.render(), j.render())
    assert t.traj_px == j.traj_px
    rgb = rng.uniform(0, 255, (24, 40, 3)).astype(np.float32)
    got = tmaps.compose_map_frame(rgb, t.render())
    np.testing.assert_array_equal(got, jmaps.compose_map_frame(rgb, j.render()))
    assert got.shape == (24, 40 + 2 + 24, 3) and got.dtype == np.uint8


def test_generate_video_writes_an_mp4(tmp_path):
    frames = [np.full((32, 48, 3), i * 20, np.uint8) for i in range(8)]
    path = tmaps.generate_video(frames, str(tmp_path), "ep0", fps=5)
    assert path == str(tmp_path / "ep0.mp4") and os.path.getsize(path) > 0
    cap = cv2.VideoCapture(path)
    try:
        n = 0
        while cap.read()[0]:
            n += 1
    finally:
        cap.release()
    assert n == 8


def _records(seed):
    rng = np.random.default_rng(seed)
    return [{"vo_l2": float(v), "prev_rgb": rng.uniform(0, 255, (16, 16, 3)),
             "cur_rgb": rng.uniform(0, 255, (16, 16, 3)).astype(np.float32),
             "action": int(rng.integers(1, 4))}
            for v in rng.permutation(8) / 10]


def _assert_same_ranked(got_dir, want_dir, n, rtol=0.0):
    """The same images rank by rank and the same manifest; ``rtol``: the
    errors come from two packages' VO deltas, so the ``vo_l2`` values (and
    the file names that print them) may differ in the last digits."""
    manifests = []
    for d in (got_dir, want_dir):
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
        assert len(os.listdir(d)) == n + 1
    got, want = manifests
    assert len(got) == len(want) == n
    for rank, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(cv2.imread(a["path"]), cv2.imread(b["path"]),
                                      f"rank {rank}")
        np.testing.assert_allclose(a.pop("vo_l2"), b.pop("vo_l2"), rtol=rtol)
        pa, pb = os.path.basename(a.pop("path")), os.path.basename(b.pop("path"))
        assert pa.startswith(f"rank{rank:03d}_") and pb.startswith(f"rank{rank:03d}_")
        if not rtol:
            assert pa == pb
        assert a == b


def test_ranked_images_match_jax(tmp_path):
    recs = _records(0)
    got = tmaps.save_ranked_error_images(recs, str(tmp_path / "t"), top_k=3)
    want = jmaps.save_ranked_error_images(recs, str(tmp_path / "j"), top_k=3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert "0.7000" in got[0]  # worst first
    _assert_same_ranked(tmp_path / "t", tmp_path / "j", 3)


class _Frames:
    """A TensorBoard writer that keeps the videos it is given."""

    def __init__(self):
        self.videos = []

    def add_video_from_np_images(self, name, step, images, fps=10):
        self.videos.append((name, step, np.stack(images)))


def test_evaluator_videos_and_ranked_images_match_jax(tmp_path):
    """Det VO over 2 noise-free envs: the same [rgb | map] frames of env 0's
    first two episodes and the same ranked worst-VO images as JAX's
    evaluator, and the mp4 files on disk."""
    h = w = 32
    kw = dict(image_h=h, image_w=w, max_episode_steps=12, actuation_noise_multiplier=0.0,
              rgb_noise_intensity=0.0, depth_noise_multiplier=0.0)
    jens, tens = _ensembles(h, w)
    out = {}
    for side in ("t", "j"):
        tb = _Frames()
        run = dict(video_dir=str(tmp_path / side / "videos"), video_episodes=2,
                   ranked_img_dir=str(tmp_path / side / "ranked"), rank_top_k=4,
                   tb_writer=tb)
        if side == "t":
            ev = TEvaluator(model=TGreedy(), device="cpu", vo_ensemble=tens,
                            envs=tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), 2,
                                                                seed=3))
            agg = ev.run(4, **run)
        else:
            ev = JEvaluator(model=JGreedy(), variables={"params": {}}, vo_ensemble=jens,
                            rng=jax.random.PRNGKey(0), fused=True,
                            envs=jenvs.make_scripted_vector_env(jenvs.EnvConfig(**kw), 2,
                                                                seed=3))
            agg = ev.run(num_episodes=4, **run)
        out[side] = (agg, tb.videos)
    (tagg, tvid), (jagg, jvid) = out["t"], out["j"]
    assert tagg["total_env_steps"] == jagg["total_env_steps"]
    assert [(n, s) for n, s, _ in tvid] == [(n, s) for n, s, _ in jvid] == [
        ("video/episode_0", 0), ("video/episode_1", 1)]
    for (_, _, a), (_, _, b) in zip(tvid, jvid):
        assert a.shape == b.shape and a.shape[2] == w + 2 + h  # [rgb | gap | map]
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "t" / "videos")) == ["episode_0.mp4", "episode_1.mp4"]
    _assert_same_ranked(tmp_path / "t" / "ranked", tmp_path / "j" / "ranked", 4, rtol=1e-4)
