"""Port parity, the evaluator's host side: the shared-memory ring and the
shm env farm, the in-process VectorEnv's split step, pause and replay, the
habitat backend (over ``tests/fake_habitat.py``), and ``Evaluator.run``
over the farm, unfused, GPS-only and with a ``vo_fn`` hook, of
pointnav_vo_tpu_torch against the JAX package (CPU, 16x16 to 32x32
frames, 2-3 workers).

The farm's payload is float32: observations, rewards, poses and deltas
(float32 in every env) cross it bit for bit, while ``spl``, ``softspl``,
``distance_to_goal`` and ``agent_yaw`` (float64 in the in-process env)
arrive rounded to float32, so they are compared to the in-process values
after that rounding.  JAX and torch draw different random bits, so rnd mode is held
to JAX at dropout 0, and with dropout on to the port's own fused loop on
the same generator.
"""

import dataclasses
import glob
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fake_habitat
from pointnav_vo_tpu.config.defaults import get_rl_config as j_rl_config
from pointnav_vo_tpu.native import ShmRing as JShmRing
from pointnav_vo_tpu.native.shm_env import ShmVectorEnv as JShm
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl.eval import Evaluator as JEvaluator

from pointnav_vo_tpu_torch.config.defaults import get_rl_config
from pointnav_vo_tpu_torch.native import ShmRing, library_path
from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv as TShm
from pointnav_vo_tpu_torch.native.shm_env import ring_bytes
from pointnav_vo_tpu_torch.rl import envs as tenvs
from pointnav_vo_tpu_torch.rl.eval import Evaluator as TEvaluator

from test_eval import GreedyGoalPolicy as JGreedy
from test_torch_port_eval import TGreedy, _ensembles
from test_torch_port_rnd import _ensembles as _rnd_ensembles

H = W = 32
N_ENVS = 3
EPISODES = 6
# the float64 metrics the float32 payload rounds (and the float64 yaw of
# the infos)
ROUNDED = ("spl", "softspl", "distance_to_goal")
ROUNDED_INFO = ROUNDED + ("agent_yaw",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores: one torch thread
    each keeps their small ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_segment_left(monkeypatch):
    """Every ring a test makes, the port's or JAX's, has left ``/dev/shm``
    when the test ends.  Only the test's own names are checked: other test
    processes make farms of their own meanwhile."""
    made = []
    for cls in (ShmRing, JShmRing):
        def record(self, name, *args, _init=cls.__init__, **kwargs):
            made.append(name)
            _init(self, name, *args, **kwargs)

        monkeypatch.setattr(cls, "__init__", record)
    yield
    assert not [n for n in made if os.path.exists("/dev/shm" + n)]


@pytest.fixture
def habitat_stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "habitat", fake_habitat)
    return fake_habitat


def _kw(h=H, w=W, noise=False, **kw):
    if not noise:
        kw.update(actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                  depth_noise_multiplier=0.0)
    return dict(image_h=h, image_w=w, **kw)


def _f32(x):
    return np.float32(x) if np.isscalar(x) else x


def _assert_infos_equal(got, want, rounded=False):
    """Info dicts key for key; ``rounded``: ``want`` is the in-process
    env's (a superset of the farm's keys, float64 metrics)."""
    for a, b in zip(got, want, strict=True):
        if not rounded:
            assert a.keys() == b.keys()
        for k in a:
            wb = _f32(b[k]) if rounded and k in ROUNDED_INFO else b[k]
            if isinstance(a[k], dict):
                assert a[k] == wb, k
            else:
                np.testing.assert_array_equal(a[k], wb, err_msg=k)


def _assert_steps_equal(got, want, rounded=False):
    (go, gr, gd, gi), (wo, wr, wd, wi) = got, want
    assert go.keys() == wo.keys()
    for k in go:
        assert go[k].dtype == wo[k].dtype == np.float32
        np.testing.assert_array_equal(go[k], wo[k], err_msg=k)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gd, wd)
    _assert_infos_equal(gi, wi, rounded)


# ---------------------------------------------------------------- the ring


def test_ring_round_trip_order_and_timeouts():
    name = f"/pnvo_t_ring_{os.getpid()}"
    ring = ShmRing(name, slots=4, slot_bytes=64, create=True)
    try:
        assert library_path().parent.name == "native"
        assert library_path().exists()
        reader = ShmRing(name)
        out = np.zeros(16, np.float32)
        for i in range(10):
            ring.push(np.full(16, i, np.float32))
            reader.pop_into(out)
            np.testing.assert_array_equal(out, i)
        for i in range(4):  # fill to capacity, drain in order
            ring.push(np.full(16, 100 + i, np.float32))
        assert reader.size() == 4
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            ring.push(np.zeros(16, np.float32), timeout_ms=50)
        for i in range(4):
            reader.pop_into(out)
            assert out[0] == 100 + i
        with pytest.raises(TimeoutError):
            reader.pop_into(out, timeout_ms=50)
        assert time.monotonic() - t0 < 5
        with pytest.raises(ValueError, match="rc=-2"):
            ring.push(np.zeros(17, np.float32))
        with pytest.raises(ValueError, match="contiguous"):
            ring.push(np.zeros((4, 8), np.float32)[:, ::2])
        reader.close()
    finally:
        ring.close()
    with pytest.raises(OSError, match="attach failed"):
        ShmRing(name)


def test_ring_name_in_use_is_refused():
    """Creating a ring under a live segment's name fails with EEXIST and
    leaves that segment as it was; two farms of one process get distinct
    names."""
    name = f"/pnvo_t_dup_{os.getpid()}"
    ring = ShmRing(name, slots=2, slot_bytes=16, create=True)
    try:
        ring.push(np.arange(4, dtype=np.float32))
        with pytest.raises(OSError, match="create failed") as err:
            ShmRing(name, slots=2, slot_bytes=16, create=True)
        assert err.value.errno == 17  # EEXIST
        assert ring.size() == 1
        out = np.zeros(4, np.float32)
        reader = ShmRing(name)
        reader.pop_into(out, timeout_ms=50)
        reader.close()
        np.testing.assert_array_equal(out, np.arange(4))
    finally:
        ring.close()
    cfg = tenvs.EnvConfig(**_kw(8, 8))
    a, b = TShm(cfg, 1, seed=0), TShm(cfg, 1, seed=0)
    try:
        assert a._prefix != b._prefix
        assert glob.glob(f"/dev/shm{a._prefix}_*") and glob.glob(f"/dev/shm{b._prefix}_*")
    finally:
        a.close()
        b.close()


def test_ring_larger_than_dev_shm_fails_at_creation():
    """The segment is backed when it is made: a ring larger than /dev/shm
    raises ENOSPC there and leaves no segment behind."""
    st = os.statvfs("/dev/shm")
    too_big = 2 * st.f_blocks * st.f_frsize
    name = f"/pnvo_t_big_{os.getpid()}"
    with pytest.raises(OSError, match="create failed") as err:
        ShmRing(name, slots=1, slot_bytes=too_big, create=True)
    assert err.value.errno in (28, 27)  # ENOSPC, or EFBIG past the file size limit
    assert not os.path.exists("/dev/shm" + name)


# ---------------------------------------------------------------- the farm


def test_shm_farm_matches_jax_farm_and_vector_env():
    """Same seeds, same actions (STOP included, episodes of at most 8
    steps): the port's farm equals JAX's farm bit for bit, infos included,
    and the in-process VectorEnv up to the payload's float32 metrics."""
    kw = _kw(24, 16, noise=True, max_episode_steps=8)
    sync = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), N_ENVS, seed=7)
    tshm = TShm(tenvs.EnvConfig(**kw), N_ENVS, seed=7)
    jshm = JShm(jenvs.EnvConfig(**kw), N_ENVS, seed=7)
    try:
        o_t, o_j, o_s = tshm.reset(), jshm.reset(), sync.reset()
        for k in o_s:
            np.testing.assert_array_equal(o_t[k], o_j[k], err_msg=k)
            np.testing.assert_array_equal(o_t[k], o_s[k], err_msg=k)
        rng = np.random.default_rng(0)
        for _ in range(20):
            acts = rng.integers(0, 4, N_ENVS)
            got = tshm.step(acts)
            _assert_steps_equal(got, jshm.step(acts))
            _assert_steps_equal(got, sync.step(acts), rounded=True)
        assert tshm.current_episodes() == jshm.current_episodes()
        assert sum(tshm.current_episodes()) >= N_ENVS  # episodes did end
    finally:
        tshm.close()
        jshm.close()


def test_step_async_equals_step_and_a_dangling_step_closes():
    kw = _kw(16, 16, noise=True, max_episode_steps=10)
    a = TShm(tenvs.EnvConfig(**kw), 2, seed=11)
    b = TShm(tenvs.EnvConfig(**kw), 2, seed=11)
    c = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), 2, seed=11)
    try:
        a.reset(), b.reset(), c.reset()
        rng = np.random.default_rng(3)
        for _ in range(8):
            acts = rng.integers(1, 4, 2)
            want = a.step(acts)
            b.step_async(acts)
            _assert_steps_equal(b.step_wait(), want)
            c.step_async(acts)
            _assert_steps_equal(want, c.step_wait(), rounded=True)
        b.step_async([1, 1])  # pushed, never collected
    finally:
        t0 = time.monotonic()
        a.close()
        b.close()
        assert time.monotonic() - t0 < 15
    assert not any(p.is_alive() for p in a._procs + b._procs)


def test_killed_worker_is_reported_within_seconds():
    shm = TShm(tenvs.EnvConfig(**_kw(8, 8, max_episode_steps=10)), 2, seed=1)
    try:
        shm.reset()
        proc = shm._procs[1]
        proc.kill()
        proc.join(timeout=30)
        assert not proc.is_alive()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"worker\(s\) died: \[\(1, -9\)\]"):
            shm.step([1, 1])
        assert time.monotonic() - t0 < 5
    finally:
        shm.close()


class CountedEnv(tenvs.ScriptedPointNavEnv):
    """A scripted env that reports a finite dataset of 5 episodes."""

    number_of_episodes = 5


def test_number_of_episodes_before_and_after_reset():
    cfg = tenvs.EnvConfig(**_kw(8, 8))
    shm = TShm(cfg, 2, seed=3)
    counted = TShm(cfg, 2, seed=3, env_factory="test_torch_port_envfarm:CountedEnv")
    try:
        assert shm.number_of_episodes() == [None, None]  # asked before reset
        assert shm.reset()["rgb"].shape == (2, 8, 8, 3)
        assert shm.number_of_episodes() == [None, None]
        with pytest.raises(RuntimeError, match="once"):
            shm.reset()
        counted.reset()
        assert counted.number_of_episodes() == [5, 5]
    finally:
        shm.close()
        counted.close()
    with pytest.raises(ValueError, match="module:callable"):
        TShm(cfg, 1, env_factory="no_colon")


# ---------------------------------------------------------------- in-process envs


def test_pause_resume_and_reset_to_episode_match_jax():
    kw = _kw(8, 8, noise=True, max_episode_steps=6)
    je = jenvs.make_scripted_vector_env(jenvs.EnvConfig(**kw), 3, seed=0)
    te = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), 3, seed=0)
    ids = [id(e) for e in te.envs]
    _assert_steps_equal((te.reset(), 0, 0, []), (je.reset(), 0, 0, []))
    je.pause_at(1)
    te.pause_at(1)
    assert te.num_envs == je.num_envs == 2
    for _ in range(4):
        _assert_steps_equal(te.step([1, 2]), je.step([1, 2]))
    assert te.current_episodes() == je.current_episodes()
    je.close()
    te.close()  # resumes first
    assert te.num_envs == 3 and [id(e) for e in te.envs] == ids
    jenv = jenvs.ScriptedPointNavEnv(jenvs.EnvConfig(**kw), seed=4)
    tenv = tenvs.ScriptedPointNavEnv(tenvs.EnvConfig(**kw), seed=4)
    for ep in (3, 0, 5):
        jo, to = jenv.reset_to_episode(ep), tenv.reset_to_episode(ep)
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{k} episode {ep}")
        assert tenv._episode_id == jenv._episode_id == ep
        np.testing.assert_array_equal(tenv.goal_position(), jenv.goal_position())


def test_split_scenes_and_env_config_seed_match_jax():
    for scenes, n in ((["a", "b", "c", "d", "e"], 2), ([], 3), (["x"], 1)):
        assert tenvs.split_scenes(scenes, n) == jenvs.split_scenes(scenes, n)
    for bad in ((["a"], 2),):
        with pytest.raises(ValueError, match="reduce workers"):
            tenvs.split_scenes(*bad)
    got = dataclasses.asdict(tenvs.env_config_from_task(get_rl_config(), noisy=False, seed=9))
    want = dataclasses.asdict(jenvs.env_config_from_task(j_rl_config(), noisy=False, seed=9))
    assert got == want and got["seed"] == 9


# ---------------------------------------------------------------- the habitat backend


def _habitat_configs(num_envs=2, size=8, steps=12):
    out = []
    for make in (get_rl_config, j_rl_config):
        cfg = make()
        cfg.NUM_PROCESSES = num_envs
        for sensor in ("DEPTH_SENSOR", "RGB_SENSOR"):
            cfg.TASK_CONFIG.SIMULATOR[sensor].HEIGHT = size
            cfg.TASK_CONFIG.SIMULATOR[sensor].WIDTH = size
        cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = steps
        out.append(cfg)
    return out


def test_agent_state_delta_and_overlay_match_jax(habitat_stub):
    rng = np.random.default_rng(0)
    for _ in range(20):
        p0, p1 = rng.normal(size=3), rng.normal(size=3)
        q0, q1 = (q / np.linalg.norm(q) for q in rng.normal(size=(2, 4)))
        np.testing.assert_array_equal(tenvs.agent_state_delta(p0, q0, p1, q1),
                                      jenvs.agent_state_delta(p0, q0, p1, q1))
    quat = fake_habitat._Quat(0.1, 0.7, 0.2, 0.68)
    np.testing.assert_array_equal(tenvs._as_xyzw(quat), jenvs._as_xyzw(quat))
    assert tenvs.NOISE_CRITICAL_KEYS == jenvs.NOISE_CRITICAL_KEYS

    from pointnav_vo_tpu.utils.config import Config

    def locked():
        dst = Config({"A": {"X": 1}, "B": 2})
        for node in (dst, dst.A):
            object.__setattr__(node, "_new_allowed", False)
        return dst

    src = {"A": {"X": 5, "Y": 6}, "B": 7, "C": {"D": {"E": 1}, "F": 2}}
    t_dst, j_dst = locked(), locked()
    assert sorted(tenvs._overlay_config(t_dst, src)) == sorted(
        jenvs._overlay_config(j_dst, src)) == ["A.Y", "C.D.E", "C.F"]
    assert t_dst.to_dict() == j_dst.to_dict()


def test_habitat_refuses_a_silent_noise_drop(habitat_stub, monkeypatch):
    monkeypatch.setattr(fake_habitat, "STRICT_NO_NOISE", True)
    tcfg, _ = _habitat_configs(1)
    with pytest.raises(ValueError, match="noise-critical"):
        tenvs.HabitatNavEnv(tenvs.EnvConfig(**_kw(8, 8)), seed=0,
                            task_config=tcfg.TASK_CONFIG.to_dict())


@pytest.mark.parametrize("backend", ["sync", "shm"])
def test_habitat_backend_matches_jax(habitat_stub, backend):
    """The scene split, observations, rewards and infos (with their global
    episode keys in process) of the port's habitat envs equal JAX's over
    the same fake simulator."""
    tcfg, jcfg = _habitat_configs(2)
    te = tenvs.make_habitat_vector_env(tcfg, 2, seed=5, backend=backend)
    je = jenvs.make_habitat_vector_env(jcfg, 2, seed=5, backend=backend)
    try:
        if backend == "sync":
            t_scenes = [e._env.config.DATASET.CONTENT_SCENES for e in te.envs]
            assert t_scenes == [e._env.config.DATASET.CONTENT_SCENES for e in je.envs]
            assert sorted(sum(t_scenes, [])) == sorted(fake_habitat.ALL_SCENES)
        else:
            assert isinstance(te, TShm)
        _assert_steps_equal((te.reset(), 0, 0, []), (je.reset(), 0, 0, []))
        assert te.number_of_episodes() == je.number_of_episodes()
        rng = np.random.default_rng(1)
        keys = set()
        for _ in range(16):
            acts = rng.integers(0, 4, 2)
            got = te.step(acts)
            _assert_steps_equal(got, je.step(acts))
            keys |= {i["episode_key"] for i, d in zip(got[3], got[2]) if d and "episode_key" in i}
        if backend == "sync":
            assert keys and all(k[0] in fake_habitat.ALL_SCENES for k in keys)
    finally:
        te.close()
        je.close()


# ---------------------------------------------------------------- Evaluator.run


def _results(ev):
    return [dataclasses.asdict(r) for r in ev.results]


def _assert_same_eval(got, want, rounded=False):
    """Two runs of the port on the same trajectories: every aggregate and
    per-episode field equal (``rounded``: ``got`` ran over the farm, whose
    float32 payload rounds the ROUNDED metrics and carries no episode id)."""
    (gagg, gres), (wagg, wres) = got, want
    assert gagg.keys() == wagg.keys()
    for k in gagg:
        if k.startswith("time_"):
            continue
        if rounded and k in ROUNDED:
            np.testing.assert_allclose(gagg[k], wagg[k], rtol=1e-6, err_msg=k)
        else:
            assert gagg[k] == wagg[k], k
    assert len(gres) == len(wres)
    for a, b in zip(gres, wres):
        for k in a:
            if rounded and k == "episode_id":
                assert a[k] == -1
            elif rounded and k in ROUNDED:
                assert np.float32(a[k]) == np.float32(b[k]), k
            else:
                np.testing.assert_equal(a[k], b[k], err_msg=k)


def _assert_matches_jax(got, want, vo=True):
    """test_torch_port_eval.py's rules: exact counts, success and spl,
    rtol 1e-4 on the float metrics, equal per-episode steps."""
    (gagg, gres), (wagg, wres) = got, want
    assert gagg.keys() == wagg.keys()
    for k in ("episodes", "success", "spl", "total_env_steps", "stuck_dx", "stuck_dz",
              "stuck_both"):
        assert gagg[k] == wagg[k], k
    for k in ("softspl", "distance_to_goal", "reward") + (
            ("vo_l2_mean", "global_drift_mean") if vo else ()):
        np.testing.assert_allclose(gagg[k], wagg[k], rtol=1e-4, err_msg=k)
    assert [r["steps"] for r in gres] == [r["steps"] for r in wres]
    assert [r["success"] for r in gres] == [r["success"] for r in wres]


def _t_eval(envs, vo=None, **kw):
    ev = TEvaluator(model=TGreedy(), envs=envs, vo_ensemble=vo, device="cpu", **kw)
    try:
        agg = ev.run(EPISODES)
    finally:
        envs.close()
    return agg, _results(ev)


def _j_eval(envs, vo=None, **kw):
    ev = JEvaluator(model=JGreedy(), variables={"params": {}}, envs=envs, vo_ensemble=vo,
                    rng=jax.random.PRNGKey(0), **kw)
    try:
        agg = ev.run(num_episodes=EPISODES)
    finally:
        envs.close()
    return agg, _results(ev)


@pytest.fixture(scope="module")
def det_runs():
    """The det ensemble's fused eval: the port in process, and JAX over its farm."""
    jens, tens = _ensembles(H, W)
    kw = _kw(max_episode_steps=12)
    sync = _t_eval(tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), N_ENVS, seed=7),
                   tens)
    jax_shm = _j_eval(JShm(jenvs.EnvConfig(**kw), N_ENVS, seed=7), jens, fused=True)
    return {"jens": jens, "tens": tens, "kw": kw, "sync": sync, "jax_shm": jax_shm}


@pytest.mark.parametrize("overlap", [False, True])
def test_evaluator_over_the_farm_matches_sync_and_jax(det_runs, overlap, monkeypatch):
    monkeypatch.setenv("PNVO_EVAL_ASYNC", "1" if overlap else "0")
    shm = TShm(tenvs.EnvConfig(**det_runs["kw"]), N_ENVS, seed=7)
    calls = {"step_async": 0, "step_wait": 0}
    for name in calls:  # count the split step's calls
        def counted(*a, _fn=getattr(shm, name), _name=name):
            calls[_name] += 1
            return _fn(*a)
        setattr(shm, name, counted)
    got = _t_eval(shm, det_runs["tens"])
    _assert_same_eval(got, det_runs["sync"], rounded=True)
    _assert_matches_jax(got, det_runs["jax_shm"])
    assert got[0]["episodes"] == EPISODES and got[0]["total_env_steps"] > 2 * EPISODES
    if overlap:  # every step but the first is pushed early; the last push dangles
        assert calls["step_wait"] > 0 and calls["step_async"] == calls["step_wait"] + 1
    else:
        assert calls["step_async"] == calls["step_wait"] > 0  # inside step()


def test_gps_only_eval_matches_jax():
    """No VO: the policy reads the env's own goal sensor (noisy actuation);
    no VO or drift aggregates."""
    kw = _kw(16, 16, noise=True, max_episode_steps=20)
    got = _t_eval(tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), N_ENVS, seed=2))
    want = _j_eval(jenvs.make_scripted_vector_env(jenvs.EnvConfig(**kw), N_ENVS, seed=2))
    _assert_matches_jax(got, want, vo=False)
    assert "vo_l2_mean" not in got[0] and "global_drift_mean" not in got[0]
    assert got[0]["time_act_s"] > 0 and got[0]["time_device_s"] == 0
    assert got[0]["success"] > 0


def test_vo_fn_ground_truth_hook_reaches_every_goal():
    """tests/test_eval.py's oracle: the ground-truth delta as the VO hook
    gives success 1.0 and no drift, as in JAX."""
    kw = _kw(4, 4, max_episode_steps=60)
    seen = []

    def gt_vo(prev_obs, new_obs, actions_np, infos):
        seen.append(prev_obs["rgb"].device.type == new_obs["rgb"].device.type == "cpu")
        gt = torch.as_tensor(np.stack([i["gt_delta"] for i in infos]))
        return gt, torch.zeros_like(gt)

    def j_gt_vo(prev_obs, new_obs, actions, infos):
        gt = jnp.asarray(np.stack([i["gt_delta"] for i in infos]))
        return gt, jnp.zeros_like(gt)

    got = _t_eval(tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), N_ENVS, seed=1),
                  vo_fn=gt_vo)
    want = _j_eval(jenvs.make_scripted_vector_env(jenvs.EnvConfig(**kw), N_ENVS, seed=1),
                   vo_fn=j_gt_vo)
    assert got[0]["success"] == 1.0 and got[0]["spl"] > 0.5
    assert got[0]["global_drift_mean"] < 1e-4 and got[0]["vo_l2_mean"] < 1e-7
    assert all(seen) and got[0]["time_vo_s"] > 0
    _assert_matches_jax(got, want, vo=False)


@pytest.mark.parametrize("mode", ["det", "rnd"])
def test_unfused_eval_matches_jax(mode, det_runs):
    """``fused=False`` against JAX's unfused loop (rnd at dropout 0) and
    against the port's fused loop."""
    kw = det_runs["kw"]
    if mode == "det":
        jens, tens = det_runs["jens"], det_runs["tens"]
    else:
        jens, tens = _rnd_ensembles("rnd", dropout_p=0.0, k=3, h=H, w=W)

    def envs(lib):
        return lib.make_scripted_vector_env(lib.EnvConfig(**kw), N_ENVS, seed=7)

    got = _t_eval(envs(tenvs), tens, fused=False)
    _assert_matches_jax(got, _j_eval(envs(jenvs), jens, fused=False))
    fused = det_runs["sync"] if mode == "det" else _t_eval(envs(tenvs), tens)
    for k in ("episodes", "success", "total_env_steps", "vo_l2_mean", "global_drift_mean"):
        np.testing.assert_allclose(got[0][k], fused[0][k], rtol=1e-6, err_msg=k)
    assert got[0]["time_vo_s"] > 0 and got[0]["time_device_s"] == 0


def test_unfused_rnd_with_dropout_equals_fused_on_one_generator():
    """Both loops draw the dropout masks and the sampled actions from one
    generator in the same order, so the runs agree."""
    _, tens = _rnd_ensembles("rnd", dropout_p=0.3, k=3, h=H, w=W)
    kw = _kw(max_episode_steps=12)

    def run(fused):
        envs = tenvs.make_scripted_vector_env(tenvs.EnvConfig(**kw), N_ENVS, seed=4)
        return _t_eval(envs, tens, fused=fused, deterministic=False,
                       generator=torch.Generator().manual_seed(5))

    got, want = run(False), run(True)
    assert got[0]["vo_pred_std_mean"] > 0
    for k in want[0]:
        if not k.startswith("time_"):
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-6, err_msg=k)
    assert [r["steps"] for r in got[1]] == [r["steps"] for r in want[1]]


def test_habitat_eval_keys_episodes_by_dataset_identity(habitat_stub):
    """Over the habitat adapter the counted episodes carry (scene, episode)
    keys; the port's run equals JAX's (GPS-only, noisy fake simulator)."""
    tcfg, jcfg = _habitat_configs(2, size=8, steps=16)
    got = _t_eval(tenvs.make_habitat_vector_env(tcfg, 2, seed=5, backend="sync"))
    want = _j_eval(jenvs.make_habitat_vector_env(jcfg, 2, seed=5, backend="sync"))
    _assert_matches_jax(got, want, vo=False)
    assert [r["episode_id"] for r in got[1]] == [r["episode_id"] for r in want[1]]


def test_ring_bytes_at_full_width():
    """The farm's payload at 341x192: (192 * 341 * 4 + 24) float32."""
    cfg = tenvs.EnvConfig()
    assert ring_bytes(cfg, 1, 1) == (192 * 341 * 4 + 24) * 4 + 8 == 1_047_656
    assert ring_bytes(cfg, 32, 4) == 134_099_968


def test_eval_994_protocol_on_the_farm_equals_sync(monkeypatch):
    """The 994 script's eval phase on its default farm, with and without
    the overlap, counts the loop steps (``step`` or ``step_wait``) and the
    distinct episodes of the in-process run."""
    from pointnav_vo_tpu_torch.examples import eval_994

    _, tens = _ensembles(H, W)
    env_cfg = tenvs.EnvConfig(**_kw(noise=True, max_episode_steps=12))
    runs = {}
    for name, backend, overlap in (("sync", "sync", "0"), ("shm", "shm", "0"),
                                   ("shm_async", "shm", "1")):
        monkeypatch.setenv("PNVO_EVAL_ASYNC", overlap)
        runs[name] = eval_994.run_protocol(tens, env_cfg, episodes=EPISODES, n_envs=N_ENVS,
                                           device="cpu", backend=backend)
    want = runs["sync"]
    assert want["distinct_episodes"] == EPISODES and want["loop_steps"] > 1
    for name in ("shm", "shm_async"):
        got = runs[name]
        assert got["distinct_episodes"] == EPISODES
        assert got["loop_steps"] == want["loop_steps"]
        for k, v in want["metrics"].items():
            if k.startswith("time_"):
                continue
            if k in ROUNDED:
                np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
            else:
                assert got["metrics"][k] == v, k
    with pytest.raises(ValueError, match="unknown backend"):
        eval_994.make_envs(env_cfg, 1, "habitat")
