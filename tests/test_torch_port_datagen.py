"""Port parity, VO dataset generation and the process-parallel decode
reader: ``vo/dataset.py``'s generators, the ``vo/generate_datasets.py``
CLI and ``vo/parallel_reader.py`` of pointnav_vo_tpu_torch against the
JAX package (CPU, 64x36 renders, a 50-step episode cap).

Tolerances: files written with ``--obs_transform none`` are equal to
JAX's bit for bit, dataset by dataset (groups, names, dtypes, shapes,
compression, values).  With ``resize_crop`` the area resize sums in
another order (``adaptive_avg_pool2d`` against JAX's two matmuls), so a
pixel a hair from an integer can truncate to the next uint8 and a depth
round to the next float16: rgb within 1 on at most 1e-5 of the values,
depth within 1 float16 ulp on at most 5e-4 of them (measured: rgb equal at
64x36 and 1 off on 1.7e-6 of the values at 640x360 to 341x192, depth 1 ulp
off on 6.5e-5 and 3.8e-5); every other dataset equal.  The decode
reader's batches equal JAX's bit for bit.
"""

import dataclasses
import glob
import gzip
import json
import multiprocessing as mp
import os
import sys

import h5py
import numpy as np
import pytest
import torch

import fake_habitat
from pointnav_vo_tpu.rl.envs import EnvConfig as JEnvConfig
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import generate_datasets as jgen
from pointnav_vo_tpu.vo.parallel_reader import ParallelDecodeReader as JParallel

from pointnav_vo_tpu_torch.rl.envs import EnvConfig
from pointnav_vo_tpu_torch.vo import dataset as tdataset
from pointnav_vo_tpu_torch.vo import generate_datasets as tgen
from pointnav_vo_tpu_torch.vo.parallel_reader import ParallelDecodeReader

RENDER = dict(image_h=36, image_w=64, max_episode_steps=50)
RGB_OFF_BY_ONE = 1e-5  # resize_crop: the share of rgb values that may be 1 off
DEPTH_OFF_BY_ULP = 5e-4  # and of depth values 1 float16 ulp off
N_ENTRIES = 300  # two chunks of the schema's 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _datasets(path):
    """``{group/name: (dtype, shape, compression, values)}`` of a file."""
    out = {}
    with h5py.File(path, "r") as f:
        for g in f:
            for k, d in f[g].items():
                out[f"{g}/{k}"] = (d.dtype, d.shape, d.compression, d[()])
    return out


def _assert_files_equal(got_path, want_path, transformed=False):
    got, want = _datasets(got_path), _datasets(want_path)
    assert list(got) == list(want)
    for k, (dtype, shape, comp, w) in want.items():
        g = got[k]
        assert g[:3] == (dtype, shape, comp), k
        if transformed and k.endswith("rgbs"):
            diff = np.abs(g[3].astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= RGB_OFF_BY_ONE, (k, diff.mean())
        elif transformed and k.endswith("depths"):
            ulp = np.spacing(np.abs(w)).astype(np.float32)
            diff = np.abs(g[3].astype(np.float32) - w.astype(np.float32))
            assert (diff <= ulp).all() and (diff > 0).mean() <= DEPTH_OFF_BY_ULP, k
        else:
            np.testing.assert_array_equal(g[3], w, err_msg=k)


# ---------------------------------------------------------------- generators


GEN_CASES = {
    "all actions": {},
    "rnd_p 0.5": dict(rnd_p=0.5),
    "left turns only": dict(valid_actions=(2,)),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_dataset_matches_jax(case, tmp_path):
    kw = GEN_CASES[case]
    want = jdataset.generate_dataset(str(tmp_path / "jax.h5"), N_ENTRIES,
                                     env_cfg=JEnvConfig(**RENDER), seed=3, **kw)
    got = tdataset.generate_dataset(str(tmp_path / "port.h5"), N_ENTRIES,
                                    env_cfg=EnvConfig(**RENDER), seed=3, **kw)
    assert got == want == N_ENTRIES
    _assert_files_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert sorted(f) == ["chunk_0", "chunk_1"] and len(f["chunk_0"]) == 22
        assert f["chunk_0/actions"].shape == (256,) and f["chunk_1/actions"].shape == (44,)
        if "valid_actions" in kw:
            assert (f["chunk_1/actions"][()] == 2).all()


def test_scripted_dataset_and_rollout_iterator_match_jax(tmp_path):
    """``generate_scripted_dataset`` writes JAX's file; the h5py-free
    rollout iterator yields its rows in order."""
    jdataset.generate_scripted_dataset(str(tmp_path / "jax.h5"), 40,
                                       env_cfg=JEnvConfig(**RENDER), seed=1)
    tdataset.generate_scripted_dataset(str(tmp_path / "port.h5"), 40,
                                       env_cfg=EnvConfig(**RENDER), seed=1)
    _assert_files_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    entries = list(tdataset.iter_rollout_entries(40, env_cfg=EnvConfig(**RENDER), seed=1))
    with h5py.File(tmp_path / "jax.h5", "r") as f:
        assert len(entries) == 40 and set(entries[0]) == set(f["chunk_0"])
        for k in f["chunk_0"]:
            np.testing.assert_array_equal(np.stack([e[k] for e in entries]), f["chunk_0"][k][()],
                                          err_msg=k)


def test_follower_factory_and_parallel_generation_match_jax(tmp_path):
    """``oracle_follower_factory`` as the follower, forked over 2 workers:
    each shard equal to JAX's (worker i seeded ``seed + 1000 i``, the last
    one taking the remainder)."""
    want = jdataset.generate_dataset_parallel(
        str(tmp_path / "jax"), 21, 2, follower_factory=jdataset.oracle_follower_factory,
        env_cfg=JEnvConfig(**RENDER), seed=5)
    got = tdataset.generate_dataset_parallel(
        str(tmp_path / "port"), 21, 2, follower_factory=tdataset.oracle_follower_factory,
        env_cfg=EnvConfig(**RENDER), seed=5)
    assert [os.path.basename(p) for p in got] == ["port.w0.h5", "port.w1.h5"]
    for g, w in zip(got, want, strict=True):
        _assert_files_equal(g, w)
    with h5py.File(got[1], "r") as f:
        assert f["chunk_0/actions"].shape == (11,)


def test_parallel_generation_refuses_after_cuda_init(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="forked child cannot use the card"):
        tdataset.generate_dataset_parallel(str(tmp_path / "x"), 4, 2,
                                           env_cfg=EnvConfig(**RENDER))
    assert not glob.glob(str(tmp_path / "x*"))


# ---------------------------------------------------------------- the CLI


def _task_yaml(tmp_path):
    p = tmp_path / "task.yaml"
    p.write_text("SIMULATOR:\n"
                 "  RGB_SENSOR: {WIDTH: 64, HEIGHT: 36}\n"
                 "  DEPTH_SENSOR: {WIDTH: 64, HEIGHT: 36}\n"
                 "ENVIRONMENT: {MAX_EPISODE_STEPS: 50}\n")
    return str(p)


def _both_clis(tmp_path, args):
    """Both CLIs on the same arguments (the port's on the CPU); returns the
    two save dirs."""
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    common = ["--config_f", _task_yaml(tmp_path), "--vis_size_w", "64", "--vis_size_h", "36"]
    jgen.main(common + ["--save_dir", str(dirs["jax"])] + args)
    tgen.main(common + ["--save_dir", str(dirs["port"]), "--device", "cpu"] + args)
    return dirs


CLI_CASES = {
    # the TRAIN.md surface at a small size: two splits, {name}_{N}.h5
    "train_md": (["--backend", "scripted", "--data_version", "v2", "--obs_transform", "none",
                  "--act_type", "-1", "--rnd_p", "1.0", "--N_list", "300", "40",
                  "--name_list", "train", "val"], ["train_300.h5", "val_40.h5"]),
    "act_type": (["--backend", "scripted", "--act_type", "3", "--rnd_p", "0.7", "--seed", "2",
                  "--N_list", "30", "--name_list", "train"], ["train_30.h5"]),
    "workers": (["--backend", "scripted", "--workers", "2", "--N_list", "41",
                 "--name_list", "val"], ["val_41.w0.h5", "val_41.w1.h5"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax(case, tmp_path):
    args, names = CLI_CASES[case]
    dirs = _both_clis(tmp_path, args)
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"])) == sorted(names)
    for name in names:
        _assert_files_equal(str(dirs["port"] / name), str(dirs["jax"] / name))
    if case == "act_type":
        with h5py.File(dirs["port"] / names[0], "r") as f:
            assert (f["chunk_0/actions"][()] == 3).all()


def test_cli_resize_crop_within_bounds(tmp_path):
    """64x36 renders resized on the shortest edge and cropped to 32x24."""
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    args = ["--config_f", _task_yaml(tmp_path), "--backend", "scripted", "--N_list", "40",
            "--name_list", "train", "--vis_size_w", "32", "--vis_size_h", "24",
            "--obs_transform", "resize_crop"]
    jgen.main(args + ["--save_dir", str(dirs["jax"])])
    tgen.main(args + ["--save_dir", str(dirs["port"]), "--device", "cpu"])
    _assert_files_equal(str(dirs["port"] / "train_40.h5"), str(dirs["jax"] / "train_40.h5"),
                        transformed=True)
    batch = next(tdataset.FramePairReader(str(dirs["port"] / "train_40.h5"), 32, 24)
                 .iter_batches(40))
    assert batch.cur_rgb.shape == (40, 24, 32, 3) and batch.cur_depth.shape == (40, 24, 32, 1)


def test_make_obs_transform_truncates_as_jax():
    """The transform alone, on frames whose area means land near integers."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (36, 64, 3)).astype(np.uint8)
    depth = rng.uniform(0, 1, (36, 64, 1)).astype(np.float32)
    for kind in ("resize", "resize_crop"):
        jt = jgen.make_obs_transform(kind, 32, 24)
        tt = tgen.make_obs_transform(kind, 32, 24, "cpu")
        got, want = tt(rgb), jt(rgb)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= RGB_OFF_BY_ONE, kind
        np.testing.assert_allclose(tt(depth), jt(depth), rtol=1e-6, atol=1e-7, err_msg=kind)
    assert tgen.make_obs_transform("none", 32, 24, "cpu") is None


def test_scene_lists_match_jax(tmp_path):
    content = tmp_path / "content"
    content.mkdir()
    for s in ("Cross", "Adrian", "Beach"):
        (content / f"{s}.json.gz").write_bytes(b"")
    assert tgen.scene_list_v2(str(content)) == jgen.scene_list_v2(str(content)) == [
        "Adrian", "Beach", "Cross"]
    v1 = tmp_path / "val.json.gz"
    with gzip.open(v1, "wt") as f:
        f.write(json.dumps({"episodes": [{"scene_id": f"data/scene/{s}.glb"}
                                         for s in ("Zed", "Arkansaw", "Zed")]}))
    assert tgen.scene_list_v1(str(v1)) == jgen.scene_list_v1(str(v1)) == ["Arkansaw", "Zed"]


def test_cli_habitat_backend_matches_jax(tmp_path, monkeypatch):
    """``--backend habitat`` over ``tests/fake_habitat.py`` (it has no
    ShortestPathFollower: each CLI gets its package's oracle follower)."""
    monkeypatch.setitem(sys.modules, "habitat", fake_habitat)
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    args = ["--config_f", _task_yaml(tmp_path), "--backend", "habitat", "--N_list", "30",
            "--name_list", "train", "--vis_size_w", "64", "--vis_size_h", "36"]
    jgen.main(args + ["--save_dir", str(dirs["jax"]),
                      "--follower", "pointnav_vo_tpu.vo.dataset:oracle_follower_factory"])
    tgen.main(args + ["--save_dir", str(dirs["port"]), "--device", "cpu",
                      "--follower", "pointnav_vo_tpu_torch.vo.dataset:oracle_follower_factory"])
    _assert_files_equal(str(dirs["port"] / "train_30.h5"), str(dirs["jax"] / "train_30.h5"))


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """The default ``--device`` is the card: with none, main raises before
    writing anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--save_dir", str(tmp_path / "ds"), "--backend", "scripted",
                   "--N_list", "4", "--name_list", "train"])
    assert not (tmp_path / "ds").exists()
    assert tgen.build_parser().parse_args(["--save_dir", "x", "--N_list", "1", "--name_list",
                                           "val"]).device == "cuda"


def test_cli_forking_parent_never_asks_cuda(tmp_path, monkeypatch):
    """With ``--workers 2`` a forked child checks for the card: the parent
    never queries the CUDA runtime, which would leave its forked writers
    unable to use the card, and a missing card still raises before
    anything is written."""
    parent = os.getpid()

    def no_card():
        assert os.getpid() != parent, "the forking parent queried the CUDA runtime"
        return False

    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--save_dir", str(tmp_path / "ds"), "--backend", "scripted",
                   "--workers", "2", "--N_list", "4", "--name_list", "train"])
    assert not (tmp_path / "ds").exists()


def test_parser_matches_jax():
    """The same arguments and defaults, plus ``--device``."""
    jp, tp = jgen.build_parser(), tgen.build_parser()
    jacts = {a.dest: (a.default, a.choices, a.nargs, a.required) for a in jp._actions}
    tacts = {a.dest: (a.default, a.choices, a.nargs, a.required) for a in tp._actions}
    assert tacts.pop("device") == ("cuda", ["cuda", "cpu"], None, False)
    assert tacts == jacts


# ---------------------------------------------------------------- the decode reader


@pytest.fixture(scope="module")
def decode_path(tmp_path_factory):
    """600 entries at 32x24: three chunks, so both workers decode."""
    path = str(tmp_path_factory.mktemp("pdec") / "train.h5")
    jdataset.generate_scripted_dataset(
        path, 600, env_cfg=JEnvConfig(image_h=24, image_w=32, max_episode_steps=40), seed=3)
    return path


def _kwargs(path, **kw):
    return {"path": path, "vis_size_w": 32, "vis_size_h": 24, "act_type": -1, **kw}


def _own_segments():
    return [f for f in os.listdir("/dev/shm") if f.startswith(f"pnvdec_{os.getpid()}_")]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.twins_packed == w.twins_packed
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _keys(batches):
    """The samples of an epoch as a sorted list: a worker's ``chunk_idx``
    counts its own chunks, so a sample is told by its entry, data type and
    target."""
    return sorted((int(b.actions[i]), int(b.entry_idx[i]), int(b.data_types[i]),
                   b.gt_delta[i].tobytes()) for b in batches for i in range(b.actions.shape[0]))


@pytest.mark.parametrize("case", ["all actions", "joint twins"])
def test_parallel_reader_stream_matches_jax(decode_path, case):
    """Two workers: JAX's batches in JAX's order under the same rng, the
    serial reader's samples, twins adjacent in the joint layout."""
    kw = (_kwargs(decode_path) if case == "all actions" else
          _kwargs(decode_path, act_type=[2, 3], geo_invariance_types=("inverse_joint_train",)))
    got = list(ParallelDecodeReader(kw, 2).iter_batches(16, rng=np.random.default_rng(4),
                                                         drop_last=case != "all actions"))
    want = list(JParallel(kw, 2).iter_batches(16, rng=np.random.default_rng(4),
                                              drop_last=case != "all actions"))
    _assert_batches_equal(got, want)
    serial = tdataset.FramePairReader(**kw)
    if case == "all actions":
        assert _keys(got) == _keys(serial.iter_batches(16))
    else:
        for b in got:
            assert b.twins_packed
            assert (b.data_types[0::2] == 0).all() and (b.data_types[1::2] == 1).all()
            np.testing.assert_array_equal(b.entry_idx[0::2], b.entry_idx[1::2])
    assert not _own_segments()


def test_parallel_reader_unshuffled_epoch_and_metadata(decode_path):
    kw = _kwargs(decode_path, act_type=1)
    par = ParallelDecodeReader(kw, 2)
    serial = tdataset.FramePairReader(**kw)
    got = list(par.iter_batches(32))
    _assert_batches_equal(got, list(JParallel(kw, 2).iter_batches(32)))
    assert _keys(got) == _keys(serial.iter_batches(32))
    assert par.num_samples() == serial.num_samples()
    assert par.chunks == serial.chunks and par.paths == serial.paths
    assert not _own_segments()


def test_parallel_reader_shard_composition(decode_path):
    """Worker slices compose with a host shard: ``chunks[s::n][w::W]``."""
    for shard in ((0, 1), (1, 2)):
        kw = _kwargs(decode_path, shard_index=shard[0], num_shards=shard[1])
        par = ParallelDecodeReader(kw, 2)
        jpar = JParallel(kw, 2)
        parts = [tdataset.FramePairReader(**par._worker_kwargs(w)).chunks for w in range(2)]
        assert [par._worker_kwargs(w) for w in range(2)] == [jpar._worker_kwargs(w)
                                                              for w in range(2)]
        assert sorted(parts[0] + parts[1]) == sorted(par.chunks)
        assert not set(parts[0]) & set(parts[1])
    with pytest.raises(ValueError):
        ParallelDecodeReader(_kwargs(decode_path), 0)


def test_parallel_reader_killed_worker_raises(decode_path):
    """Workers killed mid-epoch: a RuntimeError naming the exit code, never
    a short epoch; every ring unlinked."""
    it = ParallelDecodeReader(_kwargs(decode_path), 2).iter_batches(
        16, rng=np.random.default_rng(0))
    first = next(it)
    assert first.actions.shape == (16,)
    for p in mp.active_children():
        p.kill()
    with pytest.raises(RuntimeError, match=r"decode worker \d died \(exit code -9\)"):
        for _ in it:
            pass
    assert not _own_segments()
