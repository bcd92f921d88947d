"""The tracer (``utils/logging.py``: ``Timing``, ``TRACER``, ``h2d``,
``h2d_async``, ``device_const``): its aggregates and counters, its ranges
under ``torch.profiler``, the reset it shares with the launch counts, the
cached constants, and the uploads it counts in the eval step and the VO
train step (CPU); on the card (``-m cuda``, skipped where there is none)
that count against CUDA's own sync debug mode, a host batch overwritten
while its upload may still be queued, and the pinned pool over many steps.

No JAX here: the card's machine runs ``pytest -m cuda --noconftest`` on
this file.
"""

import copy
import dataclasses
import json
import linecache
import os
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, pixel_bins
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils.logging import TRACER, Timing
from pointnav_vo_tpu_torch.vo import engine as tengine
from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOEnsemble,
    VOInferenceConfig,
    frame_features_packed,
)

H, W, N, HIDDEN, BATCH = 32, 48, 6, 32, 8
# cached constants (utils/logging.py::device_const), each a const_hit once
# warm and a blocking upload only on its first use: a frame's features take
# 13 (the 12 float32 constants of ops/topdown.py::pixel_bins, the 255 of
# pack_frame_features), the goal's geometry 1, the loss weights 1
FRAME_CONSTANTS = 13
EVAL_CONSTANTS = FRAME_CONSTANTS + 1
TRAIN_CONSTANTS = 2 * FRAME_CONSTANTS + 1


@pytest.fixture(autouse=True)
def _clean_tracer():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


def _counted(timing: Timing) -> dict:
    return {k: c for k, (c, _ns, _parent) in timing.aggs.items()}


# ------------------------------------------------------------------ the tracer


def test_spans_aggregate_count_nanoseconds_and_parent_per_name():
    t = Timing()
    for _ in range(3):
        with t.span("step"):
            with t.span("child"):
                pass
            with t.span("child"):
                pass
    t.count("syncs")
    t.count("bytes", 40)
    t.count("bytes", 2)
    snap = t.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {"step": 3, "child": 6}
    assert snap["spans"]["step"]["parents"] == [None]
    assert snap["spans"]["child"]["parents"] == ["step"]
    assert snap["spans"]["step"]["total_ns"] >= snap["spans"]["child"]["total_ns"] > 0
    assert t["step"] == snap["spans"]["step"]["total_ns"] * 1e-9  # the dict face: seconds
    assert snap["counters"] == {"syncs": 1, "bytes": 42}
    assert "profiled" not in snap  # a Timing keeps profiled spans apart only when asked
    json.dumps(snap)  # plain data


def test_an_exception_still_closes_the_span():
    t = Timing()
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("inner"):
                raise ValueError
    assert _counted(t) == {"outer": 1, "inner": 1} and t.open == []
    with t.span("next"):
        pass
    assert t.snapshot()["spans"]["next"]["parents"] == [None]


def test_timing_keeps_preset_keys_and_pickles():
    import pickle

    t = Timing.fromkeys(("env", "act"), 0.0)
    with t.span("env"):
        pass
    assert list(t) == ["env", "act"] and t["act"] == 0.0 and t["env"] > 0
    u = pickle.loads(pickle.dumps(t))
    assert u == t and _counted(u) == {"env": 1}


def test_under_the_profiler_spans_are_ranges_kept_apart(tmp_path):
    """Under ``torch.profiler`` each span is a ``record_function`` range
    nested in the caller's range, and its time goes to ``profiled``; a
    Timing without ``profiled`` keeps them with the rest."""
    own = Timing()
    with TRACER.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            with TRACER.span("eval_step"):
                with TRACER.span("vo.predict"):
                    torch.ones(4).add_(1)
            with own.span("env"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert {"outer", "eval_step", "vo.predict", "env"} <= set(ranges)
    assert "before" not in ranges
    (o0, o1), (s0, s1), (p0, p1) = ranges["outer"], ranges["eval_step"], ranges["vo.predict"]
    assert o0 <= s0 <= p0 <= p1 <= s1 <= o1
    snap = TRACER.snapshot()
    assert set(snap["spans"]) == {"before"}
    assert {k: v["count"] for k, v in snap["profiled"].items()} == {"eval_step": 1,
                                                                  "vo.predict": 1}
    assert snap["profiled"]["vo.predict"]["parents"] == ["eval_step"]
    assert _counted(own) == {"env": 1}


def test_reset_launch_counts_clears_spans_and_counters():
    with TRACER.span("eval_step"):
        TRACER.count("host_syncs", 3)
        TRACER.count("bin_counts")
    assert tk.launch_counts is TRACER.counters
    assert tk.launch_counts["bin_counts"] == 1 and TRACER.counters["host_syncs"] == 3
    tk.reset_launch_counts()
    snap = TRACER.snapshot()
    assert snap["spans"] == {} and snap["profiled"] == {} and dict(TRACER) == {}
    assert set(snap["counters"].values()) == {0}
    assert tk.launch_counts["bin_counts"] == 0
    TRACER.count("bin_counts")
    assert tk.launch_counts["bin_counts"] == 1


def test_trace_scope_writes_the_tracer_snapshot(tmp_path):
    with tlog.trace(str(tmp_path / "t")):
        with TRACER.span("eval_step"):
            torch.ones(4).add_(1)
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert spans["profiled"]["eval_step"]["count"] == 1
    assert (tmp_path / "t" / "trace.json").is_file()


def test_h2d_counts_every_copy_whatever_the_device():
    a = np.arange(6, dtype=np.float32)
    out = tlog.h2d(a, torch.device("cpu"))
    assert torch.equal(out, torch.from_numpy(a))
    assert TRACER.counters["host_syncs"] == 1 and TRACER.counters["h2d_bytes"] == 24
    assert _counted(TRACER) == {"sync.h2d": 1}


def test_h2d_async_on_the_cpu_equals_h2d_and_counts_apart():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    for dtype in (None, torch.float64):
        want = tlog.h2d(a, "cpu", dtype)
        tk.reset_launch_counts()
        got = tlog.h2d_async(a, torch.device("cpu"), dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert TRACER.counters["host_syncs"] == 0 and TRACER.counters["h2d_async"] == 1
        assert TRACER.counters["h2d_async_bytes"] == want.nbytes
        assert _counted(TRACER) == {}


def test_an_expert_without_rows_gets_empty_buckets():
    arrs = {"actions": tlog.h2d_async(np.ones(4, np.int64), "cpu")}
    out = tengine.attach_expert_buckets(arrs, np.ones(4, np.int32), (1, 2))
    assert torch.equal(out["bucket_idx_0"], torch.arange(4))
    assert out["bucket_idx_1"].dtype == torch.int64 and out["bucket_idx_1"].shape == (0,)
    assert out["bucket_own_1"].dtype == torch.float32 and out["bucket_own_1"].shape == (0,)
    assert TRACER.counters["h2d_async"] == 5 and TRACER.counters.get("host_syncs", 0) == 0


def test_device_const_is_uploaded_once_and_then_shared(monkeypatch):
    monkeypatch.setattr(tlog, "_CONSTS", {})
    first = tlog.device_const(0.1, "cpu")
    assert TRACER.counters["host_syncs"] == 1 and TRACER.counters.get("const_hits", 0) == 0
    assert tlog.device_const(0.1, torch.device("cpu")) is first
    assert tlog.device_const(0.1, "cpu", torch.float32) is first
    assert TRACER.counters["host_syncs"] == 1 and TRACER.counters["const_hits"] == 2
    # exact: the value a Python float rounds to in the dtype, no other
    assert first.dtype == torch.float32 and first.shape == ()
    assert torch.equal(first, torch.tensor(0.1, dtype=torch.float32))
    table = tlog.device_const([[0.0, -0.25, 0.0], [1.5, 2.0, -3.0]], "cpu", torch.float64)
    assert table.dtype == torch.float64 and table.tolist() == [[0.0, -0.25, 0.0],
                                                              [1.5, 2.0, -3.0]]
    assert torch.equal(tlog.device_const(255.0, "cpu", torch.bfloat16),
                       torch.tensor(255.0, dtype=torch.bfloat16))


def test_device_const_keys_on_the_device_the_dtype_the_shape_and_the_bits(monkeypatch):
    monkeypatch.setattr(tlog, "_CONSTS", {})
    base = tlog.device_const(2.0, "cpu")
    others = [tlog.device_const(2.0, "cpu", torch.float64), tlog.device_const(2.0, "meta"),
              tlog.device_const([2.0], "cpu"), tlog.device_const(2.5, "cpu")]
    assert all(o is not base for o in others) and len({id(o) for o in others}) == 4
    assert others[0].dtype == torch.float64 and others[1].device.type == "meta"
    assert others[2].shape == (1,)
    zero, neg = tlog.device_const(0.0, "cpu"), tlog.device_const(-0.0, "cpu")
    assert zero is not neg and torch.signbit(neg) and not torch.signbit(zero)
    assert TRACER.counters["host_syncs"] == 7 and TRACER.counters.get("const_hits", 0) == 0


def test_pixel_bins_are_bit_identical_on_a_cold_and_a_warm_cache(monkeypatch):
    monkeypatch.setattr(tlog, "_CONSTS", {})
    params = TopDownParams(vis_size_h=H, vis_size_w=W, rows_around_center=10)
    depth = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (3, H, W))
                             .astype(np.float32))
    depth[0, :3] = 0.0  # an empty border to strip
    cold = pixel_bins(depth, params)
    assert TRACER.counters["host_syncs"] == 10  # 12 constants, 2 of them repeats
    tk.reset_launch_counts()
    warm = pixel_bins(depth, params)
    assert TRACER.counters["host_syncs"] == 0 and TRACER.counters["const_hits"] == 12
    for c, w in zip(cold, warm):
        assert c.dtype == w.dtype and torch.equal(c, w)


# ------------------------------------------------------ the eval and train steps


def _eval_step(dev, actions, mode="det"):
    """A closure running one ``fused_vo_act_step`` at a tiny size on ``dev``."""
    g = torch.Generator().manual_seed(0)
    cfg = VOInferenceConfig(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, mode=mode,
                            rnd_mode_n=3)
    vo = VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                    device=dev)
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W), hidden_size=HIDDEN,
                                              baseplanes=8), g).to(dev).eval()
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    rgb = t(rng.integers(0, 256, (2, N, H, W, 3)).astype(np.uint8))
    depth = t(rng.uniform(0, 1, (2, N, H, W, 1)).astype(np.float32))
    prev = frame_features_packed(rgb[0], depth[0], cfg)
    reset = t(np.zeros((N, 1), np.float32))
    sensor = t(np.stack([rng.uniform(0.5, 5, N), rng.uniform(-3, 3, N)], -1)
               .astype(np.float32))
    goal = t(rng.normal(size=(N, 3)).astype(np.float32))
    seed_rot = t(np.tile(np.asarray([0, 0, 0, 1], np.float32), (N, 1)))
    seed_pos = t(np.zeros((N, 3), np.float32))
    hidden = policy.initial_hidden(N, dev)
    prev_actions = t(np.asarray(actions, np.int64)[:, None])
    gen = torch.Generator(device=dev).manual_seed(0)
    acts = np.asarray(actions, np.int32)

    def step():
        return fused_vo_act_step(policy, vo, prev, rgb[1], depth[1], acts, goal, reset,
                                 sensor, hidden, prev_actions, 1.0 - reset, seed_rot,
                                 seed_pos, seed_rot, seed_pos, generator=gen)

    return step


EVAL_MIXES = {  # actions -> experts with rows (STOP runs the forward expert)
    "forward only": ([1] * N, 1),
    "stop and left": ([0, 2, 2, 0, 1, 2], 2),
    "all three": ([1, 2, 3, 1, 0, 3], 3),
}


@pytest.mark.parametrize("mode", ["det", "rnd"])
@pytest.mark.parametrize("mix", list(EVAL_MIXES))
def test_eval_step_counts_one_upload_per_expert_with_rows(mix, mode):
    """A warmed step uploads every expert's rows in one copy without a host
    sync, and each expert with rows runs in a ``vo.expert`` span (eagerly
    on the CPU)."""
    actions, experts = EVAL_MIXES[mix]
    step = _eval_step(torch.device("cpu"), actions, mode)
    step()  # warm-up: the constants' first uploads
    tk.reset_launch_counts()
    for _ in range(2):
        step()
    assert TRACER.counters.get("host_syncs", 0) == 0
    assert TRACER.counters["h2d_async"] == 2
    assert TRACER.counters["const_hits"] == 2 * EVAL_CONSTANTS
    assert TRACER.counters["h2d_async_bytes"] == 2 * 8 * N  # every row's int64 index
    assert TRACER.counters["vo_graph_eager"] == 2 * experts
    calls = _counted(TRACER)
    assert calls == {"eval_step": 2, "features": 2, "vo.predict": 2, "vo.expert": 2 * experts,
                     "goal": 2, "policy": 2, "policy.encoder": 2,
                     "policy.rnn": 2, "policy.heads": 2, "pose": 2}
    parents = {k: v["parents"] for k, v in TRACER.snapshot()["spans"].items()}
    assert parents == {"eval_step": [None], "features": ["eval_step"],
                       "vo.predict": ["eval_step"], "vo.expert": ["vo.predict"],
                       "goal": ["eval_step"],
                       "policy": ["eval_step"], "policy.encoder": ["policy"],
                       "policy.rnn": ["policy"], "policy.heads": ["policy"],
                       "pose": ["eval_step"]}


def _frame_pairs(actions, data_types, seed=0) -> FramePairBatch:
    rng = np.random.default_rng(seed)
    n = len(actions)
    return FramePairBatch(
        prev_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
        cur_rgb=rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8),
        prev_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
        cur_depth=rng.uniform(0, 1, (n, H, W, 1)).astype(np.float32),
        actions=np.asarray(actions, np.int32),
        gt_delta=rng.normal(0, 0.1, (n, 3)).astype(np.float32),
        data_types=np.asarray(data_types, np.int32),
        dz_regress_mask=np.ones(n, np.float32),
        chunk_idx=np.zeros(n, np.int32), entry_idx=np.arange(n, dtype=np.int32))


TRAIN_STAGES = {  # stage -> (train config, batch's actions, data types, experts)
    "forward": (dict(action_type=1), [1] * BATCH, [0] * BATCH, 1),
    "joint": (dict(action_type=(2, 3), geo_invariance_types=("inverse_joint_train",)),
              [2, 3] * (BATCH // 2), [0, 1] * (BATCH // 2), 2),
}


def _engine(stage, dev):
    kw = TRAIN_STAGES[stage][0]
    return tengine.VORegressionEngine(
        VOInferenceConfig(vis_size_w=W, vis_size_h=H, hidden_size=HIDDEN, dropout_p=0.0),
        tengine.VOTrainConfig(batch_size=BATCH, **kw), device=dev)


@pytest.mark.parametrize("stage", list(TRAIN_STAGES))
def test_train_step_counts_eight_uploads_plus_two_per_expert(stage):
    _kw, actions, data_types, experts = TRAIN_STAGES[stage]
    engine = _engine(stage, torch.device("cpu"))
    engine.train_step(_frame_pairs(actions, data_types, 1))  # warm-up: the constants
    batch = _frame_pairs(actions, data_types)
    tk.reset_launch_counts()
    engine.train_step(batch)
    assert TRACER.counters["host_syncs"] == 0
    assert TRACER.counters["h2d_async"] == 8 + 2 * experts
    assert TRACER.counters["const_hits"] == TRAIN_CONSTANTS
    # per row: actions, data types int64, gt 3 and dz mask float32, both
    # frames' rgb uint8 and depth float32, its bucket's int64 index and
    # float32 ownership
    assert TRACER.counters["h2d_async_bytes"] == BATCH * (8 + 8 + 12 + 4 + 14 * H * W + 12)
    calls = _counted(TRACER)
    assert calls == {"vo_train.step": 1, "vo_train.upload": 1, "vo_train.optimizer": 2,
                     "vo_train.features": 1, "features": 2, "vo_train.forward": 1,
                     "vo_train.loss": 1, "vo_train.backward": 1}
    parents = {k: v["parents"] for k, v in TRACER.snapshot()["spans"].items()}
    assert parents["features"] == ["vo_train.features"]
    assert {p for k in calls if k.startswith("vo_train.") and k != "vo_train.step"
            for p in parents[k]} == {"vo_train.step"}


# ---------------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sync_warnings(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    tracer's ``host_syncs`` delta, the syncs CUDA warned of, counted by the
    line that made them, and any other warning's message."""
    fn()  # a second warm-up: nothing of the first call's set-up is left
    torch.cuda.synchronize()
    before = TRACER.counters.get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(f"{os.path.relpath(w.filename)}:{w.lineno} "
                    f"{linecache.getline(w.filename, w.lineno).strip()}" for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message))
    others = [str(w.message)[:200] for w in caught
              if "called a synchronizing CUDA operation" not in str(w.message)]
    return TRACER.counters["host_syncs"] - before, syncs, others


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "rnd"])
@pytest.mark.parametrize("mix", list(EVAL_MIXES))
def test_eval_step_syncs_are_the_counted_ones_on_card(cuda, mix, mode):
    actions, experts = EVAL_MIXES[mix]
    step = _eval_step(cuda, actions, mode)
    step()  # the first call's set-up (cuDNN plans, the kernel's build, the constants)
    counted, syncs, others = _sync_warnings(step)
    assert counted == 0  # the rows go up without a sync; the constants are cached
    assert sum(syncs.values()) == counted, (dict(syncs), others)
    assert TRACER.counters["vo_graph_replays"] == 2 * experts  # the checked step's too


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(TRAIN_STAGES))
def test_train_step_syncs_are_the_counted_ones_on_card(cuda, stage):
    _kw, actions, data_types, experts = TRAIN_STAGES[stage]
    engine = _engine(stage, cuda)
    engine.train_step(_frame_pairs(actions, data_types, 0))
    counted, syncs, others = _sync_warnings(lambda: engine.train_step(
        _frame_pairs(actions, data_types, 1)))
    assert counted == 0 and not syncs, (dict(syncs), others)


def _overwrite(batch: FramePairBatch) -> None:
    for f in dataclasses.fields(batch):
        a = getattr(batch, f.name)
        if isinstance(a, np.ndarray):
            a.fill(7)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(TRAIN_STAGES))
def test_host_batch_may_be_overwritten_once_train_step_returns_on_card(cuda, stage):
    """Every array of each host batch overwritten right after
    ``train_step`` returns, before any sync: three steps give the losses
    and parameters of a run on untouched copies, bit for bit (cuDNN's
    deterministic algorithms on both runs)."""
    _kw, actions, data_types, _experts = TRAIN_STAGES[stage]
    batches = [_frame_pairs(actions, data_types, s) for s in range(3)]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = []
        for overwrite in (False, True):
            engine = _engine(stage, cuda)
            losses = []
            for b in copy.deepcopy(batches):
                losses.append(engine.train_step(b)["total_loss"])
                if overwrite:
                    _overwrite(b)
            torch.cuda.synchronize()
            runs.append(([float(x) for x in losses],
                         [p.detach().cpu() for m in engine.experts for p in m.parameters()]))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (loss_a, params_a), (loss_b, params_b) = runs
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


@pytest.mark.cuda
def test_pinned_host_memory_stays_bounded_on_card(cuda):
    """30 train steps, synchronised every 5 as a loop that logs: the pinned
    pool grows by at most what 6 steps' uploads hold rounded to powers of
    two (a leak would hold all 30)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        pytest.skip("this torch has no torch.cuda.host_memory_stats")
    _kw, actions, data_types, _experts = TRAIN_STAGES["forward"]
    engine = _engine("forward", cuda)
    batch = _frame_pairs(actions, data_types)
    engine.train_step(batch)
    torch.cuda.synchronize()
    before = stats().get("allocated_bytes.current")
    if before is None:
        pytest.skip("this torch's host_memory_stats has no allocated_bytes.current")
    tk.reset_launch_counts()
    for i in range(30):
        engine.train_step(batch)
        if i % 5 == 4:
            torch.cuda.synchronize()
    step_bytes = TRACER.counters["h2d_async_bytes"] / 30
    grown = stats()["allocated_bytes.current"] - before
    assert TRACER.counters["host_syncs"] == 0
    assert grown <= 15 * step_bytes, (grown, step_bytes)


@pytest.mark.cuda
def test_device_const_shares_one_entry_for_cuda_and_its_index_on_card(cuda):
    index = torch.cuda.current_device()
    a = tlog.device_const(0.375, "cuda")
    assert a.device == torch.device("cuda", index)
    assert tlog.device_const(0.375, f"cuda:{index}") is a

