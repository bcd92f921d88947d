"""The VO experts replayed from CUDA graphs keyed by their row count
(``vo/ensemble.py::ExpertGraphs``, ``VOEnsemble._own_experts``).

On the CPU: the rule that keeps a call eager, one case per condition, and
its count under ``vo_graph_eager``; the experts' rows as one array with
each expert's span in it (an empty expert, STOP and ids past the right
turn clipped); ``step`` bit-equal to the own-expert loop as it ran before
the graphs, one blocking upload per expert; a copy or a pickle of the
ensemble starts with no graphs.  The benchmark's reader of the counters.

On the card (``-m cuda``; skipped where there is none): replays bit-equal
to that loop for det in float32, bf16 and an int8 cache, and rnd's mean
and std, at B=32 over changing counts and at B=1; the graphs replayed in a
scrambled order of experts and counts; weights loaded in place read by the
next replay; a capture only on a key's first sighting; no host sync in a
warmed step; an outer capture and a dtype change.

No JAX here: the card's machine runs ``pytest -m cuda --noconftest`` on
this file.
"""

import copy
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils.logging import TRACER, Timing
from pointnav_vo_tpu_torch.vo import ensemble as tens
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOEnsemble,
    VOInferenceConfig,
    dequantize_rows,
    expert_rows,
    frame_features_packed,
    pass_mean_std,
)

H, W = 32, 48
COUNTERS = ("vo_graph_eager", "vo_graph_captures", "vo_graph_replays")


@pytest.fixture(autouse=True)
def _clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


def _counts():
    return tuple(TRACER.counters.get(k, 0) for k in COUNTERS)


def _ensemble(device="cpu", mode="det", precision="fp32", cache="native", size=(H, W),
              seed=0):
    cfg = VOInferenceConfig(vis_size_h=size[0], vis_size_w=size[1], hidden_size=32,
                            mode=mode, rnd_mode_n=3, precision=precision, cache_dtype=cache)
    g = torch.Generator().manual_seed(seed)
    return VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                      device=device)


def _frames(vo, b, seed):
    rng = np.random.default_rng(seed)
    h, w = vo.cfg.vis_size_h, vo.cfg.vis_size_w

    def t(a):
        return torch.from_numpy(a).to(vo.device)

    return (t(rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)),
            t(rng.uniform(0.1, 10, (b, h, w, 1)).astype(np.float32)))


def _parent_loop(vo, pairs, actions, masks=None):
    """The own-expert loop as it ran before the graphs: per expert with
    rows, a blocking upload of its indices, ``index_select``, dequantize,
    the expert (rnd: the encoder, then the trunk with the rows' masks) and
    ``index_copy_``; rnd's mean and std over the passes."""
    passes = () if masks is None else (vo.cfg.rnd_mode_n,)
    out = torch.zeros(passes + (pairs.shape[0], 3), dtype=torch.float32, device=pairs.device)
    for expert, rows in zip(vo.experts, expert_rows(actions)):
        if rows.size == 0:
            continue
        idx = torch.as_tensor(rows).to(pairs.device)
        sub = dequantize_rows(pairs.index_select(0, idx), vo.cfg)
        if masks is None:
            y = expert(sub)
        else:
            feats = expert.visual_encoder(sub).flatten(1)
            y = expert.trunk(feats, (masks[0].index_select(1, idx),
                                     masks[1].index_select(1, idx)))
        out.index_copy_(len(passes), idx, y.float())
    return (out, torch.zeros_like(out)) if masks is None else pass_mean_std(out)


def _check_steps(vo, mixes, seed=0):
    """``vo.step`` over consecutive frames with each of ``mixes``' actions,
    each step's delta and std bit-equal to :func:`_parent_loop` on the same
    pairs (rnd: the same masks)."""
    b = len(mixes[0])
    prev = frame_features_packed(*_frames(vo, b, seed), vo.cfg)
    gen = torch.Generator(device=vo.device).manual_seed(seed)
    for k, actions in enumerate(mixes):
        rgb, depth = _frames(vo, b, seed + 1 + k)
        masks = vo.draw_masks(gen, b) if vo.cfg.mode == "rnd" else None
        with torch.no_grad():
            delta, std, cur = vo.step(prev, rgb, depth, np.asarray(actions), masks=masks)
            want = _parent_loop(vo, torch.cat([prev, cur], -1), actions, masks)
        assert torch.equal(delta, want[0]) and torch.equal(std, want[1]), (k, actions)
        prev = cur


# ------------------------------------------------------------ the rows (CPU)


@pytest.mark.parametrize("actions, spans", [
    ([1, 2, 3, 1], [(0, 2), (2, 3), (3, 4)]),
    ([0, 2, 2, 0, 1, 2], [(0, 3), (3, 6), (6, 6)]),  # STOP runs forward; right has none
    ([2, 2, 2], [(0, 0), (0, 3), (3, 3)]),
    ([3, 5, -1, 1], [(0, 2), (2, 2), (2, 4)]),  # ids outside 1..3 clip to the nearest
    ([], [(0, 0)] * 3)])
def test_the_rows_go_up_as_one_array_with_each_experts_span(actions, spans):
    rows, got = tens.packed_rows(np.asarray(actions, np.int32))
    assert got == spans and rows.dtype == np.int64
    for (start, stop), want in zip(got, expert_rows(np.asarray(actions))):
        np.testing.assert_array_equal(rows[start:stop], want)


# ------------------------------------------------------------ the rule (CPU)


@pytest.mark.parametrize("case, want", [
    ("cpu", "device"), ("grad", "grad"), ("expert_hook", "hook"),
    ("expert_pre_hook", "hook"), ("global_hook", "hook"), ("capturing", "capturing")])
def test_each_condition_chooses_eager(case, want, monkeypatch):
    """One case per condition; ``capturing`` on a stand-in for a card's
    pairs, as the CPU has no stream to capture."""
    vo = _ensemble()
    pairs = torch.zeros((2, H, W, vo.experts[0].visual_encoder.input_channels))
    block = vo.experts[2].visual_encoder.backbone.layer1[0]
    handle = {
        "expert_hook": lambda: block.register_forward_hook(lambda *a: None),
        "expert_pre_hook": lambda: block.register_forward_pre_hook(lambda *a: None),
        "global_hook": lambda: torch.nn.modules.module.register_module_forward_hook(
            lambda *a: None),
    }.get(case, lambda: None)()
    if case == "capturing":
        pairs = SimpleNamespace(device=torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    try:
        with torch.set_grad_enabled(case == "grad"):
            got = vo._graphs.eager_reason(vo.experts, pairs, vo.cfg)
    finally:
        if handle is not None:
            handle.remove()
    assert got == want
    assert not vo._graphs.graphs and vo._graphs.staging is None


@pytest.mark.parametrize("case", ["cpu", "grad", "expert_hook"])
def test_each_eager_expert_call_is_counted(case):
    """The loop itself (the public methods hold gradients off), each call
    of an expert with rows counted once under ``vo_graph_eager``; the rows
    go up in one upload, without a host sync."""
    vo = _ensemble()
    fired = []
    handle = (vo.experts[0].visual_encoder.register_forward_hook(lambda *a: fired.append(1))
              if case == "expert_hook" else None)
    pairs = torch.cat([frame_features_packed(*_frames(vo, 4, s), vo.cfg) for s in (0, 1)], -1)
    syncs = TRACER.counters.get("host_syncs", 0)  # the features' constants, met first
    with torch.set_grad_enabled(case == "grad"):
        for actions in ([1, 2, 3, 0], [2, 2, 2, 2]):
            got = vo._own_experts(pairs, np.asarray(actions), "det")
            with torch.no_grad():
                assert torch.equal(got, _parent_loop(vo, pairs, actions)[0])
    if handle is not None:
        handle.remove()
    assert _counts() == (4, 0, 0)  # 3 experts with rows, then 1
    assert fired == ([1, 1] if case == "expert_hook" else [])
    assert TRACER.counters.get("host_syncs", 0) == syncs and TRACER.counters["h2d_async"] == 2
    assert got.requires_grad == (case == "grad")


# ------------------------------------------------ the parent's loop (CPU)


MIXES = [[1, 2, 3, 1, 0, 3], [1] * 6, [0, 2, 2, 0, 1, 2], [3, 3, 2, 3, 3, 3]]


@pytest.mark.parametrize("mode, precision, cache", [
    ("det", "fp32", "native"), ("det", "fp32", "int8"), ("det", "bf16", "native"),
    ("rnd", "fp32", "native"), ("rnd", "bf16", "int8")])
def test_cpu_step_is_bit_equal_to_the_parents_loop(mode, precision, cache):
    _check_steps(_ensemble(mode=mode, precision=precision, cache=cache), MIXES)
    assert _counts() == (sum(len(set(np.clip(m, 1, 3))) for m in MIXES), 0, 0)


def test_a_copy_or_a_pickle_of_the_ensemble_starts_with_no_graphs():
    vo = _ensemble()
    vo._graphs.graphs["key"] = object()
    vo._graphs.key = ("weights",)
    for other in (copy.deepcopy(vo), pickle.loads(pickle.dumps(vo))):
        assert isinstance(other._graphs, tens.ExpertGraphs)
        assert not other._graphs.graphs and other._graphs.key is None
    assert "key" in vo._graphs.graphs


# --------------------------------------------------- the reader (CPU)


def _ctx():
    return SimpleNamespace(traffic={"entry": "eval_step"}, trace_summary=None)


@pytest.mark.parametrize("counts, want", [
    ({}, None), ({"policy_graph_replays": 1}, None),
    ({"vo_graph_replays": 3, "vo_graph_eager": 0}, 100.0),
    ({"vo_graph_replays": 3, "vo_graph_eager": 1}, 75.0),
    ({"vo_graph_eager": 2, "vo_graph_captures": 2}, 0.0),
    ({"vo_graph_replays": 0, "vo_graph_eager": 0}, None)])
def test_the_hit_share_reader(monkeypatch, counts, want):
    monkeypatch.setattr(tlog, "TRACER", Timing(profiled=Timing()))
    for _ in range(4):
        with tlog.TRACER.span("eval_step"):
            for name, n in counts.items():
                tlog.TRACER.count(name, n)
    assert harness._load_reader("vo_graph_hit_pct.eval")(_ctx()) == want


def test_the_hit_share_reader_without_the_tracer(monkeypatch):
    monkeypatch.delattr(tlog, "TRACER")
    assert harness._load_reader("vo_graph_hit_pct.eval")(_ctx()) is None


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


CARD = (64, 96)


def _mixes(b, steps, seed):
    """``steps`` action mixes of ``b`` envs (STOP, forward, left, right at
    about eval32's 5 / 59 / 17 / 19 %), the first steps' repeated."""
    rng = np.random.default_rng(seed)
    mixes = [rng.choice(4, size=b, p=[0.05, 0.59, 0.17, 0.19]).tolist() for _ in range(steps)]
    return mixes + mixes[:3]


def _keys(mixes):
    return {(e, len(r)) for m in mixes for e, r in enumerate(expert_rows(np.asarray(m)))
            if len(r)}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 1])
@pytest.mark.parametrize("mode, precision, cache", [
    ("det", "fp32", "native"), ("det", "bf16", "native"), ("det", "fp32", "int8"),
    ("det", "bf16", "int8"), ("rnd", "fp32", "native")])
def test_replay_is_bit_equal_to_the_parents_loop(cuda, b, mode, precision, cache):
    vo = _ensemble(cuda, mode, precision, cache, CARD)
    mixes = _mixes(b, 6, seed=b)
    _check_steps(vo, mixes)
    calls = sum(len(_keys([m])) for m in mixes)
    captures = len(_keys(mixes))
    assert _counts() == (0, captures, calls - captures)
    assert len(vo._graphs.graphs) == captures


@pytest.mark.cuda
def test_graphs_replay_in_a_scrambled_order(cuda):
    vo = _ensemble(cuda, size=CARD)
    mixes = _mixes(32, 5, seed=7)
    _check_steps(vo, mixes)
    captured = _counts()[1]
    order = np.random.default_rng(3).permutation(len(mixes))
    _check_steps(vo, [mixes[i][::-1] for i in order], seed=20)  # experts' rows reversed
    assert _counts()[1] == captured  # every key met before: replays only


@pytest.mark.cuda
def test_replay_reads_new_weights_loaded_in_place(cuda):
    vo = _ensemble(cuda, size=CARD)
    mix = [[1, 2, 3, 1] * 8]
    _check_steps(vo, mix * 2)
    other = _ensemble(cuda, size=CARD, seed=9)
    for m, o in zip(vo.experts, other.experts):
        m.load_state_dict(o.state_dict())
    _check_steps(vo, mix, seed=5)
    assert _counts() == (0, 3, 6)


@pytest.mark.cuda
def test_a_new_dtype_drops_the_graphs(cuda):
    vo = _ensemble(cuda, size=CARD)
    mix = [[1, 2, 3, 1] * 8]
    _check_steps(vo, mix * 2)
    for m in vo.experts:
        m.to(torch.float64)
    pairs = torch.rand((32, CARD[0], CARD[1], vo.experts[0].visual_encoder.input_channels),
                       device=cuda, dtype=torch.float64)
    with torch.no_grad():
        got = vo.predict_packed(pairs, np.asarray(mix[0]))
        assert torch.equal(got, _parent_loop(vo, pairs, mix[0])[0])
    assert _counts() == (0, 6, 3) and len(vo._graphs.graphs) == 3


@pytest.mark.cuda
def test_a_warmed_step_makes_no_host_sync(cuda):
    vo = _ensemble(cuda, size=CARD)
    mix = np.asarray([1, 2, 3, 0] * 8)
    prev = frame_features_packed(*_frames(vo, 32, 0), vo.cfg)
    rgb, depth = _frames(vo, 32, 1)
    with torch.no_grad():
        vo.step(prev, rgb, depth, mix)  # captures, the constants' first uploads
        torch.cuda.synchronize()
        before = TRACER.counters.get("host_syncs", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                vo.step(prev, rgb, depth, mix)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert TRACER.counters.get("host_syncs", 0) == before
    assert _counts() == (0, 3, 9)


@pytest.mark.cuda
def test_inside_an_outer_capture_the_experts_run_eagerly(cuda):
    vo = _ensemble(cuda, size=CARD)
    pairs = torch.rand((8, CARD[0], CARD[1], vo.experts[0].visual_encoder.input_channels),
                       device=cuda)
    idx = torch.arange(8, device=cuda)
    with torch.no_grad():
        vo.predict_packed(pairs, np.ones(8))  # warm: the expert's own capture
        want = vo.experts[0](pairs)
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            assert vo._graphs.eager_reason(vo.experts, pairs, vo.cfg) == "capturing"
            y = vo.experts[0](tens.select_rows(pairs, idx, vo.cfg))
        outer.replay()
        torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert _counts() == (0, 1, 0)
