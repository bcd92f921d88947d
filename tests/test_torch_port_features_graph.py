"""The VO frame features' chain replayed from a CUDA graph
(``vo/ensemble.py::frame_features_packed``, its cache ``_FEATURES_GRAPHS``).

On the CPU: the rule that keeps a call eager, one case per reason, and
grad mode let through; the key, one case per field that must give a new
one; the count of eager calls; ``frame_features_packed`` and the two
packed pair functions bit-equal to the chain as it ran before the graphs;
the benchmark's reader of the counters.

On the card (``-m cuda``; skipped where there is none): replays bit-equal
to that chain in float32, bf16, an int8 cache and with
``obs_transform="resize"``, at B=1, 2, 32 and 64, each result unchanged by
the calls after it; two calls of one key in a row (the twin pairs) leave
the first result as it was; one ``bin_counts`` launch a call; no host sync
in a warmed call; a capture only on a key's second sighting, with
gradients on; an outer capture keeps the call eager.

No JAX here: the card's machine runs ``pytest -m cuda --noconftest`` on
this file.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from pointnav_vo_tpu_torch.models.feature_graphs import FeatureGraphs
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils.logging import TRACER, Timing
from pointnav_vo_tpu_torch.vo import ensemble as tens
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOInferenceConfig,
    features_eager_reason,
    features_key,
    frame_features,
    frame_features_packed,
    preprocess_obs_pairs_packed,
    preprocess_obs_pairs_twins_packed,
)

H, W = 32, 48
COUNTERS = ("features_graph_eager", "features_graph_captures", "features_graph_replays")


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    """An empty graph cache and a clean tracer for each test."""
    monkeypatch.setattr(tens, "_FEATURES_GRAPHS", FeatureGraphs())
    TRACER.reset()
    yield
    TRACER.reset()


def _counts():
    return tuple(TRACER.counters.get(k, 0) for k in COUNTERS)


def _cfg(precision="fp32", cache="native", transform="none", size=(H, W), **kw):
    return VOInferenceConfig(vis_size_h=size[0], vis_size_w=size[1], precision=precision,
                             cache_dtype=cache, obs_transform=transform, **kw)


def _frames(b, seed, size=(H, W), device="cpu"):
    """rgb uint8 and depth float32, habitat's dtypes; every depth is
    nonzero but a border band, so the crop and the band both move."""
    rng = np.random.default_rng(seed)
    h, w = size
    depth = rng.uniform(0.0, 1.0, (b, h, w, 1)).astype(np.float32)
    depth[:, : h // 8] = 0.0
    depth[:, :, -(w // 10):] = 0.0
    return (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(device),
            torch.from_numpy(depth).to(device))


def _parent_pack(rgb, depth, cfg):
    """``frame_features_packed`` as it ran before the graphs: every feature,
    rgb over a 255 on its device, one ``cat`` (int8: quantised)."""
    feats = frame_features(rgb, depth, cfg)
    parts = []
    for k in ("rgb", "depth", "discretized_depth", "top_down_view"):
        if k in feats:
            v = feats[k].to(cfg.dtype)
            if k == "rgb":
                v = v / torch.tensor(255.0, dtype=v.dtype, device=v.device)
            parts.append(v)
    pack = torch.cat(parts, -1)
    if cfg.cache_dtype == "int8":
        pack = torch.clamp(torch.round(pack.float() * 127.0), 0, 127).to(torch.int8)
    return pack


def _parent_pairs(prev, cur, cfg, twins):
    fp, fc = _parent_pack(*prev, cfg), _parent_pack(*cur, cfg)
    if not twins:
        return torch.cat([fp, fc], -1)
    both = torch.stack([torch.cat([fp, fc], -1), torch.cat([fc, fp], -1)], 1)
    return both.reshape((-1,) + tuple(fp.shape[1:-1]) + (2 * fp.shape[-1],))


# ------------------------------------------------------------ the rule (CPU)


def _stand_in(shape=(2, H, W, 1), dtype=torch.float32, device=("cuda", 0), grad=False):
    """A card tensor's face: the rule and the key read no data."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype, device=torch.device(*device),
                           requires_grad=grad)


@pytest.mark.parametrize("case, want", [
    ("cpu", "device"), ("two_cards", "device"), ("rgb_requires_grad", "grad"),
    ("depth_requires_grad", "grad"), ("capturing", "capturing"), ("grad_mode", None)])
def test_each_reason_keeps_the_call_eager_and_grad_mode_is_none(case, want, monkeypatch):
    """One case per reason; grad mode on, with no input that requires
    grad, lets the call through (the chain has no parameters)."""
    rgb, depth = _stand_in((2, H, W, 3), torch.uint8), _stand_in()
    if case == "cpu":
        rgb, depth = _frames(2, 0)
    elif case == "two_cards":
        depth = _stand_in(device=("cuda", 1))
    elif case == "rgb_requires_grad":
        rgb = _stand_in((2, H, W, 3), grad=True)
    elif case == "depth_requires_grad":
        depth = _stand_in(grad=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    with torch.enable_grad():
        assert features_eager_reason(rgb, depth) == want


# ------------------------------------------------------------- the key (CPU)


def _key_of(change):
    """The key of a B=2 call at (H, W) with one input, the config or the
    mode changed by ``change``."""
    rgb, depth, cfg = _stand_in((2, H, W, 3), torch.uint8), _stand_in(), _cfg()
    if change == "batch":
        rgb, depth = _stand_in((4, H, W, 3), torch.uint8), _stand_in((4, H, W, 1))
    elif change == "frame_size":
        rgb, depth = _stand_in((2, 40, 60, 3), torch.uint8), _stand_in((2, 40, 60, 1))
    elif change == "rgb_dtype":
        rgb = _stand_in((2, H, W, 3), torch.float32)
    elif change == "depth_dtype":
        depth = _stand_in(dtype=torch.float16)
    elif change == "card":
        rgb, depth = (_stand_in((2, H, W, 3), torch.uint8, ("cuda", 1)),
                      _stand_in(device=("cuda", 1)))
    elif change in ("bf16", "int8", "resize", "obs_space", "dd_channels", "max_depth"):
        cfg = {"bf16": lambda: _cfg("bf16"), "int8": lambda: _cfg(cache="int8"),
               "resize": lambda: _cfg(transform="resize"),
               "obs_space": lambda: _cfg(observation_space=("rgb", "depth")),
               "dd_channels": lambda: _cfg(discretized_depth_channels=8),
               "max_depth": lambda: _cfg(max_depth=5.0)}[change]()
    if change == "inference":
        with torch.inference_mode():
            return features_key(rgb, depth, cfg)
    return features_key(rgb, depth, cfg)


@pytest.mark.parametrize("change", [
    "batch", "frame_size", "rgb_dtype", "depth_dtype", "card", "bf16", "int8", "resize",
    "obs_space", "dd_channels", "max_depth", "inference"])
def test_each_field_of_the_key_gives_a_new_key(change):
    assert _key_of(change) != _key_of(None)


def test_the_same_call_gives_the_same_key_in_either_grad_mode():
    with torch.enable_grad():
        on = _key_of(None)
    with torch.no_grad():
        assert _key_of(None) == on and hash(on) == hash(_key_of(None))


# ------------------------------------------- the parent's chain (CPU)


CPU_CASES = [("fp32", "native", "none"), ("bf16", "native", "none"),
             ("fp32", "int8", "none"), ("bf16", "int8", "none"), ("fp32", "native", "resize")]


def _sizes(transform, size):
    """The frames' size: a 1.25x larger render where the config resizes."""
    return size if transform == "none" else (size[0] * 5 // 4, size[1] * 5 // 4)


@pytest.mark.parametrize("precision, cache, transform", CPU_CASES)
def test_cpu_features_are_bit_equal_to_the_parents_chain(precision, cache, transform):
    cfg = _cfg(precision, cache, transform)
    prev, cur = (_frames(3, s, _sizes(transform, (H, W))) for s in (1, 2))
    got = frame_features_packed(*prev, cfg)
    assert got.dtype == (torch.int8 if cache == "int8" else cfg.dtype)
    assert torch.equal(got, _parent_pack(*prev, cfg))
    assert torch.equal(preprocess_obs_pairs_packed(*prev, *cur, cfg),
                       _parent_pairs(prev, cur, cfg, twins=False))
    assert torch.equal(preprocess_obs_pairs_twins_packed(*prev, *cur, cfg),
                       _parent_pairs(prev, cur, cfg, twins=True))
    assert _counts() == (5, 0, 0)  # every call on the CPU eager, each counted once
    assert not tens._FEATURES_GRAPHS.graphs and not tens._FEATURES_GRAPHS.seen


def test_cpu_features_without_rgb_or_top_down_are_bit_equal():
    cfg = _cfg(observation_space=("depth", "discretized_depth"))
    frames = _frames(2, 3)
    got = frame_features_packed(*frames, cfg)
    assert got.shape[-1] == 1 + cfg.discretized_depth_channels
    assert torch.equal(got, _parent_pack(*frames, cfg))
    assert got.data_ptr() != frames[1].data_ptr()  # a new tensor, not the caller's depth


@pytest.mark.parametrize("grad", [False, True])
def test_each_eager_call_is_counted_once_in_either_grad_mode(grad):
    cfg = _cfg()
    with torch.set_grad_enabled(grad):
        for s in range(3):
            out = frame_features_packed(*_frames(2, s), cfg)
    assert _counts() == (3, 0, 0) and not out.requires_grad
    assert TRACER.aggs["features"][0] == 3


# --------------------------------------------------- the reader (CPU)


@pytest.mark.parametrize("entry, top", [("eval_step", "eval_step"), ("vo_train", "vo_train.step")])
@pytest.mark.parametrize("counts, want", [
    ({}, None), ({"vo_graph_replays": 4}, None),
    ({"features_graph_replays": 2, "features_graph_eager": 0}, 100.0),
    ({"features_graph_replays": 3, "features_graph_eager": 1}, 75.0),
    ({"features_graph_eager": 2, "features_graph_captures": 1}, 0.0),
    ({"features_graph_replays": 0, "features_graph_eager": 0}, None)])
def test_the_hit_share_reader(monkeypatch, entry, top, counts, want):
    monkeypatch.setattr(tlog, "TRACER", Timing(profiled=Timing()))
    for _ in range(4):
        with tlog.TRACER.span(top):
            for name, n in counts.items():
                tlog.TRACER.count(name, n)
    ctx = SimpleNamespace(traffic={"entry": entry}, trace_summary=None)
    suffix = "eval" if entry == "eval_step" else "vo_train"
    assert harness._load_reader(f"features_graph_hit_pct.{suffix}")(ctx) == want


def test_the_hit_share_reader_without_the_tracer(monkeypatch):
    monkeypatch.delattr(tlog, "TRACER")
    ctx = SimpleNamespace(traffic={"entry": "eval_step"}, trace_summary=None)
    assert harness._load_reader("features_graph_hit_pct.eval")(ctx) is None


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


CARD = (64, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 32, 64])
@pytest.mark.parametrize("precision, cache, transform", [
    ("fp32", "native", "none"), ("bf16", "native", "none"), ("fp32", "int8", "none"),
    ("fp32", "native", "resize")])
def test_replays_are_bit_equal_to_the_parents_chain(cuda, b, precision, cache, transform):
    cfg = _cfg(precision, cache, transform, CARD)
    frames = [_frames(b, 10 * b + s, _sizes(transform, CARD), cuda) for s in range(5)]
    got = []
    for f in frames:
        got.append(frame_features_packed(*f, cfg))
        assert torch.equal(got[-1], _parent_pack(*f, cfg))
    assert _counts() == (1, 1, 3)
    for f, g in zip(frames, got):  # no later replay wrote into an earlier result
        assert torch.equal(g, _parent_pack(*f, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["native", "int8"])
def test_two_calls_of_one_key_in_a_row_leave_the_first_result(cuda, cache):
    cfg = _cfg(cache=cache, size=CARD)
    prev, cur = (_frames(32, s, CARD, cuda) for s in (1, 2))
    for _ in range(2):  # the key's eager call and its capture
        frame_features_packed(*prev, cfg)
    first = frame_features_packed(*prev, cfg)
    second = frame_features_packed(*cur, cfg)
    assert torch.equal(first, _parent_pack(*prev, cfg))
    assert torch.equal(second, _parent_pack(*cur, cfg))
    for twins in (False, True):
        fn = preprocess_obs_pairs_twins_packed if twins else preprocess_obs_pairs_packed
        assert torch.equal(fn(*prev, *cur, cfg), _parent_pairs(prev, cur, cfg, twins))
    assert _counts() == (1, 1, 6)


@pytest.mark.cuda
def test_each_call_launches_bin_counts_once(cuda):
    cfg = _cfg(size=CARD)
    rgb, depth = _frames(32, 0, CARD, cuda)
    for k in range(5):
        before = TRACER.counters.get("bin_counts", 0)
        frame_features_packed(rgb, depth, cfg)
        assert TRACER.counters["bin_counts"] == before + 1, k
    assert _counts() == (1, 1, 3)


@pytest.mark.cuda
def test_a_warmed_call_makes_no_host_sync(cuda):
    cfg = _cfg(size=CARD)
    rgb, depth = _frames(32, 0, CARD, cuda)
    for _ in range(2):  # eager (the constants' first uploads), then the capture
        frame_features_packed(rgb, depth, cfg)
    torch.cuda.synchronize()
    before = TRACER.counters.get("host_syncs", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = frame_features_packed(rgb, depth, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TRACER.counters.get("host_syncs", 0) == before
    assert _counts() == (1, 1, 3)
    assert torch.equal(out, _parent_pack(rgb, depth, cfg))


@pytest.mark.cuda
def test_a_capture_only_on_the_second_sighting_with_gradients_on(cuda):
    cfg = _cfg(size=CARD)
    cache = tens._FEATURES_GRAPHS
    frames = _frames(8, 0, CARD, cuda)
    want = [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2)]
    with torch.enable_grad():
        for k, counts in enumerate(want):
            out = frame_features_packed(*frames, cfg)
            assert _counts() == counts and len(cache.graphs) == min(k, 1)
            assert not out.requires_grad
    other = _frames(4, 1, CARD, cuda)  # another batch: another key, met afresh
    frame_features_packed(*other, cfg)
    assert _counts() == (2, 1, 2) and len(cache.graphs) == 1


@pytest.mark.cuda
def test_inside_an_outer_capture_the_call_runs_eagerly(cuda):
    cfg = _cfg(size=CARD)
    rgb, depth = _frames(8, 0, CARD, cuda)
    for _ in range(2):  # warm: the key's own capture
        frame_features_packed(rgb, depth, cfg)
    want = _parent_pack(rgb, depth, cfg)
    torch.cuda.synchronize()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        assert features_eager_reason(rgb, depth) == "capturing"
        y = frame_features_packed(rgb, depth, cfg)
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert _counts() == (2, 1, 0)
