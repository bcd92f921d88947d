"""The policy's visual encoder replayed from a CUDA graph
(``models/feature_graphs.py``, ``models/policy.py::_ActorCritic._encode``).

On the CPU: the rule that picks the eager path, one case per condition;
the second-sighting rule and the bounded key cache; the module tree kept
between calls and rebuilt where a module or a weight is replaced; the
counters (a CPU call counts as eager, the graph counters stay 0); and
``forward`` bit-equal to its eager parts.  The benchmark's reader of the
counters gives nothing without them.

On the card (``-m cuda``; skipped where there is none): the replay
against the eager parts, bit for bit, over consecutive steps with
changing inputs, for ResNet18 and SE-ResNeXt101 (64x96, B=4); new weights
loaded in place; ``.to(float64)`` and back; a forward hook; the SE gate
counter; an outer stream capture.

No JAX here: the card's machine runs ``pytest -m cuda --noconftest`` on
this file.
"""

import copy
import pickle
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models import feature_graphs as fg
from pointnav_vo_tpu_torch.models.policy import (
    GOAL_KEY,
    PointNavActorCritic,
    PointNavBaselineActorCritic,
)
from pointnav_vo_tpu_torch.utils import logging as tlog
from pointnav_vo_tpu_torch.utils.logging import TRACER, Timing

H, W, N = 48, 64, 3
COUNTERS = ("policy_graph_eager", "policy_graph_captures", "policy_graph_replays")
SE_GATES = 33


@pytest.fixture(autouse=True)
def _clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


def _policy(kind="depth", seed=1, device="cpu", **kw):
    """A seeded policy; its frames' size as ``image_size``."""
    if kind == "baseline":
        size = (64, 64)  # the VALID convs need 36 pixels
        net = PointNavBaselineActorCritic(image_size=size, hidden_size=32)
    else:
        vis = {"depth": ("depth",), "rgbd": ("rgb", "depth")}[kind]
        size = kw.setdefault("image_size", (H, W))
        kw.setdefault("hidden_size", 32)
        kw.setdefault("baseplanes", 8)
        net = PointNavActorCritic(vis_types=vis, normalize_visual_inputs=kind == "rgbd", **kw)
    net = seeded_init_(net, torch.Generator().manual_seed(seed)).eval().to(device)
    net.image_size = size
    return net


def _inputs(policy, n=N, seed=0, device="cpu", t=None):
    """Observations, hidden, previous actions and masks for one step (or a
    ``t``-step sequence) of ``n`` envs; some masks 0."""
    g = torch.Generator().manual_seed(seed)
    lead = (n,) if t is None else (t, n)
    h, w = policy.image_size
    obs = {"depth": torch.rand(lead + (h, w, 1), generator=g),
           "rgb": torch.randint(0, 256, lead + (h, w, 3), generator=g, dtype=torch.uint8),
           GOAL_KEY: torch.rand(lead + (2,), generator=g) * 4}
    obs = {k: obs[k].to(device) for k in policy.observation_keys}
    hidden = torch.rand((policy.num_packed_hidden, n, policy.hidden_size),
                        generator=g).to(device)
    prev = torch.randint(0, 4, lead + (1,), generator=g).to(device)
    masks = (torch.rand(lead + (1,), generator=g) > 0.3).float().to(device)
    return obs, hidden, prev, masks


def _eager_forward(policy, obs, hidden, prev, masks, update_stats=False):
    """``_ActorCritic.forward`` as it was before the graphs: ``_features``
    always run eagerly, then the state encoder and the heads."""
    seq = prev.dim() == 3
    if seq:
        t, n = prev.shape[:2]
        obs = {k: obs[k].reshape((t * n,) + obs[k].shape[2:]) for k in policy.observation_keys}
        prev, masks = prev.reshape(t * n, 1), masks.reshape(t * n, 1)
    x = policy._features(obs, prev, masks, update_stats)
    dtype = x.dtype
    enc = policy.net.state_encoder
    rnn_dtype = enc.rnn.weight_ih_l0.dtype
    x, hidden, masks = x.to(rnn_dtype), hidden.to(rnn_dtype), masks.to(rnn_dtype)
    if seq:
        x, hidden = enc(x.reshape(t, n, -1), hidden, masks.reshape(t, n, 1))
        x = x.reshape(t * n, -1)
    else:
        x, hidden = enc(x, hidden, masks)
    x = x.to(dtype)
    out = torch.promote_types(dtype, torch.float32)
    return policy.action_distribution.linear(x).to(out), policy.critic.fc(x).to(out), hidden


def _reason(policy, obs, prev, masks, update_stats=False):
    inputs = [obs[k] for k in policy.observation_keys] + [prev, masks]
    tree = policy._graphs.tree(policy.feature_roots())
    return fg.eager_reason(tree, inputs, prev.dim() == 3, update_stats)


def _counts():
    return tuple(TRACER.counters.get(k, 0) for k in COUNTERS)


# ------------------------------------------------------------ the rule (CPU)


@pytest.mark.parametrize("case, want", [
    ("grad", "grad"), ("update_stats", "update_stats"), ("sequence", "sequence"),
    ("backbone_hook", "hook"), ("backbone_pre_hook", "hook"), ("global_hook", "hook"),
    ("cpu", "device"), ("head_hook", "device")])
def test_each_condition_chooses_eager(case, want):
    """One case per condition; the CPU input fails last, so each other case
    shows its own reason, and a hook outside ``_features`` (the head's, as
    the benchmark's) is no reason."""
    policy = _policy("rgbd")
    obs, _hidden, prev, masks = _inputs(policy, t=2 if case == "sequence" else None)
    block = policy.net.visual_encoder.backbone.layer1[0]
    handle = {
        "backbone_hook": lambda: block.register_forward_hook(lambda *a: None),
        "backbone_pre_hook": lambda: block.register_forward_pre_hook(lambda *a: None),
        "global_hook": lambda: torch.nn.modules.module.register_module_forward_hook(
            lambda *a: None),
        "head_hook": lambda: policy.action_distribution.linear.register_forward_hook(
            lambda *a: None),
    }.get(case, lambda: None)()
    try:
        with torch.set_grad_enabled(case == "grad"):
            got = _reason(policy, obs, prev, masks, update_stats=case == "update_stats")
    finally:
        if handle is not None:
            handle.remove()
    assert got == want


def test_a_cpu_call_counts_as_eager_and_never_as_a_graph():
    policy = _policy("depth")
    obs, hidden, prev, masks = _inputs(policy)
    with torch.no_grad():
        for _ in range(3):
            policy(obs, hidden, prev, masks)
        policy(*_inputs(policy, t=2))  # the sequence form: not a single-step call
    with torch.enable_grad():
        policy(obs, hidden, prev, masks)
    assert _counts() == (4, 0, 0)
    assert not policy._graphs.graphs and not policy._graphs.seen


@pytest.mark.parametrize("kind, t, update_stats", [
    ("depth", None, False), ("depth", 3, False), ("rgbd", None, False), ("rgbd", None, True),
    ("rgbd", 2, True), ("baseline", None, False), ("baseline", 2, False)])
def test_cpu_forward_is_bit_equal_to_the_eager_parts(kind, t, update_stats):
    policy = _policy(kind)
    ref = copy.deepcopy(policy)
    args = _inputs(policy, t=t, seed=5)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = policy(*args, update_stats=update_stats)
            want = _eager_forward(ref, *args, update_stats=update_stats)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for a, b in zip(policy.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)  # the whitening folded the same frames in


# ------------------------------------------------- the cache's rules (CPU)


def test_a_key_runs_eagerly_then_captures_then_replays():
    graphs = fg.FeatureGraphs()
    assert [graphs.sight("a"), graphs.sight("b")] == [("eager", None)] * 2
    assert graphs.sight("a") == ("capture", None)
    graphs.keep("a", "graph a")
    assert [graphs.sight("a"), graphs.sight("a"), graphs.sight("b")] == \
        [("replay", "graph a"), ("replay", "graph a"), ("capture", None)]


def test_the_caches_keep_the_most_recently_used_keys():
    graphs = fg.FeatureGraphs()
    for k in range(fg.SLOTS):
        graphs.keep(k, f"graph {k}")
    assert graphs.sight(0)[0] == "replay"  # 0 is now the most recent, 1 the least
    graphs.keep(fg.SLOTS, "one more")
    assert list(graphs.graphs) == [2, 3, 0, fg.SLOTS]
    assert graphs.sight(1)[0] == "eager"  # dropped: met afresh
    for k in range(10, 10 + fg.SLOTS + 1):
        assert graphs.sight(k)[0] == "eager"
    assert len(graphs.seen) == fg.SLOTS and 1 not in graphs.seen and 10 not in graphs.seen
    assert graphs.sight(10 + fg.SLOTS)[0] == "capture"


def test_the_tree_is_kept_until_a_module_or_a_weight_is_replaced():
    policy = _policy("rgbd")
    graphs = policy._graphs
    tree = graphs.tree(policy.feature_roots())
    assert graphs.tree(policy.feature_roots()) is tree
    weights = tree.weights()
    policy.load_state_dict(_policy("rgbd", seed=2).state_dict())  # in place
    assert graphs.tree(policy.feature_roots()) is tree and tree.weights() == weights
    policy.to(torch.float64)  # parameters' data swapped, buffers replaced
    tree2 = graphs.tree(policy.feature_roots())
    assert tree2 is not tree and tree2.weights() != weights
    policy.net.visual_encoder.compression[2] = torch.nn.ReLU(True)
    tree3 = graphs.tree(policy.feature_roots())
    assert tree3 is not tree2 and tree3.weights() == tree2.weights()
    policy.net.tgt_embeding.bias = torch.nn.Parameter(policy.net.tgt_embeding.bias + 1)
    tree4 = graphs.tree(policy.feature_roots())
    assert tree4 is not tree3 and tree4.weights() != tree3.weights()
    policy.net.visual_encoder.compression[0].register_buffer("extra", torch.zeros(1))
    assert graphs.tree(policy.feature_roots()) is not tree4
    # the state encoder is not the encoder's: its weights are not in the key
    state = [p.data_ptr() for p in policy.net.state_encoder.parameters()]
    assert not set(state) & set(graphs.tree(policy.feature_roots()).weights())


def test_a_copy_or_a_pickle_of_the_policy_starts_with_no_graphs():
    policy = _policy("depth")
    policy._graphs.keep("key", object())
    policy._graphs.sight("other")
    for other in (copy.deepcopy(policy), pickle.loads(pickle.dumps(policy))):
        assert isinstance(other._graphs, fg.FeatureGraphs)
        assert not other._graphs.graphs and not other._graphs.seen
    assert "key" in policy._graphs.graphs


# --------------------------------------------------- the reader (CPU)


def _ctx():
    return SimpleNamespace(traffic={"entry": "eval_step"}, trace_summary=None)


def _window(counts, steps=4):
    for _ in range(steps):
        with tlog.TRACER.span("eval_step"):
            for name, n in counts.items():
                tlog.TRACER.count(name, n)


@pytest.mark.parametrize("counts, want", [
    ({}, None), ({"se_gates": 33}, None),
    ({"policy_graph_replays": 1, "policy_graph_eager": 0}, 100.0),
    ({"policy_graph_replays": 3, "policy_graph_eager": 1}, 75.0),
    ({"policy_graph_eager": 1}, 0.0),
    ({"policy_graph_replays": 0, "policy_graph_eager": 0}, None)])
def test_the_hit_share_reader(monkeypatch, counts, want):
    monkeypatch.setattr(tlog, "TRACER", Timing(profiled=Timing()))
    _window(counts)
    assert harness._load_reader("policy_graph_hit_pct.eval")(_ctx()) == want


def test_the_hit_share_reader_without_the_tracer(monkeypatch):
    monkeypatch.delattr(tlog, "TRACER")
    assert harness._load_reader("policy_graph_hit_pct.eval")(_ctx()) is None


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _card_policy(backbone, device, seed=1):
    if backbone == "se_resneXt101":
        return _policy("depth", seed, device, image_size=(64, 96), hidden_size=1024,
                       baseplanes=32, backbone=backbone)
    return _policy("depth", seed, device, image_size=(64, 96), hidden_size=512, baseplanes=32)


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["resnet18", "se_resneXt101"])
def test_replay_is_bit_equal_to_eager_over_changing_steps(cuda, backbone):
    policy = _card_policy(backbone, cuda)
    gates = SE_GATES if backbone == "se_resneXt101" else 0
    with torch.no_grad():
        for step in range(5):  # eager, capture, then three replays
            obs, hidden, prev, masks = _inputs(policy, 4, seed=10 + step, device=cuda)
            before = TRACER.counters.get("se_gates", 0)
            got = policy(obs, hidden, prev, masks)
            assert TRACER.counters.get("se_gates", 0) - before == gates
            want = _eager_forward(policy, obs, hidden, prev, masks)
            torch.cuda.synchronize()
            assert _equal(got, want), step
    assert _counts() == (1, 1, 3)
    assert len(policy._graphs.graphs) == 1


@pytest.mark.cuda
def test_replay_reads_new_weights_loaded_in_place(cuda):
    policy = _card_policy("resnet18", cuda)
    args = _inputs(policy, 4, seed=3, device=cuda)
    with torch.no_grad():
        for _ in range(3):
            policy(*args)
        policy.load_state_dict(_card_policy("resnet18", cuda, seed=9).state_dict())
        got = policy(*args)
        want = _eager_forward(policy, *args)
    assert _equal(got, want)
    assert _counts() == (1, 1, 2)


@pytest.mark.cuda
def test_a_dtype_round_trip_gives_a_new_key(cuda):
    policy = _card_policy("resnet18", cuda)
    args = _inputs(policy, 4, seed=4, device=cuda)
    with torch.no_grad():
        policy(*args)
        policy(*args)  # captured in float32
        policy.to(torch.float64)
        args64 = [{k: v.double() if v.is_floating_point() else v for k, v in args[0].items()},
                  args[1].double(), args[2], args[3].double()]
        got = policy(*args64)
        assert _counts() == (2, 1, 0)  # a new key: met once, eager
        assert _equal(got, _eager_forward(policy, *args64))
        policy.to(torch.float32)
        got = policy(*args)
        assert _equal(got, _eager_forward(policy, *args))
    # the float32 weights came back at their old addresses (a replay of the
    # old graph over the weights the module holds) or at new ones (met afresh)
    assert _counts() in ((2, 1, 1), (3, 1, 0))


@pytest.mark.cuda
def test_a_forward_hook_in_the_encoder_forces_eager_and_fires(cuda):
    policy = _card_policy("resnet18", cuda)
    args = _inputs(policy, 4, seed=5, device=cuda)
    fired = []
    with torch.no_grad():
        for _ in range(3):
            policy(*args)
        handle = policy.net.visual_encoder.backbone.layer2[0].register_forward_hook(
            lambda *a: fired.append(1))
        got = policy(*args)
        handle.remove()
        want = _eager_forward(policy, *args)
        policy(*args)
    assert fired == [1] and _equal(got, want)
    assert _counts() == (2, 1, 2)


@pytest.mark.cuda
def test_inside_an_outer_capture_the_encoder_runs_eagerly(cuda):
    policy = _card_policy("resnet18", cuda)
    args = _inputs(policy, 4, seed=6, device=cuda)
    with torch.no_grad():
        for _ in range(2):
            policy(*args)  # warm: eager, then the encoder's own capture
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            assert _reason(policy, args[0], args[2], args[3]) == "capturing"
            got = policy(*args)
        outer.replay()
        want = _eager_forward(policy, *args)
        torch.cuda.synchronize()
    assert _equal(got, want)
    assert _counts() == (2, 1, 0)
