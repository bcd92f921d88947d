"""Swin-B VO experts on the port (``models/swin.py``), against the
benchmark's plain reference (``benchmark/reference/backbones/swin_b.py``).

On the CPU (float32, one thread): the backbone on seeded weights at 70x101,
where every stage pads to whole windows and the last stage's map is
smaller than a window, loaded both ways, and a perturbed bias-table entry
caught; the region mask and the bias index against a brute-force
labelling and against the reference's published construction; one
``fused_vo_act_step`` with three Swin-B experts, its deltas against
``nets.VOCNN``; the ``swin_windows`` counter against the windows of the
plan; the seeded init's bias tables and LayerNorms; the bf16 path.

On the card (``-m cuda``; skipped where there is none): the experts
replayed from ``ExpertGraphs`` bit-equal to the eager experts at two row
counts, the counter re-added on every replay, no host sync; a capture of
a backbone whose masks were never built.

No JAX here: the reference is the benchmark's plain PyTorch, and the card's
machine runs ``pytest -m cuda --noconftest`` on this file.
"""

import math

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import nets
from benchmark.reference.backbones import swin_b as ref_swin
from pointnav_vo_tpu_torch.io.weights import seeded_init_
from pointnav_vo_tpu_torch.models import resnet, swin
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step
from pointnav_vo_tpu_torch.utils.logging import TRACER
from pointnav_vo_tpu_torch.vo.ensemble import (
    VOEnsemble,
    VOInferenceConfig,
    expert_rows,
    frame_features_packed,
)

CIN = 30  # the VO expert's packed frame pair
CPU = torch.device("cpu")
# float32 on the CPU: the port's attention is one fused
# scaled_dot_product_attention with the bias and mask folded in, the
# reference's is written out (q k^T, softmax, @ v); their sums round apart
# by about 1e-7 a block, 8e-7 relative after Swin-B's 24 blocks
RTOL = 1e-5


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _windows(h, w):
    """Windows one sample attends at an ``h x w`` input: each block's
    ``ceil(H/7) x ceil(W/7)`` over the stages' maps."""
    h, w = math.ceil(h / 4), math.ceil(w / 4)
    total = 0
    for depth in swin.DEPTHS:
        total += depth * math.ceil(h / 7) * math.ceil(w / 7)
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return total


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


# ------------------------------------------------------------- the backbone


@pytest.fixture(scope="module")
def backbones():
    """The port's Swin-B and the reference's on one seeded state dict."""
    ref = ref_swin.build(CIN, 32)
    sd = weights.seeded_state_dict(ref, 2**31 + 26, CPU, False)
    ref.load_state_dict(sd, strict=True)
    port = resnet.BACKBONES["swin_b"](CIN, base_planes=8, ngroups=4)
    port.load_state_dict(sd, strict=True)
    return port, ref


def _x(b=2, h=70, w=101, seed=3):
    return torch.rand(b, CIN, h, w, generator=torch.Generator().manual_seed(seed))


def test_backbone_matches_the_reference_at_70x101(backbones):
    port, ref = backbones
    # and back: the port's own state dict loads into the reference
    ref2 = ref_swin.build(CIN, 32)
    ref2.load_state_dict(port.state_dict(), strict=True)
    x = _x()
    with torch.no_grad():
        out_p, out_r, out_r2 = port(x), ref(x), ref2(x)
    # 18x26 tokens padded to 21x28, 9x13 to 14x14, 5x7 to 7x7, 3x4 to 7x7
    assert out_p.shape == out_r.shape == (2, 1024, math.ceil(70 / 32), math.ceil(101 / 32))
    assert port.final_channels == 1024
    assert _rel(out_p, out_r) < RTOL and torch.equal(out_r, out_r2)
    assert not any("relative_position_index" in k for k in port.state_dict())


@pytest.mark.parametrize("stage, block", [(2, 7), (3, 0)])  # a shifted block, a plain one
def test_a_perturbed_bias_table_entry_is_caught(backbones, stage, block):
    port, ref = backbones
    table = port.layers[stage].blocks[block].attn.relative_position_bias_table
    keep = table.detach().clone()
    x = _x(b=1)
    with torch.no_grad():
        want = ref(x)
        table[84, 1] += 1.0  # the centre entry: every token's bias to itself
        try:
            gap = _rel(port(x), want)
        finally:
            table.copy_(keep)
    assert gap > 10 * RTOL, gap


# --------------------------------------------------- the mask and the index


def _band(i, n):
    """The published slices of an axis of a padded map: (0:-7, -7:-3, -3:)."""
    return 0 if i < n - swin.WINDOW else (1 if i < n - swin.SHIFT else 2)


@pytest.mark.parametrize("hp, wp", [(7, 7), (14, 21), (28, 14)])
def test_the_region_mask_against_a_brute_force_labelling(hp, wp):
    got = swin.shift_mask(hp, wp)
    ws = swin.WINDOW
    want = torch.zeros((hp // ws) * (wp // ws), ws * ws, ws * ws)
    for wi in range(hp // ws):
        for wj in range(wp // ws):
            cells = [(wi * ws + p // ws, wj * ws + p % ws) for p in range(ws * ws)]
            labels = [3 * _band(r, hp) + _band(c, wp) for r, c in cells]
            for p in range(ws * ws):
                for q in range(ws * ws):
                    if labels[p] != labels[q]:
                        want[wi * (wp // ws) + wj, p, q] = swin.MASK_VALUE
    assert torch.equal(got, want)
    assert torch.equal(got, ref_swin._region_mask(hp, wp, CPU))


def test_the_bias_index_against_the_published_construction():
    got = swin.relative_position_index()
    ws = swin.WINDOW
    want = [(p // ws - q // ws + ws - 1) * (2 * ws - 1) + (p % ws - q % ws + ws - 1)
            for p in range(ws * ws) for q in range(ws * ws)]
    assert got.tolist() == want
    assert torch.equal(got, ref_swin._bias_index(CPU).flatten())
    assert got.min() == 0 and got.max() == (2 * ws - 1) ** 2 - 1


def test_each_stage_builds_its_mask_once(backbones):
    port, _ = backbones
    for stage in port.layers:
        stage._masks.clear()
    with torch.no_grad():
        port(_x(b=1))
        kept = [dict(stage._masks) for stage in port.layers]
        port(_x(b=1, seed=4))
    assert [list(k) for k in kept] == [[(21, 28, CPU)], [(14, 14, CPU)], [(7, 7, CPU)],
                                       [(7, 7, CPU)]]
    assert all(stage._masks[key] is k[key] for stage, k in zip(port.layers, kept)
               for key in k)


# ------------------------------------------------------ counter, init, bf16


@pytest.mark.parametrize("b, h, w", [(2, 70, 101), (3, 64, 96), (1, 192, 341)])
def test_the_window_counter_counts_the_plans_windows(backbones, b, h, w):
    port, _ = backbones
    with torch.no_grad():
        port(_x(b=b, h=h, w=w))
    assert TRACER.counters["swin_windows"] == b * _windows(h, w)
    assert _windows(192, 341) == 2 * 91 + 2 * 28 + 18 * 8 + 2 * 2 == 386


def test_seeded_init_draws_the_bias_tables_and_unit_layer_norms():
    m = seeded_init_(swin.swin_b(CIN), torch.Generator().manual_seed(0))
    tables = [mod.relative_position_bias_table for mod in m.modules()
              if isinstance(mod, swin.WindowAttention)]
    assert len(tables) == sum(swin.DEPTHS)
    flat = torch.cat([t.detach().flatten() for t in tables])
    assert abs(float(flat.std()) - 0.02) < 1e-3 and abs(float(flat.mean())) < 1e-3
    norms = [mod for mod in m.modules() if isinstance(mod, torch.nn.LayerNorm)]
    assert len(norms) == 2 + 2 * sum(swin.DEPTHS) + 3  # embed, blocks, merges, norm3
    assert all(bool((n.weight == 1).all() and (n.bias == 0).all()) for n in norms)


def test_the_bf16_path_runs(backbones):
    port, ref = backbones
    x = _x(b=1)
    with torch.no_grad():
        got, want = port(x.bfloat16()), ref(x)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    # bfloat16's 8-bit mantissa through 24 blocks: about 1e-2 relative
    assert 1e-4 < _rel(got, want) < 5e-2


# ------------------------------------------------- the eval step (CPU)


H, W, N = 64, 96, 3


def _swin_ensemble(device=CPU, size=(H, W)):
    cfg = VOInferenceConfig(vis_size_h=size[0], vis_size_w=size[1], hidden_size=32,
                            backbone="swin_b")
    g = torch.Generator().manual_seed(0)
    return VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                      device=device)


def _reference_expert(port_expert, cfg):
    """``nets.VOCNN`` holding the port expert's own tensors (built on the
    meta device, then assigned: no second copy of the weights)."""
    with torch.device("meta"):
        ref = nets.VOCNN(CIN, cfg.vis_size_h, cfg.vis_size_w, "swin_b", cfg.hidden_size,
                         cfg.dropout_p)
    ref.load_state_dict(port_expert.state_dict(), strict=True, assign=True)
    return ref.eval()


def test_fused_eval_step_with_swin_experts_matches_the_reference():
    vo = _swin_ensemble()
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W), hidden_size=32, baseplanes=8),
                          torch.Generator().manual_seed(1)).eval()
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    rgb = t(rng.integers(0, 256, (2, N, H, W, 3)).astype(np.uint8))
    depth = t(rng.uniform(0.1, 10, (2, N, H, W, 1)).astype(np.float32))
    prev = frame_features_packed(rgb[0], depth[0], vo.cfg)
    reset = t(np.zeros((N, 1), np.float32))
    sensor = t(np.stack([rng.uniform(0.5, 5, N), rng.uniform(-3, 3, N)], -1)
               .astype(np.float32))
    goal = t(rng.normal(size=(N, 3)).astype(np.float32))
    seed_rot = t(np.tile(np.asarray([0, 0, 0, 1], np.float32), (N, 1)))
    seed_pos = t(np.zeros((N, 3), np.float32))
    acts = np.asarray([3, 1, 2], np.int32)
    TRACER.reset()
    out = fused_vo_act_step(policy, vo, prev, rgb[1], depth[1], acts, goal, reset, sensor,
                            policy.initial_hidden(N), t(acts.astype(np.int64)[:, None]),
                            1.0 - reset, seed_rot, seed_pos, seed_rot, seed_pos)
    pairs = torch.cat([prev, out[8]], -1)
    want = torch.zeros(N, 3)
    with torch.no_grad():
        for expert, rows in zip(vo.experts, expert_rows(acts)):
            ref = _reference_expert(expert, vo.cfg)
            want[rows] = ref(pairs[rows])
    assert _rel(out[2], want) < RTOL
    assert float(want.abs().min()) > 0  # every row's expert ran
    # one expert a pair, each pair's windows once; the CPU runs eagerly
    assert TRACER.counters["swin_windows"] == N * _windows(H, W)
    assert TRACER.counters["vo_graph_eager"] == 3


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _frames(b, seed, device, size):
    rng = np.random.default_rng(seed)
    h, w = size
    return (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(device),
            torch.from_numpy(rng.uniform(0.1, 10, (b, h, w, 1)).astype(np.float32)).to(device))


def _eager(vo, pairs, actions):
    """Each row through its own expert, eagerly (gradients off, no graph)."""
    out = torch.zeros((pairs.shape[0], 3), device=pairs.device)
    for expert, rows in zip(vo.experts, expert_rows(actions)):
        if rows.size:
            idx = torch.as_tensor(rows).to(pairs.device)
            out.index_copy_(0, idx, expert(pairs.index_select(0, idx)))
    return out


CARD = (96, 160)


@pytest.mark.cuda
def test_replay_is_bit_equal_to_the_eager_experts_and_recounts_windows(cuda):
    vo = _swin_ensemble(cuda, CARD)
    per_pair = _windows(*CARD)
    # forward gets 6 rows, then 2: two row counts, each captured then replayed
    mixes = [[1, 1, 2, 3, 1, 1, 1, 0], [2, 2, 1, 3, 3, 1, 3, 2]] * 2
    prev = frame_features_packed(*_frames(8, 0, cuda, CARD), vo.cfg)
    with torch.no_grad():
        for k, actions in enumerate(mixes):
            rgb, depth = _frames(8, 1 + k, cuda, CARD)
            if k == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                before = TRACER.counters.get("swin_windows", 0)
                delta, _, cur = vo.step(prev, rgb, depth, np.asarray(actions))
                counted = TRACER.counters["swin_windows"] - before
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = _eager(vo, torch.cat([prev, cur], -1), np.asarray(actions))
            assert torch.equal(delta, want), k
            assert counted == 8 * per_pair, k
            prev = cur
    calls = sum(len([r for r in expert_rows(np.asarray(m)) if r.size]) for m in mixes)
    captures = len(vo._graphs.graphs)
    assert captures == 6  # (forward 6, left 1, right 1), (forward 2, left 3, right 3)
    assert (TRACER.counters["vo_graph_captures"], TRACER.counters["vo_graph_replays"],
            TRACER.counters.get("vo_graph_eager", 0)) == (captures, calls - captures, 0)


@pytest.mark.cuda
def test_a_capture_builds_missing_masks_into_the_graph_and_keeps_none(cuda):
    m = seeded_init_(swin.swin_b(CIN), torch.Generator().manual_seed(2)).to(cuda)
    x = torch.rand(2, CIN, *CARD, device=cuda)
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = m(x)  # the first call builds the masks on the card: no upload
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for stage in m.layers:
            stage._masks.clear()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = m(x)
        assert all(not stage._masks for stage in m.layers)
        g.replay()
        torch.cuda.synchronize()
    assert torch.equal(y, want)
