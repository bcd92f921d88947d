"""VO training (``vo/engine.py::VORegressionEngine.train_step``) on host
``FramePairBatch``es of consecutive bank frames, cycled over a few host
batches so that every step pays the pageable upload.

Set-up builds the engine from the seeded weights and drives it through
its first three steps on three different batches, through the window's
own call.  It keeps the loss of each, the first gradient's norm of each
leaf (Adam's first moment after one step over ``1 - beta1``), each leaf's
change after three steps (judged by the median leaf and by the worst) and
the whitening statistics.  After the window
the reference trains the same weights on the same three batches, with the
same dropout keep masks (drawn from a generator seeded alike, in the
engine's order), and the two are compared leaf by leaf.
"""

from __future__ import annotations


import numpy as np
import torch

from benchmark import flops, harness, weights
from benchmark.entries import common
from benchmark.reference import vo_train as rt
from benchmark.traffic_gen import generate

CHECKED_STEPS = 3
BETA1 = 0.9


def _host_batch(d):
    from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch

    b = d["actions"].shape[0]
    return FramePairBatch(prev_rgb=d["prev_rgb"], cur_rgb=d["cur_rgb"],
                          prev_depth=d["prev_depth"], cur_depth=d["cur_depth"],
                          actions=d["actions"], gt_delta=d["gt_delta"],
                          data_types=d["data_types"], dz_regress_mask=np.ones(b, np.float32),
                          chunk_idx=np.zeros(b, np.int32), entry_idx=np.arange(b, dtype=np.int32),
                          twins_packed=bool(d["twins"]))


def expert_actions(tr) -> tuple:
    a = tr["action_type"]
    return tuple(a) if isinstance(a, list) else (a,)


def build_engine(ctx, sds, bf16: bool):
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig

    tr = ctx.traffic
    a = tr["action_type"]
    icfg = common.port_vo_config(ctx.config, bf16)
    tcfg = VOTrainConfig(lr=tr["lr"], batch_size=tr["batch_size"],
                         action_type=tuple(a) if isinstance(a, list) else a,
                         geo_invariance_types=tuple(tr["geo_invariance_types"]),
                         seed=ctx.seed)
    experts = [common.port_vo_expert(icfg, sd, ctx.device) for sd in sds]
    return VORegressionEngine(icfg, tcfg, experts=experts, device=ctx.device)


def _leaves(experts):
    return [(f"{e}.{k}", p) for e, m in enumerate(experts) for k, p in m.named_parameters()]


def _buffers(experts):
    return {f"{e}.{k}": b.detach().clone() for e, m in enumerate(experts)
            for k, b in m.named_buffers()}


def run(ctx, bf16: bool = False, fault=None) -> dict:
    """``bf16``: the control (the program's own bf16 path); ``fault(engine)``
    may break the engine (the tests' planted faults)."""
    from pointnav_vo_tpu_torch.ops import topdown_kernels

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    vo = cfg["vo"]
    ctx.mark("imports")
    vt = common.vo_template(cfg)
    n_exp = len(expert_actions(tr))
    sds = [weights.seeded_state_dict(vt, ctx.seed + 1 + e, dev, True) for e in range(n_exp)]
    engine = build_engine(ctx, sds, bf16)
    ctx.mark("weights and modules")
    if fault is not None:
        fault(engine)
    host = generate.frame_pairs(tr, ctx.seed, vo["vis_size_h"], vo["vis_size_w"], dev)
    batches = [_host_batch(d) for d in host]
    ctx.mark("batches")

    leaves = _leaves(engine.experts)
    p0 = [p.detach().clone() for _, p in leaves]
    losses = []
    for s in range(CHECKED_STEPS):
        m = engine.train_step(batches[s])
        losses.append(float(m["total_loss"]))
        if s == 0:
            g1 = torch.stack([(engine.opt.state[p]["exp_avg"] / (1 - BETA1)).norm()
                              if p in engine.opt.state else p.new_zeros(())
                              for _, p in leaves]).double().cpu()
    d3 = torch.stack([(p.detach() - q).norm() for (_, p), q in zip(leaves, p0)]).double().cpu()
    buf3 = _buffers(engine.experts)
    del p0
    harness.sync(ctx)
    ctx.mark("first steps")
    ctx.spans.clear()
    topdown_kernels.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = harness.Window(ctx, tr["profile_seconds"])
    setup_s = win.setup_s
    k, untraced = 0, 0
    while win.running():
        profiling = win.profiling
        with win.span("train_step"):
            engine.train_step(batches[(CHECKED_STEPS + k) % len(batches)])
        untraced += 0 if profiling else 1
        k += 1
    window_s = win.seconds
    device = harness.device_info(torch, 1) if dev.type == "cuda" else {}
    ctx.counters.update(steps=k, step_flops=flops.vo_train_step_flops(cfg, tr["batch_size"]),
                        mean_step_s=win.untraced_s / untraced if untraced else float("nan"),
                        bin_counts_launches=topdown_kernels.launch_counts["bin_counts"])
    names = [n for n, _ in leaves]
    del engine, leaves
    readings = judge(ctx, sds, host, losses, g1, d3, buf3, names)
    e2e = {"vo_train_pairs_per_s": tr["batch_size"] * k / window_s, "setup_s": setup_s}
    return {"end_to_end": e2e, "attempted": k, "failed": 0, "device": device,
            "checks": harness.judge(ctx, readings)}


def judge(ctx, sds, host, losses, g1, d3, buf3, names) -> dict:
    """The reference's first three steps against the program's."""
    dev, tr = ctx.device, ctx.traffic
    vt = common.vo_template(ctx.config)
    experts = [common.reference_module(vt, sd, dev) for sd in sds]
    params = [p for m in experts for p in m.parameters()]
    ref_names = [f"{e}.{k}" for e, m in enumerate(experts) for k, _ in m.named_parameters()]
    if ref_names != names:
        raise RuntimeError("the reference's parameters are not the program's")
    p0 = [p.detach().clone() for p in params]
    opt = rt.Adam(params, tr["lr"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    ea = expert_actions(tr)
    joint = "inverse_joint_train" in tr["geo_invariance_types"]
    ref_losses, gnorm = [], None
    gmax = torch.zeros(len(params), dtype=torch.float64)
    for s in range(CHECKED_STEPS):
        d = host[s]
        batch = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(dev)
                 for k in ("prev_rgb", "cur_rgb", "prev_depth", "cur_depth", "gt_delta")}
        for k in ("actions", "data_types"):
            batch[k] = torch.from_numpy(d[k].astype(np.int64)).to(dev)
        loss, grads = rt.train_step(experts, opt, batch, ea, joint, gen,
                                    ctx.config["vo"]["discretized_depth_channels"])
        ref_losses.append(float(loss))
        norms = torch.stack([g.norm() for g in grads]).double().cpu()
        gmax = torch.maximum(gmax, norms)
        if s == 0:
            gnorm = norms
    r3 = torch.stack([(p.detach() - q).norm() for p, q in zip(params, p0)]).double().cpu()
    moved = gmax >= 1e-3 * gmax.median()
    grad_gap = ((g1 - gnorm).abs() / torch.maximum(gnorm, gnorm.median())).max()
    d_gap = ((d3 - r3).abs() / torch.maximum(r3, r3.median()))[moved]
    ref_buf = {f"{e}.{k}": b for e, m in enumerate(experts) for k, b in m.named_buffers()}
    wgap = 0.0
    for k, b in ref_buf.items():
        wgap = max(wgap, float((buf3[k].double() - b.double()).abs().max()
                               / b.double().abs().max().clamp_min(1e-30)))
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    moved_names = [n for n, m in zip(names, moved.tolist()) if m]
    ctx.extra.update(unmoved_leaves=[n for n, m in zip(names, moved.tolist()) if not m],
                     loss_gap_by_step=step_gaps,
                     dparam3_worst_name=moved_names[int(d_gap.argmax())])
    return {"loss1_rel": step_gaps[0], "grad1_gap": float(grad_gap),
            "dparam3_median_gap": float(d_gap.median()),
            "dparam3_worst_leaf": float(d_gap.max()), "whiten_gap": wgap}
