"""The closed-loop eval step (``rl/eval.py::fused_vo_act_step``, det).

Each loop step uploads the bank's next frame of every env in habitat's
dtypes (rgb uint8, depth float32) with one small float32 block (episode
starts, goal sensors, the actions just taken), calls the fused step with
the previous step's cached features, and reads the policy's actions back
to the host: the evaluator's one sync a step.  The actions just taken come
from the bank (the greedy goal rule's mix), so they pick each sample's
expert and feed the policy's previous-action input.

Set-up runs the bank's whole cycle once, which warms every bucket size the
window will see.  After the window a seeded sample of its steps (drawn
evenly over the whole window by a reservoir) and the
first step of the set-up (fresh state) are recomputed by the
reference from the bank's frames and each step's incoming state (the
goal, the recurrent state and the drift pose the program carried): the
packed features, the deltas, the goal, the logits, value and recurrent
state, and the drift pose.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import flops, harness, weights
from benchmark.entries import common
from benchmark.reference import features as rf
from benchmark.reference import geometry as rg
from benchmark.traffic_gen import generate


def build_program(ctx, sds, bf16: bool):
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    icfg = common.port_vo_config(ctx.config, bf16)
    experts = [common.port_vo_expert(icfg, sd, ctx.device) for sd in sds["vo"]]
    vo = VOEnsemble(icfg, experts=experts, device=ctx.device)
    policy = common.port_policy(ctx.config, sds["policy"], ctx.device, bf16)
    return vo, policy


def run(ctx, bf16: bool = False, fault=None) -> dict:
    """``bf16``: the control (the program's own bf16 path); ``fault(out, state)``
    may alter a step's outputs (the tests' planted faults)."""
    from pointnav_vo_tpu_torch.ops import topdown_kernels
    from pointnav_vo_tpu_torch.rl.eval import fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    vo_cfg = cfg["vo"]
    h, w, n = vo_cfg["vis_size_h"], vo_cfg["vis_size_w"], tr["envs"]
    ctx.mark("imports")
    vt, pt = common.vo_template(cfg), common.policy_template(cfg)
    sds = {"vo": [weights.seeded_state_dict(vt, ctx.seed + 1 + e, dev, False)
                  for e in range(3)],
           "policy": weights.seeded_state_dict(pt, ctx.seed, dev, False)}
    vo, policy = build_program(ctx, sds, bf16)
    ctx.mark("weights and modules")
    bank = generate.eval_bank(tr, ctx.seed, h, w, dev)
    t_len = bank["small"].shape[0]
    ctx.mark("bank")
    ctx.extra["action_mix"] = np.bincount(bank["small"][:, :, 3].astype(int).ravel(),
                                          minlength=4).tolist()

    seed_rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
    seed_pos = torch.zeros((n, 3), device=dev)
    st = {"goal": torch.zeros((n, 3), device=dev), "hidden": policy.initial_hidden(n, dev),
          "rot": seed_rot, "pos": seed_pos,
          "feats": frame_features_packed(torch.from_numpy(bank["rgb"][-1]).to(dev),
                                         torch.from_numpy(bank["depth"][-1]).to(dev), vo.cfg)}
    records = {}

    head = policy.action_distribution.linear

    def step(slot: int, small_np: np.ndarray, win=None, keep=False):
        """One loop step; with ``keep``, its inputs, outputs and logits (a
        forward hook on the policy's head, on the kept steps only)."""
        span = win.span if win is not None else ctx.span
        cap = {}
        hook = (head.register_forward_hook(lambda m, i, o: cap.__setitem__("logits", o))
                if keep else None)
        t0 = time.perf_counter()
        with span("upload"):
            rgb = torch.from_numpy(bank["rgb"][slot]).to(dev)
            depth = torch.from_numpy(bank["depth"][slot]).to(dev)
            small = torch.from_numpy(small_np).to(dev)
        with span("fused_vo_act_step"):
            reset = small[:, 0:1]
            out = fused_vo_act_step(policy, vo, st["feats"], rgb, depth, small_np[:, 3],
                                    st["goal"], reset, small[:, 1:3], st["hidden"],
                                    small[:, 3:4].long(), 1.0 - reset, st["rot"], st["pos"],
                                    seed_rot, seed_pos, deterministic=True)
            if fault is not None:
                out = fault(out, st)
        with span("readback"):
            out[5].cpu()
        dt = time.perf_counter() - t0
        rec = None
        if keep:
            hook.remove()
            rec = (slot, small_np, dict(st), out, cap["logits"])
        st.update(goal=out[0], hidden=out[7], feats=out[8], rot=out[9], pos=out[10])
        return dt, rec

    # set-up: the first step from a fresh state, then the rest of the bank's cycle
    _, records["first"] = step(0, bank["first"], keep=True)
    for s in range(1, t_len):
        step(s, bank["small"][s])
    harness.sync(ctx)
    ctx.mark("warm-up")
    ctx.spans.clear()
    topdown_kernels.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # a reservoir of ``samples`` window steps: each step of the whole window
    # is as likely to be checked as any other, drawn from the seed
    rng = np.random.default_rng([ctx.seed, 3])
    kept = {}
    win = harness.Window(ctx, tr["profile_seconds"])
    setup_s = win.setup_s
    lat, k = [], 0
    while win.running():
        slot = k % t_len
        profiling = win.profiling
        j = k if k < tr["samples"] else int(rng.integers(0, k + 1))
        dt, rec = step(slot, bank["small"][slot], win, keep=j < tr["samples"])
        if rec is not None:
            kept[j] = (k, rec)
        if not profiling:
            lat.append(dt)
        k += 1
    window_s = win.seconds
    records.update({f"step{i}": rec for i, rec in kept.values()})
    del kept
    launches = topdown_kernels.launch_counts["bin_counts"]
    device = harness.device_info(torch, 1) if dev.type == "cuda" else {}

    # per-layer inputs: the kernel's bytes for these inputs, the step's FLOPs
    ctx.counters["steps"] = k
    ctx.counters["bin_counts_launches"] = launches
    ctx.counters["step_flops"] = flops.eval_step_flops(cfg, n)
    ctx.counters["bin_counts_bytes"] = _bin_counts_bytes(bank, dev, h, w)
    ctx.counters["mean_step_s"] = win.untraced_s / len(lat) if lat else float("nan")

    # free the program's state, then judge the recorded steps
    del st
    readings = judge(ctx, sds, bank, records, vo_cfg)
    e2e = {"eval_env_steps_per_s": n * k / window_s,
           "eval_step_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else float("nan"),
           "setup_s": setup_s}
    return {"end_to_end": e2e, "attempted": k, "failed": 0, "device": device,
            "checks": harness.judge(ctx, readings)}


def _bin_counts_bytes(bank, dev, h, w) -> float:
    """Mean bytes one ``bin_counts`` launch must move on this bank: a keep
    byte per candidate point, 8 B (two int32 bins) per kept point, 4 B per
    output cell."""
    total = 0.0
    t_len = bank["small"].shape[0]
    for s in range(t_len):
        d = torch.from_numpy(bank["depth"][s]).to(dev)[..., 0]
        b = d.shape[0]
        kept = int(rf.top_down_counts(d).sum().item())
        total += b * min(2 * rf.ROWS_AROUND_CENTER, h) * w + 8 * kept + 4 * b * h * w
    return total / t_len


def judge(ctx, sds, bank, records, vo_cfg) -> dict:
    dev = ctx.device
    dd = vo_cfg["discretized_depth_channels"]
    vt, pt = common.vo_template(ctx.config), common.policy_template(ctx.config)
    experts = [common.reference_module(vt, sd, dev).eval() for sd in sds["vo"]]
    policy = common.reference_module(pt, sds["policy"], dev).eval()
    worst = {"feat_gap": 0.0, "delta_rel": 0.0, "goal_rel": 0.0, "logits_rel": 0.0,
             "value_rel": 0.0, "hidden_rel": 0.0, "pose_gap": 0.0}
    t_len = bank["small"].shape[0]
    with torch.no_grad():
        for name, rec in records.items():
            slot, small_np, st_in, out, logits_p = rec
            prev_slot = (slot - 1) % t_len
            cur = rf.pack_frame(torch.from_numpy(bank["rgb"][slot]).to(dev),
                                torch.from_numpy(bank["depth"][slot]).to(dev), dd)
            prev = rf.pack_frame(torch.from_numpy(bank["rgb"][prev_slot]).to(dev),
                                 torch.from_numpy(bank["depth"][prev_slot]).to(dev), dd)
            obs = torch.cat([prev, cur], -1)
            acts = torch.from_numpy(small_np[:, 3].astype(np.int64)).to(dev).clamp(1, 3)
            delta = torch.zeros((obs.shape[0], 3), device=dev)
            for e, m in enumerate(experts):
                rows = torch.nonzero(acts == e + 1).flatten()
                if rows.numel():
                    delta[rows] = m(obs[rows])
            small = torch.from_numpy(small_np).to(dev)
            reset, sensor = small[:, 0:1], small[:, 1:3]
            goal_in = st_in["goal"].float()
            goal, polar = rg.propagate_goal(goal_in, delta, reset, sensor)
            depth = torch.from_numpy(bank["depth"][slot]).to(dev)
            logits, value, hidden = policy(depth, polar, st_in["hidden"].float(),
                                           small[:, 3:4].long(), 1.0 - reset)
            n = obs.shape[0]
            seed_rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
            rot, pos = rg.integrate_pose(st_in["rot"], st_in["pos"], delta, reset, seed_rot,
                                         torch.zeros((n, 3), device=dev))
            got = {
                "feat_gap": max(float((out[8].float() - cur).abs().max()),
                                float((st_in["feats"].float() - prev).abs().max())),
                "delta_rel": common.rel(out[2], delta),
                "goal_rel": common.rel(out[0], goal),
                "logits_rel": common.rel(logits_p, logits),
                "value_rel": common.rel(out[4], value),
                "hidden_rel": common.rel(out[7], hidden),
                "pose_gap": max(float((out[9] - rot).abs().max()),
                                float((out[10] - pos).abs().max())),
            }
            for k, v in got.items():
                worst[k] = max(worst[k], v)
    return worst

