#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pointnav_vo_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. build: every kernel under ``pointnav_vo_tpu_torch/csrc/`` with nvcc
   (all started together), its ptxas register/shared-memory report, and the
   card's name and power limit;
2. kernel check: ``bin_counts`` on random bins and on ``pixel_bins`` of
   scripted-env depth at batch 1, 2, 32, 64, 128 and 512 (2: the policy
   training rollout's; 64 and 128: the VO training batches), and on a
   190-row grid, a grid
   cut into bands of rows, more points per image than a 16-bit count holds,
   one hot cell, all points dropped and batch 0, each ``torch.equal`` to its
   plain version on the card.  Times, on scripted-env depth, in two turns:
   ``device_ms``, the kernel's own device time (torch.profiler, L2 flushed
   before each launch by writing 256 MiB), also unflushed; ``call_ms``, the
   wrapper's time per call back to back (CUDA events); the plain version's
   and ``torch.bincount``'s device time (a yardstick only), beside the
   memory bound, and the cluster plan the wrapper chose;
3. main path: ``Evaluator.run`` of the det VO-in-the-loop eval at full
   width (three ``vo_cnn_rgb_d_dd_top_down`` experts and the ResNet18 +
   2-layer LSTM-512 policy at 341x192, seeded random weights, fp32, TF32
   off) over 32 scripted envs, an exact set of 32 episodes; the kernel's
   launch count must rise by exactly steps + 1.  Then the per-step time of
   ``fused_vo_act_step`` and one step held against the same step on the CPU;
4. rnd eval: ``Evaluator.run`` again with the experts in rnd mode (10
   dropout passes, mean and std) and sampled actions, an exact set of 32
   episodes: finite aggregates, ``vo_pred_std_mean > 0``, steps + 1
   launches.  Then the rnd step's time, a profiler breakdown, and one rnd
   step held against the CPU on the same dropout masks (mode actions);
5. steady-state VO: ``VOEnsemble.predict_step_cached`` at batch 512 with a
   70/15/15 forward/left/right action mix, frame-pairs/s;
6. VO training (``VORegressionEngine``, full width, seeded experts, frame
   pairs from the scripted env held in memory: the card has no h5py):
   (a) the forward stage at batch 128: ``train_epoch`` over 8 steps, 8 steps
   on one fixed batch with fixed dropout masks (its loss must fall),
   ``evaluate`` over a ragged
   eval set; (b) the joint turn stage, 64 twin-packed entries a batch with
   the inverse loss: the same, ``debug_geo/*`` under 1e-4; each with
   ``bin_counts`` launched exactly twice a step (prev and cur frames) and
   twice an eval batch, frame-pairs/s, peak memory and a profiler
   breakdown; (c) one train step of each stage at batch 8 (dropout off)
   held against the same step on the CPU: loss, every gradient (beside
   both devices' distance from a float64 step) and the whitening
   statistics;
7. policy training (``DDPPOTrainer``, the config of
   ``configs/rl/ddppo_pointnav.yaml``: the ResNet18 + 2-layer LSTM-512
   policy and three det VO experts in the loop at 341x192, 2 envs, 128
   steps a rollout, 2 minibatches, lr 1e-4, seeded weights): ``train`` of 2
   updates with ``bin_counts`` launched exactly updates x 128 + 1 times,
   rollout-step and update times, env-steps/s, device idle share and
   launches per step and per update (torch.profiler), peak memory; the
   loss of one fixed rollout must fall over 4 updates on it; one rollout
   step (mode action, VO delta, goal) and one ``ppo_loss`` gradient on a
   16-step rollout held against the CPU (gradients beside a float64 step).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name/power line; the last line is the run's JSON verdict.
Exits non-zero, printing no verdict, where no CUDA card is present.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

H, W = 192, 341  # full width of the deployed models
BAND = min(100, H)  # 2 * rows_around_center rows of candidate points
KERNEL_BATCHES = (1, 2, 32, 64, 128, 512)
N_ENVS = 32
STEADY_BATCH = 512
RND_PASSES = 10  # VO.REGRESS_MODEL rnd_mode_n
TRAIN_BATCH = 128  # configs/vo/vo_pointnav.yaml VO.TRAIN.batch_size
TRAIN_STEPS = 8
EVAL_PAIRS = 300  # three eval batches, the last one padded
PARITY_BATCH = 8
RL_ENVS = 2  # configs/rl/ddppo_pointnav.yaml NUM_PROCESSES
RL_STEPS = 128  # RL.PPO.num_steps
RL_UPDATES = 2
RL_FIXED_UPDATES = 4
RL_PARITY_STEPS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
_FLUSH_KERNEL = "bitwise_not"  # the L2 flush's kernel, left out of device times
SEED = 0


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, iters, warmup=3):
    """Mean CUDA-event time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(label, fn, iters=3):
    """Device kernel time per call from torch.profiler over ``iters`` calls,
    beside the host wall time (profiler on); prints the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    if busy_ms <= 0:
        _log("profile", f"{label}: device time not measured (profiler saw no kernels)")
        return None
    launches = sum(e.count for e in kernels) / iters
    _log("profile", f"{label}: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
                    f"per call ({100 * (1 - busy_ms / wall_ms):.1f} % idle, profiler on), "
                    f"{launches:.0f} kernel launches per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log("profile", f"  {e.self_device_time_total / 1e3 / iters:9.4f} ms "
                        f"x{e.count // iters:<4d} {e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle": 1 - busy_ms / wall_ms,
            "launches": launches}


def phase_build():
    from pointnav_vo_tpu_torch import kernels

    t0 = time.perf_counter()
    reports = kernels.build()
    for name, log in reports.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        _log("build", f"{name}: {' | '.join(lines) or 'already built'}")
    _log("build", f"built {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    card = _card_line()
    _log("build", f"card: {card}")
    return card


def _scripted_depth(n, seed):
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env

    env_cfg = EnvConfig(image_h=H, image_w=W)
    return make_scripted_vector_env(env_cfg, n, seed=seed).reset()["depth"][..., 0]


def _device_ms(fn, iters, flush=None):
    """Device time per call of ``fn()`` in ms from torch.profiler: the sum
    of the kernels it launches, over ``iters`` calls, each after ``flush``
    (an L2 flush) when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    per = [e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and _FLUSH_KERNEL not in e.key]
    if not per:
        raise AssertionError("device time not measured: the profiler saw no kernels")
    return sum(per)


def _check_equal(got, want, what):
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"bin_counts != plain ({what}): max abs err {err}")
    return err


def _edge_cases(dev):
    """Another grid height, a grid in two bands of rows, twice the points a
    16-bit count holds per image, one hot cell holding every point, every
    point dropped (output from torch.empty over freed garbage) and batch 0;
    each equal to the plain version."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    rng = np.random.default_rng(SEED + 3)
    b, n = N_ENVS, BAND * W
    cases = {}
    h2 = 190
    cases["190 rows"] = (
        torch.from_numpy(rng.integers(-3, h2 + 3, (b, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(-3, W + 3, (b, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.uniform(size=(b, BAND, W)) < 0.8), h2)
    hot_r = torch.from_numpy(rng.integers(0, H, (b, 1, 1)).astype(np.int32))
    hot_c = torch.from_numpy(rng.integers(0, W, (b, 1, 1)).astype(np.int32))
    h3 = 400  # two bands of rows
    cases["400 rows in bands"] = (
        torch.from_numpy(rng.integers(-3, h3 + 3, (2, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(-3, W + 3, (2, BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.uniform(size=(2, BAND, W)) < 0.8), h3)
    cases["68,200 points per image"] = (
        torch.from_numpy(rng.integers(0, H, (2, 2 * BAND, W)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, W, (2, 2 * BAND, W)).astype(np.int32)),
        torch.ones((2, 2 * BAND, W), dtype=torch.bool), H)
    cases["hot cell"] = (hot_r.expand(b, BAND, W).contiguous(),
                         hot_c.expand(b, BAND, W).contiguous(),
                         torch.ones((b, BAND, W), dtype=torch.bool), H)
    cases["all dropped"] = (torch.zeros((b, BAND, W), dtype=torch.int32),
                            torch.zeros((b, BAND, W), dtype=torch.int32),
                            torch.zeros((b, BAND, W), dtype=torch.bool), H)
    cases["batch 0"] = (torch.zeros((0, BAND, W), dtype=torch.int32),
                        torch.zeros((0, BAND, W), dtype=torch.int32),
                        torch.zeros((0, BAND, W), dtype=torch.bool), H)
    err = 0.0
    for what, (pix_r, pix_c, keep, h) in cases.items():
        pix_r, pix_c, keep = pix_r.to(dev), pix_c.to(dev), keep.to(dev)
        want = tk.bin_counts_reference(pix_r, pix_c, keep, h, W)
        garbage = torch.full((pix_r.shape[0], h, W), float("nan"), device=dev)
        del garbage  # the allocator hands its block to the kernel's output
        before = tk.launch_counts["bin_counts"]
        got = tk.bin_counts(pix_r, pix_c, keep, h, W)
        err = max(err, _check_equal(got, want, what))
        if tk.launch_counts["bin_counts"] - before != int(pix_r.shape[0] > 0):
            raise AssertionError(f"{what}: wrong number of launches")
        if what == "hot cell" and int(want.amax()) != n:
            raise AssertionError(f"hot cell holds {int(want.amax())} of {n} points")
        _log("kernel", f"{what}: equal to plain version ({int(want.sum())} points binned)")
    return err


def phase_kernel(dev):
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.ops.topdown import TopDownParams, pixel_bins

    rng = np.random.default_rng(SEED)
    depths = torch.from_numpy(_scripted_depth(max(KERNEL_BATCHES), seed=1000)).to(dev)
    params = TopDownParams(vis_size_h=H, vis_size_w=W)
    # writing 256 MiB evicts the 50 MB L2, so each timed launch reads from HBM
    scratch = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    flush = scratch.bitwise_not_
    max_err = _edge_cases(dev)
    timings = {}
    for b in KERNEL_BATCHES:
        random_bins = (
            torch.from_numpy(rng.integers(-3, H + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-3, W + 3, (b, BAND, W)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.uniform(size=(b, BAND, W)) < 0.8).to(dev))
        depth_bins = pixel_bins(depths[:b].contiguous(), params)
        for kind, bins in (("random", random_bins), ("scripted-depth", depth_bins)):
            want = tk.bin_counts_reference(*bins, H, W)
            got = tk.bin_counts(*bins, H, W)
            max_err = max(max_err, _check_equal(got, want, f"B={b} {kind}"))
            _log("kernel", f"B={b} {kind}: equal to plain version "
                           f"({int(want.sum())} points binned)")
        # time on the main path's data: bins of scripted-env depth
        pix_r, pix_c, keep = depth_bins
        kept = int(keep.sum())
        nbytes = keep.numel() * 1 + kept * 8 + b * H * W * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ok = keep & (pix_r >= 0) & (pix_r < H) & (pix_c >= 0) & (pix_c < W)
        img = torch.arange(b, device=dev).view(b, 1, 1)
        flat = torch.where(ok, (img * H + pix_r.long()) * W + pix_c.long(),
                           b * H * W).reshape(-1)
        kernel = lambda: tk.bin_counts(pix_r, pix_c, keep, H, W)  # noqa: E731
        dev_iters, call_iters = 20, (200 if b < 512 else 50)
        turns = {"device_ms": [], "call_ms": []}
        for _ in range(2):
            turns["device_ms"].append(_device_ms(kernel, dev_iters, flush))
            turns["call_ms"].append(_time_ms(kernel, call_iters))
        plan = tk.card_plan(b, BAND * W, H, W, dev)
        t = {
            "device_ms": float(np.mean(turns["device_ms"])),
            "call_ms": float(np.mean(turns["call_ms"])),
            "device_ms_l2_warm": _device_ms(kernel, dev_iters),
            "plain_ms": _device_ms(
                lambda: tk.bin_counts_reference(pix_r, pix_c, keep, H, W), dev_iters, flush),
            "library_ms": _device_ms(
                lambda: torch.bincount(flat, minlength=b * H * W + 1), dev_iters, flush),
            "bound_ms": bound_ms,
            "bytes": nbytes,
            "cluster": plan.cluster,
            "turns": turns,
        }
        timings[b] = t
        _log("kernel", f"B={b}: device_ms={t['device_ms']:.5f} (L2 flushed; "
                       f"{t['device_ms_l2_warm']:.5f} unflushed) call_ms={t['call_ms']:.5f} "
                       f"plain_ms={t['plain_ms']:.5f} library_ms(torch.bincount)="
                       f"{t['library_ms']:.5f} bound_ms={bound_ms:.5f} "
                       f"({nbytes} B over 3.35 TB/s, {100 * bound_ms / t['device_ms']:.1f} % "
                       f"of bound), cluster of {plan.cluster}; turns " + json.dumps(turns))
    del scratch
    return max_err, timings


def _build_models(cfg, dev, seed):
    """Three VO experts and the policy with seeded random weights; returns
    (card ensemble, card policy, CPU copies of both)."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble

    g = torch.Generator().manual_seed(seed)
    experts = [seeded_init_(cfg.make_model(), g) for _ in range(3)]
    policy = seeded_init_(PointNavActorCritic(image_size=(H, W)), g).eval()
    cpu_vo = VOEnsemble(cfg, experts=[copy.deepcopy(m) for m in experts], device="cpu")
    cpu_policy = copy.deepcopy(policy)
    return (VOEnsemble(cfg, experts=experts, device=dev), policy.to(dev),
            cpu_vo, cpu_policy)


def _fused_inputs(obs0, obs1, actions, dev, vo_cfg, policy):
    """Arguments of one fused step on ``dev`` from two consecutive obs."""
    import torch

    from pointnav_vo_tpu_torch.ops.geometry import pointgoal_polar2cartesian
    from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

    n = actions.shape[0]

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    sensor0 = t(obs0["pointgoal_with_gps_compass"])
    reset = t(np.zeros((n, 1)), np.float32)
    gen = torch.Generator().manual_seed(SEED)
    hidden = torch.randn(policy.num_packed_hidden, n, policy.hidden_size,
                         generator=gen).to(dev)
    return dict(
        prev_feats=frame_features_packed(t(obs0["rgb"], np.uint8), t(obs0["depth"]), vo_cfg),
        cur_rgb=t(obs1["rgb"], np.uint8), cur_depth=t(obs1["depth"]),
        actions_np=actions, goal_cart=pointgoal_polar2cartesian(sensor0),
        reset_mask=reset, sensor_polar=t(obs1["pointgoal_with_gps_compass"]),
        hidden=hidden, prev_actions=t(actions[:, None], np.int64), masks=1.0 - reset,
        est_rot=t(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), np.float32),
        est_pos=t(np.zeros((n, 3)), np.float32),
        est_seed_rot=t(np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), np.float32),
        est_seed_pos=t(np.zeros((n, 3)), np.float32))


def phase_main_path(dev):
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n_envs = n_episodes = N_ENVS  # one episode per env
    cap = 20
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=cap)
    envs = make_scripted_vector_env(env_cfg, n_envs, seed=SEED)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=vo, device=dev)

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(n_episodes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tk.launch_counts)
    loop_steps = max(r.steps for r in ev.results)
    _log("main", "Evaluator.run: " + json.dumps(agg, sort_keys=True))
    if agg["episodes"] != n_episodes or len(ev.results) != n_episodes:
        raise AssertionError(f"expected exactly {n_episodes} episodes, got {agg['episodes']}")
    bad = [k for k, v in agg.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite aggregates: {bad}")
    if launches["bin_counts"] != loop_steps + 1:
        raise AssertionError(f"bin_counts launched {launches['bin_counts']} times over "
                             f"{loop_steps} steps; expected steps + 1")
    _log("main", f"{loop_steps} steps, {int(agg['total_env_steps'])} env steps, "
                 f"wall {wall:.3f} s, bin_counts launches {launches['bin_counts']}")

    # per-step time of the fused step on the card (CUDA events), on real frames
    probe = make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n_envs) < 0.7, 1,
                       rng.integers(2, 4, n_envs)).astype(np.int64)
    obs1 = probe.step(actions)[0]
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    step_ms = _time_ms(lambda: fused_vo_act_step(policy, vo, **args), iters=20)
    _log("main", f"fused_vo_act_step at {n_envs} envs: {step_ms:.4f} ms/step "
                 "(CUDA events, host gaps included)")
    _profile(f"fused_vo_act_step at {n_envs} envs",
             lambda: fused_vo_act_step(policy, vo, **args))

    # one step on the card against the same step on the CPU
    got = fused_vo_act_step(policy, vo, **args)
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg, cpu_policy)
    want = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args)
    errs = _compare_step(got, want)
    _log("main", "card vs CPU fused step (rtol 1e-3, atol 1e-4; actions equal): "
                 + json.dumps(errs, sort_keys=True))
    return launches, step_ms, wall, loop_steps


def _compare_step(got, want):
    """Card outputs of ``fused_vo_act_step`` against the CPU's: actions
    equal, the rest within rtol 1e-3 / atol 1e-4 (fp32 with TF32 off: cuDNN
    and the CPU sum in other orders).  Returns the max abs errors."""
    import torch

    names = ("goal_cart", "polar", "delta", "std", "value", "action", "logp", "hidden",
             "cur_feats", "est_rot", "est_pos")
    errs = {}
    for name, g, w in zip(names, got, want, strict=True):
        g = g.cpu()
        errs[name] = float((g.double() - w.double()).abs().max())
        if name == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU actions differ")
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"card vs CPU {name}: max abs err {errs[name]}")
    return errs


def phase_rnd_eval(dev):
    """The eval loop with the VO in rnd mode and sampled actions."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.eval import Evaluator, fused_vo_act_step
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    n_envs = n_episodes = N_ENVS
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, mode="rnd", rnd_mode_n=RND_PASSES)
    vo, policy, cpu_vo, cpu_policy = _build_models(cfg, dev, SEED)
    env_cfg = EnvConfig(image_h=H, image_w=W, max_episode_steps=20)
    ev = Evaluator(model=policy, envs=make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 5),
                   vo_ensemble=vo, device=dev, deterministic=False,
                   generator=torch.Generator(device=dev).manual_seed(SEED))

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    agg = ev.run(n_episodes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    loop_steps = max(r.steps for r in ev.results)
    _log("rnd", "Evaluator.run: " + json.dumps(agg, sort_keys=True))
    if agg["episodes"] != n_episodes or len(ev.results) != n_episodes:
        raise AssertionError(f"expected exactly {n_episodes} episodes, got {agg['episodes']}")
    bad = [k for k, v in agg.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite aggregates: {bad}")
    if not agg["vo_pred_std_mean"] > 0:
        raise AssertionError(f"rnd mode reports vo_pred_std_mean {agg['vo_pred_std_mean']}")
    if launches != loop_steps + 1:
        raise AssertionError(f"bin_counts launched {launches} times over {loop_steps} "
                             "steps; expected steps + 1")
    _log("rnd", f"{loop_steps} steps, {int(agg['total_env_steps'])} env steps, wall "
                f"{wall:.3f} s, bin_counts launches {launches}")

    probe = make_scripted_vector_env(env_cfg, n_envs, seed=SEED + 1)
    obs0 = probe.reset()
    rng = np.random.default_rng(SEED)
    actions = np.where(rng.uniform(size=n_envs) < 0.7, 1,
                       rng.integers(2, 4, n_envs)).astype(np.int64)
    obs1 = probe.step(actions)[0]
    args = _fused_inputs(obs0, obs1, actions, dev, cfg, policy)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        return fused_vo_act_step(policy, vo, **args, deterministic=False, generator=gen)

    step_ms = _time_ms(step, iters=20)
    _log("rnd", f"rnd fused_vo_act_step at {n_envs} envs, {RND_PASSES} passes: "
                f"{step_ms:.4f} ms/step (CUDA events, host gaps included)")
    _profile(f"rnd fused_vo_act_step at {n_envs} envs", step)

    # the same masks on both, drawn once on the host; mode actions
    masks = cpu_vo.draw_masks(torch.Generator().manual_seed(SEED + 7), n_envs)
    got = fused_vo_act_step(policy, vo, **args, vo_masks=tuple(m.to(dev) for m in masks))
    cpu_args = _fused_inputs(obs0, obs1, actions, torch.device("cpu"), cfg, cpu_policy)
    want = fused_vo_act_step(cpu_policy, cpu_vo, **cpu_args, vo_masks=masks)
    if not float(want[3].min()) > 0:
        raise AssertionError("the CPU's rnd step gave a zero std")
    errs = _compare_step(got, want)
    _log("rnd", "card vs CPU rnd step on the same masks (rtol 1e-3, atol 1e-4; actions "
                "equal): " + json.dumps(errs, sort_keys=True))
    return launches, step_ms


def phase_steady_vo(dev, card):
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.vo.ensemble import (
        VOEnsemble,
        VOInferenceConfig,
        frame_features_packed,
    )

    batch, iters = STEADY_BATCH, 10
    cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 2)
    vo = VOEnsemble(cfg, experts=[seeded_init_(cfg.make_model(), g) for _ in range(3)],
                    device=dev)
    rng = np.random.default_rng(SEED)
    frames = [(torch.from_numpy(rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32)).to(dev),
               torch.from_numpy(rng.uniform(0, 1, (batch, H, W, 1)).astype(np.float32)).to(dev))
              for _ in range(2)]
    actions = np.where(rng.uniform(size=batch) < 0.7, 1,
                       rng.integers(2, 4, batch)).astype(np.int64)
    state = {"feats": frame_features_packed(*frames[0], cfg), "i": 0}

    def step():
        rgb, depth = frames[state["i"] % 2]
        state["i"] += 1
        delta, state["feats"] = vo.predict_step_cached(state["feats"], rgb, depth, actions)
        return delta

    torch.cuda.reset_peak_memory_stats(dev)
    ms = _time_ms(step, iters, warmup=2)
    _profile(f"predict_step_cached at B={batch}", step, iters=2)
    delta = step()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(delta).all()) or delta.shape != (batch, 3):
        raise AssertionError("steady-state VO delta is not finite [512, 3]")
    pairs = batch / (ms / 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _log("steady", f"predict_step_cached B={batch} fp32 70/15/15: {ms:.3f} ms/step, "
                   f"{pairs:.2f} frame-pairs/s, peak {peak:.2f} GiB on {card}")
    return ms, pairs


class _MemoryPairs:
    """Frame pairs of the scripted env held in memory, with the reader
    interface the training engine takes (``iter_batches``,
    ``num_samples``).  An entry is (prev, cur, action, global poses); with
    ``twins`` each entry also yields its swapped twin right after it (the
    opposite turn, its target from the global poses), and a batch of whole
    twins ships each entry's frames once."""

    def __init__(self, entries, twins):
        self.entries = entries
        self.twins = twins

    @classmethod
    def scripted(cls, n, action_fn, seed, twins=False):
        from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv

        env = ScriptedPointNavEnv(EnvConfig(image_h=H, image_w=W), seed=seed)
        rng = np.random.default_rng(seed)
        obs, entries = env.reset(), []
        while len(entries) < n:
            a = int(action_fn(rng))
            pos0, rot0 = env.global_pose()
            new, _r, done, _i = env.step(a)
            pos1, rot1 = env.global_pose()
            if not done:
                entries.append((obs["rgb"].astype(np.uint8), obs["depth"].astype(np.float16),
                                new["rgb"].astype(np.uint8), new["depth"].astype(np.float16),
                                a, (pos0, rot0, pos1, rot1)))
            obs = env.reset() if done else new
        return cls(entries, twins)

    def num_samples(self):
        return len(self.entries) * (2 if self.twins else 1)

    def _samples(self, order):
        from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
        from pointnav_vo_tpu_torch.vo.dataset import inverse_delta_from_global

        for e in order:
            prev_rgb, prev_d, cur_rgb, cur_d, a, (pos0, rot0, pos1, rot1) = self.entries[e]
            # cur relative to prev; the twin: prev relative to cur
            yield e, False, a, inverse_delta_from_global(rot1, pos1, rot0, pos0)
            if self.twins:
                flipped = TURN_RIGHT if a == TURN_LEFT else TURN_LEFT
                yield e, True, flipped, inverse_delta_from_global(rot0, pos0, rot1, pos1)

    def iter_batches(self, batch_size, rng=None, drop_last=False):
        order = np.arange(len(self.entries))
        if rng is not None:
            order = rng.permutation(order)
        pending = []
        for sample in self._samples(order):
            pending.append(sample)
            if len(pending) == batch_size:
                yield self._assemble(pending)
                pending = []
        if pending and not drop_last:
            yield self._assemble(pending)

    def _assemble(self, items):
        from pointnav_vo_tpu_torch.vo.dataset import FramePairBatch

        packed = (self.twins and len(items) % 2 == 0
                  and all(not items[k][1] and items[k + 1][1]
                          for k in range(0, len(items), 2)))
        pix = {"prev_rgb": [], "prev_depth": [], "cur_rgb": [], "cur_depth": []}
        for e, swapped, _a, _d in items:
            if packed and swapped:
                continue  # packed twins: each entry's frames once
            prev_rgb, prev_d, cur_rgb, cur_d = self.entries[e][:4]
            if swapped:
                prev_rgb, prev_d, cur_rgb, cur_d = cur_rgb, cur_d, prev_rgb, prev_d
            for k, v in zip(pix, (prev_rgb, prev_d, cur_rgb, cur_d)):
                pix[k].append(v)
        n = len(items)
        return FramePairBatch(
            **{k: np.stack(v) for k, v in pix.items()},
            actions=np.asarray([it[2] for it in items], np.int32),
            gt_delta=np.stack([it[3] for it in items]).astype(np.float32),
            data_types=np.asarray([int(it[1]) for it in items], np.int32),
            dz_regress_mask=np.ones(n, np.float32),
            chunk_idx=np.zeros(n, np.int32),
            entry_idx=np.asarray([it[0] for it in items], np.int32),
            twins_packed=packed)


def _train_stage(dev, card, stage, engine, data, eval_data):
    """train_epoch, fixed-batch steps, and (where ``eval_data``) evaluate,
    each with its exact launch count; returns the stage's record."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    stats = engine.train_epoch()
    launches = tk.launch_counts["bin_counts"]
    if launches != 2 * TRAIN_STEPS:
        raise AssertionError(f"{stage}: bin_counts launched {launches} times over "
                             f"{TRAIN_STEPS} steps; expected 2 a step")
    if not np.isfinite(stats["mean_total_loss"]):
        raise AssertionError(f"{stage}: epoch loss {stats['mean_total_loss']}")
    _log("train", f"{stage} train_epoch: {TRAIN_STEPS} steps of {TRAIN_BATCH}, mean loss "
                  f"{stats['mean_total_loss']:.6f}, {stats['frame_pairs_per_s']:.2f} "
                  f"frame-pairs/s over the epoch (host batches included), bin_counts "
                  f"launches {launches}")

    # the loss of one fixed batch under one fixed set of dropout masks (the
    # generator restarted before each step): a fixed objective, which 8
    # steps on it must lower
    batch = next(data.iter_batches(TRAIN_BATCH))
    gen_state = engine.generator.get_state()
    losses, debug_geo = [], []
    for _ in range(TRAIN_STEPS + 1):  # the last step's loss is after 8 updates
        engine.generator.set_state(gen_state)
        m = engine.train_step(batch)
        losses.append(float(m["total_loss"]))
        if "debug_geo/abs_diff_rot" in m:
            debug_geo.append(max(float(m["debug_geo/abs_diff_rot"]),
                                 float(m["debug_geo/abs_diff_pos"].max())))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{stage}: the fixed batch's loss did not fall: {losses}")
    if debug_geo and max(debug_geo) >= 1e-4:
        raise AssertionError(f"{stage}: debug_geo {max(debug_geo)} (ground truth not invariant)")
    _log("train", f"{stage} fixed batch and dropout masks, loss before each of "
                  f"{TRAIN_STEPS + 1} steps: " + " ".join(f"{x:.6f}" for x in losses)
                  + (f"; debug_geo max {max(debug_geo):.3e}" if debug_geo else ""))

    step_ms = _time_ms(lambda: engine.train_step(batch), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pairs = TRAIN_BATCH / (step_ms / 1e3)
    _log("train", f"{stage} train_step B={TRAIN_BATCH}: {step_ms:.3f} ms/step, "
                  f"{pairs:.2f} frame-pairs/s (CUDA events, batch upload included), "
                  f"peak {peak:.2f} GiB on {card}")
    _profile(f"{stage} train_step B={TRAIN_BATCH}", lambda: engine.train_step(batch), iters=2)
    record = {"steps": TRAIN_STEPS, "launches": launches, "epoch_loss": stats["mean_total_loss"],
              "fixed_batch_losses": losses, "epoch_frame_pairs_per_s": stats["frame_pairs_per_s"],
              "step_ms": step_ms, "frame_pairs_per_s": pairs, "peak_gib": peak}
    if debug_geo:
        record["debug_geo_max"] = max(debug_geo)
    if eval_data is not None:
        engine.eval_reader = eval_data
        tk.reset_launch_counts()
        ev = engine.evaluate()
        eval_launches = tk.launch_counts["bin_counts"]
        n_batches = -(-eval_data.num_samples() // TRAIN_BATCH)
        if eval_launches != 2 * n_batches:
            raise AssertionError(f"{stage} evaluate: {eval_launches} launches over "
                                 f"{n_batches} batches; expected 2 a batch")
        bad = [k for k, v in ev.items() if not np.isfinite(v)]
        if bad or ev["eval_samples"] != eval_data.num_samples():
            raise AssertionError(f"{stage} evaluate: {ev}")
        _log("train", f"{stage} evaluate: {int(ev['eval_samples'])} samples in {n_batches} "
                      f"batches, bin_counts launches {eval_launches}: "
                      + json.dumps(ev, sort_keys=True))
        record["launches"] += eval_launches
        record["eval_launches"] = eval_launches
    return record


def _train_step_vs_cpu(dev, stage, tcfg, batch, experts):
    """One train step at full width, dropout off, from the same weights: on
    the card and on the CPU in float32, and on the CPU in float64 as the
    reference.  Loss: card vs CPU rtol 1e-4.  Whitening statistics: rtol
    1e-4, atol 1e-6, counts equal.  Gradients: each tensor's relative L2
    error, card vs CPU, at most 5e-2.  At full width float32 itself is far
    from float64 on some tensors: a gradient sums 10^4-10^5 terms that
    largely cancel (the GroupNorm and conv-weight reductions), and the
    card's float32 gradients stray from the float64 ones by up to about 2 %
    of a tensor's max abs (relative L2 about 1 %), the CPU's by a few
    times less; the per-element bound of the CPU tests (1e-3 of the max)
    would fail float32 itself here.  Both distances from float64 are
    printed beside the check."""
    import torch

    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W, dropout_p=0.0)
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        engine = VORegressionEngine(icfg, tcfg, device=device,
                                    experts=[copy.deepcopy(m).to(dtype) for m in experts])
        loss = float(engine.train_step(batch)["total_loss"])
        runs[name] = (loss, engine.experts)
    (loss_card, card), (loss_cpu, cpu), (loss_64, cpu64) = runs.values()
    if abs(loss_card - loss_cpu) > 1e-4 * abs(loss_cpu):
        raise AssertionError(f"{stage}: card loss {loss_card} vs CPU {loss_cpu}")

    def errs(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return (float((a - b).norm() / b.norm().clamp(min=1e-30)),
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))

    worst = {"card_vs_cpu": [0.0, 0.0], "card_vs_fp64": [0.0, 0.0], "cpu_vs_fp64": [0.0, 0.0]}
    for mc, mh, m64 in zip(card, cpu, cpu64):
        for (name, pc), (_, ph), (_, p64) in zip(mc.named_parameters(), mh.named_parameters(),
                                                 m64.named_parameters()):
            for key, (a, b) in (("card_vs_cpu", (pc.grad, ph.grad)),
                                ("card_vs_fp64", (pc.grad, p64.grad)),
                                ("cpu_vs_fp64", (ph.grad, p64.grad))):
                e = errs(a, b)
                worst[key] = [max(w, x) for w, x in zip(worst[key], e)]
                if key == "card_vs_cpu" and e[0] > 5e-2:
                    raise AssertionError(f"{stage}: gradient of {name}: relative L2 error "
                                         f"{e[0]} card vs CPU")
        rc = mc.visual_encoder.running_mean_and_var
        rh = mh.visual_encoder.running_mean_and_var
        if not (torch.equal(rc._count.cpu(), rh._count)
                and torch.allclose(rc._mean.cpu(), rh._mean, rtol=1e-4, atol=1e-6)
                and torch.allclose(rc._var.cpu(), rh._var, rtol=1e-4, atol=1e-6)):
            raise AssertionError(f"{stage}: card and CPU whitening statistics differ")
    _log("train", f"{stage} card vs CPU train step, B={PARITY_BATCH}: loss {loss_card:.8f} "
                  f"(CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst gradient error over "
                  "tensors [relative L2, max abs / max abs]: "
                  + json.dumps(worst) + "; whitening statistics agree")
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst}


def phase_train(dev, card):
    """VO training: the forward stage and the joint turn stage at full width."""
    import torch

    from pointnav_vo_tpu_torch.common import TURN_LEFT, TURN_RIGHT
    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.vo.engine import VORegressionEngine, VOTrainConfig
    from pointnav_vo_tpu_torch.vo.ensemble import VOInferenceConfig

    t0 = time.perf_counter()
    forward = _MemoryPairs.scripted(TRAIN_STEPS * TRAIN_BATCH, lambda r: 1, SEED + 10)
    fwd_eval = _MemoryPairs.scripted(EVAL_PAIRS, lambda r: 1, SEED + 11)
    turns = _MemoryPairs.scripted(TRAIN_STEPS * TRAIN_BATCH // 2,
                                  lambda r: r.integers(TURN_LEFT, TURN_RIGHT + 1),
                                  SEED + 12, twins=True)
    _log("train", f"scripted frame pairs at {W}x{H}: {forward.num_samples()} forward, "
                  f"{fwd_eval.num_samples()} forward to evaluate, {len(turns.entries)} turn "
                  f"entries as {turns.num_samples()} twin samples, in "
                  f"{time.perf_counter() - t0:.1f} s")

    icfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(SEED + 3)
    experts = [seeded_init_(icfg.make_model(), g) for _ in range(3)]  # forward, left, right
    fwd_cfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=1, lr=2.5e-4, seed=SEED)
    joint_cfg = VOTrainConfig(batch_size=TRAIN_BATCH, action_type=(TURN_LEFT, TURN_RIGHT),
                              geo_invariance_types=("inverse_joint_train",), lr=1.5e-4,
                              seed=SEED)
    records = {
        "forward": _train_stage(dev, card, "forward", VORegressionEngine(
            icfg, fwd_cfg, forward, device=dev,
            experts=[copy.deepcopy(experts[0])]), forward, fwd_eval),
        "joint": _train_stage(dev, card, "joint", VORegressionEngine(
            icfg, joint_cfg, turns, device=dev,
            experts=[copy.deepcopy(m) for m in experts[1:]]), turns, None),
    }
    if not next(turns.iter_batches(TRAIN_BATCH)).twins_packed:
        raise AssertionError("the joint stage's batches are not twin-packed")

    for stage, tcfg, data, ex in (
            ("forward", dataclasses.replace(fwd_cfg, batch_size=PARITY_BATCH), forward,
             experts[:1]),
            ("joint", dataclasses.replace(joint_cfg, batch_size=PARITY_BATCH), turns,
             experts[1:])):
        records[stage]["vs_cpu"] = _train_step_vs_cpu(
            dev, stage, tcfg, next(data.iter_batches(PARITY_BATCH)), ex)
    return records


def _rl_trainer(dev, num_steps, seed):
    """The RL config at full width with seeded weights: the depth policy,
    three det VO experts in the loop, 2 scripted envs."""
    import torch

    from pointnav_vo_tpu_torch.io.weights import seeded_init_
    from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
    from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
    from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

    # configs/rl/ddppo_pointnav.yaml RL.PPO
    cfg = PPOConfig(clip_param=0.2, ppo_epoch=1, num_mini_batch=2, value_loss_coef=0.5,
                    entropy_coef=0.01, lr=1e-4, eps=1e-5, max_grad_norm=0.2,
                    num_steps=num_steps, use_gae=True, gamma=0.99, tau=0.95,
                    use_clipped_value_loss=True, use_normalized_advantage=False,
                    hidden_size=512)
    vo_cfg = VOInferenceConfig(vis_size_h=H, vis_size_w=W)
    g = torch.Generator().manual_seed(seed)
    vo = VOEnsemble(vo_cfg, experts=[seeded_init_(vo_cfg.make_model(), g) for _ in range(3)],
                    device=dev)
    envs = make_scripted_vector_env(EnvConfig(image_h=H, image_w=W), RL_ENVS, seed=seed)
    return DDPPOTrainer(model=PointNavActorCritic(image_size=(H, W)), ppo_cfg=cfg, envs=envs,
                        device=dev, init_generator=g,
                        generator=torch.Generator(device=dev).manual_seed(seed),
                        vo_ensemble=vo)


def _storage_bytes(rollouts):
    tensors = list(rollouts.observations.values()) + [
        getattr(rollouts, f) for f in ("hidden_states", "rewards", "value_preds", "returns",
                                       "action_log_probs", "actions", "prev_actions", "masks")]
    return sum(t.numel() * t.element_size() for t in tensors)


def _full_minibatch(rollouts, model):
    """All envs of a rollout with their advantages: one ppo_loss minibatch."""
    import torch

    from pointnav_vo_tpu_torch.rl.ppo import gather_env_slice

    idx = torch.arange(rollouts.num_envs, device=rollouts.masks.device)
    adv = rollouts.returns[:-1] - rollouts.value_preds[:-1]
    return gather_env_slice(rollouts, idx, model.observation_keys) + (adv[:, idx],)


def _with_returns(trainer):
    """The trainer's rollout with its GAE returns, as update_agent takes it."""
    from pointnav_vo_tpu_torch.rl.trainer import act_step

    next_value = act_step(trainer.model, trainer._last_obs, trainer.hidden,
                          trainer.prev_actions, trainer.masks)[0]
    cfg = trainer.cfg
    return trainer.rollouts.compute_returns(next_value, cfg.use_gae, cfg.gamma, cfg.tau)


def _rl_step_vs_cpu(dev, trainer):
    """One rollout step's pieces on the card and the CPU from the same
    inputs (step 0 -> 1 of the trainer's stored rollout): the mode action
    of the policy, the det VO delta of the cached step and the
    dead-reckoned goal.  Actions equal, the rest within rtol 1e-3 / atol
    1e-4."""
    import torch

    from pointnav_vo_tpu_torch.ops.geometry import pointgoal_polar2cartesian
    from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
    from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, frame_features_packed

    r = trainer.rollouts
    cpu = torch.device("cpu")
    actions_np = r.actions[0, :, 0].cpu().numpy()
    runs = {}
    for name, device, model, vo in (
            ("card", dev, trainer.model, trainer.vo),
            ("cpu", cpu, copy.deepcopy(trainer.model).to(cpu),
             VOEnsemble(trainer.vo.cfg, experts=[copy.deepcopy(m).to(cpu)
                                                 for m in trainer.vo.experts], device=cpu))):
        obs0 = {k: v[0].to(device) for k, v in r.observations.items()}
        obs1 = {k: v[1].to(device) for k, v in r.observations.items()}
        value, action, logp, hidden = act_step(model, obs0, r.hidden_states[0].to(device),
                                               r.prev_actions[0].to(device),
                                               r.masks[0].to(device))
        feats = frame_features_packed(obs0["rgb"], obs0["depth"], vo.cfg)
        delta, _ = vo.predict_step_cached(feats, obs1["rgb"], obs1["depth"], actions_np)
        goal, polar = propagate_goal(pointgoal_polar2cartesian(obs0["pointgoal_with_gps_compass"]),
                                     delta, 1.0 - r.masks[1].to(device),
                                     obs1["pointgoal_with_gps_compass"])
        runs[name] = {"value": value, "action": action, "logp": logp, "hidden": hidden,
                      "delta": delta, "goal_cart": goal, "polar": polar}
    errs = {}
    for k, w in runs["cpu"].items():
        g = runs["card"][k].cpu()
        errs[k] = float((g.double() - w.double()).abs().max())
        if k == "action":
            if not torch.equal(g, w):
                raise AssertionError("card and CPU rollout actions differ")
        elif not torch.allclose(g, w, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"card vs CPU rollout step {k}: max abs err {errs[k]}")
    _log("rl", "card vs CPU rollout step (rtol 1e-3, atol 1e-4; actions equal): "
               + json.dumps(errs, sort_keys=True))
    return errs


def _rl_grad_vs_cpu(dev, trainer):
    """``ppo_loss`` and its gradients on the trainer's whole rollout (one
    minibatch of every env) on the card, on the CPU in float32 and on the
    CPU in float64 as the reference.  Loss: card vs CPU rtol 1e-4.  Each
    gradient's relative L2 error, card vs CPU, at most 5e-2, both devices'
    distance from float64 printed beside it (the gate of phase 6)."""
    import torch

    from pointnav_vo_tpu_torch.rl.ppo import ppo_loss

    rollouts = _with_returns(trainer)
    cfg = trainer.cfg
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        model = copy.deepcopy(trainer.model).to(device=device, dtype=dtype).train()
        model.zero_grad(set_to_none=True)
        total, _ = ppo_loss(model, cfg, _full_minibatch(rollouts.to(device, dtype), model),
                            cfg.clip_param)
        total.backward()
        runs[name] = (float(total.detach()), {k: p.grad for k, p in model.named_parameters()})
    (loss_card, card), (loss_cpu, cpu), (loss_64, cpu64) = runs.values()
    if abs(loss_card - loss_cpu) > 1e-4 * abs(loss_cpu):
        raise AssertionError(f"rl: card ppo_loss {loss_card} vs CPU {loss_cpu}")

    def errs(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return (float((a - b).norm() / b.norm().clamp(min=1e-30)),
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))

    worst = {"card_vs_cpu": [0.0, 0.0], "card_vs_fp64": [0.0, 0.0], "cpu_vs_fp64": [0.0, 0.0]}
    for name in card:
        for key, (a, b) in (("card_vs_cpu", (card[name], cpu[name])),
                            ("card_vs_fp64", (card[name], cpu64[name])),
                            ("cpu_vs_fp64", (cpu[name], cpu64[name]))):
            e = errs(a, b)
            worst[key] = [max(w, x) for w, x in zip(worst[key], e)]
            if key == "card_vs_cpu" and e[0] > 5e-2:
                raise AssertionError(f"rl: gradient of {name}: relative L2 error {e[0]} "
                                     "card vs CPU")
    _log("rl", f"card vs CPU ppo_loss gradient, T={rollouts.num_steps} N={rollouts.num_envs}: "
               f"loss {loss_card:.8f} (CPU {loss_cpu:.8f}, float64 {loss_64:.8f}); worst "
               "gradient error over tensors [relative L2, max abs / max abs]: "
               + json.dumps(worst))
    return {"loss": [loss_card, loss_cpu, loss_64], "worst_gradient_error": worst}


def phase_train_rl(dev, card):
    """Policy training with VO in the loop at full width."""
    import torch

    from pointnav_vo_tpu_torch.ops import topdown_kernels as tk
    from pointnav_vo_tpu_torch.rl.ppo import make_optimizer, ppo_loss, ppo_update

    trainer = _rl_trainer(dev, RL_STEPS, SEED + 20)
    storage_gib = _storage_bytes(trainer.rollouts) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.train(RL_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.launch_counts["bin_counts"]
    expected = RL_UPDATES * RL_STEPS + 1
    if launches != expected:
        raise AssertionError(f"rl: bin_counts launched {launches} times over {RL_UPDATES} "
                             f"updates of {RL_STEPS} steps; expected {expected}")
    bad = [h for h in history if not all(np.isfinite(v) for v in h.values())]
    if bad or trainer.count_steps != RL_UPDATES * RL_STEPS * RL_ENVS:
        raise AssertionError(f"rl: train gave {history}, {trainer.count_steps} env steps")
    timing = dict(trainer.timing)
    fps = trainer.count_steps / sum(timing.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _log("rl", f"train({RL_UPDATES}) over {RL_ENVS} envs, {RL_STEPS} steps a rollout: "
               f"wall {wall:.3f} s, {trainer.count_steps} env steps, {fps:.2f} env-steps/s "
               f"(count_steps / sum(timing)), timing {json.dumps(timing)}, bin_counts "
               f"launches {launches}, peak {peak:.2f} GiB (rollout storage {storage_gib:.3f} "
               f"GiB) on {card}; " + json.dumps(history))

    # steady state: one more rollout and update, each timed to its end
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.collect_rollout()
    torch.cuda.synchronize()
    rollout_step_ms = (time.perf_counter() - t0) * 1e3 / RL_STEPS
    t0 = time.perf_counter()
    trainer.update_agent()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    _log("rl", f"rollout step {rollout_step_ms:.3f} ms (host clock over {RL_STEPS} steps, "
               f"env step and upload included), update_agent {update_ms:.3f} ms "
               f"({RL_STEPS * RL_ENVS} frames in {trainer.cfg.num_mini_batch} minibatches)")

    # the loss of one fixed rollout over successive updates on it
    trainer.collect_rollout()
    rollouts = _with_returns(trainer)
    model = copy.deepcopy(trainer.model).to(dev)  # .to: cuDNN's flat LSTM weights
    opt = make_optimizer(model.parameters(), trainer.cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def fixed_loss():
        with torch.no_grad():
            return float(ppo_loss(model, trainer.cfg, _full_minibatch(rollouts, model),
                                  trainer.cfg.clip_param)[0])

    losses = [fixed_loss()]
    for _ in range(RL_FIXED_UPDATES):
        ppo_update(model, trainer.cfg, opt, rollouts, generator=gen)
        losses.append(fixed_loss())
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rl: the fixed rollout's loss did not fall: {losses}")
    _log("rl", f"fixed rollout, loss before and after each of {RL_FIXED_UPDATES} updates: "
               + " ".join(f"{x:.6f}" for x in losses))

    # card vs CPU on a short rollout, then the per-step profile on it
    short = _rl_trainer(dev, RL_PARITY_STEPS, SEED + 21)
    short.collect_rollout()
    step_errs = _rl_step_vs_cpu(dev, short)
    grad = _rl_grad_vs_cpu(dev, short)
    prof_rollout = _profile(f"collect_rollout of {RL_PARITY_STEPS} steps at {RL_ENVS} envs",
                            short.collect_rollout, iters=1)
    prof_update = _profile(f"update_agent, {RL_STEPS} steps x {RL_ENVS} envs",
                           trainer.update_agent, iters=1)
    per_step = ({"busy_ms": prof_rollout["busy_ms"] / RL_PARITY_STEPS,
                 "wall_ms": prof_rollout["wall_ms"] / RL_PARITY_STEPS,
                 "idle": prof_rollout["idle"],
                 "launches": prof_rollout["launches"] / RL_PARITY_STEPS}
                if prof_rollout else None)
    return {"updates": RL_UPDATES, "steps": RL_STEPS, "envs": RL_ENVS, "launches": launches,
            "expected_launches": expected, "history": history, "timing": timing,
            "env_steps_per_s": fps, "wall_s": wall, "rollout_step_ms": rollout_step_ms,
            "update_ms": update_ms, "peak_gib": peak, "storage_gib": storage_gib,
            "fixed_rollout_losses": losses, "step_vs_cpu": step_errs, "grad_vs_cpu": grad,
            "profile_rollout_step": per_step, "profile_update": prof_update}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    card = phase_build()
    max_err, timings = phase_kernel(dev)
    launches, step_ms, wall, loop_steps = phase_main_path(dev)
    rnd_launches, _rnd_ms = phase_rnd_eval(dev)
    phase_steady_vo(dev, card)
    train = phase_train(dev, card)
    rl = phase_train_rl(dev, card)
    by_path = {"det_eval": launches["bin_counts"], "rnd_eval": rnd_launches,
               "train_forward": train["forward"]["launches"],
               "train_joint": train["joint"]["launches"], "train_rl": rl["launches"]}

    t32 = timings[N_ENVS]  # the main path's batch
    record = {"kernels": [{
        "name": "bin_counts",
        "route": "cuda",
        "source": "pointnav_vo_tpu_torch/csrc/bin_counts.cu",
        "replaces": "pointnav_vo_tpu/ops/topdown_pallas.py:81",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        "ms": t32["device_ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t32["library_ms"],
        "device_ms": t32["device_ms"],
        "call_ms": t32["call_ms"],
        "batches": {str(b): {k: v for k, v in t.items() if k != "turns"}
                    for b, t in timings.items()},
        "turns": {str(b): t["turns"] for b, t in timings.items()},
        "train": train,
        "train_rl": rl,
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
